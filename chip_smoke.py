#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-row-kernels SRC   (see time_row_kernels)
    python3 chip_smoke.py --train-memory fixed|expandable TAU [SRC]
                                                   (see train_memory)

Phases (each prints its lines; any failure exits non-zero):
  1. the card (nvidia-smi name and power limit) and the kernels' build;
  2. every kernel against its plain PyTorch version on the card, with the
     kernel's, the plain version's and the bound's times (quantize_decompress
     must be bit-identical; dp_clip_noise and quantize_decompress at the
     main path's, Vehicle-1's, (64, 262144) and (16, 4194304) rows, each
     case with the instance that ran, the device time of a call and its
     kernels by torch.profiler (one for row_cta and row_cluster) and the
     wrapper's host us a call; cohort_gather_scatter also with int32 slots, its
     gather and scatter timed against index_select / index_copy_, once each
     and again in turns, and its wrapper's host us per call beside theirs);
  2b. (run after 3, whose design sets its shape) counter_rng against its
     plain version on the card: at the main path's noise draw (16, tau,
     210), uniforms bit for bit and normals within RNG_ULPS f32 ulps, and
     at 21b's slab (rank 1's (2, 1, N_local) columns of gemma3-4b's
     one-layer widths on a model axis of 2) in windows, each window bit
     for bit its addresses of the whole (2, 1, N) draw on the card; each,
     and that whole draw, timed against its bound and torch.randn at the
     same shape;
  3. the main path at full width: DP-PASGD on adult_like() split by
     education (16 clients, d = 104) through repro_torch.api on cuda,
     engine "vmap", trained until a budget binds; dp_clip_noise's calls in
     that run must be tau x rounds, counter_rng's one a round;
  4. three rounds with kernel_backend="auto" against "ref" from one seed;
  5. the steady time of one round, and where its device time goes
     (torch.profiler, reported when it can trace; the rounds always run);
  6. the aggregation pipeline at full width: the comm sweep of
     benchmarks/fig4_resource_tradeoff.py (dense, topk25, topk25 at q 0.5,
     qsgd8 at q 0.5) on Adult-2 (adult_like(seed=0) split iid over 16
     clients) with benchmarks/common.run_dp_pasgd's spec, each row's
     rounds, cost, epsilon and both kernels' calls checked (dp_clip_noise
     tau x rounds, quantize_decompress rounds in qsgd8_q50); then the
     qsgd8_q50 round's steady time and profile, as in phase 5;
  7. three qsgd8_q50 rounds with kernel_backend="auto" against "ref": without
     DP bitwise equal; with DP every param gap explained by the QSGD levels
     that dp_clip_noise's rounding flipped;
  8. the population plane at full width, M == C = 16: Adult-2 as
     population_from_federated(fed2, 32) with the topk25_q100 spec, through
     train_population per round and resident (chunk 4, S = 16): 19 rounds,
     570.0 and the JAX package's epsilon exactly, params bitwise equal to
     a dense train, the cache stats and cohort_gather_scatter's launches;
  9. the population quickstart's resident step (M = 100,000, K = 16,
     S = 256, chunk 8, 24 rounds, stationary Dirichlet(0.3) shards):
     bitwise equal to 24 run_cohort_round calls, the JAX package's epsilon,
     cost and cache stats exactly, the launch formula; then ms per round of
     the per-round, chunk-boundary and resident drivers, a profile of one
     steady resident chunk and its blocking host syncs;
 10. flash_attention, rwkv6_scan and mamba2_ssd against their plain
     versions at the serving path's shapes and a ragged small one, f32 and
     bf16, timed beside their bounds (flash also beside torch's
     scaled_dot_product_attention, the yardstick the port never calls, and
     at hd 128 too; each flash, rwkv6 and SSD case names the instance
     that ran, the SSD also at S 2048 and at batch 1 with its kernel's
     device time by torch.profiler beside the wrapper's, rwkv6 also at
     batch 1 and S 2048 with, at every 32-head shape, the device time of
     one call (its tensor-core instance's three kernels summed, by
     torch.profiler) and the wrapper's host us per call; every
     tensor-core flash instance must build without spills);
 11. static serving at full width through repro_torch.launch.serve.generate
     (bf16, random weights from a seed, batch 2): gemma3-4b with a
     2048-token prompt, rwkv6-1.6b and zamba2-7b with 512, 32 greedy tokens
     each; exact kernel launches (34 flash; 24 x 33 rwkv6_scan calls,
     each one count whatever its instance launches; 13 flash + 81
     mamba2_ssd), finite logits, prefill and decode times, peak memory,
     one profiled prefill and one profiled decode step; rope_angles
     bitwise equal on the card to the host-tensor formula it replaced,
     and per arch one decode step's
     blocking host syncs and ms per token with each (none from rope);
 12. kernel_backend "auto" against "ref" on the same params, prefill and 8
     teacher-forced decode steps: f32 with the depth cut to one step of
     each segment; bf16 at 17b's depth, each route held against the f32
     computation on the same params;
 13. the paper's §8.1 experiments at full width through
     benchmarks/common_torch.py: make_cases(fast=False) (Adult-1/2,
     Vehicle-1/2), estimate_constants per case, fig2's two runs per case
     (tau 10 and 1, C_th 1000, eps_th 10), each run's rounds, epsilon and
     cost equal to the same run on the CPU and dp_clip_noise's calls equal
     to the steps taken, accuracy and ms per round, one whole run
     profiled; fig6's solver grid on the cuda and the CPU constants;
 14. the trust plane: SecureMaskedSum at (16, 210) with partial
     participation bitwise equal to the host protocol's
     unmasked_fixed_point_sum and to the CPU route; each robust aggregator
     against its CPU result; benchmarks/attack_resilience_torch.py --check
     on cuda; Adult-1 with secure_agg and central accounting, its rounds
     and epsilon against the host math at 1/P; ms per steady round of
     mean / median / trimmed_mean / norm_bound / secure in turns;
 15. the buffered-async plane (repro_torch.asyncfl): (a) the main path's
     Adult-1 spec as engine "async_buffered" with B 16, a zero-spread clock
     and alpha 0 against "vmap" for 4 rounds, dense and qsgd8 at q 0.5
     (quantize_decompress on (16, 210)): params and optimizer state
     bitwise, rho and cost exactly; (b) B 4 of 16 on a HeteroLatency fleet
     (slow factor 6, alpha 0.5) through train_async(chunk 8) until a budget
     binds, flushes, cost, dispatched epsilon and simulated seconds equal
     to the CPU route, dp_clip_noise's calls tau x (1 + flushes), ms per
     steady cycle, a profiled chunk and one cycle's blocking host syncs
     (limit 1); (c) benchmarks/throughput.py's async straggler scenario:
     async strictly ahead of sync in simulated seconds;
 16. the transformer training path: (a) gemma3-4b at its published widths,
     depth cut to one step of its 6-layer pattern (5 swa + 1 full), bf16,
     2 clients x tau 1 (cut from 2 for memory), batch 1, seq 2048, with
     expandable allocator segments, 2 rounds through
     launch.train.build_federation + api.train (kernel_backend "auto"):
     finite losses, dp_clip_noise tau x rounds calls as row_stream on
     (2, ~1.24e9), the flash / rwkv6 / SSD counters 0 (training runs the
     differentiable route), peak memory; (b) one steady round's ms, one
     profiled round (device busy share), dp_clip_noise's time at that
     shape against its byte bound and the host ms of dp_clip_noise_tree's
     flatten and unflatten around it; (c) the kernel's output on that round's
     real gradient and noise against dp_clip_noise_ref; (d)
     launch.train.main --smoke on cuda and on the CPU: dense with --save,
     qsgd at q 0.5, a resident population with topk: rounds,
     resource_spent and max_epsilon equal (under q 0.5 each route's
     epsilon its own ledger's), the cuda launches equal the CPU route's
     kernel calls, and each row kernel's output in the cuda run (its
     first call of each shape) against its plain version on the same
     operands; (e) launch.serve.main --fl-checkpoint on (d)'s dense
     checkpoint: federated params served through flash_attention;
 17. the continuous-batching engine (repro_torch.serve: SlotEngine, 4
     slots, KV blocks of 64, serve_continuous under StepClock, 10 Poisson
     requests with budgets 16 / 32, gemma3-4b at prompts 300 / 700 / 1500,
     rwkv6-1.6b and zamba2-7b at 256 / 512; each model kernel's output at
     its first call of each shape in the served workload held against its
     plain version on the same operands, phase 10's criteria): (a) f32,
     depth cut to one step of each segment: every request's tokens equal
     launch.serve.generate on the plain route (kernel_backend "ref") on
     its exact-length prompt under the top-two gap guard, requests joining
     mid-stream into recycled slots; (b) bf16, depth cut to 6 / 6 / 14
     layers (ENGINE_BF16_STEPS), random
     weights from a seeded CUDA generator: exact launches (flash per
     attention layer and prefill group, rwkv6_scan per layer and group or
     decode step, mamba2_ssd per layer and group, the row kernels 0),
     finite logits, tokens against generate under the guard (steps
     compared printed), prefill ms per group, peak memory beside the
     pools' reckoned bytes; then 4 requests admitted as one unpadded group
     and decoded in turns with the static B 4 path over the same span:
     ms per step, their tokens equal under a guard of 4x their logits'
     difference (half the steps compared at least), one profiled engine
     step, blocking host syncs (0 per decode_step(table=...), at most 1
     per engine.step()); (c) benchmarks/serve_torch.py --check --repeats 3
     on cuda at gemma3-4b's full width (the modes run in turns, three runs
     of each a load, the medians compared); (d)
     examples/serve_continuous_torch.py on cuda;
 18. the MoE archs and the chunked mixers, bf16 at the published widths,
     random weights from a seed, after a check that phase 17 left no
     memory allocated: (a) launch.serve.generate on phi3.5-moe (16 of 32
     layers, B 2, prompt 2048, 32 greedy tokens) and llama4-maverick (one
     period of its pattern, 4 layers, B 1, prompt 16,384: two 8,192-token
     chunks, decode starting a new one), exact flash launches (one per
     attention layer, a chunked layer one call over its chunks), the
     other kernels 0, finite logits, prefill and decode ms, peak memory
     beside the params' bytes, one profiled prefill naming the MoE stages'
     device time; (b) the SlotEngine (4 slots, blocks of 64, 6 Poisson
     requests at prompts 300 / 700, budget 16): exact flash launches,
     every decode step's MoE one capacity group of all the slots, then
     17b's same-shape check; (c) kernel_backend "auto" against "ref",
     prefill + 8 teacher-forced decode steps; every flash call's first
     output of each shape in (a)-(c) held against flash_attention_ref on
     the same operands; (d) phi3.5-moe training (1 layer, C 2, tau 1,
     seq 512, 2 rounds through build_federation + api.train): finite
     losses, positive aux, dp_clip_noise tau x rounds, the model kernels
     0, peak memory; (e) the chunk-parallel WKV6 at rwkv6-1.6b's widths
     (f32, one layer, rwkv_chunk 64, seq 512): the training route against
     rwkv_chunk 0, the serving route (rwkv6_scan) against both;
 19. the measurement toolchain and the last API names: (a)
     benchmarks/throughput_torch.py --smoke --check --device cuda in this
     process, every row kernel against its plain version and its H100
     bound; (b) repro_torch.launch.dryrun --all on meta tensors (started
     in the background after the build, with no CUDA device visible to
     it; 19b runs before 19a and waits for it), then gemma3-4b's prefill
     shape traced here (memory_allocated unchanged) and its bf16 prefill
     at B 2 x 2,048 run for real against the dry run's bound and live
     bytes for that shape; (c)
     api.Federation on the main path's Adult-1 spec against api.train, and
     its save_federation_state / load_federation_state resume bitwise;
     (d) launch.train --smoke --env-profile host --replica-hint in a fresh
     process (one re-exec, trains), and the same with
     REPRO_DEVICE_MEM_BYTES below the footprint (a world of one cannot
     split the replica: ValueError naming the ranks it needs);
 20. the sharded engines' client axis (repro_torch.core.fl_shard_map,
     repro_torch.mesh): (a) a world of one under NCCL: the main path's
     Adult-1 spec trained until a budget binds as "shard_map" and
     "mesh_2d" (1, 1), dense, qsgd8_q50 and trimmed_mean (shard_map only),
     each bitwise "vmap" (params, optimizer state, key, rho, rounds, cost)
     with the row kernels' launches equal, ms per steady round of vmap and
     shard_map in turns, and the population quickstart's resident driver
     under shard_map bitwise vmap's (cohort_gather_scatter launched); (b)
     two gloo ranks sharing the card (repro_torch.launch.mesh.HostWorld):
     Adult-1 as shard_map, block 8, dense and qsgd8_q50, within 1e-5 of
     vmap with the ledger exact, the ranks alike, each rank's launches tau
     x rounds (dp_clip_noise) and rounds (quantize_decompress), then
     dense as mesh_2d (1, 1), whose one client block leaves rank 1
     outside the mesh, holding no rows, to receive each round's metrics;
     every rank in slab state, its rows and bytes printed; every row
     kernel's first call of each shape in 20a and in each rank held
     against its plain version;
 21. the model axis of mesh_2d (dm > 1: each replica's weights and matmuls
     split over the ranks of a slab, repro_torch.mesh.collectives), two
     gloo ranks sharing the card: (a) the Adult-1 spec as mesh_2d (1, 2)
     (w split on d_in), dense and qsgd8_q50, until a budget binds: within
     1e-5 of vmap, ledger and participant counts exact, each rank's
     row_sumsq and clip_noise_apply launches tau x rounds (the split
     Eq.-7a clip: the norm all-reduced between the two kernels),
     quantize_decompress as vmap's; (b) gemma3-4b's widths, f32, depth cut
     to 1 layer, C 2, tau 1, seq 2048, 1 round as mesh_2d (1, 2) and as
     vmap on rank 0, in turns, the mesh in slab state (each rank's slab
     of the state between rounds) and in the whole layout
     (api.whole_state of it): the slab's params (made whole) within 2e-5
     of each tensor's largest magnitude of vmap's and bit for bit the
     whole layout's, ms per round, each rank's peak memory of each form
     (the slab's at least MA_SLAB_SAVING_GB below the whole layout's), the
     model group's all-reduces a local step, counter_rng one launch a
     round; (d)-(f) the other families as (b) in slab state, f32,
     tau 1, 1 round (2 for (e)), in turns with vmap: (d) rwkv6-1.6b's
     widths, depth 24 -> 1, C 2, seq 512; (e) zamba2-7b's widths, its
     shared attention + MLP block and one Mamba2 layer, C 2, seq 2048; (f)
     phi3.5-moe's widths, 1 layer (experts split over the ranks), C 1,
     seq 512. 21b and 21d-f share one world of two ranks; (c), after
     them:
     row_sumsq and clip_noise_apply at a rank's rows of (a), (b) and
     (d)-(f) and of phase 23's (d) (for all but (a) also row_sumsq on
     rank 1's split columns) against their plain versions and their
     bounds;
 22. the serving mesh (launch.serve.serve_on_mesh: prefill, decode and
     the engine split over a model axis), two gloo ranks sharing the card
     on the mesh (1, 2), bf16 at the published widths, in turns with the
     whole model on rank 0: (a) gemma3-4b (one 6-layer step of its 34
     layers: 5 sliding + 1 full, B 2 x 2048, 16 greedy tokens) and its
     engine (4 slots, blocks of 64, 6 Poisson
     requests at prompts 300 / 700 / 1500); (b) rwkv6-1.6b (24 -> 6
     layers, B 2 x 512, 16 tokens); (c) zamba2-7b (81 -> 14 layers: two
     steps of its shared block and six Mamba2 layers, B 2 x 512, 16
     tokens); (d)
     phi3.5-moe, 4 of 32 layers (B 2 x 512, 8 tokens): greedy tokens
     against the whole route's under the top-two gap guard (4x the whole
     route's own prefill distance to f32), at the prefill and every
     decode step the logits' relative L2 to f32 at most 1.25x the whole
     route's (both fed the mesh's tokens), the ranks' tokens bit for bit
     alike, prefill and decode ms of each route in
     turns, the model group's collectives against the prediction, each
     rank's launches and peak memory; (e) each arch in f32 at two layers,
     prefill + 4 decode steps within 1e-4 of the whole route's largest
     logit; (f) flash_attention, rwkv6_scan and mamba2_ssd at a rank's
     shapes against their plain versions and their bounds;
 23. KV heads the model axis does not divide and the sequence-split
     decode cache, on phase 22's two ranks: (a) granite-20b (MQA: its one
     KV head whole on each rank, the decode cache's sequence split over
     the two), 52 -> 8 layers, bf16, B 2 x 2048, 16 greedy tokens, held
     as 22a (the collectives with the sequence-split cache's two
     all-reduces and query gather a layer and step), each rank's first
     flash calls at (2, 24, 2048, 128) held against the plain version, a
     rank's KV cache half the whole's, and its engine (4 requests); (b)
     gemma3-4b at long_500k on (2, 1) under shard_seq (the cache's
     sequence on "data"): 34 layers, bf16, B 1, caches of 524,288 slots
     filled to 524,280 positions from seeded blocks, 4 teacher-forced
     decode steps against the whole route on rank 0 (relative L2 within
     5e-2, argmaxes), caches half the whole's, collectives as predicted;
     (c) both in f32 at two layers (granite on (1, 2), gemma3 at 524,288
     slots on (2, 1)) within 1e-4 of the whole route's largest logit;
     (d) granite-20b's widths, 1 layer, f32, mesh_2d (1, 2) training in
     turns with vmap as 21b, its all-reduces a local step as predicted;
     (e) flash_attention at (2, 24, 2048, 128) against its plain version,
     its bound and scaled_dot_product_attention;
 24. weights split over the serving mesh's data axis (serve_on_mesh's
     fsdp_over_data: each rank's model slice split again over "data",
     gathered before each layer) and a decode cache split on both its
     sequence and its heads, four gloo ranks sharing the card on the mesh
     (2, 2): (a) mistral-large-123b at its published widths, 88 -> 1
     layer, bf16, B 2 x 512, 8 greedy tokens, held as 22a against the
     whole model on rank 0 (tokens under the guard, phase 12's criterion
     at every step, the four ranks alike), the collectives a generate
     against the code's count (the model group's and the data group's
     gathers, one a layer, the embedding and the head, a step), one flash
     launch a layer on each rank, each rank's flash calls at (1, 48, 512,
     128) against the plain version, a rank's params a quarter of the
     whole's, each rank's peak; (b) gemma3-4b at long_500k under shard_seq
     on (2, 2), its caches split on the sequence ("data") and the KV heads
     ("model"), a quarter a rank, as 23b; (c) mistral-large at one f32
     layer and gemma3-4b at 23c's two f32 layers on (2, 2) within 1e-4 of
     the whole route's largest logit; then flash_attention at 24a's rank
     shape against its plain version, its bound and
     scaled_dot_product_attention;
 25. shard_map in slab state (each rank's state its client block's rows
     between rounds, each round's draws only the block's rows), two gloo
     ranks sharing the card on the (2, 1) mesh: (a) the Adult-1 spec,
     dense, qsgd8_q50, trimmed_mean and the secure sum, trained until a
     budget binds in slab state and in the whole layout: bit for bit
     alike, the ranks alike, each rank's 8 rows half the whole layout's
     bytes, each rank's dp_clip_noise, counter_rng and quantize_decompress
     launches as the code implies, on the (8, 210) block, each kernel's
     first call of each shape against its plain version; (b) the resident
     quickstart (phase 9's) in both forms, bit for bit, phase 9's exact
     numbers, cohort_gather_scatter's launches, one steady chunk's blocking
     host syncs and collectives; (c) gemma3-4b's widths (21b's cell, C 2:
     a rank's block one client) in slab state and the whole layout in
     turns, one round each: bit for bit, ms per round, each rank's peak.
Phase 2 also holds cohort_gather_scatter bitwise against its plain version
at the resident driver's shapes. The last two lines are the kernels' JSON
record and {"ok": true, "device": {...}}. Needs a CUDA GPU and the
repository's src/.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
# H100 SXM 32-bit integer ops: 64 INT32 lanes a SM (half the FP32 lanes,
# NVIDIA's Hopper white paper) x 132 SMs x the 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
BF16_FLOPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
C_TH, EPS_TH, DELTA = 1000.0, 4.0, 1e-4
BATCH, LR, CLIP = 32, 0.3, 1.0
# main path, Vehicle-1, 64 clients of a 262K-parameter model (row_cluster
# at its capacity, 64 MiB an operand: past L2), a big one (row_stream), and
# the async dispatch blocks of phases 15b (B 4 of Adult-1) and 15c (B 2 of
# throughput.py's straggler fleet, dim 32)
SHAPES = ((16, 210), (23, 202), (64, 262_144), (16, 4_194_304), (4, 210),
          (2, 66))
QSGD_BITS = (1, 4, 8, 16)
# benchmarks/fig4_resource_tradeoff.py PIPELINES: (label, q, compressor, ratio)
PIPELINES = (("dense_q100", 1.0, "none", 1.0),
             ("topk25_q100", 1.0, "topk", 0.25),
             ("topk25_q50", 0.5, "topk", 0.25),
             ("qsgd8_q50", 0.5, "qsgd", 0.25))
SWEEP_TAU, SWEEP_K, SWEEP_EPS = 5, 100, 10.0
# cohort_gather_scatter: (S, K, D, dtype) - the residuals of phases 9 and 8,
# the data leaves (x, y) of phase 9, tests/test_kernels.py's shapes, and a
# 1 GiB cache where bandwidth means something
COHORT_SHAPES = ((256, 16, 42, "float32"), (16, 16, 210, "float32"),
                 (256, 16, 800, "float32"), (256, 16, 40, "int32"),
                 (9, 3, 5, "float32"), (16, 4, 33, "bfloat16"),
                 (64, 16, 4_194_304, "float32"))
# examples/population_quickstart.py: M, K, dim, batch, tau, sigma, rounds
QS_M, QS_K, QS_DIM, QS_BATCH, QS_TAU, QS_SIGMA, QS_ROUNDS = (
    100_000, 16, 20, 8, 5, 0.8, 24)
QS_CACHE, QS_CHUNK = 256, 8
# phase 2b: counter_rng's normals may differ from the plain version's by
# this many f32 ulps (none: both round the same IEEE ops in the same
# order); the plain version runs on 21b's slab in windows of this many
# columns
RNG_ULPS, RNG_WINDOW = 0, 1 << 25
# --time-row-kernels: the main path's noise draw (clients, tau, N)
RNG_MAIN_SHAPE = (16, 1, 210)
# phase 10: (B, H, S, hd, window) gemma3's prefill full and windowed,
# zamba2's shared attention, a ragged small one; (B, H, S, hd, from s0)
# rwkv6's prefill and decode step, its prefill at batch 1 and at S 2048,
# a ragged small one; (B, S, H, P, N,
# chunk) zamba2's SSD at its serving prompt (4 chunks), at S 2048 (a
# 16-chunk chain) and at batch 1 (112 chains on 132 SMs), and a small one
# of several chunks
FLASH_SHAPES = ((2, 8, 2048, 256, 0), (2, 8, 2048, 256, 1024),
                (2, 32, 512, 112, 0), (2, 32, 2048, 128, 0),
                (1, 3, 77, 48, 20))
RWKV_SHAPES = ((2, 32, 512, 64, False), (2, 32, 1, 64, True),
               (1, 32, 512, 64, False), (2, 32, 2048, 64, False),
               (1, 3, 45, 32, True))
SSD_SHAPES = ((2, 512, 112, 64, 64, 128), (2, 2048, 112, 64, 64, 128),
              (1, 512, 112, 64, 64, 128), (1, 48, 3, 16, 8, 16))
# phases 11-12: (arch, prompt length, generated tokens), batch 2
SERVE_RUNS = (("gemma3-4b", 2048, 32), ("rwkv6-1.6b", 512, 32),
              ("zamba2-7b", 512, 32))
# phase 13: benchmarks/fig2_efficiency.py's runs, DP-PASGD and DP-SGD
FIG2_TAUS, FIG2_C, FIG2_EPS = (10, 1), 1000.0, 10.0
# phase 16: gemma3-4b's training at full width, one step of its 6-layer
# pattern: clients, local steps, batch per client, seq, rounds, eps budget.
# tau is cut from 2 to 1: at tau 2 fixed allocator segments run out of
# memory, and expandable ones peak at 78.69 GB of the card's 85.02 with the
# round's host time in the allocator (--train-memory measures both)
TRAIN_C, TRAIN_TAU, TRAIN_B, TRAIN_SEQ, TRAIN_ROUNDS, TRAIN_EPS = (
    2, 1, 1, 2048, 2, 10.0)
# phase 16d: the launcher's main at --smoke, on cuda and on the CPU
LAUNCH_BASE = ["--arch", "gemma3-4b", "--smoke", "--rounds", "3",
               "--tau", "1", "--batch", "1", "--seq", "64"]
LAUNCH_RUNS = (
    ("dense", ["--clients", "2"]),
    ("qsgd_q50", ["--clients", "4", "--compressor", "qsgd",
                  "--participation", "0.5"]),
    # the resident cache moves error-feedback rows through
    # cohort_gather_scatter, so it takes a compressor
    ("population_resident", ["--population", "64", "--cohort-size", "4",
                             "--chunk-rounds", "2", "--resident-cache", "16",
                             "--compressor", "topk", "--compress-ratio",
                             "0.25"]))
# phase 17: the continuous-batching engine. (arch, prompt lengths):
# gemma3-4b's prompts fall in the buckets 512 / 1024 / max_len, so padding
# and the 1024 window both bite; the recurrent archs prefill at exact
# lengths, zamba2's multiples of its ssd_chunk 128. Generation budgets,
# slots, KV block, requests and their Poisson rate per simulated second,
# under StepClock: a decode step 1 s, a prefill 1/256 s a padded token, so
# requests arrive while others decode, queue, and join in groups of 1-3
# rows (padded to 1 / 2 / 4) into recycled slots
ENGINE_RUNS = (("gemma3-4b", (300, 700, 1500)), ("rwkv6-1.6b", (256, 512)),
               ("zamba2-7b", (256, 512)))
# 17b's depth in bf16: steps of each arch's first segment kept (gemma3-4b
# 1 of its 6-layer steps, 6 of 34 layers; rwkv6-1.6b 6 of 24; zamba2-7b 2
# of its 7-layer steps, 14 of 81, as 22c): cut from the full depths to pay
# for phase 2b and 21b's whole layout, as the script ran 1,187-1,225 s of
# its 1,200 without the cut, and halved again (from 12 / 12 / 21) to pay
# for phase 25 (the only one of that PR's cuts that measurably paid:
# 12-18 s of phase 25's ~85; PERF.md §4); the launch counts follow the
# cut config
ENGINE_BF16_STEPS = {"gemma3-4b": 1, "rwkv6-1.6b": 6, "zamba2-7b": 2}
ENGINE_GENS, ENGINE_SLOTS, ENGINE_BLOCK = (16, 32), 4, 64
ENGINE_REQUESTS, ENGINE_RATE, ENGINE_PREFILL_TOKEN_S = 10, 1.0, 1 / 256
GUARD_F32 = 1e-4       # phase 17a's top-two gap guard, of max |logit|
MODEL_KERNELS = ("flash_attention", "rwkv6_scan", "mamba2_ssd")
# phase 17c: runs of each load, the modes in turns, the medians compared
# (one run a load read continuous 0.999x static at load 2.0 on a fast
# host, where its load 1.0 ran faster: one sample is the host's noise)
SERVE_REPEATS = 3
# phase 18: the MoE archs at their published widths, bf16. (arch, steps of
# its segment pattern kept (the depth cut), batch, prompt, greedy tokens):
# phi3.5-moe 16 of 32 layers (41.9 GB of params); llama4-maverick one
# period of its pattern (chunk-MoE, chunk-MLP, chunk-MoE, global NoRoPE
# MLP: 68.0 GB), a prompt of two 8,192-token chunks, so decode starts a
# new chunk at 16,384
MOE_SERVE_RUNS = (("phi3.5-moe-42b-a6.6b", 16, 2, 2048, 32),
                  ("llama4-maverick-400b-a17b", 1, 1, 16384, 16))
# 18b: the engine's prompts, requests and budget (slots and block: 17's);
# 18c: the routes' batch and prompt (the plain flash holds (B, H, S, S) f32
# scores beside the params)
MOE_ENGINE_PROMPTS, MOE_ENGINE_REQUESTS, MOE_ENGINE_GEN = (300, 700), 6, 16
MOE_ROUTE_B, MOE_ROUTE_PROMPT = 1, 2048
# 18c: the largest relative L2 gap between the bf16 routes' logits, per
# step, with the plain route's routers pinned to the kernel route's
# choices: phase 12 measured 2.9e-2 for gemma3-4b's 34 bf16 layers, and
# 18c's first run 3.3e-2 at phi3.5's prefill before the decode steps'
# moved expert choices (13% of them) took it to 0.29 unpinned
MOE_ROUTE_TOL = 0.1
# 18a: the MoE dispatch's stages, as functions of repro_torch.models.moe,
# named in the profile of one prefill
MOE_STAGES = {"_route": "router", "_ranks": "rank",
              "_dispatch": "dispatch (index_add)",
              "_expert_ffn": "expert GEMMs", "_combine": "combine (gather)"}
# 18d: phi3.5-moe's training at full width, depth cut to 1 layer
MOE_TRAIN_STEPS, MOE_TRAIN_SEQ = 1, 512
# 18e: the chunk-parallel WKV6 at rwkv6-1.6b's widths, f32, one layer
WKV_CHUNK, WKV_B, WKV_SEQ = 64, 2, 512


def _ptxas_instances(log: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel instance, registers, stack frame bytes, spill store bytes,
    spill load bytes) for every entry function in an ``nvcc -Xptxas -v``
    log; the flash instances named ``flash_tc<hd>`` / ``flash_fwd<type,
    columns>``, the
    SSD's ``ssd_tc<Q, P boxes, N boxes>`` / ``ssd_fwd<type>``, the WKV's
    ``wkv_chunk_state<hd>`` / ``wkv_state_pass`` / ``wkv_chunk_out<hd>``
    (its tensor-core instance), ``wkv6_fwd<type, columns>`` and the row
    kernels' ``row_cta`` / ``row_cluster`` / ``stream_partials`` /
    ``stream_apply<clip_noise | quantize>`` (", no z": clip only) and
    ``counter_rng<normal | uniform, groups a thread>``."""
    out, name, spills = [], None, (0, 0, 0)
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            tc = re.search(r"flash_tcILi(\d+)E", name)
            fwd = re.search(r"flash_fwdI(f|13__nv_bfloat16)Li(\d+)E", name)
            ssd_tc = re.search(r"ssd_tcILi(\d+)ELi(\d)ELi(\d)E", name)
            ssd_fwd = re.search(r"ssd_fwdI(f|13__nv_bfloat16)E", name)
            wkv_tc = re.search(r"(wkv_chunk_state|wkv_chunk_out)ILi(\d+)E",
                               name)
            wkv_fwd = re.search(r"wkv6_fwdI(f|13__nv_bfloat16)Li(\d+)E",
                                name)
            row = re.search(r"rowred\d+(row_cta|row_cluster|stream_partials|"
                            r"stream_apply)I.*?(clip_noise|quantize)", name)
            rng = re.search(r"counter_rng_kernelILb([01])ELi(\d+)E", name)
            if tc:
                name = f"flash_tc<{tc.group(1)}>"
            elif fwd:
                name = (f"flash_fwd<{'f32' if fwd.group(1) == 'f' else 'bf16'}"
                        f", {fwd.group(2)}>")
            elif ssd_tc:
                name = (f"ssd_tc<Q {ssd_tc.group(1)}, P boxes "
                        f"{ssd_tc.group(2)}, N boxes {ssd_tc.group(3)}>")
            elif ssd_fwd:
                kind = "f32" if ssd_fwd.group(1) == "f" else "bf16"
                name = f"ssd_fwd<{kind}>"
            elif wkv_tc:
                name = f"{wkv_tc.group(1)}<{wkv_tc.group(2)}>"
            elif "wkv_state_pass" in name:
                name = "wkv_state_pass"
            elif wkv_fwd:
                kind = "f32" if wkv_fwd.group(1) == "f" else "bf16"
                name = f"wkv6_fwd<{kind}, {wkv_fwd.group(2)}>"
            elif row:
                name = (f"{row.group(1)}<{row.group(2)}"
                        f"{', no z' if 'ELb0E' in name else ''}>")
            elif rng:
                kind = "normal" if rng.group(1) == "1" else "uniform"
                name = f"counter_rng<{kind}, {rng.group(2)} groups>"
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if spill:
            spills = tuple(int(g) for g in spill.groups())
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name is not None:
            out.append((name, int(regs.group(1)), *spills))
            name, spills = None, (0, 0, 0)
    return out


def _fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def _time_ms(fn, iters: int) -> float:
    """Mean device time of one call over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile_call(torch, fn, label, ranges=None, watch=()):
    """``fn()`` under torch.profiler; prints its wall time, the device's
    busy share, its kernel launches, the top device kernels and the top
    host ops. ``ranges`` (a module, {function name: stage}) wraps those
    functions of the module in named ranges for the call and prints each
    stage's device ms (the kernels its range launched) and share of the
    call's device time; for each name in ``watch``, the device ms and
    launches of the kernels whose name holds it. ``fn`` always runs; only
    the profiler's start, stop and report are optional. Returns (fn's
    result, the launches or None)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    module, stages = ranges or (None, {})
    reals = {name: getattr(module, name) for name in stages}

    def named(name, real):
        def call(*a, **kw):
            with record_function(f"stage{name}"):
                return real(*a, **kw)
        return call

    prof = None
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:        # noqa: BLE001 — the profiler is optional
        print(f"{label}: profile unavailable ({e!r})", flush=True)
        prof = None
    for name, real in reals.items():
        setattr(module, name, named(name, real))
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, real in reals.items():
            setattr(module, name, real)
    if prof is None:
        return out, None
    try:
        prof.stop()
        averages = prof.key_averages()
    except Exception as e:        # noqa: BLE001 — the profiler is optional
        print(f"{label}: profile unavailable ({e!r})", flush=True)
        return out, None
    ranged = {f"stage{name}" for name in stages}
    events = [e for e in averages
              if e.device_type.name == "CUDA" and e.device_time_total > 0
              and e.key not in ranged]
    device_ms = sum(e.device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"{label}: wall {wall_ms:.3f} ms (profiled), device busy "
          f"{device_ms:.3f} ms ({device_ms / wall_ms:.1%}), {launches} "
          f"kernel launches", flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / 1e3:9.4f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    for name in watch:
        hits = [e for e in events if name in e.key]
        print(f"{label}: kernels named {name}: "
              f"{sum(e.device_time_total for e in hits) / 1e3:.4f} ms of "
              f"device time in {sum(e.count for e in hits)} launches",
              flush=True)
    host = [e for e in averages if e.device_type.name == "CPU"]
    print(f"{label}: host ops by self CPU time", flush=True)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  {e.self_cpu_time_total / 1e3:9.4f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    if stages:
        parts = []
        for name, what in stages.items():
            ms = max((e.device_time_total for e in averages
                      if e.key == f"stage{name}"
                      and e.device_type.name == "CPU"), default=0.0) / 1e3
            parts.append(f"{what} {ms:.3f} ms "
                         f"({ms / max(device_ms, 1e-9):.1%})")
        print(f"{label}: stages by device time (the kernels each range "
              f"launched): " + ", ".join(parts), flush=True)
    return out, launches


def _bound_ms(rows: int, n: int, with_noise: bool) -> tuple[float, str]:
    """The least time the card could take for dp_clip_noise, and what
    bounds it. Bytes: g (and noise, sigma) read once, y and norm written
    once, f32. Operations: per element a square-and-add (2), the scale (1)
    and, with noise, a multiply-add (2)."""
    nbytes = 4 * (rows * n * (3 if with_noise else 2)
                  + rows * (2 if with_noise else 1))
    return _larger_bound(nbytes, rows * n * (5 if with_noise else 3))


def _qsgd_bound_ms(rows: int, n: int) -> tuple[float, str]:
    """The same for quantize_decompress. Bytes: x and u read once, y and
    scale written once, f32. Operations: per element abs and max (2),
    divide, add, floor (3), sign and two multiplies (3)."""
    return _larger_bound(4 * (3 * rows * n + rows), 8 * rows * n)


def _larger_bound(nbytes: int, ops: int,
                  peak: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / peak * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def _row_inputs(torch, rows: int, n: int, seed: int):
    """Phase 2's inputs of the row kernels at (rows, n): x with rows of
    norms from 1e-4 to 10, row 0 all zeros; z ~ N(0, 1) (noise) and
    w ~ U[0, 1) (QSGD's u); sigma in [0.1, 1.1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, n), generator=gen, device="cuda")
    x *= torch.logspace(-4, 1, rows, device="cuda")[:, None]
    x[0] = 0.0
    z = torch.randn((rows, n), generator=gen, device="cuda")
    w = torch.rand((rows, n), generator=gen, device="cuda")
    sigma = torch.rand((rows,), generator=gen, device="cuda") + 0.1
    return x, z, w, sigma


def _row_times(torch, fn, n: int, stem: str) -> dict:
    """A row kernel's call ``fn`` timed as phase 2 times it: ``ms`` by CUDA
    events over back-to-back calls (``_time_ms``), ``device_ms`` and
    ``kernels`` (per call, by torch.profiler, the kernels whose name holds
    ``stem``; "" takes every kernel in the window) and ``host_us`` (the
    host's time a call, ``_host_us``)."""
    big = n > 1_000_000
    device_ms, parts, kernels = _call_device_ms(torch, fn, 5 if big else 50,
                                                stem)
    first = kernels
    for _ in range(3):
        # every call runs a whole number of kernels, and a kernel record the
        # trace dropped can only lower the count: take the trace again, up
        # to three times (two traces in a row have read 0.98 where the
        # wrapper runs one kernel, and one 0.5). A count above a whole
        # number is kept, and fails its check. Halves round up: Python's
        # round(0.5) is 0
        if kernels is None or kernels >= math.floor(kernels + 0.5):
            break
        device_ms, parts, kernels = _call_device_ms(
            torch, fn, 5 if big else 50, stem)
    return {"ms": _time_ms(fn, 20 if big else 200), "device_ms": device_ms,
            "kernels": kernels, "kernels_first": first, "parts": parts,
            "host_us": _host_us(torch, fn, 20 if big else 200)}


def _row_line(rec: dict, plain_ms: float, bound) -> str:
    dev = ("device not measured" if rec["device_ms"] is None else
           f"device {rec['device_ms']:.5f} ms a call in {rec['kernels']:g} "
           f"kernel(s) ({rec['parts']})")
    if rec["kernels_first"] != rec["kernels"]:
        dev += f" (retaken: the first trace counted {rec['kernels_first']:g})"
    return (f"[{rec['variant']}]  kernel {rec['ms']:.5f} ms "
            f"({bound[0] / rec['ms']:.1%} of the bound)  {dev}  host "
            f"{rec['host_us']:.2f} us a call  plain {plain_ms:.5f} ms  bound "
            f"{bound[0]:.6f} ms ({bound[1]})  library: none (no single "
            f"PyTorch call computes this function)")


def _one_kernel_a_call(rec: dict) -> bool:
    """row_cta and row_cluster must run one kernel a call where the
    profiler traces the card (row_stream runs two)."""
    return (rec["kernels"] is None or rec["variant"] == "row_stream"
            or rec["kernels"] == 1)


def check_kernels(torch, dp_clip_noise, dp_clip_noise_ref):
    """Phase 2: the kernel against its plain version at SHAPES, both
    variants, timed with the instance that ran. Returns (ok, record of the
    main-path shape, max abs err)."""
    ok, main, worst = True, None, 0.0
    for rows, n in SHAPES:
        g, noise, _, sigma = _row_inputs(torch, rows, n, 0)
        for with_noise in (True, False):
            nz = noise if with_noise else None
            y, norm = dp_clip_noise(g, nz, CLIP, sigma)
            wy, wn = dp_clip_noise_ref(g, nz, CLIP, sigma)
            torch.cuda.synchronize()
            err_y = float((y - wy).abs().max())
            err_n = float(((norm - wn).abs() / wn.abs().clamp(min=1e-30))
                          .max())
            good = (bool(torch.allclose(y, wy, atol=1e-6, rtol=1e-5))
                    and err_n <= 1e-5)
            worst = max(worst, err_y)
            rec = _row_times(torch, lambda: dp_clip_noise(g, nz, CLIP, sigma),
                             n, "clip_noise")
            rec["variant"] = dp_clip_noise.last_variant
            good &= _one_kernel_a_call(rec)
            ok &= good
            plain_ms = _time_ms(lambda: dp_clip_noise_ref(g, nz, CLIP, sigma),
                                20 if n > 1_000_000 else 200)
            bound = _bound_ms(rows, n, with_noise)
            print(f"kernel dp_clip_noise ({rows}, {n}) "
                  f"{'noise' if with_noise else 'clip-only'}: "
                  f"max|dy|={err_y:.3e} max rel|dnorm|={err_n:.3e} "
                  f"{'ok' if good else 'MISMATCH'}  "
                  f"{_row_line(rec, plain_ms, bound)}", flush=True)
            if (rows, n) == SHAPES[0] and with_noise:
                main = {"ms": rec["ms"], "plain_ms": plain_ms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "variant": rec["variant"]}
    return ok, main, worst


def check_qsgd_kernel(torch, quantize_decompress, quantize_decompress_ref):
    """Phase 2, quantize_decompress: bit-identical to its plain version at
    SHAPES and QSGD_BITS (y and scale), timed at 8 bits, the comm sweep's,
    with the instance that ran. Returns (ok, record of the main-path shape,
    max abs err)."""
    ok, main, worst = True, None, 0.0
    for rows, n in SHAPES:
        x, _, u, _ = _row_inputs(torch, rows, n, 1)
        for bits in QSGD_BITS:
            y, scale = quantize_decompress(x, u, bits)
            wy, ws = quantize_decompress_ref(x, u, bits)
            torch.cuda.synchronize()
            err = float((y - wy).abs().max())
            good = bool(torch.equal(y, wy)) and bool(torch.equal(scale, ws))
            worst = max(worst, err)
            line = (f"kernel quantize_decompress ({rows}, {n}) bits {bits}: "
                    f"max|dy|={err:.3e} scales "
                    f"{'equal' if bool(torch.equal(scale, ws)) else 'DIFFER'}")
            if bits == 8:
                rec = _row_times(
                    torch, lambda: quantize_decompress(x, u, bits), n,
                    "quantize")
                rec["variant"] = quantize_decompress.last_variant
                good &= _one_kernel_a_call(rec)
                plain_ms = _time_ms(
                    lambda: quantize_decompress_ref(x, u, bits),
                    20 if n > 1_000_000 else 200)
                bound = _qsgd_bound_ms(rows, n)
                line += (f" {'ok' if good else 'MISMATCH'}  "
                         f"{_row_line(rec, plain_ms, bound)}")
                if (rows, n) == SHAPES[0]:
                    main = {"ms": rec["ms"], "plain_ms": plain_ms,
                            "bound_ms": bound[0], "bound_by": bound[1],
                            "variant": rec["variant"]}
            else:
                line += f" {'ok' if good else 'MISMATCH'}"
            ok &= good
            print(line, flush=True)
    return ok, main, worst


def time_row_kernels(src: str) -> int:
    """``python3 chip_smoke.py --time-row-kernels SRC``: time the
    dp_clip_noise (with noise) and quantize_decompress (8 bits) wrappers of
    the port under SRC (this tree's ``src``, or another checkout's, such as
    the parent commit's) at SHAPES on phase 2's inputs, as phase 2 times
    them (every kernel in the profiler's window counts toward a call's
    device time), and counter_rng's as phase 2b times it: the main path's
    (16, 1, 210) draw (normals and uniforms; CUDA events, the device time
    of a launch by torch.profiler and the wrapper's host us a call), 21b's
    slab and its whole row; print the card and one JSON line. Run two
    trees in turns in one chip call to compare them; nothing is checked
    here."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch import configs
    from repro_torch.kernels import counter_rng as crng
    from repro_torch.kernels.dp_clip_noise import dp_clip_noise
    from repro_torch.kernels.quantize_decompress import quantize_decompress
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    out = []
    for rows, n in SHAPES:
        x, z, w, sigma = _row_inputs(torch, rows, n, 0)
        for wrapper, fn, bound in (
                (dp_clip_noise, lambda: dp_clip_noise(x, z, CLIP, sigma),
                 _bound_ms(rows, n, True)),
                (quantize_decompress, lambda: quantize_decompress(x, w, 8),
                 _qsgd_bound_ms(rows, n))):
            rec = _row_times(torch, fn, n, "")
            out.append({"kernel": wrapper.__name__, "shape": [rows, n],
                        "variant": getattr(wrapper, "last_variant", None),
                        "ms": rec["ms"], "device_ms": rec["device_ms"],
                        "kernels": rec["kernels"], "parts": rec["parts"],
                        "host_us": rec["host_us"], "bound_ms": bound[0]})
    key, (rows_n, tau, n) = (0x5EED5EED1234, 7), RNG_MAIN_SHAPE
    rows = torch.arange(rows_n, device="cuda")
    table = torch.tensor(crng.whole_table(n), device="cuda")
    for normal in (True, False):
        def call(normal=normal):
            return crng.counter_rng(rows, table, tau, n, key, crng.NOISE,
                                    normal)
        out.append({"kernel": "counter_rng", "shape": list(RNG_MAIN_SHAPE),
                    "normal": normal, "ms": _time_ms(call, 200),
                    "device_ms": _kernel_device_ms(torch, call, 200,
                                                   "counter_rng"),
                    "host_us": _host_us(torch, call, 2000),
                    "bound_ms": _rng_bound_ms(rows_n, tau, n, normal)[0]})
    shapes, dims, n_whole, n_local = _rng_slab_21b(configs)
    rows2 = torch.arange(2, device="cuda")
    for name, rec in _rng_big_times(
            torch, crng, rows2,
            torch.tensor(crng.slab_table(shapes, dims, 1, MA_SHAPE[1]),
                         device="cuda"),
            torch.tensor(crng.whole_table(n_whole), device="cuda"), n_local,
            n_whole, key).items():
        out.append({"kernel": "counter_rng", "case": f"21b {name}", **rec})
    print(json.dumps({"src": src, "rows": out}), flush=True)
    return 0


def check_cohort_kernel(torch, cohort_gather_scatter, ref, vector_width):
    """Phase 2, cohort_gather_scatter: gather and scatter bitwise equal to
    the plain version (index_select / index_copy_) at COHORT_SHAPES, the
    whole cache compared after a scatter; the kernel's, the plain version's
    and the library call's times beside the bound. Returns (ok, record of
    the main-path shape's gather, max abs err)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    ok, main, worst = True, None, 0.0
    for s, k, d, dtype in COHORT_SHAPES:
        dt = getattr(torch, dtype)
        if dt.is_floating_point:
            cache = torch.randn((s, d), generator=gen, device="cuda").to(dt)
            rows = torch.randn((k, d), generator=gen, device="cuda").to(dt)
        else:
            cache = torch.randint(-2**31, 2**31 - 1, (s, d), generator=gen,
                                  device="cuda", dtype=dt)
            rows = torch.randint(-2**31, 2**31 - 1, (k, d), generator=gen,
                                 device="cuda", dtype=dt)
        slots = torch.randperm(s, generator=gen, device="cuda")[:k]
        got = cohort_gather_scatter(cache, slots)
        want = ref(cache, slots)
        mine, plain = cache.clone(), cache.clone()
        cohort_gather_scatter(mine, slots, rows)
        ref(plain, slots, rows)
        torch.cuda.synchronize()
        err = max(float((got.double() - want.double()).abs().max()),
                  float((mine.double() - plain.double()).abs().max()))
        good = bool(torch.equal(got, want)) and bool(torch.equal(mine,
                                                                 plain))
        del mine, plain
        ok &= good
        worst = max(worst, err)
        # int32 slots (the cohort's own type) go to the kernel as they are
        s32 = slots.to(torch.int32)
        got32 = cohort_gather_scatter(cache, s32)
        mine = cache.clone()
        cohort_gather_scatter(mine, s32, rows)
        torch.cuda.synchronize()
        good32 = bool(torch.equal(got32, want)) and bool(
            torch.equal(mine, ref(cache.clone(), slots, rows)))
        ok &= good32
        del mine
        iters = 20 if d > 1_000_000 else 200
        times = {
            "gather": _time_ms(lambda: cohort_gather_scatter(cache, slots),
                               iters),
            "gather plain": _time_ms(lambda: ref(cache, slots), iters),
            "gather library": _time_ms(
                lambda: torch.index_select(cache, 0, slots), iters),
            "scatter": _time_ms(
                lambda: cohort_gather_scatter(cache, slots, rows), iters),
            "scatter plain": _time_ms(lambda: ref(cache, slots, rows),
                                      iters),
            "scatter library": _time_ms(
                lambda: cache.index_copy_(0, slots, rows), iters),
            "gather int32": _time_ms(
                lambda: cohort_gather_scatter(cache, s32), iters),
            "scatter int32": _time_ms(
                lambda: cohort_gather_scatter(cache, s32, rows), iters)}
        bound_ms, bound_by = _larger_bound(
            2 * k * d * cache.element_size() + 8 * k, 0)
        print(f"kernel cohort_gather_scatter S={s} K={k} D={d} {dtype} "
              f"({vector_width(cache, rows)}-byte copies): gather and "
              f"scatter {'bitwise equal' if good else 'MISMATCH'} (int32 "
              f"slots {'bitwise equal' if good32 else 'MISMATCH'})  "
              + "  ".join(f"{n} {t:.5f} ms" for n, t in times.items())
              + f"  bound {bound_ms:.6f} ms ({bound_by}); library = "
              f"index_select / index_copy_", flush=True)
        if (s, k, d, dtype) == COHORT_SHAPES[0]:
            main = {"ms": times["gather"], "plain_ms": times["gather plain"],
                    "library_ms": times["gather library"],
                    "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"cohort_gather_scatter at the resident driver's shape: "
                  + _cohort_verdict(times), flush=True)
            cohort_in_turns(torch, cohort_gather_scatter, cache, slots, s32,
                            rows, iters)
            cohort_host_steps(torch, cohort_gather_scatter, cache, slots,
                              s32, rows)
    return ok, main, worst


def _cohort_verdict(times) -> str:
    return ", ".join(
        f"{op} {times[op]:.5f} ms against {lib} {times[f'{op} library']:.5f} "
        f"({'met' if times[op] <= times[f'{op} library'] else 'missed'})"
        for op, lib in (("gather", "index_select"),
                        ("scatter", "index_copy_")))


def cohort_in_turns(torch, cohort_gather_scatter, cache, slots, s32, rows,
                    iters):
    """Phase 2: gather and scatter at the resident driver's shape timed in
    turns (library, int64 slots, int32 slots, int32, int64, library), each
    ``_time_ms`` printed: at a few KB a call these read the host's issue
    rate, which drifts within a run. Printed only; the record keeps the
    single ``_time_ms`` of each, as earlier runs took it."""
    turns = {}
    for op, kern, lib in (
            ("gather", lambda sl: cohort_gather_scatter(cache, sl),
             lambda: torch.index_select(cache, 0, slots)),
            ("scatter", lambda sl: cohort_gather_scatter(cache, sl, rows),
             lambda: cache.index_copy_(0, slots, rows))):
        for name in (f"{op} library", op, f"{op} int32", f"{op} int32", op,
                     f"{op} library"):
            sl = s32 if name.endswith("int32") else slots
            fn = lib if name.endswith("library") else (
                lambda sl=sl: kern(sl))
            turns.setdefault(name, []).append(_time_ms(fn, iters))
    print("cohort_gather_scatter at the resident driver's shape in turns: "
          + "  ".join(f"{n} " + " / ".join(f"{t:.5f}" for t in v) + " ms"
                      for n, v in turns.items()), flush=True)


def cohort_host_steps(torch, cohort_gather_scatter, cache, slots, s32,
                      rows, n: int = 4000):
    """Phase 2: host microseconds per call (perf_counter over ``n`` calls,
    no synchronisation) of cohort_gather_scatter's wrapper at the resident
    driver's shape, beside the two ATen calls it is held against; then the
    device time per launch of the gather and of index_select."""
    steps = {
        "wrapper gather": lambda: cohort_gather_scatter(cache, slots),
        "wrapper gather int32": lambda: cohort_gather_scatter(cache, s32),
        "wrapper scatter": lambda: cohort_gather_scatter(cache, slots, rows),
        "index_select": lambda: torch.index_select(cache, 0, slots),
        "index_copy_": lambda: cache.index_copy_(0, slots, rows)}
    us = {name: _host_us(torch, fn, n) for name, fn in steps.items()}
    print("cohort_gather_scatter host us per call (host clock, "
          f"{n} calls): " + "; ".join(f"{k} {v:.3f}" for k, v in us.items()),
          flush=True)
    dev = {name: _kernel_device_ms(torch, steps[name], 200, key)
           for name, key in (("wrapper gather", "copy_rows"),
                             ("index_select", ""))}
    print("cohort_gather_scatter device time per launch (torch.profiler, "
          "200 calls): " + "; ".join(
              f"{k} " + ("not measured" if v is None else f"{v:.5f} ms")
              for k, v in dev.items()), flush=True)


def _host_us(torch, fn, n: int) -> float:
    """Host microseconds per call of ``fn`` (perf_counter over ``n`` calls
    after 100 warm-up calls, no synchronisation inside)."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _rng_bound_ms(rows: int, tau: int, n: int,
                  normal: bool) -> tuple[float, str]:
    """The least time the card could take for a counter_rng draw of (rows,
    tau, n): the larger of its bytes (the output written once) over HBM
    and its operations over their peak rate: the Philox integer ops (one
    call a group of four columns, 80 ops) at INT32_OPS_PER_S, or the
    normal transform's f32 ops at F32_FLOPS_PER_S."""
    from repro_torch.kernels import counter_rng as crng
    ints, f32 = crng.operations(rows, tau, n, normal)
    by_ops = max(ints / INT32_OPS_PER_S, f32 / F32_FLOPS_PER_S) * 1e3
    by_bytes = crng.cost(rows, tau, n, normal)[1] / HBM_BYTES_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def _max_ulps(torch, a, b) -> int:
    """The largest distance in f32 ulps between two f32 tensors (0: equal
    bit for bit; +0 and -0 one apart)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF) - 1, i)
    return int((ordered(a) - ordered(b)).abs().max())


def check_counter_rng(torch, configs, main_shape, card):
    """Phase 2b: the counter_rng kernel against its plain version on the
    card and timed, (a) at the main path's draw ``main_shape`` (clients,
    tau, N), normals and uniforms: uniforms bitwise, normals within
    RNG_ULPS f32 ulps; (b) at 21b's slab: rank 1's (2, 1, N_local) columns
    of gemma3-4b's one-layer widths on a model axis of 2 (its column
    table), against the plain version in windows of RNG_WINDOW columns
    and against its addresses of the whole (2, 1, N) draw on the card,
    bit for bit. Each, and the whole draw, timed against torch.randn at
    the same shape (the yardstick; a different stream) and the bound.
    Returns (ok, record)."""
    from repro_torch.kernels import counter_rng as crng
    from repro_torch.kernels.ref import counter_columns_ref, counter_rng_ref
    ok, rec = True, {}
    key = (0x5EED5EED1234, 7)
    rows_n, tau, n = main_shape
    rows = torch.arange(rows_n, device="cuda")
    table = torch.tensor(crng.whole_table(n), device="cuda")
    worst = 0.0
    for normal in (True, False):
        got = crng.counter_rng(rows, table, tau, n, key, crng.NOISE, normal)
        want = counter_rng_ref(rows, table, tau, n, key, crng.NOISE, normal)
        torch.cuda.synchronize()
        ulps = _max_ulps(torch, got, want)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        good = ulps <= (RNG_ULPS if normal else 0)
        ok &= good
        kind = "normal" if normal else "uniform"

        def call(normal=normal):
            return crng.counter_rng(rows, table, tau, n, key, crng.NOISE,
                                    normal)

        ms = _time_ms(call, 200)
        plain_ms = _time_ms(lambda normal=normal: counter_rng_ref(
            rows, table, tau, n, key, crng.NOISE, normal), 20)
        randn_ms = _time_ms(
            (lambda: torch.randn((rows_n, tau, n), device="cuda"))
            if normal else
            (lambda: torch.rand((rows_n, tau, n), device="cuda")), 200)
        bound = _rng_bound_ms(rows_n, tau, n, normal)
        rec[kind] = {"shape": [rows_n, tau, n], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "torch_ms": randn_ms,
                     "max_ulps": ulps, "max_abs_err": err,
                     "host_us": _host_us(torch, call, 200)}
        print(f"phase 2b counter_rng {kind} {main_shape}: max ulps vs plain "
              f"{ulps} (limit {RNG_ULPS if normal else 0}), max |d| "
              f"{err:.3e}; kernel {ms:.5f} ms ({bound[0] / ms:.1%} of the "
              f"bound), host {rec[kind]['host_us']:.2f} us a call, plain "
              f"{plain_ms:.5f} ms, bound {bound[0]:.7f} ms ({bound[1]}), "
              f"torch.{'randn' if normal else 'rand'} {randn_ms:.5f} ms on "
              f"{card} {'ok' if good else 'CHECK FAILED'}", flush=True)
    # (b) 21b's slab of rank 1, and its addresses of the whole draw
    shapes, dims, n_whole, n_local = _rng_slab_21b(configs)
    slab = torch.tensor(crng.slab_table(shapes, dims, 1, MA_SHAPE[1]),
                        device="cuda")
    whole_t = torch.tensor(crng.whole_table(n_whole), device="cuda")
    rows2 = torch.arange(2, device="cuda")
    got = crng.counter_rng(rows2, slab, 1, n_local, key, crng.NOISE)
    whole = crng.counter_rng(rows2, whole_t, 1, n_whole, key, crng.NOISE)
    torch.cuda.synchronize()
    ulps = same = 0
    windows = range(0, n_local, RNG_WINDOW)
    for lo in windows:
        w = min(RNG_WINDOW, n_local - lo)
        plain = counter_rng_ref(rows2, slab, 1, w, key, crng.NOISE, True,
                                lo=lo)
        ulps = max(ulps, _max_ulps(torch, got[..., lo:lo + w], plain))
        cols = counter_columns_ref(slab, lo, w, "cuda")
        same += int(torch.equal(got[..., lo:lo + w],
                                whole.index_select(2, cols)))
        del plain, cols
    del whole, got
    torch.cuda.empty_cache()
    good = ulps <= RNG_ULPS and same == len(windows)
    ok &= good
    times = _rng_big_times(torch, crng, rows2, slab, whole_t, n_local,
                           n_whole, key)
    rec["slab_21b"] = {**times["slab"], "n_whole": n_whole,
                       "max_ulps": ulps, "windows_equal_whole": same,
                       "windows": len(windows)}
    rec["whole_21b"] = times["whole"]
    print(f"phase 2b counter_rng 21b slab (2, 1, {n_local:,}) of N "
          f"{n_whole:,} (rank 1 of {MA_SHAPE}): max ulps vs plain {ulps} "
          f"(limit {RNG_ULPS}, {len(windows)} windows of {RNG_WINDOW:,}), "
          f"{same} of {len(windows)} windows bit for bit the whole draw's "
          f"columns; " + _rng_big_line(times["slab"])
          + f" on {card} {'ok' if good else 'CHECK FAILED'}", flush=True)
    print(f"phase 2b counter_rng 21b whole draw (2, 1, {n_whole:,}): "
          + _rng_big_line(times["whole"]) + f" on {card}", flush=True)
    rec["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return ok, rec


def _rng_slab_21b(configs):
    """21b's cell for counter_rng: gemma3-4b's one-layer widths (f32) on a
    model axis of MA_SHAPE[1]: (leaf shapes, split dims, N of the whole
    row, N_local of a rank's slab)."""
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.tree import tree_flatten
    one = Transformer(_ma_cfg(configs, "21b")).init(device="meta")
    dims = tree_flatten(sharding.param_split_dims(one, MA_SHAPE[1]))[0]
    shapes = [tuple(x.shape) for x in tree_flatten(one)[0]]
    n_whole = sum(math.prod(sh) for sh in shapes)
    n_local = sum(math.prod(sh) // (MA_SHAPE[1] if d >= 0 else 1)
                  for sh, d in zip(shapes, dims))
    return shapes, dims, n_whole, n_local


def _rng_big_times(torch, crng, rows2, slab, whole_t, n_local, n_whole,
                   key):
    """The normal draws of 21b's slab (2, 1, N_local) and of its whole
    row (2, 1, N) timed by CUDA events (10 calls each), beside their bounds
    and torch.randn at the same shape: {"slab": record, "whole": record}."""
    out = {}
    for name, table, n in (("slab", slab, n_local),
                           ("whole", whole_t, n_whole)):
        ms = _time_ms(lambda table=table, n=n: crng.counter_rng(
            rows2, table, 1, n, key, crng.NOISE), 10)
        torch.cuda.empty_cache()
        randn_ms = _time_ms(lambda n=n: torch.randn((2, 1, n),
                                                    device="cuda"), 10)
        torch.cuda.empty_cache()
        bound = _rng_bound_ms(2, 1, n, True)
        out[name] = {"shape": [2, 1, n], "ms": ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "torch_randn_ms": randn_ms}
    return out


def _rng_big_line(rec) -> str:
    return (f"kernel {rec['ms']:.4f} ms ({rec['bound_ms'] / rec['ms']:.1%} "
            f"of the bound {rec['bound_ms']:.4f} ms, {rec['bound_by']}), "
            f"torch.randn {rec['torch_randn_ms']:.4f} ms")


def main_path_spec(api, linear, data, conv, design, optim):
    """The main path's federation (phases 3-5): Adult-like data split by
    group, the design's K*, tau* and sigmas at full width. Returns (spec,
    the federated data, the design's solution)."""
    fed = data.split_by_group(data.adult_like())
    dim = fed.clients[0].x_train.shape[1]
    consts = conv.ProblemConstants(eta=LR, lam=0.1, lip=0.3, alpha=0.8,
                                   xi2=0.05, dim=2 * dim + 2,
                                   n_clients=fed.n_clients)
    sol = design.DesignProblem(
        consts=consts, resource=design.ResourceModel(c1=100.0, c2=1.0),
        clip_norm=CLIP, batch_sizes=fed.batch_sizes(BATCH), delta=DELTA,
        eps_th=EPS_TH, c_th=C_TH).solve()
    spec = api.FederationSpec(
        n_clients=fed.n_clients, tau=sol.tau, loss_fn=linear.logreg_loss,
        optimizer=optim.sgd(LR), clip_norm=CLIP, dp=True, engine="vmap",
        sigmas=tuple(float(s) for s in sol.sigmas),
        batch_sizes=tuple(fed.batch_sizes(BATCH)), eps_th=EPS_TH,
        delta=DELTA, c_th=C_TH)
    return spec, fed, sol


def run_main_path(torch, np, api, linear, data, conv, design, optim,
                  dp_clip_noise):
    """Phase 3: the quickstart flow at full width, until a budget binds."""
    spec, fed, sol = main_path_spec(api, linear, data, conv, design, optim)
    dim = fed.clients[0].x_train.shape[1]
    xt, yt = fed.eval_arrays("test")
    eval_fn = linear.make_eval_fn(linear.logreg_loss, xt, yt)
    state = api.init_state(spec, linear.init_linear(dim, device="cuda"),
                           device="cuda")
    init_eval = eval_fn(api.eval_params(spec, state))
    planned, _ = api.rounds_within_budgets(spec, state, 10_000)
    from repro_torch.kernels.counter_rng import counter_rng
    torch.cuda.synchronize()
    dp_clip_noise.launches = counter_rng.launches = 0
    t0 = time.perf_counter()
    state, out = api.train(spec, state, fed.make_sampler(BATCH),
                           eval_fn=eval_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dp_clip_noise.launches
    rng_launches = counter_rng.launches
    rounds = out["rounds"]
    majority = max(float(np.mean(yt)), 1.0 - float(np.mean(yt)))
    best = out["best"]
    binds = api.exceeds_budgets(spec, state)
    finite = all(bool(torch.isfinite(x).all())
                 for x in state.params.values())
    print(f"main path: adult_like() n={sum(c.n_train for c in fed.clients)} "
          f"train rows, {fed.n_clients} clients, d={dim}, "
          f"N={2 * dim + 2} params/client, batch {BATCH}; design K*={sol.k} "
          f"tau*={sol.tau} sigma*={sol.sigmas[0]:.4f}", flush=True)
    print(f"main path: rounds={rounds} (planned by the budgets {planned}) "
          f"max_epsilon={out['max_epsilon']:.6f} (budget {EPS_TH}) "
          f"resource_spent={out['resource_spent']} (budget {C_TH}) "
          f"binds={binds}", flush=True)
    print(f"main path: eval loss {init_eval['eval_loss']:.5f} -> "
          f"{best.get('eval_loss', float('nan')):.5f} (best, round "
          f"{best['round']}), best acc {best.get('eval_acc', 0.0):.4f}, "
          f"test majority-class rate {majority:.4f}", flush=True)
    print(f"main path: ms_per_round={wall / max(rounds, 1) * 1e3:.3f} (train "
          f"loop wall / rounds; host batches, eval and first-call costs "
          f"included) launches={launches} expected={sol.tau * rounds} (one "
          f"call a local step); counter_rng launches={rng_launches} "
          f"expected {rounds} (one (16, tau, 210) noise draw a round)",
          flush=True)
    ok = (rounds > 0 and rounds == planned and finite and binds is not None
          and out["max_epsilon"] <= EPS_TH + 1e-6
          and out["resource_spent"] <= C_TH
          and best.get("eval_loss", float("inf")) < init_eval["eval_loss"]
          and launches == sol.tau * rounds and rng_launches == rounds)
    return ok, (launches, rng_launches), spec, fed


def compare_backends(torch, np, api, linear, spec, fed):
    """Phase 4: 3 rounds on "auto" (the kernel) and on "ref" (its plain
    version) from one seed; the generator streams are the same."""
    finals = []
    for backend in ("auto", "ref"):
        s = spec.replace(kernel_backend=backend)
        state = api.init_state(s, linear.init_linear(
            fed.clients[0].x_train.shape[1], device="cuda"), device="cuda")
        rng = np.random.default_rng(1)
        for _ in range(3):
            state, _ = api.run_round(s, state, api.round_batch(
                s, fed.make_sampler(BATCH), rng), check_budgets=False)
        finals.append(state.params)
    torch.cuda.synchronize()
    diff = max(float((finals[0][k] - finals[1][k]).abs().max())
               for k in finals[0])
    print(f"auto vs ref, 3 rounds: max|dparams|={diff:.3e} (limit 1e-5)",
          flush=True)
    return diff <= 1e-5


def profile_rounds(torch, np, api, linear, spec, fed, label, n_timed=20):
    """Phase 5 (and the end of phase 6): steady per-round time of ``spec``'s
    round (batches built beforehand), then device time by kernel over 3
    rounds; ``label`` starts each line. Returns whether every round left
    finite params."""
    state = api.init_state(spec, linear.init_linear(
        fed.clients[0].x_train.shape[1], device="cuda"), device="cuda")
    rng = np.random.default_rng(2)
    batches = [api.round_batch(spec, fed.make_sampler(BATCH), rng)
               for _ in range(n_timed + 5)]
    for b in batches[:2]:
        state, _ = api.run_round(spec, state, b, check_budgets=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:2 + n_timed]:
        state, _ = api.run_round(spec, state, b, check_budgets=False)
    torch.cuda.synchronize()
    per_round = (time.perf_counter() - t0) * 1e3 / n_timed
    print(f"{label}: steady round (tau={spec.tau}, batches prebuilt, no "
          f"eval): {per_round:.3f} ms/round over {n_timed} rounds",
          flush=True)

    def last_rounds():
        st = state
        for b in batches[-3:]:
            st, _ = api.run_round(spec, st, b, check_budgets=False)
        return st

    state, _ = _profile_call(torch, last_rounds,
                             f"{label}: profile, 3 rounds")
    finite = all(bool(torch.isfinite(x).all()) for x in state.params.values())
    print(f"{label}: {n_timed + 5} rounds, params finite: {finite}",
          flush=True)
    return finite


def _sweep_spec(api, linear, optim, fl, fed, q, compressor, ratio):
    """benchmarks/common.run_dp_pasgd's spec for one comm-sweep row: tau 5,
    K 100, eps_th 10, C_th 10 K (c1/tau + c2) that never binds."""
    x_m = fed.batch_sizes(BATCH)
    return api.FederationSpec(
        n_clients=fed.n_clients, tau=SWEEP_TAU, loss_fn=linear.logreg_loss,
        optimizer=optim.sgd(LR), clip_norm=CLIP, dp=True, participation=q,
        compressor=compressor, compression_ratio=ratio, compression_bits=8,
        sigmas=tuple(float(s) for s in fl.design_sigmas(
            SWEEP_K, CLIP, x_m, SWEEP_EPS, DELTA)),
        batch_sizes=tuple(x_m), eps_th=SWEEP_EPS, delta=DELTA,
        c_th=10 * SWEEP_K * (100.0 / SWEEP_TAU + 1.0), c1=100.0, c2=1.0,
        seed=0)


def run_comm_sweep(torch, np, api, linear, data, optim, fl, dp_clip_noise,
                   quantize_decompress):
    """Phase 6: the four comm-sweep rows at full width on cuda, each trained
    for K / tau rounds or until privacy binds, with eval every round.
    Returns (ok, the qsgd row's quantize_decompress launches, Adult-2)."""
    fed = data.split_iid(data.adult_like(seed=0), 16)
    dim = fed.clients[0].x_train.shape[1]
    xt, yt = fed.eval_arrays("test")
    eval_fn = linear.make_eval_fn(linear.logreg_loss, xt, yt)
    ok, qsgd_launches = True, 0
    for label, q, compressor, ratio in PIPELINES:
        spec = _sweep_spec(api, linear, optim, fl, fed, q, compressor,
                           ratio)
        state = api.init_state(spec, linear.init_linear(dim, device="cuda"),
                               device="cuda")
        init_loss = eval_fn(api.eval_params(spec, state))["eval_loss"]
        torch.cuda.synchronize()
        dp_clip_noise.launches = quantize_decompress.launches = 0
        t0 = time.perf_counter()
        state, out = api.train(spec, state, fed.make_sampler(BATCH),
                               max_rounds=SWEEP_K // SWEEP_TAU,
                               eval_fn=eval_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        clip_launches = dp_clip_noise.launches
        q_launches = quantize_decompress.launches
        rounds, best = out["rounds"], out["best"]
        participants = sorted({r["participants"] for r in out["history"]})
        print(f"comm sweep {label}: rounds={rounds} "
              f"resource_spent={out['resource_spent']} "
              f"max_epsilon={out['max_epsilon']:.6f} participants per round "
              f"{participants} eval loss {init_loss:.5f} -> "
              f"{best['eval_loss']:.5f} (best, round {best['round']}) best "
              f"acc {best['eval_acc']:.4f} ms_per_round="
              f"{wall / max(rounds, 1) * 1e3:.3f} (train loop wall / rounds,"
              f" eval included) launches dp_clip_noise={clip_launches} "
              f"quantize_decompress={q_launches}", flush=True)
        good = (clip_launches == SWEEP_TAU * rounds
                and best["eval_loss"] < init_loss
                and all(bool(torch.isfinite(x).all())
                        for x in state.params.values()))
        if q == 1.0:
            good &= (rounds == 19
                     and round(out["max_epsilon"], 6) == 9.701942
                     and out["resource_spent"] == {"none": 1995.0,
                                                   "topk": 570.0}[compressor])
        else:
            good &= (rounds == 20 and out["resource_spent"] == 350.0
                     and participants == [8.0]
                     and out["max_epsilon"] <= SWEEP_EPS)
        if compressor == "qsgd":
            good &= q_launches == rounds
            qsgd_launches = q_launches
        else:
            good &= q_launches == 0
        ok &= good
        if not good:
            print(f"comm sweep {label}: CHECK FAILED", flush=True)
    return ok, qsgd_launches, fed


def compare_qsgd_routes(torch, np, api, linear, optim, fl, fed):
    """Phase 7: three qsgd8_q50 rounds on "auto" (both kernels) and on "ref"
    (their plain versions) from one seed. Without DP the QSGD kernel is the
    only difference, so params and residual must be bitwise equal. With DP,
    dp_clip_noise's FMA rounding can flip a stochastic-rounding level: each
    round runs both routes from the same state, and every param gap must be
    within the flipped levels' residual jumps / P + 1e-5."""
    dim = fed.clients[0].x_train.shape[1]
    spec = _sweep_spec(api, linear, optim, fl, fed, 0.5, "qsgd", 0.25)
    n_p = spec.participants_per_round()

    def flat(params):
        return torch.cat([params[k][0].reshape(-1) for k in sorted(params)])

    finals = []
    for backend in ("auto", "ref"):
        s = spec.replace(dp=False, kernel_backend=backend)
        state = api.init_state(s, linear.init_linear(dim, device="cuda"),
                               device="cuda")
        rng = np.random.default_rng(1)
        for _ in range(3):
            state, _ = api.run_round(s, state, api.round_batch(
                s, fed.make_sampler(BATCH), rng), check_budgets=False)
        finals.append(state)
    torch.cuda.synchronize()
    same = (all(torch.equal(finals[0].params[k], finals[1].params[k])
                for k in finals[0].params)
            and torch.equal(finals[0].residual, finals[1].residual))
    print(f"qsgd8_q50 auto vs ref, dp=False, 3 rounds: params and residual "
          f"bitwise {'equal' if same else 'DIFFERENT'}", flush=True)
    ok = same
    auto, ref = spec, spec.replace(kernel_backend="ref")
    state = api.init_state(auto, linear.init_linear(dim, device="cuda"),
                           device="cuda")
    rng = np.random.default_rng(1)
    for r in range(3):
        batch = api.round_batch(auto, fed.make_sampler(BATCH), rng)
        sa, _ = api.run_round(auto, state, batch, check_budgets=False)
        sr, _ = api.run_round(ref, state, batch, check_budgets=False)
        dres = (sa.residual - sr.residual).abs()
        flipped = dres > 1e-5
        dparams = (flat(sa.params) - flat(sr.params)).abs()
        allowed = (dres * flipped).sum(dim=0) / n_p + 1e-5
        good = bool((dparams <= allowed).all())
        ok &= good
        print(f"qsgd8_q50 auto vs ref, dp=True, round {r + 1} from one "
              f"state: max|dparams|={float(dparams.max()):.3e} "
              f"max|dresidual|={float(dres.max()):.3e} flipped "
              f"coordinates={int(flipped.sum())} "
              f"{'ok' if good else 'UNEXPLAINED GAP'}", flush=True)
        state = sa
    return ok


def _same_params(torch, a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def run_population_m_equals_c(torch, api, linear, optim, fl, pop_mod, fed,
                              cohort_gather_scatter):
    """Phase 8: Adult-2 as an M == C = 16 population with the topk25_q100
    spec, per round and resident (chunk 4, S = 16), against a dense train
    of the same spec and seed. The resident run's kernel launches: 2 per
    chunked round (residual gather + scatter) over 4 chunks of 4, 1 per
    chunk (the FLState's residual view), 1 for the first chunk's promotion
    and 1 for the flush before the 3-round budget tail."""
    dim = fed.clients[0].x_train.shape[1]
    spec = _sweep_spec(api, linear, optim, fl, fed, 1.0, "topk", 0.25)
    dense, dout = api.train(spec, api.init_state(
        spec, linear.init_linear(dim, device="cuda"), device="cuda"),
        fed.make_sampler(BATCH), max_rounds=SWEEP_K // SWEEP_TAU)
    pspec = spec.replace(population=fed.n_clients, cohort_size=fed.n_clients)
    pop = pop_mod.population_from_federated(fed, BATCH)
    ok = True
    for label, kw, launches_want in (
            ("per round", dict(chunk_rounds=1), 0),
            ("resident chunk 4 S 16", dict(chunk_rounds=4,
                                           resident_cache=16),
             2 * 16 + 4 + 1 + 1)):
        ps = pop_mod.init_population_state(
            pspec, linear.init_linear(dim, device="cuda"), device="cuda")
        torch.cuda.synchronize()
        cohort_gather_scatter.launches = 0
        t0 = time.perf_counter()
        ps, out = pop_mod.train_population(
            pspec, ps, pop, max_rounds=SWEEP_K // SWEEP_TAU, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cohort_gather_scatter.launches
        same = _same_params(torch, ps.fl.params, dense.params)
        stats = out.get("resident_cache")
        good = (out["rounds"] == dout["rounds"] == 19
                and out["resource_spent"] == dout["resource_spent"] == 570.0
                and out["max_epsilon"] == dout["max_epsilon"]
                == 9.701942456923485
                and same and launches == launches_want
                and stats in (None, {"hits": 48, "misses": 16,
                                     "evictions": 0, "flushes": 2}))
        ok &= good
        print(f"population M=C=16 {label}: rounds={out['rounds']} "
              f"resource_spent={out['resource_spent']} "
              f"max_epsilon={out['max_epsilon']!r} params vs dense train "
              f"{'bitwise equal' if same else 'DIFFERENT'} cache {stats} "
              f"cohort_gather_scatter launches={launches} (expected "
              f"{launches_want}) ms_per_round="
              f"{wall / max(out['rounds'], 1) * 1e3:.3f} (no eval) "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    return ok


def _quickstart_spec(api, linear, optim):
    return api.FederationSpec(
        n_clients=QS_K, tau=QS_TAU, loss_fn=linear.logreg_loss,
        optimizer=optim.sgd(0.3), clip_norm=1.0, dp=True,
        population=QS_M, cohort_size=QS_K, compressor="topk",
        compression_ratio=0.25, sigmas=(QS_SIGMA,) * QS_K,
        batch_sizes=(QS_BATCH,) * QS_K, eps_th=1e9, c_th=1e9)


def run_quickstart_resident(torch, np, api, linear, optim, pop_mod,
                            cohort_gather_scatter):
    """Phase 9: examples/population_quickstart.py's resident step on cuda
    against 24 per-round calls. Returns (ok, launches); the launch formula
    is :func:`_qs_gathers`."""
    spec = _quickstart_spec(api, linear, optim)
    pop = pop_mod.synthetic_population(QS_M, dim=QS_DIM,
                                       batch_size=QS_BATCH, alpha=0.3,
                                       seed=0, stationary=True)
    want = _qs_gathers()
    rs = pop_mod.init_population_state(
        spec, linear.init_linear(QS_DIM, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    cohort_gather_scatter.launches = 0
    rs, out = pop_mod.train_population(spec, rs, pop, max_rounds=QS_ROUNDS,
                                       chunk_rounds=QS_CHUNK,
                                       resident_cache=QS_CACHE)
    torch.cuda.synchronize()
    launches = cohort_gather_scatter.launches
    ps = pop_mod.init_population_state(
        spec, linear.init_linear(QS_DIM, device="cuda"), device="cuda")
    rng = np.random.default_rng(0)
    for _ in range(QS_ROUNDS):
        ps, _ = pop_mod.run_cohort_round(spec, ps, pop, rng,
                                         check_budgets=False)
    torch.cuda.synchronize()
    vids = np.arange(QS_M)
    same = (_same_params(torch, ps.fl.params, rs.fl.params)
            and np.array_equal(ps.store.rho, rs.store.rho)
            and np.array_equal(ps.store.gather_residual(vids),
                               rs.store.gather_residual(vids)))
    finite = all(bool(torch.isfinite(x).all())
                 for x in rs.fl.params.values())
    stats = out["resident_cache"]
    hist = out["history"]
    ok = (same and finite and out["rounds"] == QS_ROUNDS
          and out["max_epsilon"] == 4.729618937506673
          and out["resource_spent"] == 720.0
          and stats == {"hits": 1, "misses": 382, "evictions": 126,
                        "flushes": 1}
          and rs.store.residual_rows() == 382 and launches == want)
    print(f"population quickstart resident (M={QS_M:,}, K={QS_K}, "
          f"S={QS_CACHE}, chunk {QS_CHUNK}): rounds={out['rounds']} "
          f"max_epsilon={out['max_epsilon']!r} "
          f"resource_spent={out['resource_spent']} cache {stats} residual "
          f"rows {rs.store.residual_rows()} loss {hist[0]['loss']:.5f} -> "
          f"{hist[-1]['loss']:.5f}; params, store.rho and every residual "
          f"row vs {QS_ROUNDS} run_cohort_round calls "
          f"{'bitwise equal' if same else 'DIFFERENT'}; "
          f"cohort_gather_scatter launches={launches} (expected {want}) "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    return ok, launches, spec, pop


def time_population_drivers(torch, linear, pop_mod, spec, pop):
    """Phase 9: ms per round, eval off, of the per-round, chunk-boundary
    (chunk 8) and resident (chunk 8, S 256) drivers, each training 24
    rounds from a fresh state, in turns A B C C B A within this call."""
    drivers = {"per-round": dict(chunk_rounds=1),
               "chunk-boundary": dict(chunk_rounds=QS_CHUNK),
               "resident": dict(chunk_rounds=QS_CHUNK,
                                resident_cache=QS_CACHE)}
    order = list(drivers) + list(drivers)[::-1]
    times = {k: [] for k in drivers}
    for name in order:
        ps = pop_mod.init_population_state(
            spec, linear.init_linear(QS_DIM, device="cuda"), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ps, out = pop_mod.train_population(spec, ps, pop,
                                           max_rounds=QS_ROUNDS,
                                           **drivers[name])
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / out["rounds"])
    print("population drivers, ms per round over 24 rounds (eval off; "
          "turns per-round, chunk-boundary, resident, resident, "
          "chunk-boundary, per-round): " + "; ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in times.items()),
          flush=True)


def profile_resident_chunk(torch, np, linear, pop_mod, spec, pop):
    """Phase 9: one steady resident chunk (the third of the run: 8 rounds,
    128 promotions, evictions) under torch.profiler, then the next chunk
    under torch.cuda.set_sync_debug_mode("warn") to count its blocking host
    syncs. Returns whether the chunks left finite params."""
    st = pop_mod.init_population_state(
        spec, linear.init_linear(QS_DIM, device="cuda"), device="cuda")
    cache = pop_mod.init_resident_cache(spec, st, QS_CACHE, population=pop)
    rng = np.random.default_rng(0)

    def chunk(st):
        return pop_mod.run_resident_rounds(spec, st, pop, rng, cache,
                                           n_rounds=QS_CHUNK,
                                           check_budgets=False)[0]

    for _ in range(2):
        st = chunk(st)
    torch.cuda.synchronize()
    label = f"phase 9 resident chunk ({QS_CHUNK} rounds)"
    st, n_launch = _profile_call(torch, lambda: chunk(st), label)
    if n_launch is not None:
        print(f"{label}: {n_launch / QS_CHUNK:.1f} launches per round",
              flush=True)
    st, syncs = _blocking_syncs(torch, lambda: chunk(st))
    print(f"phase 9 resident chunk under set_sync_debug_mode: "
          f"{len(syncs)} blocking host syncs" + _sync_lines(syncs),
          flush=True)
    return (all(bool(torch.isfinite(x).all()) for x in st.fl.params.values())
            and not syncs)


def _blocking_syncs(torch, fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("warn"): (its result,
    one entry per blocking host sync it made, naming the innermost
    repro_torch line it came from)."""
    syncs = []

    def record(message, *args, **kwargs):
        # each blocking call warns once; keep the innermost repro_torch line
        # it came from
        if "called a synchronizing CUDA operation" in str(message):
            ours = [f for f in traceback.extract_stack()[:-1]
                    if "repro_torch" in f.filename]
            syncs.append(f"{Path(ours[-1].filename).name}:{ours[-1].lineno}"
                         if ours else "outside repro_torch")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, syncs


def _sync_lines(syncs) -> str:
    return "".join(f"\n  x{syncs.count(o)} {o}" for o in sorted(set(syncs)))


# -- phases 10-12: the transformer serving path -------------------------------

def _visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs causal attention with ``window`` (0: none)
    computes over S tokens."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _peak(dtype, torch) -> tuple[float, str]:
    return ((BF16_FLOPS_PER_S, "bf16 tensor cores") if dtype == torch.bfloat16
            else (F32_FLOPS_PER_S, "f32"))


def _flash_bound(torch, b, h, s, hd, window, dtype):
    """Bytes: q, k, v read once, the output written once. Operations: per
    visible (query, key) pair 2 hd for the score and 2 hd for P.V."""
    item = torch.finfo(dtype).bits // 8
    peak, _ = _peak(dtype, torch)
    return _larger_bound(4 * b * h * s * hd * item,
                         4 * hd * b * h * _visible_pairs(s, window), peak)


def _rwkv_bound(torch, b, h, s, hd, with_s0, dtype):
    """Bytes: r, k, v (and y) in the inputs' dtype, w f32, u, s0 and the
    final state f32, each once. Operations: 7 hd^2 per token and head."""
    item = torch.finfo(dtype).bits // 8
    n = b * h * s * hd
    nbytes = (4 * item + 4) * n + 4 * h * hd + 4 * b * h * hd * hd * (
        2 if with_s0 else 1)
    return _larger_bound(nbytes, 7 * hd * hd * b * h * s,
                         _peak(dtype, torch)[0])


def _ssd_bound(torch, b, s, h, p, n, q, dtype):
    """Bytes: x and y in the inputs' dtype, b and c (B, S, N) once, dt, a
    and the final state f32. Operations per chunk and head: the scores and
    M @ x over the Q (Q + 1) / 2 pairs (2 N + 2 P each), the state's
    contribution and the state update (2 Q P N each)."""
    item = torch.finfo(dtype).bits // 8
    nbytes = (item * (2 * b * s * h * p + 2 * b * s * n)
              + 4 * (b * s * h + h + b * h * p * n))
    per_chunk = q * (q + 1) // 2 * (2 * n + 2 * p) + 4 * q * p * n
    return _larger_bound(nbytes, per_chunk * (s // q) * b * h,
                         _peak(dtype, torch)[0])


def _profiled_kernels(torch, fn, iters: int, name: str):
    """The profiler's averages of the kernels whose name holds ``name`` over
    ``iters`` calls of ``fn`` (empty where it shows none), or None where
    the profiler is unavailable (a measurement, not a check)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and name in e.key
                and e.device_time_total > 0]
    except Exception as e:        # noqa: BLE001 — the profiler is optional
        print(f"profile of {name} unavailable ({e!r})", flush=True)
        return None


def _kernel_device_ms(torch, fn, iters: int, name: str):
    """Mean device time of one launch of the kernels whose name holds
    ``name`` over ``iters`` calls of ``fn``, by torch.profiler: the
    kernel's own time, free of the host's issue rate that ``_time_ms``
    reads when a call is short. None where the profiler shows no such
    kernel."""
    events = _profiled_kernels(torch, fn, iters, name)
    count = sum(e.count for e in events or ())
    return (sum(e.device_time_total for e in events) / 1e3 / count
            if count else None)


def _kernel_label(key: str) -> str:
    """A profiler kernel name without its namespace, template arguments and
    parameters ("void (anonymous namespace)::wkv_chunk_out<64>(...)" ->
    "wkv_chunk_out")."""
    found = re.search(r"::(\w+)[<(]", key)
    return found.group(1) if found else key[:40]


def _call_device_ms(torch, fn, iters: int, name: str):
    """Mean device time of one call of ``fn`` over ``iters`` calls, by
    torch.profiler: every kernel whose name holds ``name``, summed over the
    run and divided by the calls (not by the kernels, so a call that runs
    three kernels reads as their sum). Returns (ms per call, "kernel ms,
    ..." per call of each such kernel, kernels per call), or (None, "",
    None) where the profiler shows no such kernel."""
    events = _profiled_kernels(torch, fn, iters, name)
    if not events:
        return None, "", None
    parts = ", ".join(
        f"{_kernel_label(e.key)} {e.device_time_total / 1e3 / iters:.5f}"
        for e in events)
    return (sum(e.device_time_total for e in events) / 1e3 / iters, parts,
            sum(e.count for e in events) / iters)


def _sdpa_backend(torch, q, k, v, mask, causal) -> str:
    """The backend torch's scaled_dot_product_attention picks for these
    inputs (for the yardstick's label only)."""
    names = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}
    try:
        choice = int(torch._fused_sdp_choice(q, k, v, mask, 0.0, causal))
    except Exception as e:        # noqa: BLE001 — a label, not a check
        return f"unknown ({type(e).__name__})"
    return names.get(choice, f"backend {choice}")


def _kernel_err(torch, got, want, dtype):
    """(max |got - want|, within tolerance): atol 1e-5 of the output's
    largest magnitude (sums in another order), rtol 1e-4 in f32 and 8e-3
    (two bf16 ulps) where the output is rounded to bf16."""
    want = want.float()
    err = (got.float() - want).abs()
    scale = max(1.0, float(want.abs().max()))
    rtol = 1e-4 if dtype == torch.float32 else 8e-3
    ok = bool((err <= 1e-5 * scale + rtol * want.abs()).all())
    return float(err.max()), ok


def check_model_kernels(torch, kernels, refs):
    """Phase 10: flash_attention, rwkv6_scan and mamba2_ssd against their
    plain versions at the serving path's shapes and a ragged small one, in
    f32 and in bf16 (the bf16 kernel against the plain version run in f32
    on the same bf16 values), each timed (kernel, plain version, and for
    flash the library yardstick) beside its bound. Returns (ok, {name:
    record at its main shape}, {name: max abs err})."""
    import torch.nn.functional as F
    flash, rwkv, ssd = kernels
    flash_ref, rwkv_ref, ssd_ref = refs
    gen = torch.Generator(device="cuda").manual_seed(10)
    ok, recs, worst = True, {}, {"flash_attention": 0.0, "rwkv6_scan": 0.0,
                                 "mamba2_ssd": 0.0}

    def report(name, label, dtype, err, good, timed, bound, extra=""):
        nonlocal ok
        ok &= good
        worst[name] = max(worst[name], err)
        line = (f"kernel {name} {label} {str(dtype).split('.')[1]}: "
                f"max|d|={err:.3e} {'ok' if good else 'MISMATCH'}")
        if timed is not None:
            line += (f"  kernel {timed[0]:.5f} ms  plain {timed[1]:.5f} ms  "
                     f"bound {bound[0]:.6f} ms ({bound[1]}){extra}")
        print(line, flush=True)

    for b, h, s, hd, window in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, h, s, hd), generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(3))
            got = flash(q, k, v, window=window)
            variant = flash.last_variant
            want = flash_ref(q.float(), k.float(), v.float(), window=window)
            torch.cuda.synchronize()
            err, good = _kernel_err(torch, got, want, dtype)
            del want
            timed = bound = None
            extra = ""
            if s >= 512:
                iters = 10 if s >= 2048 else 30
                timed = (_time_ms(lambda: flash(q, k, v, window=window),
                                  iters),
                         _time_ms(lambda: flash_ref(q, k, v, window=window),
                                  iters))
                bound = _flash_bound(torch, b, h, s, hd, window, dtype)
                if window:
                    pos = torch.arange(s, device="cuda")
                    mask = ((pos[None, :] <= pos[:, None])
                            & (pos[None, :] > pos[:, None] - window))
                    lib = lambda: F.scaled_dot_product_attention(  # noqa
                        q, k, v, attn_mask=mask)
                    backend = _sdpa_backend(torch, q, k, v, mask, False)
                else:
                    mask = None
                    lib = lambda: F.scaled_dot_product_attention(  # noqa
                        q, k, v, is_causal=True)
                    backend = _sdpa_backend(torch, q, k, v, None, True)
                lib_ms = _time_ms(lib, iters)
                extra = (f"  library scaled_dot_product_attention "
                         f"({backend} backend"
                         f"{', boolean window mask' if window else ''}) "
                         f"{lib_ms:.5f} ms")
                if (s, hd, window) == (2048, 256, 1024) and \
                        dtype == torch.bfloat16:
                    recs["flash_attention"] = {
                        "ms": timed[0], "plain_ms": timed[1],
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": lib_ms, "variant": variant}
            report("flash_attention", f"({b}, {h}, {s}, {hd}) window "
                   f"{window} [{variant}]", dtype, err, good, timed, bound,
                   extra)
            del q, k, v, got

    for b, h, s, hd, with_s0 in RWKV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            r, k, v = (torch.randn((b, h, s, hd), generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(3))
            w = torch.sigmoid(torch.randn((b, h, s, hd), generator=gen,
                                          device="cuda"))
            u = torch.randn((h, hd), generator=gen, device="cuda")
            s0 = (torch.randn((b, h, hd, hd), generator=gen, device="cuda")
                  if with_s0 else None)
            y, st = rwkv(r, k, v, w, u, s0)
            variant = rwkv.last_variant
            wy, ws = rwkv_ref(r.float(), k.float(), v.float(), w, u, s0)
            torch.cuda.synchronize()
            e1, g1 = _kernel_err(torch, y, wy, dtype)
            e2, g2 = _kernel_err(torch, st, ws, torch.float32)
            del wy, ws
            timed = bound = None
            extra = "  library: none (no single PyTorch call computes it)"
            if h == 32:
                iters = 10 if s >= 2048 else 30
                timed = (_time_ms(lambda: rwkv(r, k, v, w, u, s0), iters),
                         _time_ms(lambda: rwkv_ref(r, k, v, w, u, s0),
                                  (1 if s >= 2048 else 3) if s > 1 else 30))
                bound = _rwkv_bound(torch, b, h, s, hd, with_s0, dtype)
                dev_ms, parts, _ = _call_device_ms(
                    torch, lambda: rwkv(r, k, v, w, u, s0), 20, "wkv")
                host_us = _host_us(
                    torch, lambda: rwkv(r, k, v, w, u, s0),
                    50 if s >= 2048 else 200)
                extra = (f"  ({bound[0] / timed[0]:.1%} of the bound; "
                         f"device time per call (its kernels summed) "
                         + ("not measured" if dev_ms is None
                            else f"{dev_ms:.5f} ms ({parts})")
                         + f" by torch.profiler over 20 calls; the "
                         f"wrapper's host time {host_us:.2f} us per call)"
                         + extra)
                if (b, s) == (2, 512) and dtype == torch.bfloat16:
                    recs["rwkv6_scan"] = {
                        "ms": timed[0], "plain_ms": timed[1],
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": None, "variant": variant}
            report("rwkv6_scan", f"({b}, {h}, {s}, {hd})"
                   f"{' from s0' if with_s0 else ''} [{variant}]", dtype,
                   max(e1, e2), g1 and g2, timed, bound, extra)
            del r, k, v, w, u, s0, y, st

    for b, s, h, p, n, q in SSD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, s, h, p), generator=gen, device="cuda")
            dt = F.softplus(torch.randn((b, s, h), generator=gen,
                                        device="cuda"))
            a = -torch.exp(0.3 * torch.randn((h,), generator=gen,
                                             device="cuda"))
            b_in, c_in = (torch.randn((b, s, n), generator=gen,
                                      device="cuda") for _ in range(2))
            x, b_in, c_in = (t.to(dtype) for t in (x, b_in, c_in))
            y, st = ssd(x, dt, a, b_in, c_in, chunk=q)
            variant = ssd.last_variant
            wy, ws = ssd_ref(x.float(), dt, a, b_in.float(), c_in.float(),
                             min(q, s))
            torch.cuda.synchronize()
            e1, g1 = _kernel_err(torch, y, wy, dtype)
            e2, g2 = _kernel_err(torch, st, ws, torch.float32)
            del wy, ws
            timed = bound = None
            extra = "  library: none (no single PyTorch call computes it)"
            if s >= 512:
                timed = (_time_ms(lambda: ssd(x, dt, a, b_in, c_in, chunk=q),
                                  20),
                         _time_ms(lambda: ssd_ref(x, dt, a, b_in, c_in, q),
                                  5))
                bound = _ssd_bound(torch, b, s, h, p, n, q, dtype)
                dev_ms = _kernel_device_ms(
                    torch, lambda: ssd(x, dt, a, b_in, c_in, chunk=q), 20,
                    "ssd_tc" if variant == "tc" else "ssd_fwd")
                host_us = _host_us(
                    torch, lambda: ssd(x, dt, a, b_in, c_in, chunk=q), 200)
                extra = (f"  ({bound[0] / timed[0]:.1%} of the bound; "
                         f"device time per launch "
                         + ("not measured" if dev_ms is None
                            else f"{dev_ms:.5f} ms")
                         + f" by torch.profiler over 20 calls; the "
                         f"wrapper's host time {host_us:.2f} us per call)"
                         + extra)
                if (b, s) == (2, 512) and dtype == torch.bfloat16:
                    recs["mamba2_ssd"] = {
                        "ms": timed[0], "plain_ms": timed[1],
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": None, "variant": variant}
            report("mamba2_ssd", f"x ({b}, {s}, {h}, {p}) N {n} chunk {q} "
                   f"[{variant}]", dtype, max(e1, e2), g1 and g2, timed,
                   bound, extra)
            del x, dt, a, b_in, c_in, y, st
    return ok, recs, worst


def _rope_angles_host_tensor(positions, head_dim: int, theta: float):
    """rope_angles as the port built it before: the base as a host tensor,
    a pageable copy to the device on every attention call."""
    import torch
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def check_rope_on_the_card(torch, configs) -> bool:
    """Phase 11: rope_angles bitwise equal to the host-tensor formula on
    the card, for every config's rope_theta and head dim, at decode (B,)
    and prefill (B, S) positions."""
    from repro_torch.models.layers import rope_angles
    positions = (torch.arange(0, 8192, 37, device="cuda"),
                 torch.arange(2 * 2048, device="cuda",
                              dtype=torch.int32).reshape(2, 2048))
    same = True
    for arch in configs.ASSIGNED_ARCHS:
        cfg = configs.get_arch(arch)
        for pos in positions:
            got = rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta)
            want = _rope_angles_host_tensor(pos, cfg.resolved_head_dim,
                                            cfg.rope_theta)
            same &= all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    print(f"rope_angles on the card, {len(configs.ASSIGNED_ARCHS)} configs' "
          f"theta and head dim, decode and prefill positions: "
          f"{'bitwise equal' if same else 'DIFFERENT'} to the host-tensor "
          f"formula", flush=True)
    return same


def rope_syncs_and_decode_ms(torch, model, params, caches, tok, pos, arch,
                             n_steps: int = 8) -> bool:
    """Phase 11: one decode step under set_sync_debug_mode("warn") with the
    host-tensor rope (the formula before) and with the port's, and the ms
    per decode step of each over ``n_steps`` steps in turns (before, after,
    after, before), all from the same caches at the same position. Returns
    whether the port's step made no blocking sync in rope (and, where the
    model has attention, fewer than the host-tensor rope's)."""
    from repro_torch.models import attention
    port_rope = attention.rope_angles
    ropes = {"before": _rope_angles_host_tensor, "after": port_rope}
    syncs, ms = {}, {"before": [], "after": []}
    try:
        for name in ("before", "after"):
            attention.rope_angles = ropes[name]
            _, syncs[name] = _blocking_syncs(
                torch, lambda: model.decode_step(params, caches, tok, pos))
        for name in ("before", "after", "after", "before"):
            attention.rope_angles = ropes[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                model.decode_step(params, caches, tok, pos)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / n_steps)
    finally:
        attention.rope_angles = port_rope
    n_attn = sum(model.cfg.count_mixers().get(k, 0)
                 for k in ("attn", "shared_attn"))
    ok = not any(o.startswith("layers.py") for o in syncs["after"])
    if n_attn:
        ok &= len(syncs["after"]) < len(syncs["before"])
    print(f"phase 11 {arch} one decode step ({n_attn} attention calls) "
          f"under set_sync_debug_mode: {len(syncs['before'])} blocking host "
          f"syncs with the host-tensor rope (before){_sync_lines(syncs['before'])}"
          f"\nphase 11 {arch}: {len(syncs['after'])} with the port's rope "
          f"(after){_sync_lines(syncs['after'])}\nphase 11 {arch} decode "
          f"step, ms per token over {n_steps} steps, turns before, after, "
          f"after, before: before {ms['before'][0]:.3f} / "
          f"{ms['before'][1]:.3f}, after {ms['after'][0]:.3f} / "
          f"{ms['after'][1]:.3f} {'ok' if ok else 'CHECK FAILED'}",
          flush=True)
    return ok


def run_serving(torch, configs, Transformer, serve, counters):
    """Phase 11: static serving (``repro_torch.launch.serve.generate``) at
    full width for SERVE_RUNS, each model initialised on the card in bf16
    from a seeded CUDA generator and freed before the next. Every kernel
    counter is set to 0 just before the counted generate and read just
    after; the hand kernels must have launched exactly as the model's
    layers say. Returns (ok, {kernel: launches summed over the runs})."""
    from repro_torch.utils.tree import tree_leaves
    ok, totals = check_rope_on_the_card(torch, configs), {}
    for arch, prompt_len, gen_tokens in SERVE_RUNS:
        cfg = configs.get_arch(arch)
        model = Transformer(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = model.init(gen, "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in tree_leaves(params))
        prompts = torch.randint(0, cfg.vocab, (2, prompt_len), generator=gen,
                                device="cuda")
        serve.generate(model, params, prompts[:, :64], 2)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = serve.generate(model, params, prompts, gen_tokens)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        launches = {name: c.launches for name, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        mixers = cfg.count_mixers()
        want = dict.fromkeys(counters, 0)
        want["flash_attention"] = (mixers.get("attn", 0)
                                   + mixers.get("shared_attn", 0))
        want["rwkv6_scan"] = mixers.get("rwkv6", 0) * (1 + gen_tokens)
        want["mamba2_ssd"] = mixers.get("mamba2", 0)
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, caches, pos = model.prefill(params, prompts,
                                                max_len=prompt_len + 4)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            _profile_call(torch, lambda: model.prefill(
                params, prompts, max_len=prompt_len + 4),
                f"phase 11 {arch} one prefill")
            tok = torch.argmax(logits, dim=-1)
            (step_logits, caches), _ = _profile_call(
                torch, lambda: model.decode_step(params, caches, tok, pos),
                f"phase 11 {arch} one decode step")
            finite = bool(torch.isfinite(logits).all()
                          and torch.isfinite(step_logits).all())
            rope_ok = rope_syncs_and_decode_ms(torch, model, params, caches,
                                               tok, pos, arch)
        decode_ms = (total_ms - prefill_ms) / gen_tokens
        good = (launches == want and finite and out.shape == (2, gen_tokens)
                and int(out.min()) >= 0 and int(out.max()) < cfg.vocab
                and rope_ok)
        ok &= good
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        print(f"serving {arch} ({cfg.dtype}, {n_params / 1e9:.3f} B params, init "
              f"{init_s:.2f} s): B 2, prompt {prompt_len}, {gen_tokens} "
              f"greedy tokens: generate {total_ms:.2f} ms, prefill "
              f"{prefill_ms:.2f} ms, decode {decode_ms:.3f} ms/token "
              f"((generate - prefill) / tokens), "
              f"{2 * gen_tokens / (total_ms / 1e3):.1f} tokens/s "
              f"(generated tokens / generate wall), max_memory_allocated "
              f"{peak_gb:.2f} GB; launches "
              + ", ".join(f"{k}={v}" for k, v in launches.items()
                          if v or want[k])
              + " (expected " + ", ".join(f"{k}={v}" for k, v in want.items()
                                          if v)
              + f"); logits finite {finite}; tokens {out[0, :8].tolist()} "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
        del params, caches, logits, step_logits, out, model
        torch.cuda.empty_cache()
    return ok, totals


def _rel(torch, a, b) -> tuple[float, float]:
    """(max |a - b| / max(1, max |b|), ||a - b|| / ||b||) in f32."""
    a, b = a.float(), b.float()
    return (float((a - b).abs().max()) / max(1.0, float(b.abs().max())),
            float(torch.linalg.vector_norm(a - b)
                  / torch.linalg.vector_norm(b)))


def compare_model_routes(torch, configs, Transformer):
    """Phase 12: the same params through kernel_backend "auto" (the hand
    kernels) and "ref" (their plain versions), teacher forced: the prefill
    logits, then 8 decode steps, each fed the auto route's greedy token.

    f32 at full width with the depth cut to one step of each segment: max
    gap <= 1e-4 of the logits' largest magnitude (the kernels sum in
    another order, ~1e-6 a call, through up to 10 layers).

    bf16 at 17b's depth (ENGINE_BF16_STEPS; full depth before the script
    ran out of time). The two routes round to bf16 at different places
    (the plain flash rounds its scores and probabilities, the kernels
    round once), and a random-init stack amplifies such differences: on an
    H100 zamba2's two bf16 routes came out 0.69 apart (relative L2), each
    ~0.7 from the f32 logits, so bf16 rounding alone moves them that far.
    So each bf16 route is held against the f32 computation
    (the "ref" route on the f32 upcast of the same params, fed the same
    tokens): at every step the kernel route's relative L2 distance to it
    must be <= 1.25 x the plain route's + 1e-3, i.e. the kernels are no
    less accurate than their plain versions."""
    import dataclasses
    from repro_torch.utils.tree import tree_map
    print(f"phase 12: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} (both set at the script's "
          f"start)", flush=True)
    ok = True
    for arch, prompt_len, _ in SERVE_RUNS:
        for dtype in ("float32", "bfloat16"):
            cfg = _engine_cfg(configs, arch, dtype)
            cut = (f" (depth cut to one step of each segment: "
                   f"{cfg.n_layers} layers)" if dtype == "float32" else
                   f" (depth cut to {cfg.n_layers} layers, 17b's)")
            gen = torch.Generator(device="cuda").manual_seed(1)
            routes = {"auto": (Transformer(cfg, kernel_backend="auto"),
                               Transformer(cfg).init(gen, "cuda"))}
            routes["ref"] = (Transformer(cfg, kernel_backend="ref"),
                             routes["auto"][1])
            if dtype == "bfloat16":
                routes["f32"] = (
                    Transformer(dataclasses.replace(cfg, dtype="float32"),
                                kernel_backend="ref"),
                    tree_map(lambda x: x.float(), routes["auto"][1]))
            prompts = torch.randint(0, cfg.vocab, (2, prompt_len),
                                    generator=gen, device="cuda")
            steps = []                      # per step: {route: logits}
            with torch.inference_mode():
                state = {}
                for name, (model, params) in routes.items():
                    logits, caches, pos = model.prefill(
                        params, prompts, max_len=prompt_len + 8)
                    state[name] = [logits, caches]
                steps.append({n: v[0] for n, v in state.items()})
                for i in range(8):
                    tok = torch.argmax(state["auto"][0], dim=-1)
                    for name, (model, params) in routes.items():
                        state[name] = list(model.decode_step(
                            params, state[name][1], tok, pos + i))
                    steps.append({n: v[0] for n, v in state.items()})
            gaps = [_rel(torch, st["auto"], st["ref"]) for st in steps]
            line = (f"auto vs ref {arch} {dtype}{cut}: prefill + 8 decode "
                    f"steps, max gap / max|logit| "
                    f"{max(g[0] for g in gaps):.3e}, relative L2 "
                    f"{max(g[1] for g in gaps):.3e}")
            if dtype == "float32":
                good = max(g[0] for g in gaps) <= 1e-4
            else:
                to_f32 = [(_rel(torch, st["auto"], st["f32"])[1],
                           _rel(torch, st["ref"], st["f32"])[1])
                          for st in steps]
                good = all(a <= 1.25 * r + 1e-3 for a, r in to_f32)
                line += (f"; relative L2 to f32 (prefill, step 8): kernel "
                         f"route {to_f32[0][0]:.3e}, {to_f32[-1][0]:.3e}, "
                         f"plain route {to_f32[0][1]:.3e}, "
                         f"{to_f32[-1][1]:.3e}; worst ratio "
                         f"{max(a / max(r, 1e-30) for a, r in to_f32):.3f}")
            ok &= good
            print(line + f" {'ok' if good else 'CHECK FAILED'}", flush=True)
            del routes, state, steps
            torch.cuda.empty_cache()
    return ok


# -- phases 13-14: the paper's experiments and the trust plane ---------------

def _fig2_line(case, tau, out, launches, cpu_out) -> tuple[bool, str]:
    same = all(out[k] == cpu_out[k]
               for k in ("rounds", "max_epsilon", "resource_spent"))
    ok = (same and out["rounds"] > 0 and launches == tau * out["rounds"]
          and out["max_epsilon"] <= FIG2_EPS)
    return ok, (
        f"phase 13 fig2 {case.name} tau={tau}: rounds={out['rounds']} "
        f"max_epsilon={out['max_epsilon']!r} "
        f"resource_spent={out['resource_spent']!r} (cpu route "
        f"{cpu_out['rounds']} / {cpu_out['max_epsilon']!r} / "
        f"{cpu_out['resource_spent']!r}: {'equal' if same else 'DIFFERENT'})"
        f" best acc {out['best'].get('eval_acc', 0.0):.4f} (cpu route "
        f"{cpu_out['best'].get('eval_acc', 0.0):.4f}) ms_per_round="
        f"{out['wall_s'] * 1e3 / max(out['rounds'], 1):.3f} (train loop wall"
        f" / rounds, eval every round) dp_clip_noise launches={launches} "
        f"(steps {tau * out['rounds']}) {'ok' if ok else 'CHECK FAILED'}")


def run_paper_experiments(torch, dp_clip_noise, card):
    """Phase 13: benchmarks/common_torch.make_cases(fast=False) on cuda (the
    paper's four cases at full width), estimate_constants per case, fig2's
    two runs per case (tau 10 and 1, C_th 1000, eps_th 10) with each run's
    rounds, epsilon and cost held against the same run on the CPU and
    dp_clip_noise's calls against the steps taken, then fig6's solver grid
    on the cuda and the CPU constants. ``card`` is nvidia-smi's name and
    power limit. Returns (ok, the fig2 runs' dp_clip_noise launches)."""
    import benchmarks.common_torch as common
    import benchmarks.fig6_optimal_tau_torch as fig6
    print(f"phase 13 on {card}", flush=True)
    ok, total = True, 0
    t0 = time.perf_counter()
    cases = common.make_cases(fast=False, device="cuda")
    cpu_cases = common.make_cases(fast=False, device="cpu")
    print(f"phase 13 make_cases(fast=False) x2: "
          f"{time.perf_counter() - t0:.2f} s; " + "; ".join(
              f"{c.name} {c.fed.n_clients} clients, "
              f"{sum(cl.n_train for cl in c.fed.clients)} train rows, "
              f"d={c.dim}, {c.loss_fn.__name__}" for c in cases), flush=True)
    for case, cpu_case in zip(cases, cpu_cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        consts = common.estimate_constants(case)
        torch.cuda.synchronize()
        print(f"phase 13 estimate_constants {case.name}: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms (30 probe rounds)"
              f" lip={consts.lip:.6g} lam={consts.lam:.6g} "
              f"alpha={consts.alpha:.6g} xi2={consts.xi2:.6g}", flush=True)
        for tau in FIG2_TAUS:
            torch.cuda.synchronize()
            dp_clip_noise.launches = 0
            out = common.run_dp_pasgd(case, tau=tau, c_th=FIG2_C,
                                      eps_th=FIG2_EPS)
            torch.cuda.synchronize()
            launches = dp_clip_noise.launches
            total += launches
            cpu_out = common.run_dp_pasgd(cpu_case, tau=tau, c_th=FIG2_C,
                                          eps_th=FIG2_EPS)
            good, line = _fig2_line(case, tau, out, launches, cpu_out)
            ok &= good
            print(line, flush=True)
    # where one fig2 run's time goes
    _profile_call(torch, lambda: common.run_dp_pasgd(
        cases[0], tau=FIG2_TAUS[0], c_th=FIG2_C, eps_th=FIG2_EPS),
        f"phase 13 profile, fig2 {cases[0].name} tau={FIG2_TAUS[0]} whole "
        f"run")
    grids = {}
    for dev in ("cuda", "cpu"):
        rows = fig6.main(fast=False, device=dev)
        grids[dev] = rows[0]
        print(f"phase 13 fig6 on {dev}: {rows[0]}", flush=True)
    same = grids["cuda"].split(",")[2] == grids["cpu"].split(",")[2]
    ok &= same
    print(f"phase 13 fig6 grid, cuda vs cpu constants: "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    return ok, total


def check_trust_kernels(torch, np):
    """Phase 14: SecureMaskedSum at (16, 210) with 12 of 16 participating
    on the card against the host protocol's unmasked_fixed_point_sum and
    the CPU route, bit for bit; each robust aggregator on the card against
    its CPU result on the same rows (P 7, 12, 16): median bitwise, the
    others within 1e-6 of the largest magnitude."""
    from repro_torch.core import robust, secureagg
    ok = True
    c, d, p = 16, 210, 12
    rng = np.random.default_rng(14)
    x = (rng.normal(size=(c, d)) * 0.05).astype(np.float32)
    mask = np.zeros((c,), np.float32)
    mask[rng.choice(c, size=p, replace=False)] = 1.0
    sec = secureagg.SecureMaskedSum(c)
    got = {}
    for dev in ("cuda", "cpu"):
        gen = torch.Generator(device=dev).manual_seed(3)
        pairs = sec.draw(gen, d, dev)
        got[dev] = sec.masked_mean(torch.as_tensor(x, device=dev),
                                   torch.as_tensor(mask, device=dev),
                                   pairs).cpu().numpy()
    survivors = [int(i) for i in np.flatnonzero(mask)]
    total = secureagg.unmasked_fixed_point_sum(dict(enumerate(x)), survivors)
    scale = np.float32(1 << 16)
    want = (np.round(total * (1 << 16)).astype(np.int64).astype(np.int32)
            .astype(np.float32) / scale) / np.float32(p)
    good = (np.array_equal(got["cuda"], want)
            and np.array_equal(got["cuda"], got["cpu"]))
    ok &= good
    print(f"phase 14 SecureMaskedSum (16, 210), {p} of 16 participating: "
          f"cuda vs unmasked_fixed_point_sum and vs the cpu route "
          f"{'bitwise equal' if good else 'DIFFERENT'}", flush=True)
    for rows in (7, 12, 16):
        u = (rng.normal(size=(rows, d))
             * rng.uniform(0.01, 2.0, size=(rows, 1))).astype(np.float32)
        for name, args in (("median", ()), ("trimmed_mean", (0.25,)),
                           ("norm_bound", (0.1, 2.0))):
            agg = robust.make_aggregator(name, *args)
            a = agg(torch.as_tensor(u, device="cuda")).cpu().numpy()
            b = agg(torch.as_tensor(u)).numpy()
            err = float(np.max(np.abs(a - b)))
            lim = 0.0 if name == "median" else 1e-6 * float(np.abs(b).max())
            good = err <= lim
            ok &= good
            print(f"phase 14 {name} P={rows}: max|cuda - cpu|={err:.3e} "
                  f"(limit {lim:.3e}) {'ok' if good else 'CHECK FAILED'}",
                  flush=True)
    return ok


def run_attack_check(torch, dp_clip_noise):
    """Phase 14: benchmarks/attack_resilience_torch.py --check on cuda at
    its own config (8 clients, tau 2, 20 rounds, fractions 0 / 0.125 /
    0.25 / 0.375). Returns (ok, dp_clip_noise launches: 16 runs x 20
    rounds x tau 2)."""
    import benchmarks.attack_resilience_torch as attack
    torch.cuda.synchronize()
    dp_clip_noise.launches = 0
    t0 = time.perf_counter()
    rc = attack.main(["--check", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dp_clip_noise.launches
    want = 4 * len(attack.AGGREGATORS) * 20 * attack.TAU
    ok = rc == 0 and launches == want
    print(f"phase 14 attack_resilience_torch --check: rc={rc} in "
          f"{time.perf_counter() - t0:.2f} s, dp_clip_noise launches="
          f"{launches} (expected {want}) {'ok' if ok else 'CHECK FAILED'}",
          flush=True)
    return ok, launches


def run_secure_central(torch, np, api, linear, spec, fed, dp_clip_noise):
    """Phase 14: the main path's Adult-1 spec at full width with
    secure_agg=True, dp_accounting="central", trained until a budget
    binds; its rounds and epsilon against the host math with every charge
    at 1/P. Returns (ok, launches)."""
    from repro_torch.core.privacy import zcdp_to_dp
    sspec = spec.replace(secure_agg=True, dp_accounting="central")
    dim = fed.clients[0].x_train.shape[1]
    state = api.init_state(sspec, linear.init_linear(dim, device="cuda"),
                           device="cuda")
    planned, binds = api.rounds_within_budgets(sspec, state, 10_000)
    charges = api.round_rho_charges(sspec)
    rho = np.zeros_like(charges)
    for _ in range(planned):
        rho = rho + charges
    want_eps = zcdp_to_dp(float(np.max(rho)), sspec.delta)
    local = api.round_rho_charges(spec)
    p = sspec.participants_per_round()
    torch.cuda.synchronize()
    dp_clip_noise.launches = 0
    t0 = time.perf_counter()
    state, out = api.train(sspec, state, fed.make_sampler(BATCH))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dp_clip_noise.launches
    ok = (out["rounds"] == planned and out["max_epsilon"] == want_eps
          and np.allclose(charges, local / p, rtol=1e-12, atol=0)
          and launches == sspec.tau * out["rounds"]
          and all(bool(torch.isfinite(v).all())
                  for v in state.params.values()))
    print(f"phase 14 Adult-1 secure_agg + central accounting (P={p}): "
          f"rounds={out['rounds']} (host math {planned}, binds {binds}) "
          f"max_epsilon={out['max_epsilon']!r} (host math {want_eps!r}) "
          f"resource_spent={out['resource_spent']!r} ms_per_round="
          f"{wall * 1e3 / max(out['rounds'], 1):.3f} (train loop wall / "
          f"rounds, no eval) dp_clip_noise launches={launches} "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    return ok, launches


def time_trust_rounds(torch, np, api, linear, spec, fed, card):
    """Phase 14: ms per steady round, as phase 5 measures it (batches
    prebuilt, no eval, 20 rounds after 2 warm-up rounds), of the main
    path's Adult-1 spec with aggregator mean / median / trimmed_mean /
    norm_bound and with secure_agg, in three turns within this call (the
    order reversed in the second), then one profiled 3-round window of
    each trust variant. ``card`` is nvidia-smi's name and power limit.
    Returns whether every round left finite params."""
    variants = {"mean": {}, "median": dict(aggregator="median"),
                "trimmed_mean": dict(aggregator="trimmed_mean",
                                     trim_fraction=0.25),
                "norm_bound": dict(aggregator="norm_bound",
                                   norm_bound_factor=2.0),
                "secure": dict(secure_agg=True)}
    dim = fed.clients[0].x_train.shape[1]
    rng = np.random.default_rng(2)
    n_timed = 20
    batches = [api.round_batch(spec, fed.make_sampler(BATCH), rng)
               for _ in range(n_timed + 5)]
    specs, states = {}, {}
    for name, kw in variants.items():
        specs[name] = spec.replace(**kw)
        st = api.init_state(specs[name], linear.init_linear(
            dim, device="cuda"), device="cuda")
        for b in batches[:2]:
            st, _ = api.run_round(specs[name], st, b, check_budgets=False)
        states[name] = st
    times = {k: [] for k in variants}
    order = list(variants)
    for turn in range(3):
        for name in (order if turn != 1 else order[::-1]):
            st = states[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches[2:2 + n_timed]:
                st, _ = api.run_round(specs[name], st, b,
                                      check_budgets=False)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / n_timed)
            states[name] = st
    print(f"phase 14 steady round on {card} (Adult-1, tau={spec.tau}, "
          f"batches prebuilt, no eval), ms/round over {n_timed} rounds in "
          f"three turns: " + "; ".join(
              f"{k} " + " / ".join(f"{t:.3f}" for t in v)
              for k, v in times.items()), flush=True)
    finite = True
    for name in order[1:]:
        def last_rounds(name=name):
            st = states[name]
            for b in batches[-3:]:
                st, _ = api.run_round(specs[name], st, b,
                                      check_budgets=False)
            return st
        st, _ = _profile_call(torch, last_rounds,
                              f"phase 14 profile, 3 rounds {name}")
        finite &= all(bool(torch.isfinite(v).all())
                      for v in st.params.values())
    return finite

# -- phase 15: the buffered-async plane ---------------------------------------

def _same_bits(torch, a, b) -> bool:
    """Two tensors equal bit for bit (signed zeros and NaNs included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                            b.reshape(-1).contiguous().view(torch.uint8)))


def _leaves(tree):
    from repro_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


def run_async_identity(torch, np, api, asyncfl, spec, fed, counters):
    """Phase 15a: the main path's Adult-1 spec as engine="async_buffered"
    with B = 16, a zero-spread clock and alpha 0 against engine="vmap"
    from one seed for 4 rounds on cuda, dense and qsgd8 at participation
    0.5: global params and optimizer state bitwise, rho and cost exactly.
    Returns (ok, {kernel: calls})."""
    dim = fed.clients[0].x_train.shape[1]
    from repro_torch.models import linear
    lat = asyncfl.UniformLatency(0, compute=(1.0, 1.0), upload=(0.1, 0.1))
    ok, calls = True, {k: 0 for k in counters}
    for label, kw in (("dense", {}),
                      ("qsgd8_q50", dict(compressor="qsgd",
                                         participation=0.5))):
        ss = spec.replace(**kw)
        sa = ss.replace(engine="async_buffered", buffer_size=ss.n_clients,
                        staleness_alpha=0.0)
        rng_s, rng_a = np.random.default_rng(5), np.random.default_rng(5)
        sampler = fed.make_sampler(BATCH)
        before = {k: c.launches for k, c in counters.items()}
        st = api.init_state(ss, linear.init_linear(dim, device="cuda"),
                            device="cuda")
        at = asyncfl.init_async_state(
            sa, linear.init_linear(dim, device="cuda"), sampler, rng=rng_a,
            latency_model=lat, device="cuda")
        same, stale = True, 0.0
        for _ in range(4):
            st, _ = api.run_round(ss, st, api.round_batch(ss, sampler,
                                                          rng_s),
                                  check_budgets=False)
            at, rec = asyncfl.run_async_cycle(sa, at, sampler, rng_a,
                                              latency_model=lat,
                                              check_budgets=False)
            same &= all(_same_bits(torch, x[0], y) for x, y in zip(
                _leaves(st.params), _leaves(at.global_params)))
            same &= all(_same_bits(torch, x[0], y) for x, y in zip(
                _leaves(st.opt_state), _leaves(at.global_opt)))
            same &= (np.array_equal(st.rho, at.fl.rho)
                     and st.resource_spent == at.fl.resource_spent)
            stale = max(stale, rec["staleness_max"])
        torch.cuda.synchronize()
        for k, c in counters.items():
            calls[k] += c.launches - before[k]
        good = same and stale == 0.0
        ok &= good
        print(f"phase 15a identity {label}: async B=16 (flat clock, alpha "
              f"0) vs vmap, 4 rounds on cuda: params, optimizer state "
              f"bitwise, rho, cost exact: {same}; staleness_max {stale}; "
              f"rho max {float(np.max(at.fl.rho))!r}, cost "
              f"{at.fl.resource_spent!r} "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    print(f"phase 15a kernel calls (both engines): {calls}", flush=True)
    return ok, calls


def _async_rows(spec, state, sampler, rng, lat, n):
    """``n`` ScheduleRows projected from ``state`` on cuda, as
    train_async's chunked driver projects them."""
    from repro_torch.asyncfl.runtime import project_schedule, schedule_cursor
    return project_schedule(spec, schedule_cursor(state), sampler, rng, lat,
                            n, "cuda")


def run_async_full_width(torch, np, asyncfl, spec, fed, dp_clip_noise, card):
    """Phase 15b: Adult-1 at full width with B = 4, HeteroLatency(0,
    fleet=16, slow_factor=6) and alpha 0.5 through train_async(chunk 8)
    until a budget binds, three times from one seed: on cuda through the
    kernels, on cuda with kernel_backend="ref" (the plain versions, from
    the same generator) and on the CPU route. The kernels' run holds the
    plain one's global params and optimizer state within 1e-5 (abs); the
    flushes, cost, dispatched epsilon and simulated seconds equal across
    all three; dp_clip_noise's calls tau x (1 + flushes) through the
    kernels and none on the plain route. Then ms per steady cycle
    (prebuilt rows, no eval),
    a profiled chunk of 8 cycles, and one steady cycle's blocking host
    syncs (this spec and the qsgd8_q50 one; limit 1). Returns (ok,
    launches)."""
    from repro_torch.models import linear
    dim = fed.clients[0].x_train.shape[1]
    aspec = spec.replace(engine="async_buffered", buffer_size=4,
                         staleness_alpha=0.5)
    lat = asyncfl.HeteroLatency(0, fleet=aspec.n_clients, slow_factor=6.0)
    outs = {}
    for dev, backend in (("cuda", "auto"), ("cuda", "ref"), ("cpu", "auto")):
        rspec = aspec.replace(kernel_backend=backend)
        rng = np.random.default_rng(0)
        sampler = fed.make_sampler(BATCH)
        if dev == "cuda":
            torch.cuda.synchronize()
            dp_clip_noise.launches = 0
        st = asyncfl.init_async_state(
            rspec, linear.init_linear(dim, device=dev), sampler, rng=rng,
            latency_model=lat, device=dev)
        t0 = time.perf_counter()
        st, out = asyncfl.train_async(rspec, st, sampler, rng=rng,
                                      chunk_rounds=8, latency_model=lat)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(v).all())
                     for v in st.global_params.values())
        outs[dev, backend] = (out, wall, finite,
                              asyncfl.exceeds_async_budgets(rspec, st),
                              dp_clip_noise.launches if dev == "cuda" else 0,
                              _leaves((st.global_params, st.global_opt)))
    co, cw, cf, binds, launches, c_leaves = outs["cuda", "auto"]
    ro, _, rf, _, ref_launches, r_leaves = outs["cuda", "ref"]
    po, pw, pf, _, _, _ = outs["cpu", "auto"]
    keys = ("rounds", "resource_spent", "max_epsilon", "sim_seconds")
    same = all(co[k] == ro[k] == po[k] for k in keys)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(c_leaves, r_leaves))
    # generation 0 plus one dispatch a flush, tau calls each
    want = aspec.tau * (1 + co["rounds"])
    ok = (same and cf and rf and pf and binds is not None
          and co["rounds"] > 0 and co["max_epsilon"] <= aspec.eps_th
          and co["resource_spent"] <= aspec.c_th and launches == want
          and ref_launches == 0 and err <= 1e-5)
    losses = [r["loss"] for r in co["history"] if "loss" in r]
    print(f"phase 15b Adult-1 async B=4 hetero (slow 6, alpha 0.5), "
          f"train_async chunk 8 until {binds} binds: cuda " + ", ".join(
              f"{k}={co[k]!r}" for k in keys) + " | cuda ref " + ", ".join(
              f"{k}={ro[k]!r}" for k in keys) + " | cpu " + ", ".join(
              f"{k}={po[k]!r}" for k in keys) + f" | equal {same}; "
          f"kernels vs plain route on cuda: params, optimizer state max "
          f"|d|={err:.3e} (tol 1e-5 abs); dp_clip_noise calls {launches} "
          f"(tau x (1 + flushes) = {want}), {ref_launches} on the plain "
          f"route; last loss {losses[-1]:.5f}; train loop wall "
          f"{cw * 1e3:.1f} ms on cuda "
          f"({cw * 1e3 / max(co['rounds'], 1):.3f} ms a flush), "
          f"{pw * 1e3:.1f} ms on the CPU "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)

    # steady cycles: prebuilt rows, budgets off, after 3 warm-up cycles
    n_timed = 20
    rng = np.random.default_rng(1)
    sampler = fed.make_sampler(BATCH)
    st = asyncfl.init_async_state(
        aspec, linear.init_linear(dim, device="cuda"), sampler, rng=rng,
        latency_model=lat, device="cuda")
    rows = _async_rows(aspec, st, sampler, rng, lat, 3 + n_timed + 8 + 1)
    box = [st, 0]

    def one_cycle():
        box[0], _ = asyncfl.run_async_cycle(aspec, box[0],
                                            check_budgets=False,
                                            prebuilt=rows[box[1]])
        box[1] += 1
        return box[0]

    ms = _time_ms(one_cycle, n_timed)
    print(f"phase 15b steady cycle on {card} (B=4 of 16, tau={aspec.tau}, "
          f"prebuilt rows, no eval): {ms:.3f} ms per cycle (_time_ms over "
          f"{n_timed} cycles)", flush=True)

    def chunk():
        for _ in range(8):
            one_cycle()
        return box[0]

    _profile_call(torch, chunk, "phase 15b profile, a chunk of 8 cycles")
    _, syncs = _blocking_syncs(torch, one_cycle)
    print(f"phase 15b one steady cycle under set_sync_debug_mode: "
          f"{len(syncs)} blocking host syncs (limit 1)" + _sync_lines(syncs),
          flush=True)
    ok &= len(syncs) <= 1

    qspec = aspec.replace(compressor="qsgd", participation=0.5)
    st = asyncfl.init_async_state(
        qspec, linear.init_linear(dim, device="cuda"), sampler, rng=rng,
        latency_model=lat, device="cuda")
    rows = _async_rows(qspec, st, sampler, rng, lat, 4)
    for row in rows[:3]:
        st, _ = asyncfl.run_async_cycle(qspec, st, check_budgets=False,
                                        prebuilt=row)
    torch.cuda.synchronize()
    _, qsyncs = _blocking_syncs(torch, lambda: asyncfl.run_async_cycle(
        qspec, st, check_budgets=False, prebuilt=rows[3]))
    print(f"phase 15b one steady qsgd8_q50 cycle under set_sync_debug_mode: "
          f"{len(qsyncs)} blocking host syncs (limit 1: the new dispatch's "
          f"mask)" + _sync_lines(qsyncs), flush=True)
    ok &= len(qsyncs) <= 1
    return ok, launches


def run_async_straggler(torch, np, api, asyncfl, dp_clip_noise):
    """Phase 15c: benchmarks/throughput.py::run_async_hetero's config (its
    reference_spec: 8 clients, tau 2, dim 32, batch 8, sigma 0.5, lr 0.3;
    B 2, alpha 0.5, 12 sync rounds, HeteroLatency(0, fleet=8,
    slow_factor=6)) on cuda, through the kernels: the async run must land
    the sync rounds' rho in strictly fewer simulated seconds. Returns
    (ok, dp_clip_noise calls)."""
    from repro_torch.models import linear
    from repro_torch.optim import sgd
    k, tau, dim, batch, rounds_sync, b = 8, 2, 32, 8, 12, 2
    flushes = rounds_sync * k // b

    def sampler(m, tau, rng):
        return {"x": rng.normal(size=(tau, batch, dim)).astype(np.float32),
                "y": rng.integers(0, 2, size=(tau, batch)).astype(np.int32)}

    base = dict(n_clients=k, tau=tau, loss_fn=linear.logreg_loss,
                optimizer=sgd(0.3), dp=True, clip_norm=1.0,
                sigmas=(0.5,) * k, batch_sizes=(batch,) * k, eps_th=1e9,
                c_th=1e9)
    sspec = api.FederationSpec(engine="vmap", **base)
    aspec = api.FederationSpec(engine="async_buffered", buffer_size=b,
                               staleness_alpha=0.5, **base)
    lat = asyncfl.HeteroLatency(0, fleet=k, slow_factor=6.0)
    target_rho = rounds_sync * float(api.round_rho_charges(aspec).sum())
    sync_sim = sum(asyncfl.sync_round_duration(lat, k, r)
                   for r in range(rounds_sync))
    before = dp_clip_noise.launches
    rng = np.random.default_rng(0)
    st = api.init_state(sspec, linear.init_linear(dim, device="cuda"),
                        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, sout = api.train(sspec, st, sampler, max_rounds=rounds_sync, rng=rng)
    torch.cuda.synchronize()
    sync_wall = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    at = asyncfl.init_async_state(
        aspec, linear.init_linear(dim, device="cuda"), sampler, rng=rng,
        latency_model=lat, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at, aout = asyncfl.train_async(aspec, at, sampler, max_rounds=flushes,
                                   rng=rng, chunk_rounds=8,
                                   latency_model=lat)
    torch.cuda.synchronize()
    async_wall = time.perf_counter() - t0
    calls = dp_clip_noise.launches - before
    landed = float(np.sum(at.fl.rho))
    ok = (sout["rounds"] == rounds_sync and aout["rounds"] == flushes
          and landed >= target_rho * (1 - 1e-9)
          and aout["sim_seconds"] < sync_sim
          and all(bool(torch.isfinite(v).all())
                  for v in at.global_params.values()))
    print(f"phase 15c straggler fleet K={k} B={b} (throughput.py "
          f"run_async_hetero's config, kernels on): landed rho "
          f"{landed!r} (target {target_rho!r}); simulated seconds sync "
          f"{sync_sim!r} vs async {aout['sim_seconds']!r} "
          f"({sync_sim / aout['sim_seconds']:.2f}x); wall on cuda: sync "
          f"{rounds_sync} rounds {sync_wall * 1e3:.1f} ms, async {flushes} "
          f"flushes {async_wall * 1e3:.1f} ms; dp_clip_noise calls {calls} "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    return ok, calls

# -- phase 16: the transformer training path ---------------------------------

def _depth_cut(configs, arch: str, steps: int):
    """The arch at its published widths and dtype with the depth cut to
    ``steps`` steps of its (first) segment's pattern: gemma3-4b's one step
    is its 6-layer pattern (5 swa + 1 full), llama4-maverick's one period
    of 4 layers."""
    import dataclasses
    cfg = configs.get_arch(arch)
    seg = cfg.segments[0]
    return dataclasses.replace(
        cfg, name=f"{arch}-{steps * len(seg.pattern)}L",
        n_layers=steps * len(seg.pattern),
        segments=(dataclasses.replace(seg, n_steps=steps),))


def _memory_reckoning(n: int) -> str:
    """The round's largest buffers at N params, from the code, in GB."""
    c, tau = TRAIN_C, TRAIN_TAU
    parts = (("params, C bf16 replicas", 2 * n * c),
             ("grads, C bf16", 2 * n * c),
             ("dp_clip_noise_tree's f32 (C, N) buffer and the kernel's "
              "output",
              2 * 4 * n * c),
             ("the round's (C, tau, N) f32 noise", 4 * n * c * tau))
    return "; ".join(f"{k} {v / 1e9:.2f}" for k, v in parts) + (
        f"; sum {sum(v for _, v in parts) / 1e9:.2f} GB plus activations "
        f"(no remat)")


def run_training_full_width(torch, np, api, fl, ops, launch_train, configs,
                            counters, dp_clip_noise, dp_clip_noise_ref,
                            card, arch="gemma3-4b", steps=1, seq=TRAIN_SEQ,
                            phases=("16", "16a", "16b", "16c")):
    """Phase 16a-c (and 18d, with its arch, depth cut, seq and labels
    ``phases``: the whole phase, then a, b, c): ``arch``'s training at full
    width (depth cut to ``steps`` steps of its pattern) through
    ``launch.train.build_federation`` and ``api.train``, kernel_backend
    "auto": TRAIN_ROUNDS rounds of TRAIN_C clients x TRAIN_TAU local steps,
    batch TRAIN_B, seq ``seq``. Every counter is set to 0 just before the
    counted train and read just after: dp_clip_noise (row_stream at (C, N))
    tau x rounds calls, the model kernels none (the training route has no
    kernel). An MoE arch also needs a positive, finite aux loss on client
    0's trained params. Then one steady round timed, one profiled with the
    operands of its last dp_clip_noise call kept; the kernel's output on
    them against dp_clip_noise_ref, its time and device time beside its byte
    bound, and the host ms of the dp_clip_noise_tree call around it.
    Returns (ok, launches, record)."""
    from repro_torch.utils.tree import tree_leaves, tree_map
    p_all, p_a, p_b, p_c = phases
    cfg = _depth_cut(configs, arch, steps)
    sigmas = fl.design_sigmas(TRAIN_ROUNDS * TRAIN_TAU, CLIP,
                              [TRAIN_B] * TRAIN_C, TRAIN_EPS, DELTA)
    torch.cuda.empty_cache()
    # the round's buffers come in a few large sizes (the (C, N) f32 block,
    # the noise, 1-2 GB logits chunks): with fixed segments the cached
    # blocks fragment (at tau 2 a 9.2 GiB request failed with ~30 GB
    # reserved but unallocated; at tau 1 alone in a process they reserve
    # 79 GB, --train-memory), so this phase, after fifteen others, maps
    # expandable segments
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, spec, state, sampler = launch_train.build_federation(
        cfg, TRAIN_C, TRAIN_TAU, TRAIN_B, seq, sigmas, clip_norm=CLIP,
        delta=DELTA, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(x[0].numel() for x in tree_leaves(state.params))
    print(f"phase {p_all} on {card}: {cfg.name} ({arch}'s widths, depth cut "
          f"{configs.get_arch(arch).n_layers} -> {cfg.n_layers} layers: "
          f"{'one step' if steps == 1 else f'{steps} steps'} of its pattern "
          f"{[ls.attn_kind for ls in cfg.segments[0].pattern]}), {cfg.dtype},"
          f" N = {n:,} params a replica ({2 * n / 1e9:.2f} GB), C "
          f"{TRAIN_C}, tau {TRAIN_TAU} (cut from 2 for memory), batch "
          f"{TRAIN_B}, seq {seq}, expandable segments, "
          f"loss_chunk {cfg.loss_chunk}, sigma {float(sigmas[0]):.4f}; "
          f"build_federation {init_s:.2f} s", flush=True)
    print(f"phase {p_all} memory reckoning: {_memory_reckoning(n)}",
          flush=True)

    # -- a. the counted run ------------------------------------------------
    rng = np.random.default_rng(0)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    state, out = api.train(spec, state, sampler, max_rounds=TRAIN_ROUNDS,
                           rng=rng)
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: c.launches for name, c in counters.items()}
    variant = dp_clip_noise.last_variant
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in out["history"]]
    want = {**dict.fromkeys(counters, 0),
            "dp_clip_noise": TRAIN_TAU * TRAIN_ROUNDS}
    finite = (all(math.isfinite(x) for x in losses)
              and all(bool(torch.isfinite(x).all())
                      for x in tree_leaves(state.params)))
    ok = (out["rounds"] == TRAIN_ROUNDS and launches == want and finite
          and variant == "row_stream")
    aux_line = ""
    if any(ls.ffn == "moe" for ls in cfg.layer_specs()):
        tokens = torch.as_tensor(sampler(0, 1, rng)["tokens"][0],
                                 device="cuda")
        with torch.no_grad():
            _, aux = model._hidden_states(
                tree_map(lambda x: x[0], state.params), tokens, None)
        aux = float(aux)
        ok &= aux > 0 and math.isfinite(aux)
        aux_line = f", aux loss on client 0's params {aux:.5f} (> 0)"
        del tokens
    print(f"phase {p_a} api.train {TRAIN_ROUNDS} rounds: {train_ms:.1f} ms "
          f"({train_ms / TRAIN_ROUNDS:.1f} ms a round, the first with its "
          f"warm-up), losses {losses}{aux_line}, max_epsilon "
          f"{out['max_epsilon']}, resource_spent {out['resource_spent']}; "
          f"launches "
          + ", ".join(f"{k}={v}" for k, v in launches.items())
          + f" (expected dp_clip_noise={want['dp_clip_noise']}, the rest 0),"
          f" dp_clip_noise instance {variant}; max_memory_allocated "
          f"{peak_gb:.2f} GB (max_memory_reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f}) of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)

    # -- b. a steady round, then a profiled one keeping its last call's
    # operands ----------------------------------------------------------------
    batch = api.round_batch(spec, sampler, rng)
    t0 = time.perf_counter()
    state, _ = api.run_round(spec, state, batch, check_budgets=False)
    torch.cuda.synchronize()
    round_ms = (time.perf_counter() - t0) * 1e3
    print(f"phase {p_b} one steady round on {card}: {round_ms:.1f} ms (host "
          f"clock to synchronize, batch built before)", flush=True)
    kept, real = {}, ops.dp_clip_noise

    def keep_last(g, noise, clip_norm, sigma):
        kept["calls"] = kept.get("calls", 0) + 1
        if kept["calls"] == TRAIN_TAU:
            kept.update(g=g, noise=noise, clip=clip_norm, sigma=sigma)
        return real(g, noise, clip_norm, sigma)

    ops.dp_clip_noise = keep_last
    try:
        (state, _), _ = _profile_call(
            torch, lambda: api.run_round(spec, state, batch,
                                         check_budgets=False),
            f"phase {p_b} profile, one round ({TRAIN_TAU} local steps)",
            watch=("counter_rng",))
    finally:
        ops.dp_clip_noise = real
    peak_kept = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase {p_b} max_memory_allocated {peak_kept:.2f} GB (with the "
          f"kept operands)", flush=True)
    like = [torch.empty(x.shape, dtype=x.dtype, device="meta")
            for x in tree_leaves(state.params)]
    del state, out, batch, model
    g, sigma, clip = kept["g"], kept["sigma"], kept["clip"]
    noise = kept.pop("noise").contiguous()
    kept.clear()
    torch.cuda.empty_cache()

    # -- c. the kernel against its plain version on the round's operands ----
    y, norm = dp_clip_noise(g, noise, clip, sigma)
    err_y = err_n = 0.0
    good = dp_clip_noise.last_variant == "row_stream"
    for r in range(g.shape[0]):
        wy, wn = dp_clip_noise_ref(g[r:r + 1], noise[r:r + 1], clip,
                                   sigma[r:r + 1])
        dy = (y[r] - wy[0]).abs()
        good &= bool((dy <= 1e-6 + 1e-5 * wy[0].abs()).all())
        err_y = max(err_y, float(dy.max()))
        err_n = max(err_n, float((norm[r] - wn[0]).abs() / wn[0]))
        del wy, wn, dy
    good &= err_n <= 1e-5
    ok &= good
    print(f"phase {p_c} dp_clip_noise ({g.shape[0]}, {n:,}) on the round's "
          f"gradient and noise against dp_clip_noise_ref: max|dy| "
          f"{err_y:.3e}, max rel|dnorm| {err_n:.3e}, norms "
          f"{norm.tolist()}; tolerance |dy| <= 1e-6 + 1e-5 |y| and 1e-5 on "
          f"the norm (f32 sums of {n:,} squares in two orders differ by at "
          f"most ~log2(N) 2^-24 = {math.log2(n) * 2.0 ** -24:.1e} relative; "
          f"y then by that times |g| plus an ulp of |y|) "
          f"{'ok' if good else 'MISMATCH'}", flush=True)
    del y, norm
    torch.cuda.empty_cache()

    # -- the kernel's time at this shape, and the host's around it ----------
    def call():
        return dp_clip_noise(g, noise, clip, sigma)

    rec = _row_times(torch, call, n, "clip_noise")
    rec["variant"] = dp_clip_noise.last_variant
    for _ in range(3):
        # row_stream runs two kernels a call; a trace that counts fewer
        # dropped a record (it read 1.2 once): take it again, and report
        # no device time rather than a short one. More than two fails
        if rec["kernels"] is None or rec["kernels"] >= 2:
            break
        rec["device_ms"], rec["parts"], rec["kernels"] = _call_device_ms(
            torch, call, 5, "clip_noise")
    if rec["kernels"] is not None and rec["kernels"] > 2:
        ok = False
        print(f"phase {p_b} dp_clip_noise ran {rec['kernels']:g} kernels a "
              f"call where row_stream runs 2: CHECK FAILED", flush=True)
    elif rec["kernels"] != 2:
        rec["device_ms"] = None
    plain_ms = _time_ms(lambda: dp_clip_noise_ref(g, noise, clip, sigma), 5)
    bound = _bound_ms(g.shape[0], n, True)
    print(f"phase {p_b} kernel dp_clip_noise ({g.shape[0]}, {n:,}) on {card}: "
          f"{_row_line(rec, plain_ms, bound)}", flush=True)
    rows = g.shape[0]
    tree = ops.unflatten_rows(g, like)

    def host_ms(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    flat_ms = host_ms(lambda: ops.flatten_rows(tree))
    unflat_ms = host_ms(lambda: ops.unflatten_rows(g, tree))
    print(f"phase {p_b} around the kernel in dp_clip_noise_tree, on the "
          f"{len(tree)} gradient leaves (host clock to synchronize): "
          f"the flatten into one f32 (C, N) buffer (ops.flatten_rows) "
          f"{flat_ms:.3f} ms, the unflatten to bf16 leaves "
          f"(ops.unflatten_rows) {unflat_ms:.3f} ms, each against "
          f"{(2 + 4) * rows * n / HBM_BYTES_PER_S * 1e3:.3f} ms of bytes "
          f"(N bf16 read or written and N f32 written or read a row)",
          flush=True)
    del tree, g, noise, sigma
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    return ok, launches, {
        "shape": [rows, n], "variant": rec["variant"], "ms": rec["ms"],
        "device_ms": rec["device_ms"], "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "max_abs_err": err_y,
        "flatten_ms": flat_ms, "unflatten_ms": unflat_ms,
        "round_ms": round_ms, "peak_gb": peak_gb}


def _launcher_summary(main, argv):
    """``main(argv)``'s exit code and printed JSON summary."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    return rc, json.loads(text[text.index("{"):text.rindex("}") + 1])


def _keeping_first_calls(torch, ops, names, kept):
    """Put a wrapper in ``ops`` in place of each kernel of ``names`` that
    keeps, at the first call of each (kernel, operand shapes and dtypes),
    clones of the operands and of what the kernel gave (for a scatter, the
    cache after it) in ``kept``. Returns the real kernels, to put back."""
    reals = {}
    for name in names:
        reals[name] = getattr(ops, name)

        def keeper(*args, _real=reals[name], _name=name):
            key = (_name,) + tuple(
                (tuple(a.shape), str(a.dtype)) for a in args
                if torch.is_tensor(a))
            if key in kept:
                return _real(*args)
            ins = [a.clone() if torch.is_tensor(a) else a for a in args]
            out = _real(*args)
            kept[key] = (ins, tuple(o.clone() for o in out)
                         if isinstance(out, tuple) else out.clone())
            return out
        setattr(ops, name, keeper)
    return reals


def _check_kept_calls(torch, kept, refs):
    """Each kept kernel call's output against its plain version on the same
    operands, with phase 2's criteria: dp_clip_noise's y within 1e-6 +
    1e-5 |y| and its norms within 1e-5 relative (phase 21's split form
    alike: row_sumsq's sums within 1e-5 relative, clip_noise_apply's y
    within 1e-6 + 1e-5 |y|); quantize_decompress and cohort_gather_scatter
    bit for bit. Returns (ok, {kernel: max abs err},
    a line for each call)."""
    ok, worst, lines = True, {}, []
    for key, (ins, out) in kept.items():
        name = key[0]
        want = refs[name](*ins)
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(outs, wants))
        if name == "dp_clip_noise":
            (y, norm), (wy, wn) = outs, wants
            good = (bool(torch.allclose(y, wy, atol=1e-6, rtol=1e-5))
                    and float(((norm - wn).abs()
                               / wn.abs().clamp(min=1e-30)).max()) <= 1e-5)
        elif name == "row_sumsq":            # phase 21: the split form
            good = float(((outs[0] - wants[0]).abs()
                          / wants[0].abs().clamp(min=1e-30)).max()) <= 1e-5
        elif name == "clip_noise_apply":
            good = bool(torch.allclose(outs[0], wants[0], atol=1e-6,
                                       rtol=1e-5))
        else:
            good = all(bool(torch.equal(a, b)) for a, b in zip(outs, wants))
        ok &= good
        worst[name] = max(worst.get(name, 0.0), err)
        mode = ("scatter" if name == "cohort_gather_scatter"
                and len(ins) == 3 else "")
        lines.append(f"{name}{' ' + mode if mode else ''} "
                     + " ".join(f"{list(sh)}" for sh, _ in key[1:])
                     + f" max|d| {err:.3e} {'ok' if good else 'MISMATCH'}")
    return ok, worst, lines


def train_memory(segments: str, tau: int, src: str | None = None) -> int:
    """``python3 chip_smoke.py --train-memory fixed|expandable TAU [SRC]``:
    phase 16a's run (gemma3-4b at one pattern step, TRAIN_C clients,
    TRAIN_ROUNDS rounds through launch.train.build_federation + api.train)
    at ``tau``
    local steps, alone in this process, with the caching allocator's
    segments fixed (PyTorch's default) or expandable
    (``PYTORCH_CUDA_ALLOC_CONF``, set before the first allocation), then
    one steady round timed and one profiled (phase 16b's, with
    counter_rng's device ms), through the port under SRC (default this
    tree's ``src``; another checkout's, such as the parent commit's, to
    compare two trees in turns in one chip call). Prints the card,
    the peak memory allocated and reserved, and the run's losses and round
    times or its out-of-memory error: a measurement, so an out-of-memory
    error is reported, not raised; nothing is checked."""
    import os
    if segments == "expandable":
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    else:
        os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(src).resolve()) if src else
                    str(ROOT / "src"))
    from repro_torch import api, configs
    from repro_torch.core import fl
    from repro_torch.launch import train as launch_train
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    cfg = _depth_cut(configs, "gemma3-4b", 1)
    sigmas = fl.design_sigmas(TRAIN_ROUNDS * tau, CLIP,
                              [TRAIN_B] * TRAIN_C, TRAIN_EPS, DELTA)
    label = f"train memory {segments} segments, tau {tau}"
    try:
        _, spec, state, sampler = launch_train.build_federation(
            cfg, TRAIN_C, tau, TRAIN_B, TRAIN_SEQ, sigmas, clip_norm=CLIP,
            delta=DELTA, device="cuda")
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        state, out = api.train(spec, state, sampler,
                               max_rounds=TRAIN_ROUNDS, rng=rng)
        torch.cuda.synchronize()
        train_ms = (time.perf_counter() - t0) * 1e3
        batch = api.round_batch(spec, sampler, rng)
        t0 = time.perf_counter()
        state, _ = api.run_round(spec, state, batch, check_budgets=False)
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) * 1e3
        _profile_call(torch, lambda: api.run_round(
            spec, state, batch, check_budgets=False),
            f"{label}, profile of one round", watch=("counter_rng",))
        result = (f"{out['rounds']} rounds in {train_ms:.1f} ms (the first "
                  f"with its warm-up), losses "
                  f"{[h['loss'] for h in out['history']]}, a steady round "
                  f"{round_ms:.1f} ms (host clock to synchronize, batch "
                  f"built before)")
    except torch.cuda.OutOfMemoryError as e:
        result = f"out of memory: {str(e).splitlines()[0]}"
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{label} on {card}: {cfg.name}, C {TRAIN_C}, batch {TRAIN_B}, "
          f"seq {TRAIN_SEQ}: {result};"
          f" max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"max_memory_reserved {torch.cuda.max_memory_reserved() / 1e9:.2f}"
          f" GB of {total / 1e9:.2f}", flush=True)
    return 0


def run_launcher_smoke(torch, ops, launch_train, serve, configs, counters,
                       refs, card):
    """Phase 16d-e: ``repro_torch.launch.train.main`` at --smoke for each of
    LAUNCH_RUNS on cuda (the kernels' counters set to 0 just before, read
    just after) and on the CPU (the row kernels' calls counted on a spy of
    ``kernels.ops``): rounds and resource_spent equal, max_epsilon equal
    (under partial participation, which draws each route's participants
    from its own generator: each route's epsilon is its own ledger's,
    ``zcdp_to_dp(max rho)``, and both ledgers charged the same total), and
    the cuda launches equal the CPU calls. The cuda run keeps each row
    kernel's operands and output at its first call of each shape, and
    holds the output against the kernel's plain version on them (phase
    2's criteria). Then ``launch.serve.main
    --fl-checkpoint`` on the dense run's cuda checkpoint: federated params,
    greedy tokens through flash_attention. Returns (ok, {kernel: cuda
    launches summed over the runs}, {kernel: max abs err of the kept
    calls})."""
    import tempfile
    from repro_torch.core.privacy import zcdp_to_dp
    row = ("dp_clip_noise", "quantize_decompress", "cohort_gather_scatter")
    ok, totals = True, dict.fromkeys(counters, 0)
    errs = dict.fromkeys(row, 0.0)
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra in LAUNCH_RUNS:
            saves = ({dev: ["--save", f"{tmp}/{label}_{dev}"]
                      for dev in ("cuda", "cpu")}
                     if label != "population_resident" else
                     {"cuda": [], "cpu": []})
            kept = {}
            reals = _keeping_first_calls(torch, ops, row, kept)
            for c in counters.values():
                c.launches = 0
            try:
                t0 = time.perf_counter()
                rc_g, gpu = _launcher_summary(
                    launch_train.main,
                    LAUNCH_BASE + extra + ["--device", "cuda"]
                    + saves["cuda"])
                torch.cuda.synchronize()
                gpu_s = time.perf_counter() - t0
            finally:
                for name, real in reals.items():
                    setattr(ops, name, real)
            launches = {k: c.launches for k, c in counters.items()}
            good_k, err_k, kept_lines = _check_kept_calls(torch, kept, refs)
            for name, err in err_k.items():
                errs[name] = max(errs[name], err)
            del kept
            spied, reals = dict.fromkeys(row, 0), {}
            for name in row:
                reals[name] = getattr(ops, name)

                def spy(*a, _real=reals[name], _name=name, **kw):
                    spied[_name] += 1
                    return _real(*a, **kw)
                setattr(ops, name, spy)
            try:
                t0 = time.perf_counter()
                rc_c, cpu = _launcher_summary(
                    launch_train.main,
                    LAUNCH_BASE + extra + ["--device", "cpu"] + saves["cpu"])
                cpu_s = time.perf_counter() - t0
            finally:
                for name, real in reals.items():
                    setattr(ops, name, real)
            good = (rc_g == rc_c == 0 and gpu["rounds"] == cpu["rounds"] > 0
                    and gpu["resource_spent"] == cpu["resource_spent"]
                    and math.isfinite(gpu["final_loss"]) and good_k
                    and set(err_k) == {k for k in row if launches[k]}
                    and all(launches[k] == spied[k] for k in row)
                    and launches["dp_clip_noise"] > 0
                    and not any(launches[k] for k in counters
                                if k not in row))
            if "--participation" in extra:
                rho = {}
                for dev in ("cuda", "cpu"):
                    with open(f"{tmp}/{label}_{dev}/meta.json") as f:
                        rho[dev] = json.load(f)["extra"]["rho"]
                good &= (gpu["max_epsilon"]
                         == zcdp_to_dp(max(rho["cuda"]), DELTA)
                         and cpu["max_epsilon"]
                         == zcdp_to_dp(max(rho["cpu"]), DELTA)
                         and math.isclose(sum(rho["cuda"]), sum(rho["cpu"]),
                                          rel_tol=1e-12)
                         and launches["quantize_decompress"]
                         == gpu["rounds"])
            else:
                good &= gpu["max_epsilon"] == cpu["max_epsilon"]
            if label == "population_resident":
                good &= launches["cohort_gather_scatter"] > 0
            ok &= good
            for k, v in launches.items():
                totals[k] += v
            print(f"phase 16d launch.train.main {label} ({' '.join(extra)}):"
                  f" cuda rounds {gpu['rounds']}, max_epsilon "
                  f"{gpu['max_epsilon']}, resource_spent "
                  f"{gpu['resource_spent']}, final_loss {gpu['final_loss']}"
                  f" in {gpu_s:.2f} s; CPU route {cpu['rounds']}, "
                  f"{cpu['max_epsilon']}, {cpu['resource_spent']} in "
                  f"{cpu_s:.2f} s; cuda launches "
                  + ", ".join(f"{k}={launches[k]}" for k in row)
                  + " vs CPU calls "
                  + ", ".join(f"{k}={spied[k]}" for k in row)
                  + "; the kernels' outputs in the cuda run against their "
                  "plain versions: " + "; ".join(kept_lines)
                  + f" {'ok' if good else 'CHECK FAILED'}", flush=True)

        # -- e. serve the dense run's checkpoint ---------------------------
        for c in counters.values():
            c.launches = 0
        rc, res = _launcher_summary(serve.main, [
            "--arch", "gemma3-4b", "--smoke", "--static", "--fl-checkpoint",
            f"{tmp}/dense_cuda", "--batch", "2", "--prompt-len", "32",
            "--gen", "4", "--device", "cuda"])
        torch.cuda.synchronize()
        flash = counters["flash_attention"].launches
        totals["flash_attention"] += flash
        # generate runs twice (warm-up and timed), one flash call a layer
        n_attn = configs.smoke_variant(
            configs.get_arch("gemma3-4b")).count_mixers()["attn"]
        good = (rc == 0 and res["params"] == "federated"
                and res["generated_shape"] == [2, 4]
                and flash == 2 * n_attn)
        ok &= good
        print(f"phase 16e launch.serve.main --fl-checkpoint (the dense "
              f"run's) on {card}: params {res['params']}, tokens "
              f"{res['sample']}, {res['tokens_per_s']} tokens/s, "
              f"flash_attention launches {flash} (expected {2 * n_attn}) "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    return ok, totals, errs


# -- phase 17: the continuous-batching serving engine -------------------------

def _engine_cfg(configs, arch: str, dtype: str):
    """The arch at its published widths in ``dtype``: in f32 with the depth
    cut to one step of each segment (phase 12's cut), in bf16 to
    ENGINE_BF16_STEPS[arch] steps of its first segment."""
    import dataclasses
    if dtype != "float32":
        return dataclasses.replace(
            _depth_cut(configs, arch, ENGINE_BF16_STEPS[arch]), dtype=dtype)
    cfg = dataclasses.replace(configs.get_arch(arch), dtype=dtype)
    segs = tuple(configs.Segment(1, s.pattern) for s in cfg.segments)
    return dataclasses.replace(
        cfg, segments=segs, n_layers=sum(len(s.pattern) for s in segs))


def _engine_max_len(prompts) -> int:
    """The span every slot covers: the longest prompt plus the largest
    budget, in whole blocks (gemma3-4b: 1,536, so a 1,500-token prompt's
    bucket is max_len; rwkv6-1.6b and zamba2-7b: 576)."""
    n = max(prompts) + max(ENGINE_GENS)
    return -(-n // ENGINE_BLOCK) * ENGINE_BLOCK


def _pool_bytes(cfg, max_len: int) -> int:
    """The paged pools' bytes, from the code: attention layers x
    (n_slots x blocks_per_slot + 1 scratch) x block x KV x hd x 2 (k, v) x
    the dtype's bytes."""
    mixers = cfg.count_mixers()
    n_attn = mixers.get("attn", 0) + mixers.get("shared_attn", 0)
    bps = -(-max_len // ENGINE_BLOCK)
    size = 2 if cfg.dtype == "bfloat16" else 4
    return (n_attn * (ENGINE_SLOTS * bps + 1) * ENGINE_BLOCK
            * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * size)


def _arch_kernels(cfg) -> set:
    """The model kernels the arch's serving path runs."""
    mixers = cfg.count_mixers()
    return ({"flash_attention"} if mixers.get("attn", 0)
            + mixers.get("shared_attn", 0) else set()) | (
        {"rwkv6_scan"} if mixers.get("rwkv6", 0) else set()) | (
        {"mamba2_ssd"} if mixers.get("mamba2", 0) else set())


def _keeping_first_model_calls(torch, ops, kept):
    """``_keeping_first_calls`` for the model kernels' routed entry points
    (``ops.flash_attention`` / ``rwkv6_scan`` / ``mamba2_ssd``), whose
    options come as keywords: the first call of each (kernel, operand
    shapes and dtypes, option values) keeps clones of its operands, its
    options and its outputs in ``kept``. Returns the real entry points, to
    put back."""
    reals = {}
    for name in MODEL_KERNELS:
        reals[name] = getattr(ops, name)

        def keeper(*args, _real=reals[name], _name=name, **kw):
            key = (_name,) + tuple(
                (tuple(a.shape), str(a.dtype)) if torch.is_tensor(a) else a
                for a in args) + tuple(sorted(kw.items()))
            if key in kept:
                return _real(*args, **kw)
            ins = [a.clone() if torch.is_tensor(a) else a for a in args]
            out = _real(*args, **kw)
            kept[key] = (ins, dict(kw), tuple(o.clone() for o in out)
                         if isinstance(out, tuple) else (out.clone(),))
            return out
        setattr(ops, name, keeper)
    return reals


def _check_kept_model_calls(torch, kept, refs):
    """Each kept model-kernel call against its plain version on the same
    operands upcast to f32, with phase 10's criteria (``_kernel_err`` at
    the operands' dtype; rwkv6_scan's and mamba2_ssd's final state at
    f32's). Returns (ok, {kernel: max abs err}, a line for each call)."""
    ok, worst, lines = True, {}, []
    for key, (ins, kw, outs) in kept.items():
        name = key[0]
        f32 = [a.float() if torch.is_tensor(a) else a for a in ins]
        if name == "flash_attention":
            # head by head where the (B, h, S, S) f32 scores of all heads
            # would pass 2 GiB (llama4's chunks, phase 18)
            b, h, s_len = f32[0].shape[:3]
            step = max(1, min(h, 2 ** 31 // (4 * b * s_len * s_len)))
            wants = (torch.cat([refs[name](
                *(a[:, i:i + step] for a in f32[:3]),
                window=kw.get("window", 0)) for i in range(0, h, step)],
                dim=1),)
            opts = f" window {kw.get('window', 0)}"
        elif name == "rwkv6_scan":
            wants = refs[name](*f32)
            opts = " from s0" if ins[5] is not None else ""
        else:
            chunk = min(kw.get("chunk", 128), ins[0].shape[1])
            wants = refs[name](*f32, chunk)
            opts = f" chunk {chunk}"
        errs = [_kernel_err(torch, got, want,
                            ins[0].dtype if i == 0 else torch.float32)
                for i, (got, want) in enumerate(zip(outs, wants))]
        del wants
        err, good = max(e for e, _ in errs), all(g for _, g in errs)
        ok &= good
        worst[name] = max(worst.get(name, 0.0), err)
        lines.append(f"{name} {str(ins[0].dtype).split('.')[1]} "
                     + " ".join(str(list(a.shape)) for a in ins[:3])
                     + f"{opts} max|d| {err:.3e} "
                     + ("ok" if good else "MISMATCH"))
    torch.cuda.synchronize()
    return ok, worst, lines


def _watched_engine(torch, serve_pkg, model, params, **kw):
    """A SlotEngine that logs in ``log``, through the engine's public
    surface and while ``watching``: each admitted group's (size, bucket)
    and wall ms (synchronised), how many of its requests joined while
    other slots decoded into a slot used before, each request's first
    logits (its slot's row of ``logits`` after the admission), and per
    step whether every slot's logits are finite (a device flag, read once
    at the end)."""

    class Watched(serve_pkg.SlotEngine):
        def admit(self, reqs):
            if not self.watching:
                return super().admit(reqs)
            log = self.log
            mid = self.n_active > 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slots = super().admit(reqs)
            torch.cuda.synchronize()
            log["ms"].append((time.perf_counter() - t0) * 1e3)
            log["groups"].append((len(reqs),
                                  self.bucket_len(reqs[0].prompt_len)))
            log["recycled"] += sum(mid and s in log["used"] for s in slots)
            log["used"].update(slots)
            for r, s in zip(reqs, slots):
                log["first"][r.rid] = self.logits[s].clone()
            return slots

        def step(self):
            out = super().step()
            if self.watching:
                self.log["finite"].append(torch.isfinite(self.logits).all())
            return out

    engine = Watched(model, params, **kw)
    engine.log = {"groups": [], "ms": [], "recycled": 0, "first": {},
                  "finite": [], "used": set()}
    engine.watching = True
    return engine


def _batch_noise(torch, np, serve, model, params, requests, n_probe=2):
    """How far rounding alone moves the logits when one request decodes in
    a batch of ENGINE_SLOTS rows instead of alone, the engine's situation
    against generate's: ``generate`` on the prompt at B 1 and on
    ENGINE_SLOTS copies of it, both greedy, the largest |logit difference|
    of row 0 over the steps both took on the same tokens (up to and with
    the first step whose tokens differ), over ``n_probe`` requests."""
    from repro_torch.utils.tree import tree_leaves
    noise = 0.0
    dev = tree_leaves(params)[0].device
    for r in requests[:n_probe]:
        prompt = torch.as_tensor(r.tokens[None].astype(np.int64), device=dev)
        one, l1 = serve.generate(model, params, prompt, r.max_gen,
                                 with_logits=True)
        many, l4 = serve.generate(model, params,
                                  prompt.expand(ENGINE_SLOTS, -1), r.max_gen,
                                  with_logits=True)
        differ = (one[0] != many[0]).nonzero()
        k = int(differ[0]) + 1 if len(differ) else r.max_gen
        noise = max(noise, float((l1[0, :k] - l4[0, :k]).abs().max()))
    return noise


def _engine_vs_generate(torch, np, serve, model, params, requests, first,
                        noise=None):
    """Each request's tokens against ``launch.serve.generate`` on its
    exact-length prompt with ``model`` and the same params, under the gap
    guard (``agree_under_gap``): in f32 (``noise`` None) GUARD_F32 of the
    largest logit; in bf16 four times ``noise`` (``_batch_noise``: what
    rounding alone moves between a batch of slots and a lone request), at
    least one bf16 ulp of the largest logit. Returns (all agree, compared
    in full, steps compared, largest first-step |engine - generate| /
    max|logit|, all reference logits finite)."""
    ok, full, steps, worst, finite = True, 0, 0, 0.0, True
    dev = first[requests[0].rid].device
    for r in requests:
        prompt = torch.as_tensor(r.tokens[None].astype(np.int64),
                                 device=dev)
        ref, logits = serve.generate(model, params, prompt, r.max_gen,
                                     with_logits=True)
        finite &= bool(torch.isfinite(logits).all())
        scale = max(1.0, float(logits.abs().max()))
        d0 = float((first[r.rid].float() - logits[0, 0]).abs().max())
        worst = max(worst, d0 / scale)
        tol = (GUARD_F32 * scale if noise is None
               else max(4 * noise, scale * 2.0 ** -8))
        agree, n = serve.agree_under_gap(r.out, ref[0], logits[0], tol)
        if not agree:
            print(f"  request {r.rid}: engine {r.out[:n + 1]} against "
                  f"generate {ref[0, :n + 1].tolist()} within the guard "
                  f"({tol:.3e})", flush=True)
        ok &= agree
        full += n == r.max_gen
        steps += n
    return ok, full, steps, worst, finite


def _serve_workload(torch, serve_pkg, ops, engine, cfg, prompts, kept,
                    n=ENGINE_REQUESTS, gens=ENGINE_GENS):
    """The phase's workload (``n`` requests, budgets ``gens``) through
    ``serve_continuous`` under StepClock on a ``_watched_engine``, each
    model kernel's first call of each shape kept in ``kept``. Returns
    (report, the engine's log)."""
    wl = serve_pkg.poisson_workload(
        n, ENGINE_RATE, cfg.vocab, seed=0, prompt_lens=prompts,
        gen_lens=gens)
    reals = _keeping_first_model_calls(torch, ops, kept)
    try:
        rep = serve_pkg.serve_continuous(engine, wl, clock=serve_pkg.StepClock(
            dt_prefill_token=ENGINE_PREFILL_TOKEN_S))
        torch.cuda.synchronize()
    finally:
        for name, real in reals.items():
            setattr(ops, name, real)
        engine.watching = False
    return rep, engine.log


def _kept_verdict(torch, kept, refs, cfg):
    """The kept calls checked (``_check_kept_model_calls``), and every
    kernel of the arch's path among them. Returns (ok, errs, lines)."""
    ok, errs, lines = _check_kept_model_calls(torch, kept, refs)
    return ok and set(errs) == _arch_kernels(cfg), errs, lines


def run_engine_exactness(torch, np, configs, Transformer, serve, serve_pkg,
                         ops, refs, dev):
    """Phase 17a: the engine on the card in f32 at the published widths,
    depth cut to one step of each segment, SlotEngine(n_slots 4, block 64)
    under StepClock, ENGINE_REQUESTS Poisson requests (gemma3-4b's prompts
    in three buckets, padded; the recurrent archs' at exact lengths): every
    request completes with its budget, at least one joins mid-stream into a
    recycled slot, every slot is free at the end, each model kernel's
    output at its first call of each shape equals its plain version's on
    the same operands, and each request's tokens are those of generate on
    the plain route (kernel_backend "ref") under the gap guard (at least
    one compared in full). Returns (ok, {kernel: max abs err})."""
    ok, worst = True, {}
    for arch, prompts in ENGINE_RUNS:
        cfg = _engine_cfg(configs, arch, "float32")
        model = Transformer(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(2),
                            dev)
        engine = _watched_engine(
            torch, serve_pkg, model, params, n_slots=ENGINE_SLOTS,
            max_len=_engine_max_len(prompts), block_size=ENGINE_BLOCK,
            device=dev)
        engine.warmup(buckets=prompts)
        kept = {}
        t0 = time.perf_counter()
        rep, log = _serve_workload(torch, serve_pkg, ops, engine, cfg,
                                   prompts, kept)
        serve_s = time.perf_counter() - t0
        k_ok, k_errs, k_lines = _kept_verdict(torch, kept, refs, cfg)
        del kept
        for name, err in k_errs.items():
            worst[name] = max(worst.get(name, 0.0), err)
        agree, full, steps, d0, finite = _engine_vs_generate(
            torch, np, serve, Transformer(cfg, kernel_backend="ref"),
            params, rep.requests, log["first"])
        finite &= bool(torch.stack(log["finite"]).all())
        good = (agree and full >= 1 and finite and k_ok
                and len(rep.requests) == ENGINE_REQUESTS
                and all(len(r.out) == r.max_gen for r in rep.requests)
                and log["recycled"] > 0
                and engine.free_slots == ENGINE_SLOTS)
        ok &= good
        print(f"phase 17a {arch} f32 ({cfg.n_layers} layers, max_len "
              f"{engine.max_len}, block {ENGINE_BLOCK}): "
              f"{len(rep.requests)} requests, {engine.steps} steps, "
              f"{len(log['groups'])} prefill groups (size, bucket) "
              f"{log['groups']}, {log['recycled']} joined mid-stream into "
              f"recycled slots, served in {serve_s:.2f} s; the kernels at "
              f"their first call of each shape against their plain "
              f"versions:" + "".join(f"\n  {x}" for x in k_lines)
              + f"\nphase 17a {arch} tokens equal generate on the plain "
              f"route under the guard, {full}/{len(rep.requests)} compared "
              f"in full, {steps}/{sum(r.max_gen for r in rep.requests)} "
              f"steps, first-step max |engine - generate| / max|logit| "
              f"{d0:.3e}; logits finite {finite} "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
        del engine, params, model, log
        torch.cuda.empty_cache()
    return ok, worst


def time_engine_step(torch, np, serve, serve_pkg, model, params, engine, p,
                     arch, n_steps: int = 8, phase: str = "phase 17b"):
    """Phase 17b (and 18b, named by ``phase``): ENGINE_SLOTS requests of p
    tokens, p a bucket (one group whose prefill pads nothing), the largest
    budget, admitted as one group;
    beside them the static path on the same prompts: ``prefill_at`` at B 4
    over the engine's span (its natural layout) and dense ``decode_step``,
    argmax, the tokens fetched as serve_static fetches them. Run in turns,
    static, engine, engine, static, n_steps each: ms per decode step with
    every slot busy. Both paths run the same shapes over the same span, so
    their logits should agree to the bit: each row's tokens are held
    against the static path's, at every step where the logits agree to
    the bit, else under a guard of 4x the largest |logit difference| up to
    the first step whose tokens differ, with at least half of the steps
    compared. Then one profiled engine step, the
    blocking host syncs of one ``engine.step()`` (limit 1) and of one
    ``decode_step(table=...)`` on a paged pool of its own (limit 0), and
    the paged decode's launches against the dense one's per attention
    layer. Returns (ok, {"static": [...], "engine": [...]})."""
    dev = engine.device
    toks_np = np.random.default_rng(17).integers(
        0, model.cfg.vocab, (ENGINE_SLOTS, p)).astype(np.int32)
    reqs = [serve_pkg.Request(rid=1000 + i, arrival=0.0, tokens=toks_np[i],
                              max_gen=max(ENGINE_GENS))
            for i in range(ENGINE_SLOTS)]
    slots = torch.as_tensor(engine.admit(reqs), device=dev)
    toks = torch.as_tensor(toks_np.astype(np.int64), device=dev)
    with torch.inference_mode():
        logits, caches, _ = model.prefill_at(
            params, toks, torch.full((ENGINE_SLOTS,), p, device=dev),
            max_len=engine.max_len)
    state = {"logits": logits, "i": 0}
    rec = {"static": [logits.float()], "engine": [engine.logits[slots]],
           "tok": []}

    def static_steps():
        with torch.inference_mode():
            for _ in range(n_steps):
                tok = torch.argmax(state["logits"], dim=-1)
                state["logits"], _ = model.decode_step(
                    params, caches, tok, p + state["i"])
                rec["tok"].append(tok.cpu())
                rec["static"].append(state["logits"].float())
                state["i"] += 1

    def engine_steps():
        for _ in range(n_steps):
            engine.step()
            rec["engine"].append(engine.logits[slots])

    ms = {"static": [], "engine": []}
    for name in ("static", "engine", "engine", "static"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (static_steps if name == "static" else engine_steps)()
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / n_steps)

    n_tok = 2 * n_steps
    ref_tok = torch.stack(rec["tok"], dim=1)
    ref_logits = torch.stack(rec["static"][:n_tok], dim=1)
    eng_logits = torch.stack(rec["engine"][:n_tok], dim=1)
    diff = 0.0
    for i, r in enumerate(reqs):
        differ = [j for j in range(n_tok) if r.out[j] != int(ref_tok[i, j])]
        k = differ[0] + 1 if differ else n_tok
        diff = max(diff, float((eng_logits[i, :k]
                                - ref_logits[i, :k]).abs().max()))
    agree, compared = True, 0
    for i, r in enumerate(reqs):
        if diff == 0.0:
            # the same logits to the bit: argmax cannot flip, ties too
            good, n = r.out[:n_tok] == ref_tok[i].tolist(), n_tok
        else:
            good, n = serve.agree_under_gap(r.out[:n_tok], ref_tok[i],
                                            ref_logits[i], 4 * diff)
        agree &= good
        compared += n
    tok_ok = agree and 2 * compared >= ENGINE_SLOTS * n_tok
    del rec, ref_logits, eng_logits

    _, eng_launches = _profile_call(
        torch, engine.step, f"{phase} {arch} one engine step (4 slots)")
    _, step_syncs = _blocking_syncs(torch, engine.step)
    bps = engine.blocks_per_slot
    pool = model.init_paged_cache(ENGINE_SLOTS, ENGINE_SLOTS * bps + 1,
                                  ENGINE_BLOCK, dev)
    table = torch.arange(ENGINE_SLOTS * bps, device=dev).view(
        ENGINE_SLOTS, bps)
    pos = torch.full((ENGINE_SLOTS,), p, dtype=torch.int64, device=dev)
    tok0 = torch.zeros(ENGINE_SLOTS, dtype=torch.int64, device=dev)

    def paged():
        with torch.inference_mode():
            return model.decode_step(params, pool, tok0, pos, table)

    _, dec_syncs = _blocking_syncs(torch, paged)
    n_attn = sum(model.cfg.count_mixers().get(k, 0)
                 for k in ("attn", "shared_attn"))
    extra = ""
    if n_attn:
        _, l_paged = _profile_call(torch, paged,
                                   f"{phase} {arch} one paged decode_step")

        def dense():
            with torch.inference_mode():
                return model.decode_step(params, caches, tok0,
                                         p + state["i"])

        _, l_dense = _profile_call(torch, dense,
                                   f"{phase} {arch} one dense decode_step")
        if l_paged is not None and l_dense is not None:
            extra = (f"; paged decode_step {l_paged} launches, dense "
                     f"{l_dense}: {(l_paged - l_dense) / n_attn:.2f} more "
                     f"per attention layer ({n_attn} layers)")
    ok = len(step_syncs) <= 1 and not dec_syncs and tok_ok
    print(f"{phase} {arch} ms per decode step, every slot busy, "
          f"{n_steps} steps a turn (static B {ENGINE_SLOTS} over the "
          f"engine's span of {engine.max_len}, engine, engine, static), "
          f"prompts of {p}: static {ms['static'][0]:.3f} / "
          f"{ms['static'][1]:.3f}, engine {ms['engine'][0]:.3f} / "
          f"{ms['engine'][1]:.3f}; engine step {eng_launches} launches"
          f"{extra}\n{phase} {arch} engine against static B "
          f"{ENGINE_SLOTS} at the same shapes: max |logit difference| "
          f"{diff:.3e} up to the first differing token, the guard 4x; "
          f"tokens agree {agree}, {compared}/{ENGINE_SLOTS * n_tok} steps "
          f"compared (at least half)\n{phase} {arch} blocking host "
          f"syncs: {len(step_syncs)} in one engine.step() (limit 1)"
          f"{_sync_lines(step_syncs)}, {len(dec_syncs)} in one "
          f"decode_step(table=...) (limit 0){_sync_lines(dec_syncs)} "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    del caches, logits, pool
    return ok, ms


def run_engine_full_width(torch, np, configs, Transformer, serve, serve_pkg,
                          ops, refs, counters, card, dev):
    """Phase 17b: the engine at the published widths in bf16, the depths
    cut (ENGINE_BF16_STEPS), random weights from a seeded CUDA generator,
    the workloads of 17a. The
    kernels' counters are set to 0 after ``warmup``, just before the
    served workload, and read just after: flash = attention layers x
    prefill groups, rwkv6_scan = rwkv6 layers x (groups + decode steps),
    mamba2_ssd = mamba2 layers x groups, the row kernels 0. Each model
    kernel's output at its first call of each shape against its plain
    version on the same operands; finite logits at every step; tokens
    against generate under the guard (the requests compared in full and
    the steps printed); prefill ms per group; peak memory beside the
    pools' reckoned bytes; then ``time_engine_step``. Returns (ok,
    {kernel: launches summed over the archs}, {kernel: max abs err})."""
    from repro_torch.utils.tree import tree_leaves
    ok, totals, worst = True, dict.fromkeys(counters, 0), {}
    for arch, prompts in ENGINE_RUNS:
        cfg = _engine_cfg(configs, arch, "bfloat16")
        model = Transformer(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dev)
        n_params = sum(x.numel() for x in tree_leaves(params))
        max_len = _engine_max_len(prompts)
        engine = _watched_engine(
            torch, serve_pkg, model, params, n_slots=ENGINE_SLOTS,
            max_len=max_len, block_size=ENGINE_BLOCK, device=dev)
        warm_s = engine.warmup(buckets=prompts)
        torch.cuda.reset_peak_memory_stats()
        kept = {}
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        rep, log = _serve_workload(torch, serve_pkg, ops, engine, cfg,
                                   prompts, kept)
        serve_s = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        k_ok, k_errs, k_lines = _kept_verdict(torch, kept, refs, cfg)
        del kept
        for name, err in k_errs.items():
            worst[name] = max(worst.get(name, 0.0), err)
        groups, steps = len(log["groups"]), engine.steps
        mixers = cfg.count_mixers()
        want = dict.fromkeys(counters, 0)
        want["flash_attention"] = (mixers.get("attn", 0)
                                   + mixers.get("shared_attn", 0)) * groups
        want["rwkv6_scan"] = mixers.get("rwkv6", 0) * (groups + steps)
        want["mamba2_ssd"] = mixers.get("mamba2", 0) * groups
        finite = bool(torch.stack(log["finite"]).all())
        noise = _batch_noise(torch, np, serve, model, params, rep.requests)
        agree, full, n_steps, d0, ref_finite = _engine_vs_generate(
            torch, np, serve, model, params, rep.requests, log["first"],
            noise)
        good = (launches == want and finite and ref_finite and agree
                and k_ok and len(rep.requests) == ENGINE_REQUESTS
                and all(len(r.out) == r.max_gen for r in rep.requests)
                and engine.free_slots == ENGINE_SLOTS)
        by_bucket = {}
        for (n, bucket), ms in zip(log["groups"], log["ms"]):
            by_bucket.setdefault((bucket, n), []).append(ms)
        print(f"phase 17b {arch} bf16 on {card} ({cfg.n_layers} layers, "
              f"{n_params / 1e9:.3f} B params, max_len {max_len}, block "
              f"{ENGINE_BLOCK}, {ENGINE_SLOTS} slots): warmup {warm_s:.2f} s "
              f"(compile_s), {len(rep.requests)} requests in {serve_s:.2f} s "
              f"wall, {steps} steps, {groups} prefill groups, "
              f"{log['recycled']} joined mid-stream into recycled slots; "
              f"prefill ms per group (bucket, rows): "
              + ", ".join(f"({b}, {n}) " + "/".join(f"{m:.2f}" for m in v)
                          for (b, n), v in sorted(by_bucket.items()))
              + f"; max_memory_allocated {peak_gb:.2f} GB (params "
              f"{2 * n_params / 1e9:.2f} GB, pools reckoned "
              f"{_pool_bytes(cfg, max_len) / 1e9:.3f} GB); launches "
              + ", ".join(f"{k}={v}" for k, v in launches.items()
                          if v or want[k])
              + " (expected " + ", ".join(f"{k}={v}" for k, v in want.items()
                                          if v)
              + f"); the kernels at their first call of each shape against "
              f"their plain versions:" + "".join(f"\n  {x}" for x in k_lines)
              + f"\nphase 17b {arch} logits finite {finite and ref_finite}; "
              f"generate B 1 against B {ENGINE_SLOTS}, max |logit "
              f"difference| {noise:.3e} (the guard: 4x); tokens equal "
              f"generate under the guard, {full}/{len(rep.requests)} "
              f"compared in full, {n_steps}/"
              f"{sum(r.max_gen for r in rep.requests)} steps, first-step "
              f"max |engine - generate| / max|logit| {d0:.3e} "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
        t_ok, _ = time_engine_step(torch, np, serve, serve_pkg, model,
                                   params, engine,
                                   engine.bucket_len(min(prompts)), arch)
        ok &= good and t_ok
        for name, n in launches.items():
            totals[name] += n
        del engine, params, model, log
        torch.cuda.empty_cache()
    return ok, totals, worst


def run_serve_benchmark(torch):
    """Phase 17c: benchmarks/serve_torch.py --check on cuda at gemma3-4b's
    full width with its own workload (prompts 5 / 8 / 12, budgets 4 / 9,
    32 requests a load, 4 slots, block 8), each load SERVE_REPEATS times
    with the two modes in turns: continuous's median tokens/s above
    static's at every load, and the same tokens in every run. Prints its
    rows and the medians."""
    import tempfile

    import benchmarks.serve_torch as bench
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "serve.json"
        t0 = time.perf_counter()
        rc = bench.main(["--check", "--device", "cuda", "--repeats",
                         str(SERVE_REPEATS), "--out", str(out)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        report = json.loads(out.read_text()) if out.exists() else {}
    for row in report.get("results", ()):
        print(f"phase 17c row {json.dumps(row)}", flush=True)
    for med in report.get("median_tokens_per_s", ()):
        print(f"phase 17c load {med['load']} median tokens/s over "
              f"{SERVE_REPEATS} runs: continuous {med['continuous']}, static "
              f"{med['static']} ({med['continuous'] / med['static']:.3f}x)",
              flush=True)
    print(f"phase 17c serve_torch --check --device cuda: rc={rc} in "
          f"{secs:.2f} s, config {json.dumps(report.get('config'))} "
          f"{'ok' if rc == 0 else 'CHECK FAILED'}", flush=True)
    torch.cuda.empty_cache()
    return rc == 0


def run_serve_example():
    """Phase 17d: examples/serve_continuous_torch.py on cuda (federate,
    serve, hot-swap, exactness) in its own process."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_continuous_torch.py")],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=600)
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-12:]:
        print(f"  {line}", flush=True)
    print(f"phase 17d serve_continuous_torch.py on cuda: rc="
          f"{proc.returncode} in {time.perf_counter() - t0:.2f} s "
          f"{'ok' if proc.returncode == 0 else 'CHECK FAILED'}", flush=True)
    return proc.returncode == 0


# -- phase 18: the MoE archs and the chunked mixers ---------------------------

def _param_reckoning(Transformer, cfg) -> tuple[float, str]:
    """The params' bytes from the code (``init`` on the meta device), in GB,
    and a line: the count, the routed experts' share, the routers'."""
    from repro_torch.utils.tree import tree_flatten, tree_leaf_paths
    meta = Transformer(cfg).init(device="meta")
    leaves = list(zip(tree_leaf_paths(meta), tree_flatten(meta)[0]))
    n = sum(x.numel() for _, x in leaves)
    gb = sum(x.numel() * x.element_size() for _, x in leaves) / 1e9
    # the routed experts are the FFN weights with an expert axis: (steps,
    # E, d, f)
    experts = sum(x.numel() for p, x in leaves if x.dim() == 4
                  and p.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down"))
    routers = sum(x.numel() for p, x in leaves if p.endswith("/router"))
    return gb, (f"{n / 1e9:.3f} B params, {gb:.2f} GB from the code "
                f"(routed experts {experts / 1e9:.3f} B, routers "
                f"{routers:,} f32)")


def run_moe_serving(torch, np, configs, Transformer, serve, serve_pkg, ops,
                    moe_mod, counters, refs, card):
    """Phase 18a-c, per MoE arch of MOE_SERVE_RUNS, on one model initialised
    on the card in bf16 from a seeded CUDA generator:

    (a) ``launch.serve.generate`` at the run's batch, prompt and budget; the
    counters set to 0 just before and read just after: flash_attention once
    per attention layer (the prefill; a chunked layer as one call over
    (B * n_chunks, H, chunk, hd)), the other kernels 0; finite logits,
    prefill ms and decode ms a token, peak memory beside the params' bytes
    from the code; one profiled prefill naming the MoE stages' device time;

    (b) the SlotEngine (ENGINE_SLOTS slots, blocks of ENGINE_BLOCK),
    MOE_ENGINE_REQUESTS Poisson requests at MOE_ENGINE_PROMPTS, budget
    MOE_ENGINE_GEN: flash = attention layers x prefill groups, finite
    logits; then the phase 17b same-shape check (``time_engine_step``).
    That a decode step's MoE groups all the slots into one capacity group
    (``moe._regroup``) is held by tests/test_torch_moe.py;

    (c) kernel_backend "auto" against "ref" on the same params: prefill of
    MOE_ROUTE_B x MOE_ROUTE_PROMPT and 8 teacher-forced decode steps, the
    relative L2 gap of the logits at most MOE_ROUTE_TOL a step with the
    plain route's routers pinned to the kernel route's choices
    (:func:`compare_moe_routes`).

    Each flash call's first output of each shape in (a)-(c) is kept and,
    once the model is freed, held against flash_attention_ref on the same
    operands (phase 17b's criteria). Returns (ok, {path: flash launches},
    max abs err)."""
    import gc
    from repro_torch.utils.tree import tree_leaves
    ok, paths, worst = True, {}, 0.0
    for arch, steps, b, prompt, gen in MOE_SERVE_RUNS:
        cfg = _depth_cut(configs, arch, steps)
        reckoned_gb, reckoning = _param_reckoning(Transformer, cfg)
        model = Transformer(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params_gb = torch.cuda.memory_allocated() / 1e9
        init_peak = torch.cuda.max_memory_allocated() / 1e9
        n_params = sum(x.numel() for x in tree_leaves(params))
        gen_t = torch.Generator(device="cuda").manual_seed(0)
        prompts = torch.randint(0, cfg.vocab, (b, prompt), generator=gen_t,
                                device="cuda")
        print(f"phase 18 {arch} on {card}: {cfg.name} ({cfg.n_layers} of "
              f"{configs.get_arch(arch).n_layers} layers at the published "
              f"widths, {cfg.dtype}): {reckoning}; init {init_s:.2f} s, "
              f"memory_allocated {params_gb:.2f} GB, init peak "
              f"{init_peak:.2f} GB", flush=True)
        serve.generate(model, params, prompts[:, :64], 2)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = serve.generate(model, params, prompts, gen)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        launches = {name: c.launches for name, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_attn = cfg.count_mixers().get("attn", 0)
        want = {**dict.fromkeys(counters, 0), "flash_attention": n_attn}
        kept = {}
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, caches, pos = model.prefill(params, prompts,
                                                max_len=prompt + gen)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            tok = torch.argmax(logits, dim=-1)
            step_logits, caches = model.decode_step(params, caches, tok, pos)
            finite = bool(torch.isfinite(logits).all()
                          and torch.isfinite(step_logits).all())
            del caches, logits, step_logits
            reals = _keeping_first_model_calls(torch, ops, kept)
            try:
                model.prefill(params, prompts, max_len=prompt + gen)
            finally:
                for name, real in reals.items():
                    setattr(ops, name, real)
            _profile_call(torch, lambda: model.prefill(
                params, prompts, max_len=prompt + gen),
                f"phase 18a {arch} one prefill (B {b}, {prompt} tokens)",
                ranges=(moe_mod, MOE_STAGES))
        decode_ms = (total_ms - prefill_ms) / gen
        good = (launches == want and finite and out.shape == (b, gen)
                and int(out.min()) >= 0 and int(out.max()) < cfg.vocab)
        ok &= good
        paths["18a"] = paths.get("18a", 0) + launches["flash_attention"]
        print(f"phase 18a {arch} generate: B {b}, prompt {prompt}, {gen} "
              f"greedy tokens: {total_ms:.2f} ms, prefill {prefill_ms:.2f} "
              f"ms, decode {decode_ms:.3f} ms/token ((generate - prefill) / "
              f"tokens); max_memory_allocated {peak_gb:.2f} GB (params "
              f"{reckoned_gb:.2f} GB reckoned from the code, "
              f"{params_gb:.2f} allocated); launches "
              + ", ".join(f"{k}={v}" for k, v in launches.items()
                          if v or want[k])
              + f" (expected flash_attention={n_attn}: one per attention "
              f"layer, the rest 0); logits finite {finite}; tokens "
              f"{out[0, :8].tolist()} {'ok' if good else 'CHECK FAILED'}",
              flush=True)
        del out

        e_ok, e_launches = run_moe_engine(
            torch, np, serve, serve_pkg, ops, model, params, cfg, counters,
            kept, arch)
        ok &= e_ok
        paths["18b"] = paths.get("18b", 0) + e_launches
        r_ok, r_launches = compare_moe_routes(
            torch, ops, moe_mod, Transformer, cfg, model, params, kept,
            counters["flash_attention"], arch)
        ok &= r_ok
        paths["18c"] = paths.get("18c", 0) + r_launches
        del params, model, prompts
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 18 {arch} freed: memory_allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB (the kept "
              f"operands)", flush=True)
        k_ok, k_errs, k_lines = _check_kept_model_calls(torch, kept, refs)
        del kept
        torch.cuda.empty_cache()
        k_ok &= set(k_errs) == {"flash_attention"}
        worst = max([worst] + list(k_errs.values()))
        ok &= k_ok
        print(f"phase 18 {arch}: each flash_attention call's first output "
              f"of each shape in 18a-c against flash_attention_ref on the "
              f"same operands (f32):" + "".join(f"\n  {x}" for x in k_lines)
              + f"\nphase 18 {arch} kept calls "
              f"{'ok' if k_ok else 'CHECK FAILED'}", flush=True)
    return ok, paths, worst


def run_moe_engine(torch, np, serve, serve_pkg, ops, model, params, cfg,
                   counters, kept, arch):
    """Phase 18b on the caller's model (see :func:`run_moe_serving`).
    Returns (ok, flash launches)."""
    prompts = MOE_ENGINE_PROMPTS
    max_len = _engine_max_len(prompts)
    engine = _watched_engine(torch, serve_pkg, model, params,
                             n_slots=ENGINE_SLOTS, max_len=max_len,
                             block_size=ENGINE_BLOCK, device="cuda")
    warm_s = engine.warmup(buckets=prompts)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rep, log = _serve_workload(torch, serve_pkg, ops, engine, cfg, prompts,
                               kept, n=MOE_ENGINE_REQUESTS,
                               gens=(MOE_ENGINE_GEN,))
    serve_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    groups, steps = len(log["groups"]), engine.steps
    n_attn = cfg.count_mixers().get("attn", 0)
    want = {**dict.fromkeys(counters, 0),
            "flash_attention": n_attn * groups}
    finite = bool(torch.stack(log["finite"]).all())
    good = (launches == want and finite
            and len(rep.requests) == MOE_ENGINE_REQUESTS
            and all(len(r.out) == r.max_gen for r in rep.requests)
            and engine.free_slots == ENGINE_SLOTS)
    by_bucket = {}
    for (n, bucket), ms in zip(log["groups"], log["ms"]):
        by_bucket.setdefault((bucket, n), []).append(ms)
    print(f"phase 18b {arch} engine ({ENGINE_SLOTS} slots, block "
          f"{ENGINE_BLOCK}, max_len {max_len}): warmup {warm_s:.2f} s, "
          f"{len(rep.requests)} requests in {serve_s:.2f} s wall, {steps} "
          f"steps, {groups} prefill groups, {log['recycled']} joined "
          f"mid-stream into recycled slots; prefill ms per group (bucket, "
          f"rows): " + ", ".join(f"({bk}, {n}) " + "/".join(
              f"{m:.2f}" for m in v) for (bk, n), v in sorted(
                  by_bucket.items()))
          + f"; max_memory_allocated {peak_gb:.2f} GB; launches "
          + ", ".join(f"{k}={v}" for k, v in launches.items()
                      if v or want[k])
          + f" (expected flash_attention={want['flash_attention']}); "
          f"logits finite {finite} "
          f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    t_ok, _ = time_engine_step(torch, np, serve, serve_pkg, model, params,
                               engine, engine.bucket_len(min(prompts)), arch,
                               phase="phase 18b")
    del engine, log, rep
    torch.cuda.empty_cache()
    return good and t_ok, launches["flash_attention"]


def compare_moe_routes(torch, ops, moe_mod, Transformer, cfg, model, params,
                       kept, flash, arch):
    """Phase 18c on the caller's model (see :func:`run_moe_serving`):
    prefill and 8 teacher-forced decode steps on the kernel route ("auto"),
    the plain route ("ref") and the plain route with its routers pinned to
    the kernel route's choices ("ref pinned": each ``moe._route`` call
    returns the kernel route's weights, ids and aux of the same call), all
    fed the kernel route's greedy token. In bf16 a rounding difference
    moves an expert choice (a near-tie of router probabilities), and one
    moved choice moves a token's output by a whole expert, so the gate
    reads the pinned route: its relative L2 gap to the kernel route at most
    MOE_ROUTE_TOL a step; the unpinned gap and the routers' agreement are
    printed. Returns (ok, the kernel route's flash launches)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (MOE_ROUTE_B, MOE_ROUTE_PROMPT),
                            generator=gen, device="cuda")
    ref = Transformer(cfg, kernel_backend="ref")
    routes = {"auto": model, "ref": ref, "ref pinned": ref}
    ids, chosen, served = {"auto": [], "ref": []}, [], [0]
    real_route = moe_mod._route
    current = ["auto"]

    def route(*a, **kw):
        if current[0] == "ref pinned":
            served[0] += 1
            return chosen[served[0] - 1]
        out = real_route(*a, **kw)
        ids[current[0]].append(out[1])
        if current[0] == "auto":
            chosen.append(out)
        return out

    steps, state = [], {}
    flash.launches = 0
    moe_mod._route = route
    try:
        with torch.inference_mode():
            for name, m in routes.items():
                current[0] = name
                reals = (_keeping_first_model_calls(torch, ops, kept)
                         if name == "auto" else {})
                try:
                    logits, caches, pos = m.prefill(
                        params, prompts, max_len=MOE_ROUTE_PROMPT + 8)
                finally:
                    for n, real in reals.items():
                        setattr(ops, n, real)
                state[name] = [logits, caches]
            steps.append({n: v[0] for n, v in state.items()})
            for i in range(8):
                tok = torch.argmax(state["auto"][0], dim=-1)
                for name, m in routes.items():
                    current[0] = name
                    state[name] = list(m.decode_step(
                        params, state[name][1], tok, pos + i))
                steps.append({n: v[0] for n, v in state.items()})
    finally:
        moe_mod._route = real_route
    launches = flash.launches
    free = [_rel(torch, st["auto"], st["ref"]) for st in steps]
    pinned = [_rel(torch, st["auto"], st["ref pinned"]) for st in steps]
    same = sum(int((a == r).sum()) for a, r in zip(ids["auto"], ids["ref"]))
    total = sum(a.numel() for a in ids["auto"])
    finite = all(bool(torch.isfinite(v).all()) for st in steps
                 for v in st.values())
    n_attn = cfg.count_mixers().get("attn", 0)
    good = (finite and max(g[1] for g in pinned) <= MOE_ROUTE_TOL
            and launches == n_attn and served[0] == len(chosen)
            and len(ids["auto"]) == len(ids["ref"]))
    print(f"phase 18c {arch} auto vs ref, {cfg.dtype}, B {MOE_ROUTE_B}, "
          f"prompt {MOE_ROUTE_PROMPT}, prefill + 8 teacher-forced decode "
          f"steps: routers pinned to the kernel route's choices, max gap / "
          f"max|logit| {max(g[0] for g in pinned):.3e}, relative L2 per "
          f"step " + ", ".join(f"{g[1]:.3e}" for g in pinned)
          + f" (limit {MOE_ROUTE_TOL}); each route its own router: max gap "
          f"/ max|logit| {max(g[0] for g in free):.3e}, relative L2 per "
          f"step " + ", ".join(f"{g[1]:.3e}" for g in free)
          + f", router ids equal in {same:,} of {total:,} assignments over "
          f"{len(ids['auto'])} MoE calls; kernel route flash launches "
          f"{launches} (expected {n_attn}); finite {finite} "
          f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    del steps, state, routes, ids, chosen
    torch.cuda.empty_cache()
    return good, launches


def run_chunked_wkv(torch, configs, Transformer, rwkv6_scan, card):
    """Phase 18e: rwkv6-1.6b's widths (d 2048, 32 heads of 64), one layer,
    f32, B WKV_B, seq WKV_SEQ, from one seeded init: logits of the training
    route with ``rwkv_chunk`` WKV_CHUNK (``wkv6_chunked``) against it with
    ``rwkv_chunk`` 0 (``wkv6_scan``), and the serving route (``forward``:
    one ``rwkv6_scan`` call, its f32 SIMT instance) against both; each gap
    at most 1e-4 of the largest logit (phase 12's f32 criterion). Returns
    (ok, rwkv6_scan launches)."""
    import dataclasses
    from repro_torch.models.layers import unembed
    scan_cfg = dataclasses.replace(_depth_cut(configs, "rwkv6-1.6b", 1),
                                   dtype="float32")
    chunk_cfg = dataclasses.replace(scan_cfg, rwkv_chunk=WKV_CHUNK)
    chunked, scan = Transformer(chunk_cfg), Transformer(scan_cfg)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = chunked.init(gen, "cuda")
    tokens = torch.randint(0, scan_cfg.vocab, (WKV_B, WKV_SEQ),
                           generator=gen, device="cuda")
    out, ms = {}, {}
    with torch.no_grad():
        for name, fn in (
                ("train chunked", lambda: unembed(params["embed"], (
                    chunked._hidden_states(params, tokens, None)[0]))),
                ("train scan", lambda: unembed(params["embed"], (
                    scan._hidden_states(params, tokens, None)[0]))),
                ("serving", lambda: chunked.forward(params, tokens)[0])):
            rwkv6_scan.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            ms[name] = ((time.perf_counter() - t0) * 1e3,
                        rwkv6_scan.launches)
    pairs = (("train chunked", "train scan"), ("serving", "train chunked"),
             ("serving", "train scan"))
    gaps = {p: _rel(torch, out[p[0]], out[p[1]]) for p in pairs}
    n_rwkv = scan_cfg.count_mixers().get("rwkv6", 0)
    ok = (all(g[0] <= 1e-4 for g in gaps.values())
          and all(bool(torch.isfinite(v).all()) for v in out.values())
          and ms["serving"][1] == n_rwkv and ms["train chunked"][1] == 0
          and ms["train scan"][1] == 0)
    print(f"phase 18e on {card}: rwkv6-1.6b's widths, {scan_cfg.n_layers} "
          f"layer, f32, B {WKV_B}, seq {WKV_SEQ}, rwkv_chunk {WKV_CHUNK}: "
          + "; ".join(f"{a} vs {b} max gap / max|logit| {g[0]:.3e}, "
                      f"relative L2 {g[1]:.3e}" for (a, b), g in gaps.items())
          + " (limit 1e-4); ms and rwkv6_scan launches: "
          + ", ".join(f"{k} {v[0]:.2f} ms / {v[1]}" for k, v in ms.items())
          + f" (serving {n_rwkv}, {rwkv6_scan.last_variant}; training 0) "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    del out, params
    torch.cuda.empty_cache()
    return ok, ms["serving"][1]


# -- phase 19: the measurement toolchain and the last API names ---------------

ROW_KERNELS = ("dp_clip_noise", "quantize_decompress",
               "cohort_gather_scatter")
OUT19 = ROOT / "experiments" / "chip_smoke_phase19"   # git-ignored
# 19b: phase 11's gemma3-4b prefill shape (B 2 x 2,048, bf16), and the
# share of the dry run's live bytes its measured peak must fall within
PREFILL_B, PREFILL_S, PREFILL_ITERS, MEM_TOL = 2, 2048, 5, 0.25
# 19d: the launcher's smoke command, and a device budget below any
# replica's footprint
ENV_ARGV = ["--arch", "gemma3-4b", "--smoke", "--rounds", "2", "--clients",
            "2", "--tau", "1", "--batch", "1", "--seq", "64",
            "--env-profile", "host", "--replica-hint"]
SMALL_BUDGET = str(1 << 20)
# 19b: the background dry run's worker processes, and how long phase 19
# waits for it at most
DRYRUN_JOBS, DRYRUN_WAIT_S = 2, 300


def run_throughput_smoke(torch, counters):
    """Phase 19a: benchmarks/throughput_torch.py --smoke --check --device
    cuda in this process. Every row prints; each row kernel is timed
    against its plain version on the same operands and must equal it
    (bitwise for QSGD and the gather, 1e-5 for dp_clip_noise); its time
    is set beside its H100 bound. Returns (ok, the row kernels' launches on
    the benchmark's driver paths: the kernel roofline's comparison calls
    are left out)."""
    import benchmarks.throughput_torch as tp
    OUT19.mkdir(parents=True, exist_ok=True)
    out = OUT19 / "BENCH_throughput_torch.json"
    compared = dict.fromkeys(ROW_KERNELS, 0)
    real = tp.run_kernel_roofline

    def roofline(*a, **kw):
        before = {n: counters[n].launches for n in ROW_KERNELS}
        res = real(*a, **kw)
        for n in ROW_KERNELS:
            compared[n] += counters[n].launches - before[n]
        return res

    for n in ROW_KERNELS:
        counters[n].launches = 0
    tp.run_kernel_roofline = roofline
    t0 = time.perf_counter()
    try:
        rc = tp.main(["--smoke", "--check", "--device", "cuda", "--out",
                      str(out)])
    finally:
        tp.run_kernel_roofline = real
    wall = time.perf_counter() - t0
    launches = {n: counters[n].launches - compared[n] for n in ROW_KERNELS}
    report = json.loads(out.read_text())
    rows = report["kernel_roofline"]["rows"]
    by = {(r["kernel"], r["backend"]): r for r in rows}
    for name in ROW_KERNELS:
        k, p = by[(name, "kernel")], by[(name, "plain")]
        print(f"phase 19a roofline {name} {k['shape']}: kernel "
              f"{k['wall_us'] / 1e3:.5f} ms, plain {p['wall_us'] / 1e3:.5f} "
              f"ms, H100 bound {k['h100_bound_us'] / 1e3:.6f} ms "
              f"({k['h100_bottleneck']}-bound; {k['flops']:.0f} flops, "
              f"{k['hbm_bytes']:.0f} bytes from the kernel's cost), share "
              f"of the bound {k['h100_bound_us'] / k['wall_us']:.4f}, "
              f"{k['fraction_of_h100_hbm_bw']:.4f} of HBM bandwidth; vs "
              f"plain {k['max_abs_err_vs_plain']!r} "
              f"{'ok' if k['matches_plain'] else 'MISMATCH'}", flush=True)
    ok = (rc == 0 and all(r["matches_plain"] for r in rows)
          and launches["dp_clip_noise"] > 0
          and launches["cohort_gather_scatter"] > 0)
    print(f"phase 19a throughput_torch.py --smoke --check --device cuda: "
          f"exit {rc}, {wall:.1f} s; driver-path launches "
          + ", ".join(f"{n}={v}" for n, v in launches.items())
          + f" (roofline comparison calls left out: {compared}) "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    return ok, launches


def start_dryrun():
    """Phase 19b's dry run (``repro_torch.launch.dryrun --all``: the ten
    archs at the four shapes, on meta tensors), started in the background
    after the build, with no CUDA device visible to it, so it overlaps
    the card's phases 2-18 (its traces are host work, minutes of it).
    Returns ``(process, start time)``; the process is killed at exit if
    it is still running."""
    import atexit
    import os
    import signal
    OUT19.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    log = open(OUT19 / "dryrun.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--jobs", str(DRYRUN_JOBS), "--out-dir", str(OUT19 / "dryrun")],
        env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()

    atexit.register(stop)
    return proc, time.perf_counter()


def run_dryrun_and_prefill(torch, configs, Transformer, counters, card,
                           dry):
    """Phase 19b: the dry run of all ten archs at the four shapes on meta
    tensors (``dry``, from :func:`start_dryrun`: no device visible to it),
    then gemma3-4b's prefill shape traced here on meta (no device memory
    allocated) and run for real in bf16 at B 2 x 2,048: its measured ms
    against the dry run's roofline bound for that shape (the model-level
    share of the bound) and its measured peak memory against the dry
    run's live bytes. Returns (ok, flash launches of the timed prefills,
    the record)."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    proc, t_start = dry
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    waited = time.perf_counter() - t0
    recs = [json.loads(p.read_text())
            for p in sorted((OUT19 / "dryrun").glob("*.json"))]
    status = {s: sum(r["status"] == s for r in recs)
              for s in ("traced", "skipped", "error")}
    traced_s = sum(r.get("trace_s", 0.0) for r in recs)
    print(f"phase 19b dryrun --all --jobs {DRYRUN_JOBS} on meta (no CUDA "
          f"device visible): exit {rc}, {status}, {traced_s:.1f} s of "
          f"traces, started {t0 - t_start:.1f} s before this phase, waited "
          f"{waited:.1f} s here", flush=True)
    for r in recs:
        if r["status"] == "error":
            print(f"  {r['arch']} {r['shape']}: {r['error']}", flush=True)
        elif r["status"] == "traced":
            t = r["roofline"]
            print(f"  {r['arch']} {r['shape']}: bound "
                  f"{dryrun.bound_ms(r):.3f} ms ({t['bottleneck']}), "
                  f"{t['flops_per_device']:.4g} flops, "
                  f"{t['hbm_bytes_per_device']:.4g} bytes, live "
                  f"{r['live_bytes_per_device'] / 2**30:.2f} GiB, useful "
                  f"{t['useful_flops_fraction']:.3f}, trace "
                  f"{r['trace_s']} s", flush=True)
    shape = InputShape(f"prefill_{PREFILL_S // 1024}k", PREFILL_S, PREFILL_B,
                       "prefill")
    mem0 = torch.cuda.memory_allocated()
    rec = dryrun.run_one("gemma3-4b", shape.name, shape=shape)
    mem1 = torch.cuda.memory_allocated()
    bound = dryrun.bound_ms(rec)
    live = rec["live_bytes_per_device"]
    cfg = configs.get_arch("gemma3-4b")
    model = Transformer(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, "cuda")
    prompts = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                            generator=gen, device="cuda")
    flash = counters["flash_attention"]
    with torch.inference_mode():
        model.prefill(params, prompts, max_len=PREFILL_S)      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.launches = 0
        times = []
        for _ in range(PREFILL_ITERS):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            logits, caches, _ = model.prefill(params, prompts,
                                              max_len=PREFILL_S)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            finite = bool(torch.isfinite(logits).all())
            del logits, caches
        launches = flash.launches
        peak = torch.cuda.max_memory_allocated()
    ms = sorted(times)[len(times) // 2]
    attn = cfg.count_mixers().get("attn", 0)
    r = rec["roofline"]
    ratio = peak / live
    print(f"phase 19b gemma3-4b prefill B {PREFILL_B} x {PREFILL_S} bf16 on "
          f"{card}: median {ms:.3f} ms of {PREFILL_ITERS} "
          f"({', '.join(f'{t:.3f}' for t in times)}); dry-run bound "
          f"{bound:.3f} ms ({r['bottleneck']}-bound: compute "
          f"{r['t_compute_s'] * 1e3:.3f} ms for {r['flops_per_device']:.4g} "
          f"flops, memory {r['t_memory_s'] * 1e3:.3f} ms for "
          f"{r['hbm_bytes_per_device']:.4g} bytes), share of the bound "
          f"{bound / ms:.4f}; useful flops "
          f"{r['useful_flops_fraction']:.4f}", flush=True)
    print(f"phase 19b the prefill's dry run here: memory_allocated {mem0} "
          f"-> {mem1} bytes, trace {rec['trace_s']} s", flush=True)
    print(f"phase 19b memory: measured peak {peak / 1e9:.3f} GB against the "
          f"dry run's live bytes {live / 1e9:.3f} GB (params "
          f"{rec['memory_analysis']['params_bytes'] / 1e9:.3f} + inputs "
          f"{rec['memory_analysis']['inputs_bytes'] / 1e9:.6f} + trace peak "
          f"{rec['memory_analysis']['temp_peak_bytes'] / 1e9:.3f}): ratio "
          f"{ratio:.4f} ({'within' if abs(ratio - 1) <= MEM_TOL else 'OUTSIDE'}"
          f" {MEM_TOL:.0%}); flash launches {launches} (expected "
          f"{attn * PREFILL_ITERS})", flush=True)
    ok = (rc == 0 and mem1 == mem0 and status["error"] == 0
          and status["traced"] + status["skipped"] == 40
          and finite and launches == attn * PREFILL_ITERS)
    print(f"phase 19b {'ok' if ok else 'CHECK FAILED'}", flush=True)
    del params, prompts, model
    torch.cuda.empty_cache()
    rec.update({"measured_ms": ms, "measured_peak_bytes": peak})
    (OUT19 / "gemma3_prefill_2k.json").write_text(json.dumps(rec, indent=2))
    return ok, launches, rec


def run_federation(torch, np, api, linear, optim, spec, fed, dp_clip_noise):
    """Phase 19c: repro_torch.api.Federation trains the main path's Adult-1
    spec at full width on cuda under its budgets (the quickstart's C_th
    1000, eps_th 4) and must equal api.train on the same spec (rounds,
    resource_spent, epsilon, params) with dp_clip_noise launched on its
    path; then a Federation saved halfway by save_federation_state and
    loaded into a fresh one resumes to the uninterrupted run bitwise.
    Returns (ok, dp_clip_noise launches of the Federation.train run)."""
    import tempfile

    from repro_torch.checkpoint import (
        load_federation_state,
        save_federation_state,
    )
    from repro_torch.core.fl import FLConfig
    dim = fed.clients[0].x_train.shape[1]

    def make():
        return api.Federation(
            cfg=FLConfig(n_clients=spec.n_clients, tau=spec.tau,
                         clip_norm=spec.clip_norm, dp=True),
            loss_fn=linear.logreg_loss, optimizer=optim.sgd(LR),
            params0=linear.init_linear(dim, device="cuda"),
            sampler=fed.make_sampler(BATCH), sigmas=np.asarray(spec.sigmas),
            delta=spec.delta, batch_sizes=list(spec.batch_sizes),
            seed=spec.seed, device="cuda")

    state = api.init_state(spec, linear.init_linear(dim, device="cuda"),
                           device="cuda")
    state, ref = api.train(spec, state, fed.make_sampler(BATCH))
    budgets = spec.budgets()
    f = make()
    torch.cuda.synchronize()
    dp_clip_noise.launches = 0
    t0 = time.perf_counter()
    out = f.train(budgets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dp_clip_noise.launches
    same = (out["rounds"], out["resource_spent"], out["max_epsilon"]) == (
        ref["rounds"], ref["resource_spent"], ref["max_epsilon"])
    bitwise = all(torch.equal(f.params[k], state.params[k])
                  for k in state.params)
    half = max(1, out["rounds"] // 2)
    g = make()
    g.train(budgets, max_rounds=half)
    with tempfile.TemporaryDirectory() as d:
        save_federation_state(d, g)
        rng = g._rng.bit_generator.state
        g.train(budgets)
        h = make()
        load_federation_state(d, h)
    h._rng.bit_generator.state = rng
    h.train(budgets)
    resumed = (h.rounds_done == g.rounds_done == out["rounds"]
               and all(torch.equal(h.params[k], g.params[k])
                       for k in g.params)
               and h.accountant.max_epsilon() == g.accountant.max_epsilon())
    ok = (same and bitwise and resumed
          and launches == spec.tau * out["rounds"] > 0)
    print(f"phase 19c Federation.train on Adult-1 (cuda): rounds "
          f"{out['rounds']} cost {out['resource_spent']!r} epsilon "
          f"{out['max_epsilon']!r} against api.train {ref['rounds']} "
          f"{ref['resource_spent']!r} {ref['max_epsilon']!r} "
          f"({'equal' if same else 'DIFFERENT'}; params "
          f"{'bitwise equal' if bitwise else 'DIFFERENT'}); "
          f"{wall * 1e3:.1f} ms; dp_clip_noise launches {launches} "
          f"(expected tau x rounds {spec.tau * out['rounds']}); saved at "
          f"round {half} and resumed: "
          f"{'bitwise equal' if resumed else 'DIFFERENT'} "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    return ok, launches


def run_launcher_env():
    """Phase 19d: ``launch.train --smoke --env-profile host --replica-hint``
    on cuda in a fresh process: it re-execs once under the host profile
    and trains (the replica hint fits, engine 'auto' resolves to vmap);
    with REPRO_DEVICE_MEM_BYTES below the footprint the same command
    raises ValueError: engine 'auto' places the replica on mesh_2d, and a
    world of one has no model axis to split it over."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_ENV_PROFILE_APPLIED", None)
    env.pop("REPRO_DEVICE_MEM_BYTES", None)
    argv = [sys.executable, "-m", "repro_torch.launch.train"] + ENV_ARGV
    t0 = time.perf_counter()
    runs = [subprocess.Popen(argv, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=e,
                             cwd=ROOT)
            for e in (env, dict(env, REPRO_DEVICE_MEM_BYTES=SMALL_BUDGET))]
    (p_out, p_err), (q_out, q_err) = (r.communicate(timeout=600)
                                      for r in runs)
    wall = time.perf_counter() - t0
    p = subprocess.CompletedProcess(argv, runs[0].returncode, p_out, p_err)
    q = subprocess.CompletedProcess(argv, runs[1].returncode, q_out, q_err)
    out = p.stdout
    try:
        summary = json.loads(out[out.index("{"):out.rindex("}") + 1])
    except ValueError:
        summary = {}
    env_lines = [ln for ln in out.splitlines() if ln.startswith("[env]")]
    hint = [ln for ln in out.splitlines() if "replica footprint" in ln]
    ok_run = (p.returncode == 0 and len(env_lines) == 1
              and len(hint) == 1 and summary.get("rounds") == 2)
    ok_big = (q.returncode != 0 and "ValueError" in q.stderr
              and "needs a model axis of at least" in q.stderr)
    print(f"phase 19d launch.train {' '.join(ENV_ARGV)} (cuda; the two "
          f"runs side by side, {wall:.1f} s): exit "
          f"{p.returncode}, {env_lines} {hint}, rounds "
          f"{summary.get('rounds')} final_loss {summary.get('final_loss')} "
          f"{'ok' if ok_run else 'CHECK FAILED'}", flush=True)
    if not ok_run:
        print(p.stdout[-2000:], p.stderr[-3000:], flush=True)
    last = (q.stderr.strip().splitlines() or [""])[-1]
    print(f"phase 19d the same with REPRO_DEVICE_MEM_BYTES={SMALL_BUDGET}: "
          f"exit {q.returncode}: {last} "
          f"{'ok' if ok_big else 'CHECK FAILED'}", flush=True)
    return ok_run and ok_big


SHARD_RUNS = (("dense", {}),
              ("qsgd8_q50", dict(compressor="qsgd", compression_bits=8,
                                 participation=0.5)),
              ("trimmed_mean", dict(aggregator="trimmed_mean",
                                    trim_fraction=0.1)))
# phase 20b: one client block in a world of two, the second rank outside
# the mesh
SHARD_SPECTATOR = ("dense mesh_2d(1,1)", dict(engine="mesh_2d",
                                              mesh_shape=(1, 1)))
SHARD_TIMED = 50       # phase 20a: steady rounds a timed turn


def _fl_bits(torch, np, a, b) -> bool:
    """Two FLStates (or population states' .fl) equal bit for bit: params,
    optimizer state, residual, generator key, rho, steps, cost, rounds."""
    same = all(_same_bits(torch, x, y) for x, y in zip(
        _leaves((a.params, a.opt_state, a.residual, a.key)),
        _leaves((b.params, b.opt_state, b.residual, b.key))))
    return (same and np.array_equal(a.rho, b.rho)
            and (a.steps, a.resource_spent, a.rounds_done)
            == (b.steps, b.resource_spent, b.rounds_done))


def _train_counted(torch, api, linear, spec, fed, counters):
    """api.train of ``spec`` from a fresh cuda state until a budget binds,
    the kernels' counters set to 0 just before and read just after."""
    state = api.init_state(spec, linear.init_linear(
        fed.clients[0].x_train.shape[1], device="cuda"), device="cuda")
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    state, out = api.train(spec, state, fed.make_sampler(BATCH))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, out, {n: k.launches for n, k in counters.items()}, wall


def _steady_ms(torch, np, api, linear, spec, fed, n_timed=SHARD_TIMED):
    """ms per steady round of ``spec`` (batches prebuilt, no eval, 2
    warm-up rounds), as phase 5 times it."""
    state = api.init_state(spec, linear.init_linear(
        fed.clients[0].x_train.shape[1], device="cuda"), device="cuda")
    rng = np.random.default_rng(2)
    batches = [api.round_batch(spec, fed.make_sampler(BATCH), rng)
               for _ in range(n_timed + 2)]
    for b in batches[:2]:
        state, _ = api.run_round(spec, state, b, check_budgets=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:]:
        state, _ = api.run_round(spec, state, b, check_budgets=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n_timed


def run_sharded_world_of_one(torch, np, api, linear, pop_mod, ops, spec,
                             fed, qs_spec, qs_pop, counters, refs, card):
    """Phase 20a: a world of one under NCCL. The main path's Adult-1 spec
    (16 clients) trained until a budget binds on engine "shard_map" and on
    "mesh_2d" at (1, 1), dense, qsgd8_q50 and trimmed_mean (mesh_2d refuses
    the adversarial aggregator), each against "vmap" bit for bit: params,
    optimizer state, key, rho, rounds, cost; the row kernels' launches per
    run; each kernel call's first output of each shape held against its
    plain version; ms per steady round of vmap and shard_map in turns (v s
    s v); then the population quickstart's resident driver (24 rounds,
    chunk 8, S 256) under shard_map against vmap, its
    cohort_gather_scatter launches. Returns (ok, {kernel: launches on the
    sharded runs}, max abs err)."""
    import torch.distributed as dist
    if dist.is_initialized():
        print("phase 20a: a process group is already initialized "
              "CHECK FAILED", flush=True)
        return False, dict.fromkeys(counters, 0), 0.0
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda:0"))
    print(f"phase 20a: world of {dist.get_world_size()}, backend "
          f"{dist.get_backend()} ({card})", flush=True)
    ok, launches, kept = True, {n: 0 for n in counters}, {}
    reals = _keeping_first_calls(torch, ops, list(counters), kept)
    try:
        for name, extra in SHARD_RUNS:
            base = spec.replace(**extra)
            want, w_out, w_l, w_wall = _train_counted(
                torch, api, linear, base, fed, counters)
            engines = (("shard_map", {}), ("mesh_2d", {"mesh_shape": (1, 1)}))
            for engine, kw in engines:
                if engine == "mesh_2d" and base.is_adversarial():
                    continue
                s = base.replace(engine=engine, **kw)
                got, out, got_l, wall = _train_counted(
                    torch, api, linear, s, fed, counters)
                same = _fl_bits(torch, np, want, got)
                want_l = {"dp_clip_noise": s.tau * out["rounds"],
                          "quantize_decompress": (
                              out["rounds"] if s.compressor == "qsgd"
                              else 0),
                          "cohort_gather_scatter": 0}
                good = (same and out["rounds"] == w_out["rounds"] > 0
                        and out["max_epsilon"] == w_out["max_epsilon"]
                        and got_l == want_l == w_l)
                ok &= good
                for n, v in got_l.items():
                    launches[n] += v
                print(f"phase 20a {name} {engine}"
                      f"{kw.get('mesh_shape', '')}: rounds {out['rounds']} "
                      f"eps {out['max_epsilon']!r} cost "
                      f"{out['resource_spent']!r} vs vmap "
                      f"{w_out['rounds']} {w_out['max_epsilon']!r} "
                      f"{w_out['resource_spent']!r}; state "
                      f"{'bitwise equal' if same else 'DIFFERENT'}; "
                      f"launches {got_l} (vmap {w_l}); train wall "
                      f"{wall * 1e3:.1f} ms (vmap {w_wall * 1e3:.1f}) "
                      f"{'ok' if good else 'CHECK FAILED'}", flush=True)
        for name, extra in SHARD_RUNS[:2]:
            base = spec.replace(**extra)
            times = {"vmap": [], "shard_map": []}
            for engine in ("vmap", "shard_map", "shard_map", "vmap"):
                times[engine].append(_steady_ms(
                    torch, np, api, linear, base.replace(engine=engine),
                    fed))
            print(f"phase 20a {name} ms per steady round (tau {base.tau}, "
                  f"{SHARD_TIMED} rounds a turn, turns v s s v): vmap "
                  f"{times['vmap'][0]:.3f} / {times['vmap'][1]:.3f}, "
                  f"shard_map {times['shard_map'][0]:.3f} / "
                  f"{times['shard_map'][1]:.3f} ({card})", flush=True)
        res = {}
        for engine in ("vmap", "shard_map"):
            st = pop_mod.init_population_state(
                qs_spec.replace(engine=engine), linear.init_linear(
                    QS_DIM, device="cuda"), device="cuda")
            torch.cuda.synchronize()
            for k in counters.values():
                k.launches = 0
            st, out = pop_mod.train_population(
                qs_spec.replace(engine=engine), st, qs_pop,
                max_rounds=QS_ROUNDS, chunk_rounds=QS_CHUNK,
                resident_cache=QS_CACHE)
            torch.cuda.synchronize()
            res[engine] = (st, out, {n: k.launches
                                     for n, k in counters.items()})
        (vs, vo, vl), (ss, so, sl) = res["vmap"], res["shard_map"]
        vids = np.arange(QS_M)
        same = (_fl_bits(torch, np, vs.fl, ss.fl)
                and np.array_equal(vs.store.rho, ss.store.rho)
                and np.array_equal(vs.store.gather_residual(vids),
                                   ss.store.gather_residual(vids)))
        good = (same and vo["rounds"] == so["rounds"] == QS_ROUNDS
                and so["max_epsilon"] == vo["max_epsilon"]
                and sl == vl and sl["cohort_gather_scatter"] > 0)
        ok &= good
        for n, v in sl.items():
            launches[n] += v
        print(f"phase 20a population quickstart resident (M={QS_M:,}, "
              f"K={QS_K}, S={QS_CACHE}) shard_map vs vmap: rounds "
              f"{so['rounds']} eps {so['max_epsilon']!r} state, store rho "
              f"and residual rows {'bitwise equal' if same else 'DIFFERENT'}"
              f"; launches {sl} (vmap {vl}) "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    finally:
        for n, f in reals.items():
            setattr(ops, n, f)
        dist.destroy_process_group()
    ok_k, worst, lines = _check_kept_calls(torch, kept, refs)
    for ln in lines:
        print(f"phase 20a kernel vs plain: {ln}", flush=True)
    return ok and ok_k, launches, max(worst.values(), default=0.0)


def _shard_rank(kw: dict, settings) -> dict:
    """Phase 20b's program on one rank of a gloo world sharing the card:
    the Adult-1 spec ``kw`` as engine "shard_map" (unless a setting names
    another) under each of ``settings``, trained until a budget binds on
    cuda in slab state; each row kernel's first call of each shape held
    against its plain version. Returns the states made whole as numpy,
    the rows and bytes the rank held, the ledgers and the kernels'
    launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api, data, optim
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.cohort_gather_scatter import (
        cohort_gather_scatter,
    )
    from repro_torch.kernels.dp_clip_noise import dp_clip_noise
    from repro_torch.kernels.quantize_decompress import quantize_decompress
    from repro_torch.models import linear
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"dp_clip_noise": dp_clip_noise,
                "quantize_decompress": quantize_decompress,
                "cohort_gather_scatter": cohort_gather_scatter}
    fed = data.split_by_group(data.adult_like())
    kept = {}
    reals = _keeping_first_calls(torch, ops, list(counters), kept)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "rank": dist.get_rank(), "runs": {}}
    try:
        for name, extra in settings:
            spec = api.FederationSpec(loss_fn=linear.logreg_loss,
                                      optimizer=optim.sgd(LR),
                                      **{"engine": "shard_map", **kw,
                                         **extra})
            state, res, launched, wall = _train_counted(
                torch, api, linear, spec, fed, counters)
            held = (state.layout.n_rows, _state_bytes(state))
            state = api.whole_state(state)      # a slab state made whole
            out["runs"][name] = {
                "rows": held[0], "bytes": held[1],
                "params": {k: v.cpu().numpy()
                           for k, v in state.params.items()},
                "residual": (None if state.residual is None
                             else state.residual.cpu().numpy()),
                "rho": np.asarray(state.rho), "rounds": res["rounds"],
                "max_epsilon": res["max_epsilon"],
                "resource_spent": res["resource_spent"],
                "launches": launched, "tau": spec.tau,
                "ms_per_round": wall * 1e3 / max(res["rounds"], 1)}
    finally:
        for n, f in reals.items():
            setattr(ops, n, f)
    refs = {"dp_clip_noise": ref.dp_clip_noise_ref,
            "quantize_decompress": ref.quantize_decompress_ref,
            "cohort_gather_scatter": ref.cohort_gather_scatter_ref}
    out["kernels_ok"], out["kernel_err"], out["kernel_lines"] = \
        _check_kept_calls(torch, kept, refs)
    return out


def run_sharded_two_ranks(torch, np, api, linear, spec, fed, counters,
                          card):
    """Phase 20b: two gloo ranks sharing the one card (NCCL refuses two
    ranks on one device; gloo reduces CUDA tensors, and the engine's row
    gather sums each block's bytes into a zero buffer there). Adult-1
    (16 clients, block 8) as shard_map, dense and qsgd8_q50, trained until
    a budget binds in each rank in slab state (its block's 8 rows),
    against vmap in this process: params and residual within 1e-5, rho,
    rounds, epsilon and cost exactly, both ranks bit for bit alike; each
    rank's dp_clip_noise launches tau x rounds on its (8, N) block and
    quantize_decompress one a round. Then dense as mesh_2d (1, 1): one
    client block on rank 0 (16 rows), and rank 1, outside the mesh, holds
    no rows (0 bytes), receives only each round's metrics
    (ClientGroup.share), the whole trees once at the end (whole_state),
    and launches no kernel.
    Returns (ok, {kernel: launches summed over the ranks}, max abs err)."""
    from repro_torch.launch.mesh import HostWorld
    settings = SHARD_RUNS[:2] + (SHARD_SPECTATOR,)
    kw = dict(n_clients=spec.n_clients, tau=spec.tau,
              clip_norm=spec.clip_norm, dp=True, sigmas=spec.sigmas,
              batch_sizes=spec.batch_sizes, eps_th=spec.eps_th,
              delta=spec.delta, c_th=spec.c_th)
    t0 = time.perf_counter()
    try:
        with HostWorld(2) as world:
            ranks = world.run(_shard_rank, kw, settings)
    except RuntimeError as e:
        print(f"phase 20b: the two ranks failed: {e} CHECK FAILED",
              flush=True)
        return False, dict.fromkeys(counters, 0), 0.0
    wall = time.perf_counter() - t0
    launches = {n: 0 for n in counters}
    ok = True
    worst = max((e for r in ranks for e in r["kernel_err"].values()),
                default=0.0)
    print(f"phase 20b: {len(ranks)} ranks, backend {ranks[0]['backend']}, "
          f"world {ranks[0]['world']}, on one card ({card}); "
          f"{wall:.1f} s with the ranks' start", flush=True)
    for name, extra in settings:
        blocks = extra.get("mesh_shape", (2, 1))[0]
        plain = {k: v for k, v in extra.items()
                 if k not in ("engine", "mesh_shape")}
        want, w_out, _, _ = _train_counted(
            torch, api, linear, spec.replace(**plain), fed, counters)
        runs = [r["runs"][name] for r in ranks]
        r0 = runs[0]
        alike = all(
            all(np.array_equal(r0["params"][k], r["params"][k])
                for k in r0["params"])
            and np.array_equal(r0["rho"], r["rho"]) for r in runs[1:])
        gap = max(float(np.max(np.abs(r0["params"][k]
                                      - want.params[k].cpu().numpy())))
                  for k in r0["params"])
        if r0["residual"] is not None:
            gap = max(gap, float(np.max(np.abs(
                r0["residual"] - want.residual.cpu().numpy()))))
        ledger = (np.array_equal(r0["rho"], want.rho)
                  and (r0["rounds"], r0["max_epsilon"], r0["resource_spent"])
                  == (w_out["rounds"], w_out["max_epsilon"],
                      w_out["resource_spent"]))
        want_l = {"dp_clip_noise": r0["tau"] * r0["rounds"],
                  "quantize_decompress": (r0["rounds"] if extra.get(
                      "compressor") == "qsgd" else 0),
                  "cohort_gather_scatter": 0}
        want_ls = [want_l if r["rank"] < blocks
                   else dict.fromkeys(want_l, 0) for r in ranks]
        rows = [r["rows"] for r in runs]
        held = (rows == [spec.n_clients // blocks if r["rank"] < blocks
                         else 0 for r in ranks]
                and all((r["bytes"] == 0) == (r["rows"] == 0)
                        for r in runs))
        good = (alike and gap <= 1e-5 and ledger and r0["rounds"] > 0
                and [r["launches"] for r in runs] == want_ls and held)
        ok &= good
        for r in runs:
            for n, v in r["launches"].items():
                launches[n] += v
        print(f"phase 20b {name} on 2 ranks ({blocks} block(s) of "
              f"{spec.n_clients // blocks}): rounds {r0['rounds']} eps "
              f"{r0['max_epsilon']!r} cost {r0['resource_spent']!r} vs "
              f"vmap {w_out['rounds']} {w_out['max_epsilon']!r} "
              f"{w_out['resource_spent']!r} ({'exact' if ledger else 'DIFFERENT'}); "
              f"max |d| vs vmap {gap:.3e} (limit 1e-5); ranks "
              f"{'bit for bit alike' if alike else 'DIFFERENT'}; slab rows "
              f"a rank {rows}, bytes {[r['bytes'] for r in runs]}; launches "
              f"per rank {[r['launches'] for r in runs]} (expected "
              f"{want_ls}); ms per round in rank 0 "
              f"{r0['ms_per_round']:.3f} (train wall / rounds) "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    for r in ranks:
        ok &= r["kernels_ok"]
        for ln in r["kernel_lines"]:
            print(f"phase 20b rank {r['rank']} kernel vs plain: {ln}",
                  flush=True)
    return ok, launches, worst


# phase 21: the model axis of mesh_2d (dm > 1), two gloo ranks sharing the
# card. 21a: phase 3's Adult-1 spec as mesh_2d (1, 2) (w (104, 2) split on
# d_in); 21b, d-f: a transformer at its published widths, f32, depth cut,
# tau 1, batch 1, MA_TF_ROUNDS rounds, (1, 2), in turns with vmap: phase ->
# (arch, the depth cut: steps of the layers kept (indices into its first
# segment's pattern), C, seq). rwkv6's seq is cut 2048 -> 512 (and its loss chunk
# 1024 -> 512 with it): its training route's per-token WKV scan keeps
# every token's (hd, hd) states a head for the backward, and at 2048 a mesh
# rank ran the card out of memory
MA_SHAPE = (1, 2)
MA_CELLS = {"21b": ("gemma3-4b", 1, (0,), 2, 2048),
            "21d": ("rwkv6-1.6b", 1, (0,), 2, 512),
            "21e": ("zamba2-7b", 1, (0, 1), 2, 2048),
            "21f": ("phi3.5-moe-42b-a6.6b", 1, (0,), 1, 512),
            "23d": ("granite-20b", 1, (0,), 2, 2048)}
MA_RUNS = (("dense", {}),
           ("qsgd8_q50", dict(compressor="qsgd", compression_bits=8,
                              participation=0.5)))
MA_KERNELS = ("row_sumsq", "clip_noise_apply", "dp_clip_noise",
              "quantize_decompress")
MA_TF_TAU, MA_TF_B = 1, 1
# rounds a turn; rwkv6's per-token training loop takes 9-19 s a round, so
# 21d takes one (the carry from round to round is 21e's), and its depth is
# cut from 4 layers to 2 to make room for phase 23 and to 1 for phase 2b and
# 21b's whole layout; 21b and 21f take one to make room for phase 24
MA_TF_ROUNDS = {"21b": 1, "21d": 1, "21e": 2, "21f": 1, "23d": 1}
MA_TF_TOL = 2e-5       # of each tensor's largest magnitude
# the forms a cell runs in turns (default: slab state and vmap), and the
# least per-rank peak a slab state must save against the whole layout at
# 21b: the full params' bytes a rank no longer holds (C 2 x N / 2 f32)
MA_FORMS = {"21b": ("slab", "whole", "vmap")}
MA_SLAB_SAVING_GB = 3.0


def _ma_counters():
    from repro_torch.kernels.dp_clip_noise import (
        clip_noise_apply,
        dp_clip_noise,
        row_sumsq,
    )
    from repro_torch.kernels.quantize_decompress import quantize_decompress
    return {"row_sumsq": row_sumsq, "clip_noise_apply": clip_noise_apply,
            "dp_clip_noise": dp_clip_noise,
            "quantize_decompress": quantize_decompress}


def _ma_refs():
    from repro_torch.kernels import ref
    return {"row_sumsq": ref.row_sumsq_ref,
            "clip_noise_apply": ref.clip_noise_apply_ref,
            "quantize_decompress": ref.quantize_decompress_ref}


def _model_axis_rank(kw: dict, settings) -> dict:
    """Phase 21a's program on one rank of a gloo world sharing the card:
    the Adult-1 spec ``kw`` as mesh_2d MA_SHAPE under each of ``settings``,
    trained until a budget binds on cuda (counters set to 0 just before,
    read just after); each split kernel's and quantize_decompress's first
    call of each shape held against its plain version. Returns numpy."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api, data, optim
    from repro_torch.kernels import ops
    from repro_torch.models import linear
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _ma_counters()
    fed = data.split_by_group(data.adult_like())
    kept = {}
    reals = _keeping_first_calls(torch, ops, list(_ma_refs()), kept)
    out = {"rank": dist.get_rank(), "runs": {}}
    try:
        for name, extra in settings:
            spec = api.FederationSpec(
                loss_fn=linear.logreg_loss, optimizer=optim.sgd(LR),
                **{**kw, **extra, "engine": "mesh_2d",
                   "mesh_shape": MA_SHAPE})
            state, res, launched, wall = _train_counted(
                torch, api, linear, spec, fed, counters)
            held = (state.layout.n_rows, _state_bytes(state))
            state = api.whole_state(state)      # a slab state made whole
            out["runs"][name] = {
                "rows": held[0], "bytes": held[1],
                "params": {k: v.cpu().numpy()
                           for k, v in state.params.items()},
                "residual": (None if state.residual is None
                             else state.residual.cpu().numpy()),
                "rho": np.asarray(state.rho), "rounds": res["rounds"],
                "max_epsilon": res["max_epsilon"],
                "resource_spent": res["resource_spent"],
                "participants": [h.get("participants")
                                 for h in res["history"]],
                "launches": launched, "tau": spec.tau,
                "ms_per_round": wall * 1e3 / max(res["rounds"], 1)}
    finally:
        for n, f in reals.items():
            setattr(ops, n, f)
    out["shapes"] = sorted({(k[0], k[1][0]) for k in kept})
    out["kernels_ok"], out["kernel_err"], out["kernel_lines"] = \
        _check_kept_calls(torch, kept, _ma_refs())
    return out


def run_model_axis_adult(torch, np, api, linear, spec, fed, card):
    """Phase 21a: two gloo ranks sharing the card, Adult-1 (16 clients, N
    210, w (104, 2) split on d_in: 106 columns a rank) as mesh_2d (1, 2),
    dense and qsgd8_q50, trained until a budget binds in each rank,
    against vmap in this process: params and residual within 1e-5, rho,
    rounds, epsilon, cost and the participant counts exactly, both ranks
    bit for bit alike; each rank's row_sumsq and clip_noise_apply launches
    tau x rounds, dp_clip_noise none, quantize_decompress as vmap's (one a
    round). Returns (ok, {kernel: launches summed over the ranks}, {kernel:
    max abs err vs plain}, the ranks' split-kernel shapes)."""
    from repro_torch.launch.mesh import HostWorld
    counters = _ma_counters()
    kw = dict(n_clients=spec.n_clients, tau=spec.tau,
              clip_norm=spec.clip_norm, dp=True, sigmas=spec.sigmas,
              batch_sizes=spec.batch_sizes, eps_th=spec.eps_th,
              delta=spec.delta, c_th=spec.c_th)
    t0 = time.perf_counter()
    try:
        with HostWorld(2) as world:
            ranks = world.run(_model_axis_rank, kw, MA_RUNS)
    except RuntimeError as e:
        print(f"phase 21a: the two ranks failed: {e} CHECK FAILED",
              flush=True)
        return False, dict.fromkeys(counters, 0), {}, []
    wall = time.perf_counter() - t0
    launches = dict.fromkeys(counters, 0)
    ok = True
    print(f"phase 21a: 2 gloo ranks on one card ({card}), mesh_2d "
          f"{MA_SHAPE}; {wall:.1f} s with the ranks' start", flush=True)
    for name, extra in MA_RUNS:
        want, w_out, w_launch, w_wall = _train_counted(
            torch, api, linear, spec.replace(**extra), fed, counters)
        runs = [r["runs"][name] for r in ranks]
        r0 = runs[0]
        alike = all(
            all(np.array_equal(r0["params"][k], r["params"][k])
                for k in r0["params"])
            and np.array_equal(r0["rho"], r["rho"]) for r in runs[1:])
        gap = max(float(np.max(np.abs(r0["params"][k]
                                      - want.params[k].cpu().numpy())))
                  for k in r0["params"])
        if r0["residual"] is not None:
            gap = max(gap, float(np.max(np.abs(
                r0["residual"] - want.residual.cpu().numpy()))))
        ledger = (np.array_equal(r0["rho"], want.rho)
                  and (r0["rounds"], r0["max_epsilon"], r0["resource_spent"])
                  == (w_out["rounds"], w_out["max_epsilon"],
                      w_out["resource_spent"])
                  and r0["participants"] == [h.get("participants")
                                             for h in w_out["history"]])
        steps = r0["tau"] * r0["rounds"]
        want_l = {"row_sumsq": steps, "clip_noise_apply": steps,
                  "dp_clip_noise": 0,
                  "quantize_decompress": w_launch["quantize_decompress"]}
        # a (1, dm) mesh: every rank holds all C rows, of its model slices
        rows = [r["rows"] for r in runs]
        good = (alike and gap <= 1e-5 and ledger and r0["rounds"] > 0
                and all(r["launches"] == want_l for r in runs)
                and w_launch["dp_clip_noise"] == steps
                and rows == [spec.n_clients] * len(runs))
        ok &= good
        for r in runs:
            for n, v in r["launches"].items():
                launches[n] += v
        print(f"phase 21a {name}: rounds {r0['rounds']} eps "
              f"{r0['max_epsilon']!r} cost {r0['resource_spent']!r} "
              f"participants {r0['participants']} vs vmap "
              f"{w_out['rounds']} {w_out['max_epsilon']!r} "
              f"{w_out['resource_spent']!r} "
              f"({'exact' if ledger else 'DIFFERENT'}); max |d| vs vmap "
              f"{gap:.3e} (limit 1e-5); ranks "
              f"{'bit for bit alike' if alike else 'DIFFERENT'}; slab rows "
              f"a rank {rows}, bytes {[r['bytes'] for r in runs]}; launches "
              f"per rank {[r['launches'] for r in runs]} (expected "
              f"{want_l}; vmap's {w_launch}); ms per round in rank 0 "
              f"{r0['ms_per_round']:.3f}, vmap {w_wall * 1e3 / max(w_out['rounds'], 1):.3f}"
              f" (train wall / rounds) {'ok' if good else 'CHECK FAILED'}",
              flush=True)
    errs = {}
    for r in ranks:
        ok &= r["kernels_ok"]
        for n, e in r["kernel_err"].items():
            errs[n] = max(errs.get(n, 0.0), e)
        for ln in r["kernel_lines"]:
            print(f"phase 21a rank {r['rank']} kernel vs plain: {ln}",
                  flush=True)
    return ok, launches, errs, [r["shapes"] for r in ranks]


def _ma_cfg(configs, phase: str):
    """Phase ``phase``'s transformer (MA_CELLS) at its published widths,
    f32, its depth cut to the listed layers of its first segment's pattern
    (one step of them): gemma3-4b's first (swa) layer; rwkv6-1.6b's 24
    layers cut to 4; zamba2-7b's shared block and one Mamba2 layer;
    phi3.5-moe's 32 cut to 1. A loss chunk longer than the cell's seq is
    cut to it."""
    import dataclasses
    arch, steps, layers, _, seq = MA_CELLS[phase]
    cfg = configs.get_arch(arch)
    seg = cfg.segments[0]
    pattern = tuple(seg.pattern[i] for i in layers)
    n = steps * len(pattern)
    return dataclasses.replace(
        cfg, name=f"{arch}-{n}L", n_layers=n, dtype="float32",
        loss_chunk=min(cfg.loss_chunk, seq),
        segments=(dataclasses.replace(seg, n_steps=steps,
                                      pattern=pattern),))


def _ma_split_shape(configs, phase: str) -> tuple:
    """Phase ``phase``'s flat gradient on a rank of the (1, 2) mesh, what
    the split kernels take, counted on meta tensors: (clients, its columns
    (the split leaves' slices, then the whole leaves): clip_noise_apply's
    on each rank and row_sumsq's on rank 0, the split leaves' columns
    alone: row_sumsq's on rank 1, a view with rank 0's row stride)."""
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.tree import tree_leaves
    one = Transformer(_ma_cfg(configs, phase)).init(device="meta")
    dims = tree_leaves(sharding.param_split_dims(one, MA_SHAPE[1]))
    cols = [(x.numel() // (MA_SHAPE[1] if d >= 0 else 1), d >= 0)
            for x, d in zip(tree_leaves(one), dims)]
    return (MA_CELLS[phase][3], sum(n for n, _ in cols),
            sum(n for n, split in cols if split))


def _tf_all_reduces(cfg, seq: int, dm: int) -> int:
    """The model group's all-reduces in one local step of an attention +
    MLP transformer on a model axis of ``dm``, from the code: the
    embedding's all-reduce and the Eq.-7a clip norm's (2); a layer's
    attention ``copy_in`` backward and ``reduce_out`` forward (2), plus
    the backward of ``wk`` and ``wv`` where they are whole (KV heads the
    axis does not divide: 2), its MLP's two; each loss chunk's
    vocabulary-parallel cross-entropy four (as counted on two CPU ranks
    at smoke widths, with one and two chunks and one and two layers)."""
    chunks = seq // cfg.loss_chunk if cfg.loss_chunk else 1
    attn = 4 if cfg.n_kv_heads % dm else 2
    return 2 + cfg.n_layers * (attn + 2) + 4 * chunks


def _model_axis_tf_rank(phase: str, sigmas, turns: int) -> dict:
    """Phase ``phase``'s program on one rank: its transformer (f32,
    MA_CELLS) built by launch.train.build_federation as mesh_2d MA_SHAPE
    and as vmap from the same seed, in the forms MA_FORMS[phase]: "slab"
    (the rank's slab of the state between rounds, the drivers' default),
    "whole" (``api.whole_state`` of that state: the whole-tree round,
    every rank holding the (C, ...) trees) and "vmap" (rank 0 alone, rank 1 waiting
    at a barrier); MA_TF_ROUNDS[phase] rounds of each from the same state
    on the same batches, in turns (slab, whole, vmap, slab, ...), the peak
    memory reset and the counters set to 0 just before each turn and read
    after it. Returns the last turns' params gaps (rank 0: the slab's
    params made whole by ``api.whole_state`` against vmap's, and whether
    the whole layout's equal them), each form's losses, ms per round and
    per-rank peak memory (its first turn's), and the model group's
    all-reduces and gathers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api, configs
    from repro_torch.kernels.counter_rng import counter_rng
    from repro_torch.launch import train as launch_train
    from repro_torch.mesh import collectives
    from repro_torch.utils.tree import tree_leaves
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    rank = dist.get_rank()
    cfg = _ma_cfg(configs, phase)
    n_clients, seq = MA_CELLS[phase][3:]
    counters = _ma_counters()
    forms = MA_FORMS.get(phase, ("slab", "vmap"))
    out = {"rank": rank, "forms": forms, "ms": {f: [] for f in forms},
           "losses": {}, "peak_gb": {}, "launches": [], "rng_launches": [],
           "all_reduce": [], "gather": []}
    batches = final = None
    for turn in range(turns):
        for form in forms:
            dist.barrier()
            if form == "vmap" and rank != 0:
                continue
            mesh = form != "vmap"
            # each turn builds its state anew from the seed (the same
            # params and key every time) and frees it after, so the ranks'
            # mesh turns and rank 0's vmap turn never hold another turn's
            # buffers
            t_build = time.perf_counter()
            model, spec, state, sampler = launch_train.build_federation(
                cfg, n_clients, MA_TF_TAU, MA_TF_B, seq, sigmas,
                clip_norm=CLIP, delta=DELTA,
                engine="mesh_2d" if mesh else "vmap",
                mesh_shape=MA_SHAPE if mesh else None, device="cuda")
            if form == "whole":
                state = api.whole_state(state)
            assert (state.layout is not None) == (form == "slab")
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t_build
            if batches is None:
                rng = np.random.default_rng(0)
                batches = [api.round_batch(spec, sampler, rng)
                           for _ in range(MA_TF_ROUNDS[phase])]
            del sampler
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            counter_rng.launches = 0
            collectives.counts.update(all_reduce=0, gather=0)
            losses = []
            t0 = time.perf_counter()
            for batch in batches:
                state, rec = api.run_round(spec, state, batch,
                                           check_budgets=False)
                losses.append(float(rec["loss"]))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / MA_TF_ROUNDS[phase]
            out["ms"][form].append(ms)
            out["losses"][form] = losses
            # the first turn's: the last one's rank 0 also holds the slab's
            # params made whole, to compare them
            out["peak_gb"].setdefault(form,
                                      torch.cuda.max_memory_allocated() / 1e9)
            if form == "slab":
                out["launches"].append({n: c.launches
                                        for n, c in counters.items()})
                out["rng_launches"].append(counter_rng.launches)
                out["all_reduce"].append(collectives.counts["all_reduce"])
                out["gather"].append(collectives.counts["gather"])
            if turn == turns - 1:
                # the slab's params made whole (both ranks), kept on rank 0
                # until the other forms' last turns compare theirs
                params = tree_leaves(api.whole_state(state).params
                                     if mesh else state.params)
                if form == "slab" and rank == 0:
                    final = params
                    out["n_params"] = sum(x[0].numel() for x in final)
                elif form == "whole" and rank == 0:
                    out["slab_equals_whole"] = all(
                        torch.equal(a, b) for a, b in zip(final, params))
                elif form == "vmap":
                    out["param_gaps"] = [
                        float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(final, params)]
                    del final
                del params
            out.setdefault("build_s", []).append(round(t_build, 3))
            del model, spec, state, rec
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def run_model_axis_tf(torch, np, fl, configs, card, phase: str, world):
    """Phase 21b (gemma3-4b: d_model 2560, 8 / 4 heads of 256, ffn 10240,
    vocab 262144, depth 1), 21d (rwkv6-1.6b: d_model 2048, 32 heads of
    64, d_ff 7168, depth 24 -> 1, seq 512), 21e (zamba2-7b: d_model 3584,
    112 SSD heads of 64, 7,296 conv channels, 32 attention heads, the
    shared block and one Mamba2 layer) or 21f (phi3.5-moe: d_model 4096, 16 experts of
    6400, 32 / 8 heads, depth 32 -> 1, C 1, seq 512), f32, tau 1, batch 1,
    as mesh_2d (1, 2) on two gloo ranks sharing the card in slab state
    (21b also in the whole layout), and as vmap on rank 0 from the same
    seed, state and batches, in turns: the slab's params (made whole)
    within MA_TF_TOL of each tensor's largest magnitude of vmap's (21b:
    the whole layout's bit for bit the slab's, and the slab's per-rank
    peak at least MA_SLAB_SAVING_GB below the whole layout's), the losses
    finite and alike on the ranks, ms per round of each in turns, each
    rank's peak memory, the model group's all-reduces a local step and
    gathers a round, launches (row_sumsq and clip_noise_apply tau x rounds
    a rank, dp_clip_noise none, counter_rng one a round). ``world`` is the
    HostWorld(2) the cells share (a failed cell closes it). Returns (ok,
    {kernel: launches summed over the ranks, last turn}, record)."""
    arch, _, _, n_clients, seq = MA_CELLS[phase]
    rounds = MA_TF_ROUNDS[phase]
    sigmas = fl.design_sigmas(rounds * MA_TF_TAU, CLIP,
                              [MA_TF_B] * n_clients, TRAIN_EPS, DELTA)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = world.run(_model_axis_tf_rank, phase, sigmas, 2)
    except RuntimeError as e:
        print(f"phase {phase}: the two ranks failed: {e} CHECK FAILED",
              flush=True)
        return False, dict.fromkeys(MA_KERNELS + ("counter_rng",), 0), {}
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    forms = r0["forms"]
    gaps = r0["param_gaps"]
    steps = MA_TF_TAU * rounds
    want_l = {"row_sumsq": steps, "clip_noise_apply": steps,
              "dp_clip_noise": 0, "quantize_decompress": 0}
    launches_ok = all(all(ln == want_l for ln in r["launches"])
                      and all(n == rounds for n in r["rng_launches"])
                      for r in ranks)
    finite = all(math.isfinite(x) for r in ranks
                 for f in forms if f != "vmap" for x in r["losses"][f])
    alike = all(ranks[0]["losses"][f] == ranks[1]["losses"][f]
                for f in forms if f != "vmap")
    loss_gap = max(abs(a - b) for a, b in zip(r0["losses"]["slab"],
                                              r0["losses"]["vmap"]))
    ok = max(gaps) <= MA_TF_TOL and launches_ok and finite and alike
    saving = None
    if "whole" in forms:
        saving = [r["peak_gb"]["whole"] - r["peak_gb"]["slab"]
                  for r in ranks]
        ok &= r0["slab_equals_whole"] and min(saving) >= MA_SLAB_SAVING_GB
    per_step = [a / steps for a in r0["all_reduce"]]
    pred = ""
    if phase == "23d":          # whole K/V: two more a layer, predicted
        want_ar = _tf_all_reduces(_ma_cfg(configs, phase), seq, MA_SHAPE[1])
        ok &= all(a == want_ar for a in per_step)
        pred = f" (predicted {want_ar})"
    seg = _ma_cfg(configs, phase).segments[0]
    layers = [f"{ls.mixer} + {ls.ffn}" for ls in seg.pattern] * seg.n_steps
    print(f"phase {phase} on {card}: {arch}'s widths, f32, depth cut to "
          f"{len(layers)} layer(s) {layers}, "
          f"N = {r0['n_params']:,} params a replica, C {n_clients}, tau "
          f"{MA_TF_TAU}, batch {MA_TF_B}, seq {seq}, {rounds} round(s), "
          f"mesh_2d {MA_SHAPE} on 2 gloo ranks ({' / '.join(forms[:-1])}) "
          f"vs vmap on rank 0; {wall:.1f} s", flush=True)
    print(f"phase {phase} params: slab (made whole) max |d| / max |vmap| "
          f"per tensor {max(gaps):.3e} (limit {MA_TF_TOL})"
          + ("" if "whole" not in forms else
             f"; the whole layout's params "
             f"{'bit for bit the slab' if r0['slab_equals_whole'] else 'DIFFERENT from the slab'}'s")
          + f"; losses {r0['losses']} (slab - vmap max |d| "
          f"{loss_gap:.3e}); ranks' losses "
          f"{'alike' if alike else 'DIFFERENT'}", flush=True)
    print(f"phase {phase} ms per round in turns ({', '.join(forms)}): "
          + "; ".join(f"{f} {[round(x, 3) for x in r0['ms'][f]]}"
                      for f in forms)
          + f" (rank 0's builds {r0['build_s']} s); peak memory allocated "
          f"per rank, first turn: "
          + "; ".join(f"{f} {[round(r['peak_gb'][f], 3) for r in ranks if f in r['peak_gb']]} GB"
                      for f in forms)
          + ("" if saving is None else
             f"; the slab's saving per rank {[round(x, 3) for x in saving]} "
             f"GB (limit >= {MA_SLAB_SAVING_GB})"), flush=True)
    print(f"phase {phase} model-group all-reduces a local step {per_step}"
          f"{pred} (forward, backward and the clip norm), gathers a round "
          f"{[g / rounds for g in r0['gather']]} (those of weights used "
          f"whole: zamba2's LoRA factors and conv); launches per rank and "
          f"turn {[r['launches'] for r in ranks]} (expected {want_l}), "
          f"counter_rng {[r['rng_launches'] for r in ranks]} (expected "
          f"{rounds} a turn) {'ok' if ok else 'CHECK FAILED'}", flush=True)
    launches = {n: sum(r["launches"][-1][n] for r in ranks)
                for n in MA_KERNELS}
    launches["counter_rng"] = sum(r["rng_launches"][-1] for r in ranks)
    rec = {"max_rel_param_gap": max(gaps), "losses": r0["losses"],
           "ms": r0["ms"],
           "peak_gb_per_rank": {f: [r["peak_gb"][f] for r in ranks
                                    if f in r["peak_gb"]] for f in forms},
           "slab_saving_gb_per_rank": saving,
           "all_reduces_per_local_step": per_step,
           "gathers_per_round": [g / rounds for g in r0["gather"]]}
    return ok, launches, rec


def check_split_kernels(torch, shapes, card):
    """Phase 21c: row_sumsq and clip_noise_apply at a rank's rows of 21a,
    21b, 21d-f and 23d, ``shapes`` of (rows, columns) or (rows, columns, the
    split columns rank 1's row_sumsq takes as a row-strided view), against
    their plain versions (row_sumsq within 1e-5 relative; y within 1e-6 +
    1e-5 |y|), timed (CUDA events) beside the plain version and the bound
    (bytes over HBM's rate, operations over the f32 peak: the larger).
    Returns (ok, {kernel: record at the first shape, with the others under
    "at"}, {kernel: max abs err})."""
    from repro_torch.kernels.dp_clip_noise import (
        clip_noise_apply,
        clip_noise_apply_cost,
        row_sumsq,
        row_sumsq_cost,
    )
    from repro_torch.kernels.ref import clip_noise_apply_ref, row_sumsq_ref
    ok, recs, errs = True, {}, {}
    for rows, n, *split in shapes:
        big = rows * n > 1e8
        x, z, _, sigma = _row_inputs(torch, rows, n, 1)
        sq = row_sumsq(x)
        want_sq = row_sumsq_ref(x)
        norm = torch.sqrt(want_sq)
        y = clip_noise_apply(x, z, norm, CLIP, sigma)
        want_y = clip_noise_apply_ref(x, z, norm, CLIP, sigma)
        rel = float(((sq - want_sq).abs()
                     / want_sq.abs().clamp(min=1e-30)).max())
        for n_split in split:               # rank 1's call
            part = x[:, :n_split]
            sq_1, want_1 = row_sumsq(part), row_sumsq_ref(part)
            rel_1 = float(((sq_1 - want_1).abs()
                           / want_1.abs().clamp(min=1e-30)).max())
            errs["row_sumsq"] = max(errs.get("row_sumsq", 0.0),
                                    float((sq_1 - want_1).abs().max()))
            ok &= rel_1 <= 1e-5
            print(f"phase 21c row_sumsq ({rows}, {n_split:,}) of ({rows}, "
                  f"{n:,}) (rank 1's split columns, row stride {n:,}): vs "
                  f"plain rel {rel_1:.2e} "
                  f"{'ok' if rel_1 <= 1e-5 else 'MISMATCH'} ({card})",
                  flush=True)
            del part, sq_1, want_1
        torch.cuda.synchronize()
        err_y = float((y - want_y).abs().max())
        good = rel <= 1e-5 and bool(torch.allclose(y, want_y, atol=1e-6,
                                                   rtol=1e-5))
        ok &= good
        errs["row_sumsq"] = max(errs.get("row_sumsq", 0.0),
                                float((sq - want_sq).abs().max()))
        errs["clip_noise_apply"] = max(errs.get("clip_noise_apply", 0.0),
                                       err_y)
        iters = 5 if big else 200
        for name, fn, plain, cost in (
                ("row_sumsq", lambda: row_sumsq(x),
                 lambda: row_sumsq_ref(x), row_sumsq_cost(rows, n)),
                ("clip_noise_apply",
                 lambda: clip_noise_apply(x, z, norm, CLIP, sigma),
                 lambda: clip_noise_apply_ref(x, z, norm, CLIP, sigma),
                 clip_noise_apply_cost(rows, n))):
            ms, plain_ms = _time_ms(fn, iters), _time_ms(plain, iters)
            bound, by = _larger_bound(cost[1], cost[0])
            rec = {"rows": rows, "n": n, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by}
            if name in recs:
                recs[name].setdefault("at", []).append(rec)
            else:
                recs[name] = dict(rec)
            print(f"phase 21c {name} ({rows}, {n:,}): kernel {ms:.5f} ms "
                  f"({bound / ms:.1%} of the bound)  plain {plain_ms:.5f} "
                  f"ms  bound {bound:.6f} ms ({by})  library: none (no "
                  f"single PyTorch call computes this function); vs plain "
                  f"{'row_sumsq rel ' + format(rel, '.2e') if name == 'row_sumsq' else 'y max|d| ' + format(err_y, '.2e')} "
                  f"{'ok' if good else 'MISMATCH'} ({card})", flush=True)
        del x, z, y, want_y, sq, want_sq, norm
        torch.cuda.empty_cache()
    return ok, recs, errs


# -- phase 22: the serving mesh ---------------------------------------------

SM_SHAPE = (1, 2)
# (arch, steps of its first segment's pattern kept (None: every layer),
# prompt, greedy tokens), batch SM_B, bf16 at the published widths.
# gemma3-4b's depth is cut to one of its 6-layer steps (5 sliding + 1
# full of its 34 layers) to make room for phase 23 in the script's time,
# rwkv6-1.6b's to 12 of its 24 and zamba2-7b's to three steps of its
# pattern (21 of its 81 layers) to make room for phase 24; 23a is
# granite-20b (MQA) with its 52 layers cut to 8
SM_CELLS = {"22a": ("gemma3-4b", 1, 2048, 16),
            "22b": ("rwkv6-1.6b", 12, 512, 16),
            "22c": ("zamba2-7b", 3, 512, 16),
            "22d": ("phi3.5-moe-42b-a6.6b", 4, 512, 8),
            "23a": ("granite-20b", 8, 2048, 16)}
SM_PHASES = ("22a", "22b", "22c", "22d")
SM_B, SM_TURNS = 2, 2
# the engine runs of 22a and 23a: requests (prompts SM_ENGINE_PROMPTS;
# slots, block, budgets, rate: 17's)
SM_ENGINE_PROMPTS = (300, 700, 1500)
SM_ENGINE = {"22a": 6, "23a": 4}
# 22e: f32, two layers a model (zamba2: its shared block and one Mamba2
# layer), prompt, decode steps, phase 12's gate of the largest logit; 23c
# runs granite-20b's so (one full layer twice)
SM_F32_LAYERS = {"gemma3-4b": (0, 5), "rwkv6-1.6b": (0,),
                 "zamba2-7b": (0, 1), "phi3.5-moe-42b-a6.6b": (0,),
                 "granite-20b": (0,)}
SM_F32_ARCHS = ("gemma3-4b", "rwkv6-1.6b", "zamba2-7b",
                "phi3.5-moe-42b-a6.6b")
SM_F32_PROMPT, SM_F32_STEPS, SM_F32_TOL = 512, 4, 1e-4
# 22f: each model kernel at a rank's shapes on the (1, 2) mesh, bf16:
# (B, H / 2, S, hd, window) gemma3-4b's two masks, zamba2's shared
# attention, phi3.5-moe's; (B, H / 2, S, hd, from s0) rwkv6-1.6b's
# prefill and decode step; (B, S, H / 2, P, N, chunk) zamba2's SSD
SM_FLASH = ((2, 4, 2048, 256, 1024), (2, 4, 2048, 256, 0),
            (2, 16, 512, 112, 0), (2, 16, 512, 128, 0))
SM_RWKV = ((2, 16, 512, 64, False), (2, 16, 1, 64, True))
SM_SSD = ((2, 512, 56, 64, 64, 128),)


def _sm_cfg(configs, phase: str):
    """Phase ``phase``'s model (SM_CELLS) at its published widths in bf16,
    phi3.5-moe's depth cut to 4 of its 32 layers."""
    arch, steps, _, _ = SM_CELLS[phase]
    return (configs.get_arch(arch) if steps is None
            else _depth_cut(configs, arch, steps))


def _sm_f32_cfg(configs, arch: str):
    """22e's model: ``arch`` at its published widths in f32, two layers of
    its first segment's pattern (SM_F32_LAYERS; one step of a one-layer
    pattern twice)."""
    import dataclasses
    cfg = configs.get_arch(arch)
    seg = cfg.segments[0]
    keep = SM_F32_LAYERS[arch]
    pattern = tuple(seg.pattern[i] for i in keep)
    steps = 2 // len(pattern)
    return dataclasses.replace(
        cfg, name=f"{arch}-2L", n_layers=2, dtype="float32",
        segments=(dataclasses.replace(seg, n_steps=steps,
                                      pattern=pattern),))


def _sm_seq_collectives(cfg, mesh_shape, shard_seq: bool,
                        max_len: int) -> dict:
    """What a decode step adds to :func:`_sm_collectives` where the decode
    rules split a KV cache's sequence over g ranks (KV heads the model
    axis does not divide: g = dm; ``shard_seq``: g = dd, or dd x dm), from
    the code: two all-reduces an attention layer whose cache splits (the
    group's largest score, then the partial sums), a ring the g ranks do
    not divide staying whole; and a gather of its query heads where the
    K/V heads are whole on a model axis over 1."""
    dd, dm = mesh_shape
    kv_divides = cfg.n_kv_heads % dm == 0
    g = ((dd if kv_divides else dd * dm) if shard_seq
         else (1 if kv_divides else dm))
    n_full = -(-max_len // g) * g
    ar = ga = 0
    for seg in cfg.segments:
        for ls in seg.pattern:
            if ls.mixer not in ("attn", "shared_attn") or g == 1:
                continue
            limit = {"swa": cfg.window, "chunk": cfg.chunk}.get(
                ls.attn_kind, 0)
            if not limit or n_full < limit or limit % g == 0:
                ar += 2 * seg.n_steps
                ga += seg.n_steps if dm > 1 and not kv_divides else 0
    return {"all_reduce": ar, "gather": ga}


def _sm_collectives(cfg) -> dict:
    """The model group's collectives in one decode step (and in a prefill),
    predicted from the code: the vocabulary-parallel embedding's
    all-reduce and the tied LM head's gather; an attention layer's output
    all-reduce (zamba2's shared block also gathers its two LoRA factors),
    an MLP's one, an MoE's one (plus its shared expert's); RWKV6's time
    mix three (the projections, the norm, w_o) and channel mix two;
    Mamba2 three (w_in, the norm, w_out) and one gather of conv_w."""
    ar, ga = 1, 1
    for seg in cfg.segments:
        for ls in seg.pattern:
            n = seg.n_steps
            if ls.mixer in ("attn", "shared_attn"):
                ar += n
                ga += 2 * n if ls.mixer == "shared_attn" else 0
            elif ls.mixer == "rwkv6":
                ar += 3 * n
            elif ls.mixer == "mamba2":
                ar += 3 * n
                ga += n
            ar += n * {"mlp": 1, "shared_mlp": 1, "rwkv_cm": 2, "none": 0,
                       "moe": 2 if cfg.shared_expert else 1}[ls.ffn]
    return {"all_reduce": ar, "gather": ga}


def _sm_counters():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    return {"flash_attention": flash_attention, "rwkv6_scan": rwkv6_scan,
            "mamba2_ssd": mamba2_ssd}


def _sm_want(cfg, gen: int) -> dict:
    """Each model kernel's launches in one generate of ``gen`` tokens on a
    rank (phase 11's formula: the rank runs every layer on its heads)."""
    mixers = cfg.count_mixers()
    return {"flash_attention": mixers.get("attn", 0)
            + mixers.get("shared_attn", 0),
            "rwkv6_scan": mixers.get("rwkv6", 0) * (1 + gen),
            "mamba2_ssd": mixers.get("mamba2", 0)}


def _sm_generate(torch, serve, model, params, prompts, gen, counters,
                 on_mesh: bool, mesh_shape=SM_SHAPE, fsdp=None):
    """One counted ``generate`` (counters and the mesh's collectives set
    to 0 just before, read just after), then one timed prefill of the same
    prompts; on the serving mesh ``mesh_shape`` (``fsdp``: its
    ``fsdp_over_data``) when ``on_mesh``."""
    import contextlib

    from repro_torch.mesh import collectives
    ctx = (serve.serve_on_mesh(model, mesh_shape, fsdp_over_data=fsdp)
           if on_mesh else contextlib.nullcontext())
    with ctx:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        collectives.counts.update(all_reduce=0, gather=0)
        t0 = time.perf_counter()
        tokens, seen = serve.generate(model, params, prompts, gen,
                                      with_logits=True)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
        launches = {n: c.launches for n, c in counters.items()}
        coll = dict(collectives.counts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.inference_mode():
            t0 = time.perf_counter()
            model.prefill(params, prompts, max_len=prompts.shape[1] + gen)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
    return {"tokens": tokens, "logits": seen, "gen_ms": gen_ms,
            "prefill_ms": prefill_ms,
            "decode_ms": (gen_ms - prefill_ms) / gen,
            "launches": launches, "collectives": coll, "peak_gb": peak}


def _sm_engine(torch, serve, serve_pkg, model, params, counters,
               on_mesh: bool, n_requests: int):
    """22a's (or 23a's) workload of ``n_requests`` through a SlotEngine
    (phase 17's slots, block and budgets; no warm-up: nothing is timed), on
    the serving mesh when ``on_mesh``: each request's tokens and the
    logits it drew each from
    (the held row of its slot before each step), the block table after
    each step, the model kernels' launches (set to 0 just before the
    workload)."""
    import contextlib
    ctx = (serve.serve_on_mesh(model, SM_SHAPE) if on_mesh
           else contextlib.nullcontext())
    record = {"tables": [], "logits": {}}

    class Recording(serve_pkg.SlotEngine):
        def step(self):
            for s in map(int, self._active_np.nonzero()[0]):
                rid = self._slot_req[s].rid
                record["logits"].setdefault(rid, []).append(
                    self.logits[s].clone())
            out = super().step()
            record["tables"].append(self._table_np.copy())
            return out

    with ctx:
        max_len = _engine_max_len(SM_ENGINE_PROMPTS)
        engine = Recording(model, params, n_slots=ENGINE_SLOTS,
                           max_len=max_len, block_size=ENGINE_BLOCK,
                           device="cuda")
        wl = serve_pkg.poisson_workload(
            n_requests, ENGINE_RATE, model.cfg.vocab, seed=0,
            prompt_lens=SM_ENGINE_PROMPTS, gen_lens=ENGINE_GENS)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        rep = serve_pkg.serve_continuous(
            engine, wl, clock=serve_pkg.StepClock(
                dt_prefill_token=ENGINE_PREFILL_TOKEN_S))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
    return {"tokens": {r.rid: list(r.out) for r in rep.requests},
            "logits": {k: torch.stack(v) for k, v in
                       record["logits"].items()},
            "tables": record["tables"], "launches": launches,
            "steps": engine.steps, "wall_s": wall,
            "n_requests": len(rep.requests)}


def _sm_rank(phase: str) -> dict:
    """Phase ``phase``'s program on one rank of two sharing the card: its
    model (SM_CELLS) made whole from a seeded CUDA generator, the rank's
    slices cut from it under the serving mesh SM_SHAPE (rank 1 then frees
    the whole params; rank 0 keeps them for the whole route); SM_TURNS
    turns of a counted greedy ``generate`` of SM_B prompts on the mesh
    (both ranks), then on the whole model (rank 0; rank 1 waits at a
    barrier); on rank 0 the whole route and the f32 computation (the plain
    route on the f32 upcast of the params) teacher-forced with the last
    mesh turn's tokens (``_sm_forced``); for 22a and 23a, the engine's
    workload on the mesh and whole. 23a also keeps the first mesh turn's
    flash_attention calls (their operands and outputs) and holds them
    against the plain version after it, and sizes a rank's KV cache and
    the whole's. Returns, moved to the host, each turn's times, launches,
    collectives and peak memory, the last turn's tokens and logits, and
    rank 0's teacher-forced logits."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch import serve as serve_pkg
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.tree import tree_leaves
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    arch, _, prompt, gen = SM_CELLS[phase]
    cfg = _sm_cfg(configs, phase)
    model = Transformer(cfg)
    counters = _sm_counters()
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    whole = model.init(g, "cuda")
    prompts = torch.randint(0, cfg.vocab, (SM_B, prompt), generator=g,
                            device="cuda")
    with serve.serve_on_mesh(model, SM_SHAPE):
        local = sharding.local_params(whole)
        cache_gb = sum(x.nbytes for x in tree_leaves(model.init_cache(
            SM_B, prompt + gen, "meta"))) / 1e9
    torch.cuda.synchronize()
    out = {"rank": rank, "init_s": time.perf_counter() - t0,
           "whole_gb": sum(x.nbytes for x in tree_leaves(whole)) / 1e9,
           "local_gb": sum(x.nbytes for x in tree_leaves(local)) / 1e9,
           "cache_gb": cache_gb, "whole_cache_gb": sum(
               x.nbytes for x in tree_leaves(model.init_cache(
                   SM_B, prompt + gen, "meta"))) / 1e9,
           "mesh": [], "whole": []}
    if rank != 0:
        del whole
    torch.cuda.empty_cache()
    # warm-up: each route's first calls (cuBLAS handles, the allocator)
    _sm_generate(torch, serve, model, local, prompts[:, :128], 2, counters,
                 True)
    if rank == 0:
        _sm_generate(torch, serve, model, whole, prompts[:, :128], 2,
                     counters, False)
    for turn in range(SM_TURNS):
        dist.barrier()
        kept = {}
        reals = (_keeping_first_model_calls(torch, ops, kept)
                 if phase == "23a" and turn == 0 else {})
        out["mesh"].append(_sm_generate(torch, serve, model, local, prompts,
                                        gen, counters, True))
        for name, real in reals.items():
            setattr(ops, name, real)
        if kept:
            k_ok, k_err, k_lines = _check_kept_model_calls(
                torch, kept, {"flash_attention": flash_attention_ref})
            out["kept"] = {"ok": k_ok, "err": k_err.get("flash_attention",
                                                        0.0),
                           "lines": k_lines, "calls": len(kept)}
            del kept
            torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            out["whole"].append(_sm_generate(torch, serve, model, whole,
                                             prompts, gen, counters, False))
    dist.barrier()
    if rank == 0:
        # the whole route and the f32 computation (the plain route on the
        # f32 upcast of the same params) fed the mesh's tokens: what the
        # mesh's prefill and decode steps are held against
        import dataclasses

        from repro_torch.utils.tree import tree_map
        tokens = out["mesh"][-1]["tokens"]
        out["whole_forced"] = _sm_forced(torch, model, whole, prompts,
                                         tokens, gen)
        model32 = Transformer(dataclasses.replace(cfg, dtype="float32"),
                              kernel_backend="ref")
        p32 = tree_map(lambda x: x.float(), whole)
        out["f32_forced"] = _sm_forced(torch, model32, p32, prompts, tokens,
                                       gen)
        del p32
        torch.cuda.empty_cache()
    dist.barrier()
    for runs in (out["mesh"], out["whole"]):
        for i, r in enumerate(runs):
            last = i == len(runs) - 1
            r["tokens"] = r["tokens"].cpu().numpy() if last else None
            r["logits"] = r["logits"].float().cpu().numpy() if last else None
    if phase in SM_ENGINE:
        for on_mesh in (True, False):
            dist.barrier()
            if not on_mesh and rank != 0:
                continue
            eng = _sm_engine(torch, serve, serve_pkg, model,
                             local if on_mesh else whole, counters, on_mesh,
                             SM_ENGINE[phase])
            eng["logits"] = {k: v.float().cpu().numpy()
                             for k, v in eng["logits"].items()}
            out["engine_mesh" if on_mesh else "engine_whole"] = eng
        dist.barrier()
    del local
    if rank == 0:
        del whole
    torch.cuda.empty_cache()
    return out


def _sm_forced(torch, model, params, prompts, tokens, gen: int):
    """``model``'s logits of the prefill of ``prompts`` and of gen - 1
    decode steps fed ``tokens`` (teacher-forced), (B, gen, V) f32 on the
    host."""
    with torch.inference_mode():
        logits, caches, pos = model.prefill(params, prompts,
                                            max_len=prompts.shape[1] + gen)
        steps = [logits]
        for i in range(gen - 1):
            logits, caches = model.decode_step(params, caches, tokens[:, i],
                                               pos + i)
            steps.append(logits)
    return torch.stack(steps, 1).float().cpu().numpy()


def _sm_f32_rank(arch: str) -> dict:
    """22e's program on one rank: ``arch`` in f32 at its published widths,
    two layers (``_sm_f32_cfg``), whole params from a seeded CUDA
    generator, B SM_B x SM_F32_PROMPT: ``generate`` of SM_F32_STEPS + 1
    greedy tokens on the serving mesh (the prefill and SM_F32_STEPS
    decode steps' logits); rank 0 then runs the whole route's prefill and
    decode steps teacher-forced with the mesh's tokens. Returns the
    routes' logits (rank 0) and the rank's tokens."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    cfg = _sm_f32_cfg(configs, arch)
    model = Transformer(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    whole = model.init(g, "cuda")
    prompts = torch.randint(0, cfg.vocab, (SM_B, SM_F32_PROMPT),
                            generator=g, device="cuda")
    n = SM_F32_STEPS + 1
    with serve.serve_on_mesh(model, SM_SHAPE):
        local = sharding.local_params(whole)
        tokens, seen = serve.generate(model, local, prompts, n,
                                      with_logits=True)
    out = {"rank": rank, "tokens": tokens.cpu().numpy(),
           "mesh": seen.cpu().numpy()}
    del local
    if rank == 0:
        out["whole"] = _sm_forced(torch, model, whole, prompts, tokens, n)
    del whole
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _sm_guarded(serve, np, tokens, ref_tokens, ref_logits, tol):
    """Each row's tokens against the reference's under the top-two gap
    guard (``agree_under_gap`` at ``tol``): (all agree, steps compared,
    steps)."""
    ok, n, total = True, 0, 0
    for got, ref, lg in zip(tokens, ref_tokens, ref_logits):
        agree, k = serve.agree_under_gap(list(got), ref, lg, tol)
        ok &= agree
        n += k
        total += len(ref)
    return ok, n, total


def run_serving_mesh(torch, np, configs, serve, card, world,
                     phases=SM_PHASES):
    """Phase 22a-d (or 23a: ``phases``): each SM_CELLS model in bf16 on
    the serving mesh (1, 2)
    of ``world``'s two gloo ranks sharing the card, in turns with the
    whole model on rank 0 (``_sm_rank``): greedy tokens against the whole
    route's under the top-two gap guard at four times the whole route's
    own rounding, the largest |whole - f32| of the prefill logits (the f32
    computation: the plain route on the f32 upcast of the params; a
    measure the mesh does not move), at least one bf16 ulp of the largest
    logit; at the prefill and at every decode step, the whole route and
    the f32 computation fed the mesh's tokens (``_sm_forced``), the mesh's
    logits' relative L2 distance to the f32 computation at most 1.25 x
    the whole route's + 1e-3 (phase 12's bf16 criterion: a random-init
    bf16 stack moves far from f32 by rounding alone, so the guard may
    leave few steps to compare, and this holds the split's accuracy on
    every step instead); the ranks' tokens and logits bit for bit alike;
    prefill ms and decode ms a token of each route in turns; the model
    group's collectives over a generate against the prediction (per
    decode step and prefill, ``_sm_collectives``); each rank's launches
    (``_sm_want``); each rank's peak memory against the whole route's;
    22a's engine on the mesh against the whole engine (tokens under the
    same guard, the ranks' tokens and block tables alike, flash launches
    per prefill group). 23a (granite-20b's one KV head, whole on each rank,
    its decode cache's sequence split over the two): the collectives add
    ``_sm_seq_collectives`` a decode step; a rank's KV cache is half the
    whole's; the first mesh turn's flash calls held against the plain
    version (``_check_kept_model_calls``). Returns (ok, {kernel: launches
    of both ranks, the last mesh turn, by phase}, {phase: record}, {kernel:
    max abs err of the kept calls})."""
    ok, launches, recs, errs = True, {}, {}, {}
    for phase in phases:
        arch, _, prompt, gen = SM_CELLS[phase]
        cfg = _sm_cfg(configs, phase)
        t0 = time.perf_counter()
        try:
            ranks = world.run(_sm_rank, phase)
        except RuntimeError as e:
            print(f"phase {phase}: the two ranks failed: {e} CHECK FAILED",
                  flush=True)
            return False, launches, recs, errs
        wall = time.perf_counter() - t0
        r0, r1 = ranks
        mesh, whole = r0["mesh"][-1], r0["whole"][-1]
        alike = (np.array_equal(mesh["tokens"], r1["mesh"][-1]["tokens"])
                 and np.array_equal(mesh["logits"],
                                    r1["mesh"][-1]["logits"]))
        f32, forced = r0["f32_forced"], r0["whole_forced"]
        scale = float(np.abs(whole["logits"]).max())
        rounding = float(np.abs(forced[:, 0] - f32[:, 0]).max())
        tol = max(4 * rounding, scale * 2.0 ** -8)
        agree, n_cmp, n_all = _sm_guarded(serve, np, mesh["tokens"],
                                          whole["tokens"], whole["logits"],
                                          tol)
        # phase 12's bf16 criterion at the prefill and every decode step:
        # the mesh's logits no farther from the f32 computation than
        # 1.25 x the whole route's (both fed the mesh's tokens)
        to_f32 = {k: [float(np.linalg.norm(x[:, t] - f32[:, t])
                            / np.linalg.norm(f32[:, t])) for t in range(gen)]
                  for k, x in (("mesh", mesh["logits"]), ("whole", forced))}
        near = all(m <= 1.25 * w + 1e-3
                   for m, w in zip(to_f32["mesh"], to_f32["whole"]))
        ratio = max(m / w for m, w in zip(to_f32["mesh"], to_f32["whole"]))
        gap = [float(np.abs(mesh["logits"][:, t] - forced[:, t]).max())
               for t in range(gen)]
        want_l = _sm_want(cfg, gen)
        pred = _sm_collectives(cfg)
        extra = _sm_seq_collectives(cfg, SM_SHAPE, False, prompt + gen)
        want_c = {k: v * (gen + 1) + extra[k] * gen for k, v in pred.items()}
        launches_ok = all(t["launches"] == want_l for r in ranks
                          for t in r["mesh"])
        coll_ok = all(t["collectives"] == want_c for r in ranks
                      for t in r["mesh"])
        finite = bool(np.isfinite(mesh["logits"]).all()
                      and np.isfinite(whole["logits"]).all())
        good = (alike and agree and near and launches_ok and coll_ok
                and finite)
        if "kept" in r0:                  # 23a: the kept flash calls
            kept_ok = all(r["kept"]["ok"] and r["kept"]["calls"] > 0
                          for r in ranks)
            halves = all(abs(2 * r["cache_gb"] - r["whole_cache_gb"])
                         <= 1e-9 for r in ranks)
            errs["flash_attention"] = max(r["kept"]["err"] for r in ranks)
            good &= kept_ok and halves
            print(f"phase {phase} the first mesh turn's flash calls on each "
                  f"rank against the plain version: "
                  f"{[r['kept']['lines'] for r in ranks]} "
                  f"{'ok' if kept_ok else 'CHECK FAILED'}; KV cache a rank "
                  f"{[round(r['cache_gb'], 6) for r in ranks]} GB, whole "
                  f"{r0['whole_cache_gb']:.6f} GB (half: {halves})",
                  flush=True)
        launches[phase] = {n: sum(r["mesh"][-1]["launches"][n]
                                  for r in ranks) for n in want_l}
        rec = {"arch": arch, "layers": cfg.n_layers, "prompt": prompt,
               "tokens": gen, "rounding": rounding, "guard": tol,
               "steps_compared": [n_cmp, n_all],
               "rel_l2_to_f32": to_f32, "max_ratio": ratio,
               "max_abs_mesh_vs_forced": gap,
               "prefill_ms": {"mesh": [t["prefill_ms"] for t in r0["mesh"]],
                              "whole": [t["prefill_ms"]
                                        for t in r0["whole"]]},
               "decode_ms": {"mesh": [t["decode_ms"] for t in r0["mesh"]],
                             "whole": [t["decode_ms"] for t in r0["whole"]]},
               "peak_gb": {"mesh": [r["mesh"][-1]["peak_gb"] for r in ranks],
                           "whole": whole["peak_gb"]},
               "params_gb": {"whole": r0["whole_gb"],
                             "rank": [r["local_gb"] for r in ranks]},
               "cache_gb": {"whole": r0["whole_cache_gb"],
                            "rank": [r["cache_gb"] for r in ranks]},
               "collectives_per_step": {k: v / (gen + 1) for k, v in
                                        mesh["collectives"].items()}}
        print(f"phase {phase} {arch} bf16 on {card}: {cfg.n_layers} layers, "
              f"B {SM_B} x {prompt}, {gen} greedy tokens, serving mesh "
              f"{SM_SHAPE} on 2 gloo ranks vs the whole model on rank 0, "
              f"in turns; {wall:.1f} s with the params' init "
              f"({r0['init_s']:.1f} s); params {r0['whole_gb']:.2f} GB "
              f"whole, {[round(r['local_gb'], 3) for r in ranks]} GB a rank",
              flush=True)
        print(f"phase {phase} tokens mesh {mesh['tokens'][0, :8].tolist()} "
              f"whole {whole['tokens'][0, :8].tolist()}: agree under the "
              f"guard {tol:.3e} (4x the whole route's prefill max |whole - "
              f"f32| {rounding:.3e}, at least a bf16 ulp of max|logit| "
              f"{scale:.2f}) {agree}, {n_cmp}/{n_all} steps compared; "
              f"logits' relative L2 to the f32 computation (fed the mesh's "
              f"tokens) at the prefill and each decode step mesh "
              f"{[float(f'{x:.4g}') for x in to_f32['mesh']]} whole "
              f"{[float(f'{x:.4g}') for x in to_f32['whole']]} (each mesh "
              f"<= 1.25 x whole + 1e-3: {near}, largest mesh / whole "
              f"{ratio:.4f}); max |mesh - whole fed the mesh's tokens| a "
              f"step {[float(f'{x:.4g}') for x in gap]}; ranks' tokens and "
              f"logits "
              f"{'bit for bit alike' if alike else 'DIFFERENT'}; logits "
              f"finite {finite}", flush=True)
        print(f"phase {phase} ms in turns (m w m w): prefill mesh "
              f"{[round(x, 3) for x in rec['prefill_ms']['mesh']]} whole "
              f"{[round(x, 3) for x in rec['prefill_ms']['whole']]}; decode "
              f"a token ((generate - prefill) / tokens) mesh "
              f"{[round(x, 3) for x in rec['decode_ms']['mesh']]} whole "
              f"{[round(x, 3) for x in rec['decode_ms']['whole']]}; peak "
              f"memory a rank {[round(x, 3) for x in rec['peak_gb']['mesh']]}"
              f" GB, whole {whole['peak_gb']:.3f} GB", flush=True)
        print(f"phase {phase} model-group collectives a generate "
              f"{mesh['collectives']} (predicted {want_c}: "
              f"{pred} a decode step and a prefill, x {gen + 1}, and "
              f"{extra} more a decode step for the sequence-split cache, x "
              f"{gen}); "
              f"launches per rank and turn "
              f"{[t['launches'] for r in ranks for t in r['mesh']]} "
              f"(expected {want_l}) {'ok' if good else 'CHECK FAILED'}",
              flush=True)
        if phase in SM_ENGINE:
            e_ok, e_rec = _sm_engine_verdict(serve, np, cfg, ranks, tol, card,
                                             phase)
            good &= e_ok
            launches[f"{phase} engine"] = {
                n: sum(r["engine_mesh"]["launches"][n] for r in ranks)
                for n in want_l}
            rec["engine"] = e_rec
        ok &= good
        recs[phase] = rec
        print(f"phase {phase} wall time {time.perf_counter() - t0:.1f} s",
              flush=True)
    return ok, launches, recs, errs


def _sm_engine_verdict(serve, np, cfg, ranks, tol, card, phase):
    """22a's (23a's) engine: the mesh engine's tokens against the whole
    engine's
    under the guard ``tol`` (the whole engine's logits before each token
    the reference), the ranks' tokens and every block table alike,
    flash launches = attention layers x prefill groups on each rank."""
    r0, r1 = ranks
    em, ew = r0["engine_mesh"], r0["engine_whole"]
    alike = (em["tokens"] == r1["engine_mesh"]["tokens"]
             and len(em["tables"]) == len(r1["engine_mesh"]["tables"])
             and all(np.array_equal(a, b) for a, b in
                     zip(em["tables"], r1["engine_mesh"]["tables"])))
    ok, n_cmp, n_all = True, 0, 0
    for rid, ref in ew["tokens"].items():
        agree, k = serve.agree_under_gap(em["tokens"][rid], ref,
                                         ew["logits"][rid], tol)
        ok &= agree
        n_cmp += k
        n_all += len(ref)
    groups = em["launches"]["flash_attention"] // max(
        cfg.count_mixers().get("attn", 1), 1)
    launch_ok = (all(r["engine_mesh"]["launches"] == em["launches"]
                     for r in ranks)
                 and em["launches"]["flash_attention"] == groups
                 * cfg.count_mixers()["attn"] and groups > 0
                 and em["launches"]["flash_attention"]
                 == ew["launches"]["flash_attention"])
    good = (alike and ok and launch_ok
            and em["n_requests"] == SM_ENGINE[phase])
    print(f"phase {phase} engine on {card} ({ENGINE_SLOTS} slots, block "
          f"{ENGINE_BLOCK}, {SM_ENGINE[phase]} Poisson requests at prompts "
          f"{SM_ENGINE_PROMPTS}): mesh {em['steps']} steps in "
          f"{em['wall_s']:.2f} s, whole {ew['steps']} steps in "
          f"{ew['wall_s']:.2f} s; tokens against the whole engine's under "
          f"the guard {tol:.3e}: {ok}, {n_cmp}/{n_all} steps compared; "
          f"ranks' tokens and {len(em['tables'])} block tables "
          f"{'alike' if alike else 'DIFFERENT'}; launches per rank "
          f"{[r['engine_mesh']['launches'] for r in ranks]} ({groups} "
          f"prefill groups x {cfg.count_mixers()['attn']} attention "
          f"layers; whole {ew['launches']}) "
          f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    return good, {"steps": em["steps"], "wall_s": {"mesh": em["wall_s"],
                                                    "whole": ew["wall_s"]},
                  "steps_compared": [n_cmp, n_all], "groups": groups}


def run_serving_mesh_f32(torch, np, configs, card, world,
                         archs=SM_F32_ARCHS, phase="22e"):
    """Phase 22e (23c: granite-20b): each of ``archs`` in f32 at its
    published widths, two layers, on the serving mesh (1, 2) against the
    whole route on rank 0 teacher-forced with the mesh's tokens: the
    prefill and SM_F32_STEPS decode steps' logits within SM_F32_TOL of the
    whole route's largest logit (phase 12's gate); the ranks' tokens
    alike."""
    ok = True
    for arch in archs:
        try:
            r0, r1 = world.run(_sm_f32_rank, arch)
        except RuntimeError as e:
            print(f"phase {phase} {arch}: the two ranks failed: {e} CHECK "
                  f"FAILED", flush=True)
            return False
        gap = float(np.abs(r0["mesh"] - r0["whole"]).max()) / max(
            1.0, float(np.abs(r0["whole"]).max()))
        alike = np.array_equal(r0["tokens"], r1["tokens"])
        good = (gap <= SM_F32_TOL and alike
                and bool(np.isfinite(r0["mesh"]).all()))
        ok &= good
        cfg = _sm_f32_cfg(configs, arch)
        layers = [f"{ls.mixer} + {ls.ffn}"
                  for ls in cfg.segments[0].pattern] * cfg.segments[0].n_steps
        print(f"phase {phase} {arch} f32 on {card}, layers {layers}, B {SM_B} x "
              f"{SM_F32_PROMPT}: prefill + {SM_F32_STEPS} decode steps, mesh "
              f"{SM_SHAPE} vs whole, max gap / max|logit| {gap:.3e} (limit "
              f"{SM_F32_TOL}); ranks' tokens "
              f"{'alike' if alike else 'DIFFERENT'} "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    return ok


def check_rank_kernels(torch, card, phase="22f", flash=SM_FLASH,
                       rwkv=SM_RWKV, ssd=SM_SSD):
    """Phase 22f (23e: ``phase``, and its shapes): flash_attention,
    rwkv6_scan and mamba2_ssd at a rank's shapes on the (1, 2) serving mesh
    (``flash``, ``rwkv``, ``ssd``), bf16, each against its plain version
    on the same values upcast to f32 (phase 10's criteria), timed (CUDA
    events) beside the plain version, the bound and, for flash, torch's
    scaled_dot_product_attention. Returns (ok, {kernel: [record a shape]},
    {kernel: max abs err})."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         mamba2_ssd_ref, rwkv6_scan_ref)
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    gen = torch.Generator(device="cuda").manual_seed(22)
    bf = torch.bfloat16
    ok, recs, worst = True, {}, {}

    def record(name, shape, variant, err, good, fn, plain, bound, lib=None,
               iters=20):
        nonlocal ok
        ok &= good
        worst[name] = max(worst.get(name, 0.0), err)
        ms, plain_ms = _time_ms(fn, iters), _time_ms(plain, max(iters // 4,
                                                                 1))
        lib_ms = None if lib is None else _time_ms(lib, iters)
        recs.setdefault(name, []).append({
            "shape": list(shape), "variant": variant, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms,
            "max_abs_err": err})
        print(f"phase {phase} {name} {shape} bf16 [{variant}]: max|d| {err:.3e} "
              f"{'ok' if good else 'MISMATCH'}  kernel {ms:.5f} ms "
              f"({bound[0] / ms:.1%} of the bound)  plain {plain_ms:.5f} ms"
              f"  bound {bound[0]:.6f} ms ({bound[1]})  library "
              + ("none (no single PyTorch call computes it)" if lib is None
                 else f"scaled_dot_product_attention {lib_ms:.5f} ms")
              + f" ({card})", flush=True)

    for b, h, s, hd, window in flash:
        q, k, v = (torch.randn((b, h, s, hd), generator=gen,
                               device="cuda").to(bf) for _ in range(3))
        got = flash_attention(q, k, v, window=window)
        want = flash_attention_ref(q.float(), k.float(), v.float(),
                                   window=window)
        err, good = _kernel_err(torch, got, want, bf)
        del want
        if window:
            pos = torch.arange(s, device="cuda")
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True)
        record("flash_attention", (b, h, s, hd, window),
               flash_attention.last_variant, err, good,
               lambda: flash_attention(q, k, v, window=window),
               lambda: flash_attention_ref(q, k, v, window=window),
               _flash_bound(torch, b, h, s, hd, window, bf), lib)
        del q, k, v, got
    for b, h, s, hd, with_s0 in rwkv:
        r, k, v = (torch.randn((b, h, s, hd), generator=gen,
                               device="cuda").to(bf) for _ in range(3))
        w = torch.sigmoid(torch.randn((b, h, s, hd), generator=gen,
                                      device="cuda"))
        u = torch.randn((h, hd), generator=gen, device="cuda")
        s0 = (torch.randn((b, h, hd, hd), generator=gen, device="cuda")
              if with_s0 else None)
        y, st = rwkv6_scan(r, k, v, w, u, s0)
        variant = rwkv6_scan.last_variant
        wy, ws = rwkv6_scan_ref(r.float(), k.float(), v.float(), w, u, s0)
        e1, g1 = _kernel_err(torch, y, wy, bf)
        e2, g2 = _kernel_err(torch, st, ws, torch.float32)
        del wy, ws
        record("rwkv6_scan", (b, h, s, hd) + (("s0",) if with_s0 else ()),
               variant, max(e1, e2), g1 and g2,
               lambda: rwkv6_scan(r, k, v, w, u, s0),
               lambda: rwkv6_scan_ref(r, k, v, w, u, s0),
               _rwkv_bound(torch, b, h, s, hd, with_s0, bf),
               iters=30 if s > 1 else 200)
        del r, k, v, w, u, s0, y, st
    for b, s, h, p, n, q in ssd:
        x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(bf)
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
        a = -torch.exp(0.3 * torch.randn((h,), generator=gen, device="cuda"))
        b_in, c_in = (torch.randn((b, s, n), generator=gen,
                                  device="cuda").to(bf) for _ in range(2))
        y, st = mamba2_ssd(x, dt, a, b_in, c_in, chunk=q)
        variant = mamba2_ssd.last_variant
        wy, ws = mamba2_ssd_ref(x.float(), dt, a, b_in.float(), c_in.float(),
                                min(q, s))
        e1, g1 = _kernel_err(torch, y, wy, bf)
        e2, g2 = _kernel_err(torch, st, ws, torch.float32)
        del wy, ws
        record("mamba2_ssd", (b, s, h, p, n, q), variant, max(e1, e2),
               g1 and g2, lambda: mamba2_ssd(x, dt, a, b_in, c_in, chunk=q),
               lambda: mamba2_ssd_ref(x, dt, a, b_in, c_in, q),
               _ssd_bound(torch, b, s, h, p, n, q, bf))
        del x, dt, a, b_in, c_in, y, st
    torch.cuda.synchronize()
    return ok, recs, worst


# -- phase 23: KV heads the model axis does not divide, the sequence-split
# decode cache -----------------------------------------------------------------

# 23a: SM_CELLS["23a"] (granite-20b, MQA) on SM_SHAPE, its engine SM_ENGINE's.
# 23b-c: gemma3-4b's long_500k on (2, 1) (shard_seq): B 1, a cache of
# LONG_LEN slots filled to LONG_FILL positions block by block (LONG_BLOCK
# positions a block, each drawn from a generator keyed by (seed, layer,
# block), so a rank draws only its own slots' blocks and the whole route
# the same values), then LONG_STEPS decode steps teacher-forced with seeded
# tokens; 23b bf16 at all 34 layers, 23c f32 at two (one sliding, one full)
LONG_SHAPE, LONG_LEN, LONG_FILL = (2, 1), 524_288, 524_280
LONG_BLOCK, LONG_STEPS, LONG_SEED = 8192, 4, 23
# 23b's gate on each step's relative L2 between the mesh's and the whole
# route's bf16 logits: two bf16 routes of gemma3-4b's 34 layers (phase 12
# measured 2.9e-2 between its kernel and plain routes); argmaxes compared
# where the whole route's top-two gap exceeds 2^-6 of its largest logit
# (2-4 bf16 ulps of it)
LONG_REL_L2 = 5e-2
# 23e: flash_attention at a rank's shape of 23a's prefill (24 of 48 heads)
MQ_FLASH = ((2, 24, 2048, 128, 0),)


def _long_cfg(configs, phase: str):
    """23b's and 24b's gemma3-4b (its 34 layers, bf16) or 23c's and 24c's
    (f32, one sliding and one full layer: ``_sm_f32_cfg``)."""
    return (configs.get_arch("gemma3-4b") if phase in ("23b", "24b")
            else _sm_f32_cfg(configs, "gemma3-4b"))


def _long_shape(phase: str) -> tuple:
    """The serving mesh of a long-context phase: 23's (2, 1) (the cache's
    sequence over "data"), 24's (2, 2) (also its KV heads over
    "model")."""
    return LONG_SHAPE if phase.startswith("23") else FSDP_SHAPE


def _fill_long(torch, model, caches) -> None:
    """Every attention cache of ``caches`` (this rank's block of slots
    under the active rules, or whole; its KV heads where the model axis
    splits them) holds the K/V of positions 0 .. LONG_FILL - 1 where its
    ring or span keeps them: the values of position p drawn with the
    block p // LONG_BLOCK of (B, LONG_BLOCK, KV, hd) normal draws of its
    layer's generator, seeded by (LONG_SEED, layer, block), every KV head
    drawn and the rank's taken. Only the blocks a rank's slots hold are
    drawn."""
    from repro_torch.models import attention as attn
    from repro_torch.models import sharding
    cfg = model.cfg
    grp = sharding.seq_group()
    layer = 0
    for seg, seg_c in zip(cfg.segments, caches):
        for i in range(seg.n_steps):
            for j, ls in enumerate(seg.pattern):
                k = seg_c[str(j)]["mixer"]["k"][i]
                v = seg_c[str(j)]["mixer"]["v"][i]
                n_local = k.shape[1]
                blk = attn.seq_block(n_local, ls.attn_kind, cfg.window,
                                     cfg.chunk, grp)
                _, lo, n = blk if blk is not None else (None, 0, n_local)
                slots = torch.arange(lo, lo + n_local, device=k.device)
                pos = (LONG_FILL - 1) - torch.remainder(
                    LONG_FILL - 1 - slots, n)
                block = torch.where(pos >= 0, pos // LONG_BLOCK, -1)
                for b in sorted(set(block.unique().tolist()) - {-1}):
                    g = torch.Generator(device=k.device).manual_seed(
                        LONG_SEED * 1_000_003 + layer * 10_007 + b)
                    shape = (k.shape[0], LONG_BLOCK, cfg.n_kv_heads,
                             k.shape[3])
                    kb = torch.randn(shape, generator=g, device=k.device)
                    vb = torch.randn(shape, generator=g, device=k.device)
                    if k.shape[2] < cfg.n_kv_heads:   # the rank's heads
                        lo, hi = sharding.model_group().bounds(
                            cfg.n_kv_heads)
                        kb, vb = kb[:, :, lo:hi], vb[:, :, lo:hi]
                    sel = torch.nonzero(block == b).squeeze(1)
                    at = pos[sel] % LONG_BLOCK
                    k[:, sel] = kb[:, at].to(k.dtype)
                    v[:, sel] = vb[:, at].to(v.dtype)
                    del kb, vb
                layer += 1


def _long_rank(phase: str) -> dict:
    """Phase 23b's (or 23c's; 24b's, 24c's) program on one rank of two
    (four) sharing the card: gemma3-4b (``_long_cfg``) from a seeded CUDA
    generator, made whole on each rank; on the serving mesh
    ``_long_shape(phase)`` under ``shard_seq`` each rank serves its slices
    of the params (whole where the model axis is 1; rank 0 keeps the
    whole params for the whole route, the others free them), allocates
    its part of the caches (half of the slots on (2, 1); half of the
    slots and of the KV heads on (2, 2)), fills them (``_fill_long``) and
    runs LONG_STEPS teacher-forced decode steps (the collectives
    counted); then rank 0 runs the whole route on whole caches filled
    with the same values. Returns the logits of each route (rank 0), the
    rank's, the cache bytes, each step's ms, the collectives and the
    peaks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.mesh import collectives
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.tree import tree_leaves
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    model = Transformer(_long_cfg(configs, phase))
    g = torch.Generator(device="cuda").manual_seed(LONG_SEED)
    whole = model.init(g, "cuda")
    tokens = torch.randint(0, model.cfg.vocab, (LONG_STEPS, 1), generator=g,
                           device="cuda")
    out = {"rank": rank, "params_gb": sum(
        x.nbytes for x in tree_leaves(whole)) / 1e9}
    params = whole

    def run(route: str) -> None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        caches = model.init_cache(1, LONG_LEN, "cuda")
        _fill_long(torch, model, caches)
        torch.cuda.synchronize()
        out[f"{route}_fill_s"] = time.perf_counter() - t0
        out[f"{route}_cache_gb"] = sum(x.nbytes
                                       for x in tree_leaves(caches)) / 1e9
        collectives.counts.update(all_reduce=0, gather=0)
        steps, ms = [], []
        with torch.inference_mode():
            for i in range(LONG_STEPS):
                t0 = time.perf_counter()
                logits, caches = model.decode_step(params, caches, tokens[i],
                                                   LONG_FILL + i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                steps.append(logits[0].float().cpu().numpy())
        out[route] = np.stack(steps)
        out[f"{route}_ms"] = ms
        out[f"{route}_collectives"] = dict(collectives.counts)
        out[f"{route}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del caches
        torch.cuda.empty_cache()

    with serve.serve_on_mesh(model, _long_shape(phase), shard_seq=True):
        params = sharding.local_params(whole)
        out["local_gb"] = sum(x.nbytes for x in tree_leaves(params)) / 1e9
        if rank != 0:
            del whole
        torch.cuda.empty_cache()
        dist.barrier()
        run("mesh")
    params = None
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        params = whole
        run("whole")
        del whole
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def run_long_context(torch, np, configs, card, world, phase: str):
    """Phase 23b (gemma3-4b at long_500k, 34 layers, bf16) or 23c (its
    sliding and full layer in f32), and 24b / 24c the same on (2, 2): the
    mesh's ranks each hold their part of every cache (``shard_seq``: the
    sequence on "data"; on (2, 2) the KV heads on "model" too) against
    the whole route on rank 0 (``_long_rank``). 23b / 24b: each step's
    relative L2 between the routes' logits within LONG_REL_L2, and the
    argmaxes equal where the whole route's top-two gap exceeds 2^-6 of its
    largest logit; 23c / 24c: within SM_F32_TOL of the whole route's
    largest logit (phase 12's gate). All: the ranks' logits alike and
    finite; a rank's caches 1 / (dd x dm) of the whole's; the collectives
    a step as ``_sm_seq_collectives`` predicts, plus the model axis'
    (``_sm_collectives``) on (2, 2). Returns (ok, record)."""
    cfg = _long_cfg(configs, phase)
    shape = _long_shape(phase)
    parts = shape[0] * shape[1]
    t0 = time.perf_counter()
    try:
        ranks = world.run(_long_rank, phase)
    except RuntimeError as e:
        print(f"phase {phase}: the ranks failed: {e} CHECK FAILED",
              flush=True)
        return False, {}
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    mesh, whole = r0["mesh"], r0["whole"]
    alike = all(np.array_equal(mesh, r["mesh"]) for r in ranks[1:])
    finite = bool(np.isfinite(mesh).all() and np.isfinite(whole).all())
    rel = [float(np.linalg.norm(mesh[t] - whole[t]) / np.linalg.norm(
        whole[t])) for t in range(LONG_STEPS)]
    gap = float(np.abs(mesh - whole).max()) / max(1.0, float(
        np.abs(whole).max()))
    top2 = np.sort(whole, axis=-1)[:, -2:]
    guard = float(np.abs(whole).max()) * 2.0 ** -6
    compared = [t for t in range(LONG_STEPS)
                if top2[t, 1] - top2[t, 0] > guard]
    argmax_ok = all(int(mesh[t].argmax()) == int(whole[t].argmax())
                    for t in compared)
    if phase in ("23b", "24b"):
        close = max(rel) <= LONG_REL_L2 and argmax_ok
        gate = (f"relative L2 a step {[float(f'{x:.4g}') for x in rel]} "
                f"(limit {LONG_REL_L2}), argmax equal on {len(compared)} "
                f"of {LONG_STEPS} steps whose top-two gap exceeds "
                f"{guard:.3e}: {argmax_ok}")
    else:
        close = gap <= SM_F32_TOL
        gate = (f"max gap / max|logit| {gap:.3e} (limit {SM_F32_TOL}), "
                f"relative L2 a step {[float(f'{x:.3g}') for x in rel]}")
    halves = all(abs(parts * r["mesh_cache_gb"] - r0["whole_cache_gb"])
                 <= 1e-9 for r in ranks)
    want_c = _sm_seq_collectives(cfg, shape, True, LONG_LEN)
    if shape[1] > 1:
        want_c = {k: v + _sm_collectives(cfg)[k] for k, v in want_c.items()}
    coll_ok = all(r["mesh_collectives"] == {k: v * LONG_STEPS
                                            for k, v in want_c.items()}
                  for r in ranks)
    ok = alike and finite and close and halves and coll_ok
    where = ('the sequence on "data"' if shape[1] == 1 else
             'the sequence on "data", the KV heads on "model"')
    print(f"phase {phase} gemma3-4b {cfg.dtype} on {card}: {cfg.n_layers} "
          f"layers, B 1, caches of {LONG_LEN:,} slots filled to "
          f"{LONG_FILL:,} positions, {LONG_STEPS} decode steps, serving "
          f"mesh {shape} under shard_seq ({where}) on {parts} gloo ranks "
          f"vs the whole route on rank 0; {wall:.1f} s; params "
          f"{r0['params_gb']:.2f} GB whole, "
          f"{[round(r['local_gb'], 3) for r in ranks]} GB a rank; KV "
          f"caches {[round(r['mesh_cache_gb'], 4) for r in ranks]} GB a "
          f"rank, {r0['whole_cache_gb']:.4f} GB whole (1 / {parts}: "
          f"{halves}); fill {r0['mesh_fill_s']:.1f} s a rank, "
          f"{r0['whole_fill_s']:.1f} s whole", flush=True)
    print(f"phase {phase} logits mesh vs whole: {gate}; ranks' logits "
          f"{'bit for bit alike' if alike else 'DIFFERENT'}; finite "
          f"{finite}; ms a step mesh {[round(x, 2) for x in r0['mesh_ms']]} "
          f"whole {[round(x, 2) for x in r0['whole_ms']]}; peak memory "
          f"allocated a rank (mesh) "
          f"{[round(r['mesh_peak_gb'], 3) for r in ranks]} GB, whole "
          f"route {r0['whole_peak_gb']:.3f} GB; collectives a step "
          f"{ {k: v / LONG_STEPS for k, v in r0['mesh_collectives'].items()} }"
          f" (predicted {want_c}) {'ok' if ok else 'CHECK FAILED'}",
          flush=True)
    return ok, {"layers": cfg.n_layers, "dtype": cfg.dtype,
                "mesh_shape": list(shape),
                "rel_l2": rel, "max_gap_of_max_logit": gap,
                "steps_compared": [len(compared), LONG_STEPS],
                "cache_gb": {"whole": r0["whole_cache_gb"],
                             "rank": [r["mesh_cache_gb"] for r in ranks]},
                "params_gb": {"whole": r0["params_gb"],
                              "rank": [r["local_gb"] for r in ranks]},
                "ms": {"mesh": r0["mesh_ms"], "whole": r0["whole_ms"]},
                "peak_gb": {"mesh": [r["mesh_peak_gb"] for r in ranks],
                            "whole": r0["whole_peak_gb"]},
                "collectives_per_step": {
                    k: v / LONG_STEPS
                    for k, v in r0["mesh_collectives"].items()}}



# -- phase 24: weights over the serving mesh's data axis; a decode cache
# split on both its sequence and its heads --------------------------------------

# 24a: mistral-large-123b at its published widths, FSDP_LAYERS of its 88
# layers, bf16, random weights from a seed, on the serving mesh FSDP_SHAPE
# of four gloo ranks sharing the card, with fsdp_over_data=True (each
# rank's model slice of a weight split again over "data", gathered before
# each layer): B SM_B x FSDP_PROMPT, FSDP_GEN greedy tokens, in turns with
# the whole model on rank 0. 24b: gemma3-4b at long_500k on FSDP_SHAPE
# under shard_seq (its 4 KV heads divide the model axis, so each cache
# splits on its sequence over "data" and its heads over "model"), as 23b.
# 24c: mistral-large at one layer in f32 (fsdp on FSDP_SHAPE, 22e's
# prompt and steps) and gemma3-4b at 23c's two f32 layers on FSDP_SHAPE.
FSDP_ARCH, FSDP_SHAPE = "mistral-large-123b", (2, 2)
# (24a's depth cut from 2 layers to 1 to pay for phase 2b and 21b's whole
# layout, whose turns exceed the script's time limit otherwise)
FSDP_LAYERS, FSDP_PROMPT, FSDP_GEN = 1, 512, 8
# a rank's flash call in 24a's prefill: B / dd rows, H / dm heads
FSDP_FLASH = ((1, 48, 512, 128, 0),)


def _fsdp_cfg(configs, phase: str):
    """24a's mistral-large (FSDP_LAYERS layers, bf16) or 24c's (one layer,
    f32), at the published widths."""
    import dataclasses
    cfg = _depth_cut(configs, FSDP_ARCH,
                     FSDP_LAYERS if phase == "24a" else 1)
    return (cfg if phase == "24a"
            else dataclasses.replace(cfg, dtype="float32"))


def _fsdp_gathers(cfg) -> int:
    """The data group's gathers in one prefill or decode step under
    fsdp_over_data, from the code: one a layer (its weights in one
    all-reduce), one for the embedding and one for the LM head."""
    return cfg.n_layers + 2


def _fsdp_rank(phase: str) -> dict:
    """Phase 24a's program (24c's: ``phase``) on one rank of four sharing
    the card: mistral-large (``_fsdp_cfg``) made whole from a seeded CUDA
    generator and the rank's slices cut under the serving mesh FSDP_SHAPE
    with fsdp_over_data (a quarter of each split weight); ranks 1-3 then
    free the whole params, rank 0 keeps them for the whole route. 24a: a
    counted generate of SM_B x FSDP_PROMPT prompts and FSDP_GEN greedy
    tokens on the mesh and a timed prefill of the whole batch (their
    flash calls kept and held against the plain version after them);
    rank 0 then, after a short warm-up, the same on the whole model, and
    the whole route and the f32 computation teacher-forced with the
    mesh's tokens (``_sm_forced``). 24c: a generate of SM_F32_STEPS + 1 tokens on the
    mesh, rank 0 the whole route teacher-forced with its tokens. Returns
    host copies."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.tree import tree_leaves, tree_map
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    cfg = _fsdp_cfg(configs, phase)
    model = Transformer(cfg)
    counters = _sm_counters()
    prompt = FSDP_PROMPT if phase == "24a" else SM_F32_PROMPT
    gen = FSDP_GEN if phase == "24a" else SM_F32_STEPS + 1
    g = torch.Generator(device="cuda").manual_seed(24)
    t0 = time.perf_counter()
    whole = model.init(g, "cuda")
    prompts = torch.randint(0, cfg.vocab, (SM_B, prompt), generator=g,
                            device="cuda")
    with serve.serve_on_mesh(model, FSDP_SHAPE, fsdp_over_data=True):
        local = sharding.local_params(whole)
    torch.cuda.synchronize()
    out = {"rank": rank, "init_s": time.perf_counter() - t0,
           "whole_gb": sum(x.nbytes for x in tree_leaves(whole)) / 1e9,
           "local_gb": sum(x.nbytes for x in tree_leaves(local)) / 1e9}
    if rank != 0:
        del whole
    torch.cuda.empty_cache()
    if phase == "24c":
        with serve.serve_on_mesh(model, FSDP_SHAPE, fsdp_over_data=True):
            tokens, seen = serve.generate(model, local, prompts, gen,
                                          with_logits=True)
        out.update(tokens=tokens.cpu().numpy(), mesh=seen.cpu().numpy())
        del local
        if rank == 0:
            out["whole"] = _sm_forced(torch, model, whole, prompts, tokens,
                                      gen)
            del whole
        torch.cuda.empty_cache()
        dist.barrier()
        return out
    # warm-up of the whole route's first calls (cuBLAS handles, the
    # allocator); the mesh's steps are the data gathers' through the host
    if rank == 0:
        _sm_generate(torch, serve, model, whole, prompts[:, :128], 1,
                     counters, False)
    dist.barrier()
    kept = {}
    reals = _keeping_first_model_calls(torch, ops, kept)
    out["mesh"] = _sm_generate(torch, serve, model, local, prompts, gen,
                               counters, True, FSDP_SHAPE, True)
    for name, real in reals.items():
        setattr(ops, name, real)
    k_ok, k_err, k_lines = _check_kept_model_calls(
        torch, kept, {"flash_attention": flash_attention_ref})
    out["kept"] = {"ok": k_ok, "err": k_err.get("flash_attention", 0.0),
                   "lines": k_lines,
                   "shapes": sorted({tuple(ins[0].shape)
                                     for ins, _, _ in kept.values()})}
    del kept
    del local
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        out["whole"] = _sm_generate(torch, serve, model, whole, prompts, gen,
                                    counters, False)
        tokens = out["mesh"]["tokens"]
        out["whole_forced"] = _sm_forced(torch, model, whole, prompts,
                                         tokens, gen)
        model32 = Transformer(dataclasses.replace(cfg, dtype="float32"),
                              kernel_backend="ref")
        p32 = tree_map(lambda x: x.float(), whole)
        out["f32_forced"] = _sm_forced(torch, model32, p32, prompts, tokens,
                                       gen)
        del p32, whole
        torch.cuda.empty_cache()
    dist.barrier()
    for key in ("mesh", "whole"):
        if key in out:
            out[key]["tokens"] = out[key]["tokens"].cpu().numpy()
            out[key]["logits"] = out[key]["logits"].float().cpu().numpy()
    return out


def run_fsdp_mesh(torch, np, configs, serve, card, world):
    """Phase 24a: mistral-large on the serving mesh FSDP_SHAPE of
    ``world``'s four ranks with its weights over "data" too
    (``_fsdp_rank``), against the whole model on rank 0 as phase 22 holds
    its cells: the greedy tokens against the whole route's under the
    top-two gap guard (4x the whole route's own prefill |whole - f32|, at
    least a bf16 ulp of the largest logit), phase 12's per-step criterion
    (each step's relative L2 to the f32 computation at most 1.25x the
    whole route's + 1e-3), the four ranks' tokens and logits bit for bit
    alike, each rank's flash launches (one an attention layer a generate)
    and its kept flash calls at FSDP_FLASH's shape against the plain
    version, the collectives of a generate against the code's count (the
    model group's, ``_sm_collectives``, and the data group's gathers,
    ``_fsdp_gathers``, a prefill and each decode step), a rank's params a
    quarter of the whole's; each rank's peak. Returns (ok, {kernel:
    launches of the four ranks}, record, {kernel: max abs err})."""
    cfg = _fsdp_cfg(configs, "24a")
    gen = FSDP_GEN
    t0 = time.perf_counter()
    try:
        ranks = world.run(_fsdp_rank, "24a")
    except RuntimeError as e:
        print(f"phase 24a: the four ranks failed: {e} CHECK FAILED",
              flush=True)
        return False, {}, {}, {}
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    mesh, whole = r0["mesh"], r0["whole"]
    alike = all(np.array_equal(mesh["tokens"], r["mesh"]["tokens"])
                and np.array_equal(mesh["logits"], r["mesh"]["logits"])
                for r in ranks[1:])
    f32, forced = r0["f32_forced"], r0["whole_forced"]
    scale = float(np.abs(whole["logits"]).max())
    rounding = float(np.abs(forced[:, 0] - f32[:, 0]).max())
    tol = max(4 * rounding, scale * 2.0 ** -8)
    agree, n_cmp, n_all = _sm_guarded(serve, np, mesh["tokens"],
                                      whole["tokens"], whole["logits"], tol)
    to_f32 = {k: [float(np.linalg.norm(x[:, t] - f32[:, t])
                        / np.linalg.norm(f32[:, t])) for t in range(gen)]
              for k, x in (("mesh", mesh["logits"]), ("whole", forced))}
    near = all(m <= 1.25 * w + 1e-3
               for m, w in zip(to_f32["mesh"], to_f32["whole"]))
    ratio = max(m / w for m, w in zip(to_f32["mesh"], to_f32["whole"]))
    model_c = _sm_collectives(cfg)
    data_g = _fsdp_gathers(cfg)
    want_c = {"all_reduce": model_c["all_reduce"] * (gen + 1),
              "gather": (model_c["gather"] + data_g) * (gen + 1)}
    coll_ok = all(r["mesh"]["collectives"] == want_c for r in ranks)
    want_l = _sm_want(cfg, gen)
    launches_ok = all(r["mesh"]["launches"] == want_l for r in ranks)
    # the generate's prefill on the rank's row, and the timed prefill of
    # the whole batch on every rank
    kept_ok = all(r["kept"]["ok"] and tuple(FSDP_FLASH[0][:4])
                  in r["kept"]["shapes"] for r in ranks)
    quarter = all(abs(4 * r["local_gb"] - r0["whole_gb"])
                  <= 1e-3 * r0["whole_gb"] for r in ranks)
    finite = bool(np.isfinite(mesh["logits"]).all()
                  and np.isfinite(whole["logits"]).all())
    ok = (alike and agree and near and coll_ok and launches_ok and kept_ok
          and quarter and finite)
    print(f"phase 24a {FSDP_ARCH} bf16 on {card}: {cfg.n_layers} of 88 "
          f"layers, B {SM_B} x {FSDP_PROMPT}, {gen} greedy tokens, serving "
          f"mesh {FSDP_SHAPE} with fsdp_over_data on 4 gloo ranks vs the "
          f"whole model on rank 0; {wall:.1f} s with the params' init "
          f"({r0['init_s']:.1f} s); params {r0['whole_gb']:.3f} GB whole, "
          f"{[round(r['local_gb'], 4) for r in ranks]} GB a rank (a "
          f"quarter: {quarter})", flush=True)
    print(f"phase 24a tokens mesh {mesh['tokens'][0].tolist()} whole "
          f"{whole['tokens'][0].tolist()}: agree under the guard {tol:.3e} "
          f"(4x the whole route's prefill max |whole - f32| {rounding:.3e}, "
          f"at least a bf16 ulp of max|logit| {scale:.2f}) {agree}, "
          f"{n_cmp}/{n_all} steps compared; logits' relative L2 to the f32 "
          f"computation at the prefill and each decode step mesh "
          f"{[float(f'{x:.4g}') for x in to_f32['mesh']]} whole "
          f"{[float(f'{x:.4g}') for x in to_f32['whole']]} (each mesh <= "
          f"1.25 x whole + 1e-3: {near}, largest mesh / whole "
          f"{ratio:.4f}); the 4 ranks' tokens and logits "
          f"{'bit for bit alike' if alike else 'DIFFERENT'}; finite "
          f"{finite}", flush=True)
    print(f"phase 24a ms: prefill mesh {mesh['prefill_ms']:.1f} whole "
          f"{whole['prefill_ms']:.1f}; decode a token mesh "
          f"{mesh['decode_ms']:.1f} whole {whole['decode_ms']:.1f}; peak "
          f"memory a rank {[round(r['mesh']['peak_gb'], 3) for r in ranks]} "
          f"GB, whole {whole['peak_gb']:.3f} GB", flush=True)
    print(f"phase 24a collectives a generate "
          f"{[r['mesh']['collectives'] for r in ranks]} (predicted "
          f"{want_c}: the model group's {model_c} and the data group's "
          f"{data_g} gathers a prefill and a decode step, x {gen + 1}); "
          f"launches a rank {[r['mesh']['launches'] for r in ranks]} "
          f"(expected {want_l}); each rank's flash calls against the plain "
          f"version {[r['kept']['lines'] for r in ranks]} "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    launches = {n: sum(r["mesh"]["launches"][n] for r in ranks)
                for n in want_l}
    rec = {"arch": FSDP_ARCH, "layers": cfg.n_layers, "prompt": FSDP_PROMPT,
           "tokens": gen, "mesh_shape": list(FSDP_SHAPE),
           "rounding": rounding, "guard": tol,
           "steps_compared": [n_cmp, n_all], "rel_l2_to_f32": to_f32,
           "max_ratio": ratio,
           "prefill_ms": {"mesh": mesh["prefill_ms"],
                          "whole": whole["prefill_ms"]},
           "decode_ms": {"mesh": mesh["decode_ms"],
                         "whole": whole["decode_ms"]},
           "peak_gb": {"mesh": [r["mesh"]["peak_gb"] for r in ranks],
                       "whole": whole["peak_gb"]},
           "params_gb": {"whole": r0["whole_gb"],
                         "rank": [r["local_gb"] for r in ranks]},
           "collectives_per_step": {k: v / (gen + 1) for k, v in
                                    mesh["collectives"].items()},
           "wall_s": wall}
    return ok, launches, rec, {"flash_attention": max(
        r["kept"]["err"] for r in ranks)}


def run_fsdp_mesh_f32(torch, np, configs, card, world):
    """Phase 24c's mistral-large: one f32 layer with its weights over
    "data" on FSDP_SHAPE (``_fsdp_rank``), the prefill and SM_F32_STEPS
    decode steps' logits within SM_F32_TOL of the whole route's largest
    logit (teacher-forced with the mesh's tokens), the four ranks' tokens
    alike."""
    try:
        ranks = world.run(_fsdp_rank, "24c")
    except RuntimeError as e:
        print(f"phase 24c {FSDP_ARCH}: the four ranks failed: {e} CHECK "
              f"FAILED", flush=True)
        return False, {}
    r0 = ranks[0]
    gap = float(np.abs(r0["mesh"] - r0["whole"]).max()) / max(
        1.0, float(np.abs(r0["whole"]).max()))
    alike = all(np.array_equal(r0["tokens"], r["tokens"]) for r in ranks)
    ok = gap <= SM_F32_TOL and alike and bool(np.isfinite(r0["mesh"]).all())
    print(f"phase 24c {FSDP_ARCH} f32 on {card}, 1 layer, B {SM_B} x "
          f"{SM_F32_PROMPT}: prefill + {SM_F32_STEPS} decode steps, mesh "
          f"{FSDP_SHAPE} with fsdp_over_data vs whole, max gap / max|logit| "
          f"{gap:.3e} (limit {SM_F32_TOL}); params "
          f"{[round(r['local_gb'], 3) for r in ranks]} GB a rank, "
          f"{r0['whole_gb']:.3f} whole; ranks' tokens "
          f"{'alike' if alike else 'DIFFERENT'} "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    return ok, {"max_gap_of_max_logit": gap}


# -- phase 25: shard_map in slab state --------------------------------------
# Two gloo ranks sharing the card (one world for 25a-c) on shard_map's
# (2, 1) mesh, each rank's state its client block's rows between rounds.
# 25a: phase 3's Adult-1 spec (block 8 of 16 clients, N 210) under each of
# SLAB_RUNS, in slab state and in the whole layout (api.whole_state of it);
# 25b: the population quickstart's resident step (phase 9's) in both forms;
# 25c: gemma3-4b's widths as 21b's cell (1 layer, f32, C 2: a rank's block
# is one client, tau 1, seq SLAB_TF_SEQ), the forms in turns
SLAB_RUNS = (("dense", {}),
             ("qsgd8_q50", dict(compressor="qsgd", compression_bits=8,
                                participation=0.5)),
             ("trimmed_mean", dict(aggregator="trimmed_mean",
                                   trim_fraction=0.1)),
             ("secure", dict(secure_agg=True, dp_accounting="central")))
SLAB_KERNELS = ("dp_clip_noise", "counter_rng", "quantize_decompress")
SLAB_FORMS = ("slab", "whole")
SLAB_TF_CELL = "21b"        # the MA_CELLS entry 25c takes its model from
SLAB_TF_SEQ, SLAB_TF_TURNS = 2048, 2


def _state_bytes(state) -> int:
    """Bytes of an FLState's params, optimizer state and residual on this
    rank."""
    from repro_torch.utils.tree import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(
        (state.params, state.opt_state, state.residual)))


def _logging_calls(ops, names, log):
    """Put a wrapper in ``ops`` in place of each kernel of ``names`` that
    appends (name, the shape of what it computes) to ``log`` at every call:
    the rows and columns of dp_clip_noise and quantize_decompress, the (R,
    tau, n) of a counter_rng draw. Returns the wrapped functions, to put
    back."""
    reals = {}
    for name in names:
        reals[name] = getattr(ops, name)

        def logger(*args, _real=reals[name], _name=name):
            shape = tuple(args[0].shape)
            if _name == "counter_rng":
                shape += (int(args[2]), int(args[3]))
            log.append((_name, shape))
            return _real(*args)
        setattr(ops, name, logger)
    return reals


def _slab_adult_rank(kw: dict, settings, device: str = "cuda") -> dict:
    """Phase 25a's program on one rank: the Adult-1 spec ``kw`` as
    shard_map under each of ``settings``, trained until a budget binds in
    slab state and in the whole layout (api.whole_state of a fresh slab
    state), the counters set to 0 just before each run and read just
    after, with the shape of every kernel call; each kernel's first call
    of each shape held against its plain version. Returns the states made
    whole (numpy), the ledgers, launches, shapes, the rows and bytes each
    form holds."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api, data, optim
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.counter_rng import counter_rng
    from repro_torch.kernels.dp_clip_noise import dp_clip_noise
    from repro_torch.kernels.quantize_decompress import quantize_decompress
    from repro_torch.models import linear
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"dp_clip_noise": dp_clip_noise, "counter_rng": counter_rng,
                "quantize_decompress": quantize_decompress}
    fed = data.split_by_group(data.adult_like())
    dim = fed.clients[0].x_train.shape[1]
    kept, shapes = {}, []
    reals = _keeping_first_calls(torch, ops, list(counters), kept)
    keepers = _logging_calls(ops, list(counters), shapes)
    out = {"rank": dist.get_rank(), "runs": {}}
    try:
        for name, extra in settings:
            spec = api.FederationSpec(
                loss_fn=linear.logreg_loss, optimizer=optim.sgd(LR),
                **{**kw, **extra, "engine": "shard_map"})
            out["runs"][name] = run = {}
            for form in SLAB_FORMS:
                state = api.init_state(spec, linear.init_linear(
                    dim, device=device), device=device)
                if form == "whole":
                    state = api.whole_state(state)
                held = (None if state.layout is None
                        else state.layout.n_rows, _state_bytes(state))
                if device == "cuda":
                    torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                del shapes[:]
                state, res = api.train(spec, state, fed.make_sampler(BATCH))
                if device == "cuda":
                    torch.cuda.synchronize()
                launched = {n: c.launches for n, c in counters.items()}
                seen = sorted(set(shapes))
                whole = api.whole_state(state)
                run[form] = {
                    "params": {k: v.cpu().numpy()
                               for k, v in whole.params.items()},
                    "residual": (None if whole.residual is None
                                 else whole.residual.cpu().numpy()),
                    "key": whole.key.numpy(), "rho": np.asarray(whole.rho),
                    "rounds": res["rounds"],
                    "max_epsilon": res["max_epsilon"],
                    "resource_spent": res["resource_spent"],
                    "launches": launched, "shapes": seen,
                    "rows": held[0], "bytes": held[1], "tau": spec.tau}
    finally:
        for n, f in keepers.items():
            setattr(ops, n, f)
        for n, f in reals.items():
            setattr(ops, n, f)
    refs = {"dp_clip_noise": ref.dp_clip_noise_ref,
            "quantize_decompress": ref.quantize_decompress_ref,
            "counter_rng": ref.counter_rng_ref}
    out["kernels_ok"], out["kernel_err"], out["kernel_lines"] = \
        _check_kept_calls(torch, kept, refs)
    return out


def _slab_adult_expected(spec, extra: dict, rounds: int) -> dict:
    """The launches a rank's run of ``rounds`` rounds makes, from the code:
    one dp_clip_noise a local step; counter_rng one noise draw a round,
    and under a pipeline the participation mask's and, with qsgd, the
    uniforms' (the secure sum's pair masks come from a torch.Generator);
    quantize_decompress one a round with qsgd."""
    pipeline = spec.replace(**extra).has_pipeline()
    qsgd = extra.get("compressor") == "qsgd"
    return {"dp_clip_noise": spec.tau * rounds,
            "counter_rng": rounds * (1 + pipeline + qsgd),
            "quantize_decompress": rounds if qsgd else 0}


def run_slab_adult(torch, np, spec, card, world):
    """Phase 25a: the Adult-1 spec (16 clients, N 210) as shard_map (2, 1)
    on two gloo ranks sharing the card, under each of SLAB_RUNS, trained
    until a budget binds in slab state and in the whole layout: the slab
    run's state made whole bit for bit the whole layout's (params,
    residual, key, rho) with the same rounds, epsilon and cost, both ranks
    alike; each rank's slab holding its block's 8 rows, half the whole
    layout's bytes; each rank's launches of dp_clip_noise, counter_rng
    and quantize_decompress as the code implies (_slab_adult_expected),
    every dp_clip_noise and quantize_decompress call and every noise and
    uniform draw of the slab run on the block's 8 rows (the mask's 16);
    each kernel's first call of each shape against its plain version.
    Returns (ok, {kernel: launches of the slab runs, both ranks}, {kernel:
    max abs err})."""
    kw = dict(n_clients=spec.n_clients, tau=spec.tau,
              clip_norm=spec.clip_norm, dp=True, sigmas=spec.sigmas,
              batch_sizes=spec.batch_sizes, eps_th=spec.eps_th,
              delta=spec.delta, c_th=spec.c_th)
    t0 = time.perf_counter()
    try:
        ranks = world.run(_slab_adult_rank, kw, SLAB_RUNS)
    except RuntimeError as e:
        print(f"phase 25a: the two ranks failed: {e} CHECK FAILED",
              flush=True)
        return False, dict.fromkeys(SLAB_KERNELS, 0), {}
    block = spec.n_clients // 2
    ok, launches = True, dict.fromkeys(SLAB_KERNELS, 0)
    print(f"phase 25a: Adult-1 as shard_map (2, 1) on two gloo ranks "
          f"({card}), block {block} of {spec.n_clients}, N 210; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, extra in SLAB_RUNS:
        runs = [r["runs"][name] for r in ranks]
        slab, whole = runs[0]["slab"], runs[0]["whole"]
        same = all(
            _np_equal(np, slab[k], whole[k])
            for k in ("params", "residual", "key", "rho")) and all(
            slab[k] == whole[k]
            for k in ("rounds", "max_epsilon", "resource_spent"))
        alike = all(_np_equal(np, r[f][k], runs[0][f][k])
                    for r in runs[1:] for f in SLAB_FORMS
                    for k in ("params", "residual", "key", "rho"))
        want = _slab_adult_expected(spec, extra, slab["rounds"])
        counted = all(r[f]["launches"] == want for r in runs
                      for f in SLAB_FORMS)
        on_block = all(
            s[0] == block or (n == "counter_rng" and s[-1] == 1
                              and s[0] == spec.n_clients)
            for r in runs for n, s in r["slab"]["shapes"])
        held = all(r["slab"]["rows"] == block
                   and 2 * r["slab"]["bytes"] == r["whole"]["bytes"]
                   for r in runs)
        good = (same and alike and counted and on_block and held
                and slab["rounds"] > 0)
        ok &= good
        for r in runs:
            for n, v in r["slab"]["launches"].items():
                launches[n] += v
        print(f"phase 25a {name}: rounds {slab['rounds']} eps "
              f"{slab['max_epsilon']!r} cost {slab['resource_spent']!r}; "
              f"slab (made whole) vs the whole layout "
              f"{'bit for bit' if same else 'DIFFERENT'}; ranks "
              f"{'alike' if alike else 'DIFFERENT'}; rows a rank "
              f"{[r['slab']['rows'] for r in runs]}, bytes a rank slab "
              f"{[r['slab']['bytes'] for r in runs]} / whole "
              f"{[r['whole']['bytes'] for r in runs]}; launches per rank "
              f"and form "
              f"{[[r[f]['launches'] for f in SLAB_FORMS] for r in runs]}"
              f" (expected {want}); slab call shapes "
              f"{runs[0]['slab']['shapes']} "
              f"{'ok' if good else 'CHECK FAILED'}", flush=True)
    worst = {}
    for r in ranks:
        ok &= r["kernels_ok"]
        for n, e in r["kernel_err"].items():
            worst[n] = max(worst.get(n, 0.0), e)
        for ln in r["kernel_lines"]:
            print(f"phase 25a rank {r['rank']} kernel vs plain: {ln}",
                  flush=True)
    return ok, launches, worst


def _np_equal(np, a, b) -> bool:
    """Two numpy trees (dicts, arrays or None) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_np_equal(np, a[k], b[k])
                                            for k in a)
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _qs_gathers() -> int:
    """cohort_gather_scatter's launches in the quickstart's resident step
    (24 rounds, chunk 8, S 256): 4 a round (the residual rows' gather and
    scatter, the x and y shard gathers), 1 a chunk (the FLState's residual
    view), the promotions (per chunk the cold residual rows and the 2 data
    leaves: 3, 3, and 4 in chunk 3, which also gathers its 126 evicted
    rows), and 1 for the final flush. A slab rank's are as many, on its
    block's slots (the scatter and the cache's moves on all K)."""
    return 4 * QS_ROUNDS + 3 + (3 + 3 + 4) + 1


def _slab_resident_rank(device: str = "cuda") -> dict:
    """Phase 25b's program on one rank: the population quickstart's
    resident step (M 100,000, K 16, S 256, chunk 8, 24 rounds) as
    shard_map in slab state and in the whole layout, cohort_gather_scatter's
    counter set to 0 just before each run and read just after; then one
    steady slab chunk (the third) under set_sync_debug_mode with every
    torch.distributed call it makes recorded; cohort_gather_scatter's
    first call of each shape (the block's 8 slots of the cache and of the
    data shards, the scatter of all 16) held against its plain version.
    Returns each form's state made whole, ledgers, stats, launches and the
    store's digest, whether the forms' stores are equal, the syncs and
    collectives, the kernel check."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api, optim
    from repro_torch import population as pop_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.cohort_gather_scatter import (
        cohort_gather_scatter,
    )
    from repro_torch.models import linear
    if device == "cuda":
        torch.cuda.set_device(0)
    spec = _quickstart_spec(api, linear, optim).replace(engine="shard_map")
    pop = pop_mod.synthetic_population(QS_M, dim=QS_DIM,
                                       batch_size=QS_BATCH, alpha=0.3,
                                       seed=0, stationary=True)
    vids = np.arange(QS_M)
    out = {"rank": dist.get_rank(), "forms": {}}
    stores, kept = {}, {}
    for form in SLAB_FORMS:
        st = pop_mod.init_population_state(spec, linear.init_linear(
            QS_DIM, device=device), device=device)
        if form == "whole":
            st = st.replace(fl=api.whole_state(st.fl))
        rows = None if st.fl.layout is None else st.fl.layout.n_rows
        if device == "cuda":
            torch.cuda.synchronize()
        cohort_gather_scatter.launches = 0
        reals = (_keeping_first_calls(torch, ops, ["cohort_gather_scatter"],
                                      kept) if form == "slab" else {})
        t0 = time.perf_counter()
        try:
            st, res = pop_mod.train_population(
                spec, st, pop, max_rounds=QS_ROUNDS, chunk_rounds=QS_CHUNK,
                resident_cache=QS_CACHE)
            if device == "cuda":
                torch.cuda.synchronize()
        finally:
            for n, f in reals.items():
                setattr(ops, n, f)
        wall = time.perf_counter() - t0
        whole = api.whole_state(st.fl)
        stores[form] = (np.asarray(st.store.rho),
                        st.store.gather_residual(vids))
        out["forms"][form] = {
            "params": {k: v.cpu().numpy() for k, v in whole.params.items()},
            "residual": whole.residual.cpu().numpy(),
            "key": whole.key.numpy(), "rho": np.asarray(whole.rho),
            "rounds": res["rounds"], "max_epsilon": res["max_epsilon"],
            "resource_spent": res["resource_spent"],
            "stats": res["resident_cache"],
            "residual_rows": st.store.residual_rows(),
            "launches": cohort_gather_scatter.launches, "rows": rows,
            "ms_per_round": wall * 1e3 / max(res["rounds"], 1),
            "store_digest": hashlib.sha256(
                stores[form][0].tobytes()
                + stores[form][1].tobytes()).hexdigest()}
    out["stores_equal"] = all(
        _np_equal(np, a, b) for a, b in zip(stores["slab"], stores["whole"]))
    out["kernels_ok"], out["kernel_err"], out["kernel_lines"] = \
        _check_kept_calls(torch, kept,
                          {"cohort_gather_scatter":
                           ref.cohort_gather_scatter_ref})
    # the slot counts of the gathers held (a gather's key: the kernel, the
    # cache and the slots)
    out["kept_slots"] = sorted({k[2][0][0] for k in kept if len(k) == 3})
    # one steady slab chunk: its blocking host syncs and its collectives
    st = pop_mod.init_population_state(spec, linear.init_linear(
        QS_DIM, device=device), device=device)
    cache = pop_mod.init_resident_cache(spec, st, QS_CACHE, population=pop)
    rng = np.random.default_rng(0)

    def chunk(st):
        return pop_mod.run_resident_rounds(spec, st, pop, rng, cache,
                                           n_rounds=QS_CHUNK,
                                           check_budgets=False)[0]

    for _ in range(2):
        st = chunk(st)
    calls = []
    names = ("all_reduce", "broadcast", "broadcast_object_list",
             "all_gather", "barrier")
    saved = {n: getattr(dist, n) for n in names}

    def spy(name):
        def call(*args, **kwargs):
            t = args[0] if args else None
            ours = [f for f in traceback.extract_stack()[:-1]
                    if "repro_torch" in f.filename]
            where = (f"{Path(ours[-1].filename).name}:{ours[-1].lineno}"
                     if ours else "outside repro_torch")
            calls.append(f"{name} {tuple(t.shape)} {t.dtype} from {where}"
                         if isinstance(t, torch.Tensor) else
                         f"{name} from {where}")
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, spy(n))
    try:
        if device == "cuda":
            st, syncs = _blocking_syncs(torch, lambda: chunk(st))
        else:
            st, syncs = chunk(st), []
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
    out["syncs"], out["collectives"] = syncs, calls
    return out


def run_slab_resident(torch, np, card, world):
    """Phase 25b: the population quickstart's resident step (phase 9's: M
    100,000, K 16, S 256, chunk 8, 24 rounds, stationary shards) as
    shard_map (2, 1) on two gloo ranks sharing the card, in slab state
    (each rank's K-block state its block's 8 rows) and in the whole
    layout: the slab run's state made whole, the store's rho and every
    residual row bit for bit the whole layout's, phase 9's epsilon, cost
    and cache stats exactly, both ranks' stores alike; each rank's
    cohort_gather_scatter launches _qs_gathers() in each form; then one
    steady slab chunk's blocking host syncs (set_sync_debug_mode, named by
    their source line) and its collectives (each a host-staged gloo call
    on CUDA tensors); cohort_gather_scatter's first slab call of each
    shape against its plain version, bit for bit, the block's 8-slot
    gathers among them. Returns (ok, launches of the slab runs on both
    ranks, the kernel's max abs err)."""
    t0 = time.perf_counter()
    try:
        ranks = world.run(_slab_resident_rank)
    except RuntimeError as e:
        print(f"phase 25b: the two ranks failed: {e} CHECK FAILED",
              flush=True)
        return False, 0, 0.0
    want = _qs_gathers()
    f0 = ranks[0]["forms"]
    slab, whole = f0["slab"], f0["whole"]
    same = all(_np_equal(np, slab[k], whole[k])
               for k in ("params", "residual", "key", "rho")) and all(
        slab[k] == whole[k] for k in ("rounds", "max_epsilon",
                                      "resource_spent", "stats",
                                      "residual_rows", "store_digest"))
    same &= all(r["stores_equal"] for r in ranks)
    alike = all(r["forms"][f]["store_digest"] == f0[f]["store_digest"]
                and _np_equal(np, r["forms"][f]["params"], f0[f]["params"])
                for r in ranks[1:] for f in SLAB_FORMS)
    exact = (slab["rounds"] == QS_ROUNDS
             and slab["max_epsilon"] == 4.729618937506673
             and slab["resource_spent"] == 720.0
             and slab["stats"] == {"hits": 1, "misses": 382,
                                   "evictions": 126, "flushes": 1}
             and slab["residual_rows"] == 382)
    counted = all(r["forms"][f]["launches"] == want for r in ranks
                  for f in SLAB_FORMS)
    held = [r["forms"]["slab"]["rows"] for r in ranks] == [QS_K // 2] * 2
    # the block's gathers (K / 2 slots) were among the calls held
    on_block = all(QS_K // 2 in r["kept_slots"] for r in ranks)
    checked = all(r["kernels_ok"] for r in ranks) and on_block
    ok = same and alike and exact and counted and held and checked
    print(f"phase 25b: the resident quickstart (M={QS_M:,}, K={QS_K}, "
          f"S={QS_CACHE}, chunk {QS_CHUNK}) as shard_map (2, 1) on two gloo "
          f"ranks ({card}); {time.perf_counter() - t0:.1f} s; rounds "
          f"{slab['rounds']} eps {slab['max_epsilon']!r} cost "
          f"{slab['resource_spent']} cache {slab['stats']}; slab vs the "
          f"whole layout (state made whole, store rho and every residual "
          f"row) {'bit for bit' if same else 'DIFFERENT'}; ranks "
          f"{'alike' if alike else 'DIFFERENT'}; rows a rank "
          f"{[r['forms']['slab']['rows'] for r in ranks]}; "
          f"cohort_gather_scatter launches per rank and form "
          f"{[[r['forms'][f]['launches'] for f in SLAB_FORMS] for r in ranks]}"
          f" (expected {want}); ms per round on rank 0 (train wall / "
          f"rounds) slab {slab['ms_per_round']:.3f}, whole "
          f"{whole['ms_per_round']:.3f} {'ok' if ok else 'CHECK FAILED'}",
          flush=True)
    for r in ranks:
        calls = r["collectives"]
        print(f"phase 25b rank {r['rank']} one steady slab chunk "
              f"({QS_CHUNK} rounds): {len(r['syncs']) + len(calls)} "
              f"blocking host syncs: {len(r['syncs'])} in the driver "
              f"(set_sync_debug_mode's Python warnings)"
              + _sync_lines(r["syncs"])
              + f"\n  and {len(calls)} torch.distributed calls on CUDA "
              f"tensors, each a host round trip in gloo (its worker thread "
              f"synchronizes the copy: set_sync_debug_mode warns on the "
              f"rank's stderr, outside Python's warnings):"
              + "".join(f"\n  x{calls.count(c)} {c}"
                        for c in sorted(set(calls))), flush=True)
        for ln in r["kernel_lines"]:
            print(f"phase 25b rank {r['rank']} kernel vs plain: {ln}",
                  flush=True)
    if not on_block:
        print(f"phase 25b: the kernel check held gathers of "
              f"{[r['kept_slots'] for r in ranks]} slots, none of the "
              f"block's {QS_K // 2} CHECK FAILED", flush=True)
    err = max(r["kernel_err"].get("cohort_gather_scatter", 0.0)
              for r in ranks)
    return ok, sum(r["forms"]["slab"]["launches"] for r in ranks), err


def _slab_tf_rank(sigmas, turns: int, seq: int) -> dict:
    """Phase 25c's program on one rank: gemma3-4b's widths (SLAB_TF_CELL's
    cell, f32) built by launch.train.build_federation as shard_map on the
    two ranks, in the forms "slab" (the rank's block of one client between
    rounds) and "whole" (api.whole_state of it: every rank holding the
    (2, ...) trees), one round each on the same batch, in turns; the peak
    memory reset and the counters set to 0 just before each round and
    read after it. In the last turn the slab round's dp_clip_noise call,
    on the rank's (1, N) row, is kept (device clones: 3 x 3.06 GB, a few
    ms of its round) and held against its plain version on the same
    operands after the slab state is freed, one rank after the other.
    Returns each form's ms per round, losses, per-rank peak (its first
    turn's), launches, and whether the slab's block rows of params equal
    the whole layout's rows of this rank bit for bit (the last turns,
    compared on the host), the kernel check."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import api, configs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.counter_rng import counter_rng
    from repro_torch.kernels.dp_clip_noise import dp_clip_noise
    from repro_torch.launch import train as launch_train
    from repro_torch.utils.tree import tree_leaves
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    rank = dist.get_rank()
    cfg = _ma_cfg(configs, SLAB_TF_CELL)
    n_clients = MA_CELLS[SLAB_TF_CELL][3]
    counters = {"dp_clip_noise": dp_clip_noise, "counter_rng": counter_rng}
    out = {"rank": rank, "ms": {f: [] for f in SLAB_FORMS}, "losses": {},
           "peak_gb": {}, "launches": {f: [] for f in SLAB_FORMS},
           "build_s": []}
    batch = rows = None
    kept = {}
    for turn in range(turns):
        for form in SLAB_FORMS:
            dist.barrier()
            t_build = time.perf_counter()
            model, spec, state, sampler = launch_train.build_federation(
                cfg, n_clients, MA_TF_TAU, MA_TF_B, seq, sigmas,
                clip_norm=CLIP, delta=DELTA, engine="shard_map",
                device="cuda")
            if form == "whole":
                state = api.whole_state(state)
            assert (state.layout is not None) == (form == "slab")
            out["n_params"] = sum(x[0].numel()
                                  for x in tree_leaves(state.params))
            if batch is None:
                batch = api.round_batch(spec, sampler,
                                        np.random.default_rng(0))
            del sampler
            torch.cuda.synchronize()
            out["build_s"].append(round(time.perf_counter() - t_build, 3))
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            check = turn == turns - 1 and form == "slab"
            reals = (_keeping_first_calls(torch, ops, ["dp_clip_noise"],
                                          kept) if check else {})
            t0 = time.perf_counter()
            try:
                state, rec = api.run_round(spec, state, batch,
                                           check_budgets=False)
                torch.cuda.synchronize()
            finally:
                for n, f in reals.items():
                    setattr(ops, n, f)
            out["ms"][form].append((time.perf_counter() - t0) * 1e3)
            out["peak_gb"].setdefault(
                form, torch.cuda.max_memory_allocated() / 1e9)
            out["losses"][form] = float(rec["loss"])
            out["launches"][form].append({n: c.launches
                                          for n, c in counters.items()})
            if turn == turns - 1:
                # this rank's rows: the slab's block, the whole layout's
                # row of the same client
                mine = [(x if form == "slab" else x[rank:rank + 1]).cpu()
                        for x in tree_leaves(state.params)]
                if rows is None:
                    rows = mine
                else:
                    out["slab_equals_whole"] = all(
                        torch.equal(a, b) for a, b in zip(rows, mine))
                del mine
            del model, spec, state, rec
            torch.cuda.empty_cache()
            if check:
                # the check's float64 differences take ~25 GB: one rank at
                # a time
                for r in range(dist.get_world_size()):
                    if r == rank:
                        out["kernels_ok"], out["kernel_err"], \
                            out["kernel_lines"] = _check_kept_calls(
                                torch, kept,
                                {"dp_clip_noise": ref.dp_clip_noise_ref})
                        out["kept_rows"] = [k[1][0] for k in kept]
                        kept.clear()
                        torch.cuda.empty_cache()
                    dist.barrier()
    dist.barrier()
    return out


def run_slab_tf(torch, np, fl, configs, card, world):
    """Phase 25c: gemma3-4b's widths (d_model 2560, vocab 262144, depth 1,
    f32), C 2 (a rank's block one client), tau 1, batch 1, seq
    SLAB_TF_SEQ, as shard_map (2, 1) on two gloo ranks sharing the card,
    slab state and the whole layout in turns, one round each: the slab's
    params bit for bit the whole layout's rows, the losses finite and
    alike on the ranks, ms per round of each form, each rank's peak memory
    (the slab's at least MA_SLAB_SAVING_GB below the whole layout's),
    launches per rank and round (dp_clip_noise tau on the rank's (1, N)
    row, counter_rng one). Returns (ok, {kernel: launches of the slab
    rounds, both ranks, the last turn}, record, dp_clip_noise's max abs
    err against its plain version on a rank's (1, N) row, the last slab
    turn's)."""
    sigmas = fl.design_sigmas(MA_TF_TAU, CLIP, [MA_TF_B] * 2, TRAIN_EPS,
                              DELTA)
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = world.run(_slab_tf_rank, sigmas, SLAB_TF_TURNS, SLAB_TF_SEQ)
    except RuntimeError as e:
        print(f"phase 25c: the two ranks failed: {e} CHECK FAILED",
              flush=True)
        return (False, dict.fromkeys(("dp_clip_noise", "counter_rng"), 0),
                {}, 0.0)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    want = {"dp_clip_noise": MA_TF_TAU, "counter_rng": 1}
    counted = all(ln == want for r in ranks for f in SLAB_FORMS
                  for ln in r["launches"][f])
    finite = all(math.isfinite(r["losses"][f]) for r in ranks
                 for f in SLAB_FORMS)
    alike = all(r["losses"] == r0["losses"] for r in ranks[1:])
    saving = [r["peak_gb"]["whole"] - r["peak_gb"]["slab"] for r in ranks]
    equal = all(r["slab_equals_whole"] for r in ranks)
    # each rank held its (1, N) row's call against the plain version
    checked = all(r["kernels_ok"] and r["kept_rows"] == [(1, r0["n_params"])]
                  for r in ranks)
    ok = (counted and finite and alike and equal and checked
          and min(saving) >= MA_SLAB_SAVING_GB)
    print(f"phase 25c on {card}: gemma3-4b's widths, f32, 1 layer, N = "
          f"{r0['n_params']:,} params a replica, C 2 (block 1 a rank), tau "
          f"{MA_TF_TAU}, batch {MA_TF_B}, seq {SLAB_TF_SEQ}, shard_map "
          f"(2, 1) on 2 gloo ranks, slab and whole in turns; {wall:.1f} s "
          f"(builds {r0['build_s']} s)", flush=True)
    print(f"phase 25c: ms per round in turns (slab, whole): "
          + "; ".join(f"{f} {[round(x, 3) for x in r0['ms'][f]]}"
                      for f in SLAB_FORMS)
          + f"; peak memory allocated per rank, first turn: "
          + "; ".join(f"{f} {[round(r['peak_gb'][f], 3) for r in ranks]} GB"
                      for f in SLAB_FORMS)
          + f"; the slab's saving per rank {[round(x, 3) for x in saving]} "
          f"GB (limit >= {MA_SLAB_SAVING_GB}); the slab's rows "
          f"{'bit for bit' if equal else 'DIFFERENT from'} the whole "
          f"layout's; losses {[r['losses'] for r in ranks]}; launches per rank "
          f"{[r['launches'] for r in ranks]} (expected {want} a round) "
          f"{'ok' if ok else 'CHECK FAILED'}", flush=True)
    for r in ranks:
        for ln in r["kernel_lines"]:
            print(f"phase 25c rank {r['rank']} kernel vs plain (the last "
                  f"slab turn): {ln}", flush=True)
        if r["kept_rows"] != [(1, r0["n_params"])]:
            print(f"phase 25c rank {r['rank']}: dp_clip_noise held on "
                  f"{r['kept_rows']}, not the rank's (1, "
                  f"{r0['n_params']:,}) row CHECK FAILED", flush=True)
    launches = {n: sum(r["launches"]["slab"][-1][n] for r in ranks)
                for n in want}
    err = max(r["kernel_err"].get("dp_clip_noise", 0.0) for r in ranks)
    rec = {"ms": r0["ms"], "losses": r0["losses"],
           "peak_gb_per_rank": {f: [r["peak_gb"][f] for r in ranks]
                                for f in SLAB_FORMS},
           "slab_saving_gb_per_rank": saving, "seq": SLAB_TF_SEQ,
           "dp_clip_noise_max_abs_err": err}
    return ok, launches, rec, err



def main() -> int:
    if sys.argv[1:2] == ["--time-row-kernels"] and len(sys.argv) == 3:
        return time_row_kernels(sys.argv[2])
    if (sys.argv[1:2] == ["--train-memory"] and len(sys.argv) in (4, 5)
            and sys.argv[2] in ("fixed", "expandable")
            and sys.argv[3].isdigit()):
        return train_memory(sys.argv[2], int(sys.argv[3]), *sys.argv[4:])
    if len(sys.argv) > 1:
        print(f"usage: {sys.argv[0]} [--time-row-kernels SRC | "
              f"--train-memory fixed|expandable TAU [SRC]]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on a GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))          # benchmarks/*_torch.py
    import numpy as np

    from repro_torch import api, asyncfl, configs, data, optim
    from repro_torch import population as pop_mod
    from repro_torch.core import convergence as conv
    from repro_torch.core import design, fl
    from repro_torch.kernels import _build
    from repro_torch.kernels.cohort_gather_scatter import (
        cohort_gather_scatter,
        vector_width,
    )
    from repro_torch.kernels.dp_clip_noise import dp_clip_noise
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd
    from repro_torch.kernels.quantize_decompress import quantize_decompress
    from repro_torch.kernels.ref import (
        cohort_gather_scatter_ref,
        dp_clip_noise_ref,
        flash_attention_ref,
        mamba2_ssd_ref,
        quantize_decompress_ref,
        rwkv6_scan_ref,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch import serve as serve_pkg
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import linear
    from repro_torch.models.transformer import Transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def done(phases: str) -> None:
        print(f"phases {phases} done at {time.perf_counter() - t_start:.1f} "
              f"s", flush=True)

    # -- 1. card and build ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    ok_build = True
    for name, (secs, log) in _build.build_all().items():
        print(f"build {name}: {secs:.2f} s", flush=True)
        for inst, regs, frame, st, ld in _ptxas_instances(log):
            print(f"  {name} {inst}: {regs} registers, {frame} bytes stack "
                  f"frame, {st} bytes spill stores, {ld} bytes spill loads",
                  flush=True)
            if inst.startswith(("flash_tc", "counter_rng")) and st + ld:
                ok_build = False

    dry = start_dryrun()                   # phase 19b's, in the background

    # -- 2. kernels against their plain versions --------------------------
    ok_k, main_rec, worst = check_kernels(torch, dp_clip_noise,
                                          dp_clip_noise_ref)
    ok_q, q_rec, q_worst = check_qsgd_kernel(torch, quantize_decompress,
                                             quantize_decompress_ref)
    ok_g, g_rec, g_worst = check_cohort_kernel(
        torch, cohort_gather_scatter, cohort_gather_scatter_ref,
        vector_width)

    done("1-2")

    # -- 3. main path ---------------------------------------------------------
    ok_m, (launches, rng_launches), spec, fed = run_main_path(
        torch, np, api, linear, data, conv, design, optim, dp_clip_noise)

    # -- 2b. counter_rng against its plain version (the main path's draw
    # shape, from its design, and 21b's slab) ---------------------------------
    ok_rng, rng_rec = check_counter_rng(
        torch, configs, (spec.n_clients, spec.tau,
                         2 * fed.clients[0].x_train.shape[1] + 2), card)

    done("3, 2b")

    # -- 4. kernel round against plain round ----------------------------------
    ok_b = compare_backends(torch, np, api, linear, spec, fed)

    # -- 5. steady rounds, and where their device time goes ----------------
    ok_s = profile_rounds(torch, np, api, linear, spec, fed, "phase 5")

    done("4-5")

    # -- 6. the aggregation pipeline: the comm sweep at full width ----------
    ok_c, q_launches, fed2 = run_comm_sweep(
        torch, np, api, linear, data, optim, fl, dp_clip_noise,
        quantize_decompress)
    ok_c &= profile_rounds(torch, np, api, linear, _sweep_spec(
        api, linear, optim, fl, fed2, 0.5, "qsgd", 0.25), fed2,
        "phase 6 qsgd8_q50")

    # -- 7. the pipeline's kernel route against its plain route -------------
    ok_r = compare_qsgd_routes(torch, np, api, linear, optim, fl, fed2)

    done("6-7")

    # -- 8. the population plane, M == C, against the dense path ------------
    ok_p8 = run_population_m_equals_c(torch, api, linear, optim, fl, pop_mod,
                                      fed2, cohort_gather_scatter)

    # -- 9. the population quickstart's resident step -------------------------
    ok_p9, g_launches, qs_spec, qs_pop = run_quickstart_resident(
        torch, np, api, linear, optim, pop_mod, cohort_gather_scatter)
    time_population_drivers(torch, linear, pop_mod, qs_spec, qs_pop)
    ok_p9 &= profile_resident_chunk(torch, np, linear, pop_mod, qs_spec,
                                    qs_pop)

    done("8-9")

    # -- 10. the model kernels against their plain versions -----------------
    ok_mk, mk_recs, mk_worst = check_model_kernels(
        torch, (flash_attention, rwkv6_scan, mamba2_ssd),
        (flash_attention_ref, rwkv6_scan_ref, mamba2_ssd_ref))

    done("10")

    # -- 11. full-width static serving ----------------------------------------
    counters = {"dp_clip_noise": dp_clip_noise,
                "quantize_decompress": quantize_decompress,
                "cohort_gather_scatter": cohort_gather_scatter,
                "flash_attention": flash_attention,
                "rwkv6_scan": rwkv6_scan, "mamba2_ssd": mamba2_ssd}
    ok_sv, sv_launches = run_serving(torch, configs, Transformer, serve,
                                     counters)

    # -- 12. the model's kernel route against its plain route ---------------
    ok_rt = compare_model_routes(torch, configs, Transformer)

    done("11-12")

    # -- 13. the paper's experiments at full width ---------------------------
    ok_px, px_launches = run_paper_experiments(torch, dp_clip_noise, card)

    done("13")

    # -- 14. the trust plane ---------------------------------------------------
    ok_tk = check_trust_kernels(torch, np)
    ok_at, at_launches = run_attack_check(torch, dp_clip_noise)
    ok_sc, sc_launches = run_secure_central(torch, np, api, linear, spec,
                                            fed, dp_clip_noise)
    ok_tr = time_trust_rounds(torch, np, api, linear, spec, fed, card)

    done("14")

    # -- 15. the buffered-async plane -----------------------------------------
    ok_aa, aa_calls = run_async_identity(
        torch, np, api, asyncfl, spec, fed,
        {"dp_clip_noise": dp_clip_noise,
         "quantize_decompress": quantize_decompress})
    ok_ab, ab_launches = run_async_full_width(
        torch, np, asyncfl, spec, fed, dp_clip_noise, card)
    ok_ac, ac_launches = run_async_straggler(torch, np, api, asyncfl,
                                             dp_clip_noise)

    done("15")

    # -- 16. the transformer training path ------------------------------------
    ok_tw, tw_launches, tw_rec = run_training_full_width(
        torch, np, api, fl, ops, launch_train, configs, counters,
        dp_clip_noise, dp_clip_noise_ref, card)
    ok_ls, ls_launches, ls_errs = run_launcher_smoke(
        torch, ops, launch_train, serve, configs, counters,
        {"dp_clip_noise": dp_clip_noise_ref,
         "quantize_decompress": quantize_decompress_ref,
         "cohort_gather_scatter": cohort_gather_scatter_ref}, card)

    done("16")

    # -- 17. the continuous-batching serving engine ---------------------------
    t17 = time.perf_counter()
    model_refs = {"flash_attention": flash_attention_ref,
                  "rwkv6_scan": rwkv6_scan_ref,
                  "mamba2_ssd": mamba2_ssd_ref}
    ok_ea, ea_errs = run_engine_exactness(
        torch, np, configs, Transformer, serve, serve_pkg, ops, model_refs,
        "cuda")
    ok_eb, eb_launches, eb_errs = run_engine_full_width(
        torch, np, configs, Transformer, serve, serve_pkg, ops, model_refs,
        counters, card, "cuda")
    ok_ec = run_serve_benchmark(torch)
    ok_ed = run_serve_example()
    print(f"phase 17 wall time {time.perf_counter() - t17:.1f} s",
          flush=True)

    # -- 18. the MoE archs and the chunked mixers -----------------------------
    t18 = time.perf_counter()
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    left_gb = torch.cuda.memory_allocated() / 1e9
    ok_mem = left_gb <= 1.0
    print(f"phase 18: memory_allocated after phase 17 {left_gb:.3f} GB "
          f"(limit 1.0: what the earlier phases still hold) "
          f"{'ok' if ok_mem else 'CHECK FAILED'}", flush=True)
    from repro_torch.models import moe as moe_mod
    ok_ma, ma_launches, ma_err = run_moe_serving(
        torch, np, configs, Transformer, serve, serve_pkg, ops, moe_mod,
        counters, model_refs, card)
    ok_md, md_launches, md_rec = run_training_full_width(
        torch, np, api, fl, ops, launch_train, configs, counters,
        dp_clip_noise, dp_clip_noise_ref, card, arch="phi3.5-moe-42b-a6.6b",
        steps=MOE_TRAIN_STEPS, seq=MOE_TRAIN_SEQ, phases=("18d",) * 4)
    ok_me, me_launches = run_chunked_wkv(torch, configs, Transformer,
                                         rwkv6_scan, card)
    print(f"phase 18 wall time {time.perf_counter() - t18:.1f} s",
          flush=True)

    # -- 19. the measurement toolchain and the last API names ----------------
    t19 = time.perf_counter()
    # 19b first: it waits for the background dry run, whose host work
    # would otherwise share the CPU with 19a's host-timed drivers
    ok_dr, dr_launches, dr_rec = run_dryrun_and_prefill(
        torch, configs, Transformer, counters, card, dry)
    ok_ta, ta_launches = run_throughput_smoke(torch, counters)
    ok_fd, fd_launches = run_federation(torch, np, api, linear, optim, spec,
                                        fed, dp_clip_noise)
    ok_le = run_launcher_env()
    print(f"phase 19 wall time {time.perf_counter() - t19:.1f} s",
          flush=True)

    # -- 20. the sharded engines' client axis ---------------------------------
    t20 = time.perf_counter()
    row_counters = {n: counters[n] for n in ROW_KERNELS}
    row_refs = {"dp_clip_noise": dp_clip_noise_ref,
                "quantize_decompress": quantize_decompress_ref,
                "cohort_gather_scatter": cohort_gather_scatter_ref}
    ok_sa, sa_launches, sa_err = run_sharded_world_of_one(
        torch, np, api, linear, pop_mod, ops, spec, fed, qs_spec, qs_pop,
        row_counters, row_refs, card)
    ok_sb, sb_launches, sb_err = run_sharded_two_ranks(
        torch, np, api, linear, spec, fed, row_counters, card)
    print(f"phase 20 wall time {time.perf_counter() - t20:.1f} s",
          flush=True)

    # -- 21. the model axis of mesh_2d (dm > 1) ------------------------------
    t21 = time.perf_counter()
    ok_xa, xa_launches, xa_errs, xa_shapes = run_model_axis_adult(
        torch, np, api, linear, spec, fed, card)
    # 21b and 21d-f share one world of two ranks (started once)
    from repro_torch.launch.mesh import HostWorld
    t_world = time.perf_counter()
    ma_world = HostWorld(2)
    ma_world.run(int, 0)
    print(f"phase 21b-f: 2 gloo ranks started in "
          f"{time.perf_counter() - t_world:.1f} s", flush=True)
    ok_xb, xb_launches, xb_rec = run_model_axis_tf(torch, np, fl, configs,
                                                   card, "21b", ma_world)
    # 21d-f: the RWKV6, Mamba2 + shared block and MoE families
    ok_xf, xf_launches, xf_recs = True, {}, {}
    for phase in ("21d", "21e", "21f"):
        t_cell = time.perf_counter()
        ok_cell, xf_launches[phase], xf_recs[phase] = run_model_axis_tf(
            torch, np, fl, configs, card, phase, ma_world)
        ok_xf &= ok_cell
        print(f"phase {phase} wall time {time.perf_counter() - t_cell:.1f} "
              f"s", flush=True)
    ma_world.close()
    # 21c at a rank's rows: 21a's (clients, columns of rank 0), then those
    # of 21b, 21d-f and 23d (phase 23's training cell) with rank 1's split
    # columns
    split_shapes = [shape for name, shape in (xa_shapes[0] if xa_shapes
                                              else [])
                    if name == "clip_noise_apply"][:1]
    split_shapes += [_ma_split_shape(configs, phase)
                     for phase in ("21b", "21d", "21e", "21f", "23d")]
    ok_xc, split_recs, xc_errs = check_split_kernels(torch, split_shapes,
                                                     card)
    print(f"phase 21 wall time {time.perf_counter() - t21:.1f} s",
          flush=True)

    # -- 22. the serving mesh ---------------------------------------------
    t22 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sm_world = HostWorld(2)
    sm_world.run(int, 0)
    print(f"phase 22: 2 gloo ranks started in "
          f"{time.perf_counter() - t22:.1f} s", flush=True)
    ok_ya, ya_launches, ya_recs, _ = run_serving_mesh(
        torch, np, configs, serve, card, sm_world)
    ok_ye = run_serving_mesh_f32(torch, np, configs, card, sm_world)
    ok_yf, yf_recs, yf_errs = check_rank_kernels(torch, card)
    print(f"phase 22 wall time {time.perf_counter() - t22:.1f} s",
          flush=True)

    # -- 23. KV heads the model axis does not divide; the long context ------
    # (phase 22's two ranks)
    t23 = time.perf_counter()
    ok_za, za_launches, za_recs, za_errs = run_serving_mesh(
        torch, np, configs, serve, card, sm_world, phases=("23a",))
    ok_zb, zb_rec = run_long_context(torch, np, configs, card, sm_world,
                                     "23b")
    ok_zc = run_serving_mesh_f32(torch, np, configs, card, sm_world,
                                 archs=("granite-20b",), phase="23c")
    ok_zl, zc_rec = run_long_context(torch, np, configs, card, sm_world,
                                     "23c")
    ok_zc &= ok_zl
    ok_zd, zd_launches, zd_rec = run_model_axis_tf(torch, np, fl, configs,
                                                   card, "23d", sm_world)
    sm_world.close()
    ok_ze, ze_recs, ze_errs = check_rank_kernels(torch, card, "23e",
                                                 MQ_FLASH, (), ())
    ya_launches.update(za_launches)
    for name, recs_ in ze_recs.items():
        yf_recs.setdefault(name, []).extend(recs_)
    for errs_ in (za_errs, ze_errs):
        for name, err in errs_.items():
            yf_errs[name] = max(yf_errs.get(name, 0.0), err)
    print(f"phase 23 wall time {time.perf_counter() - t23:.1f} s",
          flush=True)

    # -- 24. weights over the serving mesh's data axis; the cache split on
    # both its sequence and its heads (four ranks) ---------------------------
    t24 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fs_world = HostWorld(4)
    fs_world.run(int, 0)
    print(f"phase 24: 4 gloo ranks started in "
          f"{time.perf_counter() - t24:.1f} s", flush=True)
    ok_fa, fa_launches, fa_rec, fa_errs = run_fsdp_mesh(
        torch, np, configs, serve, card, fs_world)
    ok_fb, fb_rec = run_long_context(torch, np, configs, card, fs_world,
                                     "24b")
    ok_fc, fc_rec = run_fsdp_mesh_f32(torch, np, configs, card, fs_world)
    ok_fl, fl_rec = run_long_context(torch, np, configs, card, fs_world,
                                     "24c")
    ok_fc &= ok_fl
    fs_world.close()
    ok_fk, fk_recs, fk_errs = check_rank_kernels(torch, card, "24a",
                                                 FSDP_FLASH, (), ())
    for name, recs_ in fk_recs.items():
        yf_recs.setdefault(name, []).extend(recs_)
    for errs_ in (fa_errs, fk_errs):
        for name, err in errs_.items():
            yf_errs[name] = max(yf_errs.get(name, 0.0), err)
    print(f"phase 24 wall time {time.perf_counter() - t24:.1f} s",
          flush=True)

    # -- 25. shard_map in slab state (two ranks, one world) -------------------
    t25 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    sl_world = HostWorld(2)
    sl_world.run(int, 0)
    print(f"phase 25: 2 gloo ranks started in "
          f"{time.perf_counter() - t25:.1f} s", flush=True)
    ok_la, la_launches, la_errs = run_slab_adult(torch, np, spec, card,
                                                 sl_world)
    ok_lb, lb_launches, lb_err = run_slab_resident(torch, np, card,
                                                   sl_world)
    ok_lc, lc_launches, lc_rec, lc_err = run_slab_tf(torch, np, fl, configs,
                                                     card, sl_world)
    sl_world.close()
    print(f"phase 25 wall time {time.perf_counter() - t25:.1f} s",
          flush=True)

    model_kernels = []
    for name, replaces in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:68"),
            ("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:48"),
            ("mamba2_ssd", "src/repro/kernels/mamba2_ssd.py:67")):
        rec = mk_recs[name]
        model_kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": sv_launches[name],
            "max_abs_err": max(mk_worst[name], ea_errs.get(name, 0.0),
                               eb_errs.get(name, 0.0),
                               ma_err if name == "flash_attention" else 0.0),
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        if "variant" in rec:
            model_kernels[-1]["variant"] = rec["variant"]
    model_kernels[0]["launches_other_paths"] = {
        "phase 16e serving the trained smoke checkpoint":
            ls_launches["flash_attention"]}
    for rec in model_kernels:
        rec.setdefault("launches_other_paths", {})[
            "phase 17b the engine at full width"] = eb_launches[rec["name"]]
    model_kernels[0]["launches_other_paths"].update({
        "phase 18a static MoE serving (phi3.5-moe 16 layers, llama4 one "
        "period)": ma_launches["18a"],
        "phase 18b the engine with the MoE archs": ma_launches["18b"],
        "phase 18c the MoE archs' kernel route": ma_launches["18c"]})
    model_kernels[1]["launches_other_paths"][
        "phase 18e the serving route at rwkv_chunk 64"] = me_launches
    model_kernels[0]["launches_other_paths"][
        "phase 19b gemma3-4b prefill B 2 x 2048 (dry run's real path)"] = \
        dr_launches
    for rec in model_kernels:
        name = rec["name"]
        for phase, launched in ya_launches.items():
            if launched.get(name):
                arch = SM_CELLS[phase.split()[0]][0]
                rec["launches_other_paths"][
                    f"phase {phase} {arch} on the serving mesh (1, 2), both "
                    f"ranks, the last turn"] = launched[name]
        rec["at_rank_shapes"] = yf_recs.get(name, [])
        rec["max_abs_err"] = max(rec["max_abs_err"], yf_errs.get(name, 0.0))
    model_kernels[0]["launches_other_paths"][
        f"phase 24a {FSDP_ARCH} ({FSDP_LAYERS} layers) on the serving mesh "
        f"{FSDP_SHAPE} with its weights over \"data\", the four ranks"] = \
        fa_launches.get("flash_attention", 0)

    split_kernels = []
    for name in ("row_sumsq", "clip_noise_apply"):
        rec = split_recs.get(name, {})
        split_kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
            "replaces": "src/repro/kernels/dp_clip_noise.py:54",
            "launches": xa_launches[name],
            "max_abs_err": max(xa_errs.get(name, 0.0),
                               xc_errs.get(name, 0.0)),
            "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"), "library_ms": None,
            "shape": [rec.get("rows"), rec.get("n")],
            "at_other_shapes": rec.get("at", []),
            "launches_other_paths": {
                f"phase {phase} {MA_CELLS[phase][0]}'s widths on a (1, 2) "
                f"mesh, both ranks, the last turn": launched.get(name, 0)
                for phase, launched in (("21b", xb_launches),
                                        *xf_launches.items(),
                                        ("23d", zd_launches))}})

    print(json.dumps({"kernels": [{
        "name": "dp_clip_noise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
        "replaces": "src/repro/kernels/dp_clip_noise.py:54",
        "launches": launches,
        "max_abs_err": max(worst, ls_errs["dp_clip_noise"],
                           tw_rec["max_abs_err"], md_rec["max_abs_err"],
                           sa_err, sb_err, la_errs.get("dp_clip_noise", 0.0),
                           lc_err),
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": None, "variant": main_rec["variant"],
        "launches_other_paths": {
            "phase 13 fig2 runs": px_launches,
            "phase 14 attack check": at_launches,
            "phase 14 secure central": sc_launches,
            "phase 15a async identity (async + vmap)":
                aa_calls["dp_clip_noise"],
            "phase 15b async full width": ab_launches,
            "phase 15c async straggler (sync + async)": ac_launches,
            "phase 16a gemma3-4b training at full width":
                tw_launches["dp_clip_noise"],
            "phase 16d launcher smoke runs (cuda)":
                ls_launches["dp_clip_noise"],
            "phase 18d phi3.5-moe training at full width":
                md_launches["dp_clip_noise"],
            "phase 19a throughput_torch.py --smoke drivers":
                ta_launches["dp_clip_noise"],
            "phase 19c Federation.train": fd_launches,
            "phase 20a shard_map / mesh_2d, a world of one (NCCL)":
                sa_launches["dp_clip_noise"],
            "phase 20b shard_map and mesh_2d(1,1), two gloo ranks on the card "
            "(both ranks)":
                sb_launches["dp_clip_noise"],
            "phase 25a shard_map (2, 1) in slab state, (8, 210) blocks "
            "(both ranks)": la_launches["dp_clip_noise"],
            "phase 25c gemma3-4b's widths, shard_map (2, 1) in slab state, "
            "a rank's (1, N) row (both ranks, the last turn)":
                lc_launches["dp_clip_noise"]},
        "phase16_full_width": tw_rec, "phase18d_full_width": md_rec}, {
        "name": "quantize_decompress", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_decompress.cu",
        "replaces": "src/repro/kernels/quantize_decompress.py:44",
        "launches": q_launches,
        "max_abs_err": max(q_worst, ls_errs["quantize_decompress"],
                           la_errs.get("quantize_decompress", 0.0)),
        "ms": q_rec["ms"], "plain_ms": q_rec["plain_ms"],
        "bound_ms": q_rec["bound_ms"], "bound_by": q_rec["bound_by"],
        "library_ms": None, "variant": q_rec["variant"],
        "launches_other_paths": {
            "phase 15a async identity qsgd8_q50 (async + vmap)":
                aa_calls["quantize_decompress"],
            "phase 16d launcher qsgd_q50 (cuda)":
                ls_launches["quantize_decompress"],
            "phase 19a throughput_torch.py --smoke drivers":
                ta_launches["quantize_decompress"],
            "phase 20a shard_map / mesh_2d qsgd8_q50, a world of one":
                sa_launches["quantize_decompress"],
            "phase 20b shard_map qsgd8_q50, two ranks (both ranks)":
                sb_launches["quantize_decompress"],
            "phase 21a mesh_2d (1, 2) qsgd8_q50, on whole gathered rows "
            "(both ranks)": xa_launches["quantize_decompress"],
            "phase 25a shard_map (2, 1) qsgd8_q50 in slab state, (8, 210) "
            "blocks (both ranks)": la_launches["quantize_decompress"]}}, {
        "name": "cohort_gather_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cohort_gather_scatter.cu",
        "replaces": "src/repro/kernels/cohort_gather.py:64",
        "launches": g_launches,
        "max_abs_err": max(g_worst, ls_errs["cohort_gather_scatter"],
                           lb_err),
        "ms": g_rec["ms"], "plain_ms": g_rec["plain_ms"],
        "bound_ms": g_rec["bound_ms"], "bound_by": g_rec["bound_by"],
        "library_ms": g_rec["library_ms"],
        "launches_other_paths": {
            "phase 16d launcher population_resident (cuda)":
                ls_launches["cohort_gather_scatter"],
            "phase 19a throughput_torch.py --smoke drivers":
                ta_launches["cohort_gather_scatter"],
            "phase 20a the resident quickstart under shard_map":
                sa_launches["cohort_gather_scatter"],
            "phase 25b the resident quickstart under shard_map (2, 1) in "
            "slab state, the block's slots (both ranks)": lb_launches}}, {
        "name": "counter_rng", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/counter_rng.cu",
        "replaces": "none: no Pallas kernel; the port's counterpart of "
                    "jax.random's keyed draws (src/repro/mesh/engine.py:246, "
                    "src/repro/core/fl.py:87)",
        "launches": rng_launches,
        "max_abs_err": max(rng_rec["max_abs_err"],
                           la_errs.get("counter_rng", 0.0)),
        "ms": rng_rec["normal"]["ms"],
        "plain_ms": rng_rec["normal"]["plain_ms"],
        "bound_ms": rng_rec["normal"]["bound_ms"],
        "bound_by": rng_rec["normal"]["bound_by"], "library_ms": None,
        "torch_randn_ms": rng_rec["normal"]["torch_ms"],
        "shape": rng_rec["normal"]["shape"],
        "uniform": rng_rec["uniform"], "slab_21b": rng_rec["slab_21b"],
        "whole_21b": rng_rec["whole_21b"],
        "launches_other_paths": {
            "phase 21b gemma3-4b's widths in slab state on the (1, 2) mesh, "
            "both ranks, the last turn": xb_launches.get("counter_rng", 0),
            **{f"phase {phase} {MA_CELLS[phase][0]}'s widths in slab state "
               f"on the (1, 2) mesh, both ranks, the last turn":
               launched.get("counter_rng", 0)
               for phase, launched in (*xf_launches.items(),
                                       ("23d", zd_launches))},
            "phase 25a shard_map (2, 1) in slab state, the block's rows "
            "(both ranks)": la_launches["counter_rng"],
            "phase 25c gemma3-4b's widths, shard_map (2, 1) in slab state "
            "(both ranks, the last turn)": lc_launches["counter_rng"]}}]
        + model_kernels + split_kernels,
        "phase21b_gemma3_model_axis": xb_rec,
        "phase21def_model_axis": xf_recs, "phase22_serving_mesh": ya_recs,
        "phase23": {"23a": za_recs.get("23a"), "23b": zb_rec, "23c": zc_rec,
                    "23d": zd_rec},
        "phase24": {"24a": fa_rec, "24b": fb_rec,
                    "24c": {FSDP_ARCH: fc_rec, "gemma3-4b": fl_rec}},
        "phase25c_gemma3_slab_state": lc_rec}),
        flush=True)
    for ok, what in ((ok_build, "a tensor-core flash or counter_rng "
                                "instance spills"),
                     (ok_k, "a kernel disagrees with its plain version"),
                     (ok_q, "quantize_decompress is not bit-identical to "
                            "its plain version"),
                     (ok_m, "the main path's checks failed"),
                     (ok_rng, "counter_rng disagrees with its plain version "
                              "or a slab draw with the whole draw"),
                     (ok_b, "the kernel round disagrees with the plain "
                            "round"),
                     (ok_s, "the steady rounds gave non-finite params"),
                     (ok_c, "the comm sweep's checks failed"),
                     (ok_r, "the pipeline's kernel route disagrees with its "
                            "plain route"),
                     (ok_g, "cohort_gather_scatter is not bit-identical to "
                            "its plain version"),
                     (ok_p8, "the M == C population's checks failed"),
                     (ok_p9, "the quickstart resident step's checks "
                             "failed"),
                     (ok_mk, "a model kernel disagrees with its plain "
                             "version"),
                     (ok_sv, "the full-width serving checks failed"),
                     (ok_rt, "the model's kernel route disagrees with its "
                             "plain route"),
                     (ok_px, "the paper's experiments' checks failed"),
                     (ok_tk, "a trust-plane reduction disagrees between "
                             "the card and the CPU"),
                     (ok_at, "attack_resilience_torch --check failed"),
                     (ok_sc, "the secure central-accounting run's checks "
                             "failed"),
                     (ok_tr, "the trust-plane rounds gave non-finite "
                             "params"),
                     (ok_aa, "the async identity gate on the card failed"),
                     (ok_ab, "the full-width async run's checks failed"),
                     (ok_ac, "the async straggler comparison failed"),
                     (ok_tw, "the full-width training run's checks failed"),
                     (ok_ls, "the launcher's smoke runs or the serving of "
                             "their checkpoint failed"),
                     (ok_ea, "the engine's f32 exactness checks failed"),
                     (ok_eb, "the full-width engine's checks failed"),
                     (ok_ec, "benchmarks/serve_torch.py --check failed"),
                     (ok_ed, "examples/serve_continuous_torch.py failed"),
                     (all(eb_launches[n] > 0 for n in (
                         "flash_attention", "rwkv6_scan", "mamba2_ssd")),
                      "a model kernel was not launched by the engine"),
                     (ok_mem, "the earlier phases left memory allocated"),
                     (ok_ma, "the MoE serving checks failed"),
                     (ok_md, "the MoE training run's checks failed"),
                     (ok_me, "the chunked WKV6 checks failed"),
                     (ok_ta, "benchmarks/throughput_torch.py --smoke "
                             "--check failed on cuda"),
                     (ok_dr, "the dry run or gemma3-4b's real prefill "
                             "failed"),
                     (ok_fd, "Federation.train or its resume failed"),
                     (ok_le, "the launcher's env profile or replica hint "
                             "checks failed"),
                     (ok_sa, "the sharded engines in a world of one "
                             "differ from vmap"),
                     (ok_sb, "the sharded engine on two ranks disagrees "
                             "with vmap"),
                     (ok_xa, "mesh_2d (1, 2) on two ranks disagrees with "
                             "vmap (Adult-1)"),
                     (ok_xb, "gemma3-4b on the (1, 2) mesh disagrees with "
                             "vmap or missed a check"),
                     (ok_xc, "a split clip kernel disagrees with its plain "
                             "version"),
                     (ok_xf, "rwkv6, zamba2 or phi3.5-moe on the (1, 2) mesh "
                             "disagrees with vmap or missed a check"),
                     (all(xa_launches[n] > 0 for n in ("row_sumsq",
                                                       "clip_noise_apply")),
                      "a split clip kernel was not launched on the model "
                      "axis' path"),
                     (ok_ya, "a model on the serving mesh disagrees with "
                             "the whole route or missed a check"),
                     (ok_ye, "the f32 serving mesh is off the whole route "
                             "by more than 1e-4 of the largest logit"),
                     (ok_yf, "a model kernel disagrees with its plain "
                             "version at a rank's shapes"),
                     (sum(v.get("flash_attention", 0)
                          for v in ya_launches.values()) > 0
                      and ya_launches.get("22b", {}).get("rwkv6_scan", 0) > 0
                      and ya_launches.get("22c", {}).get("mamba2_ssd", 0) > 0,
                      "a model kernel was not launched on the serving "
                      "mesh"),
                     (ok_za, "granite-20b (MQA) on the serving mesh "
                             "disagrees with the whole route or missed a "
                             "check"),
                     (za_launches.get("23a", {}).get("flash_attention", 0)
                      == 2 * SM_CELLS["23a"][1],
                      "flash_attention was not launched once a layer on "
                      "each rank of 23a's prefill"),
                     (ok_zb, "gemma3-4b at long_500k on the sequence-split "
                             "cache disagrees with the whole route or "
                             "missed a check"),
                     (ok_zc, "an f32 model on a sequence-split cache is off "
                             "the whole route by more than 1e-4 of the "
                             "largest logit"),
                     (ok_zd, "granite-20b's widths on the (1, 2) training "
                             "mesh disagree with vmap or missed a check"),
                     (ok_ze, "flash_attention disagrees with its plain "
                             "version at granite-20b's rank shape"),
                     (ok_fa, "mistral-large with its weights over \"data\" "
                             "disagrees with the whole route or missed a "
                             "check"),
                     (fa_launches.get("flash_attention", 0)
                      == 4 * FSDP_LAYERS,
                      "flash_attention was not launched once a layer on "
                      "each rank of 24a's generate"),
                     (ok_fb, "gemma3-4b at long_500k on the cache split on "
                             "its sequence and its heads disagrees with the "
                             "whole route or missed a check"),
                     (ok_fc, "an f32 model on the (2, 2) mesh (weights over "
                             "\"data\", or the two-way cache split) is off "
                             "the whole route by more than 1e-4 of the "
                             "largest logit"),
                     (ok_fk, "flash_attention disagrees with its plain "
                             "version at mistral-large's rank shape"),
                     (ok_la, "Adult-1 as shard_map in slab state disagrees "
                             "with the whole layout or missed a check"),
                     (ok_lb, "the resident quickstart as shard_map in slab "
                             "state disagrees with the whole layout or "
                             "missed a check"),
                     (ok_lc, "gemma3-4b's widths as shard_map in slab state "
                             "disagree with the whole layout or missed a "
                             "check"),
                     (all(la_launches[n] > 0 for n in SLAB_KERNELS)
                      and lb_launches > 0,
                      "a kernel was not launched on shard_map's slab "
                      "path")):
        if not ok:
            return _fail(what)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
