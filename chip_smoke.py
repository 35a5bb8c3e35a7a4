#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-row-kernels SRC   (see time_row_kernels)

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
  3. the main path at full width: DP-PASGD on adult_like() split by
     education (16 clients, d = 104) through repro_torch.api on cuda,
     engine "vmap", trained until a budget binds; dp_clip_noise's calls in
     that run must be tau x rounds;
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
     each segment; bf16 at full depth, each route held against the f32
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
     async strictly ahead of sync in simulated seconds.
Phase 2 also holds cohort_gather_scatter bitwise against its plain version
at the resident driver's shapes. The last two lines are the kernels' JSON
record and {"ok": true, "device": {...}}. Needs a CUDA GPU and the
repository's src/.
"""
from __future__ import annotations

import json
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


def _ptxas_instances(log: str) -> list[tuple[str, int, int, int]]:
    """(kernel instance, registers, spill store bytes, spill load bytes)
    for every entry function in an ``nvcc -Xptxas -v`` log; the flash
    instances named ``flash_tc<hd>`` / ``flash_fwd<type, columns>``, the
    SSD's ``ssd_tc<Q, P boxes, N boxes>`` / ``ssd_fwd<type>``, the WKV's
    ``wkv_chunk_state<hd>`` / ``wkv_state_pass`` / ``wkv_chunk_out<hd>``
    (its tensor-core instance), ``wkv6_fwd<type, columns>`` and the row
    kernels' ``row_cta`` / ``row_cluster`` / ``stream_partials`` /
    ``stream_apply<clip_noise | quantize>`` (", no z": clip only)."""
    out, name, spills = [], None, (0, 0)
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
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name is not None:
            out.append((name, int(regs.group(1)), *spills))
            name, spills = None, (0, 0)
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


def _profile_call(torch, fn, label):
    """``fn()`` under torch.profiler; prints its wall time, the device's
    busy share, its kernel launches, the top device kernels and the top
    host ops. ``fn`` always runs; only the profiler's start, stop and report
    are optional. Returns (fn's result, the launches or None)."""
    from torch.profiler import ProfilerActivity, profile
    prof = None
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:        # noqa: BLE001 — the profiler is optional
        print(f"{label}: profile unavailable ({e!r})", flush=True)
        prof = None
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if prof is None:
        return out, None
    try:
        prof.stop()
        averages = prof.key_averages()
    except Exception as e:        # noqa: BLE001 — the profiler is optional
        print(f"{label}: profile unavailable ({e!r})", flush=True)
        return out, None
    events = [e for e in averages
              if e.device_type.name == "CUDA" and e.device_time_total > 0]
    device_ms = sum(e.device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"{label}: wall {wall_ms:.3f} ms (profiled), device busy "
          f"{device_ms:.3f} ms ({device_ms / wall_ms:.1%}), {launches} "
          f"kernel launches", flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        print(f"  {e.device_time_total / 1e3:9.4f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    host = [e for e in averages if e.device_type.name == "CPU"]
    print(f"{label}: host ops by self CPU time", flush=True)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"  {e.self_cpu_time_total / 1e3:9.4f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
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
    if kernels is not None and kernels < round(kernels):
        # every call runs a whole number of kernels, and a kernel record the
        # trace dropped can only lower the count: take the trace once more.
        # A count above a whole number is kept, and fails its check
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
    device time), and print the card and one JSON line. Run two trees in
    turns in one chip call to compare them; nothing is checked here."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(src).resolve()))
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


def run_main_path(torch, np, api, linear, data, conv, design, optim,
                  dp_clip_noise):
    """Phase 3: the quickstart flow at full width, until a budget binds."""
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
    xt, yt = fed.eval_arrays("test")
    eval_fn = linear.make_eval_fn(linear.logreg_loss, xt, yt)
    state = api.init_state(spec, linear.init_linear(dim, device="cuda"),
                           device="cuda")
    init_eval = eval_fn(api.eval_params(spec, state))
    planned, _ = api.rounds_within_budgets(spec, state, 10_000)
    torch.cuda.synchronize()
    dp_clip_noise.launches = 0
    t0 = time.perf_counter()
    state, out = api.train(spec, state, fed.make_sampler(BATCH),
                           eval_fn=eval_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dp_clip_noise.launches
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
          f"call a local step)",
          flush=True)
    ok = (rounds > 0 and rounds == planned and finite and binds is not None
          and out["max_epsilon"] <= EPS_TH + 1e-6
          and out["resource_spent"] <= C_TH
          and best.get("eval_loss", float("inf")) < init_eval["eval_loss"]
          and launches == sol.tau * rounds)
    return ok, launches, spec, fed


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
    against 24 per-round calls. Returns (ok, launches). Launch formula: 4
    per round (residual gather and scatter, the x and y shard gathers), 1
    per chunk (the residual view), the promotions (per chunk the cold
    residual rows and the 2 data leaves: 3, 3, and 4 in chunk 3, which
    also gathers its 126 evicted rows), and 1 for the final flush."""
    spec = _quickstart_spec(api, linear, optim)
    pop = pop_mod.synthetic_population(QS_M, dim=QS_DIM,
                                       batch_size=QS_BATCH, alpha=0.3,
                                       seed=0, stationary=True)
    want = 4 * QS_ROUNDS + 3 + (3 + 3 + 4) + 1
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

    bf16 at full depth. The two routes round to bf16 at different places
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
            cfg = dataclasses.replace(configs.get_arch(arch), dtype=dtype)
            cut = " at full depth"
            if dtype == "float32":
                segs = tuple(configs.Segment(1, s.pattern)
                             for s in cfg.segments)
                cfg = dataclasses.replace(
                    cfg, segments=segs,
                    n_layers=sum(len(s.pattern) for s in segs))
                cut = (f" (depth cut to one step of each segment: "
                       f"{sum(len(s.pattern) for s in segs)} layers)")
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


def main() -> int:
    if sys.argv[1:2] == ["--time-row-kernels"] and len(sys.argv) == 3:
        return time_row_kernels(sys.argv[2])
    if len(sys.argv) > 1:
        print(f"usage: {sys.argv[0]} [--time-row-kernels SRC]",
              file=sys.stderr)
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
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.launch import serve
    from repro_torch.models import linear
    from repro_torch.models.transformer import Transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
        for inst, regs, st, ld in _ptxas_instances(log):
            print(f"  {name} {inst}: {regs} registers, {st} bytes spill "
                  f"stores, {ld} bytes spill loads", flush=True)
            if inst.startswith("flash_tc") and st + ld:
                ok_build = False

    # -- 2. kernels against their plain versions --------------------------
    ok_k, main_rec, worst = check_kernels(torch, dp_clip_noise,
                                          dp_clip_noise_ref)
    ok_q, q_rec, q_worst = check_qsgd_kernel(torch, quantize_decompress,
                                             quantize_decompress_ref)
    ok_g, g_rec, g_worst = check_cohort_kernel(
        torch, cohort_gather_scatter, cohort_gather_scatter_ref,
        vector_width)

    # -- 3. main path ---------------------------------------------------------
    ok_m, launches, spec, fed = run_main_path(
        torch, np, api, linear, data, conv, design, optim, dp_clip_noise)

    # -- 4. kernel round against plain round ----------------------------------
    ok_b = compare_backends(torch, np, api, linear, spec, fed)

    # -- 5. steady rounds, and where their device time goes ----------------
    ok_s = profile_rounds(torch, np, api, linear, spec, fed, "phase 5")

    # -- 6. the aggregation pipeline: the comm sweep at full width ----------
    ok_c, q_launches, fed2 = run_comm_sweep(
        torch, np, api, linear, data, optim, fl, dp_clip_noise,
        quantize_decompress)
    ok_c &= profile_rounds(torch, np, api, linear, _sweep_spec(
        api, linear, optim, fl, fed2, 0.5, "qsgd", 0.25), fed2,
        "phase 6 qsgd8_q50")

    # -- 7. the pipeline's kernel route against its plain route -------------
    ok_r = compare_qsgd_routes(torch, np, api, linear, optim, fl, fed2)

    # -- 8. the population plane, M == C, against the dense path ------------
    ok_p8 = run_population_m_equals_c(torch, api, linear, optim, fl, pop_mod,
                                      fed2, cohort_gather_scatter)

    # -- 9. the population quickstart's resident step -------------------------
    ok_p9, g_launches, qs_spec, qs_pop = run_quickstart_resident(
        torch, np, api, linear, optim, pop_mod, cohort_gather_scatter)
    time_population_drivers(torch, linear, pop_mod, qs_spec, qs_pop)
    ok_p9 &= profile_resident_chunk(torch, np, linear, pop_mod, qs_spec,
                                    qs_pop)

    # -- 10. the model kernels against their plain versions -----------------
    ok_mk, mk_recs, mk_worst = check_model_kernels(
        torch, (flash_attention, rwkv6_scan, mamba2_ssd),
        (flash_attention_ref, rwkv6_scan_ref, mamba2_ssd_ref))

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

    # -- 13. the paper's experiments at full width ---------------------------
    ok_px, px_launches = run_paper_experiments(torch, dp_clip_noise, card)

    # -- 14. the trust plane ---------------------------------------------------
    ok_tk = check_trust_kernels(torch, np)
    ok_at, at_launches = run_attack_check(torch, dp_clip_noise)
    ok_sc, sc_launches = run_secure_central(torch, np, api, linear, spec,
                                            fed, dp_clip_noise)
    ok_tr = time_trust_rounds(torch, np, api, linear, spec, fed, card)

    # -- 15. the buffered-async plane -----------------------------------------
    ok_aa, aa_calls = run_async_identity(
        torch, np, api, asyncfl, spec, fed,
        {"dp_clip_noise": dp_clip_noise,
         "quantize_decompress": quantize_decompress})
    ok_ab, ab_launches = run_async_full_width(
        torch, np, asyncfl, spec, fed, dp_clip_noise, card)
    ok_ac, ac_launches = run_async_straggler(torch, np, api, asyncfl,
                                             dp_clip_noise)

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
            "max_abs_err": mk_worst[name], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
        if "variant" in rec:
            model_kernels[-1]["variant"] = rec["variant"]

    print(json.dumps({"kernels": [{
        "name": "dp_clip_noise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dp_clip_noise.cu",
        "replaces": "src/repro/kernels/dp_clip_noise.py:54",
        "launches": launches, "max_abs_err": worst,
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
            "phase 15c async straggler (sync + async)": ac_launches}}, {
        "name": "quantize_decompress", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize_decompress.cu",
        "replaces": "src/repro/kernels/quantize_decompress.py:44",
        "launches": q_launches, "max_abs_err": q_worst,
        "ms": q_rec["ms"], "plain_ms": q_rec["plain_ms"],
        "bound_ms": q_rec["bound_ms"], "bound_by": q_rec["bound_by"],
        "library_ms": None, "variant": q_rec["variant"],
        "launches_other_paths": {
            "phase 15a async identity qsgd8_q50 (async + vmap)":
                aa_calls["quantize_decompress"]}}, {
        "name": "cohort_gather_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cohort_gather_scatter.cu",
        "replaces": "src/repro/kernels/cohort_gather.py:64",
        "launches": g_launches, "max_abs_err": g_worst,
        "ms": g_rec["ms"], "plain_ms": g_rec["plain_ms"],
        "bound_ms": g_rec["bound_ms"], "bound_by": g_rec["bound_by"],
        "library_ms": g_rec["library_ms"]}] + model_kernels}), flush=True)
    for ok, what in ((ok_build, "a tensor-core flash instance spills"),
                     (ok_k, "a kernel disagrees with its plain version"),
                     (ok_q, "quantize_decompress is not bit-identical to "
                            "its plain version"),
                     (ok_m, "the main path's checks failed"),
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
                     (ok_ac, "the async straggler comparison failed")):
        if not ok:
            return _fail(what)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
