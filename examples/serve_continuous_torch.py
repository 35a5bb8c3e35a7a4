"""Continuous-batching walkthrough on the PyTorch port: federate a model,
checkpoint it, serve it under an open-loop Poisson load on the slot
engine, then hot-swap a fresh federated checkpoint mid-stream without
dropping the requests that are already decoding (the four acts of
``examples/serve_continuous.py`` on ``repro_torch``).

Four acts, all through public entry points:

  1. federate   - two DP-PASGD rounds on a tiny gemma3 via
                  ``repro_torch.api`` produce checkpoint A; two more rounds
                  produce B
  2. serve      - ``SlotEngine`` + ``serve_continuous`` drain a Poisson
                  workload against checkpoint A; the report carries
                  tokens/s, p50/p99 latency, queue depth, occupancy
  3. hot-swap   - the same workload replayed with ``swap_at`` set mid-
                  stream: the engine rebinds from A's params to B's at a
                  decode-step boundary, in-flight requests finish on B
  4. exactness  - every served request's tokens are the static
                  ``generate`` path's on whichever params were live,
                  wherever the reference's top-two logit gap exceeds
                  rounding (``launch.serve.agree_under_gap``)

Run:  PYTHONPATH=src python examples/serve_continuous_torch.py [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import (FederationSpec, init_state, materialize_record,
                             run_round, save_state)
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.data.tokens import FederatedTokenStream, TokenTaskConfig
from repro_torch.launch.serve import (agree_under_gap, generate,
                                      load_federated_params)
from repro_torch.launch.train import federation_meta
from repro_torch.models.transformer import Transformer
from repro_torch.optim import sgd
from repro_torch.serve import (SlotEngine, StepClock, poisson_workload,
                               serve_continuous)
from repro_torch.utils.tree import tree_map

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu without a GPU)")
args = ap.parse_args()
device = torch.device(args.device)
GAP_TOL = 1e-4   # f32 logits of two batch shapes differ by ~1e-6

# ---- 1. federate: two checkpoints, two rounds apart ------------------------
C, TAU, BATCH, SEQ = 4, 2, 2, 16
cfg = smoke_variant(get_arch("gemma3-4b"))
model = Transformer(cfg)
spec = FederationSpec(
    n_clients=C, tau=TAU, loss_fn=model.loss_fn, optimizer=sgd(0.05),
    dp=True, clip_norm=5.0, sigmas=(0.01,) * C, batch_sizes=(BATCH,) * C)
stream = FederatedTokenStream(TokenTaskConfig(vocab=cfg.vocab, seq_len=SEQ,
                                              n_clients=C, seed=0),
                              BATCH)
params0 = model.init(torch.Generator(device=device).manual_seed(0), device)
state = init_state(spec, params0, device=device)
rng = np.random.default_rng(0)


def rounds(state, n):
    for _ in range(n):
        per_client = [stream.sampler(m, TAU, rng) for m in range(C)]
        batch = tree_map(lambda *xs: np.stack(xs), *per_client)
        state, rec = run_round(spec, state, batch, check_budgets=False)
    return state, materialize_record(rec)["loss"]


with tempfile.TemporaryDirectory() as ckpt_a, \
        tempfile.TemporaryDirectory() as ckpt_b:
    state, loss_a = rounds(state, 2)
    save_state(ckpt_a, state, extra=federation_meta(spec))
    state, loss_b = rounds(state, 2)
    save_state(ckpt_b, state, extra=federation_meta(spec))
    params_a = load_federated_params(model, ckpt_a, device)
    params_b = load_federated_params(model, ckpt_b, device)
print(f"federated: checkpoint A after 2 rounds (loss={loss_a:.3f}), "
      f"B after 4 (loss={loss_b:.3f}) on {device}")

# ---- 2. serve checkpoint A under Poisson load ------------------------------
workload = poisson_workload(8, rate=2.0, vocab=cfg.vocab, seed=3,
                            prompt_lens=(8, 16), gen_lens=(6, 10))
engine = SlotEngine(model, params_a, n_slots=3, max_len=32, block_size=8,
                    device=device)
engine.warmup(buckets=[r.prompt_len for r in workload])
report = serve_continuous(engine, workload, clock=StepClock())
s = report.summary()
print(f"served {s['requests']} requests / {s['tokens_out']} tokens on "
      f"{engine.n_slots} slots: p50={s['p50_latency_s']}s "
      f"p99={s['p99_latency_s']}s queue<= {s['max_queue_depth']} "
      f"occupancy={s['occupancy_mean']}")

# ---- 3. replay with a mid-stream hot-swap to checkpoint B ------------------
workload2 = poisson_workload(8, rate=2.0, vocab=cfg.vocab, seed=3,
                             prompt_lens=(8, 16), gen_lens=(6, 10))
engine2 = SlotEngine(model, params_a, n_slots=3, max_len=32, block_size=8,
                     device=device)
engine2.warmup(buckets=[r.prompt_len for r in workload2])
swap_at = workload2[3].arrival  # boundary lands mid-decode for early reqs
report2 = serve_continuous(engine2, workload2, clock=StepClock(),
                           swap_at=swap_at, swap_params=params_b)
assert engine2.stats()["swaps"] == 1
assert all(r.finished for r in report2.requests)
print(f"hot-swapped A->B at t={swap_at:.2f}s; all {len(report2.requests)} "
      f"in-flight and later requests completed")

# ---- 4. exactness: engine tokens == static generate on the live params ----
diverged, full = 0, 0
for r, r2 in zip(report.requests, report2.requests):
    prompt = torch.as_tensor(r.tokens[None].astype(np.int64), device=device)
    ref_a, logits_a = generate(model, params_a, prompt, r.max_gen,
                               with_logits=True)
    agree, n = agree_under_gap(r.out, ref_a[0], logits_a[0], GAP_TOL)
    assert agree, f"rid={r.rid} diverged from generate(A)"
    full += n == r.max_gen
    if r2.emit_times[0] >= swap_at and r2.arrival >= swap_at:
        ref_b, logits_b = generate(model, params_b, prompt, r.max_gen,
                                   with_logits=True)
        assert agree_under_gap(r2.out, ref_b[0], logits_b[0], GAP_TOL)[0]
    diverged += r.out != r2.out
print(f"tokens equal generate() per live checkpoint ({full}/"
      f"{len(report.requests)} compared in full); {diverged}/"
      f"{len(report.requests)} requests changed tokens across the swap "
      f"boundary")
