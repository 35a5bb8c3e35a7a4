"""Population quickstart on the PyTorch port: DP-PASGD over 100,000
virtual IoT devices.

Cross-device FL at IoT scale runs a small per-round *cohort* K drawn from a
huge *population* M >> K (the paper's resource-constrained fleet, scaled to
its intended setting). This script walks the whole
``repro_torch.population`` surface, as ``examples/population_quickstart.py``
does for the JAX package:

  1. synthesize a Dirichlet label-skew population of M = 100,000 virtual
     clients — lazy: a client's data exists only while it is in a cohort,
  2. declare the federation: ``FederationSpec(population=M, cohort_size=K)``
     with ``n_clients = K`` (the device block IS the cohort; device memory
     is bounded by K, independent of M),
  3. train with the fused chunked driver (cohorts resample at chunk
     boundaries) under a per-virtual-client privacy ledger held in the
     host-side ClientStore,
  4. compare uniform cohorts with the Beta-availability / dropout
     heterogeneity model, and checkpoint/resume the population state,
  5. go device-resident: ``train_population(..., resident_cache=S)``
     keeps S warm clients' sticky state on device and draws a FRESH
     cohort every round inside the fused scan — the per-round driver's
     exact schedule with zero steady-state host syncs. On the GPU the
     cohort rows move through the hand-written ``cohort_gather_scatter``
     CUDA kernel.

Run:  PYTHONPATH=src python examples/population_quickstart_torch.py
      PYTHONPATH=src python examples/population_quickstart_torch.py \
          --resident-cache 512 --device cpu
"""
import argparse
import tempfile

import numpy as np

from repro_torch.api import FederationSpec
from repro_torch.models.linear import init_linear, logreg_loss
from repro_torch.optim import sgd
from repro_torch.population import (
    HeterogeneousCohort,
    device_block_bytes,
    init_population_state,
    load_population_state,
    save_population_state,
    synthetic_population,
    train_population,
)

M, K = 100_000, 16            # population / per-round cohort
DIM, BATCH, TAU = 20, 8, 5
SIGMA, ROUNDS = 0.8, 24

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--resident-cache", type=int, default=256, metavar="S",
                help="warm-client slots for step 5's device-resident run "
                     "(must cover a chunk's cohort union, chunk_rounds*K; "
                     "default 256)")
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu without a GPU)")
args = ap.parse_args()


def fresh_state():
    return init_population_state(
        spec, init_linear(DIM, device=args.device), device=args.device)



print(f"== 1. population: M={M:,} virtual clients, Dirichlet(0.3) skew ==")
pop = synthetic_population(M, dim=DIM, batch_size=BATCH, alpha=0.3, seed=0)
print(f"   lazy: client #71,231's shard is synthesized on demand -> "
      f"{pop.sampler(71_231, 1, np.random.default_rng(0))['x'].shape}")

print(f"== 2. spec: cohort_size=K={K} is the whole device block ==")
spec = FederationSpec(
    n_clients=K, tau=TAU, loss_fn=logreg_loss, optimizer=sgd(0.3),
    clip_norm=1.0, dp=True, population=M, cohort_size=K,
    compressor="topk", compression_ratio=0.25,     # IoT uplink budget
    sigmas=(SIGMA,) * K, batch_sizes=(BATCH,) * K, eps_th=1e9, c_th=1e9)
pstate = fresh_state()
print(f"   cohort fraction K/M = {spec.cohort_fraction():.2e}; device block "
      f"= {device_block_bytes(pstate):,} bytes regardless of M")

print("== 3. train: fused chunks, cohorts resampled per chunk ==")
pstate, out = train_population(spec, pstate, pop, max_rounds=ROUNDS,
                               chunk_rounds=8)
seen = int((pstate.store.rounds_participated > 0).sum())
print(f"   rounds={out['rounds']}  loss {out['history'][0]['loss']:.4f} -> "
      f"{out['history'][-1]['loss']:.4f}")
print(f"   ledger: {seen}/{M:,} clients ever sampled; worst-client "
      f"eps={out['max_epsilon']:.3f} (conditional per-realized-client "
      f"ledger); residual rows held: {pstate.store.residual_rows()}")

print("== 4. heterogeneity: Beta-availability fleet with 10% dropout ==")
hetero = HeterogeneousCohort(seed=1, availability=(8.0, 2.0), dropout=0.1)
hstate = fresh_state()
hstate, hout = train_population(spec, hstate, pop, cohort_sampler=hetero,
                                max_rounds=ROUNDS, chunk_rounds=8)
part = hstate.store.rounds_participated
print(f"   final loss {hout['history'][-1]['loss']:.4f}; busiest device ran "
      f"{int(part.max())} rounds (availability skew the per-vid ledger "
      f"tracks exactly)")

print("== 5. checkpoint / resume the population state ==")
with tempfile.TemporaryDirectory() as d:
    save_population_state(d, pstate, extra={"note": "quickstart"})
    resumed, extra = load_population_state(d, fresh_state())
    if (resumed.fl.rounds_done != out["rounds"]
            or not np.array_equal(resumed.store.rho, pstate.store.rho)):
        raise SystemExit("the restored population state differs")
    print(f"   restored round {resumed.fl.rounds_done} with "
          f"{resumed.store.residual_rows()} sparse residual rows "
          f"({extra['note']})")

print(f"== 6. device-resident: --resident-cache S={args.resident_cache} ==")
# a stationary population (sampler ignores its rng: each client re-reads a
# fixed local shard, the IoT regime) lets the cache hold DATA rows too —
# steady-state chunks then build no per-round host batches at all. The
# cohort now resamples EVERY round inside the fused scan (the per-round
# driver's exact schedule), not once per chunk; sticky state (error
# residual, per-vid rho) round-trips the host only on eviction/flush.
pop_res = synthetic_population(M, dim=DIM, batch_size=BATCH, alpha=0.3,
                               seed=0, stationary=True)
rstate = fresh_state()
rstate, rout = train_population(spec, rstate, pop_res, max_rounds=ROUNDS,
                                chunk_rounds=8,
                                resident_cache=args.resident_cache)
stats = rout["resident_cache"]
print(f"   loss {rout['history'][0]['loss']:.4f} -> "
      f"{rout['history'][-1]['loss']:.4f} over {rout['rounds']} rounds, "
      f"fresh cohort each round, zero steady-state host syncs")
print(f"   cache: {stats['hits']} hits / {stats['misses']} misses / "
      f"{stats['evictions']} evictions across {stats['flushes']} flush(es) "
      f"(S={args.resident_cache} warm of M={M:,})")
