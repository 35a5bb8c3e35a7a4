"""Buffered-async quickstart on the PyTorch port: beating the sync barrier
on a straggler fleet.

Real IoT fleets are heterogeneous: the devices most likely to drop rounds
are also the slowest to compute and upload. A synchronous round waits for
the slowest of all K clients every round; FedBuff-style buffered
asynchrony (``repro_torch.asyncfl``) waits only for the B earliest
arrivals, folds them into the global model staleness-weighted, and
immediately redispatches, so the virtual clock advances at the pace of the
fast devices while the stragglers' (pre-charged) uploads land in later
buffers. The same walk as ``examples/async_quickstart.py``:

  1. build a correlated straggler fleet: ``HeteroLatency`` draws per-device
     compute+upload times from the SAME Beta-availability rates as the
     ``HeterogeneousCohort`` sampler (flaky == slow),
  2. train the same federation twice (sync barrier vs async B-of-K) and
     compare **simulated seconds to the same amount of landed zCDP**
     (equal client updates processed; only the clock differs),
  3. inspect the dispatch-split privacy ledger: the budget probes read
     landed + in-flight rho, so a straggler can never outrun them.

Every dispatch's local steps clip and noise the whole block of clients in
one call of the hand-written ``dp_clip_noise`` CUDA kernel on the GPU (its
plain version on the CPU).

Run:  PYTHONPATH=src python examples/async_quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import FederationSpec, init_state, round_batch, run_round
from repro_torch.asyncfl import (
    HeteroLatency,
    dispatched_epsilon,
    dispatched_rho,
    init_async_state,
    sync_round_duration,
    train_async,
)
from repro_torch.models.linear import init_linear, logreg_loss
from repro_torch.optim import sgd

K, B, TAU, DIM, BATCH = 8, 2, 2, 32, 8
SYNC_ROUNDS = 12                      # async runs the same update count
FLUSHES = SYNC_ROUNDS * K // B

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu without a GPU)")
args = ap.parse_args()


def sampler(m, tau, rng):
    r = np.random.default_rng((13, int(m)))   # fixed per-client shard
    return {"x": r.normal(size=(tau, BATCH, DIM)).astype(np.float32),
            "y": r.integers(0, 2, size=(tau, BATCH)).astype(np.int32)}


def make_spec(**kw):
    return FederationSpec(
        n_clients=K, tau=TAU, loss_fn=logreg_loss, optimizer=sgd(0.3),
        clip_norm=1.0, dp=True, sigmas=(0.5,) * K, batch_sizes=(BATCH,) * K,
        eps_th=1e9, c_th=1e9, **kw)


# -- 1. the fleet: availability-correlated straggler clocks -----------------
lat = HeteroLatency(0, fleet=K, slow_factor=6.0)
rates = lat.rates()
means = lat.mean_latency(np.arange(K))
print("fleet (availability rate -> mean compute seconds):")
for v in np.argsort(rates):
    bar = "#" * int(means[v] * 6)
    print(f"  device {v}: rate={rates[v]:.2f}  mean={means[v]:5.2f}s {bar}")

# -- 2a. sync barrier: every round waits for the slowest device -------------
sync_spec = make_spec(engine="vmap")
state = init_state(sync_spec, init_linear(DIM, device=args.device),
                   device=args.device)
rng = np.random.default_rng(0)
sync_clock = 0.0
for r in range(SYNC_ROUNDS):
    state, rec = run_round(sync_spec, state, round_batch(sync_spec, sampler,
                                                         rng))
    sync_clock += sync_round_duration(lat, K, r)
sync_eps = rec["max_epsilon"]
print(f"\nsync   : {SYNC_ROUNDS} rounds ({SYNC_ROUNDS * K} client updates) "
      f"in {sync_clock:8.2f} simulated seconds (eps={float(sync_eps):.2f})")

# -- 2b. buffered async: flush on the B earliest arrivals -------------------
async_spec = make_spec(engine="async_buffered", buffer_size=B,
                       staleness_alpha=0.5)
rng = np.random.default_rng(0)
ast = init_async_state(async_spec, init_linear(DIM, device=args.device),
                       sampler, rng=rng, latency_model=lat,
                       device=args.device)
ast, out = train_async(async_spec, ast, sampler, max_rounds=FLUSHES,
                       rng=rng, chunk_rounds=8, latency_model=lat)
print(f"async  : {FLUSHES} flushes of B={B} (same {FLUSHES * B} updates) "
      f"in {out['sim_seconds']:8.2f} simulated seconds "
      f"(eps={out['max_epsilon']:.2f})")
print(f"speedup: {sync_clock / out['sim_seconds']:.2f}x simulated "
      f"wall-clock at the same TOTAL landed zCDP across the fleet "
      f"(per-client eps skews async: fast devices are dispatched, and "
      f"charged, more often)")

# -- 3. the dispatch-split ledger ------------------------------------------
print("\ndispatch-split zCDP ledger (landed + in-flight = committed):")
for v in range(K):
    print(f"  device {v}: landed={ast.fl.rho[v]:6.3f}  "
          f"in-flight={ast.pending_rho[v]:5.3f}  "
          f"committed={dispatched_rho(ast)[v]:6.3f}  "
          f"({int(ast.arrivals[v])} arrivals)")
print(f"budget probes read the committed view: eps_dispatched="
      f"{dispatched_epsilon(async_spec, ast):.2f}; a straggler's noise is "
      f"charged when its round is HANDED OUT, not when the upload lands.")
slow, fast = int(np.argmin(rates)), int(np.argmax(rates))
print(f"note the skew: flaky device {slow} landed "
      f"{int(ast.arrivals[slow])} uploads vs {int(ast.arrivals[fast])} for "
      f"reliable device {fast}; staleness weighting (alpha=0.5) damps the "
      f"old versions it trains on.")
