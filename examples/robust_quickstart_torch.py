"""Adversarial-fleet quickstart on the PyTorch port: secure aggregation +
byzantine robustness.

The paper's DP-PASGD trusts every device AND the server. The trust plane
relaxes both, as composable knobs on the aggregation seam. This script
walks the whole ``repro_torch`` surface, as ``examples/robust_quickstart.py``
does for the JAX package:

  1. **secure aggregation** — clients upload pairwise-masked fixed-point
     updates; single uploads are mask noise to the server, yet the cohort
     sum (dropout-corrected) is EXACT. With the server reduced to
     sum-only, ``dp_accounting="central"`` models the round as one
     central Gaussian release and every zCDP charge shrinks by 1/P.
  2. **byzantine robustness** — 2 of 8 devices send boosted sign-flipped
     updates (the model-replacement poison). The participant mean
     collapses to chance; coordinate-median / trimmed-mean / norm-bound
     aggregators hold within a few accuracy points of the clean run.
  3. **population poisoning** — at M virtual clients there are no stable
     slots, so the malicious wrapper binds label-flip poisoning to vids.

Run:  PYTHONPATH=src python examples/robust_quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import FederationSpec, eval_params, init_state, train
from repro_torch.models.linear import init_linear, logits, logreg_loss
from repro_torch.optim import sgd
from repro_torch.population import (
    is_byzantine_vid,
    malicious_population,
    synthetic_population,
)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device (default cuda; cpu without a GPU)")
args = ap.parse_args()

C, TAU, DIM, BATCH, ROUNDS = 8, 2, 16, 8, 15
rng_task = np.random.default_rng(0)
W_TRUE = rng_task.normal(size=DIM)
W_TRUE /= np.linalg.norm(W_TRUE)


def draw(rng, n):
    x = rng.normal(size=(n, DIM))
    x /= np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1.0)
    return x.astype(np.float32), (x @ W_TRUE > 0).astype(np.int32)


def sampler(m, tau, rng):
    x, y = draw(rng, tau * BATCH)
    return {"x": x.reshape(tau, BATCH, DIM), "y": y.reshape(tau, BATCH)}


EVAL_X, EVAL_Y = draw(np.random.default_rng(1), 2048)


def make_spec(**kw):
    return FederationSpec(
        n_clients=C, tau=TAU, loss_fn=logreg_loss, optimizer=sgd(0.3),
        clip_norm=1.0, dp=True, sigmas=(0.05,) * C, batch_sizes=(BATCH,) * C,
        eps_th=1e9, c_th=1e9, **kw)


def run(spec):
    state = init_state(spec, init_linear(DIM, device=args.device),
                       device=args.device)
    state, out = train(spec, state, sampler, max_rounds=ROUNDS)
    with torch.no_grad():
        z = logits(eval_params(spec, state),
                   torch.as_tensor(EVAL_X, device=args.device))
    return float((z.argmax(dim=-1).cpu().numpy() == EVAL_Y).mean()), out


# -- 1. secure aggregation + central accounting -----------------------------
# the identity codec keeps the plain run on the pipeline PRNG schedule, so
# the two runs draw the SAME DP noise and differ only by mask quantization
plain = make_spec(compressor="topk", compression_ratio=1.0)
secure = make_spec(secure_agg=True, dp_accounting="central")
acc_p, out_p = run(plain)
acc_s, out_s = run(secure)
print("secure aggregation (server sees ONLY the masked cohort sum):")
print(f"  plain  mean round: acc={acc_p:.3f}  "
      f"eps={out_p['history'][-1]['max_epsilon']:.3f} (local accounting)")
print(f"  secure mean round: acc={acc_s:.3f}  "
      f"eps={out_s['history'][-1]['max_epsilon']:.3f} "
      f"(central: every charge / P={C})")
print(f"  same model to quantization precision "
      f"(|acc delta|={abs(acc_s - acc_p):.4f}); the privacy claim moved "
      f"from per-client releases to the single aggregate.\n")

# -- 2. the attack matrix: boosted flip vs every aggregator -----------------
print(f"attack matrix (2 of {C} byzantine, boosted sign-flip -25x):")
for agg, kw in [("mean", {}), ("median", {}),
                ("trimmed_mean", dict(trim_fraction=0.25)),
                ("norm_bound", dict(norm_bound_factor=2.0))]:
    clean, _ = run(make_spec(aggregator=agg, **kw))
    hit, _ = run(make_spec(aggregator=agg, attack="scale",
                           attack_scale=-25.0, byzantine_fraction=0.25,
                           **kw))
    verdict = "COLLAPSED" if clean - hit > 0.1 else "held"
    print(f"  {agg:13s} clean={clean:.3f}  attacked={hit:.3f}  "
          f"drop={clean - hit:+.3f}  {verdict}")
print("  the mean is dragged by the boosted minority; the robust "
      "reductions are coordinate-bounded by the honest rows.\n")

# -- 3. population-mode poisoning: malicious vids ---------------------------
M = 10_000
pop = synthetic_population(M, dim=DIM, batch_size=BATCH)
mal = malicious_population(pop, byzantine_fraction=0.25, seed=7)
flags = [is_byzantine_vid(v, 0.25, 7) for v in range(M)]
shard = mal.sampler(int(np.argmax(flags)), TAU,
                    np.random.default_rng(0))
print(f"population poisoning ({mal.name}):")
print(f"  {sum(flags)}/{M} vids byzantine (per-vid deterministic draw, "
      f"O(1) membership — no M-length table)")
print(f"  byzantine vid serves flipped labels: y[:4]={shard['y'][0][:4]} "
      f"(features bit-unchanged; honest vids bit-identical to the base "
      f"population)")
print("  update-level attacks stay resident-only — a cohort slot hosts a "
      "different vid every round, so corruption must ride the data path.")
