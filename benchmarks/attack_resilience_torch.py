"""Attack-resilience benchmark on the PyTorch port: final accuracy vs
byzantine fraction.

Trains ``benchmarks/attack_resilience.py``'s reference federation
(logistic regression on a separable synthetic task) through
``repro_torch`` under a byzantine update attack at a sweep of byzantine
fractions, for every aggregator (``mean | median | trimmed_mean |
norm_bound``). Each local step's clip and noise runs through the
``dp_clip_noise`` kernel on the GPU. The JSON report goes only where
``--out`` says.

Reading the numbers: at fraction 0.0 every aggregator trains to the same
clean accuracy (the robust reductions cost a little statistical
efficiency, nothing more). As the fraction grows, the ``mean`` column is
dragged by the boosted byzantine updates while the robust columns hold.
``--check`` gates the benchmark's acceptance criterion at fraction 0.25:
every robust aggregator's post-attack accuracy stays within
``GATE_POINTS`` (5 points) of its own no-attack accuracy, AND the mean
degrades by strictly more than the worst robust aggregator. The runs are
deterministic for one seed on one device, but the robust aggregators'
drops spread across random streams by more than the 5-point margin, so
the verdict can differ between seeds (``--seed``) and devices.

    PYTHONPATH=src python benchmarks/attack_resilience_torch.py  # full sweep
    PYTHONPATH=src python benchmarks/attack_resilience_torch.py --smoke \
        --check --device cpu --out /tmp/attack.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.api import FederationSpec, eval_params, init_state, train
from repro_torch.models.linear import init_linear, logits, logreg_loss
from repro_torch.optim import sgd
from repro_torch.utils.device import resolve_device

# fixed reference federation: big enough that the attacked mean visibly
# diverges, small enough for a CI smoke leg
C, TAU, DIM, BATCH = 8, 2, 16, 8
# sigma is deliberately small: the robust reductions' residual bias under
# attack scales with the honest-row spread (order statistics of noisy
# rows), and the benchmark isolates BYZANTINE damage, not DP damage
SIGMA, LR, CLIP = 0.02, 0.3, 1.0
# negative scale = boosted sign-flip (model-replacement poison): the one
# attack that durably breaks the mean at fractions < 0.5 — plain sign_flip
# only halves the mean step, and a positive boost still points the honest
# way, so both wash out over a longer round budget
ATTACK, ATTACK_SCALE = "scale", -25.0
GATE_FRACTION = 0.25            # the acceptance point: 2 of 8 clients
GATE_POINTS = 0.05              # robust post-attack accuracy within 5 points

AGGREGATORS = [
    ("mean", {}),
    ("median", {}),
    ("trimmed_mean", dict(trim_fraction=0.25)),
    ("norm_bound", dict(norm_bound_factor=2.0)),
]


def make_task(seed: int = 0):
    """A separable logistic task shared by all runs: fixed true weights,
    unit-ball features. Returns (sampler, eval_batch)."""
    root = np.random.default_rng(seed)
    w_true = root.normal(size=DIM)
    w_true /= np.linalg.norm(w_true)

    def draw(rng, n):
        x = rng.normal(size=(n, DIM))
        x /= np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1.0)
        y = (x @ w_true > 0).astype(np.int32)
        return x.astype(np.float32), y

    def sampler(m, tau, rng):
        x, y = draw(rng, tau * BATCH)
        return {"x": x.reshape(tau, BATCH, DIM), "y": y.reshape(tau, BATCH)}

    ex, ey = draw(np.random.default_rng(seed + 1), 2048)
    return sampler, {"x": ex, "y": ey}


def accuracy(params, eval_batch) -> float:
    dev = params["w"].device
    with torch.no_grad():
        z = logits(params, torch.as_tensor(eval_batch["x"], device=dev))
    return float((z.argmax(dim=-1).cpu().numpy() == eval_batch["y"]).mean())


def attack_spec(aggregator: str, fraction: float, seed: int = 0,
                **agg_kw) -> FederationSpec:
    return FederationSpec(
        n_clients=C, tau=TAU, loss_fn=logreg_loss, optimizer=sgd(LR),
        dp=True, clip_norm=CLIP,
        sigmas=(SIGMA,) * C, batch_sizes=(BATCH,) * C,
        aggregator=aggregator,
        # fraction 0 -> attack "none": identical spec shape, no byzantine
        # set (and the clean runs double as every aggregator's baseline)
        attack=(ATTACK if fraction > 0 else "none"),
        byzantine_fraction=fraction, attack_scale=ATTACK_SCALE,
        # a compressor-free pipeline is forced by the aggregator on the
        # robust rows; the mean rows get it from the participation field
        # staying at 1.0 only when adversarial — use identity topk so ALL
        # rows (mean included) share the pipeline PRNG schedule
        compressor="topk", compression_ratio=1.0, seed=seed,
        **agg_kw)


def run_matrix(fractions, rounds: int, device=None,
               seed: int = 0) -> list[dict]:
    sampler, eval_batch = make_task()
    rows = []
    for agg, kw in AGGREGATORS:
        for frac in fractions:
            spec = attack_spec(agg, frac, seed, **kw)
            state = init_state(spec, init_linear(DIM, device=device),
                               device=device)
            state, out = train(spec, state, sampler, max_rounds=rounds)
            acc = accuracy(eval_params(spec, state), eval_batch)
            rows.append({
                "aggregator": agg, "byzantine_fraction": frac,
                "attack": ATTACK if frac > 0 else "none",
                "attack_scale": ATTACK_SCALE, "rounds": out["rounds"],
                "final_loss": out["history"][-1]["loss"],
                "accuracy": round(acc, 4),
            })
            print(f"{agg:13s} byz={frac:<6} acc={acc:.3f} "
                  f"loss={out['history'][-1]['loss']:.4f}")
    return rows


def check_gate(rows) -> int:
    """The acceptance gate at GATE_FRACTION (deterministic per stream)."""
    acc = {(r["aggregator"], r["byzantine_fraction"]): r["accuracy"]
           for r in rows}
    drops = {agg: acc[(agg, 0.0)] - acc[(agg, GATE_FRACTION)]
             for agg, _ in AGGREGATORS}
    robust = {a: d for a, d in drops.items() if a != "mean"}
    print(f"accuracy drops at byz={GATE_FRACTION}: "
          f"{ {a: round(d, 4) for a, d in drops.items()} }")
    bad = {a: d for a, d in robust.items() if d > GATE_POINTS}
    if bad:
        print(f"REGRESSION: robust aggregator(s) lost more than "
              f"{GATE_POINTS * 100:.0f} accuracy points under attack: {bad}")
        return 1
    worst_robust = max(robust.values())
    if drops["mean"] <= worst_robust:
        print(f"REGRESSION: mean ({drops['mean']:.4f}) no longer degrades "
              f"more than the worst robust aggregator ({worst_robust:.4f}) "
              f"— the attack matrix lost its contrast")
        return 1
    print(f"attack gate passed: robust drops <= {GATE_POINTS}, mean drops "
          f"{drops['mean']:.3f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced sweep for CI (gate fractions only)")
    ap.add_argument("--check", action="store_true",
                    help="fail unless every robust aggregator holds within "
                         f"{GATE_POINTS * 100:.0f} accuracy points at "
                         f"byzantine fraction {GATE_FRACTION} while the "
                         "mean degrades more")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here (default: none)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu without a GPU)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the federation's seed (FederationSpec.seed): "
                         "its byzantine set, the order of its data draws "
                         "and its DP noise; the task stays the same")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # the round budget is part of the gate's calibration (the robust
    # reductions' bias transient is larger early in training), so smoke
    # trims the fraction sweep, never the rounds
    if args.smoke:
        fractions, rounds = [0.0, GATE_FRACTION], 20
    else:
        fractions, rounds = [0.0, 0.125, GATE_FRACTION, 0.375], 20

    rows = run_matrix(fractions, rounds, dev, args.seed)
    report = {
        "bench": "attack_resilience",
        "config": {"n_clients": C, "tau": TAU, "dim": DIM, "batch": BATCH,
                   "sigma": SIGMA, "lr": LR, "attack": ATTACK,
                   "attack_scale": ATTACK_SCALE, "rounds": rounds,
                   "smoke": args.smoke, "seed": args.seed},
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "results": rows,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    if args.check:
        return check_gate(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
