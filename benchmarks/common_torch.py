"""Shared benchmark setup on the PyTorch port: the paper's four data cases
on the synthetic surrogates, problem-constant estimation (paper §8.1
'estimated beforehand'), and a budget-driven training runner.

The same cases, constants and runs as ``benchmarks/common.py``, through
``repro_torch``. Every case lives on one device: ``make_cases(device=...)``
takes it (default ``"cuda"``, which raises without a GPU; pass ``"cpu"``
to run here), and ``estimate_constants`` / ``run_dp_pasgd`` run there.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad

from repro_torch.api import (
    FederationSpec,
    eval_params,
    init_state,
    round_batch,
    run_round,
    train,
)
from repro_torch.core.convergence import ProblemConstants
from repro_torch.core.fl import design_sigmas
from repro_torch.data import (
    adult_like,
    split_by_group,
    split_iid,
    vehicle_like,
)
from repro_torch.models.linear import (
    init_linear,
    logreg_loss,
    make_eval_fn,
    svm_loss,
)
from repro_torch.optim import sgd
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves

BATCH = 32
DELTA = 1e-4
C1, C2 = 100.0, 1.0          # paper §8.1 resource-cost setting
LR = 0.3
CLIP = 1.0


@dataclass
class Case:
    name: str
    fed: object
    loss_fn: object
    dim: int
    eval_fn: object
    device: torch.device


def make_cases(fast: bool = True, device=None):
    """Adult-1/2 (logreg) and Vehicle-1/2 (SVM), as in paper §8.1, on
    ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    if fast:
        adult = adult_like(n=6_000, dim=40, seed=0)
        vehicle = vehicle_like(n_sensors=23, per_sensor=300, dim=50, seed=1)
    else:
        adult = adult_like(seed=0)
        vehicle = vehicle_like(seed=1)
    cases = []
    for name, fed, loss in [
        ("Adult-1", split_by_group(adult), logreg_loss),
        ("Adult-2", split_iid(adult, 16), logreg_loss),
        ("Vehicle-1", split_by_group(vehicle), svm_loss),
        ("Vehicle-2", split_iid(vehicle, 23), svm_loss),
    ]:
        xt, yt = fed.eval_arrays("test")
        cases.append(Case(name=name, fed=fed, loss_fn=loss,
                          dim=fed.clients[0].x_train.shape[1],
                          eval_fn=make_eval_fn(loss, xt, yt), device=dev))
    return cases


def estimate_constants(case: Case, probe_rounds: int = 30) -> ProblemConstants:
    """Estimate (L, lambda, alpha, xi^2) as the paper does (§8.1)."""
    fed = case.fed
    d = case.dim
    params0 = init_linear(d, device=case.device)
    # L: top eigenvalue of the (regularized) logistic Hessian bound
    x, _ = fed.eval_arrays("train")
    n = min(len(x), 4000)
    xs = x[:n]
    v = np.random.default_rng(0).normal(size=d)
    for _ in range(20):
        v = xs.T @ (xs @ v) / n
        v /= np.linalg.norm(v) + 1e-12
    lip = 0.25 * float(v @ (xs.T @ (xs @ v)) / n) + 1e-4

    # xi^2: minibatch-gradient variance at params0
    g_fn = grad(case.loss_fn)
    rng = np.random.default_rng(1)
    sampler = fed.make_sampler(BATCH)
    grads = []
    for m in range(min(fed.n_clients, 8)):
        b = sampler(m, 1, rng)
        g = g_fn(params0, {k: torch.as_tensor(val[0], device=case.device)
                           for k, val in b.items()})
        grads.append(np.concatenate([l.cpu().numpy().ravel()
                                     for l in tree_leaves(g)]))
    grads = np.stack(grads)
    xi2 = float(np.mean(np.var(grads, axis=0)) * grads.shape[1])

    # alpha and lambda: cheap non-private probe run
    spec = FederationSpec(n_clients=fed.n_clients, tau=5, dp=False,
                          loss_fn=case.loss_fn, optimizer=sgd(LR),
                          sigmas=(0.0,) * fed.n_clients,
                          batch_sizes=tuple(fed.batch_sizes(BATCH)))
    state = init_state(spec, params0, device=case.device)
    probe_rng = np.random.default_rng(spec.seed)
    losses = []
    for _ in range(probe_rounds):
        batch = round_batch(spec, sampler, probe_rng)
        state, rec = run_round(spec, state, batch, check_budgets=False)
        losses.append(rec["loss"])                # lazy device scalars
    losses = [float(l) for l in losses]
    l0, lstar = losses[0], min(losses)
    alpha = max(l0 - lstar, 1e-3) + 0.05
    # strong convexity: fit exponential decay rate of the loss gap
    gaps = np.maximum(np.asarray(losses) - lstar + 1e-4, 1e-6)
    k = np.arange(len(gaps)) * spec.tau
    slope = np.polyfit(k, np.log(gaps), 1)[0]
    lam = min(max(-slope / LR, 1e-3), 1.0 / LR * 0.99)
    return ProblemConstants(eta=LR, lam=float(lam), lip=float(lip),
                            alpha=float(alpha), xi2=float(xi2), dim=2 * d + 2,
                            n_clients=fed.n_clients)


def run_dp_pasgd(case: Case, tau: int, c_th: float, eps_th: float,
                 k_budget: int | None = None, seed: int = 0,
                 participation: float = 1.0, compressor: str = "none",
                 compression_ratio: float = 0.1, compression_bits: int = 8,
                 proportional_batches: bool = False):
    """Train DP-PASGD at a given tau on the case's device until the budgets
    bind (paper's Eq. 8/9 schedule: K chosen by the budgets; sigma by
    Eq. 23).

    The aggregation-pipeline knobs (participation / compressor) and the
    paper's per-client X_m (``proportional_batches``) pass straight through
    to the FederationSpec; the k_max estimate keeps the dense cost so runs
    at different pipeline settings plan the same K and the Eq.-8 savings
    show up in ``resource_spent``.
    """
    fed = case.fed
    k_max = int(c_th / (C1 / tau + C2) // tau * tau)
    k = k_budget or max(tau, k_max)
    # FederatedData.batch_sizes enforces the X_m <= executed-batch cap
    x_m = fed.batch_sizes(BATCH, proportional=proportional_batches)
    sig = design_sigmas(k, CLIP, x_m, eps_th, DELTA)
    spec = FederationSpec(n_clients=fed.n_clients, tau=tau,
                          loss_fn=case.loss_fn, optimizer=sgd(LR),
                          clip_norm=CLIP, dp=True,
                          participation=participation, compressor=compressor,
                          compression_ratio=compression_ratio,
                          compression_bits=compression_bits,
                          sigmas=tuple(float(s) for s in sig),
                          batch_sizes=tuple(x_m),
                          eps_th=eps_th, delta=DELTA,
                          c_th=c_th, c1=C1, c2=C2, seed=seed)
    state = init_state(spec, init_linear(case.dim, device=case.device),
                       device=case.device)
    t0 = time.time()
    state, out = train(spec, state, fed.make_sampler(BATCH),
                       max_rounds=max(1, k // tau),
                       eval_fn=case.eval_fn, eval_every=1)
    if "eval_acc" not in out["best"]:
        # budgets bound before any evaluated round: score the current model
        out["best"] = {**out["best"], **case.eval_fn(eval_params(spec, state))}
    out["wall_s"] = time.time() - t0
    out["sigma"] = float(sig[0])
    out["k_planned"] = k
    return out


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def run_cli(main) -> None:
    """A figure script's command line: ``--device`` (default ``cuda``),
    then its CSV rows on stdout."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu to run "
                         "without a GPU)")
    args = ap.parse_args()
    for r in main(device=args.device):
        print(r)
