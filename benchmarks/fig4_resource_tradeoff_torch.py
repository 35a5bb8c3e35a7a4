"""Figure 4 on the PyTorch port: accuracy vs resource budget C_th at fixed
privacy budgets.

Uses the solver-configured DP-PASGD at each budget point. The
beyond-paper ``comm_sweep`` compares the aggregation-pipeline settings
(partial participation x compressed updates) against the paper's dense
full-cohort protocol at a *matched iteration budget*, so the Eq.-8
resource saving shows up directly in ``resource_spent`` at comparable
accuracy."""
from __future__ import annotations

import json
import time

from benchmarks.common_torch import (
    estimate_constants, make_cases, run_cli, run_dp_pasgd, csv_row,
    BATCH, C1, C2, CLIP, DELTA,
)
from repro_torch.core.design import DesignProblem, ResourceModel

C_GRID = (200.0, 500.0, 1000.0)
EPS_GRID = (1.0, 10.0)

# (label, participation q, compressor, ratio) — the comm sweep grid
PIPELINES = (
    ("dense_q100", 1.0, "none", 1.0),
    ("topk25_q100", 1.0, "topk", 0.25),
    ("topk25_q50", 0.5, "topk", 0.25),
    ("qsgd8_q50", 0.5, "qsgd", 0.25),
)


def comm_sweep(fast: bool = True, eps: float = 10.0, tau: int = 5,
               rounds: int = 20, device=None):
    """Pipeline sweep on one synthetic case at a fixed (tau, K, eps).

    All settings train the same K = rounds * tau iterations under a
    non-binding C_th; the derived column reports accuracy and the Eq.-8
    cost each setting actually spent (comm term scaled by wire_ratio * q).
    """
    case = make_cases(fast, device)[1]    # Adult-2 (iid synthetic, logreg)
    k = rounds * tau
    c_th = 10 * k * (C1 / tau + C2)     # never binds: K fixes the run length
    rows, blob = [], {}
    base_cost = None
    for label, q, comp, ratio in PIPELINES:
        t0 = time.time()
        out = run_dp_pasgd(case, tau=tau, c_th=c_th, eps_th=eps,
                           k_budget=k, participation=q, compressor=comp,
                           compression_ratio=ratio)
        dt = time.time() - t0
        acc = out["best"].get("eval_acc", 0.0)
        cost = out["resource_spent"]
        base_cost = cost if base_cost is None else base_cost
        blob[label] = {"eval_acc": acc, "resource_spent": cost,
                       "cost_vs_dense": cost / base_cost}
        rows.append(csv_row(
            f"fig4_comm_{label}", dt * 1e6,
            f"acc={acc:.4f};cost={cost:.0f};"
            f"cost_vs_dense={cost / base_cost:.3f}"))
    return rows, blob


def main(fast: bool = True, out_json: str | None = None, device=None):
    rows, blob = [], {}
    for case in make_cases(fast, device):
        consts = estimate_constants(case)
        for eps in EPS_GRID:
            accs = []
            t0 = time.time()
            for c_th in C_GRID:
                prob = DesignProblem(
                    consts=consts, resource=ResourceModel(C1, C2),
                    clip_norm=CLIP, batch_sizes=case.fed.batch_sizes(BATCH),
                    delta=DELTA, eps_th=eps, c_th=c_th)
                sol = prob.solve()
                out = run_dp_pasgd(case, tau=sol.tau, c_th=c_th, eps_th=eps,
                                   k_budget=sol.k)
                accs.append(out["best"].get("eval_acc", 0.0))
            dt = time.time() - t0
            key = f"{case.name}_eps{eps:g}"
            blob[key] = dict(zip(map(int, C_GRID), accs))
            monotone = accs[-1] >= accs[0] - 0.02
            rows.append(csv_row(
                f"fig4_{key}", dt * 1e6 / len(C_GRID),
                ";".join(f"C{int(c)}={a:.4f}" for c, a in zip(C_GRID, accs))
                + f";higher_C_helps={monotone}"))
    sweep_rows, sweep_blob = comm_sweep(fast, device=device)
    rows.extend(sweep_rows)
    blob["comm_sweep"] = sweep_blob
    if out_json:
        with open(out_json, "w") as f:
            json.dump(blob, f, indent=2)
    return rows


if __name__ == "__main__":
    run_cli(main)
