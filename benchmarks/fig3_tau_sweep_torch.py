"""Figure 3 on the PyTorch port: accuracy vs tau, with the optimal-design
solver's tau* marker.

Grid-searches tau (paper: 1..20) under (C_th, eps_th) budgets and compares
the solver's tau* (paper §7) against the empirical best."""
from __future__ import annotations

import json
import time

from benchmarks.common_torch import (
    estimate_constants,
    make_cases,
    run_cli,
    run_dp_pasgd,
    csv_row,
    BATCH, C1, C2, CLIP, DELTA,
)
from repro_torch.core.design import DesignProblem, ResourceModel

TAUS = (1, 2, 3, 5, 8, 10, 14, 20)


def main(fast: bool = True, out_json: str | None = None,
         budgets=((1000.0, 4.0),), device=None):
    rows, blob = [], {}
    cases = make_cases(fast, device)
    for case in cases:
        consts = estimate_constants(case)
        for c_th, eps_th in budgets:
            t0 = time.time()
            accs = {}
            for tau in TAUS:
                out = run_dp_pasgd(case, tau=tau, c_th=c_th, eps_th=eps_th)
                accs[tau] = out["best"].get("eval_acc", 0.0)
            prob = DesignProblem(
                consts=consts, resource=ResourceModel(C1, C2),
                clip_norm=CLIP,
                batch_sizes=case.fed.batch_sizes(BATCH),
                delta=DELTA, eps_th=eps_th, c_th=c_th)
            sol = prob.solve()
            best_tau = max(accs, key=accs.get)
            # accuracy at the solver's tau vs the empirical best
            tau_near = min(TAUS, key=lambda t: abs(t - sol.tau))
            gap = accs[best_tau] - accs[tau_near]
            dt = time.time() - t0
            key = f"{case.name}_C{int(c_th)}_eps{eps_th:g}"
            blob[key] = {"accs": accs, "tau_star_solver": sol.tau,
                         "tau_star_grid": best_tau, "acc_gap": gap}
            rows.append(csv_row(
                f"fig3_{key}", dt * 1e6 / len(TAUS),
                f"tau_solver={sol.tau};tau_grid={best_tau};"
                f"acc_at_solver={accs[tau_near]:.4f};"
                f"acc_at_grid={accs[best_tau]:.4f};gap={gap:.4f}"))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(blob, f, indent=2)
    return rows


if __name__ == "__main__":
    run_cli(main)
