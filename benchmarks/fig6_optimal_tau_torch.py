"""Figure 6 on the PyTorch port: the solver's optimal tau over the
(C_th, eps_th) grid.

Paper §8.5 claim: tau* decreases with the resource budget and increases
with the privacy budget. Pure solver evaluation (no training)."""
from __future__ import annotations

import json
import time

from benchmarks.common_torch import (
    estimate_constants, make_cases, run_cli, csv_row,
    BATCH, C1, C2, CLIP, DELTA,
)
from repro_torch.core.design import DesignProblem, ResourceModel

C_GRID = (200.0, 400.0, 600.0, 800.0, 1000.0)
EPS_GRID = (1.0, 2.0, 4.0, 7.0, 10.0)


def main(fast: bool = True, out_json: str | None = None, device=None):
    rows, blob = [], {}
    case = make_cases(fast, device)[0]          # Adult-1 representative
    consts = estimate_constants(case)
    t0 = time.time()
    grid = {}
    for c_th in C_GRID:
        for eps in EPS_GRID:
            prob = DesignProblem(
                consts=consts, resource=ResourceModel(C1, C2),
                clip_norm=CLIP, batch_sizes=case.fed.batch_sizes(BATCH),
                delta=DELTA, eps_th=eps, c_th=c_th)
            grid[f"C{int(c_th)}_eps{eps:g}"] = prob.solve().tau
    dt = time.time() - t0
    blob["grid"] = grid
    # monotonicity checks of the paper's §8.5 claims
    tau_low_c = grid[f"C{int(C_GRID[0])}_eps4"]
    tau_high_c = grid[f"C{int(C_GRID[-1])}_eps4"]
    tau_low_e = grid[f"C600_eps{EPS_GRID[0]:g}"]
    tau_high_e = grid[f"C600_eps{EPS_GRID[-1]:g}"]
    rows.append(csv_row(
        "fig6_optimal_tau", dt * 1e6 / (len(C_GRID) * len(EPS_GRID)),
        f"tau(C{int(C_GRID[0])})={tau_low_c};tau(C{int(C_GRID[-1])})={tau_high_c};"
        f"dec_with_C={tau_low_c >= tau_high_c};"
        f"tau(eps1)={tau_low_e};tau(eps10)={tau_high_e};"
        f"inc_with_eps={tau_high_e >= tau_low_e}"))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(blob, f, indent=2)
    return rows


if __name__ == "__main__":
    run_cli(main)
