"""Figure 5 on the PyTorch port: accuracy vs privacy budget eps_th at fixed
resource budgets."""
from __future__ import annotations

import json
import time

from benchmarks.common_torch import (
    estimate_constants, make_cases, run_cli, run_dp_pasgd, csv_row,
    BATCH, C1, C2, CLIP, DELTA,
)
from repro_torch.core.design import DesignProblem, ResourceModel

EPS_GRID = (1.0, 2.0, 4.0, 10.0)
C_GRID = (500.0, 1000.0)


def main(fast: bool = True, out_json: str | None = None, device=None):
    rows, blob = [], {}
    for case in make_cases(fast, device):
        consts = estimate_constants(case)
        for c_th in C_GRID:
            accs = []
            t0 = time.time()
            for eps in EPS_GRID:
                prob = DesignProblem(
                    consts=consts, resource=ResourceModel(C1, C2),
                    clip_norm=CLIP, batch_sizes=case.fed.batch_sizes(BATCH),
                    delta=DELTA, eps_th=eps, c_th=c_th)
                sol = prob.solve()
                out = run_dp_pasgd(case, tau=sol.tau, c_th=c_th, eps_th=eps,
                                   k_budget=sol.k)
                accs.append(out["best"].get("eval_acc", 0.0))
            dt = time.time() - t0
            key = f"{case.name}_C{int(c_th)}"
            blob[key] = dict(zip(map(float, EPS_GRID), accs))
            monotone = accs[-1] >= accs[0] - 0.02
            rows.append(csv_row(
                f"fig5_{key}", dt * 1e6 / len(EPS_GRID),
                ";".join(f"eps{e:g}={a:.4f}"
                         for e, a in zip(EPS_GRID, accs))
                + f";higher_eps_helps={monotone}"))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(blob, f, indent=2)
    return rows


if __name__ == "__main__":
    run_cli(main)
