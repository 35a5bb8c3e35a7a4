"""Figure 2 on the PyTorch port: resource efficiency of DP-PASGD (tau=10)
vs DP-SGD (tau=1).

Paper setting: run both until resource cost C=1000 and privacy loss eps=10;
DP-PASGD should reach higher accuracy at every resource level."""
from __future__ import annotations

import json
import time

from benchmarks.common_torch import csv_row, make_cases, run_cli, run_dp_pasgd

C_TH, EPS = 1000.0, 10.0


def main(fast: bool = True, out_json: str | None = None, device=None):
    rows, blob = [], {}
    for case in make_cases(fast, device):
        t0 = time.time()
        pasgd = run_dp_pasgd(case, tau=10, c_th=C_TH, eps_th=EPS)
        dpsgd = run_dp_pasgd(case, tau=1, c_th=C_TH, eps_th=EPS)
        dt = time.time() - t0
        acc_p = pasgd["best"].get("eval_acc", 0.0)
        acc_s = dpsgd["best"].get("eval_acc", 0.0)
        blob[case.name] = {
            "dp_pasgd": {"acc": acc_p, "rounds": pasgd["rounds"],
                         "curve": [(h.get("resource_spent"),
                                    h.get("eval_acc"))
                                   for h in pasgd["history"]]},
            "dp_sgd": {"acc": acc_s, "rounds": dpsgd["rounds"],
                       "curve": [(h.get("resource_spent"),
                                  h.get("eval_acc"))
                                 for h in dpsgd["history"]]},
        }
        rows.append(csv_row(
            f"fig2_{case.name}", dt * 1e6 / max(1, pasgd["rounds"]),
            f"acc_pasgd={acc_p:.4f};acc_dpsgd={acc_s:.4f};"
            f"pasgd_wins={acc_p > acc_s}"))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(blob, f, indent=2)
    return rows


if __name__ == "__main__":
    run_cli(main)
