"""Benchmark harness on the PyTorch port: the paper's figures 2-6.

Prints ``name,us_per_call,derived`` CSV rows, as ``benchmarks/run.py``
does for the JAX package (its ``roofline`` suite has no port yet).
``--full`` uses the paper-scale dataset sizes; the default fast mode uses
the statistically matched reduced sizes. Each suite's JSON goes to
``--out-dir``.

    PYTHONPATH=src python -m benchmarks.run_torch [--full] [--only fig2,fig6]
        [--device cpu] [--out-dir experiments/bench_torch]
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from benchmarks import (  # noqa: E402
    fig2_efficiency_torch,
    fig3_tau_sweep_torch,
    fig4_resource_tradeoff_torch,
    fig5_privacy_tradeoff_torch,
    fig6_optimal_tau_torch,
)

SUITES = {
    "fig2": fig2_efficiency_torch.main,
    "fig3": fig3_tau_sweep_torch.main,
    "fig4": fig4_resource_tradeoff_torch.main,
    "fig5": fig5_privacy_tradeoff_torch.main,
    "fig6": fig6_optimal_tau_torch.main,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset, e.g. fig2,fig6")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu without a GPU)")
    ap.add_argument("--out-dir", default="experiments/bench_torch")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    names = (args.only.split(",") if args.only else list(SUITES))
    print("name,us_per_call,derived")
    failures = 0
    for name in names:
        try:
            rows = SUITES[name](
                fast=not args.full,
                out_json=os.path.join(args.out_dir, f"{name}.json"),
                device=args.device)
            for r in rows:
                print(r, flush=True)
        except Exception:  # noqa: BLE001 — report the suite, run the rest
            failures += 1
            print(f"{name},0,ERROR", flush=True)
            traceback.print_exc(file=sys.stderr)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
