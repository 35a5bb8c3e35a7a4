"""Roofline table of the port's dry runs: the records of
``repro_torch.launch.dryrun`` (``experiments/dryrun_torch/*.json``), one
CSV row per (arch, shape) plus a markdown table, as ``benchmarks/
roofline.py`` does for the JAX package's. The terms are the H100's
(:mod:`repro_torch.utils.roofline`); the records come from meta tensors,
so this suite reads files and runs nothing on a device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python benchmarks/roofline_torch.py
"""
from __future__ import annotations

import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from benchmarks.common_torch import csv_row  # noqa: E402

DRYRUN_DIR = "experiments/dryrun_torch"


def load_records(dirname: str = DRYRUN_DIR):
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def markdown_table(recs) -> str:
    hdr = ("| arch | shape | card | status | t_comp (s) | t_mem (s) | "
           "bottleneck | useful FLOPs | live (GiB) | fits HBM |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in recs:
        if r.get("roofline"):
            t = r["roofline"]
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
                f"| {t['t_compute_s']:.3f} | {t['t_memory_s']:.3f} "
                f"| {t['bottleneck']} | {t['useful_flops_fraction']:.1%} "
                f"| {r['live_bytes_per_device'] / 2**30:.1f} "
                f"| {r['fits_hbm']} |")
        else:
            reason = r.get("reason", r.get("error", ""))[:60]
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
                f"| - | - | - | - | - | {reason} |")
    return hdr + "\n".join(lines)


def main(fast: bool = True, out_json: str | None = None, device=None,
         dirname: str = DRYRUN_DIR):
    """The suite's CSV rows (``benchmarks/run_torch.py``'s interface;
    ``fast`` and ``device`` do not apply: the records are files)."""
    recs = load_records(dirname)
    rows = []
    for r in recs:
        if r.get("roofline"):
            t = r["roofline"]
            rows.append(csv_row(
                f"roofline_{r['arch']}_{r['shape']}_{r['mesh']}",
                max(t["t_compute_s"], t["t_memory_s"],
                    t["t_collective_s"]) * 1e6,
                f"bottleneck={t['bottleneck']};"
                f"useful={t['useful_flops_fraction']:.3f};"
                f"fits={r['fits_hbm']}"))
        else:
            rows.append(csv_row(
                f"roofline_{r['arch']}_{r['shape']}_{r['mesh']}", 0.0,
                f"status={r['status']}"))
    if not rows:
        rows.append(csv_row("roofline_no_dryruns_found", 0.0,
                            "run repro_torch.launch.dryrun --all first"))
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"records": recs, "rows": rows}, f, indent=2)
    return rows


if __name__ == "__main__":
    for row in main():
        print(row)
    print()
    print(markdown_table(load_records()))
