"""The port's benchmark and example scripts run on the CPU: every figure
script (``benchmarks/fig*_torch.py``), the runner (``run_torch.py``), the
serving benchmark (``serve_torch.py``) and six ``examples/*_torch.py``, on
``device="cpu"``. Their numbers are held against the JAX package's in
``tests/test_torch_benchmarks.py``.
"""
import _torch_threads
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import benchmarks.run_torch as run_torch  # noqa: E402


@pytest.mark.parametrize("name", ["fig2", "fig3", "fig4", "fig5"])
def test_figure_script_runs_on_the_cpu(tmp_path, name):
    out = tmp_path / f"{name}.json"
    rows = run_torch.SUITES[name](fast=True, out_json=str(out),
                                  device="cpu")
    assert rows and all(r.startswith(f"{name}_") for r in rows)
    assert json.loads(out.read_text())


def test_runner_writes_each_suite_json(tmp_path, capsys):
    run_torch.main(["--device", "cpu", "--only", "fig6", "--out-dir",
                    str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[1].startswith("fig6_optimal_tau,")
    assert (tmp_path / "fig6.json").exists()
    # the JAX runner's suites, roofline included (benchmarks/roofline_torch)
    assert set(run_torch.SUITES) == {"fig2", "fig3", "fig4", "fig5", "fig6",
                                     "roofline"}


@pytest.mark.parametrize("script", [
    "quickstart_torch.py", "optimal_design_torch.py",
    "population_quickstart_torch.py", "robust_quickstart_torch.py",
    "serve_continuous_torch.py", "serve_batched_torch.py"])
def test_example_runs_on_the_cpu(script):
    import os
    import subprocess
    args = [sys.executable, str(ROOT / "examples" / script)]
    if script != "optimal_design_torch.py":       # host math only
        args += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               **_torch_threads.SUBPROCESS_ENV)
    proc = subprocess.run(args, capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip()


def test_serve_benchmark_runs_on_the_cpu(tmp_path, capsys):
    """benchmarks/serve_torch.py on the CPU: every load's continuous and
    static rows, the same greedy tokens in both modes. (Its --check also
    compares the two modes' host-timed tokens/s, which a loaded CPU makes
    noisy: that gate runs on the card.)"""
    import benchmarks.serve_torch as serve_bench
    out = tmp_path / "serve.json"
    assert serve_bench.main(["--smoke", "--requests", "6", "--device",
                             "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and report["tokens_byte_identical"]
    assert [(r["mode"], r["load"]) for r in report["results"]] == [
        (m, load) for load in serve_bench.LOADS
        for m in ("continuous", "static")]
    assert all(r["requests"] == 6 and r["tokens_per_s"] > 0
               for r in report["results"])
    assert f"wrote {out}" in capsys.readouterr().out


def test_serve_benchmark_repeats_each_load_in_turns(tmp_path):
    """--repeats N serves every load N times in both modes and reports each
    mode's median tokens/s per load, the numbers --check compares."""
    import benchmarks.serve_torch as serve_bench
    out = tmp_path / "serve.json"
    assert serve_bench.main(["--smoke", "--requests", "4", "--repeats", "3",
                             "--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["config"]["repeats"] == 3
    assert report["tokens_byte_identical"]
    assert [(r["load"], r["repeat"], r["mode"]) for r in report["results"]] \
        == [(load, k, m) for load in serve_bench.LOADS for k in range(3)
            for m in ("continuous", "static")]
    for med in report["median_tokens_per_s"]:
        for mode in ("continuous", "static"):
            assert med[mode] == float(np.median(
                [r["tokens_per_s"] for r in report["results"]
                 if r["load"] == med["load"] and r["mode"] == mode]))
