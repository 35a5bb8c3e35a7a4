"""The port's training launcher on gemma3-4b (``--smoke``): the documented
command against the JAX launcher on the same argv (rounds, epsilon, cost
and the ``[design]`` line exactly), and ``--save`` -> the port's serve
driver for a dense, a population and an async checkpoint. The other
launcher gates are in ``tests/test_torch_launch_train.py``.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import json

import pytest
from test_torch_launch_train import SUMMARY_KEYS, _run, _run_port

import repro.launch.train as jtrain

from repro_torch.launch import serve
from repro_torch.launch import train as ttrain


@pytest.mark.parametrize("tau", ["2", "0"])
def test_gemma3_smoke_matches_jax_launcher(tau, monkeypatch):
    """The documented command: gemma3-4b --smoke, 2 rounds of 2 clients,
    seq 64, at tau 2 and with the design solver (tau 0)."""
    argv = ["--arch", "gemma3-4b", "--smoke", "--rounds", "2", "--clients",
            "2", "--tau", tau, "--seq", "64"]
    jsum, jdesign = _run(jtrain.main, argv)
    tsum, tdesign, _ = _run_port(argv, monkeypatch)
    assert [tsum[k] for k in SUMMARY_KEYS] == [jsum[k] for k in SUMMARY_KEYS]
    assert tdesign == jdesign and bool(tdesign) == (tau == "0")


@pytest.mark.parametrize("extra", [
    [], ["--population", "16", "--cohort-size", "2"],
    ["--async-buffer", "2"]], ids=["dense", "population", "async"])
def test_saved_checkpoint_serves(tmp_path, extra, capsys):
    """--save writes the state with federation_meta beside it; the port's
    serve driver loads the aggregated model from it (the async checkpoint's
    global_params) and serves federated params."""
    ckpt = str(tmp_path / "ckpt")
    argv = ["--arch", "gemma3-4b", "--smoke", "--rounds", "1", "--clients",
            "2", "--tau", "1", "--batch", "1", "--seq", "8", "--save", ckpt,
            "--device", "cpu"]
    assert ttrain.main(argv + extra) == 0
    with open(f"{ckpt}/meta.json") as f:
        meta = json.load(f)["extra"]
    assert meta["tau"] == 1 and "history" in meta
    capsys.readouterr()
    assert serve.main(["--arch", "gemma3-4b", "--smoke", "--static",
                       "--fl-checkpoint", ckpt, "--batch", "1",
                       "--prompt-len", "8", "--gen", "2", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    res = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert res["params"] == "federated"
    assert res["generated_shape"] == [1, 2]
