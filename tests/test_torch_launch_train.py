"""The port's training launcher (``repro_torch.launch.train``) against the
JAX package's (``repro.launch.train``), on the CPU at smoke size.

``main`` runs on the same argv in both packages (the port with ``--device
cpu``), and its summary's ``rounds``, ``max_epsilon`` and
``resource_spent``, and the design solver's ``[design]`` line, must be
JAX's exactly: they are host math (the ledger, the costs, the design), and
none depends on the model's params, which come from another generator in
each package. Partial participation is left out of that comparison: which
clients a round draws comes from each package's own random stream, and the
epsilon of the busiest client with it. The kernel calls the launcher makes
are counted on spies of ``repro_torch.kernels.ops`` (the CPU wrappers'
launch counters do not move).
"""
import contextlib
import io
import json

import numpy as np
import pytest

import repro.launch.train as jtrain
from repro.api import FederationSpec as JSpec
from repro.optim import sgd as jsgd

import repro_torch.kernels.ops as tops
from repro_torch.api import FederationSpec as TSpec
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.optim import sgd as tsgd

BASE = ["--arch", "codeqwen1.5-7b", "--smoke", "--rounds", "3",
        "--clients", "4", "--tau", "1", "--batch", "1", "--seq", "8"]
ROW_KERNELS = ("dp_clip_noise", "quantize_decompress", "cohort_gather_scatter")
SUMMARY_KEYS = ("rounds", "max_epsilon", "resource_spent")


def _run(main, argv):
    """``main(argv)``'s printed summary (JSON) and its ``[design]`` lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    out = buf.getvalue()
    design = [ln for ln in out.splitlines() if ln.startswith("[design]")]
    summary = json.loads(out[out.index("{"):out.rindex("}") + 1])
    return summary, design


def _run_port(argv, monkeypatch):
    """The port's main on the CPU, with its row-kernel calls counted."""
    calls = dict.fromkeys(ROW_KERNELS, 0)
    for name in ROW_KERNELS:
        real = getattr(tops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tops, name, spy)
    summary, design = _run(ttrain.main, argv + ["--device", "cpu"])
    return summary, design, calls


# (extra argv, the port's row-kernel calls at tau 1: dp_clip_noise,
# quantize_decompress, cohort_gather_scatter)
CASES = {
    "dense_chunked": (["--chunk-rounds", "2"], (3, 0, 0)),
    "qsgd": (["--compressor", "qsgd", "--compress-bits", "4"], (3, 3, 0)),
    # the resident cache moves error-feedback rows, so it needs a compressor
    # to call cohort_gather_scatter (7: 2 x (2 gathers + 2 scatters) for a
    # chunk of two rounds, minus the last chunk's single round's, plus the
    # promotions and the final gather)
    "population_resident": (["--population", "64", "--cohort-size", "4",
                             "--chunk-rounds", "2", "--resident-cache", "16",
                             "--compressor", "topk", "--compress-ratio",
                             "0.25"], (3, 0, 7)),
    # generation 0's dispatch, then one a flush (2 flushes)
    "async": (["--async-buffer", "2", "--latency-profile", "hetero",
               "--staleness-alpha", "0.5"], (3, 0, 0)),
    "secure_central": (["--secure-agg", "--dp-accounting", "central"],
                       (3, 0, 0)),
    "design": (["--tau", "0", "--cth", "500", "--eps", "50"], (0, 0, 0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_main_matches_jax_launcher(case, monkeypatch):
    extra, want_calls = CASES[case]
    jsum, jdesign = _run(jtrain.main, BASE + extra)
    tsum, tdesign, calls = _run_port(BASE + extra, monkeypatch)
    assert [tsum[k] for k in SUMMARY_KEYS] == [jsum[k] for k in SUMMARY_KEYS]
    assert tdesign == jdesign
    assert (case == "design") == bool(tdesign)
    assert tuple(calls[k] for k in ROW_KERNELS) == want_calls
    if tsum["rounds"]:
        assert np.isfinite(tsum["final_loss"])
    for k in ("population", "cohort_size", "distinct_sampled",
              "distinct_participants", "buffer_size", "sim_seconds"):
        assert tsum.get(k) == jsum.get(k), k


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


def test_partial_participation_runs_each_round_on_half_the_clients(
        monkeypatch):
    """qsgd at q 0.5: the JAX launcher's rounds and cost; one
    quantize_decompress call a round; epsilon within the budget (its value
    follows the clients the port's generator draws)."""
    extra = ["--compressor", "qsgd", "--participation", "0.5"]
    jsum, _ = _run(jtrain.main, BASE + extra)
    tsum, _, calls = _run_port(BASE + extra, monkeypatch)
    assert (tsum["rounds"], tsum["resource_spent"]) == \
        (jsum["rounds"], jsum["resource_spent"])
    assert calls["quantize_decompress"] == tsum["rounds"]
    assert 0 < tsum["max_epsilon"] <= 10.0


_META_SPECS = [
    dict(),
    dict(participation=0.5, compressor="qsgd", compression_bits=4),
    dict(population=1000, cohort_size=4, compressor="topk",
         compression_ratio=0.25),
    dict(secure_agg=True, dp_accounting="central"),
    dict(attack="sign_flip", byzantine_fraction=0.25,
         aggregator="trimmed_mean"),
    dict(topology="local_only"),
]


@pytest.mark.parametrize("kw", _META_SPECS,
                         ids=lambda kw: "-".join(kw) or "dense")
def test_federation_meta_equals_jax(kw):
    common = dict(n_clients=4, tau=2, loss_fn=lambda p, b: 0.0,
                  sigmas=(0.5,) * 4, batch_sizes=(2,) * 4)
    jspec = JSpec(optimizer=jsgd(0.1), **common, **kw)
    tspec = TSpec(optimizer=tsgd(0.1), **common, **kw)
    got, want = ttrain.federation_meta(tspec), jtrain.federation_meta(jspec)
    assert got == want
    assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("extra,item", [
    (["--engine", "shard_map"], "item 12"),
    (["--engine", "mesh_2d"], "item 12"),
    (["--mesh-shape", "2,1"], "item 12"),
    (["--replica-hint"], "item 13b"),
    (["--env-profile", "host"], "item 13b"),
    (["--host-devices", "2"], "item 13b"),
])
def test_unported_flags_raise_naming_their_item(extra, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(BASE + extra + ["--device", "cpu"])


def test_async_and_population_are_exclusive():
    with pytest.raises(SystemExit, match="mutually exclusive"):
        ttrain.main(BASE + ["--async-buffer", "2", "--population", "8",
                            "--device", "cpu"])


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
