"""The paper's experiments on the port (``benchmarks/common_torch.py``, the
``fig*_torch.py`` scripts and ``run_torch.py``) against the JAX package's.

- ``make_cases(fast=True)`` builds JAX's data exactly (numpy generators).
- ``estimate_constants``: the power-iteration L exactly (host numpy), the
  gradient variance xi^2 within rtol 1e-5 (f32 gradients), alpha and
  lambda within rtol 1e-4 (fitted to 30 f32 probe rounds).
- The optimal design on the port's constants picks JAX's (K*, tau*) on all
  four cases, and fig6's solver grid is JAX's.
- ``run_dp_pasgd`` at fig2's tau 10 on all four cases with JAX's noise
  injected: the stopping round, epsilon and cost exactly, params within
  1e-5.
- Without a GPU the entry points' default device raises. The scripts
  themselves run in ``tests/test_torch_benchmark_scripts.py``.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import benchmarks.common as jcommon  # noqa: E402
import benchmarks.common_torch as tcommon  # noqa: E402
import benchmarks.fig6_optimal_tau as jfig6  # noqa: E402
import benchmarks.run_torch as run_torch  # noqa: E402
import repro_torch.api.state as tstate  # noqa: E402
from repro.core.design import DesignProblem as JDesign  # noqa: E402
from repro.core.design import ResourceModel as JResource  # noqa: E402
from repro.models import linear as jlin  # noqa: E402
from repro_torch.core.design import DesignProblem, ResourceModel  # noqa: E402
from repro_torch.utils.convert import tree_to_numpy  # noqa: E402
from test_torch_fl import jax_round_noise  # noqa: E402

NAMES = ("Adult-1", "Adult-2", "Vehicle-1", "Vehicle-2")


@pytest.fixture(scope="module")
def cases():
    return (jcommon.make_cases(True),
            tcommon.make_cases(True, device="cpu"))


@pytest.fixture(scope="module")
def constants(cases):
    jcases, tcases = cases
    return ([jcommon.estimate_constants(c) for c in jcases],
            [tcommon.estimate_constants(c) for c in tcases])


def test_make_cases_builds_jax_data_exactly(cases):
    jcases, tcases = cases
    assert [c.name for c in tcases] == [c.name for c in jcases] == \
        list(NAMES)
    for j, t in zip(jcases, tcases):
        assert t.dim == j.dim and t.fed.n_clients == j.fed.n_clients
        assert t.loss_fn.__name__ == j.loss_fn.__name__
        assert str(t.device) == "cpu"
        for split in ("train", "test"):
            for a, b in zip(t.fed.eval_arrays(split),
                            j.fed.eval_arrays(split)):
                np.testing.assert_array_equal(a, b)
        assert t.fed.batch_sizes(tcommon.BATCH) == \
            j.fed.batch_sizes(jcommon.BATCH)


@pytest.mark.parametrize("i", range(4), ids=NAMES)
def test_estimate_constants_match_jax(constants, i):
    jc, tc = constants[0][i], constants[1][i]
    assert tc.lip == jc.lip
    assert tc.xi2 == pytest.approx(jc.xi2, rel=1e-5)
    assert tc.alpha == pytest.approx(jc.alpha, rel=1e-4)
    assert tc.lam == pytest.approx(jc.lam, rel=1e-4)
    assert (tc.eta, tc.dim, tc.n_clients) == (jc.eta, jc.dim, jc.n_clients)


@pytest.mark.parametrize("i", range(4), ids=NAMES)
def test_design_on_the_port_constants_picks_jax_k_and_tau(cases, constants,
                                                          i):
    jcase, tcase = cases[0][i], cases[1][i]
    jc, tc = constants[0][i], constants[1][i]
    for c_th, eps in ((1000.0, 4.0), (500.0, 10.0), (200.0, 1.0)):
        kw = dict(clip_norm=tcommon.CLIP,
                  batch_sizes=tcase.fed.batch_sizes(tcommon.BATCH),
                  delta=tcommon.DELTA, eps_th=eps, c_th=c_th)
        t = DesignProblem(consts=tc, resource=ResourceModel(100.0, 1.0),
                          **kw).solve()
        j = JDesign(consts=jc, resource=JResource(100.0, 1.0), **kw).solve()
        assert (t.k, t.tau) == (j.k, j.tau), (jcase.name, c_th, eps)


def _capture_train(monkeypatch, module, box):
    """Record the final state ``module.train`` returns."""
    inner = module.train

    def train(*args, **kwargs):
        state, out = inner(*args, **kwargs)
        box.append(state)
        return state, out

    monkeypatch.setattr(module, "train", train)


@pytest.mark.parametrize("i", range(4), ids=NAMES)
def test_run_dp_pasgd_matches_jax_with_its_noise(monkeypatch, cases, i):
    """fig2's DP-PASGD run (tau 10, C_th 1000, eps_th 10) in both packages,
    the port fed JAX's per-round noise."""
    jcase, tcase = cases[0][i], cases[1][i]
    params0 = jlin.init_linear(jcase.dim)
    jfinal, tfinal, jkey = [], [], []
    _capture_train(monkeypatch, jcommon, jfinal)
    _capture_train(monkeypatch, tcommon, tfinal)
    jinit = jcommon.init_state

    def init_state(spec, p0):                   # the JAX run's first key
        st = jinit(spec, p0)
        jkey.append(st.key)
        return st

    monkeypatch.setattr(jcommon, "init_state", init_state)
    jout = jcommon.run_dp_pasgd(jcase, tau=10, c_th=1000.0, eps_th=10.0)

    def jax_noise(key, params, tau):
        noise = jax_round_noise(jkey[0], params0, jcase.fed.n_clients, tau)
        jkey[0] = jax.random.split(jkey[0])[0]            # state.py:258
        return noise, key

    monkeypatch.setattr(tstate, "draw_round_noise", jax_noise)
    tout = tcommon.run_dp_pasgd(tcase, tau=10, c_th=1000.0, eps_th=10.0)
    assert tout["rounds"] == jout["rounds"] > 0
    assert tout["max_epsilon"] == jout["max_epsilon"] <= 10.0
    assert tout["resource_spent"] == jout["resource_spent"]
    assert (tout["sigma"], tout["k_planned"]) == \
        (jout["sigma"], jout["k_planned"])
    assert [h["round"] for h in tout["history"]] == \
        [h["round"] for h in jout["history"]]
    jp = jax.tree.map(np.asarray, jfinal[0].params)
    tp = tree_to_numpy(tfinal[0].params)
    for k in ("w", "b"):
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tfinal[0].rho, jfinal[0].rho)
    assert abs(tout["best"]["eval_acc"] - jout["best"]["eval_acc"]) <= 1e-3


def test_fig6_grid_equals_jax(tmp_path):
    jrows = jfig6.main(fast=True, out_json=str(tmp_path / "j.json"))
    trows = run_torch.SUITES["fig6"](fast=True,
                                     out_json=str(tmp_path / "t.json"),
                                     device="cpu")
    jgrid = json.loads((tmp_path / "j.json").read_text())["grid"]
    tgrid = json.loads((tmp_path / "t.json").read_text())["grid"]
    assert tgrid == jgrid and len(tgrid) == 25
    assert trows[0].split(",")[2] == jrows[0].split(",")[2]


def test_entry_points_default_to_cuda():
    import torch

    import benchmarks.attack_resilience_torch as attack
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcommon.make_cases(True)
    with pytest.raises(RuntimeError, match="CUDA"):
        attack.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_torch.SUITES["fig6"](fast=True)
    import benchmarks.serve_torch as serve_bench
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import SlotEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_bench.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "gemma3-4b", "--smoke"])
    model = Transformer(smoke_variant(get_arch("gemma3-4b")))
    with pytest.raises(RuntimeError, match="CUDA"):
        SlotEngine(model, model.init(device="cpu"), n_slots=2, max_len=8)
