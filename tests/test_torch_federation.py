"""The port's last public API names against the JAX package's, on the CPU:
``Federation`` (with ``Budgets``, ``FederationSpec.budgets()`` and
``checkpoint.save_federation_state`` / ``load_federation_state``),
``api.sigmas_for``, the round-engine registry, ``core.adaptive`` and
``benchmarks/throughput_torch.py``.

- ``Federation`` with JAX's noise injected (``test_torch_fl.jax_round_noise``
  replays the JAX Federation's key schedule): the stopping round, the cost
  and epsilon exactly, the params within 1e-5 (tests/test_fl_engine.py:
  120-170, tests/test_api.py:280).
- A checkpoint written mid-training resumes to the uninterrupted run's
  params bit for bit.
- The registry (tests/test_api.py:80-89), the sigma cache
  (tests/test_fused_rounds.py:267) and the ``AdaptiveDesigner`` plans
  (tests/test_extensions.py:55-88) exactly.
- ``throughput_torch.py --smoke --device cpu`` in-process at two rounds a
  scenario: every row, and the ``--check`` gates that read no clock.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import os
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_fl import jax_round_noise

import repro.api as japi
from repro.core.adaptive import AdaptiveDesigner as JDesigner
from repro.core.convergence import ProblemConstants as JConsts
from repro.core.design import DesignProblem as JProblem
from repro.core.design import ResourceModel as JResource
from repro.core.fl import Budgets as JBudgets
from repro.core.fl import FLConfig as JConfig
from repro.core.privacy import PrivacyAccountant as JAccountant
from repro.data import adult_like, split_iid
from repro.models import linear as jlin
from repro.optim import sgd as jsgd

import repro_torch.api as tapi
import repro_torch.api.state as tstate
from repro_torch.checkpoint import (
    load_federation_state,
    save_federation_state,
)
from repro_torch.core.adaptive import AdaptiveDesigner
from repro_torch.core.convergence import ProblemConstants
from repro_torch.core.design import DesignProblem, ResourceModel
from repro_torch.core.fl import Budgets, FLConfig
from repro_torch.core.privacy import PrivacyAccountant
from repro_torch.models import linear as tlin
from repro_torch.optim import sgd as tsgd

C, DIM = 4, 12


def _fed():
    return split_iid(adult_like(n=600, dim=DIM, seed=0), C, seed=0)


def _pair(fed, sigma, batch, tau=5, x=None):
    """The JAX and the port's Federation on the same data, sigmas and
    batch sizes (the port's on the CPU)."""
    sig = np.full((C,), sigma, np.float32)
    sizes = fed.batch_sizes(batch) if x is None else [x] * C
    kw = dict(sampler=fed.make_sampler(batch), sigmas=sig, batch_sizes=sizes)
    jf = japi.Federation(cfg=JConfig(n_clients=C, tau=tau, clip_norm=1.0,
                                     dp=True),
                         loss_fn=jlin.logreg_loss, optimizer=jsgd(0.2),
                         params0=jlin.init_linear(DIM), **kw)
    tf = tapi.Federation(cfg=FLConfig(n_clients=C, tau=tau, clip_norm=1.0,
                                      dp=True),
                         loss_fn=tlin.logreg_loss, optimizer=tsgd(0.2),
                         params0=tlin.init_linear(DIM, device="cpu"),
                         device="cpu", **kw)
    return jf, tf


def _inject(monkeypatch, jf):
    """Feed the port the noise the JAX Federation's rounds draw: its key
    schedule from its current key (api/state.py: one split a round)."""
    jkey = [jf.state.key]
    params0 = jlin.init_linear(DIM)

    def jax_noise(key, params, tau):
        noise = jax_round_noise(jkey[0], params0, C, tau)
        jkey[0] = jax.random.split(jkey[0])[0]
        return noise, key

    monkeypatch.setattr(tstate, "draw_round_noise", jax_noise)


def _params_gap(jp, tp) -> float:
    return max(float(np.max(np.abs(np.asarray(jp[k], np.float64)
                                   - tp[k].numpy()))) for k in jp)


@pytest.mark.parametrize("binding", ["resource", "privacy"])
def test_federation_train_matches_jax_with_its_draws(binding, monkeypatch):
    """tests/test_fl_engine.py:123-147: 105 a round stops at exactly 4
    rounds in 420; a 0.5 eps budget stops the privacy way (at sigma 4 and
    X 16, after 2 rounds: the JAX test's sigma 0.05 binds before the
    first)."""
    fed = _fed()
    if binding == "resource":
        jf, tf = _pair(fed, 1.0, 16)
        budgets = dict(c_th=420.0, eps_th=1e9, c1=100.0, c2=1.0)
    else:
        jf, tf = _pair(fed, 4.0, 16, x=16)
        budgets = dict(c_th=1e9, eps_th=0.5)
    _inject(monkeypatch, jf)
    jout = jf.train(JBudgets(**budgets), max_rounds=100)
    tout = tf.train(Budgets(**budgets), max_rounds=100)
    assert tout["rounds"] == jout["rounds"] > 0
    assert tout["resource_spent"] == jout["resource_spent"]
    assert tout["max_epsilon"] == jout["max_epsilon"]
    if binding == "resource":
        assert tout["rounds"] == 4 and tout["resource_spent"] == 420.0
    else:
        assert tout["max_epsilon"] <= 0.5 and tout["rounds"] == 2
    assert tf.rounds_done == jf.rounds_done
    assert tf.accountant.max_epsilon() == jf.accountant.max_epsilon()
    assert [r["round"] for r in tf.history] == [r["round"]
                                                for r in jf.history]
    assert _params_gap(jf.params, tf.params) <= 1e-5
    assert tf.round_cost(Budgets(**budgets)) == jf.round_cost(
        JBudgets(**budgets))


def test_federation_round_is_thin_over_run_round(monkeypatch):
    """tests/test_api.py:280: one unconditional round; the Eq.-8 cost is
    rolled back; the loss, params and accountant as JAX's."""
    jf, tf = _pair(_fed(), 0.5, 8, tau=3)
    _inject(monkeypatch, jf)
    jrec, trec = jf.round(), tf.round()
    assert tf.rounds_done == 1 and tf.history == [trec]
    assert trec["resource_spent"] == jrec["resource_spent"] == 0.0
    assert tf.resource_spent == 0.0
    assert abs(trec["loss"] - jrec["loss"]) <= 1e-5
    assert trec["max_epsilon"] == jrec["max_epsilon"]
    assert tf.accountant.max_epsilon() == jf.accountant.max_epsilon()
    assert _params_gap(jf.params, tf.params) <= 1e-5
    tf.params = {k: v + 1.0 for k, v in tf.params.items()}
    assert tf.state.params is tf.params


def test_budgets_and_the_spec_view_equal_jax():
    assert Budgets() == Budgets(c_th=float("inf"), eps_th=float("inf"),
                                c1=100.0, c2=1.0)
    assert vars(Budgets()) == vars(JBudgets())
    kw = dict(n_clients=C, tau=2, sigmas=(0.5,) * C, batch_sizes=(8,) * C,
              c_th=321.0, eps_th=2.5, c1=7.0, c2=3.0)
    t = tapi.FederationSpec(loss_fn=tlin.logreg_loss, optimizer=tsgd(0.1),
                            **kw).budgets()
    j = japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=jsgd(0.1),
                            **kw).budgets()
    assert isinstance(t, Budgets) and vars(t) == vars(j)


def test_federation_checkpoint_resumes_bitwise(tmp_path):
    """A Federation saved after 2 rounds and loaded into a fresh one
    continues to the uninterrupted run's params bit for bit (the numpy
    batch stream is the caller's, as in the JAX package, so its state is
    handed across)."""
    fed = _fed()
    budgets = Budgets(c_th=1e9, eps_th=1e9)
    _, full = _pair(fed, 0.5, 8, tau=2)
    full.train(budgets, max_rounds=2)
    save_federation_state(str(tmp_path), full)
    rng_state = full._rng.bit_generator.state
    full.train(budgets, max_rounds=4)

    _, resumed = _pair(fed, 0.5, 8, tau=2)
    load_federation_state(str(tmp_path), resumed)
    assert resumed.rounds_done == 2 and len(resumed.history) == 2
    assert resumed.accountant.steps == 4
    resumed._rng.bit_generator.state = rng_state
    resumed.train(budgets, max_rounds=4)
    assert resumed.rounds_done == full.rounds_done == 4
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k]), k
    assert resumed.accountant.max_epsilon() == full.accountant.max_epsilon()
    assert [r["loss"] for r in resumed.history] == [r["loss"]
                                                    for r in full.history]


def test_sigmas_for_is_cached_per_ledger_key():
    """tests/test_fused_rounds.py:267: budget edits reuse the device sigma
    vector, mechanism edits repopulate it; it lives on the asked device."""
    spec = tapi.FederationSpec(n_clients=C, tau=2, loss_fn=tlin.logreg_loss,
                               optimizer=tsgd(0.1), sigmas=(0.5,) * C,
                               batch_sizes=(8,) * C)
    s = tapi.sigmas_for(spec, "cpu")
    assert s.device.type == "cpu" and s.dtype == torch.float32
    assert torch.equal(s, torch.full((C,), 0.5))
    assert tapi.sigmas_for(spec, "cpu") is s
    assert tapi.sigmas_for(spec.replace(eps_th=3.0, c_th=9.0), "cpu") is s
    assert tapi.sigmas_for(spec.replace(sigmas=(0.7,) * C), "cpu") is not s
    assert spec.ledger_key() is spec.ledger_key()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.sigmas_for(spec)


def test_engine_registry():
    """tests/test_api.py:80-89: the port registers every engine the JAX
    package does, the sharded ones included."""
    assert set(tapi.available_engines()) == {
        "vmap", "map", "shard_map", "mesh_2d", "async_buffered"}
    with pytest.raises(KeyError):
        tapi.get_engine("nope")
    from repro_torch.api import engines
    assert tapi.get_engine("shard_map") is engines.build_shard_map_engine
    with pytest.raises(ValueError, match="FederationSpec"):
        tapi.get_engine("auto")
    sharded = tapi.FederationSpec(n_clients=C, tau=1,
                                  loss_fn=tlin.logreg_loss,
                                  optimizer=tsgd(0.1), engine="shard_map")
    assert tapi.get_engine(sharded) is engines.build_shard_map_engine
    try:
        @tapi.register_engine("_test_engine")
        def _builder(spec):
            return tapi.get_engine("vmap")(spec)

        assert tapi.get_engine("_test_engine") is _builder
        tapi.register_engine("_test_direct", _builder)
        assert tapi.get_engine("_test_direct") is _builder
    finally:
        engines._REGISTRY.pop("_test_engine", None)
        engines._REGISTRY.pop("_test_direct", None)
    spec = tapi.FederationSpec(n_clients=C, tau=1, loss_fn=tlin.logreg_loss,
                               optimizer=tsgd(0.1), sigmas=(0.5,) * C,
                               batch_sizes=(8,) * C)
    assert tapi.get_engine(spec) is engines.build_vmap_engine
    assert tapi.get_engine(spec.replace(engine="map")) is \
        engines.build_map_engine
    assert tapi.get_engine(spec.replace(engine="mesh_2d")) is \
        engines.build_mesh_2d_engine


def test_replica_hint_places_engine_auto(monkeypatch):
    """A replica that fits the device resolves engine='auto' to vmap on one
    rank; one over the budget resolves to mesh_2d, whose build raises
    ValueError saying how many ranks the replica needs (a world of one
    cannot split it);
    REPRO_DEVICE_MEM_BYTES overrides the budget, as in the JAX package."""
    from repro_torch.api import engines
    monkeypatch.delenv(engines.ENV_DEVICE_MEM, raising=False)
    spec = tapi.FederationSpec(n_clients=C, tau=1, loss_fn=tlin.logreg_loss,
                               optimizer=tsgd(0.1), replica_bytes=4096)
    assert tapi.resolve_engine(spec) == "vmap"
    if not torch.cuda.is_available():
        assert engines.device_memory_budget() == engines.H100_MEM_BYTES
    assert engines.device_memory_budget(default=123) == 123
    monkeypatch.setenv(engines.ENV_DEVICE_MEM, "4096")
    assert engines.replica_fits(4096) and not engines.replica_fits(4097)
    assert tapi.resolve_engine(spec) == "vmap"
    big = spec.replace(replica_bytes=4097)
    assert tapi.resolve_engine(big) == "mesh_2d"
    assert tapi.get_engine(big) is engines.build_mesh_2d_engine
    with pytest.raises(ValueError, match="needs a model axis of at least 2 "
                                         "ranks to split it; the world has "
                                         "1 rank"):
        tapi.round_fn_for(big)
    assert tapi.resolve_engine(spec.replace(replica_bytes=4097,
                                            engine="map")) == "map"
    monkeypatch.setenv(engines.ENV_DEVICE_MEM, "0")
    with pytest.raises(ValueError):
        engines.device_memory_budget()


def _problems(eps_th=4.0, c_th=1000.0):
    kw = dict(eta=0.05, lam=0.3, lip=1.5, alpha=2.0, xi2=0.4, dim=50,
              n_clients=4)
    common = dict(clip_norm=1.0, batch_sizes=[32] * 4, delta=1e-4,
                  eps_th=eps_th, c_th=c_th)
    return (DesignProblem(consts=ProblemConstants(**kw),
                          resource=ResourceModel(100.0, 1.0), **common),
            JProblem(consts=JConsts(**kw), resource=JResource(100.0, 1.0),
                     **common))


def _accountants():
    t, j = (PrivacyAccountant(clip_norm=1.0, delta=1e-4),
            JAccountant(clip_norm=1.0, delta=1e-4))
    for m in range(4):
        t.register_client(m, 32, 1.0)
        j.register_client(m, 32, 1.0)
    return t, j


def _same_plan(a, b):
    assert (a.phase, a.remaining_eps_equiv, a.remaining_c) == (
        b.phase, b.remaining_eps_equiv, b.remaining_c)
    sa, sb = a.solution, b.solution
    assert (sa.k, sa.tau, sa.predicted_bound, sa.cost) == (
        sb.k, sb.tau, sb.predicted_bound, sb.cost)
    assert np.array_equal(np.asarray(sa.sigmas), np.asarray(sb.sigmas))


def test_adaptive_designer_never_exceeds_eps_as_jax():
    """tests/test_extensions.py:55-76 in both packages side by side: every
    phase's plan is JAX's exactly, and the total eps stays in budget."""
    tprob, jprob = _problems()
    td, jd = AdaptiveDesigner(tprob), JDesigner(jprob)
    tacc, jacc = _accountants()
    spent = 0.0
    for _ in range(4):
        tplan, jplan = td.replan(tacc, spent), jd.replan(jacc, spent)
        _same_plan(tplan, jplan)
        sol = tplan.solution
        if tplan.remaining_c < 101 or tplan.remaining_eps_equiv < 1e-3:
            break
        steps = max(sol.tau, (sol.k // 4) // sol.tau * sol.tau)
        for m in range(4):
            tacc.sigmas[m] = float(sol.sigmas[m])
            jacc.sigmas[m] = float(jplan.solution.sigmas[m])
        tacc.step(steps)
        jacc.step(steps)
        spent += steps / sol.tau * 100.0 + steps * 1.0
    assert tacc.max_epsilon() == jacc.max_epsilon()
    assert tacc.max_epsilon() <= tprob.eps_th * (1 + 1e-6)


def test_adaptive_designer_uses_observed_constants_as_jax():
    """tests/test_extensions.py:79-88: a smaller observed gap favors fewer
    iterations, in both packages alike."""
    tprob, jprob = _problems()
    td, jd = AdaptiveDesigner(tprob), JDesigner(jprob)
    tacc, jacc = _accountants()
    _same_plan(td.replan(tacc, 0.0), jd.replan(jacc, 0.0))
    obs = {"alpha": 0.01, "xi2": 0.2}
    p2, j2 = td.replan(tacc, 0.0, observed=obs), jd.replan(jacc, 0.0,
                                                           observed=obs)
    _same_plan(p2, j2)
    assert p2.solution.k <= td.replan(tacc, 0.0).solution.k


def test_throughput_smoke_runs_in_process_on_the_cpu(tmp_path):
    """benchmarks/throughput_torch.py --smoke --device cpu at two rounds a
    scenario: every scenario's rows, the JAX grid's shape, the kernel
    rows equal to their plain versions, and --check's structural gates
    (bytes flat in M, 0 resident syncs, memory-bound kernels, async ahead
    in simulated seconds; the wall-clock ratios are the card's)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    import benchmarks.throughput_torch as tp
    out = tmp_path / "t.json"
    assert tp.main(["--smoke", "--device", "cpu", "--rounds", "2", "--out",
                    str(out)]) == 0
    import json
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and report["config"]["rounds"] == 2
    assert [(r["engine"], r["compressor"], r["chunk_rounds"])
            for r in report["results"]] == [
        ("vmap", "none", 1), ("vmap", "none", 8), ("vmap", "topk", 1),
        ("vmap", "topk", 8)]
    assert set(report["speedup_fused_vs_per_round"]) == {
        "vmap/none/q1.0", "vmap/topk/q0.5"}
    assert [r["population"] for r in report["cohort_scaling"]] == [
        1_000, 100_000]
    assert report["resident_cohort"]["resident"]["host_syncs_per_round"] \
        == 0
    rows = report["kernel_roofline"]["rows"]
    assert [(r["kernel"], r["backend"]) for r in rows] == [
        (k, b) for k in ("quantize_decompress", "cohort_gather_scatter",
                         "dp_clip_noise") for b in ("kernel", "plain")]
    assert all(r["matches_plain"] and r["h100_bottleneck"] == "memory"
               for r in rows)
    assert rows[0]["hbm_bytes"] == 4 * (3 * 65536 + 1)
    assert report["mesh_plane"]["skipped"]
    assert report["mesh_plane"]["reason"] == \
        "needs 8 ranks for the (4,2) mesh, have 1"
    assert tp.check(report, timing=False) == []
    with pytest.raises(SystemExit):
        tp.main(["--out", "BENCH_throughput.json", "--device", "cpu"])
