"""The port's public facade (``repro_torch.api``) against the JAX package's.

The spec's validation, the sigma design, the rho ledger, the budget probes
and the stopping round are host math and must match ``repro.api`` exactly;
the port's own noise stream is held by its distribution, and its chunked
driver by bitwise equality with the per-round one.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.data import adult_like, split_by_group
from repro.models import linear as jlin
from repro.optim import sgd as jsgd
from repro_torch.core.clipping import make_dp_grad_fn
from repro_torch.core.fl import draw_round_noise
from repro_torch.models import linear as tlin
from repro_torch.optim import sgd as tsgd
from repro_torch.utils.convert import tree_to_numpy

C, TAU, DIM, B = 4, 3, 6, 4


def _kw(**kw):
    base = dict(n_clients=C, tau=TAU, clip_norm=1.0, sigmas=(0.5,) * C,
                batch_sizes=(B,) * C)
    base.update(kw)
    return base


def _tspec(**kw):
    return tapi.FederationSpec(loss_fn=tlin.logreg_loss, optimizer=tsgd(0.2),
                               **_kw(**kw))


def _jspec(**kw):
    return japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=jsgd(0.2),
                               kernel_backend="ref", **_kw(**kw))


def _cpu_state(spec):
    return tapi.init_state(spec, tlin.init_linear(DIM, device="cpu"),
                           device="cpu")


# -------------------------------- spec --------------------------------------

@pytest.mark.parametrize("bad", [
    dict(n_clients=0), dict(tau=0), dict(topology="ring"),
    dict(engine="pmap"), dict(compressor="zip"), dict(compression_ratio=0.0),
    dict(participation=0.0), dict(participation=True),
    dict(aggregator="mode"), dict(trim_fraction=0.5), dict(attack="noise"),
    dict(secure_frac_bits=30), dict(dp_accounting="central"),
    dict(buffer_size=2), dict(staleness_alpha=0.5),
    dict(engine="vmap", mesh_shape=(1, 1)), dict(cohort_size=2),
    dict(sigmas=(0.5,) * 3), dict(batch_sizes=(B,) * 5),
])
def test_spec_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        _jspec(**bad)
    with pytest.raises(ValueError):
        _tspec(**bad)


@pytest.mark.parametrize("plane,item", [
    (dict(engine="shard_map"), "item 12c"), (dict(engine="mesh_2d"), "item 12d"),
])
def test_unported_planes_raise_naming_their_roadmap_item(plane, item):
    """The sharded engines build, in the port as in the JAX package (a
    world of one here), and a model axis over 1 needs more ranks than that.
    Items 12c and 12d are ported: an RWKV model's placement resolves,
    ``bonus_u`` on its heads, and a weight split over the serving mesh's
    data axis too resolves (its hint's model dim is the one the layer
    body splits), where the port once raised naming item 12d."""
    import types

    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import sharding
    from repro_torch.models.transformer import Transformer
    _jspec(**plane)
    assert callable(tapi.round_fn_for(_tspec(**plane)))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tapi.round_fn_for(_tspec(engine="mesh_2d", mesh_shape=(2, 2)))
    if item == "item 12c":
        model = Transformer(smoke_variant(get_arch("rwkv6-1.6b")))
        dims = sharding.param_split_dims(model.init(device="meta"), 2)
        mixer = dims["segments"][0]["0"]["mixer"]
        assert mixer["bonus_u"] == 1 and mixer["ln_scale"] == -1  # step, heads
        return
    x = torch.ones(4, 6)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    with sharding.axis_rules(mesh, sharding.serve_rules(True)):
        assert sharding.shard_hint(x, "fsdp", "tp") is x
        assert sharding.model_dim("fsdp", "tp") == 1


def test_async_spec_is_accepted_and_keyed_like_jax():
    """engine="async_buffered" builds in the port as in the JAX package:
    buffer_size defaults to n_clients, and the engine key tells buffer
    sizes apart but not staleness_alpha."""
    for make in (_jspec, _tspec):
        spec = make(engine="async_buffered")
        assert spec.is_async() and not make().is_async()
        assert spec.buffer_size == spec.resolved_buffer_size() == C
        half = spec.replace(buffer_size=2)
        assert half.resolved_buffer_size() == 2
        assert half.engine_key() != spec.engine_key()
        assert half.replace(staleness_alpha=0.5).engine_key() == \
            half.engine_key()
        assert make().resolved_buffer_size() == C
    with pytest.raises(ValueError, match="buffer_size"):
        _tspec(engine="async_buffered", buffer_size=C + 1)


@pytest.mark.parametrize("plane", [
    dict(secure_agg=True), dict(aggregator="median"),
    dict(attack="sign_flip", byzantine_fraction=0.25),
], ids=["secure", "median", "signflip"])
def test_trust_plane_builds_the_pipeline_jax_builds(plane):
    """The specs the port refused until the trust plane came: the same
    pipeline fields, participant count, byzantine flags and engine-key
    membership as the JAX package's."""
    js, ts = _jspec(**plane), _tspec(**plane)
    jp, tp = js.aggregation_pipeline(), ts.aggregation_pipeline()
    assert ts.has_pipeline() and ts.is_adversarial()
    assert tp.n_participants == jp.n_participants == C
    assert tp.compressor is jp.compressor is None
    for field in ("aggregator", "secure", "attack"):
        t, j = getattr(tp, field), getattr(jp, field)
        assert (t is None) == (j is None), field
        if t is not None:
            assert type(t).__name__ == type(j).__name__
            assert vars(t) == {k: v for k, v in vars(j).items()
                               if not k.startswith("_")}
    assert ts.resolved_byzantine_flags() == js.resolved_byzantine_flags()
    plain = _tspec()
    assert ts.engine_key() != plain.engine_key()
    assert (ts.replace(eps_th=9.0).engine_key() == ts.engine_key())
    key = ts.engine_key()
    for field in ("aggregator", "secure_agg", "attack"):
        if field in plane:
            assert plane[field] in key
    if ts.attack != "none":
        assert ts.resolved_byzantine_flags() in key
    if ts.aggregator != "mean":
        assert ts.participants_per_round() in key


def test_kernel_backend_takes_auto_or_ref():
    assert _tspec(kernel_backend="ref").kernel_backend == "ref"
    for bad in ("pallas", "interpret", "cuda"):
        with pytest.raises(ValueError):
            _tspec(kernel_backend=bad)


@pytest.mark.parametrize("pipe", [
    {}, dict(participation=0.5), dict(participation=1),
    dict(compressor="topk", compression_ratio=0.25),
    dict(compressor="randk", compression_ratio=0.3, participation=0.75),
    dict(compressor="qsgd", compression_bits=4, participation=3),
], ids=["dense", "q50", "q1client", "topk25", "randk30-q75", "qsgd4-p3"])
def test_spec_views_match_jax(pipe):
    kw = dict(sigmas=None, dp=True, eps_th=2.0, total_steps=120, c1=50.0,
              c2=2.0, batch_sizes=(4, 8, 16, 32), **pipe)
    js, ts = _jspec(**kw), _tspec(**kw)
    assert ts.has_pipeline() == js.has_pipeline() == bool(pipe)
    assert ts.participants_per_round() == js.participants_per_round()
    assert ts.participation_fraction() == js.participation_fraction()
    assert ts.wire_ratio() == js.wire_ratio()
    assert ts.comm_scale() == js.comm_scale()
    assert ts.round_cost() == js.round_cost()
    assert ts.resolved_sigmas().dtype == np.float32
    np.testing.assert_array_equal(ts.resolved_sigmas(), js.resolved_sigmas())
    assert ts.ledger_key() == js.ledger_key()
    assert ts.accounting_q() == js.accounting_q()
    assert (ts.replace(amplify_participation=True).accounting_q()
            == js.replace(amplify_participation=True).accounting_q())
    assert ts.replace(eps_th=9.0).engine_key() == ts.engine_key()
    assert (ts.replace(kernel_backend="ref").engine_key()
            != ts.engine_key())
    assert (ts.replace(amplify_participation=True).engine_key()
            == ts.engine_key())
    assert (ts.replace(compressor="qsgd").engine_key() != ts.engine_key()
            or ts.compressor == "qsgd")
    assert tapi.resolve_engine(ts) == "vmap"
    assert tapi.resolve_engine(ts.replace(engine="map")) == "map"


# ---------------------------- device and noise -------------------------------

def test_init_state_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the guard fires only where no GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_state(_tspec(), jlin.init_linear(DIM))


def test_init_state_replicates_jax_params_and_state():
    js = japi.init_state(_jspec(), jlin.init_linear(DIM))
    ts = tapi.init_state(_tspec(), jax.tree.map(np.asarray,
                                                jlin.init_linear(DIM)),
                         device="cpu")
    for a, b in zip(jax.tree.leaves((js.params, js.opt_state)),
                    jax.tree.leaves(tree_to_numpy((ts.params,
                                                   ts.opt_state)))):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_noise_draw_distribution():
    """The applied noise of a zero gradient is sigma * N(0, 1) per row:
    mean ~ 0 and variance ~ sigma^2."""
    sigmas = torch.tensor([0.5, 2.0])
    params = {"w": torch.zeros((2, 40_000))}
    key = torch.tensor([3, 0])
    noise, next_key = draw_round_noise(key, params, tau=2)
    assert noise.shape == (2, 2, 40_000) and noise.dtype == torch.float32
    assert not torch.equal(next_key, key)
    dp_grad = make_dp_grad_fn(lambda p, b: torch.sum(p["w"] * 0.0), 1.0)
    noisy, _ = dp_grad(params, {"x": torch.zeros((2, 1))}, noise[:, 0],
                       sigmas)
    for r, s in enumerate(sigmas.tolist()):
        row = noisy["w"][r].double()
        assert abs(float(row.mean())) < 4 * s / 200
        assert float(row.var()) == pytest.approx(s * s, rel=0.03)


def test_same_key_same_noise_and_rounds_differ():
    state = _cpu_state(_tspec())
    a, _ = draw_round_noise(state.key, state.params, TAU)
    b, key = draw_round_noise(state.key, state.params, TAU)
    c, _ = draw_round_noise(key, state.params, TAU)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------ chunking -------------------------------------

def _fed():
    return split_by_group(adult_like(n=1500, dim=DIM, seed=2))


def test_run_rounds_equals_run_round_bitwise():
    fed = _fed()
    n = fed.n_clients
    spec = _tspec(n_clients=n, sigmas=(0.7,) * n, batch_sizes=(B,) * n)
    batches = tapi.round_batches(spec, fed.make_sampler(B),
                                 np.random.default_rng(0), 3)
    s1 = _cpu_state(spec)
    recs1 = []
    for r in range(3):
        s1, rec = tapi.run_round(spec, s1,
                                 jax.tree.map(lambda x: x[r], batches))
        recs1.append(tapi.materialize_record(rec))
    s2, recs2 = tapi.run_rounds(spec, _cpu_state(spec), batches)
    for a, b in zip(jax.tree.leaves(tree_to_numpy((s1.params, s1.opt_state))),
                    jax.tree.leaves(tree_to_numpy((s2.params,
                                                   s2.opt_state)))):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(s1.key, s2.key)
    np.testing.assert_array_equal(s1.rho, s2.rho)
    assert (s1.steps, s1.resource_spent, s1.rounds_done) == \
        (s2.steps, s2.resource_spent, s2.rounds_done)
    assert recs1 == [tapi.materialize_record(r) for r in recs2]


def test_prefetch_failure_keeps_the_chunk():
    fed = _fed()
    n = fed.n_clients
    spec = _tspec(n_clients=n, sigmas=(0.7,) * n, batch_sizes=(B,) * n)
    batches = tapi.round_batches(spec, fed.make_sampler(B),
                                 np.random.default_rng(0), 2)

    def boom():
        raise OSError("sampler down")

    with pytest.raises(tapi.PrefetchFailed) as info:
        tapi.run_rounds(spec, _cpu_state(spec), batches, prefetch=boom)
    assert info.value.state.rounds_done == 2 and len(info.value.records) == 2
    assert isinstance(info.value.__cause__, OSError)


# --------------------------- budgets and train --------------------------------

def _train_specs(fed, **kw):
    n = fed.n_clients
    common = dict(n_clients=n, tau=2, clip_norm=1.0, dp=True,
                  sigmas=tuple(float(s) for s in np.linspace(4.0, 8.0, n)),
                  batch_sizes=tuple(fed.batch_sizes(B)), eps_th=3.0,
                  delta=1e-4, c_th=2000.0)
    common.update(kw)
    return (japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=jsgd(0.3),
                                kernel_backend="ref", **common),
            tapi.FederationSpec(loss_fn=tlin.logreg_loss,
                                optimizer=tsgd(0.3), **common))


@pytest.mark.parametrize("binding", ["privacy", "resource"])
def test_train_stops_where_jax_stops(binding):
    fed = _fed()
    kw = {} if binding == "privacy" else dict(c_th=615.0)
    jspec, tspec = _train_specs(fed, **kw)
    xt, yt = fed.eval_arrays("test")
    js, jout = japi.train(jspec, japi.init_state(jspec, jlin.init_linear(DIM)),
                          fed.make_sampler(B),
                          eval_fn=jlin.make_eval_fn(jlin.logreg_loss, xt, yt))
    ts, tout = tapi.train(tspec, _cpu_state(tspec), fed.make_sampler(B),
                          eval_fn=tlin.make_eval_fn(tlin.logreg_loss, xt, yt))
    assert jout["rounds"] == tout["rounds"] > 0
    assert japi.exceeds_budgets(jspec, js) == \
        tapi.exceeds_budgets(tspec, ts) == binding
    assert tout["max_epsilon"] == jout["max_epsilon"]
    assert tout["resource_spent"] == jout["resource_spent"]
    for jr, tr in zip(jout["history"], tout["history"]):
        for k in ("round", "iterations", "max_epsilon", "resource_spent",
                  "participants"):
            assert tr[k] == jr[k]
    np.testing.assert_array_equal(ts.rho, js.rho)
    assert tout["max_epsilon"] <= 3.0
    for probe in (1, TAU, 10):
        assert (tapi.peek_epsilon_fast(tspec, ts, probe)
                == japi.peek_epsilon_fast(jspec, js, probe))
    assert (tapi.rounds_within_budgets(tspec, _cpu_state(tspec), 500)
            == japi.rounds_within_budgets(
                jspec, japi.init_state(jspec, jlin.init_linear(DIM)), 500))


def test_full_width_adult_train_matches_jax(monkeypatch):
    """The main path at full width: adult_like() defaults split by group
    (16 clients, d = 104), the quickstart's design constants with
    dim = 2d + 2, trained until a budget binds in both packages with JAX's
    noise fed to the port. The stopping round, the ledger and the best
    model's eval loss and accuracy agree. Both packages end at the test
    set's majority-class rate: the design stops after a few steps, so the
    reference itself gives no accuracy above it at this width."""
    from repro.core.convergence import ProblemConstants
    from repro.core.design import DesignProblem, ResourceModel
    from test_torch_fl import jax_round_noise

    import repro_torch.api.state as tstate

    lr, batch = 0.3, 32
    fed = split_by_group(adult_like())
    dim = fed.clients[0].x_train.shape[1]
    sol = DesignProblem(
        consts=ProblemConstants(eta=lr, lam=0.1, lip=0.3, alpha=0.8,
                                xi2=0.05, dim=2 * dim + 2,
                                n_clients=fed.n_clients),
        resource=ResourceModel(c1=100.0, c2=1.0), clip_norm=1.0,
        batch_sizes=fed.batch_sizes(batch), delta=1e-4, eps_th=4.0,
        c_th=1000.0).solve()
    common = dict(n_clients=fed.n_clients, tau=sol.tau, clip_norm=1.0,
                  dp=True, sigmas=tuple(float(s) for s in sol.sigmas),
                  batch_sizes=tuple(fed.batch_sizes(batch)), eps_th=4.0,
                  delta=1e-4, c_th=1000.0)
    jspec = japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=jsgd(lr),
                                kernel_backend="ref", **common)
    tspec = tapi.FederationSpec(loss_fn=tlin.logreg_loss,
                                optimizer=tsgd(lr), **common)
    xt, yt = fed.eval_arrays("test")
    params0 = jlin.init_linear(dim)
    js0 = japi.init_state(jspec, params0)
    jkey = [js0.key]

    def jax_noise(key, params, tau):
        noise = jax_round_noise(jkey[0], params0, fed.n_clients, tau)
        jkey[0] = jax.random.split(jkey[0])[0]            # state.py:258
        return noise, key

    monkeypatch.setattr(tstate, "draw_round_noise", jax_noise)
    js, jout = japi.train(jspec, js0, fed.make_sampler(batch),
                          eval_fn=jlin.make_eval_fn(jlin.logreg_loss, xt, yt))
    ts, tout = tapi.train(
        tspec, tapi.init_state(tspec, tlin.init_linear(dim, device="cpu"),
                               device="cpu"),
        fed.make_sampler(batch),
        eval_fn=tlin.make_eval_fn(tlin.logreg_loss, xt, yt))
    assert tout["rounds"] == jout["rounds"] > 0
    assert tout["max_epsilon"] == jout["max_epsilon"] <= 4.0
    assert tout["resource_spent"] == jout["resource_spent"]
    jb, tb = jout["best"], tout["best"]
    assert tb["round"] == jb["round"]
    assert abs(tb["eval_loss"] - jb["eval_loss"]) <= 1e-5
    assert abs(tb["eval_acc"] - jb["eval_acc"]) <= 1e-5
    init_loss = jlin.make_eval_fn(jlin.logreg_loss, xt, yt)(
        params0)["eval_loss"]
    assert jb["eval_loss"] < init_loss
    majority = max(float(np.mean(yt)), 1.0 - float(np.mean(yt)))
    assert abs(jb["eval_acc"] - majority) <= 1e-6


def test_chunked_train_equals_per_round_train():
    fed = _fed()
    _, tspec = _train_specs(fed)
    runs = []
    for chunk in (1, 3):
        state, out = tapi.train(tspec, _cpu_state(tspec), fed.make_sampler(B),
                                chunk_rounds=chunk)
        runs.append((tree_to_numpy(state.params), out))
    (p1, o1), (p3, o3) = runs
    assert o1["rounds"] == o3["rounds"]
    for k in ("w", "b"):
        np.testing.assert_array_equal(p1[k], p3[k])
    assert [r["max_epsilon"] for r in o1["history"]] == \
        [r["max_epsilon"] for r in o3["history"]]
    assert [r["loss"] for r in o1["history"]] == \
        [r["loss"] for r in o3["history"]]


def test_run_round_raises_before_a_budget_breaks():
    _, tspec = _train_specs(_fed(), c_th=10.0)
    state = _cpu_state(tspec)
    with pytest.raises(tapi.BudgetExceeded) as info:
        tapi.run_round(tspec, state, None)
    assert info.value.which == "resource"


def test_eval_params_per_topology():
    spec = _tspec(topology="local_only")
    state = _cpu_state(spec)
    w = torch.arange(C * DIM * 2, dtype=torch.float32).reshape(C, DIM, 2)
    state = state.replace(params={"w": w, "b": torch.zeros((C, 2))})
    np.testing.assert_array_equal(
        tapi.eval_params(spec, state)["w"].numpy(), w.mean(0).numpy())
    np.testing.assert_array_equal(
        tapi.collapse_clients(state.params, "full_average")["w"].numpy(),
        w[0].numpy())
