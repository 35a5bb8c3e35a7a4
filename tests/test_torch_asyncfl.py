"""The port's buffered-async plane (``repro_torch.asyncfl``) against the JAX
package's (``repro.asyncfl``).

The clocks and the event schedule are numpy copies and must give the JAX
package's draws and pops exactly. The engine draws each dispatch's
randomness (the block's participation mask, its (b, tau, N) noise and the
compressor's ``agg_rand``) with ``repro_torch.core.fl.draw_dispatch``; the
tests replay the JAX executor's key schedule (asyncfl/engine.py:130-140,
165-180, 240-262, then the local rounds' noise as in
``test_torch_fl.jax_client_noise``) and inject it by patching
``repro_torch.asyncfl.engine.draw_dispatch``. Tolerances: global params and
optimizer state within 1e-5 (the port's parity policy, DP sums taken in
another order); the ledger, the costs, the schedule, the clock and the
staleness exactly. Inside the port the degenerate async engine equals the
sync ``vmap`` engine bit for bit, and the chunked driver and a resumed run
equal the per-cycle driver bit for bit.

On a GPU machine without jax, the ``gpu`` test alone runs:
``PYTHONPATH=src python3 -m pytest --noconftest -m gpu
tests/test_torch_asyncfl.py -q``.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import numpy as np
import pytest
import torch

try:        # the reference; absent where only the gpu test runs
    import jax
    import jax.numpy as jnp
    from test_torch_fl import jax_client_noise

    import repro.api as japi
    import repro.asyncfl as jasync
    from repro.asyncfl.engine import (
        block_participants as jblock_participants,
    )
    from repro.core import aggregation as jagg
    from repro.core.fl import pipeline_round_keys
    from repro.core.privacy import PrivacyAccountant as JAccountant
    from repro.models import linear as jlin
    from repro.optim import sgd as jsgd
    from repro.population.samplers import HeterogeneousCohort as JCohort
except ImportError:
    pass

import repro_torch.api as tapi
import repro_torch.asyncfl as tasync
import repro_torch.asyncfl.engine as tengine
import repro_torch.kernels.ops as tops
from repro_torch.core.privacy import PrivacyAccountant as TAccountant
from repro_torch.core.privacy import gaussian_zcdp, grad_sensitivity
from repro_torch.models import linear as tlin
from repro_torch.optim import momentum as tmomentum
from repro_torch.optim import sgd as tsgd
from repro_torch.population.samplers import HeterogeneousCohort as TCohort
from repro_torch.utils.convert import tree_to_numpy
from repro_torch.utils.tree import tree_leaves, tree_map

C, TAU, DIM, B = 4, 3, 8, 4
D = 2 * DIM + 2
SIGMA = 0.5

# every dispatch takes exactly 1.1 simulated seconds: the degenerate clock
# of the identity gate (all C uploads arrive together, the flush is a
# barrier)
FLAT = dict(compute=(1.0, 1.0), upload=(0.1, 0.1))


def _kw(**kw):
    base = dict(n_clients=C, tau=TAU, clip_norm=1.0, dp=True,
                sigmas=(SIGMA,) * C, batch_sizes=(B,) * C,
                engine="async_buffered")
    base.update(kw)
    return base


def _tspec(**kw):
    return tapi.FederationSpec(loss_fn=tlin.logreg_loss, optimizer=tsgd(0.2),
                               **_kw(**kw))


def _jspec(**kw):
    return japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=jsgd(0.2),
                               kernel_backend="ref", **_kw(**kw))


def _sampler(m, tau, rng):
    return {"x": rng.normal(size=(tau, B, DIM)).astype(np.float32),
            "y": rng.integers(0, 2, size=(tau, B)).astype(np.int32)}


def _fixed_sampler(m, tau, rng):
    """rng-free sampler (pure in the client id): resume tests replay the
    exact data stream without checkpointing a numpy Generator."""
    r = np.random.default_rng((7, int(m)))
    return {"x": r.normal(size=(tau, B, DIM)).astype(np.float32),
            "y": r.integers(0, 2, size=(tau, B)).astype(np.int32)}


def _tinit(spec, lat, sampler=_sampler, seed=0, **kw):
    return tasync.init_async_state(
        spec, tlin.init_linear(DIM, device="cpu"), sampler,
        rng=np.random.default_rng(seed), latency_model=lat, device="cpu",
        **kw)


def _bitwise(a, b):
    """Two trees of tensors equal bit for bit (signed zeros included)."""
    la, lb = tree_leaves(tree_to_numpy(a)), tree_leaves(tree_to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _close_to_jax(jtree, ttree, atol=1e-5):
    want = jax.tree.leaves(jax.tree.map(np.asarray, jtree))
    got = jax.tree.leaves(tree_to_numpy(ttree))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)


# ------------------------------- clocks -------------------------------------

VIDS = np.repeat(np.arange(6), 5)
SEQS = np.tile(np.arange(5), 6) + 17

LATENCIES = [
    ("uniform", lambda m: m.UniformLatency(5)),
    ("flat", lambda m: m.UniformLatency(0, **FLAT)),
    ("lognormal", lambda m: m.LognormalLatency(3, median=1.5, sigma=0.9)),
    ("hetero", lambda m: m.HeteroLatency(11, fleet=6, slow_factor=6.0,
                                         jitter=0.2)),
]


@pytest.mark.parametrize("name,make", LATENCIES,
                         ids=[n for n, _ in LATENCIES])
def test_latency_models_draw_jax_draws(name, make):
    """Each model's draws over a (vid, seq) grid are the JAX package's,
    bit for bit (a pure function of (seed, tag, vid, seq))."""
    got, want = make(tasync)(VIDS, SEQS), make(jasync)(VIDS, SEQS)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(make(tasync)(VIDS, SEQS), got)


def test_hetero_rates_and_mean_latency_match_jax():
    t = tasync.HeteroLatency(11, fleet=16, jitter=0.1,
                             cohort=TCohort(seed=11, availability=(2.0, 2.0)))
    j = jasync.HeteroLatency(11, fleet=16, jitter=0.1,
                             cohort=JCohort(seed=11, availability=(2.0, 2.0)))
    np.testing.assert_array_equal(t.rates(), j.rates())
    np.testing.assert_array_equal(t.mean_latency(np.arange(16)),
                                  j.mean_latency(np.arange(16)))
    default = tasync.HeteroLatency(0, fleet=8, slow_factor=6.0)
    np.testing.assert_array_equal(
        default.rates(), jasync.HeteroLatency(0, fleet=8,
                                              slow_factor=6.0).rates())


@pytest.mark.parametrize("name,kw", [
    ("uniform", dict(seed=1)), ("lognormal", dict(scale=2.0)),
    ("hetero", dict(fleet=8, scale=0.5)),
])
def test_latency_profile_factory_matches_jax(name, kw):
    t, j = tasync.latency_profile(name, **kw), jasync.latency_profile(name,
                                                                      **kw)
    assert type(t).__name__ == type(j).__name__
    np.testing.assert_array_equal(t(VIDS % 6, SEQS), j(VIDS % 6, SEQS))
    with pytest.raises(ValueError):
        tasync.latency_profile("nope")
    assert tasync.LATENCY_PROFILES == jasync.LATENCY_PROFILES


def test_sync_round_duration_matches_jax():
    t = tasync.HeteroLatency(3, fleet=8, slow_factor=6.0)
    j = jasync.HeteroLatency(3, fleet=8, slow_factor=6.0)
    assert [tasync.sync_round_duration(t, 8, r) for r in range(12)] == \
        [jasync.sync_round_duration(j, 8, r) for r in range(12)]


# ------------------------------- events -------------------------------------

@pytest.mark.parametrize("b", [1, 3, 8])
def test_event_view_pops_like_jax(b):
    """20 flushes of the port's EventView give JAX's popped slots, flush
    times, seqs and latency draws, exactly; ties pop in seq order."""
    k = 8
    tl = tasync.HeteroLatency(5, fleet=k, slow_factor=6.0)
    jl = jasync.HeteroLatency(5, fleet=k, slow_factor=6.0)
    tv = tasync.EventView(tl(np.arange(k), np.arange(k)), np.arange(k), k,
                          0.0)
    jv = jasync.EventView(jl(np.arange(k), np.arange(k)), np.arange(k), k,
                          0.0)
    for _ in range(20):
        got, want = tv.pop(b, tl), jv.pop(b, jl)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(tv.arrival_time, jv.arrival_time)
    np.testing.assert_array_equal(tv.seq, jv.seq)
    assert (tv.next_seq, tv.clock) == (jv.next_seq, jv.clock)
    at, seq = np.asarray([3.0, 1.0, 2.0, 1.0]), np.asarray([0, 3, 2, 1])
    np.testing.assert_array_equal(tasync.earliest_arrivals(at, seq, 3),
                                  jasync.earliest_arrivals(at, seq, 3))
    with pytest.raises(ValueError):
        tv.pop(k + 1, tl)


def test_polynomial_staleness_matches_jax():
    s = np.asarray([0, 1, 3, 10])
    for alpha in (0.0, 0.5, 1.0, 2.0):
        got = tasync.polynomial_staleness(alpha)(s)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got,
                                      jasync.polynomial_staleness(alpha)(s))


# ------------------- the identity gate inside the port ----------------------

GATE_SETTINGS = [
    ("dense", dict()),
    ("q50", dict(participation=0.5)),
    ("topk25", dict(compressor="topk", compression_ratio=0.25)),
    ("qsgd4", dict(compressor="qsgd", compression_bits=4)),
]


@pytest.mark.parametrize("name,extra", GATE_SETTINGS,
                         ids=[n for n, _ in GATE_SETTINGS])
def test_identity_gate_async_equals_sync_vmap_bitwise(name, extra):
    """B == C + a zero-spread clock + alpha=0 reduce the port's async engine
    to the port's sync vmap engine: global params, optimizer state, the rho
    ledger and resource_spent equal ``run_round``'s bit for bit, round for
    round, under dense, partial-participation and compressed specs."""
    ss, sa = _tspec(engine="vmap", **extra), _tspec(**extra)
    lat = tasync.UniformLatency(0, **FLAT)
    rng_s, rng_a = np.random.default_rng(0), np.random.default_rng(0)
    st_s = tapi.init_state(ss, tlin.init_linear(DIM, device="cpu"),
                           device="cpu")
    st_a = tasync.init_async_state(sa, tlin.init_linear(DIM, device="cpu"),
                                   _sampler, rng=rng_a, latency_model=lat,
                                   device="cpu")
    for _ in range(4):
        st_s, _ = tapi.run_round(ss, st_s, tapi.round_batch(ss, _sampler,
                                                            rng_s),
                                 check_budgets=False)
        st_a, rec = tasync.run_async_cycle(sa, st_a, _sampler, rng_a,
                                           latency_model=lat,
                                           check_budgets=False)
        _bitwise(tree_map(lambda x: x[0], st_s.params), st_a.global_params)
        _bitwise(tree_map(lambda x: x[0], st_s.opt_state), st_a.global_opt)
        np.testing.assert_array_equal(st_s.rho, st_a.fl.rho)
        assert st_s.resource_spent == st_a.fl.resource_spent
        assert rec["staleness_max"] == 0.0
        assert rec["participants"] == float(ss.participants_per_round())


@pytest.mark.parametrize("extra", [dict(), dict(participation=0.5)],
                         ids=["dense", "q50"])
def test_identity_gate_with_local_optimizer_state(extra):
    """average_opt_state=False with momentum: each slot resumes its own
    optimizer state, and the degenerate async engine still equals the sync
    vmap engine bit for bit. The slots hold the in-flight dispatch, one
    round ahead: after cycle r the global model is round r's and the
    slots' optimizer states are round r + 1's."""
    kw = dict(average_opt_state=False, **extra)
    ss = tapi.FederationSpec(loss_fn=tlin.logreg_loss, optimizer=tmomentum(
        0.1), **_kw(engine="vmap", **kw))
    sa = ss.replace(engine="async_buffered", buffer_size=C)
    lat = tasync.UniformLatency(0, **FLAT)
    rng_s, rng_a = np.random.default_rng(0), np.random.default_rng(0)
    st_s = tapi.init_state(ss, tlin.init_linear(DIM, device="cpu"),
                           device="cpu")
    st_a = tasync.init_async_state(sa, tlin.init_linear(DIM, device="cpu"),
                                   _sampler, rng=rng_a, latency_model=lat,
                                   device="cpu")
    def sync_round(st):
        return tapi.run_round(ss, st, tapi.round_batch(ss, _sampler, rng_s),
                              check_budgets=False)[0]

    st_s = sync_round(st_s)
    _bitwise(st_s.opt_state, st_a.fl.opt_state)
    for _ in range(3):
        params_r, rho_r = tree_map(lambda x: x[0], st_s.params), st_s.rho
        st_a, _ = tasync.run_async_cycle(sa, st_a, _sampler, rng_a,
                                         latency_model=lat,
                                         check_budgets=False)
        _bitwise(params_r, st_a.global_params)
        np.testing.assert_array_equal(rho_r, st_a.fl.rho)
        st_s = sync_round(st_s)
        _bitwise(st_s.opt_state, st_a.fl.opt_state)


# ----------------------- async against JAX's async --------------------------

def jax_dispatch_draws(key, params0, jspec, b):
    """What the JAX executor's dispatch of a b-slot block with carried key
    ``key`` draws, in the port's operand form: ``(mask, noise, agg_rand,
    next_key)`` (``next_key`` the next JAX key)."""
    key, sub = jax.random.split(key)             # engine.py:166 / :245
    if jspec.has_pipeline():
        sub, mask_key = jax.random.split(sub)    # engine.py:130
        mask = np.asarray(jagg.participation_mask(
            mask_key, b, jblock_participants(jspec, b)))
        keys, agg_keys = pipeline_round_keys(sub, b)   # engine.py:133
    else:
        mask = np.ones((b,), np.float32)         # engine.py:135
        keys, agg_keys = jax.random.split(sub, b), None
    noise = jax_client_noise(keys, params0, jspec.tau)
    agg_rand = None
    if jspec.compressor == "qsgd":               # aggregation.py:178
        agg_rand = torch.as_tensor(np.stack([np.asarray(jax.random.uniform(
            k, (D,), jnp.float32)) for k in agg_keys]))
    return torch.tensor(mask), noise, agg_rand, key


def _inject(monkeypatch, jspec, params0):
    """Make every dispatch of the port draw what the JAX executor's
    dispatches from ``PRNGKey(seed)`` draw, in order."""
    box = [jax.random.PRNGKey(jspec.seed)]

    def draws(key, params, tau, pipeline, n_participants):
        b = jax.tree.leaves(params)[0].shape[0]
        assert n_participants == jblock_participants(jspec, b)
        mask, noise, agg_rand, box[0] = jax_dispatch_draws(
            box[0], params0, jspec, b)
        return mask, noise, agg_rand, key

    monkeypatch.setattr(tengine, "draw_dispatch", draws)


def _assert_matches_jax(js, ts, atol=1e-5):
    _close_to_jax(js.global_params, ts.global_params, atol)
    _close_to_jax(js.global_opt, ts.global_opt, atol)
    np.testing.assert_array_equal(ts.fl.rho, js.fl.rho)
    np.testing.assert_array_equal(ts.pending_rho, js.pending_rho)
    np.testing.assert_array_equal(ts.slot_mask, js.slot_mask)
    for field in ("slot_version", "slot_seq", "arrival_time", "arrivals"):
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field))
    assert (ts.clock, ts.next_seq) == (js.clock, js.next_seq)
    assert (ts.fl.steps, ts.fl.resource_spent, ts.fl.rounds_done) == \
        (js.fl.steps, js.fl.resource_spent, js.fl.rounds_done)
    if js.sent is not None:
        np.testing.assert_allclose(ts.sent.numpy(), np.asarray(js.sent),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(ts.fl.residual.numpy(),
                                   np.asarray(js.fl.residual), rtol=0,
                                   atol=atol)


PARITY_SETTINGS = [
    ("dense", dict()),
    ("q50", dict(participation=0.5)),
    ("qsgd4", dict(compressor="qsgd", compression_bits=4)),
]


@pytest.mark.parametrize("name,extra", PARITY_SETTINGS,
                         ids=[n for n, _ in PARITY_SETTINGS])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("buf", [4, 2])
def test_async_matches_jax_with_its_draws(monkeypatch, buf, alpha, name,
                                          extra):
    """Five cycles on a lognormal straggler clock in both packages, the
    port fed the JAX executor's draws: the models within 1e-5; the ledger,
    the costs, the schedule, the clock and every record's staleness and
    epsilon exactly. A flush none of whose arrivals participated (B < C
    under partial participation) turns the JAX package's global model into
    NaN (it divides by the zero participant count); the port keeps the
    global model there and its record holds no local metrics, and the
    comparison of the models ends."""
    kw = dict(buffer_size=buf, staleness_alpha=alpha, **extra)
    jspec, tspec = _jspec(**kw), _tspec(**kw)
    params0 = jlin.init_linear(DIM)
    _inject(monkeypatch, jspec, params0)
    tl = tasync.LognormalLatency(3, sigma=0.9)
    jl = jasync.LognormalLatency(3, sigma=0.9)
    rj, rt = np.random.default_rng(1), np.random.default_rng(1)
    js = jasync.init_async_state(jspec, params0, _sampler, rng=rj,
                                 latency_model=jl)
    ts = tasync.init_async_state(tspec, tlin.init_linear(DIM, device="cpu"),
                                 _sampler, rng=rt, latency_model=tl,
                                 device="cpu")
    _assert_matches_jax(js, ts)
    stale = []
    for _ in range(5):
        popped = tasync.earliest_arrivals(ts.arrival_time, ts.slot_seq, buf)
        empty = not ts.slot_mask[popped].any()
        before = tree_to_numpy((ts.global_params, ts.global_opt))
        js, jrec = jasync.run_async_cycle(jspec, js, _sampler, rj,
                                          latency_model=jl,
                                          check_budgets=False)
        ts, trec = tasync.run_async_cycle(tspec, ts, _sampler, rt,
                                          latency_model=tl,
                                          check_budgets=False)
        if empty:
            assert np.isnan(np.asarray(js.global_params["w"])).all()
            _bitwise(before, (ts.global_params, ts.global_opt))
            np.testing.assert_array_equal(ts.fl.rho, js.fl.rho)
            assert trec["participants"] == jrec["participants"] == 0.0
            assert np.isnan(float(jrec["loss"])) and "loss" not in trec
            break
        _assert_matches_jax(js, ts)
        for k in ("round", "iterations", "max_epsilon",
                  "max_epsilon_dispatched", "resource_spent", "participants",
                  "sim_seconds", "buffer_size", "staleness_mean",
                  "staleness_max"):
            assert trec[k] == jrec[k], k
        assert float(trec["loss"]) == pytest.approx(float(jrec["loss"]),
                                                    abs=1e-5)
        stale.append(trec["staleness_max"])
    if buf < C:
        assert max(stale) > 0.0          # the weights really applied


def test_a_flush_without_participants_keeps_the_global_model():
    """B = 1 of C = 4 at participation 0.5 (one participant in two slots of
    a dispatch block rounds to one of one, so use B = 2): every flush whose
    popped arrivals all sat out leaves the global model and its optimizer
    state bit for bit, costs only compute and records no local metric, and
    training goes on finite. train_async's history of the same run holds
    the same: no metric in an empty flush's record, finite ones in every
    other."""
    spec = _tspec(buffer_size=2, participation=0.5, eps_th=1e9, c_th=1e9)
    lat = tasync.LognormalLatency(3, sigma=0.9)
    rng = np.random.default_rng(1)
    st = _tinit(spec, lat, seed=1)
    empties = 0
    for _ in range(12):
        popped = tasync.earliest_arrivals(st.arrival_time, st.slot_seq, 2)
        empty = not st.slot_mask[popped].any()
        before = tree_to_numpy((st.global_params, st.global_opt))
        spent = st.fl.resource_spent
        st, rec = tasync.run_async_cycle(spec, st, _sampler, rng,
                                         latency_model=lat)
        if empty:
            empties += 1
            _bitwise(before, (st.global_params, st.global_opt))
            assert rec["participants"] == 0.0
            assert not set(rec) & set(st.slot_metrics)
            assert st.fl.resource_spent - spent == pytest.approx(
                spec.c2 * TAU * 2 / C, abs=1e-12)
        else:
            assert set(st.slot_metrics) <= set(rec)
    assert empties > 0
    assert np.isfinite(tree_to_numpy(st.global_params)["w"]).all()
    st = _tinit(spec, lat, seed=1)
    st, out = tasync.train_async(spec, st, _sampler, max_rounds=12,
                                 rng=np.random.default_rng(1), chunk_rounds=4,
                                 latency_model=lat)
    hist = out["history"]
    assert len(hist) == 12
    assert sum(r["participants"] == 0.0 for r in hist) == empties
    for r in hist:
        metrics = set(r) & set(st.slot_metrics)
        if r["participants"] == 0.0:
            assert not metrics
        else:
            assert metrics == set(st.slot_metrics)
            assert all(np.isfinite(r[k]) for k in metrics)


# ---------------------------- the host logic --------------------------------

def test_dispatch_ledger_soundness_matches_jax():
    """The dispatched view equals the hand-computed Lemma-2 composition of
    every dispatch issued, the landed ledger lags it by exactly the
    in-flight uploads, and both ledgers equal the JAX package's."""
    kw = dict(buffer_size=2, eps_th=1e9, c_th=1e9)
    tspec, jspec = _tspec(**kw), _jspec(**kw)
    tl = tasync.LognormalLatency(3, median=1.0, sigma=0.9)
    jl = jasync.LognormalLatency(3, median=1.0, sigma=0.9)
    rt, rj = np.random.default_rng(0), np.random.default_rng(0)
    ts = tasync.init_async_state(tspec, tlin.init_linear(DIM, device="cpu"),
                                 _sampler, rng=rt, latency_model=tl,
                                 device="cpu")
    js = jasync.init_async_state(jspec, jlin.init_linear(DIM), _sampler,
                                 rng=rj, latency_model=jl)
    per_dispatch = np.asarray(
        [TAU * gaussian_zcdp(grad_sensitivity(1.0, B), SIGMA)] * C)
    dispatches, arrived = np.ones(C), np.zeros(C)
    for _ in range(6):
        np.testing.assert_allclose(tasync.dispatched_rho(ts),
                                   dispatches * per_dispatch, rtol=1e-12)
        np.testing.assert_allclose(ts.fl.rho, arrived * per_dispatch,
                                   rtol=1e-12)
        assert np.all(ts.pending_rho >= 0.0)
        assert np.all(tasync.dispatched_rho(ts) >= ts.fl.rho)
        np.testing.assert_array_equal(tasync.dispatched_rho(ts),
                                      jasync.dispatched_rho(js))
        np.testing.assert_array_equal(ts.pending_rho, js.pending_rho)
        idx = tasync.earliest_arrivals(ts.arrival_time, ts.slot_seq, 2)
        ts, _ = tasync.run_async_cycle(tspec, ts, _sampler, rt,
                                       latency_model=tl, check_budgets=False)
        js, _ = jasync.run_async_cycle(jspec, js, _sampler, rj,
                                       latency_model=jl, check_budgets=False)
        arrived[idx] += 1
        dispatches[idx] += 1
    tacc = tasync.async_accountant_view(tspec, ts)
    jacc = jasync.async_accountant_view(jspec, js)
    for m in range(C):
        assert tacc.rho(m) == jacc.rho(m)
        assert tacc.pending_rho(m) == jacc.pending_rho(m)
        assert tacc.landed_rho(m) == jacc.landed_rho(m)
        assert tacc.pending_rho(m) == float(ts.pending_rho[m])
    assert tacc.steps == jacc.steps
    assert tasync.dispatched_epsilon(tspec, ts) == \
        jasync.dispatched_epsilon(jspec, js)


def test_accountant_charges_at_dispatch_like_jax():
    """The dispatch/arrival split: the pre-charge shows up in rho at once,
    the arrival moves it from pending to landed without changing the
    total; every number equal to the JAX package's accountant."""
    accs = []
    for cls in (TAccountant, JAccountant):
        acc = cls(clip_norm=1.0, delta=1e-5)
        acc.register_client(0, 16, 0.7)
        acc.register_client(1, 8, 1.1)
        acc.charge_at_dispatch(TAU, [0, 1])
        before = (acc.rho(0), acc.pending_rho(0), acc.landed_rho(0),
                  acc.epsilon(0))
        acc.note_arrival([0])
        after = (acc.rho(0), acc.pending_rho(0), acc.landed_rho(0),
                 acc.epsilon(0), acc.pending_rho(1), acc.max_epsilon())
        with pytest.raises(ValueError):
            acc.charge_at_dispatch(-1, [0])
        accs.append((before, after))
    assert accs[0] == accs[1]
    (rho, pending, landed, eps), after = accs[0]
    assert pending == rho and landed == 0.0
    assert after[:4] == (rho, 0.0, rho, eps)


def test_budget_probe_counts_in_flight():
    """The privacy probe trips on dispatched (not landed) rho: a state whose
    pending charges already exhaust the budget refuses the next flush
    although nothing has landed, as in the JAX package."""
    lat = tasync.UniformLatency(0, **FLAT)
    st = _tinit(_tspec(buffer_size=2, eps_th=1e9, c_th=1e9), lat)
    js = jasync.init_async_state(_jspec(buffer_size=2, eps_th=1e9, c_th=1e9),
                                 jlin.init_linear(DIM), _sampler,
                                 rng=np.random.default_rng(0),
                                 latency_model=jasync.UniformLatency(0,
                                                                     **FLAT))
    assert float(np.max(st.fl.rho)) == 0.0
    eps_now = tasync.dispatched_epsilon(_tspec(buffer_size=2), st)
    assert eps_now > 0.0
    tight = dict(buffer_size=2, eps_th=eps_now * 1.0001, c_th=1e9)
    assert tasync.exceeds_async_budgets(_tspec(**tight), st) == "privacy"
    assert jasync.exceeds_async_budgets(_jspec(**tight), js) == "privacy"
    assert tasync.flushes_within_budgets(_tspec(**tight), st, 10) == \
        (0, "privacy")
    with pytest.raises(tapi.BudgetExceeded):
        tasync.run_async_cycle(_tspec(**tight), st, _sampler,
                               np.random.default_rng(1), latency_model=lat)


@pytest.mark.parametrize("extra", [dict(), dict(participation=0.5),
                                   dict(compressor="qsgd",
                                        compression_bits=4)],
                         ids=["dense", "q50", "qsgd4"])
def test_flush_cost_degenerates_to_round_cost(extra):
    spec, jspec = _tspec(**extra), _jspec(**extra)
    p = spec.participants_per_round()
    assert tasync.async_flush_cost(spec, C, p) == spec.round_cost()
    assert tasync.async_flush_cost(spec, C, p) == \
        jasync.async_flush_cost(jspec, C, p)
    half, jhalf = _tspec(buffer_size=2, **extra), _jspec(buffer_size=2,
                                                        **extra)
    assert tasync.async_flush_cost(half, 2, 1) < half.round_cost()
    assert tasync.async_flush_cost_bound(half) == \
        jasync.async_flush_cost_bound(jhalf)


@pytest.mark.parametrize("budgets", [dict(eps_th=40.0, c_th=1e9),
                                     dict(eps_th=1e9, c_th=700.0),
                                     dict(eps_th=1e9, c_th=1e9)],
                         ids=["privacy", "resource", "none"])
def test_flushes_within_budgets_matches_jax(budgets):
    kw = dict(buffer_size=2, delta=1e-5, **budgets)
    lat = tasync.UniformLatency(0, **FLAT)
    st = _tinit(_tspec(**kw), lat)
    js = jasync.init_async_state(_jspec(**kw), jlin.init_linear(DIM),
                                 _sampler, rng=np.random.default_rng(0),
                                 latency_model=jasync.UniformLatency(0,
                                                                     **FLAT))
    got = tasync.flushes_within_budgets(_tspec(**kw), st, 50)
    assert got == jasync.flushes_within_budgets(_jspec(**kw), js, 50)
    assert tasync.exceeds_async_budgets(_tspec(**kw), st) == \
        jasync.exceeds_async_budgets(_jspec(**kw), js)


def test_train_async_budget_stop_matches_jax():
    """train_async stops at the flush the JAX package stops at, with its
    epsilon, cost and simulated seconds, never past the budget."""
    kw = dict(buffer_size=2, eps_th=25.0, c_th=1e9, delta=1e-5)
    tspec, jspec = _tspec(**kw), _jspec(**kw)
    tl = tasync.UniformLatency(4)
    jl = jasync.UniformLatency(4)
    rt, rj = np.random.default_rng(0), np.random.default_rng(0)
    ts = tasync.init_async_state(tspec, tlin.init_linear(DIM, device="cpu"),
                                 _sampler, rng=rt, latency_model=tl,
                                 device="cpu")
    js = jasync.init_async_state(jspec, jlin.init_linear(DIM), _sampler,
                                 rng=rj, latency_model=jl)
    ts, tout = tasync.train_async(tspec, ts, _sampler, rng=rt,
                                  latency_model=tl, chunk_rounds=4)
    js, jout = jasync.train_async(jspec, js, _sampler, rng=rj,
                                  latency_model=jl, chunk_rounds=4)
    assert 0 < tout["rounds"] == jout["rounds"] < 10_000
    for k in ("max_epsilon", "resource_spent", "sim_seconds"):
        assert tout[k] == jout[k], k
    assert tasync.exceeds_async_budgets(tspec, ts) is not None
    assert tasync.dispatched_epsilon(tspec, ts) <= tspec.eps_th
    np.testing.assert_array_equal(ts.fl.rho, js.fl.rho)


# ------------------------- drivers within the port --------------------------

@pytest.mark.parametrize("extra", [
    dict(compressor="topk", compression_ratio=0.25),
    dict(participation=0.5, staleness_alpha=0.5),
], ids=["topk25", "q50-alpha"])
def test_train_async_chunked_equals_per_cycle_bitwise(extra):
    """chunk_rounds > 1 (pre-projected schedule + uploaded batches) is bit
    for bit the per-cycle driver, including a tail shorter than a chunk."""
    lat = tasync.LognormalLatency(2, sigma=0.8)

    def run(chunk):
        spec = _tspec(buffer_size=2, eps_th=1e9, c_th=1e9, **extra)
        rng = np.random.default_rng(0)
        st = tasync.init_async_state(spec, tlin.init_linear(DIM,
                                                            device="cpu"),
                                     _sampler, rng=rng, latency_model=lat,
                                     device="cpu")
        return tasync.train_async(spec, st, _sampler, max_rounds=7, rng=rng,
                                  chunk_rounds=chunk, latency_model=lat)

    s1, o1 = run(1)
    s3, o3 = run(3)
    assert o1["rounds"] == o3["rounds"] == 7
    _bitwise((s1.global_params, s1.global_opt, s1.fl.params, s1.sent,
              s1.fl.residual),
             (s3.global_params, s3.global_opt, s3.fl.params, s3.sent,
              s3.fl.residual))
    np.testing.assert_array_equal(s1.fl.rho, s3.fl.rho)
    np.testing.assert_array_equal(s1.arrival_time, s3.arrival_time)
    assert s1.clock == s3.clock
    # a flush that no participant reached records no loss (None here)
    assert ([r.get("loss") for r in o1["history"]]
            == [r.get("loss") for r in o3["history"]])


def test_save_load_resume_identity(tmp_path):
    """Checkpoint mid-run, restore, continue: bit for bit the uninterrupted
    run (model, slot storages, ledgers, schedule, clock, generator)."""
    lat = tasync.LognormalLatency(4, sigma=0.7)
    spec = _tspec(buffer_size=2, eps_th=1e9, c_th=1e9,
                  compressor="qsgd", compression_bits=4, participation=0.5)
    rng = np.random.default_rng(0)      # _fixed_sampler ignores it

    def fresh():
        return _tinit(spec, lat, sampler=_fixed_sampler)

    st_a = fresh()
    for _ in range(4):
        st_a, _ = tasync.run_async_cycle(spec, st_a, _fixed_sampler, rng,
                                         latency_model=lat,
                                         check_budgets=False)
    st_b = fresh()
    for _ in range(2):
        st_b, _ = tasync.run_async_cycle(spec, st_b, _fixed_sampler, rng,
                                         latency_model=lat,
                                         check_budgets=False)
    tasync.save_async_state(str(tmp_path / "ck"), st_b, extra={"tag": 7})
    st_c, extra = tasync.load_async_state(str(tmp_path / "ck"), like=fresh())
    assert extra["tag"] == 7
    assert st_c.clock == st_b.clock and st_c.next_seq == st_b.next_seq
    for _ in range(2):
        st_c, _ = tasync.run_async_cycle(spec, st_c, _fixed_sampler, rng,
                                         latency_model=lat,
                                         check_budgets=False)
    _bitwise((st_a.global_params, st_a.global_opt, st_a.fl.params,
              st_a.fl.opt_state, st_a.slot_metrics, st_a.sent,
              st_a.fl.residual, st_a.fl.key),
             (st_c.global_params, st_c.global_opt, st_c.fl.params,
              st_c.fl.opt_state, st_c.slot_metrics, st_c.sent,
              st_c.fl.residual, st_c.fl.key))
    for field in ("pending_rho", "slot_mask", "slot_version", "slot_seq",
                  "arrival_time", "arrivals"):
        np.testing.assert_array_equal(getattr(st_a, field),
                                      getattr(st_c, field))
    np.testing.assert_array_equal(st_a.fl.rho, st_c.fl.rho)
    assert (st_a.clock, st_a.fl.resource_spent, st_a.fl.steps) == \
        (st_c.clock, st_c.fl.resource_spent, st_c.fl.steps)


def test_desynced_schedule_row_raises():
    lat = tasync.LognormalLatency(2, sigma=0.8)
    spec = _tspec(buffer_size=2, eps_th=1e9, c_th=1e9)
    st = _tinit(spec, lat)
    view = tasync.EventView(st.arrival_time, st.slot_seq, st.next_seq,
                            st.clock)
    idx, t, _, latency = view.pop(2, lat)
    batch = {k: torch.as_tensor(v) for k, v in tasync.runtime._block_batch(
        spec, _sampler, np.random.default_rng(3), idx).items()}
    wrong = tasync.ScheduleRow(idx=idx[::-1].copy(), flush_time=t,
                               latency=latency, batch=batch)
    with pytest.raises(RuntimeError, match="desynced"):
        tasync.run_async_cycle(spec, st, check_budgets=False, prebuilt=wrong)
    with pytest.raises(ValueError, match="prebuilt"):
        tasync.run_async_cycle(spec, st, check_budgets=False)
    right = tasync.ScheduleRow(idx=idx, flush_time=t, latency=latency,
                               batch=batch)
    st, rec = tasync.run_async_cycle(spec, st, check_budgets=False,
                                     prebuilt=right)
    assert rec["round"] == 1 and st.clock == t


def test_sync_round_fns_refuse_async_specs():
    spec = _tspec()
    assert tapi.resolve_engine(spec) == "async_buffered"
    assert tapi.resolve_engine(_tspec(engine="auto")) == "vmap"
    with pytest.raises(ValueError, match="repro_torch.asyncfl"):
        tapi.round_fn_for(spec)
    with pytest.raises(ValueError, match="repro_torch.asyncfl"):
        tapi.chunked_round_fn_for(spec)
    with pytest.raises(ValueError, match="async"):
        tapi.run_round(spec, tapi.init_state(
            spec, tlin.init_linear(DIM, device="cpu"), device="cpu"),
            tapi.round_batch(spec, _sampler, np.random.default_rng(0)),
            check_budgets=False)
    with pytest.raises(ValueError, match="async"):
        _tinit(_tspec(engine="vmap"), tasync.UniformLatency(0))
    with pytest.raises(ValueError, match="async"):
        tasync.AsyncBufferedExecutor(_tspec(engine="vmap"))


def test_init_async_state_needs_a_gpu_or_an_explicit_cpu(monkeypatch):
    """No fallback: without a GPU the default device raises; device="cpu"
    runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _tspec()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tasync.init_async_state(spec, tlin.init_linear(DIM, device="cpu"),
                                _sampler)
    st = _tinit(spec, tasync.UniformLatency(0))
    assert tasync.async_eval_params(spec, st) is st.global_params
    assert st.global_params["w"].device.type == "cpu"


def test_executor_cache_is_keyed_by_engine_key_and_participants():
    spec = _tspec(buffer_size=2)
    assert tasync.executor_for(spec) is tasync.executor_for(
        spec.replace(eps_th=9.0, staleness_alpha=0.5))
    assert tasync.executor_for(spec) is not tasync.executor_for(
        _tspec(buffer_size=3))
    assert tasync.executor_for(_tspec(participation=0.5)) is not \
        tasync.executor_for(_tspec(participation=0.75))


# ---------------------------- kernel calls ----------------------------------

@pytest.mark.parametrize("buf", [4, 2])
def test_one_dp_clip_noise_call_per_step_over_the_block(monkeypatch, buf):
    """Generation 0 clips all C slots in one (C, N) call per local step; a
    cycle's dispatch one (B, N) call per step."""
    seen = []
    real = tops.dp_clip_noise

    def spy(g, noise, clip_norm, sigma):
        seen.append(tuple(g.shape))
        return real(g, noise, clip_norm, sigma)

    monkeypatch.setattr(tops, "dp_clip_noise", spy)
    spec = _tspec(buffer_size=buf, eps_th=1e9, c_th=1e9)
    lat = tasync.LognormalLatency(1)
    rng = np.random.default_rng(0)
    st = tasync.init_async_state(spec, tlin.init_linear(DIM, device="cpu"),
                                 _sampler, rng=rng, latency_model=lat,
                                 device="cpu")
    assert seen == [(C, D)] * TAU
    seen.clear()
    for _ in range(3):
        st, _ = tasync.run_async_cycle(spec, st, _sampler, rng,
                                       latency_model=lat)
    assert seen == [(buf, D)] * (3 * TAU)


def test_one_quantize_decompress_call_per_dispatch(monkeypatch):
    seen = []
    real = tops.quantize_decompress

    def spy(x, u, bits):
        seen.append((tuple(x.shape), bits))
        return real(x, u, bits)

    monkeypatch.setattr(tops, "quantize_decompress", spy)
    spec = _tspec(buffer_size=2, compressor="qsgd", compression_bits=4,
                  participation=0.5, eps_th=1e9, c_th=1e9)
    lat = tasync.LognormalLatency(1)
    rng = np.random.default_rng(0)
    st = tasync.init_async_state(spec, tlin.init_linear(DIM, device="cpu"),
                                 _sampler, rng=rng, latency_model=lat,
                                 device="cpu")
    for _ in range(3):
        st, _ = tasync.run_async_cycle(spec, st, _sampler, rng,
                                       latency_model=lat)
    assert seen == [((C, D), 4)] + [((2, D), 4)] * 3


# --------------------------- the quickstart ---------------------------------

def test_async_quickstart_runs_on_the_cpu(capsys):
    import runpy
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "async_quickstart_torch.py"
    argv = sys.argv
    sys.argv = [str(path), "--device", "cpu"]
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "speedup" in out and "dispatch-split" in out


# ------------------------------- the card -----------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU "
                    "mode (their plain versions run above)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [dict(), dict(compressor="qsgd",
                                                compression_bits=4,
                                                participation=0.5)],
                         ids=["dense", "qsgd4-q50"])
def test_cuda_cycle_matches_plain_route(cuda_device, extra):
    """One async cycle on the card through the kernels ("auto") against
    the same cycle with kernel_backend="ref", from one generator state."""
    lat = tasync.LognormalLatency(1)
    finals = []
    for backend in ("auto", "ref"):
        spec = _tspec(buffer_size=2, kernel_backend=backend, **extra)
        rng = np.random.default_rng(0)
        st = tasync.init_async_state(
            spec, tlin.init_linear(DIM, device=cuda_device), _sampler,
            rng=rng, latency_model=lat, device=cuda_device)
        st, _ = tasync.run_async_cycle(spec, st, _sampler, rng,
                                       latency_model=lat)
        finals.append(tree_to_numpy(st.global_params))
    for k in finals[0]:
        np.testing.assert_allclose(finals[0][k], finals[1][k], rtol=0,
                                   atol=1e-5)
