"""The port's population plane (``repro_torch.population``: virtual client
populations, cohort drivers, the resident cohort cache) against the JAX
package.

- The numpy host modules (populations, cohort samplers, the ClientStore and
  its ``.npz`` layout) match ``repro.population`` exactly.
- The identity gates of tests/test_population.py hold in torch, bit for
  bit: M == C equals the dense ``run_round`` on the vmap and map engines;
  the resident driver equals the per-round cohort driver, streaming and
  stationary; eviction churn with S = K + 1 lands bit-identical after a
  flush, swept over seeds 0-2 (of tests/test_seed_sweep.py's sweeps, the
  only one ported).
- With JAX's draws injected (``test_torch_aggregation.jax_pipeline_draws``)
  the port's cohort rounds and resident chunks match JAX: params and
  residual within 1e-5 (sums taken in another order); rho, costs,
  participants, the stopping round, the cache stats and the slot plans
  exactly.
- The reference values of the population quickstart's resident step and of
  Adult-2 as an M == C population, at full size.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_aggregation import jax_pipeline_draws

import repro.api as japi
import repro.population as jpop
import repro_torch.api as tapi
import repro_torch.api.state as tstate
import repro_torch.core.fl as tfl
import repro_torch.kernels.ops as tops
import repro_torch.population as tpop
from repro.data import adult_like as jadult_like
from repro.data import split_iid as jsplit_iid
from repro.models import linear as jlin
from repro.optim import sgd as jsgd
from repro_torch.api.engines import resident_chunked_round_fn_for
from repro_torch.checkpoint import checkpoint_leaf_paths, load_checkpoint
from repro_torch.core.fl import design_sigmas
from repro_torch.data import adult_like, split_iid
from repro_torch.models import linear as tlin
from repro_torch.optim import sgd as tsgd
from repro_torch.utils.convert import tree_to_numpy

C, TAU, DIM, B = 4, 2, 8, 4
TOPT = tsgd(0.2)        # one optimizer instance -> round caches shared
JOPT = jsgd(0.2)

SETTINGS = [
    ("dense", dict()),
    ("q50", dict(participation=0.5)),
    ("topk25", dict(compressor="topk", compression_ratio=0.25)),
    ("qsgd4-q50", dict(compressor="qsgd", compression_bits=4,
                       participation=0.5)),
]
SETTING_IDS = [n for n, _ in SETTINGS]


def _common(**kw):
    base = dict(n_clients=C, tau=TAU, clip_norm=1.0, dp=True,
                sigmas=(0.5,) * C, batch_sizes=(B,) * C)
    base.update(kw)
    return base


def _tspec(**kw):
    return tapi.FederationSpec(loss_fn=tlin.logreg_loss, optimizer=TOPT,
                               **_common(**kw))


def _jspec(**kw):
    return japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=JOPT,
                               kernel_backend="ref", **_common(**kw))


def _tstate(spec):
    return tpop.init_population_state(
        spec, tlin.init_linear(DIM, device="cpu"), device="cpu")


def _fed():
    return split_iid(adult_like(n=400, dim=DIM, seed=0), C)


def _assert_trees_equal(a, b):
    for x, y in zip(jax.tree.leaves(tree_to_numpy(a)),
                    jax.tree.leaves(tree_to_numpy(b))):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _assert_stores_equal(a, b):
    np.testing.assert_array_equal(a.rho, b.rho)
    np.testing.assert_array_equal(a.rounds_participated,
                                  b.rounds_participated)
    assert a.max_rho() == b.max_rho()
    if a.needs_residual():
        vids = np.arange(a.population)
        np.testing.assert_array_equal(a.gather_residual(vids),
                                      b.gather_residual(vids))
        assert a.residual_rows() == b.residual_rows()


# ------------------------- numpy host modules vs JAX -------------------------

@pytest.mark.parametrize("stationary", [False, True])
def test_synthetic_population_shards_match_jax(stationary):
    kw = dict(dim=6, batch_size=5, alpha=0.3, seed=3, stationary=stationary)
    tp = tpop.synthetic_population(1000, **kw)
    jp = jpop.synthetic_population(1000, **kw)
    assert (tp.name, tp.stationary, tp.n_clients) == \
        (jp.name, jp.stationary, jp.n_clients)
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    for vid in (0, 17, 999, 17):
        a, b = tp.sampler(vid, 3, rt), jp.sampler(vid, 3, rj)
        for k in ("x", "y"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # streaming populations draw from the shared rng, stationary ones not
    assert (rt.random() == np.random.default_rng(7).random()) == stationary


def test_population_constructors_match_jax():
    tfed = _fed()
    jfed = jsplit_iid(jadult_like(n=400, dim=DIM, seed=0), C)
    tp = tpop.population_from_federated(tfed, B)
    jp = jpop.population_from_federated(jfed, B)
    assert (tp.n_clients, tp.name, tp.stationary) == \
        (jp.n_clients, jp.name, jp.stationary)
    rt, rj = np.random.default_rng(1), np.random.default_rng(1)
    for vid in range(C):
        a, b = tp.sampler(vid, TAU, rt), jp.sampler(vid, TAU, rj)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    fn = jp.sampler
    wrapped = tpop.population_from_sampler(C, fn, name="s", stationary=True)
    assert (wrapped.n_clients, wrapped.name, wrapped.stationary) == \
        (C, "s", True)
    with pytest.raises(ValueError):
        tpop.ClientPopulation(n_clients=0, sampler=fn)
    with pytest.raises(ValueError):
        tpop.synthetic_population(10, n_classes=1)
    with pytest.raises(ValueError):
        tpop.synthetic_population(10, alpha=0.0)


# uniform: the rejection branch (K * 16 < M) and the permutation branch
@pytest.mark.parametrize("m,k", [(100_000, 16), (50, 8), (16, 16)])
def test_uniform_cohorts_match_jax(m, k):
    for seed in (0, 5):
        t, j = tpop.UniformCohort(seed), jpop.UniformCohort(seed)
        assert t.uniform_over_population and j.uniform_over_population
        for r in range(6):
            a, b = t(r, m, k), j(r, m, k)
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tpop.chunk_cohorts(t, 3, 5, m, k),
                                      jpop.chunk_cohorts(j, 3, 5, m, k))
    if m == k:
        np.testing.assert_array_equal(tpop.UniformCohort(0)(2, m, k),
                                      np.arange(m))


# default rates; rates so low the cohort is topped up from the unavailable
# set; heavy dropout
@pytest.mark.parametrize("availability,dropout", [
    ((8.0, 2.0), 0.05), ((0.05, 50.0), 0.0), ((2.0, 2.0), 0.9)])
def test_heterogeneous_cohorts_match_jax(availability, dropout):
    t = tpop.HeterogeneousCohort(seed=2, availability=availability,
                                 dropout=dropout)
    j = jpop.HeterogeneousCohort(seed=2, availability=availability,
                                 dropout=dropout)
    assert not getattr(t, "uniform_over_population", False)
    for m, k in ((200, 8), (5000, 16)):
        np.testing.assert_array_equal(t.rates(m), j.rates(m))
        for r in range(5):
            np.testing.assert_array_equal(t(r, m, k), j(r, m, k))
    assert set(t._rates) == {200, 5000}     # cached per population size
    for bad in (dict(availability=(0.0, 1.0)), dict(dropout=1.0)):
        with pytest.raises(ValueError):
            tpop.HeterogeneousCohort(**bad)
    with pytest.raises(ValueError):
        tpop.UniformCohort(0)(0, 4, 5)
    with pytest.raises(ValueError):
        tpop.chunk_cohorts(tpop.UniformCohort(0), 0, 0, 10, 2)


def _store_ops(mod):
    """The same scatter / gather / prune sequence on a store of ``mod``."""
    rng = np.random.default_rng(4)
    st = mod.ClientStore(50, residual_dim=6)
    for _ in range(4):
        cohort = rng.permutation(50)[:5]
        block = rng.normal(size=(5, 6)).astype(np.float32)
        block[rng.integers(0, 5)] = 0.0          # a row that prunes
        st.scatter_residual(cohort, block)
        st.scatter_rho(cohort, st.gather_rho(cohort) + rng.uniform(size=5))
        st.note_participation(cohort, 2)
    return st


def test_client_store_matches_jax_and_round_trips_across_packages(tmp_path):
    t, j = _store_ops(tpop), _store_ops(jpop)
    _assert_stores_equal(t, j)
    cohort = np.asarray([3, 9, 49, 0])
    np.testing.assert_array_equal(t.gather_residual(cohort),
                                  j.gather_residual(cohort))
    np.testing.assert_array_equal(t.gather_rho(cohort), j.gather_rho(cohort))
    t.save(str(tmp_path / "torch.npz"))
    j.save(str(tmp_path / "jax.npz"))
    for path in ("torch.npz", "jax.npz"):
        _assert_stores_equal(tpop.ClientStore.load(str(tmp_path / path)), t)
        _assert_stores_equal(jpop.ClientStore.load(str(tmp_path / path)), t)
    with np.load(str(tmp_path / "torch.npz")) as a, \
            np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    empty = tpop.ClientStore(7)
    empty.save(str(tmp_path / "empty.npz"))
    back = jpop.ClientStore.load(str(tmp_path / "empty.npz"))
    assert back.residual_dim is None and back.population == 7
    with pytest.raises(ValueError):
        empty.gather_residual(cohort)
    with pytest.raises(ValueError):
        t.scatter_residual(cohort, np.zeros((3, 6), np.float32))
    t.rho[5] = 100.0                             # bypassing scatter_rho
    assert t.max_rho() < 100.0 and t.refresh_max_rho() == 100.0


@pytest.mark.parametrize("m,kw", [
    (1000, dict()), (1000, dict(participation=0.5)),
    (C, dict(compressor="topk", compression_ratio=0.25)),
    (40, dict(participation=0.5, amplify_participation=True)),
    (40, dict(compressor="qsgd", amplify_participation=True))])
def test_population_spec_views_match_jax(m, kw):
    t = _tspec(population=m, cohort_size=C, **kw)
    j = _jspec(population=m, cohort_size=C, **kw)
    assert t.is_population() and t.cohort_fraction() == j.cohort_fraction()
    assert t.accounting_q() == j.accounting_q()
    assert t.round_cost() == j.round_cost()
    np.testing.assert_array_equal(tapi.round_rho_charges(t),
                                  japi.round_rho_charges(j))
    # M is accounting-only: sweeping it reuses the round function
    assert t.engine_key() == t.replace(population=10 * m).engine_key()
    assert not _tspec().is_population() and _tspec().cohort_fraction() == 1.0


# --------------------------- identity gates (torch) --------------------------

@pytest.mark.parametrize("engine", ["vmap", "map"])
@pytest.mark.parametrize("name,kw", SETTINGS, ids=SETTING_IDS)
def test_cohort_path_identity_with_full_population(engine, name, kw):
    """M == C with cohort == population is the dense path bit for bit: the
    same round function, the same draws, the same ledger."""
    dense = _tspec(engine=engine, **kw)
    pspec = _tspec(engine=engine, population=C, cohort_size=C, **kw)
    fed = _fed()
    pop = tpop.population_from_federated(fed, B)
    s_d = tapi.init_state(dense, tlin.init_linear(DIM, device="cpu"),
                          device="cpu")
    s_p = _tstate(pspec)
    rng_d, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    sampler = fed.make_sampler(B)
    for _ in range(3):
        s_d, rec_d = tapi.run_round(dense, s_d, tapi.round_batch(
            dense, sampler, rng_d), check_budgets=False)
        s_p, rec_p = tpop.run_cohort_round(pspec, s_p, pop, rng_p,
                                           check_budgets=False)
        assert float(rec_p["loss"]) == float(rec_d["loss"])
        for k in ("max_epsilon", "participants", "resource_spent"):
            assert rec_p[k] == rec_d[k]
    _assert_trees_equal((s_d.params, s_d.opt_state),
                        (s_p.fl.params, s_p.fl.opt_state))
    np.testing.assert_array_equal(s_d.rho, s_p.store.rho)
    assert s_d.resource_spent == s_p.fl.resource_spent
    assert torch.equal(s_d.key, s_p.fl.key)
    if s_d.residual is not None:
        np.testing.assert_array_equal(s_d.residual.numpy(),
                                      s_p.store.gather_residual(np.arange(C)))


@pytest.mark.parametrize("resident", [0, C])
def test_chunked_cohort_train_identity_with_full_population(resident):
    """train_population(chunk_rounds=2) over cohort == population (also
    through the resident cache) equals the dense train(chunk_rounds=2)."""
    kw = dict(compressor="topk", compression_ratio=0.25, participation=0.5,
              eps_th=1e9, c_th=1e9)
    dense, pspec = _tspec(**kw), _tspec(population=C, cohort_size=C, **kw)
    fed = _fed()
    s_d, out_d = tapi.train(dense, tapi.init_state(
        dense, tlin.init_linear(DIM, device="cpu"), device="cpu"),
        fed.make_sampler(B), max_rounds=5, chunk_rounds=2)
    s_p, out_p = tpop.train_population(
        pspec, _tstate(pspec), tpop.population_from_federated(fed, B),
        max_rounds=5, chunk_rounds=2, resident_cache=resident)
    assert out_d["rounds"] == out_p["rounds"] == 5
    _assert_trees_equal(s_d.params, s_p.fl.params)
    np.testing.assert_array_equal(s_d.rho, s_p.store.rho)
    for rd, rp in zip(out_d["history"], out_p["history"]):
        assert rd["loss"] == rp["loss"]
        assert rd["max_epsilon"] == rp["max_epsilon"]
    if resident:
        assert out_p["resident_cache"] == {"hits": 4, "misses": 4,
                                           "evictions": 0, "flushes": 2}


def _per_round(spec, pop, rounds, seed=0):
    st = _tstate(spec)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(rounds):
        st, rec = tpop.run_cohort_round(spec, st, pop, rng,
                                        check_budgets=False)
        losses.append(float(rec["loss"]))
    return st, losses


def _resident(spec, pop, rounds, chunk, capacity, seed=0):
    st = _tstate(spec)
    rng = np.random.default_rng(seed)
    cache = tpop.init_resident_cache(spec, st, capacity, population=pop)
    losses = []
    for _ in range(rounds // chunk):
        st, recs = tpop.run_resident_rounds(spec, st, pop, rng, cache,
                                            n_rounds=chunk,
                                            check_budgets=False)
        losses.extend(float(r["loss"]) for r in recs)
    cache.flush(st.store)
    return st, losses, cache


@pytest.mark.parametrize("stationary", [False, True],
                         ids=["streaming", "stationary"])
@pytest.mark.parametrize("name,kw", SETTINGS, ids=SETTING_IDS)
def test_resident_equals_per_round_bitwise(stationary, name, kw):
    """A fresh cohort per round inside the chunk, sticky state in the
    device cache: bit for bit the per-round cohort driver after the flush,
    on streaming and on stationary (data-resident) populations."""
    m, rounds = 12, 4
    spec = _tspec(population=m, cohort_size=C, **kw)
    pop = tpop.synthetic_population(m, DIM, batch_size=B, seed=0,
                                    stationary=stationary)
    a, la = _per_round(spec, pop, rounds)
    b, lb, cache = _resident(spec, pop, rounds, 2, m)
    assert (cache.data is not None) == (stationary and name != "dense")
    assert la == lb
    _assert_trees_equal((a.fl.params, a.fl.opt_state, a.fl.residual),
                        (b.fl.params, b.fl.opt_state, b.fl.residual))
    assert torch.equal(a.fl.key, b.fl.key)
    np.testing.assert_array_equal(a.fl.rho, b.fl.rho)
    assert (a.fl.steps, a.fl.resource_spent, a.fl.rounds_done) == \
        (b.fl.steps, b.fl.resource_spent, b.fl.rounds_done)
    _assert_stores_equal(a.store, b.store)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resident_eviction_churn_identity(seed):
    """A cache of S = K + 1 slots forces LRU evictions and re-promotions of
    pending rows every chunk, on a stationary population (data rows
    evicted too), and the store still lands bit-identical to the per-round
    driver after the flush. Evicted rows are gathered copies, so the
    scatters into the cache that follow cannot change them."""
    m, rounds = 9, 6
    spec = _tspec(population=m, cohort_size=C, compressor="topk",
                  compression_ratio=0.25, seed=seed)
    pop = tpop.synthetic_population(m, DIM, batch_size=B, seed=seed,
                                    stationary=True)
    a, la = _per_round(spec, pop, rounds, seed)
    b, lb, cache = _resident(spec, pop, rounds, 1, C + 1, seed)
    assert cache.stats["evictions"] > 0 and not cache.pending
    assert la == lb
    _assert_trees_equal((a.fl.params, a.fl.residual),
                        (b.fl.params, b.fl.residual))
    _assert_stores_equal(a.store, b.store)


def test_resident_reads_no_view_of_the_cache():
    """The FLState's residual and a pending eviction row are copies: a
    later scatter into the cache leaves both as they were."""
    m = 9
    spec = _tspec(population=m, cohort_size=C, compressor="topk",
                  compression_ratio=0.25)
    pop = tpop.synthetic_population(m, DIM, batch_size=B, seed=0)
    st = _tstate(spec)
    cache = tpop.init_resident_cache(spec, st, C + 1, population=pop)
    rng = np.random.default_rng(0)
    st, _ = tpop.run_resident_rounds(spec, st, pop, rng, cache, n_rounds=1,
                                     check_budgets=False)
    view = st.fl.residual.clone()
    assert st.fl.residual.data_ptr() != cache.residual.data_ptr()
    cache.residual.fill_(7.0)
    assert torch.equal(st.fl.residual, view)
    st, _ = tpop.run_resident_rounds(spec, st, pop, rng, cache, n_rounds=1,
                                     check_budgets=False)
    assert cache.pending
    rows = {v: b[j].clone() for v, (b, j) in cache.pending.items()}
    cache.residual.fill_(-3.0)
    for v, (b, j) in cache.pending.items():
        assert torch.equal(b[j], rows[v])


def _count_kernel_calls(monkeypatch):
    calls = []
    real = tops.cohort_gather_scatter

    def spy(cache, slots, rows=None):
        calls.append("gather" if rows is None else "scatter")
        return real(cache, slots, rows)

    monkeypatch.setattr(tops, "cohort_gather_scatter", spy)
    return calls


@pytest.mark.parametrize("stationary", [False, True])
def test_launch_formula_full_population(monkeypatch, stationary):
    """M == C = S, topk, 7 rounds in chunks of 3 (2 chunks + a tail of 1):
    per chunked round 2 kernel calls (residual gather + scatter), 2 more
    with the data cache (the x and y leaves); per chunk 1 (the FLState's
    residual view); the first chunk's promotion 1 (residual rows) + 2 with
    data; the tail's flush 1; the final flush finds the cache empty."""
    calls = _count_kernel_calls(monkeypatch)
    spec = _tspec(population=C, cohort_size=C, compressor="topk",
                  compression_ratio=0.25, eps_th=1e9, c_th=1e9)
    pop = tpop.synthetic_population(C, DIM, batch_size=B, seed=0,
                                    stationary=stationary)
    _, out = tpop.train_population(spec, _tstate(spec), pop, max_rounds=7,
                                   chunk_rounds=3, resident_cache=C)
    per_round = 4 if stationary else 2
    promote = 3 if stationary else 1
    assert out["rounds"] == 7
    assert out["resident_cache"] == {"hits": C, "misses": C,
                                     "evictions": 0, "flushes": 2}
    assert len(calls) == per_round * 6 + 2 + promote + 1


def test_resident_refusals():
    spec = _tspec(population=12, cohort_size=C, compressor="topk",
                  compression_ratio=0.25)
    pop = tpop.synthetic_population(12, DIM, batch_size=B, seed=0,
                                    stationary=True)
    st = _tstate(spec)
    with pytest.raises(ValueError):       # per-round already does this
        tpop.train_population(spec, st, pop, chunk_rounds=1,
                              resident_cache=8)
    with pytest.raises(ValueError):       # a chunk may touch 3 * 4 vids
        tpop.train_population(spec, st, pop, chunk_rounds=3,
                              resident_cache=8)
    with pytest.raises(ValueError):
        tpop.init_resident_cache(spec, st, C - 1, population=pop)
    with pytest.raises(ValueError):
        tpop.init_resident_cache(_tspec(), st, 8)
    cache = tpop.init_resident_cache(spec, st, 8, population=pop)
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):       # data-resident takes no batches
        tpop.run_resident_rounds(spec, st, pop, rng, cache, n_rounds=1,
                                 batches={"x": np.zeros(1)})
    with pytest.raises(ValueError):       # a vid twice in one round
        tpop.run_resident_rounds(spec, st, pop, rng, cache,
                                 cohorts=np.asarray([[0, 1, 1, 2]]))
    with pytest.raises(ValueError):
        tpop.run_resident_rounds(spec, st, pop, rng, cache,
                                 cohorts=np.asarray([[0, 1, 2, 12]]))
    with pytest.raises(ValueError):
        tpop.run_cohort_rounds(spec, st, pop, rng, n_rounds=1,
                               cohort=np.arange(C), resident=cache)
    with pytest.raises(ValueError):
        resident_chunked_round_fn_for(_tspec(population=12, cohort_size=C))
    with pytest.raises(ValueError):
        tpop.init_population_state(_tspec(), tlin.init_linear(DIM,
                                                               device="cpu"),
                                   device="cpu")
    amp = spec.replace(amplify_participation=True)
    with pytest.raises(ValueError):
        tpop.run_cohort_round(amp, _tstate(amp), pop, rng,
                              cohort_sampler=tpop.HeterogeneousCohort(0))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    spec = _tspec(population=12, cohort_size=C)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpop.init_population_state(spec, tlin.init_linear(DIM, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpop.ResidentCache(4, residual_dim=3)


# ----------------------- torch vs JAX, JAX's draws injected ------------------

def _inject(monkeypatch, jspec, jkey, params0):
    """Every pipeline round of the port (per-round, chunk and resident
    chunk) draws what JAX's rounds from ``jkey`` draw, in order."""
    box = [jkey]

    def draws(key, params, tau, pipeline):
        mask, noise, agg_rand, box[0] = jax_pipeline_draws(box[0], params0,
                                                           jspec)
        return mask, noise, agg_rand, key

    monkeypatch.setattr(tstate, "draw_pipeline_round", draws)
    monkeypatch.setattr(tfl, "draw_pipeline_round", draws)


def _assert_close_to_jax(js, ts, atol=1e-5):
    for w, g in zip(jax.tree.leaves(jax.tree.map(np.asarray, js.fl.params)),
                    jax.tree.leaves(tree_to_numpy(ts.fl.params))):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    np.testing.assert_array_equal(ts.store.rho, js.store.rho)
    np.testing.assert_array_equal(ts.store.rounds_participated,
                                  js.store.rounds_participated)
    assert ts.store.max_rho() == js.store.max_rho()
    assert (ts.fl.steps, ts.fl.resource_spent, ts.fl.rounds_done) == \
        (js.fl.steps, js.fl.resource_spent, js.fl.rounds_done)
    if js.store.needs_residual():
        vids = np.arange(js.store.population)
        np.testing.assert_allclose(ts.store.gather_residual(vids),
                                   js.store.gather_residual(vids), rtol=0,
                                   atol=atol)
        assert ts.store.residual_rows() == js.store.residual_rows()


def _assert_records(trecs, jrecs):
    assert len(trecs) == len(jrecs)
    for tr, jr in zip(trecs, jrecs):
        tr, jr = tapi.materialize_record(tr), japi.materialize_record(jr)
        for k in ("round", "iterations", "max_epsilon", "resource_spent",
                  "participants"):
            assert tr[k] == jr[k]
        assert tr["loss"] == pytest.approx(jr["loss"], abs=1e-5)


@pytest.mark.parametrize("name,kw", SETTINGS[1:], ids=SETTING_IDS[1:])
def test_cohort_rounds_match_jax(monkeypatch, name, kw):
    """Per-round cohort rounds over M = 40 virtual clients, then a
    chunk-boundary chunk of 2 (one cohort for the chunk)."""
    m = 40
    tspec = _tspec(population=m, cohort_size=C, **kw)
    jspec = _jspec(population=m, cohort_size=C, **kw)
    tp = tpop.synthetic_population(m, DIM, batch_size=B, seed=1)
    jp = jpop.synthetic_population(m, DIM, batch_size=B, seed=1)
    params0 = jlin.init_linear(DIM)
    js = jpop.init_population_state(jspec, params0)
    ts = _tstate(tspec)
    _inject(monkeypatch, jspec, js.fl.key, params0)
    rt, rj = np.random.default_rng(0), np.random.default_rng(0)
    trecs, jrecs = [], []
    for _ in range(3):
        ts, tr = tpop.run_cohort_round(tspec, ts, tp, rt)
        js, jr = jpop.run_cohort_round(jspec, js, jp, rj)
        trecs.append(tr)
        jrecs.append(jr)
    ts, tr = tpop.run_cohort_rounds(tspec, ts, tp, rt, n_rounds=2)
    js, jr = jpop.run_cohort_rounds(jspec, js, jp, rj, n_rounds=2)
    _assert_records(trecs + tr, jrecs + jr)
    _assert_close_to_jax(js, ts)


@pytest.mark.parametrize("stationary", [False, True],
                         ids=["streaming", "stationary"])
@pytest.mark.parametrize("name,kw", [SETTINGS[2], SETTINGS[3]],
                         ids=[SETTING_IDS[2], SETTING_IDS[3]])
def test_resident_chunks_match_jax(monkeypatch, stationary, name, kw):
    """Resident chunks of 2 with a cache of K + 2 slots over M = 10 (LRU
    evictions and re-promotions): the slot plans, the cache's slot map and
    stats and the ledger exactly as in JAX, params and residual within
    1e-5."""
    m, cap = 10, C + 4
    tspec = _tspec(population=m, cohort_size=C, **kw)
    jspec = _jspec(population=m, cohort_size=C, **kw)
    tp = tpop.synthetic_population(m, DIM, batch_size=B, seed=2,
                                   stationary=stationary)
    jp = jpop.synthetic_population(m, DIM, batch_size=B, seed=2,
                                   stationary=stationary)
    params0 = jlin.init_linear(DIM)
    js = jpop.init_population_state(jspec, params0)
    ts = _tstate(tspec)
    _inject(monkeypatch, jspec, js.fl.key, params0)
    tc = tpop.init_resident_cache(tspec, ts, cap, population=tp)
    jc = jpop.init_resident_cache(jspec, js, cap, population=jp)
    assert (tc.data is None) == (jc.data is None) == (not stationary)
    rt, rj = np.random.default_rng(0), np.random.default_rng(0)
    trecs, jrecs = [], []
    sampler = tpop.UniformCohort(0)
    for chunk in range(3):
        plan = tpop.chunk_cohorts(sampler, 2 * chunk, 2, m, C)
        ts, tr = tpop.run_resident_rounds(tspec, ts, tp, rt, tc, 2)
        js, jr = jpop.run_resident_rounds(jspec, js, jp, rj, jc, 2)
        np.testing.assert_array_equal(tc.slots_for(plan), jc.slots_for(plan))
        np.testing.assert_array_equal(tc.vids, jc.vids)
        np.testing.assert_array_equal(tc.rho, jc.rho)
        assert sorted(tc.pending) == sorted(jc.pending)
        trecs += tr
        jrecs += jr
        np.testing.assert_allclose(ts.fl.residual.numpy(),
                                   np.asarray(js.fl.residual), rtol=0,
                                   atol=1e-5)
    assert tc.stats == jc.stats and tc.stats["evictions"] > 0
    tc.flush(ts.store)
    jc.flush(js.store)
    _assert_records(trecs, jrecs)
    _assert_close_to_jax(js, ts)


def test_train_population_budget_tail_matches_jax(monkeypatch):
    """train_population with a resident cache until privacy binds: chunks
    of 3, then the budget tail through the per-round store path (flush +
    reset): the same stopping round, epsilon, cost, ledger and cache stats
    as JAX."""
    m = 12
    kw = dict(population=m, cohort_size=C, compressor="topk",
              compression_ratio=0.25, eps_th=6.0, sigmas=(1.5,) * C)
    tspec, jspec = _tspec(**kw), _jspec(**kw)
    tp = tpop.synthetic_population(m, DIM, batch_size=B, seed=0)
    jp = jpop.synthetic_population(m, DIM, batch_size=B, seed=0)
    params0 = jlin.init_linear(DIM)
    js0 = jpop.init_population_state(jspec, params0)
    _inject(monkeypatch, jspec, js0.fl.key, params0)
    ts, tout = tpop.train_population(tspec, _tstate(tspec), tp,
                                     chunk_rounds=3, resident_cache=m)
    js, jout = jpop.train_population(jspec, js0, jp, chunk_rounds=3,
                                     resident_cache=m)
    assert tout["rounds"] == jout["rounds"]
    assert tout["rounds"] % 3 != 0              # a tail ran
    assert tout["resident_cache"] == jout["resident_cache"]
    assert tout["resident_cache"]["flushes"] == 2
    for k in ("max_epsilon", "resource_spent"):
        assert tout[k] == jout[k]
    assert tpop.exceeds_population_budgets(tspec, ts) == \
        jpop.exceeds_population_budgets(jspec, js) == "privacy"
    assert tpop.peek_population_epsilon(tspec, ts, 2) == \
        jpop.peek_population_epsilon(jspec, js, 2)
    assert tpop.rounds_within_population_budgets(tspec, ts, 5) == \
        jpop.rounds_within_population_budgets(jspec, js, 5)
    _assert_records(tout["history"], jout["history"])
    _assert_close_to_jax(js, ts)


# ---------------------------------- checkpoints ------------------------------

def test_checkpoint_resume_identity_and_geometry_refusal(tmp_path):
    spec = _tspec(population=30, cohort_size=C, compressor="qsgd",
                  participation=0.5)
    pop = tpop.synthetic_population(30, DIM, batch_size=B, seed=0)
    full, _ = _per_round(spec, pop, 4)
    part = _tstate(spec)
    rng = np.random.default_rng(0)
    for _ in range(2):
        part, _ = tpop.run_cohort_round(spec, part, pop, rng)
    tpop.save_population_state(str(tmp_path), part, extra={"note": "r2"})
    resumed, extra = tpop.load_population_state(str(tmp_path), _tstate(spec))
    assert extra["note"] == "r2" and extra["population"] == 30
    for _ in range(2):
        resumed, _ = tpop.run_cohort_round(spec, resumed, pop, rng)
    _assert_trees_equal((full.fl.params, full.fl.opt_state, full.fl.residual),
                        (resumed.fl.params, resumed.fl.opt_state,
                         resumed.fl.residual))
    assert torch.equal(full.fl.key, resumed.fl.key)
    _assert_stores_equal(full.store, resumed.store)
    with pytest.raises(ValueError, match="population"):
        tpop.load_population_state(str(tmp_path), _tstate(
            spec.replace(population=31)))
    with pytest.raises(ValueError, match="residual_dim"):
        tpop.load_population_state(str(tmp_path), _tstate(
            spec.replace(compressor="none")))


def test_jax_population_checkpoint_loads_in_the_port(tmp_path):
    """A population checkpoint the JAX package wrote (after two qsgd cohort
    rounds) reads back in the port: the store bit for bit through
    ``ClientStore.load``, the K-block arrays under the port's leaf paths."""
    kw = dict(population=30, cohort_size=C, compressor="qsgd",
              participation=0.5)
    jspec, tspec = _jspec(**kw), _tspec(**kw)
    jp = jpop.synthetic_population(30, DIM, batch_size=B, seed=0)
    js = jpop.init_population_state(jspec, jlin.init_linear(DIM))
    rng = np.random.default_rng(0)
    for _ in range(2):
        js, _ = jpop.run_cohort_round(jspec, js, jp, rng)
    jpop.save_population_state(str(tmp_path / "jax"), js)
    ts = _tstate(tspec)
    tpop.save_population_state(str(tmp_path / "torch"), ts)
    assert checkpoint_leaf_paths(str(tmp_path / "jax")) == \
        checkpoint_leaf_paths(str(tmp_path / "torch"))
    store = tpop.ClientStore.load(str(tmp_path / "jax" / "client_store.npz"))
    _assert_stores_equal(store, js.store)
    like = {"params": ts.fl.params, "opt_state": ts.fl.opt_state,
            "residual": ts.fl.residual}
    tree, step, extra = load_checkpoint(str(tmp_path / "jax"), like=like)
    assert step == 2 and extra["population"] == 30
    want = jax.tree.map(np.asarray, {"params": js.fl.params,
                                     "opt_state": js.fl.opt_state,
                                     "residual": js.fl.residual})
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tree)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


def test_device_block_bytes_independent_of_population():
    sizes = {}
    for m in (100, 100_000):
        spec = _tspec(population=m, cohort_size=C, compressor="topk",
                      compression_ratio=0.25)
        pop = tpop.synthetic_population(m, dim=DIM, batch_size=B, seed=1)
        ps = _tstate(spec)
        batch = tpop.cohort_batch(spec, pop, tpop.UniformCohort(0)(0, m, C),
                                  np.random.default_rng(0))
        sizes[m] = tpop.device_block_bytes(ps, batch)
        jspec = _jspec(population=m, cohort_size=C, compressor="topk",
                       compression_ratio=0.25)
        assert sizes[m] == jpop.device_block_bytes(
            jpop.init_population_state(jspec, jlin.init_linear(DIM)), batch)
    assert sizes[100] == sizes[100_000]


# ------------------------- reference values at full size ---------------------

def _quickstart(stationary=True):
    """examples/population_quickstart.py's federation (M = 100,000, K = 16,
    logreg dim 20, batch 8, tau 5, sigma 0.8, TopK 0.25) on the CPU."""
    k, dim, batch = 16, 20, 8
    spec = tapi.FederationSpec(
        n_clients=k, tau=5, loss_fn=tlin.logreg_loss, optimizer=tsgd(0.3),
        clip_norm=1.0, dp=True, population=100_000, cohort_size=k,
        compressor="topk", compression_ratio=0.25, sigmas=(0.8,) * k,
        batch_sizes=(batch,) * k, eps_th=1e9, c_th=1e9)
    pop = tpop.synthetic_population(100_000, dim=dim, batch_size=batch,
                                    alpha=0.3, seed=0, stationary=stationary)
    return spec, pop, tlin.init_linear(dim, device="cpu")


def test_quickstart_resident_step_reference_values(monkeypatch):
    """The quickstart's resident step (S = 256, chunk 8, 24 rounds): the
    JAX package's epsilon, cost and cache stats exactly, the same params,
    rho and residual rows as 24 per-round calls, and the kernel-call
    formula: 4 per round (residual gather and scatter, the x and y
    gathers), 1 per chunk (the residual view), promotions 3 + 3 + 4 (the
    residual rows and the 2 data leaves each chunk, an eviction gather in
    chunk 3) and 1 for the final flush."""
    calls = _count_kernel_calls(monkeypatch)
    spec, pop, params0 = _quickstart()
    rs = tpop.init_population_state(spec, params0, device="cpu")
    rs, out = tpop.train_population(spec, rs, pop, max_rounds=24,
                                    chunk_rounds=8, resident_cache=256)
    assert out["max_epsilon"] == 4.729618937506673
    assert out["resource_spent"] == 720.0 and out["rounds"] == 24
    assert out["resident_cache"] == {"hits": 1, "misses": 382,
                                     "evictions": 126, "flushes": 1}
    assert len(calls) == 4 * 24 + 3 + (3 + 3 + 4) + 1
    ps = tpop.init_population_state(spec, params0, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(24):
        ps, _ = tpop.run_cohort_round(spec, ps, pop, rng,
                                      check_budgets=False)
    _assert_trees_equal(ps.fl.params, rs.fl.params)
    _assert_stores_equal(ps.store, rs.store)
    assert ps.store.residual_rows() == 382


def test_adult2_population_reference_values():
    """Adult-2 at full width (split_iid(adult_like(seed=0), 16), d = 104) as
    an M == C population with the topk25_q100 comm-sweep spec: dense train,
    train_population per round and resident (chunk 4, S = 16) all give 19
    rounds, 570.0 and the JAX package's epsilon, with the same params."""
    fed = split_iid(adult_like(seed=0), 16)
    dim = fed.clients[0].x_train.shape[1]
    x_m = fed.batch_sizes(32)
    dense = tapi.FederationSpec(
        n_clients=16, tau=5, loss_fn=tlin.logreg_loss, optimizer=tsgd(0.3),
        clip_norm=1.0, dp=True, compressor="topk", compression_ratio=0.25,
        sigmas=tuple(float(s) for s in design_sigmas(100, 1.0, x_m, 10.0,
                                                     1e-4)),
        batch_sizes=tuple(x_m), eps_th=10.0, delta=1e-4, c_th=21_000.0)
    sd, od = tapi.train(dense, tapi.init_state(
        dense, tlin.init_linear(dim, device="cpu"), device="cpu"),
        fed.make_sampler(32), max_rounds=20)
    pspec = dense.replace(population=16, cohort_size=16)
    pop = tpop.population_from_federated(fed, 32)
    for kw in (dict(chunk_rounds=1),
               dict(chunk_rounds=4, resident_cache=16)):
        ps, op = tpop.train_population(
            pspec, tpop.init_population_state(
                pspec, tlin.init_linear(dim, device="cpu"), device="cpu"),
            pop, max_rounds=20, **kw)
        for o in (od, op):
            assert o["rounds"] == 19 and o["resource_spent"] == 570.0
            assert o["max_epsilon"] == 9.701942456923485
        _assert_trees_equal(sd.params, ps.fl.params)
        if "resident_cache" in kw:
            assert op["resident_cache"] == {"hits": 48, "misses": 16,
                                            "evictions": 0, "flushes": 2}


if __name__ == "__main__":
    # the max |torch - jax| of params and residual the injected-draw gates
    # see (the tests above assert 1e-5):
    # PYTHONPATH=src python tests/test_torch_population.py
    class _Patch:
        def setattr(self, obj, name, value):
            setattr(obj, name, value)

    for name, kw in SETTINGS[1:]:
        m = 40
        tspec = _tspec(population=m, cohort_size=C, **kw)
        jspec = _jspec(population=m, cohort_size=C, **kw)
        tp = tpop.synthetic_population(m, DIM, batch_size=B, seed=1)
        jp = jpop.synthetic_population(m, DIM, batch_size=B, seed=1)
        params0 = jlin.init_linear(DIM)
        js = jpop.init_population_state(jspec, params0)
        ts = _tstate(tspec)
        _inject(_Patch(), jspec, js.fl.key, params0)
        rt, rj = np.random.default_rng(0), np.random.default_rng(0)
        for _ in range(5):
            ts, _ = tpop.run_cohort_round(tspec, ts, tp, rt)
            js, _ = jpop.run_cohort_round(jspec, js, jp, rj)
        dp = max(float(np.max(np.abs(np.asarray(a) - b))) for a, b in zip(
            jax.tree.leaves(js.fl.params),
            jax.tree.leaves(tree_to_numpy(ts.fl.params))))
        dr = 0.0
        if js.store.needs_residual():
            vids = np.arange(m)
            dr = float(np.max(np.abs(ts.store.gather_residual(vids)
                                     - js.store.gather_residual(vids))))
        print(f"cohort rounds {name}: max|dparams| = {dp:.3e}, "
              f"max|dresidual| = {dr:.3e}")
