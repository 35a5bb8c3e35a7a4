"""The population plane's cohort and resident drivers on the sharded
engines in slab state: ``shard_map`` and ``mesh_2d`` at (2, 1) in one gloo
world of 2 ranks started once for the module.

``init_population_state`` gives such a spec slab state: each rank holds its
block of the K-block's rows, the cohort's residual rows come out of the
host store as the block's, and go back gathered over the client group once
per call, so every rank's ``ClientStore`` stays the same; the resident
chunk gathers only the block's slots out of the (S, D) cache, which stays
whole and alike on every rank. Held here:

* the per-round driver, a chunk-boundary chunk and resident chunks (LRU
  evictions included), streaming and stationary shards: bit for bit the
  same drivers in the whole layout (the slab state made whole), every
  rank's store alike, each rank holding its block's rows;
* a mesh_2d mesh with a pad row (C 5 on (2, 1)) and a shard_map mesh
  smaller than the world (C 3: one block, rank 1 a spectator holding no
  rows): the same drivers bit for bit the whole layout, every store
  alike;
* population checkpoints of slab state: saved once, loaded into slab
  state and into the whole layout, each resuming bit for bit;
* the M == C identity gate: the cohort path equals the dense
  participation path bit for bit, in slab state;
* on JAX's draws (replayed, cut to each block), within 1e-5 of JAX's
  cohort and resident drivers, the ledger, stats and slot map exactly
  (tests/test_torch_population.py holds the single-process drivers so).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import jax
import numpy as np
import pytest
from test_torch_aggregation import jax_pipeline_draws
from test_torch_shard_map import (
    _assert_bitwise,
    _assert_ranks_agree,
    _kw,
)

import repro.api as japi
import repro.population as jpop
from repro.models import linear as jlin
from repro.optim import sgd as jsgd
from repro_torch.launch.mesh import HostWorld

C, DIM = 4, 6
ENGINES = {"shard_map": dict(engine="shard_map"),
           "mesh_2d": dict(engine="mesh_2d", mesh_shape=(2, 1))}
SETTINGS = {
    "q50": dict(participation=0.5),
    "topk25": dict(compressor="topk", compression_ratio=0.25),
    "qsgd4_q50": dict(compressor="qsgd", compression_bits=4,
                      participation=0.5),
}
# (population, per-round rounds, chunk, resident chunks, cache slots)
DRIVE = (10, 2, 2, 3, C + 4)


@pytest.fixture(scope="module")
def world():
    w = HostWorld(2)
    yield w
    w.close()


def _check_layout(got):
    """Rank r holds block r of the K-block: two rows of every leaf."""
    for rank, r in enumerate(got):
        for key in ("layout", "layout_after"):
            lay = r[key]
            assert (lay["mesh_shape"], lay["rows"], lay["client_index"]) \
                == ((2, 1), C // 2, rank)
            assert all(s[0] == C // 2 for part in lay["shapes"]
                       for s in part)


CASES = [(e, s, st) for e in ENGINES for s in SETTINGS
         for st in (False, True)]


@pytest.mark.parametrize("engine,name,stationary", CASES,
                         ids=[f"{e}-{s}-{'stationary' if st else 'streaming'}"
                              for e, s, st in CASES])
def test_drivers_in_slab_state_equal_whole_layout(world, engine, name,
                                                  stationary):
    """Per-round, chunk-boundary and resident chunks over M = 10 (cache of
    K + 4: evictions and re-promotions) in slab state: the state made
    whole, the records, the stores, the cache stats and slot map bit for
    bit the whole layout's, on both ranks alike."""
    kw = _kw(C, **ENGINES[engine], **SETTINGS[name])
    got = world.run(cases.population_forms, kw, DIM, *DRIVE, stationary)
    _check_layout(got)
    _assert_ranks_agree([{k: r[k] for k in ("slab", "whole")} for r in got])
    slab, whole = got[0]["slab"], got[0]["whole"]
    _assert_bitwise(slab, whole)
    assert slab["stats"]["evictions"] > 0


# (engine, clients, each rank's rows: a pad row on rank 1; a spectator)
ODD_MESHES = {"mesh_2d-pad": ("mesh_2d", 5, [3, 3]),
              "shard_map-spectator": ("shard_map", 3, [3, 0])}
ODD_CASES = [(m, s) for m in ODD_MESHES for s in ("q50", "qsgd4_q50")]


@pytest.mark.parametrize("mesh,name", ODD_CASES,
                         ids=[f"{m}-{s}" for m, s in ODD_CASES])
def test_drivers_with_pad_rows_or_a_spectator_equal_whole_layout(
        world, mesh, name):
    """DRIVE's drivers (stationary shards, a cache of K + 4) where the
    clients do not fill the mesh: mesh_2d (2, 1) at C 5 (rank 1's block
    ends in a pad row) and shard_map at C 3 (a (1, 1) mesh: rank 1 holds
    no rows). The state made whole, the records, the stores, the cache
    stats and slot map bit for bit the whole layout's, both ranks' stores
    alike."""
    engine, n, rows = ODD_MESHES[mesh]
    kw = _kw(n, **ENGINES[engine], **SETTINGS[name])
    drive = DRIVE[:4] + (n + 4,)
    got = world.run(cases.population_forms, kw, DIM, *drive, True)
    for rank, r in enumerate(got):
        for key in ("layout", "layout_after"):
            lay = r[key]
            assert (lay["rows"], lay["idle"]) == (rows[rank],
                                                  rows[rank] == 0)
            assert all(s[0] == rows[rank] for part in lay["shapes"]
                       for s in part)
    _assert_ranks_agree([{k: r[k] for k in ("slab", "whole")} for r in got])
    _assert_bitwise(got[0]["slab"], got[0]["whole"])


CKPT_CASES = {"shard_map": ("shard_map", C, [2, 2]),
              "mesh_2d-pad": ("mesh_2d", 5, [3, 3]),
              "shard_map-spectator": ("shard_map", 3, [3, 0])}


@pytest.mark.parametrize("case", list(CKPT_CASES))
def test_population_checkpoint_of_slab_state(world, tmp_path, case):
    """save_population_state of a slab PopulationState after two cohort
    rounds (qsgd4_q50: a residual in the store and the state), loaded
    into a fresh slab state and into the whole layout: both bit for bit
    the saved state and store, the slab holding each rank's rows; one
    more round from each equal to the saved run's next round."""
    engine, n, rows = CKPT_CASES[case]
    kw = _kw(n, **ENGINES[engine], **SETTINGS["qsgd4_q50"])
    got = world.run(cases.population_checkpoint, kw, DIM, 10, 2,
                    str(tmp_path / "ckpt"))
    _assert_ranks_agree([{k: r[k] for k in ("saved", "slab", "whole",
                                            "next")} for r in got])
    assert [r["layout"]["rows"] for r in got] == rows
    r = got[0]
    assert r["saved"]["store"]["residual_rows"] > 0
    for form in ("slab", "whole"):
        _assert_bitwise(r[form], r["saved"])
        _assert_bitwise(r["next"][form], r["next"]["saved"])


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("name", ["q50", "topk25"])
def test_cohort_path_at_m_equals_c_is_the_dense_path(world, engine, name):
    """The identity gate in slab state: M == C with cohort == population
    equals the dense participation path bit for bit (state, key, rho,
    records, residual rows in the store), each rank holding its block."""
    got = world.run(cases.cohort_and_dense,
                    _kw(C, **ENGINES[engine], **SETTINGS[name]), DIM, 3,
                    True)
    _assert_ranks_agree([{k: v for k, v in r.items() if k != "layout"}
                         for r in got])
    for rank, r in enumerate(got):
        assert (r["layout"]["rows"], r["layout"]["client_index"]) == \
            (C // 2, rank)
    r = got[0]
    _assert_bitwise(r["dense"]["params"], r["cohort"]["params"])
    _assert_bitwise(r["dense"]["opt_state"], r["cohort"]["opt_state"])
    np.testing.assert_array_equal(r["dense"]["rho"], r["cohort_rho"])
    np.testing.assert_array_equal(r["dense"]["key"], r["cohort"]["key"])
    assert r["dense_records"] == r["cohort_records"]
    if r["dense"]["residual"] is not None:
        np.testing.assert_array_equal(r["dense"]["residual"],
                                      r["cohort_residual"])


def _jax_drive(kw, stationary):
    """JAX's drivers in DRIVE's order on the same population and rng, and
    the draws its rounds made (the port's operand form)."""
    m, per_round, chunk, chunks, cap = DRIVE
    kw = {k: v for k, v in kw.items() if k not in ("engine", "mesh_shape")}
    jspec = japi.FederationSpec(loss_fn=jlin.logreg_loss,
                                optimizer=jsgd(0.2), kernel_backend="ref",
                                population=m, cohort_size=C, **kw)
    params0 = jlin.init_linear(DIM)
    pop = jpop.synthetic_population(m, DIM, batch_size=kw["batch_sizes"][0],
                                    seed=2, stationary=stationary)
    js = jpop.init_population_state(jspec, params0)
    key, draws = js.fl.key, []
    for _ in range(per_round + chunk * (1 + chunks)):
        mask, noise, agg_rand, key = jax_pipeline_draws(key, params0, jspec)
        draws.append((mask.numpy(), noise.numpy(),
                      None if agg_rand is None else agg_rand.numpy()))
    rng = np.random.default_rng(0)
    recs = []
    for _ in range(per_round):
        js, rec = jpop.run_cohort_round(jspec, js, pop, rng,
                                        check_budgets=False)
        recs.append(rec)
    js, rs = jpop.run_cohort_rounds(jspec, js, pop, rng, n_rounds=chunk,
                                    check_budgets=False)
    recs += rs
    cache = jpop.init_resident_cache(jspec, js, cap, population=pop)
    for _ in range(chunks):
        js, rs = jpop.run_resident_rounds(jspec, js, pop, rng, cache,
                                          n_rounds=chunk,
                                          check_budgets=False)
        recs += rs
    cache.flush(js.store)
    return js, [japi.materialize_record(r) for r in recs], cache, draws


JAX_CASES = [("shard_map", "qsgd4_q50", True), ("mesh_2d", "topk25", False)]


@pytest.mark.parametrize("engine,name,stationary", JAX_CASES,
                         ids=[f"{e}-{s}" for e, s, _ in JAX_CASES])
def test_slab_drivers_match_jax(world, engine, name, stationary):
    """The drivers of DRIVE in slab state on JAX's draws: params and every
    residual row of the store within 1e-5 of JAX's, rho, participation,
    costs, records, cache stats and slot map exactly."""
    kw = _kw(C, **ENGINES[engine], **SETTINGS[name])
    js, jrecs, jcache, draws = _jax_drive(kw, stationary)
    got = world.run(cases.population_forms, kw, DIM, *DRIVE, stationary,
                    draws)
    _assert_ranks_agree([r["slab"] for r in got])
    slab = got[0]["slab"]
    for w, g in zip(jax.tree.leaves(jax.tree.map(np.asarray, js.fl.params)),
                    jax.tree.leaves(slab["state"]["params"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    store = slab["store"]
    np.testing.assert_array_equal(store["rho"], js.store.rho)
    np.testing.assert_array_equal(store["rounds_participated"],
                                  js.store.rounds_participated)
    vids = np.arange(js.store.population)
    np.testing.assert_allclose(store["residual"],
                               js.store.gather_residual(vids), rtol=0,
                               atol=1e-5)
    assert store["residual_rows"] == js.store.residual_rows()
    st = slab["state"]
    assert (st["steps"], st["resource_spent"], st["rounds_done"]) == \
        (js.fl.steps, js.fl.resource_spent, js.fl.rounds_done)
    assert slab["stats"] == jcache.stats
    np.testing.assert_array_equal(slab["vids"], jcache.vids)
    assert len(slab["records"]) == len(jrecs)
    for tr, jr in zip(slab["records"], jrecs):
        for k in ("round", "iterations", "max_epsilon", "resource_spent",
                  "participants"):
            assert tr[k] == jr[k]
        assert tr["loss"] == pytest.approx(jr["loss"], abs=1e-5)
