"""The port's mesh plane (``repro_torch.mesh``, ``launch/mesh``,
``models/sharding``) against the JAX package's, and its ``mesh_2d``
engine in a gloo world of 4 ranks.

* Placement (pure Python): the ``engine="auto"`` decision table and the
  mesh-shape arithmetic of :mod:`repro_torch.mesh.placement`, value by
  value against ``repro.mesh.placement`` (tests/test_mesh.py:78-204), at
  an explicit budget; the no-card default is an H100's, not a v5e's.
* Spec plumbing and the logical-axis rules: ``mesh_shape`` /
  ``sharding_rules`` / ``replica_bytes`` validation and engine keys as in
  the JAX package, ``resolve_spec`` against JAX's under ``mesh2d_rules``,
  ``train_rules`` and ``serve_rules``, ``shard_hint`` the identity on a
  weight's local slice under a model axis (and a refusal of a hint that
  does not name each dim). The model axis itself (``dm > 1``) is held
  against the JAX package in tests/test_torch_mesh_model_axis.py.
* The meshes over a world's ranks, and ``mesh_2d`` at (4, 1): bitwise
  ``shard_map`` where clients divide, within 1e-5 of ``vmap`` where they
  do not (C = 3, 5, 7).
"""
import types

import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import jax
import numpy as np
import pytest
import torch
from test_torch_shard_map import (  # noqa: F401  (worlds is a fixture)
    ATOL,
    DIM,
    ONE_RANK_CASES,
    SETTINGS,
    _assert_bitwise,
    _assert_ranks_agree,
    _batches,
    _kw,
    _leaves,
    worlds,
)

import repro.api as japi
import repro.mesh.engine as jengine
import repro.mesh.placement as jplace
import repro.models.sharding as jshard
import repro_torch.api as tapi
import repro_torch.mesh.engine as tengine
import repro_torch.mesh.placement as tplace
import repro_torch.models.sharding as tshard
from repro.models import linear as jlin
from repro.optim import sgd as jsgd
from repro_torch.models import linear as tlin
from repro_torch.optim import sgd as tsgd

GIB = 1024 ** 3
TOPT, JOPT = tsgd(0.2), jsgd(0.2)


def _tspec(n_clients=4, **kw):
    return tapi.FederationSpec(**_kw(n_clients, **kw),
                               loss_fn=tlin.logreg_loss, optimizer=TOPT)


def _jspec(n_clients=4, **kw):
    return japi.FederationSpec(**_kw(n_clients, **kw),
                               loss_fn=jlin.logreg_loss, optimizer=JOPT)


# ---------------------- placement, value by value ---------------------------

def test_device_memory_budget_default_and_env(monkeypatch):
    """The env override and an explicit default as in the JAX package;
    the no-card default is an H100's memory (the JAX package's is a
    v5e's 16 GiB)."""
    monkeypatch.delenv(tplace.ENV_DEVICE_MEM, raising=False)
    assert tplace.ENV_DEVICE_MEM == jplace.ENV_DEVICE_MEM
    if not torch.cuda.is_available():
        assert tplace.device_memory_budget() == \
            tplace.DEFAULT_DEVICE_MEM_BYTES == tplace.H100_MEM_BYTES
    assert tplace.device_memory_budget(default=7) == 7
    monkeypatch.setenv(tplace.ENV_DEVICE_MEM, str(2 * GIB))
    for mod in (tplace, jplace):
        assert mod.device_memory_budget() == 2 * GIB
        assert mod.device_memory_budget(default=7) == 2 * GIB  # env wins
    monkeypatch.setenv(tplace.ENV_DEVICE_MEM, "0")
    for mod in (tplace, jplace):
        with pytest.raises(ValueError):
            mod.device_memory_budget()


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 6, 8, 16])
def test_decision_table_matches_jax(monkeypatch, n_devices):
    """replica_fits, n_client_shards, model_shards_for, choose_engine and
    default_mesh_shape over a grid of clients, devices, footprints and
    budgets, equal to repro.mesh.placement's."""
    monkeypatch.delenv(tplace.ENV_DEVICE_MEM, raising=False)
    for hbm in (2 * GIB, 16 * GIB):
        for replica in (None, GIB, 3 * GIB, 7 * GIB, 15 * GIB, 100 * GIB):
            if replica is not None:
                assert tplace.replica_fits(replica, hbm) == \
                    jplace.replica_fits(replica, hbm)
                assert tplace.model_shards_for(replica, n_devices, hbm) == \
                    jplace.model_shards_for(replica, n_devices, hbm)
            for n_clients in (1, 2, 4, 6, 7, 8, 23):
                assert tplace.n_client_shards(n_clients, n_devices) == \
                    jplace.n_client_shards(n_clients, n_devices)
                for adv in (False, True):
                    assert tplace.choose_engine(
                        n_clients, n_devices, replica, hbm, adv) == \
                        jplace.choose_engine(n_clients, n_devices, replica,
                                             hbm, adv)
                assert tplace.default_mesh_shape(
                    n_clients, n_devices, replica, hbm) == \
                    jplace.default_mesh_shape(n_clients, n_devices, replica,
                                              hbm)
    for mod in (tplace, jplace):
        with pytest.raises(ValueError):
            mod.default_mesh_shape(4, 0)


def test_pinned_table_values():
    """tests/test_mesh.py's pinned values, in the port."""
    assert tplace.n_client_shards(6, 4) == 3
    assert tplace.n_client_shards(7, 4) == 1
    assert tplace.model_shards_for(7 * GIB, 8, hbm_bytes=2 * GIB) == 4
    assert tplace.model_shards_for(100 * GIB, 8, hbm_bytes=2 * GIB) == 8
    assert tplace.choose_engine(8, 1) == "vmap"
    assert tplace.choose_engine(8, 4) == "shard_map"
    assert tplace.choose_engine(7, 4) == "vmap"
    assert tplace.choose_engine(8, 8, replica_bytes=3 * GIB,
                                hbm_bytes=2 * GIB) == "mesh_2d"
    assert tplace.choose_engine(8, 8, replica_bytes=3 * GIB,
                                hbm_bytes=2 * GIB,
                                adversarial=True) == "shard_map"
    assert tplace.default_mesh_shape(8, 8, replica_bytes=7 * GIB,
                                     hbm_bytes=2 * GIB) == (2, 4)
    assert tplace.default_mesh_shape(2, 8, replica_bytes=3 * GIB,
                                     hbm_bytes=2 * GIB) == (2, 2)


def test_env_override_steers_choose_engine(monkeypatch):
    monkeypatch.setenv(tplace.ENV_DEVICE_MEM, str(2 * GIB))
    assert tplace.choose_engine(8, 8, replica_bytes=3 * GIB) == "mesh_2d"
    monkeypatch.setenv(tplace.ENV_DEVICE_MEM, str(64 * GIB))
    assert tplace.choose_engine(8, 8, replica_bytes=3 * GIB) == "shard_map"


def test_engines_module_uses_the_placement_module():
    """api/engines.py imports the placement functions, it keeps no
    copies."""
    from repro_torch.api import engines
    for name in ("device_memory_budget", "replica_fits", "choose_engine",
                 "default_mesh_shape", "n_client_shards"):
        assert getattr(engines, name) is getattr(tplace, name)
    assert engines.H100_MEM_BYTES == tplace.H100_MEM_BYTES


# ------------------------------ spec plumbing --------------------------------

@pytest.mark.parametrize("bad", [
    dict(engine="vmap", mesh_shape=(2, 2)),
    dict(engine="mesh_2d", mesh_shape=(0, 2)),
    dict(engine="mesh_2d", mesh_shape=(2,)),
    dict(engine="mesh_2d", replica_bytes=-1),
    dict(engine="shard_map", sharding_rules={"tp": None}),
    dict(engine="mesh_2d", attack="sign_flip", byzantine_fraction=0.25,
         aggregator="median"),
], ids=["vmap-shape", "zero", "one-dim", "negative", "rules-1d", "adv"])
def test_spec_mesh_fields_validation_matches_jax(bad):
    with pytest.raises(ValueError):
        _jspec(**bad)
    with pytest.raises(ValueError):
        _tspec(**bad)
    assert _tspec(engine="mesh_2d", mesh_shape=[2, 2]).mesh_shape == (2, 2)


def test_spec_mesh_fields_key_the_engine_cache():
    specs = [_tspec(engine="mesh_2d", mesh_shape=(2, 2)),
             _tspec(engine="mesh_2d", mesh_shape=(4, 1)),
             _tspec(engine="auto", replica_bytes=GIB), _tspec(engine="auto")]
    assert len({s.engine_key() for s in specs}) == 4
    a = _tspec(engine="mesh_2d", sharding_rules={"fsdp": "model",
                                                 "tp": None})
    b = _tspec(engine="mesh_2d", sharding_rules=[("tp", None),
                                                 ("fsdp", "model")])
    assert a.sharding_rules == b.sharding_rules == _jspec(
        engine="mesh_2d", sharding_rules={"fsdp": "model",
                                          "tp": None}).sharding_rules
    assert a.engine_key() == b.engine_key()


def test_auto_on_one_rank_and_the_model_axis(monkeypatch):
    """One rank: engine='auto' is vmap; a replica over the budget resolves
    to mesh_2d, whose build raises ValueError saying how many ranks the
    replica needs, and an explicit model axis over 1 needs more ranks than
    the world has (the JAX package keeps vmap on one device)."""
    monkeypatch.setenv(tplace.ENV_DEVICE_MEM, "4096")
    spec = _tspec(engine="auto")
    assert tapi.resolve_engine(spec) == "vmap"
    assert tapi.resolve_engine(spec.replace(replica_bytes=4096)) == "vmap"
    big = spec.replace(replica_bytes=4097)
    assert tapi.resolve_engine(big) == "mesh_2d"
    assert tapi.resolve_engine(big.replace(
        aggregator="median", participation=0.5)) == "vmap"
    with pytest.raises(ValueError, match="needs a model axis of at least 2 "
                                         "ranks"):
        tapi.round_fn_for(big)
    with pytest.raises(ValueError, match="needs 2 ranks, only 1"):
        tapi.round_fn_for(_tspec(engine="mesh_2d", mesh_shape=(1, 2)))


# ---------------------------- logical-axis rules -----------------------------

LOGICAL = [("fsdp", "tp"), ("wg", "tp", None), ("batch", "seq", "tp"),
           ("client",), ("client", "fsdp", "tp"), ("act",), (None, "tp"),
           ("kv_tp", "cache_seq"), ()]
SHAPES = [None, (4, 6, 8), (2, 3, 16), (8, 8, 8)]


@pytest.mark.parametrize("rules", ["mesh2d_rules", "train_rules",
                                   "serve_rules"])
@pytest.mark.parametrize("sizes", [
    dict(client=1, model=1), dict(client=2, model=2),
    dict(client=2, replica=2, model=4), dict(data=4, model=2)])
def test_resolve_spec_matches_jax(rules, sizes):
    """First-dim-wins dedupe and the divisibility drop, spec for spec, on
    meshes given by their axis sizes."""
    mesh = types.SimpleNamespace(shape={"client": 1, "replica": 1,
                                        "data": 1, "model": 1, **sizes})
    for logical in LOGICAL:
        for shape in SHAPES:
            if shape is not None and len(shape) < len(logical):
                continue
            with jshard.axis_rules(mesh, getattr(jshard, rules)()):
                want = tuple(jshard.resolve_spec(logical, shape))
            with tshard.axis_rules(mesh, getattr(tshard, rules)()):
                got = tshard.resolve_spec(logical, shape)
            assert tuple(got) == want, (logical, shape)
    # outside any rules context: the identity placement
    assert tshard.resolve_spec(("fsdp", "tp")) == tshard.P() == ()


def test_spec_tree_matches_jax():
    mesh = types.SimpleNamespace(shape={"client": 2, "model": 2})
    logical = {"w": ("fsdp", "tp"), "b": ("tp",),
               "blocks": [("wg", "tp", None), ()]}
    shapes = {"w": torch.zeros(4, 6), "b": torch.zeros(3),
              "blocks": [torch.zeros(2, 4, 5), torch.zeros(())]}
    with tshard.axis_rules(mesh, tshard.mesh2d_rules()):
        got = tshard.spec_tree(logical, shapes)
        got_free = tshard.spec_tree(logical)
    with jshard.axis_rules(mesh, jshard.mesh2d_rules()):
        want = jshard.spec_tree(logical, jax.tree.map(
            lambda x: np.zeros(tuple(x.shape)), shapes))
        want_free = jshard.spec_tree(logical)
    assert jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec)) == jax.tree.map(
        tuple, got, is_leaf=lambda x: isinstance(x, tshard.P))
    assert [tuple(x) for x in jax.tree.leaves(
        want_free, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))] == \
        [got_free["b"], got_free["blocks"][0], got_free["blocks"][1],
         got_free["w"]]


def test_shard_hint_identity_and_model_axis_refusal():
    """shard_hint is the identity everywhere; under a model axis of 2 it
    checks that a hint names each dim of its (local) tensor, and
    model_dim gives the dim the model axis splits; a weight's hint over
    the serving mesh's data axis too passes (its data blocks are gathered
    before the layer runs), and a hint that would split a tensor over any
    other mesh axis (a federated mesh's "replica") raises."""
    x = torch.ones(4, 6)
    assert tshard.shard_hint(x, "fsdp", "tp") is x
    one = types.SimpleNamespace(shape={"client": 4, "model": 1})
    with tshard.axis_rules(one, tshard.mesh2d_rules()):
        assert tshard.shard_hint(x, "fsdp", "tp") is x
        assert tshard.shard_hint(x, "client", "act") is x
        assert tshard.model_dim("fsdp", "tp") == -1
    two = types.SimpleNamespace(shape={"client": 2, "model": 2})
    with tshard.axis_rules(two, tshard.mesh2d_rules()):
        assert tshard.shard_hint(x, "fsdp", "tp") is x
        assert tshard.shard_hint(torch.ones(3, 5), "fsdp", "tp") is not None
        assert tshard.model_dim("fsdp", "tp") == 0
        assert tshard.model_dim("wg", "tp", None) == 1
        assert tshard.model_dim("batch", "seq", None) == -1
        with pytest.raises(ValueError, match="2 logical axes"):
            tshard.shard_hint(torch.ones(2, 3, 4), "fsdp", "tp")
    data = types.SimpleNamespace(shape={"data": 2, "model": 2})
    with tshard.axis_rules(data, tshard.serve_rules(fsdp_over_data=True)):
        assert tshard.shard_hint(x, "fsdp", "tp") is x
        assert tshard.model_dim("fsdp", "tp") == 1
        assert tshard.model_dim("tp", None, "fsdp") == 0
    replica = types.SimpleNamespace(shape={"client": 2, "replica": 2,
                                           "model": 2})
    with tshard.axis_rules(replica, tshard.train_rules()):
        with pytest.raises(NotImplementedError, match="'replica'"):
            tshard.shard_hint(x, "fsdp", "tp")


@pytest.mark.parametrize("dm", [1, 2, 4])
def test_default_param_specs_match_jax(dm):
    tree = {"w": np.zeros((4, 6, 8)), "b": np.zeros((4, 8)),
            "step": np.zeros((4,), np.int32), "odd": np.zeros((4, 3, 5))}
    want = jengine.default_param_specs(tree, dm)
    got = tengine.default_param_specs(
        {k: torch.as_tensor(v) for k, v in tree.items()}, dm)
    assert {k: tuple(v) for k, v in want.items()} == \
        {k: tuple(v) for k, v in got.items()}


# --------------------------- meshes over the ranks ---------------------------

def test_meshes_over_a_world_of_four(worlds):
    """make_mesh_2d lays contiguous row-major client slabs; sub-meshes
    leave the remaining ranks out; the federated and serving views keep
    the model axis; the production mesh and a model axis over 1 raise."""
    got = worlds(4).run(cases.mesh_views)
    for rank, v in enumerate(got):
        shape, names, coord, client, model = v["m22"]
        assert (shape, names) == ((2, 2), ("client", "model"))
        assert coord == (rank // 2, rank % 2)
        assert client == [rank % 2, rank % 2 + 2]
        assert model == [rank - rank % 2, rank - rank % 2 + 1]
        assert v["m41"] == ((4, 1), (rank, 0), [0, 1, 2, 3])
        assert v["m31"] == (None if rank == 3 else (rank, 0))
        assert v["fed"] == ((2, 1, 2), ("client", "replica", "model"),
                            [[[0, 1]], [[2, 3]]])
        assert v["serve"] == ((2, 2), ("data", "model"), [[0, 1], [2, 3]])
        assert v["n_clients"] == (4, 6)
        assert v["same_mesh"] and v["world"] == 4
        assert v["too_big"][0] == "ValueError"
        assert "needs 6 ranks" in v["too_big"][1]
        for name, need in (("production", 256), ("multi_pod", 512)):
            assert v[name][0] == "ValueError"
            assert f"{need} ranks, have 4" in v[name][1]
        assert v["model_axis"] is None          # (2, 2) builds


# ------------------------------ mesh_2d engine -------------------------------

@pytest.mark.parametrize("n_clients", [4, 8])
@pytest.mark.parametrize("name", ["dense", "qsgd4-q50"])
def test_degenerate_mesh_2d_equals_shard_map_bitwise(worlds, n_clients,
                                                     name):
    """mesh_2d at (4, 1) with dividing clients is shard_map bit for bit."""
    kw = SETTINGS[name]
    batches = _batches(n_clients)
    world = worlds(4)
    a = world.run(cases.federate, _kw(n_clients, engine="shard_map", **kw),
                  DIM, batches)
    b = world.run(cases.federate, _kw(n_clients, engine="mesh_2d",
                                      mesh_shape=(4, 1), **kw),
                  DIM, batches)
    _assert_ranks_agree(b)
    _assert_bitwise(a[0], b[0])


PADDED = [(3, "dense"), (5, "dense"), (7, "dense"), (5, "topk25"),
          (7, "q50"), (5, "local_only"), (3, "momentum-keep")]


@pytest.mark.parametrize("n_clients,name", PADDED,
                         ids=[f"C{c}-{n}" for c, n in PADDED])
def test_padded_mesh_2d_matches_vmap(worlds, n_clients, name):
    """mesh_2d at (4, 1) with clients that do not divide 4: pad rows copy
    client 0 and weigh 0; within 1e-5 of the port's vmap, ledger exact."""
    kw = ONE_RANK_CASES[name]
    batches = _batches(n_clients)
    want = cases.federate(_kw(n_clients, engine="vmap", **kw), DIM, batches)
    got = worlds(4).run(cases.federate,
                        _kw(n_clients, engine="mesh_2d", mesh_shape=(4, 1),
                            **kw), DIM, batches)
    _assert_ranks_agree(got)
    st, ws = got[0]["state"], want["state"]
    for w, g in zip(_leaves((ws["params"], ws["opt_state"], ws["residual"])),
                    _leaves((st["params"], st["opt_state"],
                             st["residual"]))):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(st["rho"], ws["rho"])
    np.testing.assert_array_equal(st["key"], ws["key"])
    for wr, gr in zip(want["records"], got[0]["records"]):
        assert gr["loss"] == pytest.approx(wr["loss"], abs=ATOL)
        assert {k: v for k, v in gr.items() if k != "loss"} == \
            {k: v for k, v in wr.items() if k != "loss"}


def test_fewer_blocks_than_ranks_hand_results_to_the_rest(worlds):
    """C = 3 on 4 ranks: shard_map takes 3 client blocks; the fourth rank
    takes none and receives the round's results; train stops on the
    budget at the vmap round, epsilon and cost."""
    kw = _kw(3, engine="shard_map", eps_th=6.0, c_th=1e9)
    got = worlds(4).run(cases.train_to_budget, kw, DIM, 20)
    _assert_ranks_agree(got)
    want = cases.train_to_budget(dict(kw, engine="vmap"), DIM, 20)
    assert (got[0]["rounds"], got[0]["max_epsilon"],
            got[0]["resource_spent"]) == (want["rounds"],
                                          want["max_epsilon"],
                                          want["resource_spent"])
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=0,
                               atol=ATOL)


def test_mesh_quickstart_example_runs_on_two_ranks():
    """examples/mesh_quickstart_torch.py starts its gloo ranks and ends
    with 0: vmap / shard_map / mesh_2d at (2, 1) and (1, 2) agree, the
    oversized replica trains on a (1, 2) mesh, the padded clients match
    vmap."""
    import os
    import pathlib
    import subprocess
    import sys

    from _torch_threads import SUBPROCESS_ENV
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, **SUBPROCESS_ENV,
           "PYTHONPATH": str(root / "src")}
    out = subprocess.run(
        [sys.executable, str(root / "examples" / "mesh_quickstart_torch.py"),
         "--ranks", "2", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "mesh_2d (1, 2)" in out.stdout
    assert "engine=mesh_2d, mesh (1, 2): loss" in out.stdout
    assert out.stdout.rstrip().endswith("done.")
    assert out.stdout.count("== 1.") == 1          # rank 0 prints alone


def test_host_world_raises_at_the_first_failing_rank():
    """A rank that raises while another waits in an all-reduce for it:
    ``HostWorld.run`` closes the world and raises rank 1's error within
    seconds, not after the world's collective timeout."""
    import time

    from repro_torch.launch.mesh import WORLD_TIMEOUT_S, HostWorld
    world = HostWorld(2)
    try:
        assert world.run(int, 7) == [7, 7]       # both ranks up
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            world.run(cases.rank_one_fails)
        assert time.perf_counter() - t0 < 30 < WORLD_TIMEOUT_S
        assert world._procs is None              # closed
    finally:
        world.close(force=True)


@pytest.mark.parametrize("driver", ["run_rounds", "train", "cohort"])
def test_mesh_2d_drivers_on_two_ranks(worlds, driver):
    """mesh_2d (2, 1) in a world of 2 through run_rounds (bitwise
    shard_map's), train at C = 3 (padded; vmap's rounds, epsilon and cost,
    losses within 1e-5) and the cohort path at M == C (bitwise the dense
    participation path)."""
    world = worlds(2)
    mesh = dict(engine="mesh_2d", mesh_shape=(2, 1))
    if driver == "run_rounds":
        kw = _kw(4, participation=0.5)
        batches = _batches(4, rounds=3)
        a = world.run(cases.federate, dict(kw, engine="shard_map"), DIM,
                      batches, None, True)
        b = world.run(cases.federate, dict(kw, **mesh), DIM, batches, None,
                      True)
        _assert_ranks_agree(b)
        _assert_bitwise(a[0], b[0])
    elif driver == "train":
        kw = _kw(3, eps_th=6.0, c_th=1e9)
        got = world.run(cases.train_to_budget, dict(kw, **mesh), DIM, 20, 2)
        _assert_ranks_agree(got)
        want = cases.train_to_budget(dict(kw, engine="vmap"), DIM, 20, 2)
        assert (got[0]["rounds"], got[0]["max_epsilon"],
                got[0]["resource_spent"]) == (want["rounds"],
                                              want["max_epsilon"],
                                              want["resource_spent"])
        np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=0,
                                   atol=ATOL)
    else:
        got = world.run(cases.cohort_and_dense,
                        _kw(4, participation=0.5, **mesh), DIM, 3)
        _assert_ranks_agree(got)
        r = got[0]
        _assert_bitwise(r["dense"]["params"], r["cohort"]["params"])
        np.testing.assert_array_equal(r["dense"]["rho"], r["cohort_rho"])
        assert r["dense_records"] == r["cohort_records"]


@pytest.mark.parametrize("engine", ["shard_map", "mesh_2d"])
def test_world_of_one_train_and_chunks_equal_vmap_bitwise(engine):
    """A world of one in this process: train (chunks of 2, until the
    budget binds) and one run_rounds chunk equal vmap's bit for bit."""
    extra = {"mesh_shape": (1, 1)} if engine == "mesh_2d" else {}
    kw = _kw(4, eps_th=6.0, c_th=1e9, compressor="topk",
             compression_ratio=0.25)
    got = cases.train_to_budget(dict(kw, engine=engine, **extra), DIM, 20, 2)
    want = cases.train_to_budget(dict(kw, engine="vmap"), DIM, 20, 2)
    _assert_bitwise(want, got)
    batches = _batches(4, rounds=3)
    _assert_bitwise(
        cases.federate(_kw(4, engine="vmap"), DIM, batches, None, True),
        cases.federate(_kw(4, engine=engine, **extra), DIM, batches, None,
                       True))
