"""Slab-local state of the port's ``engine="shard_map"`` between rounds, in
one gloo world of 4 ranks started once for the module.

On a world of several ranks ``init_state`` gives a ``shard_map`` spec slab
state, as the JAX package's round keeps params, optimizer state and
residual at ``P("client")``: each rank holds its client block's rows, and
the drivers run the engine's slab round on it, drawing only its block's
rows of each round's randomness. Held here at C 4 and 8 (four blocks) and
C 6 (three blocks: the fourth rank is outside the mesh and holds no rows),
dense, qsgd8 at q 0.5, ``local_only``, ``trimmed_mean``, the secure sum
and a sign-flip attack under the median:

* each rank's resident state: exactly its block's rows, none outside the
  mesh;
* ``whole_state`` after ``run_round``, ``run_rounds`` and ``train`` equals
  the whole-layout run (the whole-tree round on the same ranks) bit for
  bit, and the port's ``vmap`` within 1e-5, the ledger, key and records
  exactly;
* on JAX's draws (replayed, cut to each block) within 1e-5 of JAX's
  ``shard_map`` engine, the ledger and key exactly;
* checkpoints cross the layouts (slab, whole, ``vmap``);
* a dense ``full_average`` round makes one f32 all-reduce over the client
  group and no row gather, and each rank draws only its block's rows.
"""
import math

import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import numpy as np
import pytest
from test_torch_shard_map import (
    ATOL,
    DIM,
    _assert_bitwise,
    _assert_close_to_jax,
    _assert_ranks_agree,
    _batches,
    _jax_run,
    _kw,
    _leaves,
)

from repro_torch.kernels.counter_rng import AGG_RAND, MASK, NOISE
from repro_torch.launch.mesh import HostWorld
from repro_torch.mesh.placement import n_client_shards
from repro_torch.models import linear as tlin
from repro_torch.utils.tree import tree_flatten

RANKS = 4
SETTINGS = {
    "dense": {},
    "qsgd8_q50": dict(participation=0.5, compressor="qsgd",
                      compression_bits=8),
    "local_only": dict(topology="local_only"),
    "trimmed_mean": dict(aggregator="trimmed_mean", trim_fraction=0.25,
                         participation=0.5),
    "secure": dict(secure_agg=True, dp_accounting="central"),
    "attack": dict(attack="sign_flip", byzantine_fraction=0.25,
                   aggregator="median"),
}
CASES = [(c, name) for c in (4, 8, 6) for name in SETTINGS]


@pytest.fixture(scope="module")
def world():
    w = HostWorld(RANKS)
    yield w
    w.close()


def _smap_kw(n_clients, name, **extra):
    return _kw(n_clients, engine="shard_map", **SETTINGS[name], **extra)


def _close(got, want, atol=ATOL):
    lg, lw = _leaves(got), _leaves(want)
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _ledger_equal(got, want):
    for k in ("rho", "key"):
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["steps"], got["resource_spent"], got["rounds_done"]) == \
        (want["steps"], want["resource_spent"], want["rounds_done"])


def _check_rows(got, n_clients, name):
    """Each rank holds exactly its block's rows of every leaf (the linear
    model's whole leaves, the residual whole in D), a rank outside the
    mesh none; the bytes are those rows'."""
    shards = n_client_shards(n_clients, RANKS)
    block = n_clients // shards
    one = [tuple(x.shape) for x in
           tree_flatten(tlin.init_linear(DIM, device="meta"))[0]]
    n = sum(math.prod(s) for s in one)
    for rank, r in enumerate(got):
        rows = block if rank < shards else 0
        for key in ("layout", "layout_after"):
            lay = r[key]
            assert lay["mesh_shape"] == (shards, 1)
            assert (lay["rows"], lay["idle"]) == (rows, rank >= shards)
            assert lay["client_index"] == (rank if rank < shards else None)
            p_shapes, s_shapes, r_shapes = lay["shapes"]
            assert p_shapes == [(rows,) + s for s in one]
            assert all(s[0] == rows for s in s_shapes)
            want_r = ([(rows, n)] if SETTINGS[name].get("compressor")
                      else [])
            assert r_shapes == want_r
            assert lay["bytes"] == 4 * sum(
                math.prod(s) for part in lay["shapes"] for s in part)


@pytest.mark.parametrize("n_clients,name", CASES,
                         ids=[f"C{c}-{n}" for c, n in CASES])
def test_slab_state_rounds_equal_whole_layout_and_vmap(world, n_clients,
                                                       name):
    """Three rounds per round and as one chunk: each rank holds only its
    block's rows, and whole_state equals the whole-layout run bit for bit,
    vmap within 1e-5, the ledger, key and records exactly; eval_params
    alike on every rank, the spectator's included."""
    batches = _batches(n_clients, rounds=3)
    kw = _smap_kw(n_clients, name)
    got = world.run(cases.slab_and_whole, kw, DIM, batches)
    _check_rows(got, n_clients, name)
    _assert_ranks_agree([{k: r[k] for k in ("slab", "whole", "slab_chunk",
                                            "whole_chunk")} for r in got])
    vkw = dict(kw, engine="vmap")
    want = cases.federate(vkw, DIM, batches)
    want_chunk = cases.federate(vkw, DIM, batches, None, True)
    r0 = got[0]
    for form, ref in (("", want), ("_chunk", want_chunk)):
        slab, whole = r0["slab" + form], r0["whole" + form]
        _assert_bitwise(slab["state"], whole["state"])
        assert slab["records"] == whole["records"]
        st = slab["state"]
        _close((st["params"], st["opt_state"], st["residual"]),
               (ref["state"]["params"], ref["state"]["opt_state"],
                ref["state"]["residual"]))
        _ledger_equal(st, ref["state"])
        for g, w in zip(slab["records"], ref["records"]):
            assert g["loss"] == pytest.approx(w["loss"], abs=ATOL)
            assert {k: v for k, v in g.items() if k != "loss"} == \
                {k: v for k, v in w.items() if k != "loss"}
    if SETTINGS[name].get("topology") != "local_only":
        _assert_bitwise(r0["slab"]["eval"], r0["whole"]["eval"])


JAX_CASES = [(4, "qsgd8_q50"), (6, "dense"), (6, "trimmed_mean"),
             (6, "secure"), (8, "local_only"), (4, "attack")]


@pytest.mark.parametrize("n_clients,name", JAX_CASES,
                         ids=[f"C{c}-{n}" for c, n in JAX_CASES])
def test_slab_state_matches_jax_shard_map(world, n_clients, name):
    """Two rounds in slab state on JAX's draws (each rank's block of them):
    whole_state within 1e-5 of JAX's shard_map engine, rho, key order,
    costs and records exactly, the ranks alike."""
    batches = _batches(n_clients)
    kw = _smap_kw(n_clients, name)
    js, jrecs, draws = _jax_run(kw, batches)
    got = world.run(cases.federate, kw, DIM, batches, draws)
    _assert_ranks_agree(got)
    _assert_close_to_jax(js, jrecs, got[0])


TRAIN_CASES = [(6, "qsgd8_q50"), (4, "local_only"), (8, "trimmed_mean")]


@pytest.mark.parametrize("n_clients,name", TRAIN_CASES,
                         ids=[f"C{c}-{n}" for c, n in TRAIN_CASES])
def test_slab_state_train_equals_whole_layout_and_vmap(world, n_clients,
                                                       name):
    """train in chunks of 2 until the privacy budget binds (two chunks and
    a tail round), an eval at each chunk boundary and after the tail
    through eval_params: the slab run's state and losses equal the
    whole-layout run's bit for bit (the evals too under full_average),
    vmap's within 1e-5 with the same rounds, epsilon and cost."""
    kw = _smap_kw(n_clients, name, eps_th=20.0, c_th=1e9)
    slab = world.run(cases.slab_train, kw, DIM, 20, 2)
    whole = world.run(cases.slab_train, kw, DIM, 20, 2, False)
    want = cases.slab_train(dict(kw, engine="vmap"), DIM, 20, 2)
    _assert_ranks_agree(slab)
    s = slab[0]
    evals = ("evals", "eval_losses", "best_round")
    _assert_bitwise({k: v for k, v in s.items() if k not in evals},
                    {k: v for k, v in whole[0].items() if k not in evals})
    if name != "local_only":
        _assert_bitwise({k: s[k] for k in evals},
                        {k: whole[0][k] for k in evals})
    assert s["rounds"] % 2 == 1 and s["rounds"] > 2        # a tail ran
    assert (s["rounds"], s["max_epsilon"], s["resource_spent"]) == \
        (want["rounds"], want["max_epsilon"], want["resource_spent"])
    _close((s["state"]["params"], s["state"]["opt_state"],
            s["state"]["residual"]),
           (want["state"]["params"], want["state"]["opt_state"],
            want["state"]["residual"]))
    _ledger_equal(s["state"], want["state"])
    np.testing.assert_allclose(s["losses"], want["losses"], rtol=0,
                               atol=ATOL)
    _close(s["evals"], want["evals"])


@pytest.mark.parametrize("n_clients,name", [(6, "qsgd8_q50"),
                                            (8, "secure")],
                         ids=["C6-qsgd8_q50", "C8-secure"])
def test_checkpoints_cross_the_layouts(world, tmp_path, n_clients, name):
    """A slab run's checkpoint resumes in slab state to the uninterrupted
    run bit for bit, and loads into the whole layout and into vmap
    exactly as the slab state's whole trees; a vmap run's checkpoint
    loads into slab state exactly and continues bit for bit as the whole
    layout does from it (the rank outside the mesh at C 6 included)."""
    batches = _batches(n_clients, rounds=4)
    kw = _smap_kw(n_clients, name)
    got = world.run(cases.slab_checkpoint, kw, DIM, batches, str(tmp_path),
                    2)
    _assert_ranks_agree(got)
    r = got[0]
    for reader in ("slab", "whole", "vmap"):
        _assert_bitwise(r[f"slab>{reader}@load"], r["slab@save"])
        _assert_bitwise(r[f"vmap>{reader}@load"], r["vmap@save"])
    _assert_bitwise(r["slab>slab"], r["slab"])
    _assert_bitwise(r["slab>whole"], r["slab"])
    _assert_bitwise(r["vmap>slab"], r["vmap>whole"])
    _assert_bitwise(r["vmap>vmap"], r["vmap"])
    for a, b in ((r["slab>vmap"], r["slab"]), (r["vmap>slab"], r["vmap"])):
        _close((a["params"], a["opt_state"], a["residual"]),
               (b["params"], b["opt_state"], b["residual"]))
        _ledger_equal(a, b)


@pytest.mark.parametrize("n_clients,name", [(8, "dense"), (6, "dense"),
                                            (4, "qsgd8_q50")],
                         ids=["C8-dense", "C6-dense", "C4-qsgd8_q50"])
def test_round_collectives_and_draws(world, n_clients, name):
    """One run_round in slab state. Dense full_average: each rank of the
    mesh makes exactly one all-reduce, f32, over the client group (the
    block means), and no row gather; the rank outside the mesh only
    receives the metrics. Every rank's noise (and qsgd's uniforms) covers
    only its block's rows at their global ids, the mask all C."""
    shards = n_client_shards(n_clients, RANKS)
    block = n_clients // shards
    got = world.run(cases.slab_round_traffic, _smap_kw(n_clients, name),
                    DIM, _batches(n_clients, rounds=1)[0])
    for rank, r in enumerate(got):
        rows = tuple(range(rank * block, (rank + 1) * block)
                     if rank < shards else ())
        assert tuple(r["rows"]) == rows
        noise = [d for p, d in r["draws"] if p == NOISE]
        assert noise == [rows]
        if name == "dense":
            spectators = ([("broadcast_object_list",)]
                          if shards < RANKS else [])
            if rank < shards:
                # the params' and metrics' block means, in one buffer
                assert [c[:2] for c in r["calls"]] == \
                    [("all_reduce", "torch.float32")] + spectators
            else:
                assert r["calls"] == spectators
        else:
            assert [d for p, d in r["draws"] if p == MASK] == \
                [tuple(range(n_clients))]
            assert [d for p, d in r["draws"] if p == AGG_RAND] == [rows]
            # one all-reduce of the masked sums and no row gather
            assert [c for c in r["calls"] if c[0] == "all_reduce"] == \
                [r["calls"][0]] and r["calls"][0][1] == "torch.float32"
