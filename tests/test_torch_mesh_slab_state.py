"""Slab-local state of the port's ``mesh_2d`` engine between rounds, in one
gloo world of 4 ranks started once for the module, as the meshes (2, 2)
and (4, 1).

On a world of several ranks ``init_state`` gives a mesh_2d spec slab state:
each rank holds its client block's rows (pad rows past the last client
included) of its model slices, and the drivers run the engine's slab round
on it, drawing their slab's addresses of the round's noise from the
counter generator. Held here, at C 3 and 5 (padded) and 4, dense and
qsgd8 at q 0.5, ``full_average`` and ``local_only``:

* each rank's resident state: exactly its block's rows of its slices;
* a batch given whole or as the block's rows: the same rounds;
* ``whole_state`` after ``run_round``, ``run_rounds`` and ``train`` (eval
  every round through ``eval_params``) equals the whole-layout mesh run
  (the whole-tree round on the same ranks) bit for bit, and the port's
  ``vmap`` within 1e-5, the ledger and the key exactly; ``eval_params``
  alike on every rank;
* checkpoints: a slab run's resumes in slab state bit for bit and loads
  into the whole layouts exactly, and a ``vmap`` run's loads into slab
  state and continues as the whole mesh layout does, bit for bit;
* gemma3's smoke transformer cells (tests/test_torch_mesh_model_axis_gemma3.py)
  through slab state on JAX's draws, within 1e-5 of each tensor's largest
  magnitude of JAX's ``vmap`` round.
"""
import math

import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import numpy as np
import pytest
import torch
from _torch_model_axis_jax import _JAX_ROUNDS, _jax_round, jax_params
from test_torch_mesh_model_axis_gemma3 import _gemma_cfgs
from test_torch_shard_map import (
    ATOL,
    DIM,
    _assert_bitwise,
    _assert_ranks_agree,
    _batches,
    _kw,
    _leaves,
)

from repro_torch.launch.mesh import HostWorld
from repro_torch.models import linear as tlin
from repro_torch.models import sharding
from repro_torch.models.transformer import Transformer
from repro_torch.utils.convert import (
    transformer_params_from_jax,
    tree_to_numpy,
)
from repro_torch.utils.tree import tree_flatten

# (mesh, clients, setting): padded C 3 / 5 and a dividing C 4 on both
# meshes, dense and qsgd8 at q 0.5, full_average and local_only
SETTINGS = {
    "dense": {},
    "qsgd8_q50": dict(participation=0.5, compressor="qsgd",
                      compression_bits=8),
    "local_only": dict(topology="local_only"),
}
CASES = [((2, 2), 3, "dense"), ((2, 2), 5, "qsgd8_q50"),
         ((2, 2), 5, "local_only"), ((2, 2), 4, "qsgd8_q50"),
         ((4, 1), 5, "dense"), ((4, 1), 3, "qsgd8_q50"),
         ((4, 1), 3, "local_only"), ((4, 1), 4, "dense")]


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


def _mesh_kw(mesh, n_clients, name, **extra):
    return _kw(n_clients, engine="mesh_2d", mesh_shape=mesh,
               **SETTINGS[name], **extra)


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


def _expected_slab(mesh, n_clients, layout, name):
    """The leaf shapes a rank should hold: its block's rows of the linear
    model's whole leaves cut along their split dims, and the residual's
    block rows whole in D."""
    dc, dm = mesh
    block = -(-n_clients // dc)
    one = tlin.init_linear(DIM, device="meta")
    dims = tree_flatten(sharding.param_split_dims(one, dm))[0]
    params = []
    for x, d in zip(tree_flatten(one)[0], dims):
        shape = list(x.shape)
        if d >= 0:
            shape[d] //= dm
        params.append((block,) + tuple(shape))
    n = sum(x.numel() for x in tree_flatten(one)[0])
    residual = [(block, n)] if SETTINGS[name].get("compressor") else []
    return block, params, residual


@pytest.mark.parametrize("mesh,n_clients,name", CASES,
                         ids=[f"{m[0]}x{m[1]}-C{c}-{n}"
                              for m, c, n in CASES])
def test_slab_state_rounds_equal_whole_mesh_and_vmap(world, mesh, n_clients,
                                                     name):
    """Three rounds per round and as one chunk: each rank holds only its
    slab (rows and slices, step counters none here: SGD), and whole_state
    equals the whole-layout mesh run bit for bit, vmap within 1e-5, the
    ledger, key and records exactly; eval_params alike on every rank."""
    batches = _batches(n_clients, rounds=3)
    kw = _mesh_kw(mesh, n_clients, name)
    got = world.run(cases.slab_and_whole, kw, DIM, batches)
    want = cases.federate(dict(kw, engine="vmap", mesh_shape=None), DIM,
                          batches)
    want_chunk = cases.federate(dict(kw, engine="vmap", mesh_shape=None),
                                DIM, batches, None, True)
    block, p_shapes, r_shapes = _expected_slab(mesh, n_clients,
                                               got[0]["layout"], name)
    for rank, r in enumerate(got):
        lay = r["layout"]
        assert lay["mesh_shape"] == mesh and lay["block"] == block
        assert (lay["client_index"], lay["model_index"]) == \
            (rank // mesh[1], rank % mesh[1])
        for key in ("layout", "layout_after"):
            shapes = r[key]["shapes"]
            assert shapes[0] == p_shapes and shapes[2] == r_shapes
            assert all(s[0] == block for s in shapes[1])
            assert r[key]["bytes"] == 4 * sum(
                math.prod(s) for part in shapes for s in part)
    _assert_ranks_agree([{k: r[k] for k in ("slab", "whole", "slab_chunk",
                                            "whole_chunk")} for r in got])
    r0 = got[0]
    for form in ("", "_chunk"):
        slab, whole = r0["slab" + form], r0["whole" + form]
        ref = want_chunk if form else want
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
    # the eval model: alike on every rank (checked above), vmap's within
    # 1e-5, the whole layout's bit for bit under full_average
    import repro_torch.api as tapi
    spec = cases.make_spec(dict(kw, engine="vmap", mesh_shape=None))
    vm = tree_to_numpy(tapi.collapse_clients(
        {k: torch.as_tensor(v) for k, v in want["state"]["params"].items()},
        spec.topology))
    _close(r0["slab"]["eval"], vm)
    if spec.topology == "full_average":
        _assert_bitwise(r0["slab"]["eval"], r0["whole"]["eval"])


@pytest.mark.parametrize("mesh,n_clients,name", [
    ((2, 2), 3, "dense"), ((4, 1), 5, "qsgd8_q50"), ((2, 2), 4, "dense")],
    ids=["2x2-C3-dense", "4x1-C5-qsgd8_q50", "2x2-C4-dense"])
def test_slab_state_takes_whole_or_block_batches(world, mesh, n_clients,
                                                  name):
    """A slab state's run_round and run_rounds take the block's rows of a
    whole (C, ...) batch, and a batch of the block's rows as it is (told
    apart by the client axis' length): both give the same state, bit for
    bit."""
    kw = _mesh_kw(mesh, n_clients, name)
    got = world.run(cases.slab_block_batches, kw, DIM,
                    _batches(n_clients, rounds=2))
    _assert_ranks_agree(got)
    for form in ("", "_chunk"):
        _assert_bitwise(got[0]["block" + form], got[0]["whole" + form])


@pytest.mark.parametrize("mesh,n_clients,name", [
    ((2, 2), 3, "qsgd8_q50"), ((4, 1), 5, "local_only")],
    ids=["2x2-C3-qsgd8_q50", "4x1-C5-local_only"])
def test_slab_state_train_equals_whole_mesh_and_vmap(world, mesh,
                                                     n_clients, name):
    """train in chunks of 2 until the privacy budget binds (5 rounds: two
    chunks and a tail round), an eval at each chunk boundary and after the
    tail through eval_params: the slab run's state and losses equal the
    whole-layout run's bit for bit (the evals too under full_average;
    under local_only the slab's eval model is an all-reduced mean, within
    1e-5), vmap's within 1e-5 with the same rounds, epsilon and cost; the
    eval models alike on every rank."""
    kw = _mesh_kw(mesh, n_clients, name, eps_th=20.0, c_th=1e9)
    slab = world.run(cases.slab_train, kw, DIM, 20, 2)
    whole = world.run(cases.slab_train, kw, DIM, 20, 2, False)
    want = cases.slab_train(dict(kw, engine="vmap", mesh_shape=None), DIM,
                            20, 2)
    _assert_ranks_agree(slab)
    s = slab[0]
    evals = ("evals", "eval_losses", "best_round")
    _assert_bitwise({k: v for k, v in s.items() if k not in evals},
                    {k: v for k, v in whole[0].items() if k not in evals})
    if name != "local_only":
        _assert_bitwise({k: s[k] for k in evals},
                        {k: whole[0][k] for k in evals})
    assert s["rounds"] == 5
    assert (s["rounds"], s["max_epsilon"], s["resource_spent"]) == \
        (want["rounds"], want["max_epsilon"], want["resource_spent"])
    _close((s["state"]["params"], s["state"]["opt_state"],
            s["state"]["residual"]),
           (want["state"]["params"], want["state"]["opt_state"],
            want["state"]["residual"]))
    _ledger_equal(s["state"], want["state"])
    np.testing.assert_allclose(s["losses"], want["losses"], rtol=0,
                               atol=ATOL)
    assert [e is None for e in s["eval_losses"]] == \
        [e is None for e in want["eval_losses"]] == \
        [True, False, True, False, False]
    np.testing.assert_allclose(
        [e for e in s["eval_losses"] if e is not None],
        [e for e in want["eval_losses"] if e is not None], rtol=0,
        atol=ATOL)
    assert len(s["evals"]) == 3
    _close(s["evals"], want["evals"])


@pytest.mark.parametrize("mesh,n_clients,name", [
    ((2, 2), 5, "qsgd8_q50"), ((4, 1), 3, "dense")],
    ids=["2x2-C5-qsgd8_q50", "4x1-C3-dense"])
def test_checkpoints_cross_the_layouts(world, tmp_path, mesh, n_clients,
                                       name):
    """A slab run's checkpoint resumes in slab state to the uninterrupted
    run bit for bit, and loads into the whole mesh layout and into vmap
    exactly as the slab state's whole trees; each continues, the whole
    mesh layout bit for bit the slab's, vmap within 1e-5. A vmap run's
    checkpoint loads into slab state exactly and continues bit for bit as
    the whole mesh layout does from it, within 1e-5 of vmap's own."""
    batches = _batches(n_clients, rounds=4)
    kw = _mesh_kw(mesh, n_clients, name)
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


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_gemma3_cells_through_slab_state_match_jax(world, mesh_shape):
    """gemma3's smoke cells (2 layers, 4 q / 2 kv heads) through slab state
    on the world's 4 ranks: one DP round (C 2, tau 2) from JAX's weights
    on JAX's noise (replayed, cut to each slab) by run_round; the whole
    params within 1e-5 of each tensor's largest magnitude of JAX's vmap
    round, the loss within 1e-5, the ranks alike, each rank holding its
    block's rows of its slices ((4, 1): blocks of one row, two of them
    pad)."""
    jcfg, tcfg = _gemma_cfgs()
    jm, jp0 = jax_params(jcfg)
    common, batch, noise, jloss, want, _ = _jax_round("gemma3-4b", jcfg,
                                                      tcfg, jm, jp0)
    assert _JAX_ROUNDS["gemma3-4b"][2] is noise
    p0 = tree_to_numpy(transformer_params_from_jax(jp0, Transformer(tcfg),
                                                   "cpu"))
    kw = dict(common, engine="mesh_2d", mesh_shape=mesh_shape)
    got = world.run(cases.transformer_slab_round, tcfg, p0, batch, noise,
                    kw)
    _assert_ranks_agree([{"p": g["params"], "l": g["loss"]} for g in got])
    r0 = got[0]
    assert abs(r0["loss"] - jloss) <= 1e-5 * max(1.0, abs(jloss))
    have = tree_flatten(r0["params"])[0]
    assert len(have) == len(want)
    for w, g in zip(want, have):
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= 1e-5 * max(1.0, np.max(np.abs(w)))
    block = -(-common["n_clients"] // mesh_shape[0])
    n_whole = sum(x.size for x in tree_flatten(p0)[0])
    for g in got:
        lay = g["layout"]
        assert lay["block"] == block
        assert all(s[0] == block for s in lay["shapes"][0])
        n_local = sum(math.prod(s[1:]) for s in lay["shapes"][0])
        if mesh_shape[1] > 1:
            assert n_local < n_whole
        else:
            assert n_local == n_whole
