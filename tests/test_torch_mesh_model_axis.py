"""The model axis of the port's ``mesh_2d`` engine (``dm > 1``: each client
replica's weights and matmuls split over the ranks of a slab, by
hand-written tensor parallelism) against the JAX package, in one gloo
world of 8 ranks started once for the module.

* Placement: the port's per-leaf split (``param_split_dims``) equals what
  JAX's ``resolve_spec`` gives each weight at its ``shard_hint`` site under
  ``mesh2d_rules``, for the linear model.
* The autograd collectives: the MLP and attention (GQA, sliding window,
  qkv biases) split over two model ranks equal the unsplit layers within
  1e-6 of each tensor's largest magnitude, under ``vmap(grad_and_value)``
  and under the ``map`` engine's loop.
* The split clip: ``row_sumsq`` -> all-reduce -> ``clip_noise_apply`` on
  the slices equals ``repro.kernels.ref.dp_clip_noise`` on whole rows
  within 1e-6.
* JAX's own gates, ported (tests/test_mesh.py:248-279): the (4, 2) mesh at
  C 8 (dense, participation, top-k, qsgd, microbatched clips, no DP) and
  at the padded C 3/5/7/9,
  through ``run_round``, ``run_rounds`` and ``train``, within 1e-5 of
  JAX's ``vmap`` on JAX's draws, the ledger exact; ``engine="auto"`` over
  the budget resolves to a model axis and runs; one dense case against
  JAX's own ``mesh_2d`` (4, 2) in a process with 8 forced host devices
  (started with the module, so it runs beside the other tests).

The transformers on the model axis are in
tests/test_torch_mesh_model_axis_{gemma3,rwkv,zamba2,moe}.py.
"""
import json
import os
import pathlib
import subprocess
import sys
import types

import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_aggregation import jax_pipeline_draws
from test_torch_fl import jax_round_noise

import repro.api as japi
import repro.models.sharding as jshard
from repro.kernels import ref as jref
from repro.models import linear as jlin
from repro.optim import sgd as jsgd
from repro_torch.launch.mesh import HostWorld
from repro_torch.models import sharding as tshard

C, TAU, DIM, B = 8, 2, 8, 4
ATOL = 1e-5
MESH = (4, 2)
SETTINGS = {
    "dense": {},
    "participation": dict(participation=0.5),
    "topk": dict(compressor="topk", compression_ratio=0.25),
    "qsgd": dict(compressor="qsgd", compression_bits=4, participation=0.5),
    # the clip's other granularities (Eq. 7a per microbatch, stacked or
    # accumulated) and the plain gradient without DP
    "microbatch": dict(num_microbatches=2),
    "microbatch-scan": dict(num_microbatches=2, vmap_microbatches=False,
                            grad_accumulate="scan"),
    "no-dp": dict(dp=False),
}


@pytest.fixture(scope="module")
def world():
    w = HostWorld(8)
    yield w
    w.close()


@pytest.fixture(scope="module", autouse=True)
def jax_mesh_2d():
    """JAX's own mesh_2d (4, 2) rounds (:data:`_JAX_MESH_2D`), started with
    the module in a process of its own with 8 forced host devices."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_MESH_2D.format(C=C, TAU=TAU, DIM=DIM,
                                                   B=B)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def _kw(n_clients=C, **kw):
    base = dict(n_clients=n_clients, tau=TAU, clip_norm=1.0, dp=True,
                sigmas=(0.5,) * n_clients, batch_sizes=(B,) * n_clients)
    base.update(kw)
    return base


def _batches(n_clients=C, rounds=2):
    out = []
    for r in range(rounds):
        rng = np.random.default_rng(r)
        out.append({
            "x": rng.normal(size=(n_clients, TAU, B, DIM)).astype(
                np.float32),
            "y": rng.integers(0, 2, size=(n_clients, TAU, B)).astype(
                np.int32)})
    return out


_JAX_RUNS = {}


def _jax_run(kw, batches):
    """JAX's vmap rounds on ``kw`` and their draws in the port's operand
    form (what ``cases.replayed`` feeds the port); memoized."""
    memo = repr(sorted(kw.items()))
    if memo not in _JAX_RUNS:
        jspec = japi.FederationSpec(loss_fn=jlin.logreg_loss,
                                    optimizer=jsgd(0.2),
                                    kernel_backend="ref",
                                    **dict(kw, engine="vmap"))
        params0 = jlin.init_linear(DIM)
        js = japi.init_state(jspec, params0)
        key, draws, recs = js.key, [], []
        for batch in batches:
            if jspec.has_pipeline():
                mask, noise, agg_rand, key = jax_pipeline_draws(
                    key, params0, jspec)
                draws.append((mask.numpy(), noise.numpy(), None
                              if agg_rand is None else agg_rand.numpy()))
            else:
                draws.append(jax_round_noise(key, params0, jspec.n_clients,
                                             jspec.tau).numpy())
                key = jax.random.split(key)[0]
            js, rec = japi.run_round(jspec, js, jax.tree.map(jnp.asarray,
                                                             batch),
                                     check_budgets=False)
            recs.append(japi.materialize_record(rec))
        _JAX_RUNS[memo] = (js, recs, draws)
    return _JAX_RUNS[memo]


def _leaves(tree):
    return jax.tree.leaves(tree)


def _assert_ranks_agree(results):
    for other in results[1:]:
        for a, b in zip(_leaves(results[0]), _leaves(other)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _assert_close_to_jax(js, jrecs, got, atol=ATOL):
    st = got["state"]
    want = jax.tree.map(np.asarray, (js.params, js.opt_state))
    for w, g in zip(_leaves(want), _leaves((st["params"], st["opt_state"]))):
        assert w.dtype == g.dtype and w.shape == g.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    if js.residual is None:
        assert st["residual"] is None
    else:
        np.testing.assert_allclose(st["residual"], np.asarray(js.residual),
                                   rtol=0, atol=atol)
    np.testing.assert_array_equal(st["rho"], js.rho)
    assert (st["steps"], st["resource_spent"], st["rounds_done"]) == \
        (js.steps, js.resource_spent, js.rounds_done)
    for jr, tr in zip(jrecs, got["records"]):
        for k in ("round", "iterations", "max_epsilon", "resource_spent",
                  "participants"):
            assert tr[k] == jr[k]
        assert tr["loss"] == pytest.approx(jr["loss"], abs=atol)


def _model_dim(logical, shape, dm=2):
    """JAX's split dim of a weight hinted ``logical``: its
    ``resolve_spec`` under mesh2d_rules on a model axis of ``dm``."""
    mesh = types.SimpleNamespace(shape={"client": 1, "model": dm})
    with jshard.axis_rules(mesh, jshard.mesh2d_rules()):
        spec = tuple(jshard.resolve_spec(logical, shape))
    return spec.index("model") if "model" in spec else -1


def _jax_weight_hints(fn, *args, modules):
    """{(JAX module, param name): (shape, logical axes)} of every weight
    the ``shard_hint`` calls of ``modules`` hint while ``fn(*args)`` runs
    (a hint whose tensor is an entry of the calling function's
    ``params``)."""
    seen = {}

    def record(x, *logical):
        frame = sys._getframe(1)
        params = frame.f_locals.get("params")
        if isinstance(params, dict):
            for k, v in params.items():
                if v is x:
                    seen.setdefault((frame.f_globals["__name__"], k),
                                    (tuple(x.shape), logical))
        return x

    saved = [m.shard_hint for m in modules]
    for m in modules:
        m.shard_hint = record
    try:
        fn(*args)
    finally:
        for m, f in zip(modules, saved):
            m.shard_hint = f
    return seen


# --------------------------------- placement --------------------------------

def test_linear_placement_matches_jax_hints():
    rng = np.random.default_rng(0)
    jp = jlin.init_linear(DIM)
    import repro.models.attention as jattn
    import repro.models.layers as jlayers
    hints = _jax_weight_hints(jlin.logreg_loss, jp, {
        "x": jnp.asarray(rng.normal(size=(B, DIM)), jnp.float32),
        "y": jnp.zeros((B,), jnp.int32)}, modules=(jattn, jlayers, jlin))
    w = (jlin.__name__, "w")
    assert set(hints) == {w}
    for dm in (2, 4, 8):
        got = tshard.param_split_dims(jax.tree.map(np.asarray, jp), dm)
        assert got == {"w": _model_dim(hints[w][1], hints[w][0], dm),
                       "b": -1} == {"w": 0, "b": -1}
    with pytest.raises(ValueError, match="does not divide"):
        tshard.param_split_dims(jax.tree.map(np.asarray, jp), 16)
    # JAX's numpy weights carried across to a rank's slices
    local = tshard.to_local(jax.tree.map(np.asarray, jp), {"w": 0, "b": -1},
                            1, 2)
    np.testing.assert_array_equal(local["w"], np.asarray(jp["w"])[DIM // 2:])
    assert local["b"] is not None and local["b"].shape == (2,)


# ------------------------ collectives and the split clip ---------------------

def test_autograd_collectives_equal_the_unsplit_layers(world):
    """MLP, swa and full attention with qkv biases, GQA 4 / 2 heads:
    split over the model pairs of the (4, 2) mesh vs whole, outputs and
    gradients within 1e-6 of each tensor's largest magnitude, under
    vmap(grad_and_value) and under the map engine's loop."""
    got = world.run(cases.tp_layers, MESH, 3)
    for rank, layers in enumerate(got):
        assert layers["mlp"]["dims"] == {"w_gate": 1, "w_up": 1,
                                         "w_down": 0}
        assert layers["attention_full"]["dims"]["wo"] == 0
        for name, gaps in layers.items():
            for what, gap in gaps.items():
                if what != "dims":
                    assert gap <= 1e-6, (rank, name, what, gap)


def test_split_clip_equals_the_jax_reference(world):
    """row_sumsq -> all-reduce over the model pair -> clip_noise_apply on
    the slices (split and whole leaves) equals JAX's plain dp_clip_noise
    on each whole row within 1e-6, with noise and clip-only."""
    got = world.run(cases.split_clip, MESH, 5)
    _assert_ranks_agree(got)
    flat, noise, sigma = got[0]["inputs"]
    for name in ("noise", "clip_only"):
        y, norm = got[0][name]
        for r in range(flat.shape[0]):
            wy, wn = jref.dp_clip_noise_ref(
                jnp.asarray(flat[r]), None if name == "clip_only"
                else jnp.asarray(noise[r]), 1.5, float(sigma[r]))
            np.testing.assert_allclose(y[r], np.asarray(wy), rtol=0,
                                       atol=1e-6)
            assert abs(norm[r] - float(wn)) <= 1e-6 * max(1.0, float(wn))
    norms = got[0]["noise"][1]
    assert norms.min() < 1.5 < norms.max()       # clipped and unclipped rows


# --------------------------- JAX's gates, ported -----------------------------

CASES = ([(C, name) for name in SETTINGS]
         + [(n, name) for n in (3, 5, 7, 9)
            for name in ("dense", "participation", "topk")]
         + [(5, "qsgd")])


@pytest.mark.parametrize("n_clients,name", CASES,
                         ids=[f"C{c}-{n}" for c, n in CASES])
def test_mesh_4x2_matches_jax_vmap(world, n_clients, name):
    """mesh_2d (4, 2) on 8 ranks: each replica split over two ranks, the
    clients over four slabs (padded where they do not divide); within
    1e-5 of JAX's vmap on JAX's draws, ledger exact, ranks alike."""
    kw = _kw(n_clients, **SETTINGS[name])
    batches = _batches(n_clients)
    js, jrecs, draws = _jax_run(kw, batches)
    got = world.run(cases.federate, dict(kw, engine="mesh_2d",
                                         mesh_shape=MESH), DIM, batches,
                    draws)
    _assert_ranks_agree(got)
    _assert_close_to_jax(js, jrecs, got[0])


@pytest.mark.parametrize("name", ["dense", "qsgd"])
def test_mesh_4x2_run_rounds_matches_jax(world, name):
    """One run_rounds chunk of two rounds on the (4, 2) mesh equals JAX's
    two vmap rounds within 1e-5."""
    kw = _kw(C, **SETTINGS[name])
    batches = _batches(C)
    js, jrecs, draws = _jax_run(kw, batches)
    got = world.run(cases.federate, dict(kw, engine="mesh_2d",
                                         mesh_shape=MESH), DIM, batches,
                    draws, True)
    _assert_ranks_agree(got)
    _assert_close_to_jax(js, jrecs, got[0])


def test_mesh_4x2_train_matches_vmap(world):
    """train on the (4, 2) mesh at C = 6 (padded) in chunks of 2 until a
    budget binds: the port's vmap rounds, epsilon and cost exactly, the
    losses and params within 1e-5."""
    kw = _kw(6, eps_th=6.0, c_th=1e9)
    got = world.run(cases.train_to_budget, dict(kw, engine="mesh_2d",
                                                mesh_shape=MESH), DIM, 20, 2)
    _assert_ranks_agree(got)
    want = cases.train_to_budget(dict(kw, engine="vmap"), DIM, 20, 2)
    assert (got[0]["rounds"], got[0]["max_epsilon"],
            got[0]["resource_spent"]) == (want["rounds"],
                                          want["max_epsilon"],
                                          want["resource_spent"])
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=0,
                               atol=ATOL)
    for w, g in zip(_leaves(want["state"]["params"]),
                    _leaves(got[0]["state"]["params"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_auto_over_budget_resolves_to_a_model_axis_and_runs(world):
    """JAX's test_auto_resolves_mesh_2d_and_completes on 8 ranks: a replica
    of 100 * DIM bytes over a 256-byte budget resolves engine='auto' to
    mesh_2d (2, 4), and its rounds match JAX's vmap within 1e-5."""
    kw = _kw(C, engine="auto", replica_bytes=100 * DIM)
    batches = _batches(C)
    js, jrecs, draws = _jax_run(dict(kw, engine="vmap"), batches)
    got = world.run(cases.federate_on_budget, kw, DIM, batches, draws, 256)
    _assert_ranks_agree(got)
    assert got[0]["engine"] == "mesh_2d" and got[0]["mesh_shape"] == (2, 4)
    _assert_close_to_jax(js, jrecs, got[0])


_JAX_MESH_2D = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
import repro.api as japi
import repro.mesh.engine as jengine
from repro.models import linear as jlin
from repro.optim import sgd
C, TAU, DIM, B = {C}, {TAU}, {DIM}, {B}
assert jax.device_count() == 8


def shard_map(f, mesh, in_specs, out_specs, auto=frozenset()):
    # jax >= 0.7 names the manual axes (axis_names) where the engine
    # names the auto ones
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False,
                         axis_names=frozenset(mesh.axis_names) - set(auto))


if "auto" not in __import__("inspect").signature(jax.shard_map).parameters:
    jengine._shard_map = shard_map
spec = japi.FederationSpec(
    n_clients=C, tau=TAU, loss_fn=jlin.logreg_loss, optimizer=sgd(0.2),
    clip_norm=1.0, dp=True, sigmas=(0.5,) * C, batch_sizes=(B,) * C,
    kernel_backend="ref", engine="mesh_2d", mesh_shape=(4, 2))
state = japi.init_state(spec, jlin.init_linear(DIM))
losses = []
for r in range(2):
    rng = np.random.default_rng(r)
    batch = {{"x": jnp.asarray(rng.normal(size=(C, TAU, B, DIM)),
                               jnp.float32),
             "y": jnp.asarray(rng.integers(0, 2, size=(C, TAU, B)),
                              jnp.int32)}}
    state, rec = japi.run_round(spec, state, batch, check_budgets=False)
    losses.append(float(rec["loss"]))
print(json.dumps({{"w": np.asarray(state.params["w"]).tolist(),
                   "b": np.asarray(state.params["b"]).tolist(),
                   "losses": losses, "rho": np.asarray(state.rho).tolist()}}))
"""


def test_dense_matches_jax_own_mesh_2d(world, jax_mesh_2d):
    """JAX's own mesh_2d (4, 2) round, in a process with 8 forced host
    devices, against the port's (4, 2) mesh on its draws: within 1e-5.
    (Under a jax whose ``shard_map`` names the manual axes rather than the
    auto ones, the script hands the JAX engine a ``_shard_map`` that
    translates its ``auto`` argument.)"""
    stdout, stderr = jax_mesh_2d.communicate(timeout=300)
    assert jax_mesh_2d.returncode == 0, stderr[-4000:]
    out = types.SimpleNamespace(stdout=stdout)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    kw = _kw(C)
    batches = _batches(C)
    _, _, draws = _jax_run(kw, batches)
    got = world.run(cases.federate, dict(kw, engine="mesh_2d",
                                         mesh_shape=MESH), DIM, batches,
                    draws)[0]
    for k in ("w", "b"):
        np.testing.assert_allclose(got["state"]["params"][k],
                                   np.asarray(want[k], np.float32), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose([r["loss"] for r in got["records"]],
                               want["losses"], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got["state"]["rho"], want["rho"])
