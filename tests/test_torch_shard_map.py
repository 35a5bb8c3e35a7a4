"""The port's ``engine="shard_map"`` in gloo worlds of 1, 2 and 4 ranks,
against the JAX package's engines and against the port's own
(``mesh_2d`` is in tests/test_torch_mesh.py).

Each world of N ranks (:class:`repro_torch.launch.mesh.HostWorld`) is
started once per module; every rank runs the same driver on the full
client-stacked state (tests/_torch_world_cases.py), so the ranks must end
bit for bit alike. The parity policy: the JAX rounds' draws (noise, mask,
compressor operand) are replayed into the port as operands, and the port
is held within 1e-5 of JAX's ``shard_map`` engine (one CPU device) and,
for the dense settings, of its ``vmap`` engine, with the ledger, the
costs and the participant counts exact. The bitwise gates: a world of one
(``shard_map``, and ``mesh_2d`` at (1, 1)) equals the port's ``vmap``;
``run_rounds`` equals a loop of ``run_round``; the cohort path at M == C
equals the dense participation path.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_aggregation import jax_pipeline_draws
from test_torch_fl import jax_round_noise

import repro.api as japi
from repro.models import linear as jlin
from repro.optim import momentum as jmomentum
from repro.optim import sgd as jsgd
from repro_torch.launch.mesh import HostWorld

C, TAU, DIM, B = 8, 2, 6, 4
ROUNDS = 2
ATOL = 1e-5

SETTINGS = {
    "dense": {},
    "q50": dict(participation=0.5),
    "topk25": dict(compressor="topk", compression_ratio=0.25),
    "qsgd4-q50": dict(compressor="qsgd", compression_bits=4,
                      participation=0.5),
}
ADVERSARIAL = {
    "trimmed_mean": dict(aggregator="trimmed_mean", trim_fraction=0.25,
                         participation=0.5),
    "secure": dict(secure_agg=True, dp_accounting="central"),
    "attack": dict(attack="sign_flip", byzantine_fraction=0.25,
                   aggregator="median"),
}


@pytest.fixture(scope="module")
def worlds():
    """Gloo worlds of 2 and 4 ranks, each started on first use."""
    started = {}

    def get(n):
        if n not in started:
            started[n] = HostWorld(n)
        return started[n]

    yield get
    for w in started.values():
        w.close()


def _kw(n_clients=C, **kw):
    base = dict(n_clients=n_clients, tau=TAU, clip_norm=1.0, dp=True,
                sigmas=(0.5,) * n_clients, batch_sizes=(B,) * n_clients)
    base.update(kw)
    return base


def _batches(n_clients=C, rounds=ROUNDS):
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
    """JAX's rounds on ``kw`` and the draws they made, in the port's
    operand form (what ``cases.replayed`` feeds the port); memoized, since
    the worlds of 2 and 4 ranks are held against the same JAX run."""
    memo = repr(sorted(kw.items()))
    if memo not in _JAX_RUNS:
        _JAX_RUNS[memo] = _jax_rounds(kw, batches)
    return _JAX_RUNS[memo]


def _jax_rounds(kw, batches):
    kw = dict(kw)
    name, lr = kw.pop("opt", ("sgd", 0.2))
    jspec = japi.FederationSpec(
        loss_fn=jlin.logreg_loss,
        optimizer=(jsgd if name == "sgd" else jmomentum)(lr),
        kernel_backend="ref", **kw)
    params0 = jlin.init_linear(DIM)
    js = japi.init_state(jspec, params0)
    key, draws, recs = js.key, [], []
    for batch in batches:
        if jspec.has_pipeline():
            mask, noise, agg_rand, key = jax_pipeline_draws(key, params0,
                                                            jspec)
            draws.append((mask.numpy(), noise.numpy(), None
                          if agg_rand is None else agg_rand.numpy()))
        else:
            draws.append(jax_round_noise(key, params0, jspec.n_clients,
                                         jspec.tau).numpy())
            key = jax.random.split(key)[0]
        js, rec = japi.run_round(jspec, js, jax.tree.map(jnp.asarray, batch),
                                 check_budgets=False)
        recs.append(japi.materialize_record(rec))
    return js, recs, draws


def _leaves(tree):
    return jax.tree.leaves(tree)


def _assert_ranks_agree(results):
    """Every rank holds the same full state, bit for bit."""
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


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# ------------------------- the port against JAX ------------------------------

JAX_CASES = (
    [(4, name, kw) for name, kw in SETTINGS.items()]
    + [(2, "dense", SETTINGS["dense"]),
       (2, "qsgd4-q50", SETTINGS["qsgd4-q50"]),
       (4, "local_only", dict(topology="local_only")),
       (2, "local_only", dict(topology="local_only")),
       (4, "momentum-avg", dict(opt=("momentum", 0.1))),
       (2, "momentum-keep", dict(opt=("momentum", 0.1),
                                 average_opt_state=False)),
       (4, "momentum-keep-q50", dict(opt=("momentum", 0.1),
                                     average_opt_state=False,
                                     participation=0.5))]
    + [(4, name, kw) for name, kw in ADVERSARIAL.items()])


@pytest.mark.parametrize("world,name,kw", JAX_CASES,
                         ids=[f"{w}ranks-{n}" for w, n, _ in JAX_CASES])
def test_shard_map_matches_jax(worlds, world, name, kw):
    """The port's shard_map in a world of ``world`` ranks against JAX's
    shard_map (and, for the dense settings, vmap) on JAX's draws."""
    batches = _batches()
    js, jrecs, draws = _jax_run(_kw(engine="shard_map", **kw), batches)
    got = worlds(world).run(cases.federate, _kw(engine="shard_map", **kw),
                            DIM, batches, draws)
    _assert_ranks_agree(got)
    _assert_close_to_jax(js, jrecs, got[0])
    if name in ("dense", "local_only"):
        jv, jvrecs, _ = _jax_run(_kw(engine="vmap", **kw), batches)
        _assert_close_to_jax(jv, jvrecs, got[0])


# ------------------------------ bitwise gates --------------------------------

ONE_RANK_CASES = {**SETTINGS, "trimmed_mean": ADVERSARIAL["trimmed_mean"],
                  "secure": ADVERSARIAL["secure"],
                  "local_only": dict(topology="local_only"),
                  "momentum-keep": dict(opt=("momentum", 0.1),
                                        average_opt_state=False)}


@pytest.mark.parametrize("name", list(ONE_RANK_CASES))
def test_world_of_one_equals_vmap_bitwise(name):
    """No process group initialized: the sharded engines build a world of
    one in this process, and equal the port's vmap bit for bit."""
    kw = ONE_RANK_CASES[name]
    batches = _batches()
    want = cases.federate(_kw(engine="vmap", **kw), DIM, batches)
    engines = ["shard_map"]
    if "aggregator" not in kw and "secure_agg" not in kw:
        engines.append("mesh_2d")
    for engine in engines:
        extra = {"mesh_shape": (1, 1)} if engine == "mesh_2d" else {}
        got = cases.federate(_kw(engine=engine, **extra, **kw), DIM, batches)
        _assert_bitwise(want, got)


@pytest.mark.parametrize("name", ["dense", "q50", "topk25"])
def test_run_rounds_equals_run_round_loop_bitwise(worlds, name):
    """tests/test_fused_rounds.py:87 under shard_map in 4 ranks: one
    run_rounds chunk of 3 equals three run_round calls."""
    kw = _kw(engine="shard_map", **SETTINGS[name])
    batches = _batches(rounds=3)
    world = worlds(4)
    seq = world.run(cases.federate, kw, DIM, batches)
    fused = world.run(cases.federate, kw, DIM, batches, None, True)
    _assert_ranks_agree(fused)
    _assert_bitwise(seq[0], fused[0])


@pytest.mark.parametrize("name", list(SETTINGS))
def test_cohort_path_equals_dense_path_bitwise(worlds, name):
    """tests/test_population.py:218 under shard_map in 2 ranks: M == C
    with cohort == population is the dense participation path."""
    got = worlds(2).run(cases.cohort_and_dense,
                        _kw(4, engine="shard_map", **SETTINGS[name]),
                        DIM, 3)
    _assert_ranks_agree(got)
    r = got[0]
    _assert_bitwise(r["dense"]["params"], r["cohort"]["params"])
    _assert_bitwise(r["dense"]["opt_state"], r["cohort"]["opt_state"])
    np.testing.assert_array_equal(r["dense"]["rho"], r["cohort_rho"])
    np.testing.assert_array_equal(r["dense"]["key"], r["cohort"]["key"])
    assert r["dense_records"] == r["cohort_records"]
    if r["dense"]["residual"] is not None:
        np.testing.assert_array_equal(r["dense"]["residual"],
                                      r["cohort_residual"])


@pytest.mark.parametrize("name", ["q50", "topk25"])
def test_resident_cohort_equals_per_round_bitwise(worlds, name):
    """The resident cohort chunk (its rows moved by cohort_gather_scatter)
    under shard_map in 2 ranks equals the per-round cohort driver."""
    got = worlds(2).run(cases.resident_and_per_round,
                        _kw(4, engine="shard_map", **SETTINGS[name]),
                        DIM, 12, 4, 2)
    _assert_ranks_agree(got)
    a, b = got[0]["per_round"], got[0]["resident"]
    assert a["losses"] == b["losses"]
    _assert_bitwise(a["state"], b["state"])
    np.testing.assert_array_equal(a["store_rho"], b["store_rho"])
