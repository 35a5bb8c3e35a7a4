"""The port's aggregation pipeline (partial participation, TopK / RandK /
QSGD with error feedback) and its checkpoints, against the JAX package.

Randomness enters the port's pipeline round as operands (mask, noise,
``agg_rand``). The tests rebuild JAX's draws by replaying its key schedule
(api/state.py:258 and 266-268, core/fl.py:129-131, then the local rounds'
noise as in ``test_torch_fl.jax_client_noise`` and the compressors' draws
at aggregation.py:157 and 178) and inject them into the port's
``run_round``. Tolerances: params and residual within 1e-6 without DP and
1e-5 with DP (sums taken in another order); the ledger, the costs, the
participant counts and the stopping round exactly. The QSGD plain version
equals the JAX package's jitted reference and its Pallas kernel bit for bit.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_aggregation import PIPELINE_SETTINGS
from test_torch_fl import jax_client_noise

import repro.api as japi
import repro_torch.api as tapi
import repro_torch.api.state as tstate
import repro_torch.kernels.ops as tops
from repro.core import aggregation as jagg
from repro.core.fl import design_sigmas
from repro.data import adult_like, split_iid
from repro.kernels import ref as jref
from repro.kernels.quantize_decompress import (
    quantize_decompress as jax_quantize_decompress,
)
from repro.models import linear as jlin
from repro.optim import momentum as jmomentum
from repro.optim import sgd as jsgd
from repro_torch.checkpoint import checkpoint_leaf_paths, load_checkpoint
from repro_torch.core import aggregation as tagg
from repro_torch.kernels.ref import quantize_decompress_ref
from repro_torch.models import linear as tlin
from repro_torch.optim import momentum as tmomentum
from repro_torch.optim import sgd as tsgd
from repro_torch.utils.convert import tree_to_numpy

C, TAU, DIM, B = 4, 3, 8, 4
D = 2 * DIM + 2


def _specs(opt="sgd", **kw):
    base = dict(n_clients=C, tau=TAU, clip_norm=1.0, dp=True,
                sigmas=(0.5,) * C, batch_sizes=(B,) * C)
    base.update(kw)
    jopt, topt = ((jsgd(0.2), tsgd(0.2)) if opt == "sgd"
                  else (jmomentum(0.1), tmomentum(0.1)))
    return (japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=jopt,
                                kernel_backend="ref", **base),
            tapi.FederationSpec(loss_fn=tlin.logreg_loss, optimizer=topt,
                                **base))


def _batch(seed):
    """The round batch of tests/test_aggregation.py::_batch, as numpy."""
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(C, TAU, B, DIM)).astype(np.float32),
            "y": rng.integers(0, 2, size=(C, TAU, B)).astype(np.int32)}


def jax_pipeline_draws(key, params0, spec):
    """What a JAX pipeline round with FLState key ``key`` draws, in the
    port's operand form: ``(mask, noise, agg_rand, next_key)``, the return
    of ``repro_torch.core.fl.draw_pipeline_round`` (its ``next_key`` here
    is the next JAX key)."""
    key, sub = jax.random.split(key)                     # state.py:258
    sub, mask_key = jax.random.split(sub)                # state.py:266
    mask = np.asarray(jagg.participation_mask(           # state.py:267
        mask_key, spec.n_clients, spec.participants_per_round()))
    local_key, agg_key = jax.random.split(sub)           # fl.py:129
    noise = jax_client_noise(jax.random.split(local_key, spec.n_clients),
                             params0, spec.tau)          # fl.py:130
    agg_keys = jax.random.split(agg_key, spec.n_clients)  # fl.py:131
    d = sum(x.size for x in jax.tree.leaves(params0))
    if spec.compressor == "qsgd":                        # aggregation.py:178
        agg_rand = torch.as_tensor(np.stack([np.asarray(jax.random.uniform(
            k, (d,), jnp.float32)) for k in agg_keys]))
    elif spec.compressor == "randk":                     # aggregation.py:157
        k = max(1, min(d, int(round(spec.compression_ratio * d))))
        agg_rand = torch.as_tensor(np.stack([np.asarray(
            jax.random.permutation(a, d)[:k]) for a in agg_keys]
        ).astype(np.int64))
    else:
        agg_rand = None
    return torch.tensor(mask), noise, agg_rand, key


def _inject_jax_draws(monkeypatch, jspec, jkey, params0):
    """Make the port's run_round draw what JAX's rounds from ``jkey`` do."""
    box = [jkey]

    def draws(key, params, tau, pipeline):
        mask, noise, agg_rand, box[0] = jax_pipeline_draws(box[0], params0,
                                                           jspec)
        return mask, noise, agg_rand, key

    monkeypatch.setattr(tstate, "draw_pipeline_round", draws)


def _cpu_state(spec, dim=DIM):
    return tapi.init_state(spec, tlin.init_linear(dim, device="cpu"),
                           device="cpu")


def _max_gap(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float64) - y)))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


# ------------------------------ QSGD kernel ---------------------------------

def _qsgd_rows(seed, rows=6, n=203):
    """Rows over many magnitudes, one all-zero row, and a zero coordinate."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, n))
         * np.logspace(-5, 2, rows)[:, None]).astype(np.float32)
    x[1] = 0.0
    x[2, 7] = 0.0
    u = rng.uniform(size=(rows, n)).astype(np.float32)
    return x, u


@pytest.mark.parametrize("bits", range(1, 17))
def test_qsgd_plain_version_matches_jitted_jax_and_pallas_bitwise(bits):
    """Bit for bit against what the JAX package computes under jit (the
    vmapped jnp reference, as the pipeline vmaps it) and against its Pallas
    kernel in interpret mode."""
    x, u = _qsgd_rows(seed=bits)
    y, scale = quantize_decompress_ref(torch.as_tensor(x), torch.as_tensor(u),
                                       bits)
    wy, ws = jax.jit(jax.vmap(lambda a, b: jref.quantize_decompress_ref(
        a, b, bits)))(x, u)
    np.testing.assert_array_equal(y.numpy(), np.asarray(wy))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ws))
    for r in range(x.shape[0]):
        py, ps = jax_quantize_decompress(jnp.asarray(x[r]), jnp.asarray(u[r]),
                                         bits, block=128, interpret=True)
        np.testing.assert_array_equal(y[r].numpy(), np.asarray(py))
        assert scale[r].item() == float(ps)
    assert not y[1].any()                              # all-zero row
    assert y[2, 7].item() == 0.0


def test_eager_jax_reference_differs_in_the_scale_last_bit():
    """Why the plain version multiplies by f32(1/levels): the eager JAX
    reference divides by the level count, and its scale then differs from
    the jitted one (which XLA rewrites to that multiply) by one ulp in some
    rows; the port follows the jitted package, which every round runs."""
    x, u = _qsgd_rows(seed=0, rows=16)
    _, scale = quantize_decompress_ref(torch.as_tensor(x), torch.as_tensor(u),
                                       8)
    eager = np.asarray([float(jref.quantize_decompress_ref(
        jnp.asarray(x[r]), jnp.asarray(u[r]), 8)[1]) for r in range(16)],
        np.float32)
    differ = eager != scale.numpy()
    assert differ.any()
    ulps = np.abs(eager.view(np.int32) - scale.numpy().view(np.int32))
    assert ulps[differ].max() == 1


@pytest.mark.parametrize("seed", range(3))
def test_qsgd_error_bounded_by_one_level(seed):
    """|x - Q(x)| < scale elementwise; signs and zeros are kept."""
    x, u = _qsgd_rows(seed=seed)
    for bits in (2, 4, 8):
        y, scale = tops.quantize_decompress_rows(torch.as_tensor(x),
                                                 torch.as_tensor(u), bits)
        err = np.abs(y.numpy() - x)
        assert np.all(err <= scale.numpy()[:, None] * (1 + 1e-6))
        assert np.all(np.sign(y.numpy()) * np.sign(x) >= 0)


# ------------------------------ compressors ---------------------------------

def _rows(seed, rows=3, n=40):
    return np.random.default_rng(seed).normal(size=(rows, n)).astype(
        np.float32)


@pytest.mark.parametrize("ratio", [0.05, 0.25, 1.0])
def test_topk_matches_jax(ratio):
    x = _rows(1)
    got = tagg.TopK(ratio)(torch.as_tensor(x), None).numpy()
    for r in range(x.shape[0]):
        np.testing.assert_array_equal(
            got[r], np.asarray(jagg.TopK(ratio)(jnp.asarray(x[r]), None)))


@pytest.mark.parametrize("ratio", [0.1, 0.5])
def test_randk_matches_jax_with_its_indices(ratio):
    x = _rows(2)
    keys = jax.random.split(jax.random.PRNGKey(3), x.shape[0])
    k = max(1, round(ratio * x.shape[1]))
    idx = torch.as_tensor(np.stack([np.asarray(
        jax.random.permutation(a, x.shape[1])[:k]) for a in keys]).astype(
        np.int64))
    got = tagg.RandK(ratio)(torch.as_tensor(x), idx).numpy()
    for r in range(x.shape[0]):
        np.testing.assert_array_equal(
            got[r], np.asarray(jagg.RandK(ratio)(jnp.asarray(x[r]), keys[r])))


def test_compressor_draws_are_uniform_operands():
    key, rows = (0, 0), tuple(range(5))
    idx = tagg.RandK(0.25).draw(key, rows, 40, "cpu")
    assert idx.shape == (5, 10) and idx.dtype == torch.int64
    for row in idx.tolist():
        assert len(set(row)) == 10 and 0 <= min(row) and max(row) < 40
    u = tagg.QSGD(8).draw((0, 1), rows, 40, "cpu")
    assert u.shape == (5, 40) and float(u.min()) >= 0 and float(u.max()) < 1
    assert tagg.TopK(0.25).draw(key, rows, 40, "cpu") is None


@pytest.mark.parametrize("name,ratio,bits", [
    ("none", 0.1, 8), ("topk", 0.25, 8), ("randk", 0.3, 8), ("qsgd", 0.1, 4),
    ("qsgd", 0.1, 16)])
def test_wire_ratios_and_validation_match_jax(name, ratio, bits):
    assert (tagg.compression_wire_ratio(name, ratio, bits)
            == jagg.compression_wire_ratio(name, ratio, bits))
    comp = tagg.make_compressor(name, ratio, bits)
    if name == "none":
        assert comp is None
    else:
        assert comp.wire_ratio() == jagg.make_compressor(
            name, ratio, bits, kernel_backend="ref").wire_ratio()
    for bad in (dict(name="gzip"), dict(ratio=0.0), dict(bits=0)):
        args = {**dict(name=name, ratio=ratio, bits=bits), **bad}
        with pytest.raises(ValueError):
            jagg.validate_compression(**args)
        with pytest.raises(ValueError):
            tagg.validate_compression(**args)


def test_participation_mask_count_and_spread():
    seen, counts = set(), np.zeros(8)
    for s in range(200):
        m = tagg.participation_mask((s, 0), 8, 3, "cpu")
        assert m.dtype == torch.float32 and m.shape == (8,)
        assert set(m.tolist()) <= {0.0, 1.0} and float(m.sum()) == 3.0
        seen.add(tuple(np.flatnonzero(m.numpy())))
        counts += m.numpy()
    assert len(seen) > 30                  # 56 possible sets
    assert np.all(np.abs(counts / 200 - 3 / 8) < 0.1)


def test_flatten_unflatten_roundtrip_keeps_dtypes():
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(2, 2, 3),
            "b": torch.ones((2, 4), dtype=torch.bfloat16)}
    flat = tagg.flatten_tree(tree)
    assert flat.shape == (2, 10) and flat.dtype == torch.float32
    back = tagg.unflatten_like(flat, tree)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k], tree[k])
    assert tagg.tree_dim({"w": tree["w"][0], "b": tree["b"][0]}) == 10


# ------------------------- pipeline rounds vs JAX ----------------------------

def _run_both(monkeypatch, jspec, tspec, n_rounds=2):
    params0 = jlin.init_linear(DIM)
    js = japi.init_state(jspec, params0)
    ts = _cpu_state(tspec)
    _inject_jax_draws(monkeypatch, jspec, js.key, params0)
    jrecs, trecs = [], []
    for r in range(n_rounds):
        batch = _batch(r)
        js, jrec = japi.run_round(jspec, js, jax.tree.map(jnp.asarray, batch),
                                  check_budgets=False)
        ts, trec = tapi.run_round(tspec, ts, batch, check_budgets=False)
        jrecs.append(japi.materialize_record(jrec))
        trecs.append(tapi.materialize_record(trec))
    return js, ts, jrecs, trecs


@pytest.mark.parametrize("engine", ["vmap", "map"])
@pytest.mark.parametrize("dp,atol", [(False, 1e-6), (True, 1e-5)])
@pytest.mark.parametrize("name,kw", PIPELINE_SETTINGS,
                         ids=[n for n, _ in PIPELINE_SETTINGS])
def test_pipeline_rounds_match_jax(monkeypatch, engine, dp, atol, name, kw):
    jspec, tspec = _specs(engine=engine, dp=dp, **kw)
    js, ts, jrecs, trecs = _run_both(monkeypatch, jspec, tspec)
    want = jax.tree.map(np.asarray, (js.params, js.opt_state))
    got = tree_to_numpy((ts.params, ts.opt_state))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert w.dtype == g.dtype and w.shape == g.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    if js.residual is None:
        assert ts.residual is None
    else:
        assert ts.residual.shape == (C, D)
        np.testing.assert_allclose(ts.residual.numpy(),
                                   np.asarray(js.residual), rtol=0,
                                   atol=atol)
    np.testing.assert_array_equal(ts.rho, js.rho)
    assert (ts.steps, ts.resource_spent, ts.rounds_done) == \
        (js.steps, js.resource_spent, js.rounds_done)
    for jr, tr in zip(jrecs, trecs):
        for k in ("round", "iterations", "max_epsilon", "resource_spent",
                  "participants"):
            assert tr[k] == jr[k]
        assert tr["loss"] == pytest.approx(jr["loss"], abs=atol)
    # every replica ends the round on the one global model
    for x in tree_to_numpy(ts.params).values():
        for c in range(1, C):
            np.testing.assert_array_equal(x[c], x[0])


@pytest.mark.parametrize("average_opt_state", [True, False])
def test_momentum_state_under_participation_matches_jax(monkeypatch,
                                                        average_opt_state):
    """Optimizer state: the participants' mean, or each non-participant's
    own state kept; the int32 step counter stays int32."""
    jspec, tspec = _specs(opt="momentum", participation=0.5,
                          compressor="qsgd",
                          average_opt_state=average_opt_state)
    js, ts, _, _ = _run_both(monkeypatch, jspec, tspec, n_rounds=3)
    assert ts.opt_state.step.dtype == torch.int32
    np.testing.assert_array_equal(ts.opt_state.step.numpy(),
                                  np.asarray(js.opt_state.step))
    assert _max_gap((js.params, js.opt_state),
                    tree_to_numpy((ts.params, ts.opt_state))) <= 1e-5


def test_amplified_ledger_matches_jax(monkeypatch):
    jspec, tspec = _specs(participation=1, amplify_participation=True)
    assert tspec.accounting_q() == jspec.accounting_q() == 1 / C
    js, ts, jrecs, trecs = _run_both(monkeypatch, jspec, tspec, n_rounds=3)
    np.testing.assert_array_equal(ts.rho, js.rho)
    assert [r["max_epsilon"] for r in trecs] == \
        [r["max_epsilon"] for r in jrecs]


def test_nonparticipants_spend_no_privacy():
    _, tspec = _specs(participation=1)
    state = _cpu_state(tspec)
    recs = []
    for r in range(3):
        state, rec = tapi.run_round(tspec, state, _batch(r),
                                    check_budgets=False)
        recs.append(rec)
    assert [r["participants"] for r in recs] == [1.0] * 3
    assert (state.rho > 0).sum() <= 3
    per_round = tapi.round_rho_charges(tspec)[0]
    assert state.rho.sum() == pytest.approx(3 * per_round, rel=1e-12)


def test_qsgd_round_makes_one_kernel_call_on_all_rows(monkeypatch):
    seen = []
    real = tops.quantize_decompress

    def spy(x, u, bits):
        seen.append((tuple(x.shape), bits))
        return real(x, u, bits)

    monkeypatch.setattr(tops, "quantize_decompress", spy)
    _, tspec = _specs(compressor="qsgd", compression_bits=4,
                      participation=0.5)
    tapi.run_round(tspec, _cpu_state(tspec), _batch(0), check_budgets=False)
    assert seen == [((C, D), 4)]


def test_q_sweep_reuses_the_round_function():
    _, q = _specs(participation=0.5)
    assert q.replace(participation=0.75).engine_key() == q.engine_key()
    assert q.engine_key() != _specs()[1].engine_key()
    assert tapi.round_fn_for(q) is tapi.round_fn_for(
        q.replace(participation=0.75))


# ------------------------------ chunking -------------------------------------

@pytest.mark.parametrize("kw", [
    dict(compressor="qsgd", compression_bits=8, participation=0.75),
    dict(compressor="randk", compression_ratio=0.25, participation=0.5),
], ids=["qsgd8-q75", "randk25-q50"])
def test_run_rounds_equals_run_round_bitwise_under_a_pipeline(kw):
    _, tspec = _specs(**kw)
    batches = {k: np.stack([_batch(r)[k] for r in range(3)])
               for k in ("x", "y")}
    s1, recs1 = _cpu_state(tspec), []
    for r in range(3):
        s1, rec = tapi.run_round(tspec, s1, {k: v[r] for k, v in
                                             batches.items()})
        recs1.append(tapi.materialize_record(rec))
    s2, recs2 = tapi.run_rounds(tspec, _cpu_state(tspec), batches)
    for a, b in zip(jax.tree.leaves(tree_to_numpy((s1.params, s1.opt_state,
                                                   s1.residual))),
                    jax.tree.leaves(tree_to_numpy((s2.params, s2.opt_state,
                                                   s2.residual)))):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(s1.key, s2.key)
    np.testing.assert_array_equal(s1.rho, s2.rho)
    assert (s1.steps, s1.resource_spent, s1.rounds_done) == \
        (s2.steps, s2.resource_spent, s2.rounds_done)
    assert recs1 == [tapi.materialize_record(r) for r in recs2]
    assert all(r["participants"] == tspec.participants_per_round()
               for r in recs1)


def test_chunked_train_equals_per_round_train_under_a_pipeline():
    _, tspec = _specs(compressor="topk", compression_ratio=0.25,
                      participation=0.5, eps_th=1e9, c_th=200.0)

    def sampler(m, tau, rng):
        return {"x": rng.normal(size=(tau, B, DIM)).astype(np.float32),
                "y": rng.integers(0, 2, size=(tau, B)).astype(np.int32)}

    runs = []
    for chunk in (1, 3):
        state, out = tapi.train(tspec, _cpu_state(tspec), sampler,
                                chunk_rounds=chunk, max_rounds=20)
        runs.append((tree_to_numpy((state.params, state.residual)), out))
    (p1, o1), (p3, o3) = runs
    assert o1["rounds"] == o3["rounds"] == 12     # 200 // (12.5 + 3)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p3)):
        np.testing.assert_array_equal(a, b)
    assert [r["loss"] for r in o1["history"]] == \
        [r["loss"] for r in o3["history"]]


# ------------------------- full width: the comm sweep -----------------------

def _comm_sweep_specs(fed, participation, compressor, ratio):
    """``benchmarks/common.run_dp_pasgd``'s spec for the comm sweep of
    ``benchmarks/fig4_resource_tradeoff.py``: tau 5, K 100, eps_th 10, a
    C_th that never binds, sgd 0.3, batch 32."""
    tau, k, eps = 5, 100, 10.0
    x_m = fed.batch_sizes(32)
    common = dict(n_clients=fed.n_clients, tau=tau, clip_norm=1.0, dp=True,
                  participation=participation, compressor=compressor,
                  compression_ratio=ratio, compression_bits=8,
                  sigmas=tuple(float(s) for s in design_sigmas(
                      k, 1.0, x_m, eps, 1e-4)),
                  batch_sizes=tuple(x_m), eps_th=eps, delta=1e-4,
                  c_th=10 * k * (100.0 / tau + 1.0), c1=100.0, c2=1.0,
                  seed=0)
    return (japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=jsgd(0.3),
                                kernel_backend="ref", **common),
            tapi.FederationSpec(loss_fn=tlin.logreg_loss,
                                optimizer=tsgd(0.3), **common))


def _full_width_qsgd8_q50(monkeypatch):
    """Train the qsgd8_q50 comm-sweep row in both packages, JAX's draws fed
    to the port; -> (jax state, jax summary, port state, port summary)."""
    fed = split_iid(adult_like(seed=0), 16)
    dim = fed.clients[0].x_train.shape[1]
    jspec, tspec = _comm_sweep_specs(fed, 0.5, "qsgd", 0.25)
    xt, yt = fed.eval_arrays("test")
    params0 = jlin.init_linear(dim)
    js0 = japi.init_state(jspec, params0)
    _inject_jax_draws(monkeypatch, jspec, js0.key, params0)
    js, jout = japi.train(jspec, js0, fed.make_sampler(32), max_rounds=20,
                          eval_fn=jlin.make_eval_fn(jlin.logreg_loss, xt, yt))
    ts, tout = tapi.train(tspec, _cpu_state(tspec, dim), fed.make_sampler(32),
                          max_rounds=20,
                          eval_fn=tlin.make_eval_fn(tlin.logreg_loss, xt, yt))
    return js, jout, ts, tout


def _flips(js, ts) -> int:
    """Residual coordinates a flipped QSGD level moved (by a level step,
    far above the 1e-5 round gaps)."""
    return int(np.sum(np.abs(ts.residual.numpy() - np.asarray(js.residual))
                      > 1e-5))


def test_full_width_qsgd8_q50_comm_sweep_row_matches_jax(monkeypatch):
    """The qsgd8_q50 row of the comm sweep at full width (Adult-2:
    split_iid(adult_like(seed=0), 16), d = 104) in both packages: 20
    rounds, resource_spent 350.0 and max_epsilon 8.772661 exactly; best
    eval loss within 1e-4 and accuracy within 5e-4. The JAX side reproduces
    its own recorded row (best acc 0.7198, best eval loss 0.56906). At these
    seeds no QSGD level flips, so the residuals agree within 1e-5."""
    js, jout, ts, tout = _full_width_qsgd8_q50(monkeypatch)
    assert jout["rounds"] == tout["rounds"] == 20
    assert jout["resource_spent"] == tout["resource_spent"] == 350.0
    assert tout["max_epsilon"] == jout["max_epsilon"]
    assert round(tout["max_epsilon"], 6) == 8.772661
    np.testing.assert_array_equal(ts.rho, js.rho)
    assert all(r["participants"] == 8.0 for r in tout["history"])
    jb, tb = jout["best"], tout["best"]
    assert round(jb["eval_acc"], 4) == 0.7198
    assert round(jb["eval_loss"], 5) == 0.56906
    assert abs(tb["eval_loss"] - jb["eval_loss"]) <= 1e-4
    assert abs(tb["eval_acc"] - jb["eval_acc"]) <= 5e-4
    assert _flips(js, ts) == 0


# ------------------------------ checkpoints ---------------------------------

def test_checkpoint_round_trip_continues_bitwise(tmp_path):
    _, tspec = _specs(opt="momentum", compressor="qsgd", participation=0.5)
    full = _cpu_state(tspec)
    for r in range(4):
        full, _ = tapi.run_round(tspec, full, _batch(r))
    part = _cpu_state(tspec)
    for r in range(2):
        part, _ = tapi.run_round(tspec, part, _batch(r))
    tapi.save_state(str(tmp_path), part, extra={"note": "r2"})
    resumed, extra = tapi.load_state(str(tmp_path), _cpu_state(tspec))
    assert extra["note"] == "r2" and resumed.rounds_done == 2
    for r in range(2, 4):
        resumed, _ = tapi.run_round(tspec, resumed, _batch(r))
    for a, b in zip(
            jax.tree.leaves(tree_to_numpy((full.params, full.opt_state,
                                           full.residual))),
            jax.tree.leaves(tree_to_numpy((resumed.params, resumed.opt_state,
                                           resumed.residual)))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert torch.equal(full.key, resumed.key)
    np.testing.assert_array_equal(full.rho, resumed.rho)
    assert (full.steps, full.resource_spent) == \
        (resumed.steps, resumed.resource_spent)


def test_jax_checkpoint_reads_back_bitwise(tmp_path):
    """A checkpoint the JAX package wrote (its FLState after two qsgd
    rounds with momentum) reads back through the port's load_checkpoint
    bit for bit, under the same leaf paths the port writes."""
    jspec, tspec = _specs(opt="momentum", compressor="qsgd",
                          participation=0.5)
    js = japi.init_state(jspec, jlin.init_linear(DIM))
    for r in range(2):
        js, _ = japi.run_round(jspec, js, jax.tree.map(jnp.asarray,
                                                       _batch(r)))
    japi.save_state(str(tmp_path / "jax"), js)
    ts = _cpu_state(tspec)
    tapi.save_state(str(tmp_path / "torch"), ts)
    assert checkpoint_leaf_paths(str(tmp_path / "jax")) == \
        checkpoint_leaf_paths(str(tmp_path / "torch"))
    like = {"params": ts.params, "opt_state": ts.opt_state,
            "residual": ts.residual}
    tree, step, extra = load_checkpoint(str(tmp_path / "jax"), like=like)
    assert step == 2 and extra["rounds_done"] == 2
    want = jax.tree.map(np.asarray, {"params": js.params,
                                     "opt_state": js.opt_state,
                                     "residual": js.residual})
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tree)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


def test_residual_presence_rules_on_load(tmp_path):
    """A dense checkpoint resumed under a compressor keeps the fresh zero
    residual; a compressed checkpoint resumed dense drops its residual."""
    _, dense = _specs()
    _, comp = _specs(compressor="topk", compression_ratio=0.25)
    sd, _ = tapi.run_round(dense, _cpu_state(dense), _batch(0))
    tapi.save_state(str(tmp_path / "dense"), sd)
    got, _ = tapi.load_state(str(tmp_path / "dense"), _cpu_state(comp))
    assert torch.equal(got.residual, torch.zeros((C, D)))
    sc, _ = tapi.run_round(comp, _cpu_state(comp), _batch(0))
    assert sc.residual.abs().max() > 0
    tapi.save_state(str(tmp_path / "comp"), sc)
    got, _ = tapi.load_state(str(tmp_path / "comp"), _cpu_state(dense))
    assert got.residual is None
    np.testing.assert_array_equal(got.params["w"].numpy(),
                                  sc.params["w"].numpy())


if __name__ == "__main__":
    # the max |torch - jax| each pipeline gate sees (the tests above assert
    # the tolerances): PYTHONPATH=src python tests/test_torch_aggregation.py
    class _Patch:
        def setattr(self, obj, name, value):
            setattr(obj, name, value)

    for engine in ("vmap", "map"):
        for dp in (False, True):
            worst_p = worst_r = 0.0
            for name, kw in PIPELINE_SETTINGS:
                jspec, tspec = _specs(engine=engine, dp=dp, **kw)
                js, ts, _, _ = _run_both(_Patch(), jspec, tspec)
                worst_p = max(worst_p, _max_gap(js.params,
                                                tree_to_numpy(ts.params)))
                if js.residual is not None:
                    worst_r = max(worst_r, float(np.max(np.abs(
                        ts.residual.numpy() - np.asarray(js.residual)))))
            print(f"pipeline rounds {engine} dp={dp}: max|dparams| = "
                  f"{worst_p:.3e}, max|dresidual| = {worst_r:.3e}")
    js, jout, ts, tout = _full_width_qsgd8_q50(_Patch())
    jb, tb = jout["best"], tout["best"]
    d_loss = abs(tb["eval_loss"] - jb["eval_loss"])
    print(f"full-width qsgd8_q50: rounds {tout['rounds']} / {jout['rounds']},"
          f" max_epsilon {tout['max_epsilon']:.6f} / {jout['max_epsilon']:.6f}"
          f", |d best eval loss| = {d_loss:.3e}"
          f", |d best acc| = {abs(tb['eval_acc'] - jb['eval_acc']):.3e}, "
          f"max|dparams| = {_max_gap(js.params, tree_to_numpy(ts.params)):.3e}"
          f", flipped levels = {_flips(js, ts)}")
