"""The port's trust plane (``repro_torch.core.robust``,
``repro_torch.core.secureagg``, ``repro_torch.population.attacks`` and the
pipeline's adversarial branch) against the JAX package.

- The secure-aggregation host protocol is a numpy copy: every function
  equals JAX's bit for bit, and the masked survivor sum equals the plain
  fixed-point sum exactly under any dropout set.
- ``SecureMaskedSum.masked_mean`` equals JAX's bit for bit on the same
  updates and mask (the pair masks differ and cancel).
- The robust aggregators equal JAX's on even and odd P: the median bit for
  bit, the trimmed mean and the norm bound within 1e-6 of the largest
  magnitude (sums in another order); they are permutation-invariant.
- Byzantine flags and per-vid membership are exact; the attack is a select.
- With JAX's draws injected, trust-plane rounds (per round and chunked),
  trained runs, the central ledger and a population cohort round match JAX:
  params within 1e-5, rho, costs and epsilons exactly.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_aggregation import jax_pipeline_draws
from test_torch_population import (
    _assert_close_to_jax,
    _assert_records,
)
from test_torch_population import _jspec as _jpop_spec
from test_torch_population import _tspec as _tpop_spec
from test_torch_population import _tstate as _tpop_state

import repro.api as japi
import repro.population as jpop
import repro_torch.api as tapi
import repro_torch.api.state as tstate
import repro_torch.core.fl as tfl
import repro_torch.population as tpop
from repro.core import robust as jrob
from repro.core import secureagg as jsec
from repro.models import linear as jlin
from repro.optim import sgd as jsgd
from repro_torch.core import robust as trob
from repro_torch.core import secureagg as tsec
from repro_torch.models import linear as tlin
from repro_torch.optim import sgd as tsgd
from repro_torch.utils.convert import tree_to_numpy

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import benchmarks.attack_resilience as jatt  # noqa: E402
import benchmarks.attack_resilience_torch as tatt  # noqa: E402

C, TAU, DIM, B = 8, 3, 8, 4
BYZ = 0.25
TOPT, JOPT = tsgd(0.2), jsgd(0.2)


def _common(**kw):
    base = dict(n_clients=C, tau=TAU, clip_norm=1.0, dp=True,
                sigmas=(0.3,) * C, batch_sizes=(B,) * C)
    base.update(kw)
    return base


def _tspec(**kw):
    return tapi.FederationSpec(loss_fn=tlin.logreg_loss, optimizer=TOPT,
                               **_common(**kw))


def _jspec(**kw):
    return japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=JOPT,
                               kernel_backend="ref", **_common(**kw))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(C, TAU, B, DIM)).astype(np.float32),
            "y": rng.integers(0, 2, size=(C, TAU, B)).astype(np.int32)}


def _cpu_state(spec):
    return tapi.init_state(spec, tlin.init_linear(DIM, device="cpu"),
                           device="cpu")


def _inject(monkeypatch, jspec, jkey, params0):
    """Every pipeline round of the port draws JAX's mask, noise and
    compressor operand from ``jkey``'s schedule; under secure aggregation
    the pair masks come from a torch generator (they cancel)."""
    box = [jkey]
    gen = torch.Generator().manual_seed(11)

    def draws(key, params, tau, pipeline):
        mask, noise, agg_rand, box[0] = jax_pipeline_draws(box[0], params0,
                                                           jspec)
        if pipeline.secure is not None:
            agg_rand = (agg_rand, pipeline.secure.draw(
                gen, noise.shape[-1], "cpu"))
        return mask, noise, agg_rand, key

    monkeypatch.setattr(tstate, "draw_pipeline_round", draws)
    monkeypatch.setattr(tfl, "draw_pipeline_round", draws)


def _updates(vids, dim, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return {int(v): rng.normal(scale=scale, size=dim) for v in vids}


# --------------------------- secure aggregation, host ------------------------

@pytest.mark.parametrize("seed,m,k,n_drop,rnd,dim", [
    (0, 5, 3, 0, 0, 4), (1, 40, 12, 5, 7, 16), (2, 9, 9, 8, 3, 1),
    (3, 100, 6, 2, 50, 12), (4, 2, 2, 1, 1, 8)])
def test_host_protocol_matches_jax_bitwise(seed, m, k, n_drop, rnd, dim):
    """Every host function equals JAX's, and the masked survivor sum equals
    the plain fixed-point sum with zero tolerance."""
    rng = np.random.default_rng((seed, 0xC0))
    cohort = np.sort(rng.choice(m, size=k, replace=False))
    dropped = rng.permutation(cohort)[:min(n_drop, k - 1)]
    survivors = [int(v) for v in cohort if v not in set(dropped.tolist())]
    updates = _updates(cohort, dim, seed)
    x = updates[int(cohort[0])]
    for bits in (1, 16, 24):
        np.testing.assert_array_equal(tsec.fp_encode(x, bits),
                                      jsec.fp_encode(x, bits))
        enc = jsec.fp_encode(x, bits)
        np.testing.assert_array_equal(tsec.fp_decode(enc, bits),
                                      jsec.fp_decode(enc, bits))
    i, j = int(cohort[0]), int(cohort[-1])
    np.testing.assert_array_equal(tsec.pairwise_mask(seed, i, j, rnd, dim),
                                  jsec.pairwise_mask(seed, i, j, rnd, dim))
    np.testing.assert_array_equal(
        tsec.masked_update(x, i, cohort, seed, rnd),
        jsec.masked_update(x, i, cohort, seed, rnd))
    np.testing.assert_array_equal(
        tsec.dropout_correction(survivors, dropped, seed, rnd, dim),
        jsec.dropout_correction(survivors, dropped, seed, rnd, dim))
    got = tsec.secure_aggregate(updates, cohort, seed, rnd, dropped=dropped)
    np.testing.assert_array_equal(
        got, jsec.secure_aggregate(updates, cohort, seed, rnd,
                                   dropped=dropped))
    np.testing.assert_array_equal(
        got, tsec.unmasked_fixed_point_sum(updates, survivors))
    np.testing.assert_array_equal(
        tsec.unmasked_fixed_point_sum(updates, survivors),
        jsec.unmasked_fixed_point_sum(updates, survivors))


@pytest.mark.parametrize("frac_bits", [1, 8, 16, 24])
def test_fp_codec_roundtrip_error_bounded_by_grid(frac_bits):
    x = np.random.default_rng(frac_bits).normal(scale=10.0, size=64)
    back = tsec.fp_decode(tsec.fp_encode(x, frac_bits), frac_bits)
    assert np.max(np.abs(back - x)) <= 0.5 / (1 << frac_bits) + 1e-12
    grid = np.round(x * (1 << frac_bits)) / (1 << frac_bits)
    np.testing.assert_array_equal(
        tsec.fp_decode(tsec.fp_encode(grid, frac_bits), frac_bits), grid)


def test_pairwise_masks_antisymmetric_and_fresh_per_round():
    for seed, vi, vj, rnd in [(0, 1, 2, 0), (7, 300, 4, 9), (9, 0, 500, 99)]:
        a = tsec.pairwise_mask(seed, vi, vj, rnd, 8).astype(np.int64)
        b = tsec.pairwise_mask(seed, vj, vi, rnd, 8).astype(np.int64)
        np.testing.assert_array_equal((a + b) % tsec.MODULUS, 0)
        assert not np.array_equal(a, tsec.pairwise_mask(
            seed, vi, vj, rnd + 1, 8).astype(np.int64))
    with pytest.raises(ValueError):
        tsec.pairwise_mask(0, 3, 3, 0, 8)


def test_dropout_correction_is_exactly_the_mask_residue():
    for seed, k, dim in [(0, 2, 1), (3, 7, 5), (5, 10, 12)]:
        cohort = list(range(k))
        dropped, survivors = cohort[:k // 2], cohort[k // 2:]
        want = np.zeros(dim, np.int64)
        for i in survivors:
            for j in dropped:
                want = (want + tsec.pairwise_mask(seed, i, j, 0, dim)) \
                    % tsec.MODULUS
        np.testing.assert_array_equal(
            tsec.dropout_correction(survivors, dropped, seed, 0, dim)
            .astype(np.int64), want)
        np.testing.assert_array_equal(
            tsec.dropout_correction(survivors, (), seed, 0, dim), 0)


def test_masked_upload_hides_the_plaintext_and_inputs_are_validated():
    u = np.full((64,), 0.25)
    a = tsec.masked_update(u, 0, (0, 1, 2), seed=7, round_idx=0)
    assert not np.array_equal(a, tsec.fp_encode(u))
    assert not np.array_equal(a, tsec.masked_update(u, 0, (0, 1, 3), 7, 0))
    assert not np.array_equal(a, tsec.masked_update(u, 0, (0, 1, 2), 7, 1))
    assert np.max(np.abs(tsec.fp_decode(a))) > 1.0
    updates = _updates(range(4), 8, 0)
    with pytest.raises(ValueError):
        tsec.secure_aggregate(updates, range(4), 0, 0, dropped=(9,))
    with pytest.raises(ValueError):
        tsec.secure_aggregate(updates, range(4), 0, 0, dropped=range(4))
    with pytest.raises(ValueError):
        tsec.central_rho_scale(0)
    assert tsec.central_rho_scale(8) == jsec.central_rho_scale(8) == 1 / 8
    for bad in (0, 25):
        with pytest.raises(ValueError):
            tsec.validate_secure(bad)
        with pytest.raises(ValueError):
            tsec.SecureMaskedSum(C, bad)


def test_secure_round_over_heterogeneous_cohort_draw():
    """The port's HeterogeneousCohort picks each round's K vids; a mid-round
    dropout set over them is recovered exactly."""
    m, k, dim, seed = 40, 8, 12, 3
    sampler = tpop.HeterogeneousCohort(seed=seed, dropout=0.3)
    rng = np.random.default_rng(seed)
    saw_dropout = False
    for rnd in range(6):
        cohort = sampler(rnd, m, k)
        dropped = cohort[rng.random(k) < 0.3][:k - 1]
        saw_dropout = saw_dropout or len(dropped) > 0
        updates = _updates(cohort, dim, (seed, rnd))
        survivors = [v for v in cohort if v not in set(dropped.tolist())]
        np.testing.assert_array_equal(
            tsec.secure_aggregate(updates, cohort, seed, rnd,
                                  dropped=dropped),
            tsec.unmasked_fixed_point_sum(updates, survivors))
    assert saw_dropout


# --------------------------- secure aggregation, plugin ----------------------

@pytest.mark.parametrize("c,d,frac_bits,n_drop", [
    (8, 17, 16, 0), (8, 17, 16, 3), (16, 210, 16, 8), (5, 33, 10, 4),
    (1, 6, 24, 0), (3, 40, 1, 1)])
def test_masked_mean_matches_jax_bitwise(c, d, frac_bits, n_drop):
    rng = np.random.default_rng(c * 1000 + d)
    x = (rng.normal(size=(c, d)) * rng.uniform(0.01, 3.0)).astype(np.float32)
    mask = np.ones((c,), np.float32)
    mask[rng.choice(c, size=n_drop, replace=False)] = 0.0
    want = np.asarray(jsec.SecureMaskedSum(c, frac_bits).masked_mean(
        jnp.asarray(x), jnp.asarray(mask), jax.random.PRNGKey(c)))
    sec = tsec.SecureMaskedSum(c, frac_bits)
    pairs = sec.draw(torch.Generator().manual_seed(d), d, "cpu")
    got = sec.masked_mean(torch.as_tensor(x), torch.as_tensor(mask), pairs)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_mean_exact_on_the_fixed_point_grid():
    sec = tsec.SecureMaskedSum(n_clients=C, frac_bits=10)
    rng = np.random.default_rng(0)
    grid = rng.integers(-4000, 4000, size=(C, 17)) / float(1 << 10)
    pairs = sec.draw(torch.Generator().manual_seed(3), 17, "cpu")
    for dropped in (0, 3):
        mask = np.ones((C,), np.float32)
        if dropped:
            mask[rng.choice(C, size=dropped, replace=False)] = 0.0
        got = sec.masked_mean(torch.as_tensor(grid, dtype=torch.float32),
                              torch.as_tensor(mask), pairs).numpy()
        int_sum = (grid * (1 << 10)).astype(np.int64)[mask > 0].sum(axis=0)
        want = (int_sum.astype(np.int32).astype(np.float32)
                / np.float32(1 << 10)) / np.float32(mask.sum())
        np.testing.assert_array_equal(got, want)


def test_pair_masks_are_antisymmetric_field_elements():
    sec = tsec.SecureMaskedSum(6)
    m = sec.draw(torch.Generator().manual_seed(0), 9, "cpu")
    assert m.shape == (6, 6, 9) and m.dtype == torch.int64
    assert int(m.min()) >= 0 and int(m.max()) < tsec.MODULUS
    assert torch.equal((m + m.transpose(0, 1)) % tsec.MODULUS,
                       torch.zeros_like(m))
    assert torch.equal(m.sum(dim=(0, 1)) % tsec.MODULUS,
                       torch.zeros(9, dtype=torch.int64))
    assert int((m[0, 1] != 0).sum()) > 0


# --------------------------------- robust -----------------------------------

@pytest.mark.parametrize("p", [1, 2, 3, 6, 7, 16])
@pytest.mark.parametrize("name,kw", [
    ("median", {}), ("trimmed_mean", dict(trim_fraction=0.25)),
    ("trimmed_mean", dict(trim_fraction=0.1)),
    ("norm_bound", dict(norm_bound_factor=2.0)),
    ("norm_bound", dict(norm_bound_factor=0.5))],
    ids=["median", "trim25", "trim10", "norm2", "norm05"])
def test_aggregators_match_jax(p, name, kw):
    rng = np.random.default_rng(p)
    u = (rng.normal(size=(p, 210)) * rng.uniform(0.1, 10.0, size=(p, 1))
         ).astype(np.float32)
    args = (kw.get("trim_fraction", 0.1), kw.get("norm_bound_factor", 3.0))
    want = np.asarray(jrob.make_aggregator(name, *args)(jnp.asarray(u)))
    got = trob.make_aggregator(name, *args)(torch.as_tensor(u)).numpy()
    if name == "median":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("seed", range(4))
def test_aggregators_permutation_invariant_and_bounded(seed):
    rng = np.random.default_rng(seed)
    p = 3 + seed * 2
    u = torch.as_tensor(rng.normal(scale=rng.uniform(0.1, 10.0),
                                   size=(p, 5)).astype(np.float32))
    perm = torch.as_tensor(rng.permutation(p))
    for agg in (trob.CoordinateMedian(), trob.TrimmedMean(0.3),
                trob.NormBound(2.0)):
        out = agg(u)
        np.testing.assert_allclose(agg(u[perm]).numpy(), out.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert bool((out >= u.min(dim=0).values - 1e-6).all())
        assert bool((out <= u.max(dim=0).values + 1e-6).all())


@pytest.mark.parametrize("seed", range(3))
def test_participant_rows_match_jax(seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(C, 4)).astype(np.float32)
    chosen = np.sort(rng.choice(C, size=2 + seed, replace=False))
    mask = np.zeros((C,), np.float32)
    mask[chosen] = 1.0
    got = trob.participant_rows(torch.as_tensor(u), torch.as_tensor(mask),
                                len(chosen)).numpy()
    np.testing.assert_array_equal(got, u[chosen])
    np.testing.assert_array_equal(got, np.asarray(jrob.participant_rows(
        jnp.asarray(u), jnp.asarray(mask), len(chosen))))


@pytest.mark.parametrize("n,frac,seed", [(8, 0.25, 0), (8, 0.25, 3),
                                         (16, 0.1, 1), (5, 0.0, 0),
                                         (100, 0.375, 9)])
def test_byzantine_flags_and_attacks_match_jax(n, frac, seed):
    flags = trob.byzantine_flags(n, frac, seed)
    assert flags == jrob.byzantine_flags(n, frac, seed)
    assert sum(flags) == round(frac * n)
    u = np.random.default_rng(seed).normal(size=(n, 5)).astype(np.float32)
    for name, scale in (("sign_flip", 10.0), ("scale", -25.0)):
        t_att = trob.make_attack(name, flags, scale)
        j_att = jrob.make_attack(name, flags, scale)
        if not any(flags):
            assert t_att is None and j_att is None
            continue
        got = t_att(torch.as_tensor(u)).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_att(jnp.asarray(u))))
        honest = np.asarray(flags) == 0
        np.testing.assert_array_equal(got[honest], u[honest])


def test_factories_and_validation_match_jax():
    assert trob.make_aggregator("mean") is None
    assert isinstance(trob.make_aggregator("median"), trob.CoordinateMedian)
    assert isinstance(trob.make_aggregator("trimmed_mean", 0.2),
                      trob.TrimmedMean)
    assert isinstance(trob.make_aggregator("norm_bound", 0.1, 2.0),
                      trob.NormBound)
    assert trob.make_attack("none", (1, 1)) is None
    assert trob.make_attack("sign_flip", (0,) * C) is None
    assert isinstance(trob.make_attack("sign_flip", (1, 0)),
                      trob.UpdateAttack)
    for args in [("krum",), ("trimmed_mean", 0.5), ("norm_bound", 0.1, 0.0)]:
        for mod in (trob, jrob):
            with pytest.raises(ValueError):
                mod.validate_aggregator(*args)
    for args in [("theft",), ("sign_flip", 1.0), ("scale", 0.25, 0.0)]:
        for mod in (trob, jrob):
            with pytest.raises(ValueError):
                mod.validate_attack(*args)
    assert trob.AGGREGATORS == jrob.AGGREGATORS
    assert trob.ATTACKS == jrob.ATTACKS
    y = np.asarray([0, 1, 2, 1])
    np.testing.assert_array_equal(trob.flip_labels(y, 3),
                                  jrob.flip_labels(y, 3))


# ------------------------------ population attacks ---------------------------

def test_malicious_population_matches_jax():
    m, frac, seed = 64, 0.25, 5
    flags = [tpop.is_byzantine_vid(v, frac, seed) for v in range(m)]
    assert flags == [jpop.is_byzantine_vid(v, frac, seed) for v in range(m)]
    assert any(flags) and not all(flags)
    tmal = tpop.malicious_population(
        tpop.synthetic_population(m, dim=DIM, batch_size=B),
        byzantine_fraction=frac, seed=seed)
    jmal = jpop.malicious_population(
        jpop.synthetic_population(m, dim=DIM, batch_size=B),
        byzantine_fraction=frac, seed=seed)
    tbase = tpop.synthetic_population(m, dim=DIM, batch_size=B)
    assert tmal.name == jmal.name and tmal.n_clients == m
    for vid in range(0, m, 5):
        got = tmal.sampler(vid, TAU, np.random.default_rng((1, vid)))
        want = jmal.sampler(vid, TAU, np.random.default_rng((1, vid)))
        base = tbase.sampler(vid, TAU, np.random.default_rng((1, vid)))
        for k in ("x", "y"):
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["x"], base["x"])
        np.testing.assert_array_equal(
            got["y"], 1 - base["y"] if flags[vid] else base["y"])
    assert tpop.POPULATION_ATTACKS == jpop.POPULATION_ATTACKS
    with pytest.raises(ValueError):
        tpop.malicious_population(tbase, attack="sign_flip")
    with pytest.raises(ValueError):
        tpop.malicious_population(tbase, n_classes=1)


# --------------------- trust-plane rounds, JAX's draws injected --------------

TRUST = [
    ("median-q75", dict(aggregator="median", participation=0.75)),
    ("trimmed-topk", dict(aggregator="trimmed_mean", trim_fraction=0.25,
                          compressor="topk", compression_ratio=0.25)),
    ("normbound", dict(aggregator="norm_bound", norm_bound_factor=2.0)),
    ("secure-q50", dict(secure_agg=True, participation=0.5)),
    ("secure-qsgd-central", dict(secure_agg=True, compressor="qsgd",
                                 compression_bits=4,
                                 dp_accounting="central")),
    ("signflip", dict(attack="sign_flip", byzantine_fraction=BYZ)),
    ("scale-median", dict(attack="scale", attack_scale=-25.0,
                          byzantine_fraction=BYZ, aggregator="median")),
]
TRUST_IDS = [n for n, _ in TRUST]


def _assert_state_close(js, ts, atol=1e-5):
    for w, g in zip(jax.tree.leaves(jax.tree.map(np.asarray, js.params)),
                    jax.tree.leaves(tree_to_numpy(ts.params))):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    np.testing.assert_array_equal(ts.rho, js.rho)
    assert (ts.steps, ts.resource_spent, ts.rounds_done) == \
        (js.steps, js.resource_spent, js.rounds_done)
    if js.residual is not None:
        np.testing.assert_allclose(ts.residual.numpy(),
                                   np.asarray(js.residual), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("name,kw", TRUST, ids=TRUST_IDS)
def test_trust_rounds_match_jax(monkeypatch, name, kw):
    """Two run_round calls, then a run_rounds chunk of 2, in both packages
    from JAX's draws: params within 1e-5, the ledger and records exactly."""
    jspec, tspec = _jspec(**kw), _tspec(**kw)
    params0 = jlin.init_linear(DIM)
    js = japi.init_state(jspec, params0)
    ts = _cpu_state(tspec)
    _inject(monkeypatch, jspec, js.key, params0)
    for r in range(2):
        js, jr = japi.run_round(jspec, js, _batch(r), check_budgets=False)
        ts, tr = tapi.run_round(tspec, ts, _batch(r), check_budgets=False)
        assert tr["max_epsilon"] == jr["max_epsilon"]
        assert tr["participants"] == float(jr["participants"])
        assert float(tr["loss"]) == pytest.approx(float(jr["loss"]),
                                                  abs=1e-5)
    chunk = {k: np.stack([_batch(2)[k], _batch(3)[k]]) for k in ("x", "y")}
    js, jrecs = japi.run_rounds(jspec, js, chunk, check_budgets=False)
    ts, trecs = tapi.run_rounds(tspec, ts, chunk, check_budgets=False)
    assert [r["max_epsilon"] for r in trecs] == \
        [r["max_epsilon"] for r in jrecs]
    _assert_state_close(js, ts)


@pytest.mark.parametrize("name,kw", [TRUST[0], TRUST[3], TRUST[6]],
                         ids=[TRUST_IDS[0], TRUST_IDS[3], TRUST_IDS[6]])
def test_trained_trust_runs_stop_where_jax_stops(monkeypatch, name, kw):
    """train() to a binding privacy budget under the trust plane, per round
    and in chunks of 3."""
    budgets = dict(eps_th=30.0, c_th=1e9)
    jspec, tspec = _jspec(**kw, **budgets), _tspec(**kw, **budgets)
    params0 = jlin.init_linear(DIM)

    def sampler(m, tau, rng):
        return {"x": rng.normal(size=(tau, B, DIM)).astype(np.float32),
                "y": rng.integers(0, 2, size=(tau, B)).astype(np.int32)}

    js0 = japi.init_state(jspec, params0)
    js, jout = japi.train(jspec, js0, sampler)
    for chunk in (1, 3):
        _inject(monkeypatch, jspec, js0.key, params0)
        ts, tout = tapi.train(tspec, _cpu_state(tspec), sampler,
                              chunk_rounds=chunk)
        assert tout["rounds"] == jout["rounds"] > 1
        assert tout["max_epsilon"] == jout["max_epsilon"] <= 30.0
        _assert_state_close(js, ts)


def test_central_ledger_matches_jax(monkeypatch):
    """dp_accounting='central' divides every charge by P, exactly as JAX's
    ledger does; it stays out of the engine key."""
    kw = dict(secure_agg=True, participation=0.5)
    local_t, local_j = _tspec(**kw), _jspec(**kw)
    central_t = local_t.replace(dp_accounting="central")
    central_j = local_j.replace(dp_accounting="central")
    p = local_t.participants_per_round()
    assert central_t.engine_key() == local_t.engine_key()
    assert central_t.accounting_q() == central_j.accounting_q() == 1.0 / p
    amp_t = central_t.replace(amplify_participation=True)
    amp_j = central_j.replace(amplify_participation=True)
    assert amp_t.accounting_q() == amp_j.accounting_q()
    np.testing.assert_array_equal(tapi.round_rho_charges(central_t),
                                  japi.round_rho_charges(central_j))
    np.testing.assert_allclose(tapi.round_rho_charges(central_t),
                               tapi.round_rho_charges(local_t) / p,
                               rtol=1e-12)
    params0 = jlin.init_linear(DIM)
    js = japi.init_state(central_j, params0)
    ts = _cpu_state(central_t)
    _inject(monkeypatch, central_j, js.key, params0)
    for r in range(3):
        js, jr = japi.run_round(central_j, js, _batch(r), check_budgets=False)
        ts, tr = tapi.run_round(central_t, ts, _batch(r), check_budgets=False)
        assert tr["max_epsilon"] == jr["max_epsilon"]
    np.testing.assert_array_equal(ts.rho, js.rho)
    assert tapi.max_epsilon(central_t, ts) == japi.max_epsilon(central_j, js)
    assert (tapi.rounds_within_budgets(central_t.replace(eps_th=50.0), ts,
                                       100)
            == japi.rounds_within_budgets(central_j.replace(eps_th=50.0), js,
                                          100))


def test_zero_fraction_attack_and_trust_knobs_keep_the_local_ledger():
    plain = _tspec(participation=0.5)
    armed = _tspec(participation=0.5, attack="sign_flip",
                   byzantine_fraction=0.0)
    assert armed.aggregation_pipeline().attack is None
    runs = {}
    for tag, spec in [("plain", plain), ("armed", armed),
                      ("median", _tspec(participation=0.5,
                                        aggregator="median")),
                      ("secure", _tspec(participation=0.5,
                                        secure_agg=True))]:
        st = _cpu_state(spec)
        for r in range(2):
            st, _ = tapi.run_round(spec, st, _batch(r), check_budgets=False)
        runs[tag] = st
    for k in ("w", "b"):
        assert torch.equal(runs["plain"].params[k], runs["armed"].params[k])
        # the same draws: the secure mean differs by quantization alone
        np.testing.assert_allclose(runs["secure"].params[k].numpy(),
                                   runs["plain"].params[k].numpy(),
                                   rtol=0, atol=1e-4)
    for tag in ("armed", "median", "secure"):
        np.testing.assert_array_equal(runs[tag].rho, runs["plain"].rho)


def test_trust_run_rounds_equals_run_round_bitwise():
    """The chunk draws each round's mask, noise and pair masks inside its
    loop exactly as run_round does."""
    spec = _tspec(secure_agg=True, participation=0.5, attack="sign_flip",
                  byzantine_fraction=BYZ)
    a = b = _cpu_state(spec)
    for r in range(3):
        a, _ = tapi.run_round(spec, a, _batch(r), check_budgets=False)
    chunk = {k: np.stack([_batch(r)[k] for r in range(3)])
             for k in ("x", "y")}
    b, _ = tapi.run_rounds(spec, b, chunk, check_budgets=False)
    for k in ("w", "b"):
        assert torch.equal(a.params[k], b.params[k])
    np.testing.assert_array_equal(a.rho, b.rho)


@pytest.mark.parametrize("name,kw", [
    ("median-q75", dict(aggregator="median", participation=0.75)),
    ("secure-topk", dict(secure_agg=True, compressor="topk",
                         compression_ratio=0.5))],
    ids=["median-q75", "secure-topk"])
def test_population_cohort_rounds_match_jax(monkeypatch, name, kw):
    """Cohort rounds over M = 40 virtual clients (per round, then a chunk of
    2) under the trust plane, against JAX with its draws injected."""
    m, k = 40, 4
    tspec = _tpop_spec(population=m, cohort_size=k, **kw)
    jspec = _jpop_spec(population=m, cohort_size=k, **kw)
    tp = tpop.synthetic_population(m, DIM, batch_size=B, seed=1)
    jp = jpop.synthetic_population(m, DIM, batch_size=B, seed=1)
    params0 = jlin.init_linear(DIM)
    js = jpop.init_population_state(jspec, params0)
    ts = _tpop_state(tspec)
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


def test_resident_population_chunks_match_jax_under_median(monkeypatch):
    """The resident driver (cache of K + 4 slots over M = 10) with a robust
    aggregator: the cohort_gather_scatter path and the trust plane
    together."""
    m, k = 10, 4
    kw = dict(aggregator="median", compressor="topk", compression_ratio=0.5)
    tspec = _tpop_spec(population=m, cohort_size=k, **kw)
    jspec = _jpop_spec(population=m, cohort_size=k, **kw)
    tp = tpop.synthetic_population(m, DIM, batch_size=B, seed=2)
    jp = jpop.synthetic_population(m, DIM, batch_size=B, seed=2)
    params0 = jlin.init_linear(DIM)
    js = jpop.init_population_state(jspec, params0)
    ts = _tpop_state(tspec)
    _inject(monkeypatch, jspec, js.fl.key, params0)
    tc = tpop.init_resident_cache(tspec, ts, k + 4, population=tp)
    jc = jpop.init_resident_cache(jspec, js, k + 4, population=jp)
    rt, rj = np.random.default_rng(0), np.random.default_rng(0)
    trecs, jrecs = [], []
    for _ in range(2):
        ts, tr = tpop.run_resident_rounds(tspec, ts, tp, rt, tc, 2)
        js, jr = jpop.run_resident_rounds(jspec, js, jp, rj, jc, 2)
        trecs += tr
        jrecs += jr
    assert tc.stats == jc.stats
    _assert_records(trecs, jrecs)
    np.testing.assert_allclose(ts.fl.residual.numpy(),
                               np.asarray(js.fl.residual), rtol=0, atol=1e-5)


@pytest.mark.parametrize("agg,kw", [
    ("mean", {}), ("median", {}), ("trimmed_mean", dict(trim_fraction=0.25)),
    ("norm_bound", dict(norm_bound_factor=2.0))],
    ids=["mean", "median", "trimmed_mean", "norm_bound"])
def test_attack_matrix_matches_jax_with_its_draws(monkeypatch, agg, kw):
    """benchmarks/attack_resilience_torch.py's run at byzantine fraction
    0.25 (20 rounds) equals the JAX benchmark's when fed JAX's draws: the
    gate's verdict is a property of the random streams, not of the port."""
    jspec = jatt.attack_spec(agg, 0.25, **kw)
    tspec = tatt.attack_spec(agg, 0.25, **kw)
    sampler, eval_batch = jatt.make_task()
    params0 = jlin.init_linear(jatt.DIM)
    js = japi.init_state(jspec, params0)
    _inject(monkeypatch, jspec, js.key, params0)
    js, jout = japi.train(jspec, js, sampler, max_rounds=20)
    ts, tout = tapi.train(tspec, tapi.init_state(
        tspec, tlin.init_linear(tatt.DIM, device="cpu"), device="cpu"),
        sampler, max_rounds=20)
    assert tout["rounds"] == jout["rounds"] == 20
    for k in ("w", "b"):
        np.testing.assert_allclose(ts.params[k].numpy(),
                                   np.asarray(js.params[k]), rtol=0,
                                   atol=1e-5)
    assert tatt.accuracy(tapi.eval_params(tspec, ts), eval_batch) == \
        jatt.accuracy(japi.eval_params(jspec, js), eval_batch)
