"""The port's DP-PASGD round (Eq. 7a / 7b) against the JAX package.

Both packages start from the same params (``init_linear`` is the same numpy
draw) and take the same numpy round batches. The JAX round draws its noise
from its key; the test rebuilds that noise by replaying JAX's key schedule
(api/state.py:258, then core/fl.py:173, fl.py:87 and kernels/ops.py:44-47)
and feeds it to the port's round function as its ``noise`` operand. JAX runs
with ``kernel_backend="ref"``. Tolerances: 1e-6 without DP (the same f32
math), 1e-5 with DP (clip and noise sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
import repro_torch.kernels.ops as tops
from repro.core import clipping as jclip
from repro.data import adult_like, split_iid
from repro.models import linear as jlin
from repro.optim import momentum as jmomentum
from repro.optim import sgd as jsgd
from repro_torch.core import clipping as tclip
from repro_torch.models import linear as tlin
from repro_torch.optim import momentum as tmomentum
from repro_torch.optim import sgd as tsgd
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy

C, TAU, DIM, B = 4, 3, 8, 8
SIGMAS = (0.5, 0.8, 1.1, 0.3)


def _fed():
    return split_iid(adult_like(n=1200, dim=DIM, seed=0), C, seed=0)


@pytest.fixture(scope="module")
def fed():
    return _fed()


def _specs(opt="sgd", **kw):
    base = dict(n_clients=C, tau=TAU, clip_norm=1.0, sigmas=SIGMAS,
                batch_sizes=(B,) * C)
    base.update(kw)
    jopt, topt = ((jsgd(0.2), tsgd(0.2)) if opt == "sgd"
                  else (jmomentum(0.1), tmomentum(0.1)))
    return (japi.FederationSpec(loss_fn=jlin.logreg_loss, optimizer=jopt,
                                kernel_backend="ref", **base),
            tapi.FederationSpec(loss_fn=tlin.logreg_loss, optimizer=topt,
                                **base))


def jax_client_noise(client_keys, params0, tau):
    """The (C, tau, N) normals JAX's local rounds add, one client per key
    of ``client_keys`` (core/fl.py:87, then kernels/ops.py:44-47)."""
    leaves = jax.tree.leaves(params0)                    # per-client leaves
    out = []
    for kc in client_keys:
        steps = []
        for kt in jax.random.split(kc, tau):             # fl.py:87
            lk = jax.random.split(kt, len(leaves))       # ops.py:44
            steps.append(np.concatenate([np.asarray(jax.random.normal(
                k, x.shape, jnp.float32)).reshape(-1)
                for k, x in zip(lk, leaves)]))
        out.append(np.stack(steps))
    return torch.as_tensor(np.stack(out))


def jax_round_noise(key, params0, n_clients, tau):
    """The (C, tau, N) normals a JAX round with FLState key ``key`` adds."""
    _, sub = jax.random.split(key)                       # state.py:258
    return jax_client_noise(jax.random.split(sub, n_clients),  # fl.py:173
                            params0, tau)


def _run_both(jspec, tspec, fed, n_rounds=2):
    """n_rounds rounds in both packages with JAX's noise injected; returns
    both final states (as numpy) and the per-round losses."""
    params0 = jlin.init_linear(DIM)
    js = japi.init_state(jspec, params0)
    ts = tapi.init_state(tspec, tlin.init_linear(DIM, device="cpu"),
                         device="cpu")
    rf = tapi.round_fn_for(tspec)
    sig = torch.as_tensor(np.asarray(SIGMAS, np.float32))
    rng = np.random.default_rng(7)
    losses = []
    for _ in range(n_rounds):
        batch = japi.round_batch(jspec, fed.make_sampler(B), rng)
        noise = jax_round_noise(js.key, params0, C, TAU)
        js, jrec = japi.run_round(jspec, js, batch, check_budgets=False)
        tp, to, tms = rf(ts.params, ts.opt_state,
                         tree_from_numpy(batch, "cpu"), noise, sig)
        ts = ts.replace(params=tp, opt_state=to)
        losses.append((float(jrec["loss"]), float(tms["loss"])))
    return (jax.tree.map(np.asarray, (js.params, js.opt_state)),
            tree_to_numpy((ts.params, ts.opt_state)), losses)


def _max_gap(want, got) -> float:
    return max(float(np.max(np.abs(np.asarray(w, np.float64) - g)))
               for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)))


def _assert_states(want, got, atol):
    wl, gl = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert w.dtype == g.dtype and w.shape == g.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("engine", ["vmap", "map"])
@pytest.mark.parametrize("topology", ["full_average", "local_only"])
@pytest.mark.parametrize("dp,atol", [(False, 1e-6), (True, 1e-5)])
def test_round_matches_jax(fed, engine, topology, dp, atol):
    jspec, tspec = _specs(engine=engine, topology=topology, dp=dp)
    want, got, losses = _run_both(jspec, tspec, fed)
    _assert_states(want, got, atol)
    for jl, tl in losses:
        assert tl == pytest.approx(jl, abs=atol)


@pytest.mark.parametrize("vmap_mb,accumulate", [(True, "stack"),
                                                (False, "stack"),
                                                (False, "scan")])
def test_microbatch_modes_match_jax(fed, vmap_mb, accumulate):
    jspec, tspec = _specs(num_microbatches=2, vmap_microbatches=vmap_mb,
                          grad_accumulate=accumulate)
    want, got, _ = _run_both(jspec, tspec, fed)
    _assert_states(want, got, 1e-5)


def test_momentum_state_averaging_matches_jax(fed):
    jspec, tspec = _specs(opt="momentum", topology="full_average")
    want, got, _ = _run_both(jspec, tspec, fed, n_rounds=3)
    _assert_states(want, got, 1e-5)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_tree_matches_jax(scale):
    """One tree clipped to a global norm, inside and outside the ball; leaf
    dtypes (here an f16 leaf, scaled in f32 and rounded once, within one
    f16 ulp) are kept."""
    rng = np.random.default_rng(5)
    tree = {"w": (rng.normal(size=(6, 2)) * scale).astype(np.float32),
            "b": (rng.normal(size=(3,)) * scale).astype(np.float16)}
    want, wnorm = jclip.clip_tree(jax.tree.map(jnp.asarray, tree), 1.0)
    got, norm = tclip.clip_tree(tree_from_numpy(tree, "cpu"), 1.0)
    got = tree_to_numpy(got)
    for k in tree:
        assert got[k].dtype == np.asarray(want[k]).dtype
        np.testing.assert_allclose(got[k].astype(np.float32),
                                   np.asarray(want[k], np.float32),
                                   rtol=2.0 ** -10 if k == "b" else 0,
                                   atol=1e-6)
    assert float(norm) == pytest.approx(float(wnorm), rel=1e-6)


@pytest.mark.parametrize("average_opt_state", [True, False])
def test_step_counters_stay_int32(fed, average_opt_state):
    _, tspec = _specs(average_opt_state=average_opt_state)
    state = tapi.init_state(tspec, tlin.init_linear(DIM, device="cpu"),
                            device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        state, _ = tapi.run_round(
            tspec, state, tapi.round_batch(tspec, fed.make_sampler(B), rng),
            check_budgets=False)
    step = state.opt_state.step
    assert step.dtype == torch.int32 and step.shape == (C,)
    assert step.tolist() == [2 * TAU] * C


@pytest.mark.parametrize("engine,rows,calls", [("vmap", C, TAU),
                                               ("map", 1, C * TAU)])
def test_one_kernel_call_per_step_for_all_clients(fed, monkeypatch, engine,
                                                  rows, calls):
    """The vmap engine clips all C clients in one (C, N) call per local
    step; the map engine makes one single-row call per client and step."""
    seen = []
    real = tops.dp_clip_noise

    def spy(g, noise, clip_norm, sigma):
        seen.append(tuple(g.shape))
        return real(g, noise, clip_norm, sigma)

    monkeypatch.setattr(tops, "dp_clip_noise", spy)
    _, tspec = _specs(engine=engine)
    state = tapi.init_state(tspec, tlin.init_linear(DIM, device="cpu"),
                            device="cpu")
    batch = tapi.round_batch(tspec, fed.make_sampler(B),
                             np.random.default_rng(0))
    tapi.run_round(tspec, state, batch, check_budgets=False)
    assert seen == [(rows, 2 * DIM + 2)] * calls


if __name__ == "__main__":
    # the max |torch - jax| each round gate sees (the tests above assert the
    # tolerances): PYTHONPATH=src python tests/test_torch_fl.py
    data = _fed()
    for engine in ("vmap", "map"):
        for topology in ("full_average", "local_only"):
            for dp in (False, True):
                w, g, _ = _run_both(*_specs(engine=engine, topology=topology,
                                            dp=dp), data)
                print(f"round {engine} {topology} dp={dp}: max|dparams| = "
                      f"{_max_gap(w, g):.3e}")
    for vmap_mb, acc in ((True, "stack"), (False, "stack"), (False, "scan")):
        w, g, _ = _run_both(*_specs(num_microbatches=2,
                                    vmap_microbatches=vmap_mb,
                                    grad_accumulate=acc), data)
        print(f"microbatches vmap={vmap_mb} {acc}: max|dparams| = "
              f"{_max_gap(w, g):.3e}")
