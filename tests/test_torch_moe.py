"""The port's MoE FFN (``repro_torch.models.moe``) and chunk-parallel WKV6
(``repro_torch.models.rwkv.wkv6_chunked``) against the JAX package's, on
the CPU in f32, on the same numpy inputs made from a seed.

Tolerance, per tensor, ``max|port - jax| <= TOL * max(1, max|jax|)``:
MODEL_TOL = 2e-5 (the model stack's, tests/test_torch_models.py) for
values, GRAD_TOL = 4e-5 for gradients. Router ids and capacities are held
exactly, as are the ranks that decide which tokens a capacity drops.
"""
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

import jax
import jax.numpy as jnp
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv

from repro_torch.models import moe, rwkv
from repro_torch.utils.tree import tree_flatten, tree_leaf_paths, tree_map

MODEL_TOL = 2e-5
GRAD_TOL = 4e-5
D, F, E = 16, 32, 4
# (top_k, shared expert, capacity factor): llama4's top-1 + shared and
# phi3.5's top-2, each with a capacity that drops tokens (1.0) and one
# that does not (4.0, smoke_variant's)
CASES = [(1, True, 1.0), (1, True, 4.0), (2, False, 1.0), (2, False, 4.0)]
SHAPES = [(2, 64, D), (8, 1, D)]      # prefill rows (S > 8), decode (S 1)


def _close(got, want, tol, what):
    got = (got.detach().to(torch.float32).numpy()
           if isinstance(got, torch.Tensor) else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 0.0)
    assert gap <= tol * scale, f"{what}: gap {gap} scale {scale}"


def _params(seed, shared):
    """numpy MoE params in JAX's tree (router f32 (d, E); experts (E, d, f)
    and (E, f, d); the shared SwiGLU MLP)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    p = {"router": normal(D, E, fan_in=D),
         "w_gate": normal(E, D, F, fan_in=D),
         "w_up": normal(E, D, F, fan_in=D),
         "w_down": normal(E, F, D, fan_in=F)}
    if shared:
        p["shared"] = {"w_gate": normal(D, F, fan_in=D),
                       "w_up": normal(D, F, fan_in=D),
                       "w_down": normal(F, D, fan_in=F)}
    return p


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(tree):
    return tree_map(torch.as_tensor, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("shape", SHAPES, ids=["prefill", "decode"])
@pytest.mark.parametrize("top_k,shared,factor", CASES)
def test_route_matches_jax(top_k, shared, factor, shape):
    """``_route`` per dispatch group: renormalised top-k weights, the ids
    exactly, and the aux loss (load balance + 1e-3 z-loss)."""
    p = _params(1, shared)
    x = _x(2, shape)
    groups = moe._regroup(torch.as_tensor(x))
    jgroups = jmoe._regroup(jnp.asarray(x))
    assert tuple(groups.shape) == jgroups.shape
    w, ids, aux = moe._route(_t(p), groups, top_k)
    jw, jids, jaux = jax.vmap(lambda xr: jmoe._route(_j(p), xr, top_k))(
        jgroups)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw, MODEL_TOL, "weights")
    _close(aux, jaux, MODEL_TOL, "aux")
    assert w.dtype == aux.dtype == torch.float32


@pytest.mark.parametrize("tokens,experts,k,factor", [
    (64, 4, 1, 1.0), (64, 4, 2, 1.25), (1, 128, 1, 1.25), (8, 16, 2, 4.0),
    (2048, 16, 2, 1.25), (16384, 128, 1, 1.25), (3, 5, 3, 0.5)])
def test_capacity_matches_jax(tokens, experts, k, factor):
    assert moe.capacity(tokens, experts, k, factor) == jmoe.capacity(
        tokens, experts, k, factor)


@pytest.mark.parametrize("shape", [(3, 9, 4), (3, 8, 4), (5, 1, 4)])
def test_regroup_matches_jax(shape):
    x = _x(0, shape)
    got = moe._regroup(torch.as_tensor(x))
    want = jmoe._regroup(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["scatter", "dense"])
@pytest.mark.parametrize("shape", SHAPES, ids=["prefill", "decode"])
@pytest.mark.parametrize("top_k,shared,factor", CASES)
def test_moe_matches_jax(top_k, shared, factor, shape, impl):
    """``moe_scatter`` / ``moe_dense`` (through ``moe_apply``) against the
    JAX package's on the same params and input: outputs and aux. At factor
    1.0 the prefill rows overflow their experts, so the ranks in token
    order decide which assignments are dropped."""
    p = _params(3, shared)
    x = _x(4, shape)
    y, aux = moe.moe_apply(_t(p), torch.as_tensor(x), top_k=top_k,
                           capacity_factor=factor, impl=impl)
    jy, jaux = jmoe.moe_apply(_j(p), jnp.asarray(x), top_k=top_k,
                              capacity_factor=factor, impl=impl)
    _close(y, jy, MODEL_TOL, f"{impl} y")
    _close(aux, jaux, MODEL_TOL, f"{impl} aux")
    groups = moe._regroup(torch.as_tensor(x))
    _, ids, _ = moe._route(_t(p), groups, top_k)
    cap = moe.capacity(groups.shape[1], E, top_k, factor)
    _, keep = moe._ranks(ids.reshape(groups.shape[0], -1), E, cap)
    drops = int((~keep).sum())
    assert (drops > 0) == (factor == 1.0 and shape[1] > 8), drops


@pytest.mark.parametrize("shape", SHAPES, ids=["train", "decode"])
@pytest.mark.parametrize("top_k,shared,factor", CASES)
def test_moe_scatter_equals_dense_train_and_decode(top_k, shared, factor,
                                                   shape):
    """The port of ``tests/test_perf_opts.py::
    test_moe_scatter_equals_dense_train_and_decode``, at every case."""
    p = _t(_params(0, shared))
    x = torch.as_tensor(_x(1, shape))
    y1, a1 = moe.moe_scatter(p, x, top_k=top_k, capacity_factor=factor)
    y2, a2 = moe.moe_dense(p, x, top_k=top_k, capacity_factor=factor)
    _close(y1, y2.numpy(), MODEL_TOL, "scatter vs dense")
    _close(a1, a2.numpy(), MODEL_TOL, "aux")


def test_moe_decode_grouping_no_waste():
    """The port of ``tests/test_perf_opts.py::
    test_moe_decode_grouping_no_waste``: decode (S 1) groups the whole
    batch, so capacity is ~ B * K / E, not 8 per row."""
    g = moe._regroup(torch.zeros((128, 1, 16)))
    assert g.shape == (1, 128, 16)
    assert moe.capacity(128, 16, 2, 1.25) < 128


@pytest.mark.parametrize("top_k,shared,factor", CASES)
def test_moe_grads_match_jax(top_k, shared, factor):
    """Gradients of sum(y^2) + aux through ``moe_scatter`` (the training
    route's dispatch) with respect to the params and the input."""
    p = _params(5, shared)
    x = _x(6, (2, 64, D))

    def loss(params, x):
        y, aux = moe.moe_scatter(params, x, top_k=top_k,
                                 capacity_factor=factor)
        return torch.sum(y ** 2) + aux

    def jloss(params, x):
        y, aux = jmoe.moe_scatter(params, x, top_k=top_k,
                                  capacity_factor=factor)
        return jnp.sum(y ** 2) + aux

    (g, gx), val = grad_and_value(loss, argnums=(0, 1))(_t(p),
                                                        torch.as_tensor(x))
    jval, (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        _j(p), jnp.asarray(x))
    _close(val, jval, MODEL_TOL, "loss")
    _close(gx, jgx, GRAD_TOL, "grad x")
    assert tree_leaf_paths(g) == tree_leaf_paths(jax.tree.map(np.asarray,
                                                              jg))
    for path, a, b in zip(tree_leaf_paths(g), tree_flatten(g)[0],
                          jax.tree.leaves(jg)):
        _close(a, b, GRAD_TOL, f"grad {path}")


@pytest.mark.parametrize("top_k,shared,factor", CASES)
def test_vmapped_grad_over_clients_equals_a_loop(top_k, shared, factor):
    """``torch.func.vmap(grad_and_value(...))`` over a client axis, the DP
    step's form, equals the same call client by client."""
    cp = [_t(_params(10 + c, shared)) for c in range(3)]
    xs = torch.as_tensor(_x(7, (3, 2, 64, D)))

    def loss(params, x):
        y, aux = moe.moe_scatter(params, x, top_k=top_k,
                                 capacity_factor=factor)
        return torch.mean(y ** 2) + 0.01 * aux

    stacked = tree_map(lambda *t: torch.stack(t), *cp)
    vg, vl = vmap(grad_and_value(loss))(stacked, xs)
    for c in range(3):
        g, val = grad_and_value(loss)(cp[c], xs[c])
        _close(vl[c], val.numpy(), MODEL_TOL, f"client {c} loss")
        for path, a, b in zip(tree_leaf_paths(g), tree_flatten(vg)[0],
                              tree_flatten(g)[0]):
            _close(a[c], b.numpy(), GRAD_TOL, f"client {c} grad {path}")


def test_init_moe_tree_and_distribution():
    """JAX's tree (router f32, experts in the model dtype, the shared MLP),
    N(0, 1 / fan_in) with fan-in on axis 1, drawn one expert at a time; on
    the meta device shapes only."""
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 64, 96, 8, 2, shared_expert=True,
                     dtype=torch.bfloat16)
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(0), 64, 96, 8, 2,
                          shared_expert=True, dtype=jnp.bfloat16)
    assert tree_leaf_paths(p) == tree_leaf_paths(jax.tree.map(np.asarray,
                                                              jp))
    for a, b in zip(tree_flatten(p)[0], jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[1] == str(b.dtype)
    assert p["router"].dtype == torch.float32
    for name, fan_in in (("w_gate", 64), ("w_up", 64), ("w_down", 96)):
        w = p[name].float()
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.03, name
        # each expert its own draw
        assert not torch.equal(w[0], w[1])
    meta = moe.init_moe(None, 64, 96, 8, 2, device="meta")
    assert meta["w_down"].shape == (8, 96, 64)
    assert meta["w_down"].device.type == "meta"


def test_iterative_top_k_is_not_ported():
    p = _t(_params(0, False))
    with pytest.raises(ValueError, match="iterative_topk"):
        moe.moe_apply(p, torch.zeros((1, 4, D)), top_k=1,
                      iterative_topk=True)


# ------------------------------ chunked WKV6 ---------------------------------

def _wkv_inputs(seed, b=1, s=32, h=2, hd=16):
    """r / k / v and log decays as ``tests/test_perf_opts.py``'s WKV test
    draws them (log w = -exp(N - 2)), from numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, hd)) - 2).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("chunk,s0", [(8, False), (8, True), (32, False),
                                      (64, False)])
def test_wkv6_chunked_matches_jax(chunk, s0):
    """y and the final state against JAX's ``wkv6_chunked`` (chunk 64
    clamps to the sequence), from zeros and from a state."""
    r, k, v, logw, u = _wkv_inputs(0)
    st = (np.random.default_rng(1).standard_normal((1, 2, 16, 16))
          .astype(np.float32) if s0 else None)
    y, sf = rwkv.wkv6_chunked(*map(torch.as_tensor, (r, k, v, logw, u)),
                              s0=None if st is None else torch.as_tensor(st),
                              chunk=chunk)
    jy, jsf = jrwkv.wkv6_chunked(*map(jnp.asarray, (r, k, v, logw, u)),
                                 s0=None if st is None else jnp.asarray(st),
                                 chunk=chunk)
    _close(y, jy, MODEL_TOL, "y")
    _close(sf, jsf, MODEL_TOL, "state")


def test_wkv6_chunked_equals_scan_gradients():
    """The port of ``tests/test_perf_opts.py::
    test_wkv6_chunked_equals_scan_gradients``: the chunked form against the
    per-token scan, forward and the gradient in r, and that gradient
    against JAX's chunked form's."""
    r, k, v, logw, u = _wkv_inputs(2)
    k_t, v_t, lw_t, u_t = map(torch.as_tensor, (k, v, logw, u))

    def f_scan(r):
        y, _ = rwkv.wkv6_scan(r, k_t, v_t, torch.exp(lw_t), u_t)
        return torch.sum(y ** 2)

    def f_chunk(r):
        y, _ = rwkv.wkv6_chunked(r, k_t, v_t, lw_t, u_t, chunk=8)
        return torch.sum(y ** 2)

    g1, v1 = grad_and_value(f_scan)(torch.as_tensor(r))
    g2, v2 = grad_and_value(f_chunk)(torch.as_tensor(r))
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-4)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-3, atol=1e-4)
    jg = jax.grad(lambda r: jnp.sum(jrwkv.wkv6_chunked(
        r, *map(jnp.asarray, (k, v, logw, u)), chunk=8)[0] ** 2))(
        jnp.asarray(r))
    _close(g2, jg, GRAD_TOL, "chunked grad vs jax")


def test_wkv6_chunked_refuses_a_chunk_that_does_not_divide_the_seq():
    r, k, v, logw, u = map(torch.as_tensor, _wkv_inputs(0, s=12))
    with pytest.raises(ValueError, match="rwkv chunk"):
        rwkv.wkv6_chunked(r, k, v, logw, u, chunk=8)
