"""The JAX side of the model-axis tests of the transformer families
(tests/test_torch_mesh_model_axis_{rwkv,zamba2,moe}.py): JAX's params with
every constant leaf drawn from a seed, the split dims JAX's hints give each
weight, and one DP round of the port's ``mesh_2d`` at ``dm > 1`` held
against JAX's ``vmap`` round.
"""
import _torch_world_cases as cases
import jax
import jax.numpy as jnp
import numpy as np
from test_torch_fl import jax_round_noise
from test_torch_mesh_model_axis import (
    _assert_ranks_agree,
    _jax_weight_hints,
    _model_dim,
)

import repro.api as japi
import repro.models.attention as jattn
import repro.models.layers as jlayers
import repro.models.moe as jmoe
import repro.models.rwkv as jrwkv
import repro.models.ssm as jssm
from repro.models.transformer import Transformer as JaxTransformer
from repro.optim import sgd as jsgd
from repro_torch.models import sharding as tshard
from repro_torch.models.transformer import Transformer
from repro_torch.utils.convert import (
    transformer_params_from_jax,
    tree_to_numpy,
)
from repro_torch.utils.tree import tree_flatten

N_CLIENTS, TAU, BATCH, SEQ = 2, 2, 2, 16
PARAM_TOL = 2e-5       # of each tensor's largest magnitude
GRAD_TOL = 4e-5
NORM_TOL = 1e-6        # relative, the Eq.-7a pre-clip norm

# the JAX module whose shard_hint sites a dict of params meets, by a key
# only that dict has (the MoE's router before the MLP's names, which its
# experts share); a dict with none of them (norms, the embedding, zamba2's
# LoRA) has no use-site hint
_KINDS = (("router", jmoe), ("wq", jattn), ("w_r", jrwkv), ("mu_k", jrwkv),
          ("w_in", jssm), ("w_gate", jlayers))


def jax_params(jcfg, seed: int = 1):
    """JAX's ``Transformer(jcfg).init`` as numpy, with every leaf whose
    elements are all equal (norm scales, token-shift mixes, the decay's
    base, ``bonus_u``, Mamba2's per-head scalars, zamba2's zero LoRA
    factors) moved by N(0, 0.1) draws from ``seed``: a head or a channel
    taken from the wrong rank then shows. Returns (model, params)."""
    jm = JaxTransformer(jcfg)
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if x.size > 1 and x.min() == x.max():
            x = (x + rng.normal(scale=0.1, size=x.shape)).astype(x.dtype)
        return x

    return jm, jax.tree.map(draw, jm.init(jax.random.PRNGKey(seed)))


def jax_split_dims(jm, jp, dm: int):
    """The split dim JAX gives each leaf under ``mesh2d_rules`` on a model
    axis of ``dm`` (a tree like ``jp``): its use-site hint where its
    module has one (a step axis put in front for the stacked layers),
    else its init axes (``param_axes``). Also the use-site hints met."""
    tokens = jnp.zeros((1, SEQ), jnp.int32)
    hints = _jax_weight_hints(jm.loss_fn, jp,
                              {"tokens": tokens, "labels": tokens},
                              modules=tuple({m for _, m in _KINDS}))

    def walk(axes, params, stacked):
        if not isinstance(params, dict):
            raise TypeError(type(params))
        mod = next((m.__name__ for k, m in _KINDS if k in params), None)
        out = {}
        for k, p in params.items():
            if isinstance(p, dict):
                out[k] = walk(axes[k], p, stacked)
                continue
            logical = axes[k]
            if (mod, k) in hints:
                logical = ((None,) if stacked else ()) + hints[mod, k][1]
            out[k] = _model_dim(logical, tuple(p.shape), dm)
        return out

    axes = jm.param_axes()
    dims = {k: walk(axes[k], jp[k], False) for k in jp if k != "segments"}
    dims["segments"] = [walk(ax, p, True) for ax, p in
                        zip(axes["segments"], jp["segments"])]
    return dims, hints


def placement_matches_jax(jcfg, tcfg, dm: int = 2) -> dict:
    """Assert the port's ``param_split_dims`` equals JAX's split of every
    leaf (:func:`jax_split_dims`); returns the port's dims and JAX's
    use-site hints."""
    jm, jp = jax_params(jcfg)
    want, hints = jax_split_dims(jm, jp, dm)
    p0 = transformer_params_from_jax(jp, Transformer(tcfg), "cpu")
    got = tshard.param_split_dims(p0, dm)
    assert got == want
    return got, hints


_JAX_ROUNDS = {}


def _jax_round(name, jcfg, tcfg, jm, jp0):
    """JAX's vmap round (C 2, tau 2) from ``jp0`` on seeded tokens, its
    noise in the port's operand form, and the first step's per-client
    loss gradients; memoized by ``name``."""
    if name in _JAX_ROUNDS:
        return _JAX_ROUNDS[name]
    n = N_CLIENTS
    common = dict(n_clients=n, tau=TAU, clip_norm=1.0, sigmas=(0.5,) * n,
                  batch_sizes=(BATCH,) * n)
    jspec = japi.FederationSpec(loss_fn=jm.loss_fn, optimizer=jsgd(0.05),
                                kernel_backend="ref", **common)
    js = japi.init_state(jspec, jp0)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, tcfg.vocab, size=(n, TAU, BATCH, SEQ + 1))
    batch = {"tokens": tokens[..., :-1].astype(np.int32),
             "labels": tokens[..., 1:].astype(np.int32)}
    noise = jax_round_noise(js.key, jp0, n, TAU).numpy()
    js, jrec = japi.run_round(jspec, js, jax.tree.map(jnp.asarray, batch),
                              check_budgets=False)
    grad = jax.jit(jax.grad(jm.loss_fn))
    jgrads = [jax.tree.map(np.asarray, grad(jp0, {
        k: jnp.asarray(v[c, 0]) for k, v in batch.items()}))
        for c in range(n)]
    _JAX_ROUNDS[name] = (common, batch, noise, float(jrec["loss"]),
                         jax.tree.leaves(jax.tree.map(np.asarray,
                                                      js.params)),
                         jgrads)
    return _JAX_ROUNDS[name]


def round_matches_jax(world, name, jcfg, tcfg, mesh_shape, *,
                      budget_share=None, param_tol=PARAM_TOL):
    """One DP round of ``tcfg`` as mesh_2d ``mesh_shape`` on ``world``'s
    ranks from JAX's seeded params (:func:`jax_params`) on JAX's noise,
    against JAX's vmap round: every rank's params and loss alike; the loss
    and each tensor within PARAM_TOL of its largest magnitude; under the
    model axis the first step's loss gradients within GRAD_TOL, each
    client's Eq.-7a pre-clip norm within NORM_TOL of its whole row's, and
    the gradients of every rank in the mesh (whole leaves their own)
    equal bit for bit. ``param_tol`` replaces PARAM_TOL. With ``budget_share`` the spec is ``engine="auto"``
    with the replica's bytes (its params') as its hint, over a device
    budget of ``budget_share`` of them, and the round resolves its engine
    and mesh shape. Returns rank 0's result (with the resolved engine and
    mesh shape under "engine" and "mesh_shape")."""
    jm, jp0 = jax_params(jcfg)
    common, batch, noise, jloss, want, jgrads = _jax_round(
        name, jcfg, tcfg, jm, jp0)
    model = Transformer(tcfg)
    p0 = tree_to_numpy(transformer_params_from_jax(jp0, model, "cpu"))
    kw = dict(common, engine="mesh_2d", mesh_shape=mesh_shape)
    if budget_share is None:
        got = world.run(cases.transformer_round, tcfg, p0, batch, noise,
                        common["sigmas"], kw)
    else:
        nbytes = sum(x.nbytes for x in tree_flatten(p0)[0])
        kw = dict(common, engine="auto", replica_bytes=nbytes)
        got = world.run(cases.transformer_round_on_budget,
                        int(nbytes * budget_share), tcfg, p0, batch, noise,
                        common["sigmas"], kw)
    _assert_ranks_agree([{"p": g["params"], "l": g["loss"]} for g in got])
    r0 = got[0]
    assert abs(r0["loss"] - jloss) <= param_tol * max(1.0, abs(jloss))
    have = tree_flatten(r0["params"])[0]
    assert len(want) == len(have)
    for w, g in zip(want, have):
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= param_tol * max(1.0,
                                                        np.max(np.abs(w)))
    inside = [g for g in got if "grads" in g]
    shape = mesh_shape if budget_share is None else r0["mesh_shape"]
    assert len(inside) == shape[0] * shape[1]
    _assert_ranks_agree([g["grads"] for g in inside])
    for r in inside:
        for c in range(N_CLIENTS):
            for w, g in zip(jax.tree.leaves(jgrads[c]),
                            tree_flatten(r["grads"])[0]):
                assert np.max(np.abs(g[c] - w)) <= GRAD_TOL * max(
                    1.0, float(np.max(np.abs(w))))
        whole = np.sqrt(np.sum(r["flat_grads"].astype(np.float64) ** 2, 1))
        np.testing.assert_allclose(r["step_norm"], whole, rtol=NORM_TOL,
                                   atol=0)
    return r0


def round_and_vmap_match_jax(world, name, jcfg, tcfg, mesh_shape,
                             tol: float) -> dict:
    """:func:`round_matches_jax` at ``param_tol=tol``, with the port's own
    ``vmap`` round beside it (run in this process): its loss and params
    within ``tol`` of JAX's, and the mesh round's params within ``tol`` of
    it. Returns the mesh round's rank 0 result."""
    r0 = round_matches_jax(world, name, jcfg, tcfg, mesh_shape,
                           param_tol=tol)
    common, batch, noise, jloss, want, _ = _JAX_ROUNDS[name]
    p0 = tree_to_numpy(transformer_params_from_jax(
        jax_params(jcfg)[1], Transformer(tcfg), "cpu"))
    vm = cases.transformer_round(tcfg, p0, batch, noise, common["sigmas"],
                                 dict(common, engine="vmap"))
    assert abs(vm["loss"] - jloss) <= tol * max(1.0, abs(jloss))

    def close(got, ref):
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) <= tol * max(1.0,
                                                      np.max(np.abs(ref)))

    for w, v, m in zip(want, tree_flatten(vm["params"])[0],
                       tree_flatten(r0["params"])[0]):
        close(v, w)
        close(m, v)
    return r0
