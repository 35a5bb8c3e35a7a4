"""The transformer on the model axis of the port's ``mesh_2d`` engine
(``dm > 1``), against the JAX package, in one gloo world of 4 ranks
started once for the module (the linear models' gates are in
tests/test_torch_mesh_model_axis.py).

* Placement: every weight of a gemma3 smoke variant splits where JAX's
  ``resolve_spec`` puts it at its ``shard_hint`` site under
  ``mesh2d_rules``; the embedding follows its init axes; norms stay whole.
* The round: gemma3's smoke widths (2 layers, 4 q / 2 kv heads, a sliding
  window and a full layer) as ``mesh_2d`` (1, 2) and (2, 2) against JAX's
  ``vmap`` round within 2e-5 of each tensor's largest magnitude, the loss
  gradients within 4e-5, and the Eq.-7a pre-clip norm equal to the whole
  row's within 1e-6.
"""
from dataclasses import replace

import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_fl import jax_round_noise
from test_torch_mesh_model_axis import _assert_ranks_agree, _jax_weight_hints
from test_torch_mesh_model_axis import _model_dim

import repro.api as japi
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import Segment as JSegment
from repro.models.transformer import Transformer as JaxTransformer
from repro.optim import sgd as jsgd
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import Segment
from repro_torch.launch.mesh import HostWorld
from repro_torch.models import sharding as tshard
from repro_torch.models.transformer import Transformer
from repro_torch.utils.convert import (
    transformer_params_from_jax,
    tree_to_numpy,
)
from repro_torch.utils.tree import tree_flatten


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


def _gemma_cfgs(n_kv_heads=2):
    """gemma3's smoke widths with GQA (4 q / 2 kv heads), cut to one swa
    and one full layer: both attention masks in two layers."""
    def cut(cfg, seg):
        pattern = cfg.segments[0].pattern
        return replace(cfg, n_kv_heads=n_kv_heads, n_layers=2,
                       segments=(seg(1, (pattern[0], replace(
                           pattern[0], attn_kind="full"))),))
    return (cut(jax_smoke_variant(jax_get_arch("gemma3-4b")), JSegment),
            cut(smoke_variant(get_arch("gemma3-4b")), Segment))


def test_gemma3_placement_matches_jax_hints():
    """Every weight JAX hints at its use site splits where JAX's rules put
    it; the embedding follows its init axes ("tp", "fsdp"); the norm
    scales stay whole."""
    jcfg, tcfg = _gemma_cfgs()
    jm, model = JaxTransformer(jcfg), Transformer(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tokens = jnp.zeros((1, 8), jnp.int32)
    hints = _jax_weight_hints(jm.loss_fn, jp, {"tokens": tokens,
                                               "labels": tokens})
    assert set(hints) == {"wq", "wk", "wv", "wo", "w_gate", "w_up",
                          "w_down"}
    p0 = transformer_params_from_jax(jax.tree.map(np.asarray, jp), model,
                                     "cpu")
    dims = tshard.param_split_dims(p0, 2)
    for layer in dims["segments"][0].values():
        for part in ("mixer", "ffn"):
            for name, d in layer[part].items():
                shape, logical = hints[name]
                assert d - 1 == _model_dim(logical, shape), name
        assert set(layer["norm1"].values()) == {-1}
    emb_axes = jm._embed_axes["embedding"]
    assert dims["embed"]["embedding"] == _model_dim(
        emb_axes, tuple(jp["embed"]["embedding"].shape)) == 0
    assert dims["final_norm"] == {"scale": -1}
    assert [dims["segments"][0][j]["mixer"]["wq"] for j in "01"] == [2, 2]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_gemma3_round_matches_jax(world, mesh_shape):
    """gemma3's smoke widths (2 layers, 4 q / 2 kv heads, vocab 512) as
    mesh_2d ``mesh_shape`` (a (1, 2) mesh leaves two ranks outside): one
    DP round (C 2, tau 2) from JAX's weights on JAX's noise within 2e-5 of
    each tensor's largest magnitude of JAX's vmap round; the first step's
    loss gradients within 4e-5 of JAX's; the Eq.-7a pre-clip norm of each
    client equal to its whole row's within 1e-6."""
    n, tau, b, s = 2, 2, 2, 16
    jcfg, tcfg = _gemma_cfgs()
    jm, model = JaxTransformer(jcfg), Transformer(tcfg)
    jp0 = jm.init(jax.random.PRNGKey(1))
    common = dict(n_clients=n, tau=tau, clip_norm=1.0, sigmas=(0.5,) * n,
                  batch_sizes=(b,) * n)
    jspec = japi.FederationSpec(loss_fn=jm.loss_fn, optimizer=jsgd(0.05),
                                kernel_backend="ref", **common)
    js = japi.init_state(jspec, jp0)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, tcfg.vocab, size=(n, tau, b, s + 1))
    batch = {"tokens": tokens[..., :-1].astype(np.int32),
             "labels": tokens[..., 1:].astype(np.int32)}
    noise = jax_round_noise(js.key, jp0, n, tau).numpy()
    js, jrec = japi.run_round(jspec, js, jax.tree.map(jnp.asarray, batch),
                              check_budgets=False)
    p0 = tree_to_numpy(transformer_params_from_jax(
        jax.tree.map(np.asarray, jp0), model, "cpu"))
    got = world.run(cases.transformer_round, tcfg, p0, batch, noise,
                    common["sigmas"], dict(common, engine="mesh_2d",
                                           mesh_shape=mesh_shape))
    _assert_ranks_agree([{"p": g["params"], "l": g["loss"]} for g in got])
    r0 = got[0]
    assert abs(r0["loss"] - float(jrec["loss"])) <= 2e-5 * max(
        1.0, abs(float(jrec["loss"])))
    want = jax.tree.leaves(jax.tree.map(np.asarray, js.params))
    have = tree_flatten(r0["params"])[0]
    assert len(want) == len(have)
    for w, g in zip(want, have):
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= 2e-5 * max(1.0, np.max(np.abs(w)))
    # the first step's per-client loss gradients, against jax.grad
    step0 = {k: v[:, 0] for k, v in batch.items()}
    jgrads = [jax.grad(jm.loss_fn)(jp0, {k: jnp.asarray(v[c])
                                         for k, v in step0.items()})
              for c in range(n)]
    for c in range(n):
        for w, g in zip(jax.tree.leaves(jgrads[c]),
                        tree_flatten(r0["grads"])[0]):
            g = g[c]
            assert np.max(np.abs(g - np.asarray(w))) <= 4e-5 * max(
                1.0, float(np.max(np.abs(np.asarray(w)))))
    whole = np.sqrt(np.sum(r0["flat_grads"].astype(np.float64) ** 2, 1))
    np.testing.assert_allclose(r0["step_norm"], whole, rtol=1e-6, atol=0)
