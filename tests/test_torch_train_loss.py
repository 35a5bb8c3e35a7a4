"""The port's ``Transformer.loss_fn`` / ``_chunked_loss`` and their
``torch.func`` gradients (the MoE archs' aux loss included) against the
JAX package's ``loss_fn`` and ``jax.value_and_grad``, on the CPU at
``smoke_variant`` size in f32, on JAX's own weights carried across by
``transformer_params_from_jax``. Tolerances are
``tests/test_torch_train.py``'s: MODEL_TOL for the losses, GRAD_TOL for
the gradients (see its docstring for the measured gaps).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (
    GRAD_TOL,
    LOSS_CHUNK,
    MODEL_KERNELS,
    MODEL_TOL,
    B,
    S,
    _close,
    _normal,
    _spy_model_kernels,
)
from torch.func import grad_and_value, vmap

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models.transformer import Transformer as JaxTransformer
from repro_torch.configs import ASSIGNED_ARCHS, get_arch, smoke_variant
from repro_torch.models.transformer import Transformer
from repro_torch.utils.convert import (
    transformer_params_from_jax,
    tree_from_numpy,
)
from repro_torch.utils.tree import tree_flatten, tree_leaf_paths, tree_map


# ---------------------------- loss_fn and its grads --------------------------

@functools.lru_cache(maxsize=None)
def _models(arch, loss_chunk, changes=()):
    jm = JaxTransformer(replace(jax_smoke_variant(jax_get_arch(arch)),
                                loss_chunk=loss_chunk, **dict(changes)))
    jp = jm.init(jax.random.PRNGKey(0))
    model = Transformer(replace(smoke_variant(get_arch(arch)),
                                loss_chunk=loss_chunk, **dict(changes)))
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jp), model,
                                         "cpu")
    return jm, jp, model, params


def _token_batch(cfg, seed, lead=(), seq=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, lead + (B, seq)),
             "labels": rng.integers(0, cfg.vocab, lead + (B, seq))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    if cfg.prefix_len:
        batch["prefix"] = _normal(rng, *lead, B, cfg.prefix_len, cfg.d_model,
                                  scale=0.02)
    return batch


@pytest.mark.parametrize("loss_chunk", [0, LOSS_CHUNK],
                         ids=["unchunked", "chunked"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_loss_and_grads_match_jax(arch, loss_chunk):
    """loss_fn and torch.func.grad_and_value of it on JAX's weights against
    jax.value_and_grad, and the same under vmap over two clients (the DP
    step's form); on the training route no model kernel is called. The
    MoE archs' loss carries AUX_WEIGHT times their aux loss, and their
    router and expert gradients are held too."""
    _check_loss_and_grads(arch, loss_chunk, {}, S)


@pytest.mark.parametrize("arch,changes,seq", [
    ("rwkv6-1.6b", dict(rwkv_chunk=8), 16),          # two WKV chunks
    ("llama4-maverick-400b-a17b", {}, 32),            # two attention chunks
], ids=["rwkv-chunked-wkv", "llama4-two-chunks"])
def test_chunked_mixers_loss_and_grads_match_jax(arch, changes, seq):
    """The chunk-parallel WKV6 (``rwkv_chunk`` 8 over 16 tokens) and
    llama4's chunked layers across a chunk boundary (32 tokens, chunk 16)
    in the loss and its gradients."""
    _check_loss_and_grads(arch, 0, changes, seq)


def _check_loss_and_grads(arch, loss_chunk, changes, seq):
    jm, jp, model, params = _models(arch, loss_chunk, tuple(changes.items()))
    batch = _token_batch(model.cfg, len(arch), seq=seq)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, jax.tree.map(jnp.asarray, batch))
    tb = tree_from_numpy(batch, "cpu")
    calls = _spy_model_kernels()
    try:
        g, loss = grad_and_value(model.loss_fn)(params, tb)
        pair = tree_map(lambda t: torch.stack([t, t]), params)
        vg, vloss = vmap(grad_and_value(model.loss_fn))(
            pair, tree_map(lambda t: torch.stack([t, t]), tb))
    finally:
        calls.restore()
    assert calls.counts == dict.fromkeys(MODEL_KERNELS, 0)
    assert loss.dtype == torch.float32 and loss.shape == ()
    _close(loss, jl, MODEL_TOL, f"{arch} loss")
    _close(vloss[1], jl, MODEL_TOL, f"{arch} vmapped loss")
    paths = tree_leaf_paths(g)
    for path, a, b, c in zip(paths, jax.tree.leaves(jg), tree_flatten(g)[0],
                             tree_flatten(vg)[0]):
        _close(b, a, GRAD_TOL, f"{arch} grad {path}")
        _close(c[0], a, GRAD_TOL, f"{arch} vmapped grad {path}")


def test_unchunked_loss_is_cross_entropy_of_the_serving_logits():
    _, _, model, params = _models("gemma3-4b", 0)
    batch = tree_from_numpy(_token_batch(model.cfg, 1), "cpu")
    logits, _ = model.forward(params, batch["tokens"])
    from repro_torch.models.layers import cross_entropy
    _close(model.loss_fn(params, batch),
           cross_entropy(logits, batch["labels"]).numpy(), MODEL_TOL,
           "loss vs forward")


def test_chunked_loss_refuses_a_chunk_that_does_not_divide_the_seq():
    _, _, model, params = _models("codeqwen1.5-7b", 5)
    batch = tree_from_numpy(_token_batch(model.cfg, 1), "cpu")
    with pytest.raises(ValueError, match="loss_chunk"):
        model.loss_fn(params, batch)
