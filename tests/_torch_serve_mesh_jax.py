"""The JAX side of the serving-mesh tests (tests/test_torch_serve_mesh*.py):
smoke variants of the served archs in f32 from JAX's own weights, JAX's
prefill, teacher-forced decode and greedy tokens, and the gate that holds
a serving-mesh route (tests/_torch_world_cases.py's ``serve_mesh_route``,
run on the ranks of a ``HostWorld``) against JAX and against the port's
whole route.

Tolerance: ``max|got - want| <= TOL * max(1, max|want|)`` per tensor, as
tests/test_torch_models.py holds the whole route against JAX.
"""
import functools
from dataclasses import replace

import _torch_world_cases as cases
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import Segment as JSegment
from repro.launch.serve import generate as jax_generate
from repro.models.transformer import Transformer as JaxTransformer
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import Segment
from repro_torch.launch import serve
from repro_torch.models.transformer import Transformer
from repro_torch.utils.convert import (
    transformer_params_from_jax,
    tree_to_numpy,
)
from repro_torch.utils.tree import tree_flatten, tree_leaf_paths

TOL = 2e-5
LOGIT_TOL = 1e-4       # the smallest top-two gap a compared argmax needs
B, S, GEN = 2, 32, 8


def _gemma(cfg, seg, **kw):
    """gemma3's smoke widths with GQA (4 q / 2 kv heads), cut to one
    sliding-window and one full layer."""
    p = cfg.segments[0].pattern[0]
    return replace(cfg, n_kv_heads=2, n_layers=2, **kw,
                   segments=(seg(1, (p, replace(p, attn_kind="full"))),))


def _granite(cfg, seg, **kw):
    """granite-20b's smoke widths (4 q heads, d_model 256) cut to one
    sliding-window layer (window 16) and one full layer, with its MQA
    (one KV head) or ``kw``'s KV heads and window."""
    p = cfg.segments[0].pattern[0]
    kw = {"window": 16, **kw}
    return replace(cfg, n_layers=2, **kw, segments=(seg(1, (
        replace(p, attn_kind="swa"), p)),))


# name -> (JAX config, port config)
CASES = {
    # MQA on a model axis of 2: the cache's sequence on "model"
    "granite-20b": lambda: (
        _granite(jax_smoke_variant(jax_get_arch("granite-20b")), JSegment),
        _granite(smoke_variant(get_arch("granite-20b")), Segment)),
    # 2 KV heads, 4 q heads on a model axis of 4: a rank's one query head
    # reads KV head index // 2; a window of 6 the four ranks do not divide
    "granite-20b-kv2": lambda: (
        _granite(jax_smoke_variant(jax_get_arch("granite-20b")), JSegment,
                 n_kv_heads=2, window=6),
        _granite(smoke_variant(get_arch("granite-20b")), Segment,
                 n_kv_heads=2, window=6)),
    # gemma3's smoke widths with MQA: under shard_seq on (2, 2) the cache's
    # sequence splits over ("data", "model")
    "gemma3-4b-kv1": lambda: tuple(
        replace(c, n_kv_heads=1) for c in CASES["gemma3-4b"]()),
    "gemma3-4b": lambda: (
        _gemma(jax_smoke_variant(jax_get_arch("gemma3-4b")), JSegment),
        _gemma(smoke_variant(get_arch("gemma3-4b")), Segment)),
    "gemma3-4b-untied": lambda: (
        _gemma(jax_smoke_variant(jax_get_arch("gemma3-4b")), JSegment,
               tie_head=False),
        _gemma(smoke_variant(get_arch("gemma3-4b")), Segment,
               tie_head=False)),
    **{arch: (lambda arch=arch: (jax_smoke_variant(jax_get_arch(arch)),
                                 smoke_variant(get_arch(arch))))
       for arch in ("rwkv6-1.6b", "zamba2-7b", "phi3.5-moe-42b-a6.6b",
                    "llama4-maverick-400b-a17b")},
}


@functools.lru_cache(maxsize=None)
def models(name):
    """(JAX model, JAX params, port model, port params) of ``name``."""
    jcfg, tcfg = CASES[name]()
    jm = JaxTransformer(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = Transformer(tcfg)
    params = transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                         model, "cpu")
    return jm, jp, model, params


def prompts(vocab, batch=B, seed=0, s=S):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, s)).astype(np.int64)


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[:, -2:]
    return float(np.min(top[:, 1] - top[:, 0]))


@functools.lru_cache(maxsize=None)
def jax_reference(name, s=S, batch=B):
    """JAX's greedy tokens (batch, GEN), prefill logits and caches, and
    the logits and caches of GEN decode steps teacher-forced with those
    tokens, as numpy (prompts of ``s`` tokens)."""
    jm, jp, model, _ = models(name)
    pr = prompts(model.cfg.vocab, batch, s=s)
    tokens = np.asarray(jax_generate(jm, jp, jnp.asarray(pr, jnp.int32),
                                     GEN))
    logits, caches, pos = jm.prefill(jp, jnp.asarray(pr, jnp.int32),
                                     max_len=s + GEN)
    out = {"tokens": tokens, "prefill_logits": np.asarray(logits),
           "prefill_caches": jax.tree.map(np.asarray, caches)}
    step = jax.jit(jm.decode_step)
    steps = []
    for i in range(GEN):
        logits, caches = step(jp, caches, jnp.asarray(tokens[:, i]),
                              pos + i)
        steps.append(np.asarray(logits))
    out["decode_logits"] = np.stack(steps, 1)
    out["decode_caches"] = jax.tree.map(np.asarray, caches)
    return out


def close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 0.0)
    assert gap <= TOL * scale, f"{what}: gap {gap} scale {scale}"


def close_caches(got, want, what):
    """Every cache leaf of the port's tree ``got`` against JAX's ``want``
    (or the port's), leaf by leaf."""
    paths = tree_leaf_paths(got)
    want_leaves = jax.tree.leaves(want)
    assert len(paths) == len(want_leaves)
    for path, g, w in zip(paths, tree_flatten(got)[0], want_leaves):
        close(g, w, f"{what} {path}")


def decode_collectives(cfg, mesh_shape=(1, 2), shard_seq=False,
                       max_len=S + GEN, fsdp=False) -> dict:
    """The collectives in one decode step on the serving mesh, from the
    code: on a model axis over 1 the vocabulary-parallel embedding's
    all-reduce and the LM head's gather (an untied head's all-reduce),
    then a layer's all-reduces (attention and the MLP one each; the MoE
    one, plus its shared expert's; RWKV6's time mix three (the five
    projections, the norm, ``w_o``) and its channel mix two; Mamba2 three
    (``w_in``, the norm, ``w_out``) and one gather of ``conv_w``; zamba2's
    shared block gathers its two LoRA factors). An attention layer whose
    cache's sequence splits over g ranks (the decode rules: KV heads the
    model axis does not divide, or ``shard_seq``; a ring the g ranks do
    not divide stays whole) adds two all-reduces (the group's largest
    score, then the sums), and a gather of the query heads where its K/V
    heads are whole on a model axis over 1. Weights over "data" (``fsdp``
    on a data axis over 1) add one gather over the data group a layer
    (its weights, with zamba2's shared block) and one each for the
    embedding and the LM head."""
    dd, dm = mesh_shape
    kv_divides = cfg.n_kv_heads % dm == 0
    g = (dd if kv_divides else dd * dm) if shard_seq else (
        1 if kv_divides else dm)
    n_full = -(-max_len // g) * g
    ar, ga = ((1, 1) if cfg.tie_head else (2, 0)) if dm > 1 else (0, 0)
    for seg in cfg.segments:
        for ls in seg.pattern:
            n = seg.n_steps
            tp = dm > 1
            if ls.mixer in ("attn", "shared_attn"):
                ar += n if tp else 0
                ga += 2 * n if ls.mixer == "shared_attn" and tp else 0
                limit = {"swa": cfg.window, "chunk": cfg.chunk}.get(
                    ls.attn_kind, 0)
                if g > 1 and (not limit or n_full < limit
                              or limit % g == 0):
                    ar += 2 * n
                    ga += n if tp and not kv_divides else 0
            elif ls.mixer == "rwkv6":
                ar += 3 * n if tp else 0
            elif ls.mixer == "mamba2":
                ar += 3 * n if tp else 0
                ga += n if tp else 0
            ar += n * {"mlp": 1, "shared_mlp": 1, "rwkv_cm": 2, "none": 0,
                       "moe": 2 if cfg.shared_expert else 1}[ls.ffn] * (
                dm > 1)
            ga += n if fsdp and dd > 1 else 0
    ga += 2 if fsdp and dd > 1 else 0
    return {"all_reduce": ar, "gather": ga}


def route_matches(world, name, mesh_shape=(1, 2), shard_seq=False, s=S,
                  fsdp=None, batch=B):
    """``name``'s serving route on ``world``'s ranks at ``mesh_shape``
    (``shard_seq``: a long context's rules; ``fsdp``: ``serve_on_mesh``'s
    ``fsdp_over_data``; ``batch`` prompts of ``s`` tokens) against JAX
    and the port's whole route: the prefill's logits and every cache leaf
    (made whole along its split dims), GEN teacher-forced decode steps'
    logits and caches, within TOL; the greedy tokens JAX's (where JAX's
    top-two gap exceeds LOGIT_TOL); the ranks' logits and tokens bit for
    bit alike; the collectives of a decode step as
    :func:`decode_collectives` counts them."""
    _, _, model, params = models(name)
    want = jax_reference(name, s, batch)
    for i in range(GEN):
        assert _top2_gap(want["decode_logits"][:, i - 1] if i else
                         want["prefill_logits"]) > LOGIT_TOL, (name, i)
    pr = prompts(model.cfg.vocab, batch, s=s)
    got = world.run(cases.serve_mesh_route, model.cfg,
                    tree_to_numpy(params), pr, want["tokens"], mesh_shape,
                    shard_seq, fsdp)
    got = [g for g in got if g is not None]
    assert len(got) == mesh_shape[0] * mesh_shape[1]
    r0 = got[0]
    for r in got[1:]:
        for key in ("prefill_logits", "decode_logits", "tokens",
                    "token_logits"):
            assert np.array_equal(r[key], r0[key]), (name, key)
    with torch.inference_mode():
        whole = _whole_route(model, params, pr, want["tokens"])
    for ref, what in ((want, "jax"), (whole, "whole")):
        close(r0["prefill_logits"], ref["prefill_logits"],
              f"{name} prefill logits vs {what}")
        close_caches(r0["prefill_caches"], ref["prefill_caches"],
                     f"{name} prefill cache vs {what}")
        close(r0["decode_logits"], ref["decode_logits"],
              f"{name} decode logits vs {what}")
        close_caches(r0["decode_caches"], ref["decode_caches"],
                     f"{name} decode cache vs {what}")
    np.testing.assert_array_equal(r0["tokens"], want["tokens"])
    # generate's logits before each token: the prefill's, then the steps'
    close(r0["token_logits"], np.concatenate(
        [r0["prefill_logits"][:, None], r0["decode_logits"][:, :-1]], 1),
        f"{name} generate")
    assert r0["collectives_per_step"] == decode_collectives(
        model.cfg, mesh_shape, shard_seq, s + GEN, bool(fsdp))
    return r0


def _whole_route(model, params, pr, forced):
    """The whole route's prefill and teacher-forced decode (numpy)."""
    pr, forced = torch.as_tensor(pr), torch.as_tensor(np.array(forced))
    logits, caches, pos = model.prefill(params, pr,
                                        max_len=pr.shape[1] + GEN)
    out = {"prefill_logits": logits.numpy(),
           "prefill_caches": cases._copied(tree_to_numpy(caches))}
    steps = []
    for i in range(GEN):
        logits, caches = model.decode_step(params, caches, forced[:, i],
                                           pos + i)
        steps.append(logits.numpy())
    out["decode_logits"] = np.stack(steps, 1)
    out["decode_caches"] = cases._copied(tree_to_numpy(caches))
    return out


def generate_whole(name, batch, gen=GEN, seed=0):
    """The port's whole ``generate`` on ``batch`` rows: tokens and
    logits."""
    _, _, model, params = models(name)
    tokens, seen = serve.generate(
        model, params, torch.as_tensor(prompts(model.cfg.vocab, batch,
                                               seed)), gen,
        with_logits=True)
    return tokens.numpy(), seen.numpy()
