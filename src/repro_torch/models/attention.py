"""Attention: GQA / MQA / MHA with full-causal and sliding-window variants;
the prefill runs through the hand-written ``flash_attention`` kernel, the
one-token decode through a plain cached path (a port of the JAX package's
``repro/models/attention.py``).

The JAX package's model computes prefill attention with its own jnp path
(``blocked_causal_attention``); the port routes it through
``kernels.ops.flash_attention`` and is held against the JAX model's
outputs. Not ported yet: chunked (llama4) attention, the jnp blocked and
bucketed paths, and the paged serving cache (``init_paged_kv_cache``,
``paged_decode_attention``).

Shapes: x (B, S, d); q (B, S, H, hd); k / v (B, S, KV, hd).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, apply_rope, rope_angles

NEG_INF = -1e30


def init_attention(generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, qkv_bias: bool = False,
                   dtype=torch.float32, device="cpu"):
    params = {
        "wq": _dense_init(generator, (d_model, n_heads, head_dim), 0, dtype,
                          device),
        "wk": _dense_init(generator, (d_model, n_kv_heads, head_dim), 0,
                          dtype, device),
        "wv": _dense_init(generator, (d_model, n_kv_heads, head_dim), 0,
                          dtype, device),
        "wo": _dense_init(generator, (n_heads, head_dim, d_model), 2, dtype,
                          device),
    }
    if qkv_bias:
        params["bq"] = torch.zeros((n_heads, head_dim), dtype=dtype,
                                   device=device)
        params["bk"] = torch.zeros((n_kv_heads, head_dim), dtype=dtype,
                                   device=device)
        params["bv"] = torch.zeros((n_kv_heads, head_dim), dtype=dtype,
                                   device=device)
    return params


def _project_qkv(params, x, positions, use_rope: bool, rope_theta: float):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if use_rope:
        cos, sin = rope_angles(positions, q.shape[-1], rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _sdpa(q, k, v, mask):
    """Grouped scaled-dot-product attention. q (B, Sq, H, hd); k / v
    (B, Skv, KV, hd); mask broadcastable to (B, KV, G, Sq, Skv). Softmax in
    fp32."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


def _expand_heads(t, n_heads: int):
    """(B, S, KV, hd) -> contiguous (B, H, S, hd): q head h reads KV head
    h // (H / KV), the grouping of :func:`_sdpa`."""
    t = t.transpose(1, 2)
    g = n_heads // t.shape[1]
    if g > 1:
        t = t.repeat_interleave(g, dim=1)
    return t.contiguous()


def attention_forward(params, x, positions, *, kind: str = "full",
                      window: int = 0, chunk: int = 0, use_rope: bool = True,
                      rope_theta: float = 1e4, backend: str = "auto"):
    """Full-sequence attention (prefill). Returns (B, S, d)."""
    out, _ = attention_forward_kv(params, x, positions, kind=kind,
                                  window=window, chunk=chunk,
                                  use_rope=use_rope, rope_theta=rope_theta,
                                  backend=backend)
    return out


def attention_forward_kv(params, x, positions, *, kind: str = "full",
                         window: int = 0, chunk: int = 0,
                         use_rope: bool = True, rope_theta: float = 1e4,
                         backend: str = "auto"):
    """Like :func:`attention_forward` but also returns the (k, v) pair for
    the prefill cache. ``full`` and ``swa`` run ``ops.flash_attention`` on
    (B, H, S, hd) with GQA expanded."""
    if kind == "chunk":
        raise NotImplementedError(
            "chunked (llama4) attention is not ported yet")
    if kind not in ("full", "swa"):
        raise ValueError(f"unknown attention kind {kind}")
    q, k, v = _project_qkv(params, x, positions, use_rope, rope_theta)
    h = q.shape[2]
    ctxv = ops.flash_attention(
        q.transpose(1, 2).contiguous(), _expand_heads(k, h),
        _expand_heads(v, h), window=window if kind == "swa" else 0,
        backend=backend).transpose(1, 2)
    out = torch.einsum("bshk,hkd->bsd", ctxv, params["wo"])
    return out, (k, v)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def cache_len(kind: str, max_len: int, window: int, chunk: int) -> int:
    if kind == "swa":
        return min(window, max_len)
    if kind == "chunk":
        return min(chunk, max_len)
    return max_len


def init_kv_cache(batch: int, kind: str, max_len: int, n_kv_heads: int,
                  head_dim: int, window: int = 0, chunk: int = 0,
                  dtype=torch.bfloat16, device="cpu"):
    n = cache_len(kind, max_len, window, chunk)
    shape = (batch, n, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def fill_kv_cache(cache, k, v, kind: str, window: int = 0, chunk: int = 0):
    """Write a full prefill sequence into the cache, in place (possibly
    ring-truncated), and return it.

    k / v (B, S, KV, hd). For swa caches only the tail that remains visible
    is stored, laid out in ring order (slot = pos % cache_len)."""
    n = cache["k"].shape[1]
    s = k.shape[1]
    if s <= n:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        return cache
    # ring layout: position p lives at slot p % n
    slots = torch.arange(s - n, s, device=k.device) % n
    order = torch.argsort(slots)
    cache["k"].copy_(k[:, s - n:][:, order])
    cache["v"].copy_(v[:, s - n:][:, order])
    return cache


def decode_attention(params, x, cache, pos: int, *, kind: str = "full",
                     window: int = 0, chunk: int = 0, use_rope: bool = True,
                     rope_theta: float = 1e4):
    """One-token decode. x (B, 1, d); ``pos`` (int) the index of this token.
    Writes this token's k / v into the cache in place (the JAX package
    returns a new cache) and returns ``(out (B, 1, d), cache)``."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, positions, use_rope, rope_theta)
    n = cache["k"].shape[1]
    slot = pos % n
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v
    # entry at slot i currently holds position: the largest p <= pos with
    # p % n == i  ->  p = pos - ((pos - i) % n)
    slots = torch.arange(n, device=x.device)
    entry_pos = pos - torch.remainder(pos - slots, n)
    valid = entry_pos >= 0
    if kind == "swa":
        valid &= entry_pos > pos - window
    elif kind == "chunk":
        valid &= entry_pos >= (pos // chunk) * chunk
    ctxv = _sdpa(q, cache["k"], cache["v"], valid[None, None, None, None, :])
    out = torch.einsum("bshk,hkd->bsd", ctxv, params["wo"])
    return out, cache
