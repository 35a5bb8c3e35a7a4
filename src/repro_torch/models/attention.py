"""Attention: GQA / MQA / MHA with full-causal, sliding-window and chunked
(llama4's iRoPE) variants (a port of the JAX package's
``repro/models/attention.py``).

Two routes, chosen by the caller and never by the device:

- serving (``attention_forward``, ``attention_forward_kv``): the prefill
  runs through the hand-written ``flash_attention`` kernel (a chunked layer
  as one causal call over (B * n_chunks, H, chunk, hd)), the one-token
  decode through a plain cached path;
- training (``attention_forward_train``): the JAX model's own
  differentiable paths, ``blocked_causal_attention`` (and
  ``_bucketed_causal_attention``) and ``chunked_causal_attention``, in
  torch ops that run under ``torch.func.vmap(grad_and_value(...))``. The
  JAX package trains through the same jnp paths; the kernel has no
  backward and refuses tensors that require grad.

The serving engine's paged cache (``init_paged_kv_cache``, ``paged_index``,
``paged_decode_attention``) is plain PyTorch, as the JAX package keeps it
in jnp: no TPU kernel carries it.

Under a model axis over 1 (:func:`repro_torch.models.sharding.model_group`)
both routes split the heads: each rank holds its heads' slices of ``wq`` /
``wk`` / ``wv`` (and the qkv biases) and of ``wo``, takes the replicated
input through an identity-forward / all-reduce-backward function, attends
over its own q and kv heads (with GQA the group size is the whole
model's, so q head h still reads kv head h // (H / KV)), and sums the
ranks' output projections in one all-reduce. The sliding window and the
chunks keep their masks. On the serving mesh the prefill's one
``flash_attention`` call runs on the rank's (B, H / dm, S, hd), and the
decode paths (``decode_attention``, ``paged_decode_attention``) read and
write caches of the rank's KV heads (``init_kv_cache`` /
``init_paged_kv_cache`` sized with that count).

KV heads the model axis does not divide (MQA) stay whole
(:func:`repro_torch.models.sharding.kv_heads_whole`): each rank computes
every KV head from the whole ``wk`` / ``wv`` and attends with its own
query heads, which read the KV heads of their *global* index
(:func:`_rank_kv_heads`: the rank's heads start at ``index * H / dm``).
In training the whole K/V leaves enter through ``copy_in``, so their
gradient is summed over the model group. Such a decode cache splits its
sequence over a group of ranks instead (``cache_seq``; also the data
axis for a long context): each rank holds a contiguous block of the
cache's slots (:func:`seq_block`), the owner of a new token's slot writes
it, and every rank attends over its own slots and combines the partial
softmaxes with the others' (:func:`_sdpa_over_group`). A cache split on
both its sequence (over "data", a long context's ``shard_seq``) and its
KV heads (over "model") holds the rank's heads of its block of slots: the
block's offset is the data rank's, and the combine runs over the data
group alone, each rank's query heads already reading its KV heads.

Shapes: x (B, S, d); q (B, S, H, hd); k / v (B, S, KV, hd).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, apply_rope, rope_angles
from repro_torch.models.sharding import (
    ATTN_AXES,
    KV_LEAVES,
    hinted_group,
    kv_heads_whole,
)

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


def _project_qkv(params, x, positions, use_rope: bool, rope_theta: float,
                 angles=None):
    """q / k / v of x, rotated at ``positions`` (or by ``angles``, their
    precomputed ``rope_angles``)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if use_rope:
        cos, sin = angles or rope_angles(positions, q.shape[-1], rope_theta)
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


def blocked_causal_attention(q, k, v, *, window: int = 0,
                             block_q: int = 512, q_start: int = 0,
                             causal_buckets: bool = False):
    """Causal (optionally sliding-window) attention, tiled over q blocks.

    window == 0 -> full causal. window == W -> attend to the last W positions
    (inclusive of self). q_start offsets q positions relative to k positions
    (used when a prefix occupies the head of the kv sequence).

    causal_buckets: group q blocks into power-of-two buckets so bucket b only
    reads kv[0 : 2^(b+1) * block_q] (:func:`_bucketed_causal_attention`).

    The JAX package checkpoints each block's body; the port keeps the
    blocks' activations for the backward pass (torch's checkpointing does
    not run under ``torch.func.grad``)."""
    if causal_buckets and not window and q_start == 0:
        return _bucketed_causal_attention(q, k, v, block_q=block_q)
    sq, skv = q.shape[1], k.shape[1]
    bq = min(block_q, sq)
    n_blocks = -(-sq // bq)
    pad = n_blocks * bq - sq
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    kv_positions = torch.arange(skv, device=q.device)
    offsets = torch.arange(bq, device=q.device)
    outs = []
    for i in range(n_blocks):
        qs = i * bq
        q_pos = q_start + qs + offsets
        if window and window + bq < skv:
            # only the last (window + bq) keys can be visible to this block
            kv_len = window + bq
            start = min(max(q_start + qs + bq - kv_len, 0), skv - kv_len)
            kb = k[:, start:start + kv_len]
            vb = v[:, start:start + kv_len]
            k_pos = start + torch.arange(kv_len, device=q.device)
        else:
            kb, vb = k, v
            k_pos = kv_positions
        mask = q_pos[:, None] >= k_pos[None, :]
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        outs.append(_sdpa(q[:, qs:qs + bq], kb, vb, mask[None, None, None]))
    return torch.cat(outs, dim=1)[:, :sq]


def _bucketed_causal_attention(q, k, v, *, block_q: int):
    """Causal attention with power-of-two kv buckets (static shapes).

    q block i needs kv[0 : (i+1) * bq]. Blocks with i+1 in (2^b/2, 2^b] share
    the padded kv span kv[0 : 2^b * bq]. FLOPs ~ (2/3) S^2 vs S^2 for the
    full grid."""
    sq, skv = q.shape[1], k.shape[1]
    bq = min(block_q, sq)
    if sq % bq:
        raise ValueError(f"seq {sq} not divisible by block_q {bq}")
    nb = sq // bq
    offsets = torch.arange(bq, device=q.device)
    outs = []
    start = 0
    span = 1
    while start < nb:
        count = min(span - start, nb - start)     # blocks in this bucket
        kv_len = min(span * bq, skv)
        kb, vb = k[:, :kv_len], v[:, :kv_len]
        k_pos = torch.arange(kv_len, device=q.device)
        for i in range(count):
            qs = (start + i) * bq
            q_pos = qs + offsets
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None, None]
            outs.append(_sdpa(q[:, qs:qs + bq], kb, vb, mask))
        start += count
        span *= 2
    return torch.cat(outs, dim=1)


def _chunks(s: int, chunk: int) -> int:
    """How many chunks of ``chunk`` tokens split a sequence of ``s`` (1 when
    ``s <= chunk``); a longer ``s`` must be a multiple of ``chunk``, as the
    JAX package asserts."""
    if chunk < 1:
        raise ValueError(f"chunked attention needs chunk >= 1, got {chunk}")
    if s <= chunk:
        return 1
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    return s // chunk


def chunked_causal_attention(q, k, v, chunk: int):
    """Llama4-style chunked attention: tokens attend causally only within
    their own chunk; plain causal when ``s <= chunk``. O(S * chunk). The
    JAX package maps over the chunks; the port takes them as one batch of
    B * n_chunks sequences (the same sums per chunk)."""
    b, s, h, hd = q.shape
    n = _chunks(s, chunk)
    c = s // n
    pos = torch.arange(c, device=q.device)
    mask = (pos[:, None] >= pos[None, :])[None, None, None]

    def split(t):
        return t.reshape(b * n, c, *t.shape[2:])

    return _sdpa(split(q), split(k), split(v), mask).reshape(b, s, h, hd)


def _sdpa_over_group(q, k, v, mask, group):
    """:func:`_sdpa` over a sequence split on ``group``: k / v and ``mask``
    hold this rank's slots. Each rank's f32 scores are shifted by the
    group's largest (``all_max``; a rank with no visible slot brings
    -inf, clamped to ``NEG_INF`` so that no inf - inf is formed), and
    the exponentials' sums and weighted values are summed over the group
    in one all-reduce. Returns (B, Sq, H, hd) in v's dtype."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    scores = (scores / math.sqrt(hd)).masked_fill(~mask, -math.inf)
    top = group.all_max(scores.amax(-1, keepdim=True).clamp_min(NEG_INF))
    e = torch.exp(scores - top)
    o = torch.einsum("bkgqs,bskd->bkgqd", e, v.to(torch.float32))
    lo = group.reduce_out(torch.cat([o, e.sum(-1, keepdim=True)], -1))
    out = lo[..., :hd] / lo[..., hd:]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(v.dtype)


def _rank_kv_heads(t, n_heads: int, grp):
    """The KV heads of the whole ``t`` (B, S, KV, hd) that this rank's
    ``n_heads`` query heads read, in :func:`_sdpa`'s grouping: query head
    h of the whole model (``n_heads * grp.size`` of them) reads KV head
    h // (H / KV), and the rank's heads start at ``grp.index * n_heads``.
    A narrow where the rank's heads cover whole groups or lie in one,
    else one KV head per query head."""
    g = n_heads * grp.size // t.shape[2]        # q heads a KV head
    lo = grp.index * n_heads
    if n_heads % g == 0:
        return t.narrow(2, lo // g, n_heads // g)
    if g % n_heads == 0:
        return t.narrow(2, lo // g, 1)
    return t.index_select(2, torch.arange(lo, lo + n_heads,
                                          device=t.device) // g)


def _kv_whole(grp) -> bool:
    """Whether this rank holds the whole K/V projections while its query
    heads are split (:func:`repro_torch.models.sharding.kv_heads_whole`)."""
    return grp.size > 1 and kv_heads_whole()


def _expand_heads(t, n_heads: int):
    """(B, S, KV, hd) -> contiguous (B, H, S, hd): q head h reads KV head
    h // (H / KV), the grouping of :func:`_sdpa`."""
    t = t.transpose(1, 2)
    g = n_heads // t.shape[1]
    if g > 1:
        t = t.repeat_interleave(g, dim=1)
    return t.contiguous()


def attention_forward_train(params, x, positions, *, kind: str = "full",
                            window: int = 0, chunk: int = 0,
                            use_rope: bool = True, rope_theta: float = 1e4,
                            block_q: int = 512,
                            causal_buckets: bool = False):
    """Full-sequence attention on the training route: the JAX model's
    blocked (or chunked) jnp path in differentiable torch ops, no kernel.
    Returns (B, S, d)."""
    if kind not in ("full", "swa", "chunk"):
        raise ValueError(f"unknown attention kind {kind}")
    grp = hinted_group("attention", params, ATTN_AXES)
    x = grp.copy_in(x)
    whole_kv = _kv_whole(grp)
    if whole_kv:        # used by every rank its own way: gradients summed
        params = {k: grp.copy_in(v) if k in KV_LEAVES else v
                  for k, v in params.items()}
    q, k, v = _project_qkv(params, x, positions, use_rope, rope_theta)
    if whole_kv:
        k, v = (_rank_kv_heads(t, q.shape[2], grp) for t in (k, v))
    if kind == "chunk":
        ctxv = chunked_causal_attention(q, k, v, chunk)
    else:
        ctxv = blocked_causal_attention(
            q, k, v, window=window if kind == "swa" else 0, block_q=block_q,
            causal_buckets=causal_buckets and kind == "full")
    out = torch.einsum("bshk,hkd->bsd", ctxv, params["wo"])
    return grp.reduce_out(out)


def attention_forward(params, x, positions, *, kind: str = "full",
                      window: int = 0, chunk: int = 0, use_rope: bool = True,
                      rope_theta: float = 1e4, backend: str = "auto"):
    """Full-sequence attention on the serving route (prefill). Returns
    (B, S, d)."""
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
    the prefill cache. One ``ops.flash_attention`` call a layer on
    (B, H, S, hd) with GQA expanded; a ``chunk`` layer longer than its
    chunk as (B * n_chunks, H, chunk, hd), causal within each chunk. Under
    a model axis the rank's heads: (B, H / dm, S, hd), and k / v of its
    KV / dm heads, or of every KV head where they are whole (the rank's
    query heads then read theirs: :func:`_rank_kv_heads`)."""
    if kind not in ("full", "swa", "chunk"):
        raise ValueError(f"unknown attention kind {kind}")
    grp = hinted_group("attention", params, ATTN_AXES)
    q, k, v = _project_qkv(params, grp.copy_in(x), positions, use_rope,
                           rope_theta)
    b, s, h, hd = q.shape
    n = _chunks(s, chunk) if kind == "chunk" else 1
    kq, vq = k, v
    if _kv_whole(grp):
        kq, vq = (_rank_kv_heads(t, h, grp) for t in (k, v))

    def split(t):
        return t.reshape(b * n, s // n, *t.shape[2:])

    ctxv = ops.flash_attention(
        split(q).transpose(1, 2).contiguous(), _expand_heads(split(kq), h),
        _expand_heads(split(vq), h), window=window if kind == "swa" else 0,
        backend=backend).transpose(1, 2).reshape(b, s, h, hd)
    out = torch.einsum("bshk,hkd->bsd", ctxv, params["wo"])
    return grp.reduce_out(out), (k, v)


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


def seq_block(n_local: int, kind: str, window: int, chunk: int, group):
    """``(group, lo, n)``: where a KV cache of ``n_local`` slots a rank
    sits in a cache whose sequence ``group`` splits (:func:`repro_torch
    .models.sharding.seq_group`): this rank's block starts at slot ``lo``
    of ``n`` (GSPMD's block layout), or ``None`` where the cache is whole
    (no group, or a sliding-window / chunk ring the group does not divide,
    which stays whole as ``resolve_spec`` drops the axis: its length is
    then the window or the chunk itself). ``Transformer.init_cache`` rounds
    a split cache's ``max_len`` up to a multiple of the group, so a
    full-length cache always splits."""
    if group is None:
        return None
    limit = window if kind == "swa" else chunk if kind == "chunk" else 0
    if limit and n_local == limit:
        return None
    return group, group.index * n_local, n_local * group.size


def fill_kv_cache(cache, k, v, kind: str, window: int = 0, chunk: int = 0,
                  seq=None):
    """Write a full prefill sequence into the cache, in place (possibly
    ring-truncated), and return it.

    k / v (B, S, KV, hd). For swa / chunk caches only the tail that
    remains visible is stored, laid out in ring order (slot = pos %
    cache_len). Under a sequence split (``seq``, :func:`seq_block`) the
    rank writes only its own block of slots, from the whole k / v."""
    n_local, s = cache["k"].shape[1], k.shape[1]
    _, lo, n = seq if seq is not None else (None, 0, n_local)
    if s <= n:
        m = max(0, min(lo + n_local, s) - lo)
        cache["k"][:, :m] = k[:, lo:lo + m]
        cache["v"][:, :m] = v[:, lo:lo + m]
        return cache
    # ring layout: slot i holds the last position p < s with p % n == i
    slots = torch.arange(lo, lo + n_local, device=k.device)
    p = (s - 1) - torch.remainder(s - 1 - slots, n)
    cache["k"].copy_(k[:, p])
    cache["v"].copy_(v[:, p])
    return cache


def init_paged_kv_cache(n_blocks: int, block_size: int, n_kv_heads: int,
                        head_dim: int, dtype=torch.bfloat16, device="cpu"):
    """Preallocated block pool for the paged serving cache.

    Unlike the dense per-sequence cache of :func:`init_kv_cache`, the pool
    is indexed by *physical block id*: a slot owns an arbitrary set of
    blocks through an engine-managed ``(slots, blocks_per_slot)`` block
    table, so recycled slots reuse whatever blocks are free rather than a
    fixed contiguous span. Layout inside a slot's span is natural
    (position ``p`` lives at logical offset ``p``; no ring truncation:
    swa / chunk visibility is enforced by the decode mask instead), which
    makes the pool the dense full-attention cache when one block spans
    ``max_len`` and the table is the identity."""
    shape = (n_blocks, block_size, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_index(table, pos, block_size: int, kind: str, window: int,
                head_dim: int, rope_theta: float, chunk: int = 0):
    """What :func:`paged_decode_attention` derives from the block table and
    the positions, the same in every attention layer of a kind in one
    decode step: ``(physical block (B,), offset (B,), visibility mask (B,
    1, 1, 1, span), rope angles at pos)``. The mask is ``p <= pos``, and
    within the window (``swa``) or the token's own chunk (``chunk``). A
    logical block past the table's end reads its last column, as JAX's
    gather clamps: only a released slot, whose row is all scratch block,
    runs that far."""
    if kind not in ("full", "swa", "chunk"):
        raise ValueError(f"unknown attention kind {kind}")
    if kind == "chunk" and chunk < 1:
        raise ValueError(f"chunked attention needs chunk >= 1, got {chunk}")
    b, bps = table.shape
    rows = torch.arange(b, device=table.device)
    phys = table[rows, torch.clamp(pos // block_size, max=bps - 1)]
    p = torch.arange(bps * block_size, device=table.device)
    valid = p[None, :] <= pos[:, None]
    if kind == "swa":
        valid &= p[None, :] > pos[:, None] - window
    elif kind == "chunk":
        valid &= p[None, :] >= (pos[:, None] // chunk) * chunk
    return (phys, pos % block_size, valid[:, None, None, None, :],
            rope_angles(pos[:, None], head_dim, rope_theta))


def paged_decode_attention(params, x, cache, table, index, *,
                           use_rope: bool = True):
    """One-token decode over B independent slots of a paged KV cache.

    x (B, 1, d); cache {"k" / "v": (NB, bs, KV, hd)} block pool; table
    (B, bps) integer maps each slot's logical block l to a physical block;
    ``index``: :func:`paged_index` of the table and the slots' positions
    (B,), computed once per decode step and attention kind by the caller
    (the JAX package derives it in every layer and XLA merges the copies).
    Writes each slot's k / v at (table[b, pos_b // bs], pos_b % bs) in
    place, gathers the slot's whole logical span back in position order,
    and masks entries beyond pos_b (and outside the window or the chunk).
    Returns ``(out (B, 1, d), cache)``.

    No host sync: the positions stay on the device. With one block
    spanning the span and an identity table the gathered reads are the
    dense :func:`decode_attention` cache's, bit for bit; with more blocks
    they are the same values in the same position order."""
    phys, off, valid, angles = index
    b, span = x.shape[0], table.shape[1] * cache["k"].shape[1]
    grp = hinted_group("attention", params, ATTN_AXES)
    q, k, v = _project_qkv(params, grp.copy_in(x), None, use_rope, 0.0,
                           angles)
    cache["k"][phys, off] = k[:, 0].to(cache["k"].dtype)
    cache["v"][phys, off] = v[:, 0].to(cache["v"].dtype)
    kb = cache["k"][table].reshape(b, span, *cache["k"].shape[2:])
    vb = cache["v"][table].reshape(b, span, *cache["v"].shape[2:])
    if _kv_whole(grp):              # the pool holds every KV head
        kb, vb = (_rank_kv_heads(t, q.shape[2], grp) for t in (kb, vb))
    ctxv = _sdpa(q, kb, vb, valid)
    out = torch.einsum("bshk,hkd->bsd", ctxv, params["wo"])
    return grp.reduce_out(out), cache


def decode_attention(params, x, cache, pos: int, *, kind: str = "full",
                     window: int = 0, chunk: int = 0, use_rope: bool = True,
                     rope_theta: float = 1e4, seq=None):
    """One-token decode. x (B, 1, d); ``pos`` (int) the index of this token.
    Writes this token's k / v into the cache in place (the JAX package
    returns a new cache) and returns ``(out (B, 1, d), cache)``.

    Under a sequence split (``seq``, :func:`seq_block`) the cache holds
    this rank's block of slots: the rank that owns slot ``pos % n``
    writes it, and every rank attends over its own slots and combines
    over the group (:func:`_sdpa_over_group`), with every query head
    (gathered over the model group) where the K/V heads are whole, then
    takes its own heads into ``wo``."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    grp = hinted_group("attention", params, ATTN_AXES)
    whole_kv = _kv_whole(grp)
    q, k, v = _project_qkv(params, grp.copy_in(x), positions, use_rope,
                           rope_theta)
    n_local = cache["k"].shape[1]
    group, lo, n = seq if seq is not None else (None, 0, n_local)
    slot = pos % n - lo
    if 0 <= slot < n_local:
        cache["k"][:, slot:slot + 1] = k
        cache["v"][:, slot:slot + 1] = v
    # entry at slot i currently holds position: the largest p <= pos with
    # p % n == i  ->  p = pos - ((pos - i) % n)
    slots = torch.arange(lo, lo + n_local, device=x.device)
    entry_pos = pos - torch.remainder(pos - slots, n)
    valid = entry_pos >= 0
    if kind == "swa":
        valid &= entry_pos > pos - window
    elif kind == "chunk":
        valid &= entry_pos >= (pos // chunk) * chunk
    mask = valid[None, None, None, None, :]
    if group is None:
        kc, vc = cache["k"], cache["v"]
        if whole_kv:
            kc, vc = (_rank_kv_heads(t, q.shape[2], grp) for t in (kc, vc))
        ctxv = _sdpa(q, kc, vc, mask)
    else:
        h = q.shape[2]
        ctxv = _sdpa_over_group(grp.gather(q, 2) if whole_kv else q,
                                cache["k"], cache["v"], mask, group)
        if whole_kv:
            ctxv = ctxv.narrow(2, grp.index * h, h)
    out = torch.einsum("bshk,hkd->bsd", ctxv, params["wo"])
    return grp.reduce_out(out), cache
