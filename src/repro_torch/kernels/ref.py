"""Plain PyTorch versions of the port's hand-written kernels.

Each one computes what its kernel computes, on any device. The wrappers take
them for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernels
against them.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def dp_clip_noise_ref(g, noise, clip_norm, sigma):
    """Row-batched clip + noise: for every row r of ``g`` (R, N)

        norm[r] = ||g[r]||_2                      (f32)
        y[r]    = g[r] * min(1, C / max(norm[r], 1e-12)) + sigma[r] * noise[r]

    ``noise`` is (R, N) or ``None`` (clip only; ``sigma`` is then unused),
    ``sigma`` is (R,). Returns ``(y, norm)`` with ``y`` in ``g.dtype``."""
    g32 = g.to(torch.float32)
    norm = torch.sqrt(torch.sum(torch.square(g32), dim=1))
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    y = g32 * scale[:, None]
    if noise is not None:
        y = y + sigma[:, None] * noise.to(torch.float32)
    return y.to(g.dtype), norm


def row_sumsq_ref(x):
    """Each row's sum of squares of ``x`` (R, N), in f32: the first phase
    of :func:`dp_clip_noise_ref` split off (``norm = sqrt(row_sumsq)``)."""
    return torch.sum(torch.square(x.to(torch.float32)), dim=1)


def clip_noise_apply_ref(x, noise, norm, clip_norm, sigma):
    """The second phase of :func:`dp_clip_noise_ref` from a given ``norm``
    (R,): ``y[r] = x[r] * min(1, C / max(norm[r], 1e-12)) + sigma[r] *
    noise[r]`` (``noise=None``: the clip only). ``y`` in ``x.dtype``."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    y = x32 * scale[:, None]
    if noise is not None:
        y = y + sigma[:, None] * noise.to(torch.float32)
    return y.to(x.dtype)


def quantize_decompress_ref(x, u, bits: int):
    """Row-batched QSGD round trip: for every row r of ``x`` (R, D)

        scale[r] = max(max|x[r]|, 1e-30) * f32(1 / (2**bits - 1))
        y[r]     = sign(x[r]) * floor(|x[r]| / scale[r] + u[r]) * scale[r]

    ``u`` (R, D) ~ U[0, 1) drives the stochastic rounding. The scale is the
    max times the f32 reciprocal of the level count, as the JAX package
    computes it under ``jit`` (XLA turns the division by the constant level
    count into that multiply); ``|x| / scale`` is a true divide. An all-zero
    row comes back as zeros. Returns ``(y, scale (R,))``, ``y`` in
    ``x.dtype``."""
    levels = (1 << bits) - 1
    inv_levels = float(np.float32(1) / np.float32(levels))
    x32 = x.to(torch.float32)
    absx = torch.abs(x32)
    scale = torch.clamp(torch.amax(absx, dim=1), min=1e-30) * inv_levels
    level = torch.floor(absx / scale[:, None] + u.to(torch.float32))
    return (torch.sign(x32) * level * scale[:, None]).to(x.dtype), scale


def cohort_gather_scatter_ref(cache, slots, rows=None):
    """Cohort row gather / scatter: for the (S, D) ``cache`` and the (K,)
    unique ``slots``

        gather  (``rows=None``): returns ``cache[slots]``, a new (K, D)
        scatter: ``cache[slots] = rows`` in place, returns ``cache``

    A pure copy, so every route is bit-identical."""
    slots = slots.to(torch.int64)
    if rows is None:
        return torch.index_select(cache, 0, slots)
    return cache.index_copy_(0, slots, rows)


def flash_attention_ref(q, k, v, *, window: int = 0):
    """Causal attention, optionally sliding-window, on q / k / v
    (B, H, S, hd) with one head count (GQA expanded by the caller):

        scores = (q k^T) / sqrt(hd),  masked to  k <= q  (and, with a
                 window W,  k > q - W)  with -1e30
        out    = softmax(scores) v

    A port of the JAX package's ``ref.flash_attention_ref``: the scores
    are taken in the inputs' dtype and then widened to f32, and the
    probabilities are rounded to v's dtype before the second product, so
    bf16 inputs round twice where the kernel (f32 inside) does not.
    Returns (B, H, S, hd) in v's dtype."""
    s = q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(q.shape[-1])
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """The WKV6 recurrence, one step per token, state in f32. For r / k /
    v / w (B, H, S, hd), u (H, hd), s0 (B, H, hd, hd) or ``None`` (zeros):

        y_t[j] = sum_i r_t[i] (S[i, j] + u[i] k_t[i] v_t[j])
        S      <- diag(w_t) S + k_t v_t^T

    A port of the JAX package's ``ref.rwkv6_scan_ref``. Returns
    ``(y (B, H, S, hd) in r's dtype, final state (B, H, hd, hd) f32)``."""
    b, h, s, hd = r.shape
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
             if s0 is None else s0.to(torch.float32))
    u32 = u.to(torch.float32)
    ys = []
    for t in range(s):
        rt, kt, vt, wt = (x[:, :, t].to(torch.float32) for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               state + u32[None, :, :, None] * kv))
        state = state * wt[..., None] + kv
    return torch.stack(ys, dim=2).to(r.dtype), state


def mamba2_ssd_ref(x, dt, a, b_in, c_in, chunk: int):
    """Mamba2's SSD chunk scan from a zero state, chunk by chunk as the
    kernel computes it. For x (B, S, H, P), dt (B, S, H) (after softplus),
    a (H,), b / c (B, S, N) shared across heads, per chunk of Q tokens:

        L      = cumsum(dt * a)
        M[t,s] = (c_t . b_s) exp(L_t - L_s) dt_s  [s <= t]
        y      = M x + exp(L_t) (c_t . state)
        state <- exp(L_Q) state + sum_s exp(L_Q - L_s) dt_s x_s b_s^T

    all in f32. S must be a multiple of ``chunk``. Returns ``(y (B, S, H,
    P) in x's dtype, final state (B, H, P, N) f32)``."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by ssd chunk {chunk}")
    f32 = torch.float32
    xs = x.to(f32).permute(0, 2, 1, 3)                      # (B, H, S, P)
    dts = dt.to(f32).permute(0, 2, 1)                       # (B, H, S)
    a32 = a.to(f32)[None, :, None]
    bs, cs = b_in.to(f32)[:, None], c_in.to(f32)[:, None]  # (B, 1, S, N)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        xc, dtc = xs[:, :, c0:c0 + chunk], dts[:, :, c0:c0 + chunk]
        bc, cc = bs[:, :, c0:c0 + chunk], cs[:, :, c0:c0 + chunk]
        l = torch.cumsum(dtc * a32, dim=-1)                  # (B, H, Q)
        l_last = l[..., -1:]
        scores = cc @ bc.transpose(-1, -2)                  # (B, 1, Q, Q)
        decay = torch.exp(l[..., :, None] - l[..., None, :])
        m = torch.where(tri, scores * decay,
                        torch.zeros((), dtype=f32, device=x.device))
        m = m * dtc[..., None, :]
        y = m @ xc
        y = y + torch.exp(l)[..., None] * (cc @ state.transpose(-1, -2))
        w = torch.exp(l_last - l) * dtc
        state = (torch.exp(l_last)[..., None] * state
                 + (w[..., None] * xc).transpose(-1, -2) @ bc)
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)
    return y.to(x.dtype), state
