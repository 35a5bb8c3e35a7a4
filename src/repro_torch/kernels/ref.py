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


# ---------------------------------------------------------------------------
# counter_rng: Philox4x32-10 by address, Box-Muller in exactly rounded ops
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_CPU_PIECE = 1 << 18       # values of a piece of counter_rng_ref on the CPU
PHILOX_M = (0xD2511F53, 0xCD9E8D57)         # the round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)         # the key's bump each round
# The f32 constants of the normal transform, as bit patterns; the kernel
# (csrc/counter_rng.cu) spells the same words, and a test holds the two
# tables alike. Log: ln m = 2s (1 + s^2 (1/3 + s^2 (1/5 + ... + s^2/13)))
# with s = (m - 1) / (m + 1), m in (sqrt(1/2), sqrt(2)]; sine and cosine:
# Taylor to theta^9 and theta^10 on [0, pi/4].
RNG_CONSTANTS = {
    "sqrt2": 0x3FB504F3, "ln2": 0x3F317218, "pi_4": 0x3F490FDB,
    "l13": 0x3D9D89D9, "l11": 0x3DBA2E8C, "l9": 0x3DE38E39,
    "l7": 0x3E124925, "l5": 0x3E4CCCCD, "l3": 0x3EAAAAAB,
    "s9": 0x3638EF1D, "s7": 0xB9500D01, "s5": 0x3C088889,
    "s3": 0xBE2AAAAB,
    "c10": 0xB493F27E, "c8": 0x37D00D01, "c6": 0xBAB60B61,
    "c4": 0x3D2AAAAB, "c2": 0xBF000000,
}


def _f32(name: str) -> float:
    return float(np.array(RNG_CONSTANTS[name], np.uint32).view(np.float32))


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of ``a * m`` for int64 tensors ``a`` in
    [0, 2^32) and a 32-bit constant ``m``, ``m`` taken in 16-bit halves so
    no int64 product overflows."""
    p_lo = a * (m & 0xFFFF)                  # < 2^48
    p_hi = a * (m >> 16)                     # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)       # < 2^49
    return (p_hi >> 16) + (t >> 32), t & _U32


def philox4x32_ref(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's ``philox4x32``) on
    int64 tensors holding 32-bit words: ten rounds, the key bumped by
    (0x9E3779B9, 0xBB67AE85) before each round but the first. Returns the
    four output words."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _U32, (k1 + PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform24(x):
    """U[0, 1) from a 32-bit word: its top 24 bits times 2^-24 (exact)."""
    return (x >> 8).to(torch.float32) * 2.0 ** -24


def _neg2_log_uniform(x):
    """-2 ln(u) for u = ((x >> 8) + 1) 2^-24 in (0, 1], from the float's
    exponent and a series in its mantissa, every op an IEEE f32 op."""
    v = ((x >> 8) + 1).to(torch.float32)                 # exact, <= 2^24
    bits = v.view(torch.int32).to(torch.int64)
    e = (bits >> 23) - 127
    m = ((bits & 0x7FFFFF) | 0x3F800000).to(torch.int32).view(torch.float32)
    big = m > _f32("sqrt2")
    m = torch.where(big, m * 0.5, m)
    e = e + big.to(torch.int64)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    p = _f32("l13")
    for name in ("l11", "l9", "l7", "l5", "l3"):
        p = p * s2 + _f32(name)
    t = s2 * p
    s_2 = s + s
    ln_m = s_2 + s_2 * t
    ln_u = (e - 24).to(torch.float32) * _f32("ln2") + ln_m
    return ln_u * -2.0


def _sincos_2pi(x):
    """(cos, sin) of 2 pi u for u = (x >> 8) 2^-24: the octant from the
    top 3 of the 24 bits, the angle within it (reflected in odd octants)
    times pi/4, Taylor polynomials there, and an exact quadrant turn."""
    k = x >> 8
    octant, frac = k >> 21, k & 0x1FFFFF
    odd = octant & 1
    g = torch.where(odd == 1, 0x200000 - frac, frac).to(torch.float32)
    theta = (g * 2.0 ** -21) * _f32("pi_4")
    z = theta * theta
    sp = _f32("s9")
    for name in ("s7", "s5", "s3"):
        sp = sp * z + _f32(name)
    sin = theta + (theta * z) * sp
    cp = _f32("c10")
    for name in ("c8", "c6", "c4", "c2"):
        cp = cp * z + _f32(name)
    cos = z * cp + 1.0
    sin = torch.where(odd == 1, -sin, sin)
    quad = ((octant + odd) >> 1) & 3
    c = torch.where(quad == 0, cos, torch.where(
        quad == 1, -sin, torch.where(quad == 2, -cos, sin)))
    s = torch.where(quad == 0, sin, torch.where(
        quad == 1, cos, torch.where(quad == 2, -sin, -cos)))
    return c, s


def counter_columns_ref(table, lo: int, n: int, device):
    """The whole-row columns of local columns [lo, lo + n) under the
    per-leaf ``table`` (L, 5) of (local start, whole offset, local span,
    whole span, shift): a local column k of the leaf starting at ``start``
    reads ``offset + (k - start) // span_l * span_w + shift + (k - start)
    % span_l``."""
    table = torch.as_tensor(table, dtype=torch.int64, device=device)
    k = torch.arange(lo, lo + n, dtype=torch.int64, device=device)
    leaf = torch.searchsorted(table[:, 0].contiguous(), k, right=True) - 1
    start, offset, span_l, span_w, shift = table[leaf].unbind(1)
    d = k - start
    return offset + torch.div(d, span_l, rounding_mode="floor") * span_w \
        + shift + d % span_l


def counter_rng_ref(rows, table, tau: int, n: int, key, purpose: int,
                    normal: bool, lo: int = 0):
    """The plain version of ``counter_rng``: the (R, tau, n) f32 values at
    rows ``rows`` (their global row ids, (R,) int64), steps 0..tau-1 and
    the local columns [lo, lo + n) under ``table``, of the stream
    ``key = (seed, counter)`` and ``purpose``. Value (row, step, column j)
    is word j % 4 of Philox4x32-10 at counter (j // 4, purpose << 24 |
    step, row, counter) and key (seed's low, high 32 bits): a uniform
    (its top 24 bits times 2^-24) or, with ``normal``, Box-Muller on the
    word pair (0, 1) or (2, 3) holding it (even word r cos, odd r sin).
    Each run of columns in one group of four is computed once; on the CPU
    in pieces of ~256K values, whose temporaries stay in the cache."""
    seed, counter = (int(v) for v in key)
    seed &= (1 << 64) - 1
    dev = rows.device
    leaves = torch.as_tensor(table).tolist()
    if len(leaves) == 1 and leaves[0][2] == leaves[0][3]:
        # one leaf kept whole (a whole draw): its columns are one run
        start, offset, _, _, shift = leaves[0]
        c0 = offset + shift + lo - start
        groups = torch.arange(c0 >> 2, ((c0 + n - 1) >> 2) + 1,
                              dtype=torch.int64, device=dev)
        col = where = None
    else:
        col = counter_columns_ref(table, lo, n, dev)
        groups, where = torch.unique_consecutive(col >> 2,
                                                 return_inverse=True)
    c1 = ((purpose << 24)
          | torch.arange(tau, dtype=torch.int64, device=dev))[None, :, None]
    c2 = rows.to(torch.int64)[:, None, None]
    lead = (rows.shape[0], tau)
    piece = (max(1, _CPU_PIECE // (lead[0] * tau)) if dev.type == "cpu"
             else groups.shape[0])
    quads = []
    for g0 in range(0, groups.shape[0], piece):
        g = groups[g0:g0 + piece]
        shape = lead + (g.shape[0],)
        x = philox4x32_ref(g[None, None, :].expand(shape), c1.expand(shape),
                           c2.expand(shape),
                           torch.full(shape, counter, dtype=torch.int64,
                                      device=dev),
                           seed & _U32, seed >> 32)
        if normal:
            r01 = torch.sqrt(_neg2_log_uniform(x[0]))
            r23 = torch.sqrt(_neg2_log_uniform(x[2]))
            c01, s01 = _sincos_2pi(x[1])
            c23, s23 = _sincos_2pi(x[3])
            vals = (r01 * c01, r01 * s01, r23 * c23, r23 * s23)
        else:
            vals = tuple(_uniform24(w) for w in x)
        quads.append(torch.stack(vals, dim=-1).reshape(lead + (-1,)))
    quad = torch.cat(quads, dim=2)
    if col is None:
        return quad[..., c0 & 3:(c0 & 3) + n].contiguous()
    return quad.index_select(2, where * 4 + (col & 3))
