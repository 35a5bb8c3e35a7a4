"""Plain PyTorch versions of the port's hand-written kernels.

Each one computes what its kernel computes, on any device. The wrappers take
them for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernels
against them.
"""
from __future__ import annotations

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
