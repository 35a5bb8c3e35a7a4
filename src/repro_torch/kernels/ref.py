"""Plain PyTorch versions of the port's hand-written kernels.

Each one computes what its kernel computes, on any device. The wrappers take
them for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernels
against them.
"""
from __future__ import annotations

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
