"""Wrapper of the hand-written CUDA ``dp_clip_noise`` kernel
(``csrc/dp_clip_noise.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/dp_clip_noise.py: dp_clip_noise``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.dp_clip_noise_ref`, and a ``meta`` tensor
gets outputs of the right shapes and dtypes and no arithmetic. Any other
device raises. Nothing falls back. Under :func:`repro_torch.utils.cost.cost_of`
a call counts as :func:`cost`, whatever implements it.

The library holds three instances, chosen by :func:`_variant` from the row
length alone (``kernels/row_reduce.py``): ``"row_cta"`` (N <= 4,096),
``"row_cluster"`` (N <= 262,144), both one launch a call that reads g from
HBM once, and ``"row_stream"`` (two passes). A refused launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import row_reduce
from repro_torch.kernels.mamba2_ssd import _on
from repro_torch.kernels.ref import dp_clip_noise_ref
from repro_torch.kernels.row_reduce import variant as _variant  # noqa: F401
from repro_torch.utils.cost import counted

_KERNEL = None                       # (name, launch, error string), once built


def _check(g, noise, sigma):
    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous (R, N) float32 tensor, got "
                         f"{tuple(g.shape)} {g.dtype}")
    rows, n = g.shape
    if rows == 0 or n == 0:
        raise ValueError(f"g must be non-empty, got {tuple(g.shape)}")
    if noise is None:
        return
    if (noise.dtype != torch.float32 or noise.shape != g.shape
            or (n > 1 and noise.stride(1) != 1) or not _on(noise, g)):
        raise ValueError(f"noise must be a float32 tensor of g's shape "
                         f"{tuple(g.shape)} with contiguous rows on "
                         f"{g.device}, got {tuple(noise.shape)} "
                         f"{noise.dtype} on {noise.device}")
    if (sigma is None or sigma.dtype != torch.float32
            or sigma.shape != (rows,) or not sigma.is_contiguous()
            or not _on(sigma, g)):
        raise ValueError(f"sigma must be a contiguous ({rows},) float32 "
                         f"tensor on {g.device}")


def cost(rows: int, n: int, with_noise: bool = True) -> tuple[int, int]:
    """(flops, bytes) of one call on (rows, n), f32. Bytes: g (and noise,
    sigma) read once, y and norm written once. Operations: per element a
    square-and-add (2), the scale (1) and, with noise, a multiply-add
    (2)."""
    nbytes = 4 * (rows * n * (3 if with_noise else 2)
                  + rows * (2 if with_noise else 1))
    return rows * n * (5 if with_noise else 3), nbytes


def dp_clip_noise(g, noise, clip_norm: float, sigma):
    """Row-batched clip + noise; see ``dp_clip_noise_ref`` for the math.

    g (R, N) f32 contiguous, noise (R, N) f32 with contiguous rows (a row
    stride is allowed) or ``None`` (clip only),
    sigma (R,) f32 (unused without noise). Returns ``(y (R, N), norm (R,))``.
    On a CUDA tensor every call runs the instance :func:`_variant` names
    on the current stream, adds 1 to ``dp_clip_noise.launches`` (one per
    call, whatever the instance launches) and sets
    ``dp_clip_noise.last_variant``. On a ``meta`` tensor it returns empty
    outputs and runs nothing."""
    _check(g, noise, sigma)
    return counted("dp_clip_noise",
                   lambda: cost(*g.shape, with_noise=noise is not None),
                   lambda: _run(g, noise, clip_norm, sigma))


def _run(g, noise, clip_norm, sigma):
    global _KERNEL
    if not g.is_cuda:
        if g.device.type == "cpu":
            return dp_clip_noise_ref(g, noise, clip_norm, sigma)
        if g.device.type == "meta":
            return torch.empty_like(g), g.new_empty(g.shape[:1])
        raise ValueError(f"dp_clip_noise runs on cuda, cpu or meta tensors, "
                         f"got {g.device}")
    if _KERNEL is None:
        _KERNEL = row_reduce.load("dp_clip_noise")
    y, norm, variant = row_reduce.launch(
        _KERNEL, g, noise, 0 if noise is None else noise.stride(0),
        None if noise is None else sigma, float(clip_norm))
    dp_clip_noise.launches += 1
    dp_clip_noise.last_variant = variant
    return y, norm


dp_clip_noise.launches = 0
dp_clip_noise.last_variant = None
