"""Wrapper of the hand-written CUDA ``quantize_decompress`` kernel
(``csrc/quantize_decompress.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/quantize_decompress.py: quantize_decompress``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.quantize_decompress_ref`. Nothing falls back.

The library holds three instances, chosen by :func:`_variant` from the row
length alone (``kernels/row_reduce.py``): ``"row_cta"`` (N <= 4,096),
``"row_cluster"`` (N <= 262,144), both one launch a call that reads x from
HBM once, and ``"row_stream"`` (two passes). A refused launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import row_reduce
from repro_torch.kernels.mamba2_ssd import _on
from repro_torch.kernels.ref import quantize_decompress_ref
from repro_torch.kernels.row_reduce import variant as _variant  # noqa: F401

_KERNEL = None                       # (name, launch, error string), once built
# f32(1 / levels) for bits 1..16, as the scale takes it
_INV_LEVELS = {bits: float(np.float32(1) / np.float32((1 << bits) - 1))
               for bits in range(1, 17)}


def _check(x, u, bits):
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (R, N) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"x must be non-empty, got {tuple(x.shape)}")
    if (u.dtype != torch.float32 or u.shape != x.shape
            or not u.is_contiguous() or not _on(u, x)):
        raise ValueError(f"u must be a contiguous float32 tensor of x's "
                         f"shape {tuple(x.shape)} on {x.device}, got "
                         f"{tuple(u.shape)} {u.dtype} on {u.device}")
    if isinstance(bits, bool) or not isinstance(bits, int) or not (
            1 <= bits <= 16):
        raise ValueError(f"bits must be an int in [1, 16], got {bits!r}")


def quantize_decompress(x, u, bits: int):
    """Row-batched QSGD round trip; see ``quantize_decompress_ref`` for the
    math.

    x, u (R, N) f32 contiguous (u ~ U[0, 1)), ``bits`` in [1, 16]. Returns
    ``(y (R, N), scale (R,))``. On a CUDA tensor every call runs the
    instance :func:`_variant` names on the current stream, adds 1 to
    ``quantize_decompress.launches`` (one per call, whatever the instance
    launches) and sets ``quantize_decompress.last_variant``."""
    global _KERNEL
    _check(x, u, bits)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return quantize_decompress_ref(x, u, bits)
        raise ValueError(f"quantize_decompress runs on cuda or cpu tensors, "
                         f"got {x.device}")
    if _KERNEL is None:
        _KERNEL = row_reduce.load("quantize_decompress")
    y, scale, variant = row_reduce.launch(_KERNEL, x, u, x.shape[1], None,
                                          _INV_LEVELS[bits])
    quantize_decompress.launches += 1
    quantize_decompress.last_variant = variant
    return y, scale


quantize_decompress.launches = 0
quantize_decompress.last_variant = None
