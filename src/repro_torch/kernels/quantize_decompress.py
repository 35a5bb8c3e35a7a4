"""Wrapper of the hand-written CUDA ``quantize_decompress`` kernel
(``csrc/quantize_decompress.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/quantize_decompress.py: quantize_decompress``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.quantize_decompress_ref`. Nothing falls back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.ref import quantize_decompress_ref

_MAX_ROWS = 65535                    # the kernel's grid.y


def _check(x, u, bits):
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (R, N) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"x must be non-empty, got {tuple(x.shape)}")
    if (u.dtype != torch.float32 or u.shape != x.shape
            or not u.is_contiguous() or u.device != x.device):
        raise ValueError(f"u must be a contiguous float32 tensor of x's "
                         f"shape {tuple(x.shape)} on {x.device}, got "
                         f"{tuple(u.shape)} {u.dtype} on {u.device}")
    if isinstance(bits, bool) or not isinstance(bits, int) or not (
            1 <= bits <= 16):
        raise ValueError(f"bits must be an int in [1, 16], got {bits!r}")


def _library():
    from repro_torch.kernels._build import load_library
    lib = load_library("quantize_decompress")
    if lib.quantize_decompress_launch.argtypes is None:
        lib.quantize_decompress_partials.argtypes = [ctypes.c_int64]
        lib.quantize_decompress_partials.restype = ctypes.c_int64
        lib.quantize_decompress_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
            + [ctypes.c_void_p] * 3
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])
        lib.quantize_decompress_launch.restype = ctypes.c_int
        lib.quantize_decompress_error_string.argtypes = [ctypes.c_int]
        lib.quantize_decompress_error_string.restype = ctypes.c_char_p
    return lib


def quantize_decompress(x, u, bits: int):
    """Row-batched QSGD round trip; see ``quantize_decompress_ref`` for the
    math.

    x, u (R, N) f32 contiguous (u ~ U[0, 1)), ``bits`` in [1, 16]. Returns
    ``(y (R, N), scale (R,))``. On a CUDA tensor every call launches two
    kernels and adds 2 to ``quantize_decompress.launches``."""
    _check(x, u, bits)
    if x.device.type == "cpu":
        return quantize_decompress_ref(x, u, bits)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_decompress runs on cuda or cpu tensors, "
                         f"got {x.device}")
    rows, n = x.shape
    if rows > _MAX_ROWS:
        raise ValueError(f"quantize_decompress takes at most {_MAX_ROWS} "
                         f"rows, got {rows}")
    inv_levels = float(np.float32(1) / np.float32((1 << bits) - 1))
    lib = _library()
    with torch.cuda.device(x.device):
        partial = torch.empty((rows, lib.quantize_decompress_partials(n)),
                              dtype=torch.float32, device=x.device)
        y = torch.empty_like(x)
        scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
        err = lib.quantize_decompress_launch(
            x.data_ptr(), u.data_ptr(), inv_levels, partial.data_ptr(),
            y.data_ptr(), scale.data_ptr(), rows, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"quantize_decompress launch failed: "
            f"{lib.quantize_decompress_error_string(err).decode()}")
    quantize_decompress.launches += 2
    return y, scale


quantize_decompress.launches = 0
