"""Wrapper of the hand-written CUDA ``dp_clip_noise`` kernel
(``csrc/dp_clip_noise.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/dp_clip_noise.py: dp_clip_noise``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.dp_clip_noise_ref`. Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import dp_clip_noise_ref

_MAX_ROWS = 65535                    # the kernel's grid.y


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
            or (n > 1 and noise.stride(1) != 1) or noise.device != g.device):
        raise ValueError(f"noise must be a float32 tensor of g's shape "
                         f"{tuple(g.shape)} with contiguous rows on "
                         f"{g.device}, got {tuple(noise.shape)} "
                         f"{noise.dtype} on {noise.device}")
    if (sigma is None or sigma.dtype != torch.float32
            or sigma.shape != (rows,) or not sigma.is_contiguous()
            or sigma.device != g.device):
        raise ValueError(f"sigma must be a contiguous ({rows},) float32 "
                         f"tensor on {g.device}")


def _library():
    from repro_torch.kernels._build import load_library
    lib = load_library("dp_clip_noise")
    if lib.dp_clip_noise_launch.argtypes is None:
        lib.dp_clip_noise_partials.argtypes = [ctypes.c_int64]
        lib.dp_clip_noise_partials.restype = ctypes.c_int64
        lib.dp_clip_noise_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_float] + [ctypes.c_void_p] * 3
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])
        lib.dp_clip_noise_launch.restype = ctypes.c_int
        lib.dp_clip_noise_error_string.argtypes = [ctypes.c_int]
        lib.dp_clip_noise_error_string.restype = ctypes.c_char_p
    return lib


def dp_clip_noise(g, noise, clip_norm: float, sigma):
    """Row-batched clip + noise; see ``dp_clip_noise_ref`` for the math.

    g (R, N) f32 contiguous, noise (R, N) f32 with contiguous rows (a row
    stride is allowed) or ``None`` (clip only),
    sigma (R,) f32 (unused without noise). Returns ``(y (R, N), norm (R,))``.
    On a CUDA tensor every call launches two kernels and adds 2 to
    ``dp_clip_noise.launches``."""
    _check(g, noise, sigma)
    if g.device.type == "cpu":
        return dp_clip_noise_ref(g, noise, clip_norm, sigma)
    if g.device.type != "cuda":
        raise ValueError(f"dp_clip_noise runs on cuda or cpu tensors, got "
                         f"{g.device}")
    rows, n = g.shape
    if rows > _MAX_ROWS:
        raise ValueError(f"dp_clip_noise takes at most {_MAX_ROWS} rows, "
                         f"got {rows}")
    lib = _library()
    with torch.cuda.device(g.device):
        partial = torch.empty((rows, lib.dp_clip_noise_partials(n)),
                              dtype=torch.float32, device=g.device)
        y = torch.empty_like(g)
        norm = torch.empty((rows,), dtype=torch.float32, device=g.device)
        err = lib.dp_clip_noise_launch(
            g.data_ptr(), None if noise is None else noise.data_ptr(),
            0 if noise is None else noise.stride(0),
            None if noise is None else sigma.data_ptr(), float(clip_norm),
            partial.data_ptr(), y.data_ptr(), norm.data_ptr(), rows, n,
            torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dp_clip_noise launch failed: "
                           f"{lib.dp_clip_noise_error_string(err).decode()}")
    dp_clip_noise.launches += 2
    return y, norm


dp_clip_noise.launches = 0
