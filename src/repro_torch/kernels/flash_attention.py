"""Wrapper of the hand-written CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/flash_attention.py: flash_attention``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`. Nothing falls back.
The kernel has no backward, so an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_Q_TILES = 65535                 # the kernel's grid.y, 32 rows a tile


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.requires_grad:
            raise ValueError(f"flash_attention has no backward: {name} "
                             f"requires grad")
        if (t.dim() != 4 or t.dtype not in DTYPES or not t.is_contiguous()
                or t.device != q.device or t.dtype != q.dtype
                or t.shape != q.shape):
            raise ValueError(
                f"q, k, v must be contiguous (B, H, S, hd) tensors of one "
                f"shape, one dtype (float32 or bfloat16) and one device; got "
                f"{name} {tuple(t.shape)} {t.dtype} on {t.device} against q "
                f"{tuple(q.shape)} {q.dtype} on {q.device}")
    b, h, s, hd = q.shape
    if min(b, h, s, hd) < 1 or hd > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes non-empty tensors with "
                         f"hd <= {_MAX_HEAD_DIM}, got {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _library():
    from repro_torch.kernels._build import load_library
    lib = load_library("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
            + [ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, window: int = 0):
    """Causal attention of q / k / v (B, H, S, hd), float32 or bfloat16,
    with a sliding window of ``window`` keys (0: full causal); see
    ``flash_attention_ref`` for the math. Returns (B, H, S, hd) in q's
    dtype. Any S >= 1, hd <= 256. On a CUDA tensor every call launches one
    kernel (f32 inside, one rounding at the end) and adds 1 to
    ``flash_attention.launches``."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    b, h, s, hd = q.shape
    if -(-s // 32) > _MAX_Q_TILES:
        raise ValueError(f"flash_attention takes S <= {32 * _MAX_Q_TILES}, "
                         f"got {s}")
    lib = _library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            s, hd, window, DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
