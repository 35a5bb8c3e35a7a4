"""Wrapper of the hand-written CUDA ``rwkv6_scan`` kernel
(``csrc/rwkv6_scan.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/rwkv6_scan.py: rwkv6_scan``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.rwkv6_scan_ref`. Nothing falls back. The
kernel has no backward, so an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.ref import rwkv6_scan_ref

_MAX_HEAD_DIM = 64                   # every config's rwkv_headdim


def _check(r, k, v, w, u, s0):
    b, h, s, hd = r.shape if r.dim() == 4 else (0, 0, 0, 0)
    named = {"r": r, "k": k, "v": v, "w": w, "u": u}
    if s0 is not None:
        named["s0"] = s0
    for name, t in named.items():
        if t.requires_grad:
            raise ValueError(f"rwkv6_scan has no backward: {name} requires "
                             f"grad")
    if min(b, h, s, hd) < 1 or hd > _MAX_HEAD_DIM:
        raise ValueError(f"r must be a non-empty (B, H, S, hd) tensor with "
                         f"hd <= {_MAX_HEAD_DIM}, got {tuple(r.shape)}")
    want = {"r": (r.dtype, (b, h, s, hd)), "k": (r.dtype, (b, h, s, hd)),
            "v": (r.dtype, (b, h, s, hd)),
            "w": (torch.float32, (b, h, s, hd)),
            "u": (torch.float32, (h, hd)),
            "s0": (torch.float32, (b, h, hd, hd))}
    for name, t in named.items():
        dtype, shape = want[name]
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != r.device
                or dtype not in DTYPES):
            raise ValueError(
                f"rwkv6_scan takes contiguous r, k, v (B, H, S, hd) float32 "
                f"or bfloat16, w (B, H, S, hd), u (H, hd) and s0 (B, H, hd, "
                f"hd) float32, on one device; {name} should be {dtype} "
                f"{shape} on {r.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _library():
    from repro_torch.kernels._build import load_library
    lib = load_library("rwkv6_scan")
    if lib.rwkv6_scan_launch.argtypes is None:
        lib.rwkv6_scan_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 4
            + [ctypes.c_int, ctypes.c_void_p])
        lib.rwkv6_scan_launch.restype = ctypes.c_int
        lib.rwkv6_scan_error_string.argtypes = [ctypes.c_int]
        lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
    return lib


def rwkv6_scan(r, k, v, w, u, s0=None):
    """The WKV6 recurrence; see ``rwkv6_scan_ref`` for the math. r, k, v
    (B, H, S, hd) float32 or bfloat16, w (B, H, S, hd) float32, u (H, hd)
    float32, s0 (B, H, hd, hd) float32 or ``None`` (zero state); the dtypes
    are taken as they come, nothing is cast. Returns ``(y (B, H, S, hd) in
    r's dtype, final state (B, H, hd, hd) float32)``. On a CUDA tensor every
    call launches one kernel and adds 1 to ``rwkv6_scan.launches``."""
    _check(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cuda or cpu tensors, got "
                         f"{r.device}")
    b, h, s, hd = r.shape
    lib = _library()
    with torch.cuda.device(r.device):
        y = torch.empty_like(r)
        s_out = torch.empty((b, h, hd, hd), dtype=torch.float32,
                            device=r.device)
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), b * h, s, h, hd, DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: "
                           f"{lib.rwkv6_scan_error_string(err).decode()}")
    rwkv6_scan.launches += 1
    return y, s_out


rwkv6_scan.launches = 0
