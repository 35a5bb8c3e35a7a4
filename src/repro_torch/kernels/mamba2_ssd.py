"""Wrapper of the hand-written CUDA ``mamba2_ssd`` kernel
(``csrc/mamba2_ssd.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/mamba2_ssd.py: mamba2_ssd``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.mamba2_ssd_ref`. Nothing falls back. The
kernel has no backward, so an input that requires grad is refused.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.ref import mamba2_ssd_ref

_MAX_SMEM = 232_448                  # bytes a block may use on Hopper


def _check(x, dt, a, b_in, c_in, chunk):
    named = {"x": x, "dt": dt, "a": a, "b": b_in, "c": c_in}
    for name, t in named.items():
        if t.requires_grad:
            raise ValueError(f"mamba2_ssd has no backward: {name} requires "
                             f"grad")
    bsz, s, h, p = x.shape if x.dim() == 4 else (0, 0, 0, 0)
    n = b_in.shape[-1] if b_in.dim() == 3 else 0
    if min(bsz, s, h, p, n) < 1:
        raise ValueError(f"x must be a non-empty (B, S, H, P) tensor and b a "
                         f"(B, S, N) one, got {tuple(x.shape)} and "
                         f"{tuple(b_in.shape)}")
    want = {"x": (x.dtype, (bsz, s, h, p)),
            "dt": (torch.float32, (bsz, s, h)), "a": (torch.float32, (h,)),
            "b": (x.dtype, (bsz, s, n)), "c": (x.dtype, (bsz, s, n))}
    for name, t in named.items():
        dtype, shape = want[name]
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != x.device
                or dtype not in DTYPES):
            raise ValueError(
                f"mamba2_ssd takes contiguous x (B, S, H, P), b and c "
                f"(B, S, N) float32 or bfloat16, dt (B, S, H) and a (H,) "
                f"float32, on one device; {name} should be {dtype} {shape} "
                f"on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} not divisible by ssd chunk {chunk}")


def _library():
    from repro_torch.kernels._build import load_library
    lib = load_library("mamba2_ssd")
    if lib.mamba2_ssd_launch.argtypes is None:
        lib.mamba2_ssd_smem_bytes.argtypes = [ctypes.c_int64] * 3
        lib.mamba2_ssd_smem_bytes.restype = ctypes.c_int64
        lib.mamba2_ssd_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 6
            + [ctypes.c_int, ctypes.c_void_p])
        lib.mamba2_ssd_launch.restype = ctypes.c_int
        lib.mamba2_ssd_error_string.argtypes = [ctypes.c_int]
        lib.mamba2_ssd_error_string.restype = ctypes.c_char_p
    return lib


def mamba2_ssd(x, dt, a, b_in, c_in, *, chunk: int = 128):
    """Mamba2's SSD chunk scan from a zero state; see ``mamba2_ssd_ref``
    for the math. x (B, S, H, P) float32 or bfloat16 in the model's
    layout, dt (B, S, H) float32 after softplus, a (H,) float32, b / c
    (B, S, N) in x's dtype, shared by every head. The chunk is
    ``min(chunk, S)`` and must divide S. Returns ``(y (B, S, H, P) in x's
    dtype, final state (B, H, P, N) float32)``. On a CUDA tensor every call
    launches one kernel and adds 1 to ``mamba2_ssd.launches``."""
    chunk = min(chunk, x.shape[1]) if x.dim() == 4 else chunk
    _check(x, dt, a, b_in, c_in, chunk)
    if x.device.type == "cpu":
        return mamba2_ssd_ref(x, dt, a, b_in, c_in, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd runs on cuda or cpu tensors, got "
                         f"{x.device}")
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    lib = _library()
    smem = lib.mamba2_ssd_smem_bytes(chunk, p, n)
    if smem > _MAX_SMEM:
        raise ValueError(f"mamba2_ssd: chunk {chunk}, P {p}, N {n} need "
                         f"{smem} bytes of shared memory, above {_MAX_SMEM}")
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                            device=x.device)
        err = lib.mamba2_ssd_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, s, h, p, n,
            chunk, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd launch failed: "
                           f"{lib.mamba2_ssd_error_string(err).decode()}")
    mamba2_ssd.launches += 1
    return y, state


mamba2_ssd.launches = 0
