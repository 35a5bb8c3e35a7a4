"""Wrapper of the hand-written CUDA ``mamba2_ssd`` kernel
(``csrc/mamba2_ssd.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/mamba2_ssd.py: mamba2_ssd``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.mamba2_ssd_ref`, and a ``meta`` tensor gets
outputs of the right shapes and dtypes and no arithmetic. Any other device
raises. Nothing falls back. Under :func:`repro_torch.utils.cost.cost_of` a
call counts as :func:`cost`, whatever implements it. The kernel has no
backward, so an input that requires grad is refused.

The library holds two instances, chosen by :func:`_variant` from the chunk,
the head and state widths and the dtype alone: ``"tc"`` (bf16 at Q 64 or
128, P and N multiples of 16 up to 128: ``wgmma`` on the tensor cores) and
``"simt"`` (f32, and bf16 at any other shape: the f32 CUDA cores). A failed
build or launch of either raises.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.ref import mamba2_ssd_ref
from repro_torch.utils.cost import counted

_MAX_SMEM = 232_448                  # bytes a block may use on Hopper
_TC_WIDTHS = range(16, 129, 16)      # P and N the tensor-core tiles take
# the C entry's one argument: {instance (0 simt, 1 tc), dtype, x, dt, a, b,
# c, y, state, B, S, H, P, N, Q, stream} as sixteen int64 (one packed
# argument costs ctypes less than sixteen typed ones)
_ARGS = struct.Struct("<16q")
_LIB = None                          # the loaded library, once built
_RAW_STREAM = None                   # torch's current-stream handle getter


def _simt_smem(q: int, p: int, n: int) -> int:
    """Bytes of shared memory one block of the SIMT instance needs
    (``smem_floats`` in ``csrc/mamba2_ssd.cu``, whose launcher refuses the
    same shapes)."""
    return 4 * (q * p + 2 * q * (n + 1) + q * q + p * (n + 1) + 4 * q + 8)


def _variant(q: int, p: int, n: int, dtype) -> str:
    """The kernel instance for chunk ``q``, head width ``p``, state width
    ``n`` and ``dtype``: ``"tc"`` for bf16 at Q 64 or 128 with P and N
    multiples of 16 up to 128 (64-row ``wgmma`` tiles, k16 steps), else
    ``"simt"`` where its tiles fit in shared memory; anything else raises
    ``ValueError``."""
    if dtype not in DTYPES:
        raise ValueError(f"mamba2_ssd takes float32 or bfloat16, got {dtype}")
    if min(q, p, n) < 1:
        raise ValueError(f"mamba2_ssd takes a chunk and widths >= 1, got Q "
                         f"{q}, P {p}, N {n}")
    if (dtype == torch.bfloat16 and q in (64, 128) and p in _TC_WIDTHS
            and n in _TC_WIDTHS):
        return "tc"
    if _simt_smem(q, p, n) > _MAX_SMEM:
        raise ValueError(f"mamba2_ssd: chunk {q}, P {p}, N {n} need "
                         f"{_simt_smem(q, p, n)} bytes of shared memory, "
                         f"above {_MAX_SMEM}")
    return "simt"


def _on(t, x) -> bool:
    """Whether ``t`` lies on ``x``'s device; for CUDA tensors by their
    integer device index, which builds no ``torch.device`` objects."""
    if x.is_cuda:
        return t.is_cuda and t.get_device() == x.get_device()
    return t.device == x.device


def _check(x, dt, a, b_in, c_in, chunk):
    named = (("x", x), ("dt", dt), ("a", a), ("b", b_in), ("c", c_in))
    if x.requires_grad or dt.requires_grad or a.requires_grad or \
            b_in.requires_grad or c_in.requires_grad:
        name = next(n for n, t in named if t.requires_grad)
        raise ValueError(f"mamba2_ssd has no backward: {name} requires "
                         f"grad")
    bsz, s, h, p = x.shape if x.dim() == 4 else (0, 0, 0, 0)
    n = b_in.shape[-1] if b_in.dim() == 3 else 0
    if min(bsz, s, h, p, n) < 1:
        raise ValueError(f"x must be a non-empty (B, S, H, P) tensor and b a "
                         f"(B, S, N) one, got {tuple(x.shape)} and "
                         f"{tuple(b_in.shape)}")
    want = ((x.dtype, (bsz, s, h, p)), (torch.float32, (bsz, s, h)),
            (torch.float32, (h,)), (x.dtype, (bsz, s, n)),
            (x.dtype, (bsz, s, n)))
    for (name, t), (dtype, shape) in zip(named, want):
        if (t.dtype != dtype or t.shape != shape or not t.is_contiguous()
                or not _on(t, x) or dtype not in DTYPES):
            raise ValueError(
                f"mamba2_ssd takes contiguous x (B, S, H, P), b and c "
                f"(B, S, N) float32 or bfloat16, dt (B, S, H) and a (H,) "
                f"float32, on one device; {name} should be {dtype} {shape} "
                f"on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} not divisible by ssd chunk {chunk}")


def _library():
    global _LIB, _RAW_STREAM
    if _LIB is None:
        from repro_torch.kernels._build import load_library
        lib = load_library("mamba2_ssd")
        lib.mamba2_ssd_launch.argtypes = [ctypes.c_char_p]
        lib.mamba2_ssd_launch.restype = ctypes.c_int
        lib.mamba2_ssd_error_string.argtypes = [ctypes.c_int]
        lib.mamba2_ssd_error_string.restype = ctypes.c_char_p
        _RAW_STREAM = torch._C._cuda_getCurrentRawStream
        _LIB = lib
    return _LIB


def cost(b: int, s: int, h: int, p: int, n: int, q: int,
         itemsize: int = 2) -> tuple[int, int]:
    """(flops, bytes) of one call on x (B, S, H, P), b / c (B, S, N) at
    chunk Q. Bytes: x and y in the inputs' dtype, b and c once, dt, a and
    the final state f32. Operations per chunk and head: the scores and
    M x over the Q (Q + 1) / 2 pairs (2 N + 2 P each), the state's
    contribution and the state update (2 Q P N each)."""
    nbytes = (itemsize * (2 * b * s * h * p + 2 * b * s * n)
              + 4 * (b * s * h + h + b * h * p * n))
    per_chunk = q * (q + 1) // 2 * (2 * n + 2 * p) + 4 * q * p * n
    return per_chunk * (s // q) * b * h, nbytes


def mamba2_ssd(x, dt, a, b_in, c_in, *, chunk: int = 128):
    """Mamba2's SSD chunk scan from a zero state; see ``mamba2_ssd_ref``
    for the math. x (B, S, H, P) float32 or bfloat16 in the model's
    layout, dt (B, S, H) float32 after softplus, a (H,) float32, b / c
    (B, S, N) in x's dtype, shared by every head. The chunk is
    ``min(chunk, S)`` and must divide S. Returns ``(y (B, S, H, P) in x's
    dtype, final state (B, H, P, N) float32)``. On a CUDA tensor every call
    launches one kernel, the instance :func:`_variant` names, adds 1 to
    ``mamba2_ssd.launches`` and sets ``mamba2_ssd.last_variant``. The
    ``"tc"`` instance copies x, b and c in 16-byte pieces, which needs
    16-byte aligned data pointers: a misaligned view raises
    ``ValueError``. On a ``meta`` tensor it returns empty outputs and runs
    nothing."""
    chunk = min(chunk, x.shape[1]) if x.dim() == 4 else chunk
    _check(x, dt, a, b_in, c_in, chunk)
    return counted("mamba2_ssd",
                   lambda: cost(*x.shape, b_in.shape[-1], chunk,
                                itemsize=x.element_size()),
                   lambda: _run(x, dt, a, b_in, c_in, chunk))


def _run(x, dt, a, b_in, c_in, chunk):
    if not x.is_cuda:
        if x.device.type == "cpu":
            return mamba2_ssd_ref(x, dt, a, b_in, c_in, chunk)
        if x.device.type == "meta":
            bsz, _, h, p = x.shape
            return (torch.empty_like(x),
                    dt.new_empty((bsz, h, p, b_in.shape[-1])))
        raise ValueError(f"mamba2_ssd runs on cuda, cpu or meta tensors, "
                         f"got {x.device}")
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    variant = _variant(chunk, p, n, x.dtype)
    xp, bp, cp = x.data_ptr(), b_in.data_ptr(), c_in.data_ptr()
    if variant == "tc" and (xp | bp | cp) % 16:
        raise ValueError("mamba2_ssd's tensor-core instance copies x, b and "
                         "c in 16-byte pieces and needs 16-byte aligned data "
                         "pointers")
    lib = _LIB or _library()
    dev = x.get_device()
    if torch._C._cuda_getDevice() != dev:
        # a launch goes to the current device: make it x's (the common
        # single-device case never enters this context)
        with torch.cuda.device(dev):
            return _run(x, dt, a, b_in, c_in, chunk)
    y = torch.empty_like(x)
    state = dt.new_empty((bsz, h, p, n))
    err = lib.mamba2_ssd_launch(_ARGS.pack(
        variant == "tc", DTYPES[x.dtype], xp, dt.data_ptr(), a.data_ptr(),
        bp, cp, y.data_ptr(), state.data_ptr(), bsz, s, h, p, n, chunk,
        _RAW_STREAM(dev)))
    if err != 0:
        raise RuntimeError(f"mamba2_ssd launch failed: "
                           f"{lib.mamba2_ssd_error_string(err).decode()}")
    mamba2_ssd.launches += 1
    mamba2_ssd.last_variant = variant
    return y, state


mamba2_ssd.launches = 0
mamba2_ssd.last_variant = None
