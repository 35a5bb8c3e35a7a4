"""Wrapper of the hand-written CUDA ``rwkv6_scan`` kernel
(``csrc/rwkv6_scan.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/rwkv6_scan.py: rwkv6_scan``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.rwkv6_scan_ref`, and a ``meta`` tensor gets
outputs of the right shapes and dtypes and no arithmetic. Any other device
raises. Nothing falls back. Under :func:`repro_torch.utils.cost.cost_of` a
call counts as :func:`cost`, whatever implements it. The kernel has no
backward, so an input that requires grad is refused.

The library holds two instances, chosen by :func:`_variant` from S, hd and
the dtype alone: ``"tc"`` (bf16 at hd 16, 32, 48 or 64 and S >= 16: the
chunk-parallel WKV on the tensor cores, three kernels a call) and
``"simt"`` (f32, the decode step and any other hd: the recurrence on the
f32 CUDA cores, one kernel a call). A failed build or launch of either
raises.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels.mamba2_ssd import _on
from repro_torch.kernels.ref import rwkv6_scan_ref
from repro_torch.utils.cost import counted

_MAX_HEAD_DIM = 64                   # every config's rwkv_headdim
_TC_WIDTHS = (16, 32, 48, 64)        # hd the tensor-core tiles take
# the shortest S the tensor-core instance takes: one 16-token sub-chunk.
# Shorter calls run the recurrence: the decode step (S = 1) is one kernel
# of ~5 us on an H100 where the tensor-core instance launches three. Where
# the two cross between S 1 and 64 is not measured.
_TC_MIN_S = 16
_CHUNK = 64                          # tokens per chunk of the tc instance
# the C entry's one argument: {instance (0 simt, 1 tc), dtype, r, k, v, w,
# u, s0, y, s_out, states, decay, B * H, S, H, hd, stream} as seventeen
# int64 (one packed argument costs ctypes less than seventeen typed ones)
_ARGS = struct.Struct("<17q")
_LIB = None                          # the loaded library, once built
_RAW_STREAM = None                   # torch's current-stream handle getter


def _variant(s: int, hd: int, dtype) -> str:
    """The kernel instance for S tokens of head width ``hd`` in ``dtype``:
    ``"tc"`` for bf16 at hd 16 / 32 / 48 / 64 with S >= 16, else
    ``"simt"``; a dtype other than float32 / bfloat16, S < 1 or hd outside
    1..64 raises ``ValueError``."""
    if dtype not in DTYPES:
        raise ValueError(f"rwkv6_scan takes float32 or bfloat16, got {dtype}")
    if s < 1 or not 1 <= hd <= _MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan takes S >= 1 and hd in 1..."
                         f"{_MAX_HEAD_DIM}, got S {s}, hd {hd}")
    if dtype == torch.bfloat16 and hd in _TC_WIDTHS and s >= _TC_MIN_S:
        return "tc"
    return "simt"


def _refusal(r, k, v, w, u, s0) -> str:
    """Why ``_check`` refused: the first input that is not what the kernel
    takes (the slow path, taken only to word the error)."""
    b, h, s, hd = r.shape if r.dim() == 4 else (0, 0, 0, 0)
    if min(b, h, s, hd) < 1 or hd > _MAX_HEAD_DIM:
        return (f"r must be a non-empty (B, H, S, hd) tensor with hd <= "
                f"{_MAX_HEAD_DIM}, got {tuple(r.shape)}")
    seq = (b, h, s, hd)
    for name, t, dtype, shape in (
            ("r", r, r.dtype, seq), ("k", k, r.dtype, seq),
            ("v", v, r.dtype, seq), ("w", w, torch.float32, seq),
            ("u", u, torch.float32, (h, hd)),
            ("s0", s0, torch.float32, (b, h, hd, hd))):
        if t is not None and (t.dtype != dtype or tuple(t.shape) != shape
                              or not t.is_contiguous() or not _on(t, r)
                              or dtype not in DTYPES):
            return (f"rwkv6_scan takes contiguous r, k, v (B, H, S, hd) "
                    f"float32 or bfloat16, w (B, H, S, hd), u (H, hd) and "
                    f"s0 (B, H, hd, hd) float32, on one device; {name} should "
                    f"be {dtype} {shape} on {r.device}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    return "rwkv6_scan: inputs refused"


def _check(r, k, v, w, u, s0):
    if (r.requires_grad or k.requires_grad or v.requires_grad
            or w.requires_grad or u.requires_grad
            or (s0 is not None and s0.requires_grad)):
        name = next(n for n, t in (("r", r), ("k", k), ("v", v), ("w", w),
                                   ("u", u), ("s0", s0))
                    if t is not None and t.requires_grad)
        raise ValueError(f"rwkv6_scan has no backward: {name} requires grad")
    seq = r.shape
    f32 = torch.float32
    if not (r.dim() == 4 and 1 <= min(seq) and seq[3] <= _MAX_HEAD_DIM
            and r.dtype in DTYPES and k.dtype == r.dtype
            and v.dtype == r.dtype and w.dtype == f32 and u.dtype == f32
            and k.shape == seq and v.shape == seq and w.shape == seq
            and u.shape == (seq[1], seq[3])
            and r.is_contiguous() and k.is_contiguous()
            and v.is_contiguous() and w.is_contiguous()
            and u.is_contiguous() and _on(k, r) and _on(v, r) and _on(w, r)
            and _on(u, r)
            and (s0 is None or (s0.dtype == f32 and s0.is_contiguous()
                                and s0.shape == (seq[0], seq[1], seq[3],
                                                 seq[3])
                                and _on(s0, r)))):
        raise ValueError(_refusal(r, k, v, w, u, s0))


def _library():
    global _LIB, _RAW_STREAM
    if _LIB is None:
        from repro_torch.kernels._build import load_library
        lib = load_library("rwkv6_scan")
        lib.rwkv6_scan_launch.argtypes = [ctypes.c_char_p]
        lib.rwkv6_scan_launch.restype = ctypes.c_int
        lib.rwkv6_scan_error_string.argtypes = [ctypes.c_int]
        lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
        _RAW_STREAM = torch._C._cuda_getCurrentRawStream
        _LIB = lib
    return _LIB


def cost(b: int, h: int, s: int, hd: int, with_s0: bool = False,
         itemsize: int = 2) -> tuple[int, int]:
    """(flops, bytes) of one call on (B, H, S, hd). Bytes: r, k, v (and y)
    in the inputs' dtype, w f32, u, s0 and the final state f32, each once.
    Operations: 7 hd^2 per token and head."""
    n = b * h * s * hd
    nbytes = (4 * itemsize + 4) * n + 4 * h * hd + 4 * b * h * hd * hd * (
        2 if with_s0 else 1)
    return 7 * hd * hd * b * h * s, nbytes


def rwkv6_scan(r, k, v, w, u, s0=None):
    """The WKV6 recurrence; see ``rwkv6_scan_ref`` for the math. r, k, v
    (B, H, S, hd) float32 or bfloat16, w (B, H, S, hd) float32, u (H, hd)
    float32, s0 (B, H, hd, hd) float32 or ``None`` (zero state); the dtypes
    are taken as they come, nothing is cast. Returns ``(y (B, H, S, hd) in
    r's dtype, final state (B, H, hd, hd) float32)``. On a CUDA tensor every
    call runs the instance :func:`_variant` names, adds 1 to
    ``rwkv6_scan.launches`` (one per call, whatever the instance launches)
    and sets ``rwkv6_scan.last_variant``. ``"simt"`` launches one kernel;
    ``"tc"`` launches three on the current stream (per-chunk states, the
    state passing, the outputs) with scratch of (B, H, ceil(S / 64), hd,
    hd + 1) float32, and reads r, k, v and w in 16-byte pieces, which needs
    16-byte aligned data pointers: a misaligned view raises
    ``ValueError``. On a ``meta`` tensor it returns empty outputs and runs
    nothing."""
    _check(r, k, v, w, u, s0)
    return counted("rwkv6_scan",
                   lambda: cost(*r.shape, with_s0=s0 is not None,
                                itemsize=r.element_size()),
                   lambda: _run(r, k, v, w, u, s0))


def _run(r, k, v, w, u, s0):
    if not r.is_cuda:
        if r.device.type == "cpu":
            return rwkv6_scan_ref(r, k, v, w, u, s0)
        if r.device.type == "meta":
            b, h, _, hd = r.shape
            return torch.empty_like(r), w.new_empty((b, h, hd, hd))
        raise ValueError(f"rwkv6_scan runs on cuda, cpu or meta tensors, "
                         f"got {r.device}")
    b, h, s, hd = r.shape
    variant = _variant(s, hd, r.dtype)
    rp, kp, vp, wp = r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr()
    if variant == "tc" and (rp | kp | vp | wp) % 16:
        raise ValueError("rwkv6_scan's tensor-core instance reads r, k, v "
                         "and w in 16-byte pieces and needs 16-byte aligned "
                         "data pointers")
    lib = _LIB or _library()
    dev = r.get_device()
    if torch._C._cuda_getDevice() != dev:
        # a launch goes to the current device: make it r's (the common
        # single-device case never enters this context)
        with torch.cuda.device(dev):
            return _run(r, k, v, w, u, s0)
    y = torch.empty_like(r)
    s_out = w.new_empty((b, h, hd, hd))
    states = decay = 0
    if variant == "tc":
        # the per-chunk states (B, H, nc, hd, hd) and decays (B, H, nc, hd),
        # f32, as one allocation
        n_states = b * h * -(-s // _CHUNK) * hd
        scratch = w.new_empty(n_states * (hd + 1))
        states = scratch.data_ptr()
        decay = states + 4 * n_states * hd
    err = lib.rwkv6_scan_launch(_ARGS.pack(
        variant == "tc", DTYPES[r.dtype], rp, kp, vp, wp, u.data_ptr(),
        0 if s0 is None else s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        states, decay, b * h, s, h, hd, _RAW_STREAM(dev)))
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: "
                           f"{lib.rwkv6_scan_error_string(err).decode()}")
    rwkv6_scan.launches += 1
    rwkv6_scan.last_variant = variant
    return y, s_out


rwkv6_scan.launches = 0
rwkv6_scan.last_variant = None
