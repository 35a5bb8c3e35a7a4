"""Wrapper of the hand-written CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/flash_attention.py: flash_attention``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`, and a ``meta`` tensor
gets an output of the right shape and dtype and no arithmetic. Any other
device raises. Nothing falls back. Under
:func:`repro_torch.utils.cost.cost_of` a call counts as :func:`cost`,
whatever implements it.
The kernel has no backward, so an input that requires grad is refused.

The library holds two instances, chosen by :func:`_variant` from the head
dim and dtype alone: ``"tc"`` (bf16 at hd a multiple of 16: ``wgmma`` on
the tensor cores, K / V tiles by TMA) and ``"simt"`` (f32 at any hd, bf16
at any other hd: the f32 CUDA cores). A failed build or launch of either
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.utils.cost import counted

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
_MAX_Q_TILES = 65535                 # the kernels' grid.y
_Q_TILE = {"tc": 64, "simt": 32}     # query rows per block


def _variant(hd: int, dtype) -> str:
    """The kernel instance for head dim ``hd`` and ``dtype``: ``"tc"``
    for bf16 at hd a multiple of 16 (the tensor cores take k16 steps),
    else ``"simt"`` (the tensor cores have no f32 product)."""
    if dtype not in DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{dtype}")
    if not 1 <= hd <= _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes 1 <= hd <= "
                         f"{_MAX_HEAD_DIM}, got {hd}")
    return "tc" if dtype == torch.bfloat16 and hd % 16 == 0 else "simt"


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
    if lib.flash_attention_simt_launch.argtypes is None:
        lib.flash_attention_simt_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
            + [ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_simt_launch.restype = ctypes.c_int
        lib.flash_attention_tc_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
            + [ctypes.c_void_p])
        lib.flash_attention_tc_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def visible_pairs(s: int, window: int) -> int:
    """(query, key) pairs causal attention with ``window`` (0: none)
    computes over S tokens."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def cost(b: int, h: int, s: int, hd: int, window: int = 0,
         itemsize: int = 2) -> tuple[int, int]:
    """(flops, bytes) of one call on (B, H, S, hd). Bytes: q, k, v read
    once, the output written once. Operations: per visible (query, key)
    pair (the causal and window skipping) 2 hd for the score and 2 hd
    for P V."""
    return (4 * hd * b * h * visible_pairs(s, window),
            4 * b * h * s * hd * itemsize)


def flash_attention(q, k, v, *, window: int = 0):
    """Causal attention of q / k / v (B, H, S, hd), float32 or bfloat16,
    with a sliding window of ``window`` keys (0: full causal); see
    ``flash_attention_ref`` for the math. Returns (B, H, S, hd) in q's
    dtype. Any S >= 1, hd <= 256. On a CUDA tensor every call launches one
    kernel, the instance :func:`_variant` names (f32 inside, one rounding at
    the end), adds 1 to ``flash_attention.launches`` and sets
    ``flash_attention.last_variant``. The ``"tc"`` instance reads q, k, v
    through TMA, which needs 16-byte aligned bases: a misaligned view
    raises ``ValueError``. On a ``meta`` tensor it returns an empty output
    and runs nothing."""
    _check(q, k, v, window)
    return counted("flash_attention",
                   lambda: cost(*q.shape, window=window,
                                itemsize=q.element_size()),
                   lambda: _run(q, k, v, window))


def _run(q, k, v, window):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda, cpu or meta "
                         f"tensors, got {q.device}")
    b, h, s, hd = q.shape
    variant = _variant(hd, q.dtype)
    rows = _Q_TILE[variant]
    if -(-s // rows) > _MAX_Q_TILES:
        raise ValueError(f"flash_attention takes S <= {rows * _MAX_Q_TILES}, "
                         f"got {s}")
    if variant == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's tensor-core instance reads q, k, "
                         "v by TMA and needs 16-byte aligned data pointers")
    lib = _library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, s, hd, window)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if variant == "tc":
            err = lib.flash_attention_tc_launch(*args, stream)
        else:
            err = lib.flash_attention_simt_launch(*args, DTYPES[q.dtype],
                                                  stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention.launches += 1
    flash_attention.last_variant = variant
    return out


flash_attention.launches = 0
flash_attention.last_variant = None
