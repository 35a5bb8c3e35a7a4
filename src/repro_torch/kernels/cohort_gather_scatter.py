"""Wrapper of the hand-written CUDA ``cohort_gather_scatter`` kernel
(``csrc/cohort_gather_scatter.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/cohort_gather.py: cohort_gather_scatter``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.cohort_gather_scatter_ref`. Nothing falls
back. The scatter writes the cache in place on both routes, where the JAX
form aliases the cache into its output.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels.ref import cohort_gather_scatter_ref

_MAX_ROWS = 65535                    # the kernel's grid.y
_SLOT_BYTES = {torch.int32: 4, torch.int64: 8}
# the C entry's one argument: {scatter, cache, slots, slot bytes, rows, K,
# row bytes, S, stream} as nine int64 (one packed argument costs ctypes
# less than nine typed ones)
_ARGS = struct.Struct("<9q")
_LIB = None                          # the loaded library, once built
_RAW_STREAM = None                   # torch's current-stream handle getter


def _on(t, cache) -> bool:
    """Whether ``t`` lies on ``cache``'s device; for CUDA tensors by their
    integer device index, which builds no ``torch.device`` objects."""
    if cache.is_cuda:
        return t.is_cuda and t.get_device() == cache.get_device()
    return t.device == cache.device


def _check(cache, slots, rows):
    if cache.dim() != 2 or 0 in cache.shape or not cache.is_contiguous():
        raise ValueError(f"cache must be a contiguous non-empty (S, D) "
                         f"tensor, got {tuple(cache.shape)}")
    if (slots.dim() != 1 or slots.dtype not in _SLOT_BYTES
            or slots.shape[0] == 0 or not _on(slots, cache)):
        raise ValueError(f"slots must be a non-empty (K,) int32 or int64 "
                         f"tensor on {cache.device}, got "
                         f"{tuple(slots.shape)} {slots.dtype} on "
                         f"{slots.device}")
    if rows is None:
        return
    if (rows.dtype != cache.dtype
            or rows.shape != (slots.shape[0], cache.shape[1])
            or not rows.is_contiguous() or not _on(rows, cache)):
        want = (slots.shape[0], cache.shape[1])
        raise ValueError(f"rows must be a contiguous {cache.dtype} tensor of "
                         f"shape {want} on {cache.device}, got "
                         f"{tuple(rows.shape)} {rows.dtype} on {rows.device}")


def _library():
    global _LIB, _RAW_STREAM
    if _LIB is None:
        from repro_torch.kernels._build import load_library
        lib = load_library("cohort_gather_scatter")
        lib.cohort_gather_scatter_launch.argtypes = [ctypes.c_char_p]
        lib.cohort_gather_scatter_launch.restype = ctypes.c_int
        lib.cohort_gather_scatter_width.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int64])
        lib.cohort_gather_scatter_width.restype = ctypes.c_int
        lib.cohort_gather_scatter_error_string.argtypes = [ctypes.c_int]
        lib.cohort_gather_scatter_error_string.restype = ctypes.c_char_p
        _RAW_STREAM = torch._C._cuda_getCurrentRawStream
        _LIB = lib
    return _LIB


def cohort_gather_scatter(cache, slots, rows=None):
    """Gather (``rows=None``) or scatter rows of the (S, D) cohort cache.

    gather:  ``cohort_gather_scatter(cache, slots)`` -> new (K, D) rows
    scatter: ``cohort_gather_scatter(cache, slots, rows)`` writes ``rows``
             over the slot rows of ``cache`` in place and returns ``cache``

    ``cache`` is any dtype, ``slots`` (K,) int32 or int64 and unique (the
    cohort contract; the scatter has no write conflicts), ``rows`` (K, D)
    of the cache's dtype. On a CUDA tensor every call launches one kernel,
    which reads the slots in their own type (no cast kernel), and adds 1 to
    ``cohort_gather_scatter.launches``; a slot outside [0, S) makes that
    kernel trap."""
    _check(cache, slots, rows)
    if not cache.is_cuda:
        if cache.device.type == "cpu":
            return cohort_gather_scatter_ref(cache, slots, rows)
        raise ValueError(f"cohort_gather_scatter runs on cuda or cpu "
                         f"tensors, got {cache.device}")
    k = slots.shape[0]
    if k > _MAX_ROWS:
        raise ValueError(f"cohort_gather_scatter takes at most {_MAX_ROWS} "
                         f"slots, got {k}")
    lib = _LIB or _library()
    if not slots.is_contiguous():
        slots = slots.contiguous()
    dev = cache.get_device()
    if torch._C._cuda_getDevice() != dev:
        # a launch goes to the current device: make it the cache's (the
        # common single-device case never enters this context)
        with torch.cuda.device(dev):
            return cohort_gather_scatter(cache, slots, rows)
    d = cache.shape[1]
    out = cache.new_empty((k, d)) if rows is None else cache
    err = lib.cohort_gather_scatter_launch(_ARGS.pack(
        rows is not None, cache.data_ptr(), slots.data_ptr(),
        _SLOT_BYTES[slots.dtype], (out if rows is None else rows).data_ptr(),
        k, d * cache.element_size(), cache.shape[0], _RAW_STREAM(dev)))
    if err != 0:
        raise RuntimeError(
            f"cohort_gather_scatter launch failed: "
            f"{lib.cohort_gather_scatter_error_string(err).decode()}")
    cohort_gather_scatter.launches += 1
    return out


def vector_width(cache, rows) -> int:
    """The bytes per copy the kernel would use for these CUDA tensors: the
    widest of 16, 8, 4, 2, 1 dividing the row length and both pointers."""
    return _library().cohort_gather_scatter_width(
        cache.data_ptr(), rows.data_ptr(),
        cache.shape[1] * cache.element_size())


cohort_gather_scatter.launches = 0
