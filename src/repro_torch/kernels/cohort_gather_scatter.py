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

import torch

from repro_torch.kernels.ref import cohort_gather_scatter_ref

_MAX_ROWS = 65535                    # the kernel's grid.y


def _check(cache, slots, rows):
    if cache.dim() != 2 or not cache.is_contiguous() or 0 in cache.shape:
        raise ValueError(f"cache must be a contiguous non-empty (S, D) "
                         f"tensor, got {tuple(cache.shape)}")
    if (slots.dim() != 1 or slots.dtype not in (torch.int32, torch.int64)
            or slots.shape[0] == 0 or slots.device != cache.device):
        raise ValueError(f"slots must be a non-empty (K,) int32 or int64 "
                         f"tensor on {cache.device}, got "
                         f"{tuple(slots.shape)} {slots.dtype} on "
                         f"{slots.device}")
    if rows is None:
        return
    want = (slots.shape[0], cache.shape[1])
    if (rows.dtype != cache.dtype or tuple(rows.shape) != want
            or not rows.is_contiguous() or rows.device != cache.device):
        raise ValueError(f"rows must be a contiguous {cache.dtype} tensor of "
                         f"shape {want} on {cache.device}, got "
                         f"{tuple(rows.shape)} {rows.dtype} on {rows.device}")


def _library():
    from repro_torch.kernels._build import load_library
    lib = load_library("cohort_gather_scatter")
    if lib.cohort_gather_launch.argtypes is None:
        args = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                + [ctypes.c_void_p])
        for fn in (lib.cohort_gather_launch, lib.cohort_scatter_launch):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.cohort_gather_scatter_width.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int64])
        lib.cohort_gather_scatter_width.restype = ctypes.c_int
        lib.cohort_gather_scatter_error_string.argtypes = [ctypes.c_int]
        lib.cohort_gather_scatter_error_string.restype = ctypes.c_char_p
    return lib


def cohort_gather_scatter(cache, slots, rows=None):
    """Gather (``rows=None``) or scatter rows of the (S, D) cohort cache.

    gather:  ``cohort_gather_scatter(cache, slots)`` -> new (K, D) rows
    scatter: ``cohort_gather_scatter(cache, slots, rows)`` writes ``rows``
             over the slot rows of ``cache`` in place and returns ``cache``

    ``cache`` is any dtype, ``slots`` (K,) int32 or int64 and unique (the
    cohort contract; the scatter has no write conflicts), ``rows`` (K, D)
    of the cache's dtype. On a CUDA tensor every call launches one kernel
    and adds 1 to ``cohort_gather_scatter.launches``; a slot outside
    [0, S) makes that kernel trap."""
    _check(cache, slots, rows)
    if cache.device.type == "cpu":
        return cohort_gather_scatter_ref(cache, slots, rows)
    if cache.device.type != "cuda":
        raise ValueError(f"cohort_gather_scatter runs on cuda or cpu "
                         f"tensors, got {cache.device}")
    k = slots.shape[0]
    if k > _MAX_ROWS:
        raise ValueError(f"cohort_gather_scatter takes at most {_MAX_ROWS} "
                         f"slots, got {k}")
    lib = _library()
    row_bytes = cache.shape[1] * cache.element_size()
    with torch.cuda.device(cache.device):
        slots = slots.to(torch.int64).contiguous()
        stream = torch.cuda.current_stream(cache.device).cuda_stream
        if rows is None:
            out = torch.empty((k, cache.shape[1]), dtype=cache.dtype,
                              device=cache.device)
            err = lib.cohort_gather_launch(
                cache.data_ptr(), slots.data_ptr(), out.data_ptr(), k,
                row_bytes, cache.shape[0], stream)
        else:
            out = cache
            err = lib.cohort_scatter_launch(
                cache.data_ptr(), slots.data_ptr(), rows.data_ptr(), k,
                row_bytes, cache.shape[0], stream)
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
