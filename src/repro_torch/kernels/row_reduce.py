"""Host side of the row-reduce kernels (``csrc/row_reduce.cuh``) that
``dp_clip_noise`` and ``quantize_decompress`` share: which instance a row
length gets, its geometry, and the one trimmed launch call.

Instances, by the row length N alone:

- ``"row_cta"`` (N <= 4,096): one CTA per row, the row in registers;
- ``"row_cluster"`` (N <= 262,144): one thread-block cluster of 2-16 CTAs
  per row, the row in shared memory, partials exchanged through
  distributed shared memory;
- ``"row_stream"`` (longer rows): two passes over a grid sized to the SM
  count, with an (R, ceil(N / 8,192)) f32 scratch of partials.

The first two are one launch a call and allocate nothing but the outputs.
Nothing here imports a CUDA library or builds a kernel.
"""
from __future__ import annotations

import struct

import torch

VARIANTS = ("row_cta", "row_cluster", "row_stream")
THREADS = 256                        # a CTA's threads (the header's kThreads)
CTA_MAX = 16 * THREADS               # row_cta: 16 elements a thread
CLUSTER_CTAS = 16                    # row_cluster: CTAs a cluster at most
SLICE_MAX = 16_384                   # row_cluster: elements a CTA, 64 KiB
CLUSTER_MAX = CLUSTER_CTAS * SLICE_MAX
CHUNK = 8192                         # row_stream: elements a partial
_MAX_GRID = 2**31 - 1                # CTAs a launch (grid.x)
# the C entry's one argument (rowred::Args): {variant, x, z, z row stride,
# sigma, param (double), y, aux, partial, rows, n, g0, g1, stream} (one
# packed argument costs ctypes less than fourteen typed ones)
_ARGS = struct.Struct("<5qd8q")
_RAW_STREAM = None                   # torch's current-stream handle getter


def variant(rows: int, n: int) -> str:
    """The instance for ``rows`` rows of ``n`` f32 elements: ``"row_cta"``
    up to 4,096, ``"row_cluster"`` up to 262,144, else ``"row_stream"``;
    empty shapes, and more rows than one launch's grid takes, raise
    ``ValueError``."""
    if rows < 1 or n < 1:
        raise ValueError(f"a row-reduce kernel takes a non-empty (R, N), got "
                         f"({rows}, {n})")
    if n <= CTA_MAX:
        name = "row_cta"
    elif n <= CLUSTER_MAX:
        name = "row_cluster"
    else:
        name = "row_stream"
    if rows * (cluster_shape(n)[0] if name == "row_cluster" else 1) > \
            _MAX_GRID:
        raise ValueError(f"a row-reduce kernel takes at most {_MAX_GRID} "
                         f"CTAs a launch; {rows} rows of {n} need more")
    return name


def cluster_shape(n: int) -> tuple[int, int]:
    """(CTAs a cluster, elements a CTA) of ``"row_cluster"`` for rows of
    ``n``: one CTA per 4,096 elements, 2 to 16 of them, each holding an
    equal share rounded up to a multiple of 4 (so every slice starts at
    the row's own 16-byte phase)."""
    ctas = min(CLUSTER_CTAS, max(2, -(-n // CTA_MAX)))
    per = -(-n // ctas)
    return ctas, per + (-per % 4)


def load(name: str):
    """Build (at first use) and load kernel ``name``'s library; ->
    ``(name, its launch entry, its error-string entry)``, the first
    argument of :func:`launch`."""
    import ctypes

    from repro_torch.kernels._build import load_library
    lib = load_library(name)
    entry, error_string = (getattr(lib, f"{name}_launch"),
                           getattr(lib, f"{name}_error_string"))
    entry.argtypes = [ctypes.c_char_p]
    entry.restype = ctypes.c_int
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return name, entry, error_string


def launch(kernel, x, z, z_stride: int, sigma, param: float):
    """One call of ``kernel`` (from :func:`load`) on the CUDA tensor ``x``
    (R, N) with second operand ``z`` (or ``None``) of row stride
    ``z_stride`` and per-row ``sigma`` (or ``None``). Returns ``(y, aux
    (R,), instance)``; a refused launch raises ``RuntimeError``."""
    global _RAW_STREAM
    dev = x.get_device()
    if torch._C._cuda_getDevice() != dev:
        # a launch goes to the current device: make it x's (the common
        # single-device case never enters this context)
        with torch.cuda.device(dev):
            return launch(kernel, x, z, z_stride, sigma, param)
    rows, n = x.shape
    name = variant(rows, n)
    g0 = g1 = partial = 0
    if name == "row_cluster":
        g0, g1 = cluster_shape(n)
    elif name == "row_stream":
        g0, g1 = CHUNK, -(-n // CHUNK)
        scratch = x.new_empty((rows * g1,))
        partial = scratch.data_ptr()
    y = torch.empty_like(x)
    aux = x.new_empty((rows,))
    if _RAW_STREAM is None:
        _RAW_STREAM = torch._C._cuda_getCurrentRawStream
    label, entry, error_string = kernel
    err = entry(_ARGS.pack(
        VARIANTS.index(name), x.data_ptr(),
        0 if z is None else z.data_ptr(), z_stride,
        0 if sigma is None else sigma.data_ptr(), param, y.data_ptr(),
        aux.data_ptr(), partial, rows, n, g0, g1, _RAW_STREAM(dev)))
    if err != 0:
        raise RuntimeError(f"{label} launch ({name}) failed: "
                           f"{error_string(err).decode()}")
    return y, aux, name
