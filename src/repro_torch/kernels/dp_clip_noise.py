"""Wrapper of the hand-written CUDA ``dp_clip_noise`` kernel
(``csrc/dp_clip_noise.cu``), the port of the Pallas TPU kernel
``src/repro/kernels/dp_clip_noise.py: dp_clip_noise``.

The tensor's device decides the route: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.dp_clip_noise_ref`, and a ``meta`` tensor
gets outputs of the right shapes and dtypes and no arithmetic. Any other
device raises. Nothing falls back. Under :func:`repro_torch.utils.cost.cost_of`
a call counts as :func:`cost`, whatever implements it.

The library holds three instances, chosen by :func:`_variant` from the row
length alone (``kernels/row_reduce.py``): ``"row_cta"`` (N <= 4,096),
``"row_cluster"`` (N <= 262,144), both one launch a call that reads g from
HBM once, and ``"row_stream"`` (two passes). A refused launch raises.

The same library holds the split form for a model axis, where a client's
gradient lies over several ranks and its norm is a sum over them
(:mod:`repro_torch.core.clipping`): :func:`row_sumsq` (each row's sum of
squares) and :func:`clip_noise_apply` (the clip and noise from a given
norm), with an all-reduce between the two calls. Each has its own launch
counter and :func:`cost`, and routes by device as :func:`dp_clip_noise`
does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import row_reduce
from repro_torch.kernels.mamba2_ssd import _on
from repro_torch.kernels.ref import (
    clip_noise_apply_ref,
    dp_clip_noise_ref,
    row_sumsq_ref,
)
from repro_torch.kernels.row_reduce import variant as _variant  # noqa: F401
from repro_torch.utils.cost import counted

_KERNEL = None                       # (name, launch, error string), once built
_SPLIT = {}                          # the split form's C entries, once built


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
            or (n > 1 and noise.stride(1) != 1) or not _on(noise, g)):
        raise ValueError(f"noise must be a float32 tensor of g's shape "
                         f"{tuple(g.shape)} with contiguous rows on "
                         f"{g.device}, got {tuple(noise.shape)} "
                         f"{noise.dtype} on {noise.device}")
    if (sigma is None or sigma.dtype != torch.float32
            or sigma.shape != (rows,) or not sigma.is_contiguous()
            or not _on(sigma, g)):
        raise ValueError(f"sigma must be a contiguous ({rows},) float32 "
                         f"tensor on {g.device}")


def cost(rows: int, n: int, with_noise: bool = True) -> tuple[int, int]:
    """(flops, bytes) of one call on (rows, n), f32. Bytes: g (and noise,
    sigma) read once, y and norm written once. Operations: per element a
    square-and-add (2), the scale (1) and, with noise, a multiply-add
    (2)."""
    nbytes = 4 * (rows * n * (3 if with_noise else 2)
                  + rows * (2 if with_noise else 1))
    return rows * n * (5 if with_noise else 3), nbytes


def dp_clip_noise(g, noise, clip_norm: float, sigma):
    """Row-batched clip + noise; see ``dp_clip_noise_ref`` for the math.

    g (R, N) f32 contiguous, noise (R, N) f32 with contiguous rows (a row
    stride is allowed) or ``None`` (clip only),
    sigma (R,) f32 (unused without noise). Returns ``(y (R, N), norm (R,))``.
    On a CUDA tensor every call runs the instance :func:`_variant` names
    on the current stream, adds 1 to ``dp_clip_noise.launches`` (one per
    call, whatever the instance launches) and sets
    ``dp_clip_noise.last_variant``. On a ``meta`` tensor it returns empty
    outputs and runs nothing."""
    _check(g, noise, sigma)
    return counted("dp_clip_noise",
                   lambda: cost(*g.shape, with_noise=noise is not None),
                   lambda: _run(g, noise, clip_norm, sigma))


def _run(g, noise, clip_norm, sigma):
    global _KERNEL
    if not g.is_cuda:
        if g.device.type == "cpu":
            return dp_clip_noise_ref(g, noise, clip_norm, sigma)
        if g.device.type == "meta":
            return torch.empty_like(g), g.new_empty(g.shape[:1])
        raise ValueError(f"dp_clip_noise runs on cuda, cpu or meta tensors, "
                         f"got {g.device}")
    if _KERNEL is None:
        _KERNEL = row_reduce.load("dp_clip_noise")
    y, norm, variant = row_reduce.launch(
        _KERNEL, g, noise, 0 if noise is None else noise.stride(0),
        None if noise is None else sigma, float(clip_norm))
    dp_clip_noise.launches += 1
    dp_clip_noise.last_variant = variant
    return y, norm


dp_clip_noise.launches = 0
dp_clip_noise.last_variant = None


# -- the split form (a model axis) -------------------------------------------

def row_sumsq_cost(rows: int, n: int) -> tuple[int, int]:
    """(flops, bytes) of one :func:`row_sumsq` call on (rows, n) f32: a
    square-and-add an element; x read once, the sums written once."""
    return 2 * rows * n, 4 * (rows * n + rows)


def clip_noise_apply_cost(rows: int, n: int,
                          with_noise: bool = True) -> tuple[int, int]:
    """(flops, bytes) of one :func:`clip_noise_apply` call on (rows, n)
    f32: the scale and, with noise, a multiply-add an element (3 flops);
    x (and noise) read once, the norms read once, y written once."""
    return 3 * rows * n, 4 * ((3 if with_noise else 2) * rows * n + rows)


def _split_entry(name: str):
    """The C entry ``name`` of the dp_clip_noise library (built at first
    use) and its error-string entry."""
    if name not in _SPLIT:
        import ctypes

        from repro_torch.kernels._build import load_library
        lib = load_library("dp_clip_noise")
        entry = getattr(lib, f"{name}_launch")
        entry.argtypes = [ctypes.c_char_p]
        entry.restype = ctypes.c_int
        err = lib.dp_clip_noise_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _SPLIT[name] = (entry, err)
    return _SPLIT[name]


def _split_launch(name, x, x_stride, z, z_stride, sigma, param, y, aux,
                  partial, chunks):
    dev = x.get_device()
    if torch._C._cuda_getDevice() != dev:
        with torch.cuda.device(dev):
            return _split_launch(name, x, x_stride, z, z_stride, sigma,
                                 param, y, aux, partial, chunks)
    entry, error_string = _split_entry(name)
    rows, n = x.shape
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    err = entry(row_reduce._ARGS.pack(
        0, x.data_ptr(), ptr(z), z_stride if z is not None else x_stride,
        ptr(sigma), float(param), ptr(y), aux.data_ptr(), ptr(partial), rows,
        n, row_reduce.CHUNK, chunks,
        torch._C._cuda_getCurrentRawStream(dev)))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{error_string(err).decode()}")


def _check_rows(x, what: str, contiguous: bool):
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] == 0
            or x.shape[1] == 0 or (x.shape[1] > 1 and x.stride(1) != 1)
            or (contiguous and not x.is_contiguous())):
        raise ValueError(f"{what} must be a non-empty (R, N) float32 tensor "
                         f"with {'contiguous' if contiguous else 'unit-stride'}"
                         f" rows, got {tuple(x.shape)} {x.dtype}")


def row_sumsq(x):
    """Each row's sum of squares, ``(R,)`` f32, of ``x`` (R, N) f32 whose
    rows have unit stride (a row stride is allowed, so the leading columns
    of a wider buffer need no copy). On a CUDA tensor one call launches the
    kernel (two launches when a row spans more than one 8,192-element
    chunk) and adds 1 to ``row_sumsq.launches``; on the CPU the plain
    version; on ``meta`` an empty output."""
    _check_rows(x, "x", contiguous=False)
    return counted("row_sumsq",
                   lambda: row_sumsq_cost(*x.shape),
                   lambda: _run_sumsq(x))


def _run_sumsq(x):
    if not x.is_cuda:
        if x.device.type == "cpu":
            return row_sumsq_ref(x)
        if x.device.type == "meta":
            return x.new_empty(x.shape[:1])
        raise ValueError(f"row_sumsq runs on cuda, cpu or meta tensors, "
                         f"got {x.device}")
    rows, n = x.shape
    chunks = -(-n // row_reduce.CHUNK)
    out = x.new_empty((rows,))
    partial = out if chunks == 1 else x.new_empty((rows * chunks,))
    _split_launch("row_sumsq", x, x.stride(0), None, 0, None, 0.0, None,
                  out, partial, chunks)
    row_sumsq.launches += 1
    return out


def clip_noise_apply(x, noise, norm, clip_norm: float, sigma):
    """``y = x * min(1, C / max(norm, 1e-12)) + sigma * noise`` row by row
    (``noise=None``: the clip only), ``x`` (R, N) f32 contiguous, ``noise``
    (R, N) f32 with unit-stride rows (a row stride is allowed), ``norm``
    and ``sigma`` (R,) f32. Returns ``y`` (R, N). On a CUDA tensor one
    launch, counted in ``clip_noise_apply.launches``; on the CPU the plain
    version; on ``meta`` an empty output."""
    _check_rows(x, "x", contiguous=True)
    rows = x.shape[0]
    vecs = (norm,) if noise is None else (norm, sigma)
    if noise is not None:
        _check_rows(noise, "noise", contiguous=False)
        if noise.shape != x.shape or not _on(noise, x):
            raise ValueError(f"noise must have x's shape {tuple(x.shape)} "
                             f"on {x.device}, got {tuple(noise.shape)} on "
                             f"{noise.device}")
    for v in vecs:
        if (v is None or v.dtype != torch.float32 or v.shape != (rows,)
                or not v.is_contiguous() or not _on(v, x)):
            raise ValueError(f"norm and sigma must be contiguous ({rows},) "
                             f"float32 tensors on {x.device}")
    return counted("clip_noise_apply",
                   lambda: clip_noise_apply_cost(*x.shape,
                                                  noise is not None),
                   lambda: _run_apply(x, noise, norm, clip_norm, sigma))


def _run_apply(x, noise, norm, clip_norm, sigma):
    if not x.is_cuda:
        if x.device.type == "cpu":
            return clip_noise_apply_ref(x, noise, norm, clip_norm, sigma)
        if x.device.type == "meta":
            return torch.empty_like(x)
        raise ValueError(f"clip_noise_apply runs on cuda, cpu or meta "
                         f"tensors, got {x.device}")
    y = torch.empty_like(x)
    _split_launch("clip_noise_apply", x, x.shape[1], noise,
                  0 if noise is None else noise.stride(0),
                  None if noise is None else sigma, clip_norm, y, norm, None,
                  -(-x.shape[1] // row_reduce.CHUNK))
    clip_noise_apply.launches += 1
    return y


row_sumsq.launches = 0
clip_noise_apply.launches = 0
