"""The routed entry points of the port's kernels, and tree-level wrappers.

``backend`` is ``"auto"`` (the hand-written kernel for CUDA tensors, its
plain version for CPU tensors; the tensor's device decides) or ``"ref"``
(always the plain version, for parity checks on the card). The model stack
calls the kernels only through this module (``ops.flash_attention``,
``ops.rwkv6_scan``, ``ops.mamba2_ssd``), so a test can count its calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cohort_gather_scatter import cohort_gather_scatter
from repro_torch.kernels.counter_rng import counter_rng
from repro_torch.kernels.dp_clip_noise import (
    clip_noise_apply,
    dp_clip_noise,
    row_sumsq,
)
from repro_torch.kernels.flash_attention import (
    flash_attention as flash_attention_kernel,
)
from repro_torch.kernels.mamba2_ssd import mamba2_ssd as mamba2_ssd_kernel
from repro_torch.kernels.quantize_decompress import quantize_decompress
from repro_torch.kernels.ref import (
    clip_noise_apply_ref,
    cohort_gather_scatter_ref,
    dp_clip_noise_ref,
    flash_attention_ref,
    mamba2_ssd_ref,
    quantize_decompress_ref,
    row_sumsq_ref,
    rwkv6_scan_ref,
)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rwkv6_scan_kernel
from repro_torch.utils.device import device_constant
from repro_torch.utils.tree import tree_flatten, tree_unflatten

KERNEL_BACKENDS = ("auto", "ref")


def counter_draw(key, rows: tuple, table: tuple, tau: int, n: int,
                 purpose: int, normal: bool, device):
    """One ``counter_rng`` draw on ``device``: the (len(rows), tau, n) f32
    values of stream ``key`` and ``purpose`` at the global row ids
    ``rows`` and the local columns that ``table`` maps
    (:func:`repro_torch.kernels.counter_rng.whole_table` / ``slab_table``).
    The row ids and the table go to the device once
    (:func:`repro_torch.utils.device.device_constant`)."""
    return counter_rng(device_constant(rows, device),
                       device_constant(table, device), tau, n, key, purpose,
                       normal)


def validate_backend(backend: str) -> None:
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"kernel_backend must be one of {KERNEL_BACKENDS}, "
                         f"got {backend!r}")


def flatten_rows(leaves):
    """The leaves (each with a leading row axis R) laid end to end in one
    (R, N) f32 buffer, by one ``torch.cat`` into it: f32 leaves in one
    copy kernel, other dtypes each cast straight into their slice, so no
    f32 copy of the tree is made beside the buffer (10 GB at two clients of
    a 1.24 B-param bf16 model)."""
    rows = leaves[0].shape[0]
    flat = torch.empty((rows, sum(x[0].numel() for x in leaves)),
                       dtype=torch.float32, device=leaves[0].device)
    return torch.cat([x.reshape(rows, -1) for x in leaves], dim=1, out=flat)


def unflatten_rows(flat, leaves):
    """:func:`flatten_rows` undone: each leaf's (R, n) slice of ``flat``
    back in the leaf's shape and dtype. The strided slice is cast first,
    one pass into a contiguous leaf (a reshape first would copy the f32
    slice as well)."""
    news = []
    off = 0
    for x in leaves:
        n = x[0].numel()
        news.append(flat[:, off:off + n].to(x.dtype).reshape(x.shape))
        off += n
    return news


def dp_clip_noise_tree(grads, noise, clip_norm, sigma, backend: str = "auto"):
    """Clip + noise of a row-batched gradient tree in one kernel call.

    Every leaf carries a leading row axis R (clients, or client
    microbatches). The leaves are laid end to end, in ``jax.tree.flatten``
    order, into one (R, N) f32 buffer, so each row's norm covers its whole
    tree; the kernel runs once for all R rows, and each leaf gets its shape
    and dtype back. ``noise`` is an operand, (R, N) f32, or ``None`` for the
    clip-only variant; ``sigma`` is a float or an (R,) tensor (unused
    without noise). Returns ``(tree, norm (R,))``."""
    validate_backend(backend)
    leaves, treedef = tree_flatten(grads)
    rows = leaves[0].shape[0]
    flat = flatten_rows(leaves)
    if noise is not None:
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=flat.device)
        sigma = sigma.expand(rows).contiguous()
    else:
        sigma = None
    kernel = dp_clip_noise_ref if backend == "ref" else dp_clip_noise
    out, norm = kernel(flat, noise, clip_norm, sigma)
    return tree_unflatten(treedef, unflatten_rows(out, leaves)), norm


def split_order(dims) -> list[int]:
    """The order of a split gradient's leaves in its flat (R, N_local)
    buffer: the leaves split over the model axis (``dims`` >= 0, in
    ``jax.tree.flatten`` order), then the whole ones. ``dims`` is the
    per-leaf split-dim list (:func:`repro_torch.models.sharding
    .param_split_dims`, flattened)."""
    return ([i for i, d in enumerate(dims) if d >= 0]
            + [i for i, d in enumerate(dims) if d < 0])


def split_row_sq_norm(flat, n_split: int, group, backend: str = "auto"):
    """Each row's squared norm of a gradient split over ``group``'s ranks:
    the sum of squares of the split leaves' columns (``flat[:, :n_split]``)
    all-reduced over the group, plus the whole leaves' (the other columns,
    alike on every rank) counted once: model rank 0 sums all its columns,
    the others their split columns only, in one ``row_sumsq`` call each."""
    part = flat if group.index == 0 else flat[:, :n_split]
    if part.shape[1] == 0:
        s = flat.new_zeros(flat.shape[:1])
    else:
        s = (row_sumsq_ref if backend == "ref" else row_sumsq)(part)
    return group.all_sum(s)


def dp_clip_noise_split_tree(grads, noise, clip_norm, sigma, dims, group,
                             backend: str = "auto"):
    """:func:`dp_clip_noise_tree` for a gradient whose leaves are split
    over the model ``group`` (``dims``: each leaf's split dim, -1 whole).
    The leaves go into one (R, N_local) f32 buffer in :func:`split_order`;
    the row norm is the whole gradient's (:func:`split_row_sq_norm`, then
    the square root) and ``clip_noise_apply`` clips and adds ``noise``,
    whose columns come in the same order (``None``: clip only). Two kernel
    calls, an all-reduce between them. Returns ``(tree, norm (R,))``, the
    norm the same on every rank."""
    validate_backend(backend)
    leaves, treedef = tree_flatten(grads)
    order = split_order(dims)
    ordered = [leaves[i] for i in order]
    flat = flatten_rows(ordered)
    n_split = sum(leaves[i][0].numel() for i in order if dims[i] >= 0)
    norm = torch.sqrt(split_row_sq_norm(flat, n_split, group, backend))
    if noise is not None:
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=flat.device)
        sigma = sigma.expand(flat.shape[0]).contiguous()
    apply = clip_noise_apply_ref if backend == "ref" else clip_noise_apply
    out = apply(flat, noise, norm, clip_norm, sigma)
    news = [None] * len(leaves)
    for i, x in zip(order, unflatten_rows(out, ordered)):
        news[i] = x
    return tree_unflatten(treedef, news), norm


def quantize_decompress_rows(x, u, bits: int, backend: str = "auto"):
    """QSGD quantize -> dequantize of every row of ``x`` (R, D) f32 in one
    kernel call, ``u`` (R, D) ~ U[0, 1) the stochastic-rounding operand.
    Returns ``(y (R, D), scale (R,))``."""
    validate_backend(backend)
    kernel = quantize_decompress_ref if backend == "ref" else \
        quantize_decompress
    return kernel(x, u, bits)


def cohort_gather(cache, slots, backend: str = "auto"):
    """The cohort's (K, D) rows out of the (S, D) resident cache, as a new
    tensor (a copy: later scatters into the cache leave it alone)."""
    validate_backend(backend)
    kernel = cohort_gather_scatter_ref if backend == "ref" else \
        cohort_gather_scatter
    return kernel(cache, slots)


def cohort_scatter(cache, slots, rows, backend: str = "auto"):
    """Write the cohort's updated (K, D) rows into the (S, D) resident
    cache, in place; returns the cache."""
    validate_backend(backend)
    kernel = cohort_gather_scatter_ref if backend == "ref" else \
        cohort_gather_scatter
    return kernel(cache, slots, rows)


def flash_attention(q, k, v, *, window: int = 0, backend: str = "auto"):
    """Causal (sliding-window when ``window`` > 0) attention of q / k / v
    (B, H, S, hd), GQA already expanded. Returns (B, H, S, hd)."""
    validate_backend(backend)
    if backend == "ref":
        return flash_attention_ref(q, k, v, window=window)
    return flash_attention_kernel(q, k, v, window=window)


def rwkv6_scan(r, k, v, w, u, s0=None, backend: str = "auto"):
    """The WKV6 recurrence over r / k / v / w (B, H, S, hd) from ``s0``
    (B, H, hd, hd) or zeros. Returns ``(y, final state)``."""
    validate_backend(backend)
    if backend == "ref":
        return rwkv6_scan_ref(r, k, v, w, u, s0)
    return rwkv6_scan_kernel(r, k, v, w, u, s0)


def mamba2_ssd(x, dt, a, b_in, c_in, *, chunk: int = 128,
               backend: str = "auto"):
    """Mamba2's SSD chunk scan of x (B, S, H, P) from a zero state, chunk
    ``min(chunk, S)``. Returns ``(y (B, S, H, P), final state (B, H, P,
    N))``."""
    validate_backend(backend)
    if backend == "ref":
        return mamba2_ssd_ref(x, dt, a, b_in, c_in, min(chunk, x.shape[1]))
    return mamba2_ssd_kernel(x, dt, a, b_in, c_in, chunk=chunk)
