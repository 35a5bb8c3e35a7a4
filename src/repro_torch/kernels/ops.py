"""Tree-level wrappers over the port's kernels.

``backend`` is ``"auto"`` (the hand-written kernel for CUDA tensors, its
plain version for CPU tensors; the tensor's device decides) or ``"ref"``
(always the plain version, for parity checks on the card).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dp_clip_noise import dp_clip_noise
from repro_torch.kernels.quantize_decompress import quantize_decompress
from repro_torch.kernels.ref import dp_clip_noise_ref, quantize_decompress_ref
from repro_torch.utils.tree import tree_flatten, tree_unflatten

KERNEL_BACKENDS = ("auto", "ref")


def validate_backend(backend: str) -> None:
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"kernel_backend must be one of {KERNEL_BACKENDS}, "
                         f"got {backend!r}")


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
    flat = torch.cat([x.reshape(rows, -1).to(torch.float32) for x in leaves],
                     dim=1)
    if noise is not None:
        sigma = torch.as_tensor(sigma, dtype=torch.float32,
                                device=flat.device)
        sigma = sigma.expand(rows).contiguous()
    else:
        sigma = None
    kernel = dp_clip_noise_ref if backend == "ref" else dp_clip_noise
    out, norm = kernel(flat, noise, clip_norm, sigma)
    news = []
    off = 0
    for x in leaves:
        n = x[0].numel()
        news.append(out[:, off:off + n].reshape(x.shape).to(x.dtype))
        off += n
    return tree_unflatten(treedef, news), norm


def quantize_decompress_rows(x, u, bits: int, backend: str = "auto"):
    """QSGD quantize -> dequantize of every row of ``x`` (R, D) f32 in one
    kernel call, ``u`` (R, D) ~ U[0, 1) the stochastic-rounding operand.
    Returns ``(y (R, D), scale (R,))``."""
    validate_backend(backend)
    kernel = quantize_decompress_ref if backend == "ref" else \
        quantize_decompress
    return kernel(x, u, bits)
