"""Sensitivity enforcement + Gaussian mechanism for DP-PASGD (paper Eq. 7a).

Gradients are clipped to norm G so that the stochastic-gradient sensitivity
is 2G/X_m (§5.2). Three granularities:

  num_microbatches == batch    -> per-example clipping (DP-SGD style)
  1 < num_microbatches < batch -> per-microbatch clipping
  num_microbatches == 1        -> flat clipping of the mean gradient

after which Gaussian noise b ~ N(0, sigma^2 I_d) is added to the averaged
gradient, exactly Eq. (7a).

Every function here works on a block of C clients at once: params and batch
leaves carry a leading client axis, ``noise`` is the (C, N) standard-normal
operand (N = parameters per client, leaves laid end to end in
``jax.tree.flatten`` order) and ``sigma`` the (C,) noise stds. The clip (and
the flat path's noise) runs through the ``dp_clip_noise`` kernel in one call
for all rows.

Under a model axis over 1 (the ``mesh_2d`` engine at ``dm > 1``) each
rank holds its slices of the split leaves and the whole other leaves, and
the clip norm is still the norm of the whole per-client gradient: the
split leaves' squares summed over the model ranks plus the whole leaves'
counted once (:func:`repro_torch.kernels.ops.dp_clip_noise_split_tree`:
``row_sumsq``, an all-reduce, then ``clip_noise_apply``). The noise
operand then holds this rank's columns of the flat draw, split leaves
first (:func:`repro_torch.kernels.ops.split_order`).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch.kernels.ops import (
    dp_clip_noise_split_tree,
    dp_clip_noise_tree,
    split_order,
    validate_backend,
)
from repro_torch.models.sharding import model_group, model_placement
from repro_torch.utils.tree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_sq_norm,
    tree_unflatten,
)


def clip_tree(grads, clip_norm: float):
    """Scale one gradient pytree so its global L2 norm is <= clip_norm.
    Preserves each leaf's dtype (the scale is an f32 scalar)."""
    norm = torch.sqrt(tree_sq_norm(grads))
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    clipped = tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                       grads)
    return clipped, norm


def _add_noise(tree, noise, sigma, order=None):
    """x + sigma * noise per leaf, each leaf reading its slice of the flat
    (C, N) noise, the leaves taken in ``order`` (default: tree order);
    dtypes are kept (the legacy per-leaf mechanism)."""
    leaves, treedef = tree_flatten(tree)
    news = [None] * len(leaves)
    off = 0
    for i in (range(len(leaves)) if order is None else order):
        x = leaves[i]
        n = x[0].numel()
        s = sigma.reshape((-1,) + (1,) * (x.dim() - 1))
        nz = noise[:, off:off + n].reshape(x.shape)
        news[i] = (x.to(torch.float32) + s * nz).to(x.dtype)
        off += n
    return tree_unflatten(treedef, news)


def _model_split():
    """(group, per-leaf split dims) under a model axis over 1, else
    ``None``."""
    group = model_group()
    if group is None:
        return None
    return group, tree_leaves(model_placement())


def make_dp_grad_fn(
    loss_fn: Callable,
    clip_norm: float,
    num_microbatches: int = 1,
    vmap_microbatches: bool = True,
    accumulate: str = "stack",
    kernel_backend: str = "auto",
) -> Callable:
    """Build dp_grad(params, batch, noise, sigma) -> (noisy_grad, metrics)
    for a block of clients; metrics are (C,) tensors.

    ``loss_fn(params, batch)`` returns the mean loss over the leading batch
    axis of one client's batch.

    Flat clipping (``num_microbatches == 1``) is one kernel call: norm,
    clip and noise for all C rows. The microbatch paths clip each microbatch
    with the kernel's clip-only variant and add the noise once, to the
    averaged gradient. ``vmap_microbatches`` clips all C x M microbatches in
    one call; otherwise the microbatches run one after another, averaged
    from a stack (``accumulate="stack"``) or a running f32 sum
    (``"scan"``)."""
    validate_backend(kernel_backend)
    vg_fn = vmap(grad_and_value(loss_fn))

    def _clip_noise(g, noise, sigma):
        split = _model_split()
        if split is None:
            return dp_clip_noise_tree(g, noise, clip_norm, sigma,
                                      backend=kernel_backend)
        return dp_clip_noise_split_tree(g, noise, clip_norm, sigma,
                                        split[1], split[0],
                                        backend=kernel_backend)

    def _clip(g):
        return _clip_noise(g, None, None)

    def dp_grad(params, batch, noise, sigma):
        if num_microbatches == 1:
            g, loss = vg_fn(params, batch)
            noisy, pre_norm = _clip_noise(g, noise, sigma)
            return noisy, {"loss": loss, "grad_norm_preclip": pre_norm}

        m = num_microbatches

        def _split(x):
            c, b = x.shape[:2]
            if b % m:
                raise ValueError(f"batch {b} not divisible by microbatches {m}")
            return x.reshape((c, m, b // m) + tuple(x.shape[2:]))

        mbs = tree_map(_split, batch)
        first = tree_leaves(mbs)[0]
        c = first.shape[0]
        if vmap_microbatches:
            g, losses = vmap(vmap(grad_and_value(loss_fn), in_dims=(None, 0))
                             )(params, mbs)
            rows = tree_map(lambda x: x.reshape((c * m,) + x.shape[2:]), g)
            clipped_rows, norms = _clip(rows)
            clipped = tree_map(
                lambda x: torch.mean(x.reshape((c, m) + x.shape[1:]), dim=1),
                clipped_rows)
            loss = torch.mean(losses, dim=1)
            pre_norm = torch.mean(norms.reshape(c, m), dim=1)
        elif accumulate == "scan":
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            loss = torch.zeros((c,), dtype=torch.float32, device=first.device)
            pre_norm = torch.zeros_like(loss)
            for i in range(m):
                g, l_i = vg_fn(params, tree_map(lambda x: x[:, i], mbs))
                c_i, n_i = _clip(g)
                acc = tree_map(lambda a, x: a + x.to(torch.float32), acc, c_i)
                loss = loss + l_i
                pre_norm = pre_norm + n_i
            clipped = tree_map(lambda a, p: (a / m).to(p.dtype), acc, params)
            loss = loss / m
            pre_norm = pre_norm / m
        else:
            outs = []
            for i in range(m):
                g, l_i = vg_fn(params, tree_map(lambda x: x[:, i], mbs))
                outs.append((*_clip(g), l_i))
            clipped = tree_map(lambda *xs: torch.mean(torch.stack(xs, 1), 1),
                               *[o[0] for o in outs])
            pre_norm = torch.mean(torch.stack([o[1] for o in outs], 1), 1)
            loss = torch.mean(torch.stack([o[2] for o in outs], 1), 1)
        split = _model_split()
        noisy = _add_noise(clipped, noise, sigma,
                           None if split is None else split_order(split[1]))
        return noisy, {"loss": loss, "grad_norm_preclip": pre_norm}

    return dp_grad


def make_plain_grad_fn(loss_fn: Callable) -> Callable:
    """Non-private gradient with the same signature (noise, sigma ignored)."""
    vg_fn = vmap(grad_and_value(loss_fn))

    def plain_grad(params, batch, noise, sigma):
        del noise, sigma
        g, loss = vg_fn(params, batch)
        split = _model_split()
        if split is None:
            sq = vmap(tree_sq_norm)(g)
        else:
            # the whole gradient's norm: split leaves summed over the
            # model ranks, whole leaves (alike on every rank) once
            group, dims = split
            leaves = tree_leaves(g)
            sq = group.all_sum(sum(
                (torch.sum(torch.square(x.reshape(x.shape[0], -1).to(
                    torch.float32)), dim=1)
                 for x, d in zip(leaves, dims) if d >= 0 or group.index == 0),
                torch.zeros(leaves[0].shape[:1], device=leaves[0].device)))
        return g, {"loss": loss, "grad_norm_preclip": torch.sqrt(sq)}

    return plain_grad
