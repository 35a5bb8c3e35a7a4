"""DP-PASGD round engine (paper Eq. 7a–7b).

One *round* = tau local noisy-SGD steps on each of C clients (no
cross-client communication) followed by one global model average over the
client axis (Eq. 7b). Params and optimizer state carry a leading client
axis C on every leaf.

The client axis is an explicit batch dimension, and the tau steps are a
loop outside it: each step computes every client's gradient at once
(``torch.func.vmap``), makes **one** ``dp_clip_noise`` kernel call on the
(C, N) gradient block, and applies the optimizer to the C-stacked state.
(The JAX package vmaps a whole local round per client instead; a kernel
launched through ctypes has no vmap batching rule.) The ``map`` engine
(``vmap_clients=False``) runs the same code one client at a time, so each of
its kernel calls has one row.

Randomness enters as an operand: a round takes ``noise`` (C, tau, N)
standard normals, drawn by :func:`draw_round_noise` from the federation's
generator state. N is the number of parameters per client, leaves laid end
to end in ``jax.tree.flatten`` order. A round with an aggregation pipeline
(:mod:`repro_torch.core.aggregation`) also takes the participation ``mask``
and the compressor's ``agg_rand``, drawn by :func:`draw_pipeline_round`;
a buffered-async dispatch draws its block's with :func:`draw_dispatch`.

New code should go through :mod:`repro_torch.api`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.aggregation import participation_mask
from repro_torch.core.clipping import make_dp_grad_fn, make_plain_grad_fn
from repro_torch.core.privacy import sigma_star
from repro_torch.kernels.ops import cohort_gather, cohort_scatter
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.tree import (
    tree_add,
    tree_broadcast_axis0,
    tree_leaves,
    tree_map,
    tree_mean_over_axis0,
)

TOPOLOGIES = ("full_average", "local_only")


@dataclass(frozen=True)
class FLConfig:
    """Configuration of one DP-PASGD federation."""
    n_clients: int
    tau: int                      # global aggregation period (local steps/round)
    clip_norm: float = 1.0        # G (sensitivity bound)
    dp: bool = True               # False -> PASGD (no noise, no clipping)
    num_microbatches: int = 1     # see clipping.py; =local batch -> per-example
    vmap_microbatches: bool = True
    grad_accumulate: str = "stack"  # "stack" | "scan"
    average_opt_state: bool = True  # average optimizer state with the models
    vmap_clients: bool = True     # False -> one client at a time ("map")
    kernel_backend: str = "auto"  # "auto" (the kernel on CUDA tensors) | "ref"


def make_grad_fn(loss_fn: Callable, cfg: FLConfig) -> Callable:
    """The per-step gradient: DP (clip + noise, Eq. 7a) or plain."""
    if cfg.dp:
        return make_dp_grad_fn(loss_fn, cfg.clip_norm, cfg.num_microbatches,
                               cfg.vmap_microbatches, cfg.grad_accumulate,
                               kernel_backend=cfg.kernel_backend)
    return make_plain_grad_fn(loss_fn)


def make_local_round(grad_fn: Callable, optimizer: Optimizer, tau: int):
    """tau local DP-SGD steps of a block of clients (Eq. 7a). No collectives.

    Returns ``local_round(params, opt_state, batches, noise, sigmas)`` ->
    ``(params, opt_state, metrics)``; batch leaves are (C, tau, B, ...),
    ``noise`` is (C, tau, N) (or ``None`` for a plain gradient), metrics are
    (C,) means over the tau steps."""
    update = vmap(optimizer.update)

    def local_round(params, opt_state, batches, noise, sigmas):
        steps = []
        for t in range(tau):
            mb = tree_map(lambda x: x[:, t], batches)
            g, metrics = grad_fn(params, mb,
                                 None if noise is None else noise[:, t],
                                 sigmas)
            upd, opt_state = update(g, opt_state, params)
            params = tree_add(params, upd)
            steps.append(metrics)
        ms = {k: torch.mean(torch.stack([m[k] for m in steps]), dim=0)
              for k in steps[0]}
        return params, opt_state, ms

    return local_round


def make_round_step(loss_fn: Callable, optimizer: Optimizer, cfg: FLConfig,
                    topology: str = "full_average", pipeline=None):
    """Build ``round_step(params, opt_state, batch, noise, sigmas)``.

    params/opt_state : pytrees with leading client axis C on every leaf
    batch            : pytree with leading axes (C, tau, local_batch, ...)
    noise            : (C, tau, N) f32 standard normals
    sigmas           : (C,) f32 per-client per-step noise std (Eq. 23)
    topology         : "full_average" (Eq. 7b averaging each round) or
                       "local_only" (ablation: no communication ever)
    pipeline         : optional :class:`repro_torch.core.aggregation
                       .AggregationPipeline`. ``None`` keeps the dense
                       all-clients protocol; with a pipeline the function is
                       ``round_step(params, opt_state, batch, noise, sigmas,
                       mask, residual, agg_rand) -> (new_params,
                       new_opt_state, new_residual, metrics)``, ``mask``
                       the 0/1 (C,) participation mask and ``agg_rand`` the
                       compressor's random operand
    returns          : (new_params, new_opt_state, metrics)
    """
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}, "
                         f"got {topology!r}")
    if pipeline is not None and topology != "full_average":
        raise ValueError("the aggregation pipeline requires "
                         "topology='full_average'")
    local_round = make_local_round(make_grad_fn(loss_fn, cfg), optimizer,
                                   cfg.tau)

    def _local_rounds(params, opt_state, batch, noise, sigmas):
        if cfg.vmap_clients:
            return local_round(params, opt_state, batch, noise, sigmas)
        outs = [local_round(*tree_map(lambda x: x[c:c + 1],
                                      (params, opt_state, batch, noise,
                                       sigmas)))
                for c in range(cfg.n_clients)]
        return tree_map(lambda *xs: torch.cat(xs), *outs)

    def round_step(params, opt_state, batch, noise, sigmas):
        new_p, new_s, ms = _local_rounds(params, opt_state, batch, noise,
                                         sigmas)
        if topology == "full_average":
            # ---- Eq. (7b): periodic global averaging ----------------------
            new_p = tree_broadcast_axis0(tree_mean_over_axis0(new_p),
                                         cfg.n_clients)
            if cfg.average_opt_state:
                # keep_dtype: int leaves (step counters) stay int
                new_s = tree_broadcast_axis0(
                    tree_mean_over_axis0(new_s, keep_dtype=True),
                    cfg.n_clients)
        return new_p, new_s, {k: torch.mean(v) for k, v in ms.items()}

    def round_step_pipeline(params, opt_state, batch, noise, sigmas, mask,
                            residual, agg_rand):
        new_p, new_s, ms = _local_rounds(params, opt_state, batch, noise,
                                         sigmas)
        new_p, new_s, residual = pipeline.aggregate(
            params, new_p, new_s, opt_state, residual, mask, agg_rand)
        return new_p, new_s, residual, pipeline.masked_metrics(ms, mask)

    return round_step if pipeline is None else round_step_pipeline


def _n_params(params) -> int:
    return sum(x[0].numel() for x in tree_leaves(params))


def draw_round_noise(key, params, tau: int):
    """One round's (C, tau, N) f32 standard normals, in one ``torch.randn``
    call on the params' device, from the generator state ``key``.
    Returns ``(noise, next_key)``."""
    leaves = tree_leaves(params)
    gen = torch.Generator(device=leaves[0].device)
    gen.set_state(key)
    noise = torch.randn((leaves[0].shape[0], tau, _n_params(params)),
                        generator=gen, dtype=torch.float32,
                        device=leaves[0].device)
    return noise, gen.get_state()


def draw_pipeline_round(key, params, tau: int, pipeline):
    """The randomness of one pipeline round from the generator state
    ``key``, drawn on the params' device in this order: the participation
    mask (:func:`~repro_torch.core.aggregation.participation_mask`), the
    (C, tau, N) noise, then the compressor's ``agg_rand`` (``None`` without
    one). Under secure aggregation the (C, C, N) pair masks are drawn last
    and ride in ``agg_rand`` as ``(agg_rand, pair_masks)``; ``next_key`` is
    the state before them, so a secure spec draws every mask, noise and
    ``agg_rand`` the same spec without it draws, as in the JAX package. The
    pair masks thus reuse the stream the next round's draws start from;
    they cancel exactly, so no result depends on their values. Nothing
    comes to the host. Returns ``(mask, noise, agg_rand, next_key)``."""
    leaves = tree_leaves(params)
    dev, n_clients, n = leaves[0].device, leaves[0].shape[0], _n_params(params)
    gen = torch.Generator(device=dev)
    gen.set_state(key)
    mask = participation_mask(gen, n_clients, pipeline.n_participants, dev)
    noise = torch.randn((n_clients, tau, n), generator=gen,
                        dtype=torch.float32, device=dev)
    agg_rand = (None if pipeline.compressor is None
                else pipeline.compressor.draw(gen, n_clients, n, dev))
    next_key = gen.get_state()
    if pipeline.secure is not None:
        agg_rand = (agg_rand, pipeline.secure.draw(gen, n, dev))
    return mask, noise, agg_rand, next_key


def draw_dispatch(key, params, tau: int, pipeline, n_participants: int):
    """The randomness of one buffered-async dispatch of the block of clients
    that ``params`` stacks (b rows), from the generator state ``key``, on
    the params' device: ``(mask, noise, agg_rand, next_key)``. Under a
    pipeline it draws as :func:`draw_pipeline_round` does (the (b,) mask
    with ``n_participants`` ones, the (b, tau, N) noise, then b rows of the
    compressor's ``agg_rand``; an async spec has no secure sum). Without
    one the mask is all ones (made on the device, not drawn) and the noise
    is :func:`draw_round_noise`'s. So a dispatch of all C clients consumes
    the generator exactly as a sync round does."""
    if pipeline is None:
        noise, next_key = draw_round_noise(key, params, tau)
        return (torch.ones((noise.shape[0],), dtype=torch.float32,
                           device=noise.device), noise, None, next_key)
    leaves = tree_leaves(params)
    dev, b, n = leaves[0].device, leaves[0].shape[0], _n_params(params)
    gen = torch.Generator(device=dev)
    gen.set_state(key)
    mask = participation_mask(gen, b, n_participants, dev)
    noise = torch.randn((b, tau, n), generator=gen, dtype=torch.float32,
                        device=dev)
    agg_rand = (None if pipeline.compressor is None
                else pipeline.compressor.draw(gen, b, n, dev))
    return mask, noise, agg_rand, gen.get_state()


def make_chunked_round(round_fn: Callable, pipeline=None) -> Callable:
    """R rounds of ``round_fn`` as one call (a plain loop). Without a
    pipeline:

        chunk_fn(params, opt_state, batches, key, sigmas)
            -> (params, opt_state, key, metrics)

    with ``batches`` leaves shaped (R, C, tau, B, ...) and metrics stacked
    (R,). Each round draws its noise from the carried generator state
    exactly as :func:`repro_torch.api.run_round` does, so a chunk equals R
    sequential run_round calls. With a pipeline:

        chunk_fn(params, opt_state, batches, key, sigmas, residual)
            -> (params, opt_state, key, residual, metrics, masks)

    where each round draws its mask, noise and ``agg_rand`` with
    :func:`draw_pipeline_round` inside the loop, and the realized masks come
    back stacked (R, C) for the host ledger."""
    def chunk_fn(params, opt_state, batches, key, sigmas):
        n_rounds, _, tau = tree_leaves(batches)[0].shape[:3]
        ms = []
        for r in range(n_rounds):
            noise, key = draw_round_noise(key, params, tau)
            params, opt_state, m = round_fn(
                params, opt_state, tree_map(lambda x: x[r], batches), noise,
                sigmas)
            ms.append(m)
        return params, opt_state, key, {
            k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def chunk_fn_pipeline(params, opt_state, batches, key, sigmas, residual):
        n_rounds, _, tau = tree_leaves(batches)[0].shape[:3]
        ms, masks = [], []
        for r in range(n_rounds):
            mask, noise, agg_rand, key = draw_pipeline_round(
                key, params, tau, pipeline)
            params, opt_state, residual, m = round_fn(
                params, opt_state, tree_map(lambda x: x[r], batches), noise,
                sigmas, mask, residual, agg_rand)
            ms.append(m)
            masks.append(mask)
        return params, opt_state, key, residual, {
            k: torch.stack([m[k] for m in ms]) for k in ms[0]
        }, torch.stack(masks)

    return chunk_fn if pipeline is None else chunk_fn_pipeline


def make_resident_chunked_round(round_fn: Callable, pipeline,
                                kernel_backend: str = "auto",
                                data_resident: bool = False) -> Callable:
    """:func:`make_chunked_round`'s pipeline form with a fresh cohort per
    round, its sticky rows in the device-resident cohort cache:

        chunk_fn(params, opt_state, batches, slots, key, sigmas, cache)
            -> (params, opt_state, key, cache, metrics, masks)

    ``slots`` is the (R, K) int64 per-round cohort -> cache-slot plan on the
    device, ``cache`` the (S, D) f32 error-feedback residual block (or
    ``None`` for a pipeline without a compressor) and ``batches`` leaves are
    (R, K, tau, B, ...). Each round gathers its cohort's K residual rows out
    of the cache with the ``cohort_gather_scatter`` kernel, draws its mask,
    noise and ``agg_rand`` with :func:`draw_pipeline_round` exactly as
    :func:`repro_torch.api.run_round` does, runs the unchanged pipeline
    round, and scatters the updated rows back into the cache in place. So
    the chunk runs the per-round driver's ops, on the same shapes and in the
    same order, and equals R per-round calls bit for bit.

    ``data_resident=True`` is the stationary-population form: ``batches`` is
    then the (S, tau, B, ...) warm-shard cache and each round's
    (K, tau, B, ...) batch is gathered from it by slot through the same
    kernel (every leaf viewed as (S, row) rows), so the chunk reads no
    host-built data."""
    def gather_shards(batches, slot):
        def one(x):
            rows = cohort_gather(x.reshape(x.shape[0], -1), slot,
                                 backend=kernel_backend)
            return rows.reshape((slot.shape[0],) + tuple(x.shape[1:]))
        return tree_map(one, batches)

    def chunk_fn(params, opt_state, batches, slots, key, sigmas, cache):
        tau = (tree_leaves(batches)[0].shape[1] if data_resident
               else tree_leaves(batches)[0].shape[2])
        ms, masks = [], []
        for r in range(slots.shape[0]):
            slot = slots[r]
            batch = (gather_shards(batches, slot) if data_resident
                     else tree_map(lambda x: x[r], batches))
            mask, noise, agg_rand, key = draw_pipeline_round(
                key, params, tau, pipeline)
            rows = (cohort_gather(cache, slot, backend=kernel_backend)
                    if cache is not None else None)
            params, opt_state, rows, m = round_fn(
                params, opt_state, batch, noise, sigmas, mask, rows,
                agg_rand)
            if cache is not None:
                cohort_scatter(cache, slot, rows, backend=kernel_backend)
            ms.append(m)
            masks.append(mask)
        return params, opt_state, key, cache, {
            k: torch.stack([m[k] for m in ms]) for k in ms[0]
        }, torch.stack(masks)

    return chunk_fn


@dataclass
class Budgets:
    """Per-device budgets of the optimal-design problem (paper §5.3)."""
    c_th: float = float("inf")     # resource budget C_th
    eps_th: float = float("inf")   # privacy budget eps_th
    c1: float = 100.0              # comm cost / aggregation (paper §8.1 default)
    c2: float = 1.0                # compute cost / local step


def design_sigmas(k: int, clip_norm: float, batch_sizes: list[int],
                  eps_th: float, delta: float) -> np.ndarray:
    """Vector of Eq.-(23) optimal noise levels, one per client."""
    return np.asarray([sigma_star(k, clip_norm, x, eps_th, delta)
                       for x in batch_sizes], dtype=np.float32)
