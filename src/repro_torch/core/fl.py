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
counter-based generator (:mod:`repro_torch.kernels.counter_rng`) at its
key ``(seed, counter)``: every value is a function of its address (the
counter, what it is for, the client's row, the step, the column), so any
block of rows and columns of a draw equals the same part of the whole
draw. N is the number of parameters per client, leaves laid end to end in
``jax.tree.flatten`` order. A round with an aggregation pipeline
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
from repro_torch.kernels.counter_rng import (
    NOISE,
    SECURE,
    key_parts,
    next_key,
    whole_table,
)
from repro_torch.kernels.ops import cohort_gather, cohort_scatter, counter_draw
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.tree import (
    tree_add,
    tree_broadcast_axis0,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_mean_over_axis0,
    tree_unflatten,
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


def make_local_rounds(loss_fn: Callable, optimizer: Optimizer,
                      cfg: FLConfig) -> Callable:
    """The engine's Eq.-7a stage on a block of B clients (no collectives):
    ``local_rounds(params, opt_state, batch, noise, sigmas)`` over the
    block's (B, ...) operands, all B at once (``vmap_clients``) or one
    client at a time."""
    local_round = make_local_round(make_grad_fn(loss_fn, cfg), optimizer,
                                   cfg.tau)

    def local_rounds(params, opt_state, batch, noise, sigmas):
        if cfg.vmap_clients:
            return local_round(params, opt_state, batch, noise, sigmas)
        outs = [local_round(*tree_map(lambda x: x[c:c + 1],
                                      (params, opt_state, batch, noise,
                                       sigmas)))
                for c in range(sigmas.shape[0])]
        return tree_map(lambda *xs: torch.cat(xs), *outs)

    return local_rounds


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
    check_topology(topology, pipeline)
    local_rounds = make_local_rounds(loss_fn, optimizer, cfg)

    def round_step(params, opt_state, batch, noise, sigmas):
        new_p, new_s, ms = local_rounds(params, opt_state, batch, noise,
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
        new_p, new_s, ms = local_rounds(params, opt_state, batch, noise,
                                        sigmas)
        return pipeline.aggregate(params, new_p, new_s, opt_state, residual,
                                  mask, agg_rand, ms)

    return round_step if pipeline is None else round_step_pipeline


def check_topology(topology: str, pipeline) -> None:
    """The engines' shared refusal of an unknown topology, and of a
    pipeline without ``full_average``."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"topology must be one of {TOPOLOGIES}, "
                         f"got {topology!r}")
    if pipeline is not None and topology != "full_average":
        raise ValueError("the aggregation pipeline requires "
                         "topology='full_average'")


def tree_valid_mean_axis0(tree, valid, denom, all_sum=lambda xs: xs):
    """Mean over axis 0 of every leaf, weighted by the 0/1 ``valid`` vector
    and normalized by the (possibly cross-rank) ``denom`` count.

    The padded-client Eq.-7b boundary of the mesh_2d engine
    (:mod:`repro_torch.mesh`): when C clients do not divide the client
    axis, blocks are padded to Cp rows and pad rows carry ``valid = 0``;
    this weighted form with ``denom`` = C reproduces the exact mean over
    the C real clients. Sums run in f32 and cast back per leaf (int leaves
    such as optimizer step counters round-trip exactly: weighted means of
    identical integers are integral). ``all_sum`` takes the list of every
    leaf's block sum and returns them summed over the ranks (one
    collective for the whole tree)."""
    leaves, treedef = tree_flatten(tree)
    sums = all_sum([torch.sum(valid.reshape((-1,) + (1,) * (x.dim() - 1))
                              * x.to(torch.float32), dim=0) for x in leaves])
    return tree_unflatten(treedef, [(s / denom).to(x.dtype)
                                    for s, x in zip(sums, leaves)])


def _n_params(params) -> int:
    return sum(x[0].numel() for x in tree_leaves(params))


def draw_round_noise(key, params, tau: int, slab=None):
    """One round's f32 standard normals from the counter generator
    (:mod:`repro_torch.kernels.counter_rng`, purpose ``NOISE``) at the key
    ``(seed, counter)``, in one ``counter_rng`` launch on the params'
    device: the whole (C, tau, N), client r at row r, or with ``slab`` (a
    :class:`repro_torch.mesh.engine.SlabLayout`) the slab's (block, tau,
    N_local), its rows' global ids and its columns in its local layout:
    the same values as those addresses of the whole draw. Returns
    ``(noise, next_key)``."""
    return _noise(key, params, tau, slab), next_key(key)


def _noise(key, params, tau: int, slab):
    leaves = tree_leaves(params)
    if slab is None:
        rows, n = tuple(range(leaves[0].shape[0])), _n_params(params)
        table = whole_table(n)
    else:
        rows, table, n = slab.rows, slab.table, slab.n_local
    return counter_draw(key, rows, table, tau, n, NOISE, True,
                        leaves[0].device)


def _secure_generator(key, device) -> torch.Generator:
    """The secure sum's pair-mask generator, seeded on the host from the
    key's (seed, counter) and the ``SECURE`` purpose."""
    seed, counter = key_parts(key)
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & (2 ** 64 - 1)) * 0x9E3779B97F4A7C15
                     + counter * 4 + SECURE) % 2 ** 63)
    return gen


def draw_pipeline_round(key, params, tau: int, pipeline, slab=None):
    """The randomness of one pipeline round at the key ``(seed, counter)``,
    drawn on the params' device by address (each its own purpose of the
    counter generator, so their order does not matter): the whole (C,)
    participation mask
    (:func:`~repro_torch.core.aggregation.participation_mask`; every rank
    draws it whole), the noise (:func:`draw_round_noise`, ``slab`` as
    there), then the compressor's ``agg_rand`` (``None`` without one), of
    the clients whose noise is drawn, whole in D. Under secure aggregation
    the (C, C, N) pair masks come from a ``torch.Generator`` seeded from
    the key and ride in ``agg_rand`` as ``(agg_rand, pair_masks)``; they
    cancel exactly, so no result depends on their values. Nothing comes to
    the host. Returns ``(mask, noise, agg_rand, next_key)``."""
    leaves = tree_leaves(params)
    dev = leaves[0].device
    if slab is None:
        n_clients, d = leaves[0].shape[0], _n_params(params)
        rows = tuple(range(n_clients))
    else:
        n_clients, d, rows = slab.n_clients, slab.n_whole, slab.rows
    mask = participation_mask(key, n_clients, pipeline.n_participants, dev)
    noise = _noise(key, params, tau, slab)
    agg_rand = (None if pipeline.compressor is None
                else pipeline.compressor.draw(key, rows, d, dev))
    if pipeline.secure is not None:
        agg_rand = (agg_rand, pipeline.secure.draw(
            _secure_generator(key, dev), d, dev))
    return mask, noise, agg_rand, next_key(key)


def draw_dispatch(key, params, tau: int, pipeline, n_participants: int):
    """The randomness of one buffered-async dispatch of the block of clients
    that ``params`` stacks (b rows, at rows 0..b-1 of the counter
    generator), at the key ``(seed, counter)``, on the params' device:
    ``(mask, noise, agg_rand, next_key)``. Under a pipeline it draws as
    :func:`draw_pipeline_round` does (the (b,) mask with
    ``n_participants`` ones, the (b, tau, N) noise, then b rows of the
    compressor's ``agg_rand``; an async spec has no secure sum). Without
    one the mask is all ones (made on the device, not drawn) and the noise
    is :func:`draw_round_noise`'s. So a dispatch of all C clients draws
    exactly what a sync round at the same key does."""
    noise = _noise(key, params, tau, None)
    b, dev = noise.shape[0], noise.device
    if pipeline is None:
        return (torch.ones((b,), dtype=torch.float32, device=dev), noise,
                None, next_key(key))
    mask = participation_mask(key, b, n_participants, dev)
    agg_rand = (None if pipeline.compressor is None
                else pipeline.compressor.draw(key, tuple(range(b)),
                                              noise.shape[-1], dev))
    return mask, noise, agg_rand, next_key(key)


def make_chunked_round(round_fn: Callable, pipeline=None) -> Callable:
    """R rounds of ``round_fn`` as one call (a plain loop). Without a
    pipeline:

        chunk_fn(params, opt_state, batches, key, sigmas, slab=None)
            -> (params, opt_state, key, metrics)

    with ``batches`` leaves shaped (R, C, tau, B, ...) and metrics stacked
    (R,). Each round draws its noise at the carried key exactly as
    :func:`repro_torch.api.run_round` does, so a chunk equals R sequential
    run_round calls. With a pipeline:

        chunk_fn(params, opt_state, batches, key, sigmas, residual,
                 slab=None) -> (params, opt_state, key, residual, metrics,
                                masks)

    where each round draws its mask, noise and ``agg_rand`` with
    :func:`draw_pipeline_round` inside the loop, and the realized masks come
    back stacked (R, C) for the host ledger. With ``slab`` (a
    :class:`repro_torch.mesh.engine.SlabLayout`) ``round_fn`` is a mesh_2d
    slab round and every operand the slab's (batches, sigmas, residual:
    the block's rows): each round draws the slab's noise and ``agg_rand``
    and hands the round the block's rows of the whole mask."""
    def chunk_fn(params, opt_state, batches, key, sigmas, slab=None):
        n_rounds, _, tau = tree_leaves(batches)[0].shape[:3]
        lead = () if slab is None else (slab,)
        ms = []
        for r in range(n_rounds):
            noise, key = draw_round_noise(key, params, tau, **_slab_kw(slab))
            params, opt_state, m = round_fn(
                *lead, params, opt_state, tree_map(lambda x: x[r], batches),
                noise, sigmas)
            ms.append(m)
        return params, opt_state, key, {
            k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def chunk_fn_pipeline(params, opt_state, batches, key, sigmas, residual,
                          slab=None):
        n_rounds, _, tau = tree_leaves(batches)[0].shape[:3]
        lead = () if slab is None else (slab,)
        ms, masks = [], []
        for r in range(n_rounds):
            mask, noise, agg_rand, key = draw_pipeline_round(
                key, params, tau, pipeline, **_slab_kw(slab))
            params, opt_state, residual, m = round_fn(
                *lead, params, opt_state, tree_map(lambda x: x[r], batches),
                noise, sigmas, mask if slab is None else slab.take(mask),
                residual, agg_rand)
            ms.append(m)
            masks.append(mask)
        return params, opt_state, key, residual, {
            k: torch.stack([m[k] for m in ms]) for k in ms[0]
        }, torch.stack(masks)

    return chunk_fn if pipeline is None else chunk_fn_pipeline


def _slab_kw(slab) -> dict:
    """The draws' ``slab`` keyword, left out for whole state (so a draw
    replaced by a test's four-argument stand-in keeps working)."""
    return {} if slab is None else {"slab": slab}


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
