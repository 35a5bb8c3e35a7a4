"""The mesh_2d round: DP-PASGD on a ("client", "model") 2D mesh (the port
of the JAX package's ``repro/mesh/engine.py``).

* The **client axis** is the 1D engine's (:mod:`repro_torch.core.fl_shard_map`):
  each of the ``dc`` slabs owns a contiguous block of client replicas and
  the only cross-slab collective is the Eq.-7b reduction.
* The **model axis** (``dm > 1``) splits each replica's weights and matmul
  work over the ``dm`` ranks of a slab. The JAX package leaves that to
  GSPMD through its models' ``shard_hint`` sites; PyTorch has no such
  partitioner, so the split is written by hand
  (:mod:`repro_torch.mesh.collectives`): each weight is split where its
  logical axes resolve under the rules (default
  :func:`repro_torch.models.sharding.mesh2d_rules`, first dim wins:
  :func:`repro_torch.models.sharding.param_split_dims`), column-parallel
  weights behind an identity-forward / all-reduce-backward function and
  row-parallel ones before an all-reduce-forward / identity-backward one.
  Leaves without a hint (norm scales, token-shift mixes, the MoE router,
  biases of the linear model) stay whole on every model rank, and enter
  the split code so that their gradient is summed over the model group.
  The linear models of §8.1 and every transformer of the repo run so:
  attention + MLP (heads, ffn), RWKV6 (heads, d_ff), Mamba2 with zamba2's
  shared block (heads, the LoRA factors gathered), MoE (experts).

A round at ``dm > 1``: each rank takes its block's rows of the operands
and its slices of params and optimizer state (step counters whole), and
its columns of the round's (C, tau, N) noise, split leaves first
(:func:`repro_torch.kernels.ops.split_order`); the local rounds run under
the model context, where the Eq.-7a clip norm is the norm of the whole
per-client gradient (a sum over the model ranks); Eq. 7b is the same
single all-reduce over the client group as at ``dm = 1``, on the slices;
the outputs come back as full (C, ...) trees through a gather over the
model group. The pipeline path follows the JAX package's stage 2: each
update row is gathered whole over the model group and the block pipeline
(``quantize_decompress``, top-k) runs on whole rows, as at ``dm = 1``.

**Memory is not yet saved between rounds.** Every rank still holds the
full client-stacked trees between rounds (the round keeps the other
engines' signature, so the drivers, budgets, eval and checkpoints run
unchanged on every rank); only a step's weights, activations and gradients
are split (model-sharded resident state is a ROADMAP item of its own).

Clients that do not divide ``dc`` are padded to ``Cp = ceil(C/dc) * dc``
rows. Pad rows are copies of client 0's operands, so their local rounds
compute real (finite) values and nothing poisons a mean through
``NaN * 0``; a ``valid`` 0/1 vector drops them from every aggregate exactly
(:func:`repro_torch.core.fl.tree_valid_mean_axis0`; the pipeline path
zero-pads the participation mask instead, which its masked sums already
handle). Each rank gathers only its own block's rows (``index_select``),
where the JAX package pads through ``dynamic_update_slice``, an XLA
workaround that PyTorch does not need. The degenerate mesh ``(dc, 1)``
with dividing clients delegates to
:func:`repro_torch.core.fl_shard_map.make_shard_map_round` verbatim, so its
identity with ``engine="shard_map"`` is structural.

The adversarial extensions (robust aggregators, secure sum, update
attacks) are full-view reductions over exactly ``n_clients`` gathered rows
and do not compose with the padded client axis: ``FederationSpec``
refuses them on this engine (use ``engine="shard_map"``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.fl import (
    FLConfig,
    check_topology,
    make_local_rounds,
    tree_valid_mean_axis0,
)
from repro_torch.core.fl_shard_map import (
    ClientGroup,
    make_shard_map_round,
    widen,
)
from repro_torch.kernels.ops import split_order
from repro_torch.mesh.collectives import ModelGroup
from repro_torch.models.sharding import (
    P,
    axis_rules,
    mesh2d_rules,
    param_split_dims,
    state_split_dims,
    to_local,
    to_whole,
)
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.tree import (
    tree_broadcast_axis0,
    tree_flatten,
    tree_map,
)

CLIENT_AXIS = "client"
MODEL_AXIS = "model"


def default_param_specs(tree, dm: int, *, client_axis: str = CLIENT_AXIS,
                        model_axis: str = MODEL_AXIS):
    """Per-leaf PartitionSpecs for client-stacked state on the 2D mesh.

    Every leaf carries the leading client axis; with ``dm > 1`` the model
    axis lands on the LARGEST remaining dim divisible by ``dm`` (the dim
    whose sharding saves the most memory). Leaves with no shardable dim
    (per-client scalars such as step counters) replicate over the model
    axis. The JAX engine pins its boundary layouts with these; the port's
    round places each leaf by its hint instead
    (:func:`repro_torch.models.sharding.param_split_dims`), where this
    table would split norm scales and biases that the hand-written split
    keeps whole."""
    def one(x):
        spec: list = [client_axis] + [None] * (x.dim() - 1)
        if dm > 1:
            sizes = [(x.shape[i], i) for i in range(1, x.dim())
                     if x.shape[i] % dm == 0 and x.shape[i] >= dm]
            if sizes:
                spec[max(sizes)[1]] = model_axis
        while len(spec) > 1 and spec[-1] is None:
            spec.pop()
        return P(*spec)

    return tree_map(one, tree)


def _mesh_dims(mesh) -> tuple[int, int]:
    names = list(mesh.mesh_dim_names)
    return (int(mesh.shape[names.index(CLIENT_AXIS)]),
            int(mesh.shape[names.index(MODEL_AXIS)]))


def local_noise(noise, params, dims, index: int, dm: int):
    """Model rank ``index`` of ``dm``'s columns of the flat noise ``noise``
    (..., N), leaves in ``jax.tree.flatten`` order, as a new (..., N_local)
    tensor in its local layout (:func:`repro_torch.kernels.ops
    .split_order`): a split leaf's columns of its slice along its split
    dim, a whole leaf's columns all (alike on every model rank). ``params``
    is one client's whole tree (its shapes), ``dims`` its split dims. One
    strided copy a leaf, no index tensor."""
    leaves = tree_flatten(params)[0]
    flat_dims = tree_flatten(dims)[0]
    offsets, off = [], 0
    for x in leaves:
        offsets.append(off)
        off += x.numel()
    lead = tuple(noise.shape[:-1])
    sizes = [x.numel() // (dm if d >= 0 else 1)
             for x, d in zip(leaves, flat_dims)]
    out = noise.new_empty(lead + (sum(sizes),))
    o = 0
    for i in split_order(flat_dims):
        shape = tuple(leaves[i].shape)
        src = noise[..., offsets[i]:offsets[i] + leaves[i].numel()].view(
            lead + shape)
        d = flat_dims[i]
        if d >= 0:
            per = shape[d] // dm
            src = src.narrow(len(lead) + d, index * per, per)
        out[..., o:o + sizes[i]].view(lead + tuple(src.shape[len(lead):])
                                      ).copy_(src)
        o += sizes[i]
    return out


def make_mesh_2d_round(loss_fn: Callable, optimizer: Optimizer,
                       cfg: FLConfig, mesh, *, rules=None,
                       topology: str = "full_average", pipeline=None):
    """Build ``round_step`` on a 2D ("client", "model") mesh with the
    signature and randomness operands of the other engines:
    ``(params, opt_state, batch, noise, sigmas) -> (params, opt_state,
    metrics)``, or with ``pipeline`` the 8-operand masked / residual form.
    ``rules`` is a logical->mesh dict for the model axis' placement
    (default :func:`repro_torch.models.sharding.mesh2d_rules`); with a model
    axis of 1 nothing is placed and no rules are installed."""
    check_topology(topology, pipeline)
    if pipeline is not None and (pipeline.aggregator is not None
                                 or pipeline.secure is not None
                                 or pipeline.attack is not None):
        raise ValueError(
            "mesh_2d does not support the adversarial extensions (robust "
            "aggregator / secure sum / update attack): their full-view "
            "reductions do not compose with the padded client axis. Use "
            "engine='shard_map'.")
    dc, dm = _mesh_dims(mesh)
    n_clients = cfg.n_clients
    block = -(-n_clients // dc)
    if block * dc == n_clients and dm == 1:
        # degenerate mesh: the 1D engine body on the same ranks
        return make_shard_map_round(loss_fn, optimizer, cfg, mesh,
                                    client_axis=CLIENT_AXIS,
                                    topology=topology, pipeline=pipeline)
    grp = ClientGroup(mesh, CLIENT_AXIS)
    mgrp = ModelGroup(mesh, MODEL_AXIS) if dm > 1 else None
    rules = mesh2d_rules() if rules is None else dict(rules)
    local_rounds = make_local_rounds(loss_fn, optimizer, cfg)
    placements: dict = {}

    def block_rows(device):
        """This rank's padded row indices (pad rows read client 0) and
        their 0/1 ``valid`` weights."""
        ids = torch.arange(grp.index * block, (grp.index + 1) * block,
                           device=device)
        valid = (ids < n_clients).to(torch.float32)
        return torch.where(ids < n_clients, ids, 0), valid

    def take(tree, idx):
        if block == n_clients:       # one slab holds every client
            return tree
        return tree_map(lambda x: x.index_select(0, idx), tree)

    def unpad(tree):
        return tree_map(lambda x: x[:n_clients].contiguous(),
                        grp.all_gather_tree(tree))

    def placement(params, opt_state):
        """(one client's params on meta, param dims, opt-state dims),
        once per params structure and shapes."""
        key = tuple((tuple(x.shape), x.dtype)
                    for x in tree_flatten(params)[0])
        if key not in placements:
            one = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype,
                                                 device="meta"), params)
            dims = param_split_dims(one, dm, rules)
            placements[key] = (one, dims,
                               state_split_dims(opt_state, params, dims))
        return placements[key]

    def run_local(p_b, s_b, batch_b, noise_b, sig_b):
        """The block's local rounds: whole at dm = 1; at dm > 1 on this
        rank's slices under the model context. -> (params, opt_state,
        metrics, whole), ``whole(tree, of_state, lead)`` making a tree of
        slices of the params (or of the optimizer state) whole again."""
        if mgrp is None:
            return (*local_rounds(p_b, s_b, batch_b, noise_b, sig_b),
                    lambda tree, of_state, lead=1: tree)
        one, dims, sdims = placement(p_b, s_b)
        p_l = to_local(p_b, dims, mgrp.index, dm, lead=1)
        s_l = to_local(s_b, sdims, mgrp.index, dm, lead=1)
        noise_l = (None if noise_b is None
                   else local_noise(noise_b, one, dims, mgrp.index, dm))
        with axis_rules(mesh, rules, placement=dims):
            new_p, new_s, ms = local_rounds(p_l, s_l, batch_b, noise_l,
                                            sig_b)

        def whole(tree, of_state, lead=1):
            return to_whole(tree, sdims if of_state else dims, mgrp, lead)

        return new_p, new_s, ms, whole

    def round_step(params, opt_state, batch, noise, sigmas):
        result = None
        if not grp.idle:
            idx, valid = block_rows(sigmas.device)
            denom = torch.tensor(float(n_clients), device=sigmas.device)
            new_p, new_s, ms, whole = run_local(*take(
                (params, opt_state, batch, noise, sigmas), idx))
            full = topology == "full_average"
            avg_s = full and cfg.average_opt_state
            # ---- Eq. (7b) with pad rows weighted out: one all-reduce
            avg = tree_valid_mean_axis0(
                (new_p if full else {}, new_s if avg_s else {}, ms), valid,
                denom, all_sum=grp.all_sum)
            new_p = (tree_broadcast_axis0(whole(avg[0], False, 0),
                                          n_clients) if full
                     else unpad(whole(new_p, False)))
            new_s = (tree_broadcast_axis0(whole(avg[1], True, 0), n_clients)
                     if avg_s else unpad(whole(new_s, True)))
            result = (new_p, new_s, avg[2])
        return grp.share(result)

    def round_step_pipeline(params, opt_state, batch, noise, sigmas, mask,
                            residual, agg_rand):
        result = None
        if not grp.idle:
            idx, valid = block_rows(sigmas.device)
            p_b, s_b, batch_b, noise_b, sig_b, rand_b = take(
                (params, opt_state, batch, noise, sigmas, agg_rand), idx)
            mask_b = mask.index_select(0, idx) * valid
            res_b = (None if residual is None
                     else residual.index_select(0, idx) * valid[:, None])
            new_p, new_s, ms, whole = run_local(p_b, s_b, batch_b, noise_b,
                                                sig_b)
            # the JAX package's stage 2: whole update rows
            new_p, new_s = whole(new_p, False), whole(new_s, True)
            new_p, new_s, res_b, ms = pipeline.aggregate(
                p_b, new_p, new_s, s_b, res_b, mask_b, rand_b, ms,
                all_sum=grp.all_sum)
            new_s = (widen(new_s, n_clients) if cfg.average_opt_state
                     else unpad(new_s))
            result = (widen(new_p, n_clients), new_s,
                      None if res_b is None else unpad(res_b), ms)
        return grp.share(result)

    return round_step if pipeline is None else round_step_pipeline
