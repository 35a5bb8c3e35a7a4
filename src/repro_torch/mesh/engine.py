"""The mesh_2d round: DP-PASGD on a ("client", "model") 2D mesh (the port
of the JAX package's ``repro/mesh/engine.py``), client axis only.

* The **client axis** is the 1D engine's (:mod:`repro_torch.core.fl_shard_map`):
  each of the ``dc`` ranks owns a contiguous block of client replicas and
  the only cross-rank collective is the Eq.-7b reduction.
* The **model axis** (``dm > 1``) would split each replica's weights and
  activations over the ``dm`` ranks of a slab, which the JAX package leaves
  to GSPMD through its models' ``shard_hint`` sites. PyTorch has no such
  partitioner; the port would need hand-written tensor parallelism through
  every mixer. It raises ``NotImplementedError`` naming ROADMAP queue 1
  item 12b.

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
from repro_torch.models.sharding import P
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.tree import tree_broadcast_axis0, tree_map

CLIENT_AXIS = "client"
MODEL_AXIS = "model"


def default_param_specs(tree, dm: int, *, client_axis: str = CLIENT_AXIS,
                        model_axis: str = MODEL_AXIS):
    """Per-leaf PartitionSpecs for client-stacked state on the 2D mesh.

    Every leaf carries the leading client axis; with ``dm > 1`` the model
    axis lands on the LARGEST remaining dim divisible by ``dm`` (the dim
    whose sharding saves the most memory). Leaves with no shardable dim
    (per-client scalars such as step counters) replicate over the model
    axis."""
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


def refuse_model_axis(dm: int) -> None:
    """A model axis over 1 is ROADMAP queue 1 item 12b."""
    if dm > 1:
        from repro_torch.api.spec import _not_ported
        raise _not_ported(f"mesh_2d with a model axis of {dm} ranks "
                          f"(tensor-parallel replicas)", "item 12b")


def make_mesh_2d_round(loss_fn: Callable, optimizer: Optimizer,
                       cfg: FLConfig, mesh, *,
                       topology: str = "full_average", pipeline=None):
    """Build ``round_step`` on a 2D ("client", "model") mesh with the
    signature and randomness operands of the other engines:
    ``(params, opt_state, batch, noise, sigmas) -> (params, opt_state,
    metrics)``, or with ``pipeline`` the 8-operand masked / residual form.
    With a model axis of 1 no logical->mesh rule places anything, so none
    is installed around the local rounds (the model axis is item 12b)."""
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
    refuse_model_axis(dm)
    n_clients = cfg.n_clients
    block = -(-n_clients // dc)
    if block * dc == n_clients:
        # degenerate mesh: the 1D engine body on the same ranks
        return make_shard_map_round(loss_fn, optimizer, cfg, mesh,
                                    client_axis=CLIENT_AXIS,
                                    topology=topology, pipeline=pipeline)
    grp = ClientGroup(mesh, CLIENT_AXIS)
    local_rounds = make_local_rounds(loss_fn, optimizer, cfg)

    def block_rows(device):
        """This rank's padded row indices (pad rows read client 0) and
        their 0/1 ``valid`` weights."""
        ids = torch.arange(grp.index * block, (grp.index + 1) * block,
                           device=device)
        valid = (ids < n_clients).to(torch.float32)
        return torch.where(ids < n_clients, ids, 0), valid

    def take(tree, idx):
        return tree_map(lambda x: x.index_select(0, idx), tree)

    def unpad(tree):
        return tree_map(lambda x: x[:n_clients].contiguous(),
                        grp.all_gather_tree(tree))

    def round_step(params, opt_state, batch, noise, sigmas):
        result = None
        if not grp.idle:
            idx, valid = block_rows(noise.device)
            denom = torch.tensor(float(n_clients), device=noise.device)
            new_p, new_s, ms = local_rounds(*take(
                (params, opt_state, batch, noise, sigmas), idx))
            full = topology == "full_average"
            avg_s = full and cfg.average_opt_state
            # ---- Eq. (7b) with pad rows weighted out: one all-reduce
            avg = tree_valid_mean_axis0(
                (new_p if full else {}, new_s if avg_s else {}, ms), valid,
                denom, all_sum=grp.all_sum)
            new_p = (tree_broadcast_axis0(avg[0], n_clients) if full
                     else unpad(new_p))
            new_s = (tree_broadcast_axis0(avg[1], n_clients) if avg_s
                     else unpad(new_s))
            result = (new_p, new_s, avg[2])
        return grp.share(result)

    def round_step_pipeline(params, opt_state, batch, noise, sigmas, mask,
                            residual, agg_rand):
        result = None
        if not grp.idle:
            idx, valid = block_rows(noise.device)
            p_b, s_b, batch_b, noise_b, sig_b, rand_b = take(
                (params, opt_state, batch, noise, sigmas, agg_rand), idx)
            mask_b = mask.index_select(0, idx) * valid
            res_b = (None if residual is None
                     else residual.index_select(0, idx) * valid[:, None])
            new_p, new_s, ms = local_rounds(p_b, s_b, batch_b, noise_b,
                                            sig_b)
            new_p, new_s, res_b, ms = pipeline.aggregate(
                p_b, new_p, new_s, s_b, res_b, mask_b, rand_b, ms,
                all_sum=grp.all_sum)
            new_s = (widen(new_s, n_clients) if cfg.average_opt_state
                     else unpad(new_s))
            result = (widen(new_p, n_clients), new_s,
                      None if res_b is None else unpad(res_b), ms)
        return grp.share(result)

    return round_step if pipeline is None else round_step_pipeline
