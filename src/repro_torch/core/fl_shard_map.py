"""The sharded DP-PASGD round: an explicit collective schedule over the
client axis (Eq. 7a-7b), the port of the JAX package's
``repro/core/fl_shard_map.py`` on ``torch.distributed``.

Each rank of the mesh's ``client`` axis (:mod:`repro_torch.launch.mesh`)
owns a contiguous block of ``n_clients / n_shards`` client replicas. It
runs its block's tau local noisy-SGD steps with ZERO collectives, each
step one ``dp_clip_noise`` call on the block's (block, N) rows, and then
meets the other ranks in the one Eq.-7b reduction:

* dense ``full_average``: the block means of params, optimizer state and
  metrics in one flat f32 buffer, one all-reduce SUM over the client group,
  divided by the shard count (the reference's ``pmean``);
* the aggregation pipeline: the participant count, the masked block sums
  and the metrics' masked sums in one all-reduce
  (:meth:`repro_torch.core.aggregation.AggregationPipeline.aggregate` with
  ``all_sum``); the adversarial extensions also gather every block's
  update rows and compute the same global result on every rank.

Operands and results are the full client-stacked (C, ...) trees on every
rank, as the JAX engine presents its global arrays: the round function
has the single-process engines' signature, so ``run_round``,
``run_rounds``, the chunked and resident drivers, budgets and eval run
unchanged, each rank driving the same federation. A rank takes its rows of
params, opt_state, batch, noise, sigmas, mask, residual and ``agg_rand``
(every rank draws the round's randomness whole at the same key of the
counter-based generator, so a sharded round is row for row the ``vmap``
round). Outputs that
stay per client (``local_only`` params, optimizer state that is not
averaged, the error-feedback residual) come back whole through one
all-gather of the blocks along axis 0, rank order being row order.

Ranks of the world outside the mesh (fewer client blocks than ranks) take
no block; they receive the round's results from the mesh's first rank.

On a 2D mesh with a model axis over 1 (:mod:`repro_torch.mesh.engine`) a
:class:`ClientGroup` is taken at this rank's model coordinate: its ranks
hold the same slices of every replica, so the Eq.-7b sums run on the
slices, and the round's outputs are made whole by a gather over the model
group (:func:`repro_torch.models.sharding.to_whole`) before the row
gathers here.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core.fl import (
    FLConfig,
    check_topology,
    make_local_rounds,
)
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.tree import (
    tree_broadcast_axis0,
    tree_flatten,
    tree_map,
    tree_mean_over_axis0,
    tree_unflatten,
)


class ClientGroup:
    """This rank's place on a mesh's client axis, and the axis'
    collectives: the sum, the mean and the row gather over its ranks."""

    def __init__(self, mesh, client_axis: str = "client"):
        dim = list(mesh.mesh_dim_names).index(client_axis)
        self.n_shards = int(mesh.shape[dim])
        coord = mesh.get_coordinate()
        self.idle = coord is None
        self.index = None if self.idle else int(coord[dim])
        self.group = None if self.idle else mesh.get_group(client_axis)
        ranks = mesh.mesh.reshape(-1).tolist()
        self.root = int(ranks[0])
        self.spectators = dist.get_world_size() > len(ranks)

    def all_sum(self, tensors: list) -> list:
        """Each tensor of ``tensors`` summed over the client group (new
        tensors): one all-reduce of a flat buffer per dtype, so one for a
        round's f32 partial sums."""
        out = list(tensors)
        for dtype in dict.fromkeys(t.dtype for t in tensors):  # rank-stable
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            buf = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(buf, group=self.group)
            for i, part in zip(idx, buf.split([tensors[i].numel()
                                               for i in idx])):
                out[i] = part.reshape(tensors[i].shape)
        return out

    def all_mean_trees(self, *trees):
        """Every float leaf of ``trees`` summed over the client group in
        f32 (one all-reduce), divided by the shard count and cast back;
        other leaves pass through."""
        flat = [tree_flatten(t) for t in trees]
        floats = [x for leaves, _ in flat for x in leaves
                  if torch.is_floating_point(x)]
        means = iter(s / self.n_shards for s in self.all_sum(
            [x.to(torch.float32) for x in floats]))
        return tuple(tree_unflatten(treedef, [
            next(means).to(x.dtype) if torch.is_floating_point(x) else x
            for x in leaves]) for leaves, treedef in flat)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks' (b, ...) rows, concatenated in rank order:
        (n_shards * b, ...). Each rank writes its block into a zero buffer
        and the group sums the buffers' bytes: one addend per byte is not
        zero, so the sum is exact, and it runs on every backend (gloo does
        not gather CUDA tensors)."""
        b = x.shape[0]
        out = torch.zeros((self.n_shards * b,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        out[self.index * b:(self.index + 1) * b] = x
        dist.all_reduce(out.view(-1).view(torch.uint8), group=self.group)
        return out

    def all_gather_tree(self, tree):
        """:meth:`all_gather_rows` of every leaf, leaves of one dtype laid
        side by side so each dtype makes one gather."""
        leaves, treedef = tree_flatten(tree)
        out = list(leaves)
        for dtype in dict.fromkeys(x.dtype for x in leaves):  # rank-stable
            idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
            b = leaves[idx[0]].shape[0]
            cols = [leaves[i].reshape(b, -1) for i in idx]
            whole = self.all_gather_rows(torch.cat(cols, dim=1))
            for i, part in zip(idx, whole.split(
                    [c.shape[1] for c in cols], dim=1)):
                out[i] = part.reshape((whole.shape[0],)
                                      + tuple(leaves[i].shape[1:]))
                out[i] = out[i].contiguous()
        return tree_unflatten(treedef, out)

    def share(self, result):
        """Hand the mesh's result to the world's ranks outside the mesh
        (from the mesh's first rank); a no-op without such ranks."""
        if not self.spectators:
            return result
        box = [None if self.idle else result]
        dist.broadcast_object_list(box, src=self.root)
        return box[0]

    def rows(self, tree, block: int):
        """This rank's ``block`` rows of every leaf of ``tree``."""
        lo = self.index * block
        return tree_map(lambda x: x[lo:lo + block], tree)


def block_mean(grp: ClientGroup, new_p, new_s, ms: dict, full: bool,
               avg_s: bool):
    """Eq. 7b over a block of clients that divide the client axis: each
    metric's block mean and, under ``full_average`` (``full``), the block
    means of params and (``avg_s``) optimizer state, in one all-reduce over
    the client group divided by the shard count (the reference's
    ``pmean``; C / n_shards fewer bytes than a gather). Returns
    ``(avg_p or None, avg_s or None, metrics)``, the averages without the
    client axis."""
    keys = list(ms)
    ms = {k: torch.mean(v) for k, v in ms.items()}
    if full:
        s_mean = (tree_mean_over_axis0(new_s, keep_dtype=True) if avg_s
                  else {})
        p_mean, s_mean, ms = grp.all_mean_trees(
            tree_mean_over_axis0(new_p), s_mean, ms)
    else:
        p_mean = s_mean = None
        (ms,) = grp.all_mean_trees(ms)
    return p_mean, (s_mean if avg_s else None), {k: ms[k] for k in keys}


def widen(tree, n: int):
    """A block of identical rows (the re-broadcast global model) as ``n``
    rows: row 0 tiled."""
    return tree_broadcast_axis0(tree_map(lambda x: x[0], tree), n)


def make_shard_map_round(loss_fn: Callable, optimizer: Optimizer,
                         cfg: FLConfig, mesh, client_axis: str = "client",
                         topology: str = "full_average", pipeline=None):
    """Build ``round_step(params, opt_state, batch, noise, sigmas)`` over
    ``mesh``'s client axis, or with ``pipeline`` the 8-operand form
    ``(..., mask, residual, agg_rand) -> (params, opt_state, residual,
    metrics)``: the signatures of
    :func:`repro_torch.core.fl.make_round_step`, on full (C, ...) trees.
    Clients must divide the client axis (``mesh_2d`` pads them)."""
    check_topology(topology, pipeline)
    grp = ClientGroup(mesh, client_axis)
    n_clients = cfg.n_clients
    if n_clients % grp.n_shards:
        raise ValueError(f"{n_clients} clients do not divide over "
                         f"{grp.n_shards} '{client_axis}' mesh slots")
    block = n_clients // grp.n_shards
    local_rounds = make_local_rounds(loss_fn, optimizer, cfg)

    def round_step(params, opt_state, batch, noise, sigmas):
        result = None
        if not grp.idle:
            p_b, s_b, batch_b, noise_b, sig_b = grp.rows(
                (params, opt_state, batch, noise, sigmas), block)
            new_p, new_s, ms = local_rounds(p_b, s_b, batch_b, noise_b,
                                            sig_b)
            full = topology == "full_average"
            avg_p, avg_s, ms = block_mean(grp, new_p, new_s, ms, full,
                                          full and cfg.average_opt_state)
            new_p = (tree_broadcast_axis0(avg_p, n_clients) if full
                     else grp.all_gather_tree(new_p))
            new_s = (tree_broadcast_axis0(avg_s, n_clients)
                     if avg_s is not None else grp.all_gather_tree(new_s))
            result = (new_p, new_s, ms)
        return grp.share(result)

    def round_step_pipeline(params, opt_state, batch, noise, sigmas, mask,
                            residual, agg_rand):
        result = None
        if not grp.idle:
            # the secure sum's pair masks are drawn whole on every rank and
            # stay whole; the compressor operand has a row per client
            comp_rand, pair_masks = (agg_rand if pipeline.secure is not None
                                     else (agg_rand, None))
            p_b, s_b, batch_b, noise_b, sig_b, mask_b, res_b, rand_b = \
                grp.rows((params, opt_state, batch, noise, sigmas, mask,
                          residual, comp_rand), block)
            if pipeline.secure is not None:
                rand_b = (rand_b, pair_masks)
            new_p, new_s, ms = local_rounds(p_b, s_b, batch_b, noise_b,
                                            sig_b)
            new_p, new_s, res_b, ms = pipeline.aggregate(
                p_b, new_p, new_s, s_b, res_b, mask_b, rand_b, ms,
                all_sum=grp.all_sum, all_gather=grp.all_gather_rows)
            new_p = widen(new_p, n_clients)
            new_s = (widen(new_s, n_clients) if cfg.average_opt_state
                     else grp.all_gather_tree(new_s))
            if res_b is not None:
                res_b = grp.all_gather_rows(res_b)
            result = (new_p, new_s, res_b, ms)
        return grp.share(result)

    return round_step if pipeline is None else round_step_pipeline
