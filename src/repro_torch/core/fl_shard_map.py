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
  divided by the shard count (the reference's ``pmean``), and the average
  widened to the block's rows;
* the aggregation pipeline: the participant count, the masked block sums
  and the metrics' masked sums in one all-reduce
  (:meth:`repro_torch.core.aggregation.AggregationPipeline.aggregate` with
  ``all_sum``); the adversarial extensions (robust aggregators, secure
  sum, update attacks) also gather every block's update rows inside the
  round (``all_gather``, as JAX's ``shard_map`` body gathers them) and
  compute the same global result on every rank.

As in the JAX package, whose round has ``in_specs`` and ``out_specs`` of
``P("client")``, a rank's params, optimizer state and error-feedback
residual stay its block's rows between rounds: the engine's slab round
(``round_step.slab_round(layout, ...)``, ``round_step.layout``) takes and
returns only them, and the drivers keep such slab state on a world of
several ranks (:func:`repro_torch.api.state.init_state`). Each rank draws
only its block's rows of the round's randomness from the counter-based
generator, at their global row ids, so a sharded round is row for row
the ``vmap`` round. The engine's round is the ``mesh_2d`` engine's on
the degenerate ``(n_shards, 1)`` mesh (:func:`repro_torch.mesh.engine
.make_mesh_2d_round`), whose clients divide: its whole-tree form takes
the block of whole operands, runs the slab round and gathers the outputs
whole. Ranks of the world outside the mesh (fewer client blocks than
ranks) hold no rows and receive each round's metrics from the mesh's
first rank. This module holds the collectives and block means that
round runs.

:class:`ClientGroup` is the client axis' collectives; the serving mesh
uses it over its data axis too.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

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
        """Hand ``result`` (any picklable value, here a round's metrics)
        from the mesh's first rank to the world's ranks outside the mesh;
        each rank of the mesh keeps its own. A no-op without such ranks."""
        if not self.spectators:
            return result
        box = [None if self.idle else result]
        dist.broadcast_object_list(box, src=self.root)
        return box[0] if self.idle else result

    def share_rows(self, tree, n: int):
        """Hand a tree of ``n``-row leaves from the mesh's first rank to
        the world's ranks outside the mesh, whose ``tree`` holds leaves of
        no rows and the same trailing shapes: one broadcast over the world
        per dtype. A no-op without such ranks."""
        if not self.spectators:
            return tree
        leaves, treedef = tree_flatten(tree)
        out = list(leaves)
        for dtype in dict.fromkeys(x.dtype for x in leaves):  # rank-stable
            idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
            widths = [math.prod(leaves[i].shape[1:]) for i in idx]
            if self.idle:
                buf = torch.empty((n, sum(widths)), dtype=dtype,
                                  device=leaves[idx[0]].device)
            else:
                buf = torch.cat([leaves[i].reshape(n, -1) for i in idx], 1)
            dist.broadcast(buf, src=self.root)
            if self.idle:
                for i, part in zip(idx, buf.split(widths, dim=1)):
                    out[i] = part.reshape(
                        (n,) + tuple(leaves[i].shape[1:])).contiguous()
        return tree_unflatten(treedef, out)


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
