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

**The slab round.** A rank's state between rounds is its slab: its
client block's rows and, at ``dm > 1``, its model slices of params and
optimizer state (step counters whole), described by a
:class:`SlabLayout`. The slab round (``round_step.slab_round``) takes and
returns only that: the block's batch rows, sigmas and (block, tau,
N_local) noise in, the same layout out, plus the metrics. The local rounds
run under the model context, where the Eq.-7a clip norm is the norm of the
whole per-client gradient (a sum over the model ranks); Eq. 7b is one
all-reduce over the client group, on the slices, and under
``full_average`` the average is widened to the block's rows only. No tree
is gathered whole. The pipeline form keeps the JAX package's stage 2:
each update row is gathered whole over the model group with the block's
whole params (the anchor), ``quantize_decompress`` and top-k run on whole
rows, the rank keeps its columns of the result, and the error-feedback
residual is the block's rows, whole in D (client-sharded and
model-replicated, as JAX's).

The noise a rank draws is its slab's addresses of the round's whole draw:
the counter-based generator (:mod:`repro_torch.kernels.counter_rng`)
draws the block's rows and the slab's columns, split leaves first
(:func:`repro_torch.kernels.ops.split_order`), a whole leaf's columns the
same on every model rank (else the replicas drift and nothing reports
it). So the slab round is row for row the ``vmap`` round.

**The whole-tree round** (what :func:`make_mesh_2d_round` returns, for
callers with whole trees) is the same body: it takes its slab of the
whole operands (:meth:`SlabLayout.take`, ``to_local``,
:func:`local_noise`), runs the slab round, and gathers the outputs whole:
an average (under ``full_average`` the params, with ``average_opt_state``
the optimizer state) from its row 0 over the model group, widened to C
rows; per-client rows over the model group and the client group
(:func:`from_slab`). With dividing clients at ``dm = 1`` this is
``engine="shard_map"``'s round (:mod:`repro_torch.core.fl_shard_map`).

Ranks of the world outside the mesh (fewer slabs than ranks) hold a
layout of no rows (:attr:`SlabLayout.idle`): each round they receive only
the metrics, and the whole trees come to them from the mesh's first rank
only when a caller asks (:func:`from_slab`, :func:`slab_eval_model`).

Clients that do not divide ``dc`` are padded to ``Cp = ceil(C/dc) * dc``
rows. Pad rows are copies of client 0's operands and read client 0's
random addresses, so their local rounds compute real (finite) values and
nothing poisons a mean through ``NaN * 0``; a ``valid`` 0/1 vector drops
them from every aggregate exactly
(:func:`repro_torch.core.fl.tree_valid_mean_axis0`; the pipeline path
zeroes the pad rows' participation mask, which its masked sums already
handle). Each rank takes only its own block's rows (``index_select``),
where the JAX package pads through ``dynamic_update_slice``, an XLA
workaround that PyTorch does not need.

The adversarial extensions (robust aggregators, secure sum, update
attacks) are full-view reductions over exactly ``n_clients`` rows,
gathered over the client group inside the round, as the JAX package's
``shard_map`` gathers them: they need dividing clients and a model axis
of 1, so ``FederationSpec`` refuses them on ``engine="mesh_2d"`` and
``engine="shard_map"`` (whose mesh is such) runs them here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.fl import (
    FLConfig,
    check_topology,
    make_local_rounds,
    tree_valid_mean_axis0,
)
from repro_torch.core.fl_shard_map import ClientGroup, block_mean, widen
from repro_torch.kernels.counter_rng import slab_table, whole_table
from repro_torch.kernels.ops import split_order
from repro_torch.launch.mesh import make_mesh_2d
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
from repro_torch.utils.device import device_constant
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


@dataclass(frozen=True, eq=False)
class SlabLayout:
    """Where one rank's slab of a sharded federation's state lies: the
    mesh ``(dc, dm)``, the rank's client block ``client_index`` (rows
    ``client_index * block ...``; pad rows past the last client read client
    0's operands and address and weigh 0) and model coordinate
    ``model_index``, and the split dims of one client's params
    (``param_dims``, :func:`repro_torch.models.sharding.param_split_dims`)
    and optimizer state (``state_dims``, step counters whole), with the
    whole shapes of the params' leaves in ``jax.tree.flatten`` order
    (``shapes``). On a rank outside the mesh both indices are ``None``:
    it holds no rows, and its (empty) leaves keep their whole shapes."""
    mesh_shape: tuple
    n_clients: int
    client_index: int | None
    model_index: int | None
    param_dims: Any
    state_dims: Any
    shapes: tuple

    @property
    def idle(self) -> bool:
        """Whether this rank is outside the mesh."""
        return self.client_index is None

    @property
    def block(self) -> int:
        return -(-self.n_clients // self.mesh_shape[0])

    @property
    def n_rows(self) -> int:
        """The rows this rank holds: its block, none outside the mesh."""
        return 0 if self.idle else self.block

    @property
    def dividing(self) -> bool:
        """Whether the clients divide the client axis (no pad rows)."""
        return self.block * self.mesh_shape[0] == self.n_clients

    @property
    def _dm(self) -> int:
        """The model split of this rank's leaves (none outside the mesh)."""
        return 1 if self.idle else self.mesh_shape[1]

    @cached_property
    def rows(self) -> tuple:
        """The block's global row ids, pad rows 0 (client 0's)."""
        lo = 0 if self.idle else self.client_index * self.block
        return tuple(r if r < self.n_clients else 0
                     for r in range(lo, lo + self.n_rows))

    @cached_property
    def valid(self) -> tuple:
        lo = 0 if self.idle else self.client_index * self.block
        return tuple(1.0 if r < self.n_clients else 0.0
                     for r in range(lo, lo + self.n_rows))

    @cached_property
    def table(self) -> tuple:
        """The counter generator's column table of this slab
        (:func:`repro_torch.kernels.counter_rng.slab_table`)."""
        if self.idle:
            return whole_table(self.n_whole)
        return slab_table(self.shapes, tree_flatten(self.param_dims)[0],
                          self.model_index, self.mesh_shape[1])

    @cached_property
    def n_local(self) -> int:
        """Columns of the slab's flat row: split leaves' slices, then the
        whole leaves."""
        return sum(math.prod(s) // (self._dm if d >= 0 else 1)
                   for s, d in zip(self.shapes,
                                   tree_flatten(self.param_dims)[0]))

    @cached_property
    def n_whole(self) -> int:
        return sum(math.prod(s) for s in self.shapes)

    def take(self, tree, axis: int = 0):
        """The block's rows (pad rows: client 0's) along ``axis`` of every
        leaf of ``tree``, host numpy or tensors."""
        if self.rows == tuple(range(self.n_clients)):
            return tree
        idx = np.asarray(self.rows, np.int64)

        def one(x):
            if isinstance(x, torch.Tensor):
                return x.index_select(axis, device_constant(self.rows,
                                                            x.device))
            return np.take(np.asarray(x), idx, axis=axis)

        return tree_map(one, tree)

    def take_state(self, x):
        """The block's rows of per-client state ``x`` (C, D), numpy or a
        tensor, pad rows zero (they carry none)."""
        return self.zero_pad(self.take(x))

    def zero_pad(self, x):
        """The block's rows ``x`` (block, D) with pad rows zeroed."""
        if self.dividing:
            return x
        if isinstance(x, torch.Tensor):
            return x * self.valid_on(x.device)[:, None]
        return x * np.asarray(self.valid, np.float32)[:, None]

    def valid_on(self, device) -> torch.Tensor:
        return device_constant(self.valid, device, torch.float32)

    def whole_rows(self, x):
        """The whole (C, ...) rows of the block's per-client rows ``x``
        that no model dim splits (a residual), alike on every rank of the
        world: :func:`from_slab` of one leaf."""
        return from_slab(self, x, -1)


def slab_layout(mesh_shape, n_clients: int, params, opt_state, rules=None
                ) -> SlabLayout:
    """This rank's :class:`SlabLayout` on the mesh ``mesh_shape`` for one
    client's ``params`` and ``opt_state`` (no client axis; real, meta or
    numpy leaves); on a rank outside the mesh, a layout of no rows."""
    mesh = make_mesh_2d(tuple(mesh_shape))
    coord = mesh.get_coordinate()
    dm = int(mesh_shape[1])
    dims = param_split_dims(params, dm, mesh2d_rules() if rules is None
                            else dict(rules))
    names = list(mesh.mesh_dim_names)
    return SlabLayout(
        mesh_shape=(int(mesh_shape[0]), dm), n_clients=int(n_clients),
        client_index=(None if coord is None
                      else int(coord[names.index(CLIENT_AXIS)])),
        model_index=(None if coord is None
                     else int(coord[names.index(MODEL_AXIS)])),
        param_dims=dims, state_dims=state_split_dims(opt_state, params,
                                                     dims),
        shapes=tuple(tuple(x.shape) for x in tree_flatten(params)[0]))


def _groups(layout: SlabLayout):
    mesh = make_mesh_2d(layout.mesh_shape)
    return (ClientGroup(mesh, CLIENT_AXIS),
            ModelGroup(mesh, MODEL_AXIS) if layout.mesh_shape[1] > 1
            else None)


def to_slab(layout: SlabLayout, tree, dims, lead: int = 1):
    """The rank's slab of a whole tree (leaves (C, ...) with ``lead`` 1, or
    one client's with ``lead`` 0): the block's rows, then the model
    slices along ``dims`` (host numpy stays numpy). Outside the mesh: no
    rows, nothing sliced."""
    if lead:
        tree = layout.take(tree)
    if layout._dm == 1:
        return tree
    return to_local(tree, dims, layout.model_index, layout.mesh_shape[1],
                    lead=lead)


def from_slab(layout: SlabLayout, tree, dims):
    """:func:`to_slab` undone on every rank of the world: the model slices
    gathered over the model group, the blocks over the client group
    (byte-sum all-reduces), pad rows dropped: the whole (C, ...) tree,
    which ranks outside the mesh receive from its first rank
    (:meth:`~repro_torch.core.fl_shard_map.ClientGroup.share_rows`)."""
    grp, mgrp = _groups(layout)
    if not layout.idle:
        if mgrp is not None:
            tree = to_whole(tree, dims, mgrp, lead=1)
        if layout.mesh_shape[0] > 1:
            tree = grp.all_gather_tree(tree)
        if not layout.dividing:
            tree = tree_map(lambda x: x[:layout.n_clients].contiguous(),
                            tree)
    return grp.share_rows(tree, layout.n_clients)


def slab_eval_model(layout: SlabLayout, params, topology: str):
    """The one evaluation model of slab ``params``, whole and alike on
    every rank of the world: row 0 under ``full_average`` (every row holds
    the average), else the mean of the valid rows (the block's sums
    all-reduced over the client group, over C, in f32), gathered whole
    over the model group; ranks outside the mesh receive it from the
    mesh's first rank."""
    grp, mgrp = _groups(layout)
    if layout.idle:
        one = tree_map(lambda x: x[:0], params)
    elif topology == "full_average":
        one = tree_map(lambda x: x[:1], params)
    else:
        denom = torch.tensor(float(layout.n_clients),
                             device=tree_flatten(params)[0][0].device)
        one = tree_map(lambda x: x.unsqueeze(0), tree_valid_mean_axis0(
            params, layout.valid_on(denom.device), denom,
            all_sum=grp.all_sum))
    if mgrp is not None and not layout.idle:
        one = to_whole(one, layout.param_dims, mgrp, lead=1)
    return tree_map(lambda x: x[0], grp.share_rows(one, 1))


def make_mesh_2d_round(loss_fn: Callable, optimizer: Optimizer,
                       cfg: FLConfig, mesh, *, rules=None,
                       topology: str = "full_average", pipeline=None):
    """Build the whole-tree ``round_step`` on a 2D ("client", "model") mesh
    with the signature and randomness operands of the other engines:
    ``(params, opt_state, batch, noise, sigmas) -> (params, opt_state,
    metrics)``, or with ``pipeline`` the 8-operand masked / residual form.
    It takes its slab of the whole operands, runs the slab round and
    gathers the outputs whole. The slab round itself is
    ``round_step.slab_round(layout, params, opt_state, batch, noise,
    sigmas[, mask, residual, agg_rand])``: every operand the block's rows
    (pad rows: client 0's), params and optimizer state the rank's model
    slices and the noise its (block, tau, N_local) columns, outputs in the
    same layout, plus the metrics (the drivers keep slab state,
    :mod:`repro_torch.api.state`); a rank outside the mesh holds no rows
    and receives only the metrics. ``round_step.layout(params,
    opt_state)`` is this rank's :class:`SlabLayout` for one client's
    trees. ``rules`` is a logical->mesh dict for the model axis' placement
    (default :func:`repro_torch.models.sharding.mesh2d_rules`); with a
    model axis of 1 nothing is placed and no rules are installed. The
    adversarial extensions need clients that divide the client axis and a
    model axis of 1 (as ``engine="shard_map"``'s mesh always has): they
    gather every client's update row inside the round."""
    check_topology(topology, pipeline)
    dc, dm = _mesh_dims(mesh)
    n_clients = cfg.n_clients
    adversarial = pipeline is not None and (
        pipeline.aggregator is not None or pipeline.secure is not None
        or pipeline.attack is not None)
    if adversarial and (n_clients % dc or dm > 1):
        raise ValueError(
            f"the adversarial extensions (robust aggregator / secure sum "
            f"/ update attack) need clients that divide the client axis "
            f"and a model axis of 1: their full-view reductions do not "
            f"compose with pad rows or model slices ({n_clients} clients "
            f"on a ({dc}, {dm}) mesh)")
    grp = ClientGroup(mesh, CLIENT_AXIS)
    mgrp = ModelGroup(mesh, MODEL_AXIS) if dm > 1 else None
    rules = mesh2d_rules() if rules is None else dict(rules)
    local_rounds = make_local_rounds(loss_fn, optimizer, cfg)
    full = topology == "full_average"
    avg_s = full and cfg.average_opt_state
    layouts: dict = {}

    def layout_of(params, opt_state):
        """The layout for one client's trees, once per structure and
        shapes."""
        key = tuple((tuple(x.shape), x.dtype)
                    for x in tree_flatten(params)[0])
        if key not in layouts:
            layouts[key] = slab_layout((dc, dm), n_clients, params,
                                       opt_state, rules)
        return layouts[key]

    def run_local(lay, p_l, s_l, batch_b, noise_l, sig_b):
        """The block's local rounds: whole at dm = 1; at dm > 1 on this
        rank's slices under the model context."""
        if mgrp is None:
            return local_rounds(p_l, s_l, batch_b, noise_l, sig_b)
        with axis_rules(mesh, rules, placement=lay.param_dims):
            return local_rounds(p_l, s_l, batch_b, noise_l, sig_b)

    def slab_round(lay, p_l, s_l, batch_b, noise_l, sig_b):
        if lay.idle:            # outside the mesh: the metrics only
            return p_l, s_l, grp.share(None)
        new_p, new_s, ms = run_local(lay, p_l, s_l, batch_b, noise_l, sig_b)
        block = sig_b.shape[0]
        if lay.dividing:
            # ---- Eq. (7b) as shard_map's: block means, one all-reduce
            p_avg, s_avg, ms = block_mean(grp, new_p, new_s, ms, full,
                                          avg_s)
        else:
            # ---- Eq. (7b) with pad rows weighted out: one all-reduce
            denom = torch.tensor(float(n_clients), device=sig_b.device)
            p_avg, s_avg, ms = tree_valid_mean_axis0(
                (new_p if full else {}, new_s if avg_s else {}, ms),
                lay.valid_on(sig_b.device), denom, all_sum=grp.all_sum)
        if full:            # the average widened to the block's rows
            new_p = tree_broadcast_axis0(p_avg, block)
        if avg_s:
            new_s = tree_broadcast_axis0(s_avg, block)
        return new_p, new_s, grp.share(ms)

    def slab_round_pipeline(lay, p_l, s_l, batch_b, noise_l, sig_b, mask_b,
                            res_b, rand_b):
        if lay.idle:            # outside the mesh: the metrics only
            return p_l, s_l, res_b, grp.share(None)
        if not lay.dividing:
            valid = lay.valid_on(sig_b.device)
            mask_b = mask_b * valid
            res_b = None if res_b is None else res_b * valid[:, None]
        new_p, new_s, ms = run_local(lay, p_l, s_l, batch_b, noise_l, sig_b)
        if mgrp is not None:
            # the JAX package's stage 2: update rows whole over the model
            # group, with the block's whole params the anchor
            p_l = to_whole(p_l, lay.param_dims, mgrp, lead=1)
            new_p = to_whole(new_p, lay.param_dims, mgrp, lead=1)
        # the adversarial extensions gather every client's row inside the
        # round (JAX's shard_map does so too); the result is the block's
        new_p, new_s, res_b, ms = pipeline.aggregate(
            p_l, new_p, new_s, s_l, res_b, mask_b, rand_b, ms,
            all_sum=grp.all_sum, all_gather=grp.all_gather_rows)
        if mgrp is not None:       # the rank keeps its columns
            new_p = to_local(new_p, lay.param_dims, mgrp.index, dm, lead=1)
        return new_p, new_s, res_b, grp.share(ms)

    def whole_operands(params, opt_state, batch, noise, sigmas):
        """This rank's layout and slab of the whole operands."""
        lay = layout_of(tree_map(lambda x: x[0], params),
                        tree_map(lambda x: x[0], opt_state))
        p_b, s_b, batch_b, noise_b, sig_b = lay.take(
            (params, opt_state, batch, noise, sigmas))
        if mgrp is not None and not lay.idle:
            p_b = to_local(p_b, lay.param_dims, mgrp.index, dm, lead=1)
            s_b = to_local(s_b, lay.state_dims, mgrp.index, dm, lead=1)
            noise_b = local_noise(noise_b, tree_map(lambda x: x[0], params),
                                  lay.param_dims, mgrp.index, dm)
        return lay, p_b, s_b, batch_b, noise_b, sig_b

    def whole_out(lay, tree, dims, averaged: bool):
        """A slab output made whole: an average (every row alike) from its
        row 0, gathered over the model group only and widened to C rows;
        else every block row, over both groups (:func:`from_slab`)."""
        if not averaged:
            return from_slab(lay, tree, dims)
        one = tree_map(lambda x: x[:1], tree)
        if mgrp is not None and not lay.idle:
            one = to_whole(one, dims, mgrp, lead=1)
        return widen(grp.share_rows(one, 1), n_clients)

    def round_step(params, opt_state, batch, noise, sigmas):
        lay, *ops = whole_operands(params, opt_state, batch, noise, sigmas)
        new_p, new_s, ms = slab_round(lay, *ops)
        return (whole_out(lay, new_p, lay.param_dims, full),
                whole_out(lay, new_s, lay.state_dims, avg_s), ms)

    def round_step_pipeline(params, opt_state, batch, noise, sigmas, mask,
                            residual, agg_rand):
        lay, *ops = whole_operands(params, opt_state, batch, noise, sigmas)
        mask_b, res_b = lay.take((mask, residual))
        # the secure sum's pair masks are whole on every rank; the
        # compressor's operand has a row per client
        rand_b = (lay.take(agg_rand) if pipeline.secure is None
                  else (lay.take(agg_rand[0]), agg_rand[1]))
        new_p, new_s, res_b, ms = slab_round_pipeline(
            lay, *ops, mask_b, res_b, rand_b)
        return (whole_out(lay, new_p, lay.param_dims, True),
                whole_out(lay, new_s, lay.state_dims, avg_s),
                None if res_b is None else from_slab(lay, res_b, -1), ms)

    fn = round_step if pipeline is None else round_step_pipeline
    fn.slab_round = slab_round if pipeline is None else slab_round_pipeline
    fn.layout = layout_of
    return fn
