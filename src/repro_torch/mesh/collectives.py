"""The model axis' collectives: hand-written tensor parallelism on
``torch.distributed``, inside ``torch.func``.

PyTorch has no GSPMD, and DTensor's ``parallelize_module`` does not
compose with ``torch.func.vmap(grad_and_value(...))`` over the client axis,
so the model code places the model axis' collectives itself, Megatron
style, through two autograd functions (:class:`ModelGroup`'s methods):

* :meth:`ModelGroup.copy_in` (identity forward, all-reduce backward)
  before a column-parallel weight: the replicated activation feeds each
  rank's slice of output features, and its gradient is the sum of the
  ranks' parts;
* :meth:`ModelGroup.reduce_out` (all-reduce forward, identity backward)
  after a row-parallel weight: each rank's partial product is summed, and
  the sum is replicated, so each rank's partial gets the sum's gradient as
  it is.

Both are ``torch.autograd.Function`` s in the ``torch.func`` style
(``forward`` plus ``setup_context``, and a ``vmap`` staticmethod that runs
the collective on the physical batched tensor: an all-reduce is element
wise, so the batch dimension is just more elements). A backward runs its
collective through the other function's ``apply``, so it works under the
transforms too. Nothing is reduced in place on an input.
:meth:`ModelGroup.psum` chains the two (all-reduce forward and backward):
a sum that each rank then uses its own way (its heads of a projection,
a norm's denominator over a split width), so each rank's part of the
sum's gradient is summed back. :meth:`ModelGroup.all_max` (no gradient)
serves the vocabulary-parallel softmax.

Only ``all_reduce`` is used, on every backend (gloo does not gather CUDA
tensors): :meth:`ModelGroup.gather` lays each rank's slice into a zero
buffer and sums the buffers' bytes, exact because one addend a byte is
not zero, as :meth:`repro_torch.core.fl_shard_map.ClientGroup
.all_gather_rows` does. It is differentiable too (a weight split on one
dim and used whole, e.g. zamba2's LoRA factors and Mamba2's conv): its
backward is the rank's slice of the gradient summed over the group.
:meth:`ModelGroup.gather_all` gathers many tensors in one such
all-reduce (a serving layer's weights over the data group).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

# collectives over the model group since the last reset: the
# all-reduces of the local steps (forward, backward and the clip norm) and
# the gathers that make a round's outputs whole (and, serving, the data
# group's gathers of a layer's weights)
counts = {"all_reduce": 0, "gather": 0}
_ALIGN = 16          # bytes: each tensor's place in a gather_all buffer


def _reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    counts["all_reduce"] += 1
    return out


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(x, group):
        return _reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _ReduceFromModel.apply(x, group), in_dims[0]


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromModel.apply(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToModel.apply(x, group), in_dims[0]


class _MaxOverModel(torch.autograd.Function):
    """All-reduce (max) forward; no gradient (callers pass detached
    tensors, e.g. the softmax's shift)."""

    @staticmethod
    def forward(x, group):
        return _reduce(x, group, dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _MaxOverModel.apply(x, group), in_dims[0]


def _gather(x, group, index: int, size: int, dim: int):
    shape = list(x.shape)
    per = shape[dim]
    shape[dim] = per * size
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, index * per, per).copy_(x)
    dist.all_reduce(out.view(-1).view(torch.uint8), group=group)
    counts["gather"] += 1
    return out


class _GatherFromModel(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim`` forward; the rank's
    slice of the gradient summed over the group backward."""

    @staticmethod
    def forward(x, group, index, size, dim):
        return _gather(x, group, index, size, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.group, ctx.index, ctx.size, ctx.dim = inputs

    @staticmethod
    def backward(ctx, grad):
        per = grad.shape[ctx.dim] // ctx.size
        whole = _ReduceFromModel.apply(grad, ctx.group)
        return whole.narrow(ctx.dim, ctx.index * per, per), None, None, \
            None, None

    @staticmethod
    def vmap(info, in_dims, x, group, index, size, dim):
        if in_dims[0] is None:
            return _GatherFromModel.apply(x, group, index, size, dim), None
        return _GatherFromModel.apply(x.movedim(in_dims[0], 0), group,
                                      index, size, dim + 1), 0


class ModelGroup:
    """This rank's place on a mesh's model axis and the axis' collectives.
    ``size`` ranks split each client replica; ``index`` is this rank's
    coordinate (its slice of every split dim). ``model_axis`` may be a
    tuple of the mesh's axes, flattened in their order (the first
    slowest): a decode cache's sequence split over ``("data", "model")``.
    Flattening makes a process group, so every rank of the world builds
    such a group together."""

    def __init__(self, mesh, model_axis: str | tuple = "model"):
        if isinstance(model_axis, (tuple, list)):
            if len(model_axis) > 1:
                mesh = mesh[tuple(model_axis)]._flatten()
                model_axis = mesh.mesh_dim_names[0]
            else:
                model_axis = model_axis[0]
        names = list(mesh.mesh_dim_names)
        self.size = int(mesh.shape[names.index(model_axis)])
        coord = mesh.get_coordinate()
        self.index = None if coord is None else int(coord[names.index(
            model_axis)])
        self.group = (None if coord is None
                      else mesh.get_group(model_axis))

    def bounds(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's slice of a dim of ``n`` (divisible)."""
        per = n // self.size
        return self.index * per, (self.index + 1) * per

    def copy_in(self, x):
        return _CopyToModel.apply(x, self.group)

    def reduce_out(self, x):
        return _ReduceFromModel.apply(x, self.group)

    def psum(self, x):
        """``x`` summed over the group, all-reduced forward and backward:
        for a sum each rank consumes in its own way, whose gradient is the
        sum of the ranks' parts."""
        return self.copy_in(self.reduce_out(x))

    def reduce_out_all(self, parts):
        """Each of ``parts`` (alike but for their last dim) summed over the
        group as :meth:`reduce_out` does, in one all-reduce."""
        sizes = [p.shape[-1] for p in parts]
        return list(self.reduce_out(torch.cat(parts, dim=-1))
                    .split(sizes, dim=-1))

    def psum_all(self, parts):
        """Each of ``parts`` summed over the group as :meth:`psum` does, in
        one all-reduce each way."""
        sizes = [p.shape[-1] for p in parts]
        return list(self.psum(torch.cat(parts, dim=-1)).split(sizes, dim=-1))

    def all_max(self, x):
        return _MaxOverModel.apply(x, self.group)

    def local_slice(self, x, dim: int):
        """This rank's slice of the replicated ``x`` along ``dim``: the
        input of a row-parallel weight (differentiable: the gradient of
        ``x`` is summed over the ranks)."""
        lo, hi = self.bounds(x.shape[dim])
        return self.copy_in(x).narrow(dim, lo, hi - lo)

    def all_sum(self, x):
        """``x`` summed over the group (a new tensor; no autograd)."""
        return _reduce(x, self.group)

    def gather_all(self, parts, dims):
        """Each of ``parts`` with the ranks' slices concatenated along its
        dim in ``dims``, as :meth:`gather` gives it, all in one byte-sum
        all-reduce of one zero-padded buffer (no autograd). The results
        are views of that buffer, each segment 16-byte aligned."""
        shapes, offsets, total = [], [], 0
        for x, d in zip(parts, dims):
            shape = list(x.shape)
            shape[d] *= self.size
            shapes.append(shape)
            offsets.append(total)
            n = x.element_size() * math.prod(shape)
            total += -(-n // _ALIGN) * _ALIGN
        buf = torch.zeros(total, dtype=torch.uint8, device=parts[0].device)
        outs = []
        for x, d, shape, at in zip(parts, dims, shapes, offsets):
            n = x.element_size() * math.prod(shape)
            whole = buf[at:at + n].view(x.dtype).view(shape)
            per = x.shape[d]
            whole.narrow(d, self.index * per, per).copy_(x)
            outs.append(whole)
        dist.all_reduce(buf, group=self.group)
        counts["gather"] += 1
        return outs

    def gather(self, x, dim: int):
        """The ranks' slices of ``x`` concatenated along ``dim`` in rank
        order, by a byte sum of zero-padded buffers (exact on every
        backend). Differentiable: the gradient of the slice is the
        rank's part of the whole's gradient, summed over the group."""
        dim = dim % x.dim()
        return _GatherFromModel.apply(x, self.group, self.index, self.size,
                                      dim)
