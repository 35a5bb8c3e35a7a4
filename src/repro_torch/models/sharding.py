"""Logical-axis sharding rules (the port's copy of the JAX package's
``repro/models/sharding.py``).

Models name tensor dims with *logical* axes; a context installs the active
mesh plus a logical->mesh translation. Outside any context every helper is
the identity placement, so the same model code runs on one device and on a
mesh.

Logical names used across the model stack:
  "client"  federated client axis (leading axis of FL-stacked params)
  "fsdp"    fully-sharded param dim            -> mesh "replica" (train)
                                                   or "data" (serve, optional)
  "tp"      tensor-parallel param/activation dim -> mesh "model"
  "batch"   data batch                          -> mesh "replica" / "data"
  "seq"     sequence dim (sharded only for long-context decode caches)

The port shards the client axis only (:mod:`repro_torch.core.fl_shard_map`):
each client's replica stays whole on its rank. So :func:`shard_hint` is the
identity wherever every mesh axis it resolves to has size 1, and raises
where a tensor would split over ranks within a client (a model axis over
1: ROADMAP queue 1 item 12b). :class:`PartitionSpec` is a tuple of mesh-axis
names (or ``None``) standing in for ``jax.sharding.PartitionSpec``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

_state = threading.local()


class PartitionSpec(tuple):
    """Mesh axis (or ``None``, or a tuple of axes) per tensor dim;
    trailing ``None`` dims are dropped by :func:`resolve_spec`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _current():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: dict[str, Any]):
    """Install mesh + logical->mesh rules for model code in this thread.
    ``mesh`` is a ``DeviceMesh`` with named dims, or any object whose
    ``shape`` maps axis names to sizes."""
    prev = _current()
    _state.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.ctx = prev


def train_rules() -> dict[str, Any]:
    return {"client": "client", "fsdp": "replica", "tp": "model",
            "batch": "replica", "seq": None, "act": None,
            # weight sharding at the use site; None gathers weights instead
            "wg": "replica"}


def mesh2d_rules() -> dict[str, Any]:
    """Rules for the 2D ("client", "model") federation mesh
    (:mod:`repro_torch.mesh`).

    The client axis is the engine's own (each rank owns a block of client
    replicas), so no logical name maps to it. With a single model axis,
    "fsdp" and "tp" both map to "model" and :func:`resolve_spec` keeps
    whichever dim claims it first (an axis may appear once per spec)."""
    return {"client": None, "fsdp": "model", "tp": "model",
            "batch": None, "seq": None, "act": "model", "wg": None}


def serve_rules(fsdp_over_data: bool = False,
                shard_seq: bool = False) -> dict[str, Any]:
    return {"client": None, "fsdp": "data" if fsdp_over_data else None,
            "tp": "model", "batch": "data",
            "seq": "data" if shard_seq else None, "act": None,
            "kv_tp": "model", "cache_seq": "data" if shard_seq else None,
            "wg": "data" if fsdp_over_data else None}


def _axis_size(mesh, name: str) -> int:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # a torch DeviceMesh
        return int(mesh.shape[list(names).index(name)])
    return int(mesh.shape[name])


def _mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    n = 1
    for a in _atomic_axes(axis):
        n *= _axis_size(mesh, a)
    return n


def _atomic_axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def resolve_spec(logical: tuple, shape: tuple[int, ...] | None = None
                 ) -> PartitionSpec:
    """Translate logical axis names to a PartitionSpec under active rules.

    If ``shape`` is given, any mesh axis that does not divide the dim size
    is dropped (explicit replication). A mesh axis claimed by an earlier
    dim is dropped from later dims (first dim wins)."""
    ctx = _current()
    if ctx is None:
        return P()
    mesh, rules = ctx
    out = []
    used: set = set()
    for i, name in enumerate(logical):
        axis = rules.get(name) if name is not None else None
        if axis is not None and any(a in used for a in _atomic_axes(axis)):
            axis = None
        if axis is not None and shape is not None:
            if shape[i] % _mesh_axis_size(mesh, axis) != 0:
                axis = None
        if axis is not None:
            used.update(_atomic_axes(axis))
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def shard_hint(x, *logical):
    """The identity on ``x``: outside a rules context, and under a mesh
    where every axis the hint resolves to has size 1. A hint that would
    split ``x`` over ranks raises (the model axis: item 12b)."""
    ctx = _current()
    if ctx is None:
        return x
    mesh, _ = ctx
    spec = resolve_spec(logical, tuple(x.shape))
    if any(_mesh_axis_size(mesh, a) > 1 for a in spec if a is not None):
        from repro_torch.api.spec import _not_ported
        raise _not_ported(f"sharding a tensor over {spec} (a model axis "
                          f"over 1)", "item 12b")
    return x


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def _map_logical(fn, tree, shapes):
    if _is_logical(tree):
        return fn(tree, shapes)
    if isinstance(tree, dict):
        return {k: _map_logical(fn, v, None if shapes is None else shapes[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_logical(fn, v, None if shapes is None else shapes[i])
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    raise TypeError(f"not a logical-axis tree: {tree!r}")


def spec_tree(logical_tree, shape_tree=None):
    """Map a pytree of logical-axis tuples to PartitionSpecs (with the
    divisibility drop when ``shape_tree`` gives each leaf's tensor)."""
    return _map_logical(
        lambda lg, arr: resolve_spec(
            lg, None if arr is None else tuple(arr.shape)),
        logical_tree, shape_tree)
