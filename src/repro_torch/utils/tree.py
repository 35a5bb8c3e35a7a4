"""Pytree utilities over nested dicts / tuples / lists / NamedTuples.

Leaves come out in ``jax.tree.flatten`` order: dict keys sorted, tuple and
NamedTuple fields in order, ``None`` an empty subtree. Code that lays leaves
end to end (the flat clip+noise buffer) relies on that order, so a noise
vector drawn for one package addresses the same parameters in the other.

The walks are module-level functions that take their accumulator as an
argument: a nested function that calls itself is a reference cycle, and
its closure would keep every leaf (a model's weights, on the device) alive
until Python's cycle collector happens to run.
"""
from __future__ import annotations

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(x, leaves):
    if x is None:
        return ("none",)
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_flatten(x[k], leaves) for k in keys))
    if _is_namedtuple(x):
        return ("namedtuple", type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return (type(x), None, tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return ("leaf",)


def tree_flatten(tree):
    """-> (leaves, treedef). ``treedef`` is a nested tuple of node records."""
    leaves = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def _build(d, it):
    kind = d[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    if kind == "namedtuple":
        return d[1](*(_build(c, it) for c in d[2]))
    return kind(_build(c, it) for c in d[2])


def tree_unflatten(treedef, leaves):
    return _build(treedef, iter(leaves))


def _paths(x, prefix, paths):
    if x is None:
        return
    if isinstance(x, dict):
        items = [(str(k), x[k]) for k in sorted(x)]
    elif _is_namedtuple(x):
        items = list(zip(x._fields, x))
    elif isinstance(x, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(x)]
    else:
        paths.append("/".join(prefix))
        return
    for name, v in items:
        _paths(v, prefix + [name], paths)


def tree_leaf_paths(tree) -> list[str]:
    """The path of every leaf, in :func:`tree_flatten` order, named as
    ``jax.tree_util.tree_flatten_with_path`` names it: dict keys,
    NamedTuple field names and sequence indices joined by "/"."""
    paths = []
    _paths(tree, [], paths)
    return paths


def _structure(treedef):
    """treedef with NamedTuple classes replaced by their field names, so two
    NamedTuple classes with the same fields count as one structure."""
    kind = treedef[0]
    if kind in ("leaf", "none"):
        return treedef
    meta = treedef[1]._fields if kind == "namedtuple" else treedef[1]
    return (kind, meta, tuple(_structure(c) for c in treedef[2]))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if _structure(r_def) != _structure(treedef):
            raise ValueError("tree_map: trees have different structures")
        others.append(r_leaves)
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_sq_norm(a):
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(a)]
    total = leaves[0]
    for x in leaves[1:]:
        total = total + x
    return total


def tree_mean_over_axis0(a, keep_dtype: bool = False):
    """Mean over a leading (client) axis of every leaf.

    ``keep_dtype=True`` returns each mean in its leaf's dtype: f32-and-wider
    floats take the plain mean, sub-f32 floats accumulate in f32, and integer
    leaves (optimizer step counters, equal across replicas) take replica 0.
    Without it integer leaves are promoted to f32 before the mean, as
    ``jnp.mean`` does (``torch.mean`` of an integer tensor raises)."""
    def _mean(x):
        if not torch.is_floating_point(x):
            if keep_dtype:
                return x[0]
            return torch.mean(x.to(torch.float32), dim=0)
        if not keep_dtype or torch.finfo(x.dtype).bits >= 32:
            return torch.mean(x, dim=0)
        return torch.mean(x.to(torch.float32), dim=0).to(x.dtype)

    return tree_map(_mean, a)


def tree_broadcast_axis0(a, n: int):
    """Tile every leaf along a new leading axis of size n (materialized)."""
    return tree_map(lambda x: x.unsqueeze(0).expand((n,) + tuple(x.shape))
                    .contiguous(), a)
