"""numpy <-> torch conversion of whole pytrees, and the carry-over of the
JAX package's transformer params into the port's tree.

Containers (dicts, tuples, NamedTuples such as an optimizer's ``SgdState``)
are kept as they are; only the leaves change type. dtypes carry over, so an
int32 step counter stays int32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import (
    tree_flatten,
    tree_leaf_paths,
    tree_map,
    tree_unflatten,
)


def tree_from_numpy(tree, device):
    """Every array leaf (numpy array, numpy scalar or tensor) as a tensor on
    ``device``; numpy leaves are copied, never shared."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else torch.tensor(np.asarray(x), device=device), tree)


def upload(arr, device) -> torch.Tensor:
    """A host array on ``device``: to a GPU from pinned memory without
    blocking the host (the copy is ordered on the current stream), on the
    CPU as it is (the tensor shares the array's memory)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def tree_upload(tree, device):
    """:func:`upload` of every leaf of a tree of host arrays."""
    return tree_map(lambda x: upload(np.asarray(x), device), tree)


def tree_to_numpy(tree):
    """Every tensor leaf as a host numpy array."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def _tensor_of(arr: np.ndarray) -> torch.Tensor:
    """A numpy array (bfloat16 from ml_dtypes included) as a CPU tensor,
    copied."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def transformer_params_from_jax(np_params, model, device=None,
                                lead: int = 0):
    """The JAX package's ``Transformer.init`` output, carried across as
    numpy arrays, as the port's params tree on ``device`` (default: the
    GPU).

    The tree must have the port's structure (``tree_leaf_paths`` of
    ``model.init``), and every leaf its shape and dtype, after ``lead``
    leading axes (1 for client-stacked params); anything else raises
    ``ValueError``. Nothing is cast."""
    device = resolve_device(device)
    like = model.init(device="meta")
    want, got = tree_leaf_paths(like), tree_leaf_paths(np_params)
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        raise ValueError(f"params tree does not match {model.cfg.name}: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    like_leaves, treedef = tree_flatten(like)
    leaves = []
    for path, x, ref in zip(want, tree_flatten(np_params)[0], like_leaves):
        t = _tensor_of(np.asarray(x))
        if (t.dtype != ref.dtype or t.dim() != ref.dim() + lead
                or tuple(t.shape[lead:]) != tuple(ref.shape)):
            raise ValueError(f"{path}: expected {ref.dtype} "
                             f"{tuple(ref.shape)} after {lead} leading "
                             f"axes, got {t.dtype} {tuple(t.shape)}")
        leaves.append(t.to(device))
    return tree_unflatten(treedef, leaves)
