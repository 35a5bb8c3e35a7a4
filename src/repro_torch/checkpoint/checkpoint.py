"""Checkpointing: pytree <-> on-disk, in the JAX package's layout.

Layout of a checkpoint directory:
    meta.json              leaf paths, shapes, dtypes, step, extra metadata
    arrays/<idx>.npy       one file per leaf, split into
                           arrays/<idx>.<part>.npy chunks above 1 GiB

Leaf paths are named as ``jax.tree_util.tree_flatten_with_path`` names them
(dict keys, NamedTuple field names and sequence indices joined by "/", e.g.
``opt_state/step``), so the two packages read each other's arrays. Leaves
are tensors or numpy arrays; they are written from the host.

Under a ``torch.distributed`` world every rank holds the same full state
when it writes (``repro_torch.api.save_state`` gathers a sharded engine's
slab state whole once first, and ranks outside the mesh receive it), so
rank 0 writes and the other ranks wait at a barrier (:func:`one_writer`).
A checkpoint is the same whatever layout wrote it, and loads into any.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import (
    tree_flatten,
    tree_leaf_paths,
    tree_unflatten,
)

_CHUNK_BYTES = 1 << 30   # split leaves bigger than 1 GiB


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


@contextlib.contextmanager
def one_writer():
    """Yield whether this process writes: rank 0 of an initialized process
    group, or the only process. Every rank meets at a barrier on exit, so
    no rank reads what is not written yet."""
    import torch.distributed as dist
    world = dist.is_available() and dist.is_initialized()
    yield not world or dist.get_rank() == 0
    if world:
        dist.barrier()


def save_checkpoint(directory: str, tree: Any, step: int = 0,
                    extra: dict | None = None) -> None:
    with one_writer() as writer:
        if writer:
            _write_checkpoint(directory, tree, step, extra)


def _write_checkpoint(directory: str, tree: Any, step: int,
                      extra: dict | None) -> None:
    os.makedirs(os.path.join(directory, "arrays"), exist_ok=True)
    leaves, _ = tree_flatten(tree)
    meta = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(zip(tree_leaf_paths(tree), leaves)):
        arr = _to_numpy(leaf)
        n_parts = max(1, (arr.nbytes + _CHUNK_BYTES - 1) // _CHUNK_BYTES)
        meta["leaves"].append({
            "path": path, "index": i, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "parts": int(n_parts),
        })
        if n_parts == 1:
            np.save(os.path.join(directory, "arrays", f"{i}.npy"), arr)
        else:
            flat = arr.reshape(-1)
            for p, part in enumerate(np.array_split(flat, n_parts)):
                np.save(os.path.join(directory, "arrays", f"{i}.{p}.npy"),
                        part)
    tmp = os.path.join(directory, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(directory, "meta.json"))


def _read_meta(directory: str) -> dict:
    with open(os.path.join(directory, "meta.json")) as f:
        return json.load(f)


def checkpoint_leaf_paths(directory: str) -> list[str]:
    """The leaf paths stored in a checkpoint (reads meta.json only), so a
    caller can ask for an optional subtree only when it is there."""
    return [rec["path"] for rec in _read_meta(directory)["leaves"]]


def load_checkpoint(directory: str, like: Any | None = None):
    """Returns (tree, step, extra) with numpy leaves. With ``like`` the tree
    has its structure (every path of ``like`` must be stored); otherwise a
    nested dict is rebuilt from the paths."""
    meta = _read_meta(directory)
    arrays = {}
    for rec in meta["leaves"]:
        i = rec["index"]
        if rec["parts"] == 1:
            arr = np.load(os.path.join(directory, "arrays", f"{i}.npy"))
        else:
            parts = [np.load(os.path.join(directory, "arrays",
                                          f"{i}.{p}.npy"))
                     for p in range(rec["parts"])]
            arr = np.concatenate(parts).reshape(rec["shape"])
        arrays[rec["path"]] = arr.astype(rec["dtype"])

    if like is not None:
        paths = tree_leaf_paths(like)
        missing = [p for p in paths if p not in arrays]
        if missing:
            raise ValueError(f"checkpoint missing leaves: {missing[:5]}...")
        _, treedef = tree_flatten(like)
        return (tree_unflatten(treedef, [arrays[p] for p in paths]),
                meta["step"], meta["extra"])

    root: dict = {}
    for path, arr in arrays.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root, meta["step"], meta["extra"]


def save_federation_state(directory: str, fed) -> None:
    """Persist a ``repro_torch.api.Federation``: its FLState + sigmas and
    history.

    Thin sugar over ``repro_torch.api.save_state`` (which handles the
    arrays and the accountant snapshot); use that directly for functional
    drivers.
    """
    from repro_torch.api.state import save_state
    save_state(directory, fed.state,
               extra={"sigmas": np.asarray(fed.sigmas).tolist(),
                      "history": fed.history})


def load_federation_state(directory: str, fed) -> None:
    """Restore a Federation saved by :func:`save_federation_state`."""
    from repro_torch.api.state import load_state
    state, extra = load_state(directory, fed.state)
    fed.restore(state, history=extra.get("history"))
