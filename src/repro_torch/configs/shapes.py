"""The four assigned input shapes, and ``input_specs()`` stand-ins for dry
runs: the port's copy of the JAX package's ``repro/configs/shapes.py``.

Decode shapes trace ``decode_step`` (one new token, a KV cache of
seq_len); train_4k traces the DP-PASGD round (tau local steps); prefill_32k
traces ``prefill``. The abstract shapes are tensors on the ``meta`` device
(``jax.ShapeDtypeStruct``'s place): they carry shapes and dtypes and
allocate nothing, not even for llama4-maverick at full depth.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.utils.tree import tree_leaves


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def needs_subquadratic(shape: InputShape) -> bool:
    return shape.name == "long_500k"


def supports_shape(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """long_500k only runs on sub-quadratic decode paths (DESIGN.md §4)."""
    if needs_subquadratic(shape) and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch has no sub-quadratic "
                       "path for 500k decode (DESIGN.md §4)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def meta_params(cfg: ArchConfig):
    """One replica's params as ``meta`` tensors (``Transformer.init`` on
    the meta device: shapes and dtypes, no storage)."""
    from repro_torch.models.transformer import Transformer
    return Transformer(cfg).init(device="meta")


def param_count_estimate(cfg: ArchConfig) -> int:
    """Parameter count of one model replica, from its ``meta`` init."""
    return sum(x.numel() for x in tree_leaves(meta_params(cfg)))


def replica_footprint_bytes(cfg: ArchConfig, optimizer=None) -> int:
    """Bytes of ONE client replica: params + optimizer state, from meta
    shapes. This is the ``FederationSpec.replica_bytes`` hint that
    ``engine="auto"`` reads (``repro_torch.api.engines.resolve_engine``).
    Activations and gradients are excluded (``launch.dryrun`` reports
    them separately)."""
    params = meta_params(cfg)
    leaves = list(tree_leaves(params))
    if optimizer is not None:
        leaves += list(tree_leaves(optimizer.init(params)))
    return sum(x.numel() * x.element_size() for x in leaves)


def input_specs(cfg: ArchConfig, shape: InputShape, n_clients: int = 1,
                tau: int = 1, dtype=torch.bfloat16):
    """Meta-tensor stand-ins for every model input (no allocation).

    train:   {"tokens": (C, tau, B/C, S), "labels": ..., ["prefix": ...]}
    prefill: {"tokens": (B, S), ["prefix": (B, P, d)]}
    decode:  {"tokens": (B,), "pos": ()} (+ caches built separately)
    """
    s, b = shape.seq_len, shape.global_batch
    if shape.kind == "train":
        assert b % n_clients == 0, (b, n_clients)
        bc = b // n_clients
        batch = {
            "tokens": _meta((n_clients, tau, bc, s), torch.int32),
            "labels": _meta((n_clients, tau, bc, s), torch.int32),
        }
        if cfg.prefix_len:
            batch["prefix"] = _meta((n_clients, tau, bc, cfg.prefix_len,
                                     cfg.d_model), dtype)
        return batch
    if shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32)}
        if cfg.prefix_len:
            batch["prefix"] = _meta((b, cfg.prefix_len, cfg.d_model), dtype)
        return batch
    if shape.kind == "decode":
        return {"tokens": _meta((b,), torch.int32),
                "pos": _meta((), torch.int32)}
    raise ValueError(shape.kind)
