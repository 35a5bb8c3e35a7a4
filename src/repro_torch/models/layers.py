"""Common transformer layers: RMSNorm, RoPE, SwiGLU MLP, embeddings (a port
of the JAX package's ``repro/models/layers.py``).

Every f32 upcast sits where the JAX package has it, so a bf16 model rounds
at the same places. ``init_*`` functions take a ``torch.Generator`` and a
device and return the same param dicts as JAX's (the logical-axes trees of
the JAX package live in :func:`repro_torch.models.sharding
.param_logical_axes`). On the ``meta`` device they return shapes and dtypes
only.

Under a model axis over 1 (:func:`repro_torch.models.sharding.model_group`)
the MLP runs column-parallel (``w_gate`` / ``w_up`` split on ``ffn``) then
row-parallel (``w_down``), with one all-reduce forward; the embedding split
on the vocabulary looks each token up on the rank that holds its row
(zeros elsewhere, summed over the ranks), and :func:`lm_loss` takes the
logits of the rank's vocabulary slice through a vocabulary-parallel
softmax cross-entropy (the max, the sum of exponentials and the gold logit
each all-reduced). Norm scales stay whole. Another placement (a custom
rule splitting another dim) raises ``NotImplementedError``. On the serving
mesh :func:`unembed` gathers the tied embedding's vocabulary slices of the
logits over the model group (an untied head, split on its d_model rows,
takes the rank's columns of x into an all-reduce), so every rank holds
the same (B, V) logits bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import (
    EMBED_AXES,
    MLP_AXES,
    hinted_group,
    model_dim,
    model_group,
)


def _normal(generator, shape, device):
    """Standard normal f32 of ``shape``; on the meta device an empty tensor
    (shapes only, the generator is not used)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def _dense_init(generator, shape, in_axis: int = 0, dtype=torch.float32,
                device="cpu"):
    """N(0, 1) / sqrt(fan_in) in f32, then cast to ``dtype``, as JAX's."""
    scale = 1.0 / math.sqrt(shape[in_axis])
    return (_normal(generator, shape, device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding (computed on the fly from positions)
# ---------------------------------------------------------------------------

def rope_angles(positions, head_dim: int, theta: float):
    """positions (...,) -> cos / sin (..., head_dim // 2), float32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python-scalar base: no host-to-device copy (and no blocking sync)
    # on every attention call; the same f32 powers as a tensor base
    freqs = torch.pow(float(theta), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, hd); cos / sin (..., S, hd // 2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    x32_1, x32_2 = x1.to(torch.float32), x2.to(torch.float32)
    out = torch.cat([x32_1 * c - x32_2 * s, x32_2 * c + x32_1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP (dense FFN used by every assigned arch)
# ---------------------------------------------------------------------------

def init_mlp(generator, d_model: int, d_ff: int, dtype=torch.float32,
             device="cpu"):
    return {
        "w_gate": _dense_init(generator, (d_model, d_ff), 0, dtype, device),
        "w_up": _dense_init(generator, (d_model, d_ff), 0, dtype, device),
        "w_down": _dense_init(generator, (d_ff, d_model), 0, dtype, device),
    }


def _not_covered(what: str, dims):
    return NotImplementedError(
        f"{what} placed {dims} under a model axis: the port's tensor "
        f"parallelism covers the split mesh2d_rules and serve_mesh_rules "
        f"give (or none)")


def mlp(params, x):
    grp = hinted_group("the MLP", params, MLP_AXES)
    x = grp.copy_in(x)               # column-parallel in
    h = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(h.to(torch.float32)).to(x.dtype) * u
    out = h @ params["w_down"]
    return grp.reduce_out(out)       # row-parallel out


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------

def init_embed(generator, vocab: int, d_model: int, tie_head: bool = True,
               dtype=torch.float32, device="cpu"):
    params = {"embedding": _dense_init(generator, (vocab, d_model), 1, dtype,
                                       device)}
    if not tie_head:
        params["head"] = _dense_init(generator, (d_model, vocab), 0, dtype,
                                     device)
    return params


def _lookup(table, tokens, impl: str):
    if impl == "one_hot":
        oh = F.one_hot(tokens.to(torch.int64), table.shape[0]).to(table.dtype)
        return torch.einsum("bsv,vd->bsd", oh, table)
    return F.embedding(tokens, table)


def embed(params, tokens, impl: str = "gather"):
    table = params["embedding"]
    grp = model_group()
    dim = model_dim("tp", "fsdp")
    if grp is None or dim < 0:
        return _lookup(table, tokens, impl)
    if dim != 0:
        raise _not_covered("the embedding", dim)
    # vocabulary-parallel: each token's row on the rank that holds it
    v = table.shape[0]
    local = tokens - grp.index * v
    inside = (local >= 0) & (local < v)
    e = _lookup(table, torch.where(inside, local, 0), impl)
    return grp.reduce_out(torch.where(inside[..., None], e, 0.0))


def unembed(params, x):
    """The logits of the hidden states ``x``: under a model axis the whole
    vocabulary on every rank, from the tied embedding's vocabulary slices
    (gathered over the model group) or from an untied head's d_model rows
    (the rank's columns of x, summed in one all-reduce)."""
    grp = hinted_group("the LM head", params, EMBED_AXES)
    if "head" in params:
        return grp.reduce_out(grp.local_slice(x, -1) @ params["head"])
    return grp.gather(grp.copy_in(x) @ params["embedding"].T, -1)


def lm_loss(params, x, labels, ignore_id: int = -1):
    """The mean token cross-entropy of the LM head on the hidden states
    ``x``: ``cross_entropy(unembed(params, x), labels)``, and under a model
    axis that splits the tied embedding on the vocabulary its
    vocabulary-parallel form (an untied head is not covered: no arch of the
    repo has one)."""
    grp = model_group()
    dim = -1 if grp is None else model_dim("tp", "fsdp")
    if dim < 0 and (grp is None or "head" not in params):
        return cross_entropy(unembed(params, x), labels, ignore_id)
    if dim != 0 or "head" in params:
        raise _not_covered("the LM head", dim)
    w = params["embedding"]                    # this rank's (V_local, d)
    return vocab_parallel_cross_entropy(
        grp, grp.copy_in(x) @ w.T, labels, grp.index * w.shape[0], ignore_id)


def vocab_parallel_cross_entropy(grp, logits, labels, lo: int,
                                 ignore_id: int = -1):
    """:func:`cross_entropy` of logits whose vocabulary is split over the
    model group ``grp``: ``logits`` holds this rank's columns, vocabulary
    ids ``[lo, lo + V_local)``. The softmax's shift is the max over every
    rank (no gradient), the sum of exponentials and the gold logit are
    summed over the ranks."""
    logits = logits.to(torch.float32)
    m = grp.all_max(torch.amax(logits.detach(), dim=-1))
    sumexp = grp.reduce_out(torch.sum(torch.exp(logits - m[..., None]),
                                      dim=-1))
    logz = torch.log(sumexp) + m
    local = labels.to(torch.int64) - lo
    inside = (local >= 0) & (local < logits.shape[-1]) & (labels != ignore_id)
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    gold = grp.reduce_out(torch.where(inside, gold[..., 0], 0.0))
    nll = logz - gold
    mask = (labels != ignore_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def cross_entropy(logits, labels, ignore_id: int = -1):
    """Mean token cross-entropy in fp32. labels (B, S) integer."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    # ignored labels gather any valid entry: their nll is masked out below
    idx = torch.where(labels == ignore_id, 0, labels).to(torch.int64)
    gold = torch.gather(logits, -1, idx[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
