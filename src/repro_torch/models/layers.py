"""Common transformer layers: RMSNorm, RoPE, SwiGLU MLP, embeddings (a port
of the JAX package's ``repro/models/layers.py``).

Every f32 upcast sits where the JAX package has it, so a bf16 model rounds
at the same places. ``init_*`` functions take a ``torch.Generator`` and a
device and return the same param dicts as JAX's (the logical-axes trees of
the JAX package are not ported). On the ``meta`` device they return shapes
and dtypes only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def mlp(params, x):
    h = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(h.to(torch.float32)).to(x.dtype) * u
    return h @ params["w_down"]


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


def embed(params, tokens, impl: str = "gather"):
    table = params["embedding"]
    if impl == "one_hot":
        oh = F.one_hot(tokens.to(torch.int64), table.shape[0]).to(table.dtype)
        return torch.einsum("bsv,vd->bsd", oh, table)
    return F.embedding(tokens, table)


def unembed(params, x):
    if "head" in params:
        return x @ params["head"]
    return x @ params["embedding"].T


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
