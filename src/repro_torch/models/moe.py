"""Mixture-of-Experts FFN (phi3.5-moe 16e top-2, llama4 128e top-1 + shared),
a port of the JAX package's ``repro/models/moe.py``.

Token-choice top-k routing with per-group capacity. Two dispatch
implementations:

  "scatter" (baseline): ``index_add`` of the tokens into per-expert buffers,
      one batched expert matmul, a gather back. Memory O(E * capacity * d):
      no (T, E, C) dispatch tensor is ever materialized.
  "dense" (GShard-style): a one-hot dispatch einsum; the oracle of the
      tests.

Both are plain PyTorch, as the JAX package's are plain jnp: no TPU kernel
carries MoE. The groups of the JAX package's ``vmap`` are a leading batch
axis here, so the whole dispatch is a handful of batched calls; it runs
under ``torch.func.vmap(grad_and_value(...))`` (the DP step's form): the
one-hots are comparisons with ``arange`` (``F.one_hot`` is data-dependent
control flow there). Aux losses: the switch load-balance loss plus 1e-3 of
the router z-loss, averaged over groups.

``_iterative_top_k`` (an XLA partitioner workaround selected by
``ArchConfig.scan_unroll``) is not ported: ``moe_apply(iterative_topk=True)``
raises.

Under a model axis over 1 (:func:`repro_torch.models.sharding.model_group`)
the experts are split over the ranks (expert parallelism, the JAX
package's ``("tp", ...)`` hints: :data:`repro_torch.models.sharding
.MOE_AXES`), where GSPMD inserts a token all-to-all: the router runs whole
on every rank, so routing, ranks, capacity (from the whole expert count)
and the aux loss are alike everywhere; each rank dispatches the tokens
routed to its E / dm experts (the others land in the overflow row), runs
them and combines their outputs, and the partial outputs are summed in
one all-reduce. The tokens and the combine weights enter the rank's
dispatch through ``copy_in``, so their gradients (and the router's) are
summed over the ranks. llama4's shared expert is the dense MLP, split on
its own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init, init_mlp, mlp
from repro_torch.models.sharding import MOE_AXES, hinted_group, shard_hint


def _expert_init(generator, shape, dtype, device):
    """(E, fan_in, fan_out) expert weights, N(0, 1 / fan_in) as JAX's
    ``_dense_init(..., in_axis=1)``, drawn one expert's slab at a time so
    that only one (fan_in, fan_out) f32 slab is ever live beside the result
    (a whole f32 draw of llama4's (128, 5120, 8192) is 21.5 GB)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type != "meta":
        for e in range(shape[0]):
            out[e].copy_(_dense_init(generator, tuple(shape[1:]), 0, dtype,
                                     device))
    return out


def init_moe(generator, d_model: int, d_ff: int, n_experts: int, top_k: int,
             shared_expert: bool = False, dtype=torch.float32, device="cpu"):
    params = {
        "router": _dense_init(generator, (d_model, n_experts), 0,
                              torch.float32, device),
        "w_gate": _expert_init(generator, (n_experts, d_model, d_ff), dtype,
                               device),
        "w_up": _expert_init(generator, (n_experts, d_model, d_ff), dtype,
                             device),
        "w_down": _expert_init(generator, (n_experts, d_ff, d_model), dtype,
                               device),
    }
    if shared_expert:
        params["shared"] = init_mlp(generator, d_model, d_ff, dtype, device)
    return params


def _expert_ffn(params, xe):
    """xe (G, E, C, d) -> (G, E, C, d), batched over groups and experts
    (under a model axis the rank's experts)."""
    w_gate = shard_hint(params["w_gate"], *MOE_AXES["w_gate"])
    w_up = shard_hint(params["w_up"], *MOE_AXES["w_up"])
    w_down = shard_hint(params["w_down"], *MOE_AXES["w_down"])
    h = torch.einsum("gecd,edf->gecf", xe, w_gate)
    u = torch.einsum("gecd,edf->gecf", xe, w_up)
    h = F.silu(h.to(torch.float32)).to(xe.dtype) * u
    return torch.einsum("gecf,efd->gecd", h, w_down)


def _experts_here(params):
    """(model group, first expert, experts) of this rank: :data:`WHOLE`
    and the whole expert range without a model axis that splits them."""
    grp = hinted_group("the MoE experts", params, MOE_AXES)
    e_here = params["w_gate"].shape[0]
    return grp, grp.index * e_here, e_here


def _finish(params, x, y, grp, orig_shape):
    """The routed output summed over the ranks of ``grp``, in ``x``'s
    shape, plus the shared expert."""
    y = shard_hint(grp.reduce_out(y).reshape(orig_shape), "batch", "seq",
                   None)
    if "shared" in params:
        y = y + mlp(params["shared"], x)
    return y


def _one_hot(ids, n: int, dtype):
    """``jax.nn.one_hot`` as a comparison with ``arange`` (runs under
    ``torch.func.vmap``, where ``F.one_hot`` does not)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _route(params, x, top_k: int):
    """x (G, T, d) -> weights (G, T, K) f32, ids (G, T, K), aux (G,) f32."""
    logits = torch.einsum("gtd,de->gte", x.to(torch.float32),
                          params["router"])
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                                    min=1e-9)
    # switch load-balance loss: E * sum_e f_e * p_e
    e = params["router"].shape[1]
    f = torch.mean(_one_hot(ids[..., 0], e, torch.float32), dim=1)
    p = torch.mean(probs, dim=1)
    lb = e * torch.sum(f * p, dim=-1)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)), dim=-1)
    return weights, ids, lb + 1e-3 * z


def capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    c = int(tokens * top_k * factor / n_experts)
    return max(8, (c + 7) // 8 * 8)


def _regroup(x):
    """Dispatch groups: per batch row for long sequences; the whole batch as
    one group for decode (S <= 8), where per-row capacity would pad each
    row's token to a full min-capacity expert buffer."""
    bsz, s, d = x.shape
    if s <= 8:
        return x.reshape(1, bsz * s, d)
    return x


def _ranks(flat_ids, e: int, cap: int):
    """Each (token, k) assignment's rank within its expert, in token order,
    and whether it fits the capacity. flat_ids (G, T*K)."""
    oh = _one_hot(flat_ids, e, torch.int32)                 # (G, T*K, E)
    ranks = torch.cumsum(oh, dim=1) - oh
    rank = torch.sum(ranks * oh, dim=-1)                    # (G, T*K)
    return rank, rank < cap


def _flat_slots(slot, n: int):
    """Per-group slots (G, T*K) as rows of one flat (G * n, d) buffer:
    group i owns rows [i * n, (i + 1) * n)."""
    offsets = torch.arange(slot.shape[0], device=slot.device)[:, None] * n
    return (slot + offsets).reshape(-1)


def _dispatch(xg, slot, top_k: int, n: int):
    """``index_add`` of every (token, k) assignment of xg (G, S, d) into its
    slot of a per-group (n, d) buffer (n = E * cap + 1: the last row takes
    the overflow). Returns (G, n, d) in xg's dtype."""
    g, s, d = xg.shape
    x_rep = torch.repeat_interleave(xg, top_k, dim=1).reshape(g * s * top_k,
                                                              d)
    buf = torch.zeros((g * n, d), dtype=xg.dtype, device=xg.device)
    return buf.index_add(0, _flat_slots(slot, n), x_rep).view(g, n, d)


def _combine(ye, slot, scale, top_k: int):
    """The gather back: each assignment's expert output (ye (G, E, cap, d);
    the overflow slot reads zeros) times ``scale`` (G, T*K) (weight x keep,
    cast to the activations' dtype before the product, as JAX's), summed
    over k. Returns (G, T, d)."""
    g, e, cap, d = ye.shape
    n = e * cap + 1
    y_tok = torch.cat([ye.reshape(g, e * cap, d),
                       torch.zeros((g, 1, d), dtype=ye.dtype,
                                   device=ye.device)], dim=1)
    gathered = y_tok.reshape(g * n, d)[_flat_slots(slot, n)]
    gathered = gathered.reshape(g, -1, d) * scale[..., None].to(ye.dtype)
    return torch.sum(gathered.reshape(g, -1, top_k, d), dim=2)


def moe_scatter(params, x, *, top_k: int, capacity_factor: float = 1.25):
    """x (B, S, d) -> (y, aux). Scatter / gather dispatch, per group:
    :func:`_route`, the ranks in token order (:func:`_ranks`; an
    assignment past the capacity goes to the overflow slot E * cap),
    :func:`_dispatch`, the experts, :func:`_combine`, the shared expert."""
    orig_shape = x.shape
    xg = _regroup(x)
    g, s, d = xg.shape
    e = params["router"].shape[1]
    cap = capacity(s, e, top_k, capacity_factor)
    weights, ids, aux = _route(params, xg, top_k)
    flat_ids = ids.reshape(g, s * top_k)
    rank, keep = _ranks(flat_ids, e, cap)
    scale = weights.reshape(g, s * top_k) * keep
    grp, e0, e_here = _experts_here(params)
    xg, scale = grp.copy_in(xg), grp.copy_in(scale)
    local = flat_ids - e0
    here = keep & (local >= 0) & (local < e_here)
    slot = torch.where(here, local * cap + rank, e_here * cap)
    buf = _dispatch(xg, slot, top_k, e_here * cap + 1)
    ye = _expert_ffn(params, buf[:, :-1].reshape(g, e_here, cap, d))
    y = _combine(ye, slot, scale, top_k)
    return _finish(params, x, y, grp, orig_shape), torch.mean(aux)


def moe_dense(params, x, *, top_k: int, capacity_factor: float = 1.25):
    """Reference GShard-style dense-dispatch implementation (the oracle)."""
    orig_shape = x.shape
    xg = _regroup(x)
    g, s, d = xg.shape
    e = params["router"].shape[1]
    cap = capacity(s, e, top_k, capacity_factor)
    weights, ids, aux = _route(params, xg, top_k)
    flat_ids = ids.reshape(g, s * top_k)
    flat_w = weights.reshape(g, s * top_k)
    rank, keep = _ranks(flat_ids, e, cap)
    grp, e0, e_here = _experts_here(params)
    xg, flat_w = grp.copy_in(xg), grp.copy_in(flat_w)
    # an expert of another rank matches no column of the one-hot
    disp = (_one_hot(flat_ids - e0, e_here, torch.float32)[..., None]
            * _one_hot(rank, cap, torch.float32)[..., None, :]
            ) * keep[..., None, None]                       # (G, T*K, E, C)
    x_rep = torch.repeat_interleave(xg, top_k, dim=1)
    xe = torch.einsum("gtec,gtd->gecd", disp.to(x.dtype), x_rep)
    ye = _expert_ffn(params, xe)
    comb = disp * flat_w[..., None, None]
    y = torch.einsum("gtec,gecd->gtd", comb.to(ye.dtype), ye)
    y = torch.sum(y.reshape(g, s, top_k, d), dim=2)
    return _finish(params, x, y, grp, orig_shape), torch.mean(aux)


def moe_apply(params, x, *, top_k: int, capacity_factor: float = 1.25,
              impl: str = "scatter", iterative_topk: bool = False):
    if iterative_topk:
        raise ValueError("iterative_topk (moe._iterative_top_k, an XLA "
                         "partitioner workaround) is not ported")
    fn = moe_scatter if impl == "scatter" else moe_dense
    return fn(params, x, top_k=top_k, capacity_factor=capacity_factor)
