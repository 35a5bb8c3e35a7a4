"""RWKV6 ("Finch") mixer with data-dependent decay (a port of the JAX
package's ``repro/models/rwkv.py``).

Time-mix (per head, state S of shape (hd, hd)):
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + lora(x~_t))) data-dependent per channel.

Channel-mix: squared-ReLU MLP with token shift.

Serving: prefill runs the whole prompt through the hand-written
``rwkv6_scan`` kernel from a zero state; decode runs the same kernel with
S = 1 from the cached state, as the JAX package's decode calls the same
scan as its prefill. With ``rwkv_chunk > 0`` the JAX package prefills
through its chunk-parallel :func:`wkv6_chunked`; the port keeps the kernel,
whose bf16 instance is chunk-parallel itself, and holds it against
``wkv6_chunked``. Training (``rwkv6_timemix_forward_train``) runs the JAX
model's own paths in differentiable torch ops (the kernel has no
backward): the per-token recurrence :func:`wkv6_scan`, or
:func:`wkv6_chunked` when ``rwkv_chunk > 0``.

Under a model axis over 1 (:func:`repro_torch.models.sharding.model_group`)
both routes split the heads, placed by the JAX package's axes
(:data:`repro_torch.models.sharding.RWKV_TM_AXES` / ``RWKV_CM_AXES``):
the projections ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` and ``decay_a``
are split on their d_model rows, so each rank takes its columns of the
token-shift mixes and the partial products are summed in one all-reduce
(:meth:`repro_torch.mesh.collectives.ModelGroup.psum`, whose backward
all-reduces too: each rank then uses its own heads of the sum). The WKV
runs on the rank's heads with its rows of ``bonus_u`` and its columns of
``decay_b``; the RMS norm over d_model sums its squares over the ranks;
``w_o`` is row-parallel into an all-reduce. The whole leaves (the mixes,
``decay_w0``, ``ln_scale``) enter through ``local_slice``, so their
gradient is summed over the ranks and stays whole and alike on each. The
channel mix is row-parallel twice: ``w_k`` / ``w_r`` into one all-reduce,
then the rank's d_ff slice of ``relu(k)^2`` through ``w_v`` into
another. On the serving mesh the prefill's and the decode's
``rwkv6_scan`` run on the rank's (B, H / dm, S, hd) with its rows of
``bonus_u``, from and into the cache's ``wkv`` rows of the rank's heads;
``tm_last`` / ``cm_last`` stay whole (the JAX package's ``cache_axes``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init
from repro_torch.models.sharding import (
    RWKV_CM_AXES,
    RWKV_TM_AXES,
    WHOLE,
    hinted_group,
    shard_hint,
)


def init_rwkv6_timemix(generator, d_model: int, headdim: int = 64,
                       lora_rank: int = 32, dtype=torch.float32,
                       device="cpu"):
    n_heads = d_model // headdim

    def full(value, dt=dtype):
        return torch.full((d_model,), value, dtype=dt, device=device)

    def dense(shape):
        return _dense_init(generator, shape, 0, dtype, device)

    return {
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_w": full(0.5), "mu_g": full(0.5),
        "w_r": dense((d_model, d_model)),
        "w_k": dense((d_model, d_model)),
        "w_v": dense((d_model, d_model)),
        "w_g": dense((d_model, d_model)),
        "w_o": dense((d_model, d_model)),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x @ a) @ b))
        "decay_w0": full(-6.0, torch.float32),
        "decay_a": dense((d_model, lora_rank)),
        "decay_b": dense((lora_rank, d_model)) * 0.1,
        "bonus_u": torch.zeros((n_heads, headdim), dtype=torch.float32,
                               device=device),
        "ln_scale": full(1.0),
    }


def _token_shift(x, last=None):
    """x_{t-1} with zero (or cached) init. x (B, S, d) -> (B, S, d)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


_TM_MIXES = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")


def _tm_inputs(params, x, last=None, grp=WHOLE):
    """r, k, v, g, w and log_decay (B, S, d / dm) of the rank's heads under
    the model group ``grp`` (:data:`WHOLE`: every head). The token shift
    (after ``last``, zeros where ``None``) runs on the rank's columns of x;
    the row-split projections of the rank's columns of the mixes are
    summed in one all-reduce (forward and backward), the decay's LoRA
    finished on the rank's columns of ``decay_b``."""
    lo, hi = grp.bounds(x.shape[-1])
    mus = grp.local_slice(torch.stack([params[m] for m in _TM_MIXES]), -1)
    x = grp.local_slice(x, -1)
    x_prev = _token_shift(x, None if last is None
                          else grp.local_slice(last, -1))
    r, k, v, g, a = grp.psum_all(
        [(x + (x_prev - x) * mu) @ params[w]
         for mu, w in zip(mus.unbind(0), ("w_r", "w_k", "w_v", "w_g",
                                          "decay_a"))])
    lora = torch.tanh(a) @ params["decay_b"]
    w0 = grp.local_slice(params["decay_w0"], 0)
    log_decay = -torch.exp(w0 + lora.to(torch.float32))
    w = torch.exp(log_decay)                               # (B,S,d) in (0,1)
    return (r[..., lo:hi], k[..., lo:hi], v[..., lo:hi], g[..., lo:hi], w,
            log_decay)


def wkv6_scan(r, k, v, w, u, s0=None):
    """Sequential WKV6 recurrence, one token a step (the training route).
    r / k / v / w (B, S, H, hd); u (H, hd). Returns (y (B, S, H, hd) f32,
    final state (B, H, hd, hd) f32)."""
    bsz, s, h, hd = r.shape
    state = (torch.zeros((bsz, h, hd, hd), dtype=torch.float32,
                         device=r.device) if s0 is None else s0)
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    ys = []
    for t in range(s):
        kv = torch.einsum("bhi,bhj->bhij", k[:, t], v[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = state * w[:, t, ..., None] + kv
    return torch.stack(ys, dim=1), state


def wkv6_chunked(r, k, v, log_decay, u, s0=None, chunk: int = 64):
    """Chunk-parallel WKV6 (fla-style): an intra-chunk quadratic form plus
    one state read / write per chunk instead of per token. Exact (every
    exponent is <= 0 under the causal mask, so nothing overflows).

    r / k / v / log_decay (B, S, H, hd); u (H, hd). Returns (y (B, S, H, hd)
    f32, final state (B, H, hd, hd) f32). The JAX package streams the
    intra-chunk decay tensor over (head x channel-block) tiles of 8
    channels; the port takes the same 8-channel blocks for all heads at
    once and sums the blocks' score matrices before the product with v."""
    bsz, s, h, hd = r.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % rwkv chunk {chunk}")
    nc = s // chunk
    if s0 is None:
        s0 = torch.zeros((bsz, h, hd, hd), dtype=torch.float32,
                         device=r.device)
    shp = (bsz, nc, chunk, h, hd)
    rc, kc, vc, ld = (t.to(torch.float32).reshape(shp)
                      for t in (r, k, v, log_decay))
    lc = torch.cumsum(ld, dim=2)                    # L_t = sum_{s<=t} log w_s
    lcm1 = lc - ld                                  # L_{t-1}
    lq = lc[:, :, -1:]                              # L_Q (chunk total)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)   # s < t

    # A[t, s] = sum_i r_t k_s exp(L_{t-1} - L_s), s < t (exponent <= 0)
    blk = min(8, hd)
    a = 0.0
    for i in range(0, hd, blk):
        sl = slice(i, i + blk)
        diff = lcm1[..., None, :, sl] - lc[:, :, None, :, :, sl]
        diff = diff.masked_fill(~tri[:, :, None, None], float("-inf"))
        a = a + torch.einsum("bcthi,bcshi,bctshi->bchts", rc[..., sl],
                             kc[..., sl], torch.exp(diff))
    y_intra = torch.einsum("bchts,bcshj->bcthj", a, vc)

    # bonus (diagonal) term: (r_t . u k_t) v_t
    bonus = torch.einsum("bcthi,hi,bcthi->bcth", rc, u.to(torch.float32), kc)
    y_intra = y_intra + bonus[..., None] * vc

    # inter-chunk: state scan, one (hd, hd) read / write per chunk
    r_tilde = rc * torch.exp(lcm1)                  # exponent <= 0
    k_hat = kc * torch.exp(lq - lc)                 # exponent <= 0
    chunk_states = torch.einsum("bcthi,bcthj->bchij", k_hat, vc)
    chunk_decay = torch.exp(lq[:, :, 0])            # (B, nc, H, hd)
    state, prev = s0, []
    for c in range(nc):
        prev.append(state)                          # state BEFORE chunk c
        state = state * chunk_decay[:, c, ..., None] + chunk_states[:, c]
    y_state = torch.einsum("bcthi,bchij->bcthj", r_tilde,
                           torch.stack(prev, dim=1))
    return (y_intra + y_state).reshape(bsz, s, h, hd), state


def _wkv(r, k, v, w, u, headdim, s0, backend):
    """r / k / v / w (B, S, d) -> heads (B, H, S, hd), the kernel, and
    y back to (B, S, H, hd)."""
    b, s, d = r.shape
    n_heads = d // headdim

    def heads(t):
        return t.reshape(b, s, n_heads, headdim).transpose(1, 2).contiguous()

    y, s_final = ops.rwkv6_scan(heads(r), heads(k), heads(v), heads(w), u,
                                s0, backend=backend)
    return y.transpose(1, 2), s_final


def _tm_output(params, y, g, d_model, grp=WHOLE):
    """The normed, gated WKV output through ``w_o``; under the model group
    ``grp`` y and g are the rank's heads, the norm's mean of squares is
    summed over the ranks and ``w_o`` is row-parallel into an
    all-reduce."""
    bsz, s = y.shape[:2]
    y = y.reshape(bsz, s, -1).to(torch.float32)
    # per-head group norm approximated by full-layer RMS norm
    var = grp.psum(torch.sum(torch.square(y), dim=-1,
                             keepdim=True)) / d_model
    scale = grp.local_slice(params["ln_scale"], 0)
    y = y * torch.rsqrt(var + 1e-6) * scale.to(torch.float32)
    y = y * F.silu(g.to(torch.float32))
    w_o = shard_hint(params["w_o"], "tp", "fsdp")
    out = grp.reduce_out(y.to(w_o.dtype) @ w_o)
    return shard_hint(out, "batch", "seq", None)


def rwkv6_timemix_forward_train(params, x, headdim: int = 64,
                                chunk: int = 0):
    """Full-sequence time-mix on the training route, from a zero state, no
    kernel: :func:`wkv6_scan`, or :func:`wkv6_chunked` when ``chunk`` > 0.
    Returns (B, S, d)."""
    d_model = x.shape[-1]
    grp = hinted_group("the RWKV6 time mix", params, RWKV_TM_AXES)
    r, k, v, g, w, log_decay = _tm_inputs(params, x, grp=grp)

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], -1, headdim)

    if chunk:
        y, _ = wkv6_chunked(heads(r), heads(k), heads(v), heads(log_decay),
                            params["bonus_u"], chunk=chunk)
    else:
        y, _ = wkv6_scan(heads(r), heads(k), heads(v), heads(w),
                         params["bonus_u"])
    return _tm_output(params, y.to(x.dtype), g, d_model, grp)


def rwkv6_timemix_forward(params, x, headdim: int = 64, chunk: int = 0,
                          backend: str = "auto"):
    out, _ = rwkv6_timemix_forward_state(params, x, headdim, chunk,
                                         backend=backend)
    return out


def rwkv6_timemix_forward_state(params, x, headdim: int = 64,
                                chunk: int = 0, backend: str = "auto"):
    """Full-sequence time-mix that also returns the decode cache; the WKV
    recurrence runs in ``ops.rwkv6_scan`` from a zero state, ``chunk`` or
    not. A ``chunk`` > 0 that does not divide the sequence raises, as the
    JAX package's ``wkv6_chunked`` does."""
    if chunk and x.shape[1] % min(chunk, x.shape[1]):
        raise ValueError(f"seq {x.shape[1]} % rwkv chunk {chunk}")
    d_model = x.shape[-1]
    grp = hinted_group("the RWKV6 time mix", params, RWKV_TM_AXES)
    r, k, v, g, w, _ = _tm_inputs(params, x, grp=grp)
    y, s_final = _wkv(r, k, v, w, params["bonus_u"], headdim, None, backend)
    out = _tm_output(params, y.to(x.dtype), g, d_model, grp)
    return out, {"wkv": s_final, "tm_last": x[:, -1:]}


def init_rwkv6_channelmix(generator, d_model: int, d_ff: int,
                          dtype=torch.float32, device="cpu"):
    return {
        "mu_k": torch.full((d_model,), 0.5, dtype=dtype, device=device),
        "mu_r": torch.full((d_model,), 0.5, dtype=dtype, device=device),
        "w_k": _dense_init(generator, (d_model, d_ff), 0, dtype, device),
        "w_v": _dense_init(generator, (d_ff, d_model), 0, dtype, device),
        "w_r": _dense_init(generator, (d_model, d_model), 0, dtype, device),
    }


def rwkv6_channelmix_forward(params, x, x_prev=None):
    """The squared-ReLU channel mix; under a model axis (the training
    route) ``w_k`` / ``w_r`` row-parallel into one all-reduce, the rank's
    d_ff slice of ``relu(k)^2`` through ``w_v`` into another."""
    grp = hinted_group("the RWKV6 channel mix", params, RWKV_CM_AXES)
    mu_k, mu_r = grp.local_slice(torch.stack([params["mu_k"],
                                              params["mu_r"]]), -1).unbind(0)
    x = grp.local_slice(x, -1)              # the shift on the rank's columns
    xp = _token_shift(x, None if x_prev is None
                      else grp.local_slice(x_prev, -1))
    xk = x + (xp - x) * mu_k
    xr = x + (xp - x) * mu_r
    k, kr = grp.reduce_out_all([xk @ params["w_k"], xr @ params["w_r"]])
    k = torch.square(F.relu(k.to(torch.float32))).to(x.dtype)
    k = shard_hint(k, "batch", "seq", "tp")
    kv = grp.reduce_out(grp.local_slice(k, -1) @ params["w_v"])
    r = torch.sigmoid(kr.to(torch.float32))
    return (r * kv.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_rwkv6_cache(batch: int, d_model: int, headdim: int,
                     dtype=torch.float32, device="cpu"):
    n_heads = d_model // headdim
    return {
        "wkv": torch.zeros((batch, n_heads, headdim, headdim),
                           dtype=torch.float32, device=device),
        "tm_last": torch.zeros((batch, 1, d_model), dtype=dtype,
                               device=device),
        "cm_last": torch.zeros((batch, 1, d_model), dtype=dtype,
                               device=device),
    }


def rwkv6_timemix_decode(params, x, cache, headdim: int = 64,
                         backend: str = "auto"):
    """x (B, 1, d); one ``ops.rwkv6_scan`` step (S = 1) from
    ``cache["wkv"]``. Returns ``(out, new cache)``."""
    d_model = x.shape[-1]
    grp = hinted_group("the RWKV6 time mix", params, RWKV_TM_AXES)
    r, k, v, g, w, _ = _tm_inputs(params, x, cache["tm_last"], grp)
    y, s_new = _wkv(r, k, v, w, params["bonus_u"], headdim,
                    cache["wkv"].contiguous(), backend)
    out = _tm_output(params, y.to(x.dtype), g, d_model, grp)
    return out, dict(cache, wkv=s_new, tm_last=x)


def rwkv6_channelmix_decode(params, x, cache):
    out = rwkv6_channelmix_forward(params, x, cache["cm_last"])
    return out, dict(cache, cm_last=x)
