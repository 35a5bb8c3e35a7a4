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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init


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


def _tm_inputs(params, x, x_prev):
    def mix(mu):
        return x + (x_prev - x) * mu

    r = mix(params["mu_r"]) @ params["w_r"]
    k = mix(params["mu_k"]) @ params["w_k"]
    v = mix(params["mu_v"]) @ params["w_v"]
    g = mix(params["mu_g"]) @ params["w_g"]
    xw = mix(params["mu_w"])
    lora = torch.tanh(xw @ params["decay_a"]) @ params["decay_b"]
    log_decay = -torch.exp(params["decay_w0"] + lora.to(torch.float32))
    w = torch.exp(log_decay)                               # (B,S,d) in (0,1)
    return r, k, v, g, w, log_decay


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


def _tm_output(params, y, g, d_model):
    bsz, s = y.shape[:2]
    y = y.reshape(bsz, s, d_model).to(torch.float32)
    # per-head group norm approximated by full-layer RMS norm
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * params["ln_scale"].to(torch.float32)
    y = y * F.silu(g.to(torch.float32))
    w_o = params["w_o"]
    return y.to(w_o.dtype) @ w_o


def rwkv6_timemix_forward_train(params, x, headdim: int = 64,
                                chunk: int = 0):
    """Full-sequence time-mix on the training route, from a zero state, no
    kernel: :func:`wkv6_scan`, or :func:`wkv6_chunked` when ``chunk`` > 0.
    Returns (B, S, d)."""
    d_model = x.shape[-1]
    n_heads = d_model // headdim
    r, k, v, g, w, log_decay = _tm_inputs(params, x, _token_shift(x))

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], n_heads, headdim)

    if chunk:
        y, _ = wkv6_chunked(heads(r), heads(k), heads(v), heads(log_decay),
                            params["bonus_u"], chunk=chunk)
    else:
        y, _ = wkv6_scan(heads(r), heads(k), heads(v), heads(w),
                         params["bonus_u"])
    return _tm_output(params, y.to(x.dtype), g, d_model)


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
    x_prev = _token_shift(x)
    r, k, v, g, w, _ = _tm_inputs(params, x, x_prev)
    y, s_final = _wkv(r, k, v, w, params["bonus_u"], headdim, None, backend)
    out = _tm_output(params, y.to(x.dtype), g, d_model)
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
    xp = _token_shift(x, x_prev)
    xk = x + (xp - x) * params["mu_k"]
    xr = x + (xp - x) * params["mu_r"]
    k = xk @ params["w_k"]
    k = torch.square(F.relu(k.to(torch.float32))).to(x.dtype)
    kv = k @ params["w_v"]
    r = torch.sigmoid((xr @ params["w_r"]).to(torch.float32))
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
    r, k, v, g, w, _ = _tm_inputs(params, x, cache["tm_last"])
    y, s_new = _wkv(r, k, v, w, params["bonus_u"], headdim,
                    cache["wkv"].contiguous(), backend)
    out = _tm_output(params, y.to(x.dtype), g, d_model)
    return out, dict(cache, wkv=s_new, tm_last=x)


def rwkv6_channelmix_decode(params, x, cache):
    out = rwkv6_channelmix_forward(params, x, cache["cm_last"])
    return out, dict(cache, cm_last=x)
