"""Mamba2 (SSD) mixer, used by zamba2 (a port of the JAX package's
``repro/models/ssm.py``).

State-space recurrence per head h with state (P, N):
    H_t = exp(dt_t * A_h) * H_{t-1} + dt_t * x_t (P) outer B_t (N)
    y_t = H_t @ C_t + D_h * x_t
Serving: prefill runs the chunked SSD scan in the hand-written
``mamba2_ssd`` kernel; decode is the plain one-step recurrence in PyTorch,
as in the JAX package. Both split over a model axis as the training route
does (below): on the serving mesh the prefill's kernel runs on the rank's
(B, S, H / dm, P), and the cache holds the rank's rows of ``h`` and the
whole conv window (every rank convolves every channel). Training (``mamba2_forward_train``) runs the JAX
model's own chunked SSD, :func:`ssd_chunked`, in differentiable torch ops
(the kernel has no backward).

Shapes: d_inner = expand * d_model; H = d_inner / headdim (P = headdim);
B / C shared across heads (single group), state size N = cfg.ssm_state.

Under a model axis over 1 (:func:`repro_torch.models.sharding.model_group`)
the training route splits the heads, placed by the JAX package's axes
(:data:`repro_torch.models.sharding.MAMBA2_AXES`): ``w_in`` is split on
its d_model rows, so the rank's columns of x give a partial projection
summed in one all-reduce (forward and backward: each rank then takes its
own heads of z, x and dt, and B and C whole). ``conv_w`` is split on its
channels (x, then B, then C), which do not line up with the heads (zamba2
at dm 2: 3,648 of 7,296 channels a rank against x's 3,584), so the conv
weight is gathered whole (a differentiable gather: 4 x 7,296 weights,
against a (B, S, 7,296) activation for a conv on the rank's channels)
and the conv runs over every channel on every rank; the rank keeps its
heads of x and the whole B and C. The SSD runs on the rank's heads with
its slices of ``a_log``, ``dt_bias`` and ``d_skip``; the gated RMS norm
over d_inner sums its squares over the ranks; ``w_out`` is row-parallel
into an all-reduce.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init
from repro_torch.models.sharding import (
    MAMBA2_AXES,
    WHOLE,
    hinted_group,
    shard_hint,
)


def init_mamba2(generator, d_model: int, d_state: int, headdim: int = 64,
                expand: int = 2, conv_kernel: int = 4, dtype=torch.float32,
                device="cpu"):
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": _dense_init(generator,
                            (d_model, 2 * d_inner + 2 * d_state + n_heads),
                            0, dtype, device),
        "conv_w": _dense_init(generator,
                              (conv_kernel, d_inner + 2 * d_state), 0, dtype,
                              device),
        "a_log": torch.zeros((n_heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32,
                               device=device),
        "d_skip": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
        "w_out": _dense_init(generator, (d_inner, d_model), 0, dtype, device),
    }


def _split_proj(proj, d_inner, d_state, n_heads):
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w):
    """Depthwise causal conv over seq. xbc (B, S, C); conv_w (K, C)."""
    k = conv_w.shape[0]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s] * conv_w[i] for i in range(k))
    return F.silu(out.to(torch.float32)).to(xbc.dtype)


def _gated_out(params, y, z, d_model, grp=WHOLE):
    """The gated RMS norm over d_inner and ``w_out``; under the model group
    ``grp`` y, z and ``norm_scale`` are the rank's heads' slices, the mean
    of squares is summed over the ranks (d_inner = the slice's width times
    the ranks) and ``w_out`` is row-parallel into an all-reduce."""
    b, s = y.shape[:2]
    y = y.reshape(b, s, -1)
    # RMS-normed gating (Mamba2 uses grouped RMSNorm before out-proj)
    y32 = y.to(torch.float32) * F.silu(z.to(torch.float32))
    var = grp.psum(torch.sum(torch.square(y32), dim=-1,
                             keepdim=True)) / (y32.shape[-1] * grp.size)
    y32 = (y32 * torch.rsqrt(var + 1e-6)
           * params["norm_scale"].to(torch.float32))
    w_out = shard_hint(params["w_out"], "tp", "fsdp")
    out = grp.reduce_out(y32.to(w_out.dtype) @ w_out)
    return shard_hint(out, "batch", "seq", None)


def _einsum(spec: str, *operands):
    """``torch.einsum`` with the operands first promoted to one dtype, as
    ``jnp.einsum`` promotes them (bf16 with f32 -> f32)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in operands))
    return torch.einsum(spec, *(t.to(dt) for t in operands))


def ssd_chunked(x, dt, a, b_in, c_in, chunk: int = 128, h0=None):
    """Chunked SSD scan (the training route): the intra-chunk quadratic
    form plus an inter-chunk state scan, in the JAX model's expressions,
    but for the causal mask, which the port applies to the decay's
    exponent (the JAX package's overflows to NaN at long chunks).

    x (B, S, H, P); dt (B, S, H) (post-softplus); a (H,) negative;
    b_in / c_in (B, S, N). Returns (y (B, S, H, P), final state
    (B, H, P, N))."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by ssd chunk {chunk}")
    nc = s // chunk

    xs = x.reshape(bsz, nc, chunk, h, p)
    dts = dt.reshape(bsz, nc, chunk, h)
    bs = b_in.reshape(bsz, nc, chunk, n)
    cs = c_in.reshape(bsz, nc, chunk, n)

    # log-decay within chunk: l[t] = cumsum(dt * a)
    dta = dts * a[None, None, None, :]                     # (B,nc,Q,H)
    l = torch.cumsum(dta, dim=2)
    l_last = l[:, :, -1:]                                  # (B,nc,1,H)

    # ---- intra-chunk (quadratic within chunk) -----------------------------
    scores = _einsum("bctn,bcsn->bcts", cs, bs)            # (B,nc,Q,Q)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    # the exponent is masked before the exp: above the diagonal l_t - l_s
    # > 0 grows with the chunk (past f32's range at zamba2's 128, where the
    # JAX package's exp(...) * tri gives inf * 0 = NaN)
    decay = torch.exp((l[:, :, :, None, :] - l[:, :, None, :, :])
                      .masked_fill(~tri[None, None, :, :, None],
                                   float("-inf")))
    m = scores[..., None] * decay
    y_intra = _einsum("bctsh,bcsh,bcshp->bcthp", m, dts, xs)

    # ---- chunk states ------------------------------------------------------
    # state contribution of chunk c: sum_s exp(l_last - l_s) dt_s x_s (x) B_s
    w = torch.exp(l_last - l) * dts                        # (B,nc,Q,H)
    chunk_state = _einsum("bcsh,bcshp,bcsn->bchpn", w, xs, bs)
    chunk_decay = torch.exp(l_last[:, :, 0])               # (B,nc,H)

    # ---- inter-chunk state scan -------------------------------------------
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if h0 is None else h0)
    chunk_state = chunk_state.to(torch.float32)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(carry)                      # the state BEFORE chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,H,P,N)

    # ---- inter-chunk contribution to outputs ------------------------------
    y_inter = _einsum("bcth,bctn,bchpn->bcthp", torch.exp(l), cs,
                      h_prevs.to(x.dtype))
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, carry


def _mamba2(params, x, scan, *, d_state: int, headdim: int, expand: int,
            chunk: int):
    """The Mamba2 mixer around its SSD scan, one body for the serving and
    the training routes: ``scan(xh, dt, a, b_in, c_in, chunk)`` returns
    ``(y, final state)`` with chunk ``min(chunk, S)``, which must divide S.
    Under a model axis the rank's heads (see the module's docstring).
    Returns ``(out, final state, the conv's raw input)``."""
    d_model = x.shape[-1]
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    bsz, s = x.shape[:2]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by ssd chunk {chunk}")
    grp = hinted_group("the Mamba2 mixer", params, MAMBA2_AXES)
    proj = grp.psum(grp.local_slice(x, -1) @ params["w_in"])
    conv_w = grp.gather(params["conv_w"], 1)
    lo, hi = grp.bounds(n_heads)
    z, xbc_raw, dt = _split_proj(proj, d_inner, d_state, n_heads)
    xbc = _causal_conv(xbc_raw, conv_w)
    mine = slice(lo * headdim, hi * headdim)        # the rank's heads' x
    xh = xbc[..., mine].reshape(bsz, s, hi - lo, headdim).contiguous()
    xh = shard_hint(xh, "batch", "seq", "tp", None)
    b_in = xbc[..., d_inner:d_inner + d_state].contiguous()
    c_in = xbc[..., d_inner + d_state:].contiguous()
    dt = F.softplus(dt[..., lo:hi].to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, h_final = scan(xh, dt.contiguous(), a, b_in, c_in, chunk)
    y = y + params["d_skip"][None, None, :, None] * xh.to(y.dtype)
    out = _gated_out(params, y.to(x.dtype), z[..., mine], d_model, grp)
    return out, h_final, xbc_raw


def mamba2_forward_train(params, x, *, d_state: int, headdim: int,
                         expand: int, chunk: int = 128):
    """Full-sequence Mamba2 mixer on the training route: :func:`ssd_chunked`
    with chunk ``min(chunk, S)``, no kernel. x (B, S, d) -> (B, S, d)."""
    out, _, _ = _mamba2(params, x, ssd_chunked, d_state=d_state,
                        headdim=headdim, expand=expand, chunk=chunk)
    return out


def mamba2_forward(params, x, *, d_state: int, headdim: int, expand: int,
                   chunk: int = 128, backend: str = "auto"):
    """Full-sequence Mamba2 mixer. x (B, S, d) -> (B, S, d)."""
    out, _ = mamba2_forward_state(params, x, d_state=d_state,
                                  headdim=headdim, expand=expand,
                                  chunk=chunk, backend=backend)
    return out


def mamba2_forward_state(params, x, *, d_state: int, headdim: int,
                         expand: int, chunk: int = 128,
                         backend: str = "auto"):
    """Full-sequence Mamba2 that also returns the decode cache (final SSM
    state + conv window). The SSD scan runs in ``ops.mamba2_ssd`` with chunk
    ``min(chunk, S)``, which must divide S. Its y comes back in x's dtype
    before ``d_skip * x`` is added in f32, where the JAX package adds it to
    its f32 y: in bf16 the port rounds once more."""
    def scan(xh, dt, a, b_in, c_in, chunk):
        return ops.mamba2_ssd(xh, dt, a, b_in, c_in, chunk=chunk,
                              backend=backend)

    out, h_final, xbc_raw = _mamba2(params, x, scan, d_state=d_state,
                                    headdim=headdim, expand=expand,
                                    chunk=chunk)
    cache = {"h": h_final,                          # (B, H, P, N)
             "conv": xbc_raw[:, -(params["conv_w"].shape[0] - 1):]}
    return out, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_mamba2_cache(batch: int, d_model: int, d_state: int, headdim: int,
                      expand: int, conv_kernel: int, dtype=torch.float32,
                      device="cpu"):
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    return {
        "h": torch.zeros((batch, n_heads, headdim, d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_kernel - 1, d_inner + 2 * d_state),
                            dtype=dtype, device=device),
    }


def mamba2_decode(params, x, cache, *, d_state: int, headdim: int,
                  expand: int):
    """One-token step. x (B, 1, d). Under a model axis the prefill's split
    (see the module's docstring): ``w_in`` row-parallel into one
    all-reduce, the whole window convolved with the gathered ``conv_w``,
    the rank's heads of x, dt and z against its rows of ``h``."""
    d_model = x.shape[-1]
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    grp = hinted_group("the Mamba2 mixer", params, MAMBA2_AXES)
    proj = grp.psum(grp.local_slice(x, -1) @ params["w_in"])
    z, xbc, dt = _split_proj(proj, d_inner, d_state, n_heads)
    lo, hi = grp.bounds(n_heads)
    mine = slice(lo * headdim, hi * headdim)        # the rank's heads' x
    # conv over the cached window + this token
    win = torch.cat([cache["conv"], xbc], dim=1)           # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", win,
                            grp.gather(params["conv_w"], 1))
    conv_out = F.silu(conv_out.to(torch.float32)).to(x.dtype)[:, None]
    new_conv = win[:, 1:]
    xin = conv_out[..., mine]
    b_in = conv_out[..., d_inner:d_inner + d_state]
    c_in = conv_out[..., d_inner + d_state:]
    dt = F.softplus(dt[..., lo:hi].to(torch.float32)
                    + params["dt_bias"])[:, 0]
    a = -torch.exp(params["a_log"])
    xh = xin[:, 0].reshape(-1, hi - lo, headdim)
    decay = torch.exp(dt * a[None, :])                     # (B, H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh.to(torch.float32),
                       b_in[:, 0].to(torch.float32))
    h_new = cache["h"] * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, c_in[:, 0].to(torch.float32))
    y = y + params["d_skip"][None, :, None] * xh.to(torch.float32)
    y = y[:, None].to(x.dtype)                             # (B, 1, H, P)
    out = _gated_out(params, y, z[..., mine], d_model, grp)
    return out, {"h": h_new, "conv": new_conv}
