"""The port's transformer training path against the JAX package's, on the
CPU at ``smoke_variant`` size in f32: the token task
(``repro_torch.data.tokens``), the training mixers
(``attention.blocked_causal_attention``, ``chunked_causal_attention``,
``rwkv.wkv6_scan``, ``rwkv.wkv6_chunked``, ``ssm.ssd_chunked``) and one
DP-PASGD round with JAX's noise injected. ``Transformer.loss_fn`` /
``_chunked_loss`` and their ``torch.func`` gradients are held in
``tests/test_torch_train_loss.py``, with this file's tolerances.

Weights are JAX's own ``Transformer.init`` carried across by
``transformer_params_from_jax``; tokens and mixer operands are made with
numpy from a seed and fed to both packages.

Tolerances, per tensor, ``max|port - jax| <= TOL * max(1, max|jax|)``:
- MODEL_TOL = 2e-5 (the model stack's, tests/test_torch_models.py) for the
  mixers, the losses and the round's params;
- GRAD_TOL = 4e-5 for the loss gradients. The largest measured gap is
  2.34e-5, zamba2's embedding gradient, where JAX's own f32 result lies
  2.24e-5 from the same gradient computed in float64 by the port and the
  port's f32 result 8.1e-6 from it: the gap is JAX's rounding. Every other
  arch stays below 1.2e-6.

On a GPU machine without jax, the ``gpu`` test alone runs:
``PYTHONPATH=src python3 -m pytest --noconftest -m gpu
tests/test_torch_train.py -q``.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.func import grad_and_value

try:        # the reference; absent where only the gpu test runs
    import jax
    import jax.numpy as jnp
    from test_torch_fl import jax_round_noise

    import repro.api as japi
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import smoke_variant as jax_smoke_variant
    from repro.configs.base import Segment as JSegment
    from repro.data.tokens import FederatedTokenStream as JStream
    from repro.data.tokens import TokenTaskConfig as JTask
    from repro.models import attention as jattn
    from repro.models import rwkv as jrwkv
    from repro.models import ssm as jssm
    from repro.models.transformer import Transformer as JaxTransformer
    from repro.optim import sgd as jsgd
except ImportError:
    pass

import repro_torch.api as tapi
import repro_torch.kernels.ops as tops
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import Segment
from repro_torch.data.tokens import FederatedTokenStream, TokenTaskConfig
from repro_torch.launch.train import build_federation
from repro_torch.models import attention, rwkv, ssm
from repro_torch.models.transformer import Transformer
from repro_torch.optim import sgd
from repro_torch.utils.convert import (
    transformer_params_from_jax,
    tree_from_numpy,
    tree_to_numpy,
)
from repro_torch.utils.tree import tree_flatten, tree_leaf_paths, tree_map

MODEL_TOL = 2e-5
GRAD_TOL = 4e-5
B, S = 2, 16
LOSS_CHUNK = 8
MODEL_KERNELS = ("flash_attention", "rwkv6_scan", "mamba2_ssd")


def _close(got, want, tol, what):
    got = (got.detach().to(torch.float32).numpy()
           if isinstance(got, torch.Tensor) else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 0.0)
    assert gap <= tol * scale, f"{what}: gap {gap} scale {scale}"


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------- the token task ------------------------------

@pytest.mark.parametrize("prefix_len", [0, 3])
def test_token_stream_is_jax_bit_for_bit(prefix_len):
    kw = dict(vocab=1000, seq_len=12, n_clients=5, seed=3)
    stream = FederatedTokenStream(TokenTaskConfig(**kw), 2,
                                  prefix_len=prefix_len, d_model=8)
    jstream = JStream(JTask(**kw), 2, prefix_len=prefix_len, d_model=8)
    np.testing.assert_array_equal(stream.client_topics, jstream.client_topics)
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for client, tau in ((0, 1), (4, 3), (2, 2), (4, 1)):
        got = stream.sampler(client, tau, rng)
        want = jstream.sampler(client, tau, jrng)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert got["tokens"].shape == (tau, 2, 12)


# ------------------------------ the training mixers --------------------------

@pytest.mark.parametrize("window,block_q,q_start,buckets,sq", [
    (0, 8, 0, False, 32),       # full causal, 4 blocks
    (0, 5, 0, False, 23),       # ragged: the last block padded
    (6, 8, 0, False, 32),       # sliding window, kv sliced per block
    (20, 8, 0, False, 32),      # window + block >= seq: no kv slice
    (4, 8, 6, False, 26),       # a prefix of 6 at the head of the kv
    (0, 4, 0, True, 32),        # power-of-two kv buckets
])
def test_blocked_causal_attention_matches_jax(window, block_q, q_start,
                                              buckets, sq):
    rng = np.random.default_rng(sq + window)
    q = _normal(rng, 2, sq, 4, 8)
    k = _normal(rng, 2, q_start + sq, 2, 8)
    v = _normal(rng, 2, q_start + sq, 2, 8)
    got = attention.blocked_causal_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        window=window, block_q=block_q, q_start=q_start,
        causal_buckets=buckets)
    want = jattn.blocked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=block_q, q_start=q_start, causal_buckets=buckets)
    _close(got, want, MODEL_TOL, "attention")


def test_bucketed_attention_refuses_a_ragged_seq():
    x = torch.zeros((1, 10, 2, 4))
    with pytest.raises(ValueError):
        attention.blocked_causal_attention(x, x, x, block_q=4,
                                           causal_buckets=True)


@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_scan_matches_jax(with_s0):
    rng = np.random.default_rng(5)
    r, k, v = (_normal(rng, 2, 12, 3, 8, scale=0.5) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (2, 12, 3, 8)).astype(np.float32)
    u = _normal(rng, 3, 8)
    s0 = _normal(rng, 2, 3, 8, 8) if with_s0 else None
    t = (lambda a: None if a is None else torch.as_tensor(a))
    y, st = rwkv.wkv6_scan(t(r), t(k), t(v), t(w), t(u), t(s0))
    jy, jst = jrwkv.wkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                              s0=None if s0 is None else jnp.asarray(s0))
    _close(y, jy, MODEL_TOL, "wkv y")
    _close(st, jst, MODEL_TOL, "wkv state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax(dtype):
    """bf16 x / b / c are promoted to f32 against dt and the decays, as
    ``jnp.einsum`` promotes them, so both dtypes meet the model tolerance
    (bf16: 6.2e-8 measured)."""
    rng = np.random.default_rng(9)
    x = _normal(rng, 2, 24, 3, 8)
    dt = rng.uniform(0.1, 1.0, (2, 24, 3)).astype(np.float32)
    a = -rng.uniform(0.5, 1.5, (3,)).astype(np.float32)
    b_in, c_in = _normal(rng, 2, 24, 5), _normal(rng, 2, 24, 5)
    tdt = getattr(torch, dtype)
    y, h = ssm.ssd_chunked(torch.as_tensor(x).to(tdt), torch.as_tensor(dt),
                           torch.as_tensor(a), torch.as_tensor(b_in).to(tdt),
                           torch.as_tensor(c_in).to(tdt), chunk=8)
    jdt = getattr(jnp, dtype)
    jy, jh = jssm.ssd_chunked(jnp.asarray(x, jdt), jnp.asarray(dt),
                              jnp.asarray(a), jnp.asarray(b_in, jdt),
                              jnp.asarray(c_in, jdt), chunk=8)
    assert y.dtype == torch.float32 and jy.dtype == jnp.float32
    _close(y, jy, MODEL_TOL, "ssd y")
    _close(h, jh, MODEL_TOL, "ssd state")


def _mixer_case(arch):
    """(port model, params of step 0 of the arch's first mixer layer, its
    LayerSpec, an input (B, S, d))."""
    model = Transformer(smoke_variant(get_arch(arch)))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    spec = model.cfg.segments[0].pattern[0]
    lp = tree_map(lambda t: t[0], params["segments"][0]["0"])
    x = torch.as_tensor(_normal(np.random.default_rng(2), B, S,
                                model.cfg.d_model, scale=0.5))
    return model, params, spec, lp, x


@pytest.mark.parametrize("arch", ["gemma3-4b", "codeqwen1.5-7b",
                                  "rwkv6-1.6b", "zamba2-7b"])
def test_training_mixers_match_the_serving_forward(arch):
    """Each arch's first mixer on the training route against the same mixer
    on the serving route (the kernels' plain versions on the CPU)."""
    model, params, spec, lp, x = _mixer_case(arch)
    positions = torch.arange(S)
    shared = params.get("shared")
    got = model._apply_mixer(spec, lp, shared, x, positions, train=True)
    want = model._apply_mixer(spec, lp, shared, x, positions)
    _close(got, want.numpy(), MODEL_TOL, f"{arch} {spec.mixer}")
    if arch == "zamba2-7b":       # its mamba2 layers (the first is attention)
        spec = model.cfg.segments[0].pattern[1]
        lp = tree_map(lambda t: t[0], params["segments"][0]["1"])
        _close(model._apply_mixer(spec, lp, shared, x, positions, train=True),
               model._apply_mixer(spec, lp, shared, x, positions).numpy(),
               MODEL_TOL, "zamba2 mamba2")


def test_training_route_refuses_what_is_not_ported():
    """``moe._iterative_top_k`` (an XLA workaround) is not ported:
    ``iterative_topk=True`` raises. What the JAX package refuses, the port
    refuses: a chunked layer or a chunked WKV6 whose chunk does not divide
    the sequence."""
    from repro_torch.models import moe
    p = {"wq": torch.ones((4, 1, 4)), "wk": torch.ones((4, 1, 4)),
         "wv": torch.ones((4, 1, 4)), "wo": torch.ones((1, 4, 4))}
    with pytest.raises(ValueError, match="not divisible by chunk"):
        attention.attention_forward_train(p, torch.ones((1, 6, 4)),
                                          torch.arange(6), kind="chunk",
                                          chunk=4)
    tm = rwkv.init_rwkv6_timemix(torch.Generator().manual_seed(0), 64, 32,
                                 4)
    with pytest.raises(ValueError, match="rwkv chunk"):
        rwkv.rwkv6_timemix_forward_train(tm, torch.ones((1, 12, 64)), 32,
                                         chunk=8)
    mp = moe.init_moe(torch.Generator().manual_seed(0), 4, 8, 2, 1)
    with pytest.raises(ValueError, match="iterative_topk"):
        moe.moe_apply(mp, torch.ones((1, 4, 4)), top_k=1,
                      iterative_topk=True)


def _attn_case(seed, s, h=4, kv=2, hd=8, d=16):
    rng = np.random.default_rng(seed)
    p = {"wq": _normal(rng, d, h, hd, scale=0.3),
         "wk": _normal(rng, d, kv, hd, scale=0.3),
         "wv": _normal(rng, d, kv, hd, scale=0.3),
         "wo": _normal(rng, h, hd, d, scale=0.3)}
    return p, _normal(rng, 2, s, d)


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 8), (8, 16), (16, 16)])
def test_chunked_attention_matches_jax_on_both_routes(s, chunk):
    """A chunked (llama4 iRoPE) layer across chunk boundaries (and within
    one chunk, plain causal): the training route's
    ``chunked_causal_attention`` and the serving route's one
    ``flash_attention`` call over (B * n_chunks, H, chunk, hd) against JAX's
    ``attention_forward(kind="chunk")``, and the training route's input
    gradient against JAX's."""
    p, x = _attn_case(s + chunk, s)
    pos = np.arange(s)
    kw = dict(kind="chunk", chunk=chunk, rope_theta=5e5)
    want = jattn.attention_forward(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), jnp.asarray(pos), **kw)
    tp = tree_map(torch.as_tensor, p)
    train = attention.attention_forward_train(tp, torch.as_tensor(x),
                                              torch.as_tensor(pos), **kw)
    serve = attention.attention_forward(tp, torch.as_tensor(x),
                                        torch.as_tensor(pos), **kw)
    _close(train, want, MODEL_TOL, "chunked train route")
    _close(serve, want, MODEL_TOL, "chunked serving route")
    jg = jax.grad(lambda x: jnp.sum(jattn.attention_forward(
        jax.tree.map(jnp.asarray, p), x, jnp.asarray(pos), **kw) ** 2))(
        jnp.asarray(x))
    g, _ = grad_and_value(lambda x: torch.sum(
        attention.attention_forward_train(tp, x, torch.as_tensor(pos),
                                          **kw) ** 2))(torch.as_tensor(x))
    _close(g, jg, GRAD_TOL, "chunked train route grad")


# ------------------------------ one DP-PASGD round ---------------------------

C, TAU = 2, 2
SIGMAS = (0.3, 0.7)


class _Spy:
    """Counts calls of ``repro_torch.kernels.ops``' model kernels (the
    model calls them only through that module)."""

    def __init__(self, names):
        self.counts = dict.fromkeys(names, 0)
        self.real = {n: getattr(tops, n) for n in names}
        for n, real in self.real.items():
            setattr(tops, n, self._wrap(n, real))

    def _wrap(self, name, real):
        def spy(*a, **kw):
            self.counts[name] += 1
            return real(*a, **kw)
        return spy

    def restore(self):
        for n, real in self.real.items():
            setattr(tops, n, real)


def _spy_model_kernels():
    return _Spy(MODEL_KERNELS)


def _round_cfgs():
    """gemma3's smoke widths, cut to one swa and one full layer: both
    attention masks in two layers."""
    def cut(cfg, seg):
        pattern = cfg.segments[0].pattern
        return replace(cfg, segments=(seg(1, (pattern[0],
                                              replace(pattern[0],
                                                      attn_kind="full"))),),
                       n_layers=2)
    return (cut(jax_smoke_variant(jax_get_arch("gemma3-4b")), JSegment),
            cut(smoke_variant(get_arch("gemma3-4b")), Segment))


def test_dp_round_matches_jax_with_its_noise():
    """One DP-PASGD round (C 2, tau 2) of a smoke transformer in both
    packages from JAX's weights and the same token batches, JAX's noise
    injected: params and the round's loss within the model tolerance, and
    no model kernel called on the training route."""
    jcfg, tcfg = _round_cfgs()
    jm, model = JaxTransformer(jcfg), Transformer(tcfg)
    jp0 = jm.init(jax.random.PRNGKey(1))
    p0 = transformer_params_from_jax(jax.tree.map(np.asarray, jp0), model,
                                     "cpu")
    common = dict(n_clients=C, tau=TAU, clip_norm=1.0, sigmas=SIGMAS,
                  batch_sizes=(B,) * C)
    jspec = japi.FederationSpec(loss_fn=jm.loss_fn, optimizer=jsgd(0.05),
                                kernel_backend="ref", **common)
    tspec = tapi.FederationSpec(loss_fn=model.loss_fn, optimizer=sgd(0.05),
                                **common)
    js = japi.init_state(jspec, jp0)
    ts = tapi.init_state(tspec, p0, device="cpu")
    stream = FederatedTokenStream(
        TokenTaskConfig(vocab=tcfg.vocab, seq_len=S, n_clients=C), B)
    batch = tapi.round_batch(tspec, stream.sampler, np.random.default_rng(4))
    noise = jax_round_noise(js.key, jp0, C, TAU)
    js, jrec = japi.run_round(jspec, js, batch, check_budgets=False)
    calls = _spy_model_kernels()
    try:
        tp, _, tms = tapi.round_fn_for(tspec)(
            ts.params, ts.opt_state, tree_from_numpy(batch, "cpu"), noise,
            torch.as_tensor(np.asarray(SIGMAS, np.float32)))
    finally:
        calls.restore()
    assert calls.counts == dict.fromkeys(MODEL_KERNELS, 0)
    _close(tms["loss"], jrec["loss"], MODEL_TOL, "round loss")
    want = jax.tree.leaves(jax.tree.map(np.asarray, js.params))
    got = tree_flatten(tree_to_numpy(tp))[0]
    assert len(want) == len(got)
    for path, w, g in zip(tree_leaf_paths(tp), want, got):
        _close(g, w, MODEL_TOL, f"round params {path}")


@pytest.mark.parametrize("arch", ["gemma3-4b", "rwkv6-1.6b", "zamba2-7b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b"])
def test_model_kernels_stay_unlaunched_in_a_training_round(arch):
    """A round through build_federation and run_round on each arch with a
    model kernel (the MoE archs: flash in their attention layers):
    flash_attention, rwkv6_scan and mamba2_ssd are never called;
    dp_clip_noise is called tau times."""
    cfg = smoke_variant(get_arch(arch))
    _, spec, state, sampler = build_federation(cfg, 2, 2, 1, 16, [0.5, 0.5],
                                               device="cpu")
    calls = _Spy(MODEL_KERNELS + ("dp_clip_noise",))
    try:
        state, rec = tapi.run_round(
            spec, state, tapi.round_batch(spec, sampler,
                                          np.random.default_rng(0)))
    finally:
        calls.restore()
    assert calls.counts == {**dict.fromkeys(MODEL_KERNELS, 0),
                            "dp_clip_noise": 2}
    assert np.isfinite(float(rec["loss"]))


# ---------------------------------- the card ---------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU "
                    "mode (their plain versions run above)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_training_round_matches_plain_route(cuda_device):
    """A smoke gemma3 round on the card through the kernels ("auto": the
    dp_clip_noise kernel) against kernel_backend="ref", from one seed."""
    cfg = smoke_variant(get_arch("gemma3-4b"))
    finals = []
    for backend in ("auto", "ref"):
        _, spec, state, sampler = build_federation(
            cfg, 2, 2, 2, 32, [0.5, 0.5], device=cuda_device)
        spec = spec.replace(kernel_backend=backend)
        state, _ = tapi.run_round(spec, state, tapi.round_batch(
            spec, sampler, np.random.default_rng(0)))
        finals.append(tree_flatten(tree_to_numpy(state.params))[0])
    for a, b in zip(*finals):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
