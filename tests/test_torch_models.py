"""The port's transformer model stack (``repro_torch.models``) against the
JAX package's (``repro.models``), on the CPU at ``smoke_variant`` size in
f32.

Weights are JAX's own ``Transformer.init`` carried across as numpy arrays by
``transformer_params_from_jax``; tokens and prefix embeddings are made with
numpy from a seed and fed to both. On the CPU the port's kernel wrappers run
their plain versions, so the mixers here are the plain ``flash_attention``,
``rwkv6_scan`` and ``mamba2_ssd``, held against the JAX model's own jnp
paths (``blocked_causal_attention``, ``chunked_causal_attention``,
``wkv6_scan``, ``ssd_chunked``). The two MoE archs run their FFNs in plain
PyTorch against JAX's ``moe_scatter``; their router picks the same experts
as JAX's (``test_router_ids_match_jax``).

Model-level tolerance: ``max|port - jax| <= MODEL_TOL * max(1, max|jax|)``
per tensor, MODEL_TOL = 2e-5. Each mixer's plain version sums in another
order than the JAX model's path (~2e-6 per call, see
tests/test_torch_kernels.py), and the gaps grow through the stack: the
largest, on zamba2's seven stacked mamba2 layers, are ~3e-5 on logits of
magnitude ~4 and ~9e-5 on SSM states of magnitude ~14 (relative ~7e-6).
``python tests/test_torch_models.py`` prints the largest gap per arch.
"""
import functools
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.transformer import Transformer as JaxTransformer

from repro_torch.configs import ASSIGNED_ARCHS, get_arch, smoke_variant
from repro_torch.kernels import ops
from repro_torch.models import layers, ssm
from repro_torch.models.transformer import Transformer
from repro_torch.utils.convert import transformer_params_from_jax
from repro_torch.utils.tree import tree_flatten, tree_leaf_paths

MODEL_TOL = 2e-5
B, S, N_DECODE = 2, 32, 8
DENSE_ARCHS = [a for a in ASSIGNED_ARCHS
               if a not in ("phi3.5-moe-42b-a6.6b",
                            "llama4-maverick-400b-a17b")]
MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]
GAPS: dict[str, float] = {}


def _close(got, want, what: str, arch: str):
    got = got.detach().to(torch.float32).numpy() \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    gap = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 0.0)
    GAPS[arch] = max(GAPS.get(arch, 0.0), gap / scale)
    assert gap <= MODEL_TOL * scale, f"{arch} {what}: gap {gap} scale {scale}"


def _to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(jax model, jax params, port model, port params, inputs)."""
    jm = JaxTransformer(jax_smoke_variant(jax_get_arch(arch)))
    jp = jm.init(jax.random.PRNGKey(0))
    model = Transformer(smoke_variant(get_arch(arch)))
    params = transformer_params_from_jax(_to_numpy_tree(jp), model, "cpu")
    cfg = model.cfg
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    prefix = None
    if cfg.prefix_len:
        prefix = (rng.normal(size=(B, cfg.prefix_len, cfg.d_model))
                  * 0.02).astype(np.float32)
    decode = rng.integers(0, cfg.vocab, size=(N_DECODE, B)).astype(np.int32)
    return jm, jp, model, params, (tokens, prefix, decode)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """JAX's forward logits, prefill (logits, caches, pos) and the
    teacher-forced decode trajectory [(logits, caches)] as numpy."""
    jm, jp, model, _, (tokens, prefix, decode) = _models(arch)
    logits, aux = jax.jit(jm.forward)(jp, _j(tokens), _j(prefix))
    max_len = S + N_DECODE + (model.cfg.prefix_len or 0)
    pl, pc, pos = jax.jit(lambda p, t, pre: jm.prefill(
        p, t, pre, max_len=max_len))(jp, _j(tokens), _j(prefix))
    prefill = (np.asarray(pl), _to_numpy_tree(pc), int(pos))
    step = jax.jit(jm.decode_step)
    traj, caches = [], pc
    for i in range(N_DECODE):
        lg, caches = step(jp, caches, jnp.asarray(decode[i]),
                          jnp.int32(int(pos) + i))
        traj.append((np.asarray(lg), _to_numpy_tree(caches)))
    return (np.asarray(logits), float(aux)), prefill, traj


def _close_caches(got, want, what, arch):
    paths = tree_leaf_paths(got)
    want_leaves = jax.tree.leaves(want)
    assert len(paths) == len(want_leaves)
    for path, g, w in zip(paths, tree_flatten(got)[0], want_leaves):
        assert g.dtype == torch.float32 and g.shape == w.shape, path
        _close(g, w, f"{what} {path}", arch)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_forward_logits_match_jax(arch):
    """Logits and the aux loss (0 for the dense archs, the MoE layers'
    summed load-balance and z losses for the MoE archs)."""
    _, _, model, params, (tokens, prefix, _) = _models(arch)
    (want, want_aux), _, _ = _jax_run(arch)
    got, aux = model.forward(params, _t(tokens), _t(prefix))
    assert got.shape == (B, S, model.cfg.vocab)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert (float(aux) == 0.0) == (arch in DENSE_ARCHS) == (want_aux == 0.0)
    _close(aux, want_aux, "forward aux", arch)
    _close(got, want, "forward logits", arch)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_prefill_logits_and_every_cache_leaf_match_jax(arch):
    """Includes gemma3's ring-ordered sliding-window KV (S 32 > window 16),
    llama4's ring-ordered chunk KV (S 32, two chunks of 16), rwkv's wkv /
    tm_last / cm_last, mamba's h / conv, and the prefix archs' caches over
    prefix + prompt."""
    _, _, model, params, (tokens, prefix, _) = _models(arch)
    _, (wl, wc, wpos), _ = _jax_run(arch)
    max_len = S + N_DECODE + (model.cfg.prefix_len or 0)
    logits, caches, pos = model.prefill(params, _t(tokens), _t(prefix),
                                        max_len=max_len)
    assert pos == wpos == S + (model.cfg.prefix_len or 0)
    _close(logits, wl, "prefill logits", arch)
    _close_caches(caches, wc, "prefill cache", arch)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_teacher_forced_decode_matches_jax_at_every_step(arch):
    """Eight steps from position 32; llama4's chunked layers start a new
    chunk there, and the MoE archs route the B decode tokens as one
    group."""
    _, _, model, params, (tokens, prefix, decode) = _models(arch)
    _, (_, _, pos), traj = _jax_run(arch)
    max_len = S + N_DECODE + (model.cfg.prefix_len or 0)
    _, caches, pos = model.prefill(params, _t(tokens), _t(prefix),
                                   max_len=max_len)
    for i, (wl, wc) in enumerate(traj):
        logits, caches = model.decode_step(params, caches, _t(decode[i]),
                                           pos + i)
        _close(logits, wl, f"decode {i} logits", arch)
        _close_caches(caches, wc, f"decode {i} cache", arch)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_kernel_launch_formulas_on_a_spy(arch, monkeypatch):
    """Each attn / shared_attn layer calls flash_attention once per prefill
    (and per forward; llama4's chunked layers too, over both chunks), each
    rwkv6 layer calls rwkv6_scan once per prefill and once per decoded
    token, each mamba2 layer calls mamba2_ssd once per prefill; decode calls neither flash nor the SSD. Counted on a spy of
    ``repro_torch.kernels.ops``, since the CPU wrappers' launch counters do
    not move."""
    _, _, model, params, (tokens, prefix, decode) = _models(arch)
    calls = {"flash_attention": 0, "rwkv6_scan": 0, "mamba2_ssd": 0}
    for name in calls:
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    mixers = model.cfg.count_mixers()
    n_attn = mixers.get("attn", 0) + mixers.get("shared_attn", 0)
    n_rwkv, n_mamba = mixers.get("rwkv6", 0), mixers.get("mamba2", 0)
    model.forward(params, _t(tokens), _t(prefix))
    assert calls == {"flash_attention": n_attn, "rwkv6_scan": n_rwkv,
                     "mamba2_ssd": n_mamba}
    calls.update(dict.fromkeys(calls, 0))
    _, caches, pos = model.prefill(params, _t(tokens), _t(prefix),
                                   max_len=S + N_DECODE + 8)
    for i in range(N_DECODE):
        _, caches = model.decode_step(params, caches, _t(decode[i]), pos + i)
    assert calls == {"flash_attention": n_attn,
                     "rwkv6_scan": n_rwkv * (1 + N_DECODE),
                     "mamba2_ssd": n_mamba}


def _recording(real, record):
    """``moe_apply`` that records each MoE layer's (params, input)."""
    def rec(params, x, **kw):
        record.append((params, x))
        return real(params, x, **kw)
    return rec


def _jax_moe_ids(arch):
    """JAX's router ids and top-k probabilities (with the next one) at every
    MoE layer of the forward: JAX's own ``_apply_layer`` run eagerly layer
    by layer (``forward``'s scan would hide the inputs), ``moe_apply``
    wrapped to record each layer's params and input, then ``_route`` and the
    softmax per dispatch group."""
    from repro.models import moe as jmoe
    from repro.models import transformer as jtr
    jm, jp, model, _, (tokens, prefix, _) = _models(arch)
    record = []
    real = jmoe.moe_apply
    jtr.moe_mod.moe_apply = _recording(real, record)
    try:
        x = jm._embed_tokens(jp, _j(tokens), _j(prefix))
        positions = jnp.arange(x.shape[1])
        for seg_params, seg in zip(jp["segments"], model.cfg.segments):
            for i in range(seg.n_steps):
                p_step = jax.tree.map(lambda t, i=i: t[i], seg_params)
                for j, ls in enumerate(seg.pattern):
                    x, _ = jm._apply_layer(ls, p_step[str(j)],
                                           jp.get("shared"), x, positions)
    finally:
        jtr.moe_mod.moe_apply = real
    out = []
    for p, h in record:
        groups = jmoe._regroup(h)
        ids = jax.vmap(lambda xr, p=p: jmoe._route(
            p, xr, model.cfg.top_k)[1])(groups)
        probs = jax.nn.softmax(jnp.einsum(
            "gtd,de->gte", groups.astype(jnp.float32), p["router"]), -1)
        top = jax.lax.top_k(probs, model.cfg.top_k + 1)[0]
        out.append((np.asarray(ids), np.asarray(top)))
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ids_match_jax(arch):
    """The port's router picks JAX's experts at every MoE layer of the
    forward (phi3.5: 1 layer x 2 rows x 32 tokens x top-2; llama4: 2 layers
    x top-1). A flip is allowed only at a near-tie: where JAX's k-th and
    (k+1)-th probabilities lie within 1e-5, an argmax that rounding can
    move (none at these inputs)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as ttr
    _, _, model, params, (tokens, prefix, _) = _models(arch)
    record = []
    real = moe.moe_apply
    ttr.moe_mod.moe_apply = _recording(real, record)
    try:
        model.forward(params, _t(tokens), _t(prefix))
    finally:
        ttr.moe_mod.moe_apply = real
    want = _jax_moe_ids(arch)
    n_moe = sum(ls.ffn == "moe" for ls in model.cfg.layer_specs())
    assert len(record) == len(want) == n_moe > 0
    flips = 0
    for (p, h), (wids, wtop) in zip(record, want):
        _, ids, _ = moe._route(p, moe._regroup(h), model.cfg.top_k)
        ids = ids.numpy()
        assert ids.shape == wids.shape == (B, S, model.cfg.top_k)
        differ = ids != wids
        gaps = wtop[..., :-1] - wtop[..., 1:]
        assert np.all(gaps[differ] <= 1e-5), (arch, np.argwhere(differ))
        flips += int(differ.sum())
    assert flips == 0


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_port_init_has_jax_tree_shapes_and_dtypes(arch):
    _, jp, model, _, _ = _models(arch)
    mine = model.init(torch.Generator().manual_seed(0), "cpu")
    assert tree_leaf_paths(mine) == tree_leaf_paths(_to_numpy_tree(jp))
    for path, a, b in zip(tree_leaf_paths(mine), tree_flatten(mine)[0],
                          jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).split(".")[1] == str(b.dtype), path


def test_port_init_distribution():
    """The port draws its own numbers with JAX's distribution: dense
    weights N(0, 1/fan_in) (fan_in the axis JAX names: the input axis, and
    for ``wo`` (H, hd, d) its last one, as JAX's ``in_axis=2`` says),
    ``decay_b`` 0.1 times that, constants exactly as JAX sets them."""
    cfg = smoke_variant(get_arch("zamba2-7b"))
    p = Transformer(cfg).init(torch.Generator().manual_seed(1), "cpu")
    w_in = p["segments"][0]["1"]["mixer"]["w_in"]          # (1, d, f)
    assert abs(float(w_in.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.02
    assert abs(float(w_in.mean())) < 0.01
    wo = p["shared"]["attn"]["wo"]                          # (H, hd, d)
    assert abs(float(wo.std()) * np.sqrt(wo.shape[2]) - 1.0) < 0.05
    m = p["segments"][0]["1"]["mixer"]
    assert torch.equal(m["a_log"], torch.zeros_like(m["a_log"]))
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    assert torch.equal(p["segments"][0]["0"]["mixer"]["lora_q_b"],
                       torch.zeros_like(p["segments"][0]["0"]["mixer"]
                                        ["lora_q_b"]))
    rc = smoke_variant(get_arch("rwkv6-1.6b"))
    tm = Transformer(rc).init(torch.Generator().manual_seed(2),
                              "cpu")["segments"][0]["0"]["mixer"]
    rank = tm["decay_a"].shape[-1]
    assert abs(float(tm["decay_b"].std()) * np.sqrt(rank) - 0.1) < 0.005
    assert torch.equal(tm["decay_w0"], torch.full_like(tm["decay_w0"], -6.0))
    assert torch.equal(tm["mu_g"], torch.full_like(tm["mu_g"], 0.5))
    assert torch.equal(tm["bonus_u"], torch.zeros_like(tm["bonus_u"]))
    assert tm["decay_w0"].dtype == tm["bonus_u"].dtype == torch.float32
    gen = torch.Generator().manual_seed(3)
    again = Transformer(rc).init(torch.Generator().manual_seed(2), "cpu")
    assert torch.equal(again["segments"][0]["0"]["mixer"]["w_r"],
                       tm["w_r"])
    other = Transformer(rc).init(gen, "cpu")["segments"][0]["0"]["mixer"]
    assert not torch.equal(other["w_r"], tm["w_r"])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_init_on_meta_and_cpu_give_the_same_tree(arch):
    """``init`` on the meta device and on the CPU: the same leaf paths,
    shapes and dtypes (those of JAX's tree,
    ``test_port_init_has_jax_tree_shapes_and_dtypes``), at the smoke size
    (one step a segment: the ``unsqueeze(0)`` views of ``_stacked``) and
    at two steps a segment (the filled stack)."""
    cfg = smoke_variant(get_arch(arch))
    two = replace(cfg, segments=tuple(replace(sg, n_steps=2)
                                      for sg in cfg.segments))
    for c in (cfg, two):
        model = Transformer(c)
        meta = model.init(device="meta")
        cpu = model.init(torch.Generator().manual_seed(0), "cpu")
        assert tree_leaf_paths(meta) == tree_leaf_paths(cpu)
        for path, a, b in zip(tree_leaf_paths(cpu), tree_flatten(meta)[0],
                              tree_flatten(cpu)[0]):
            assert a.device.type == "meta" and b.device.type == "cpu"
            assert a.shape == b.shape and a.dtype == b.dtype, path


def test_stacked_single_step_is_views_of_one_draw():
    """``_stacked(1, make)`` gives ``make()``'s values as ``unsqueeze(0)``
    views (no second copy); ``_stacked(n, make)`` stacks n draws in
    order."""
    from repro_torch.models.transformer import _stacked
    gen = torch.Generator().manual_seed(5)

    def make():
        return {"a": torch.randn((3, 4), generator=gen),
                "b": {"c": torch.randn((2,), generator=gen)}}
    one = _stacked(1, make)
    gen.manual_seed(5)
    want = make()
    assert one["a"].shape == (1, 3, 4)
    assert torch.equal(one["a"][0], want["a"])
    assert torch.equal(one["b"]["c"][0], want["b"]["c"])
    assert one["a"]._base is not None           # a view, not a copy
    gen.manual_seed(5)
    three = _stacked(3, make)
    gen.manual_seed(5)
    for i in range(3):
        w = make()
        assert torch.equal(three["a"][i], w["a"])
        assert torch.equal(three["b"]["c"][i], w["b"]["c"])


def test_init_on_meta_gives_shapes_only():
    model = Transformer(get_arch("gemma3-4b"))
    p = model.init(device="meta")
    assert p["embed"]["embedding"].shape == (262144, 2560)
    assert p["embed"]["embedding"].dtype == torch.bfloat16
    assert p["segments"][0]["0"]["mixer"]["wq"].shape == (5, 2560, 8, 256)
    assert all(x.device.type == "meta" for x in tree_flatten(p)[0])


@pytest.mark.parametrize("bad", ["shape", "dtype", "missing", "extra"])
def test_params_from_jax_refuses_a_mismatch(bad):
    _, jp, model, _, _ = _models("gemma3-4b")
    tree = _to_numpy_tree(jp)
    norm = tree["final_norm"]
    if bad == "shape":
        norm["scale"] = norm["scale"][:-1]
    elif bad == "dtype":
        norm["scale"] = norm["scale"].astype(np.float64)
    elif bad == "missing":
        del tree["embed"]["embedding"]
    else:
        norm["bias"] = np.zeros_like(norm["scale"])
    with pytest.raises(ValueError):
        transformer_params_from_jax(tree, model, "cpu")


def test_kernel_backend_ref_equals_auto_on_the_cpu_and_is_validated():
    _, _, model, params, (tokens, prefix, decode) = _models("zamba2-7b")
    ref = Transformer(model.cfg, kernel_backend="ref")
    a, ca, pos = model.prefill(params, _t(tokens), max_len=S + 1)
    b, cb, _ = ref.prefill(params, _t(tokens), max_len=S + 1)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(tree_flatten(ca)[0],
                                                 tree_flatten(cb)[0]))
    with pytest.raises(ValueError):
        Transformer(model.cfg, kernel_backend="pallas")


# ------------------------------ layers --------------------------------------

def _layer_rng(seed):
    return np.random.default_rng(seed)


def test_rmsnorm_and_rope_match_jax():
    rng = _layer_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(jlayers.rmsnorm({"scale": _j(scale)}, _j(x))),
        atol=1e-6, rtol=1e-6)
    pos = np.arange(5, dtype=np.int32) + 1000
    for theta in (1e4, 1e6):
        cos, sin = layers.rope_angles(_t(pos), 16, theta)
        jcos, jsin = jlayers.rope_angles(_j(pos), 16, theta)
        # f32 angles up to ~1000 rad: cos / sin differ in the last ulps
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=2e-6)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=2e-6)
        np.testing.assert_allclose(
            layers.apply_rope(_t(x), cos, sin).numpy(),
            np.asarray(jlayers.apply_rope(_j(x), jcos, jsin)), atol=2e-5)


def _rope_angles_from_a_tensor_base(positions, head_dim, theta):
    """rope_angles as it was built before: the base as a host tensor copied
    to the positions' device on every call."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_rope_angles_bitwise_unchanged_without_a_host_tensor(arch,
                                                             monkeypatch):
    """rope_angles builds no tensor from host data (a pageable copy and a
    blocking sync on the card, once per attention call) and gives the same
    bits as the tensor-base formula, at every config's theta and head dim,
    for decode positions (B,) and prefill positions (B, S)."""
    cfg = get_arch(arch)
    hd = cfg.resolved_head_dim
    positions = (torch.arange(0, 8192, 37, dtype=torch.int64),
                 torch.arange(2 * 300, dtype=torch.int32).reshape(2, 300))
    want = [_rope_angles_from_a_tensor_base(p, hd, cfg.rope_theta)
            for p in positions]

    def no_host_tensor(*args, **kwargs):
        raise AssertionError("rope_angles made a tensor from host data")

    monkeypatch.setattr(torch, "tensor", no_host_tensor)
    for p, (wcos, wsin) in zip(positions, want):
        cos, sin = layers.rope_angles(p, hd, cfg.rope_theta)
        assert cos.dtype == sin.dtype == torch.float32
        assert torch.equal(cos, wcos) and torch.equal(sin, wsin)


def test_mlp_embed_unembed_and_cross_entropy_match_jax():
    rng = _layer_rng(1)
    d, f, v = 16, 24, 40
    p = {k: rng.normal(size=s).astype(np.float32) / 4 for k, s in
         (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    np.testing.assert_allclose(
        layers.mlp({k: _t(a) for k, a in p.items()}, _t(x)).numpy(),
        np.asarray(jlayers.mlp({k: _j(a) for k, a in p.items()}, _j(x))),
        atol=1e-5, rtol=1e-5)
    table = rng.normal(size=(v, d)).astype(np.float32)
    toks = rng.integers(0, v, size=(2, 3)).astype(np.int32)
    for impl in ("gather", "one_hot"):
        np.testing.assert_allclose(
            layers.embed({"embedding": _t(table)}, _t(toks), impl).numpy(),
            np.asarray(jlayers.embed({"embedding": _j(table)}, _j(toks),
                                     impl)), atol=1e-6)
    head = rng.normal(size=(d, v)).astype(np.float32)
    for tp, jp in (({"embedding": _t(table)}, {"embedding": _j(table)}),
                   ({"embedding": _t(table), "head": _t(head)},
                    {"embedding": _j(table), "head": _j(head)})):
        np.testing.assert_allclose(layers.unembed(tp, _t(x)).numpy(),
                                   np.asarray(jlayers.unembed(jp, _j(x))),
                                   atol=1e-5, rtol=1e-5)
    logits = rng.normal(size=(2, 3, v)).astype(np.float32) * 4
    labels = toks.copy()
    labels[0, 1] = -1
    np.testing.assert_allclose(
        float(layers.cross_entropy(_t(logits), _t(labels))),
        float(jlayers.cross_entropy(_j(logits), _j(labels))), rtol=1e-6)


def test_causal_conv_and_gated_out_match_jax():
    rng = _layer_rng(2)
    xbc = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    np.testing.assert_allclose(
        ssm._causal_conv(_t(xbc), _t(w)).numpy(),
        np.asarray(jssm._causal_conv(_j(xbc), _j(w))), atol=1e-6, rtol=1e-6)
    y = rng.normal(size=(2, 9, 3, 4)).astype(np.float32)
    z = rng.normal(size=(2, 9, 12)).astype(np.float32)
    p = {"norm_scale": rng.normal(size=(12,)).astype(np.float32),
         "w_out": rng.normal(size=(12, 8)).astype(np.float32)}
    np.testing.assert_allclose(
        ssm._gated_out({k: _t(a) for k, a in p.items()}, _t(y), _t(z),
                       8).numpy(),
        np.asarray(jssm._gated_out({k: _j(a) for k, a in p.items()}, _j(y),
                                   _j(z), 8)), atol=1e-5, rtol=1e-5)


if __name__ == "__main__":
    # the largest relative gap per arch over forward, prefill and decode:
    # PYTHONPATH=src python tests/test_torch_models.py
    for arch in ASSIGNED_ARCHS:
        test_forward_logits_match_jax(arch)
        test_prefill_logits_and_every_cache_leaf_match_jax(arch)
        test_teacher_forced_decode_matches_jax_at_every_step(arch)
        print(f"{arch}: max |port - jax| / max(1, max |jax|) = "
              f"{GAPS[arch]:.3e} (tolerance {MODEL_TOL})")
