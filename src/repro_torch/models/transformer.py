"""Transformer assembly: segments of stacked layer patterns, with the
training loss, the full forward and the serving path (prefill + decode); a
port of the JAX package's ``repro/models/transformer.py``.

Params and caches keep the JAX package's trees: ``params["segments"]`` is a
list with one dict per segment, ``{"0": layer params, "1": ...}`` by
pattern position, every leaf carrying a leading ``n_steps`` axis, and
``init_cache`` gives the same stacked layout. Where the JAX package scans
over ``n_steps``, the port loops in Python over views of step ``i``.
``decode_step``, ``prefill`` and ``insert_prefill`` write the caches in
place (the JAX package returns new arrays).

Two routes, fixed by the method and not by the device:

- **serving** (``forward``, ``prefill``, ``prefill_at``, ``decode_step``):
  the mixers' hot loops run in the hand-written kernels, through
  ``kernels.ops`` with the model's ``kernel_backend``: ``flash_attention``
  at every ``attn`` / ``shared_attn`` prefill, ``rwkv6_scan`` at every
  ``rwkv6`` prefill and decoded token, ``mamba2_ssd`` at every ``mamba2``
  prefill. The continuous-batching engine (``repro_torch.serve``) adds the
  paged cache (``init_paged_cache``, ``prefill_at``, ``insert_prefill``,
  ``decode_step(..., table=...)``), plain PyTorch as in the JAX package;
- **training** (``loss_fn``, ``_chunked_loss``, ``_hidden_states``): the
  JAX model's own differentiable paths (``attention.blocked_causal_attention``,
  ``rwkv.wkv6_scan``, ``ssm.ssd_chunked``) in torch ops that run under
  ``torch.func.vmap(grad_and_value(...))``, which is how the DP step calls
  the loss. The JAX package trains through the same jnp paths and reaches
  no Pallas kernel there; the three model kernels have no backward and
  refuse tensors that require grad.

``cfg.remat`` is not carried over: under ``torch.func.grad``,
``torch.utils.checkpoint`` raises (saved-tensor hooks in the non-reentrant
form, a missing ``setup_context`` in the reentrant one). The numbers are
those of the JAX model with or without remat; the port keeps every
layer's activations for the backward pass instead of recomputing them.

MoE FFNs (``models/moe.py``) run on both routes in plain PyTorch, as in
the JAX package; their aux loss is summed over layers into ``loss_fn``.

Under a model axis over 1 both routes run every mixer and FFN split as
:func:`repro_torch.models.sharding.param_split_dims` places its weights:
the training route under the ``mesh_2d`` engine at ``dm > 1``, the
serving route on a serving mesh (``launch.serve.serve_on_mesh``: the
``("data", "model")`` ranks under
:func:`repro_torch.models.sharding.serve_mesh_rules`). zamba2's shared
attention adds each invocation's LoRA deltas to the rank's heads of the
shared ``wq`` / ``wo`` (:meth:`_merged_shared_attn`). On the serving mesh
every cache holds the rank's heads: :meth:`cache_axes` (JAX's table, but
for Mamba2's conv window, which stays whole: every rank convolves every
channel) names each cache leaf's dims, and ``init_cache`` /
``init_paged_cache`` size the split ones at ``1 / dm``. Where the decode
rules put a KV cache's sequence on a group of ranks (``cache_seq``: KV
heads the model axis does not divide, or a long context's
``shard_seq``), ``init_cache`` holds the rank's block of its slots
instead, prefill fills that block and decode combines the ranks'
partial softmaxes (``attention.seq_block``); the engine's natural-layout
prefill caches and paged pools stay whole on every rank. A KV cache split
on both its sequence ("data") and its heads ("model", ``shard_seq`` with
KV heads the model axis divides) holds the rank's heads of its block.
Where serving splits the weights over "data" too (``serve_on_mesh``'s
``fsdp_over_data``), the serving route gathers each layer's weights (with
zamba2's shared block where the layer runs it) over the data group just
before the layer and drops them after it, and the embedding or the head
at each use (:meth:`_layer_weights`, :meth:`_embed_weights`): each body
runs on the model slice it runs on without that split.
:meth:`check_model_axis` refuses a model axis the arch cannot take. The
weights' logical-axes trees live in :mod:`repro_torch.models.sharding`
(``param_logical_axes``); ``param_axes`` is not ported.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.kernels.ops import validate_backend
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    _dense_init,
    embed,
    init_embed,
    init_mlp,
    init_rmsnorm,
    lm_loss,
    mlp,
    rmsnorm,
    unembed,
)
from repro_torch.models.sharding import (
    SHARED_LORA_AXES,
    cache_group,
    cache_split_dims,
    data_placement,
    gather_data,
    hinted_group,
    seq_group,
    split_dims,
    split_sizes,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


AUX_WEIGHT = 0.01  # load-balance aux loss weight


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (computed once, so
    a decode step makes no tensor on the host for it)."""
    return float(torch.tensor(value, dtype=dtype))


def _step(tree, i: int):
    """Step ``i`` of a stacked tree, as views."""
    return tree_map(lambda t: t[i], tree)


def _write(dst, src):
    """Copy every leaf of ``src`` into the same leaf of ``dst`` (views into
    stacked tensors), skipping leaves that already are that storage."""
    for d, s in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
        if d.data_ptr() != s.data_ptr() or d.shape != s.shape:
            d.copy_(s)


def _stacked(n: int, make):
    """A tree of ``n`` stacked layers from ``make()`` (one layer a call),
    filled step by step so that only one extra layer is ever allocated; a
    single layer (``n == 1``) is returned as ``unsqueeze(0)`` views, with
    no copy."""
    first = make()
    if n == 1:
        return tree_map(lambda x: x.unsqueeze(0), first)
    leaves, treedef = tree_flatten(first)
    out = [torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
           for x in leaves]
    for o, x in zip(out, leaves):
        o[0].copy_(x)
    del first, leaves
    for i in range(1, n):
        for o, x in zip(out, tree_flatten(make())[0]):
            o[i].copy_(x)
    return tree_unflatten(treedef, out)


class Transformer:
    """Functional model: params are explicit trees of tensors; methods are
    pure apart from the in-place cache writes of the serving path.

    ``kernel_backend`` is passed to every kernel call: ``"auto"`` (the
    hand-written kernel on CUDA tensors, its plain version on CPU tensors)
    or ``"ref"`` (always the plain version)."""

    def __init__(self, cfg: ArchConfig, kernel_backend: str = "auto"):
        validate_backend(kernel_backend)
        self.cfg = cfg
        self.kernel_backend = kernel_backend
        self.has_shared = any(ls.mixer == "shared_attn"
                              for ls in cfg.layer_specs())

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def _init_layer(self, spec: LayerSpec, generator, device):
        cfg = self.cfg
        dt = _dtype(cfg)
        d = cfg.d_model
        params: dict[str, Any] = {"norm1": init_rmsnorm(d, dt, device)}
        if spec.mixer == "attn":
            params["mixer"] = attn.init_attention(
                generator, d, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim, cfg.qkv_bias, dt, device)
        elif spec.mixer == "mamba2":
            params["mixer"] = ssm_mod.init_mamba2(
                generator, d, cfg.ssm_state, cfg.ssm_headdim,
                cfg.ssm_expand, cfg.conv_kernel, dt, device)
        elif spec.mixer == "rwkv6":
            params["mixer"] = rwkv_mod.init_rwkv6_timemix(
                generator, d, cfg.rwkv_headdim, max(4, cfg.lora_rank or 32),
                dt, device)
        elif spec.mixer == "shared_attn":
            r = max(1, cfg.lora_rank)
            hd = cfg.resolved_head_dim
            params["mixer"] = {
                "lora_q_a": _dense_init(generator, (d, r), 0, dt, device),
                "lora_q_b": torch.zeros((r, cfg.n_heads * hd), dtype=dt,
                                        device=device),
                "lora_o_a": _dense_init(generator, (cfg.n_heads * hd, r), 0,
                                        dt, device),
                "lora_o_b": torch.zeros((r, d), dtype=dt, device=device),
            }
        else:
            raise ValueError(f"unknown mixer {spec.mixer}")

        if spec.ffn != "none":
            params["norm2"] = init_rmsnorm(d, dt, device)
        if spec.ffn == "mlp":
            params["ffn"] = init_mlp(generator, d, cfg.d_ff, dt, device)
        elif spec.ffn == "moe":
            params["ffn"] = moe_mod.init_moe(
                generator, d, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts,
                cfg.top_k, cfg.shared_expert, dt, device)
        elif spec.ffn == "rwkv_cm":
            params["ffn"] = rwkv_mod.init_rwkv6_channelmix(
                generator, d, cfg.d_ff, dt, device)
        elif spec.ffn in ("none", "shared_mlp"):
            params["ffn"] = {}
        else:
            raise ValueError(f"unknown ffn {spec.ffn}")
        return params

    def init(self, generator=None, device=None):
        """Random params from ``generator`` (a ``torch.Generator`` on
        ``device``; ``None`` draws from the default generator) in the
        config's dtype, on ``device`` (default: the GPU). On the ``meta``
        device: shapes and dtypes only."""
        cfg = self.cfg
        device = resolve_device(device)
        dt = _dtype(cfg)
        params: dict[str, Any] = {
            "embed": init_embed(generator, cfg.vocab, cfg.d_model,
                                cfg.tie_head, dt, device),
            "final_norm": init_rmsnorm(cfg.d_model, dt, device),
            "segments": [
                {str(j): _stacked(seg.n_steps,
                                  lambda ls=ls: self._init_layer(
                                      ls, generator, device))
                 for j, ls in enumerate(seg.pattern)}
                for seg in cfg.segments],
        }
        if self.has_shared:
            params["shared"] = {
                "attn": attn.init_attention(
                    generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim, cfg.qkv_bias, dt, device),
                "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dt,
                                device),
            }
        return params

    # ------------------------------------------------------------------
    # layer application (full sequence)
    # ------------------------------------------------------------------

    def _merged_shared_attn(self, lora, shared):
        """The shared attention with this invocation's LoRA deltas added to
        ``wq`` / ``wo``. Under a model axis the rank's heads: the whole
        ``lora_q_a`` (gathered) times the rank's columns of ``lora_q_b``,
        the rank's rows of ``lora_o_a`` times the whole ``lora_o_b``
        (gathered), added to the rank's heads of the shared weights."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        d = cfg.d_model
        grp = hinted_group("zamba2's shared-attention LoRA", lora,
                           SHARED_LORA_AXES)
        q_a = grp.gather(lora["lora_q_a"], 0)
        o_b = grp.gather(lora["lora_o_b"], 1)
        dq = (q_a @ lora["lora_q_b"]).reshape(d, -1, hd)
        do = (lora["lora_o_a"] @ o_b).reshape(-1, hd, d)
        p = dict(shared["attn"])
        p["wq"] = p["wq"] + dq
        p["wo"] = p["wo"] + do
        return p

    def _apply_mixer(self, spec: LayerSpec, lparams, shared, h, positions,
                     train: bool = False):
        """The layer's mixer over the full sequence: the training route's
        differentiable paths under ``train``, else the kernels."""
        cfg = self.cfg
        if spec.mixer in ("attn", "shared_attn"):
            p = (self._merged_shared_attn(lparams["mixer"], shared)
                 if spec.mixer == "shared_attn" else lparams["mixer"])
            if train:
                return attn.attention_forward_train(
                    p, h, positions, kind=spec.attn_kind, window=cfg.window,
                    chunk=cfg.chunk, use_rope=spec.use_rope,
                    rope_theta=cfg.rope_theta, block_q=cfg.block_q,
                    causal_buckets=cfg.causal_buckets)
            return attn.attention_forward(
                p, h, positions, kind=spec.attn_kind, window=cfg.window,
                chunk=cfg.chunk, use_rope=spec.use_rope,
                rope_theta=cfg.rope_theta, backend=self.kernel_backend)
        if spec.mixer == "mamba2":
            if train:
                return ssm_mod.mamba2_forward_train(
                    lparams["mixer"], h, d_state=cfg.ssm_state,
                    headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
                    chunk=cfg.ssd_chunk)
            return ssm_mod.mamba2_forward(
                lparams["mixer"], h, d_state=cfg.ssm_state,
                headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
                chunk=cfg.ssd_chunk, backend=self.kernel_backend)
        if spec.mixer == "rwkv6":
            if train:
                return rwkv_mod.rwkv6_timemix_forward_train(
                    lparams["mixer"], h, cfg.rwkv_headdim, cfg.rwkv_chunk)
            return rwkv_mod.rwkv6_timemix_forward(
                lparams["mixer"], h, cfg.rwkv_headdim, cfg.rwkv_chunk,
                backend=self.kernel_backend)
        raise ValueError(spec.mixer)

    def _apply_ffn(self, spec: LayerSpec, lparams, shared, h):
        """(out, aux): the FFN of ``h`` and its aux loss (a tensor for MoE,
        the Python 0.0 otherwise, as in the JAX package, so that dense
        archs add nothing on the device)."""
        cfg = self.cfg
        if spec.ffn == "mlp":
            return mlp(lparams["ffn"], h), 0.0
        if spec.ffn == "moe":
            return moe_mod.moe_apply(
                lparams["ffn"], h, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor, impl=cfg.moe_impl)
        if spec.ffn == "rwkv_cm":
            return rwkv_mod.rwkv6_channelmix_forward(lparams["ffn"], h), 0.0
        if spec.ffn == "shared_mlp":
            return mlp(shared["mlp"], h), 0.0
        return None, 0.0

    def _apply_layer(self, spec: LayerSpec, lparams, shared, x, positions,
                     train: bool = False):
        """(x after the layer, the layer's aux loss)."""
        aux = 0.0
        h = rmsnorm(lparams["norm1"], x)
        x = x + self._apply_mixer(spec, lparams, shared, h, positions, train)
        if spec.ffn != "none":
            h2 = rmsnorm(lparams["norm2"], x)
            out, aux = self._apply_ffn(spec, lparams, shared, h2)
            x = x + out
        return x, aux

    # ------------------------------------------------------------------
    # full forward (prefill logits) and the training loss
    # ------------------------------------------------------------------

    @staticmethod
    def _embed_weights(params, head: bool = False):
        """``params["embed"]`` with the leaf a use reads (the embedding; for
        the LM head an untied ``head``, else the tied embedding) gathered
        over the data group where serving splits the weights over "data"
        (:func:`repro_torch.models.sharding.gather_data`); as it is
        otherwise."""
        dims = data_placement()
        emb = params["embed"]
        if dims is None:
            return emb
        leaf = "head" if head and "head" in emb else "embedding"
        return {**emb, leaf: gather_data(emb[leaf], dims["embed"][leaf])}

    def _layer_weights(self, spec: LayerSpec, seg: int, j: int, lparams,
                       shared):
        """The weights the layer at pattern position ``j`` of segment
        ``seg`` runs on (``lparams``, one step's views) and the shared
        block's: where serving splits the weights over "data"
        (:func:`repro_torch.models.sharding.data_placement`), the layer's
        leaves, with the shared block's where the layer runs it, gathered
        over the data group in one collective (:func:`repro_torch.models
        .sharding.gather_data`) and freed when the caller drops them after
        the layer; as they are otherwise."""
        dims = data_placement()
        if dims is None:
            return lparams, shared
        tree = {"layer": lparams}
        stepped = tree_map(lambda d: d - 1 if d >= 0 else d,
                           dims["segments"][seg][str(j)])
        tdims = {"layer": stepped}
        if spec.mixer == "shared_attn" or spec.ffn == "shared_mlp":
            tree["shared"], tdims["shared"] = shared, dims["shared"]
        out = gather_data(tree, tdims)
        return out["layer"], out.get("shared", shared)

    def _embed_scaled(self, params, tokens):
        cfg = self.cfg
        x = embed(self._embed_weights(params), tokens, cfg.embed_impl)
        if cfg.embed_scale:
            # the JAX package multiplies by a weakly typed Python float,
            # i.e. by sqrt(d) rounded to the activations' dtype
            x = x * _rounded(math.sqrt(cfg.d_model), x.dtype)
        return x

    def _embed_tokens(self, params, tokens, prefix):
        x = self._embed_scaled(params, tokens)
        if prefix is not None:
            x = torch.cat([prefix.to(x.dtype), x], dim=1)
        return x

    def forward(self, params, tokens, prefix=None):
        """tokens (B, S) -> (logits (B, S, V), aux) on the serving route
        (the kernels). prefix (B, P, d) stub embeddings are prepended (vlm /
        audio) and stripped from logits. ``aux`` is the MoE aux loss summed
        over layers (0 without MoE)."""
        x, aux = self._hidden_states(params, tokens, prefix, train=False)
        return unembed(self._embed_weights(params, head=True), x), aux

    def loss_fn(self, params, batch):
        """batch: {"tokens": (B,S), "labels": (B,S), ["prefix": (B,P,d)]}.
        The mean token cross-entropy on the training route, plus
        ``AUX_WEIGHT`` times the MoE aux loss summed over layers.
        Chunked over the sequence when ``cfg.loss_chunk`` is set."""
        prefix = batch.get("prefix")
        if self.cfg.loss_chunk:
            return self._chunked_loss(params, batch, prefix)
        x, aux = self._hidden_states(params, batch["tokens"], prefix)
        return lm_loss(params["embed"], x, batch["labels"]) + AUX_WEIGHT * aux

    def _chunked_loss(self, params, batch, prefix):
        """Cross-entropy computed per sequence chunk of ``cfg.loss_chunk``
        tokens: never materializes the full (B, S, V) logits (the default
        for large-vocab archs). Raises ``ValueError`` unless the chunk
        divides the sequence."""
        x, aux = self._hidden_states(params, batch["tokens"], prefix)
        c = self.cfg.loss_chunk
        s = x.shape[1]
        if s % c:
            raise ValueError(f"seq {s} % loss_chunk {c} != 0")
        labels = batch["labels"]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, c):
            total = total + lm_loss(params["embed"], x[:, i:i + c],
                                    labels[:, i:i + c]) * c
        return total / s + AUX_WEIGHT * aux

    def _hidden_states(self, params, tokens, prefix, train: bool = True):
        """Final-normed hidden states (B, S, d), prefix stripped, and the
        aux loss summed over layers (f32): on the training route (no
        kernel) unless ``train`` is False."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens, prefix)
        positions = torch.arange(x.shape[1], device=x.device)
        shared = params.get("shared")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for s, (seg_params, seg) in enumerate(zip(params["segments"],
                                                  cfg.segments)):
            for i in range(seg.n_steps):
                p_step = _step(seg_params, i)
                for j, ls in enumerate(seg.pattern):
                    lp, sh = self._layer_weights(ls, s, j, p_step[str(j)],
                                                 shared)
                    x, a = self._apply_layer(ls, lp, sh, x, positions, train)
                    del lp, sh
                    if torch.is_tensor(a):
                        aux = aux + a
        x = rmsnorm(params["final_norm"], x)
        if prefix is not None:
            x = x[:, prefix.shape[1]:]
        return x, aux

    # ------------------------------------------------------------------
    # serving: prefill + decode
    # ------------------------------------------------------------------

    def check_model_axis(self, dm: int) -> None:
        """Raise ``ValueError`` unless a model axis of ``dm`` divides every
        dim it splits in this arch (query heads, widths, experts, the
        vocabulary; the message names the model axes that do). KV heads
        it does not divide stay whole on every rank (MQA), and their
        decode cache splits its sequence instead."""
        if dm < 1:
            raise ValueError(f"a model axis needs at least one rank, got "
                             f"{dm}")
        if dm == 1:
            return
        sizes = split_sizes(self.init(device="meta"))
        bad = {k: n for k, n in sizes.items() if n % dm}
        if bad:
            g = math.gcd(*sizes.values())
            fits = [d for d in range(1, g + 1) if g % d == 0]
            raise ValueError(
                f"a model axis of {dm} does not divide {self.cfg.name}'s "
                f"split dims {bad}; the model axis can be one of {fits}")

    def cache_axes(self, paged: bool = False, natural: bool = False):
        """Logical axes of the cache leaves, in the caches' tree (a leading
        step axis a leaf), as the JAX package's ``cache_axes``: KV caches
        (batch, seq on ``cache_seq``, heads on ``kv_tp``), RWKV6's ``wkv``
        and Mamba2's ``h`` on their heads, the token-shift rows whole. One
        departure: Mamba2's conv window is whole (``None`` where JAX hints
        "tp"), since every rank convolves every channel with the gathered
        ``conv_w``. ``paged``: the engine's block pools (blocks, block
        offset, heads, hd) in place of the dense KV caches; ``natural``:
        the engine's prefill caches, whose sequence is whole as the pools'
        is."""
        kv = ((None, None, None, "kv_tp", None) if paged
              else (None, "batch", None if natural else "cache_seq",
                    "kv_tp", None))
        axes = []
        for seg in self.cfg.segments:
            pat = {}
            for j, ls in enumerate(seg.pattern):
                c: dict[str, Any] = {}
                if ls.mixer in ("attn", "shared_attn"):
                    c["mixer"] = {"k": kv, "v": kv}
                elif ls.mixer == "mamba2":
                    c["mixer"] = {"h": (None, "batch", "tp", None, None),
                                  "conv": (None, "batch", None, None)}
                elif ls.mixer == "rwkv6":
                    c["mixer"] = {"wkv": (None, "batch", "tp", None, None),
                                  "tm_last": (None, "batch", None, None)}
                c["ffn"] = ({"cm_last": (None, "batch", None, None)}
                            if ls.ffn == "rwkv_cm" else {})
                pat[str(j)] = c
            axes.append(pat)
        return axes

    def _layer_cache_shape(self, spec: LayerSpec, batch: int, max_len: int,
                           natural: bool = False):
        """One layer's whole cache as meta tensors."""
        cfg = self.cfg
        dt = _dtype(cfg)
        cache: dict[str, Any] = {}
        if spec.mixer in ("attn", "shared_attn"):
            # natural: a full-length position-ordered cache even for swa
            # layers (no ring truncation), the layout the paged serving
            # pool ingests; visibility is enforced by masks
            cache["mixer"] = attn.init_kv_cache(
                batch, "full" if natural else spec.attn_kind, max_len,
                cfg.n_kv_heads, cfg.resolved_head_dim, cfg.window,
                cfg.chunk, dt, "meta")
        elif spec.mixer == "mamba2":
            cache["mixer"] = ssm_mod.init_mamba2_cache(
                batch, cfg.d_model, cfg.ssm_state, cfg.ssm_headdim,
                cfg.ssm_expand, cfg.conv_kernel, dt, "meta")
        elif spec.mixer == "rwkv6":
            n_heads = cfg.d_model // cfg.rwkv_headdim
            cache["mixer"] = {
                "wkv": torch.zeros((batch, n_heads, cfg.rwkv_headdim,
                                    cfg.rwkv_headdim), dtype=torch.float32,
                                   device="meta"),
                "tm_last": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                                       device="meta"),
            }
        if spec.ffn == "rwkv_cm":
            cache["ffn"] = {"cm_last": torch.zeros((batch, 1, cfg.d_model),
                                                   dtype=dt, device="meta")}
        else:
            cache["ffn"] = {}
        return cache

    def _whole_caches(self, make):
        """The whole stacked caches as meta tensors, ``make(layer_spec)``
        giving one layer's."""
        return [{str(j): tree_map(
            lambda x, n=seg.n_steps: torch.empty((n,) + tuple(x.shape),
                                                 dtype=x.dtype,
                                                 device="meta"), make(ls))
                 for j, ls in enumerate(seg.pattern)}
                for seg in self.cfg.segments]

    def _alloc_caches(self, make, device, paged: bool = False,
                      natural: bool = False):
        """Zeroed stacked caches, ``make(layer_spec)`` giving one layer's
        whole meta cache; under a serving mesh each leaf that
        :meth:`cache_axes` splits (:func:`repro_torch.models.sharding
        .cache_split_dims` on its whole shape) holds the rank's part of it:
        ``1 / dm`` of its heads, or its block of a sequence split over
        ``g`` ranks."""
        axes = self.cache_axes(paged, natural)
        whole = self._whole_caches(make)
        dims = cache_split_dims(axes, whole)

        def alloc(x, logical, d):
            if isinstance(x, dict):
                return {k: alloc(v, logical[k], d[k]) for k, v in x.items()}
            if isinstance(x, list):
                return [alloc(*t) for t in zip(x, logical, d)]
            shape = list(x.shape)
            for dim in split_dims(d):
                shape[dim] //= cache_group(logical, dim).size
            return torch.zeros(shape, dtype=x.dtype, device=device)

        return alloc(whole, axes, dims)

    def _cache_max_len(self, max_len: int, natural: bool) -> int:
        """``max_len`` rounded up to a multiple of the sequence group
        (:func:`repro_torch.models.sharding.seq_group`) where one splits
        the caches: the extra slots are never visible, and a full-length
        cache then always splits (``attention.seq_block``)."""
        grp = None if natural else seq_group()
        return max_len if grp is None else -(-max_len // grp.size) * grp.size

    def cache_dims(self, batch: int, max_len: int, natural: bool = False):
        """The split dims (:func:`repro_torch.models.sharding
        .cache_split_dims`) of ``init_cache(batch, max_len, natural=...)``'s
        caches under the active context: what
        :func:`repro_torch.models.sharding.caches_to_whole` makes whole."""
        max_len = self._cache_max_len(max_len, natural)
        return cache_split_dims(self.cache_axes(natural=natural),
                                self._whole_caches(
                                    lambda ls: self._layer_cache_shape(
                                        ls, batch, max_len, natural)))

    def init_cache(self, batch: int, max_len: int, device=None,
                   natural: bool = False):
        """Zeroed caches matching the segment structure. KV caches of swa
        layers are ring buffers of the window size (or full
        position-ordered buffers under ``natural``, the serving-ingest
        layout). Under a serving mesh the rank's heads, or the rank's
        block of a KV cache's slots where the rules split its sequence
        (``max_len`` then rounds up to a multiple of the group)."""
        max_len = self._cache_max_len(max_len, natural)
        return self._alloc_caches(
            lambda ls: self._layer_cache_shape(ls, batch, max_len, natural),
            resolve_device(device), natural=natural)

    def init_paged_cache(self, n_slots: int, n_blocks: int, block_size: int,
                         device=None):
        """Serving caches for a continuous-batching engine: attention
        layers get a physical block pool (block-table indexed, the same
        geometry in every layer), recurrent layers keep per-slot state rows
        (their state is O(1) per slot: nothing to page). Under a serving
        mesh the rank's heads."""
        cfg = self.cfg

        def make(ls):
            one = self._layer_cache_shape(ls, n_slots, 1)
            if ls.mixer in ("attn", "shared_attn"):
                one["mixer"] = attn.init_paged_kv_cache(
                    n_blocks, block_size, cfg.n_kv_heads,
                    cfg.resolved_head_dim, _dtype(cfg), "meta")
            return one

        return self._alloc_caches(make, resolve_device(device), paged=True)

    def _decode_layer(self, spec: LayerSpec, lparams, shared, cache, x, pos,
                      table=None, indexes=None):
        cfg = self.cfg
        h = rmsnorm(lparams["norm1"], x)
        new_cache = dict(cache)
        if spec.mixer in ("attn", "shared_attn"):
            p = (self._merged_shared_attn(lparams["mixer"], shared)
                 if spec.mixer == "shared_attn" else lparams["mixer"])
            if table is None:
                out, kv = attn.decode_attention(
                    p, h, cache["mixer"], pos, kind=spec.attn_kind,
                    window=cfg.window, chunk=cfg.chunk,
                    use_rope=spec.use_rope, rope_theta=cfg.rope_theta,
                    seq=self._seq_block(spec, cache["mixer"]))
            else:
                # one paged_index per attention kind and decode step
                if spec.attn_kind not in indexes:
                    indexes[spec.attn_kind] = attn.paged_index(
                        table, pos, cache["mixer"]["k"].shape[1],
                        spec.attn_kind, cfg.window, cfg.resolved_head_dim,
                        cfg.rope_theta, cfg.chunk)
                out, kv = attn.paged_decode_attention(
                    p, h, cache["mixer"], table, indexes[spec.attn_kind],
                    use_rope=spec.use_rope)
            new_cache["mixer"] = kv
        elif spec.mixer == "mamba2":
            out, mc = ssm_mod.mamba2_decode(
                lparams["mixer"], h, cache["mixer"], d_state=cfg.ssm_state,
                headdim=cfg.ssm_headdim, expand=cfg.ssm_expand)
            new_cache["mixer"] = mc
        elif spec.mixer == "rwkv6":
            out, rc = rwkv_mod.rwkv6_timemix_decode(
                lparams["mixer"], h, cache["mixer"], cfg.rwkv_headdim,
                backend=self.kernel_backend)
            new_cache["mixer"] = {"wkv": rc["wkv"], "tm_last": rc["tm_last"]}
        else:
            raise ValueError(spec.mixer)
        x = x + out

        if spec.ffn != "none":
            h2 = rmsnorm(lparams["norm2"], x)
            if spec.ffn == "rwkv_cm":
                out2, fc = rwkv_mod.rwkv6_channelmix_decode(
                    lparams["ffn"], h2, cache["ffn"])
                new_cache["ffn"] = fc
            else:
                out2, _ = self._apply_ffn(spec, lparams, shared, h2)
            x = x + out2
        return x, new_cache

    def _seq_block(self, spec: LayerSpec, kv_cache, natural: bool = False):
        """``attention.seq_block`` of one attention layer's dense KV cache
        (a step's view) under the active rules."""
        if natural:
            return None
        return attn.seq_block(kv_cache["k"].shape[1], spec.attn_kind,
                              self.cfg.window, self.cfg.chunk, seq_group())

    def decode_step(self, params, caches, tokens, pos, table=None):
        """One decode step. tokens (B,) integer; ``pos`` (int) the position
        of this token (prefix-inclusive). Updates ``caches`` in place and
        returns ``(logits (B, V), caches)``.

        With ``table`` (B, blocks_per_slot) integer, ``caches`` are the
        paged pools of :meth:`init_paged_cache` and ``pos`` is a per-slot
        (B,) integer tensor: the continuous-batching decode, where every
        slot sits at its own position. That path reads no value back to
        the host."""
        cfg = self.cfg
        if table is None:
            pos = int(pos)
        indexes = {}
        x = self._embed_scaled(params, tokens[:, None])
        shared = params.get("shared")
        for s, (seg_params, seg_cache, seg) in enumerate(zip(
                params["segments"], caches, cfg.segments)):
            for i in range(seg.n_steps):
                p_step, c_step = _step(seg_params, i), _step(seg_cache, i)
                for j, ls in enumerate(seg.pattern):
                    lp, sh = self._layer_weights(ls, s, j, p_step[str(j)],
                                                 shared)
                    x, new_c = self._decode_layer(
                        ls, lp, sh, c_step[str(j)], x, pos, table, indexes)
                    del lp, sh
                    _write(c_step[str(j)], new_c)
        x = rmsnorm(params["final_norm"], x)
        logits = unembed(self._embed_weights(params, head=True), x)[:, 0]
        return logits, caches

    def _prefill_states(self, params, tokens, prefix, max_len,
                        natural: bool = False):
        """Shared prefill body: final-normed hidden states (B, S_total, d)
        plus the filled caches."""
        cfg = self.cfg
        x = self._embed_tokens(params, tokens, prefix)
        b, s_total = x.shape[:2]
        max_len = max_len or s_total
        positions = torch.arange(s_total, device=x.device)
        shared = params.get("shared")
        caches = self.init_cache(b, max_len, x.device, natural)
        for s, (seg_params, seg_cache, seg) in enumerate(zip(
                params["segments"], caches, cfg.segments)):
            for i in range(seg.n_steps):
                p_step, c_step = _step(seg_params, i), _step(seg_cache, i)
                for j, ls in enumerate(seg.pattern):
                    lp, sh = self._layer_weights(ls, s, j, p_step[str(j)],
                                                 shared)
                    x, new_c = self._prefill_layer(
                        ls, lp, sh, c_step[str(j)], x, positions, natural)
                    del lp, sh
                    _write(c_step[str(j)], new_c)
        x = rmsnorm(params["final_norm"], x)
        return x, caches, s_total

    def prefill(self, params, tokens, prefix=None, max_len=None):
        """Run the full prompt, building caches. Returns (last-token logits
        (B, V), caches, next position (int)). Where the rules split a KV
        cache's sequence (``cache_seq``, :meth:`init_cache`), each rank
        computes the whole prompt's k / v (its heads, or every KV head)
        and fills its own block of slots; under ``shard_seq`` every rank
        of the data axis so runs the whole batch (the JAX dry run lowers
        no prefill there)."""
        x, caches, s_total = self._prefill_states(params, tokens, prefix,
                                                  max_len)
        logits = unembed(self._embed_weights(params, head=True),
                         x[:, -1:])[:, 0]
        return logits, caches, s_total

    def prefill_at(self, params, tokens, lengths, prefix=None,
                   max_len=None):
        """Bucketed prefill for the serving engine: tokens (B, S) are
        right-padded to a common bucket length, lengths (B,) integer tensor
        the true prompt lengths. Returns (per-row logits at each row's last
        true token (B, V), natural-layout caches, per-row next position
        (B,) int32).

        Rows' cache entries beyond their true length hold pad garbage;
        paged decode overwrites position p before the ``p <= pos`` mask
        ever exposes it, so right-padding is safe for attention layers (the
        logits equal an exact-length prefill's up to the summation order of
        the longer rows). Recurrent state (mamba2 / rwkv6 / rwkv_cm)
        consumes pad tokens, so engines must prefill those archs at exact
        lengths."""
        p_len = 0 if prefix is None else prefix.shape[1]
        x, caches, _ = self._prefill_states(params, tokens, prefix, max_len,
                                            natural=True)
        b = x.shape[0]
        idx = p_len + lengths - 1
        xg = x[torch.arange(b, device=x.device), idx][:, None]
        logits = unembed(self._embed_weights(params, head=True), xg)[:, 0]
        return logits, caches, (p_len + lengths).to(torch.int32)

    def insert_prefill(self, paged, pre, table_rows, slots):
        """Scatter one prefill batch's natural-layout caches into the paged
        pools and slot state rows, in place; returns ``paged``.

        paged: pools from :meth:`init_paged_cache`; pre: caches from
        :meth:`prefill_at` (attention rows in position order, length n);
        table_rows (nb, bps) integer, the physical blocks of the target
        slots; slots (nb,) integer slot ids. Only the blocks the prompt
        span covers are written: later blocks keep stale values that decode
        overwrites before the position mask exposes them. Duplicate rows
        (admission padding) carry identical values, so the indexed stores
        stay deterministic."""
        def scatter_blocks(pool, rows):
            # pool (T, NB, bs, KV, hd); rows (T, nb, n, KV, hd)
            bs = pool.shape[2]
            n = rows.shape[2]
            nb_blocks = -(-n // bs)
            pad = nb_blocks * bs - n
            if pad:
                rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
            blocks = rows.reshape(rows.shape[0], rows.shape[1], nb_blocks,
                                  bs, *rows.shape[3:])
            pool[:, table_rows[:, :nb_blocks]] = blocks.to(pool.dtype)

        def scatter_rows(g, p):
            g[:, slots] = p.to(g.dtype)

        for seg_pre, seg_paged, seg in zip(pre, paged, self.cfg.segments):
            for j, ls in enumerate(seg.pattern):
                cp, cg = seg_pre[str(j)], seg_paged[str(j)]
                if ls.mixer in ("attn", "shared_attn"):
                    scatter_blocks(cg["mixer"]["k"], cp["mixer"]["k"])
                    scatter_blocks(cg["mixer"]["v"], cp["mixer"]["v"])
                else:
                    for name in cg["mixer"]:
                        scatter_rows(cg["mixer"][name], cp["mixer"][name])
                for name in cg["ffn"]:
                    scatter_rows(cg["ffn"][name], cp["ffn"][name])
        return paged

    def _prefill_layer(self, spec: LayerSpec, lparams, shared, cache, x,
                       positions, natural: bool = False):
        cfg = self.cfg
        h = rmsnorm(lparams["norm1"], x)
        new_cache = dict(cache)
        if spec.mixer in ("attn", "shared_attn"):
            p = (self._merged_shared_attn(lparams["mixer"], shared)
                 if spec.mixer == "shared_attn" else lparams["mixer"])
            out, (k, v) = attn.attention_forward_kv(
                p, h, positions, kind=spec.attn_kind, window=cfg.window,
                chunk=cfg.chunk, use_rope=spec.use_rope,
                rope_theta=cfg.rope_theta, backend=self.kernel_backend)
            new_cache["mixer"] = attn.fill_kv_cache(
                cache["mixer"], k, v, spec.attn_kind, cfg.window, cfg.chunk,
                self._seq_block(spec, cache["mixer"], natural))
        elif spec.mixer == "mamba2":
            out, st = ssm_mod.mamba2_forward_state(
                lparams["mixer"], h, d_state=cfg.ssm_state,
                headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
                chunk=cfg.ssd_chunk, backend=self.kernel_backend)
            new_cache["mixer"] = st
        elif spec.mixer == "rwkv6":
            out, st = rwkv_mod.rwkv6_timemix_forward_state(
                lparams["mixer"], h, cfg.rwkv_headdim, cfg.rwkv_chunk,
                backend=self.kernel_backend)
            new_cache["mixer"] = st
        else:
            raise ValueError(spec.mixer)
        x = x + out
        if spec.ffn != "none":
            h2 = rmsnorm(lparams["norm2"], x)
            if spec.ffn == "rwkv_cm":
                out2 = rwkv_mod.rwkv6_channelmix_forward(lparams["ffn"], h2)
                new_cache["ffn"] = {"cm_last": h2[:, -1:]}
            else:
                out2, _ = self._apply_ffn(spec, lparams, shared, h2)
            x = x + out2
        return x, new_cache
