"""Logical-axis sharding rules (the port's copy of the JAX package's
``repro/models/sharding.py``).

Models name tensor dims with *logical* axes; a context installs the active
mesh plus a logical->mesh translation. Outside any context every helper is
the identity placement, so the same model code runs on one device and on a
mesh.

Logical names used across the model stack:
  "client"  federated client axis (leading axis of FL-stacked params)
  "fsdp"    fully-sharded param dim            -> mesh "replica" (train)
                                                   or "data" (serve, optional)
  "tp"      tensor-parallel param/activation dim -> mesh "model"
  "batch"   data batch                          -> mesh "replica" / "data"
  "seq"     sequence dim (sharded only for long-context decode caches)

Under the ``mesh_2d`` engine with a model axis over 1
(:mod:`repro_torch.mesh.engine`), each rank holds its slice of every split
weight and the model code runs the model axis' collectives by hand
(:mod:`repro_torch.mesh.collectives`): PyTorch has no partitioner. Where a
weight is split comes from these rules, as in the JAX package:
:func:`param_split_dims` resolves each leaf's logical axes
(:func:`param_logical_axes`, the JAX models' ``shard_hint`` sites) with
:func:`resolve_spec` on the whole shapes, and the engine cuts the slices
(:func:`to_local`) and joins them again (:func:`to_whole`). Inside the
round :func:`shard_hint` is the identity on a weight's local slice (it
checks the slice against its spec) and on activations, and
:func:`model_dim` tells the model code which dim of a weight is split.
:class:`PartitionSpec` is a tuple of mesh-axis names (or ``None``)
standing in for ``jax.sharding.PartitionSpec``.

The serving mesh (``("data", "model")`` ranks, :func:`serve_mesh_rules`)
places weights as the training mesh does, not as the JAX package's
``serve_rules`` would: each weight splits on the first dim its hint names
"fsdp" or "tp" (:func:`mesh2d_rules`), so every layer keeps the one split
body it trains with. Literal ``serve_rules`` map "fsdp" to nothing, which
would split Mamba2's ``w_in`` on its output columns (z, x, B, C and dt
side by side, not lined up with the heads), RWKV6's projections and an
untied head on their columns and leave zamba2's LoRA factors whole. The
values served are the same; only where a weight's slices sit differs.
Weights over "data" too (``serve_rules(fsdp_over_data=True)``, chosen by
:func:`needs_param_sharding`): each rank keeps a block of its model slice
along a second dim (:func:`data_split_dims`: where JAX's rules put
"data", or, where the port's model split took that dim, the other dim
the hint names), installed beside the model placement
(:func:`axis_rules`' ``data_placement``); the model gathers a layer's
blocks over the data group before the layer runs (:func:`gather_data`),
so each body sees the model slice it sees without them.
The rows (``batch``) go on "data" and the decode caches' heads on
"model", as ``serve_rules`` put them, unless the decode rules
(:func:`decode_mesh_rules`, the JAX dry run's ``lower_decode`` line for
line) move a KV cache's sequence onto a group of ranks (``cache_seq``):
onto "model" where the model axis does not divide the KV heads (MQA),
onto "data" (or both axes) for a long context (``shard_seq``), where a
KV cache whose heads the model axis divides splits on both its sequence
("data") and its heads ("model").
:func:`cache_split_dims` finds each cache leaf's split dims from the
model's ``cache_axes`` table. A hint's ``batch`` dim is always the rank's
own rows (the drivers hand each rank its rows: the engines their client
blocks, the serving mesh each data row of ranks its prompts), so no hint
splits it by hand.

K/V projections the model axis does not divide (``wk`` / ``wv`` / ``bk``
/ ``bv`` of an MQA arch, or of any GQA arch whose model axis outgrows its
KV heads) stay whole on every model rank, as JAX's ``resolve_spec`` drops
the axis from their hint on the whole shape: each rank computes every KV
head and attends with its own query heads (:func:`kv_heads_whole` tells
the attention body so).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

_state = threading.local()


class PartitionSpec(tuple):
    """Mesh axis (or ``None``, or a tuple of axes) per tensor dim;
    trailing ``None`` dims are dropped by :func:`resolve_spec`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _current():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: dict[str, Any], placement=None,
               data_placement=None):
    """Install mesh + logical->mesh rules for model code in this thread.
    ``mesh`` is a ``DeviceMesh`` with named dims, or any object whose
    ``shape`` maps axis names to sizes. ``placement`` is the split-dim tree
    of the params the code runs on (:func:`param_split_dims`), which the
    clip of Eq. 7a reads (:func:`model_placement`); ``data_placement``
    the tree of the dims their model slices split over "data"
    (:func:`data_split_dims`, serving weights over "data"), which the
    model gathers before each layer (:func:`gather_data`)."""
    prev = (_current(), getattr(_state, "placement", None),
            getattr(_state, "data_placement", None))
    _state.ctx = (mesh, dict(rules))
    _state.placement = placement
    _state.data_placement = data_placement
    try:
        yield
    finally:
        _state.ctx, _state.placement, _state.data_placement = prev


def current_context():
    """``(mesh, rules, placement, data_placement)`` of the active rules
    context, or ``None``: what a caller re-enters with
    ``axis_rules(*ctx)`` (the serving engine keeps the context it was
    built under)."""
    ctx = _current()
    return None if ctx is None else (
        *ctx, getattr(_state, "placement", None),
        getattr(_state, "data_placement", None))


DATA_AXIS = "data"
MODEL_AXIS = "model"


def data_axis_size() -> int:
    """The size of the active mesh's "data" axis (1 without one): how many
    row blocks the serving mesh splits a batch into."""
    ctx = _current()
    return 1 if ctx is None else _axis_size_or_one(ctx[0], DATA_AXIS)


def model_placement():
    """The split-dim tree installed with the active rules, or ``None``."""
    return getattr(_state, "placement", None) if _current() else None


def data_placement():
    """The data-split-dim tree installed with the active rules
    (:func:`data_split_dims`), or ``None``: weights whole over "data"."""
    return getattr(_state, "data_placement", None) if _current() else None


def train_rules() -> dict[str, Any]:
    return {"client": "client", "fsdp": "replica", "tp": "model",
            "batch": "replica", "seq": None, "act": None,
            # weight sharding at the use site; None gathers weights instead
            "wg": "replica"}


def mesh2d_rules() -> dict[str, Any]:
    """Rules for the 2D ("client", "model") federation mesh
    (:mod:`repro_torch.mesh`).

    The client axis is the engine's own (each rank owns a block of client
    replicas), so no logical name maps to it. With a single model axis,
    "fsdp" and "tp" both map to "model" and :func:`resolve_spec` keeps
    whichever dim claims it first (an axis may appear once per spec)."""
    return {"client": None, "fsdp": "model", "tp": "model",
            "batch": None, "seq": None, "act": "model", "wg": None}


def serve_rules(fsdp_over_data: bool = False,
                shard_seq: bool = False) -> dict[str, Any]:
    return {"client": None, "fsdp": "data" if fsdp_over_data else None,
            "tp": "model", "batch": "data",
            "seq": "data" if shard_seq else None, "act": None,
            "kv_tp": "model", "cache_seq": "data" if shard_seq else None,
            "wg": "data" if fsdp_over_data else None}


def serve_mesh_rules(shard_seq: bool = False) -> dict[str, Any]:
    """Rules of the port's serving mesh (``("data", "model")`` ranks): the
    weights as :func:`mesh2d_rules` place them ("fsdp" and "tp" on the
    model axis, the first named dim wins), the rows on "data", the caches'
    heads on "model" (``kv_tp``) and, under ``shard_seq``, the sequence on
    "data" (``seq``, ``cache_seq``), as :func:`serve_rules` put them.
    Weights over "data" too are a second placement beside these rules
    (:func:`data_split_dims`), gathered before each layer: the rules the
    layer bodies see stay these. :func:`decode_mesh_rules` adapts them to
    an arch's KV heads."""
    return {"client": None, "fsdp": "model", "tp": "model", "wg": None,
            "act": None, "batch": "data",
            "seq": DATA_AXIS if shard_seq else None, "kv_tp": "model",
            "cache_seq": DATA_AXIS if shard_seq else None}


def decode_mesh_rules(n_kv_heads: int, mesh_shape: tuple[int, int],
                      shard_seq: bool = False,
                      base: dict[str, Any] | None = None) -> dict[str, Any]:
    """The serving mesh's decode rules for an arch of ``n_kv_heads`` KV
    heads on the ``(dd, dm)`` serving mesh, as the JAX dry run's
    ``lower_decode`` builds them (``src/repro/launch/dryrun.py:216-228``)
    from ``base`` (default :func:`serve_mesh_rules`; the dry run passes
    JAX's :func:`serve_rules`): the KV heads on "model" where the model
    axis divides them, else the cache's sequence on "model"; under
    ``shard_seq`` (a batch of one long context) no row split, and the
    cache's sequence on "data", or on ``("data", "model")`` where the
    model axis does not divide the KV heads."""
    _, dm = (int(n) for n in mesh_shape)
    rules = dict(serve_mesh_rules(shard_seq=shard_seq) if base is None
                 else base)
    kv_divides = n_kv_heads % dm == 0
    if shard_seq:
        rules["batch"] = None
        rules["cache_seq"] = ((DATA_AXIS, MODEL_AXIS) if not kv_divides
                              else DATA_AXIS)
        rules["kv_tp"] = MODEL_AXIS if kv_divides else None
    elif not kv_divides:
        rules["kv_tp"] = None
        rules["cache_seq"] = MODEL_AXIS
    return rules


def _axis_size(mesh, name: str) -> int:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # a torch DeviceMesh
        return int(mesh.shape[list(names).index(name)])
    return int(mesh.shape[name])


def _mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    n = 1
    for a in _atomic_axes(axis):
        n *= _axis_size(mesh, a)
    return n


def _atomic_axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def resolve_spec(logical: tuple, shape: tuple[int, ...] | None = None
                 ) -> PartitionSpec:
    """Translate logical axis names to a PartitionSpec under active rules.

    If ``shape`` is given, any mesh axis that does not divide the dim size
    is dropped (explicit replication). A mesh axis claimed by an earlier
    dim is dropped from later dims (first dim wins)."""
    ctx = _current()
    if ctx is None:
        return P()
    mesh, rules = ctx
    out = []
    used: set = set()
    for i, name in enumerate(logical):
        axis = rules.get(name) if name is not None else None
        if axis is not None and any(a in used for a in _atomic_axes(axis)):
            axis = None
        if axis is not None and shape is not None:
            if shape[i] % _mesh_axis_size(mesh, axis) != 0:
                axis = None
        if axis is not None:
            used.update(_atomic_axes(axis))
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _axis_size_or_one(mesh, name: str) -> int:
    names = getattr(mesh, "mesh_dim_names", None)
    axes = mesh.shape if names is None else names
    return _axis_size(mesh, name) if name in axes else 1


def _model_size(mesh) -> int:
    return _axis_size_or_one(mesh, MODEL_AXIS)


def _split_of(spec: PartitionSpec, mesh, axes=(MODEL_AXIS,)) -> int:
    """The dim of ``spec`` that one of ``axes`` splits (-1: none): the
    model axis for a weight or an activation, also "data" for a cache's
    sequence (:func:`cache_split_dims`). A weight's "data" is its second
    placement (:func:`data_split_dims`), gathered before the layer runs,
    so it is passed over here. Any other axis over 1 (a federated mesh's
    "replica") is not split by hand: it raises ``NotImplementedError``."""
    dim = -1
    for i, axis in enumerate(spec):
        for a in (() if axis is None else _atomic_axes(axis)):
            if a in axes:
                dim = i
            elif a != DATA_AXIS and _axis_size(mesh, a) > 1:
                raise NotImplementedError(
                    f"splitting a tensor over the mesh axis {a!r} inside a "
                    f"client replica: the port splits a replica by hand "
                    f"over {MODEL_AXIS!r} (and serving weights over "
                    f"{DATA_AXIS!r}) only")
    return dim


def shard_hint(x, *logical):
    """The identity on ``x``. Outside a rules context, or where every axis
    the hint resolves to has size 1, nothing is checked. Under a model axis
    over 1, ``x`` is a weight's local slice or an activation: the hint must
    name each of its dims (``ValueError`` otherwise), and a hint that would
    split it over another mesh axis raises (``NotImplementedError``)."""
    ctx = _current()
    if ctx is None:
        return x
    mesh, _ = ctx
    # the batch dim holds the rank's own rows: never split by hand
    spec = resolve_spec(tuple(None if a == "batch" else a for a in logical))
    if all(_mesh_axis_size(mesh, a) == 1 for a in spec if a is not None):
        return x
    if x.dim() != len(logical):
        raise ValueError(f"a hint of {len(logical)} logical axes "
                         f"{logical} on a tensor of {x.dim()} dims "
                         f"{tuple(x.shape)}")
    _split_of(spec, mesh)
    return x


def model_group():
    """The :class:`repro_torch.mesh.collectives.ModelGroup` of the active
    rules context when its mesh has a model axis over 1, else ``None``
    (the model code then runs whole)."""
    ctx = _current()
    if ctx is None or _model_size(ctx[0]) == 1:
        return None
    mesh = ctx[0]
    cached = getattr(_state, "group", None)
    if cached is None or cached[0] is not mesh:
        from repro_torch.mesh.collectives import ModelGroup
        cached = _state.group = (mesh, ModelGroup(mesh, MODEL_AXIS))
    return cached[1]


def data_group():
    """The :class:`repro_torch.mesh.collectives.ModelGroup` over the active
    mesh's "data" axis where serving weights split over it (a data
    placement installed, :func:`data_placement`, and a data axis over 1),
    else ``None``: the group :func:`gather_data` gathers a layer's weights
    over."""
    ctx = _current()
    if (ctx is None or data_placement() is None
            or _axis_size_or_one(ctx[0], DATA_AXIS) == 1):
        return None
    mesh = ctx[0]
    cached = getattr(_state, "data_group", None)
    if cached is None or cached[0] is not mesh:
        from repro_torch.mesh.collectives import ModelGroup
        cached = _state.data_group = (mesh, ModelGroup(mesh, DATA_AXIS))
    return cached[1]


def seq_group():
    """The group of ranks that splits a KV cache's sequence under the
    active rules (its ``cache_seq`` axes: "model", "data" or both,
    flattened data-major), a :class:`repro_torch.mesh.collectives
    .ModelGroup`, or ``None`` where those axes have one rank (or no
    context is active). Build it first on every rank of the world (the
    serving mesh does): a group over two axes is a new process group."""
    ctx = _current()
    if ctx is None:
        return None
    mesh, rules = ctx
    axis = rules.get("cache_seq")
    if axis is None or _mesh_axis_size(mesh, axis) == 1:
        return None
    axes = _atomic_axes(axis)
    groups = getattr(_state, "seq_groups", None)
    if groups is None or groups[0] is not mesh:
        groups = _state.seq_groups = (mesh, {})
    if axes not in groups[1]:
        from repro_torch.mesh.collectives import ModelGroup
        groups[1][axes] = ModelGroup(mesh, axes)
    return groups[1][axes]


# the K/V leaves of an attention layer: whole on a model axis that does not
# divide the KV heads (param_split_dims), each rank then computing every KV
# head from them
KV_LEAVES = ("wk", "wv", "bk", "bv")


def kv_heads_whole() -> bool:
    """Whether the attention layers of the params the code runs on keep
    their K/V projections whole under a model axis over 1 (the model axis
    does not divide the KV heads): what the installed placement
    (:func:`param_split_dims` of those params, :func:`axis_rules`'
    ``placement``) says of ``wk``. Every attention layer of a model has
    the same KV heads, so the first ``wk`` met decides. ``False`` without
    a model axis over 1 or a placement."""
    placement = model_placement()
    if placement is None or model_group() is None:
        return False
    cached = getattr(_state, "kv_whole", None)
    if cached is None or cached[0] is not placement:
        cached = _state.kv_whole = (placement, _wk_dim(placement) == -1)
    return cached[1]


def _wk_dim(tree):
    """The split dim of the first ``wk`` leaf in a split-dim tree (``None``
    where it has none)."""
    if isinstance(tree, dict):
        if isinstance(tree.get("wk"), int):
            return tree["wk"]
        subs = tree.values()
    elif isinstance(tree, (list, tuple)):
        subs = tree
    else:
        return None
    return next((d for d in map(_wk_dim, subs) if d is not None), None)


def model_dim(*logical) -> int:
    """The dim of a weight hinted ``logical`` that the active model axis
    splits, or -1 (whole, or no model axis over 1). The engine places a
    weight only where its spec resolves alike with and without its whole
    shape (:func:`param_split_dims`), so the local slice needs no shape."""
    ctx = _current()
    if ctx is None or _model_size(ctx[0]) == 1:
        return -1
    return _split_of(resolve_spec(logical), ctx[0])


# -- the placement of a model's params ----------------------------------------

# the logical axes of each weight at its use site in the JAX models
# (``shard_hint`` in repro/models/{linear,layers,attention,rwkv,ssm,moe}.py),
# else its init axes there (the embedding, an untied head, the qkv biases,
# the RWKV and Mamba2 projections, zamba2's LoRA factors); every other leaf
# (norm scales, token-shift mixes, the decay's base, the router, the linear
# model's bias) stays whole
ATTN_AXES = {"wq": ("wg", "tp", None), "wk": ("wg", "tp", None),
             "wv": ("wg", "tp", None), "wo": ("tp", None, "fsdp"),
             "bq": ("tp", None), "bk": ("tp", None), "bv": ("tp", None)}
MLP_AXES = {"w_gate": ("wg", "tp"), "w_up": ("wg", "tp"),
            "w_down": ("tp", "wg")}
EMBED_AXES = {"embedding": ("tp", "fsdp"), "head": ("fsdp", "tp")}
LINEAR_AXES = {"w": ("fsdp", "tp"), "b": ()}
# RWKV6 time mix (repro/models/rwkv.py:46-53, w_o at its use site :185)
# and channel mix (:228-231)
RWKV_TM_AXES = {"w_r": ("fsdp", "tp"), "w_k": ("fsdp", "tp"),
                "w_v": ("fsdp", "tp"), "w_g": ("fsdp", "tp"),
                "w_o": ("tp", "fsdp"), "decay_a": ("fsdp", None),
                "decay_b": (None, "tp"), "bonus_u": ("tp", None)}
RWKV_CM_AXES = {"w_k": ("fsdp", "tp"), "w_v": ("tp", "fsdp"),
                "w_r": ("fsdp", "tp")}
# Mamba2 (repro/models/ssm.py:39-47, w_out at its use site :73)
MAMBA2_AXES = {"w_in": ("fsdp", "tp"), "conv_w": (None, "tp"),
               "a_log": ("tp",), "dt_bias": ("tp",), "d_skip": ("tp",),
               "norm_scale": ("tp",), "w_out": ("tp", "fsdp")}
# zamba2's per-invocation LoRA on the shared attention
# (repro/models/transformer.py:84-88)
SHARED_LORA_AXES = {"lora_q_a": ("fsdp", None), "lora_q_b": (None, "tp"),
                    "lora_o_a": ("tp", None), "lora_o_b": (None, "fsdp")}
# the routed experts at their use site (repro/models/moe.py:50-52): expert
# parallel; llama4's shared expert is the dense MLP
MOE_AXES = {"w_gate": ("tp", "fsdp", None), "w_up": ("tp", "fsdp", None),
            "w_down": ("tp", None, "fsdp")}

_MIXER_AXES = {"wq": ATTN_AXES, "w_r": RWKV_TM_AXES, "w_in": MAMBA2_AXES,
               "lora_q_a": SHARED_LORA_AXES}
# the MoE's experts share the MLP's names: the router tells them apart
_FFN_AXES = {"router": MOE_AXES, "mu_k": RWKV_CM_AXES, "w_gate": MLP_AXES}


def _axes_of(sub: dict, tables: dict, what: str) -> dict:
    """The logical axes of a mixer's or FFN's leaves: the table of the
    first key of ``tables`` in ``sub`` (hinted leaves), ``()`` for every
    other leaf (whole); a nested dict (the MoE's shared expert) is the
    dense MLP."""
    table = next((t for k, t in tables.items() if k in sub), None)
    if table is None:
        raise ValueError(f"{what} with params {sorted(sub)}: no hint "
                         f"table for it")
    return {k: dict(MLP_AXES) if isinstance(v, dict) else table.get(k, ())
            for k, v in sub.items()}


def _layer_axes(layer: dict) -> dict:
    out = {}
    for name, sub in layer.items():
        if name in ("norm1", "norm2"):
            out[name] = {k: () for k in sub}
        elif name == "mixer":
            out[name] = _axes_of(sub, _MIXER_AXES, "the mixer")
        elif name == "ffn":
            out[name] = sub and _axes_of(sub, _FFN_AXES, "the FFN")
        else:
            raise ValueError(f"the layer part {name!r}: no hint table for "
                             f"it")
    return out


def _stepped(tree):
    """A layer's logical axes with a leading ``None`` for the step axis of
    the stacked layers (whole leaves stay ``()``)."""
    if isinstance(tree, dict):
        return {k: _stepped(v) for k, v in tree.items()}
    return tree and (None,) + tree


def param_logical_axes(params) -> dict:
    """A tree like ``params`` (one client's, no client axis) of each
    leaf's logical axes, one name a dim (``()`` for a whole leaf): the
    linear models of §8.1, a transformer of the repo's archs (attention,
    RWKV6 and Mamba2 mixers, zamba2's shared block with its LoRA; MLP,
    RWKV channel-mix and MoE FFNs), or one of its MLP or attention layers.
    Stacked layers get a leading ``None`` for their step axis."""
    if set(params) == set(LINEAR_AXES):
        return dict(LINEAR_AXES)
    if set(params) == set(MLP_AXES):                  # one MLP
        return dict(MLP_AXES)
    if "wq" in params and set(params) <= set(ATTN_AXES):   # one attention
        return {k: ATTN_AXES[k] for k in params}
    if "segments" not in params:
        raise ValueError(f"a model with params {sorted(params)}: no hint "
                         f"table for it")
    out = {"embed": {k: EMBED_AXES[k] for k in params["embed"]},
           "final_norm": {k: () for k in params["final_norm"]},
           "segments": [{j: _stepped(_layer_axes(layer))
                         for j, layer in seg.items()}
                        for seg in params["segments"]]}
    if "shared" in params:                   # zamba2's shared block
        out["shared"] = {"attn": {k: ATTN_AXES[k]
                                  for k in params["shared"]["attn"]},
                         "mlp": dict(MLP_AXES)}
    return out


class _Whole:
    """The model group of one rank, where a layer's weights are whole:
    every collective is the identity and the rank's slice is the whole
    dim, so a layer's split code runs unsplit through it."""

    size, index = 1, 0

    @staticmethod
    def bounds(n: int) -> tuple[int, int]:
        return 0, n

    @staticmethod
    def _same(x, *_):
        return x

    copy_in = reduce_out = psum = local_slice = gather = _same

    @staticmethod
    def reduce_out_all(parts):
        return list(parts)

    psum_all = reduce_out_all


WHOLE = _Whole()


# the split every layer body is written for: each weight on the first dim
# its hint names "fsdp" or "tp" (what mesh2d_rules and serve_mesh_rules give)
_BODY_AXES = ("fsdp", "tp")


def _first_dim_named(logical: tuple, names) -> int:
    """The first dim of the logical axes ``logical`` whose name is in
    ``names`` (-1: none)."""
    return next((i for i, a in enumerate(logical) if a in names), -1)


def hinted_group(what: str, params, axes: dict):
    """The model group that splits the weights of ``params`` named in
    ``axes`` (their logical axes), or :data:`WHOLE` where every one is
    whole (no model axis over 1, or rules that split none). Each weight's
    split dim comes from the active context's rules (:func:`model_dim`):
    :func:`mesh2d_rules` under the training mesh, :func:`serve_mesh_rules`
    under the serving mesh, the rules the params were cut by
    (:func:`param_split_dims`), so one placement decides both the slices a
    rank holds and the dims its layer code splits. The layer bodies are
    written for the split those rules give (the first dim a hint names
    "fsdp" or "tp"); rules that place a weight elsewhere (JAX's literal
    ``serve_rules``, say, which would split Mamba2's ``w_in`` on its
    columns) raise ``NotImplementedError``."""
    grp = model_group()
    if grp is None:
        return WHOLE
    dims, want = {}, {}
    for name, logical in axes.items():
        if name in params:
            shard_hint(params[name], *logical)
            dims[name] = model_dim(*logical)
            want[name] = _first_dim_named(logical, _BODY_AXES)
    if dims == want:
        return grp
    if set(dims.values()) <= {-1}:
        return WHOLE
    raise NotImplementedError(
        f"{what} placed {dims} under a model axis: the port's tensor "
        f"parallelism covers the split mesh2d_rules and serve_mesh_rules "
        f"give ({want}) or none")


def param_split_dims(params, dm: int, rules: dict | None = None):
    """Each leaf's split dim (-1: whole) in a tree like ``params`` (one
    client's whole params, torch or numpy): its logical axes
    (:func:`param_logical_axes`) resolved by :func:`resolve_spec` under
    ``rules`` (default :func:`mesh2d_rules`) on a mesh with a model axis of
    ``dm``, on the whole shapes. A K/V leaf (:data:`KV_LEAVES`) whose head
    dim the model axis does not divide is whole (-1), as JAX's
    ``resolve_spec`` makes it: the attention body then computes every KV
    head on every rank (:func:`kv_heads_whole`). Any other leaf whose spec
    changes with its shape (a first-named dim the model axis does not
    divide, so the split would fall on a later dim) raises ``ValueError``:
    the port splits a weight on the dim its hint names first, which the
    model code finds again from the hint alone (:func:`model_dim`)."""
    import types
    mesh = types.SimpleNamespace(shape={MODEL_AXIS: dm})

    def one(logical, leaf, name):
        spec = resolve_spec(logical, tuple(leaf.shape))
        if name in KV_LEAVES and not any(a is not None for a in spec):
            return -1
        if tuple(resolve_spec(logical)) != tuple(spec):
            raise ValueError(
                f"a model axis of {dm} does not divide the dim a weight "
                f"hinted {logical} splits on (its whole shape "
                f"{tuple(leaf.shape)} resolves to {spec}); use a model axis "
                f"that divides it")
        return _split_of(spec, mesh) if dm > 1 else -1

    with axis_rules(mesh, mesh2d_rules() if rules is None else rules):
        return _map_logical(one, param_logical_axes(params), params,
                            named=True)


def local_params(params):
    """This rank's slices of the whole ``params`` under the active rules
    context: :func:`param_split_dims` under the context's rules cut at the
    rank's model coordinate (:func:`to_local`), then, where weights split
    over "data" too (:func:`data_placement`), the installed data dims cut
    at its data coordinate; ``params`` as they are without either."""
    grp = model_group()
    if grp is not None:
        dims = param_split_dims(params, grp.size, _current()[1])
        params = to_local(params, dims, grp.index, grp.size)
    dgrp = data_group()
    if dgrp is not None:
        params = to_local(params, data_placement(), dgrp.index, dgrp.size)
    return params


def needs_param_sharding(n_params: int, dm: int,
                         device_mem_bytes: int) -> bool:
    """Whether serving splits the weights over "data" too: a pure
    tensor-parallel placement's bf16 bytes a rank (``2 n / dm``) over 60%
    of a device's memory, the JAX dry run's ``_needs_param_sharding``
    (``src/repro/launch/dryrun.py:251-256``) with the device's memory as
    an argument."""
    return n_params * 2 / int(dm) > 0.6 * device_mem_bytes


# the names a weight's hint gives the dims a split may take: the data split
# falls on one of these where the port's model split took JAX's data dim
_WEIGHT_AXES = ("fsdp", "wg", "tp")


def data_split_dims(params, mesh_shape: tuple[int, int],
                    rules: dict | None = None):
    """Each leaf's data split dim (-1: whole over "data") in a tree like
    ``params`` (one replica's whole params, torch or numpy) when serving
    splits weights over "data" on the ``(dd, dm)`` serving mesh: the dim
    JAX's ``serve_rules(fsdp_over_data=True)`` puts "data" on
    (:func:`resolve_spec` on the whole shape, so dropped where ``dd`` does
    not divide it), or, where the port's model split
    (:func:`param_split_dims` under ``rules``, default
    :func:`serve_mesh_rules`) took that dim (Mamba2's ``w_in``, RWKV6's
    projections, an untied head), the first other dim the leaf's hint
    names "fsdp", "wg" or "tp" that ``dd`` divides, else none (a hint
    naming one dim: RWKV6's ``decay_a``, zamba2's ``lora_q_a`` /
    ``lora_o_b``). So a rank holds a ``1 / dd`` block of its model slice
    along a dim the model split leaves whole. Every leaf is -1 at ``dd ==
    1``."""
    import types
    dd, dm = (int(n) for n in mesh_shape)
    model = param_split_dims(params, dm,
                             serve_mesh_rules() if rules is None else rules)
    mesh = types.SimpleNamespace(shape={DATA_AXIS: dd, MODEL_AXIS: dm})

    def one(logical, pair):
        leaf, md = pair
        if dd == 1:
            return -1
        spec = resolve_spec(logical, tuple(leaf.shape))
        d = next((i for i, a in enumerate(spec) if a is not None
                  and DATA_AXIS in _atomic_axes(a)), -1)
        if d < 0 or d != md:
            return d
        return next((i for i, a in enumerate(logical)
                     if i != md and a in _WEIGHT_AXES
                     and leaf.shape[i] % dd == 0), -1)

    with axis_rules(mesh, serve_rules(fsdp_over_data=True)):
        return _map_logical(one, param_logical_axes(params),
                            _zip_dims(lambda x, d: (x, d), params, model))


def gather_data(tree, dims):
    """``tree`` (the rank's slices of some weights) with each leaf that
    ``dims`` (a tree like it, from :func:`data_split_dims`, each dim
    counted on the leaf as it is in ``tree``) splits over "data"
    gathered over the data group (:func:`data_group`) into the
    model slice the layer bodies run on, in one byte-sum all-reduce for
    the whole tree (:meth:`repro_torch.mesh.collectives.ModelGroup
    .gather_all`); ``tree`` itself without a data group. The gathered
    leaves are views of one buffer, freed with the returned tree."""
    grp = data_group()
    if grp is None:
        return tree
    parts = []
    _zip_dims(lambda x, d: parts.append((x, d)) if d >= 0 else None, tree,
              dims)
    if not parts:
        return tree
    whole = iter(grp.gather_all([x for x, _ in parts],
                                [d for _, d in parts]))
    return _zip_dims(lambda x, d: next(whole) if d >= 0 else x, tree, dims)


def cache_split_dims(cache_axes, caches=None):
    """Each cache leaf's split dim (-1: whole) under the active rules
    context, in a tree like ``cache_axes`` (the model's ``cache_axes``, one
    logical name a dim): the dim the context's rules put on a group of
    ranks over 1. That is a model axis for the heads (under
    :func:`serve_mesh_rules` the heads of a KV cache, RWKV6's ``wkv`` and
    Mamba2's ``h``), and the sequence group (:func:`seq_group`: "model",
    "data" or both) for a KV cache's ``cache_seq``; every leaf whole
    without one. Given ``caches`` (a tree like it of the whole leaves, or
    their meta stand-ins), a sequence the group does not divide stays
    whole, as ``resolve_spec`` drops the axis. A KV cache split on both its
    sequence (over "data") and its heads (over "model": ``shard_seq``
    with KV heads the model axis divides) gets the pair ``(sequence dim,
    heads dim)`` (:func:`split_dims` reads either form). The rows
    ("batch" on "data") are the rank's own and are not counted here."""
    ctx = _current()
    if ctx is None:
        return _map_logical(lambda logical, _: -1, cache_axes, None)
    mesh, rules = ctx
    names = set() if _model_size(mesh) == 1 else {
        a for a, axis in rules.items() if axis == MODEL_AXIS}
    names.discard("cache_seq")

    def one(logical, leaf):
        seq = -1
        if seq_group() is not None:     # the sequence, dropped where the
            seq = _split_of(resolve_spec(     # group does not divide it
                tuple(a if a == "cache_seq" else None for a in logical),
                None if leaf is None else tuple(leaf.shape)),
                mesh, (MODEL_AXIS, DATA_AXIS))
        heads = _first_dim_named(logical, names)
        if seq >= 0 and heads >= 0:
            return seq, heads
        return max(seq, heads)

    return _map_logical(one, cache_axes, caches)


def split_dims(d) -> tuple[int, ...]:
    """The split dims of one leaf of :func:`cache_split_dims`: ``()`` for
    -1, ``(d,)`` for one dim, the pair as it is."""
    if isinstance(d, tuple):
        return d
    return () if d < 0 else (d,)


def cache_group(logical, dim: int):
    """The group that splits dim ``dim`` of a cache leaf hinted
    ``logical`` (:func:`cache_split_dims`): the sequence group for its
    ``cache_seq``, else the model group; ``None`` for a whole leaf."""
    if dim < 0:
        return None
    return seq_group() if logical[dim] == "cache_seq" else model_group()


def caches_to_whole(caches, cache_axes, dims):
    """The rank's caches made whole on every rank: each leaf split along
    ``dims`` (:func:`cache_split_dims`) gathered over its group
    (:func:`cache_group`), over each group in turn where two split it."""
    def walk(tree, axes, d):
        if isinstance(tree, dict):
            return {k: walk(v, axes[k], d[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, a, x) for v, a, x in
                              zip(tree, axes, d))
        for dim in split_dims(d):
            tree = cache_group(axes, dim).gather(tree, dim)
        return tree

    return walk(caches, cache_axes, dims)


def split_sizes(params) -> dict[str, int]:
    """``{leaf name: size}`` of the dim a model axis splits in each split
    leaf of ``params`` (one client's whole params; a name met twice keeps
    its smallest size): what the model axis must divide. The K/V leaves
    are left out: a model axis that does not divide them keeps them whole
    (:func:`param_split_dims`)."""
    out: dict[str, int] = {}

    def walk(axes, tree, name):
        if _is_logical(axes):
            i = _first_dim_named(axes, _BODY_AXES)
            if i >= 0 and name not in KV_LEAVES:
                out[name] = min(out.get(name, tree.shape[i]),
                                tree.shape[i])
            return
        items = (axes.items() if isinstance(axes, dict)
                 else enumerate(axes))
        for k, sub in items:
            walk(sub, tree[k], k if isinstance(k, str) else name)

    walk(param_logical_axes(params), params, "")
    return out


def to_local(tree, dims, index: int, dm: int, lead: int = 0):
    """This rank's slices of ``tree`` (torch tensors or numpy arrays):
    leaf by leaf its ``index``-th of ``dm`` parts along ``dims``' dim
    (shifted by ``lead`` leading axes, e.g. 1 for the client axis); whole
    leaves (-1) pass through. Torch slices are contiguous copies."""
    def one(x, d):
        if d < 0:
            return x
        d += lead
        per = x.shape[d] // dm
        if hasattr(x, "narrow"):
            return x.narrow(d, index * per, per).contiguous()
        return x.take(range(index * per, (index + 1) * per), axis=d)

    return _zip_dims(one, tree, dims)


def to_whole(tree, dims, group, lead: int = 0):
    """The slices of ``tree`` joined over the model ``group``
    (:class:`repro_torch.mesh.collectives.ModelGroup`) into whole leaves:
    :func:`to_local` undone, on every rank."""
    return _zip_dims(lambda x, d: x if d < 0 else group.gather(x, d + lead),
                     tree, dims)


def _zip_dims(fn, tree, dims):
    if isinstance(tree, dict):
        return {k: _zip_dims(fn, v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_dims(fn, v, d) for v, d in zip(tree, dims)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_dims(fn, v, d) for v, d in zip(tree, dims))
    if tree is None:
        return None
    return fn(tree, dims)


def state_split_dims(state, params, dims):
    """Split dims for an optimizer state over ``params``: each subtree
    shaped like ``params`` (momentum, AdamW moments) is split as the params
    are (``dims``); every other leaf (step counters) stays whole."""
    from repro_torch.utils.tree import tree_flatten
    want = tree_flatten(params)[1]

    def walk(node):
        if node is None:
            return None
        if tree_flatten(node)[1] == want:
            return dims
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return -1

    return walk(state)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def _map_logical(fn, tree, shapes, named: bool = False, name=None):
    """``fn(logical, leaf)`` at each logical-axes tuple of ``tree`` (its
    leaf from ``shapes``, or ``None``); with ``named`` also the leaf's
    dict key, ``fn(logical, leaf, key)``."""
    if _is_logical(tree):
        return fn(tree, shapes, name) if named else fn(tree, shapes)
    if isinstance(tree, dict):
        return {k: _map_logical(fn, v, None if shapes is None else shapes[k],
                                named, k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_logical(fn, v, None if shapes is None else shapes[i],
                            named, name)
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    raise TypeError(f"not a logical-axis tree: {tree!r}")


def shard_bytes(logical_tree, tree) -> int:
    """The bytes one rank holds of ``tree`` (tensors, or meta stand-ins)
    under the active rules: each leaf's bytes over the sizes of the mesh
    axes its logical axes (a tree like ``tree``) resolve to on its whole
    shape (:func:`resolve_spec`, so each split divides). What JAX's
    ``NamedSharding`` of the same specs puts on a device."""
    mesh = _current()[0]

    def one(logical, x):
        n = x.numel() * x.element_size()
        for axis in resolve_spec(logical, tuple(x.shape)):
            n //= _mesh_axis_size(mesh, axis)
        return n

    from repro_torch.utils.tree import tree_leaves
    return sum(tree_leaves(_map_logical(one, logical_tree, tree)))


def spec_tree(logical_tree, shape_tree=None):
    """Map a pytree of logical-axis tuples to PartitionSpecs (with the
    divisibility drop when ``shape_tree`` gives each leaf's tensor)."""
    return _map_logical(
        lambda lg, arr: resolve_spec(
            lg, None if arr is None else tuple(arr.shape)),
        logical_tree, shape_tree)
