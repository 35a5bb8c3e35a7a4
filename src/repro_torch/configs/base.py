"""Architecture config schema + registry (a jax-free copy of the JAX
package's ``repro/configs/base.py``, field for field).

An architecture is a stack of *segments*; each segment is ``n_steps``
repetitions (stacked params, a leading ``n_steps`` axis on every leaf) of a
``pattern`` of layers: gemma3's 5:1 local:global, llama4's 3:1
chunked:global iRoPE, zamba2's shared-attention-every-6-mamba.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # attn | mamba2 | rwkv6 | shared_attn
    ffn: str = "mlp"           # mlp | moe | rwkv_cm | none | shared_mlp
    attn_kind: str = "full"    # full | swa | chunk
    use_rope: bool = True


@dataclass(frozen=True)
class Segment:
    n_steps: int
    pattern: tuple[LayerSpec, ...]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str             # dense | moe | ssm | hybrid | vlm | audio
    source: str                # paper / model-card citation
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_layers: int
    segments: tuple[Segment, ...]
    head_dim: int = 0          # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int = 0            # sliding-window size (swa layers)
    chunk: int = 0             # chunk size (chunked-attention layers)
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scale
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_impl: str = "scatter"
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssd_chunk: int = 128
    # --- RWKV ---
    rwkv_headdim: int = 64
    rwkv_chunk: int = 0        # 0 = per-token scan; >0 = chunk-parallel WKV6
    # --- shared attention block (zamba2) ---
    lora_rank: int = 0
    # --- modality frontend stub (vlm / audio) ---
    prefix_len: int = 0        # precomputed patch/frame embeddings length
    # --- misc ---
    tie_head: bool = True
    dtype: str = "bfloat16"
    remat: bool = True
    # fully unroll the layer/loss-chunk scans (straight-line HLO). Required
    # inside the mesh_2d partial-auto shard_map region, where XLA's SPMD
    # partitioner cannot propagate manual-subgroup shardings into while
    # loops (hlo_sharding_util IsManualSubgroup check). Numerics identical;
    # compile time grows with depth, so keep False everywhere else.
    scan_unroll: bool = False
    block_q: int = 512
    loss_chunk: int = 0        # 0 = unchunked cross-entropy (hillclimb knob)
    embed_impl: str = "gather"  # "gather" | "one_hot" (§Perf knob)
    causal_buckets: bool = False  # bucketed causal block-skip (§Perf knob)
    # long-context support (decides long_500k applicability)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_specs(self):
        out = []
        for seg in self.segments:
            for _ in range(seg.n_steps):
                out.extend(seg.pattern)
        return out

    def count_mixers(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for ls in self.layer_specs():
            counts[ls.mixer] = counts.get(ls.mixer, 0) + 1
        return counts


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import all config modules lazily
        import repro_torch.configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)


def uniform_segments(n_layers: int, spec: LayerSpec) -> tuple[Segment, ...]:
    return (Segment(n_steps=n_layers, pattern=(spec,)),)


def patterned_segments(n_layers: int, pattern: tuple[LayerSpec, ...]
                       ) -> tuple[Segment, ...]:
    """Repeat ``pattern`` as many full times as fits; remainder becomes a
    second segment with a truncated pattern."""
    p = len(pattern)
    full, rem = divmod(n_layers, p)
    segs = []
    if full:
        segs.append(Segment(n_steps=full, pattern=pattern))
    if rem:
        segs.append(Segment(n_steps=1, pattern=pattern[:rem]))
    return tuple(segs)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced config of the same family: <=2 segment steps, d_model<=256,
    <=4 experts — runnable on CPU for the per-arch smoke tests."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    segs = []
    total = 0
    for seg in cfg.segments:
        if total >= 2:
            break
        segs.append(Segment(n_steps=1, pattern=seg.pattern[:4]))
        total += 1
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=0,
        d_ff=min(cfg.d_ff, 512),
        vocab=min(cfg.vocab, 512),
        n_layers=sum(len(s.pattern) * s.n_steps for s in segs),
        segments=tuple(segs),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.moe_d_ff else 0,
        # drop-free capacity at smoke scale so teacher-forced decode matches
        # the full forward exactly (capacity drops are a train-time effect)
        capacity_factor=4.0 if cfg.n_experts else cfg.capacity_factor,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else cfg.ssm_headdim,
        rwkv_headdim=32,
        window=min(cfg.window, 16) if cfg.window else 0,
        chunk=min(cfg.chunk, 16) if cfg.chunk else 0,
        lora_rank=min(cfg.lora_rank, 4) if cfg.lora_rank else 0,
        prefix_len=min(cfg.prefix_len, 8) if cfg.prefix_len else 0,
        block_q=8,
        ssd_chunk=8,
        loss_chunk=0,
        dtype="float32",
        remat=False,
    )
