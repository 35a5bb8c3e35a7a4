"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention [arXiv:2411.15242].

Assigned spec: 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64. We implement 81 Mamba2 layers with ONE shared-weight
attention+MLP block invoked every 6 layers (13 invocations), each with
per-invocation LoRA deltas on the attention projections — the adaptation of
Zamba2's shared blocks recorded in DESIGN.md §5.5. Hybrid -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, Segment, register

_M = LayerSpec(mixer="mamba2", ffn="none")
_SH = LayerSpec(mixer="shared_attn", ffn="shared_mlp")

ZAMBA2_7B = register(ArchConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    n_layers=81,             # mamba2 layers; + 13 shared-attn invocations
    segments=(
        Segment(n_steps=13, pattern=(_SH, _M, _M, _M, _M, _M, _M)),
        Segment(n_steps=1, pattern=(_M, _M, _M)),
    ),
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    lora_rank=64,
    rope_theta=1e4,
    subquadratic=True,
))
