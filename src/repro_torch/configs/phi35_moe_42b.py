"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

Assigned spec: 32L d_model=4096 32H (GQA kv=8) d_ff=6400 (per expert)
vocab=32064, MoE 16e top-2.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register, uniform_segments

PHI35_MOE_42B = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_layers=32,
    segments=uniform_segments(32, LayerSpec(mixer="attn", ffn="moe")),
    n_experts=16,
    top_k=2,
    moe_d_ff=6400,
    rope_theta=1e4,
    subquadratic=False,
))
