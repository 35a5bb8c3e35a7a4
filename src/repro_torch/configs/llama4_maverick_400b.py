"""llama4-maverick-400b-a17b [moe]: 128 experts top-1, early fusion, iRoPE
[hf:meta-llama/Llama-4-Scout-17B-16E family].

Assigned spec: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert)
vocab=202048, MoE 128e top-1 + shared expert. iRoPE adaptation: 3-in-4 layers
use chunked attention (8192-token chunks, RoPE); 1-in-4 layers are global
with NoRoPE. The chunked layers bound the decode cache -> long_500k runs
(global layers' caches sharded over sequence).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, patterned_segments, register

# Maverick interleaves MoE and dense FFN layers 1:1 (interleave_moe_step=2);
# attention is iRoPE 3:1 chunked:global. Period-4 pattern: 24 MoE + 24 dense.
_C_MOE = LayerSpec(mixer="attn", ffn="moe", attn_kind="chunk", use_rope=True)
_C_MLP = LayerSpec(mixer="attn", ffn="mlp", attn_kind="chunk", use_rope=True)
_G_MLP = LayerSpec(mixer="attn", ffn="mlp", attn_kind="full", use_rope=False)

LLAMA4_MAVERICK_400B = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_layers=48,
    head_dim=128,
    segments=patterned_segments(48, (_C_MOE, _C_MLP, _C_MOE, _G_MLP)),
    chunk=8192,
    n_experts=128,
    top_k=1,
    moe_d_ff=8192,
    shared_expert=True,
    capacity_factor=1.25,
    loss_chunk=1024,
    rope_theta=5e5,
    subquadratic=True,
))
