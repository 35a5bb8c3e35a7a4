"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407].

Assigned spec: 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register, uniform_segments

MISTRAL_LARGE_123B = register(ArchConfig(
    name="mistral-large-123b",
    arch_type="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    n_layers=88,
    head_dim=128,
    segments=uniform_segments(88, LayerSpec(mixer="attn", ffn="mlp")),
    rope_theta=1e6,
    subquadratic=False,
))
