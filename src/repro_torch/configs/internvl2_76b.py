"""internvl2-76b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821].

Assigned spec: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision encoder is a STUB: input_specs() provides precomputed patch
embeddings (B, 256, d_model); this config is the language backbone that
consumes them (DESIGN.md §5.4).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register, uniform_segments

INTERNVL2_76B = register(ArchConfig(
    name="internvl2-76b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    n_layers=80,
    segments=uniform_segments(80, LayerSpec(mixer="attn", ffn="mlp")),
    rope_theta=1e6,
    prefix_len=256,          # ViT patch embeddings stub
    loss_chunk=1024,
    subquadratic=False,
))
