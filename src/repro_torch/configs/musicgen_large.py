"""musicgen-large [audio]: decoder-only over EnCodec tokens [arXiv:2306.05284].

Assigned spec: 48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048.
EnCodec frontend is a STUB: tokens ARE codec tokens (vocab 2048); the text
conditioning is adapted from cross-attention to prefix embeddings (B, 64, d)
— documented deviation (DESIGN.md §5.4).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register, uniform_segments

MUSICGEN_LARGE = register(ArchConfig(
    name="musicgen-large",
    arch_type="audio",
    source="arXiv:2306.05284",
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    n_layers=48,
    segments=uniform_segments(48, LayerSpec(mixer="attn", ffn="mlp")),
    rope_theta=1e4,
    prefix_len=64,           # T5 text-conditioning embeddings stub
    subquadratic=False,
))
