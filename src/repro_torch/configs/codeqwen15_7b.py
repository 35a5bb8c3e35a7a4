"""codeqwen1.5-7b [dense]: qwen1.5 architecture [hf:Qwen/CodeQwen1.5-7B].

Assigned spec: 32L d_model=4096 32H (GQA kv=32 = MHA) d_ff=13440 vocab=92416.
Qwen1.5 uses QKV biases.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register, uniform_segments

CODEQWEN15_7B = register(ArchConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    source="hf:Qwen/CodeQwen1.5-7B",
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    n_layers=32,
    segments=uniform_segments(32, LayerSpec(mixer="attn", ffn="mlp")),
    qkv_bias=True,
    loss_chunk=1024,
    rope_theta=1e6,
    subquadratic=False,
))
