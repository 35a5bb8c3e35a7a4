"""granite-20b [dense]: llama-arch code model, MQA [arXiv:2405.04324].

Assigned spec: 52L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register, uniform_segments

GRANITE_20B = register(ArchConfig(
    name="granite-20b",
    arch_type="dense",
    source="arXiv:2405.04324",
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    n_layers=52,
    segments=uniform_segments(52, LayerSpec(mixer="attn", ffn="mlp")),
    rope_theta=1e4,
    loss_chunk=1024,
    subquadratic=False,
))
