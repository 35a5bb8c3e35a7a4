"""rwkv6-1.6b [ssm]: RWKV-6 "Finch" — data-dependent decay [arXiv:2404.05892].

Assigned spec: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
Each layer = time-mix (WKV6 recurrence) + channel-mix. Sub-quadratic:
decode state is O(1) in sequence length -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register, uniform_segments

RWKV6_1_6B = register(ArchConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    d_model=2048,
    n_heads=32,              # = d_model / rwkv_headdim (bookkeeping only)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    n_layers=24,
    segments=uniform_segments(24, LayerSpec(mixer="rwkv6", ffn="rwkv_cm")),
    rwkv_headdim=64,
    loss_chunk=1024,
    subquadratic=True,
))
