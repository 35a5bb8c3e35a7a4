"""gemma3-4b [dense]: 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family].

Assigned spec: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
Gemma3 uses head_dim=256 (decoupled from d_model/n_heads), sliding window
1024 on local layers, sqrt(d) embedding scaling. The 5:1 SWA pattern gives a
sub-quadratic decode path (global layers' caches are sharded over sequence)
-> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, patterned_segments, register

_LOCAL = LayerSpec(mixer="attn", ffn="mlp", attn_kind="swa")
_GLOBAL = LayerSpec(mixer="attn", ffn="mlp", attn_kind="full")

GEMMA3_4B = register(ArchConfig(
    name="gemma3-4b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    n_layers=34,
    head_dim=256,
    segments=patterned_segments(
        34, (_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL)),
    window=1024,
    embed_scale=True,
    loss_chunk=1024,
    rope_theta=1e6,
    subquadratic=True,
))
