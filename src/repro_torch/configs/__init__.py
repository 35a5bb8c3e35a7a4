"""Config registry: importing this package registers all assigned archs.

A jax-free copy of the JAX package's ``repro.configs`` (the same dataclasses
and the same ten architectures); ``configs/shapes.py``, the dry run's input
shapes, is not ported.
"""
from repro_torch.configs.base import (
    ArchConfig,
    LayerSpec,
    Segment,
    get_arch,
    list_archs,
    patterned_segments,
    register,
    smoke_variant,
    uniform_segments,
)

# one module per assigned architecture (registration side effect)
from repro_torch.configs import codeqwen15_7b      # noqa: F401
from repro_torch.configs import gemma3_4b          # noqa: F401
from repro_torch.configs import granite_20b        # noqa: F401
from repro_torch.configs import internvl2_76b     # noqa: F401
from repro_torch.configs import llama4_maverick_400b  # noqa: F401
from repro_torch.configs import mistral_large_123b    # noqa: F401
from repro_torch.configs import musicgen_large     # noqa: F401
from repro_torch.configs import phi35_moe_42b      # noqa: F401
from repro_torch.configs import rwkv6_1_6b         # noqa: F401
from repro_torch.configs import zamba2_7b          # noqa: F401

ASSIGNED_ARCHS = [
    "internvl2-76b",
    "musicgen-large",
    "mistral-large-123b",
    "codeqwen1.5-7b",
    "rwkv6-1.6b",
    "zamba2-7b",
    "gemma3-4b",
    "phi3.5-moe-42b-a6.6b",
    "granite-20b",
    "llama4-maverick-400b-a17b",
]

__all__ = [
    "ArchConfig", "LayerSpec", "Segment", "get_arch", "list_archs",
    "patterned_segments", "register", "smoke_variant", "uniform_segments",
    "ASSIGNED_ARCHS",
]
