"""Three-term roofline model for one NVIDIA H100 SXM (the port's target).

    compute term    = flops / peak FLOP/s of the run's dtype
    memory term     = hbm_bytes / HBM bandwidth
    collective term = collective bytes / NVLink bandwidth

The counterpart of the JAX package's ``repro/utils/roofline.py``, with the
same fields, ``as_dict()`` keys and parameter arithmetic, and the H100's
terms in place of TPU v5e's. The numbers are NVIDIA's H100 SXM5 data
sheet values:

- ``HBM_BW`` 3.35e12 B/s: HBM3 bandwidth of the 80 GB SXM part;
- ``PEAK_FLOPS_BF16`` 989e12 FLOP/s: dense bf16 on the tensor cores (the
  data sheet's 1,979 is with 2:4 sparsity);
- ``PEAK_FLOPS_F32`` 67e12 FLOP/s: f32 on the CUDA cores (TF32 tensor
  cores are not used: they would fail the port's f32 parity gates);
- ``NVLINK_BW`` 450e9 B/s: NVLink 4's 900 GB/s total, per direction.

The flops and bytes come from :func:`repro_torch.utils.cost.cost_of` (or a
kernel's ``cost``), which count what one card does, so nothing is divided
by a card count. On one card ``coll_bytes`` is 0 and so is the collective
term. ``t_compute`` reads the peak of the record's ``dtype`` (bf16 unless
the run is f32).
"""
from __future__ import annotations

from dataclasses import dataclass, field

# -- NVIDIA H100 SXM constants (data sheet) --------------------------------
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12       # FLOP/s, f32 CUDA cores
HBM_BW = 3.35e12             # B/s, HBM3
NVLINK_BW = 450e9            # B/s per direction

_PEAKS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}


def peak_flops(dtype="bfloat16") -> float:
    """The card's peak FLOP/s for ``dtype`` (a name or a ``torch.dtype``):
    bf16 on the tensor cores, f32 on the CUDA cores."""
    name = str(dtype).replace("torch.", "")
    try:
        return _PEAKS[name]
    except KeyError:
        raise ValueError(f"no H100 peak for dtype {dtype!r}; known: "
                         f"{sorted(_PEAKS)}") from None


@dataclass
class RooflineTerms:
    flops: float                 # flops of the work on one card
    hbm_bytes: float             # bytes the work moves to and from HBM
    coll_bytes: float            # bytes over NVLink (0 on one card)
    model_flops: float = 0.0     # 6*N*D (train) / 2*N*D (inference), global
    chips: int = 1
    coll_breakdown: dict = field(default_factory=dict)
    dtype: str = "bfloat16"      # whose peak t_compute divides by

    @property
    def t_compute(self) -> float:
        return self.flops / peak_flops(self.dtype)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (flops summed over cards)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "chips": self.chips,
            "coll_breakdown": self.coll_breakdown,
        }


def model_flops_estimate(n_params_active: float, tokens: float,
                         kind: str) -> float:
    """6*N*D for training, 2*N*D for inference forward passes."""
    if kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens


def active_params(cfg, n_params_total: float) -> float:
    """MoE: scale expert params down to the activated top-k fraction."""
    if not cfg.n_experts:
        return n_params_total
    # expert FFN params per layer: 3 * d_model * moe_d_ff * n_experts
    moe_layers = sum(1 for ls in cfg.layer_specs() if ls.ffn == "moe")
    expert_total = 3.0 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff) \
        * cfg.n_experts * moe_layers
    expert_active = expert_total * cfg.top_k / cfg.n_experts
    return n_params_total - expert_total + expert_active
