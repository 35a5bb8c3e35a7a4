"""Byzantine-robust aggregation and update attacks at the Eq.-7b boundary.

The two halves of the trust plane's threat model, as plugins of
:class:`repro_torch.core.aggregation.AggregationPipeline`:

* **robust aggregators** replace the participant mean with a reduction a
  bounded fraction of corrupted updates cannot drag arbitrarily far:

  ``median``        coordinate-wise median of the participant updates
                    (Yin et al. 2018), the mean of the two middle values
                    when P is even.
  ``trimmed_mean``  coordinate-wise mean after dropping the
                    ``floor(trim_fraction * P)`` largest and smallest values.
  ``norm_bound``    mean over the updates whose L2 norm is within
                    ``factor`` times the median participant norm.

  ``mean`` (the default) keeps the pipeline's own masked-mean expressions.

* **update attacks** corrupt the byzantine clients' uploads at the server
  boundary, after compression: ``sign_flip`` negates the update, ``scale``
  multiplies it by ``attack_scale`` (a negative scale is the boosted
  sign-flip poison). The byzantine set is static, drawn once per
  ``(seed, byzantine_fraction)`` from ``default_rng((seed, TAG))``, so it
  equals the JAX package's set exactly.

The reductions act on the (P, D) participant rows that
:func:`participant_rows` gathers without a host sync; they are plain torch
(the JAX package has no Pallas kernel for them). Label flipping, the
data-level attack, binds to virtual client ids in
:func:`repro_torch.population.attacks.malicious_population`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

AGGREGATORS = ("mean", "median", "trimmed_mean", "norm_bound")
ATTACKS = ("none", "sign_flip", "scale")

_BYZ_TAG = 0xB42A17


def validate_aggregator(name: str, trim_fraction: float = 0.1,
                        norm_bound_factor: float = 3.0) -> None:
    """The robust-aggregator knobs' invariants (spec and factory)."""
    if name not in AGGREGATORS:
        raise ValueError(f"aggregator must be one of {AGGREGATORS}, "
                         f"got {name!r}")
    if not 0.0 <= trim_fraction < 0.5:
        raise ValueError(f"trim_fraction must be in [0, 0.5) (trimming half "
                         f"from each end leaves nothing), "
                         f"got {trim_fraction}")
    if norm_bound_factor <= 0.0:
        raise ValueError(f"norm_bound_factor must be positive, "
                         f"got {norm_bound_factor}")


def validate_attack(name: str, byzantine_fraction: float = 0.0,
                    attack_scale: float = 10.0) -> None:
    """The update-attack knobs' invariants (spec and factory)."""
    if name not in ATTACKS:
        raise ValueError(f"attack must be one of {ATTACKS}, got {name!r}")
    if not 0.0 <= byzantine_fraction < 1.0:
        raise ValueError(f"byzantine_fraction must be in [0, 1) (a fully "
                         f"byzantine fleet has no signal to aggregate), "
                         f"got {byzantine_fraction}")
    if attack_scale == 0.0:
        raise ValueError(f"attack_scale must be nonzero (zero would drop "
                         f"the byzantine uploads instead of corrupting "
                         f"them), got {attack_scale}")


# ---------------------------------------------------------------------------
# robust aggregators: (P, D) participant updates -> (D,) aggregate
# ---------------------------------------------------------------------------

def _median0(x: torch.Tensor) -> torch.Tensor:
    """The median over axis 0 as ``jnp.median`` computes it: sorted, then
    ``(low + high) * 0.5`` of the two middle values (one value when the
    count is odd). ``torch.median`` would return the lower one."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


@dataclass(frozen=True)
class CoordinateMedian:
    """Coordinate-wise median of the participant updates."""

    def __call__(self, updates: torch.Tensor) -> torch.Tensor:
        return _median0(updates)


@dataclass(frozen=True)
class TrimmedMean:
    """Per coordinate: sort the P values, drop ``floor(trim_fraction * P)``
    from each end, average the rest."""
    trim_fraction: float

    def __call__(self, updates: torch.Tensor) -> torch.Tensor:
        p = updates.shape[0]
        k = int(self.trim_fraction * p)
        s = torch.sort(updates, dim=0).values
        return torch.mean(s[k:p - k], dim=0)


@dataclass(frozen=True)
class NormBound:
    """Mean over the participants whose L2 norm is within ``factor`` times
    the median participant norm; outliers are rejected whole. The
    denominator is floored at one for factors below one."""
    factor: float

    def __call__(self, updates: torch.Tensor) -> torch.Tensor:
        norms = torch.linalg.vector_norm(updates, dim=1)
        keep = (norms <= self.factor * _median0(norms)).to(torch.float32)
        denom = torch.clamp(torch.sum(keep), min=1.0)
        return torch.sum(keep[:, None] * updates, dim=0) / denom


def make_aggregator(name: str, trim_fraction: float = 0.1,
                    norm_bound_factor: float = 3.0):
    """A robust aggregator by spec name; ``"mean"`` -> None (the pipeline's
    masked-mean expressions stay as they are)."""
    validate_aggregator(name, trim_fraction, norm_bound_factor)
    if name == "mean":
        return None
    if name == "median":
        return CoordinateMedian()
    if name == "trimmed_mean":
        return TrimmedMean(trim_fraction)
    return NormBound(norm_bound_factor)


def participant_rows(updates: torch.Tensor, mask: torch.Tensor,
                     n_participants: int) -> torch.Tensor:
    """The (P, D) participant rows of the (C, D) updates under the 0/1
    ``mask``, in client order (a stable sort of ``-mask``); P is the
    spec's static participant count, so no value comes to the host."""
    order = torch.argsort(-mask, stable=True)
    return torch.index_select(updates, 0, order[:n_participants])


# ---------------------------------------------------------------------------
# update attacks
# ---------------------------------------------------------------------------

def byzantine_flags(n_clients: int, byzantine_fraction: float,
                    seed: int = 0) -> tuple[int, ...]:
    """The static 0/1 byzantine membership of a resident federation:
    ``round(fraction * C)`` clients drawn without replacement from
    ``default_rng((seed, TAG))``."""
    validate_attack("none", byzantine_fraction)
    n_byz = int(round(byzantine_fraction * n_clients))
    flags = np.zeros((n_clients,), np.int64)
    if n_byz > 0:
        rng = np.random.default_rng((seed, _BYZ_TAG))
        flags[rng.choice(n_clients, size=n_byz, replace=False)] = 1
    return tuple(int(f) for f in flags)


@dataclass(frozen=True)
class UpdateAttack:
    """Corrupt the flagged clients' (C, D) upload rows. A select: honest
    rows pass through bit-unchanged."""
    attack: str                      # "sign_flip" | "scale"
    flags: tuple[int, ...]
    scale: float = 10.0

    def __call__(self, updates: torch.Tensor) -> torch.Tensor:
        sel = self._selector(updates.device)
        if self.attack == "sign_flip":
            return torch.where(sel, -updates, updates)
        return torch.where(sel, self.scale * updates, updates)

    def _selector(self, device) -> torch.Tensor:
        """The (C, 1) bool byzantine selector on ``device``, built once per
        device (a host copy a round would cost a copy each time)."""
        cache = self.__dict__.setdefault("_sel", {})
        sel = cache.get(device)
        if sel is None:
            sel = cache[device] = torch.tensor(
                self.flags, dtype=torch.bool, device=device)[:, None]
        return sel


def make_attack(name: str, flags: tuple[int, ...],
                attack_scale: float = 10.0):
    """An update attack by spec name; ``"none"`` (or an all-honest flag
    vector) -> None."""
    validate_attack(name, attack_scale=attack_scale)
    if name == "none" or not any(flags):
        return None
    return UpdateAttack(name, tuple(int(f) for f in flags), attack_scale)


def flip_labels(y: np.ndarray, n_classes: int) -> np.ndarray:
    """The label-flip data poison: class c -> n_classes - 1 - c."""
    return (n_classes - 1 - np.asarray(y)).astype(np.asarray(y).dtype)
