"""Simulated device clocks: pluggable per-client latency distributions
(numpy only, a copy of the JAX package's ``asyncfl/clock.py``: the same draws).

Buffered-async federation (:mod:`repro_torch.asyncfl`) measures its speedup in
**simulated seconds**, not host time: every dispatched client draws a
compute+upload latency from a :class:`LatencyModel`, the virtual clock
advances to each flush's B-th arrival, and a sync baseline for the same
fleet is the per-round barrier ``max`` over all clients
(:func:`sync_round_duration`).

Determinism contract (the same one ``repro_torch.population.samplers`` uses for
cohorts): a draw depends ONLY on ``(model seed, vid, dispatch seq)`` via a
fresh ``np.random.default_rng((seed, _LATENCY_TAG, vid, seq))`` per
element — no sampler state, so checkpoint/resume replays the identical
arrival schedule from the counters carried on the
:class:`repro_torch.asyncfl.runtime.AsyncState`, and the chunked driver can
project the event schedule ahead of execution
(:class:`repro_torch.asyncfl.events.EventView`) without desyncing from the
per-cycle driver.

Three models ship (plus the :func:`latency_profile` CLI factory):

* :class:`UniformLatency` — compute ~ U(a, b) + upload ~ U(c, d). With
  zero spread (``a == b``, ``c == d``) every device is identical — the
  degenerate clock of the sync-equivalence identity gate.
* :class:`LognormalLatency` — heavy-tailed compute times
  (``median * lognormal(0, sigma)``), the classic straggler model.
* :class:`HeteroLatency` — per-vid means scaled by a
  :class:`repro_torch.population.samplers.HeterogeneousCohort`'s availability
  rates: ``mean_v = base * (1 + slow_factor * (1 - rate_v))``, so flaky
  (low-availability) devices are also the slow ones — the correlation
  that makes staleness weighting matter.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol

import numpy as np

# integer stream tag (SeedSequence entropy): disjoint from the cohort /
# rates tags of repro_torch.population.samplers
_LATENCY_TAG = 0x1A7E9C


class LatencyModel(Protocol):
    """``model(vids, seqs) -> (n,) float64 simulated seconds``: the total
    compute+upload latency of each (client vid, dispatch seq) pair. Must
    be a pure function of ``(self, vid, seq)`` — see the module
    determinism contract."""

    def __call__(self, vids: np.ndarray, seqs: np.ndarray) -> np.ndarray: ...


def _element_rngs(seed: int, vids, seqs):
    """One independent Generator per (vid, seq) element."""
    return [np.random.default_rng((int(seed), _LATENCY_TAG, int(v), int(s)))
            for v, s in zip(np.asarray(vids).ravel(), np.asarray(seqs).ravel())]


def _check_range(name: str, lo: float, hi: float) -> None:
    if not 0.0 <= lo <= hi:
        raise ValueError(f"{name} range must satisfy 0 <= lo <= hi, "
                         f"got ({lo}, {hi})")


@dataclass(frozen=True)
class UniformLatency:
    """compute ~ U(compute) + upload ~ U(upload), identical for every vid.

    ``compute=(c, c), upload=(u, u)`` is the zero-spread degenerate clock:
    every dispatch takes exactly ``c + u`` simulated seconds, so all B ==
    n_clients uploads arrive simultaneously and the async engine reduces
    to the sync barrier (the identity gate's setting)."""
    seed: int = 0
    compute: tuple[float, float] = (0.5, 1.5)
    upload: tuple[float, float] = (0.05, 0.15)

    def __post_init__(self):
        _check_range("compute", *self.compute)
        _check_range("upload", *self.upload)

    def __call__(self, vids, seqs) -> np.ndarray:
        out = np.empty(np.asarray(vids).size, np.float64)
        for i, rng in enumerate(_element_rngs(self.seed, vids, seqs)):
            out[i] = (rng.uniform(*self.compute) + rng.uniform(*self.upload))
        return out


@dataclass(frozen=True)
class LognormalLatency:
    """Heavy-tailed compute: ``median * lognormal(0, sigma)`` + U(upload).

    The classic straggler distribution — most devices cluster near the
    median, a long tail takes many multiples of it."""
    seed: int = 0
    median: float = 1.0
    sigma: float = 0.75
    upload: tuple[float, float] = (0.05, 0.15)

    def __post_init__(self):
        if self.median <= 0:
            raise ValueError(f"median must be positive, got {self.median}")
        if self.sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")
        _check_range("upload", *self.upload)

    def __call__(self, vids, seqs) -> np.ndarray:
        out = np.empty(np.asarray(vids).size, np.float64)
        for i, rng in enumerate(_element_rngs(self.seed, vids, seqs)):
            out[i] = (self.median * rng.lognormal(0.0, self.sigma)
                      + rng.uniform(*self.upload))
        return out


@dataclass(frozen=True)
class HeteroLatency:
    """Fleet-correlated latency: slow where the cohort model is flaky.

    Per-vid mean ``mean_v = base * (1 + slow_factor * (1 - rate_v))`` with
    ``rate_v`` the Beta availability rate of ``cohort``
    (:meth:`HeterogeneousCohort.rates`), jittered per draw by
    ``U(1 - jitter, 1 + jitter)``. A device with rate 1.0 runs at ``base``;
    a rate-0 device at ``base * (1 + slow_factor)``. Coupling compute
    speed to the availability model is the point: the devices most likely
    to miss rounds are also the ones whose uploads arrive late and stale,
    which is exactly the regime staleness-weighted buffered aggregation
    (and its dispatch-time privacy charging) is designed for."""
    seed: int = 0
    fleet: int = 0                  # number of client vids (rates vector size)
    cohort: object = None           # HeterogeneousCohort; None -> default
    base: float = 1.0
    slow_factor: float = 4.0
    jitter: float = 0.25
    upload: tuple[float, float] = (0.05, 0.15)
    _cohort: object = field(init=False, repr=False, compare=False,
                            default=None)

    def __post_init__(self):
        if self.fleet <= 0:
            raise ValueError(f"fleet size must be positive, got {self.fleet}")
        if self.base <= 0 or self.slow_factor < 0:
            raise ValueError("base must be > 0 and slow_factor >= 0, got "
                             f"base={self.base} slow_factor={self.slow_factor}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        _check_range("upload", *self.upload)
        cohort = self.cohort
        if cohort is None:
            from repro_torch.population.samplers import HeterogeneousCohort
            cohort = HeterogeneousCohort(seed=self.seed)
        object.__setattr__(self, "_cohort", cohort)

    def rates(self) -> np.ndarray:
        """The fleet's (fleet,) availability rates (shared with sampling)."""
        return self._cohort.rates(self.fleet)

    def mean_latency(self, vids) -> np.ndarray:
        """Expected compute seconds per vid (before jitter/upload) — the
        monotone-in-unreliability quantity the composition test pins."""
        rate = self.rates()[np.asarray(vids)]
        return self.base * (1.0 + self.slow_factor * (1.0 - rate.astype(
            np.float64)))

    def __call__(self, vids, seqs) -> np.ndarray:
        means = self.mean_latency(vids)
        out = np.empty(means.size, np.float64)
        for i, rng in enumerate(_element_rngs(self.seed, vids, seqs)):
            out[i] = (means[i] * rng.uniform(1.0 - self.jitter,
                                             1.0 + self.jitter)
                      + rng.uniform(*self.upload))
        return out


LATENCY_PROFILES = ("uniform", "lognormal", "hetero")


def latency_profile(name: str, seed: int = 0, fleet: int = 0,
                    scale: float = 1.0) -> LatencyModel:
    """CLI factory for ``launch/train --latency-profile``. ``scale`` sets
    the nominal per-dispatch seconds; ``fleet`` (the client count) is only
    needed by the hetero profile's rates vector."""
    if name == "uniform":
        return UniformLatency(seed, compute=(0.5 * scale, 1.5 * scale),
                              upload=(0.05 * scale, 0.15 * scale))
    if name == "lognormal":
        return LognormalLatency(seed, median=scale,
                                upload=(0.05 * scale, 0.15 * scale))
    if name == "hetero":
        return HeteroLatency(seed, fleet=fleet, base=scale,
                             upload=(0.05 * scale, 0.15 * scale))
    raise ValueError(f"latency profile must be one of {LATENCY_PROFILES}, "
                     f"got {name!r}")


def sync_round_duration(model: LatencyModel, fleet: int,
                        round_idx: int) -> float:
    """Simulated seconds one SYNC round takes on this fleet: the barrier
    waits for the slowest of all ``fleet`` clients (each drawing with
    ``seq = round_idx``). The sync side of the simulated-time-to-target
    comparison in ``benchmarks/throughput.py``."""
    vids = np.arange(fleet)
    return float(np.max(model(vids, np.full(fleet, int(round_idx)))))
