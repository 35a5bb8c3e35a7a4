"""Pluggable cohort samplers: which K of the M virtual clients run a round
(a numpy-only copy of ``repro.population.samplers``; the stream tags and
the draws are the same, so both packages realize the same cohorts).

A cohort sampler is a callable

    sampler(round_idx, population_size, cohort_size) -> sorted unique vids (K,)

Sampling is *stateless per round*: the draw is derived deterministically
from ``(seed, round_idx)``, so checkpoint/resume needs no sampler state
(the round counter on the FLState suffices), the fused multi-round driver
can pre-compute chunk cohorts, and two drivers replay the identical cohort
schedule. Returned vids are SORTED — a cohort is a set, and the canonical
order makes ``cohort == population`` literally ``arange(M)``, which is what
pins the bit-identity of the M == C gate against the dense engines.

Two samplers ship:

* :class:`UniformCohort` — uniform K-of-M without replacement, the
  cross-device FL baseline (and the model under which the K/M subsampling
  amplification of ``repro_torch.core.privacy`` is stated).
* :class:`HeterogeneousCohort` — a per-client availability / dropout model
  for scenario diversity: client m is reachable in a round with probability
  ``rate_m ~ Beta(a, b)`` (charging state, duty cycling), and a selected
  client drops out mid-round with probability ``dropout`` (lost uplink);
  dropped slots are backfilled so the realized cohort keeps its fixed size
  K (static jit shapes). The availability rates are the only O(M) state —
  one float32 vector, materialized lazily on first use.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol

import numpy as np


# integer stream tags (numpy SeedSequence entropy must be ints on older
# numpys): disjoint sub-streams of one sampler seed
_COHORT_TAG = 0xC0407
_RATES_TAG = 0x7A7E5


class CohortSampler(Protocol):
    def __call__(self, round_idx: int, population_size: int,
                 cohort_size: int) -> np.ndarray: ...


def _check_cohort_args(population_size: int, cohort_size: int) -> None:
    if not 1 <= cohort_size <= population_size:
        raise ValueError(f"cohort_size must be in [1, {population_size}], "
                         f"got {cohort_size}")


def _uniform_without_replacement(rng: np.random.Generator, m: int,
                                 k: int) -> np.ndarray:
    """K of M without replacement. For small cohorts of huge populations
    (the IoT regime) rejection sampling is O(K) instead of the O(M)
    permutation ``Generator.choice`` pays."""
    if k * 16 >= m:
        return rng.choice(m, size=k, replace=False)
    picked = np.unique(rng.integers(0, m, size=2 * k))
    while picked.size < k:
        picked = np.unique(np.concatenate(
            [picked, rng.integers(0, m, size=2 * k)]))
    return rng.permutation(picked)[:k]


def chunk_cohorts(sampler: "CohortSampler", start: int, n_rounds: int,
                  population_size: int, cohort_size: int) -> np.ndarray:
    """The stacked (R, K) per-round cohorts of rounds [start, start + R).

    Row r is ``sampler(start + r, ...)`` — the SAME stateless per-round
    draw the per-round driver makes, which is what pins chunked ==
    per-round cohort schedules for the resident-cohort path: both drivers
    call through here (directly or one round at a time), so fusing R
    rounds into one scan never changes which clients train when."""
    if n_rounds <= 0:
        raise ValueError(f"n_rounds must be positive, got {n_rounds}")
    return np.stack([sampler(start + r, population_size, cohort_size)
                     for r in range(n_rounds)])


@dataclass(frozen=True)
class UniformCohort:
    """Uniform K-of-M cohorts, the cross-device FL default."""
    seed: int = 0
    # the subsampling-amplification accounting of
    # FederationSpec(amplify_participation=True) is stated for uniform
    # K-of-M draws; samplers that can honestly make this claim set it
    # (the population drivers refuse amplified accounting otherwise)
    uniform_over_population = True

    def __call__(self, round_idx: int, population_size: int,
                 cohort_size: int) -> np.ndarray:
        _check_cohort_args(population_size, cohort_size)
        rng = np.random.default_rng((self.seed, _COHORT_TAG, int(round_idx)))
        vids = _uniform_without_replacement(rng, population_size, cohort_size)
        return np.sort(vids.astype(np.int64))


@dataclass(frozen=True)
class HeterogeneousCohort:
    """Availability/dropout cohorts: a heterogeneity model over the fleet.

    ``availability=(a, b)`` draws one Beta(a, b) reachability rate per
    virtual client (default mean 0.8 — most devices usually reachable, a
    long tail rarely so); per round, each client is available i.i.d. at its
    rate and the cohort is drawn uniformly from the available set. A drawn
    client then *drops out* mid-round with probability proportional to its
    unreliability — ``dropout * (1 - rate_m) / mean(1 - rate)`` over the
    round's available set, so the fleet-average drop rate is ~``dropout``
    but flaky devices bear it — and its slot is backfilled from the
    remaining available clients. Identity-dependent dropout is the point:
    an identity-blind coin flip over a uniformly drawn set would be a
    distributional no-op (the backfill restores uniformity), whereas this
    model skews realized cohorts toward reliable devices beyond what
    availability alone does — stragglers cost selection bias (what the
    privacy caveat below is about), never a jagged block shape. If fewer
    than K clients are available at all, the server is modeled as
    re-polling: the shortfall is filled from the unavailable set (rare
    under the defaults; deliberate at extreme rates).

    Privacy caveat: the amplification accounting of
    ``FederationSpec(amplify_participation=True)`` assumes *uniform* K-of-M
    sampling. Under availability skew a high-rate client realizes more than
    K/M of the rounds and the expectation-level bound does not transport;
    the sound default (conditional per-realized-client ledger, q = 1) stays
    exact because it charges realized participation only. The ClientStore's
    per-vid ledger is what surfaces that skew.
    """
    seed: int = 0
    availability: tuple[float, float] = (8.0, 2.0)   # Beta(a, b); mean 0.8
    dropout: float = 0.05
    _rates: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        a, b = self.availability
        if a <= 0 or b <= 0:
            raise ValueError(f"availability Beta params must be positive, "
                             f"got {self.availability}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")

    def rates(self, population_size: int) -> np.ndarray:
        """The per-client availability rates (M,) — lazily materialized and
        cached per population size (one f32 vector is the model's only O(M)
        state)."""
        got = self._rates.get(population_size)
        if got is None:
            rng = np.random.default_rng((self.seed, _RATES_TAG))
            a, b = self.availability
            got = rng.beta(a, b, size=population_size).astype(np.float32)
            self._rates[population_size] = got
        return got

    def __call__(self, round_idx: int, population_size: int,
                 cohort_size: int) -> np.ndarray:
        _check_cohort_args(population_size, cohort_size)
        rng = np.random.default_rng((self.seed, _COHORT_TAG, int(round_idx)))
        avail = np.flatnonzero(rng.random(population_size)
                               < self.rates(population_size))
        if avail.size < cohort_size:
            rest = np.setdiff1d(np.arange(population_size), avail,
                                assume_unique=True)
            top_up = rng.permutation(rest)[:cohort_size - avail.size]
            return np.sort(np.concatenate([avail, top_up]).astype(np.int64))
        order = rng.permutation(avail)
        unrel = 1.0 - self.rates(population_size)[order]
        p_drop = np.minimum(
            1.0, self.dropout * unrel / max(float(unrel.mean()), 1e-9))
        survives = rng.random(order.size) >= p_drop
        # first-K survivors; dropped / late candidates backfill in draw order
        ranked = np.concatenate([order[survives], order[~survives]])
        return np.sort(ranked[:cohort_size].astype(np.int64))
