"""Serving requests and deterministic open-loop workloads (numpy only, a
copy of the JAX package's ``serve/requests.py``: the same workloads).

A :class:`Request` is one decode job: a prompt, an arrival time in
simulated seconds, and a generation budget. :func:`poisson_workload`
builds an open-loop Poisson arrival stream with mixed prompt/generation
lengths under the same determinism contract as
:mod:`repro_torch.asyncfl.clock`: every per-request draw comes from a fresh
``np.random.default_rng((seed, _SERVE_TAG, rid))`` — no sampler state,
so a workload is a pure function of ``(seed, rid)`` and any slice of it
can be regenerated independently of execution order.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# integer stream tag (SeedSequence entropy): disjoint from the latency /
# cohort tags of repro_torch.asyncfl.clock and repro_torch.population.samplers
_SERVE_TAG = 0x5E12F3


@dataclass
class Request:
    """One serving job: ``tokens`` (S,) int32 prompt, ``arrival`` in
    simulated seconds, ``max_gen`` tokens to decode. ``out`` /
    ``emit_times`` are filled by the scheduler as tokens stream out."""
    rid: int
    arrival: float
    tokens: np.ndarray
    max_gen: int
    out: list = field(default_factory=list)
    emit_times: list = field(default_factory=list)
    finished: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])

    def token_latencies(self) -> np.ndarray:
        """Per-token latency (s): first token measured from arrival
        (TTFT, includes queueing), the rest from the previous emission
        (inter-token time)."""
        times = np.asarray(self.emit_times, np.float64)
        prev = np.concatenate([[self.arrival], times[:-1]])
        return times - prev


def poisson_workload(n_requests: int, rate: float, vocab: int, *,
                     seed: int = 0,
                     prompt_lens=(8, 16, 32),
                     gen_lens=(8, 16)) -> list[Request]:
    """Open-loop Poisson arrivals: inter-arrival gaps ~ Exp(1/rate),
    prompt length and generation budget drawn uniformly from the choice
    sets, prompt tokens uniform over the vocab. ``rate`` is requests per
    simulated second. Deterministic per ``(seed, rid)``."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    reqs = []
    t = 0.0
    for rid in range(n_requests):
        rng = np.random.default_rng((int(seed), _SERVE_TAG, rid))
        t += float(rng.exponential(1.0 / rate))
        p_len = int(rng.choice(np.asarray(prompt_lens)))
        g_len = int(rng.choice(np.asarray(gen_lens)))
        toks = rng.integers(0, vocab, size=(p_len,)).astype(np.int32)
        reqs.append(Request(rid=rid, arrival=t, tokens=toks, max_gen=g_len))
    return reqs
