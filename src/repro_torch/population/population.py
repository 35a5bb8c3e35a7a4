"""Virtual client populations: M clients behind a lazy per-client sampler
(a numpy-only copy of ``repro.population.population``: the same shards
from the same seeds).

Cross-device FL at IoT scale (Khan et al. 2021; Imteaj et al. 2020) runs a
small per-round *cohort* K drawn from a huge *population* M >> K. The dense
``FederatedData.clients`` list — every client's shard resident in host
memory, every client's replica resident on device — is the wrong shape for
that regime. A :class:`ClientPopulation` instead names M *virtual* clients
and materializes a client's data only when that client is sampled into a
cohort: the backing ``sampler(vid, tau, rng)`` synthesizes (or loads) the
shard on demand, so host memory holds O(#distinct-client-parameters) and
device memory holds the K-block only.

Three constructors ship:

* :func:`population_from_federated` — wrap a resident
  :class:`repro_torch.data.FederatedData` (M == its client count). This is
  the identity bridge: with cohort == population the cohort execution path is
  bit-for-bit the dense engines.
* :func:`synthetic_population` — M virtual clients with Dirichlet
  label-skew (per-client class distribution ~ Dirichlet(alpha)) and a
  per-client feature shift, synthesized in the style of
  :mod:`repro_torch.data.synthetic` (unit-ball features). Each client's
  distribution parameters are re-derived from ``(seed, vid)`` at sample
  time — nothing per-client is ever held resident, so M = 10^6 costs the
  same host memory as M = 10.
* :func:`population_from_sampler` — adapt any existing
  ``sampler(client, tau, rng)`` (e.g. a ``FederatedTokenStream``) whose
  client axis is already lazy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

Sampler = Callable[[int, int, np.random.Generator], Any]


@dataclass(frozen=True)
class ClientPopulation:
    """M virtual clients behind a lazy per-client batch sampler.

    ``sampler(vid, tau, rng)`` returns one client's round shard with leading
    axes (tau, B, ...) — the same contract as the resident samplers of
    ``repro_torch.api.round_batch``, with ``vid`` ranging over the whole
    population [0, n_clients). It must be cheap to call for any vid without
    touching the other M-1 clients.

    ``stationary=True`` declares the sampler IGNORES its ``rng`` — every
    call for a vid returns the same fixed shard (the on-device-dataset IoT
    regime). That is the contract that lets the resident-cohort driver
    (:mod:`repro_torch.population.resident`) keep warm clients' data rows on
    device across rounds exactly: a cached shard equals what streaming
    would have rebuilt, bit for bit, and no shared-rng stream is consumed.
    Fresh-per-round sampling populations must leave it False — their data
    stream depends on call order and cannot be cached without changing it.
    """
    n_clients: int                  # M (population size)
    sampler: Sampler
    name: str = ""
    stationary: bool = False

    def __post_init__(self):
        if self.n_clients <= 0:
            raise ValueError(f"population must be positive, "
                             f"got {self.n_clients}")


def population_from_federated(fed, batch_size: int) -> ClientPopulation:
    """A :class:`repro_torch.data.FederatedData` viewed as a (resident)
    population.

    M equals the federation's client count; the sampler is
    ``fed.make_sampler(batch_size)`` verbatim, so a cohort == population
    configuration consumes the data RNG stream identically to the dense
    drivers (the bit-identity gate of tests/test_torch_population.py).
    """
    return ClientPopulation(n_clients=fed.n_clients,
                            sampler=fed.make_sampler(batch_size),
                            name=fed.name or "federated")


def population_from_sampler(n_clients: int, sampler: Sampler,
                            name: str = "",
                            stationary: bool = False) -> ClientPopulation:
    """Adapt an existing lazy ``sampler(client, tau, rng)`` (token streams,
    custom loaders) whose client axis already scales to ``n_clients``.
    Pass ``stationary=True`` only if the sampler ignores ``rng`` (see
    :class:`ClientPopulation`)."""
    return ClientPopulation(n_clients=n_clients, sampler=sampler, name=name,
                            stationary=stationary)


def synthetic_population(n_clients: int, dim: int = 20, batch_size: int = 8,
                         n_classes: int = 2, alpha: float = 0.5,
                         client_shift: float = 1.0, noise: float = 0.8,
                         label_strength: float = 0.9,
                         seed: int = 0,
                         stationary: bool = False) -> ClientPopulation:
    """M virtual clients with Dirichlet(alpha) label skew, fully lazy.

    Population-level structure (class directions, the label signal) is drawn
    once from ``seed``; everything client-specific — the class mixture
    ``p_vid ~ Dirichlet(alpha)`` and a feature-space shift (the client's
    "sensor placement", as in ``vehicle_like``) — is re-derived from
    ``(seed, vid)`` inside the sampler, so per-client state is materialized
    on demand and discarded. Small ``alpha`` -> strongly non-iid clients
    (most clients see a single dominant class), large ``alpha`` -> iid.

    Labels are ints in [0, n_classes); with the default ``n_classes=2`` the
    batches plug straight into ``repro_torch.models.linear.logreg_loss``.
    Features are normalized to the unit ball (paper §4 assumption), matching
    :mod:`repro_torch.data.synthetic`.

    ``stationary=True`` draws each client's shard from its own ``(seed,
    vid)`` generator instead of the shared round rng — the client re-reads
    one fixed local dataset every round (and the shared stream is never
    consumed), which is the contract the resident-cohort driver needs to
    cache warm data rows on device (see :class:`ClientPopulation`).
    """
    if n_classes < 2:
        raise ValueError(f"n_classes must be >= 2, got {n_classes}")
    if alpha <= 0:
        raise ValueError(f"Dirichlet alpha must be positive, got {alpha}")
    root = np.random.default_rng(seed)
    class_dirs = root.normal(size=(n_classes, dim)) / np.sqrt(dim)

    def sampler(vid: int, tau: int, rng: np.random.Generator):
        # lazy shard: the client's distribution parameters exist only for
        # the duration of this call
        vrng = np.random.default_rng((seed, int(vid)))
        p = vrng.dirichlet([alpha] * n_classes)
        shift = vrng.normal(size=dim) / np.sqrt(dim) * client_shift
        draw = vrng if stationary else rng
        y = draw.choice(n_classes, size=(tau, batch_size), p=p)
        x = draw.normal(scale=noise, size=(tau, batch_size, dim))
        x += shift
        x += class_dirs[y] * label_strength
        norms = np.linalg.norm(x, axis=-1, keepdims=True)
        x = (x / np.maximum(norms, 1.0)).astype(np.float32)
        return {"x": x, "y": y.astype(np.int32)}

    tag = "-fixed" if stationary else ""
    return ClientPopulation(n_clients=n_clients, sampler=sampler,
                            name=f"dirichlet{alpha}-M{n_clients}{tag}",
                            stationary=stationary)
