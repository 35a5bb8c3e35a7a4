"""Malicious virtual clients: data-level poisoning bound to vids.

The update attacks of :mod:`repro_torch.core.robust` corrupt a static
byzantine set of resident clients. A :class:`ClientPopulation` has no
stable slots (cohort slot k hosts another virtual client every round), so
here the corruption binds to the virtual id and rides the data path:

* ``label_flip``: every label a byzantine vid serves is flipped
  ``c -> n_classes - 1 - c``; features pass through bit-unchanged.

Membership is an independent Bernoulli(byzantine_fraction) coin per vid
from ``default_rng((seed, TAG, vid))``, the JAX package's draw, so it is
stable across rounds, cohorts and restarts with no M-length table.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.robust import _BYZ_TAG, flip_labels, validate_attack
from repro_torch.population.population import ClientPopulation

POPULATION_ATTACKS = ("label_flip",)


def is_byzantine_vid(vid: int, byzantine_fraction: float,
                     seed: int = 0) -> bool:
    """Is virtual client ``vid`` byzantine? O(1), deterministic per
    (vid, fraction, seed)."""
    validate_attack("none", byzantine_fraction)
    rng = np.random.default_rng((seed, _BYZ_TAG, int(vid)))
    return bool(rng.random() < byzantine_fraction)


def malicious_population(base: ClientPopulation, attack: str = "label_flip",
                         byzantine_fraction: float = 0.25,
                         n_classes: int = 2,
                         seed: int = 0) -> ClientPopulation:
    """``base`` with its byzantine vids serving poisoned shards: a lazy
    :class:`ClientPopulation` of the same M and sampler contract, so it
    drops into ``train_population`` / ``run_cohort_round`` unchanged. At
    ``byzantine_fraction=0`` every shard passes through bit-unchanged."""
    if attack not in POPULATION_ATTACKS:
        raise ValueError(f"population attack must be one of "
                         f"{POPULATION_ATTACKS} (update-level attacks are "
                         f"resident-mode features, see "
                         f"FederationSpec.attack), got {attack!r}")
    validate_attack("none", byzantine_fraction)
    if n_classes < 2:
        raise ValueError(f"n_classes must be >= 2, got {n_classes}")

    def sampler(vid: int, tau: int, rng: np.random.Generator):
        shard = base.sampler(vid, tau, rng)
        if not is_byzantine_vid(vid, byzantine_fraction, seed):
            return shard
        poisoned = dict(shard)
        poisoned["y"] = flip_labels(shard["y"], n_classes)
        return poisoned

    return ClientPopulation(
        n_clients=base.n_clients, sampler=sampler,
        name=f"{base.name or 'population'}+{attack}{byzantine_fraction}")
