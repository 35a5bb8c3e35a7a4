"""``repro_torch.population``: virtual client populations with cohort
execution.

A :class:`ClientPopulation` names M clients behind a lazy per-client
sampler, a cohort sampler draws K << M of them per round, and the drivers
gather only the sampled cohort onto the device: device memory is bounded by
K, independent of M. Sticky per-client state (error-feedback residuals, the
per-client privacy ledger) lives in the host-side :class:`ClientStore`.

    from repro_torch.population import (
        init_population_state, synthetic_population, train_population)

    spec = FederationSpec(n_clients=K, tau=8, loss_fn=loss,
                          optimizer=sgd(0.3), population=M, cohort_size=K,
                          sigmas=(sigma,) * K, batch_sizes=(B,) * K)
    pop = synthetic_population(M, dim=20, batch_size=B, alpha=0.3)
    pstate = init_population_state(spec, params0)        # on the GPU
    pstate, out = train_population(spec, pstate, pop, chunk_rounds=8)

``init_population_state(..., device="cpu")`` runs on the CPU. With M == C
and cohort == population this path is bit for bit the dense
``repro_torch.api`` path. ``train_population(..., resident_cache=S)`` keeps
S warm clients' sticky state (and, for stationary populations, their
shards) on the device and draws a fresh cohort every round
(:mod:`repro_torch.population.resident`); the rows move through the
hand-written ``cohort_gather_scatter`` kernel. ``malicious_population``
wraps a population so a deterministic fraction of its vids serve
label-flipped shards (:mod:`repro_torch.population.attacks`).
"""
from repro_torch.population.attacks import (
    POPULATION_ATTACKS,
    is_byzantine_vid,
    malicious_population,
)
from repro_torch.population.population import (
    ClientPopulation,
    population_from_federated,
    population_from_sampler,
    synthetic_population,
)
from repro_torch.population.resident import (
    ResidentCache,
    init_resident_cache,
    run_resident_rounds,
)
from repro_torch.population.runtime import (
    PopulationState,
    cohort_batch,
    cohort_batches,
    device_block_bytes,
    exceeds_population_budgets,
    init_population_state,
    load_population_state,
    peek_population_epsilon,
    rounds_within_population_budgets,
    run_cohort_round,
    run_cohort_rounds,
    save_population_state,
    train_population,
)
from repro_torch.population.samplers import (
    CohortSampler,
    HeterogeneousCohort,
    UniformCohort,
    chunk_cohorts,
)
from repro_torch.population.store import ClientStore

__all__ = [
    "ClientPopulation", "population_from_federated", "population_from_sampler",
    "synthetic_population",
    "PopulationState", "cohort_batch", "cohort_batches", "device_block_bytes",
    "exceeds_population_budgets", "init_population_state",
    "load_population_state", "peek_population_epsilon",
    "rounds_within_population_budgets", "run_cohort_round",
    "run_cohort_rounds", "save_population_state", "train_population",
    "ResidentCache", "init_resident_cache", "run_resident_rounds",
    "CohortSampler", "HeterogeneousCohort", "UniformCohort", "chunk_cohorts",
    "ClientStore",
    "POPULATION_ATTACKS", "is_byzantine_vid", "malicious_population",
]
