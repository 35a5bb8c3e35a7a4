"""Cohort execution: drive the DP-PASGD engines over a virtual population.

The device never sees the population. Each round the driver

1. draws a **cohort** of K = ``spec.n_clients`` virtual ids from the M =
   ``spec.population`` clients (:mod:`repro_torch.population.samplers`,
   deterministic per round index),
2. **gathers** the cohort onto the device block: the K per-client data
   shards are materialized lazily from the :class:`ClientPopulation`, and
   the cohort's sticky state (error-feedback residual rows, per-vid rho)
   comes out of the :class:`ClientStore`,
3. runs the *existing* round, :func:`repro_torch.api.run_round` /
   ``run_rounds`` over the K-block, unchanged (``spec.population`` is not
   part of ``engine_key()``, so device memory is bounded by K, independent
   of M; under a sharded engine on several ranks each rank holds its
   block of the K rows, :func:`init_population_state`),
4. **scatters** the cohort's updated residual rows and rho charges back
   into the store.

Identity gate: with M == C and cohort == population the gather/scatter are
the identity (the uniform sampler returns sorted vids, so the full cohort
is ``arange(M)``), the data RNG stream is consumed in the same order, and
the same round function runs, so the cohort path is bit for bit the dense
path (tests/test_torch_population.py).

:func:`run_cohort_rounds` chunks R rounds through ``run_rounds`` with ONE
cohort per chunk (cohorts resample at chunk boundaries). Passing
``resident=`` a :class:`repro_torch.population.resident.ResidentCache`
draws a fresh cohort every round instead, with the warm clients' sticky
state on the device (:mod:`repro_torch.population.resident`), which
realizes the per-round driver's schedule exactly.

The host math (rho ledger, budget probes, the population epsilon) is the
JAX package's float64 numpy, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.spec import FederationSpec
from repro_torch.api.state import (
    FLState,
    PrefetchFailed,
    _device_of,
    _raise_budget,
    budget_train_loop,
    eval_params,
    init_state,
    load_state,
    round_rho_charges,
    run_round,
    run_rounds,
    save_state,
)
from repro_torch.checkpoint.checkpoint import one_writer
from repro_torch.core.aggregation import tree_dim
from repro_torch.core.privacy import rho_budget, zcdp_to_dp
from repro_torch.population.population import ClientPopulation
from repro_torch.population.samplers import CohortSampler, UniformCohort
from repro_torch.population.store import STORE_FILENAME, ClientStore
from repro_torch.utils.convert import tree_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class PopulationState:
    """Training state of a cohort-executed federation: the device-resident
    K-block :class:`FLState` plus the host-resident per-virtual-client
    :class:`ClientStore`. ``fl.rho`` holds the *current cohort's* ledger
    view (gathered/scattered each round); the store is authoritative."""
    fl: FLState
    store: ClientStore

    def replace(self, **changes) -> "PopulationState":
        return dataclasses.replace(self, **changes)


def init_population_state(spec: FederationSpec, params0: Any,
                          device=None) -> PopulationState:
    """Fresh population state: a K-block FLState on ``device`` (default
    ``"cuda"``; raises when no GPU is present), slab state where
    :func:`repro_torch.api.slab_applies`, and an empty ClientStore (whole,
    and alike on every rank)."""
    if not spec.is_population():
        raise ValueError("init_population_state needs a population spec "
                         "(FederationSpec(population=M, cohort_size=K))")
    fl = init_state(spec, params0, device)
    pipe = spec.aggregation_pipeline()
    dim = (tree_dim(params0)
           if pipe is not None and pipe.needs_residual() else None)
    return PopulationState(fl=fl,
                           store=ClientStore(spec.population,
                                             residual_dim=dim))


# ---------------------------------------------------------------------------
# cohort data plumbing
# ---------------------------------------------------------------------------

def cohort_batch(spec: FederationSpec, population: ClientPopulation,
                 cohort: np.ndarray, rng) -> Any:
    """Stack the cohort's lazily-materialized shards into the (K, tau, B,
    ...) numpy round batch: ``repro_torch.api.round_batch`` with vids
    instead of a dense client range (the same stream order when cohort ==
    arange)."""
    per_client = [population.sampler(int(v), spec.tau, rng) for v in cohort]
    return tree_map(lambda *xs: np.stack(xs), *per_client)


def cohort_batches(spec: FederationSpec, population: ClientPopulation,
                   cohort: np.ndarray, rng, n_rounds: int) -> Any:
    """``n_rounds`` stacked cohort batches, leaves (R, K, tau, B, ...): the
    chunk operand of :func:`run_cohort_rounds` (one fixed cohort per
    chunk), drawn from ``rng`` in per-round order."""
    rounds = [cohort_batch(spec, population, cohort, rng)
              for _ in range(n_rounds)]
    return tree_map(lambda *xs: np.stack(xs), *rounds)


def _resolve_cohort_sampler(spec: FederationSpec,
                            cohort_sampler: CohortSampler | None,
                            ) -> CohortSampler:
    """Default the sampler, and refuse ``amplify_participation=True`` under
    a sampler that does not declare ``uniform_over_population``: the K/M
    amplification bound holds for uniform K-of-M cohorts only, and a skewed
    sampler would make the reported epsilon understate a frequent client's
    loss (the conditional default ledger stays exact under any sampler)."""
    sampler = cohort_sampler or UniformCohort(spec.seed)
    if spec.amplify_participation and not getattr(
            sampler, "uniform_over_population", False):
        raise ValueError(
            "amplify_participation=True needs a uniform K-of-M cohort "
            f"sampler; {type(sampler).__name__} does not declare "
            "uniform_over_population, so the K/M amplification bound does "
            "not hold for its skewed cohorts — drop "
            "amplify_participation (the conditional per-realized-client "
            "ledger stays exact) or use UniformCohort")
    return sampler


def _check_cohort(spec: FederationSpec, population: ClientPopulation,
                  cohort: np.ndarray) -> np.ndarray:
    if not spec.is_population():
        raise ValueError("cohort drivers need a population spec "
                         "(FederationSpec(population=M, cohort_size=K)); "
                         "use repro_torch.api.run_round for dense "
                         "federations")
    cohort = np.asarray(cohort)
    if cohort.shape != (spec.n_clients,):
        raise ValueError(f"cohort has shape {cohort.shape}, expected "
                         f"({spec.n_clients},) (= spec cohort_size)")
    if population.n_clients != spec.population:
        raise ValueError(f"population object has {population.n_clients} "
                         f"clients, spec.population={spec.population}")
    if np.unique(cohort).size != cohort.size:
        raise ValueError("cohort vids must be unique")
    if cohort.min() < 0 or cohort.max() >= spec.population:
        raise ValueError(f"cohort vids out of range [0, {spec.population})")
    return cohort


def _gathered_fl(spec: FederationSpec, pstate: PopulationState,
                 cohort: np.ndarray) -> FLState:
    """The K-block FLState with the cohort's sticky state gathered in (a
    slab state's: its block's residual rows)."""
    fl = pstate.fl
    changes: dict = {"rho": pstate.store.gather_rho(cohort)}
    if pstate.store.needs_residual():
        rows = pstate.store.gather_residual(cohort)
        if fl.layout is not None:
            rows = fl.layout.take_state(rows)
        changes["residual"] = torch.as_tensor(rows, device=_device_of(fl))
    return fl.replace(**changes)


def device_block_bytes(pstate: PopulationState, batch: Any = None) -> int:
    """Bytes of the device-resident cohort block (params, opt_state,
    residual, plus an optional batch operand): independent of M."""
    trees = [pstate.fl.params, pstate.fl.opt_state]
    if pstate.fl.residual is not None:
        trees.append(pstate.fl.residual)
    if batch is not None:
        trees.append(batch)

    def nbytes(x) -> int:
        if isinstance(x, torch.Tensor):
            return x.element_size() * x.numel()
        return np.asarray(x).nbytes

    return int(sum(nbytes(x) for t in trees for x in tree_leaves(t)))


# ---------------------------------------------------------------------------
# budget probes (population-wide: worst rho over the store, not the cohort)
# ---------------------------------------------------------------------------

def _max_round_charge(spec: FederationSpec) -> float:
    """Worst-case per-round rho increment of any virtual client."""
    return float(np.max(round_rho_charges(spec)))


def peek_population_epsilon(spec: FederationSpec, pstate: PopulationState,
                            extra_rounds: int = 0) -> float:
    """Worst-client eps over the POPULATION if the worst client were
    sampled into the next ``extra_rounds`` cohorts (the population analog
    of ``repro_torch.api.peek_epsilon_fast``)."""
    worst = pstate.store.max_rho() + extra_rounds * _max_round_charge(spec)
    return zcdp_to_dp(worst, spec.delta)


def exceeds_population_budgets(spec: FederationSpec,
                               pstate: PopulationState) -> str | None:
    """Would one more cohort round break a budget? "resource" / "privacy"
    / None, mirroring ``repro_torch.api.exceeds_budgets``."""
    if pstate.fl.resource_spent + spec.round_cost() > spec.c_th:
        return "resource"
    if peek_population_epsilon(spec, pstate, 1) > spec.eps_th:
        return "privacy"
    return None


def rounds_within_population_budgets(spec: FederationSpec,
                                     pstate: PopulationState,
                                     limit: int) -> tuple[int, str | None]:
    """How many future cohort rounds CERTAINLY fit the budgets (capped at
    ``limit``), plus the next-binding budget. Worst-case projection: the
    same (worst) client is assumed sampled and charged every round, so a
    chunk sized by this bound never holds a round the per-round driver
    would refuse."""
    charge = _max_round_charge(spec)
    cost = spec.round_cost()
    worst = pstate.store.max_rho()
    spent = pstate.fl.resource_spent
    n = 0
    while n < limit:
        if spent + cost > spec.c_th:
            return n, "resource"
        if zcdp_to_dp(worst + charge, spec.delta) > spec.eps_th:
            return n, "privacy"
        worst += charge
        spent += cost
        n += 1
    return n, None


# ---------------------------------------------------------------------------
# round drivers
# ---------------------------------------------------------------------------

def _population_epsilon_fix(rec: dict, outside_max: float,
                            delta: float) -> None:
    """Lift a cohort-local ``max_epsilon`` record to the population max.

    The round computed eps over the cohort's rho only; clients outside the
    cohort are static during the round(s), so the population worst is
    max(outside_max, cohort_worst). ``rho_budget`` is the exact inverse of
    ``zcdp_to_dp`` and recovers the cohort-worst rho from the record. With
    cohort == population (outside_max == -inf) the record is already the
    population worst and stays untouched (the inversion costs a ULP)."""
    if math.isinf(outside_max) and outside_max < 0:
        return
    eps = rec["max_epsilon"]
    cohort_rho = math.inf if math.isinf(eps) else rho_budget(eps, delta)
    rec["max_epsilon"] = zcdp_to_dp(max(cohort_rho, outside_max), delta)


def _outside_max_rho(store: ClientStore, cohort: np.ndarray) -> float:
    """An exact stand-in for the worst rho among clients NOT in the cohort
    (-inf when cohort == population), read before the round's charges
    land: the pre-round global max. Exact where it is used, since rho only
    grows and ``_population_epsilon_fix`` takes the max with the cohort's
    post-round worst."""
    if len(cohort) == store.population:
        return -math.inf
    return store.max_rho()


def _scatter_back(pstate: PopulationState, cohort: np.ndarray,
                  fl: FLState, n_rounds: int) -> PopulationState:
    """Write the round's cohort state back into the store. The residual
    fetch is the cohort path's one forced device sync (per round for the
    per-round driver, per chunk for the chunk-boundary one); a slab
    state's block rows are gathered over the client group first, once, so
    every rank's store stays the same (the JAX package's store is one host
    array)."""
    pstate.store.scatter_rho(cohort, fl.rho)
    if pstate.store.needs_residual():
        rows = fl.residual
        if fl.layout is not None:
            rows = fl.layout.whole_rows(rows)
        pstate.store.scatter_residual(cohort, rows.cpu().numpy())
    pstate.store.note_participation(cohort, n_rounds)
    return pstate.replace(fl=fl)


def run_cohort_round(spec: FederationSpec, pstate: PopulationState,
                     population: ClientPopulation, rng,
                     cohort_sampler: CohortSampler | None = None,
                     check_budgets: bool = True,
                     ) -> tuple[PopulationState, dict]:
    """One cohort round: sample K of M, gather, run the K-block round
    (:func:`repro_torch.api.run_round`), scatter back.

    Returns (successor state, record); the record is the dense round record
    with ``max_epsilon`` lifted to the population worst. Raises
    ``BudgetExceeded`` (state untouched) like the dense driver."""
    if check_budgets:
        which = exceeds_population_budgets(spec, pstate)
        if which is not None:
            _raise_budget(which, spec)
    sampler = _resolve_cohort_sampler(spec, cohort_sampler)
    cohort = _check_cohort(spec, population, sampler(
        pstate.fl.rounds_done, spec.population, spec.n_clients))
    return _cohort_round_with_batch(
        spec, pstate, population, cohort,
        cohort_batch(spec, population, cohort, rng))


def run_cohort_rounds(spec: FederationSpec, pstate: PopulationState,
                      population: ClientPopulation, rng,
                      n_rounds: int | None = None,
                      cohort_sampler: CohortSampler | None = None,
                      check_budgets: bool = True,
                      cohort: np.ndarray | None = None,
                      batches: Any = None,
                      prefetch: Callable[[], None] | None = None,
                      resident: Any = None,
                      cohorts: np.ndarray | None = None,
                      ) -> tuple[PopulationState, list[dict]]:
    """A chunk of R rounds over ONE cohort (resampled per chunk).

    The chunk runs through :func:`repro_torch.api.run_rounds` with the
    cohort's sticky state gathered before and scattered after. ``cohort``
    and ``batches`` may be passed pre-built (the prefetch of
    :func:`train_population`); otherwise the cohort is drawn for round
    index ``fl.rounds_done`` and the batches built from ``rng``. A raising
    ``prefetch`` propagates as ``PrefetchFailed`` carrying the completed
    PopulationState (store already updated).

    ``resident=`` a :class:`repro_torch.population.resident.ResidentCache`
    switches to resident-cohort execution: a fresh cohort per round, sticky
    state moving through the device-resident cache. ``cohorts`` may pass
    the pre-drawn (R, K) per-round plan; ``cohort`` must then be None."""
    if resident is not None:
        from repro_torch.population.resident import run_resident_rounds
        if cohort is not None:
            raise ValueError("resident execution draws a fresh cohort per "
                             "round; pass the (R, K) plan via cohorts=, "
                             "not a single cohort")
        return run_resident_rounds(spec, pstate, population, rng, resident,
                                   n_rounds, cohort_sampler=cohort_sampler,
                                   check_budgets=check_budgets,
                                   cohorts=cohorts, batches=batches,
                                   prefetch=prefetch)
    if cohorts is not None:
        raise ValueError("a per-round cohort plan needs resident= (the "
                         "chunk-boundary path runs one cohort per chunk)")
    sampler = _resolve_cohort_sampler(spec, cohort_sampler)
    if cohort is None:
        if batches is not None:
            raise ValueError("pre-built batches need their cohort")
        cohort = sampler(pstate.fl.rounds_done, spec.population,
                         spec.n_clients)
    cohort = _check_cohort(spec, population, cohort)
    if batches is None:
        if n_rounds is None or n_rounds <= 0:
            raise ValueError(f"n_rounds must be positive, got {n_rounds}")
        batches = cohort_batches(spec, population, cohort, rng, n_rounds)
    if check_budgets:
        lead = int(tree_leaves(batches)[0].shape[0])
        want = n_rounds if n_rounds is not None else lead
        ok, which = rounds_within_population_budgets(spec, pstate, want)
        if ok < want:
            _raise_budget(which, spec)
    outside_max = _outside_max_rho(pstate.store, cohort)
    try:
        fl, recs = run_rounds(spec, _gathered_fl(spec, pstate, cohort),
                              batches, n_rounds, check_budgets=False,
                              prefetch=prefetch)
    except PrefetchFailed as pf:
        new = _scatter_back(pstate, cohort, pf.state, len(pf.records))
        for rec in pf.records:
            _population_epsilon_fix(rec, outside_max, spec.delta)
        raise PrefetchFailed(pf.__cause__, new, pf.records) from pf.__cause__
    new = _scatter_back(pstate, cohort, fl, len(recs))
    for rec in recs:
        _population_epsilon_fix(rec, outside_max, spec.delta)
    return new, recs


def _cohort_round_with_batch(spec, pstate, population, cohort, batch):
    """One per-round-path round over an explicit cohort and its (K, tau, B,
    ...) batch."""
    cohort = _check_cohort(spec, population, cohort)
    outside_max = _outside_max_rho(pstate.store, cohort)
    fl, rec = run_round(spec, _gathered_fl(spec, pstate, cohort), batch,
                        check_budgets=False)
    new = _scatter_back(pstate, cohort, fl, 1)
    _population_epsilon_fix(rec, outside_max, spec.delta)
    return new, rec


# ---------------------------------------------------------------------------
# budget-aware training driver
# ---------------------------------------------------------------------------

def train_population(spec: FederationSpec, pstate: PopulationState,
                     population: ClientPopulation,
                     cohort_sampler: CohortSampler | None = None,
                     max_rounds: int = 10_000,
                     eval_fn: Callable | None = None, eval_every: int = 1,
                     rng=None, history: list[dict] | None = None,
                     chunk_rounds: int = 1,
                     resident_cache: int = 0,
                     ) -> tuple[PopulationState, dict]:
    """Cohort-executed :func:`repro_torch.api.train`: rounds until a budget
    binds, on the dense driver's loop
    (:func:`repro_torch.api.state.budget_train_loop`) with the population
    probes and cohort chunks. Returns (state, summary) shaped like
    ``train``'s.

    ``chunk_rounds=R > 1`` runs R rounds per :func:`run_cohort_rounds` call
    over one cohort (cohorts resample at chunk boundaries), the next
    chunk's cohort and batches built while the current chunk runs.

    ``resident_cache=S > 0`` switches the chunks to resident-cohort
    execution (:mod:`repro_torch.population.resident`): S warm clients'
    sticky state stays on the device, every round draws a fresh cohort
    (the per-round driver's schedule), and the store is touched only at
    chunk boundaries. Stationary populations also keep the warm shards on
    the device. Needs chunk_rounds > 1 and S >= min(chunk_rounds * K, M).
    The summary gains ``resident_cache`` (hit / miss / eviction / flush
    counts), and the cache is flushed before returning."""
    if rng is None:
        rng = np.random.default_rng(spec.seed)
    sampler = _resolve_cohort_sampler(spec, cohort_sampler)
    history = [] if history is None else history
    dev = _device_of(pstate.fl)
    # a slab state's chunks hold its block's rows only
    lay = pstate.fl.layout
    take = (lambda b: b) if lay is None else partial(lay.take, axis=1)
    cache = None
    if resident_cache:
        from repro_torch.population.resident import init_resident_cache
        from repro_torch.population.samplers import chunk_cohorts
        if chunk_rounds <= 1:
            raise ValueError(
                "resident_cache needs chunk_rounds > 1: per-round cohorts "
                "inside the chunk are what the cache buys; the per-round "
                "driver already realizes that schedule")
        cache = init_resident_cache(spec, pstate, resident_cache,
                                    population=population)
        need = min(chunk_rounds * spec.n_clients, spec.population)
        if cache.capacity < need:
            raise ValueError(
                f"resident_cache={cache.capacity} can underflow: a chunk "
                f"may touch up to {need} distinct vids (chunk_rounds * K); "
                f"raise it or lower chunk_rounds")

    if cache is None:
        def build_chunk(start: int, n: int):
            cohort = sampler(start, spec.population, spec.n_clients)
            return (cohort, tree_from_numpy(
                take(cohort_batches(spec, population, cohort, rng, n)), dev))

        def run_chunk(ps, chunk, n, prefetch):
            cohort, batches = chunk
            return run_cohort_rounds(spec, ps, population, rng, n,
                                     cohort_sampler=sampler,
                                     check_budgets=False,
                                     cohort=cohort, batches=batches,
                                     prefetch=prefetch)

        def run_tail(ps, chunk, r):
            # tail rows were built for this chunk's (single) cohort
            cohort, batches = chunk
            return _cohort_round_with_batch(
                spec, ps, population, cohort,
                tree_map(lambda x, r=r: x[r], batches))
    else:
        def build_chunk(start: int, n: int):
            cohorts = chunk_cohorts(sampler, start, n, spec.population,
                                    spec.n_clients)
            if cache.data is not None:
                # stationary shards: pre-materialize only the cold vids'
                # rows (warm ones are on the device already); residency
                # does not change before run_chunk promotes this plan's
                # union. The stationary sampler ignores its rng
                throwaway = np.random.default_rng(0)
                rows = {int(v): population.sampler(int(v), spec.tau,
                                                   throwaway)
                        for v in np.unique(cohorts)
                        if int(v) not in cache.slot_of}
                return (cohorts, None, rows)
            per = [cohort_batch(spec, population, cohorts[r], rng)
                   for r in range(n)]
            return (cohorts, tree_from_numpy(
                take(tree_map(lambda *xs: np.stack(xs), *per)), dev), None)

        def run_chunk(ps, chunk, n, prefetch):
            from repro_torch.population.resident import run_resident_rounds
            cohorts, batches, rows = chunk
            return run_resident_rounds(spec, ps, population, rng, cache, n,
                                       cohort_sampler=sampler,
                                       check_budgets=False,
                                       cohorts=cohorts, batches=batches,
                                       data_rows=rows, prefetch=prefetch)

        def run_tail(ps, chunk, r):
            # budget/max_rounds edge: the rows go through the per-round
            # store path. The cache flushes first (the store regains
            # authority) and resets, since its rows would go stale as the
            # store-side rounds land. At most once per training run
            cohorts, batches, rows = chunk
            if cache.warm_count() or cache.pending:
                cache.flush(ps.store)
                cache.reset()
            if batches is None:
                # the stationary sampler ignores its rng: the rebuild is
                # exact and consumes no shared stream
                batch = cohort_batch(spec, population, cohorts[r],
                                     np.random.default_rng(0))
            else:
                batch = tree_map(lambda x, r=r: x[r], batches)
            return _cohort_round_with_batch(spec, ps, population,
                                            cohorts[r], batch)

    pstate, best = budget_train_loop(
        state=pstate, max_rounds=max_rounds, eval_fn=eval_fn,
        eval_every=eval_every, history=history, chunk_rounds=chunk_rounds,
        rounds_done=lambda ps: ps.fl.rounds_done,
        exceeds=lambda ps: exceeds_population_budgets(spec, ps) is not None,
        safe_rounds=lambda ps, cap: rounds_within_population_budgets(
            spec, ps, cap)[0],
        run_single=lambda ps: run_cohort_round(
            spec, ps, population, rng, cohort_sampler=sampler,
            check_budgets=False),
        build_chunk=build_chunk, run_chunk=run_chunk, run_tail=run_tail,
        eval_model=lambda ps: eval_params(spec, ps.fl))
    summary = {
        "best": best, "rounds": pstate.fl.rounds_done,
        "resource_spent": pstate.fl.resource_spent,
        "max_epsilon": zcdp_to_dp(pstate.store.max_rho(), spec.delta),
        "history": history,
    }
    if cache is not None:
        cache.flush(pstate.store)
        summary["resident_cache"] = dict(cache.stats)
    return pstate, summary


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def save_population_state(directory: str, pstate: PopulationState,
                          extra: dict | None = None) -> None:
    """Persist a PopulationState: the FLState checkpoint plus the
    ClientStore (sparse residual rows + per-vid ledger) beside it, in the
    JAX package's layout."""
    save_state(directory, pstate.fl,
               extra={"population": int(pstate.store.population),
                      **(extra or {})})
    with one_writer() as writer:
        if writer:
            pstate.store.save(os.path.join(directory, STORE_FILENAME))


def load_population_state(directory: str, like: PopulationState,
                          ) -> tuple[PopulationState, dict]:
    """Restore a PopulationState saved by :func:`save_population_state`
    onto ``like``'s device. ``like`` (a fresh ``init_population_state``)
    supplies the structure; the store is restored wholesale and checked
    against ``like``'s population geometry."""
    fl, extra = load_state(directory, like.fl)
    store = ClientStore.load(os.path.join(directory, STORE_FILENAME))
    if store.population != like.store.population:
        raise ValueError(f"checkpoint population {store.population} != "
                         f"spec population {like.store.population}")
    if store.residual_dim != like.store.residual_dim:
        raise ValueError(f"checkpoint residual_dim {store.residual_dim} != "
                         f"{like.store.residual_dim} (compressor mismatch?)")
    return PopulationState(fl=fl, store=store), extra
