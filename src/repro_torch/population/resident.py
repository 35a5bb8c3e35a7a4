"""Device-resident cohort execution: a warm-client cache on the device and a
fresh cohort every round inside the chunk.

The chunk-boundary driver of :mod:`repro_torch.population.runtime` fixes
ONE cohort per chunk, because the cohort's sticky state (error-feedback
residual rows, per-vid rho) lives in the host :class:`ClientStore`. This
module keeps a **resident cache** of S >> K warm virtual clients instead:

* **residual**: an (S, D) f32 device block of the warm clients'
  error-feedback rows, written back to the store only on eviction or
  :meth:`ResidentCache.flush`. An eviction gathers the victims' rows into a
  new device tensor (pending until the flush brings it to the host), so it
  never blocks the host.
* **rho**: an (S,) f64 host vector. The zCDP ledger is exact host math, so
  it is write-through: charged during the chunk's ledger replay and written
  to the store at every chunk boundary.
* **data**: optionally the warm clients' (S, tau, B, ...) shards on the
  device, only for populations that declare themselves ``stationary`` (the
  sampler ignores its rng, so a cached shard is what a rebuild would give).

:func:`run_resident_rounds` draws a fresh cohort every round from the same
stateless ``(seed, round_idx)`` draw the per-round driver makes
(:func:`repro_torch.population.samplers.chunk_cohorts`), maps the vids to
cache slots on the host, uploads the (R, K) slot plan once, and the chunk
moves rows between the cache and the round's K-block with the
``cohort_gather_scatter`` kernel. Every slot-indexed row move of the cache
goes through that kernel: the chunk's gathers and scatters, promotion,
eviction, the flush and the FLState's residual view. Under a sharded
engine in slab state a rank gathers only its block's slots and the
FLState's residual is its block's rows; the cache stays whole and alike
on every rank (:func:`repro_torch.core.fl.make_resident_chunked_round`).

The cache is written in place (the JAX form rebuilds it functionally), so
every reference to cache rows that must outlive a later scatter (pending
eviction rows, the FLState's "current cohort" residual view) is a copy
made by a gather, never a view of the cache.

Exactness: the store round trip keeps f32 bits, the kernel is a pure row
copy, the chunk runs the per-round driver's ops in its order, and the host
ledger replay mirrors the per-round driver's float operations expression by
expression (the same repeated adds, the same ``np.max`` / ``zcdp_to_dp`` /
``_population_epsilon_fix`` order, a running mirror of the store's
monotone ``_max_rho``). So the resident path equals the per-round cohort
driver bit for bit (params, opt_state, rho, residual, resource_spent) for
any S and any eviction churn. Under full within-cohort participation the
chunk makes no blocking host sync; :meth:`ResidentCache.flush` is the one
deliberate sync.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.engines import (
    chunked_round_fn_for,
    resident_chunked_round_fn_for,
)
from repro_torch.api.spec import FederationSpec
from repro_torch.api.state import (
    PrefetchFailed,
    _batch_on,
    _device_of,
    _raise_budget,
    _sigmas_on,
    round_rho_charges,
)
from repro_torch.core.privacy import zcdp_to_dp
from repro_torch.kernels.ops import cohort_gather, cohort_scatter
from repro_torch.population.population import ClientPopulation
from repro_torch.population.samplers import CohortSampler, chunk_cohorts
from repro_torch.population.store import ClientStore
from repro_torch.utils.convert import tree_from_numpy, upload
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map


class ResidentCache:
    """The warm-client cache (see the module docstring).

    Host half: ``vids`` (S,) int64 slot -> vid map (-1 empty), ``slot_of``
    its inverse, ``rho`` (S,) f64 write-through ledger rows, ``last_used``
    LRU stamps. Device half: ``residual`` (S, D) f32 write-back rows (None
    for specs without error feedback) and optionally ``data``, the warm
    shards' (S, tau, B, ...) tree (stationary populations only).
    ``pending`` holds evicted residual rows as ``vid -> (rows, j)``, row j
    of an eviction's gathered (n, D) device tensor, until :meth:`flush`.
    """

    def __init__(self, capacity: int, residual_dim: int | None = None,
                 data_template: Any = None, device=None,
                 kernel_backend: str = "auto"):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.residual_dim = residual_dim
        self.device = resolve_device(device)
        self.kernel_backend = kernel_backend
        self.vids = np.full((self.capacity,), -1, np.int64)
        self.slot_of: dict[int, int] = {}
        self.last_used = np.zeros((self.capacity,), np.int64)
        self.rho = np.zeros((self.capacity,), np.float64)
        self.residual = (torch.zeros((self.capacity, residual_dim),
                                     dtype=torch.float32, device=self.device)
                         if residual_dim is not None else None)
        self.data = (tree_map(
            lambda x: torch.zeros(
                (self.capacity,) + tuple(np.shape(x)),
                dtype=torch.as_tensor(np.asarray(x)).dtype,
                device=self.device),
            data_template) if data_template is not None else None)
        self.pending: dict[int, tuple[torch.Tensor, int]] = {}
        self.clock = 0
        self.stats = {"hits": 0, "misses": 0, "evictions": 0, "flushes": 0}

    def warm_count(self) -> int:
        return len(self.slot_of)

    def _stamp(self, vids: np.ndarray) -> None:
        self.clock += 1
        idx = np.asarray([self.slot_of[int(v)] for v in vids], np.int64)
        self.last_used[idx] = self.clock

    def _slots(self, slots) -> torch.Tensor:
        return upload(np.asarray(slots, np.int64), self.device)

    def ensure_resident(self, store: ClientStore, vids: np.ndarray, *,
                        population: ClientPopulation | None = None,
                        tau: int | None = None,
                        data_rows: dict[int, Any] | None = None) -> None:
        """Promote ``vids`` into the cache, evicting LRU slots not in the
        incoming set. No host sync: evicted rows are gathered on the device
        and kept pending, promoted rows are uploaded from pinned memory and
        scattered into their slots. ``data_rows`` may supply the cold vids'
        shards already built (``train_population``'s prefetch); missing
        ones come from the sampler."""
        vids = np.unique(np.asarray(vids, np.int64))
        if vids.size > self.capacity:
            raise ValueError(
                f"chunk needs {vids.size} distinct warm clients but the "
                f"resident cache holds {self.capacity}; raise the cache "
                f"size or lower chunk_rounds (a chunk can touch up to "
                f"chunk_rounds * K distinct vids)")
        need = [int(v) for v in vids if int(v) not in self.slot_of]
        self.stats["hits"] += int(vids.size) - len(need)
        self.stats["misses"] += len(need)
        if need:
            needed = {int(v) for v in vids}
            free = [int(s) for s in np.flatnonzero(self.vids < 0)]
            if len(free) < len(need):
                lru = sorted(
                    (int(self.last_used[s]), int(s))
                    for s in np.flatnonzero(self.vids >= 0)
                    if int(self.vids[s]) not in needed)
                free += [s for _, s in lru[:len(need) - len(free)]]
            victims = [s for s in free if self.vids[s] >= 0]
            if self.residual is not None and victims:
                # write-back without a sync: one gather of the victims' rows
                # into a new tensor, referenced per vid until flush()
                vrows = cohort_gather(self.residual, self._slots(victims),
                                      backend=self.kernel_backend)
                for j, s in enumerate(victims):
                    self.pending[int(self.vids[s])] = (vrows, j)
            for s in victims:
                del self.slot_of[int(self.vids[s])]
                self.vids[s] = -1
            self.stats["evictions"] += len(victims)
            slots_new = free[:len(need)]
            need_arr = np.asarray(need, np.int64)
            slots_arr = np.asarray(slots_new, np.int64)
            self.vids[slots_arr] = need_arr
            for v, s in zip(need, slots_new):
                self.slot_of[v] = s
            # rho is write-through: between chunks the store is
            # authoritative, so promotion is a plain host read
            self.rho[slots_arr] = store.rho[need_arr]
            # cold rows come out of the store in one batched gather; rows
            # evicted earlier and sampled again before a flush come back
            # from their pending eviction tensors
            cold = [v for v in need if v not in self.pending]
            warm = [v for v in need if v in self.pending]
            if self.residual is not None and cold:
                rrows = store.gather_residual(np.asarray(cold, np.int64))
                cohort_scatter(self.residual,
                               self._slots([self.slot_of[v] for v in cold]),
                               upload(rrows, self.device),
                               backend=self.kernel_backend)
            if self.data is not None:
                if population is None or tau is None:
                    raise ValueError("data-resident promotion needs the "
                                     "population and tau")
                throwaway = np.random.default_rng(0)
                shards = []
                for v in need:
                    got = None if data_rows is None else data_rows.get(v)
                    if got is None:
                        # stationary contract: the sampler ignores its rng,
                        # so a throwaway generator re-derives the client's
                        # fixed shard without touching the shared stream
                        got = population.sampler(int(v), tau, throwaway)
                    shards.append(got)
                drows = tree_map(lambda *xs: np.stack(xs), *shards)
                sl = self._slots(slots_new)
                for block, rows in zip(tree_leaves(self.data),
                                       tree_leaves(drows)):
                    cohort_scatter(block.reshape(self.capacity, -1), sl,
                                   upload(rows.reshape(len(need), -1),
                                          self.device),
                                   backend=self.kernel_backend)
            if self.residual is not None and warm:
                rows = [self.pending.pop(v) for v in warm]
                cohort_scatter(self.residual,
                               self._slots([self.slot_of[v] for v in warm]),
                               torch.stack([b[j] for b, j in rows]),
                               backend=self.kernel_backend)
        self._stamp(vids)

    def slots_for(self, cohorts: np.ndarray) -> np.ndarray:
        """Map an (R, K) vid plan to its (R, K) int64 cache-slot plan."""
        flat = np.asarray([self.slot_of[int(v)]
                           for v in np.asarray(cohorts).ravel()], np.int64)
        return flat.reshape(np.asarray(cohorts).shape)

    def flush(self, store: ClientStore) -> None:
        """Bring every warm and pending residual row into the store and
        write the warm rho rows through: the store is then authoritative
        again (checkpoint-safe). The one deliberate blocking sync of the
        resident path; rho and the slot map are host-only."""
        self.stats["flushes"] += 1
        occ = np.flatnonzero(self.vids >= 0)
        if self.residual is not None:
            if occ.size:
                rows = cohort_gather(self.residual, self._slots(occ),
                                     backend=self.kernel_backend)
                store.scatter_residual(self.vids[occ], rows.cpu().numpy())
            if self.pending:
                vids = np.asarray(sorted(self.pending), np.int64)
                # bring each eviction tensor to the host once, then pick rows
                mat: dict[int, np.ndarray] = {}

                def _row(batch, j):
                    if id(batch) not in mat:
                        mat[id(batch)] = batch.cpu().numpy()
                    return mat[id(batch)][j]

                rows = np.stack([_row(*self.pending[int(v)]) for v in vids])
                store.scatter_residual(vids, rows)
                self.pending.clear()
        if occ.size:
            store.scatter_rho(self.vids[occ], self.rho[occ])

    def reset(self) -> None:
        """Drop all residency (after a flush): slots empty, device blocks
        kept allocated. Stale rows are never read: gathers touch only slots
        in ``slot_of`` and promotion overwrites before use."""
        self.vids.fill(-1)
        self.slot_of.clear()
        self.last_used.fill(0)
        self.clock = 0


def init_resident_cache(spec: FederationSpec, pstate, capacity: int,
                        population: ClientPopulation | None = None,
                        ) -> ResidentCache:
    """The resident cache for ``spec`` on ``pstate``'s device: capacity
    clamped to min(capacity, M), the residual block sized from the store,
    and the data block allocated iff the population declares
    ``stationary`` and the spec has a pipeline (the data-resident chunk is
    the pipeline form; other specs stream host-built batches)."""
    if not spec.is_population():
        raise ValueError("resident caches need a population spec "
                         "(FederationSpec(population=M, cohort_size=K))")
    capacity = min(int(capacity), spec.population)
    if capacity < spec.n_clients:
        raise ValueError(f"resident cache capacity {capacity} < cohort "
                         f"size {spec.n_clients}")
    data_template = None
    if (population is not None and population.stationary
            and spec.has_pipeline()):
        data_template = population.sampler(0, spec.tau,
                                           np.random.default_rng(0))
    return ResidentCache(capacity, residual_dim=pstate.store.residual_dim,
                         data_template=data_template,
                         device=_device_of(pstate.fl),
                         kernel_backend=spec.kernel_backend)


def run_resident_rounds(spec: FederationSpec, pstate,
                        population: ClientPopulation, rng,
                        cache: ResidentCache,
                        n_rounds: int | None = None,
                        cohort_sampler: CohortSampler | None = None,
                        check_budgets: bool = True,
                        cohorts: np.ndarray | None = None,
                        batches: Any = None,
                        data_rows: dict[int, Any] | None = None,
                        prefetch: Callable[[], None] | None = None,
                        ) -> tuple[Any, list[dict]]:
    """A chunk of R rounds with a FRESH COHORT PER ROUND.

    The per-round cohorts are ``chunk_cohorts(sampler, rounds_done, R)``,
    the per-round driver's schedule; their union is promoted into
    ``cache``, and the (R, K) slot plan goes to the device once, where the
    ``cohort_gather_scatter`` kernel moves residual rows between the cache
    and each round's block. Host syncs per steady chunk: none under full
    within-cohort participation (the all-ones mask is never fetched), one
    stacked-mask fetch otherwise.

    ``batches`` may be passed pre-built with leaves (R, K, tau, B, ...) in
    per-round cohort order; a data-resident cache (stationary population)
    takes none, since each round's shards are gathered from the cache.
    Bit-identical to R sequential ``run_cohort_round`` calls; raises and
    returns like ``run_cohort_rounds`` (``PrefetchFailed`` carries the
    completed PopulationState)."""
    from repro_torch.population import runtime as rt

    sampler = rt._resolve_cohort_sampler(spec, cohort_sampler)
    if cohorts is None:
        if n_rounds is None or n_rounds <= 0:
            raise ValueError(f"n_rounds must be positive, got {n_rounds}")
        cohorts = chunk_cohorts(sampler, pstate.fl.rounds_done, n_rounds,
                                spec.population, spec.n_clients)
    cohorts = np.asarray(cohorts)
    if n_rounds is None:
        n_rounds = int(cohorts.shape[0])
    if cohorts.shape[0] != n_rounds:
        raise ValueError(f"n_rounds={n_rounds} != cohort plan leading axis "
                         f"{cohorts.shape[0]}")
    # row 0 through the single-cohort check (spec / population / shape
    # errors), the other rows vectorized
    rt._check_cohort(spec, population, cohorts[0])
    if cohorts.ndim != 2 or cohorts.shape[1] != spec.n_clients:
        raise ValueError(f"cohort plan has shape {cohorts.shape}, expected "
                         f"({n_rounds}, {spec.n_clients})")
    srt = np.sort(cohorts, axis=1)
    if np.any(srt[:, 1:] == srt[:, :-1]):
        raise ValueError("cohort vids must be unique within each round")
    if cohorts.min() < 0 or cohorts.max() >= spec.population:
        raise ValueError(f"cohort vids out of range [0, {spec.population})")
    data_resident = cache.data is not None
    if data_resident and batches is not None:
        raise ValueError("data-resident chunks gather shards from the "
                         "cache; don't pass batches")
    fl = pstate.fl
    dev = _device_of(fl)
    lay = fl.layout
    if batches is None and not data_resident:
        per = [rt.cohort_batch(spec, population, cohorts[r], rng)
               for r in range(n_rounds)]
        batches = tree_map(lambda *xs: np.stack(xs), *per)
    if batches is not None:
        batches = _batch_on(fl, batches, dev, axis=1)
    if check_budgets:
        ok, which = rt.rounds_within_population_budgets(spec, pstate,
                                                        n_rounds)
        if ok < n_rounds:
            _raise_budget(which, spec)

    cache.ensure_resident(pstate.store, np.unique(cohorts),
                          population=population, tau=spec.tau,
                          data_rows=data_rows)
    slots = cache.slots_for(cohorts)

    sig = _sigmas_on(spec, fl, dev)
    pipeline = spec.has_pipeline()
    full_part = spec.participants_per_round() >= spec.n_clients
    prefetch_exc = None

    def _prefetch():
        nonlocal prefetch_exc
        if prefetch is not None:
            try:
                prefetch()
            except Exception as e:    # noqa: BLE001 — re-raised below
                prefetch_exc = e

    slots_dev = None
    if pipeline:
        fn = resident_chunked_round_fn_for(spec, data_resident=data_resident)
        slots_dev = upload(slots, dev)
        new_p, new_s, key, _, ms, masks = fn(
            fl.params, fl.opt_state,
            cache.data if data_resident else batches, slots_dev, fl.key,
            sig, cache.residual, slab=lay)
        _prefetch()
        # P == C makes participation_mask all ones: the ledger replays
        # without fetching the masks, and the chunk never blocks
        masks_np = None if full_part else masks.cpu().numpy()
    else:
        fn = chunked_round_fn_for(spec, slab=lay is not None)
        new_p, new_s, key, ms = fn(fl.params, fl.opt_state, batches,
                                   fl.key, sig, slab=lay)
        _prefetch()
        masks_np = None

    # exact host ledger replay, mirroring the per-round driver expression by
    # expression: per-cohort repeated adds, the pre-round global-max mirror
    # of the store's monotone _max_rho, and the same lift order
    charges = round_rho_charges(spec)
    running = pstate.store.max_rho()
    recs: list[dict] = []
    spent = fl.resource_spent
    touched: set[int] = set()
    for r in range(n_rounds):
        vids_r = cohorts[r]
        slots_r = slots[r]
        outside = -math.inf if vids_r.size == spec.population else running
        if masks_np is None:
            add = charges
            participants = float(spec.n_clients)
        else:
            m = masks_np[r]
            add = np.where(m > 0, charges, 0.0)
            participants = float(int(m.sum()))
        block = cache.rho[slots_r] + add
        cache.rho[slots_r] = block
        pstate.store.note_participation(vids_r, 1)
        touched.update(int(v) for v in vids_r)
        spent = spent + spec.round_cost()
        rec = {k: v[r] for k, v in ms.items()}       # lazy 0-d device views
        rec["round"] = fl.rounds_done + r + 1
        rec["iterations"] = (fl.rounds_done + r + 1) * spec.tau
        rec["max_epsilon"] = zcdp_to_dp(float(np.max(block)), spec.delta)
        rec["resource_spent"] = spent
        rec["participants"] = participants
        rt._population_epsilon_fix(rec, outside, spec.delta)
        running = max(running, float(np.max(block)))
        recs.append(rec)

    # rho write-through: the store is authoritative again at the boundary
    tv = np.asarray(sorted(touched), np.int64)
    tslots = np.asarray([cache.slot_of[int(v)] for v in tv], np.int64)
    pstate.store.scatter_rho(tv, cache.rho[tslots])

    changes: dict = dict(
        params=new_p, opt_state=new_s, key=key,
        rho=cache.rho[slots[-1]].copy(),
        steps=fl.steps + n_rounds * spec.tau,
        resource_spent=spent,
        rounds_done=fl.rounds_done + n_rounds)
    if pipeline and cache.residual is not None:
        # the FLState keeps its "current cohort" residual: a gathered copy
        # of the last round's rows (a slab state's: its block's), which
        # later scatters leave alone
        last = slots_dev[-1] if lay is None else lay.take(slots_dev[-1])
        rows = cohort_gather(cache.residual, last,
                             backend=spec.kernel_backend)
        changes["residual"] = rows if lay is None else lay.zero_pad(rows)
    new_state = pstate.replace(fl=fl.replace(**changes))
    if prefetch_exc is not None:
        raise PrefetchFailed(prefetch_exc, new_state, recs) from prefetch_exc
    return new_state, recs
