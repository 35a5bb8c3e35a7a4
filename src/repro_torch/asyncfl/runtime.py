"""Buffered-async training driver: AsyncState + init/cycle/train_async.

The async mirror of :mod:`repro_torch.api.state`: one :class:`AsyncState`
value per federation (the global model, the K slot storages with one
in-flight client per slot, the simulated arrival schedule and the
dispatch-split privacy ledger) advanced one *flush cycle* at a time by
:func:`run_async_cycle` and driven to the budgets by :func:`train_async`
through the shared :func:`repro_torch.api.state.budget_train_loop` hooks
(eval boundaries, theta* tracking and double-buffered chunking are
inherited, not reimplemented).

Dispatch-time privacy accounting (the staleness-aware ledger): a client
is charged the full Lemma-2 per-round rho **when it is dispatched**, for
the model version it trains on, not when its upload lands. The charge
sits in ``pending_rho`` until the flush that consumes the upload moves it
into the landed ``fl.rho``; every budget probe reads the *dispatched*
view ``fl.rho + pending_rho``, so a straggler whose upload is still in
flight can never let the probe under-count. With the degenerate schedule
(B == K, zero latency spread, alpha=0) the landed ledger is bit-for-bit
the sync ``run_round`` ledger: same masks, same per-round charge vector,
same numpy accumulation order.

Resource accounting charges Eq. 8 *per flush*, scaled by what actually
moved: ``c1 * wire_ratio * (participating arrivals / C)`` for the
aggregation and ``c2 * tau * (B / C)`` for the compute the flush consumed,
exactly ``spec.round_cost()`` in the degenerate case.

The event schedule, the staleness weights and the ledger are the JAX
package's host numpy, bit for bit. The device work of a cycle runs where
the state lives (``init_async_state(..., device=...)``, the GPU by
default); a cycle's one blocking host sync is the fetch of the new
dispatch's participation mask under a pipeline (none without one), and
its metrics stay 0-d device tensors until ``materialize_record``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.spec import FederationSpec
from repro_torch.api.state import (
    BudgetExceeded,
    FLState,
    accountant_view,
    budget_train_loop,
    round_batch,
    round_rho_charges,
    sigmas_for,
)
from repro_torch.asyncfl.clock import LatencyModel, UniformLatency
from repro_torch.asyncfl.engine import executor_for
from repro_torch.asyncfl.events import EventView, earliest_arrivals
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.privacy import zcdp_to_dp
from repro_torch.kernels.counter_rng import make_key
from repro_torch.utils.convert import tree_from_numpy, tree_upload
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AsyncState:
    """Complete state of one buffered-async federation.

    ``fl`` reuses :class:`repro_torch.api.FLState` with async readings: its
    params/opt_state/residual are the K *slot* storages (slot i = the
    in-flight dispatch of client i; what that client will upload, computed
    at dispatch), its ``key`` the counter generator's ``(seed, counter)``
    the dispatches draw at, its ``rho`` the LANDED ledger (flushed charges only; probe with
    ``+ pending_rho`` for the sound dispatched view), and ``rounds_done``
    counts completed flushes (== the global model version). All schedule
    arrays are host numpy: the event loop is exact host math, like the
    zCDP ledger. A cycle updates the slot storages in place, so continue
    from the state it returns.
    """
    fl: FLState
    global_params: Any              # the single server model (no client axis)
    global_opt: Any                 # its optimizer state (average_opt_state)
    sent: Any                       # (K, D) at-dispatch compressed uploads
    #   (None for dense specs); the flush averages rows of this
    slot_metrics: Any               # dict of (K,) per-slot local metrics
    slot_mask: np.ndarray           # (K,) f32 dispatch-time participation mask
    pending_rho: np.ndarray         # (K,) f64 in-flight dispatch pre-charges
    slot_version: np.ndarray        # (K,) i64 model version trained on
    slot_seq: np.ndarray            # (K,) i64 dispatch seq (latency stream id)
    arrival_time: np.ndarray        # (K,) f64 pending arrival timestamps
    arrivals: np.ndarray            # (K,) i64 landed uploads per slot
    clock: float = 0.0              # virtual seconds at the last flush
    next_seq: int = 0               # global dispatch counter

    def replace(self, **changes) -> "AsyncState":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ScheduleRow:
    """One pre-projected flush cycle (see :func:`train_async` chunking)."""
    idx: np.ndarray                 # (B,) popped slots, pop order
    flush_time: float
    latency: np.ndarray             # (B,) replacement-dispatch latencies
    batch: Any                      # (B, tau, ...) device round batch


def polynomial_staleness(alpha: float) -> Callable[[np.ndarray], np.ndarray]:
    """The default staleness weight ``w(s) = 1 / (1 + s)^alpha`` (FedBuff /
    FedAsync polynomial damping). ``alpha=0`` returns exact 1.0 weights,
    the identity-gate setting."""
    def weight(s: np.ndarray) -> np.ndarray:
        return np.power(1.0 + np.asarray(s, np.float64),
                        -float(alpha)).astype(np.float32)
    return weight


def _device_of(state: AsyncState) -> torch.device:
    return tree_leaves(state.global_params)[0].device


# ---------------------------------------------------------------------------
# budget probes (dispatched view: landed + in-flight)
# ---------------------------------------------------------------------------

def dispatched_rho(state: AsyncState) -> np.ndarray:
    """(C,) zCDP each client has COMMITTED to spend: landed + in-flight.
    Every probe reads this, never the landed ledger alone."""
    return state.fl.rho + state.pending_rho


def dispatched_epsilon(spec: FederationSpec, state: AsyncState) -> float:
    """Worst-client (eps, delta)-DP of the dispatched view."""
    return zcdp_to_dp(float(np.max(dispatched_rho(state))), spec.delta)


def async_flush_cost(spec: FederationSpec, n_arrivals: int,
                     n_participants: int) -> float:
    """Eq.-8 cost of one realized flush: comm for the participating
    arrivals' uploads + compute for the ``n_arrivals`` local rounds the
    flush consumed. Degenerates bit-for-bit to ``spec.round_cost()`` when
    the flush is a full sync round (n_arrivals == C, participants == the
    spec's per-round count)."""
    comm = spec.c1 * (spec.wire_ratio() * (n_participants / spec.n_clients))
    comp = spec.c2 * spec.tau * (n_arrivals / spec.n_clients)
    return comm + comp


def async_flush_cost_bound(spec: FederationSpec) -> float:
    """Upper bound on any flush's cost (all B arrivals participate): the
    conservative per-flush increment the budget probes assume."""
    b = spec.resolved_buffer_size()
    return async_flush_cost(spec, b, b)


def exceeds_async_budgets(spec: FederationSpec,
                          state: AsyncState) -> str | None:
    """Would one more flush break a budget? "resource" / "privacy" / None.

    Conservative and sound: the privacy probe assumes every client may be
    redispatched once more on top of everything already committed
    (dispatched view + one worst-case round charge); the resource probe
    assumes a maximal flush. It can stop one flush earlier than the landed
    ledger alone would, never later."""
    if state.fl.resource_spent + async_flush_cost_bound(spec) > spec.c_th:
        return "resource"
    probe = np.max(dispatched_rho(state) + round_rho_charges(spec))
    if zcdp_to_dp(float(probe), spec.delta) > spec.eps_th:
        return "privacy"
    return None


def flushes_within_budgets(spec: FederationSpec, state: AsyncState,
                           limit: int) -> tuple[int, str | None]:
    """How many consecutive flushes are CERTAIN to fit the budgets (the
    async ``rounds_within_budgets``): replays the conservative per-flush
    probes with worst-case ledger growth."""
    charges = round_rho_charges(spec)
    rho = dispatched_rho(state)
    spent = state.fl.resource_spent
    cost = async_flush_cost_bound(spec)
    n = 0
    while n < limit:
        if spent + cost > spec.c_th:
            return n, "resource"
        if zcdp_to_dp(float(np.max(rho + charges)), spec.delta) > spec.eps_th:
            return n, "privacy"
        rho = rho + charges
        spent = spent + cost
        n += 1
    return n, None


def _raise_async_budget(which: str, spec: FederationSpec):
    if which == "resource":
        raise BudgetExceeded(
            "resource", f"flush cost bound {async_flush_cost_bound(spec)} "
            f"would exceed C_th={spec.c_th}")
    raise BudgetExceeded(
        "privacy", f"dispatching {spec.resolved_buffer_size()} more clients "
        f"(tau={spec.tau} pre-charged steps each) could exceed "
        f"eps_th={spec.eps_th}")


def async_accountant_view(spec: FederationSpec, state: AsyncState):
    """A :class:`~repro_torch.core.privacy.PrivacyAccountant` materialized
    at the dispatched view, with the dispatch/arrival split restored
    (``pending_rho`` / ``landed_rho`` report per-client in-flight vs
    flushed charges)."""
    acc = accountant_view(spec)
    for m in range(spec.n_clients):
        acc._rho[m] = float(state.fl.rho[m] + state.pending_rho[m])
        if state.pending_rho[m] > 0.0:
            acc._pending[m] = float(state.pending_rho[m])
    acc.steps = state.fl.steps
    return acc


# ---------------------------------------------------------------------------
# init / cycle
# ---------------------------------------------------------------------------

def _block_batch(spec: FederationSpec, sampler: Callable, rng,
                 idx: np.ndarray) -> Any:
    """Stack the popped slots' round batches in pop order (host numpy). With
    the degenerate ``idx == arange(C)`` this consumes the sampler rng stream
    exactly like :func:`repro_torch.api.state.round_batch`."""
    per_slot = [sampler(int(m), spec.tau, rng) for m in idx]
    return tree_map(lambda *xs: np.stack(xs), *per_slot)


def schedule_cursor(state: AsyncState) -> EventView:
    """A replica of ``state``'s event schedule for :func:`project_schedule`
    to advance (the state itself is not touched)."""
    return EventView(state.arrival_time, state.slot_seq, state.next_seq,
                     state.clock)


def project_schedule(spec: FederationSpec, cursor: EventView,
                     sampler: Callable, rng, latency_model: LatencyModel,
                     n: int, device) -> list[ScheduleRow]:
    """The next ``n`` cycles' :class:`ScheduleRow` s, popped from
    ``cursor`` (:func:`schedule_cursor`), which advances: each row's pop,
    flush time, redispatch latencies and its block's round batch, sent to
    ``device`` from pinned memory. Rows must run in order from the state
    the cursor was taken from (``run_async_cycle(prebuilt=row)`` raises on
    a desync); the sampler ``rng`` is consumed as the per-cycle driver
    consumes it."""
    b = spec.resolved_buffer_size()
    rows = []
    for _ in range(n):
        idx, t, _, latency = cursor.pop(b, latency_model)
        rows.append(ScheduleRow(
            idx=idx, flush_time=t, latency=latency,
            batch=tree_upload(_block_batch(spec, sampler, rng, idx), device)))
    return rows


def _host_mask(mask: torch.Tensor, has_pipeline: bool, b: int) -> np.ndarray:
    """The dispatch's participation mask on the host: fetched under a
    pipeline (a cycle's one blocking sync), all ones without one."""
    if has_pipeline:
        return mask.cpu().numpy()
    return np.ones((b,), np.float32)


def init_async_state(spec: FederationSpec, params0: Any, sampler: Callable,
                     *, rng=None, latency_model: LatencyModel | None = None,
                     key: torch.Tensor | None = None,
                     check_budgets: bool = True, device=None) -> AsyncState:
    """Fresh AsyncState on ``device`` (default ``"cuda"``; raises when no
    GPU is present): dispatch generation 0 (all K slots, from the initial
    model) and schedule its arrivals at the latency model's draws.

    The generation-0 dispatch draws exactly the sync driver's round-1
    randomness and batch schedule (``key`` defaults to the counter
    generator's key ``init_state`` makes) and is pre-charged in ``pending_rho``: nothing
    has landed yet, so ``fl.rho`` starts zero and ``clock`` at 0.0.
    """
    if not spec.is_async():
        raise ValueError("init_async_state needs engine='async_buffered', "
                         f"got engine={spec.engine!r}")
    dev = resolve_device(device)
    if rng is None:
        rng = np.random.default_rng(spec.seed)
    if latency_model is None:
        latency_model = UniformLatency(spec.seed)
    if key is None:
        key = make_key(spec.seed)
    charges = round_rho_charges(spec)
    if check_budgets:
        # the same first-round probe the sync driver runs, against the
        # conservative flush bound / the gen-0 dispatch charge
        if async_flush_cost_bound(spec) > spec.c_th:
            _raise_async_budget("resource", spec)
        if zcdp_to_dp(float(np.max(charges)), spec.delta) > spec.eps_th:
            _raise_async_budget("privacy", spec)
    k = spec.n_clients
    global_params = tree_from_numpy(params0, dev)
    global_opt = spec.optimizer.init(global_params)
    pipe = spec.aggregation_pipeline()
    residual0 = (pipe.init_residual(global_params) if pipe is not None
                 else None)
    batch = tree_upload(round_batch(spec, sampler, rng), dev)
    out = executor_for(spec).init_dispatch(
        global_params, global_opt, batch, key, sigmas_for(spec, dev),
        residual=residual0)
    mask_np = _host_mask(out["mask"], pipe is not None, k)
    fl = FLState(params=out["slot_params"], opt_state=out["slot_opt"],
                 key=out["key"], rho=np.zeros((k,), np.float64),
                 residual=out["residual"])
    latency = np.asarray(latency_model(np.arange(k), np.arange(k)),
                         np.float64)
    return AsyncState(
        fl=fl, global_params=global_params, global_opt=global_opt,
        sent=out["sent"], slot_metrics=out["slot_metrics"],
        slot_mask=mask_np.astype(np.float32),
        pending_rho=np.where(mask_np > 0, charges, 0.0),
        slot_version=np.zeros((k,), np.int64),
        slot_seq=np.arange(k, dtype=np.int64),
        arrival_time=latency, arrivals=np.zeros((k,), np.int64),
        clock=0.0, next_seq=k)


def run_async_cycle(spec: FederationSpec, state: AsyncState,
                    sampler: Callable | None = None, rng=None, *,
                    latency_model: LatencyModel | None = None,
                    staleness_weight: Callable | None = None,
                    check_budgets: bool = True,
                    prebuilt: ScheduleRow | None = None,
                    ) -> tuple[AsyncState, dict]:
    """One flush cycle: pop the B earliest arrivals, fold them into the
    global model (staleness-weighted), land their privacy charges, and
    redispatch the popped slots from the new model (pre-charging them).

    Either pass ``sampler``/``rng``/``latency_model`` (the per-cycle
    driver builds its own schedule step) or a ``prebuilt``
    :class:`ScheduleRow` from the chunked driver's projection: the two
    are interchangeable cycle for cycle (the schedule is deterministic;
    a desynced projection raises rather than training on wrong slots).

    The input state's slot storages are updated in place: continue from
    the returned state, like ``run_round``. The returned record's metric
    values stay 0-d device tensors; ``materialize_record`` forces them.
    """
    if check_budgets:
        which = exceeds_async_budgets(spec, state)
        if which is not None:
            _raise_async_budget(which, spec)
    b = spec.resolved_buffer_size()
    dev = _device_of(state)
    if prebuilt is None:
        if sampler is None or rng is None or latency_model is None:
            raise ValueError("run_async_cycle needs sampler, rng and "
                             "latency_model (or a prebuilt ScheduleRow)")
        idx, flush_time, new_seqs, new_latency = schedule_cursor(state).pop(
            b, latency_model)
        batch = tree_upload(_block_batch(spec, sampler, rng, idx), dev)
    else:
        idx, flush_time = prebuilt.idx, prebuilt.flush_time
        new_latency, batch = prebuilt.latency, prebuilt.batch
        live = earliest_arrivals(state.arrival_time, state.slot_seq, b)
        if not np.array_equal(live, idx):
            raise RuntimeError(
                "prebuilt schedule desynced from the live event state "
                f"(expected pop {live}, row has {idx}): rebuild the "
                "projection from the current AsyncState")
        new_seqs = state.next_seq + np.arange(b, dtype=np.int64)
    staleness = (state.fl.rounds_done
                 - state.slot_version[idx]).astype(np.int64)
    weight_fn = (staleness_weight
                 or polynomial_staleness(spec.staleness_alpha))
    weights = np.asarray(weight_fn(staleness), np.float32)
    arr_mask = state.slot_mask[idx].astype(np.float32)
    out = executor_for(spec).cycle(
        state.global_params, state.global_opt, state.fl.params,
        state.fl.opt_state, state.slot_metrics, state.fl.key,
        sigmas_for(spec, dev), idx, weights, arr_mask, batch,
        sent=state.sent, residual=state.fl.residual)
    nmask = _host_mask(out["mask"], spec.has_pipeline(), b)
    charges = round_rho_charges(spec)
    # land the popped arrivals' pre-charges, then pre-charge the redispatch
    landed = np.zeros((spec.n_clients,), np.float64)
    landed[idx] = state.pending_rho[idx]
    rho = state.fl.rho + landed
    pending = state.pending_rho.copy()
    pending[idx] = np.where(nmask > 0, charges[idx], 0.0)
    n_participants = int(arr_mask.sum())
    cost = async_flush_cost(spec, b, n_participants)
    slot_mask = state.slot_mask.copy()
    slot_mask[idx] = nmask.astype(np.float32)
    slot_version = state.slot_version.copy()
    slot_version[idx] = state.fl.rounds_done + 1   # trains on the new model
    arrival_time = state.arrival_time.copy()
    arrival_time[idx] = flush_time + new_latency
    slot_seq = state.slot_seq.copy()
    slot_seq[idx] = new_seqs
    arrivals = state.arrivals.copy()
    arrivals[idx] += 1
    fl = state.fl.replace(
        params=out["slot_params"], opt_state=out["slot_opt"],
        key=out["key"], residual=out["residual"], rho=rho,
        steps=state.fl.steps + spec.tau,
        resource_spent=state.fl.resource_spent + cost,
        rounds_done=state.fl.rounds_done + 1)
    new_state = state.replace(
        fl=fl, global_params=out["global_params"],
        global_opt=out["global_opt"], sent=out["sent"],
        slot_metrics=out["slot_metrics"], slot_mask=slot_mask,
        pending_rho=pending, slot_version=slot_version, slot_seq=slot_seq,
        arrival_time=arrival_time, arrivals=arrivals,
        clock=float(flush_time), next_seq=state.next_seq + b)
    rec = dict(out["metrics"])        # lazy 0-d device tensors, no sync
    rec["round"] = fl.rounds_done
    rec["iterations"] = fl.rounds_done * spec.tau
    rec["max_epsilon"] = zcdp_to_dp(float(np.max(rho)), spec.delta)
    rec["max_epsilon_dispatched"] = dispatched_epsilon(spec, new_state)
    rec["resource_spent"] = fl.resource_spent
    rec["participants"] = float(n_participants)
    rec["sim_seconds"] = new_state.clock
    rec["buffer_size"] = float(b)
    rec["staleness_mean"] = float(np.mean(staleness))
    rec["staleness_max"] = float(np.max(staleness))
    return new_state, rec


# ---------------------------------------------------------------------------
# budget-aware driver
# ---------------------------------------------------------------------------

def async_eval_params(spec: FederationSpec, state: AsyncState) -> Any:
    """The single evaluation/serving model: async topology is always
    full_average, and the server model is already collapsed."""
    del spec
    return state.global_params


def train_async(spec: FederationSpec, state: AsyncState, sampler: Callable,
                max_rounds: int = 10_000, eval_fn: Callable | None = None,
                eval_every: int = 1, rng=None,
                history: list[dict] | None = None, chunk_rounds: int = 1,
                latency_model: LatencyModel | None = None,
                staleness_weight: Callable | None = None,
                ) -> tuple[AsyncState, dict]:
    """Run flush cycles until a budget would be exceeded: the async
    :func:`repro_torch.api.state.train`, built on the same
    :func:`budget_train_loop` (identical eval-boundary, theta* and
    double-buffer semantics; "round" = flush).

    ``chunk_rounds=R > 1`` pre-projects R cycles of the (fully
    deterministic) event schedule on the host (pop indices, flush times,
    latency draws, and batches sent to the device from pinned memory)
    while the current chunk computes; cycles still run one flush + dispatch
    each. ``max_rounds`` caps completed flushes; the summary reports
    virtual ``sim_seconds`` alongside the budget totals.
    """
    if rng is None:
        rng = np.random.default_rng(spec.seed)
    if latency_model is None:
        latency_model = UniformLatency(spec.seed)
    history = [] if history is None else history
    dev = _device_of(state)
    # the chunked driver's schedule cursor, advanced in build order.
    # budget_train_loop builds chunks in execution order, so the cursor
    # (like the sampler rng stream) stays aligned with the runs;
    # run_async_cycle re-derives the live pop and raises on any desync.
    cursor = schedule_cursor(state)

    def build_chunk(start: int, n: int) -> list[ScheduleRow]:
        del start
        return project_schedule(spec, cursor, sampler, rng, latency_model, n,
                                dev)

    def run_chunk(s, chunk, n, prefetch):
        recs = []
        for i in range(n):
            s, rec = run_async_cycle(spec, s, check_budgets=False,
                                     prebuilt=chunk[i],
                                     staleness_weight=staleness_weight)
            recs.append(rec)
            if i == 0:
                prefetch()     # overlap building the next chunk's schedule
        return s, recs

    state, best = budget_train_loop(
        state=state, max_rounds=max_rounds, eval_fn=eval_fn,
        eval_every=eval_every, history=history, chunk_rounds=chunk_rounds,
        rounds_done=lambda s: s.fl.rounds_done,
        exceeds=lambda s: exceeds_async_budgets(spec, s) is not None,
        safe_rounds=lambda s, cap: flushes_within_budgets(spec, s, cap)[0],
        run_single=lambda s: run_async_cycle(
            spec, s, sampler, rng, latency_model=latency_model,
            staleness_weight=staleness_weight, check_budgets=False),
        build_chunk=build_chunk,
        run_chunk=run_chunk,
        run_tail=lambda s, chunk, r: run_async_cycle(
            spec, s, check_budgets=False, prebuilt=chunk[r],
            staleness_weight=staleness_weight),
        eval_model=lambda s: async_eval_params(spec, s))
    return state, {
        "best": best, "rounds": state.fl.rounds_done,
        "resource_spent": state.fl.resource_spent,
        "max_epsilon": dispatched_epsilon(spec, state),
        "sim_seconds": state.clock,
        "history": history,
    }


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def save_async_state(directory: str, state: AsyncState,
                     extra: dict | None = None) -> None:
    """Persist an AsyncState (device trees + the host schedule/ledger), in
    the JAX package's layout. ``key`` is the port's counter generator's
    ``(seed, counter)``."""
    meta = {
        "rho": [float(r) for r in state.fl.rho],
        "steps": int(state.fl.steps),
        "resource_spent": float(state.fl.resource_spent),
        "rounds_done": int(state.fl.rounds_done),
        "slot_mask": [float(x) for x in state.slot_mask],
        "pending_rho": [float(x) for x in state.pending_rho],
        "slot_version": [int(x) for x in state.slot_version],
        "slot_seq": [int(x) for x in state.slot_seq],
        "arrival_time": [float(x) for x in state.arrival_time],
        "arrivals": [int(x) for x in state.arrivals],
        "clock": float(state.clock),
        "next_seq": int(state.next_seq),
        **(extra or {}),
    }
    arrays = {"params": state.fl.params, "opt_state": state.fl.opt_state,
              "key": state.fl.key, "global_params": state.global_params,
              "global_opt": state.global_opt,
              "slot_metrics": state.slot_metrics}
    if state.fl.residual is not None:
        arrays["residual"] = state.fl.residual
    if state.sent is not None:
        arrays["sent"] = state.sent
    save_checkpoint(directory, arrays, step=state.fl.rounds_done, extra=meta)


def load_async_state(directory: str,
                     like: AsyncState) -> tuple[AsyncState, dict]:
    """Restore an AsyncState saved by :func:`save_async_state` onto
    ``like``'s device; ``like`` supplies structure (e.g. a fresh
    :func:`init_async_state`). Returns (state, extra). The restored
    schedule arrays replay the exact event stream: resuming mid-run
    realizes the same flush sequence as the uninterrupted run."""
    like_tree = {"params": like.fl.params, "opt_state": like.fl.opt_state,
                 "key": like.fl.key, "global_params": like.global_params,
                 "global_opt": like.global_opt,
                 "slot_metrics": like.slot_metrics}
    if like.fl.residual is not None:
        like_tree["residual"] = like.fl.residual
    if like.sent is not None:
        like_tree["sent"] = like.sent
    tree, _, extra = load_checkpoint(directory, like=like_tree)
    dev = _device_of(like)
    dev_tree = {k: (torch.as_tensor(v) if k == "key"
                    else tree_from_numpy(v, dev)) for k, v in tree.items()}
    fl = like.fl.replace(
        params=dev_tree["params"], opt_state=dev_tree["opt_state"],
        key=dev_tree["key"],
        residual=dev_tree.get("residual", like.fl.residual),
        rho=np.asarray(extra["rho"], np.float64),
        steps=int(extra["steps"]),
        resource_spent=float(extra["resource_spent"]),
        rounds_done=int(extra["rounds_done"]))
    state = like.replace(
        fl=fl, global_params=dev_tree["global_params"],
        global_opt=dev_tree["global_opt"],
        sent=dev_tree.get("sent", like.sent),
        slot_metrics=dev_tree["slot_metrics"],
        slot_mask=np.asarray(extra["slot_mask"], np.float32),
        pending_rho=np.asarray(extra["pending_rho"], np.float64),
        slot_version=np.asarray(extra["slot_version"], np.int64),
        slot_seq=np.asarray(extra["slot_seq"], np.int64),
        arrival_time=np.asarray(extra["arrival_time"], np.float64),
        arrivals=np.asarray(extra["arrivals"], np.int64),
        clock=float(extra["clock"]), next_seq=int(extra["next_seq"]))
    return state, extra
