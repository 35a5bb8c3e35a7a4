"""Functional DP-PASGD core: FLState + init_state / run_round / train.

The state of a federation is one immutable :class:`FLState` value: model
replicas, optimizer state, the key of the counter-based generator the
noise is drawn from, the privacy-accountant snapshot, the spent resources
and, with a compressor, the error-feedback residual. Under ``mesh_2d`` on
a world of several ranks each rank's state is its slab (its client
block's rows and its model slices; :func:`init_state`), and
:func:`whole_state` reads the whole trees. ``run_round`` maps
(spec, state, batch) -> (state', metrics); ``save_state`` / ``load_state``
checkpoint it. The rho ledger, the resource cost and the budget probes are
the JAX package's float64 host math, bit for bit.

Tensors follow the device of the state: ``init_state`` places everything on
``device`` (the GPU unless the caller asks for another), and every round
runs there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.engines import (
    chunked_round_fn_for,
    mesh_shape_for,
    resolve_engine,
    round_fn_for,
    slab_round_fn_for,
)
from repro_torch.api.spec import FederationSpec
from repro_torch.checkpoint import (
    checkpoint_leaf_paths,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.core.fl import draw_pipeline_round, draw_round_noise
from repro_torch.core.privacy import (
    PrivacyAccountant,
    gaussian_zcdp,
    grad_sensitivity,
    per_step_charges,
    zcdp_to_dp,
)
from repro_torch.kernels.counter_rng import make_key
from repro_torch.utils.convert import tree_from_numpy
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import (
    tree_broadcast_axis0,
    tree_leaves,
    tree_map,
    tree_mean_over_axis0,
)


class BudgetExceeded(RuntimeError):
    """Raised by run_round when the next round would break a budget."""

    def __init__(self, which: str, message: str):
        super().__init__(message)
        self.which = which          # "resource" | "privacy"


class PrefetchFailed(RuntimeError):
    """The ``prefetch`` callback of :func:`run_rounds` raised after the
    chunk ran. The chunk's DP releases happened, so the completed successor
    state and records are attached (``.state`` / ``.records``); the original
    exception is chained as ``__cause__``."""

    def __init__(self, cause: BaseException, state: "FLState",
                 records: list):
        super().__init__(f"run_rounds prefetch callback failed: {cause!r}")
        self.state = state
        self.records = records


@dataclass(frozen=True)
class FLState:
    """Complete training state of one federation (immutable).

    params/opt_state carry the leading client axis C on every leaf, or,
    with a ``layout`` (a :class:`repro_torch.mesh.engine.SlabLayout`:
    ``mesh_2d`` on several ranks), this rank's slab: its client block's
    rows (pad rows past the last client included) of its model slices,
    the residual the block's rows whole in D (:func:`whole_state` gathers
    the whole trees). ``key`` is the counter-based generator's (2,) int64
    ``(seed, counter)`` on the host (:mod:`repro_torch.kernels
    .counter_rng`): each round's draws take its counter and advance it by
    one. The accountant snapshot (rho, steps) lives host-side as plain
    numpy, whole on every rank.
    """
    params: Any
    opt_state: Any
    key: torch.Tensor               # (seed, counter), one counter a round
    rho: np.ndarray                 # (C,) spent zCDP per client (Lemma 1)
    steps: int = 0                  # local iterations accounted so far
    resource_spent: float = 0.0     # accumulated Eq.-(8) cost
    rounds_done: int = 0
    residual: Any = None            # (C, D) f32 error-feedback residual of
    #   the aggregation pipeline; None unless the spec sets a compressor
    layout: Any = None              # SlabLayout of a slab state, else None

    def replace(self, **changes) -> "FLState":
        return dataclasses.replace(self, **changes)


def _device_of(state: FLState) -> torch.device:
    return tree_leaves(state.params)[0].device


def slab_applies(spec: FederationSpec) -> bool:
    """Whether :func:`init_state` gives ``spec`` slab state: a ``mesh_2d``
    spec (after ``engine="auto"``) on a world of more than one rank whose
    mesh holds every rank, neither a population nor an async spec (their
    drivers keep whole state)."""
    from repro_torch.launch.mesh import world_size
    if (spec.is_population() or spec.is_async() or world_size() < 2
            or resolve_engine(spec) != "mesh_2d"):
        return False
    dc, dm = mesh_shape_for(spec)
    return dc * dm == world_size()


def init_state(spec: FederationSpec, params0: Any, device=None) -> FLState:
    """Fresh FLState: params0 (no client axis) replicated C times on
    ``device`` (default ``"cuda"``; raises when no GPU is present).

    Where :func:`slab_applies` each rank holds only its slab:
    ``params0``'s model slices, widened to its client block's rows, and the
    optimizer state likewise; the (C, ...) trees are never made on the
    device (:func:`whole_state` of it is the whole layout)."""
    dev = resolve_device(device)
    params0 = tree_from_numpy(params0, dev)
    opt0 = spec.optimizer.init(params0)
    pipe = spec.aggregation_pipeline()
    layout = None
    if slab_applies(spec):
        from repro_torch.mesh.engine import to_slab
        layout = round_fn_for(spec).layout(params0, opt0)
    rows = spec.n_clients if layout is None else layout.block
    residual = (pipe.init_residual(params0, rows) if pipe is not None
                else None)
    if layout is not None:
        params0 = to_slab(layout, params0, layout.param_dims, lead=0)
        opt0 = to_slab(layout, opt0, layout.state_dims, lead=0)
    return FLState(
        params=tree_broadcast_axis0(params0, rows),
        opt_state=tree_broadcast_axis0(opt0, rows),
        key=make_key(spec.seed),
        rho=np.zeros((spec.n_clients,), np.float64),
        residual=residual, layout=layout)


def whole_state(state: FLState) -> FLState:
    """The whole FLState of a slab state: params, optimizer state and
    residual gathered over the mesh's model and client groups, (C, ...) on
    every rank (a collective: every rank of the mesh calls it); a whole
    state as it is. The counterpart of reading a sharded JAX array whole."""
    lay = state.layout
    if lay is None:
        return state
    from repro_torch.mesh.engine import from_slab
    return state.replace(
        params=from_slab(lay, state.params, lay.param_dims),
        opt_state=from_slab(lay, state.opt_state, lay.state_dims),
        residual=(None if state.residual is None
                  else from_slab(lay, state.residual, -1)),
        layout=None)


# ---------------------------------------------------------------------------
# per-spec ledger constants (cached per ledger key)
# ---------------------------------------------------------------------------

_SIGMA_CACHE: dict[tuple, torch.Tensor] = {}
_RHO_STEP_CACHE: dict[tuple, np.ndarray] = {}
_LEDGER_CACHE_MAX = 128


def _ledger_cached(cache: dict, key, build):
    val = cache.get(key)
    if val is None:
        if len(cache) >= _LEDGER_CACHE_MAX:
            cache.clear()          # tiny (C,) vectors; simple bound suffices
        val = cache[key] = build()
    return val


def sigmas_for(spec: FederationSpec, device=None) -> torch.Tensor:
    """The (C,) f32 sigma vector for ``spec`` on ``device`` (default: the
    GPU), cached per ``spec.ledger_key()`` and device so rounds stop
    copying the same constants to the device every time."""
    device = resolve_device(device)
    return _ledger_cached(
        _SIGMA_CACHE, (spec.ledger_key(), str(device)),
        lambda: torch.as_tensor(spec.resolved_sigmas(), dtype=torch.float32,
                                device=device))


def _rho_steps(spec: FederationSpec) -> np.ndarray:
    """(C,) per-local-step zCDP charge per client at q=1 (Lemma 2 with the
    §5.2 sensitivity), as ``PrivacyAccountant`` computes it."""
    def build():
        sig = spec.resolved_sigmas()
        return np.asarray(
            [gaussian_zcdp(grad_sensitivity(spec.clip_norm, x), float(s))
             for x, s in zip(spec.resolved_batch_sizes(), sig)], np.float64)

    return _ledger_cached(_RHO_STEP_CACHE, spec.ledger_key(), build)


def round_rho_charges(spec: FederationSpec) -> np.ndarray:
    """(C,) per-round rho increments: tau steps at the accounting rate."""
    return spec.tau * per_step_charges(_rho_steps(spec), spec.accounting_q())


def accountant_view(spec: FederationSpec,
                    state: FLState | None = None) -> PrivacyAccountant:
    """A PrivacyAccountant materialized from spec (+ optional state)."""
    acc = PrivacyAccountant(clip_norm=spec.clip_norm, delta=spec.delta)
    sig = spec.resolved_sigmas()
    for m, x in enumerate(spec.resolved_batch_sizes()):
        acc.register_client(m, x, float(sig[m]))
    if state is not None:
        for m in range(spec.n_clients):
            acc._rho[m] = float(state.rho[m])
        acc.steps = state.steps
    return acc


def max_epsilon(spec: FederationSpec, state: FLState) -> float:
    return accountant_view(spec, state).max_epsilon()


def peek_epsilon_fast(spec: FederationSpec, state: FLState,
                      extra_steps: int) -> float:
    """Worst-client eps if every client took ``extra_steps`` more local
    iterations, from the state's rho snapshot plus the cached per-step
    charges; bit-identical to ``PrivacyAccountant.peek_epsilon``."""
    extra = extra_steps * per_step_charges(_rho_steps(spec),
                                           spec.accounting_q())
    return zcdp_to_dp(float(np.max(state.rho + extra)), spec.delta)


def exceeds_budgets(spec: FederationSpec, state: FLState) -> str | None:
    """Would one more round break a budget? -> "resource" / "privacy" /
    None."""
    if state.resource_spent + spec.round_cost() > spec.c_th:
        return "resource"
    if peek_epsilon_fast(spec, state, spec.tau) > spec.eps_th:
        return "privacy"
    return None


def rounds_within_budgets(spec: FederationSpec, state: FLState,
                          limit: int) -> tuple[int, str | None]:
    """How many consecutive future rounds certainly fit the budgets, capped
    at ``limit``, plus the budget that would bind next. Replays
    ``exceeds_budgets``'s per-round probes, so its decisions are the
    per-round driver's."""
    charges = round_rho_charges(spec)
    rho = state.rho
    spent = state.resource_spent
    cost = spec.round_cost()
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


def _raise_budget(which: str, spec: FederationSpec):
    if which == "resource":
        raise BudgetExceeded("resource", f"round cost {spec.round_cost()} "
                             f"would exceed C_th={spec.c_th}")
    raise BudgetExceeded("privacy", f"tau={spec.tau} more steps would "
                         f"exceed eps_th={spec.eps_th}")


def run_round(spec: FederationSpec, state: FLState, batch: Any,
              check_budgets: bool = True) -> tuple[FLState, dict]:
    """One DP-PASGD round (Eq. 7a-7b): tau local steps + the topology's
    collective.

    batch leaves are (C, tau, B, ...), numpy arrays or tensors (or, for a
    slab state, already its block's rows). The round's noise
    is drawn in one ``counter_rng`` launch at the state's key: the whole
    (C, tau, N), or a slab state's own (block, tau, N_local) addresses
    of it (:func:`repro_torch.core.fl.draw_round_noise`), and a slab state
    runs its engine's slab round. Under an aggregation pipeline the round
    draws its participation mask, noise and compressor operand
    (:func:`repro_torch.core.fl.draw_pipeline_round`), brings the mask to
    the host (the round's one sync) and charges rho to the participants
    only. Returns the successor state and a metrics record whose metric
    values are 0-d device tensors (:func:`materialize_record` turns them
    into floats). Raises :class:`BudgetExceeded` (state untouched) when
    ``check_budgets`` and the round would overrun ``c_th`` / ``eps_th``."""
    if check_budgets:
        which = exceeds_budgets(spec, state)
        if which is not None:
            _raise_budget(which, spec)
    dev = _device_of(state)
    lay = state.layout
    batch = _batch_on(state, batch, dev)
    sig = _sigmas_on(spec, state, dev)
    per_round = round_rho_charges(spec)
    pipe = spec.aggregation_pipeline()
    residual = state.residual
    kw = {} if lay is None else {"slab": lay}
    fn = round_fn_for(spec) if lay is None else partial(
        slab_round_fn_for(spec), lay)
    if pipe is not None:
        mask, noise, agg_rand, key = draw_pipeline_round(
            state.key, state.params, spec.tau, pipe, **kw)
        mask_np = mask.cpu().numpy()
        new_p, new_s, residual, ms = fn(
            state.params, state.opt_state, batch, noise, sig,
            mask if lay is None else lay.take(mask), state.residual,
            agg_rand)
        rho = state.rho + np.where(mask_np > 0, per_round, 0.0)
        n_participants = int(mask_np.sum())
    else:
        noise, key = draw_round_noise(state.key, state.params, spec.tau,
                                      **kw)
        new_p, new_s, ms = fn(state.params, state.opt_state, batch, noise,
                              sig)
        rho = state.rho + per_round
        n_participants = spec.n_clients
    new_state = state.replace(
        params=new_p, opt_state=new_s, key=key, residual=residual, rho=rho,
        steps=state.steps + spec.tau,
        resource_spent=state.resource_spent + spec.round_cost(),
        rounds_done=state.rounds_done + 1)
    rec = dict(ms)                 # lazy: 0-d device tensors, no sync
    rec["round"] = new_state.rounds_done
    rec["iterations"] = new_state.rounds_done * spec.tau
    rec["max_epsilon"] = zcdp_to_dp(float(np.max(rho)), spec.delta)
    rec["resource_spent"] = new_state.resource_spent
    rec["participants"] = float(n_participants)
    return new_state, rec


def _batch_on(state: FLState, batch, dev, axis: int = 0):
    """A round's (or, ``axis`` 1, a chunk's) batch on the device: a slab
    state's block rows of it (taken on the host, so only they go up),
    unless its client axis holds the block's rows already (where the block
    is all C clients, taking them again reads the same rows)."""
    lay = state.layout
    if (lay is not None and int(tree_leaves(batch)[0].shape[axis])
            == lay.n_clients):
        batch = lay.take(batch, axis)
    return tree_from_numpy(batch, dev)


def _sigmas_on(spec: FederationSpec, state: FLState, dev) -> torch.Tensor:
    sig = sigmas_for(spec, dev)
    return sig if state.layout is None else state.layout.take(sig)


def run_rounds(spec: FederationSpec, state: FLState, batches: Any,
               n_rounds: int | None = None, check_budgets: bool = True,
               prefetch: Callable[[], None] | None = None
               ) -> tuple[FLState, list[dict]]:
    """A chunk of R rounds in one call, equal to R sequential
    :func:`run_round` calls (the same noise draws in the same order).

    ``batches`` leaves are (R, C, tau, B, ...) (see :func:`round_batches`;
    for a slab state, or its (R, block, ...) rows already); a slab state
    runs the chunk on its slab.
    ``prefetch()``, if given, runs after the chunk is enqueued, so callers
    build the next chunk's host batches while the device computes. If it
    raises, :class:`PrefetchFailed` carries the completed state and
    records. Under an aggregation pipeline the chunk draws each round's
    mask inside its loop and the stacked (R, C) masks come to the host once,
    after ``prefetch``, to replay the conditional ledger. Raises
    BudgetExceeded (state untouched) when ``check_budgets`` and any of the
    R rounds could overrun a budget (a worst-case projection: exact for
    full participation, conservative under partial participation)."""
    lead = int(tree_leaves(batches)[0].shape[0])
    if n_rounds is None:
        n_rounds = lead
    if n_rounds <= 0:
        raise ValueError(f"n_rounds must be positive, got {n_rounds}")
    if n_rounds != lead:
        raise ValueError(f"n_rounds={n_rounds} != stacked batches leading "
                         f"axis {lead}")
    if check_budgets:
        ok, which = rounds_within_budgets(spec, state, n_rounds)
        if ok < n_rounds:
            _raise_budget(which, spec)
    dev = _device_of(state)
    lay = state.layout
    fn = chunked_round_fn_for(spec, slab=lay is not None)
    batches = _batch_on(state, batches, dev, axis=1)
    sig = _sigmas_on(spec, state, dev)
    residual = state.residual
    if spec.has_pipeline():
        new_p, new_s, key, residual, ms, masks = fn(
            state.params, state.opt_state, batches, state.key, sig,
            state.residual, slab=lay)
    else:
        new_p, new_s, key, ms = fn(state.params, state.opt_state, batches,
                                   state.key, sig, slab=lay)
        masks = None
    prefetch_exc = None
    if prefetch is not None:
        try:
            prefetch()
        except Exception as e:        # noqa: BLE001 — re-raised below
            prefetch_exc = e
    if masks is None:
        participants = np.full((n_rounds,), float(spec.n_clients))
    else:
        masks = masks.cpu().numpy()             # the chunk's one sync
        participants = masks.sum(axis=1)
    # exact ledger replay at the chunk boundary
    acc = accountant_view(spec, state)
    worst_rho = acc.step_many([spec.tau] * n_rounds, masks=masks,
                              q=spec.accounting_q())
    rho = np.asarray([acc.rho(m) for m in range(spec.n_clients)], np.float64)
    recs = []
    spent = state.resource_spent
    for r in range(n_rounds):
        spent = spent + spec.round_cost()   # repeated add: bit-identical to
        #   the per-round driver's accumulation
        rec = {k: v[r] for k, v in ms.items()}      # lazy 0-d device slices
        rec["round"] = state.rounds_done + r + 1
        rec["iterations"] = (state.rounds_done + r + 1) * spec.tau
        rec["max_epsilon"] = zcdp_to_dp(float(worst_rho[r]), spec.delta)
        rec["resource_spent"] = spent
        rec["participants"] = float(participants[r])
        recs.append(rec)
    new_state = state.replace(
        params=new_p, opt_state=new_s, key=key, residual=residual, rho=rho,
        steps=state.steps + n_rounds * spec.tau,
        resource_spent=spent,
        rounds_done=state.rounds_done + n_rounds)
    if prefetch_exc is not None:
        raise PrefetchFailed(prefetch_exc, new_state, recs) from prefetch_exc
    return new_state, recs


def materialize_record(rec: dict) -> dict:
    """Force the device-resident metric values of a round record to host
    floats (the drivers' one deliberate sync point)."""
    return {k: (v if isinstance(v, (bool, int, float, str)) else float(v))
            for k, v in rec.items()}


# ---------------------------------------------------------------------------
# data plumbing + budget-aware driver
# ---------------------------------------------------------------------------

def round_batch(spec: FederationSpec, sampler: Callable, rng) -> Any:
    """Stack per-client samples into the (C, tau, B, ...) numpy round batch.
    ``sampler(client, tau, rng)`` returns one client's (tau, B, ...) tree."""
    per_client = [sampler(m, spec.tau, rng) for m in range(spec.n_clients)]
    return tree_map(lambda *xs: np.stack(xs), *per_client)


def round_batches(spec: FederationSpec, sampler: Callable, rng,
                  n_rounds: int) -> Any:
    """Stack ``n_rounds`` round batches into the (R, C, tau, B, ...) chunk
    operand of :func:`run_rounds`, drawing from ``rng`` in the order of
    ``n_rounds`` sequential :func:`round_batch` calls."""
    rounds = [round_batch(spec, sampler, rng) for _ in range(n_rounds)]
    return tree_map(lambda *xs: np.stack(xs), *rounds)


def collapse_clients(params: Any, topology: str) -> Any:
    """Client-stacked params -> the single eval model: any replica after
    full averaging, the cross-client mean under local_only."""
    if topology == "full_average":
        return tree_map(lambda x: x[0], params)
    return tree_mean_over_axis0(params)


def eval_params(spec: FederationSpec, state: FLState) -> Any:
    """The single evaluation model for ``spec``'s topology, whole. A slab
    state's is alike on every rank of its mesh
    (:func:`repro_torch.mesh.engine.slab_eval_model`: a collective)."""
    if state.layout is not None:
        from repro_torch.mesh.engine import slab_eval_model
        return slab_eval_model(state.layout, state.params, spec.topology)
    return collapse_clients(state.params, spec.topology)


def budget_train_loop(*, state, max_rounds: int, eval_fn: Callable | None,
                      eval_every: int, history: list[dict],
                      chunk_rounds: int,
                      rounds_done: Callable[[Any], int],
                      exceeds: Callable[[Any], bool],
                      safe_rounds: Callable[[Any, int], int],
                      run_single: Callable[[Any], tuple],
                      build_chunk: Callable[[int, int], Any],
                      run_chunk: Callable[..., tuple],
                      run_tail: Callable[[Any, Any, int], tuple],
                      eval_model: Callable[[Any], Any]) -> tuple[Any, dict]:
    """The budget-aware driver loop, parameterized over an opaque ``state``
    and an opaque prepared ``chunk``:

        rounds_done(state) -> int          completed-round counter
        exceeds(state) -> bool             would one more round overrun?
        safe_rounds(state, cap) -> int     certain-to-fit round count
        run_single(state) -> (state, rec)  one round, building its own batch
        build_chunk(start, n) -> chunk     host-build n rounds from ``start``
        run_chunk(state, chunk, n, prefetch) -> (state, recs)
        run_tail(state, chunk, r) -> (state, rec)   row r of chunk, per round
        eval_model(state) -> params        the eval_fn operand

    Tracks theta* = argmin of the evaluated loss (the paper uses the best
    model among K iterations); appends materialized records to ``history``;
    returns (state, best).
    """
    best = {"loss": float("inf"), "round": 0}

    def track_best(rec: dict, evaluated: bool):
        nonlocal best
        if eval_fn is None:
            # an async flush that no participant reached reports no loss
            crit = rec.get("loss", float("inf"))
        elif evaluated:
            crit = rec["eval_loss"]
        else:
            crit = float("inf")
        if crit < best["loss"]:
            best = {**rec, "loss": crit, "round": rec["round"]}

    if chunk_rounds <= 1:
        while rounds_done(state) < max_rounds:
            if exceeds(state):
                break
            state, rec = run_single(state)
            rec = materialize_record(rec)
            history.append(rec)
            evaluated = False
            if eval_fn is not None and rounds_done(state) % eval_every == 0:
                rec.update(eval_fn(eval_model(state)))
                evaluated = True
            track_best(rec, evaluated)
        return state, best

    pending = None            # double buffer: (chunk, n) prefetched
    while rounds_done(state) < max_rounds:
        cap = min(2 * chunk_rounds, max_rounds - rounds_done(state))
        safe = safe_rounds(state, cap)
        if pending is not None:
            # prefetched chunks were sized by the post-chunk projection, so
            # they always fit; run them whole to keep the sampler stream
            # aligned with the per-round driver
            chunk, n = pending
            pending = None
        elif safe == 0:
            break
        else:
            n = min(chunk_rounds, safe)
            chunk = build_chunk(rounds_done(state), n)
        next_n = min(chunk_rounds, safe - n,
                     max_rounds - rounds_done(state) - n)
        next_start = rounds_done(state) + n

        def build_next(next_n=next_n, next_start=next_start):
            nonlocal pending
            if next_n > 0:
                pending = (build_chunk(next_start, next_n), next_n)

        deferred = None
        if n < chunk_rounds:
            # tail chunk (budget/max_rounds edge): drive the rows through
            # the per-round path
            recs = []
            for r in range(n):
                state, rec = run_tail(state, chunk, r)
                recs.append(rec)
        else:
            try:
                state, recs = run_chunk(state, chunk, n, build_next)
            except PrefetchFailed as pf:
                # keep the completed chunk, re-raise the sampler's error
                # after recording it
                state, recs, deferred = pf.state, pf.records, pf.__cause__
        recs = [materialize_record(r) for r in recs]
        history.extend(recs)
        evaluated = False
        if eval_fn is not None and (
                rounds_done(state) // eval_every
                > (rounds_done(state) - n) // eval_every):
            # an eval was due mid-chunk: run it once, at the boundary
            recs[-1].update(eval_fn(eval_model(state)))
            evaluated = True
        for rec in recs[:-1]:
            track_best(rec, False)
        track_best(recs[-1], evaluated)
        if deferred is not None:
            raise deferred
    return state, best


def train(spec: FederationSpec, state: FLState, sampler: Callable,
          max_rounds: int = 10_000, eval_fn: Callable | None = None,
          eval_every: int = 1, rng=None,
          history: list[dict] | None = None,
          chunk_rounds: int = 1) -> tuple[FLState, dict]:
    """Run rounds until a budget (resource or privacy) would be exceeded.

    Returns (final_state, summary) with best/rounds/resource_spent/
    max_epsilon/history. ``chunk_rounds=R > 1`` drives training in
    :func:`run_rounds` chunks, the next chunk's batches built and moved to
    the device while the current one runs; chunks are sized by
    :func:`rounds_within_budgets`, so no round runs that the per-round
    driver would refuse. ``eval_fn`` then runs at chunk boundaries only.
    """
    if rng is None:
        rng = np.random.default_rng(spec.seed)
    history = [] if history is None else history
    dev = _device_of(state)
    # a slab state's chunks hold its block's rows only
    take = ((lambda b: b) if state.layout is None
            else partial(state.layout.take, axis=1))
    state, best = budget_train_loop(
        state=state, max_rounds=max_rounds, eval_fn=eval_fn,
        eval_every=eval_every, history=history, chunk_rounds=chunk_rounds,
        rounds_done=lambda s: s.rounds_done,
        exceeds=lambda s: exceeds_budgets(spec, s) is not None,
        safe_rounds=lambda s, cap: rounds_within_budgets(spec, s, cap)[0],
        run_single=lambda s: run_round(
            spec, s, round_batch(spec, sampler, rng), check_budgets=False),
        build_chunk=lambda start, n: tree_from_numpy(
            take(round_batches(spec, sampler, rng, n)), dev),
        run_chunk=lambda s, chunk, n, prefetch: run_rounds(
            spec, s, chunk, n, check_budgets=False, prefetch=prefetch),
        run_tail=lambda s, chunk, r: run_round(
            spec, s, tree_map(lambda x: x[r], chunk), check_budgets=False),
        eval_model=lambda s: eval_params(spec, s))
    return state, {
        "best": best, "rounds": state.rounds_done,
        "resource_spent": state.resource_spent,
        "max_epsilon": max_epsilon(spec, state),
        "history": history,
    }


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def save_state(directory: str, state: FLState,
               extra: dict | None = None) -> None:
    """Persist an FLState (arrays + accountant snapshot) to ``directory``,
    in the JAX package's checkpoint layout. ``key`` is the port's counter
    generator's ``(seed, counter)``, not a JAX key. A slab state is
    gathered whole once (:func:`whole_state`, every rank of the mesh
    calls this) and rank 0 writes, so the checkpoint is the same as a whole
    run's and loads into either layout."""
    state = whole_state(state)
    meta = {
        "rho": [float(r) for r in state.rho],
        "steps": int(state.steps),
        "resource_spent": float(state.resource_spent),
        "rounds_done": int(state.rounds_done),
        **(extra or {}),
    }
    arrays = {"params": state.params, "opt_state": state.opt_state,
              "key": state.key}
    if state.residual is not None:
        arrays["residual"] = state.residual
    save_checkpoint(directory, arrays, step=state.rounds_done, extra=meta)


def load_state(directory: str, like: FLState) -> tuple[FLState, dict]:
    """Restore an FLState saved by :func:`save_state` onto ``like``'s
    device. ``like`` supplies the structure (e.g. a fresh ``init_state``);
    a slab ``like`` takes its own slab of the stored whole trees on each
    rank. Returns (state, extra) with any caller metadata passed to
    save_state."""
    like_tree = {"params": like.params, "opt_state": like.opt_state,
                 "key": like.key}
    # ask for the residual only when both sides have one: a dense-trained
    # checkpoint resumed under a compressor keeps like's zero residual, a
    # compressed checkpoint resumed dense drops it
    has_residual = any(p == "residual" or p.startswith("residual/")
                       for p in checkpoint_leaf_paths(directory))
    if like.residual is not None and has_residual:
        like_tree["residual"] = like.residual
    tree, _, extra = load_checkpoint(directory, like=like_tree)
    dev = _device_of(like)
    lay = like.layout
    if lay is not None:
        from repro_torch.mesh.engine import to_slab
        tree["params"] = to_slab(lay, tree["params"], lay.param_dims)
        tree["opt_state"] = to_slab(lay, tree["opt_state"], lay.state_dims)
        if "residual" in tree:      # pad rows carry no residual
            tree["residual"] = (lay.take(tree["residual"])
                                * np.asarray(lay.valid, np.float32)[:, None])
    state = like.replace(
        params=tree_from_numpy(tree["params"], dev),
        opt_state=tree_from_numpy(tree["opt_state"], dev),
        key=torch.as_tensor(tree["key"]),
        residual=(tree_from_numpy(tree["residual"], dev)
                  if "residual" in tree else like.residual),
        rho=np.asarray(extra["rho"], np.float64),
        steps=int(extra["steps"]),
        resource_spent=float(extra["resource_spent"]),
        rounds_done=int(extra["rounds_done"]))
    return state, extra
