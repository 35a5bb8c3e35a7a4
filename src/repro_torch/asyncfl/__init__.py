"""repro_torch.asyncfl — buffered asynchronous federation (FedBuff-style).

The execution-side answer to IoT fleet heterogeneity: clients train on
simulated device clocks (:mod:`repro_torch.asyncfl.clock`), the server
aggregates the first B arrivals per flush with staleness-weighted updates
and immediately redispatches (:mod:`repro_torch.asyncfl.engine`), and
privacy is pre-charged at dispatch time so the zCDP budget probe is never
outrun by a straggler (:mod:`repro_torch.asyncfl.runtime`). Select it with
``FederationSpec(engine="async_buffered", buffer_size=B,
staleness_alpha=...)`` and drive with :func:`init_async_state` (on the GPU
unless ``device=`` says otherwise) / :func:`run_async_cycle` /
:func:`train_async` (the sync ``run_round`` / ``train`` have no async form;
see ``repro_torch.api.engines.round_fn_for``).
"""
from repro_torch.asyncfl.clock import (
    LATENCY_PROFILES,
    HeteroLatency,
    LatencyModel,
    LognormalLatency,
    UniformLatency,
    latency_profile,
    sync_round_duration,
)
from repro_torch.asyncfl.engine import AsyncBufferedExecutor, executor_for
from repro_torch.asyncfl.events import EventView, earliest_arrivals
from repro_torch.asyncfl.runtime import (
    AsyncState,
    ScheduleRow,
    async_accountant_view,
    async_eval_params,
    async_flush_cost,
    async_flush_cost_bound,
    dispatched_epsilon,
    dispatched_rho,
    exceeds_async_budgets,
    flushes_within_budgets,
    init_async_state,
    load_async_state,
    polynomial_staleness,
    run_async_cycle,
    save_async_state,
    train_async,
)

__all__ = [
    "LATENCY_PROFILES",
    "AsyncBufferedExecutor",
    "AsyncState",
    "EventView",
    "HeteroLatency",
    "LatencyModel",
    "LognormalLatency",
    "ScheduleRow",
    "UniformLatency",
    "async_accountant_view",
    "async_eval_params",
    "async_flush_cost",
    "async_flush_cost_bound",
    "dispatched_epsilon",
    "dispatched_rho",
    "earliest_arrivals",
    "exceeds_async_budgets",
    "executor_for",
    "flushes_within_budgets",
    "init_async_state",
    "latency_profile",
    "load_async_state",
    "polynomial_staleness",
    "run_async_cycle",
    "save_async_state",
    "sync_round_duration",
    "train_async",
]
