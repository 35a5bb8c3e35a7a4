"""``repro_torch.api``: the public entry point for running DP-PASGD on
PyTorch.

    from repro_torch.api import FederationSpec, init_state, train

    spec = FederationSpec(n_clients=16, tau=8, loss_fn=loss, optimizer=sgd(0.3),
                          sigmas=sigmas, batch_sizes=batch_sizes,
                          eps_th=4.0, c_th=1000.0)
    state = init_state(spec, params0)             # on the GPU
    state, out = train(spec, state, sampler, eval_fn=eval_fn)

or drive rounds yourself with ``run_round(spec, state, batch)``; budget
checks raise :class:`BudgetExceeded` before a round would overrun eps_th /
C_th. ``run_rounds`` runs a chunk of R rounds, equal to R ``run_round``
calls. ``init_state(..., device="cpu")`` runs on the CPU.

``FederationSpec(participation=0.5, compressor="qsgd")`` (or ``"topk"`` /
``"randk"``) runs the aggregation pipeline: a fresh participant set every
round, compressed error-fed updates (``FLState.residual``). ``save_state`` /
``load_state`` checkpoint a state. Under ``engine="mesh_2d"`` on a world
of several ranks a state is each rank's slab (its client block's rows and
model slices); ``whole_state`` reads it whole. :class:`Federation` is the
back-compat mutable wrapper over the same functions, and
``register_engine`` / ``get_engine`` the round-engine registry.
"""
from repro_torch.api.engines import (
    RoundEngine,
    available_engines,
    chunked_round_fn_for,
    get_engine,
    register_engine,
    resolve_engine,
    round_fn_for,
    slab_round_fn_for,
)
from repro_torch.api.federation import Federation
from repro_torch.api.spec import COMPRESSORS, ENGINES, FederationSpec
from repro_torch.core.aggregation import (
    AggregationPipeline,
    make_compressor,
    participation_mask,
)
from repro_torch.api.state import (
    BudgetExceeded,
    FLState,
    PrefetchFailed,
    accountant_view,
    budget_train_loop,
    collapse_clients,
    eval_params,
    exceeds_budgets,
    init_state,
    load_state,
    materialize_record,
    max_epsilon,
    peek_epsilon_fast,
    round_batch,
    round_batches,
    round_rho_charges,
    rounds_within_budgets,
    run_round,
    run_rounds,
    save_state,
    sigmas_for,
    slab_applies,
    train,
    whole_state,
)

__all__ = [
    "COMPRESSORS", "ENGINES", "FederationSpec",
    "AggregationPipeline", "make_compressor", "participation_mask",
    "RoundEngine", "available_engines", "chunked_round_fn_for", "get_engine",
    "register_engine", "resolve_engine", "round_fn_for",
    "slab_round_fn_for",
    "BudgetExceeded", "FLState", "PrefetchFailed", "accountant_view",
    "budget_train_loop", "collapse_clients", "eval_params",
    "exceeds_budgets", "init_state", "load_state", "materialize_record",
    "max_epsilon", "peek_epsilon_fast", "round_batch", "round_batches",
    "round_rho_charges", "rounds_within_budgets", "run_round", "run_rounds",
    "save_state", "sigmas_for", "slab_applies", "train", "whole_state",
    "Federation",
]
