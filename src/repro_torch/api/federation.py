"""Back-compat mutable driver over the pure functional core: the port of
the JAX package's ``repro/api/federation.py``.

:class:`Federation` keeps the historic surface (construct from FLConfig +
arrays, ``.round()``, ``.train(budgets)``, ``.params`` / ``.accountant`` /
``.history`` attributes) while delegating every round to
``repro_torch.api.state.run_round``. New code should use
:class:`FederationSpec` + ``init_state`` / ``run_round`` / ``train``
directly. It runs on the GPU unless ``device`` names another device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.api import state as api_state
from repro_torch.api.spec import FederationSpec
from repro_torch.core.fl import Budgets, FLConfig
from repro_torch.optim.optimizers import Optimizer


@dataclass
class Federation:
    """Coordinates clients, the round engine, and the privacy accountant.

    ``sampler(client, tau, rng) -> batch pytree with leading axes (tau, B)``

    Thin wrapper: all state lives in ``self.state`` (an
    :class:`FLState`); the attributes below are views over it. Under
    ``engine="shard_map"`` or ``"mesh_2d"`` on a world of several ranks
    ``params`` and ``opt_state`` are this rank's slab (its client block's
    rows of its model slices, none outside the mesh);
    ``repro_torch.api.whole_state(fed.state)`` reads them whole.
    """
    cfg: FLConfig
    loss_fn: Callable
    optimizer: Optimizer
    params0: Any                              # single-replica init (no C axis)
    sampler: Callable[[int, int, np.random.Generator], Any]
    sigmas: np.ndarray                        # (C,) per-step noise std
    delta: float = 1e-4
    batch_sizes: list[int] = field(default_factory=list)  # X_m per client
    seed: int = 0
    engine: str | None = None                 # None -> derive from cfg
    topology: str = "full_average"
    device: Any = None                        # None -> the GPU

    def __post_init__(self):
        c = self.cfg.n_clients
        engine = self.engine or ("vmap" if self.cfg.vmap_clients else "map")
        self.spec = FederationSpec(
            n_clients=c, tau=self.cfg.tau, loss_fn=self.loss_fn,
            optimizer=self.optimizer, topology=self.topology, engine=engine,
            kernel_backend=self.cfg.kernel_backend,
            dp=self.cfg.dp, clip_norm=self.cfg.clip_norm,
            num_microbatches=self.cfg.num_microbatches,
            vmap_microbatches=self.cfg.vmap_microbatches,
            grad_accumulate=self.cfg.grad_accumulate,
            average_opt_state=self.cfg.average_opt_state,
            sigmas=tuple(float(s) for s in np.asarray(self.sigmas)),
            batch_sizes=tuple(self.batch_sizes) if self.batch_sizes
            else (1,) * c,
            delta=self.delta, seed=self.seed)
        self.state = api_state.init_state(self.spec, self.params0,
                                          self.device)
        self.accountant = api_state.accountant_view(self.spec, self.state)
        self._rng = np.random.default_rng(self.seed)
        self.history: list[dict] = []

    # -- state views ---------------------------------------------------------
    @property
    def params(self):
        return self.state.params

    @params.setter
    def params(self, value):
        self.state = self.state.replace(params=value)

    @property
    def opt_state(self):
        return self.state.opt_state

    @opt_state.setter
    def opt_state(self, value):
        self.state = self.state.replace(opt_state=value)

    @property
    def rounds_done(self) -> int:
        return self.state.rounds_done

    @property
    def resource_spent(self) -> float:
        return self.state.resource_spent

    def _sync_accountant(self) -> None:
        for m in range(self.spec.n_clients):
            self.accountant._rho[m] = float(self.state.rho[m])
        self.accountant.steps = self.state.steps

    def restore(self, state: api_state.FLState,
                history: list[dict] | None = None) -> None:
        """Adopt a checkpointed FLState (see repro_torch.checkpoint)."""
        self.state = state
        if history is not None:
            self.history = list(history)
        self._sync_accountant()

    # -- training ------------------------------------------------------------
    def round(self) -> dict:
        """One unconditional round (no budget check).

        Historic semantics: resources are only charged inside ``train``,
        where the caller's Budgets set the prices, so the Eq.-8 cost
        accrued by run_round at the spec's default c1/c2 is rolled back.
        """
        batch = api_state.round_batch(self.spec, self.sampler, self._rng)
        spent = self.state.resource_spent
        self.state, rec = api_state.run_round(self.spec, self.state, batch,
                                              check_budgets=False)
        rec = api_state.materialize_record(rec)
        self.state = self.state.replace(resource_spent=spent)
        rec["resource_spent"] = spent
        self._sync_accountant()
        self.history.append(rec)
        return rec

    def round_cost(self, budgets: Budgets) -> float:
        """Eq. (8) per round: c1 + c2 * tau."""
        return budgets.c1 + budgets.c2 * self.cfg.tau

    def train(self, budgets: Budgets, max_rounds: int = 10_000,
              eval_fn: Callable | None = None, eval_every: int = 1) -> dict:
        """Run rounds until a budget (resource or privacy) would be exceeded.

        Tracks theta* = argmin of the evaluated loss (paper uses the best
        model among K iterations).
        """
        spec = self.spec.replace(c_th=budgets.c_th, eps_th=budgets.eps_th,
                                 c1=budgets.c1, c2=budgets.c2)
        self.state, out = api_state.train(
            spec, self.state, self.sampler, max_rounds=max_rounds,
            eval_fn=eval_fn, eval_every=eval_every, rng=self._rng,
            history=self.history)
        self._sync_accountant()
        return out
