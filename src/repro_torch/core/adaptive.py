"""Beyond-paper extension: adaptive re-solving of the DP-PASGD design. A
copy of the JAX package's ``repro/core/adaptive.py`` over the port's
``core/design`` and ``core/privacy`` (float64 host math, so the plans are
the JAX package's bit for bit).

The paper picks (K, tau, sigma) ONCE from constants estimated before
training (§8.1). Those estimates (alpha, xi^2, lambda) are exactly the
quantities a running federation observes, so re-solving the design problem
on the REMAINING budgets mid-run adapts tau as the loss landscape reveals
itself (cf. Wang & Joshi's adaptive communication, paper ref [33], but
driven by the paper's own Theorem-1 surrogate and privacy accounting).

Privacy correctness: the total zCDP of a run with per-phase noise sigma_i
over k_i steps is sum_i k_i * 2G^2/(X^2 sigma_i^2) (Lemma 1); the
accountant tracks it exactly, and each re-solve budgets only the REMAINING
rho, so eps_th is never exceeded however often the run re-plans.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

from repro_torch.core.convergence import ProblemConstants
from repro_torch.core.design import DesignProblem, DesignSolution
from repro_torch.core.privacy import rho_budget


@dataclass
class AdaptivePlan:
    solution: DesignSolution
    remaining_eps_equiv: float     # eps-budget equivalent of remaining rho
    remaining_c: float
    phase: int


class AdaptiveDesigner:
    """Re-solves the optimal design on remaining (resource, privacy) budget.

    Usage:
        designer = AdaptiveDesigner(problem)
        plan = designer.replan(fed.accountant, resource_spent, observed)
        -> run plan.solution.tau-sized rounds with plan.solution.sigmas
    """

    def __init__(self, problem: DesignProblem):
        self.problem = problem
        self.phase = 0

    def _remaining_eps(self, accountant) -> float:
        """Convert remaining rho budget back to an eps budget (invert
        Lemma 3 on the unspent part)."""
        delta = self.problem.delta
        rho_total = rho_budget(self.problem.eps_th, delta)
        rho_spent = max((accountant.rho(m) for m in accountant.batch_sizes),
                        default=0.0)
        left = max(rho_total - rho_spent, 0.0)
        ld = math.log(1.0 / delta)
        return left + 2.0 * math.sqrt(left * ld)

    def replan(self, accountant, resource_spent: float,
               observed: dict | None = None) -> AdaptivePlan:
        """observed may update {"alpha": current loss gap, "xi2": ..., "lam": ...}."""
        consts = self.problem.consts
        if observed:
            consts = ProblemConstants(
                eta=consts.eta,
                lam=float(observed.get("lam", consts.lam)),
                lip=float(observed.get("lip", consts.lip)),
                alpha=float(observed.get("alpha", consts.alpha)),
                xi2=float(observed.get("xi2", consts.xi2)),
                dim=consts.dim, n_clients=consts.n_clients)
        eps_left = self._remaining_eps(accountant)
        c_left = max(self.problem.c_th - resource_spent, 0.0)
        sub = replace(self.problem, consts=consts, eps_th=max(eps_left, 1e-6),
                      c_th=max(c_left, 1.0))
        sol = sub.solve()
        self.phase += 1
        return AdaptivePlan(solution=sol, remaining_eps_equiv=eps_left,
                            remaining_c=c_left, phase=self.phase)
