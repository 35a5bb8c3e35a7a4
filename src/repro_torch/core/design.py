"""Optimal schematic design of DP-PASGD (paper §5, §7).

Given per-device resource budget C_th and privacy budget eps_th, choose
(tau, K, {sigma_m}) minimizing the Theorem-1 surrogate objective (Eq. 21/24):

  - resource model (Eq. 8):   C = c1 K / tau + c2 K <= C_th
  - dF/dtau > 0  =>  resource constraint binds:  tau* = c1 K / (C_th - c2 K)
  - dF/dsigma^2 > 0  =>  privacy constraint binds:  sigma_m* from Eq. (23)
  - 1-D problem in K (Eq. 24), solved by projected gradient descent (paper's
    method) with a coarse grid warm-start for robustness; integers recovered
    by nearest-integer rounding (paper §7 heuristic).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.convergence import ProblemConstants, theorem1_bound
from repro_torch.core.privacy import rho_budget, sigma_star


@dataclass(frozen=True)
class ResourceModel:
    """Eq. (8): C = c1 * comm_scale * K / tau + c2 K.

    ``comm_scale`` extends the paper's model with the aggregation-pipeline
    knobs: ``wire_ratio * q`` (compression times participation,
    ``FederationSpec.comm_scale()``). Cheaper aggregations shift the Eq.-22
    binding tau* down — ``solve()`` co-designs tau against compression and
    participation for free. Default 1.0 is the paper's dense protocol.
    """
    c1: float  # communication cost of one dense full-cohort aggregation
    c2: float  # computation cost of one local update
    comm_scale: float = 1.0  # pipeline multiplier on c1 (wire_ratio * q)

    def _c1(self) -> float:
        return self.c1 * self.comm_scale

    def cost(self, k: float, tau: float) -> float:
        return self._c1() * k / tau + self.c2 * k

    def tau_binding(self, k: float, c_th: float) -> float:
        """Eq. (22): tau* that spends exactly the resource budget at K=k."""
        denom = c_th - self.c2 * k
        if denom <= 0:
            return math.inf
        return self._c1() * k / denom

    def k_max(self, c_th: float, tau: float) -> float:
        """Largest K affordable at aggregation period tau."""
        return c_th / (self._c1() / tau + self.c2)


@dataclass(frozen=True)
class DesignSolution:
    k: int
    tau: int
    sigmas: tuple[float, ...]       # per-client sigma_m*
    predicted_bound: float          # Theorem-1 surrogate at the solution
    cost: float                     # resource cost at the solution
    k_relaxed: float                # continuous optimum before rounding
    tau_relaxed: float


@dataclass(frozen=True)
class DesignProblem:
    consts: ProblemConstants
    resource: ResourceModel
    clip_norm: float                 # G
    batch_sizes: Sequence[int]       # X_m per client
    delta: float
    eps_th: float
    c_th: float

    # ---- Eq. (24) pieces -------------------------------------------------
    def _sigma2_sum(self, k: float) -> float:
        """sum_m (sigma_m*)^2 with corrected Eq. (23) substituted:
        2 K G^2 / (X_m^2 rho*), rho* = eps_th^2 / Z (see privacy.sigma_star)."""
        rho = rho_budget(self.eps_th, self.delta)
        g2 = self.clip_norm ** 2
        return sum(2.0 * k * g2 / (x * x * rho) for x in self.batch_sizes)

    def tau_of_k(self, k: float) -> float:
        """tau choice at K=k: binding value clamped to [1, tau_max]."""
        t = self.resource.tau_binding(k, self.c_th)
        return min(max(t, 1.0), self.consts.tau_max())

    def objective(self, k: float) -> float:
        """Relaxed Eq. (24) objective F(K) with tau*, sigma* substituted."""
        if k < 1.0:
            return math.inf
        tau = self.tau_of_k(k)
        if self.resource.cost(k, tau) > self.c_th * (1.0 + 1e-9):
            return math.inf
        c = self.consts
        sig2 = self._sigma2_sum(k)
        payload = c.xi2 + c.dim / c.n_clients * sig2
        pref = (c.eta * c.lip + c.eta ** 2 * c.lip ** 2 * (tau - 1.0) * c.n_clients) \
            / (2.0 * c.lam * c.n_clients)
        b = pref * payload
        decay = (1.0 - c.eta * c.lam) ** k
        return decay / k * (c.alpha - b) + b

    # ---- solver ----------------------------------------------------------
    def k_feasible_range(self) -> tuple[float, float]:
        r, c = self.resource, self.consts
        tau_hi = min(c.tau_max(), 1e6)
        k_hi = r.k_max(self.c_th, tau_hi)
        return 1.0, max(1.0, k_hi)

    def solve_relaxed(self, n_grid: int = 400, gd_iters: int = 200,
                      gd_lr: float | None = None) -> float:
        """Grid warm-start + projected gradient descent on K (paper §7)."""
        k_lo, k_hi = self.k_feasible_range()
        if k_hi <= k_lo:
            return k_lo
        # log-spaced grid warm start
        best_k, best_f = k_lo, self.objective(k_lo)
        for i in range(n_grid + 1):
            k = math.exp(math.log(k_lo) + (math.log(k_hi) - math.log(k_lo)) * i / n_grid)
            f = self.objective(k)
            if f < best_f:
                best_k, best_f = k, f
        # gradient descent refinement (central differences)
        k = best_k
        lr = gd_lr if gd_lr is not None else max(1.0, 0.01 * k)
        for _ in range(gd_iters):
            h = max(1e-3, 1e-4 * k)
            g = (self.objective(k + h) - self.objective(k - h)) / (2.0 * h)
            if not math.isfinite(g):
                break
            k_new = min(max(k - lr * g, k_lo), k_hi)
            if self.objective(k_new) > self.objective(k) - 1e-15:
                lr *= 0.5
                if lr < 1e-6:
                    break
                continue
            k = k_new
        return k if self.objective(k) <= best_f else best_k

    def solve(self) -> DesignSolution:
        k_rel = self.solve_relaxed()
        tau_rel = self.tau_of_k(k_rel)
        # paper §7: round to nearest integers; then repair feasibility.
        k = max(1, round(k_rel))
        tau = max(1, round(tau_rel))
        # keep K an integer multiple of tau (Theorem 1 assumption)
        k = max(tau, (k // tau) * tau)
        # repair: rounding down tau can overshoot the budget -> bump tau up
        guard = 0
        while self.resource.cost(k, tau) > self.c_th and guard < 10_000:
            if tau < self.consts.tau_max():
                tau += 1
            else:
                k = max(tau, k - tau)
            guard += 1
        sigmas = tuple(
            sigma_star(k, self.clip_norm, x, self.eps_th, self.delta)
            for x in self.batch_sizes
        )
        bound = theorem1_bound(self.consts, k, tau, [s * s for s in sigmas])
        return DesignSolution(
            k=k, tau=tau, sigmas=sigmas, predicted_bound=bound,
            cost=self.resource.cost(k, tau), k_relaxed=k_rel, tau_relaxed=tau_rel,
        )


def grid_search_reference(problem: DesignProblem, taus: Sequence[int],
                          ks_per_tau: int = 64) -> tuple[int, int, float]:
    """Brute-force (tau, K) search over the surrogate — the paper's comparison
    baseline (§8.3). Returns (tau, K, bound)."""
    best = (1, 1, math.inf)
    for tau in taus:
        if not problem.consts.lr_constraint_ok(tau):
            continue
        k_hi = problem.resource.k_max(problem.c_th, tau)
        if k_hi < tau:
            continue
        for i in range(1, ks_per_tau + 1):
            k = max(tau, int(k_hi * i / ks_per_tau) // tau * tau)
            sig2 = [
                sigma_star(k, problem.clip_norm, x, problem.eps_th, problem.delta) ** 2
                for x in problem.batch_sizes
            ]
            f = theorem1_bound(problem.consts, k, tau, sig2)
            if f < best[2]:
                best = (tau, k, f)
    return best
