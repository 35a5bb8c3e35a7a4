"""Convergence analysis of DP-PASGD (paper §6, Theorem 1).

Theorem 1: under L-smoothness, lambda-strong convexity, unbiased gradients
with variance bound xi^2, learning rate satisfying
    eta L + eta^2 L^2 tau (tau - 1) <= 1,
after K iterations (K divisible by tau):

    E[ L(theta*) - L* ] <= (1 - eta lam)^K (alpha - B) / K + B

with  B = [eta L + eta^2 L^2 (tau - 1) M] / (2 lam M) * (xi^2 + d/M sum_m sigma_m^2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ProblemConstants:
    """Estimated problem constants (paper §8.1 estimates these beforehand)."""
    eta: float       # learning rate
    lam: float       # strong-convexity constant lambda
    lip: float       # gradient-Lipschitz constant L
    alpha: float     # initial optimality gap L(theta^0) - L*
    xi2: float       # mini-batch gradient variance bound xi^2
    dim: int         # model dimension d
    n_clients: int   # M

    def lr_constraint_ok(self, tau: float) -> bool:
        """Eq. (21e): eta L + eta^2 L^2 tau(tau-1) <= 1."""
        e, L = self.eta, self.lip
        return e * L + e * e * L * L * tau * (tau - 1.0) <= 1.0 + 1e-12

    def tau_max(self) -> float:
        """Largest tau satisfying Eq. (21e)."""
        e, L = self.eta, self.lip
        a = e * e * L * L
        if a == 0:
            return math.inf
        c = e * L - 1.0
        # a tau^2 - a tau + c <= 0  ->  tau <= (a + sqrt(a^2 - 4 a c)) / (2a)
        disc = a * a - 4.0 * a * c
        if disc < 0:
            return 1.0
        return (a + math.sqrt(disc)) / (2.0 * a)


def noise_term(consts: ProblemConstants, sigmas2: Sequence[float]) -> float:
    """xi^2 + (d / M) * sum_m sigma_m^2   (the variance payload of B)."""
    return consts.xi2 + consts.dim / consts.n_clients * float(sum(sigmas2))


def bound_b(consts: ProblemConstants, tau: float, sigmas2: Sequence[float]) -> float:
    """Eq. (13): the asymptotic error floor B."""
    e, L, lam, M = consts.eta, consts.lip, consts.lam, consts.n_clients
    pref = (e * L + e * e * L * L * (tau - 1.0) * M) / (2.0 * lam * M)
    return pref * noise_term(consts, sigmas2)


def theorem1_bound(consts: ProblemConstants, k: int, tau: float,
                   sigmas2: Sequence[float]) -> float:
    """Eq. (12): expected optimality gap after K iterations."""
    if k < 1:
        raise ValueError("K must be >= 1")
    b = bound_b(consts, tau, sigmas2)
    decay = (1.0 - consts.eta * consts.lam) ** k
    return decay * (consts.alpha - b) / k + b


def reduces_to_distributed_sgd(consts: ProblemConstants, k: int) -> float:
    """Sanity helper: tau=1, sigma=0 recovers the distributed-SGD bound."""
    return theorem1_bound(consts, k, tau=1.0, sigmas2=[0.0] * consts.n_clients)
