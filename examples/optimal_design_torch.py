"""Optimal schematic design walk-through (paper §5-§7) on the PyTorch
port's host modules.

The same table as ``examples/optimal_design.py``: how the solver trades tau
against K and sigma as budgets move, beside brute-force grid search on the
Theorem-1 surrogate. The design is float64 host math (no device), bit for
bit the JAX package's.

Run:  PYTHONPATH=src python examples/optimal_design_torch.py
"""
from repro_torch.core.convergence import ProblemConstants
from repro_torch.core.design import (
    DesignProblem,
    ResourceModel,
    grid_search_reference,
)

consts = ProblemConstants(eta=0.05, lam=0.3, lip=1.5, alpha=2.0, xi2=0.4,
                          dim=82, n_clients=16)
resource = ResourceModel(c1=100.0, c2=1.0)

print(f"{'C_th':>6} {'eps_th':>7} | {'K*':>6} {'tau*':>5} {'sigma*':>8} "
      f"{'bound':>9} | {'grid tau':>8} {'grid bound':>10}")
for c_th in (300.0, 1000.0, 3000.0):
    for eps in (1.0, 4.0, 10.0):
        p = DesignProblem(consts=consts, resource=resource, clip_norm=1.0,
                          batch_sizes=[32] * 16, delta=1e-4, eps_th=eps,
                          c_th=c_th)
        sol = p.solve()
        gt, gk, gb = grid_search_reference(p, taus=range(1, 25))
        print(f"{c_th:6.0f} {eps:7.1f} | {sol.k:6d} {sol.tau:5d} "
              f"{sol.sigmas[0]:8.4f} {sol.predicted_bound:9.4f} | "
              f"{gt:8d} {gb:10.4f}")

print("\nclaims (paper §8.5): tau* falls as C_th rises; tau* rises with eps")
