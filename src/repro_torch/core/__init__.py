"""DP-PASGD core. ``privacy``, ``convergence`` and ``design`` are numpy and
``math`` copies of the JAX package's modules (the port may not import it),
so the ledgers and the design come out bit for bit the same."""
from repro_torch.core.clipping import (
    clip_tree,
    make_dp_grad_fn,
    make_plain_grad_fn,
)
from repro_torch.core.convergence import (
    ProblemConstants,
    bound_b,
    theorem1_bound,
)
from repro_torch.core.design import (
    DesignProblem,
    DesignSolution,
    ResourceModel,
    grid_search_reference,
)
from repro_torch.core.fl import FLConfig, design_sigmas, make_round_step
from repro_torch.core.privacy import (
    PrivacyAccountant,
    compose_zcdp,
    epsilon_after_k,
    gaussian_zcdp,
    grad_sensitivity,
    privacy_z,
    sigma_star,
    zcdp_to_dp,
)

__all__ = [
    "clip_tree", "make_dp_grad_fn", "make_plain_grad_fn",
    "ProblemConstants", "bound_b", "theorem1_bound",
    "DesignProblem", "DesignSolution", "ResourceModel", "grid_search_reference",
    "FLConfig", "design_sigmas", "make_round_step",
    "PrivacyAccountant", "compose_zcdp", "epsilon_after_k", "gaussian_zcdp",
    "grad_sensitivity", "privacy_z", "sigma_star", "zcdp_to_dp",
]
