"""Optimizers in the (init, update) gradient-transformation convention:
``update(grads, state, params)`` returns a *delta* to add to the params and
the next state. The step counter is an int32 tensor.

The paper's DP-PASGD update (Eq. 7a) is plain SGD; momentum and AdamW serve
the beyond-paper experiments. Every tensor built here from a host number is
float32, as JAX builds it with x64 off.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)


def _resolve_lr(lr, step):
    """The learning rate as an f32 tensor on the step's device; a constant
    is filled in place there (a host-to-device copy would block the host
    once per step)."""
    if callable(lr):
        return lr(step)
    return torch.full((), lr, dtype=torch.float32, device=step.device)


def _zero_step(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


class SgdState(NamedTuple):
    step: torch.Tensor


def sgd(lr) -> Optimizer:
    """theta <- theta - eta * g   (paper Eq. 7a)."""
    def init(params):
        return SgdState(step=_zero_step(params))

    def update(grads, state, params):
        eta = _resolve_lr(lr, state.step)
        upd = tree_map(lambda g, p: (-eta * g).to(p.dtype), grads, params)
        return upd, SgdState(step=state.step + 1)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    step: torch.Tensor
    velocity: Any


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return MomentumState(step=_zero_step(params),
                             velocity=tree_map(torch.zeros_like, params))

    def update(grads, state, params):
        eta = _resolve_lr(lr, state.step)
        vel = tree_map(lambda v, g: beta * v + g, state.velocity, grads)
        if nesterov:
            upd = tree_map(lambda v, g, p: (-eta * (beta * v + g)).to(p.dtype),
                           vel, grads, params)
        else:
            upd = tree_map(lambda v, p: (-eta * v).to(p.dtype), vel, params)
        return upd, MomentumState(step=state.step + 1, velocity=vel)

    return Optimizer(init, update)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def f32zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=_zero_step(params),
                          mu=tree_map(f32zeros, params),
                          nu=tree_map(f32zeros, params))

    def update(grads, state, params):
        step = state.step + 1
        eta = _resolve_lr(lr, state.step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
            state.nu, grads)
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)

        def _upd(m, v, p):
            mhat = m / bc1
            vhat = v / bc2
            delta = -eta * (mhat / (torch.sqrt(vhat) + eps)
                            + weight_decay * p.to(torch.float32))
            return delta.to(p.dtype)

        upd = tree_map(_upd, mu, nu, params)
        return upd, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)
