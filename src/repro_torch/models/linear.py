"""The paper's convex models: logistic regression (Adult) and linear SVM
(Vehicle), with the loss functions of §8.1 (softmax cross-entropy and hinge
loss). Both are G-Lipschitz on unit-ball data, matching §4.

Params are ``{"w": (d, n_classes), "b": (n_classes,)}`` f32 tensors; a batch
is ``{"x": (B, d) f32, "y": (B,) int}``. The losses are pure functions of
their arguments, so ``torch.func`` can take their gradients and vmap them.

Under a model axis over 1 (:func:`repro_torch.models.sharding.model_group`)
``w`` is this rank's slice of the weight, placed by its hint ("fsdp",
"tp"), which the default rules resolve to ``d``: row-parallel, the rank's
columns of ``x`` times its rows of ``w``, the partial logits summed over
the ranks. ``b`` stays whole. The L2 term sums the squares of ``w`` over
the ranks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.sharding import model_dim, model_group, shard_hint
from repro_torch.utils.device import resolve_device


def init_linear(dim: int, n_classes: int = 2, seed: int = 0, device=None):
    """The JAX package's initial params, bit for bit (same numpy draw), on
    ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=0.01, size=(dim, n_classes)).astype(np.float32)
    return {"w": torch.as_tensor(w, device=dev),
            "b": torch.zeros((n_classes,), dtype=torch.float32, device=dev)}


def logits(params, x):
    w = shard_hint(params["w"], "fsdp", "tp")
    grp = model_group()
    dim = model_dim("fsdp", "tp")
    if grp is None or dim < 0:
        return x @ w + params["b"]
    if dim != 0:
        raise NotImplementedError(
            "the linear model's w split on its classes: the port's tensor "
            "parallelism covers the split the default mesh2d rules give "
            "(d_in)")
    return grp.reduce_out(grp.local_slice(x, -1) @ w) + params["b"]


def _w_sq(params):
    """sum(w ** 2) over the whole weight (summed over the model ranks
    when ``w`` is split)."""
    sq = torch.sum(params["w"] ** 2)
    grp = model_group()
    if grp is None or model_dim("fsdp", "tp") < 0:
        return sq
    return grp.reduce_out(sq)


def logreg_loss(params, batch, l2: float = 1e-4):
    """Softmax cross-entropy (paper: Adult logistic regression)."""
    z = logits(params, batch["x"])
    logp = torch.log_softmax(z, dim=-1)
    y = batch["y"].long()
    nll = -torch.take_along_dim(logp, y[:, None], dim=-1)
    reg = 0.5 * l2 * _w_sq(params)
    return torch.mean(nll) + reg


def svm_loss(params, batch, l2: float = 1e-4):
    """Binary hinge loss (paper: Vehicle linear SVM) on the margin of the
    positive-class score minus the negative-class score."""
    z = logits(params, batch["x"])
    margin = z[:, 1] - z[:, 0]
    y_pm = 2.0 * batch["y"].to(torch.float32) - 1.0
    hinge = torch.clamp(1.0 - y_pm * margin, min=0.0)
    reg = 0.5 * l2 * _w_sq(params)
    return torch.mean(hinge) + reg


def accuracy(params, x, y):
    pred = torch.argmax(logits(params, x), dim=-1)
    return torch.mean((pred == y).to(torch.float32))


def make_eval_fn(loss_fn, x, y):
    """eval_fn(params) -> {"eval_loss", "eval_acc"} as host floats. The eval
    set moves to the params' device at first use there."""
    x = np.asarray(x)
    y = np.asarray(y)
    on_device = {}

    def eval_fn(params):
        dev = params["w"].device
        if dev not in on_device:
            on_device[dev] = (torch.as_tensor(x, device=dev),
                              torch.as_tensor(y, device=dev))
        xd, yd = on_device[dev]
        with torch.no_grad():
            return {"eval_loss": float(loss_fn(params, {"x": xd, "y": yd})),
                    "eval_acc": float(accuracy(params, xd, yd))}

    return eval_fn
