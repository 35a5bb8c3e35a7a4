"""Federated splits + per-client samplers (paper §8.1 data settings).

Splits:
  - ``split_by_group``  : Adult-1 / Vehicle-1 style non-iid (one attribute
                          value -> one client).
  - ``split_iid``       : Adult-2 / Vehicle-2 style (uniform shuffle, equal
                          client sizes).
  - ``split_dirichlet`` : beyond-paper label-skew control (alpha -> niid-ness).

Each client's data is further divided 80/10/10 train/val/test (paper §8.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.synthetic import Dataset


@dataclass
class ClientData:
    x_train: np.ndarray
    y_train: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_train(self) -> int:
        return self.x_train.shape[0]


@dataclass
class FederatedData:
    clients: list[ClientData]
    name: str = ""

    @property
    def n_clients(self) -> int:
        return len(self.clients)

    def batch_sizes(self, batch_size: int,
                    proportional: bool = False) -> list[int]:
        """Per-step mini-batch size X_m per client.

        Default: uniform ``batch_size`` for every client (sampling is with
        replacement so clients smaller than the batch still work).

        ``proportional=True`` returns the paper's per-client X_m: sizes
        proportional to each client's ``n_train`` with the same *total*
        batch budget (target mean ``batch_size``, floor 1), CAPPED at
        ``batch_size``. The cap is a soundness invariant enforced here,
        not caller etiquette: the engines *sample* a uniform ``batch_size``
        per step (round batches stack to one (C, tau, B, ...) block via
        ``make_sampler(batch_size)``), so an accounted X_m above the
        executed batch would claim a smaller per-step sensitivity (2G/X_m,
        paper §5.2) than the mechanism actually has — a privacy accounting
        hole. Below the executed batch the accounting is merely
        conservative (small clients pay extra noise), which is the safe
        side the cap leaves data-rich clients on.
        """
        if not proportional:
            return [batch_size for _ in self.clients]
        total = sum(c.n_train for c in self.clients)
        budget = batch_size * len(self.clients)
        return [max(1, min(batch_size, round(budget * c.n_train / total)))
                for c in self.clients]

    def make_sampler(self, batch_size: int):
        """sampler(client, tau, rng) -> {'x': (tau,B,d), 'y': (tau,B)}"""
        def sampler(m: int, tau: int, rng: np.random.Generator):
            c = self.clients[m]
            idx = rng.integers(0, c.n_train, size=(tau, batch_size))
            return {"x": c.x_train[idx], "y": c.y_train[idx]}
        return sampler

    def eval_arrays(self, split: str = "test"):
        xs = np.concatenate([getattr(c, f"x_{split}") for c in self.clients])
        ys = np.concatenate([getattr(c, f"y_{split}") for c in self.clients])
        return xs, ys


def _split_client(x: np.ndarray, y: np.ndarray,
                  rng: np.random.Generator) -> ClientData:
    n = x.shape[0]
    perm = rng.permutation(n)
    x, y = x[perm], y[perm]
    n_tr = max(1, int(0.8 * n))
    n_va = max(1, int(0.1 * n))
    return ClientData(
        x_train=x[:n_tr], y_train=y[:n_tr],
        x_val=x[n_tr:n_tr + n_va], y_val=y[n_tr:n_tr + n_va],
        x_test=x[n_tr + n_va:], y_test=y[n_tr + n_va:],
    )


def split_by_group(ds: Dataset, seed: int = 0) -> FederatedData:
    """Non-iid: each distinct ``group`` value becomes one client."""
    rng = np.random.default_rng(seed)
    clients = []
    for g in np.unique(ds.group):
        m = ds.group == g
        clients.append(_split_client(ds.x[m], ds.y[m], rng))
    return FederatedData(clients=clients, name=f"{ds.name}-noniid")


def split_iid(ds: Dataset, n_clients: int, seed: int = 0) -> FederatedData:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.n)
    parts = np.array_split(perm, n_clients)
    clients = [_split_client(ds.x[p], ds.y[p], rng) for p in parts]
    return FederatedData(clients=clients, name=f"{ds.name}-iid")


def split_dirichlet(ds: Dataset, n_clients: int, alpha: float,
                    seed: int = 0) -> FederatedData:
    """Label-skew split: per-class Dirichlet(alpha) allocation over clients."""
    rng = np.random.default_rng(seed)
    idx_by_client: list[list[int]] = [[] for _ in range(n_clients)]
    for cls in np.unique(ds.y):
        idx = np.flatnonzero(ds.y == cls)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for c, part in enumerate(np.split(idx, cuts)):
            idx_by_client[c].extend(part.tolist())
    clients = []
    for c in range(n_clients):
        sel = np.asarray(idx_by_client[c], dtype=int)
        if sel.size < 10:   # guarantee a usable shard
            extra = rng.integers(0, ds.n, size=10)
            sel = np.concatenate([sel, extra])
        clients.append(_split_client(ds.x[sel], ds.y[sel], rng))
    return FederatedData(clients=clients, name=f"{ds.name}-dir{alpha}")
