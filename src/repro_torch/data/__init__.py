"""Synthetic datasets and federated splits: numpy copies of ``repro.data``'s
modules (the port may not import the JAX package), so both packages draw
identical arrays from the same seeds."""
from repro_torch.data.federated import (
    ClientData,
    FederatedData,
    split_by_group,
    split_dirichlet,
    split_iid,
)
from repro_torch.data.synthetic import Dataset, adult_like, vehicle_like

__all__ = [
    "ClientData", "FederatedData", "split_by_group", "split_dirichlet",
    "split_iid", "Dataset", "adult_like", "vehicle_like",
]
