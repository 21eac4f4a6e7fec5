"""Datasets (CIFAR archives or the synthetic stand-in) and client sharding."""

from .cifar import DataSource, load_cifar, synthetic_cifar
from .pipeline import (
    BIASED_STATS,
    FederatedDataset,
    client_splits,
    client_stats,
    make_federated,
    normalize,
)

__all__ = [
    "BIASED_STATS",
    "DataSource",
    "FederatedDataset",
    "client_splits",
    "client_stats",
    "load_cifar",
    "make_federated",
    "normalize",
    "synthetic_cifar",
]
