"""Consensus: FedAvg and the elastic-net penalties."""

from .fedavg import FedAvgState, fedavg_init, fedavg_round
from .penalties import elastic_net, soft_threshold

__all__ = ["FedAvgState", "elastic_net", "fedavg_init", "fedavg_round", "soft_threshold"]
