"""Consensus: FedAvg, ADMM with BB rho, and the elastic-net penalties."""

from .admm import ADMMConfig, ADMMState, admm_init, admm_penalty, admm_round
from .fedavg import FedAvgState, fedavg_init, fedavg_round
from .penalties import elastic_net, soft_threshold

__all__ = [
    "ADMMConfig",
    "ADMMState",
    "FedAvgState",
    "admm_init",
    "admm_penalty",
    "admm_round",
    "elastic_net",
    "fedavg_init",
    "fedavg_round",
    "soft_threshold",
]
