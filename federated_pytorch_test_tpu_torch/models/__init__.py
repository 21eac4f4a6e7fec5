"""Client models of the port (the simple CNNs of this slice)."""

from .base import PartitionedModel, init_client_params
from .simple import Net, Net1, Net2

MODELS = {"net": Net, "net1": Net1, "net2": Net2}

__all__ = ["MODELS", "Net", "Net1", "Net2", "PartitionedModel", "init_client_params"]
