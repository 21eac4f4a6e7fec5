"""Client models of the port: the simple CNNs and the causal LM."""

from .base import PartitionedModel, init_client_params
from .simple import Net, Net1, Net2
from .transformer import TransformerLM

# the CNN experiment's models (`ExperimentConfig.model`)
MODELS = {"net": Net, "net1": Net1, "net2": Net2}

__all__ = ["MODELS", "Net", "Net1", "Net2", "PartitionedModel", "TransformerLM", "init_client_params"]
