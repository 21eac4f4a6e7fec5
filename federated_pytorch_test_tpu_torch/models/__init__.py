"""Client models of the port: the simple CNNs, the ViT and the causal LM."""

from .base import PartitionedModel, init_client_params
from .simple import Net, Net1, Net2
from .transformer import TransformerLM, ViT

# the image-classification experiment's models (`ExperimentConfig.model`)
MODELS = {"net": Net, "net1": Net1, "net2": Net2, "vit": ViT}

__all__ = ["MODELS", "Net", "Net1", "Net2", "PartitionedModel", "TransformerLM", "ViT", "init_client_params"]
