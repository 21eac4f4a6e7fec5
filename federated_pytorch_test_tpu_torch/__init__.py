"""PyTorch/CUDA port of `federated_pytorch_test_tpu` (federated L-BFGS training).

The JAX package beside this one is the reference; this package keeps its
module names so each counterpart is easy to find. It imports `torch` and
never `jax`, and nothing of the JAX package. Entry points run on the card
(`device="cuda"`) unless the caller asks for the CPU.

Three paths are ported so far:

* the `fedavg` preset: Net clients, partial-parameter FedAvg, stochastic
  L-BFGS with batch-mode Armijo search, and the fused compact L-BFGS
  direction as hand-written CUDA kernels for Hopper (`ops/compact_cuda.py`,
  `csrc/compact_direction.cu`);
* the same engine with ViT clients (`model="vit"`, `model_kwargs`), whose
  non-causal flash attention runs the rectangular flash kernels
  (`ops/flash_cuda.py`, `csrc/flash_attention.cu`);
* federated causal-LM training (`federated_lm.py`): `TransformerLM`
  clients with the causal flash-attention forward and backward as
  hand-written CUDA kernels (`ops/flash_cuda.py`, `csrc/flash_attention.cu`).
"""

from .engine import ExperimentConfig, Trainer, get_preset

__all__ = ["ExperimentConfig", "Trainer", "get_preset"]
