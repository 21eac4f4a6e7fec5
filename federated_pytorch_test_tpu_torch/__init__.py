"""PyTorch/CUDA port of `federated_pytorch_test_tpu` (federated L-BFGS training).

The JAX package beside this one is the reference; this package keeps its
module names so each counterpart is easy to find. It imports `torch` and
never `jax`, and nothing of the JAX package. Entry points run on the card
(`device="cuda"`) unless the caller asks for the CPU.

Ported so far:

* the reference's five presets on one engine (`engine/`): `no_consensus`
  (independent Net1 clients), `fedavg` and `admm` (Net), `fedavg_resnet`
  and `admm_resnet` (ResNet18 with client-local BatchNorm); stochastic
  L-BFGS with batch-mode Armijo search, its direction plain (`compact`,
  `two_loop`) or the fused compact direction as hand-written CUDA kernels
  for Hopper (`ops/compact_cuda.py`, `csrc/compact_direction.cu`); a
  full-state checkpoint with resume (`utils/checkpoint.py`);
* the same engine with ViT and switch-MoE ViT clients (`model="vit"`,
  `model_kwargs`), on the rectangular flash kernels and the grouped GEMM
  kernel (`ops/flash_cuda.py`, `ops/grouped_gemm.py`);
* federated causal-LM training (`federated_lm.py`): `TransformerLM`
  clients with the causal flash-attention forward and backward as
  hand-written CUDA kernels (`ops/flash_cuda.py`, `csrc/flash_attention.cu`).
"""

from .engine import ExperimentConfig, Trainer, get_preset

__all__ = ["ExperimentConfig", "Trainer", "get_preset"]
