"""Experiment configuration: the knobs of the fedavg path and its preset.

Counterpart of the subset of the JAX package's `engine/config.py` that
the `fedavg` path reads. Field names and defaults are the JAX package's,
so a configuration reads the same in both; `device` is the port's own
(the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses

from ..models import MODELS
from ..optim import LBFGSConfig
from ..optim.lbfgs import DIRECTIONS


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """The knobs of the FedAvg image-classification experiment (the JAX package's defaults)."""

    name: str = "custom"
    model: str = "net"  # net | net1 | net2 | vit (models.MODELS)
    # extra constructor arguments of the model class, checked against its
    # signature by the Trainer — e.g. {"patch": 2, "attn_impl": "flash"}
    # runs the ViT on 256 tokens through the flash kernels
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    dataset: str = "cifar10"  # cifar10 | cifar100
    data_root: str | None = None  # None => $CIFAR_DATA_DIR or ./torchdata
    synthetic_n_train: int | None = None  # shrink the synthetic stand-in only
    synthetic_n_test: int | None = None

    n_clients: int = 3
    batch: int = 512
    strategy: str = "fedavg"  # only FedAvg is ported so far

    # loop nest: Nloop{groups{Nadmm{epochs{batches}}}}
    nloop: int = 12
    nepoch: int = 1
    nadmm: int = 3

    # elastic net on the active group when it is a linear layer
    lambda1: float = 1e-4
    lambda2: float = 1e-4
    reg_mode: str = "active_linear"  # active_linear | none

    biased_input: bool = True  # per-client normalization constants

    # inner optimizer: stochastic L-BFGS with batch-mode Armijo search
    lbfgs_history: int = 10
    lbfgs_max_iter: int = 4
    lbfgs_lr: float = 1.0
    # 'compact' (plain PyTorch) or 'pallas' (the fused CUDA kernels; the
    # name is the JAX package's value for its fused-kernel backend)
    lbfgs_direction: str = "compact"

    seed: int = 0
    eval_batch: int = 500
    # train only the first N groups of the partition order (None = all)
    max_groups: int | None = None

    device: str = "cuda"

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {sorted(MODELS)}, got {self.model!r}")
        if self.strategy != "fedavg":
            raise ValueError(f"strategy {self.strategy!r} is not ported yet (only 'fedavg')")
        if self.reg_mode not in ("active_linear", "none"):
            raise ValueError(f"reg_mode must be 'active_linear' or 'none', got {self.reg_mode!r}")
        if self.lbfgs_direction not in DIRECTIONS:
            raise ValueError(
                f"lbfgs_direction must be one of {sorted(DIRECTIONS)}, got {self.lbfgs_direction!r}"
            )
        for name in ("n_clients", "batch", "nloop", "nepoch", "nadmm", "eval_batch"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.max_groups is not None and self.max_groups < 1:
            raise ValueError(f"max_groups must be >= 1, got {self.max_groups}")

    def lbfgs_config(self) -> LBFGSConfig:
        return LBFGSConfig(
            lr=self.lbfgs_lr,
            max_iter=self.lbfgs_max_iter,
            history_size=self.lbfgs_history,
            direction=self.lbfgs_direction,
        )

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# The reference FedAvg simple-CNN experiment: Net, K=3, batch 512, Nloop=12, Nadmm=3.
PRESETS = {"fedavg": ExperimentConfig(name="fedavg", model="net", strategy="fedavg")}


def get_preset(name: str, **overrides) -> ExperimentConfig:
    """Fetch a preset by name, optionally overriding fields."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
