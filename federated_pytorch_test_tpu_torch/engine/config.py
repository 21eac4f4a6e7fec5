"""Experiment configuration: the knobs of the ported paths and their presets.

Counterpart of the subset of the JAX package's `engine/config.py` that
the `no_consensus`, `fedavg`, `admm`, `fedavg_resnet`, `admm_resnet`,
`fedavg_scale64` and `admm_scale64` paths read, with its checkpoint
fields, the line search's probe fan (`linesearch_probes`, `client_fold`),
`average_model` and `synthetic_ok`. Field
names and defaults are the JAX package's, so a configuration reads the
same in both; `device` is the port's own (the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

import dataclasses

from ..consensus import ADMMConfig
from ..models import MODELS
from ..optim import LBFGSConfig
from ..optim.lbfgs import DIRECTIONS


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """The knobs of the image-classification experiment (the JAX package's defaults)."""

    name: str = "custom"
    model: str = "net"  # net | net1 | net2 | resnet18 | vit (models.MODELS)
    # extra constructor arguments of the model class, checked against its
    # signature by the Trainer — e.g. {"patch": 2, "attn_impl": "flash"}
    # runs the ViT on 256 tokens through the flash kernels
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    # weight of the switch load-balance term in each client's loss when the
    # model has experts (`model_kwargs={"moe_experts": E}`); ignored otherwise
    moe_aux_coef: float = 0.01
    # 'bfloat16' runs the models' convolutions and matmuls, and the norms'
    # elementwise math, in bf16; parameters, the loss and all L-BFGS math
    # stay f32 (mixed precision, the JAX package's meaning)
    compute_dtype: str = "float32"
    # recompute the forward during the backward (torch.utils.checkpoint):
    # activation memory for compute; line-search probes are forward-only
    remat: bool = False
    dataset: str = "cifar10"  # cifar10 | cifar100
    data_root: str | None = None  # None => $CIFAR_DATA_DIR or ./torchdata
    synthetic_ok: bool = True  # fall back to synthetic data if no archive
    synthetic_n_train: int | None = None  # shrink the synthetic stand-in only
    synthetic_n_test: int | None = None

    n_clients: int = 3
    batch: int = 512
    strategy: str = "fedavg"  # none (independent training) | fedavg | admm

    # loop nest: Nloop{groups{Nadmm{epochs{batches}}}}
    nloop: int = 12
    nepoch: int = 1
    nadmm: int = 3

    lambda1: float = 1e-4
    lambda2: float = 1e-4
    # 'active_linear': elastic net on the active group when it is a linear
    #   layer; 'first_linear': elastic net on the model's first linear group
    #   of the full vector (the no_consensus script, where only fc1 is
    #   regularized); 'none': no regularization
    reg_mode: str = "active_linear"

    biased_input: bool = True  # per-client normalization constants

    # inner optimizer: stochastic L-BFGS with batch-mode Armijo search
    lbfgs_history: int = 10
    lbfgs_max_iter: int = 4
    lbfgs_lr: float = 1.0
    # 'compact' (plain PyTorch), 'two_loop' (the sequential recursion,
    # plain PyTorch) or 'pallas' (the fused CUDA kernels; the name is the
    # JAX package's value for its fused-kernel backend)
    lbfgs_direction: str = "compact"
    # rungs of the Armijo halving ladder evaluated in one batched pass (a
    # fan), the first rung that satisfies the condition picked on the card;
    # 1 is the sequential search. The picked rung is the sequential one's up
    # to ties on the Armijo threshold, so this changes trajectories by ulps
    linesearch_probes: int = 1
    # how a fan batches the P probes: 'vmap' runs the model on K·P clients
    # (every parameter repeated P times); 'gemm' gives the probe axis only to
    # the active group's parameters: the layers below it run once a fan, the
    # frozen ones above it on a P-times-wider batch. Same objective values
    # up to the wider reductions' order; no effect at linesearch_probes=1
    client_fold: str = "gemm"

    # ADMM (the reference's consensus_admm_trio.py constants)
    admm_rho0: float = 1e-3
    bb_update: bool = False
    bb_period: int = 2
    bb_alphacorrmin: float = 0.2
    bb_epsilon: float = 1e-3
    bb_rhomax: float = 0.1
    # soft-threshold the z-update by this value (> 0 enables)
    z_soft_threshold: float = 0.0

    # the reference's ResNet scripts visit the groups in one fixed seed-0 permutation,
    # reused in every outer loop
    shuffle_group_order: bool = False

    # 'auto': restore the newest readable checkpoint under checkpoint_dir
    # if there is one, else start fresh (load_model instead requires one)
    resume: str = "off"
    init_model: bool = True  # common-seed init across clients
    load_model: bool = False
    save_model: bool = False  # checkpoint after every outer loop and at the end
    check_results: bool = True  # evaluate after each averaging round
    # with check_results, also evaluate after every minibatch
    eval_every_batch: bool = False
    average_model: bool = False  # one-shot whole-model mean over the clients before training

    seed: int = 0
    eval_batch: int = 500
    checkpoint_dir: str = "./checkpoints"
    # train only the first N groups of the partition order (None = all)
    max_groups: int | None = None

    device: str = "cuda"

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {sorted(MODELS)}, got {self.model!r}")
        if self.resume not in ("off", "auto"):
            raise ValueError(f"resume must be 'off' or 'auto', got {self.resume!r}")
        if self.strategy not in ("none", "fedavg", "admm"):
            raise ValueError(f"strategy must be 'none', 'fedavg' or 'admm', got {self.strategy!r}")
        if self.reg_mode not in ("active_linear", "first_linear", "none"):
            raise ValueError(
                f"reg_mode must be 'active_linear', 'first_linear' or 'none', got {self.reg_mode!r}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {self.compute_dtype!r}")
        if not isinstance(self.linesearch_probes, int) or isinstance(self.linesearch_probes, bool):
            raise ValueError(f"linesearch_probes must be an int >= 1, got {self.linesearch_probes!r}")
        if self.linesearch_probes < 1:
            raise ValueError(f"linesearch_probes must be >= 1, got {self.linesearch_probes}")
        if self.client_fold not in ("gemm", "vmap"):
            raise ValueError(f"client_fold must be 'gemm' or 'vmap', got {self.client_fold!r}")
        if self.lbfgs_direction not in DIRECTIONS:
            raise ValueError(
                f"lbfgs_direction must be one of {sorted(DIRECTIONS)}, got {self.lbfgs_direction!r}"
            )
        for name in ("n_clients", "batch", "nloop", "nepoch", "nadmm", "eval_batch", "bb_period"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.max_groups is not None and self.max_groups < 1:
            raise ValueError(f"max_groups must be >= 1, got {self.max_groups}")

    def lbfgs_config(self) -> LBFGSConfig:
        return LBFGSConfig(
            lr=self.lbfgs_lr,
            max_iter=self.lbfgs_max_iter,
            history_size=self.lbfgs_history,
            line_search=True,
            batch_mode=True,
            direction=self.lbfgs_direction,
            ls_probes=self.linesearch_probes,
        )

    def admm_config(self) -> ADMMConfig:
        return ADMMConfig(
            rho0=self.admm_rho0,
            bb_update=self.bb_update,
            bb_period=self.bb_period,
            bb_alphacorrmin=self.bb_alphacorrmin,
            bb_epsilon=self.bb_epsilon,
            bb_rhomax=self.bb_rhomax,
            z_soft_threshold=self.z_soft_threshold,
        )

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# The reference's experiment scripts as presets (the JAX package's definitions).
PRESETS = {
    # no_consensus_trio.py: Net1, batch 32, 12 epochs of independent
    # training, fc1-only elastic net, each client its own initial draw
    "no_consensus": ExperimentConfig(
        name="no_consensus",
        model="net1",
        batch=32,
        strategy="none",
        nloop=1,
        nepoch=12,
        nadmm=1,
        reg_mode="first_linear",
        init_model=False,
    ),
    # federated_trio.py: Net, K=3, batch 512, Nloop=12, Nadmm=3
    "fedavg": ExperimentConfig(name="fedavg", model="net", strategy="fedavg"),
    # federated_trio_resnet.py: ResNet18, batch 32, no regularization, the
    # shuffled block order and one unbiased normalization for all clients
    "fedavg_resnet": ExperimentConfig(
        name="fedavg_resnet",
        model="resnet18",
        batch=32,
        strategy="fedavg",
        reg_mode="none",
        biased_input=False,
        shuffle_group_order=True,
    ),
    # consensus_admm_trio.py: Net, batch 512, Nadmm=5, rho0=1e-3 with BB on
    "admm": ExperimentConfig(name="admm", model="net", strategy="admm", nadmm=5, bb_update=True),
    # consensus_admm_trio_resnet.py: ResNet18, batch 32, Nadmm=3, a fixed
    # rho of 1e-3, the shuffled block order
    "admm_resnet": ExperimentConfig(
        name="admm_resnet",
        model="resnet18",
        batch=32,
        strategy="admm",
        nadmm=3,
        reg_mode="none",
        biased_input=False,
        bb_update=False,
        shuffle_group_order=True,
    ),
    # BASELINE.json config 5 (scale-out, no reference script): K=64 ResNet18
    # clients on CIFAR-100; on one card the clients are the batch axis
    "fedavg_scale64": ExperimentConfig(
        name="fedavg_scale64",
        model="resnet18",
        dataset="cifar100",
        n_clients=64,
        batch=32,
        strategy="fedavg",
        reg_mode="none",
        biased_input=False,
        shuffle_group_order=True,
        check_results=False,
    ),
    "admm_scale64": ExperimentConfig(
        name="admm_scale64",
        model="resnet18",
        dataset="cifar100",
        n_clients=64,
        batch=32,
        strategy="admm",
        nadmm=3,
        reg_mode="none",
        biased_input=False,
        bb_update=False,
        shuffle_group_order=True,
        check_results=False,
    ),
}


def get_preset(name: str, **overrides) -> ExperimentConfig:
    """Fetch a preset by name, optionally overriding fields."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
