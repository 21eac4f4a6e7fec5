"""The experiment loop: Nloop{groups{Nadmm{epochs{batches}}}}.

Counterpart of the fedavg path of the JAX package's `engine/trainer.py`,
without its cohort, fault, robust-aggregation, codec, observability and
fused-round machinery. Kept from it:

* the group order is the model's `TRAIN_ORDER`, cut to `max_groups`;
* each client reshuffles its shard every epoch with the same numpy
  recipe (`_epoch_seed(seed + 69, nloop, gid, nadmm, epoch)`), so both
  packages train on identical minibatches;
* every group round starts a fresh L-BFGS state and z = 0, and each of
  its `nadmm` averaging rounds is `nepoch` epochs then one FedAvg
  exchange of the group's coordinates;
* every client is evaluated on the full test set after each exchange.

All state lives on `device` (the card unless the caller asks for the
CPU): the flat client parameters `[K, N]`, the client shards and the
stacked test sweep are moved there once.
"""

from __future__ import annotations

import inspect
import time
from typing import Optional

import numpy as np
import torch

from ..data import load_cifar, make_federated
from ..models import MODELS, init_client_params
from ..utils import MetricsRecorder, resolve_device
from .config import ExperimentConfig
from .steps import GroupContext, evaluate, fedavg_consensus, round_init, run_epoch


def build_model(cfg: ExperimentConfig, num_classes: int):
    """`MODELS[cfg.model]` with `num_classes` and `cfg.model_kwargs`, whose
    keys must be constructor arguments of the model class."""
    model_cls = MODELS[cfg.model]
    settable = set(inspect.signature(model_cls.__init__).parameters) - {"self"}
    bad = sorted(set(cfg.model_kwargs) - settable)
    if bad:
        raise ValueError(
            f"model_kwargs {bad} are not fields of {cfg.model!r} ({model_cls.__name__}); "
            f"valid extras: {sorted(settable - {'num_classes'})}"
        )
    return model_cls(**{"num_classes": num_classes, **cfg.model_kwargs})


def _epoch_seed(base: int, *parts: int) -> np.random.Generator:
    return np.random.default_rng([base & 0x7FFFFFFF, *[p & 0x7FFFFFFF for p in parts]])


class Trainer:
    """Builds all device state for one experiment and runs it."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        verbose: bool = True,
        source=None,
        device=None,
        init_flat: Optional[np.ndarray] = None,
    ):
        """`device` overrides `cfg.device`; `init_flat` (`[N]` or `[K, N]`,
        in this package's flat order) replaces the common-seed init, e.g.
        with parameters converted from the JAX package (`convert.py`)."""
        self.cfg = cfg
        self.device = resolve_device(cfg.device if device is None else device)
        self.recorder = MetricsRecorder(verbose=verbose)

        if source is None:
            source = load_cifar(
                cfg.dataset,
                cfg.data_root,
                synthetic_n_train=cfg.synthetic_n_train,
                synthetic_n_test=cfg.synthetic_n_test,
            )
        self.fed = make_federated(source, cfg.n_clients, biased=cfg.biased_input)
        if self.fed.steps_per_epoch(cfg.batch) == 0:
            raise ValueError(
                f"batch={cfg.batch} exceeds the per-client shard size "
                f"({self.fed.shard_size}): zero lockstep steps fit in an epoch"
            )

        self.model = build_model(cfg, self.fed.num_classes).to(self.device)
        self.model.requires_grad_(False)  # parameters live in `self.flat`
        self.shapes = self.model.shapes()
        self.partition = self.model.partition()
        self.n_params = self.partition.total
        order = list(self.partition.train_order)
        if cfg.max_groups is not None:
            order = order[: cfg.max_groups]
        self.group_order = [int(g) for g in order]

        if init_flat is None:
            self.flat = init_client_params(self.model, cfg.n_clients, cfg.seed, self.device)
        else:
            f = torch.as_tensor(np.asarray(init_flat, np.float32))
            if f.ndim == 1:
                f = f[None].expand(cfg.n_clients, -1)
            if tuple(f.shape) != (cfg.n_clients, self.n_params):
                raise ValueError(f"init_flat has shape {tuple(f.shape)}, want [K, {self.n_params}]")
            self.flat = f.contiguous().to(self.device)

        dev = self.device
        self.shard_imgs = torch.from_numpy(self.fed.train_images).to(dev)
        self.shard_labels = torch.from_numpy(self.fed.train_labels).to(dev)
        self.mean = torch.from_numpy(self.fed.mean).to(dev)
        self.std = torch.from_numpy(self.fed.std).to(dev)
        imgs, labels, masks = zip(*self.fed.test_batches(cfg.eval_batch))
        self.test_imgs = torch.from_numpy(np.stack(imgs)).to(dev)
        self.test_labels = torch.from_numpy(np.stack(labels)).to(dev)
        self.test_mask = torch.from_numpy(np.stack(masks)).to(dev)
        self._test_total = int(self.fed.test_images.shape[0])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ctx(self, gid: int) -> GroupContext:
        cfg = self.cfg
        return GroupContext(
            model=self.model,
            shapes=self.shapes,
            partition=self.partition,
            gid=gid,
            lbfgs=cfg.lbfgs_config(),
            reg_on_active=cfg.reg_mode == "active_linear" and gid in self.partition.linear_group_ids,
            lambda1=cfg.lambda1,
            lambda2=cfg.lambda2,
        )

    def epoch_indices(self, *loop_ids: int) -> np.ndarray:
        """Per-client shuffled lockstep batch indices `[S, K, B]` (host)."""
        k, n, b = self.cfg.n_clients, self.fed.shard_size, self.cfg.batch
        s = n // b
        rng = _epoch_seed(self.cfg.seed + 69, *loop_ids)
        perms = np.stack([rng.permutation(n) for _ in range(k)])  # [K, n]
        return perms[:, : s * b].reshape(k, s, b).transpose(1, 0, 2).astype(np.int64)

    def evaluate(self) -> np.ndarray:
        """Per-client top-1 accuracy `[K]` over the full test set."""
        correct = evaluate(
            self.model, self.shapes, self.flat, self.test_imgs, self.test_labels,
            self.test_mask, self.mean, self.std,
        )
        return correct.cpu().numpy() / self._test_total

    def run_round(self, nloop: int, gid: int) -> None:
        """One group's round: fresh state, then Nadmm x (epochs + FedAvg)."""
        cfg, rec = self.cfg, self.recorder
        ctx = self.ctx(gid)
        t_round = time.perf_counter()
        lstate, cstate = round_init(ctx, self.flat)
        for a in range(cfg.nadmm):
            for e in range(cfg.nepoch):
                idx = self.epoch_indices(nloop, gid, a, e)
                with rec.phase("epoch", sync=self._sync, nloop=nloop, group=gid, nadmm=a, epoch=e):
                    self.flat, lstate, losses = run_epoch(
                        ctx, self.flat, lstate, self.shard_imgs, self.shard_labels,
                        idx, self.mean, self.std,
                    )
                    losses = losses.cpu().numpy()
                for s in range(losses.shape[0]):
                    rec.batch_losses(losses[s], nloop=nloop, group=gid, nadmm=a, epoch=e, minibatch=s)
            with rec.phase("consensus", sync=self._sync, nloop=nloop, group=gid, nadmm=a):
                self.flat, cstate, dual = fedavg_consensus(ctx, self.flat, cstate)
                dual = float(dual)
            rec.residuals(dual, nloop=nloop, group=gid, nadmm=a, group_size=self.partition.group_size(gid))
            with rec.phase("eval", sync=self._sync, nloop=nloop, group=gid, nadmm=a):
                accs = self.evaluate()
            rec.accuracies(accs, nloop=nloop, group=gid, nadmm=a)
        self._sync()
        rec.step_time("round", time.perf_counter() - t_round, nloop=nloop, group=gid)

    def run_loop(self, nloop: int) -> None:
        """One outer loop: a round for each group of the order."""
        for gid in self.group_order:
            self.run_round(nloop, gid)

    def run(self) -> MetricsRecorder:
        """The full experiment (all Nloop outer loops)."""
        for nloop in range(self.cfg.nloop):
            self.run_loop(nloop)
        return self.recorder

