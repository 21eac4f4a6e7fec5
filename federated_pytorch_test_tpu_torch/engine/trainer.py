"""The experiment loop: Nloop{groups{Nadmm{epochs{batches}}}}.

Counterpart of the none, fedavg and admm paths of the JAX package's
`engine/trainer.py`, with its checkpoint and resume, without its cohort,
fault, robust-aggregation, codec, observability and fused-round
machinery. Kept from it:

* the group order is the model's `TRAIN_ORDER`, or with
  `shuffle_group_order` one `np.random.RandomState(0)` permutation of the
  groups reused in every outer loop, then cut to `max_groups`; under
  strategy 'none' (independent training) the partition is one group, the
  whole vector, and nothing is exchanged;
* every client starts from the same draw, or with `init_model=False` from
  its own (`init_client_params(common=False)`); with `average_model` the
  clients' parameters (restored ones included) are replaced once by their
  mean before training;
* without a CIFAR archive the deterministic synthetic stand-in is used,
  unless `synthetic_ok` is False, which raises;
* each client reshuffles its shard every epoch with the same numpy
  recipe (`_epoch_seed(seed + 69, nloop, gid, nadmm, epoch)`), so both
  packages train on identical minibatches;
* every group round starts a fresh L-BFGS state and consensus state, and
  each of its `nadmm` rounds is `nepoch` epochs then one exchange of the
  group's coordinates: FedAvg (the mean, broadcast back) or ADMM (the
  clients keep their x; y and z start at 0 each round, while each group's
  rho persists across outer loops in `_rho_store`);
* a BatchNorm model's running statistics `{name: [K, C]}` are client
  state beside the flat parameters, never averaged or exchanged;
* with `check_results`, every client is evaluated on the full test set
  after each exchange, after every epoch under strategy 'none', and with
  `eval_every_batch` after every minibatch too (the round-end record is
  then skipped under 'none', where it would repeat the last one);
* with `save_model` the full state is checkpointed after every outer
  loop and once more at the end (`utils/checkpoint.py`); `load_model`
  restores the newest readable checkpoint and requires one, `resume="auto"`
  restores one if there is one, and `run()` continues from the restored
  loop cursor.

All state lives on `device` (the card unless the caller asks for the
CPU): the flat client parameters `[K, N]`, the statistics, the client
shards and the stacked test sweep are moved there once.
"""

from __future__ import annotations

import inspect
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..data import load_cifar, make_federated
from ..models import MODELS, init_client_params
from ..models.base import COMPUTE_DTYPES
from ..partition import Partition, Segment
from ..utils import MetricsRecorder, load_checkpoint, resolve_device, save_checkpoint
from .config import ExperimentConfig
from .steps import (
    GroupContext,
    admm_consensus,
    evaluate,
    fedavg_consensus,
    round_init,
    run_epoch,
)


def build_model(cfg: ExperimentConfig, num_classes: int):
    """`MODELS[cfg.model]` with `num_classes`, the compute dtype
    (`cfg.compute_dtype`) and `cfg.model_kwargs`, whose keys must be
    constructor arguments of the model class."""
    model_cls = MODELS[cfg.model]
    settable = set(inspect.signature(model_cls.__init__).parameters) - {"self"}
    bad = sorted(set(cfg.model_kwargs) - settable)
    if bad:
        raise ValueError(
            f"model_kwargs {bad} are not fields of {cfg.model!r} ({model_cls.__name__}); "
            f"valid extras: {sorted(settable - {'num_classes', 'dtype'})}"
        )
    kw = {"num_classes": num_classes}
    if "dtype" in settable:
        kw["dtype"] = COMPUTE_DTYPES[cfg.compute_dtype]
    return model_cls(**{**kw, **cfg.model_kwargs})


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
        init_stats: Optional[Mapping[str, np.ndarray]] = None,
    ):
        """`device` overrides `cfg.device`; `init_flat` (`[N]` or `[K, N]`,
        in this package's flat order) replaces the seeded init, e.g. with
        parameters converted from the JAX package (`convert.py`), and
        `init_stats` (`{name: [C] or [K, C]}`) a BatchNorm model's initial
        running statistics (`convert.stats_from_jax`)."""
        self.cfg = cfg
        self.device = resolve_device(cfg.device if device is None else device)
        self.recorder = MetricsRecorder(verbose=verbose)

        if source is None:
            source = load_cifar(
                cfg.dataset,
                cfg.data_root,
                synthetic_ok=cfg.synthetic_ok,
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
        # the model's layer groups; the training partition is the same, or
        # the one whole-vector group of independent training
        self.model_partition = self.model.partition()
        self.n_params = self.model_partition.total
        if cfg.strategy == "none":
            self.partition = Partition(groups=((Segment(0, self.n_params),),), total=self.n_params)
            self.group_order = [0]
        else:
            self.partition = self.model_partition
            order = list(self.partition.train_order)
            if cfg.shuffle_group_order:
                order = list(np.random.RandomState(0).permutation(self.partition.num_groups))
            if cfg.max_groups is not None:
                order = order[: cfg.max_groups]
            self.group_order = [int(g) for g in order]

        if init_flat is None:
            self.flat = init_client_params(self.model, cfg.n_clients, cfg.seed, self.device, common=cfg.init_model)
        else:
            f = torch.as_tensor(np.asarray(init_flat, np.float32))
            if f.ndim == 1:
                f = f[None].expand(cfg.n_clients, -1)
            if tuple(f.shape) != (cfg.n_clients, self.n_params):
                raise ValueError(f"init_flat has shape {tuple(f.shape)}, want [K, {self.n_params}]")
            self.flat = f.contiguous().to(self.device)
        self.stats: Dict[str, torch.Tensor] = self.model.init_stats(cfg.n_clients, self.device)
        if init_stats is not None:
            if sorted(init_stats) != sorted(self.stats):
                raise ValueError(f"init_stats has keys {sorted(init_stats)}, want {sorted(self.stats)}")
            for name, v in init_stats.items():
                t = torch.as_tensor(np.asarray(v, np.float32))
                self.stats[name] = t.expand_as(self.stats[name]).contiguous().to(self.device)
        # each group's ADMM rho `[K, 1]`, carried from one outer loop to the next
        self._rho_store: Dict[int, torch.Tensor] = {}
        self._completed_nloops = 0

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

        if cfg.load_model or cfg.resume == "auto":
            try:
                self._restore()
            except FileNotFoundError:
                if cfg.load_model:
                    raise  # load_model requires a checkpoint; resume='auto' starts fresh
        if cfg.average_model:
            # one-shot whole-model mean over the clients before training
            self.flat = self.flat.mean(dim=0, keepdim=True).expand_as(self.flat).contiguous()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ctx(self, gid: int) -> GroupContext:
        cfg = self.cfg
        reg_segments = ()
        if cfg.reg_mode == "first_linear" and self.model_partition.linear_group_ids:
            reg_segments = self.model_partition.groups[self.model_partition.linear_group_ids[0]]
        return GroupContext(
            model=self.model,
            shapes=self.shapes,
            partition=self.partition,
            gid=gid,
            lbfgs=cfg.lbfgs_config(),
            reg_on_active=cfg.reg_mode == "active_linear" and gid in self.partition.linear_group_ids,
            reg_segments=reg_segments,
            lambda1=cfg.lambda1,
            lambda2=cfg.lambda2,
            # the load-balance term enters the loss only where the model has experts
            moe_aux_coef=cfg.moe_aux_coef if getattr(self.model, "moe_experts", 0) else 0.0,
            strategy=cfg.strategy,
            admm=cfg.admm_config(),
            remat=cfg.remat,
            client_fold=cfg.client_fold,
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
            self.test_mask, self.mean, self.std, self.stats,
        )
        return correct.cpu().numpy() / self._test_total

    def run_round(self, nloop: int, gid: int) -> None:
        """One group's round: fresh state, then Nadmm x (epochs + exchange)."""
        cfg, rec = self.cfg, self.recorder
        ctx = self.ctx(gid)
        admm, none = cfg.strategy == "admm", cfg.strategy == "none"
        per_batch_eval = cfg.check_results and cfg.eval_every_batch
        t_round = time.perf_counter()
        lstate, cstate = round_init(ctx, self.flat)
        if admm and gid in self._rho_store:
            cstate = cstate._replace(rho=self._rho_store[gid])  # rho carried across loops
        for a in range(cfg.nadmm):
            for e in range(cfg.nepoch):
                idx = self.epoch_indices(nloop, gid, a, e)
                after_step = None
                if per_batch_eval:
                    def after_step(s, flat, stats, a=a, e=e):
                        self.flat, self.stats = flat, stats
                        # nested in the epoch's phase: its seconds include these
                        with rec.phase("eval", sync=self._sync, nloop=nloop, group=gid, nadmm=a, epoch=e,
                                       minibatch=s):
                            accs = self.evaluate()
                        rec.accuracies(accs, nloop=nloop, group=gid, nadmm=a, epoch=e, minibatch=s)
                with rec.phase("epoch", sync=self._sync, nloop=nloop, group=gid, nadmm=a, epoch=e):
                    self.flat, lstate, self.stats, losses = run_epoch(
                        ctx, self.flat, lstate, self.stats, self.shard_imgs, self.shard_labels,
                        idx, self.mean, self.std, cstate if admm else None, after_step,
                    )
                    losses = losses.cpu().numpy()
                for s in range(losses.shape[0]):
                    rec.batch_losses(losses[s], nloop=nloop, group=gid, nadmm=a, epoch=e, minibatch=s)
                if none and cfg.check_results and not per_batch_eval:
                    # independent training has no exchange: evaluate after every epoch
                    with rec.phase("eval", sync=self._sync, nloop=nloop, group=gid, nadmm=a, epoch=e):
                        accs = self.evaluate()
                    rec.accuracies(accs, nloop=nloop, group=gid, nadmm=a, epoch=e)
            if not none:
                with rec.phase("consensus", sync=self._sync, nloop=nloop, group=gid, nadmm=a):
                    if admm:
                        cstate, met = admm_consensus(ctx, self.flat, cstate, a)
                        primal, dual, mean_rho = (
                            float(met[n]) for n in ("primal_residual", "dual_residual", "mean_rho")
                        )
                    else:
                        self.flat, cstate, dual = fedavg_consensus(ctx, self.flat, cstate)
                        primal, dual, mean_rho = None, float(dual), None
                rec.residuals(primal, dual, mean_rho, nloop=nloop, group=gid, nadmm=a,
                              group_size=self.partition.group_size(gid))
            # under 'none' with per-minibatch evaluation the parameters are
            # those of the last record: a round-end record would repeat it
            if cfg.check_results and not (cfg.eval_every_batch and none):
                with rec.phase("eval", sync=self._sync, nloop=nloop, group=gid, nadmm=a):
                    accs = self.evaluate()
                rec.accuracies(accs, nloop=nloop, group=gid, nadmm=a)
        if admm:
            self._rho_store[gid] = cstate.rho
        rec.objective_passes(lstate, nloop=nloop, group=gid)
        self._sync()
        rec.step_time("round", time.perf_counter() - t_round, nloop=nloop, group=gid)

    def run_loop(self, nloop: int) -> None:
        """One outer loop: a round for each group of the order."""
        for gid in self.group_order:
            self.run_round(nloop, gid)

    def run(self) -> MetricsRecorder:
        """The experiment's outer loops from the restored cursor on (all
        Nloop of them in a fresh run), checkpointing with `save_model`."""
        start = self._completed_nloops
        for nloop in range(start, self.cfg.nloop):
            self.run_loop(nloop)
            self._completed_nloops = nloop + 1
            if self.cfg.save_model:
                self.save(step=self._completed_nloops)
        if self.cfg.save_model and start >= self.cfg.nloop:
            # no loop ran: the end still leaves a checkpoint at step nloop
            self.save(step=self.cfg.nloop)
        return self.recorder

    # ----------------------------------------------------------- checkpoint

    def save(self, step: int) -> str:
        """Write the full state as checkpoint `step`; returns its path."""
        state = {
            "flat": self.flat,
            "batch_stats": dict(self.stats),
            "completed_nloops": self._completed_nloops,
            # rho is the one piece of consensus state that outlives a round
            "rho_store": {str(g): r for g, r in self._rho_store.items()},
        }
        return save_checkpoint(self.cfg.checkpoint_dir, state, step=step)

    def _restore(self) -> None:
        """Restore the newest readable checkpoint (`load_checkpoint` falls
        back past one that does not load); FileNotFoundError if there is
        none. A checkpoint that loads but does not fit this run (another
        model or client count) raises."""
        self._apply_restore(load_checkpoint(self.cfg.checkpoint_dir))

    def _apply_restore(self, state: dict) -> None:
        flat = state["flat"]
        if tuple(flat.shape) != tuple(self.flat.shape):
            raise ValueError(f"checkpoint flat has shape {tuple(flat.shape)}, want {tuple(self.flat.shape)}")
        stats = state["batch_stats"]
        if sorted(stats) != sorted(self.stats):
            raise ValueError(f"checkpoint statistics have keys {sorted(stats)}, want {sorted(self.stats)}")
        self.flat = flat.to(self.device).contiguous()
        self.stats = {n: stats[n].to(self.device) for n in self.stats}
        self._completed_nloops = int(state["completed_nloops"])
        # cleared before the refill: a failed newer step must leave no
        # entry that an older checkpoint does not carry
        self._rho_store.clear()
        for g, r in state["rho_store"].items():
            self._rho_store[int(g)] = r.to(self.device)
