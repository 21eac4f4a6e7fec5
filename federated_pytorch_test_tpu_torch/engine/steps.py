"""Per-group step functions: client training step, epoch, consensus, eval.

Counterpart of the none, fedavg and admm paths of the JAX package's
`engine/steps.py`. The K clients are the leading axis of every tensor
(`flat [K, N]`), as the JAX package `vmap`s them; the model's
`forward_batched` runs all clients in one launch per layer.

* `objective` — the clients' loss at the active group's coordinates.
* `client_train_step` — one L-BFGS step of every client on the active
  group's coordinates, with the elastic net on that group when it is a
  linear layer or on fixed segments of the full vector (`reg_segments`)
  and, under ADMM, the augmented-Lagrangian term. The
  per-batch diagnostic loss and a BatchNorm model's new running
  statistics are folded into the accepted line-search evaluation (the
  JAX package's `fold` path): the Armijo-accepted evaluation is at the
  step's final parameters, so its data loss and statistics come without
  an extra model pass, and no line-search probe touches the statistics.
* `fan_objective` — the objective at a fan of P line-search probes a
  client (`linesearch_probes > 1`), one batched pass, in either fold
  (`client_fold`): 'vmap' runs K·P clients, every leaf and input repeated
  P times (the fan's plain reference); 'gemm' repeats only the active
  group's leaves, so the layers below it run once a fan and the frozen
  layers above it on a P-times-wider batch (`models/base.py`), BatchNorm
  statistics and MoE capacities kept per (client, probe).
* `run_epoch` — the lockstep minibatches of one epoch.
* `round_init` — a fresh optimizer state and consensus state per group
  round (independent training: none; FedAvg: z = 0; ADMM: y = z = 0,
  rho = rho0).
* `fedavg_consensus` — z = client mean of the group, broadcast back.
* `admm_consensus` — BB rho (when due), z-update, y-update; the clients
  keep their own x.
* `evaluate` — per-client correct counts over the test set, a BatchNorm
  model normalizing with each client's running averages.

Mixed precision (a model whose `dtype` is bf16, the engine's
`compute_dtype`), as the JAX package's step: the frozen coordinates are
cast to the model's dtype once a minibatch, the active group's inside each
evaluation (so its gradient comes back f32), the logits are cast to f32
before the cross-entropy, and the elastic net, the ADMM term and the
optimizer stay f32. `remat` wraps each evaluation in
`torch.utils.checkpoint` (non-reentrant): the gradient passes recompute the
forward instead of keeping its activations, and the line-search probes,
which take no gradient, run as before.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..consensus import (
    ADMMConfig,
    ADMMState,
    FedAvgState,
    admm_init,
    admm_penalty,
    admm_round,
    elastic_net,
    fedavg_init,
    fedavg_round,
)
from ..data import normalize
from ..models import PartitionedModel
from ..models.base import widen_clients
from ..optim import LBFGSConfig, LBFGSState, lbfgs_init, lbfgs_step
from ..optim.linesearch import select
from ..partition import Partition, Segment, leaf_offsets, unflatten_params


@dataclasses.dataclass(frozen=True)
class GroupContext:
    """Everything static a group's step functions close over."""

    model: PartitionedModel
    shapes: dict  # {name: shape} of one client's parameters
    partition: Partition
    gid: int
    lbfgs: LBFGSConfig
    reg_on_active: bool  # elastic net on the active (linear) group
    # elastic net on these fixed segments of the full vector (reg_mode
    # first_linear: the model's first linear group)
    reg_segments: Tuple[Segment, ...] = ()
    lambda1: float = 1e-4
    lambda2: float = 1e-4
    moe_aux_coef: float = 0.0  # weight of the MoE load-balance term (0: the model has no experts)
    strategy: str = "fedavg"  # none | fedavg | admm
    admm: ADMMConfig = ADMMConfig()
    remat: bool = False  # recompute each evaluation's forward in its backward
    client_fold: str = "vmap"  # how a probe fan batches its probes: 'vmap' | 'gemm' (the engine's default)


def data_loss(ctx: GroupContext, params: dict, images: torch.Tensor, labels: torch.Tensor):
    """Per-client data loss `[K]` of stacked params `{name: [K, ...]}`: the
    mean cross-entropy, plus `moe_aux_coef` times the load-balance term
    summed over the MoE layers where the context has a coefficient."""
    if ctx.moe_aux_coef:
        logits, aux = ctx.model.forward_batched(params, images, return_aux=True)
    else:
        logits = ctx.model.forward_batched(params, images)
    loss = _cross_entropy(logits, labels)
    return loss + ctx.moe_aux_coef * widen_clients(aux, loss.shape[0]) if ctx.moe_aux_coef else loss


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-client mean cross-entropy `[K]` of logits `[K, B, C]`, in f32
    whatever the logits' dtype (labels `[K, B]`, repeated for a fan's K·P)."""
    labels = widen_clients(labels, logits.shape[0])
    k, b, c = logits.shape
    ce = F.cross_entropy(logits.float().reshape(k * b, c), labels.reshape(k * b).long(), reduction="none")
    return ce.reshape(k, b).mean(dim=1)


def data_loss_and_stats(ctx: GroupContext, params: dict, stats: dict, images, labels):
    """`data_loss` and the clients' updated statistics: a BatchNorm model
    (non-empty `stats`) runs in train mode and returns its new running
    averages; any other model returns `stats` as it was."""
    if not stats:
        return data_loss(ctx, params, images, labels), stats
    logits, new_stats = ctx.model.forward_batched(params, images, stats=stats)
    return _cross_entropy(logits, labels), new_stats


def _group_params(ctx: GroupContext, base: torch.Tensor, x: torch.Tensor) -> dict:
    """Stacked params of `base [K, N]` with the active group's leaves taken
    from `x [K, G]`.

    Groups are unions of whole leaves, so only the active group's leaves
    are views of `x` (and carry gradients); every other leaf is a view of
    the detached `base`, and autograd computes no weight gradient for it.
    """
    params = unflatten_params(base, ctx.shapes)
    off = 0
    for seg in ctx.partition.groups[ctx.gid]:
        for path, start, size in leaf_offsets(ctx.shapes):
            if seg.start <= start and start + size <= seg.start + seg.size:
                name = ".".join(path)
                lo = off + start - seg.start
                params[name] = x[:, lo : lo + size].reshape(x.shape[0], *ctx.shapes[name])
        off += seg.size
    return params


def _segments(ctx: GroupContext, base: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`ctx.reg_segments` of the full vector `[K, N]` with the active group
    taken from `x`, concatenated: the coordinates the group trains carry
    its gradient, the frozen ones are constants. Under strategy 'none' the
    group is the whole vector, so every segment is read from `x`."""
    full = ctx.partition.insert(widen_clients(base, x.shape[0]), ctx.gid, x)
    parts = [full[:, s.start : s.start + s.size] for s in ctx.reg_segments]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def objective(ctx: GroupContext, base: torch.Tensor, x: torch.Tensor, stats: dict, images, labels, cstate=None,
              base_c: Optional[torch.Tensor] = None):
    """The clients' objective `[K]` at the active group's coordinates
    `x [K, G]` (the rest of the parameters from `base [K, N]`): the data
    loss, the elastic net on the active group or on `ctx.reg_segments`,
    and under ADMM the augmented-Lagrangian term. Returns `(objective,
    data loss, new statistics)` on normalized `images`.

    The model runs on parameters in its compute dtype: `base_c` is `base`
    already cast to it (once a minibatch; cast here when None), `x` is cast
    here, so the gradient reaches the f32 `x`. The penalties read the f32
    coordinates."""
    dt = ctx.model.dtype
    if dt != torch.float32:
        params = _group_params(ctx, base.to(dt) if base_c is None else base_c, x.to(dt))
    else:
        params = _group_params(ctx, base, x)
    dl, new_stats = data_loss_and_stats(ctx, params, stats, images, labels)
    loss = dl
    if ctx.reg_on_active:
        loss = loss + elastic_net(x, ctx.lambda1, ctx.lambda2)
    if ctx.reg_segments:
        loss = loss + elastic_net(_segments(ctx, base, x), ctx.lambda1, ctx.lambda2)
    if ctx.strategy == "admm":
        loss = loss + admm_penalty(x, cstate.y, cstate.z, cstate.rho)
    return loss, dl, new_stats


def fan_objective(ctx: GroupContext, base: torch.Tensor, x: torch.Tensor, stats: dict, images, labels,
                  cstate=None, base_c: Optional[torch.Tensor] = None):
    """`objective` at a fan's K·P points `x [K·P, G]` (client-major: row
    k·P + p is client k's probe p) in one batched pass, by `ctx.client_fold`:
    'vmap' repeats every input P times and runs K·P clients; 'gemm' hands
    the model the K clients' frozen leaves and images as they are and the
    active leaves P-wide (module docstring). Returns `(objective [K·P],
    data loss [K·P], new statistics {name: [K·P, ...]})`."""
    kp = x.shape[0]
    if ctx.client_fold == "vmap":
        base = widen_clients(base, kp)
        base_c = None if base_c is None else widen_clients(base_c, kp)
        stats = {n: widen_clients(t, kp) for n, t in stats.items()}
        images = widen_clients(images, kp)
    if cstate is not None:
        cstate = cstate._replace(y=widen_clients(cstate.y, kp), rho=widen_clients(cstate.rho, kp))
    loss, dl, new_stats = objective(ctx, base, x, stats, images, labels, cstate, base_c)
    return loss, dl, {n: widen_clients(t, kp) for n, t in new_stats.items()}


def client_train_step(
    ctx: GroupContext,
    flat: torch.Tensor,
    lstate: LBFGSState,
    stats: dict,
    images_u8: torch.Tensor,
    labels: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    cstate: Optional[ADMMState] = None,
) -> Tuple[torch.Tensor, LBFGSState, dict, torch.Tensor]:
    """One optimizer step of all K clients on group `ctx.gid`.

    `flat [K, N]` is updated in place and returned with the new optimizer
    state, the clients' statistics `{name: [K, ...]}` (empty for a model
    without BatchNorm) and the per-client diagnostic data loss `[K]`, all
    taken at the accepted parameters. Where the NaN-step fallback left the
    final point unevaluated, the entry data loss is reported and the
    previous statistics are kept. `cstate` holds y, z and rho under ADMM.
    """
    images = normalize(images_u8, mean, std)
    base = flat.detach()
    dt = ctx.model.dtype
    base_c = base.to(dt) if dt != torch.float32 else None  # the frozen coordinates, cast once a minibatch
    names = list(stats)

    def evaluation(x):
        loss, dl, new_stats = objective(ctx, base, x, stats, images, labels, cstate, base_c)
        return loss, (dl, *(new_stats[n] for n in names))

    def loss_fn(x):
        if ctx.remat and torch.is_grad_enabled():
            return checkpoint(evaluation, x, use_reentrant=False)
        return evaluation(x)

    def fan_fn(x, d, alphas):
        # the probes x + α·d as the sequential search forms each one
        k, p = alphas.shape
        xs = (x[:, None, :] + alphas[:, :, None] * d[:, None, :]).reshape(k * p, -1)
        loss, dl, new_stats = fan_objective(ctx, base, xs, stats, images, labels, cstate, base_c)
        return loss.reshape(k, p), tuple(t.reshape(k, p, *t.shape[1:]) for t in (dl, *(new_stats[n] for n in names)))

    x0 = ctx.partition.extract(flat, ctx.gid).contiguous()
    x1, lstate, aux = lbfgs_step(loss_fn, x0, lstate, ctx.lbfgs, has_aux=True, fan_fn=fan_fn)
    ctx.partition.insert_(flat, ctx.gid, x1)
    dl_final, *stats_final = aux.aux
    stats = dict(zip(names, select(aux.aux_ok, tuple(stats_final), tuple(stats[n] for n in names))))
    return flat, lstate, stats, torch.where(aux.aux_ok, dl_final, aux.entry_aux[0])


def epoch_batches(shard_imgs, shard_labels, idx: np.ndarray):
    """Yield the lockstep minibatches `([K,B,H,W,C] u8, [K,B])` of `idx [S,K,B]`."""
    k = shard_imgs.shape[0]
    rows = torch.arange(k, device=shard_imgs.device)[:, None]
    idx_t = torch.as_tensor(idx, dtype=torch.long).to(shard_imgs.device)
    for s in range(idx_t.shape[0]):
        yield shard_imgs[rows, idx_t[s]], shard_labels[rows, idx_t[s]]


def run_epoch(ctx, flat, lstate, stats, shard_imgs, shard_labels, idx, mean, std, cstate=None, after_step=None):
    """One epoch over `idx [S, K, B]`; returns (flat, lstate, stats, losses [S, K]).

    `after_step(s, flat, stats)`, when given, is called after minibatch `s`
    with the parameters and statistics that step left (per-minibatch
    evaluation)."""
    losses = []
    for s, (images, labels) in enumerate(epoch_batches(shard_imgs, shard_labels, idx)):
        flat, lstate, stats, loss = client_train_step(ctx, flat, lstate, stats, images, labels, mean, std, cstate)
        losses.append(loss)
        if after_step is not None:
            after_step(s, flat, stats)
    return flat, lstate, stats, torch.stack(losses)


def round_init(
    ctx: GroupContext, flat: torch.Tensor
) -> Tuple[LBFGSState, Union[None, FedAvgState, ADMMState]]:
    """Fresh per-group optimizer state and consensus state: none for
    independent training, FedAvg's z = 0, or ADMM's y = z = 0, rho = rho0
    (the trainer carries rho across loops)."""
    x = ctx.partition.extract(flat, ctx.gid).contiguous()
    if ctx.strategy == "none":
        return lbfgs_init(x, ctx.lbfgs), None
    if ctx.strategy == "admm":
        return lbfgs_init(x, ctx.lbfgs), admm_init(x, ctx.admm)
    return lbfgs_init(x, ctx.lbfgs), fedavg_init(x.shape[1], device=x.device, dtype=x.dtype)


def fedavg_consensus(ctx: GroupContext, flat: torch.Tensor, state: FedAvgState):
    """FedAvg over the active group: z = client mean, broadcast back into
    every client (all clients participate). Returns (flat, state, dual)."""
    x = ctx.partition.extract(flat, ctx.gid)
    state, met = fedavg_round(x, state)
    ctx.partition.insert_(flat, ctx.gid, state.z.expand(flat.shape[0], -1))
    return flat, state, met["dual_residual"]


def admm_consensus(ctx: GroupContext, flat: torch.Tensor, state: ADMMState, nadmm: int):
    """One ADMM iteration over the active group: BB rho when due, then the
    z- and y-updates. The clients keep their own x: nothing is broadcast
    back. Returns (state, {"primal_residual", "dual_residual", "mean_rho"})."""
    return admm_round(ctx.partition.extract(flat, ctx.gid), state, nadmm, ctx.admm)


@torch.no_grad()
def evaluate(model, shapes, flat, test_imgs, test_labels, test_mask, mean, std, stats=None) -> torch.Tensor:
    """Per-client correct counts `[K]` over the stacked test sweep `[T, B, ...]`.

    Every client sees the same test images under its own normalization; a
    BatchNorm model (non-empty `stats`) normalizes with each client's
    running averages.
    """
    k = flat.shape[0]
    params = unflatten_params(flat, shapes)
    correct = torch.zeros((k,), dtype=torch.int64, device=flat.device)
    for img, lab, msk in zip(test_imgs, test_labels, test_mask):
        x = normalize(img.unsqueeze(0).expand(k, *img.shape), mean, std)
        logits = model.forward_batched(params, x, stats=stats, train=False) if stats else model.forward_batched(params, x)
        pred = logits.argmax(dim=-1)
        correct += ((pred == lab.long()) & msk).sum(dim=1)
    return correct
