"""Per-group step functions: client training step, epoch, consensus, eval.

Counterpart of the fedavg path of the JAX package's `engine/steps.py`.
The K clients are the leading axis of every tensor (`flat [K, N]`), as
the JAX package `vmap`s them; the model's `forward_batched` runs all
clients in one launch per layer.

* `client_train_step` — one L-BFGS step of every client on the active
  group's coordinates, with the elastic net on that group when it is a
  linear layer. The per-batch diagnostic loss is folded into the
  accepted line-search evaluation (the JAX package's `fold` path): the
  Armijo-accepted evaluation is at the step's final parameters, so its
  data loss is the diagnostic without an extra model pass.
* `run_epoch` — the lockstep minibatches of one epoch.
* `round_init` — a fresh optimizer state and z = 0 per group round.
* `fedavg_consensus` — z = client mean of the group, broadcast back.
* `evaluate` — per-client correct counts over the test set.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..consensus import FedAvgState, elastic_net, fedavg_init, fedavg_round
from ..data import normalize
from ..models import PartitionedModel
from ..optim import LBFGSConfig, LBFGSState, lbfgs_init, lbfgs_step
from ..partition import Partition, leaf_offsets, unflatten_params


@dataclasses.dataclass(frozen=True)
class GroupContext:
    """Everything static a group's step functions close over."""

    model: PartitionedModel
    shapes: dict  # {name: shape} of one client's parameters
    partition: Partition
    gid: int
    lbfgs: LBFGSConfig
    reg_on_active: bool  # elastic net on the active (linear) group
    lambda1: float = 1e-4
    lambda2: float = 1e-4


def data_loss(ctx: GroupContext, params: dict, images: torch.Tensor, labels: torch.Tensor):
    """Per-client mean cross-entropy `[K]` of stacked params `{name: [K, ...]}`."""
    logits = ctx.model.forward_batched(params, images)
    k, b, c = logits.shape
    ce = F.cross_entropy(logits.reshape(k * b, c), labels.reshape(k * b).long(), reduction="none")
    return ce.reshape(k, b).mean(dim=1)


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


def client_train_step(
    ctx: GroupContext,
    flat: torch.Tensor,
    lstate: LBFGSState,
    images_u8: torch.Tensor,
    labels: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
) -> Tuple[torch.Tensor, LBFGSState, torch.Tensor]:
    """One optimizer step of all K clients on group `ctx.gid`.

    `flat [K, N]` is updated in place and returned with the new optimizer
    state and the per-client diagnostic data loss `[K]` at the accepted
    parameters (the entry data loss where the NaN-step fallback left the
    final point unevaluated).
    """
    images = normalize(images_u8, mean, std)
    base = flat.detach()

    def objective(x):
        dl = data_loss(ctx, _group_params(ctx, base, x), images, labels)
        loss = dl
        if ctx.reg_on_active:
            loss = loss + elastic_net(x, ctx.lambda1, ctx.lambda2)
        return loss, (dl,)

    x0 = ctx.partition.extract(flat, ctx.gid).contiguous()
    x1, lstate, aux = lbfgs_step(objective, x0, lstate, ctx.lbfgs, has_aux=True)
    ctx.partition.insert_(flat, ctx.gid, x1)
    (dl_final,) = aux.aux
    (dl_entry,) = aux.entry_aux
    return flat, lstate, torch.where(aux.aux_ok, dl_final, dl_entry)


def epoch_batches(shard_imgs, shard_labels, idx: np.ndarray):
    """Yield the lockstep minibatches `([K,B,H,W,C] u8, [K,B])` of `idx [S,K,B]`."""
    k = shard_imgs.shape[0]
    rows = torch.arange(k, device=shard_imgs.device)[:, None]
    idx_t = torch.as_tensor(idx, dtype=torch.long).to(shard_imgs.device)
    for s in range(idx_t.shape[0]):
        yield shard_imgs[rows, idx_t[s]], shard_labels[rows, idx_t[s]]


def run_epoch(ctx, flat, lstate, shard_imgs, shard_labels, idx, mean, std):
    """One epoch over `idx [S, K, B]`; returns (flat, lstate, losses [S, K])."""
    losses = []
    for images, labels in epoch_batches(shard_imgs, shard_labels, idx):
        flat, lstate, loss = client_train_step(ctx, flat, lstate, images, labels, mean, std)
        losses.append(loss)
    return flat, lstate, torch.stack(losses)


def round_init(ctx: GroupContext, flat: torch.Tensor) -> Tuple[LBFGSState, FedAvgState]:
    """Fresh per-group optimizer state and consensus state (z = 0)."""
    x = ctx.partition.extract(flat, ctx.gid).contiguous()
    return lbfgs_init(x, ctx.lbfgs), fedavg_init(x.shape[1], device=x.device, dtype=x.dtype)


def fedavg_consensus(ctx: GroupContext, flat: torch.Tensor, state: FedAvgState):
    """FedAvg over the active group: z = client mean, broadcast back into
    every client (all clients participate). Returns (flat, state, dual)."""
    x = ctx.partition.extract(flat, ctx.gid)
    state, met = fedavg_round(x, state)
    ctx.partition.insert_(flat, ctx.gid, state.z.expand(flat.shape[0], -1))
    return flat, state, met["dual_residual"]


@torch.no_grad()
def evaluate(model, shapes, flat, test_imgs, test_labels, test_mask, mean, std) -> torch.Tensor:
    """Per-client correct counts `[K]` over the stacked test sweep `[T, B, ...]`.

    Every client sees the same test images under its own normalization.
    """
    k = flat.shape[0]
    params = unflatten_params(flat, shapes)
    correct = torch.zeros((k,), dtype=torch.int64, device=flat.device)
    for img, lab, msk in zip(test_imgs, test_labels, test_mask):
        x = normalize(img.unsqueeze(0).expand(k, *img.shape), mean, std)
        pred = model.forward_batched(params, x).argmax(dim=-1)
        correct += ((pred == lab.long()) & msk).sum(dim=1)
    return correct
