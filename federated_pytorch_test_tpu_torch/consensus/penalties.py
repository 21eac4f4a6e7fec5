"""Regularization helpers: elastic net on linear partitions, soft threshold.

Counterpart of the JAX package's `consensus/penalties.py`. Both act on
the last axis, so `[K, G]` stacked clients get one penalty per client.
"""

from __future__ import annotations

import torch


def elastic_net(v: torch.Tensor, lambda1: float, lambda2: float) -> torch.Tensor:
    """`λ1‖v‖₁ + λ2‖v‖₂²` over the last axis.

    |v| is written as a select so that its gradient at v = 0 is +1, the
    subgradient JAX's `abs` takes there (`torch.abs` takes 0). A
    coordinate that an L-BFGS step lands exactly on 0 otherwise gets a
    gradient λ1 apart in the two packages, and the next steps scale that
    by the inverse-Hessian estimate.
    """
    l1 = torch.where(v >= 0, v, -v)
    return lambda1 * torch.sum(l1, dim=-1) + lambda2 * torch.sum(v * v, dim=-1)


def soft_threshold(z: torch.Tensor, sval: float) -> torch.Tensor:
    """Soft shrinkage `sign(z)·max(|z|−sval, 0)`."""
    return torch.sign(z) * torch.clamp(torch.abs(z) - sval, min=0.0)
