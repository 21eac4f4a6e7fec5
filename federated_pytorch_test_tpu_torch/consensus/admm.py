"""ADMM consensus with the optional Barzilai-Borwein adaptive penalty.

Counterpart of the JAX package's `consensus/admm.py`, its all-participate
`combine="mean"` branch (no fault mask, no separate aggregation view, no
robust combiner). One iteration over the active group's client block
`x [K, G]`:

  x-update: each client minimizes `loss + y·(x−z) + ρ/2‖x−z‖²`
            (`admm_penalty`, added to its loss by the engine);
  z-update: `znew = Σ_k ρ_k (y_k/ρ_k + x_k) / Σ_k ρ_k`, written as the JAX
            package writes it (`weighted_client_mean(y/ρ + x, ρ)`): the
            algebraically equal `Σ(y + ρx)/Σρ` rounds differently in f32;
  y-update: `y_k += ρ_k (x_k − znew)`.

Residuals: dual `‖z − znew‖/G`, primal `Σ_k ‖x_k − znew‖/(K·G)`.

BB rho runs every `bb_period` iterations, never on the first: with
`ŷ = y + ρ(x − z)` (the OLD rho), `Δy = ŷ − ŷ⁰`, `Δx = x − x⁰`, the
inner products d11 = Δy·Δy, d12 = Δy·Δx, d22 = Δx·Δx gate the proposal
(all > ε, |d12| > ε); the hybrid step `α̂ = αMG if 2αMG > αSD else
αSD − αMG/2` is accepted iff the correlation `d12/√(d11·d22)` reaches
`bb_alphacorrmin` and `α̂ < bb_rhomax`. The z-update then uses the new
rho. Reference quirks kept: ŷ⁰ starts at the group's starting x, not 0;
x⁰ is stored at nadmm 0 and at every due step, and ŷ⁰ at every due step,
whether or not the proposal was accepted.

The client axis is dim 0 of one tensor, so the JAX package's `psum`s are
reductions over it; `nadmm` is a host int.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .penalties import soft_threshold


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Hyper-parameters (the JAX package's defaults)."""

    rho0: float = 0.001
    bb_update: bool = False
    bb_period: int = 2
    bb_alphacorrmin: float = 0.2
    bb_epsilon: float = 1e-3
    bb_rhomax: float = 0.1
    z_soft_threshold: float = 0.0  # > 0: soft-threshold znew by this value


class ADMMState(NamedTuple):
    y: torch.Tensor  # [K, G] scaled duals
    z: torch.Tensor  # [G] consensus vector
    rho: torch.Tensor  # [K, 1] per-client penalty
    yhat0: torch.Tensor  # [K, G] BB: previous ŷ
    x0: torch.Tensor  # [K, G] BB: previous x


def admm_init(x: torch.Tensor, config: ADMMConfig) -> ADMMState:
    """Fresh state for a group round from its starting coordinates `x [K, G]`:
    y, z and x⁰ zero, rho = rho0, ŷ⁰ = x (the reference quirk)."""
    zero = torch.zeros_like(x)
    return ADMMState(
        y=zero,
        z=torch.zeros_like(x[0]),
        rho=torch.full((x.shape[0], 1), config.rho0, dtype=x.dtype, device=x.device),
        yhat0=x.clone(),
        x0=zero,
    )


def admm_penalty(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Augmented-Lagrangian term `y·(x−z) + ρ/2·‖x−z‖²` per client:
    `x, y [K, G]`, `z [G]`, `rho [K, 1]` -> `[K]`."""
    diff = x - z
    return (y * diff).sum(-1) + 0.5 * rho[:, 0] * (diff * diff).sum(-1)


def _bb_new_rho(rho, yhat, yhat0, x, x0, config: ADMMConfig) -> torch.Tensor:
    """Each client's BB proposal `[K, 1]` (rho where it is not accepted).

    Every branch is computed with safe denominators and selected, as the
    JAX package does, so an ill-posed client (|d12| ≤ ε, d11 ≤ ε or
    d22 ≤ ε) keeps its rho without dividing by a small number.
    """
    dy = yhat - yhat0
    dx = x - x0
    d11 = (dy * dy).sum(-1)
    d12 = (dy * dx).sum(-1)  # can be negative
    d22 = (dx * dx).sum(-1)
    eps = config.bb_epsilon
    one = torch.ones_like(d11)
    well_posed = (d12.abs() > eps) & (d11 > eps) & (d22 > eps)

    d12s = torch.where(d12.abs() > eps, d12, one)
    prod = torch.where(well_posed, d11 * d22, one)
    alpha = d12s / torch.sqrt(prod)
    alpha_sd = d11 / d12s
    alpha_mg = d12s / torch.where(d22 > eps, d22, one)
    alpha_hat = torch.where(2.0 * alpha_mg > alpha_sd, alpha_mg, alpha_sd - 0.5 * alpha_mg)

    accept = well_posed & (alpha >= config.bb_alphacorrmin) & (alpha_hat < config.bb_rhomax)
    return torch.where(accept, alpha_hat, rho[:, 0])[:, None]


def admm_round(x: torch.Tensor, state: ADMMState, nadmm: int, config: ADMMConfig) -> Tuple[ADMMState, dict]:
    """BB adaptation (when due), z-update and y-update of one ADMM iteration
    over `x [K, G]`, the clients' coordinates after their x-update.

    Returns the new state and `{"primal_residual", "dual_residual",
    "mean_rho"}` as 0-d tensors (read by the caller when it logs).
    """
    k, n = x.shape
    rho, x0, yhat0 = state.rho, state.x0, state.yhat0
    if config.bb_update:
        due = nadmm > 0 and nadmm % config.bb_period == 0
        if due:
            yhat = state.y + state.rho * (x - state.z)  # the OLD rho
            rho = _bb_new_rho(state.rho, yhat, state.yhat0, x, state.x0, config)
            yhat0 = yhat
        if due or nadmm == 0:
            x0 = x.clone()

    znew = ((state.y / rho + x) * rho).sum(0) / rho.sum(0)
    if config.z_soft_threshold > 0.0:
        znew = soft_threshold(znew, config.z_soft_threshold)
    dual = torch.linalg.vector_norm(state.z - znew) / n
    y = state.y + rho * (x - znew)
    primal = torch.linalg.vector_norm(x - znew, dim=-1).sum() / (k * n)
    mean_rho = rho.sum() / k
    new_state = ADMMState(y=y, z=znew, rho=rho, yhat0=yhat0, x0=x0)
    return new_state, {"primal_residual": primal, "dual_residual": dual, "mean_rho": mean_rho}
