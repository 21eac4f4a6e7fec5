"""Partial-parameter federated averaging.

Counterpart of the JAX package's `consensus/fedavg.py` (its
`combine="mean"` branch with every client participating): after each
inner-optimization round the active group's coordinates are averaged
across clients, `znew = mean_k x_k`, the dual residual `‖z − znew‖/N` is
reported, and znew is broadcast back into every client. z starts at 0, so
the first residual is just `‖znew‖/N` — a reference quirk kept here.

The client axis is dim 0 of one tensor on one device, so the JAX
package's cross-device `psum` is a reduction over that axis.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .penalties import soft_threshold


class FedAvgState(NamedTuple):
    z: torch.Tensor  # [G] consensus vector


def fedavg_init(n: int, device="cpu", dtype=torch.float32) -> FedAvgState:
    """z starts at zero."""
    return FedAvgState(z=torch.zeros((n,), dtype=dtype, device=device))


def fedavg_round(
    x_local: torch.Tensor, state: FedAvgState, z_soft_threshold: float = 0.0
) -> Tuple[FedAvgState, dict]:
    """One averaging round over the client block `x_local [K, G]`.

    Returns the new state (z = cross-client mean) and the dual residual
    `‖z − znew‖/G` as a 0-d tensor (read by the caller when it logs).
    """
    n = x_local.shape[-1]
    znew = torch.mean(x_local, dim=0)
    if z_soft_threshold > 0.0:
        znew = soft_threshold(znew, z_soft_threshold)
    dual = torch.linalg.vector_norm(state.z - znew) / n
    return FedAvgState(z=znew), {"dual_residual": dual, "survivors": x_local.shape[0]}
