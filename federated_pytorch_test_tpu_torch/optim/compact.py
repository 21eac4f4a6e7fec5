"""Compact-representation L-BFGS direction, batched over K clients.

Counterpart of the JAX package's `optim/compact.py`. The Byrd–Nocedal–
Schnabel compact form writes the two-loop recursion's inverse-Hessian
product in closed form:

    H g = γ g + [S  γY] · [[ R⁻ᵀ(D + γ YᵀY) R⁻¹,  −R⁻ᵀ ],
                           [ −R⁻¹,                 0    ]] · [Sᵀg; γ Yᵀg]

with S, Y the `[m, N]` step / gradient-difference history, R the upper
triangle of S Yᵀ, D its diagonal and γ the initial Hessian scale
(`h_diag`). The heavy work is a few `[m, N]` contractions; the two m×m
triangular solves are negligible at m = 10.

Every tensor carries a leading client axis: S, Y `[K, m, N]`, g `[K, N]`,
count and h_diag `[K]`. The JAX package `vmap`s the per-client function;
here the batch axis is written out and the solves run batched.

Invalid history slots (`i >= count`, or degenerate `yᵢ·sᵢ = 0`) are
masked by zeroing their rows and pinning R's diagonal to 1 there, so the
solves stay non-singular while the slot contributes exactly nothing. That
sequence lives in `compact_solves`, shared with the CUDA backend
(`ops/compact_cuda.py`) so the two backends cannot drift.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched `[K, m, N] x [K, N] -> [K, m]` contraction."""
    return torch.matmul(a, b.unsqueeze(-1)).squeeze(-1)


def compact_solves(
    sy: torch.Tensor,
    p: torch.Tensor,
    q: torch.Tensor,
    valid: torch.Tensor,
    h_diag: torch.Tensor,
    yyu: Callable[[torch.Tensor], Tuple[torch.Tensor, object]],
):
    """The middle section shared by both compact backends.

    Given `sy = S Yᵀ [K,m,m]`, `p = Sᵀg`, `q = Yᵀg [K,m]` (computed over
    `valid`-masked rows), masks degenerate-curvature slots, builds R and
    runs the two triangular solves. `yyu(u)` returns `((YᵀY) u, aux)`.

    Returns `(u, w, ok, aux)` with `u = R⁻¹Sᵀg` and
    `w = R⁻ᵀ((D + γ YᵀY)u − γ Yᵀg)`, both exactly zero at non-`ok` slots.
    """
    zero = torch.zeros((), dtype=sy.dtype, device=sy.device)
    d_diag = torch.diagonal(sy, dim1=-2, dim2=-1)
    ok = valid & (d_diag != 0.0)
    pair = ok[..., :, None] & ok[..., None, :]
    sy = torch.where(pair, sy, zero)
    p = torch.where(ok, p, zero)
    q = torch.where(ok, q, zero)
    d_diag = torch.diagonal(sy, dim1=-2, dim2=-1)

    # invalid diagonals pinned to 1: the rhs is 0 there, so u, w are 0 too
    # (the re-masking below guards NaN-contaminated invalid slots)
    pin = torch.where(ok, zero, torch.ones((), dtype=sy.dtype, device=sy.device))
    r = torch.triu(sy) + torch.diag_embed(pin)
    h = h_diag[..., None]

    u = torch.linalg.solve_triangular(r, p[..., None], upper=True)[..., 0]
    u = torch.where(ok, u, zero)
    yyu_vec, aux = yyu(u)
    rhs = d_diag * u + h * yyu_vec - h * q
    # R⁻ᵀ rhs: Rᵀ is lower triangular
    w = torch.linalg.solve_triangular(r.transpose(-1, -2), rhs[..., None], upper=False)[..., 0]
    w = torch.where(ok, w, zero)
    return u, w, ok, aux


def history_valid(count: torch.Tensor, m: int) -> torch.Tensor:
    """`[K, m]` validity of the history slots: `i < count[k]`."""
    return torch.arange(m, device=count.device) < count[..., None]


def compact_direction(
    g: torch.Tensor,
    s_hist: torch.Tensor,
    y_hist: torch.Tensor,
    count: torch.Tensor,
    h_diag: torch.Tensor,
) -> torch.Tensor:
    """-H·g via the compact representation over the valid history slots.

    `s_hist`/`y_hist` are `[K, m, N]` chronological buffers of which the
    first `count[k]` rows are valid for client k. Plain PyTorch: the
    port's `"compact"` backend.
    """
    m = s_hist.shape[-2]
    valid = history_valid(count, m)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    s = torch.where(valid[..., None], s_hist, zero)
    y = torch.where(valid[..., None], y_hist, zero)

    sy = torch.matmul(s, y.transpose(-1, -2))  # sy[i, j] = s_i . y_j
    p = _bdot(s, g)  # Sᵀg [K, m]
    q = _bdot(y, g)  # Yᵀg [K, m]

    def yyu(u):
        # (YᵀY)u contracted as Y(uᵀY); `uy` is reused in the assembly
        uy = torch.matmul(u.unsqueeze(-2), y).squeeze(-2)  # [K, N]
        return _bdot(y, uy), uy

    _u, w, _, uy = compact_solves(sy, p, q, valid, h_diag, yyu)

    h = h_diag[..., None]
    hg = h * g + torch.matmul(w.unsqueeze(-2), s).squeeze(-2) - h * uy
    return -hg
