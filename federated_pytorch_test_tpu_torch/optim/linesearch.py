"""Batch-mode Armijo backtracking for the stochastic L-BFGS, K clients at once.

Counterpart of the JAX package's `optim/linesearch.py`
(`backtracking_armijo_aux`). The cubic full-batch search is not ported
yet.

The JAX package `vmap`s the search over the clients: its `while_loop`
runs while ANY client's condition holds and freezes the clients that are
done. The same rule is written out here: every probe evaluates all K
clients in one batched pass, and a finished client's
(alpha, loss, aux, count) are kept with `torch.where`, so the batched
result equals K independent searches.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch


def select(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """Per-client `where(mask, new, old)` over tensors or (named) tuples of them."""
    if isinstance(new, tuple):
        parts = [select(mask, n, o) for n, o in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def backtracking_armijo_aux(
    phi_aux: Callable[[torch.Tensor], Tuple[torch.Tensor, Any]],
    f_old: torch.Tensor,
    gtd: torch.Tensor,
    alphabar: torch.Tensor,
    c1: float = 1e-4,
    max_iters: int = 35,
    active: Optional[torch.Tensor] = None,
):
    """Armijo backtracking from max step `alphabar`, carrying eval aux.

    Start at `alphabar [K]`, halve while `f(x + a d) > f_old + a·c1·g·d`,
    up to `max_iters` halvings; the last step is returned even if the
    condition never held. `phi_aux(alpha [K]) -> (loss [K], aux)`. The
    returned aux belongs to the returned step: the search stops at the
    pair it accepts.

    `active [K]` restricts the search to clients that still iterate in
    the caller's loop (the others' results are discarded there); it
    changes no active client's result.

    Deciding whether any client still backtracks is one host read per
    halving.

    Returns `(alpha, n_evals, aux)`.
    """
    prod = c1 * gtd
    f_new, aux = phi_aux(alphabar)
    alpha = alphabar
    ci = torch.zeros_like(gtd, dtype=torch.int32)
    while True:
        live = (f_new > f_old + alpha * prod) & (ci < max_iters)
        if active is not None:
            live = live & active
        if not bool(live.any()):
            break
        alpha_half = 0.5 * alpha
        f_half, aux_half = phi_aux(alpha_half)
        ci = torch.where(live, ci + 1, ci)
        alpha = torch.where(live, alpha_half, alpha)
        f_new = torch.where(live, f_half, f_new)
        aux = select(live, aux_half, aux)
    return alpha, ci + 1, aux
