"""Line searches for the stochastic L-BFGS, K clients at once.

Counterpart of the JAX package's `optim/linesearch.py`:

* `backtracking_armijo_aux` — batch mode: halve the step from `alphabar`
  until the Armijo condition holds, at most 35 times;
* `backtracking_armijo_probes_aux` — the same ladder evaluated in fans of
  P consecutive rungs, one batched pass a fan, the first Armijo-satisfying
  rung picked on the device;
* `cubic_linesearch` — full-batch mode: Fletcher bracketing with cubic
  interpolation and a zoom stage, directional derivatives by central
  differences of the loss (step 1e-6), as in the JAX package.

The JAX package `vmap`s each search over the clients: its `while_loop`
runs while ANY client's condition holds and freezes the clients that are
done. The same rule is written out here: every evaluation covers all K
clients in one batched pass, and a finished client's carry is kept with
`torch.where`, so the batched result equals K independent searches.
Whether any client still searches is one host read per loop iteration.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


def select(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """Per-client `where(mask, new, old)` over tensors or (named) tuples of
    them. A leaf that is the same object on both sides (a buffer updated in
    place) is returned as it is."""
    if new is old:
        return old
    if isinstance(new, tuple):
        parts = [select(mask, n, o) for n, o in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def take_rung(aux: Any, pick: torch.Tensor) -> Any:
    """Each client's rung `pick [K]` of fan leaves `[K, P, ...]` (tuples mapped)."""
    if isinstance(aux, tuple):
        return tuple(take_rung(a, pick) for a in aux)
    return aux[torch.arange(aux.shape[0], device=aux.device), pick]


def backtracking_armijo_aux(
    phi_aux: Callable[[torch.Tensor], Tuple[torch.Tensor, Any]],
    f_old: torch.Tensor,
    gtd: torch.Tensor,
    alphabar: torch.Tensor,
    c1: float = 1e-4,
    max_iters: int = 35,
    active: Optional[torch.Tensor] = None,
    read: Callable[[torch.Tensor], bool] = bool,
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
    halving (`read`, which a caller may wrap to count them).

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
        if not read(live.any()):
            break
        alpha_half = 0.5 * alpha
        f_half, aux_half = phi_aux(alpha_half)
        ci = torch.where(live, ci + 1, ci)
        alpha = torch.where(live, alpha_half, alpha)
        f_new = torch.where(live, f_half, f_new)
        aux = select(live, aux_half, aux)
    return alpha, ci + 1, aux


def backtracking_armijo_probes_aux(
    fan_aux: Callable[[torch.Tensor], Tuple[torch.Tensor, Any]],
    f_old: torch.Tensor,
    gtd: torch.Tensor,
    alphabar: torch.Tensor,
    c1: float = 1e-4,
    max_iters: int = 35,
    probes: int = 4,
    active: Optional[torch.Tensor] = None,
    read: Callable[[torch.Tensor], bool] = bool,
):
    """Armijo backtracking over fans of `probes` consecutive halving rungs.

    The JAX package's `backtracking_armijo_probes_aux`. Fan i evaluates
    the rungs `alphabar·2^-j`, j = i·P … i·P + P − 1, in one call
    `fan_aux(alphas [K, P]) -> (losses [K, P], aux with [K, P, ...]
    leaves)`, and each client takes its first rung with
    `~(f > f_old + α·c1·gtd)` — a NaN loss is accepted, as in the
    sequential search (the reference's rule) — or, when the ladder runs
    out, its rung `max_iters`. A client that accepted keeps its pick while
    the others fan on; `active [K]` stops the loop for clients the caller
    no longer iterates, as in `backtracking_armijo_aux`.

    The picked rung is the sequential search's wherever `fan_aux` returns
    the losses that `phi_aux` would. `n_evals` counts every rung evaluated
    for the client: P a fan it took part in, minus the rungs past
    `max_iters` in its last fan (the JAX package's count). One host read
    per fan (`read`).

    Returns `(alpha, n_evals, aux)`; the aux belongs to the returned alpha.
    """
    if probes < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    k = gtd.shape[0]
    dev, dt = alphabar.device, alphabar.dtype
    prod = c1 * gtd
    n_rungs = max_iters + 1  # the sequential search evaluates at most these
    n_fans = -(-n_rungs // probes)
    offsets = 0.5 ** torch.arange(probes, dtype=dt, device=dev)
    fan_step = 0.5**probes
    rows = torch.arange(k, device=dev)

    def fan_eval(base, j0):
        """One fan of `probes` rungs from `base`, the first at rung `j0`."""
        alphas = base[:, None] * offsets
        losses, auxs = fan_aux(alphas)
        n_valid = min(probes, n_rungs - j0)
        valid = torch.arange(probes, device=dev) < n_valid
        ok = valid & ~(losses > f_old[:, None] + alphas * prod[:, None])
        any_ok = ok.any(dim=1)
        first_ok = ok.to(torch.int8).argmax(dim=1)  # the first True
        pick = torch.where(any_ok, first_ok, n_valid - 1)
        # exhausting the ladder ends the search like the sequential budget
        done = any_ok | (j0 + n_valid - 1 >= max_iters)
        return alphas[rows, pick], take_rung(auxs, pick), n_valid, done

    alpha, aux, n_valid, done = fan_eval(alphabar, 0)
    evals = torch.full((k,), n_valid, dtype=torch.int32, device=dev)
    base = alphabar
    for fan in range(1, n_fans):
        live = ~done if active is None else ~done & active
        if not read(live.any()):  # the one host read of a fan
            break
        base = base * fan_step
        a, x, n_valid, d = fan_eval(base, fan * probes)
        alpha = torch.where(live, a, alpha)
        aux = select(live, x, aux)
        done = torch.where(live, d, done)
        evals = torch.where(live, evals + n_valid, evals)
    return alpha, evals, aux


class _CubicConsts(NamedTuple):
    sigma: float = 0.1
    rho: float = 0.01
    t1: float = 9.0
    t2: float = 0.1
    t3: float = 0.5


PhiFn = Callable[[torch.Tensor], torch.Tensor]  # alpha [K] -> loss(x + alpha·d) [K]


def _dphi(phi: PhiFn, a: torch.Tensor, step: float) -> torch.Tensor:
    """Central-difference directional derivative, two batched passes."""
    return (phi(a + step) - phi(a - step)) / (2.0 * step)


def _cubic_interpolate(phi: PhiFn, a: torch.Tensor, b: torch.Tensor, step: float) -> torch.Tensor:
    """Cubic minimizer on [a, b] (or [b, a]) per client.

    The JAX package's `lax.cond` on `disc > 0` becomes a `where`, as it does
    under `vmap`: the in-range probe is evaluated for every client.
    """
    f0 = phi(a)
    f0d = _dphi(phi, a, step)
    f1 = phi(b)
    f1d = _dphi(phi, b, step)

    aa = 3.0 * (f0 - f1) / (b - a) + f1d - f0d
    disc = aa * aa - f0d * f1d

    cc = torch.sqrt(torch.clamp(disc, min=0.0))
    denom = f1d - f0d + 2.0 * cc
    z0 = torch.where(denom == 0.0, (a + b) * 0.5, b - (f1d + cc - aa) * (b - a) / denom)
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    in_range = (z0 <= hi) & (z0 >= lo)
    # out-of-range probes get f0 + f1 so they lose the 3-way minimum
    fz0 = torch.where(in_range, phi(torch.minimum(torch.maximum(z0, lo), hi)), f0 + f1)
    best_ab = torch.where(f1 < fz0, b, z0)
    pos = torch.where((f0 < f1) & (f0 < fz0), a, best_ab)
    neg = torch.where(f0 < f1, a, b)
    return torch.where(disc > 0.0, pos, neg)


def _zoom(phi: PhiFn, a, b, phi_0, gphi_0, consts: _CubicConsts, step: float, searching: torch.Tensor,
          read: Callable[[torch.Tensor], bool], max_iters: int = 4) -> torch.Tensor:
    """Zoom stage on the per-client bracket [a, b] for the clients where
    `searching`; a client's carry freezes once it has found its step."""
    aj, bj, alphak = a, b, a
    found = ~searching
    for _ in range(max_iters):
        if not read((~found).any()):  # the one host read of an iteration
            break
        p01 = aj + consts.t2 * (bj - aj)
        p02 = bj - consts.t3 * (bj - aj)
        alphaj = _cubic_interpolate(phi, p01, p02, step)
        phi_j = phi(alphaj)
        phi_aj = phi(aj)

        armijo_fail = (phi_j > phi_0 + consts.rho * alphaj * gphi_0) | (phi_j >= phi_aj)
        gphi_j = _dphi(phi, alphaj, step)
        roundoff = (aj - alphaj) * gphi_j <= step
        curvature_ok = gphi_j.abs() <= -consts.sigma * gphi_0
        found_now = ~armijo_fail & (roundoff | curvature_ok)

        bj_new = torch.where(armijo_fail, alphaj, torch.where(gphi_j * (bj - aj) >= 0.0, aj, bj))
        aj_new = torch.where(armijo_fail, aj, alphaj)
        upd = ~found
        aj = torch.where(upd, aj_new, aj)
        bj = torch.where(upd, bj_new, bj)
        alphak = torch.where(upd, alphaj, alphak)
        found = found | found_now
    return alphak


def cubic_linesearch(
    phi: PhiFn,
    phi_0: torch.Tensor,
    lr: float,
    step: float = 1e-6,
    max_iters: int = 3,
    active: Optional[torch.Tensor] = None,
    read: Callable[[torch.Tensor], bool] = bool,
) -> torch.Tensor:
    """Strong-Wolfe cubic line search per client (the JAX package's
    `cubic_linesearch`, batched over K).

    `phi(alpha [K]) -> loss [K]`, `phi_0 [K]` the loss at 0. Returns the
    step sizes `[K]`. At most `max_iters` bracketing iterations; each
    client's exit code (0: keep looping, 1: accept, 2: zoom(αᵢ₋₁, αᵢ),
    3: zoom(αᵢ, αᵢ₋₁)) freezes its carry, as the JAX package's vmap-safety
    rule does. A flat direction (|φ'(0)| < 1e-12) or a NaN μ gives step 1.
    `active [K]` stops the loops for clients the caller no longer iterates;
    one host read (`read`) per iteration of either loop.
    """
    consts = _CubicConsts()
    dt, dev = phi_0.dtype, phi_0.device
    live_mask = torch.ones_like(phi_0, dtype=torch.bool) if active is None else active
    tol = torch.clamp(phi_0 * 0.01, max=1e-6)
    gphi_0 = _dphi(phi, torch.zeros_like(phi_0), step)
    mu = (tol - phi_0) / (consts.rho * gphi_0)

    alphai = torch.full_like(phi_0, 10.0 * lr)
    alphai1 = torch.zeros_like(phi_0)
    phi_prev = phi_0
    code = torch.zeros(phi_0.shape, dtype=torch.int32, device=dev)
    for ci in range(max_iters):
        looping = code == 0
        if not read((looping & live_mask).any()):  # the one host read of an iteration
            break
        phi_i = phi(alphai)
        accept0 = phi_i < tol
        bracket1 = (phi_i > phi_0 + alphai * gphi_0) | ((ci > 0) & (phi_i >= phi_prev))
        gphi_i = _dphi(phi, alphai, step)
        accept2 = gphi_i.abs() <= -consts.sigma * gphi_0
        bracket3 = gphi_i >= 0.0
        one, two, three, zero = (torch.full_like(code, v) for v in (1, 2, 3, 0))
        code_new = torch.where(accept0, one, torch.where(bracket1, two, torch.where(
            accept2, one, torch.where(bracket3, three, zero))))

        take_mu = mu <= 2.0 * alphai - alphai1
        p01 = 2.0 * alphai - alphai1
        p02 = torch.minimum(mu, alphai + consts.t1 * (alphai - alphai1))
        alphai_interp = _cubic_interpolate(phi, p01, p02, step)
        alphai_next = torch.where(take_mu, mu, alphai_interp)
        alphai1_next = torch.where(take_mu, alphai, alphai1)

        # a client that exited keeps the alphai it exited with; one that
        # exited on an earlier iteration keeps its whole carry
        keep = looping & (code_new == 0)
        alphai, alphai1, phi_prev = (
            torch.where(keep, alphai_next, alphai),
            torch.where(keep, alphai1_next, alphai1),
            torch.where(keep, phi_i, phi_prev),
        )
        code = torch.where(looping, code_new, code)

    alphak = torch.where(code == 1, alphai, torch.full_like(phi_0, lr))
    zooming = ((code == 2) | (code == 3)) & live_mask
    if read(zooming.any()):
        a = torch.where(code == 2, alphai1, alphai)
        b = torch.where(code == 2, alphai, alphai1)
        alphak = torch.where(zooming, _zoom(phi, a, b, phi_0, gphi_0, consts, step, zooming, read), alphak)

    # degenerate cases: flat direction or non-finite mu -> step 1.0
    degenerate = (gphi_0.abs() < 1e-12) | torch.isnan(mu)
    return torch.where(degenerate, torch.ones((), dtype=dt, device=dev), alphak)
