"""Stochastic L-BFGS with trust-region damping and Armijo search, K clients at once.

Counterpart of the JAX package's `optim/lbfgs.py` on its batch-mode
line-search path — the path the engine runs. Kept from it:

* trust-region damping `y += lm0·s`;
* the inter-batch gradient mean/variance estimate (Welford) feeding the
  maximum step `alphabar = 1/(1 + var/((n-1)·‖g‖))`, with the gradient
  norm frozen at its step-entry value (a reproduced reference quirk);
* the curvature guard `ys > 1e-10·‖s‖²` with history pushes suppressed on
  batch boundaries;
* the NaN guards (entry gradient norm, step size);
* the `func_evals` / `ls_evals` counters (and, the port's own, the
  batched pass counts that say how often each kernel of a pass ran);
* the `has_aux` fold: the accepted evaluation's aux is returned, so the
  engine needs no extra diagnostic forward.

The cubic full-batch search is not ported yet. `direction` is
`"compact"` (plain PyTorch), `"two_loop"` (the sequential recursion,
plain PyTorch, as the JAX package's is plain XLA) or `"pallas"` (the
fused CUDA kernels of `ops/compact_cuda.py`; the name is the JAX
package's config value).

Batching. Every tensor has a leading client axis `[K, ...]`, and
`loss_fn` maps `x [K, N]` to per-client losses `[K]`. The JAX package
`vmap`s its `while_loop` over the clients; the loop here keeps the same
freeze rule: it runs while any client is active, and a finished client's
whole state is kept with `torch.where` — a client that entered with a
NaN gradient keeps its parameters. The batched result therefore equals K
independent runs. Whether any client is still active is decided with one
host read per inner iteration (CUDA graphs that avoid it are later work).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from .compact import compact_direction
from .linesearch import backtracking_armijo_aux, select

LossFn = Callable[[torch.Tensor], Any]  # x [K, N] -> loss [K] (or (loss, aux))


def _cuda_direction(g, s_hist, y_hist, count, h_diag):
    from ..ops.compact_cuda import compact_direction_cuda

    return compact_direction_cuda(g, s_hist, y_hist, count, h_diag)


def _two_loop_direction(g, s_hist, y_hist, count, h_diag):
    """Masked two-loop recursion: -H·g over the valid history slots, K
    clients at once (`g [K, N]`, `s_hist`/`y_hist [K, m, N]`, `count [K]`,
    `h_diag [K]`).

    The JAX package's `_two_loop_direction` batched over the clients:
    slots `i >= count` and slots with `y·s = 0` get rho = 0 (a safe
    reciprocal), so their coefficients vanish.
    """
    m = s_hist.shape[1]
    ys = (y_hist * s_hist).sum(-1)  # [K, m]
    valid = torch.arange(m, device=g.device)[None, :] < count[:, None]
    nz = ys != 0.0
    ro = torch.where(valid & nz, 1.0 / torch.where(nz, ys, torch.ones_like(ys)), torch.zeros_like(ys))
    q = -g
    al = [None] * m
    for i in reversed(range(m)):
        al[i] = (s_hist[:, i] * q).sum(-1) * ro[:, i]
        q = q - al[i][:, None] * y_hist[:, i]
    r = q * h_diag[:, None]
    for i in range(m):
        b = (y_hist[:, i] * r).sum(-1) * ro[:, i]
        r = r + (al[i] - b)[:, None] * s_hist[:, i]
    return r


DIRECTIONS = {"compact": compact_direction, "two_loop": _two_loop_direction, "pallas": _cuda_direction}


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    """Hyper-parameters (the JAX package's `LBFGSConfig` defaults).

    The port runs only the JAX package's `line_search=True,
    batch_mode=True` path, so neither is a field here.
    """

    lr: float = 1.0
    max_iter: int = 10
    max_eval: int | None = None  # defaults to max_iter * 5 // 4
    tolerance_grad: float = 1e-5
    tolerance_change: float = 1e-9
    history_size: int = 7
    lm0: float = 1e-6  # trust-region damping coefficient
    direction: str = "compact"

    def __post_init__(self):
        if self.direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {sorted(DIRECTIONS)}, got {self.direction!r}")

    @property
    def resolved_max_eval(self) -> int:
        return self.max_eval if self.max_eval is not None else self.max_iter * 5 // 4


class LBFGSState(NamedTuple):
    """Persistent optimizer state, every tensor field with a leading client
    axis. The three pass counts are host ints shared by the K clients: one
    batched pass evaluates all of them (frozen clients included), so these
    are the model passes the step ran, where `func_evals` / `ls_evals` count
    each client's own evaluations."""

    s_hist: torch.Tensor  # [K, m, N] past steps s = t·d
    y_hist: torch.Tensor  # [K, m, N] past (damped) gradient differences
    hist_count: torch.Tensor  # [K] i32, valid (s, y) pairs
    h_diag: torch.Tensor  # [K] initial inverse-Hessian scale
    d: torch.Tensor  # [K, N] last search direction
    t: torch.Tensor  # [K] last step size
    prev_grad: torch.Tensor  # [K, N]
    prev_loss: torch.Tensor  # [K]
    n_iter: torch.Tensor  # [K] i32 global iteration counter
    func_evals: torch.Tensor  # [K] i32
    running_avg: torch.Tensor  # [K, N] inter-batch gradient mean
    running_avg_sq: torch.Tensor  # [K, N] inter-batch second-moment accumulator
    ls_evals: torch.Tensor  # [K] i32 Armijo probe evaluations
    grad_passes: int = 0  # batched evaluations with a gradient (entry and re-evaluations)
    value_passes: int = 0  # batched evaluations without one (line-search probes, a caller's diagnostic)
    direction_passes: int = 0  # batched inner iterations: one direction each


class LBFGSAux(NamedTuple):
    """Per-step diagnostics, per client."""

    loss: torch.Tensor  # loss at step entry
    step_size: torch.Tensor  # last accepted step size
    n_inner: torch.Tensor  # inner iterations this step
    func_evals: torch.Tensor  # closure-equivalent evaluations this step
    aux: Any = ()  # has_aux: user aux at the final parameters
    aux_ok: Any = True  # False where the final point was never evaluated
    entry_aux: Any = ()  # has_aux: user aux at the step's entry point
    ls_evals: Any = 0  # Armijo probe evaluations this step


def lbfgs_init(x0: torch.Tensor, config: LBFGSConfig) -> LBFGSState:
    """Fresh state for clients like `x0 [K, N]` (a new optimizer per round)."""
    k, n = x0.shape
    m = config.history_size
    f = dict(dtype=x0.dtype, device=x0.device)
    i = dict(dtype=torch.int32, device=x0.device)
    z = torch.zeros((k, n), **f)
    return LBFGSState(
        s_hist=torch.zeros((k, m, n), **f),
        y_hist=torch.zeros((k, m, n), **f),
        hist_count=torch.zeros((k,), **i),
        h_diag=torch.ones((k,), **f),
        d=z,
        t=torch.full((k,), config.lr, **f),
        prev_grad=z,
        prev_loss=torch.zeros((k,), **f),
        n_iter=torch.zeros((k,), **i),
        func_evals=torch.zeros((k,), **i),
        running_avg=z,
        running_avg_sq=z,
        ls_evals=torch.zeros((k,), **i),
    )


def _push_history(s_hist, y_hist, count, s, y):
    """Append (s, y) per client, evicting the oldest pair when full.

    A roll keeps slots in chronological order, as in the JAX package.
    """
    m = s_hist.shape[1]
    full = (count == m)[:, None, None]
    s_hist = torch.where(full, torch.roll(s_hist, -1, dims=1), s_hist)
    y_hist = torch.where(full, torch.roll(y_hist, -1, dims=1), y_hist)
    idx = torch.where(count == m, m - 1, count)
    slot = (torch.arange(m, device=count.device)[None, :] == idx[:, None])[:, :, None]
    s_hist = torch.where(slot, s[:, None, :], s_hist)
    y_hist = torch.where(slot, y[:, None, :], y_hist)
    return s_hist, y_hist, torch.clamp(count + 1, max=m)


class _Carry(NamedTuple):
    x: torch.Tensor
    loss: torch.Tensor
    g: torch.Tensor
    abs_grad_sum: torch.Tensor
    d: torch.Tensor
    t: torch.Tensor
    s_hist: torch.Tensor
    y_hist: torch.Tensor
    hist_count: torch.Tensor
    h_diag: torch.Tensor
    prev_grad: torch.Tensor
    prev_loss: torch.Tensor
    n_global: torch.Tensor
    evals: torch.Tensor
    n_inner: torch.Tensor
    alphabar: torch.Tensor
    running_avg: torch.Tensor
    running_avg_sq: torch.Tensor
    done: torch.Tensor
    aux: Any
    aux_ok: torch.Tensor
    ls_evals: torch.Tensor


def _detach(aux):
    if isinstance(aux, tuple):
        return tuple(_detach(a) for a in aux)
    return aux.detach()


def lbfgs_step(
    loss_fn: LossFn,
    x: torch.Tensor,
    state: LBFGSState,
    config: LBFGSConfig,
    has_aux: bool = False,
) -> Tuple[torch.Tensor, LBFGSState, LBFGSAux]:
    """One optimizer step for K clients: up to `max_iter` iterations each.

    `loss_fn(x [K, N])` returns per-client losses `[K]`, or `(loss, aux)`
    with `has_aux=True` (aux: a tuple of `[K, ...]` tensors). Clients are
    independent, so the gradient of the summed loss is each client's own.
    With `has_aux`, `LBFGSAux.aux` is the aux of the evaluation at the
    final parameters and `aux_ok` is False only where the final point came
    from the NaN-step-size fallback and was never evaluated.
    """
    max_eval = config.resolved_max_eval
    tol_grad = config.tolerance_grad
    tol_change = config.tolerance_change
    lr = config.lr
    direction_fn = DIRECTIONS[config.direction]

    def loss_fn_aux(xx):
        return loss_fn(xx) if has_aux else (loss_fn(xx), ())

    passes = {"grad": 0, "value": 0, "direction": 0}  # batched passes of this step

    def value_and_grad(xx):
        passes["grad"] += 1
        xr = xx.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, aux = loss_fn_aux(xr)
            (g,) = torch.autograd.grad(loss.sum(), xr)
        return loss.detach(), _detach(aux), g

    @torch.no_grad()
    def evaluate(xx):
        passes["value"] += 1
        return loss_fn_aux(xx)

    loss0, aux0, g0 = value_and_grad(x)
    abs_grad_sum0 = g0.abs().sum(-1)
    # frozen at entry for both the loop guard and alphabar
    grad_nrm = torch.linalg.vector_norm(g0, dim=-1)
    nan_entry = torch.isnan(grad_nrm)
    i32 = dict(dtype=torch.int32, device=x.device)

    def body(c: _Carry, active: torch.Tensor) -> _Carry:
        n_inner = c.n_inner + 1
        n_global = c.n_global + 1
        first_ever = n_global == 1
        fdt = c.x.dtype

        # update_direction (the JAX package's lax.cond picks it per client;
        # both branches are computed and selected, as under vmap)
        y = c.g - c.prev_grad
        s = c.d * c.t[:, None]
        y = y + config.lm0 * s  # trust-region damping
        ys = (y * s).sum(-1)
        ss = (s * s).sum(-1)
        # first inner iteration of a new step = new mini-batch: update the
        # inter-batch gradient statistics, not the history
        batch_changed = (n_inner == 1) & (n_global > 1)
        g_minus_old = c.g - c.running_avg
        ravg_new = c.running_avg + g_minus_old / n_global.to(fdt)[:, None]
        ravgsq_new = c.running_avg_sq + (c.g - ravg_new) * g_minus_old
        ravg = torch.where(batch_changed[:, None], ravg_new, c.running_avg)
        ravgsq = torch.where(batch_changed[:, None], ravgsq_new, c.running_avg_sq)
        var_term = ravgsq.sum(-1) / ((n_global - 1).to(fdt) * grad_nrm)
        alphabar = torch.where(batch_changed, 1.0 / (1.0 + var_term), c.alphabar)
        accept = (ys > 1e-10 * ss) & ~batch_changed
        ps, py, pc = _push_history(c.s_hist, c.y_hist, c.hist_count, s, y)
        s_hist = torch.where(accept[:, None, None], ps, c.s_hist)
        y_hist = torch.where(accept[:, None, None], py, c.y_hist)
        hist_count = torch.where(accept, pc, c.hist_count)
        yy = (y * y).sum(-1)
        h_new = torch.where(yy != 0.0, ys / torch.where(yy != 0.0, yy, torch.ones_like(yy)), c.h_diag)
        h_diag = torch.where(accept, h_new, c.h_diag)
        d = direction_fn(c.g, s_hist, y_hist, hist_count, h_diag)
        passes["direction"] += 1

        # fresh_direction on a round's first iteration: steepest descent,
        # history and running statistics reset
        fe = first_ever
        zero = torch.zeros((), dtype=fdt, device=x.device)
        d = torch.where(fe[:, None], -c.g, d)
        s_hist = torch.where(fe[:, None, None], zero, s_hist)
        y_hist = torch.where(fe[:, None, None], zero, y_hist)
        hist_count = torch.where(fe, 0, hist_count)
        h_diag = torch.where(fe, 1.0, h_diag)
        alphabar = torch.where(fe, c.alphabar, alphabar)
        ravg = torch.where(fe[:, None], zero, ravg)
        ravgsq = torch.where(fe[:, None], zero, ravgsq)

        prev_grad = c.g
        prev_loss = c.loss
        gtd = (c.g * d).sum(-1)

        x_cur = c.x

        def phi_aux(alpha):
            return evaluate(x_cur + alpha[:, None] * d)

        t_ls, ls_ev, aux_new = backtracking_armijo_aux(phi_aux, c.loss, gtd, alphabar, active=active)
        ls_evals = c.ls_evals + ls_ev
        # a NaN step size falls back to lr: x + lr·d was never evaluated
        aux_ok_new = ~torch.isnan(t_ls)
        t = torch.where(torch.isnan(t_ls), lr, t_ls).to(fdt)

        x_new = c.x + t[:, None] * d

        stop_now = (
            (n_inner >= config.max_iter)
            | (c.evals >= max_eval)
            | (gtd > -tol_change)
            | ((t[:, None] * d).abs().sum(-1) <= tol_change)
        )
        loss, g, abs_grad_sum, evals = c.loss, c.g, c.abs_grad_sum, c.evals
        # the re-evaluation runs only where some active client needs it
        # (one more host read per iteration; JAX evaluates both branches)
        reeval = ~stop_now & active
        if bool(reeval.any()):
            l_r, aux_r, g_r = value_and_grad(x_new)
            loss = torch.where(stop_now, loss, l_r)
            g = torch.where(stop_now[:, None], g, g_r)
            abs_grad_sum = torch.where(stop_now, abs_grad_sum, g_r.abs().sum(-1))
            evals = torch.where(stop_now, evals, evals + 1)
            aux_new = select(~stop_now, aux_r, aux_new)
            aux_ok_new = aux_ok_new | ~stop_now

        done = (
            stop_now
            | torch.isnan(abs_grad_sum)
            | (abs_grad_sum <= tol_grad)
            | ((loss - prev_loss).abs() < tol_change)
        )
        return _Carry(
            x=x_new, loss=loss, g=g, abs_grad_sum=abs_grad_sum, d=d, t=t,
            s_hist=s_hist, y_hist=y_hist, hist_count=hist_count, h_diag=h_diag,
            prev_grad=prev_grad, prev_loss=prev_loss, n_global=n_global,
            evals=evals, n_inner=n_inner, alphabar=alphabar,
            running_avg=ravg, running_avg_sq=ravgsq, done=done,
            aux=aux_new, aux_ok=aux_ok_new, ls_evals=ls_evals,
        )

    k = x.shape[0]
    c = _Carry(
        x=x, loss=loss0, g=g0, abs_grad_sum=abs_grad_sum0, d=state.d, t=state.t,
        s_hist=state.s_hist, y_hist=state.y_hist, hist_count=state.hist_count,
        h_diag=state.h_diag, prev_grad=state.prev_grad, prev_loss=state.prev_loss,
        n_global=state.n_iter, evals=torch.ones((k,), **i32),
        n_inner=torch.zeros((k,), **i32),
        alphabar=torch.full((k,), lr, dtype=x.dtype, device=x.device),
        running_avg=state.running_avg, running_avg_sq=state.running_avg_sq,
        done=abs_grad_sum0 <= tol_grad, aux=aux0,
        aux_ok=torch.ones((k,), dtype=torch.bool, device=x.device),
        ls_evals=torch.zeros((k,), **i32),
    )
    with torch.no_grad():
        while True:
            # a client iterates while it has budget, is not done and did
            # not enter with a NaN gradient; the others stay frozen
            active = (c.n_inner < config.max_iter) & ~c.done & ~nan_entry
            if not bool(active.any()):  # the one host read of the loop
                break
            c = select(active, body(c, active), c)

    new_state = LBFGSState(
        s_hist=c.s_hist, y_hist=c.y_hist, hist_count=c.hist_count, h_diag=c.h_diag,
        d=c.d, t=c.t, prev_grad=c.prev_grad, prev_loss=c.prev_loss, n_iter=c.n_global,
        func_evals=state.func_evals + c.evals, running_avg=c.running_avg,
        running_avg_sq=c.running_avg_sq, ls_evals=state.ls_evals + c.ls_evals,
        grad_passes=state.grad_passes + passes["grad"], value_passes=state.value_passes + passes["value"],
        direction_passes=state.direction_passes + passes["direction"],
    )
    aux = LBFGSAux(
        loss=loss0, step_size=c.t, n_inner=c.n_inner, func_evals=c.evals,
        aux=c.aux, aux_ok=c.aux_ok, entry_aux=aux0, ls_evals=c.ls_evals,
    )
    return c.x, new_state, aux
