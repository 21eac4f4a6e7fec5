"""Stochastic L-BFGS with trust-region damping and line searches, K clients at once.

Counterpart of the JAX package's `optim/lbfgs.py`, with its three step
rules: the batch-mode Armijo search (`line_search=True, batch_mode=True`,
the path the engine runs; sequential, or in fans of `ls_probes` rungs),
the full-batch cubic search (`line_search=True, batch_mode=False`) and the
fixed step (`line_search=False`: `lr`, or `min(1, 1/‖g‖₁)·lr` on a round's
first iteration). Kept from it:

* trust-region damping `y += lm0·s`;
* the inter-batch gradient mean/variance estimate (Welford) feeding the
  maximum step `alphabar = 1/(1 + var/((n-1)·‖g‖))`, with the gradient
  norm frozen at its step-entry value (a reproduced reference quirk);
* the curvature guard `ys > 1e-10·‖s‖²` with history pushes suppressed on
  batch boundaries (batch mode; damping and the running statistics are
  batch mode's too);
* the NaN guards (entry gradient norm, step size);
* the `func_evals` / `ls_evals` counters (and, the port's own, the
  batched pass counts that say how often each kernel of a pass ran);
* the `has_aux` fold: the accepted evaluation's aux is returned, so the
  engine needs no extra diagnostic forward.

`direction` is `"compact"` (plain PyTorch), `"two_loop"` (the sequential
recursion, plain PyTorch, as the JAX package's is plain XLA) or
`"pallas"` (the fused CUDA kernels of `ops/compact_cuda.py`; the name is
the JAX package's config value).

Batching. Every tensor has a leading client axis `[K, ...]`, and
`loss_fn` maps `x [K, N]` to per-client losses `[K]`. The JAX package
`vmap`s its `while_loop` over the clients; the loop here keeps the same
freeze rule: it runs while any client is active, and a finished client's
whole state is kept with `torch.where` — a client that entered with a
NaN gradient keeps its parameters. The batched result therefore equals K
independent runs. Whether any client is still active is decided with one
host read per inner iteration (CUDA graphs that avoid it are later work).

The history is updated in place. `s_hist`/`y_hist` `[K, m, N]` are the
largest tensors of a step (2 × 12 GB for 64 ResNet18 clients at the
largest block), so a push shifts the full clients' slots one place down,
slot by slot, and writes the new pair into each pushing client's slot, with
no copy of the whole history; the result is bitwise that of the JAX
package's roll-and-write push. `lbfgs_step` therefore writes into the
history tensors of the state it is given, and the state it returns holds
the same tensors: a caller that reads the old state after the step clones
it first (`clone_state`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .compact import compact_direction
from .linesearch import (
    backtracking_armijo_aux,
    backtracking_armijo_probes_aux,
    cubic_linesearch,
    select,
)

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
    """Hyper-parameters (the JAX package's `LBFGSConfig` fields and defaults:
    without `line_search` the step is fixed; the engine asks for the
    batch-mode search, `ExperimentConfig.lbfgs_config`)."""

    lr: float = 1.0
    max_iter: int = 10
    max_eval: int | None = None  # defaults to max_iter * 5 // 4
    tolerance_grad: float = 1e-5
    tolerance_change: float = 1e-9
    history_size: int = 7
    line_search: bool = False
    batch_mode: bool = False
    lm0: float = 1e-6  # trust-region damping coefficient (batch mode)
    direction: str = "compact"
    # rungs of the halving ladder a batch-mode search evaluates in one fan
    # (`backtracking_armijo_probes_aux`); 1 is the sequential search
    ls_probes: int = 1

    def __post_init__(self):
        if self.direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {sorted(DIRECTIONS)}, got {self.direction!r}")
        if self.ls_probes < 1:
            raise ValueError(f"ls_probes must be >= 1, got {self.ls_probes}")

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
    host_reads: int = 0  # device values the loops read on the host (each waits for the queue)


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


def clone_state(state: LBFGSState) -> LBFGSState:
    """`state` with its history tensors copied: `lbfgs_step` writes into the
    history of the state it is given, and every other field it replaces."""
    return state._replace(s_hist=state.s_hist.clone(), y_hist=state.y_hist.clone())


def _push_history_(s_hist, y_hist, count, s, y, push):
    """Append (s, y) in place for the clients where `push [K]`, evicting
    the oldest pair of a full client; returns the new counts.

    The slots stay in chronological order, as the JAX package's roll keeps
    them: a full client's slots move one place down, slot by slot, then
    each pushing client writes its pair into its slot (`m − 1` when full,
    else `count`). Every copy is at most `[K, N]`; the other clients' rows
    keep their bits.
    """
    k, m, _ = s_hist.shape
    shift = (push & (count == m))[:, None]
    for h in (s_hist, y_hist):
        for i in range(m - 1):
            torch.where(shift, h[:, i + 1], h[:, i], out=h[:, i])
    rows = torch.arange(k, device=count.device)
    slot = torch.where(count == m, m - 1, count).long()
    for h, v in ((s_hist, s), (y_hist, y)):
        h[rows, slot] = torch.where(push[:, None], v, h[rows, slot])
    return torch.where(push, torch.clamp(count + 1, max=m), count)


def _update_history_(s_hist, y_hist, count, s, y, push, reset=None):
    """An iteration's history update in place: push (s, y) where `push`
    (`_push_history_`), then zero the whole history of the clients where
    `reset` (a round's first iteration; None: no client). Returns the
    counts after the push."""
    count = _push_history_(s_hist, y_hist, count, s, y, push)
    if reset is not None:
        s_hist.masked_fill_(reset[:, None, None], 0.0)
        y_hist.masked_fill_(reset[:, None, None], 0.0)
    return count


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
    fan_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, LBFGSState, LBFGSAux]:
    """One optimizer step for K clients: up to `max_iter` iterations each.

    `loss_fn(x [K, N])` returns per-client losses `[K]`, or `(loss, aux)`
    with `has_aux=True` (aux: a tuple of `[K, ...]` tensors). Clients are
    independent, so the gradient of the summed loss is each client's own.
    With `has_aux`, `LBFGSAux.aux` is the aux of the evaluation at the
    final parameters and `aux_ok` is False only where the final point came
    from the NaN-step-size fallback and was never evaluated; only the
    batch-mode search threads it (its accepted step is its last
    evaluation), so `has_aux` requires it, as in the JAX package.

    `fan_fn(x [K, N], d [K, N], alphas [K, P]) -> (losses [K, P], aux with
    [K, P, ...] leaves)` evaluates a fan of `config.ls_probes > 1` step
    sizes in one batched pass (the engine's, `engine/steps.py`); without
    it each rung of a fan is one call of `loss_fn`. A fan counts as the
    batched passes it ran in `value_passes`.

    The history tensors of `state` are updated in place (module docstring).
    """
    if has_aux and not (config.batch_mode and config.line_search):
        raise ValueError(
            "has_aux requires batch_mode line search: only the Armijo "
            "path's accepted step is guaranteed to be its last-evaluated "
            "point, which is what makes the carried aux belong to the "
            "returned parameters"
        )
    max_eval = config.resolved_max_eval
    tol_grad = config.tolerance_grad
    tol_change = config.tolerance_change
    lr = config.lr
    batch = config.batch_mode
    direction_fn = DIRECTIONS[config.direction]

    def loss_fn_aux(xx):
        return loss_fn(xx) if has_aux else (loss_fn(xx), ())

    passes = {"grad": 0, "value": 0, "direction": 0, "host_reads": 0}  # batched passes of this step

    def read(flag: torch.Tensor) -> bool:
        passes["host_reads"] += 1
        return bool(flag)

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

    @torch.no_grad()
    def evaluate_fan(x_cur, d, alphas):
        if fan_fn is not None:
            passes["value"] += 1
            return fan_fn(x_cur, d, alphas)
        outs = [evaluate(x_cur + alphas[:, p, None] * d) for p in range(alphas.shape[1])]
        return torch.stack([o[0] for o in outs], dim=1), _stack_rungs([o[1] for o in outs])

    # a round's first iteration resets the history: possible in this step
    # only where a client enters with n_iter 0 (one host read a step)
    fresh_possible = read((state.n_iter == 0).any())
    loss0, aux0, g0 = value_and_grad(x)
    abs_grad_sum0 = g0.abs().sum(-1)
    # frozen at entry for both the loop guard and alphabar
    grad_nrm = torch.linalg.vector_norm(g0, dim=-1)
    nan_entry = torch.isnan(grad_nrm)
    i32 = dict(dtype=torch.int32, device=x.device)

    def body(c: _Carry, active: torch.Tensor, first_call: bool) -> _Carry:
        n_inner = c.n_inner + 1
        n_global = c.n_global + 1
        first_ever = n_global == 1
        fdt = c.x.dtype

        # update_direction (the JAX package's lax.cond picks it per client;
        # its small results are computed for every client and selected, as
        # under vmap, while the history is written only where it changes)
        y = c.g - c.prev_grad
        s = c.d * c.t[:, None]
        if batch:
            y = y + config.lm0 * s  # trust-region damping
        ys = (y * s).sum(-1)
        ss = (s * s).sum(-1)
        if batch:
            # first inner iteration of a new step = new mini-batch: update
            # the inter-batch gradient statistics, not the history
            batch_changed = (n_inner == 1) & (n_global > 1)
            g_minus_old = c.g - c.running_avg
            ravg_new = c.running_avg + g_minus_old / n_global.to(fdt)[:, None]
            ravgsq_new = c.running_avg_sq + (c.g - ravg_new) * g_minus_old
            ravg = torch.where(batch_changed[:, None], ravg_new, c.running_avg)
            ravgsq = torch.where(batch_changed[:, None], ravgsq_new, c.running_avg_sq)
            var_term = ravgsq.sum(-1) / ((n_global - 1).to(fdt) * grad_nrm)
            alphabar = torch.where(batch_changed, 1.0 / (1.0 + var_term), c.alphabar)
            accept = (ys > 1e-10 * ss) & ~batch_changed
        else:
            ravg, ravgsq, alphabar = c.running_avg, c.running_avg_sq, c.alphabar
            accept = ys > 1e-10 * ss
        # in place, and only where it changes: pushed for the active
        # clients that accept the pair; on a round's first iteration reset
        # (fresh_direction), which only the first call can meet
        fe = first_ever
        reset = fe & active if first_call and fresh_possible else None
        hist_count = _update_history_(c.s_hist, c.y_hist, c.hist_count, s, y, accept & active & ~fe, reset)
        yy = (y * y).sum(-1)
        h_new = torch.where(yy != 0.0, ys / torch.where(yy != 0.0, yy, torch.ones_like(yy)), c.h_diag)
        h_diag = torch.where(accept, h_new, c.h_diag)
        d = direction_fn(c.g, c.s_hist, c.y_hist, hist_count, h_diag)
        passes["direction"] += 1

        # fresh_direction on a round's first iteration: steepest descent,
        # history and running statistics reset
        zero = torch.zeros((), dtype=fdt, device=x.device)
        d = torch.where(fe[:, None], -c.g, d)
        hist_count = torch.where(fe, 0, hist_count)
        h_diag = torch.where(fe, 1.0, h_diag)
        alphabar = torch.where(fe, c.alphabar, alphabar)
        ravg = torch.where(fe[:, None], zero, ravg)
        ravgsq = torch.where(fe[:, None], zero, ravgsq)

        prev_grad = c.g
        prev_loss = c.loss
        gtd = (c.g * d).sum(-1)

        # step-size seed, the step itself without a line search
        t = torch.where(fe, torch.minimum(torch.ones_like(c.abs_grad_sum), 1.0 / c.abs_grad_sum) * lr,
                        torch.full_like(c.abs_grad_sum, lr)).to(fdt)
        aux_new, aux_ok_new, ls_evals = c.aux, c.aux_ok, c.ls_evals
        if config.line_search:
            x_cur = c.x
            if batch:
                if config.ls_probes > 1:
                    t_ls, ls_ev, aux_new = backtracking_armijo_probes_aux(
                        lambda alphas: evaluate_fan(x_cur, d, alphas), c.loss, gtd, alphabar,
                        probes=config.ls_probes, active=active, read=read)
                else:
                    t_ls, ls_ev, aux_new = backtracking_armijo_aux(
                        lambda alpha: evaluate(x_cur + alpha[:, None] * d), c.loss, gtd, alphabar, active=active,
                        read=read)
                ls_evals = c.ls_evals + ls_ev
                # a NaN step size falls back to lr: x + lr·d was never evaluated
                aux_ok_new = ~torch.isnan(t_ls)
            else:
                t_ls = cubic_linesearch(lambda alpha: evaluate(x_cur + alpha[:, None] * d)[0], c.loss, lr,
                                        active=active, read=read)
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
        if read(reeval.any()):
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
            s_hist=c.s_hist, y_hist=c.y_hist, hist_count=hist_count, h_diag=h_diag,
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
    first_call = True
    with torch.no_grad():
        while True:
            # a client iterates while it has budget, is not done and did
            # not enter with a NaN gradient; the others stay frozen (the
            # history, written in place only for them, is kept as it is)
            active = (c.n_inner < config.max_iter) & ~c.done & ~nan_entry
            if not read(active.any()):  # the loop's host read
                break
            c = select(active, body(c, active, first_call), c)
            first_call = False

    new_state = LBFGSState(
        s_hist=c.s_hist, y_hist=c.y_hist, hist_count=c.hist_count, h_diag=c.h_diag,
        d=c.d, t=c.t, prev_grad=c.prev_grad, prev_loss=c.prev_loss, n_iter=c.n_global,
        func_evals=state.func_evals + c.evals, running_avg=c.running_avg,
        running_avg_sq=c.running_avg_sq, ls_evals=state.ls_evals + c.ls_evals,
        grad_passes=state.grad_passes + passes["grad"], value_passes=state.value_passes + passes["value"],
        direction_passes=state.direction_passes + passes["direction"],
        host_reads=state.host_reads + passes["host_reads"],
    )
    aux = LBFGSAux(
        loss=loss0, step_size=c.t, n_inner=c.n_inner, func_evals=c.evals,
        aux=c.aux, aux_ok=c.aux_ok, entry_aux=aux0, ls_evals=c.ls_evals,
    )
    return c.x, new_state, aux


def _stack_rungs(auxs):
    """Per-rung aux tuples `[K, ...]` stacked into fan leaves `[K, P, ...]`."""
    if isinstance(auxs[0], tuple):
        return tuple(_stack_rungs([a[i] for a in auxs]) for i in range(len(auxs[0])))
    return torch.stack(auxs, dim=1)
