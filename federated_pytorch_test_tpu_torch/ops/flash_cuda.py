"""Flash attention: hand-written CUDA kernels for Hopper.

Counterpart of the JAX package's `ops/flash_attention.py`: its custom VJP
`_flash3` over two kernel families, each a `torch.autograd.Function` over
three kernels in `csrc/flash_attention.cu` (built on first use).

* Aligned causal (`_fwd_tri`, `_bwd_tri`), the path of
  `flash_attention(..., causal=True)`: `flash_fwd`, `flash_bwd_dq`,
  `flash_bwd_dkv` on `[BH, S, D]`, over the causal triangle only.
* Rectangular (`_fwd`, `_flash3_bwd`), the path of
  `flash_attention(..., causal=False)` and of `flash_block`:
  `flash_fwd_rect`, `flash_bwd_dq_rect`, `flash_bwd_dkv_rect` on q
  `[BH, Sq, D]` against k, v `[BH, Skv, D]`, non-causal or causal on the
  global positions `q_off + i`, `k_off + j`. A causal row that sees no key
  gets o = 0 and lse = -1e30 and contributes nothing to the gradients.

Every forward returns o and the natural-log row logsumexp lse, never
forming the `[Sq, Skv]` scores; the backward kernels take (q, k, v, dO,
lse, delta) with delta = rowsum(dO ∘ o) − dlse a plain reduction, as it
is outside the Pallas calls in the JAX package. Head dims {16, 32, 64}
are ported.

Each wrapper takes its plain PyTorch version for CPU tensors and only
then; for CUDA tensors it launches the kernel or raises. `LAUNCHES`
counts kernel launches per wrapper, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .attention import NEG_BIG
from .compact_cuda import _check, _on_cpu

# kernel launches per wrapper since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
    "flash_fwd_rect": 0, "flash_bwd_dq_rect": 0, "flash_bwd_dkv_rect": 0,
}
CAUSAL_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
RECT_KERNELS = ("flash_fwd_rect", "flash_bwd_dq_rect", "flash_bwd_dkv_rect")

HEAD_DIMS = (16, 32, 64)  # the kernels' template instances
BLOCK = 128  # rows a kernel block owns (kRows in the CUDA source); S must be a multiple
MAX_BH = 65535  # the grid's y extent
MAX_OFFSET = 1 << 30  # |q_off|, |k_off| bound: position arithmetic stays in int32

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("flash_attention")
        lib.flash_fwd_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
        lib.flash_bwd_dq_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
        lib.flash_bwd_dkv_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
        rect = [_I, _I, _I, _I, _I, _I, _I, _F, _P]  # bh, s_q, s_kv, d, causal, q_off, k_off, scale, stream
        lib.flash_fwd_rect_launch.argtypes = [_P] * 5 + rect
        lib.flash_bwd_dq_rect_launch.argtypes = [_P] * 7 + rect
        lib.flash_bwd_dkv_rect_launch.argtypes = [_P] * 8 + rect
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_dkv_launch,
                   lib.flash_fwd_rect_launch, lib.flash_bwd_dq_rect_launch, lib.flash_bwd_dkv_rect_launch):
            fn.restype = _I
        _lib = lib
    return _lib


def check_shape(s: int, d: int, s_kv: Optional[int] = None) -> None:
    """The JAX entry's checks (S % 128 == 0 for queries and keys, D <= 256),
    then the port's D set."""
    if s % BLOCK != 0 or (s_kv is not None and s_kv % BLOCK != 0):
        got = s if s_kv is None else (s, s_kv)
        raise ValueError(
            f"flash attention needs S divisible by {BLOCK}; got {got} "
            "(use ops.attention.dense_attention for short/ragged sequences)"
        )
    if d > 256:
        raise ValueError(f"head dim {d} too large for a single tile")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not ported: the kernels take D in {HEAD_DIMS}")


def _causal_scores(q3, k3, scale):
    s = torch.matmul(q3, k3.transpose(-1, -2)) * scale
    n = s.shape[-1]
    keep = torch.ones((n, n), dtype=torch.bool, device=s.device).tril()
    return torch.where(keep, s, torch.full((), NEG_BIG, dtype=s.dtype, device=s.device))


def flash_fwd_plain(q3, k3, v3, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `flash_fwd`: (o `[BH,S,D]`, lse `[BH,S]`)."""
    s = _causal_scores(q3, k3, scale)
    lse = torch.logsumexp(s, dim=-1)
    return torch.matmul(torch.exp(s - lse[..., None]), v3), lse


def flash_bwd_dq_plain(q3, k3, v3, do, lse, delta, scale: float) -> torch.Tensor:
    """Plain PyTorch version of `flash_bwd_dq`."""
    p = torch.exp(_causal_scores(q3, k3, scale) - lse[..., None])
    ds = p * (torch.matmul(do, v3.transpose(-1, -2)) - delta[..., None])
    return torch.matmul(ds, k3) * scale


def flash_bwd_dkv_plain(q3, k3, v3, do, lse, delta, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `flash_bwd_dkv`."""
    p = torch.exp(_causal_scores(q3, k3, scale) - lse[..., None])
    ds = p * (torch.matmul(do, v3.transpose(-1, -2)) - delta[..., None])
    return torch.matmul(ds.transpose(-1, -2), q3) * scale, torch.matmul(p.transpose(-1, -2), do)


def flash_bwd_plain(q3, k3, v3, o, lse, do, scale: float):
    """Plain PyTorch version of the backward: (dq, dk, dv) from (q, k, v, o, lse, dO)."""
    delta = (do * o).sum(-1)
    return (flash_bwd_dq_plain(q3, k3, v3, do, lse, delta, scale),
            *flash_bwd_dkv_plain(q3, k3, v3, do, lse, delta, scale))


def _check_aligned(q3, k3, v3, do=None, lse=None, delta=None):
    """`_check_rect`'s checks, and s_q == s_kv: (bh, s, d)."""
    bh, s_q, s_kv, d = _check_rect(q3, k3, v3, do, lse, delta)
    if s_q != s_kv:
        raise ValueError(f"the aligned causal kernels need as many keys as queries, got {s_kv} and {s_q}")
    return bh, s_q, d


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q3, k3, v3, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward on `[BH, S, D]` f32: (o, lse)."""
    if _on_cpu(q3, k3, v3):
        return flash_fwd_plain(q3, k3, v3, scale)
    bh, s, d = _check_aligned(q3, k3, v3)
    o = torch.empty_like(q3)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q3.device)
    rc = _kernels().flash_fwd_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, s, d, scale, _stream(q3)
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd: CUDA launch failed (cudaError {rc})")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q3, k3, v3, do, lse, delta, scale: float) -> torch.Tensor:
    """dq `[BH, S, D]` of causal attention from (q, k, v, dO) and the row
    statistics lse, delta = rowsum(dO ∘ o) `[BH, S]`."""
    if _on_cpu(q3, k3, v3, do, lse, delta):
        return flash_bwd_dq_plain(q3, k3, v3, do, lse, delta, scale)
    bh, s, d = _check_aligned(q3, k3, v3, do, lse, delta)
    dq = torch.empty_like(q3)
    rc = _kernels().flash_bwd_dq_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), bh, s, d, scale, _stream(q3),
    )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq: CUDA launch failed (cudaError {rc})")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q3, k3, v3, do, lse, delta, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) `[BH, S, D]` from the same inputs as `flash_bwd_dq`."""
    if _on_cpu(q3, k3, v3, do, lse, delta):
        return flash_bwd_dkv_plain(q3, k3, v3, do, lse, delta, scale)
    bh, s, d = _check_aligned(q3, k3, v3, do, lse, delta)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    rc = _kernels().flash_bwd_dkv_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, s, d, scale, _stream(q3),
    )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv: CUDA launch failed (cudaError {rc})")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q3, k3, v3, o, lse, do, scale: float):
    """Causal attention backward: (dq, dk, dv), each `[BH, S, D]`.

    delta = rowsum(dO ∘ o) is a plain reduction, as in the JAX package.
    """
    if _on_cpu(q3, k3, v3, o, lse, do):
        return flash_bwd_plain(q3, k3, v3, o, lse, do, scale)
    delta = (do * o).sum(-1)
    dq = flash_bwd_dq(q3, k3, v3, do, lse, delta, scale)
    return (dq, *flash_bwd_dkv(q3, k3, v3, do, lse, delta, scale))


def _rect_keep(s_q: int, s_kv: int, q_off: int, k_off: int, device) -> torch.Tensor:
    """keep[i, j]: key j (global k_off + j) is visible to query i (q_off + i)."""
    qpos = q_off + torch.arange(s_q, device=device)
    kpos = k_off + torch.arange(s_kv, device=device)
    return kpos[None, :] <= qpos[:, None]


def flash_fwd_rect_plain(q3, k3, v3, scale: float, causal: bool = False, q_off: int = 0, k_off: int = 0):
    """Plain PyTorch version of `flash_fwd_rect`: (o `[BH,Sq,D]`, lse `[BH,Sq]`).

    Written so that autograd through it stays finite on rows that see no
    key (no inf in any branch), which makes it the plain reference for the
    `flash_block` gradients too.
    """
    s = torch.matmul(q3, k3.transpose(-1, -2)) * scale
    if not causal:
        lse = torch.logsumexp(s, dim=-1)
        return torch.matmul(torch.exp(s - lse[..., None]), v3), lse
    keep = _rect_keep(s.shape[-2], s.shape[-1], q_off, k_off, s.device)
    live = keep.any(-1)  # rows that see at least one key
    s = torch.where(keep, s, NEG_BIG)
    m = torch.where(live, s.amax(-1), 0.0)
    p = torch.exp(s - m[..., None])  # exactly 0 where masked
    l = torch.where(live, p.sum(-1), 1.0)
    lse = torch.where(live, m + torch.log(l), NEG_BIG)
    return torch.matmul(p, v3) / l[..., None], lse


def _rect_p(q3, k3, lse, scale, causal, q_off, k_off):
    """P = exp(scores − lse), 0 for masked pairs and for rows that saw no key."""
    p = torch.exp(torch.matmul(q3, k3.transpose(-1, -2)) * scale - lse[..., None])
    if causal:
        keep = _rect_keep(q3.shape[-2], k3.shape[-2], q_off, k_off, q3.device) & (lse > NEG_BIG * 0.5)[..., None]
        p = torch.where(keep, p, 0.0)
    return p


def flash_bwd_dq_rect_plain(q3, k3, v3, do, lse, delta, scale: float, causal: bool = False, q_off: int = 0,
                            k_off: int = 0) -> torch.Tensor:
    """Plain PyTorch version of `flash_bwd_dq_rect`."""
    p = _rect_p(q3, k3, lse, scale, causal, q_off, k_off)
    ds = p * (torch.matmul(do, v3.transpose(-1, -2)) - delta[..., None])
    return torch.matmul(ds, k3) * scale


def flash_bwd_dkv_rect_plain(q3, k3, v3, do, lse, delta, scale: float, causal: bool = False, q_off: int = 0,
                             k_off: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `flash_bwd_dkv_rect`."""
    p = _rect_p(q3, k3, lse, scale, causal, q_off, k_off)
    ds = p * (torch.matmul(do, v3.transpose(-1, -2)) - delta[..., None])
    return torch.matmul(ds.transpose(-1, -2), q3) * scale, torch.matmul(p.transpose(-1, -2), do)


def _check_rect(q3, k3, v3, do=None, lse=None, delta=None, q_off=0, k_off=0):
    """(bh, s_q, s_kv, d) after the kernels' checks: q (and dO) `[BH, Sq, D]`,
    k, v `[BH, Skv, D]`, lse and delta `[BH, Sq]`, all f32 and contiguous."""
    bh, s_q, d = q3.shape
    s_kv = k3.shape[1]
    check_shape(s_q, d, s_kv)
    if bh > MAX_BH:
        raise ValueError(f"batch·heads {bh} exceeds {MAX_BH}")
    if max(abs(q_off), abs(k_off)) >= MAX_OFFSET:
        raise ValueError(f"offsets ({q_off}, {k_off}) outside (-{MAX_OFFSET}, {MAX_OFFSET})")
    for name, t, shape in (("q", q3, (bh, s_q, d)), ("k", k3, (bh, s_kv, d)), ("v", v3, (bh, s_kv, d)),
                           ("do", do, (bh, s_q, d))):
        if t is not None:
            _check(name, t, shape, torch.float32)
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the kernels need 16-byte aligned rows")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None:
            _check(name, t, (bh, s_q), torch.float32)
    return bh, s_q, s_kv, d


def flash_fwd_rect(q3, k3, v3, scale: float, causal: bool = False, q_off: int = 0,
                   k_off: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rectangular attention forward, q `[BH, Sq, D]` against k, v `[BH, Skv, D]`
    f32, non-causal or causal on global offsets: (o, lse)."""
    if _on_cpu(q3, k3, v3):
        return flash_fwd_rect_plain(q3, k3, v3, scale, causal, q_off, k_off)
    bh, s_q, s_kv, d = _check_rect(q3, k3, v3, q_off=q_off, k_off=k_off)
    o = torch.empty_like(q3)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q3.device)
    rc = _kernels().flash_fwd_rect_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, s_q, s_kv, d, int(causal), q_off, k_off, scale, _stream(q3),
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd_rect: CUDA launch failed (cudaError {rc})")
    LAUNCHES["flash_fwd_rect"] += 1
    return o, lse


def flash_bwd_dq_rect(q3, k3, v3, do, lse, delta, scale: float, causal: bool = False, q_off: int = 0,
                      k_off: int = 0) -> torch.Tensor:
    """dq `[BH, Sq, D]` of the rectangular family from (q, k, v, dO) and the
    row statistics lse, delta `[BH, Sq]`."""
    if _on_cpu(q3, k3, v3, do, lse, delta):
        return flash_bwd_dq_rect_plain(q3, k3, v3, do, lse, delta, scale, causal, q_off, k_off)
    bh, s_q, s_kv, d = _check_rect(q3, k3, v3, do, lse, delta, q_off, k_off)
    dq = torch.empty_like(q3)
    rc = _kernels().flash_bwd_dq_rect_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), bh, s_q, s_kv, d, int(causal), q_off, k_off, scale, _stream(q3),
    )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq_rect: CUDA launch failed (cudaError {rc})")
    LAUNCHES["flash_bwd_dq_rect"] += 1
    return dq


def flash_bwd_dkv_rect(q3, k3, v3, do, lse, delta, scale: float, causal: bool = False, q_off: int = 0,
                       k_off: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) `[BH, Skv, D]` from the same inputs as `flash_bwd_dq_rect`."""
    if _on_cpu(q3, k3, v3, do, lse, delta):
        return flash_bwd_dkv_rect_plain(q3, k3, v3, do, lse, delta, scale, causal, q_off, k_off)
    bh, s_q, s_kv, d = _check_rect(q3, k3, v3, do, lse, delta, q_off, k_off)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    rc = _kernels().flash_bwd_dkv_rect_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, s_q, s_kv, d, int(causal), q_off, k_off, scale, _stream(q3),
    )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv_rect: CUDA launch failed (cudaError {rc})")
    LAUNCHES["flash_bwd_dkv_rect"] += 1
    return dk, dv


class _FlashCausal(torch.autograd.Function):
    """o = causal attention of `[BH, S, D]` f32 q, k, v; the backward
    recomputes P from the saved lse (flash-2)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale):
        o, lse = flash_fwd(q3, k3, v3, scale)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q3, k3, v3, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


class _FlashRect(torch.autograd.Function):
    """(o, lse) of the rectangular family, both differentiable. The lse
    cotangent enters the backward as a shift of delta, as in the JAX
    package's `_flash3_bwd`: d lse/d scores is the softmax P itself, so
    dS = P ∘ (dP − delta) with delta = rowsum(dO ∘ o) − dlse. A missing
    cotangent (an output left unused) is zero."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal, q_off, k_off):
        o, lse = flash_fwd_rect(q3, k3, v3, scale, causal, q_off, k_off)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.args = (scale, causal, q_off, k_off)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q3, k3, v3, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        delta = (do * o).sum(-1)
        if dlse is not None:
            delta = delta - dlse
        dq = flash_bwd_dq_rect(q3, k3, v3, do, lse, delta, *ctx.args)
        dk, dv = flash_bwd_dkv_rect(q3, k3, v3, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def _to3(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).to(torch.float32).contiguous()


def _scale(sm_scale: Optional[float], d: int) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, sm_scale: Optional[float] = None
) -> torch.Tensor:
    """Exact attention, blockwise. q, k, v: `[B, S, H, D]` -> same.

    Drop-in for `ops.attention.dense_attention` when S is a multiple of
    128: the `[S, S]` scores never exist in device memory, forward or
    backward. Causal runs the aligned kernels over the triangle; non-causal
    (the default, as in the JAX package) the rectangular ones. Computes in
    f32.
    """
    b, s, h, d = q.shape
    check_shape(s, d)
    scale = _scale(sm_scale, d)
    q3, k3, v3 = _to3(q), _to3(k), _to3(v)
    if causal:
        o = _FlashCausal.apply(q3, k3, v3, scale)
    else:
        o, _ = _FlashRect.apply(q3, k3, v3, scale, False, 0, 0)
    return o.reshape(b, h, s, d).permute(0, 2, 1, 3).to(q.dtype)


def flash_block(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset, k_offset, causal: bool = False,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (Q block, KV block) partial attention with global positions.

    q: `[B, Sq, H, D]` at global positions `q_offset + [0, Sq)`; k, v:
    `[B, Skv, H, D]` at `k_offset + [0, Skv)`. Returns `(o, lse)`, f32 and
    head-major — o `[B, H, Sq, D]`, lse `[B, H, Sq]` — the pair an
    online-softmax merge folds across blocks (o = 0 and lse = -1e30 for
    causal rows that see no key). Differentiable in q, k, v, including
    through uses of lse.
    """
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    check_shape(s_q, d, s_kv)
    o, lse = _FlashRect.apply(_to3(q), _to3(k), _to3(v), _scale(sm_scale, d), bool(causal),
                              int(q_offset), int(k_offset))
    return o.reshape(b, h, s_q, d), lse.reshape(b, h, s_q)
