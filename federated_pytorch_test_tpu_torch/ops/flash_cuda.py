"""Causal flash attention: hand-written CUDA kernels for Hopper.

Counterpart of the JAX package's `ops/flash_attention.py` on the path its
`flash_attention(..., causal=True)` takes: the aligned causal forward
(`_fwd_tri`) and the two backward kernels (`_bwd_tri`: dq, then dk/dv)
under a custom VJP. Here that is a `torch.autograd.Function` over three
kernels in `csrc/flash_attention.cu` (built on first use):

* `flash_fwd`     — o `[BH, S, D]` and the natural-log row logsumexp lse
  `[BH, S]`, never forming the `[S, S]` scores;
* `flash_bwd_dq`  — dq from (q, k, v, dO, lse, delta);
* `flash_bwd_dkv` — dk, dv from the same inputs;

with delta = rowsum(dO ∘ o) a plain reduction, as it is outside the Pallas
calls in the JAX package. `flash_attention` discards lse, so its
cotangent is zero on this path. Only the causal mode, aligned query and
key positions, and head dims {16, 32, 64} are ported; the rectangular and
offset kernels of the ring path are not.

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
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

HEAD_DIMS = (16, 32, 64)  # the kernels' template instances
BLOCK = 128  # rows a kernel block owns (kRows in the CUDA source); S must be a multiple
MAX_BH = 65535  # the grid's y extent

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
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_dkv_launch):
            fn.restype = _I
        _lib = lib
    return _lib


def check_shape(s: int, d: int) -> None:
    """The JAX entry's checks (S % 128 == 0, D <= 256), then the port's D set."""
    if s % BLOCK != 0:
        raise ValueError(
            f"flash attention needs S divisible by {BLOCK}; got {s} "
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


def _check_qkv(**ts):
    bh, s, d = next(iter(ts.values())).shape
    check_shape(s, d)
    if bh > MAX_BH:
        raise ValueError(f"batch·heads {bh} exceeds {MAX_BH}")
    for name, t in ts.items():
        _check(name, t, (bh, s, d), torch.float32)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernels need 16-byte aligned rows")
    return bh, s, d


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q3, k3, v3, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward on `[BH, S, D]` f32: (o, lse)."""
    if _on_cpu(q3, k3, v3):
        return flash_fwd_plain(q3, k3, v3, scale)
    bh, s, d = _check_qkv(q=q3, k=k3, v=v3)
    o = torch.empty_like(q3)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q3.device)
    rc = _kernels().flash_fwd_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, s, d, scale, _stream(q3)
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd: CUDA launch failed (cudaError {rc})")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _check_stats(bh, s, *ts):
    for name, t in zip(("lse", "delta"), ts):
        _check(name, t, (bh, s), torch.float32)


def flash_bwd_dq(q3, k3, v3, do, lse, delta, scale: float) -> torch.Tensor:
    """dq `[BH, S, D]` of causal attention from (q, k, v, dO) and the row
    statistics lse, delta = rowsum(dO ∘ o) `[BH, S]`."""
    if _on_cpu(q3, k3, v3, do, lse, delta):
        return flash_bwd_dq_plain(q3, k3, v3, do, lse, delta, scale)
    bh, s, d = _check_qkv(q=q3, k=k3, v=v3, do=do)
    _check_stats(bh, s, lse, delta)
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
    bh, s, d = _check_qkv(q=q3, k=k3, v=v3, do=do)
    _check_stats(bh, s, lse, delta)
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


def _to3(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).to(torch.float32).contiguous()


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True, sm_scale: Optional[float] = None
) -> torch.Tensor:
    """Exact causal attention, blockwise. q, k, v: `[B, S, H, D]` -> same.

    Drop-in for `ops.attention.dense_attention(..., causal=True)` when S
    is a multiple of 128: the `[S, S]` scores never exist in device
    memory, forward or backward. Computes in f32.
    """
    if not causal:
        raise NotImplementedError("only causal flash attention is ported (the non-causal kernels are not)")
    b, s, h, d = q.shape
    check_shape(s, d)
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    o = _FlashCausal.apply(_to3(q), _to3(k), _to3(v), scale)
    return o.reshape(b, h, s, d).permute(0, 2, 1, 3).to(q.dtype)
