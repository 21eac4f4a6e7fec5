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
is outside the Pallas calls in the JAX package. The kernels have head
dims {16, 32, 64, 128} (`HEAD_DIMS`); the public entries (`flash_attention`,
`flash_block`) zero-pad any other D up to 128 to the next of them and
slice the padding off the outputs and the cotangents (`_padded`), the
scale taken from the true D. Zero columns add exact zeros to every
product, so the padding changes no score. D in (128, 256] raises: those
instances are not ported yet (ROADMAP B.2).

Precision, as the JAX package's `precision` argument:
* `'highest'` (the default): f32 products, three TF32 passes a product on
  the card (split TF32);
* `'default'`: one TF32 pass a product (both operands rounded by the
  kernels' `tf32()`), the card's counterpart of the TPU's single MXU pass;
  each of the six kernels has this variant (`*_1pass` in `LAUNCHES`);
* bf16 q, k, v at `'default'` with `causal=True` take the `cast16` trio of
  `csrc/flash_bf16.cu` (`flash_fwd_bf16`, `flash_bwd_dq_bf16`,
  `flash_bwd_dkv_bf16`): bf16 operands from device memory, P and dS rounded
  to bf16 before their products, f32 accumulators and statistics, outputs
  and cotangents in bf16. Every other bf16 call is upcast to f32 first,
  which is exact: the JAX package's rectangular kernels have no `cast16`
  branch, and at `'highest'` it keeps f32 probabilities.
The outputs and the cotangents come back in the input dtype.

Each wrapper takes its plain PyTorch version for CPU tensors and only
then; for CUDA tensors it launches the kernel or raises. The one-pass and
bf16 plain versions repeat the kernels' roundings tile by tile (the running
max per tile; `TILE` keys a tile for the f32 kernels, `BF16_FWD_KEYS[D]`
for the bf16 forward), so that the card's gate can hold each kernel to its
own arithmetic. `LAUNCHES` counts kernel launches per
wrapper and variant, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .attention import NEG_BIG
from .compact_cuda import _check, _on_cpu

# kernel launches per wrapper since the last `reset_launch_counts()`
CAUSAL_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
RECT_KERNELS = ("flash_fwd_rect", "flash_bwd_dq_rect", "flash_bwd_dkv_rect")
# the one-pass ('default') variant of each: `ONE_PASS[name]` counts its launches
ONE_PASS = {name: f"{name}_1pass" for name in CAUSAL_KERNELS + RECT_KERNELS}
BF16_KERNELS = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
LAUNCHES: Dict[str, int] = {name: 0 for name in (*CAUSAL_KERNELS, *RECT_KERNELS, *ONE_PASS.values(), *BF16_KERNELS)}
PRECISIONS = ("highest", "default")
# keys a forward tile of the f32 kernels by head dim (Plan<D>::kKeys, fwd128::kKeys at D = 128, in csrc/flash_attention.cu)
F32_FWD_KEYS = {16: 64, 32: 64, 64: 64, 128: 32}
BF16_FWD_KEYS = {16: 128, 32: 128, 64: 128, 128: 128}  # keys a tile of flash_fwd_bf16_tc by head dim (kFwdKeys in csrc/flash_bf16.cu)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

HEAD_DIMS = (16, 32, 64, 128)  # the kernels' template instances
MAX_HEAD_DIM = 256  # the JAX entry's bound (ops/flash_attention.py:512-513)
BLOCK = 128  # rows of the largest kernel block (kBlock in the CUDA source); S must be a multiple
MAX_BH = 65535  # the grid's y extent
MAX_OFFSET = 1 << 30  # |q_off|, |k_off| bound: position arithmetic stays in int32

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_lib = None
_lib16 = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("flash_attention")
        lib.flash_fwd_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]
        lib.flash_bwd_dq_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]
        lib.flash_bwd_dkv_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P]
        rect = [_I, _I, _I, _I, _I, _I, _I, _F, _I, _P]  # bh, s_q, s_kv, d, causal, q_off, k_off, scale, passes, stream
        lib.flash_fwd_rect_launch.argtypes = [_P] * 5 + rect
        lib.flash_bwd_dq_rect_launch.argtypes = [_P] * 7 + rect
        lib.flash_bwd_dkv_rect_launch.argtypes = [_P] * 8 + rect
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_dkv_launch,
                   lib.flash_fwd_rect_launch, lib.flash_bwd_dq_rect_launch, lib.flash_bwd_dkv_rect_launch):
            fn.restype = _I
        _lib = lib
    return _lib


def _kernels_bf16():
    global _lib16
    if _lib16 is None:
        from .build import load

        lib = load("flash_bf16")
        lib.flash_fwd_bf16_launch.argtypes = [_P] * 5 + [_I, _I, _I, _P]
        lib.flash_bwd_dq_bf16_launch.argtypes = [_P] * 7 + [_I, _I, _I, _F, _P]
        lib.flash_bwd_dkv_bf16_launch.argtypes = [_P] * 8 + [_I, _I, _I, _P]
        for fn in (lib.flash_fwd_bf16_launch, lib.flash_bwd_dq_bf16_launch, lib.flash_bwd_dkv_bf16_launch):
            fn.restype = _I
        _lib16 = lib
    return _lib16


def passes_of(precision: str) -> int:
    """TF32 passes a product at `precision`: 3 ('highest'), 1 ('default')."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    return 3 if precision == "highest" else 1


def _count(name: str, passes: int) -> None:
    LAUNCHES[name if passes == 3 else ONE_PASS[name]] += 1


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernels' `tf32()` does (csrc/tf32_wgmma.cuh):
    half of the 13 dropped bits' unit added to the magnitude, then those
    bits cleared, on the int32 view (f32 in, f32 out)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, to nearest even, returned as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def check_shape(s: int, d: int, s_kv: Optional[int] = None) -> None:
    """The JAX entry's checks (S % 128 == 0 for queries and keys, D <= 256),
    then the port's: D up to the largest kernel instance, which the public
    entries pad D up to (`padded_dim`)."""
    if s % BLOCK != 0 or (s_kv is not None and s_kv % BLOCK != 0):
        got = s if s_kv is None else (s, s_kv)
        raise ValueError(
            f"flash attention needs S divisible by {BLOCK}; got {got} "
            "(use ops.attention.dense_attention for short/ragged sequences)"
        )
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} too large for a single VMEM tile")  # the JAX entry's words
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"head dim {d} not ported: the kernels take D up to {HEAD_DIMS[-1]}; "
                         f"D in ({HEAD_DIMS[-1]}, {MAX_HEAD_DIM}] is ROADMAP B.2's remainder")


def padded_dim(d: int) -> int:
    """The kernel instance a head dim `d` <= 128 runs at: the least of HEAD_DIMS at or above it."""
    return next(h for h in HEAD_DIMS if h >= d)


def _pad_last(x: torch.Tensor, d: int) -> torch.Tensor:
    """x with its last axis zero-padded to `d` (x itself where it has d already)."""
    return x if x.shape[-1] == d else torch.nn.functional.pad(x, (0, d - x.shape[-1]))


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


# ---------------------------------------------------------------------------
# One pass ('default'): the plain versions repeat the kernels' arithmetic —
# every product's operands rounded by `tf32_round`, the forward tile by tile
# as `flash_fwd_tc` runs it (and, at D 16, `onepass::flash_fwd_1p_tc`: the
# same tiles in the same order; TILE keys, the running max in units of log2, P
# rounded before P·V and the row sum taken over the rounded P) — for both
# families: the aligned causal one is causal at offsets 0.
# ---------------------------------------------------------------------------


def _f32(x: float) -> float:
    """x rounded to f32, as a Python float: a scalar operand of an f32 op
    is applied at f32, and no device copy waits on the stream. (The product
    of two such values is exact in a Python float, so `_f32` of it is the
    f32 product.)"""
    return torch.tensor(x, dtype=torch.float32).item()


def flash_fwd_1pass_plain(q3, k3, v3, scale: float, causal: bool = True, q_off: int = 0, k_off: int = 0):
    """Plain PyTorch version of the one-pass forward (both families): (o, lse),
    tile by tile at the kernel's keys a tile for this D (`F32_FWD_KEYS`)."""
    bh, s_q, d = q3.shape
    tile = F32_FWD_KEYS[padded_dim(d)]
    s_kv = k3.shape[1]
    dev = q3.device
    c = _f32(_f32(abs(scale)) * _f32(LOG2E))  # the kernel's fabsf(scale) · log2 e, an f32 product
    qr = tf32_round(q3 * (-1.0 if scale < 0 else 1.0))  # the sign folded into Q
    kr, vr = tf32_round(k3), tf32_round(v3)
    m = torch.full((bh, s_q), -1e30, device=dev)
    acc = torch.zeros((bh, s_q, d), device=dev)
    l = torch.zeros((bh, s_q), device=dev)
    keep = _rect_keep(s_q, s_kv, q_off, k_off, dev) if causal else None
    for kt in range(0, s_kv, tile):
        s = torch.matmul(qr, kr[:, kt:kt + tile].transpose(-1, -2))
        if causal:
            s = torch.where(keep[:, kt:kt + tile], s, -math.inf)
        mn = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - mn)
        p = tf32_round(torch.exp2(s * c - mn[..., None]))  # 0 where masked
        acc = acc * corr[..., None] + torch.matmul(p, vr[:, kt:kt + tile])
        l = l * corr + p.sum(-1)
        m = mn
    live = l > 0
    o = torch.where(live[..., None], acc * (1.0 / torch.where(live, l, 1.0))[..., None], 0.0)
    lse = torch.where(live, m * LN2 + torch.log(torch.where(live, l, 1.0)), NEG_BIG)
    return o, lse


def _p_ds_1pass(q3, k3, v3, do, lse, delta, scale, causal, q_off, k_off):
    """The one-pass backward's P and dS (f32), as the kernels form them:
    P = 2^(s·scale·log2 e − lse·log2 e) from TF32-rounded q, k; dP from
    TF32-rounded dO, v; 0 for masked pairs and rows that saw no key."""
    c = _f32(_f32(scale) * _f32(LOG2E))  # the kernels' scale · log2 e, an f32 product
    s = torch.matmul(tf32_round(q3), tf32_round(k3).transpose(-1, -2))
    lse2 = torch.where(lse > NEG_BIG * 0.5, lse * LOG2E, math.inf)
    p = torch.exp2(s * c - lse2[..., None])
    if causal:
        p = torch.where(_rect_keep(q3.shape[1], k3.shape[1], q_off, k_off, q3.device), p, 0.0)
    dp = torch.matmul(tf32_round(do), tf32_round(v3).transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_1pass_plain(q3, k3, v3, do, lse, delta, scale: float, causal: bool = True, q_off: int = 0,
                             k_off: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the one-pass dq (both families)."""
    _, ds = _p_ds_1pass(q3, k3, v3, do, lse, delta, scale, causal, q_off, k_off)
    return torch.matmul(tf32_round(ds), tf32_round(k3)) * scale


def flash_bwd_dkv_1pass_plain(q3, k3, v3, do, lse, delta, scale: float, causal: bool = True, q_off: int = 0,
                              k_off: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the one-pass (dk, dv) (both families)."""
    p, ds = _p_ds_1pass(q3, k3, v3, do, lse, delta, scale, causal, q_off, k_off)
    dk = torch.matmul(tf32_round(ds).transpose(-1, -2), tf32_round(q3)) * scale
    return dk, torch.matmul(tf32_round(p).transpose(-1, -2), tf32_round(do))


def _check_rect(q3, k3, v3, do=None, lse=None, delta=None, q_off=0, k_off=0, dtype=torch.float32):
    """(bh, s_q, s_kv, d) after the kernels' checks: q (and dO) `[BH, Sq, D]`,
    k, v `[BH, Skv, D]` of `dtype`, lse and delta `[BH, Sq]` f32, all
    contiguous."""
    bh, s_q, d = q3.shape
    s_kv = k3.shape[1]
    check_shape(s_q, d, s_kv)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernels take D in {HEAD_DIMS} (the public entries pad up to one)")
    if bh > MAX_BH:
        raise ValueError(f"batch·heads {bh} exceeds {MAX_BH}")
    if max(abs(q_off), abs(k_off)) >= MAX_OFFSET:
        raise ValueError(f"offsets ({q_off}, {k_off}) outside (-{MAX_OFFSET}, {MAX_OFFSET})")
    for name, t, shape in (("q", q3, (bh, s_q, d)), ("k", k3, (bh, s_kv, d)), ("v", v3, (bh, s_kv, d)),
                           ("do", do, (bh, s_q, d))):
        if t is not None:
            _check(name, t, shape, dtype)
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the kernels need 16-byte aligned rows")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None:
            _check(name, t, (bh, s_q), torch.float32)
    return bh, s_q, s_kv, d


def _check_aligned(q3, k3, v3, do=None, lse=None, delta=None, dtype=torch.float32):
    """`_check_rect`'s checks, and s_q == s_kv: (bh, s, d)."""
    bh, s_q, s_kv, d = _check_rect(q3, k3, v3, do, lse, delta, dtype=dtype)
    if s_q != s_kv:
        raise ValueError(f"the aligned causal kernels need as many keys as queries, got {s_kv} and {s_q}")
    return bh, s_q, d


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


# ---------------------------------------------------------------------------
# The aligned causal family (f32 inputs, 'highest' or 'default')
# ---------------------------------------------------------------------------


def flash_fwd(q3, k3, v3, scale: float, precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward on `[BH, S, D]` f32: (o, lse)."""
    passes = passes_of(precision)
    if _on_cpu(q3, k3, v3):
        return flash_fwd_plain(q3, k3, v3, scale) if passes == 3 else flash_fwd_1pass_plain(q3, k3, v3, scale)
    bh, s, d = _check_aligned(q3, k3, v3)
    o = torch.empty_like(q3)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q3.device)
    _launched("flash_fwd", _kernels().flash_fwd_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, s, d, scale, passes,
        _stream(q3)))
    _count("flash_fwd", passes)
    return o, lse


def flash_bwd_dq(q3, k3, v3, do, lse, delta, scale: float, precision: str = "highest") -> torch.Tensor:
    """dq `[BH, S, D]` of causal attention from (q, k, v, dO) and the row
    statistics lse, delta = rowsum(dO ∘ o) `[BH, S]`."""
    passes = passes_of(precision)
    if _on_cpu(q3, k3, v3, do, lse, delta):
        if passes == 3:
            return flash_bwd_dq_plain(q3, k3, v3, do, lse, delta, scale)
        return flash_bwd_dq_1pass_plain(q3, k3, v3, do, lse, delta, scale)
    bh, s, d = _check_aligned(q3, k3, v3, do, lse, delta)
    dq = torch.empty_like(q3)
    _launched("flash_bwd_dq", _kernels().flash_bwd_dq_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), bh, s, d, scale, passes, _stream(q3)))
    _count("flash_bwd_dq", passes)
    return dq


def flash_bwd_dkv(q3, k3, v3, do, lse, delta, scale: float,
                  precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) `[BH, S, D]` from the same inputs as `flash_bwd_dq`."""
    passes = passes_of(precision)
    if _on_cpu(q3, k3, v3, do, lse, delta):
        if passes == 3:
            return flash_bwd_dkv_plain(q3, k3, v3, do, lse, delta, scale)
        return flash_bwd_dkv_1pass_plain(q3, k3, v3, do, lse, delta, scale)
    bh, s, d = _check_aligned(q3, k3, v3, do, lse, delta)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _launched("flash_bwd_dkv", _kernels().flash_bwd_dkv_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, s, d, scale, passes, _stream(q3)))
    _count("flash_bwd_dkv", passes)
    return dk, dv


def flash_bwd(q3, k3, v3, o, lse, do, scale: float, precision: str = "highest"):
    """Causal attention backward: (dq, dk, dv), each `[BH, S, D]`.

    delta = rowsum(dO ∘ o) is a plain reduction, as in the JAX package.
    """
    if _on_cpu(q3, k3, v3, o, lse, do) and passes_of(precision) == 3:
        return flash_bwd_plain(q3, k3, v3, o, lse, do, scale)
    delta = (do * o).sum(-1)
    dq = flash_bwd_dq(q3, k3, v3, do, lse, delta, scale, precision)
    return (dq, *flash_bwd_dkv(q3, k3, v3, do, lse, delta, scale, precision))


# ---------------------------------------------------------------------------
# The rectangular family (f32 inputs, 'highest' or 'default')
# ---------------------------------------------------------------------------


def flash_fwd_rect(q3, k3, v3, scale: float, causal: bool = False, q_off: int = 0, k_off: int = 0,
                   precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Rectangular attention forward, q `[BH, Sq, D]` against k, v `[BH, Skv, D]`
    f32, non-causal or causal on global offsets: (o, lse)."""
    passes = passes_of(precision)
    if _on_cpu(q3, k3, v3):
        plain = flash_fwd_rect_plain if passes == 3 else flash_fwd_1pass_plain
        return plain(q3, k3, v3, scale, causal, q_off, k_off)
    bh, s_q, s_kv, d = _check_rect(q3, k3, v3, q_off=q_off, k_off=k_off)
    o = torch.empty_like(q3)
    lse = torch.empty((bh, s_q), dtype=torch.float32, device=q3.device)
    _launched("flash_fwd_rect", _kernels().flash_fwd_rect_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, s_q, s_kv, d, int(causal), q_off, k_off, scale, passes, _stream(q3)))
    _count("flash_fwd_rect", passes)
    return o, lse


def flash_bwd_dq_rect(q3, k3, v3, do, lse, delta, scale: float, causal: bool = False, q_off: int = 0,
                      k_off: int = 0, precision: str = "highest") -> torch.Tensor:
    """dq `[BH, Sq, D]` of the rectangular family from (q, k, v, dO) and the
    row statistics lse, delta `[BH, Sq]`."""
    passes = passes_of(precision)
    if _on_cpu(q3, k3, v3, do, lse, delta):
        plain = flash_bwd_dq_rect_plain if passes == 3 else flash_bwd_dq_1pass_plain
        return plain(q3, k3, v3, do, lse, delta, scale, causal, q_off, k_off)
    bh, s_q, s_kv, d = _check_rect(q3, k3, v3, do, lse, delta, q_off, k_off)
    dq = torch.empty_like(q3)
    _launched("flash_bwd_dq_rect", _kernels().flash_bwd_dq_rect_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), bh, s_q, s_kv, d, int(causal), q_off, k_off, scale, passes, _stream(q3)))
    _count("flash_bwd_dq_rect", passes)
    return dq


def flash_bwd_dkv_rect(q3, k3, v3, do, lse, delta, scale: float, causal: bool = False, q_off: int = 0,
                       k_off: int = 0, precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) `[BH, Skv, D]` from the same inputs as `flash_bwd_dq_rect`."""
    passes = passes_of(precision)
    if _on_cpu(q3, k3, v3, do, lse, delta):
        plain = flash_bwd_dkv_rect_plain if passes == 3 else flash_bwd_dkv_1pass_plain
        return plain(q3, k3, v3, do, lse, delta, scale, causal, q_off, k_off)
    bh, s_q, s_kv, d = _check_rect(q3, k3, v3, do, lse, delta, q_off, k_off)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _launched("flash_bwd_dkv_rect", _kernels().flash_bwd_dkv_rect_launch(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, s_q, s_kv, d, int(causal), q_off, k_off, scale, passes, _stream(q3)))
    _count("flash_bwd_dkv_rect", passes)
    return dk, dv


# ---------------------------------------------------------------------------
# The bf16 causal trio (`cast16`): bf16 q, k, v at 'default'
# ---------------------------------------------------------------------------


def prescale_q(q3: torch.Tensor, scale: float) -> torch.Tensor:
    """q pre-scaled into the base-2 score domain and rounded back to its
    dtype, as the JAX package's `_prescale_q`: bf16(f32(q) · scale·log2 e)."""
    return (q3.to(torch.float32) * _f32(scale * LOG2E)).to(q3.dtype)


def _causal_keep(s: int, device) -> torch.Tensor:
    return torch.ones((s, s), dtype=torch.bool, device=device).tril()


def flash_fwd_bf16_plain(qs, k3, v3, keys: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `flash_fwd_bf16`, tile by tile as the kernel
    runs it: (o, lse) f32 from bf16 `qs` (pre-scaled), k, v; `keys` keys a
    tile (the kernel's, `BF16_FWD_KEYS[D]`, unless given). The row sum l is
    Σ f32(bf16(P)) at every D: the JAX package forms it on the MXU against a
    ones column of V where D is not a multiple of 128 (`fuse_l`) and in its
    l scratch where it is (D 128), the same terms either way."""
    bh, s, d = qs.shape
    keys = BF16_FWD_KEYS[padded_dim(d)] if keys is None else keys
    dev = qs.device
    qf, kf, vf = qs.float(), k3.float(), v3.float()
    keep = _causal_keep(s, dev)
    m = torch.full((bh, s), -1e30, device=dev)
    acc = torch.zeros((bh, s, d), device=dev)
    l = torch.zeros((bh, s), device=dev)
    for kt in range(0, s, keys):
        sc = torch.where(keep[:, kt:kt + keys], torch.matmul(qf, kf[:, kt:kt + keys].transpose(-1, -2)), -math.inf)
        mn = torch.maximum(m, sc.amax(-1))
        corr = torch.exp2(m - mn)
        p = bf16_round(torch.exp2(sc - mn[..., None]))  # 0 where masked
        acc = acc * corr[..., None] + torch.matmul(p, vf[:, kt:kt + keys])
        l = l * corr + p.sum(-1)
        m = mn
    l = l.clamp_min(1e-30)
    return acc / l[..., None], (m + torch.log2(l)) * LN2


def _p_ds_bf16(qs, k3, v3, do16, lse, delta):
    """The bf16 backward's P and dS in f32, before their rounding to bf16."""
    s = torch.matmul(qs.float(), k3.float().transpose(-1, -2))
    p = torch.where(_causal_keep(qs.shape[1], qs.device), torch.exp2(s - (lse * LOG2E)[..., None]), 0.0)
    dp = torch.matmul(do16.float(), v3.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_bf16_plain(qs, k3, v3, do16, lse, delta, scale: float) -> torch.Tensor:
    """Plain PyTorch version of `flash_bwd_dq_bf16`: dq in bf16."""
    _, ds = _p_ds_bf16(qs, k3, v3, do16, lse, delta)
    return (torch.matmul(bf16_round(ds), k3.float()) * scale).to(torch.bfloat16)


def flash_bwd_dkv_bf16_plain(qs, k3, v3, do16, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `flash_bwd_dkv_bf16`: (dk, dv) in bf16."""
    p, ds = _p_ds_bf16(qs, k3, v3, do16, lse, delta)
    dk = torch.matmul(bf16_round(ds).transpose(-1, -2), qs.float()) * LN2
    dv = torch.matmul(bf16_round(p).transpose(-1, -2), do16.float())
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def flash_fwd_bf16(qs, k3, v3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal forward on bf16 `[BH, S, D]` (q pre-scaled by `prescale_q`):
    (o, lse) in f32."""
    if _on_cpu(qs, k3, v3):
        return flash_fwd_bf16_plain(qs, k3, v3)
    bh, s, d = _check_aligned(qs, k3, v3, dtype=torch.bfloat16)
    o = torch.empty((bh, s, d), dtype=torch.float32, device=qs.device)
    lse = torch.empty((bh, s), dtype=torch.float32, device=qs.device)
    _launched("flash_fwd_bf16", _kernels_bf16().flash_fwd_bf16_launch(
        qs.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, s, d, _stream(qs)))
    LAUNCHES["flash_fwd_bf16"] += 1
    return o, lse


def flash_bwd_dq_bf16(qs, k3, v3, do16, lse, delta, scale: float) -> torch.Tensor:
    """dq `[BH, S, D]` bf16 from bf16 qs, k, v, dO and f32 lse, delta `[BH, S]`."""
    if _on_cpu(qs, k3, v3, do16, lse, delta):
        return flash_bwd_dq_bf16_plain(qs, k3, v3, do16, lse, delta, scale)
    bh, s, d = _check_aligned(qs, k3, v3, do16, lse, delta, dtype=torch.bfloat16)
    dq = torch.empty_like(qs)
    _launched("flash_bwd_dq_bf16", _kernels_bf16().flash_bwd_dq_bf16_launch(
        qs.data_ptr(), k3.data_ptr(), v3.data_ptr(), do16.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), bh, s, d, scale, _stream(qs)))
    LAUNCHES["flash_bwd_dq_bf16"] += 1
    return dq


def flash_bwd_dkv_bf16(qs, k3, v3, do16, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) `[BH, S, D]` bf16 from the same inputs as `flash_bwd_dq_bf16`."""
    if _on_cpu(qs, k3, v3, do16, lse, delta):
        return flash_bwd_dkv_bf16_plain(qs, k3, v3, do16, lse, delta)
    bh, s, d = _check_aligned(qs, k3, v3, do16, lse, delta, dtype=torch.bfloat16)
    dk, dv = torch.empty_like(k3), torch.empty_like(v3)
    _launched("flash_bwd_dkv_bf16", _kernels_bf16().flash_bwd_dkv_bf16_launch(
        qs.data_ptr(), k3.data_ptr(), v3.data_ptr(), do16.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, s, d, _stream(qs)))
    LAUNCHES["flash_bwd_dkv_bf16"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# Autograd and the public entries
# ---------------------------------------------------------------------------


class _FlashCausal(torch.autograd.Function):
    """o = causal attention of `[BH, S, D]` f32 q, k, v at `precision`; the
    backward recomputes P from the saved lse (flash-2)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, precision="highest"):
        o, lse = flash_fwd(q3, k3, v3, scale, precision)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale, ctx.precision = scale, precision
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q3, k3, v3, o, lse, do.contiguous(), ctx.scale, ctx.precision)
        return dq, dk, dv, None, None


class _FlashCausalBf16(torch.autograd.Function):
    """o (f32) = causal attention of `[BH, S, D]` bf16 q, k, v on the bf16
    trio; the backward's delta = rowsum(dO ∘ o) in f32 from the f32 o, dO
    rounded to bf16 once, and the cotangents in bf16 (the JAX package's
    `_flash3_bwd` and `_bwd_tri` under `cast16`)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale):
        qs = prescale_q(q3, scale)
        o, lse = flash_fwd_bf16(qs, k3, v3)
        ctx.save_for_backward(qs, k3, v3, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k3, v3, o, lse = ctx.saved_tensors
        do = do.to(torch.float32)
        delta = (do * o).sum(-1)
        do16 = do.to(torch.bfloat16).contiguous()
        dq = flash_bwd_dq_bf16(qs, k3, v3, do16, lse, delta, ctx.scale)
        dk, dv = flash_bwd_dkv_bf16(qs, k3, v3, do16, lse, delta)
        return dq, dk, dv, None


class _FlashRect(torch.autograd.Function):
    """(o, lse) of the rectangular family, both differentiable. The lse
    cotangent enters the backward as a shift of delta, as in the JAX
    package's `_flash3_bwd`: d lse/d scores is the softmax P itself, so
    dS = P ∘ (dP − delta) with delta = rowsum(dO ∘ o) − dlse. A missing
    cotangent (an output left unused) is zero."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal, q_off, k_off, precision="highest"):
        o, lse = flash_fwd_rect(q3, k3, v3, scale, causal, q_off, k_off, precision)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.args = (scale, causal, q_off, k_off, precision)
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
        return dq, dk, dv, None, None, None, None, None


def _to3(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d).to(dtype).contiguous()


def _scale(sm_scale: Optional[float], d: int) -> float:
    return float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False, sm_scale: Optional[float] = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Exact attention, blockwise. q, k, v: `[B, S, H, D]` -> same, in q's dtype.

    Drop-in for `ops.attention.dense_attention` when S is a multiple of
    128: the `[S, S]` scores never exist in device memory, forward or
    backward. Causal runs the aligned kernels over the triangle; non-causal
    (the default, as in the JAX package) the rectangular ones.
    `precision` is the JAX package's: `'highest'` (f32 products) or
    `'default'` (one TF32 pass a product). bf16 q, k, v at `'default'` with
    `causal=True` run the bf16 trio (`cast16`: bf16 probabilities and dS,
    f32 accumulators and statistics); any other input is upcast to f32,
    exactly. Cotangents come back in the inputs' dtype.
    """
    b, s, h, d = q.shape
    check_shape(s, d)
    passes_of(precision)
    scale = _scale(sm_scale, d)
    dp = padded_dim(d)
    dtype = q.dtype
    q, k, v = (_pad_last(t, dp) for t in (q, k, v))  # autograd slices the padding off dq, dk, dv
    if causal and dtype == torch.bfloat16 and precision == "default":  # the JAX package's cast16
        if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
            raise ValueError(f"bf16 q needs bf16 k and v on the bf16 path, got {k.dtype} and {v.dtype}")
        o = _FlashCausalBf16.apply(*(_to3(t, torch.bfloat16) for t in (q, k, v)), scale)
    elif causal:
        o = _FlashCausal.apply(_to3(q), _to3(k), _to3(v), scale, precision)
    else:
        o, _ = _FlashRect.apply(_to3(q), _to3(k), _to3(v), scale, False, 0, 0, precision)
    return o.reshape(b, h, s, dp).permute(0, 2, 1, 3)[..., :d].to(dtype)


def flash_block(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset, k_offset, causal: bool = False,
    sm_scale: Optional[float] = None, precision: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (Q block, KV block) partial attention with global positions.

    q: `[B, Sq, H, D]` at global positions `q_offset + [0, Sq)`; k, v:
    `[B, Skv, H, D]` at `k_offset + [0, Skv)`. Returns `(o, lse)`, f32
    whatever the input dtype (partials feed an online-softmax merge) and
    head-major — o `[B, H, Sq, D]`, lse `[B, H, Sq]` — the pair an
    online-softmax merge folds across blocks (o = 0 and lse = -1e30 for
    causal rows that see no key). Differentiable in q, k, v, including
    through uses of lse. `precision` as in `flash_attention`; the
    rectangular kernels take inputs upcast to f32. D pads as in
    `flash_attention`.
    """
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    check_shape(s_q, d, s_kv)
    passes_of(precision)
    dp = padded_dim(d)
    q, k, v = (_pad_last(t, dp) for t in (q, k, v))
    o, lse = _FlashRect.apply(_to3(q), _to3(k), _to3(v), _scale(sm_scale, d), bool(causal),
                              int(q_offset), int(k_offset), precision)
    return o.reshape(b, h, s_q, dp)[..., :d], lse.reshape(b, h, s_q)
