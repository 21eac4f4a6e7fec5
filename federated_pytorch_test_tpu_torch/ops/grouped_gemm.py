"""Grouped GEMM `[G, M, K] x [G, K, N] -> [G, M, N]`: a hand-written CUDA kernel for Hopper.

Counterpart of the JAX package's `ops/grouped_gemm.py` (`grouped_matmul_pallas`,
the TPU kernel; `grouped_matmul`, its public entry). The switch-MoE MLP
(`models/moe.py`) runs its experts through it: `[K·E, C, D] x [K·E, D, H]`
and back, K clients times E experts as the groups.

`grouped_matmul` is an autograd function over one kernel a dtype, built on
first use: f32 operands take `csrc/grouped_gemm.cu` (split-TF32 products on
the tensor cores, `wgmma`), bf16 operands `csrc/grouped_gemm_bf16.cu` (bf16
`wgmma`, f32 accumulators, the output rounded to bf16 once, as the Pallas
kernel writes lhs's dtype). Each serves three roles, each counted under its
own name in `LAUNCHES` (bf16 launches under the same names with `_bf16`
appended):

* `grouped_matmul` — the forward, C = A·B;
* `grouped_matmul_dlhs` — the input gradient dA = dC·Bᵀ, with Bᵀ a view;
* `grouped_matmul_drhs` — the weight gradient dB = Aᵀ·dC, with Aᵀ a view,
  a contraction over M (C = 20,480 slots on the ViT path). Where the output
  has too few tiles to fill the card, the contraction is split into chunks
  whose partials a second kernel adds in chunk order (`grouped_sum`,
  counted as `grouped_matmul_sum`; `split_k`).

Each gradient is computed only when autograd asks for it, so frozen
experts cost no weight gradient. Every sum has a fixed order and no
atomics: two launches give equal bits.

Each role takes its plain PyTorch version (`torch.bmm` in f32, rounded to
bf16 for bf16 operands) for CPU tensors and only then; for CUDA tensors it
launches the kernel or raises. Both operands are float32 or both bfloat16;
the gradients come back in the operands' dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from .compact_cuda import _on_cpu

ROLES = ("grouped_matmul", "grouped_matmul_dlhs", "grouped_matmul_drhs", "grouped_matmul_sum")
BF16_ROLES = tuple(f"{r}_bf16" for r in ROLES)
# kernel launches per role since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = dict.fromkeys((*ROLES, *BF16_ROLES), 0)
DTYPES = (torch.float32, torch.bfloat16)  # the operand dtypes the kernels take

TK = 32  # kBK in the f32 source: the contraction positions a stage (64 in the bf16 one)
# Where the output has fewer tiles than SPLIT_TILES (two blocks for each of
# an H100's 132 SMs), the contraction runs in chunks of SPLIT_CHUNK. A
# function of the shapes alone, so a result does not depend on the card.
SPLIT_TILES = 264
SPLIT_CHUNK = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels(dtype=torch.float32):
    """The loaded library for `dtype` operands: `grouped_gemm` (f32) or
    `grouped_gemm_bf16`, each with its GEMM and split-sum entry points
    bound as `gemm` and `sum`."""
    name = "grouped_gemm_bf16" if dtype == torch.bfloat16 else "grouped_gemm"
    if name not in _libs:
        from .build import load

        lib = load(name)
        suffix = "_bf16" if dtype == torch.bfloat16 else ""
        lib.gemm = getattr(lib, f"grouped_gemm{suffix}_launch")
        lib.gemm.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _L, _L, _I, _I, _I, _P]
        lib.gemm.restype = _I
        lib.sum = getattr(lib, f"grouped_sum{suffix}_launch")
        lib.sum.argtypes = [_P, _P, _L, _I, _P]
        lib.sum.restype = _I
        _libs[name] = lib
    return _libs[name]


def check_operands(lhs: torch.Tensor, rhs: torch.Tensor, dtypes=DTYPES) -> Tuple[int, int, int, int]:
    """(G, M, K, N) of `lhs [G, M, K]` and `rhs [G, K, N]`; raises ValueError
    on shapes that disagree (as the JAX package's kernel does) and on a
    dtype outside `dtypes`."""
    if lhs.ndim != 3 or rhs.ndim != 3 or lhs.shape[0] != rhs.shape[0] or lhs.shape[2] != rhs.shape[1]:
        raise ValueError(f"grouped_matmul shapes disagree: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}")
    if lhs.dtype not in dtypes or rhs.dtype != lhs.dtype:
        raise ValueError(f"grouped_matmul takes {' or '.join(map(str, dtypes))} operands, got {lhs.dtype} and {rhs.dtype}")
    g, m, k = lhs.shape
    return g, m, k, rhs.shape[2]


def tiles(m: int, n: int) -> Tuple[int, int]:
    """The kernel instance's output tile (BM, BN) for an M x N output: two
    warpgroups of 64 x 64, side by side in N (64 x 128) where N is wider
    than one, else stacked in M (128 x 64)."""
    return (64, 128) if n > 64 else (128, 64)


def split_k(g: int, m: int, n: int, k: int) -> Tuple[int, int]:
    """(splits, chunk) of the contraction: one split of K unless the output
    has too few tiles to fill the card and K is longer than one chunk."""
    bm, bn = tiles(m, n)
    if k <= SPLIT_CHUNK or g * math.ceil(m / bm) * math.ceil(n / bn) >= SPLIT_TILES:
        return 1, k
    return math.ceil(k / SPLIT_CHUNK), SPLIT_CHUNK


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `torch.bmm` (full f32 unless TF32 is enabled;
    float64 too, the reference the kernel is held against on the card). On
    bf16 operands the exact products are summed in f32 and rounded to bf16
    once, as the kernel does."""
    check_operands(lhs, rhs, (*DTYPES, torch.float64))
    if lhs.dtype == torch.bfloat16:
        return torch.bmm(lhs.float(), rhs.float()).to(torch.bfloat16)
    return torch.bmm(lhs, rhs)


def _layout(t: torch.Tensor) -> Tuple[torch.Tensor, int, int, int]:
    """(tensor, transposed, group stride, leading stride) of a `[G, R, C]`
    operand the kernel reads in place: row-major (C contiguous) or a
    transposed view (R contiguous); anything else (a caller's strided
    slice) is copied row-major."""
    g, r, c = t.shape
    sg, sr, sc = t.stride()
    if sc == 1 and (r == 1 or sr >= c):
        return t, 0, sg, (sr if r > 1 else c)
    if sr == 1 and (c == 1 or sc >= r):
        return t, 1, sg, (sc if c > 1 else r)
    t = t.contiguous()
    return t, 0, r * c, c


def _launch(lhs: torch.Tensor, rhs: torch.Tensor, role: str) -> torch.Tensor:
    """`lhs @ rhs` per group on the card, counted under `role` (and the
    chunk sum under `grouped_matmul_sum` where the contraction is split),
    with `_bf16` appended for bf16 operands."""
    g, m, k, n = check_operands(lhs, rhs)
    if min(g, m, k, n) < 1:
        raise ValueError(f"grouped_matmul needs non-empty operands, got {tuple(lhs.shape)} x {tuple(rhs.shape)}")
    if lhs.device != rhs.device:
        raise ValueError(f"grouped_matmul operands on {lhs.device} and {rhs.device}")
    a, a_t, a_g, lda = _layout(lhs)
    # one transposed operand at most: a caller that transposes the output
    # hands the backward a transposed dC beside the transposed Bᵀ or Aᵀ
    b, b_t, b_g, ldb = _layout(rhs if not a_t else rhs.contiguous())
    bm, bn = tiles(m, n)
    splits, chunk = split_k(g, m, n, k)
    out = torch.empty((g, m, n), dtype=lhs.dtype, device=lhs.device)
    # the split contraction's partials stay f32 whatever the operands' dtype
    dst = out if splits == 1 else torch.empty((splits, g, m, n), dtype=torch.float32, device=lhs.device)
    rc = _kernels(lhs.dtype).gemm(
        a.data_ptr(), b.data_ptr(), dst.data_ptr(), g, m, n, k, a_t, a_g, lda, b_t, b_g, ldb, bm, bn, chunk,
        torch.cuda.current_stream(lhs.device).cuda_stream,
    )
    if lhs.dtype == torch.bfloat16:
        role += "_bf16"
    if rc != 0:
        raise RuntimeError(f"{role}: CUDA launch failed (cudaError {rc})")
    LAUNCHES[role] += 1
    return out if splits == 1 else grouped_sum(dst, out)


def grouped_sum_plain(partials: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of `grouped_sum`: the splits added in order,
    the sum rounded to `dtype` once."""
    out = partials[0].clone()
    for p in partials[1:]:
        out += p
    return out.to(dtype)


def grouped_sum(partials: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Σ_s partials[s] of contiguous f32 `partials [S, ...]`, added in split
    order and rounded once to `out`'s dtype (float32 or bfloat16; float32
    where no `out` is given), into `out`."""
    dtype = torch.float32 if out is None else out.dtype
    if dtype not in DTYPES:
        raise ValueError(f"grouped_sum writes float32 or bfloat16, got {dtype}")
    if _on_cpu(partials):
        return grouped_sum_plain(partials, dtype)
    if partials.dtype != torch.float32 or not partials.is_contiguous() or partials.shape[0] < 1:
        raise ValueError(f"grouped_sum takes contiguous float32 partials [S, ...], got {partials.dtype} "
                         f"{tuple(partials.shape)}")
    if out is None:
        out = torch.empty(partials.shape[1:], dtype=dtype, device=partials.device)
    elif out.shape != partials.shape[1:] or not out.is_contiguous() or out.device != partials.device:
        raise ValueError(f"grouped_sum: out must be a contiguous {tuple(partials.shape[1:])} tensor on "
                         f"{partials.device}, got {tuple(out.shape)} on {out.device}")
    role = "grouped_matmul_sum_bf16" if dtype == torch.bfloat16 else "grouped_matmul_sum"
    rc = _kernels(dtype).sum(partials.data_ptr(), out.data_ptr(), out.numel(), partials.shape[0],
                             torch.cuda.current_stream(partials.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{role}: CUDA launch failed (cudaError {rc})")
    LAUNCHES[role] += 1
    return out


def grouped_matmul_fwd(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """C = A·B `[G, M, N]`."""
    if _on_cpu(lhs, rhs):
        return grouped_matmul_plain(lhs, rhs)
    return _launch(lhs, rhs, "grouped_matmul")


def grouped_matmul_dlhs(dout: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """dA = dC·Bᵀ `[G, M, K]` from dC `[G, M, N]` and B `[G, K, N]`."""
    rhs_t = rhs.transpose(1, 2)
    if _on_cpu(dout, rhs):
        return grouped_matmul_plain(dout, rhs_t)
    return _launch(dout, rhs_t, "grouped_matmul_dlhs")


def grouped_matmul_drhs(lhs: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """dB = Aᵀ·dC `[G, K, N]` from A `[G, M, K]` and dC `[G, M, N]`."""
    lhs_t = lhs.transpose(1, 2)
    if _on_cpu(lhs, dout):
        return grouped_matmul_plain(lhs_t, dout)
    return _launch(lhs_t, dout, "grouped_matmul_drhs")


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs):
        ctx.save_for_backward(lhs, rhs)
        return grouped_matmul_fwd(lhs, rhs)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs = ctx.saved_tensors
        dlhs = grouped_matmul_dlhs(dout, rhs) if ctx.needs_input_grad[0] else None
        drhs = grouped_matmul_drhs(lhs, dout) if ctx.needs_input_grad[1] else None
        return dlhs, drhs


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """`[G, M, K] x [G, K, N] -> [G, M, N]` in the operands' dtype (f32 or
    bf16), differentiable in both operands."""
    check_operands(lhs, rhs)
    return _GroupedMatmul.apply(lhs, rhs)
