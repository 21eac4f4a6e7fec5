"""Grouped GEMM `[G, M, K] x [G, K, N] -> [G, M, N]`: a hand-written CUDA kernel for Hopper.

Counterpart of the JAX package's `ops/grouped_gemm.py` (`grouped_matmul_pallas`,
the TPU kernel; `grouped_matmul`, its public entry). The switch-MoE MLP
(`models/moe.py`) runs its experts through it: `[K·E, C, D] x [K·E, D, H]`
and back, K clients times E experts as the groups.

`grouped_matmul` is an autograd function over one kernel
(`csrc/grouped_gemm.cu`, built on first use) that serves three roles, each
counted under its own name in `LAUNCHES`:

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

Each role takes its plain PyTorch version (`torch.bmm`, f32) for CPU
tensors and only then; for CUDA tensors it launches the kernel or raises.
Only float32 is taken (the port has no bf16 path).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from .compact_cuda import _on_cpu

# kernel launches per role since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = {
    "grouped_matmul": 0, "grouped_matmul_dlhs": 0, "grouped_matmul_drhs": 0, "grouped_matmul_sum": 0,
}

TK = 16  # kTK in the CUDA source: the contraction chunk staged in shared memory
# Where the output has fewer tiles than SPLIT_TILES (two blocks for each of
# an H100's 132 SMs), the contraction runs in chunks of SPLIT_CHUNK. A
# function of the shapes alone, so a result does not depend on the card.
SPLIT_TILES = 264
SPLIT_CHUNK = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("grouped_gemm")
        lib.grouped_gemm_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I, _L, _L, _I, _I, _I, _P]
        lib.grouped_gemm_launch.restype = _I
        lib.grouped_sum_launch.argtypes = [_P, _P, _L, _I, _P]
        lib.grouped_sum_launch.restype = _I
        _lib = lib
    return _lib


def check_operands(lhs: torch.Tensor, rhs: torch.Tensor, dtypes=(torch.float32,)) -> Tuple[int, int, int, int]:
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
    """The kernel instance's output tile (BM, BN) for an M x N output:
    128 x 128, 128 x 64 or 64 x 128."""
    bm = 128 if m > 64 else 64
    return bm, (128 if n > 64 or bm == 64 else 64)


def split_k(g: int, m: int, n: int, k: int) -> Tuple[int, int]:
    """(splits, chunk) of the contraction: one split of K unless the output
    has too few tiles to fill the card and K is longer than one chunk."""
    bm, bn = tiles(m, n)
    if k <= SPLIT_CHUNK or g * math.ceil(m / bm) * math.ceil(n / bn) >= SPLIT_TILES:
        return 1, k
    return math.ceil(k / SPLIT_CHUNK), SPLIT_CHUNK


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: `torch.bmm` (full f32 unless TF32 is enabled;
    float64 too, the reference the kernel is held against on the card)."""
    check_operands(lhs, rhs, (torch.float32, torch.float64))
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
    chunk sum under `grouped_matmul_sum` where the contraction is split)."""
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
    out = torch.empty((g, m, n), dtype=torch.float32, device=lhs.device)
    dst = out if splits == 1 else torch.empty((splits, g, m, n), dtype=torch.float32, device=lhs.device)
    rc = _kernels().grouped_gemm_launch(
        a.data_ptr(), b.data_ptr(), dst.data_ptr(), g, m, n, k, a_t, a_g, lda, b_t, b_g, ldb, bm, bn, chunk,
        torch.cuda.current_stream(lhs.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{role}: CUDA launch failed (cudaError {rc})")
    LAUNCHES[role] += 1
    return out if splits == 1 else grouped_sum(dst, out)


def grouped_sum_plain(partials: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `grouped_sum`: the splits added in order."""
    out = partials[0].clone()
    for p in partials[1:]:
        out += p
    return out


def grouped_sum(partials: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Σ_s partials[s] of contiguous f32 `partials [S, ...]`, added in split order (into `out`)."""
    if _on_cpu(partials):
        return grouped_sum_plain(partials)
    if partials.dtype != torch.float32 or not partials.is_contiguous() or partials.shape[0] < 1:
        raise ValueError(f"grouped_sum takes contiguous float32 partials [S, ...], got {partials.dtype} "
                         f"{tuple(partials.shape)}")
    if out is None:
        out = torch.empty(partials.shape[1:], dtype=torch.float32, device=partials.device)
    rc = _kernels().grouped_sum_launch(partials.data_ptr(), out.data_ptr(), out.numel(), partials.shape[0],
                                       torch.cuda.current_stream(partials.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul_sum: CUDA launch failed (cudaError {rc})")
    LAUNCHES["grouped_matmul_sum"] += 1
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
    """`[G, M, K] x [G, K, N] -> [G, M, N]` in f32, differentiable in both operands."""
    check_operands(lhs, rhs)
    return _GroupedMatmul.apply(lhs, rhs)
