"""Fused compact L-BFGS direction: hand-written CUDA kernels for Hopper.

Counterpart of the JAX package's `ops/compact_pallas.py`. The compact
direction (`optim/compact.py`) reads the `[K, m, N]` history several times
through separate contractions; two kernels bound that traffic at two
passes:

* `fused_gram_projections` — ONE pass over (S, Y, g) producing all four
  contractions `S Yᵀ`, `Y Yᵀ` `[K,m,m]` and `Sᵀg`, `Yᵀg` `[K,m]`;
* `fused_direction_assembly` — ONE pass producing
  `hg = γ·g + wᵀS − γ·(uᵀY)`.

History-slot validity (`i < count[k]`) is masked inside the kernels, so
the raw history buffers feed them directly. The m×m solves between the
passes are `optim.compact.compact_solves`, shared with the plain backend.

Each wrapper takes its plain PyTorch version for CPU tensors and only
then; for CUDA tensors it launches the kernel (`csrc/compact_direction.cu`,
built on first use) or raises. `LAUNCHES` counts kernel launches per
wrapper, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from ..optim.compact import _bdot, compact_solves, history_valid

# kernel launches per wrapper since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = {"fused_gram_projections": 0, "fused_direction_assembly": 0}

MAX_HISTORY = 16  # kMaxM in the CUDA source
_TILE = 256  # kTile in the CUDA source: columns per gram tile
# gram blocks per client: one per tile up to this cap, then each block
# takes an equal run of tiles (at K = 3, one block for each of an H100's
# 132 SMs; a sweep of 16–128 on the card found it fastest at N = 48,120
# and 4.7M). A function of N alone, so a result does not depend on the card.
_MAX_CHUNKS = 44

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib = None
# the gram's scratch per device, kept between calls: partials and the
# per-client ticket counters (zero between launches; the kernel leaves them
# zero). Calls on one stream reuse it in order.
_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("compact_direction")
        lib.compact_gram_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _P]
        lib.compact_gram_launch.restype = _I
        lib.compact_assembly_launch.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _P]
        lib.compact_assembly_launch.restype = _I
        _lib = lib
    return _lib


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True if every tensor is on the CPU; False if every one is on CUDA."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {sorted(kinds)}")


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], dtype: torch.dtype) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {shape}, got "
            f"{t.dtype} {tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def _vec_ok(n: int, *ts: torch.Tensor) -> int:
    """16-byte loads need rows of a multiple of 4 floats on aligned bases."""
    return int(n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def _check_history(s, y, g, count):
    k, m, n = s.shape
    if not 1 <= m <= MAX_HISTORY:
        raise ValueError(f"history size {m} outside [1, {MAX_HISTORY}]")
    _check("s", s, (k, m, n), torch.float32)
    _check("y", y, (k, m, n), torch.float32)
    _check("g", g, (k, n), torch.float32)
    _check("count", count, (k,), torch.int32)
    return k, m, n


def _masked(s, y, count):
    valid = history_valid(count, s.shape[-2])[..., None]
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    return torch.where(valid, s, zero), torch.where(valid, y, zero)


def fused_gram_projections_plain(s, y, g, count):
    """Plain PyTorch version of `fused_gram_projections`.

    The projections are elementwise products summed by a tree reduction:
    a batched matrix-vector product over millions of columns accumulates
    more rounding error than the kernel it is held against.
    """
    s, y = _masked(s, y, count)
    gb = g.unsqueeze(-2)
    return s @ y.transpose(-1, -2), y @ y.transpose(-1, -2), (s * gb).sum(-1), (y * gb).sum(-1)


def gram_chunks(n: int) -> Tuple[int, int]:
    """(blocks per client, column tiles per block) of the gram over N
    columns: an equal run of tiles a block, at most `_MAX_CHUNKS` blocks."""
    tiles = math.ceil(n / _TILE)
    per_block = math.ceil(tiles / _MAX_CHUNKS)
    return math.ceil(tiles / per_block), per_block


def _gram_scratch(device: torch.device, n_partial: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gram's partials (at least `n_partial` floats) and `k` zeroed
    ticket counters on `device`, grown as needed and kept between calls."""
    partial, ticket = _scratch.get(device, (None, None))
    if partial is None or partial.numel() < n_partial:
        partial = torch.empty(n_partial, dtype=torch.float32, device=device)
    if ticket is None or ticket.numel() < k:
        ticket = torch.zeros(k, dtype=torch.int32, device=device)
    _scratch[device] = (partial, ticket)
    return partial, ticket


def fused_gram_projections(s, y, g, count):
    """(S Yᵀ, Y Yᵀ, Sᵀg, Yᵀg) in one pass over the `[K, m, N]` history.

    s, y: `[K, m, N]` f32; g: `[K, N]` f32; count: `[K]` int32 — rows
    `>= count[k]` are ignored. Returns (sy `[K,m,m]`, yy `[K,m,m]`,
    p `[K,m]`, q `[K,m]`) in f32.
    """
    if _on_cpu(s, y, g, count):
        return fused_gram_projections_plain(s, y, g, count)
    k, m, n = _check_history(s, y, g, count)
    n_out = 2 * m * m + 2 * m
    chunks, tpb = gram_chunks(n)
    partial, ticket = _gram_scratch(s.device, k * chunks * n_out, k)
    out = torch.empty((k, n_out), dtype=torch.float32, device=s.device)
    rc = _kernels().compact_gram_launch(
        s.data_ptr(), y.data_ptr(), g.data_ptr(), count.data_ptr(),
        partial.data_ptr(), ticket.data_ptr(), out.data_ptr(), k, m, n, chunks, tpb, _vec_ok(n, s, y, g),
        torch.cuda.current_stream(s.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_gram_projections: CUDA launch failed (cudaError {rc})")
    LAUNCHES["fused_gram_projections"] += 1
    mm = m * m
    return (
        out[:, :mm].view(k, m, m),
        out[:, mm : 2 * mm].view(k, m, m),
        out[:, 2 * mm : 2 * mm + m],
        out[:, 2 * mm + m :],
    )


def fused_direction_assembly_plain(s, y, g, w, u, h_diag, count):
    """Plain PyTorch version of `fused_direction_assembly`."""
    s, y = _masked(s, y, count)
    h = h_diag[..., None]
    ws = torch.matmul(w.unsqueeze(-2), s).squeeze(-2)
    uy = torch.matmul(u.unsqueeze(-2), y).squeeze(-2)
    return h * g + ws - h * uy


def fused_direction_assembly(s, y, g, w, u, h_diag, count):
    """hg = γ·g + wᵀS − γ·(uᵀY) `[K, N]` in one pass over the history."""
    if _on_cpu(s, y, g, w, u, h_diag, count):
        return fused_direction_assembly_plain(s, y, g, w, u, h_diag, count)
    k, m, n = _check_history(s, y, g, count)
    _check("w", w, (k, m), torch.float32)
    _check("u", u, (k, m), torch.float32)
    _check("h_diag", h_diag, (k,), torch.float32)
    out = torch.empty((k, n), dtype=torch.float32, device=s.device)
    rc = _kernels().compact_assembly_launch(
        s.data_ptr(), y.data_ptr(), g.data_ptr(), w.data_ptr(), u.data_ptr(),
        h_diag.data_ptr(), count.data_ptr(), out.data_ptr(), k, m, n,
        _vec_ok(n, s, y, g, out), torch.cuda.current_stream(s.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_direction_assembly: CUDA launch failed (cudaError {rc})")
    LAUNCHES["fused_direction_assembly"] += 1
    return out


def compact_direction_cuda(g, s_hist, y_hist, count, h_diag):
    """-H·g via the compact representation, history traffic fused to 2 passes.

    Drop-in for `optim.compact.compact_direction` (same signature, same
    result up to reduction order): the `"pallas"` direction backend.
    """
    f32 = torch.float32
    g32 = g.to(f32).contiguous()
    s32 = s_hist.to(f32).contiguous()
    y32 = y_hist.to(f32).contiguous()
    cnt = count.to(torch.int32).contiguous()
    hd = h_diag.to(f32).contiguous()

    sy, yy, p, q = fused_gram_projections(s32, y32, g32, cnt)
    valid = history_valid(cnt, s32.shape[-2])
    u, w, _, _ = compact_solves(sy, p, q, valid, hd, lambda u: (_bdot(yy, u), None))
    hg = fused_direction_assembly(s32, y32, g32, w.contiguous(), u.contiguous(), hd, cnt)
    return (-hg).to(g.dtype)
