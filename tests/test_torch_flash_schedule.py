"""The causal tile schedule of the tensor-core backward kernels, replayed.

The aligned causal backward (`flash_bwd_dq_launch`, `flash_bwd_dkv_launch`)
runs `flash_bwd_dq_tc<D, true>` and `flash_bwd_dkv_tc<D, true>` at Sq = Skv
and shift 0. Their causal decisions are integer arithmetic on block, tile
and warpgroup indices, written out here as the kernels write them
(`csrc/flash_attention.cu`): the block order (`row0` heaviest first for
dq, `key0` for dk/dv), dq's `key_end`, dk/dv's first query tile `qt0`, and
per warpgroup and tile whether it is skipped, masked by select, or computed
in full. Replayed on the CPU for S in {128, 256, 2048} under both block
plans (`Plan<D>`): 128 rows a block as two warpgroups, with dq's tiles of
64 keys (32 at D = 64) and dk/dv's 32 queries; and at D = 128 64 rows a
block, with 16-key and 16-query tiles (dq in `dq128::flash_bwd_dq_d128_tc`
and dk/dv in `bwd128::flash_bwd_dkv_d128_tc`, whose persistent walks take
the blocks in the order of `blockIdx.x` here, their walks, masks and
barriers replayed in `test_torch_flash_bwd_dq_d128_plan.py` and
`test_torch_flash_bwd_dkv_d128_plan.py`). Every pair j <= i is computed
exactly once, no pair j > i is computed without its mask, and blocks
launch in order of non-increasing work.
"""

import numpy as np
import pytest

ROWS = 128  # rows a block owns, two warpgroups of 64 (Plan<D>::kRows up to D = 64)
DKV_TILE = 32  # queries a dk/dv tile up to D = 64 (Plan<D>::kDkvTile)
D128 = (64, 16)  # (rows a block; keys or queries a backward tile) at D = 128


def key_end(row0, shift, s_kv, rows=ROWS):
    """The kernels' `key_end`."""
    return min(max(row0 + rows + shift, 0), s_kv)


def dq_schedule(s, t, shift=0, rows=ROWS):
    """[(blockIdx.x, wrow0, kt, masked)] of every tile a warpgroup of
    `flash_bwd_dq_tc<D, true>` computes, in launch order."""
    grid = s // rows
    out = []
    for bx in range(grid):
        row0 = (grid - 1 - bx) * rows  # causal: heaviest first
        kend = key_end(row0, shift, s, rows)
        for it in range((kend + t - 1) // t):
            kt = it * t
            for wg in range(rows // 64):
                wrow0 = row0 + 64 * wg
                if kt > wrow0 + 63 + shift:  # wholly in this warpgroup's future
                    continue
                out.append((bx, wrow0, kt, kt + t - 1 > wrow0 + shift))
    return out


def dkv_schedule(s, t=DKV_TILE, shift=0, rows=ROWS):
    """[(blockIdx.x, wkey0, qt, masked)] of every tile a warpgroup of
    `flash_bwd_dkv_tc<D, true>` computes, in launch order."""
    out = []
    for bx in range(s // rows):
        key0 = bx * rows  # causal: the first blocks see the most queries
        qt0 = min(max(key0 - shift, 0), s) // t * t
        for it in range((s - qt0) // t):
            qt = qt0 + it * t
            for wg in range(rows // 64):
                wkey0 = key0 + 64 * wg
                if qt + t - 1 < wkey0 - shift:  # every query of the tile precedes these keys
                    continue
                out.append((bx, wkey0, qt, wkey0 + 63 > qt + shift))
    return out


def _covered(tiles, s, t, queries_are_rows):
    """How often each (query i, key j) pair is computed and kept; fails on a
    tile computed in full that holds a pair j > i."""
    count = np.zeros((s, s), np.int32)
    for _, r0, c0, masked in tiles:
        rows, cols = np.arange(r0, r0 + 64), np.arange(c0, c0 + t)
        q, k = (rows[:, None], cols[None, :]) if queries_are_rows else (cols[None, :], rows[:, None])
        keep = k <= q
        assert masked or keep.all(), f"tile ({r0}, {c0}) holds pairs j > i but is computed without its mask"
        block = count[r0:r0 + 64, c0:c0 + t] if queries_are_rows else count.T[r0:r0 + 64, c0:c0 + t]
        block += keep
    return count


def _heaviest_first(tiles, grid):
    work = np.bincount([bx for bx, *_ in tiles], minlength=grid)
    assert (np.diff(work) <= 0).all(), work


@pytest.mark.parametrize("s", [128, 256, 2048])
@pytest.mark.parametrize("t,rows", [(64, ROWS), (32, ROWS), D128[::-1]])  # 64 keys, 32 at D = 64, 16 at D = 128
def test_dq_schedule_computes_each_causal_pair_once(s, t, rows):
    tiles = dq_schedule(s, t, rows=rows)
    np.testing.assert_array_equal(_covered(tiles, s, t, queries_are_rows=True), np.tri(s, dtype=np.int32))
    _heaviest_first(tiles, s // rows)


@pytest.mark.parametrize("s", [128, 256, 2048])
@pytest.mark.parametrize("t,rows", [(DKV_TILE, ROWS), D128[::-1]])
def test_dkv_schedule_computes_each_causal_pair_once(s, t, rows):
    tiles = dkv_schedule(s, t, rows=rows)
    np.testing.assert_array_equal(_covered(tiles, s, t, queries_are_rows=False),
                                  np.tri(s, dtype=np.int32))
    _heaviest_first(tiles, s // rows)


def test_only_the_diagonal_tiles_are_masked_or_wasted():
    # at S = 2048 a warpgroup of 64 rows crosses the diagonal in one 64-key
    # tile of dq, two 32-key (32-query) tiles or four 16-key (16-query)
    # ones (D = 128); the rest of the triangle is computed without a
    # compare, and the pairs computed beyond it are the upper half of each
    # warpgroup's 64 x 64 diagonal square
    s = 2048
    rows, t128 = D128
    for tiles, t in ((dq_schedule(s, 64), 64), (dq_schedule(s, 32), 32), (dkv_schedule(s), DKV_TILE),
                     (dq_schedule(s, t128, rows=rows), t128), (dkv_schedule(s, t128, rows=rows), t128)):
        assert sum(masked for *_, masked in tiles) == 64 // t * s // 64
        assert 64 * t * len(tiles) == s * (s + 1) // 2 + s // 64 * (64 * 63 // 2)


def test_the_d128_plans_are_the_sources():
    # dq's 64 query rows and 16-key tiles in dq128; dk/dv's 64 key rows and 16-query tiles in bwd128
    import re
    from pathlib import Path

    from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

    src = (Path(fc.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu").read_text()
    for name in ("dq128", "bwd128"):
        ns = src[src.index(f"namespace {name} {{"):src.index(f"}}  // namespace {name}")]
        assert re.search(r"^constexpr int kRows = 64;", ns, re.M) and re.search(r"^constexpr int kTile = 16;", ns, re.M)
    assert D128 == (64, 16)
