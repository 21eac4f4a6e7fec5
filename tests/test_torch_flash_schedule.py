"""The causal tile schedule of the tensor-core backward kernels, replayed.

The aligned causal backward (`flash_bwd_dq_launch`, `flash_bwd_dkv_launch`)
runs `flash_bwd_dq_tc<D, true>` and `flash_bwd_dkv_tc<D, true>` at Sq = Skv
and shift 0. Their causal decisions are integer arithmetic on block, tile
and warpgroup indices, written out here as the kernels write them
(`csrc/flash_attention.cu`): the block order (`row0` heaviest first for
dq, `key0` for dk/dv), dq's `key_end`, dk/dv's first query tile `qt0`, and
per warpgroup and tile whether it is skipped, masked by select, or computed
in full. Replayed on the CPU for S in {128, 256, 2048} at dq's two tile
widths (64 keys; 32 at D = 64) and dk/dv's 32 queries: every pair j <= i is
computed exactly once, no pair j > i is computed without its mask, and
blocks launch in order of non-increasing work.
"""

import numpy as np
import pytest

ROWS = 128  # kRows: rows a block owns, two warpgroups of 64
DKV_TILE = 32  # kDkvTile


def key_end(row0, shift, s_kv):
    """The kernels' `key_end`."""
    return min(max(row0 + ROWS + shift, 0), s_kv)


def dq_schedule(s, t, shift=0):
    """[(blockIdx.x, wrow0, kt, masked)] of every tile a warpgroup of
    `flash_bwd_dq_tc<D, true>` computes, in launch order."""
    grid = s // ROWS
    out = []
    for bx in range(grid):
        row0 = (grid - 1 - bx) * ROWS  # causal: heaviest first
        kend = key_end(row0, shift, s)
        for it in range((kend + t - 1) // t):
            kt = it * t
            for wg in range(2):
                wrow0 = row0 + 64 * wg
                if kt > wrow0 + 63 + shift:  # wholly in this warpgroup's future
                    continue
                out.append((bx, wrow0, kt, kt + t - 1 > wrow0 + shift))
    return out


def dkv_schedule(s, t=DKV_TILE, shift=0):
    """[(blockIdx.x, wkey0, qt, masked)] of every tile a warpgroup of
    `flash_bwd_dkv_tc<D, true>` computes, in launch order."""
    out = []
    for bx in range(s // ROWS):
        key0 = bx * ROWS  # causal: the first blocks see the most queries
        qt0 = min(max(key0 - shift, 0), s) // t * t
        for it in range((s - qt0) // t):
            qt = qt0 + it * t
            for wg in range(2):
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
@pytest.mark.parametrize("t", [64, 32])  # dq's tile: 64 keys, 32 at D = 64
def test_dq_schedule_computes_each_causal_pair_once(s, t):
    tiles = dq_schedule(s, t)
    np.testing.assert_array_equal(_covered(tiles, s, t, queries_are_rows=True), np.tri(s, dtype=np.int32))
    _heaviest_first(tiles, s // ROWS)


@pytest.mark.parametrize("s", [128, 256, 2048])
def test_dkv_schedule_computes_each_causal_pair_once(s):
    tiles = dkv_schedule(s)
    np.testing.assert_array_equal(_covered(tiles, s, DKV_TILE, queries_are_rows=False),
                                  np.tri(s, dtype=np.int32))
    _heaviest_first(tiles, s // ROWS)


def test_only_the_diagonal_tiles_are_masked_or_wasted():
    # at S = 2048 a warpgroup of 64 rows crosses the diagonal in one 64-key
    # tile of dq, or two 32-key (32-query) tiles; the rest of the triangle
    # is computed without a compare, and the pairs computed beyond it are the
    # upper half of each warpgroup's 64 x 64 diagonal square
    s = 2048
    for tiles, t in ((dq_schedule(s, 64), 64), (dq_schedule(s, 32), 32), (dkv_schedule(s), DKV_TILE)):
        assert sum(masked for *_, masked in tiles) == 64 // t * s // 64
        assert 64 * t * len(tiles) == s * (s + 1) // 2 + s // 64 * (64 * 63 // 2)
