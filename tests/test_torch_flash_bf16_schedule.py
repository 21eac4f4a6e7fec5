"""The causal tile schedule of the bf16 trio's kernels, replayed.

`flash_fwd_bf16_tc<D, Keys>`, `flash_bwd_dq_bf16_tc<D, Keys>` and
`flash_bwd_dkv_bf16_tc<D>` (`csrc/flash_bf16.cu`) are persistent: G =
min(SMs, blocks) CTAs take the 128-row blocks of every head through
`Schedule`, heaviest first and dealt out in a snake. Their causal
decisions are integer arithmetic on CTA, block, tile and warpgroup
indices, written out here as the kernels write them: the block a CTA
takes (`Schedule::next`), its first row (`row0` for the forward and dq,
`key0` for dk/dv), the tiles the producer warpgroup loads (`n_tiles`), and
per consumer warpgroup the tiles it computes (the forward's and dq's
`n_live`, dk/dv's `first`), freeing the rest unread, and which of those it
masks by select. Replayed on the CPU for S in {128, 256, 2048} and two
heads, at every key tile the forward and dq have an instance of (64, 128)
and dk/dv's 64 queries, with one CTA, three and an SM's worth: every pair
j <= i of every head is computed exactly once, no pair j > i is computed
without its mask, a tile a warpgroup frees unread holds no pair it needs,
and blocks are handed out heaviest first. The key tiles by head dim are
read from the source: the forward's must be the plain version's
(`BF16_FWD_KEYS`), which rounds P tile by tile as the kernel does; dq's
plain version takes P from lse, so any tile is its arithmetic, and dq's
must be one of the tiles replayed here.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

ROWS = 128  # kRows: rows a block owns, two consumer warpgroups of 64
DKV_TILE = 64  # kDkvTile<D>
DKV_TILES = (64, 32)  # the query tiles the 128-key-block dk/dv schedule is replayed at: kDkvTile<D>, and 32
HEADS = 2
SMS = 132  # an H100 SXM's
SOURCE = Path(fc.__file__).resolve().parents[1] / "csrc" / "flash_bf16.cu"


def blocks(heads, rows, g):
    """[(cta, n, idx, bh, r)] of `Schedule::next` over G = g CTAs: CTA c's
    n-th block is item n·G + (c or G − 1 − c), head idx % heads, block row
    idx // heads (r = 0 the heaviest)."""
    out = []
    for c in range(g):
        n = 0
        while True:
            idx = n * g + (c if n % 2 == 0 else g - 1 - c)
            if idx >= heads * rows:
                break
            out.append((c, n, idx, idx % heads, idx // heads))
            n += 1
    return out


def fwd_schedule(s, t, g):
    """([(idx, bh, wrow0, kt, masked)] of every tile a consumer warpgroup
    computes; [(bh, wrow0, kt)] of every loaded tile it frees unread)."""
    rows = s // ROWS
    computed, freed = [], []
    for _, _, idx, bh, r in blocks(HEADS, rows, g):
        row0 = (rows - 1 - r) * ROWS
        n_tiles = (row0 + ROWS) // t  # the producer loads keys [0, row0 + 128)
        for wg in range(2):
            wrow0 = row0 + 64 * wg
            n_live = (wrow0 + 64 + t - 1) // t
            computed += [(idx, bh, wrow0, it * t, it * t + t - 1 > wrow0) for it in range(n_live)]
            freed += [(bh, wrow0, it * t) for it in range(n_live, n_tiles)]
    return computed, freed


def dq_schedule(s, t, g):
    """As `fwd_schedule` for dq, which walks the same tiles: T-key tiles
    against a warpgroup's 64 query rows, (idx, bh, wrow0, kt, masked); the
    one masked tile is the last live one, a compile-time branch taken where
    `it == n_live - 1`."""
    rows = s // ROWS
    computed, freed = [], []
    for _, _, idx, bh, r in blocks(HEADS, rows, g):
        row0 = (rows - 1 - r) * ROWS  # heaviest first
        n_tiles = (row0 + ROWS) // t  # the producer loads keys [0, row0 + 128)
        for wg in range(2):
            wrow0 = row0 + 64 * wg
            n_live = (wrow0 + 64 + t - 1) // t
            computed += [(idx, bh, wrow0, it * t, it == n_live - 1) for it in range(n_live)]
            freed += [(bh, wrow0, it * t) for it in range(n_live, n_tiles)]
    return computed, freed


def dkv_schedule(s, g, t=DKV_TILE):
    """As `fwd_schedule` for dk/dv: tiles of t queries against a warpgroup's
    64 keys, (idx, bh, wkey0, qt, masked); the masked tiles are the first
    64 queries a warpgroup sees, a compile-time branch taken where
    `it < first + 64 / T`."""
    rows = s // ROWS
    computed, freed = [], []
    for _, _, idx, bh, r in blocks(HEADS, rows, g):
        key0 = r * ROWS  # the first blocks see the most queries
        n_tiles = (s - key0) // t  # the producer loads queries [key0, S)
        for wg in range(2):
            wkey0 = key0 + 64 * wg
            first = 64 * wg // t
            freed += [(bh, wkey0, key0 + it * t) for it in range(first)]
            computed += [(idx, bh, wkey0, key0 + it * t, it < first + 64 // t) for it in range(first, n_tiles)]
    return computed, freed


def _covered(tiles, s, t, queries_are_rows):
    """How often each (head, query i, key j) is computed and kept; fails on
    a tile computed in full that holds a pair j > i."""
    count = np.zeros((HEADS, s, s), np.int32)
    for _, bh, r0, c0, masked in tiles:
        rows, cols = np.arange(r0, r0 + 64), np.arange(c0, c0 + t)
        q, k = (rows[:, None], cols[None, :]) if queries_are_rows else (cols[None, :], rows[:, None])
        keep = k <= q
        assert masked or keep.all(), f"tile ({r0}, {c0}) holds pairs j > i but is computed without its mask"
        block = count[bh, r0:r0 + 64, c0:c0 + t] if queries_are_rows else count[bh].T[r0:r0 + 64, c0:c0 + t]
        block += keep
    return count


def _none_needed(freed, t, queries_are_rows):
    for _, r0, c0 in freed:
        rows, cols = np.arange(r0, r0 + 64), np.arange(c0, c0 + t)
        q, k = (rows[:, None], cols[None, :]) if queries_are_rows else (cols[None, :], rows[:, None])
        assert not (k <= q).any(), f"tile ({r0}, {c0}) is freed unread but holds a pair j <= i"


def _heaviest_first(tiles, n_blocks):
    """Work by schedule item never grows, and a CTA takes its items in order."""
    work = np.bincount([idx for idx, *_ in tiles], minlength=n_blocks)
    assert (np.diff(work) <= 0).all(), work


def _ctas(s):
    n_blocks = HEADS * s // ROWS
    return sorted({1, 3, min(SMS, n_blocks)})


@pytest.mark.parametrize("s", [128, 256, 2048])
def test_schedule_deals_every_block_once_in_order(s):
    rows = s // ROWS
    for g in _ctas(s):
        dealt = blocks(HEADS, rows, g)
        assert sorted(idx for _, _, idx, _, _ in dealt) == list(range(HEADS * rows))
        for c in range(g):  # a CTA's items come in increasing order: heaviest first
            mine = [idx for cta, _, idx, _, _ in dealt if cta == c]
            assert mine == sorted(mine)


@pytest.mark.parametrize("s", [128, 256, 2048])
@pytest.mark.parametrize("t", [64, 128])  # the forward's key tiles
def test_fwd_schedule_computes_each_causal_pair_once(s, t):
    for g in _ctas(s):
        computed, freed = fwd_schedule(s, t, g)
        np.testing.assert_array_equal(_covered(computed, s, t, queries_are_rows=True),
                                      np.broadcast_to(np.tri(s, dtype=np.int32), (HEADS, s, s)))
        _none_needed(freed, t, queries_are_rows=True)
        _heaviest_first(computed, HEADS * s // ROWS)


@pytest.mark.parametrize("s", [128, 256, 2048])
@pytest.mark.parametrize("t", DKV_TILES)
def test_dkv_schedule_computes_each_causal_pair_once(s, t):
    for g in _ctas(s):
        computed, freed = dkv_schedule(s, g, t)
        np.testing.assert_array_equal(_covered(computed, s, t, queries_are_rows=False),
                                      np.broadcast_to(np.tri(s, dtype=np.int32), (HEADS, s, s)))
        _none_needed(freed, t, queries_are_rows=False)
        _heaviest_first(computed, HEADS * s // ROWS)


DQ_TILES = [64, 128]  # the key tiles dq has instances of (`DQ_CUTS` in csrc/flash_bf16.cu)


@pytest.mark.parametrize("s", [128, 256, 2048])
@pytest.mark.parametrize("t", DQ_TILES)
def test_dq_schedule_computes_each_causal_pair_once(s, t):
    for g in _ctas(s):
        computed, freed = dq_schedule(s, t, g)
        np.testing.assert_array_equal(_covered(computed, s, t, queries_are_rows=True),
                                      np.broadcast_to(np.tri(s, dtype=np.int32), (HEADS, s, s)))
        _none_needed(freed, t, queries_are_rows=True)
        _heaviest_first(computed, HEADS * s // ROWS)
        # each warpgroup's one masked tile holds its diagonal, and no tile before it does
        for _, _, wrow0, kt, masked in computed:
            assert masked == (kt <= wrow0 + 63 < kt + t)


@pytest.mark.parametrize("t", DQ_TILES)
def test_dq_masks_one_tile_a_warpgroup(t):
    s = 2048
    computed, freed = dq_schedule(s, t, SMS)
    assert sum(masked for *_, masked in computed) == HEADS * s // 64
    # a 128-key tile: the first warpgroup frees nothing, and computes the
    # 64 x 64 square wholly in its future (masked); a 64-key tile: it frees that square's tile
    wasted = s // 64 * (64 * 63 // 2) + (s // ROWS * 64 * 64 if t == 128 else 0)
    assert 64 * t * len(computed) == HEADS * (s * (s + 1) // 2 + wasted)
    assert len(freed) == (HEADS * s // ROWS if t == 64 else 0)


@pytest.mark.parametrize("t", [64, 128])
def test_only_the_diagonal_tiles_are_masked(t):
    # at S = 2048 each warpgroup of 64 rows masks the one tile across its
    # diagonal; the pairs computed beyond the triangle are that tile's part
    # past the diagonal: 64·63/2 for a 64-key tile, and for a 128-key tile
    # also the 64 x 64 square the first warpgroup sees wholly in its future
    s = 2048
    computed, _ = fwd_schedule(s, t, SMS)
    assert sum(masked for *_, masked in computed) == HEADS * s // 64
    wasted = s // 64 * (64 * 63 // 2) + (s // ROWS * 64 * 64 if t == 128 else 0)
    assert 64 * t * len(computed) == HEADS * (s * (s + 1) // 2 + wasted)
    for dkv_t in DKV_TILES:  # dk/dv masks 64 // T tiles a warpgroup
        computed, _ = dkv_schedule(s, SMS, dkv_t)
        assert sum(masked for *_, masked in computed) == HEADS * s // 64 * (64 // dkv_t)
        assert 64 * dkv_t * len(computed) == HEADS * (s * (s + 1) // 2 + s // 64 * (64 * 63 // 2))


def test_forward_key_tiles_are_the_plain_versions():
    src = SOURCE.read_text()
    default = re.search(r"template <int D>\s*constexpr int kFwdKeys = (\d+);", src)
    assert default, "kFwdKeys not found in csrc/flash_bf16.cu"
    keys = {d: int(default.group(1)) for d in fc.HEAD_DIMS}
    keys.update({int(d): int(k) for d, k in re.findall(r"constexpr int kFwdKeys<(\d+)> = (\d+);", src)})
    assert keys == fc.BF16_FWD_KEYS
    assert set(keys.values()) <= {64, 128}  # the widths replayed above


def test_dq_key_tiles_are_replayed():
    src = SOURCE.read_text()
    default = re.search(r"template <int D>\s*constexpr int kDqKeys = (\d+);", src)
    assert default, "kDqKeys not found in csrc/flash_bf16.cu"
    keys = {d: int(default.group(1)) for d in fc.HEAD_DIMS}
    keys.update({int(d): int(k) for d, k in re.findall(r"constexpr int kDqKeys<(\d+)> = (\d+);", src)})
    assert set(keys) == set(fc.HEAD_DIMS) == {16, 32, 64, 128}
    assert set(keys.values()) <= {64, 128}
    instances = {(int(d), int(k)) for d, k in re.findall(r"DQ_CUTS\((\d+), (\d+)\)", src)}
    assert {k for _, k in instances} == set(DQ_TILES)
    assert {(d, k) for d, k in keys.items()} <= instances  # the shipped tile is one the sweep times


def test_dkv_query_tiles_are_replayed():
    # kDkvTile<D>: 64 queries at every D (the D-128 dk/dv's own plan is
    # replayed in tests/test_torch_flash_bf16_d128_plan.py)
    src = SOURCE.read_text()
    m = re.search(r"template <int D>\s*constexpr int kDkvTile = (\d+);", src)
    assert m, "kDkvTile not found in csrc/flash_bf16.cu"
    assert int(m.group(1)) == DKV_TILE and DKV_TILE in DKV_TILES
