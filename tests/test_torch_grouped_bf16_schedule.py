"""The launch plan of the bf16 grouped GEMM kernel, replayed.

`grouped_gemm_bf16_tc<BM, BN, AKC, BKC, Ctas>` (`csrc/grouped_gemm_bf16.cu`)
is persistent: G' = min(SMs x Ctas, tiles) CTAs, a tile being one BM x BN
output tile of one group and one contraction chunk, the tiles in the
order (split, group, N tile, M tile), M fastest; CTA c takes tiles c,
c + G', c + 2G', … (`item_at`). Its decisions are integer arithmetic on
tile, stage and CTA indices, written out here as the kernel and
`ops/grouped_gemm.py` write them: the tile (`tiles`) and the split
(`split_k`) the wrapper picks, the tiles a CTA takes, the stages of 64
positions a chunk is read in, and the shared-memory plan (`Plan`: the ring
from the front, one output buffer a consumer warpgroup from the back, the
mbarriers). The plan's constants (tile sizes, CTAs an SM, ring depths, the
stage) are read from the source's constexprs and static_asserts.

Replayed on the CPU at the seven grouped GEMM shapes of the switch-MoE
ViT path and every role of both ragged shapes (`chip_smoke.GROUPED_TAILS`),
with 1, 3 and 132 CTAs: every (split, group, N tile, 64-row unit) is
computed and stored exactly once, the CTAs' tiles differ by one at most
and the tiles in flight lie side by side; the split chunks cover the
contraction in order, in whole stages, and the tiles times the chunks take
the SMs in one round; and the plan fits 232,448 bytes at the CTAs an SM
it claims, with a ring of two stages at least, staged or not.
"""

import math
import re
from collections import Counter
from pathlib import Path

import pytest
import torch

from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg

SOURCE = Path(gg.__file__).resolve().parents[1] / "csrc" / "grouped_gemm_bf16.cu"
SRC = SOURCE.read_text()
BF16 = torch.bfloat16
SMS = 132  # an H100 SXM's


def constexpr(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([0-9 *]+);", SRC)
    assert m, f"{name} not found in csrc/grouped_gemm_bf16.cu"
    return math.prod(int(x) for x in m.group(1).split("*"))


BK = constexpr("kBK")
MAX_RING = constexpr("kMaxRing")
CTAS = constexpr("kCtasPerSm")
SLAB = constexpr("kSlabBytes")
SMEM_BLOCK = constexpr("kSmemLimit")
SMEM_SM = constexpr("kSmemSm")
DATA = tuple(int(x) for x in re.search(r"kData = Ctas == 2 \? (\d+) : (\d+);", SRC).groups())  # (two CTAs, one)
TILES = ((128, 256), (128, 64), (64, 256), (256, 64))  # the instances `make_args` takes

# (label, G, M, K, N, A MN-major, B K-major) of the grouped GEMMs on the MoE
# ViT path (`chip_smoke.grouped_cases` at VIT_MOE_KWARGS: G = 3 clients x 8
# experts, 20,480 slots a group at the train batch, 20,000 at the eval one,
# D 64, H 256), as the autograd function hands them to the kernel
PATH = (
    ("fwd fc1", 24, 20480, 64, 256, False, False),
    ("fwd fc2", 24, 20480, 256, 64, False, False),
    ("eval fc1", 24, 20000, 64, 256, False, False),
    ("dlhs fc2", 24, 20480, 64, 256, False, True),
    ("dlhs fc1", 24, 20480, 256, 64, False, True),
    ("drhs fc1", 24, 64, 20480, 256, True, False),
    ("drhs fc2", 24, 256, 20480, 64, True, False),
)
TAILS = ((3, 13, 257, 9), (3, 300, 40, 270))  # chip_smoke.GROUPED_TAILS, (G, M, K, N)


def tail_cases():
    """Every role at both ragged shapes: the forward A·B, the input gradient
    dC·Bᵀ (Bᵀ K-major), the weight gradient Aᵀ·dC (Aᵀ MN-major)."""
    for g, m, k, n in TAILS:
        yield f"tail fwd {m}x{k}x{n}", g, m, k, n, False, False
        yield f"tail dlhs {m}x{k}x{n}", g, m, n, k, False, True
        yield f"tail drhs {m}x{k}x{n}", g, k, m, n, True, False


CASES = PATH + tuple(tail_cases())


def plan(bm: int, bn: int, ctas: int = 1) -> dict:
    """`Plan<BM, BN, Ctas>` as the source computes it: the ring beside one
    output buffer a consumer warpgroup (C staged) and without them."""
    wm = 64 if bm == 64 else bm // 2
    wn = bn // 2 if bm == 64 else bn
    data = DATA[0] if ctas == 2 else DATA[1]
    out = wm * wn * 2
    stage = (bm + bn) * BK * 2
    return {"wm": wm, "wn": wn, "out": out, "data": data, "stage": stage,
            "ring": min(MAX_RING, (data - 2 * out) // stage), "ring_unstaged": min(MAX_RING, data // stage),
            "bytes": data + 2 * MAX_RING * 8}


def launch_plan(g, m, k, n):
    """(tile, splits, chunk, tiles) of the wrapper's launch."""
    bm, bn = gg.tiles(m, n, BF16)
    splits, chunk = gg.split_k(g, m, n, k, BF16)
    return (bm, bn), splits, chunk, splits * g * math.ceil(n / bn) * math.ceil(m / bm)


def walk(g, m, k, n, grid):
    """[(cta, tile, split, group, N tile, first 64-row unit, units)] of every
    tile in the order the CTAs take them (`item_at`), G' = min(grid x Ctas,
    tiles): CTA c the tiles c, c + G', …"""
    (bm, bn), _, _, tiles = launch_plan(g, m, k, n)
    m_units, n_tiles, per, m_tiles = math.ceil(m / 64), math.ceil(n / bn), bm // 64, math.ceil(m / bm)
    ctas = min(grid * CTAS, tiles)
    out = []
    for c in range(ctas):
        for tile in range(c, tiles, ctas):
            mt, w = tile % m_tiles, tile // m_tiles
            nt, w = w % n_tiles, w // n_tiles
            out.append((c, tile, w // g, w % g, nt, mt * per, min(per, m_units - mt * per)))
    return out


def test_path_shapes_are_the_smoke_tests():
    import chip_smoke
    from federated_pytorch_test_tpu_torch.engine import get_preset

    cfg = get_preset("fedavg", model="vit", model_kwargs=chip_smoke.VIT_MOE_KWARGS)
    got = []
    for label, role, shapes in chip_smoke.grouped_cases(cfg):
        a, b = (torch.empty(sh, dtype=BF16, device="meta") for sh in shapes)
        lhs, rhs = chip_smoke.grouped_role(role)[3](a, b)
        got.append((label, *lhs.shape, rhs.shape[2], lhs.stride(1) == 1, rhs.stride(1) == 1))
    assert tuple(got) == PATH
    assert chip_smoke.GROUPED_TAILS == TAILS


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("grid", [1, 3, SMS])
def test_every_output_tile_is_computed_once(case, grid):
    _, g, m, k, n, _, _ = case
    (bm, bn), splits, _, tiles = launch_plan(g, m, k, n)
    assert (bm, bn) in TILES
    items = walk(g, m, k, n, grid)
    done = Counter((s, grp, nt, mu + i) for _, _, s, grp, nt, mu, n_u in items for i in range(n_u))
    assert len(done) == splits * g * math.ceil(n / bn) * math.ceil(m / 64)  # every 64-row unit of every tile
    assert set(done.values()) == {1}
    assert all(1 <= n_u <= bm // 64 for *_, n_u in items)
    per_cta = Counter(c for c, *_ in items)
    assert len(items) == tiles and max(per_cta.values()) - min(per_cta.values()) <= 1


@pytest.mark.parametrize("case", PATH, ids=[c[0] for c in PATH])
def test_the_tiles_in_flight_lie_side_by_side(case):
    # the r-th tiles of all CTAs are G' consecutive tiles, so the card reads
    # and writes one window of memory that moves along
    _, g, m, k, n, _, _ = case
    *_, tiles = launch_plan(g, m, k, n)
    by_cta = {}
    for c, tile, *_ in walk(g, m, k, n, SMS):
        by_cta.setdefault(c, []).append(tile)
    ctas = len(by_cta)
    for r in range(tiles // ctas):
        assert sorted(v[r] for v in by_cta.values()) == list(range(r * ctas, (r + 1) * ctas))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_chunks_cover_the_contraction_in_order(case):
    _, g, m, k, n, _, _ = case
    (bm, bn), splits, chunk, tiles = launch_plan(g, m, k, n)
    bounds = [(s * chunk, min(k, (s + 1) * chunk)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(hi == lo2 for (_, hi), (lo2, _) in zip(bounds, bounds[1:]))  # in order, no gap, no overlap
    assert all(hi > lo for lo, hi in bounds)
    if splits > 1:
        assert chunk % BK == 0  # every stage of 64 positions lies in one chunk: the TMA stops at none
        for lo, hi in bounds:
            stages = [(lo + BK * kk, min(hi, lo + BK * (kk + 1))) for kk in range(math.ceil((hi - lo) / BK))]
            assert stages[-1][1] == hi and all(b - a == BK for a, b in stages[:-1])
        assert tiles <= SMS  # the output tiles times the chunks take the card's SMs in one round


def test_only_the_path_weight_gradients_split_in_5():
    for label, g, m, k, n, _, _ in PATH:
        if label.startswith("drhs"):
            # one tile a group ([64, 256] at 64 x 256, [256, 64] at 256 x 64), 5 chunks: 120 tiles
            assert launch_plan(g, m, k, n) == (gg.tiles(m, n, BF16), 5, 4096, 120)
            assert gg.split_k(g, m, n, k) == (20, 1024)  # the f32 kernel's plan is unchanged
        else:
            assert launch_plan(g, m, k, n)[1] == 1


@pytest.mark.parametrize("tile", TILES)
def test_shared_memory_plan_fits_at_its_ctas_an_sm(tile):
    p = plan(*tile)
    assert p["wm"] * p["wn"] * 4 == tile[0] * tile[1] * 2  # two warpgroups own the tile
    assert p["wm"] % 64 == 0 and p["wn"] % 64 == 0 and p["wm"] * p["wn"] // 2 // 128 <= 128  # accumulators a thread
    assert p["bytes"] + 1024 <= SMEM_BLOCK  # 1 KB to align the swizzled slabs
    assert CTAS * (p["bytes"] + 2048) <= SMEM_SM  # and each block's 1 KB of reserve
    assert p["ring"] >= 2 and p["ring_unstaged"] >= p["ring"]
    # every slab 1 KB aligned: the ring's stages, the output buffers
    assert all(x % 1024 == 0 for x in (p["stage"], p["data"], p["out"]))
    assert p["out"] % SLAB == 0
    assert f"Plan<{tile[0]}, {tile[1]}>::kRing == {p['ring']}" in SRC  # the source asserts the same
    # and the sweep's two-CTA variant of (128, 64): both CTAs fit an SM
    p2 = plan(128, 64, 2)
    assert 2 * (p2["bytes"] + 2048) <= SMEM_SM and p2["ring"] >= 2
    assert f"Plan<128, 64, 2>::kRing == {p2['ring']}" in SRC


def test_setmaxnreg_budget_is_the_ctas_own():
    m = re.search(r"kProducerRegs = Ctas == 1 \? (\d+) : (\d+);", SRC)
    c = re.search(r"kConsumerRegs = Ctas == 1 \? (\d+) : (\d+);", SRC)
    threads = constexpr("kThreads")
    for ctas, prod, cons in ((1, int(m.group(1)), int(c.group(1))), (2, int(m.group(2)), int(c.group(2)))):
        launched = 65536 // (threads * ctas) // 8 * 8  # ptxas' registers a thread at the launch bound
        assert prod % 8 == 0 and cons % 8 == 0 and 24 <= prod <= launched <= cons <= 256
        # the consumers' increase is paid for by the producer's decrease within the CTA
        assert 128 * (launched - prod) >= 256 * (cons - launched)
