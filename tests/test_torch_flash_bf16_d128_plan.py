"""The launch plans of the head-dim-128 bf16 flash forward and dk/dv, replayed.

`flash_fwd_bf16_d128_tc<Plan>` and `flash_bwd_dkv_bf16_d128_tc<Ring>`
(`csrc/flash_bf16.cu`) are persistent: G = min(SMs, blocks) CTAs walk the
blocks of a launch head by head (`HeadWalk`: a head's blocks side by side,
the heaviest first, dealt out in a snake), so that the few heads in flight
keep their rows in L2. The forward's two consumer warpgroups own 64 rows of
a 128-query block each and take turns to issue their products (named
barriers 1 and 2); its producer thread lands K a 128-key tile ahead of V,
into rings of their own, and each block's qs into a ring of blocks
(`FwdDepth<Plan>`). A K stage is freed after both warpgroups' scores on it,
a V stage after their P·V, qs after the block's last scores. dk/dv splits
its consumers by role on blocks of 64 keys: consumer 0 takes K as its A
fragments, forms Sᵀ and Pᵀ and sums dv; consumer 1 takes V, forms dPᵀ and
dSᵀ from the Pᵀ that consumer 0 hands over through two slots on named
barriers (1–4), and sums dk; the producer lands each block's k and v once
both consumers hold the last block's, and each 64-query tile's qs, dO, lse
and delta into a ring of kDkv128Ring stages. Their decisions are integer
arithmetic on block, tile and stage indices, written out here as the
kernels write them:

* each plan's bytes, laid out as the source lays out `SmemFwd128<Plan>`,
  `SmemDq<128, 64>` and `SmemDkv128<Ring>`, equal the bytes its
  static_asserts state and fit 232,448 with the 1 KB the launch adds to
  align the slabs; dq's plan stays 197,632 bytes; a fifth dk/dv stage would
  not fit; the setmaxnreg split fits the registers the CTA is launched with;
* the walk covers every (head, block) once, heaviest first in a head, with
  few heads in flight and the CTAs' work even;
* each causal pair is computed exactly once at the new tiles and block
  widths, and masked only in the one tile a warpgroup's block crosses its
  diagonal;
* the mbarriers' and named barriers' parities, replayed with the producer
  thread and the consumer warpgroups in random interleavings and the TMA
  landing late, never let a copy overwrite a stage that a warpgroup still
  reads, nor let a warpgroup read a tile before it is whole, never let one
  side join a named barrier's phase twice, and never deadlock, at every
  plan and ring depth the sweep times; a producer without its waits for
  freed stages is caught, and so is a consumer 0 that writes a Pᵀ slot
  without waiting for consumer 1 to have read it.

The constants are read from the source. Runs in seconds on the CPU.
"""

import random
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

SOURCE = Path(fc.__file__).resolve().parents[1] / "csrc" / "flash_bf16.cu"
SRC = SOURCE.read_text()
SMS = 132  # an H100 SXM's
D = 128


def constexpr(name: str) -> int:
    m = re.search(rf"^constexpr int {name} = (\d+);", SRC, re.M)
    assert m, f"{name} not found in csrc/flash_bf16.cu"
    return int(m.group(1))


ROWS = constexpr("kRows")  # query rows of a forward block: two warpgroups of 64
THREADS = constexpr("kWsThreads")
CONSUMER_WARPS = constexpr("kConsumerWarps")
SMEM_LIMIT = constexpr("kSmemLimit")
DKV_KEYS = constexpr("kDkvKeys")
DKV_RING = constexpr("kDkv128Ring")
FWD_PLAN = constexpr("kFwd128Plan")
P_FULL, P_FREE = (int(x) for x in re.search(r"constexpr int kPFull = (\d+), kPFree = (\d+);", SRC).groups())
PRODUCER_REGS, CONSUMER_REGS = (int(x) for x in re.search(
    r"constexpr int kProducerRegs = (\d+), kConsumerRegs = (\d+);", SRC).groups())
FWD_KEYS = int(re.search(r"template <int D>\s*constexpr int kFwdKeys = (\d+);", SRC).group(1))
DKV_TILE = int(re.search(r"template <int D>\s*constexpr int kDkvTile = (\d+);", SRC).group(1))
DQ_KEYS = int(re.search(r"constexpr int kDqKeys<128> = (\d+);", SRC).group(1))
DQ_RING = int(re.search(r"constexpr int kRing = D == 128 \? (\d+) : \d+;", SRC).group(1))
# FwdDepth<Plan>: stages of K, of V, blocks of qs
DEPTHS = {int(p): tuple(int(x) for x in kvq) for p, *kvq in re.findall(
    r"struct FwdDepth<(\d+)> \{\s*static constexpr int k = (\d+), v = (\d+), q = (\d+);", SRC)}
DKV_RINGS = (4, 3)  # the rings of flash_bwd_dkv_bf16_d128_cut_launch (`DKV128_CUTS`)


def test_constants_are_the_entry_points():
    assert ROWS == 128 and FWD_KEYS == 128 == fc.BF16_FWD_KEYS[128] and DKV_TILE == 64 and DKV_KEYS == 64
    assert THREADS == 384 and CONSUMER_WARPS == 8 and SMEM_LIMIT == 232448
    assert (P_FULL, P_FREE) == (1, 3)  # slots 0 and 1: named barriers 1–4, clear of __syncthreads' 0
    assert sorted(DEPTHS) == [0, 1, 2] and FWD_PLAN in DEPTHS and DKV_RING == DKV_RINGS[0]
    assert "case 128: return launch_fwd128<kFwd128Plan>(" in SRC
    assert "case 128: return launch_dkv128<kDkv128Ring>(" in SRC
    assert "case 128: return launch_dq<128, kDqKeys<128>>(" in SRC  # dq at D 128 keeps its kernel
    assert 'static_assert(D <= 64, "D = 128 runs flash_fwd_bf16_d128_tc");' in SRC
    assert 'static_assert(D <= 64, "D = 128 runs flash_bwd_dkv_bf16_d128_tc");' in SRC
    assert "FWD128_CUTS(0) FWD128_CUTS(1) FWD128_CUTS(2)" in SRC
    assert f"DKV128_CUTS({DKV_RINGS[0]}) DKV128_CUTS({DKV_RINGS[1]})" in SRC
    import chip_smoke
    import chip_sweep

    # the build gate holds the new instances to HGMMA and no spill; the sweep times every plan
    assert {"flash_fwd_bf16_d128_tc", "flash_bwd_dkv_bf16_d128_tc"} <= set(chip_smoke.TC_KERNELS)
    assert len(chip_sweep.FWD128_PLANS) == len(DEPTHS) and chip_sweep.DKV128_RINGS == DKV_RINGS
    assert [f"k{k}v{v}q{q}" for k, v, q in (DEPTHS[p] for p in sorted(DEPTHS))] == list(chip_sweep.FWD128_PLANS)
    assert chip_sweep.BF16_CUTS[-1] == "no_loads" and "kNoLoads = 5" in SRC


# ---------------------------------------------------------------------------
# Shared memory and registers
# ---------------------------------------------------------------------------


def align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


TILE_BYTES = 128 * D * 2  # a 128-row bf16 tile of 128 columns: K, V or a block's qs


def fwd_bytes(plan: int) -> int:
    """sizeof(SmemFwd128<Plan>): the K, V and qs rings (each 1 KB aligned), then the mbarriers; padded to 1 KB."""
    k, v, q = DEPTHS[plan]
    return align((k + v + q) * TILE_BYTES + 8 * 2 * (k + v + q), 1024)


def dq_bytes() -> int:
    """sizeof(SmemDq<128, kDqKeys<128>>): kRing stages of a K and a V tile, qs and dO double-buffered, the mbarriers."""
    stage = 2 * DQ_KEYS * D * 2
    return align(DQ_RING * stage + 2 * 2 * ROWS * D * 2 + 8 * (2 * DQ_RING + 4), 1024)


def dkv_bytes(ring: int) -> int:
    """sizeof(SmemDkv128<Ring>): the stages (qs, dO, then lse and delta, each
    stage padded to 1 KB), k and v, the two Pᵀ slots (float4 [2][8][128]), the
    mbarriers; padded to 1 KB."""
    stage = align(2 * DKV_TILE * D * 2 + 2 * DKV_TILE * 4, 1024)
    off = ring * stage + 2 * DKV_KEYS * D * 2
    off += 2 * (DKV_TILE // 8) * 128 * 16
    off += 8 * (2 * ring + 2)
    return align(off, 1024)


@pytest.mark.parametrize("plan", [0, 1, 2])
def test_forward_plans_fit_and_are_the_sources(plan):
    assert f"sizeof(SmemFwd128<{plan}>) == {fwd_bytes(plan)}" in SRC  # the source asserts the same bytes
    assert fwd_bytes(plan) + 1024 <= SMEM_LIMIT
    k, v, q = DEPTHS[plan]
    assert k >= 2 and v >= 2 and q >= 1  # a copy can land under the products of the tile before


def test_the_shipped_forward_plan_spends_the_freed_memory():
    # plans 0 and 1 hold one 32 KB tile more than the parent's two K/V stages beside two qs blocks
    assert fwd_bytes(0) == fwd_bytes(1) == 230400 and fwd_bytes(2) == 197632
    assert fwd_bytes(0) + 1024 + TILE_BYTES > SMEM_LIMIT  # and no further tile fits


def test_dq_plan_is_unchanged():
    assert dq_bytes() == 197632 and f"sizeof(SmemDq<128, kDqKeys<128>>) == {dq_bytes()}" in SRC


@pytest.mark.parametrize("ring", DKV_RINGS)
def test_dkv_plans_fit_and_are_the_sources(ring):
    assert f"sizeof(SmemDkv128<{ring}>) == {dkv_bytes(ring)}" in SRC
    assert dkv_bytes(ring) + 1024 <= SMEM_LIMIT


def test_a_fifth_dkv_stage_does_not_fit():
    assert dkv_bytes(4) == 201728 and dkv_bytes(3) == 167936
    assert dkv_bytes(DKV_RING + 1) + 1024 > SMEM_LIMIT
    assert "static_assert(sizeof(SmemDkv128<kDkv128Ring + 1>) + 1024 > kSmemLimit" in SRC


def test_setmaxnreg_fits_the_registers_the_cta_is_launched_with():
    # __launch_bounds__(384, 1): 65,536 / 384 rounded down to a multiple of 8 a
    # thread; setmaxnreg moves registers within that pool, never beyond it
    launch_regs = 65536 // THREADS // 8 * 8
    assert launch_regs == 168
    assert 128 * (PRODUCER_REGS + 2 * CONSUMER_REGS) <= THREADS * launch_regs
    assert PRODUCER_REGS % 8 == 0 and CONSUMER_REGS % 8 == 0 and 24 <= PRODUCER_REGS < launch_regs < CONSUMER_REGS <= 256
    assert "static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= kWsThreads * kLaunchRegs" in SRC


# ---------------------------------------------------------------------------
# The walk and the tiles
# ---------------------------------------------------------------------------


def walk(heads: int, blocks: int, grid: int):
    """{cta: [(n, idx, bh, r)]}: `HeadWalk::next` for every CTA of a grid of `grid`."""
    out = {}
    for c in range(grid):
        n, seq = 0, []
        while True:
            idx = n * grid + (c if n % 2 == 0 else grid - 1 - c)
            if idx >= heads * blocks:
                break
            seq.append((n, idx, idx // blocks, idx % blocks))
            n += 1
        out[c] = seq
    return out


def fwd_work(r: int, blocks: int) -> int:
    """Tiles of the forward's block r: keys [0, row0 + 128), row0 = the last rows first."""
    row0 = (blocks - 1 - r) * ROWS
    return (row0 + ROWS) // FWD_KEYS


def dkv_work(r: int, s: int) -> int:
    """Tiles of dk/dv's block r: queries [key0, S), key0 = r·64."""
    return (s - r * DKV_KEYS) // DKV_TILE


@pytest.mark.parametrize("shape", [(128, 2048), (8, 2048), (8, 128), (5, 256)], ids=["lm", "bh8", "s128", "bh5"])
@pytest.mark.parametrize("kernel", ["fwd", "dkv"])
def test_walk_covers_every_block_once_heaviest_first(shape, kernel):
    heads, s = shape
    blocks = s // (ROWS if kernel == "fwd" else DKV_KEYS)
    grid = min(SMS, heads * blocks)
    seqs = walk(heads, blocks, grid)
    done = Counter((bh, r) for seq in seqs.values() for _, _, bh, r in seq)
    assert len(done) == heads * blocks and set(done.values()) == {1}
    work = (lambda r: fwd_work(r, blocks)) if kernel == "fwd" else (lambda r: dkv_work(r, s))
    order = sorted((idx, bh, r) for seq in seqs.values() for _, idx, bh, r in seq)
    assert [bh for _, bh, _ in order] == sorted(bh for _, bh, _ in order)  # a head's blocks side by side
    for bh in range(heads):
        mine = [work(r) for _, b, r in order if b == bh]
        assert mine == sorted(mine, reverse=True)  # heaviest first
    # the heads in flight: the n-th blocks of all CTAs span at most G / blocks + 2 heads
    for n in range(max(len(seq) for seq in seqs.values())):
        heads_now = {bh for seq in seqs.values() for m, _, bh, _ in seq if m == n}
        assert len(heads_now) <= grid // blocks + 2
    if heads == 128:  # the LM shape: no CTA's work more than 3.2% over the mean
        load = [sum(work(r) for *_, r in seq) for seq in seqs.values()]
        assert max(load) <= 1.032 * sum(load) / len(load)


def fwd_tiles(s: int, heads: int = 2):
    """[(bh, wrow0, kt, masked)] of every tile a forward consumer warpgroup computes."""
    blocks = s // ROWS
    tiles = []
    for seq in walk(heads, blocks, min(SMS, heads * blocks)).values():
        for _, _, bh, r in seq:
            row0 = (blocks - 1 - r) * ROWS
            n_tiles = fwd_work(r, blocks)
            for wg in range(2):
                tiles += [(bh, row0 + 64 * wg, it * FWD_KEYS, it == n_tiles - 1) for it in range(n_tiles)]
    return tiles


def dkv_tiles(s: int, heads: int = 2):
    """[(bh, key0, qt, masked)] of every tile dk/dv's consumers compute (both roles the same tile)."""
    blocks = s // DKV_KEYS
    tiles = []
    for seq in walk(heads, blocks, min(SMS, heads * blocks)).values():
        for _, _, bh, r in seq:
            key0 = r * DKV_KEYS
            tiles += [(bh, key0, key0 + it * DKV_TILE, it == 0) for it in range(dkv_work(r, s))]
    return tiles


@pytest.mark.parametrize("s", [128, 256, 2048])
def test_each_causal_pair_is_computed_once_and_masked_where_needed(s):
    heads = 2
    for kernel in ("fwd", "dkv"):
        count = np.zeros((heads, s, s), np.int32)  # [head, query, key]
        tiles = fwd_tiles(s, heads) if kernel == "fwd" else dkv_tiles(s, heads)
        for bh, r0, c0, masked in tiles:
            if kernel == "fwd":  # 64 query rows from r0, FWD_KEYS keys from c0
                q, k = np.arange(r0, r0 + 64)[:, None], np.arange(c0, c0 + FWD_KEYS)[None, :]
            else:  # 64 keys from r0, DKV_TILE queries from c0
                q, k = np.arange(c0, c0 + DKV_TILE)[None, :], np.arange(r0, r0 + DKV_KEYS)[:, None]
            keep = k <= q
            assert keep.any()  # no tile computed for nothing
            assert masked == (not keep.all())  # masked exactly where the tile holds a pair j > i
            count[bh][q, k] += keep
        np.testing.assert_array_equal(count, np.broadcast_to(np.tri(s, dtype=np.int32), (heads, s, s)))


def test_the_lm_shape_masks_one_tile_a_block_and_warpgroup():
    s = 2048
    fwd = fwd_tiles(s)
    assert sum(m for *_, m in fwd) == 2 * s // 64  # each warpgroup's last tile
    dkv = dkv_tiles(s)
    assert sum(m for *_, m in dkv) == 2 * s // DKV_KEYS  # each block's first tile
    # dk/dv's products: every pair once, and the diagonal tiles' upper halves
    assert DKV_KEYS * DKV_TILE * len(dkv) == 2 * (s * (s + 1) // 2 + s // 64 * (64 * 63 // 2))


# ---------------------------------------------------------------------------
# The barriers
# ---------------------------------------------------------------------------


class Barrier:
    """An mbarrier: `count` arrivals (and, for a TMA barrier, the bytes) complete a phase."""

    def __init__(self, count: int):
        self.count, self.pending, self.phase, self.tx = count, count, 0, 0

    def arrive(self, n: int = 1):
        self.pending -= n
        assert self.pending >= 0
        self._maybe_flip()

    def expect(self, tx: int):
        self.tx += tx
        self.arrive()

    def complete_tx(self, tx: int):
        self.tx -= tx
        self._maybe_flip()

    def _maybe_flip(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def done(self, parity: int) -> bool:  # try_wait.parity: the phase of this parity has completed
        return (self.phase & 1) != parity


class Named:
    """A named barrier between two parties (bar.arrive on one side, bar.sync
    on the other): a phase completes when both have joined it; a party that
    joins a phase twice is a fault."""

    def __init__(self):
        self.phase, self.joined = 0, set()

    def join(self, party):
        assert party not in self.joined, f"{party} joined a named barrier's phase twice"
        phase = self.phase
        self.joined.add(party)
        if len(self.joined) == 2:
            self.phase += 1
            self.joined.clear()
        return lambda: self.phase > phase


class Buffers:
    """Shared memory as the replay sees it: each buffer holds a tile and the
    writers still writing it; reads and writes are checked."""

    def __init__(self, rng):
        self.rng = rng
        self.content = {}  # buffer -> (tile, writers still writing)
        self.readers = Counter()  # (buffer, tile) -> readers now
        self.copies = []  # TMA copies in flight: (buffer, tile, barrier)

    def write(self, buf, tile, writers=("tma",)):
        others = [t for (b, t), n in self.readers.items() if b == buf and n]
        assert not others, f"{buf} overwritten with {tile} while read as {others}"
        self.content[buf] = (tile, set(writers))

    def written(self, buf, tile, writer="tma"):
        assert self.content[buf][0] == tile
        self.content[buf][1].discard(writer)

    def read_begin(self, buf, tile):
        held = self.content.get(buf)
        assert held is not None and held[0] == tile and not held[1], f"{buf} read as {tile}, holds {held}"
        self.readers[buf, tile] += 1

    def read_end(self, buf, tile):
        self.readers[buf, tile] -= 1

    def tma(self, buf, tile, bar):
        """One copy against barrier `bar` (bar_expect, then the box): lands later."""
        bar.expect(1)
        self.write(buf, tile)
        self.copies.append((buf, tile, bar))

    def land_one(self):
        buf, tile, bar = self.copies.pop(self.rng.randrange(len(self.copies)))
        self.written(buf, tile)
        bar.complete_tx(1)


def run_agents(bufs: Buffers, agents: dict, named=()) -> int:
    """Steps the agents (generators yielding the condition each waits for) in
    a random order, landing the TMA copies at random points; fails on a
    deadlock, and unless every named barrier's phases completed."""
    waiting = {name: (lambda: True) for name in agents}
    steps = 0
    while agents:
        ready = [name for name in agents if waiting[name]()]
        if bufs.copies and (not ready or bufs.rng.random() < 0.3):
            bufs.land_one()
            continue
        assert ready, f"deadlock: every agent waits ({sorted(agents)})"
        name = bufs.rng.choice(ready)
        try:
            waiting[name] = next(agents[name])
        except StopIteration:
            del agents[name]
        steps += 1
    assert not bufs.copies and not any(bufs.readers.values())
    assert all(not b.joined for b in named)
    return steps


def cta_blocks(heads: int, blocks: int, grid: int, cta: int):
    return [(bh, r) for _, _, bh, r in walk(heads, blocks, grid)[cta]]


class FwdProtocol:
    """The forward's producer thread and its two consumer warpgroups over the
    blocks of one CTA, FwdDepth `depth` = (K, V, qs stages). `empty_waits`
    False drops the producer's every wait for a freed stage. `loads_only`:
    the consumers of the kLoadsOnly cut, which only wait for and free each
    stage in the whole kernel's order, without turns; with `qs_last` they
    would free qs after the block's last V instead of its last K."""

    def __init__(self, depth, blocks, rng, empty_waits=True, loads_only=False, qs_last=False):
        self.depth, self.empty_waits, self.loads_only, self.qs_last = depth, empty_waits, loads_only, qs_last
        self.bufs = Buffers(rng)
        self.blocks = blocks  # [(bh, n_tiles)]
        k, v, q = depth
        self.full = {"k": [Barrier(1) for _ in range(k)], "v": [Barrier(1) for _ in range(v)],
                     "q": [Barrier(1) for _ in range(q)]}
        self.empty = {kind: [Barrier(CONSUMER_WARPS) for _ in bars] for kind, bars in self.full.items()}
        self.turn = [Named(), Named()]  # barrier 1 + w: warpgroup w waits, the other passes

    def stages(self, kind):
        return len(self.full[kind])

    def land(self, kind, x):
        st = self.stages(kind)
        if x >= st and self.empty_waits:
            yield lambda: self.empty[kind][x % st].done((x // st - 1) & 1)
        self.bufs.tma((kind, x % st), x, self.full[kind][x % st])

    def producer(self):
        g = 0
        for n, (_, n_tiles) in enumerate(self.blocks):
            yield from self.land("q", n)
            for _ in range(n_tiles):
                yield from self.land("k", g)
                if g > 0:
                    yield from self.land("v", g - 1)
                g += 1
        if g > 0:
            yield from self.land("v", g - 1)

    def consumer(self, wg):
        def wait_full(kind, x):
            st = self.stages(kind)
            return lambda: self.full[kind][x % st].done((x // st) & 1)

        def begin(kind, x):
            self.bufs.read_begin((kind, x % self.stages(kind)), x)

        def free(kind, x):
            self.bufs.read_end((kind, x % self.stages(kind)), x)
            self.empty[kind][x % self.stages(kind)].arrive(4)

        def turn_wait():
            yield self.turn[wg].join(wg)

        def turn_pass():
            self.turn[1 - wg].join(wg)

        def take(kind, x):
            yield wait_full(kind, x)
            begin(kind, x)
            free(kind, x)

        if self.loads_only:
            gt = 0
            for n, (_, n_tiles) in enumerate(self.blocks):
                yield wait_full("q", n)
                begin("q", n)
                for it in range(n_tiles):
                    yield from take("k", gt + it)
                    if it == n_tiles - 1 and not self.qs_last:
                        free("q", n)
                    if it > 0:
                        yield from take("v", gt + it - 1)
                yield from take("v", gt + n_tiles - 1)
                if self.qs_last:
                    free("q", n)
                gt += n_tiles
            return
        if wg == 1:
            turn_pass()
        gt = 0
        for n, (_, n_tiles) in enumerate(self.blocks):
            yield wait_full("q", n)
            begin("q", n)
            yield wait_full("k", gt)
            yield from turn_wait()
            begin("k", gt)  # scores(0) issued
            turn_pass()
            yield lambda: True  # wait_group 0
            free("k", gt)
            if n_tiles == 1:
                free("q", n)
            for it in range(1, n_tiles):
                yield wait_full("k", gt + it)
                yield wait_full("v", gt + it - 1)
                yield from turn_wait()
                begin("k", gt + it)
                begin("v", gt + it - 1)
                turn_pass()
                yield lambda: True  # wait_group 1: the scores
                free("k", gt + it)
                if it == n_tiles - 1:
                    free("q", n)
                yield lambda: True  # wait_group 0: P·V
                free("v", gt + it - 1)
            yield wait_full("v", gt + n_tiles - 1)
            yield from turn_wait()
            begin("v", gt + n_tiles - 1)
            turn_pass()
            yield lambda: True
            free("v", gt + n_tiles - 1)
            gt += n_tiles
        if wg == 0:  # warpgroup 1's last pass
            yield from turn_wait()

    def run(self):
        agents = {"producer": self.producer(), "wg0": self.consumer(0), "wg1": self.consumer(1)}
        return run_agents(self.bufs, agents, self.turn)


class DkvProtocol:
    """dk/dv's producer thread, consumer 0 (Sᵀ, Pᵀ, dv) and consumer 1 (dPᵀ,
    dSᵀ, dk) over the blocks of one CTA, `ring` qs/dO stages."""

    def __init__(self, ring, blocks, rng, empty_waits=True, slot_waits=True):
        self.ring, self.empty_waits, self.slot_waits = ring, empty_waits, slot_waits
        self.bufs = Buffers(rng)
        self.blocks = blocks  # [(bh, n_tiles)]
        self.full = [Barrier(1) for _ in range(ring)]
        self.empty = [Barrier(CONSUMER_WARPS) for _ in range(ring)]
        self.kv_full, self.kv_empty = Barrier(1), Barrier(CONSUMER_WARPS)
        self.p_full, self.p_free = [Named(), Named()], [Named(), Named()]

    def producer(self):
        gt = 0
        for n, (_, n_tiles) in enumerate(self.blocks):
            if n >= 1 and self.empty_waits:
                yield lambda n=n: self.kv_empty.done((n - 1) & 1)  # both consumers hold the last block's k and v
            self.kv_full.expect(2)
            for buf in (("k",), ("v",)):
                self.bufs.write(buf, n)
                self.bufs.copies.append((buf, n, self.kv_full))
            for _ in range(n_tiles):
                if gt >= self.ring and self.empty_waits:
                    yield lambda gt=gt: self.empty[gt % self.ring].done((gt // self.ring - 1) & 1)
                self.bufs.tma(("st", gt % self.ring), gt, self.full[gt % self.ring])
                gt += 1

    def consumer(self, role):
        own = ("k",) if role == 0 else ("v",)
        gt = 0
        for n, (_, n_tiles) in enumerate(self.blocks):
            yield lambda n=n: self.kv_full.done(n & 1)
            self.bufs.read_begin(own, n)  # take_a: the fragments into registers
            self.bufs.read_end(own, n)
            self.kv_empty.arrive(4)

            def full(x):
                return lambda: self.full[x % self.ring].done((x // self.ring) & 1)

            def issue(x):  # the tile's scores issued: its stage is read until its products are done
                self.bufs.read_begin(("st", x % self.ring), x)

            def done(x):  # the tile's products waited for
                self.bufs.read_end(("st", x % self.ring), x)
                self.empty[x % self.ring].arrive(4)

            def form(x):
                slot = x & 1
                if role == 0:
                    if x >= 2 and self.slot_waits:
                        yield self.p_free[slot].join(0)  # consumer 1 has read the slot's last Pᵀ
                    self.bufs.write(("p", slot), x, ("consumer0",))
                    self.bufs.written(("p", slot), x, "consumer0")
                    self.p_full[slot].join(0)
                else:
                    yield self.p_full[slot].join(1)
                    self.bufs.read_begin(("p", slot), x)
                    self.bufs.read_end(("p", slot), x)
                    self.p_free[slot].join(1)

            yield full(gt)
            issue(gt)
            yield lambda: True  # wait_group 0
            yield from form(gt)
            for it in range(1, n_tiles):
                yield full(gt + it)
                issue(gt + it)  # scores(it), then products(it − 1)
                yield lambda: True  # wait_group 1: the scores
                yield from form(gt + it)
                yield lambda: True  # wait_group 0: the products
                done(gt + it - 1)
            yield lambda: True  # the last products
            done(gt + n_tiles - 1)
            gt += n_tiles
        if role == 0 and self.slot_waits:  # consumer 1 freed the last two tiles' slots: match them
            for x in range(max(gt - 2, 0), gt):
                yield self.p_free[x & 1].join(0)

    def run(self):
        agents = {"producer": self.producer(), "consumer0": self.consumer(0), "consumer1": self.consumer(1)}
        return run_agents(self.bufs, agents, (*self.p_full, *self.p_free))


# (heads, S, grid, cta): a CTA's blocks — the LM walk's first CTA (its
# heaviest and lightest blocks), a CTA holding one block, one of many blocks
WALK_CASES = [(2, 512, 3, 0), (2, 512, 3, 2), (1, 256, 1, 0), (1, 128, 1, 0)]


def fwd_blocks(heads, s, grid, cta):
    blocks = s // ROWS
    return [(bh, fwd_work(r, blocks)) for bh, r in cta_blocks(heads, blocks, min(grid, heads * blocks), cta)]


def dkv_blocks(heads, s, grid, cta):
    blocks = s // DKV_KEYS
    return [(bh, dkv_work(r, s)) for bh, r in cta_blocks(heads, blocks, min(grid, heads * blocks), cta)]


@pytest.mark.parametrize("plan", sorted(DEPTHS))
@pytest.mark.parametrize("case", WALK_CASES, ids=["many", "many-last", "one-head", "one-block"])
def test_forward_barriers_never_overwrite_a_stage_in_use(plan, case):
    blocks = fwd_blocks(*case)
    assert blocks
    for seed in range(8):
        assert FwdProtocol(DEPTHS[plan], blocks, random.Random(seed)).run() > 0


@pytest.mark.parametrize("plan", sorted(DEPTHS))
def test_the_loads_only_cut_frees_qs_where_the_kernel_does(plan):
    # chip_sweep.py's producer-alone cut waits for and frees every stage in
    # the whole kernel's order; freeing qs after the block's last V instead
    # deadlocks a plan of one qs buffer (the producer lands that V only after
    # the next block's qs)
    blocks = fwd_blocks(2, 512, 3, 0)
    for seed in range(8):
        assert FwdProtocol(DEPTHS[plan], blocks, random.Random(seed), loads_only=True).run() > 0
    if DEPTHS[plan][2] == 1:
        with pytest.raises(AssertionError, match="deadlock"):
            FwdProtocol(DEPTHS[plan], blocks, random.Random(0), loads_only=True, qs_last=True).run()


@pytest.mark.parametrize("ring", DKV_RINGS)
@pytest.mark.parametrize("case", WALK_CASES, ids=["many", "many-last", "one-head", "one-block"])
def test_dkv_barriers_never_overwrite_a_stage_in_use(ring, case):
    blocks = dkv_blocks(*case)
    assert blocks
    for seed in range(8):
        assert DkvProtocol(ring, blocks, random.Random(seed)).run() > 0


@pytest.mark.parametrize("kernel", ["fwd", "dkv"])
def test_a_producer_without_the_empty_waits_is_caught(kernel):
    # the replay sees a stage refilled (K, V, qs; or qs/dO, k and v) before its readers free it
    caught = 0
    for seed in range(20):
        rng = random.Random(seed)
        try:
            if kernel == "fwd":
                FwdProtocol(DEPTHS[FWD_PLAN], fwd_blocks(2, 512, 3, 0), rng, empty_waits=False).run()
            else:
                DkvProtocol(DKV_RING, dkv_blocks(2, 512, 3, 0), rng, empty_waits=False).run()
        except AssertionError:
            caught += 1
    assert caught > 0


def test_a_consumer_0_without_its_slot_waits_is_caught():
    # consumer 0 may write tile x's Pᵀ into slot x % 2 only after consumer 1
    # has read tile x − 2's there: without the wait, it runs two tiles ahead
    # and joins the slot's `full` barrier twice, or consumer 1 reads the wrong Pᵀ
    caught = 0
    for seed in range(20):
        try:
            DkvProtocol(DKV_RING, dkv_blocks(2, 512, 3, 0), random.Random(seed), slot_waits=False).run()
        except AssertionError:
            caught += 1
    assert caught > 0
