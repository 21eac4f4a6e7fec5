"""The launch plan of the head-dim-128 f32 flash forward, replayed.

`fwd128::flash_fwd_d128_tc<Causal, Split, Ring>` (`csrc/flash_attention.cu`)
is persistent: G = min(SMs, blocks) CTAs walk the blocks of 64 query rows,
a head's blocks side by side and heaviest first within the head, dealt
out in a snake (`Walk`). A producer warpgroup lands Q once a block by TMA
and rounds it in place; it reads K and V 32 keys a tile, two tiles ahead,
into its registers and stores each tile's split operands into a ring of
Ring stages. One consumer warpgroup multiplies, freeing each stage's K
after its scores and its Vᵀ after its P·V on `empty` mbarriers. Its
decisions are integer arithmetic on block, tile and stage indices,
written out here as the kernel writes them:

* the walk covers every (head, block) exactly once, a head's blocks in a
  row, heaviest first;
* each pair j <= i + shift is computed exactly once and no pair outside
  the mask is computed without the mask, at S in {256, 2048} and at the
  card's rectangular offsets (`chip_smoke.RECT_OFFSETS`: aligned, a query
  block ahead, a block wholly in the future, an unaligned shift of 64, a
  longer key side, q_off 37, and a shift of −32, whose blocks hold an odd
  count of tiles);
* the barriers' parities, replayed as mbarriers with the producer's and
  the consumer's programs in random interleavings and the TMA landing
  late, never let the producer overwrite a buffer that the consumer still
  reads, nor let a reader see a tile before it is whole, and never
  deadlock, with two stages (shipped) or one (`chip_sweep.py flash_f32`);
* each plan's bytes, laid out as the source lays out `Smem<Ring>`, equal
  the bytes its static_asserts state and fit 232,448 with the 1 KB the
  launch adds to align the slabs, and a third stage would not; the
  block's threads may all hold 255 registers.

The constants are read from the source. Runs in seconds on the CPU.
"""

import random
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

SOURCE = Path(fc.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
SRC = SOURCE.read_text()
NS = SRC[SRC.index("namespace fwd128 {"):SRC.index("}  // namespace fwd128")]
SMS = 132  # an H100 SXM's


def constexpr(name: str) -> int:
    m = re.search(rf"^constexpr int {name} = (\d+)( / \w+)?;", NS, re.M)
    assert m, f"{name} not found in fwd128"
    return int(m.group(1))


D = constexpr("kD")
KEYS = constexpr("kKeys")
ROWS = constexpr("kRows")
THREADS = constexpr("kThreads")
SLAB = constexpr("kSlab")
SMEM_LIMIT = constexpr("kSmemLimit")
REGISTERS = constexpr("kRegisters")
VT_ROWS = D + 8  # kVt: D rows of Vᵀ, then [1 | 0]
RINGS = (2, 1)  # operand stages: the shipped plan, and `plan` 1 of flash_fwd_d128_cut_launch
CASES = [(256, 256, 0, 0), (2048, 2048, 0, 0)] + [tuple(c) for c in
                                                   ((256, 256, 0, 0), (256, 256, 128, 0), (128, 128, 0, 128),
                                                    (256, 256, 0, 64), (128, 384, 256, 64), (128, 256, 37, 0),
                                                    (256, 256, 0, 32))]


def test_constants_are_the_wrappers():
    assert KEYS == fc.F32_FWD_KEYS[128]  # the one-pass plain version's tile
    assert D == 128 and SLAB * 4 == 128 and ROWS == 64 and THREADS == 256  # a swizzled row: 128 bytes
    assert re.search(r"template <bool Causal, bool Split, int Ring = 2, int Cut = kFull>\nint launch\(", NS)
    import chip_smoke

    assert tuple(CASES[2:]) == chip_smoke.RECT_OFFSETS


def align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


STAGE = 2 * KEYS * D * 4 + 2 * VT_ROWS * KEYS * 4  # K hi and lo, Vᵀ hi and lo


def smem_bytes(ring: int) -> int:
    """sizeof(Smem<Ring>) as the compiler lays it out: Q and its lo (1 KB
    aligned), the stages, then the mbarriers; the struct padded to its 1 KB
    alignment."""
    off = 0
    for size in (ROWS * D * 4, ROWS * D * 4, ring * STAGE):
        off = align(off, 1024) + size
    off += 8 * (3 + 4 * ring)
    return align(off, 1024)


@pytest.mark.parametrize("ring", RINGS)
def test_shared_memory_plan_fits_and_is_the_sources(ring):
    assert f"sizeof(Stage) == {STAGE}" in NS and STAGE % 1024 == 0  # every stage's slabs 1 KB aligned
    assert f"sizeof(Smem<{ring}>) == {smem_bytes(ring)}" in NS  # the source asserts the same bytes
    assert smem_bytes(ring) + 1024 <= SMEM_LIMIT == 232448
    assert THREADS * 255 <= REGISTERS == 65536  # every thread may hold 255: no setmaxnreg
    assert "static_assert(kThreads * 255 <= kRegisters" in NS


def test_a_third_stage_does_not_fit():
    assert smem_bytes(2) + 1024 == 202752  # 64 rows, two stages, barriers, alignment
    assert smem_bytes(2) + STAGE + 1024 > SMEM_LIMIT and smem_bytes(3) + 1024 > SMEM_LIMIT
    assert "static_assert(sizeof(Smem<2>) + sizeof(Stage) + 1024 > kSmemLimit" in NS


# ---------------------------------------------------------------------------
# The walk and the tiles
# ---------------------------------------------------------------------------


def walk(heads: int, blocks: int, grid: int):
    """{cta: [(n, bh, r)]}: `Walk::next` for every CTA of a grid of `grid`."""
    out = {}
    for c in range(grid):
        n, seq = 0, []
        while True:
            idx = n * grid + (c if n % 2 == 0 else grid - 1 - c)
            if idx >= heads * blocks:
                break
            seq.append((n, idx // blocks, idx % blocks))
            n += 1
        out[c] = seq
    return out


def row0_of(blocks: int, r: int, causal: bool) -> int:
    return (blocks - 1 - r if causal else r) * ROWS


def block_tiles(causal: bool, row0: int, shift: int, s_kv: int):
    """(n_tiles, n_open) of a block: its K/V tiles (keys [0, key_end)) and of
    them those no row masks."""
    kend = min(max(row0 + ROWS + shift, 0), s_kv) if causal else s_kv
    n_tiles = (kend + KEYS - 1) // KEYS
    n_open = min(n_tiles, max(row0 + shift + 1, 0) // KEYS) if causal else n_tiles
    return n_tiles, n_open


@pytest.mark.parametrize("shape", [(128, 2048, True), (3072, 256, False), (8, 2048, True), (5, 256, True)],
                         ids=["lm", "vit", "bh8", "bh5"])
def test_walk_covers_every_block_once_heaviest_first(shape):
    heads, s, causal = shape
    blocks = s // ROWS
    grid = min(SMS, heads * blocks)
    seqs = walk(heads, blocks, grid)
    done = Counter((bh, r) for seq in seqs.values() for _, bh, r in seq)
    assert len(done) == heads * blocks and set(done.values()) == {1}
    per_cta = [len(seq) for seq in seqs.values()]
    assert max(per_cta) - min(per_cta) <= 1
    # in the order of the walk's index a head's blocks lie in a row, heaviest first
    order = sorted(((n * grid + (c if n % 2 == 0 else grid - 1 - c)), bh, r)
                   for c, seq in seqs.items() for n, bh, r in seq)
    assert [bh for _, bh, _ in order] == sorted(bh for _, bh, _ in order)
    work = [block_tiles(causal, row0_of(blocks, r, causal), 0, s)[0] for _, _, r in order]
    for bh in range(heads):
        mine = work[bh * blocks:(bh + 1) * blocks]
        assert mine == sorted(mine, reverse=True)
    if heads == 128:  # the LM: every CTA's work within 5% of the mean
        load = [sum(block_tiles(causal, row0_of(blocks, r, causal), 0, s)[0] for _, _, r in seq)
                for seq in seqs.values()]
        assert max(load) <= 1.05 * sum(load) / len(load)


@pytest.mark.parametrize("case", CASES, ids=[f"{a}x{b}+{c}-{d}" for a, b, c, d in CASES])
def test_each_visible_pair_is_computed_once_and_masked_where_needed(case):
    s_q, s_kv, q_off, k_off = case
    shift = q_off - k_off
    i = np.arange(s_q)[:, None]
    j = np.arange(s_kv)[None, :]
    for causal in (True, False):
        visible = (j <= i + shift) if causal else np.ones((s_q, s_kv), bool)
        seen = np.zeros((s_q, s_kv), np.int32)
        for r in range(s_q // ROWS):
            row0 = row0_of(s_q // ROWS, r, causal)
            n_tiles, n_open = block_tiles(causal, row0, shift, s_kv)
            assert 0 <= n_open <= n_tiles and n_tiles * KEYS <= s_kv  # tiles past Skv are never read
            for it in range(n_tiles):
                tile = (slice(row0, row0 + ROWS), slice(it * KEYS, it * KEYS + KEYS))
                if it < n_open:
                    assert visible[tile].all()  # no pair outside the mask computed unmasked
                else:
                    assert not visible[tile].all()  # a masked tile holds a masked pair
                assert visible[tile].any()  # no tile read for nothing
                seen[tile] += visible[tile]
        assert (seen == visible).all()  # every visible pair once, no other


def test_the_lm_diagonal_masks_two_tiles_a_block():
    for r in range(2048 // ROWS):
        row0 = row0_of(32, r, True)
        n_tiles, n_open = block_tiles(True, row0, 0, 2048)
        assert n_tiles - n_open == 2 and n_tiles == row0 // KEYS + 2  # 64 rows cross two 32-key tiles


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


class Protocol:
    """The kernel's producer warpgroup (thread 0, which also lands Q, and
    the other 127) and its consumer warpgroup as generators over the blocks
    of one CTA; each yields a condition it waits for. Buffers carry the
    tile they hold and the writers still to finish it; reads and writes
    are checked. `ring` stages; `empty_waits` False drops the producer's
    waits for freed buffers."""

    def __init__(self, ring, blocks, causal, shift, s_kv, rng, empty_waits=True):
        self.ring, self.blocks, self.causal, self.shift, self.s_kv = ring, blocks, causal, shift, s_kv
        self.rng, self.empty_waits = rng, empty_waits
        self.q_land, self.q_ready, self.q_empty = Barrier(1), Barrier(128), Barrier(4)
        self.k_ready = [Barrier(128) for _ in range(ring)]
        self.k_empty = [Barrier(4) for _ in range(ring)]
        self.v_ready = [Barrier(128) for _ in range(ring)]
        self.v_empty = [Barrier(4) for _ in range(ring)]
        self.content = {}  # buffer -> (tile, writers still writing)
        self.readers = Counter()  # (buffer, tile) -> readers now
        self.copies = []  # TMA copies in flight: (buffer, tile, barrier, bytes)

    # buffers: ("q",), ("k", stage), ("vt", stage)
    def write(self, buf, tile, writers=("tma",)):
        others = [t for (b, t), n in self.readers.items() if b == buf and n]
        assert not others, f"{buf} overwritten with {tile} while read as {others}"
        if self.content.get(buf, (None,))[0] != tile:
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

    def land_one(self):
        buf, tile, bar, nbytes = self.copies.pop(self.rng.randrange(len(self.copies)))
        self.written(buf, tile)
        bar.complete_tx(nbytes)

    def blocks_with_tiles(self):
        """[(n, n_tiles)] of the CTA's blocks in the walk's order (one CTA: every block)."""
        return [(r, block_tiles(self.causal, row0_of(self.blocks, r, self.causal), self.shift, self.s_kv)[0])
                for r in range(self.blocks)]

    def producer(self, issuer: bool):
        """`issuer`: thread 0 (weight 1 of the 128 arrivals), else the other 127."""
        weight, me = (1, "issuer") if issuer else (127, "rest")
        gt = nq = 0
        for n, n_tiles in self.blocks_with_tiles():
            for it in range(n_tiles):
                tile = (n, it)
                if it == 0:  # a block's first tile: its Q first
                    if issuer:
                        if nq > 0 and self.empty_waits:
                            yield lambda nq=nq: self.q_empty.done((nq - 1) & 1)
                        self.q_land.expect(1)
                        self.write(("q",), n)
                        self.copies.append((("q",), n, self.q_land, 1))
                    yield lambda nq=nq: self.q_land.done(nq & 1)
                    self.read_begin(("q",), n)  # rounded in place
                    yield lambda: True
                    self.read_end(("q",), n)
                    self.q_ready.arrive(weight)
                    nq += 1
                # the loads of the tile two ahead are issued here, into registers (nothing shared)
                st = gt % self.ring
                for name, empty, ready in (("k", self.k_empty, self.k_ready), ("vt", self.v_empty, self.v_ready)):
                    if gt >= self.ring and self.empty_waits:
                        yield lambda empty=empty, st=st, gt=gt: empty[st].done((gt // self.ring - 1) & 1)
                    self.write((name, st), tile, ("issuer", "rest"))  # this thread's part of the stores
                    yield lambda: True
                    self.written((name, st), tile, me)
                    ready[st].arrive(weight)
                gt += 1

    def consumer(self):
        gt = nq = 0
        for n, n_tiles in self.blocks_with_tiles():
            if n_tiles == 0:
                continue
            yield lambda nq=nq: self.q_ready.done(nq & 1)
            self.read_begin(("q",), n)

            def ready(bars, it):
                st = (gt + it) % self.ring
                return lambda: bars[st].done(((gt + it) // self.ring) & 1)

            def scores(it):
                self.read_begin(("k", (gt + it) % self.ring), (n, it))

            def scores_done(it):
                self.read_end(("k", (gt + it) % self.ring), (n, it))
                self.k_empty[(gt + it) % self.ring].arrive(4)
                if it == n_tiles - 1:
                    self.read_end(("q",), n)
                    self.q_empty.arrive(4)

            def products(it):
                self.read_begin(("vt", (gt + it) % self.ring), (n, it))

            def products_done(it):
                self.read_end(("vt", (gt + it) % self.ring), (n, it))
                self.v_empty[(gt + it) % self.ring].arrive(4)

            yield ready(self.k_ready, 0)
            scores(0)
            yield lambda: True
            scores_done(0)
            for it in range(1, n_tiles):
                yield ready(self.k_ready, it)
                yield ready(self.v_ready, it - 1)
                scores(it)
                products(it - 1)
                yield lambda: True
                scores_done(it)
                yield lambda: True
                products_done(it - 1)
            yield ready(self.v_ready, n_tiles - 1)
            products(n_tiles - 1)
            yield lambda: True
            products_done(n_tiles - 1)
            gt += n_tiles
            nq += 1


def run_protocol(pr: Protocol, rng) -> int:
    agents = {"issuer": pr.producer(True), "rest": pr.producer(False), "consumer": pr.consumer()}
    waiting = {name: (lambda: True) for name in agents}
    steps = 0
    while agents:
        ready = [name for name in agents if waiting[name]()]
        if pr.copies and (not ready or rng.random() < 0.3):
            pr.land_one()
            continue
        assert ready, f"deadlock: every agent waits ({sorted(agents)})"
        name = rng.choice(ready)
        try:
            waiting[name] = next(agents[name])
        except StopIteration:
            del agents[name]
        steps += 1
    assert not pr.copies and not any(pr.readers.values())
    return steps


PROTOCOL_CASES = [(256, 256, 0, 0, True), (256, 256, 0, 0, False), (256, 256, 0, 64, True),
                  (128, 128, 0, 128, True), (128, 384, 256, 64, True), (256, 256, 37, 0, True),
                  (256, 256, 0, 32, True)]


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("case", PROTOCOL_CASES,
                         ids=["causal", "noncausal", "shift-64", "future", "long-kv", "q37", "shift-32"])
def test_barrier_parities_never_overwrite_a_stage_in_use(ring, case):
    s_q, s_kv, q_off, k_off, causal = case
    for seed in range(12):
        rng = random.Random(seed)
        assert run_protocol(Protocol(ring, s_q // ROWS, causal, q_off - k_off, s_kv, rng), rng) > 0


def test_odd_tile_counts_are_on_the_card():
    # a shift of −32 (k_off 32, the last of RECT_OFFSETS) gives every block an odd count of tiles
    assert {block_tiles(True, row0_of(4, r, True), -32, 256)[0] % 2 for r in range(4)} == {1}


@pytest.mark.parametrize("ring", RINGS)
def test_a_producer_without_the_empty_waits_is_caught(ring):
    # the replay sees a producer that refills a stage before the consumer frees it
    caught = 0
    for seed in range(20):
        rng = random.Random(seed)
        try:
            run_protocol(Protocol(ring, 4, False, 0, 256, rng, empty_waits=False), rng)
        except AssertionError:
            caught += 1
    assert caught > 0
