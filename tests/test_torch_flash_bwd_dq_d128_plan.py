"""The launch plan of the head-dim-128 f32 flash dq, replayed.

`dq128::flash_bwd_dq_d128_tc<Causal, Split, Ring>` (`csrc/flash_attention.cu`)
is persistent: G = min(SMs, blocks) CTAs walk the blocks of 64 query rows,
a head's blocks side by side and the heaviest (causal: the last rows)
first, dealt out in a snake (`fwd128::Walk`). Two consumer warpgroups split
the work by role: consumer 0 forms S and P, consumer 1 forms dP and dS and
sums dq, taking each tile's P from consumer 0 through two slots of shared
memory on named barriers. A producer warpgroup lands each block's Q and dO
and each 16-key tile's K and V by TMA (the tiles into a ring of two) and
stores a tile's score operands into a ring of two stages; consumer 0
copies the tile's K from there into Kᵀ in a ring of Ring stages while its
scores run. Their decisions are integer arithmetic on block, tile and
stage indices, written out here as the kernel writes them:

* the walk covers every (head, query block) exactly once, a head's blocks
  in a row, heaviest first;
* each pair j <= i + shift is computed exactly once, no pair outside the
  mask is computed without the mask, and no tile is read for nothing, at S
  in {256, 2048} and at the card's rectangular offsets
  (`chip_smoke.RECT_OFFSETS`, whose q_off 0, k_off 128 case leaves every
  block without a tile);
* the mbarriers' and named barriers' parities, replayed with the
  producer's thread 0, its other 127 threads and the two consumers in
  random interleavings and the TMA landing late, never let a writer
  overwrite a buffer that a reader still reads, nor let a reader see a tile
  before it is whole, never let one side join a named barrier's phase
  twice, and never deadlock, with two transposes stages (shipped) or three
  (`chip_sweep.py flash_f32`), and catch one transposes stage (consumer 0
  would wait for a product that waits for its P) and a protocol without its
  waits for freed stages;
* each plan's bytes, laid out as the source lays out `Smem<Ring>`, equal
  the bytes its static_asserts state and fit 232,448 with the 1 KB the
  launch adds to align the slabs, a third score stage would not, and the
  setmaxnreg split fits the registers the CTA is launched with.

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
NS = SRC[SRC.index("namespace dq128 {"):SRC.index("}  // namespace dq128")]
SMS = 132  # an H100 SXM's


def constexpr(name: str) -> int:
    m = re.search(rf"^constexpr int {name} = (\d+);", NS, re.M)
    assert m, f"{name} not found in dq128"
    return int(m.group(1))


D = constexpr("kD")
ROWS = constexpr("kRows")
TILE = constexpr("kTile")
THREADS = constexpr("kThreads")
SLAB = constexpr("kSlab")
SCORE_STAGES = constexpr("kScoreStages")
RAW_STAGES = constexpr("kRawStages")
SMEM_LIMIT = constexpr("kSmemLimit")
REGISTERS = constexpr("kRegisters")
LAUNCH_REGS = constexpr("kLaunchRegs")
PRODUCER_REGS, CONSUMER_REGS = (int(x) for x in re.search(
    r"constexpr int kProducerRegs = (\d+), kConsumerRegs = (\d+);", NS).groups())
RINGS = (2, 3)  # transposes stages: the shipped plan, and `plan` 1 of flash_bwd_dq_d128_cut_launch
CASES = [(256, 256, 0, 0), (2048, 2048, 0, 0)] + [tuple(c) for c in
                                                   ((256, 256, 0, 0), (256, 256, 128, 0), (128, 128, 0, 128),
                                                    (256, 256, 0, 64), (128, 384, 256, 64), (128, 256, 37, 0),
                                                    (256, 256, 0, 32))]


def test_constants_are_the_wrappers():
    assert D == 128 and SLAB * 4 == 128 and ROWS == 64 and TILE == 16 and THREADS == 384
    assert SCORE_STAGES == 2 and RAW_STAGES == 2
    assert re.search(r"template <bool Causal, bool Split, int Ring = 2, int Cut = kFull>\nint launch\(", NS)
    # the D-128 cases of both entry points reach this kernel, the others the D <= 64 one
    for case, causal, split in ((12, "false", "false"), (13, "false", "true"), (14, "true", "false"),
                                (15, "true", "true")):
        assert f"case {case}: return dq128::launch<{causal}, {split}>(" in SRC
    assert "KERNEL_CASES_64(bwd_dq_d," in SRC and "KERNEL_CASES(" not in SRC
    assert 'static_assert(D <= 64, "D = 128 runs dq128::flash_bwd_dq_d128_tc");' in SRC
    assert "SmemDq<128>" not in SRC
    import chip_smoke

    assert tuple(CASES[2:]) == chip_smoke.RECT_OFFSETS
    assert "flash_bwd_dq_d128_tc" in chip_smoke.TC_KERNELS  # the build gate holds it to HGMMA and no spill
    assert 128 in fc.HEAD_DIMS


# ---------------------------------------------------------------------------
# Shared memory and registers
# ---------------------------------------------------------------------------


def align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


SCORES = 4 * TILE * D * 4  # K's and V's hi and lo
RAW = 2 * TILE * D * 4  # K and V as landed
TRANSPOSES = 2 * D * TILE * 4  # Kᵀ's hi and lo


def smem_bytes(ring: int, score_stages: int = SCORE_STAGES) -> int:
    """sizeof(Smem<Ring>) as the compiler lays it out: Q's and dO's rows, the
    score stages and the raw stages (each 1 KB aligned), the transposes, P's
    two slots, then the mbarriers; the struct padded to its 1 KB
    alignment."""
    off = 0
    for size in (ROWS * D * 4, ROWS * D * 4, score_stages * SCORES, RAW_STAGES * RAW):
        off = align(off, 1024) + size
    off += ring * TRANSPOSES + 2 * 2 * 128 * 16
    off += 8 * (2 + RAW_STAGES + 2 * score_stages + 2 * ring)
    return align(off, 1024)


@pytest.mark.parametrize("ring", RINGS)
def test_shared_memory_plan_fits_and_is_the_sources(ring):
    assert f"sizeof(Scores) == {SCORES}" in NS and SCORES % 1024 == 0 and RAW % 1024 == 0
    assert f"sizeof(Smem<{ring}>) == {smem_bytes(ring)}" in NS  # the source asserts the same bytes
    assert smem_bytes(ring) + 1024 <= SMEM_LIMIT == 232448


def test_two_transposes_stages_fit_and_a_third_score_stage_does_not():
    # the dk/dv's transposes (Qᵀ and dOᵀ) are twice dq's (Kᵀ): there a second stage did not fit
    assert TRANSPOSES == 16384 and smem_bytes(2) + 1024 == 206848 and smem_bytes(3) + 1024 == 223232
    assert smem_bytes(2, score_stages=3) + 1024 > SMEM_LIMIT and smem_bytes(4) + 1024 > SMEM_LIMIT
    assert "static_assert(sizeof(Smem<2>) + sizeof(Scores) + 1024 > kSmemLimit" in NS


def test_setmaxnreg_fits_the_registers_the_cta_is_launched_with():
    # __launch_bounds__(384, 1): 65,536 / 384 rounded down to a multiple of 8
    # a thread; setmaxnreg moves registers within that pool, never beyond it.
    # Consumer 0 keeps the launch's count; the producer gives up what
    # consumer 1 takes.
    assert LAUNCH_REGS == REGISTERS // THREADS // 8 * 8 == 168
    assert 128 * (PRODUCER_REGS + LAUNCH_REGS + CONSUMER_REGS) <= THREADS * LAUNCH_REGS <= REGISTERS == 65536
    assert PRODUCER_REGS % 8 == 0 and CONSUMER_REGS % 8 == 0 and 24 <= PRODUCER_REGS < LAUNCH_REGS < CONSUMER_REGS
    assert CONSUMER_REGS <= 256
    assert "regs_inc<kConsumerRegs>();\n    consume<1," in NS and "regs_dec<kProducerRegs>();" in NS
    assert "static_assert(128 * (kProducerRegs + kLaunchRegs + kConsumerRegs) <= kThreads * kLaunchRegs" in NS


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


def block_tiles(causal: bool, r: int, blocks: int, shift: int, s_kv: int):
    """(row0, n_tiles, n_open) of the walk's block r, as the kernel forms
    them: its first row (causal: the last rows first), its tiles (the keys
    before `key_end`), and of them the first ones, which no row masks."""
    row0 = (blocks - 1 - r if causal else r) * ROWS
    kend = min(max(row0 + ROWS + shift, 0), s_kv) if causal else s_kv
    n_tiles = (kend + TILE - 1) // TILE
    n_open = min(n_tiles, max(row0 + shift + 1, 0) // TILE) if causal else n_tiles
    return row0, n_tiles, n_open


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
    work = [block_tiles(causal, r, blocks, 0, s)[1] for _, _, r in order]
    for bh in range(heads):
        mine = work[bh * blocks:(bh + 1) * blocks]
        assert mine == sorted(mine, reverse=True)
    assert {block_tiles(causal, r, blocks, 0, s)[0] for r in range(blocks)} == set(range(0, s, ROWS))
    if heads == 128:  # the LM: every CTA's work within 5% of the mean
        load = [sum(block_tiles(causal, r, blocks, 0, s)[1] for _, _, r in seq) for seq in seqs.values()]
        assert max(load) <= 1.05 * sum(load) / len(load)


@pytest.mark.parametrize("case", CASES, ids=[f"{a}x{b}+{c}-{d}" for a, b, c, d in CASES])
def test_each_visible_pair_is_computed_once_and_masked_where_needed(case):
    s_q, s_kv, q_off, k_off = case
    shift = q_off - k_off
    i = np.arange(s_q)[:, None]
    j = np.arange(s_kv)[None, :]
    blocks = s_q // ROWS
    for causal in (True, False):
        visible = (j <= i + shift) if causal else np.ones((s_q, s_kv), bool)
        seen = np.zeros((s_q, s_kv), np.int32)
        for r in range(blocks):
            row0, n_tiles, n_open = block_tiles(causal, r, blocks, shift, s_kv)
            assert 0 <= n_open <= n_tiles and n_tiles * TILE <= s_kv  # tiles past Skv are never read
            for it in range(n_tiles):
                tile = (slice(row0, row0 + ROWS), slice(it * TILE, (it + 1) * TILE))
                if it < n_open:
                    assert visible[tile].all()  # no pair outside the mask computed unmasked
                else:
                    assert not visible[tile].all()  # a masked tile holds a masked pair
                assert visible[tile].any()  # no tile read for nothing
                seen[tile] += visible[tile]
        assert (seen == visible).all()  # every visible pair once, no other


def test_the_lm_diagonal_masks_four_tiles_a_block_and_a_future_block_has_none():
    blocks = 2048 // ROWS
    for r in range(blocks):
        row0, n_tiles, n_open = block_tiles(True, r, blocks, 0, 2048)
        assert n_tiles - n_open == 4 and n_tiles * TILE == row0 + ROWS  # 64 rows cross four tiles
    # RECT_OFFSETS' (128, 128, 0, 128): every key lies after every query, so no block has a tile
    assert {block_tiles(True, r, 2, -128, 128)[1] for r in range(2)} == {0}


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
    on the other, or bar.sync on both): a phase completes when both have
    joined it; a party that joins a phase twice is a fault."""

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


class Protocol:
    """The kernel's producer warpgroup (thread 0, which also issues the TMA
    copies, and the other 127) and its two consumer warpgroups as
    generators over the blocks of one CTA; each yields a condition it waits
    for. Buffers carry the tile they hold and the writers still to finish
    it; reads and writes are checked. `ring` transposes stages;
    `empty_waits` False drops every wait for a freed stage (score stages,
    transposes stages, raw stages)."""

    def __init__(self, ring, s_q, s_kv, causal, shift, rng, empty_waits=True):
        self.ring, self.rng, self.empty_waits = ring, rng, empty_waits
        blocks = s_q // ROWS
        self.blocks = [(r, *block_tiles(causal, r, blocks, shift, s_kv)) for r in range(blocks)]
        self.tiles = [(r, it) for r, _, n_tiles, _ in self.blocks for it in range(n_tiles)]
        self.qd_land, self.qd_empty = Barrier(1), Barrier(8)
        self.raw_full = [Barrier(1) for _ in range(RAW_STAGES)]
        self.s_ready = [Barrier(128) for _ in range(SCORE_STAGES)]
        self.s_empty = [Barrier(8) for _ in range(SCORE_STAGES)]
        self.t_ready = [Barrier(128) for _ in range(ring)]  # consumer 0's threads store Kᵀ
        self.t_empty = [Barrier(4) for _ in range(ring)]  # consumer 1's warps alone read it
        self.p_full, self.p_free = [Named(), Named()], [Named(), Named()]
        self.producer_bar = Named()
        self.content = {}  # buffer -> (tile, writers still writing)
        self.readers = Counter()  # (buffer, tile) -> readers now
        self.copies = []  # TMA copies in flight: (buffer, tile, barrier, bytes)

    # buffers: ("q",), ("do",), ("raw", stage), ("st", stage), ("tr", stage), ("p", slot)
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

    def tma(self, buf, tile, bar):
        bar.expect(1)
        self.write(buf, tile)
        self.copies.append((buf, tile, bar, 1))

    def producer(self, issuer: bool):
        """`issuer`: thread 0 (weight 1 of the 128 arrivals), else the other 127."""
        weight, me = (1, "issuer") if issuer else (127, "rest")
        n, nb = len(self.tiles), 0

        def store_scores(g):
            st, rs = g % SCORE_STAGES, g % RAW_STAGES
            if g >= SCORE_STAGES and self.empty_waits:
                yield lambda: self.s_empty[st].done((g // SCORE_STAGES - 1) & 1)
            yield lambda: self.raw_full[rs].done((g // RAW_STAGES) & 1)
            self.read_begin(("raw", rs), g)
            self.write(("st", st), g, ("issuer", "rest"))  # this thread's part of the stores
            yield lambda: True
            self.read_end(("raw", rs), g)
            self.written(("st", st), g, me)
            self.s_ready[st].arrive(weight)

        def land_qd(g):
            nonlocal nb
            if issuer:
                if nb > 0:
                    yield lambda nb=nb: self.qd_empty.done((nb - 1) & 1)
                block = self.tiles[g][0]
                self.qd_land.expect(2)
                for buf in (("q",), ("do",)):
                    self.write(buf, block)
                    self.copies.append((buf, block, self.qd_land, 1))
            nb += 1

        def sync():
            yield self.producer_bar.join(me)

        if n == 0:
            return
        if issuer:
            for g in range(min(RAW_STAGES, n)):
                self.tma(("raw", g % RAW_STAGES), g, self.raw_full[g % RAW_STAGES])
        yield from land_qd(0)
        for g in range(n):
            yield from store_scores(g)
            if self.empty_waits:
                yield from sync()  # raw stage g % kRawStages is read by every thread: refill it
            if issuer and g + RAW_STAGES < n:
                self.tma(("raw", (g + RAW_STAGES) % RAW_STAGES), g + RAW_STAGES,
                         self.raw_full[(g + RAW_STAGES) % RAW_STAGES])
            if g + 1 < n and self.tiles[g + 1][1] == 0:
                yield from land_qd(g + 1)

    def consumer(self, role: int):
        """Consumer warpgroup `role` (its 4 warps arrive together): role 0
        forms S and P and stores Kᵀ, role 1 dP, dS and the product against
        Kᵀ."""
        gt = nb = 0
        own = ("q",) if role == 0 else ("do",)
        for r, _, n_tiles, _ in self.blocks:
            if n_tiles == 0:
                continue
            yield lambda nb=nb: self.qd_land.done(nb & 1)
            self.read_begin(own, r)

            def form(g):
                slot = g & 1
                if role == 0:
                    if g >= 2:
                        yield self.p_free[slot].join(0)  # consumer 1 has read the slot's last P
                    self.write(("p", slot), g, ("consumer0",))
                    self.written(("p", slot), g, "consumer0")
                    self.p_full[slot].join(0)
                else:
                    yield self.p_full[slot].join(1)
                    self.read_begin(("p", slot), g)
                    self.read_end(("p", slot), g)
                    self.p_free[slot].join(1)

            def scores_done(it):
                g = gt + it
                self.read_end(("st", g % SCORE_STAGES), g)
                self.s_empty[g % SCORE_STAGES].arrive(4)
                if it == n_tiles - 1:
                    self.read_end(own, r)
                    self.qd_empty.arrive(4)

            def s_ready(it):
                g = gt + it
                return lambda: self.s_ready[g % SCORE_STAGES].done((g // SCORE_STAGES) & 1)

            def t_ready(it):
                g = gt + it
                return lambda: self.t_ready[g % self.ring].done((g // self.ring) & 1)

            def t_read(it):
                g = gt + it
                self.read_begin(("tr", g % self.ring), g)

            def t_free(it):
                g = gt + it
                self.read_end(("tr", g % self.ring), g)
                self.t_empty[g % self.ring].arrive(4)

            def transposes(it):  # role 0: the tile's Kᵀ from its score stage, which it reads already
                g = gt + it
                ts = g % self.ring
                if g >= self.ring and self.empty_waits:
                    yield lambda: self.t_empty[ts].done((g // self.ring - 1) & 1)
                self.write(("tr", ts), g, ("consumer0",))
                yield lambda: True
                self.written(("tr", ts), g, "consumer0")
                self.t_ready[ts].arrive(128)

            if role == 0:
                for it in range(n_tiles):
                    yield s_ready(it)
                    self.read_begin(("st", (gt + it) % SCORE_STAGES), gt + it)
                    yield from transposes(it)  # under the scores
                    yield lambda: True
                    scores_done(it)
                    yield from form(gt + it)
            else:
                yield s_ready(0)
                self.read_begin(("st", gt % SCORE_STAGES), gt)
                yield lambda: True
                scores_done(0)
                yield from form(gt)
                for it in range(1, n_tiles):
                    yield s_ready(it)
                    self.read_begin(("st", (gt + it) % SCORE_STAGES), gt + it)
                    yield t_ready(it - 1)
                    t_read(it - 1)
                    yield lambda: True
                    scores_done(it)
                    yield from form(gt + it)
                    yield lambda: True
                    t_free(it - 1)
                yield t_ready(n_tiles - 1)
                t_read(n_tiles - 1)
                yield lambda: True
                t_free(n_tiles - 1)
            gt += n_tiles
            nb += 1
        if role == 0:  # consumer 1 freed the last two tiles' slots without a writer waiting: match them
            for g in range(max(gt - 2, 0), gt):
                yield self.p_free[g & 1].join(0)


def run_protocol(pr: Protocol, rng) -> int:
    agents = {"issuer": pr.producer(True), "rest": pr.producer(False), "consumer0": pr.consumer(0),
              "consumer1": pr.consumer(1)}
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
    assert all(not b.joined for b in (*pr.p_full, *pr.p_free, pr.producer_bar))  # every named phase completed
    return steps


PROTOCOL_CASES = [(256, 256, 0, 0, True), (256, 256, 0, 0, False), (256, 256, 0, 64, True),
                  (128, 128, 0, 128, True), (128, 384, 256, 64, True), (128, 256, 37, 0, True),
                  (256, 256, 0, 32, True)]


@pytest.mark.parametrize("ring", RINGS)
@pytest.mark.parametrize("case", PROTOCOL_CASES,
                         ids=["causal", "noncausal", "shift-64", "future", "long-kv", "q37", "shift-32"])
def test_barrier_parities_never_overwrite_a_stage_in_use(ring, case):
    s_q, s_kv, q_off, k_off, causal = case
    for seed in range(8):
        rng = random.Random(seed)
        assert run_protocol(Protocol(ring, s_q, s_kv, causal, q_off - k_off, rng), rng) >= 0


@pytest.mark.parametrize("ring", RINGS)
def test_a_producer_without_the_empty_waits_is_caught(ring):
    # the replay sees a stage refilled (scores, Kᵀ or raw) before its readers free it
    caught = 0
    for seed in range(20):
        rng = random.Random(seed)
        try:
            run_protocol(Protocol(ring, 256, 256, False, 0, rng, empty_waits=False), rng)
        except AssertionError:
            caught += 1
    assert caught > 0


def test_one_transposes_stage_deadlocks():
    # consumer 0 would wait, under its scores, for the product of the tile
    # before, which waits for this tile's P: why the plans keep two or more
    for seed in range(4):
        rng = random.Random(seed)
        with pytest.raises(AssertionError, match="deadlock"):
            run_protocol(Protocol(1, 256, 256, True, 0, rng), rng)
