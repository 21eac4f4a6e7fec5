"""The launch plan of the one-pass f32 flash dk/dv at D <= 64, replayed.

`onepass::flash_bwd_dkv_1p_tc<D, Causal, Cut>` (`csrc/flash_attention.cu`)
is persistent: kCtas CTAs an SM walk the blocks of 128 key rows, a head's
blocks side by side, dealt out in a snake (`fwd128::Walk`). Two consumer
warpgroups own 64 key rows each of a block; a producer warpgroup, in
kChains chains that take the tiles in turn, lands each block's K and V by
bulk copy and each query tile (Q, dO, lse and delta) by cp.async into raw
stages, and stores each tile's operands into a ring of kRing stages on
`ready` / `empty` mbarriers. Its decisions are integer arithmetic on block,
tile and stage indices, written out here as the kernel writes them:

* the plan's bytes at each head dim, laid out as the source lays out
  `DkvSmem<D>`, equal the bytes its static_asserts state and fit 232,448
  (with the 1 KB the launch adds to align), two CTAs an SM where the plan
  runs two; the setmaxnreg split fits the CTA's launch registers;
* the walk covers every (head, block) once at the ViT's and the LM's path
  shapes, a head's blocks side by side;
* each visible pair is computed exactly once, masked only where a
  warpgroup's tile crosses its diagonal, and no tile is read for nothing, at
  the card's rectangular offsets (`chip_smoke.RECT_OFFSETS`) and those of
  `onepass_check`;
* the mbarriers' parities, replayed with the producer chains and the two
  consumer warpgroups in random interleavings and the copies landing late,
  never let the producer overwrite a stage or a block buffer that a
  consumer still reads, nor let a consumer read one before it is whole, and
  never deadlock; a producer without its `empty` waits is caught.

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
NS = SRC[SRC.rindex("namespace onepass {"):SRC.rindex("}  // namespace onepass")]
SMS = 132  # an H100 SXM's


def constexpr(name: str) -> int:
    m = re.search(rf"^constexpr int {name} = (\d+);", NS, re.M)
    assert m, f"{name} not found in onepass"
    return int(m.group(1))


THREADS = constexpr("kThreads")
PRODUCERS = constexpr("kProducers")
SMEM_LIMIT = constexpr("kSmemLimit")
SMEM_SM = constexpr("kSmemSm")
REGISTERS = constexpr("kRegisters")
ROWS = 128  # key rows a block: DkvPlan::kRows
TILE = 32  # queries a dk/dv tile (Plan<D>::kDkvTile)
DIMS = (16, 32, 64)


# ---------------------------------------------------------------------------
# The plans, as the source states them
# ---------------------------------------------------------------------------


def ctas(d: int) -> int:
    """DkvPlan<D>::kCtas: CTAs an SM."""
    return 2 if d == 16 else 1


def dkv_plan(d: int) -> dict:
    kv = 1 if d == 64 else 2
    return {"raw": 1 if d == 64 else 8, "ring": 2 if d == 64 else 3, "chains": 1 if d == 64 else 2,
            "regs": (64, 88) if ctas(d) == 2 else (88, 208), "bufs": kv, "ahead": kv - 1}


def test_the_plans_are_the_sources():
    assert THREADS == 384 and PRODUCERS == 128 and SMEM_LIMIT == 232448 and SMEM_SM == 233472
    for line in ("static constexpr int kCtas = D == 16 ? 2 : 1;",
                 "static constexpr int kRaw = D == 64 ? 1 : 8;",
                 "static constexpr int kRing = D == 64 ? 2 : 3;",
                 "static constexpr int kChains = D == 64 ? 1 : 2;",
                 "static constexpr int kKv = D == 64 ? 1 : 2;",
                 "static constexpr int kProducerRegs = kCtas == 2 ? 64 : 88, kConsumerRegs = kCtas == 2 ? 88 : 208;",
                 "__launch_bounds__(kThreads, DkvPlan<D>::kCtas)"):
        assert line in NS, line
    # the one-pass dk/dv of every head dim up to 64 reaches this kernel; the
    # one-pass forward at D 16 runs onepass::flash_fwd_1p_tc (replayed in
    # test_torch_flash_fwd_onepass_plan.py), the split dk/dv flash_bwd_dkv_tc
    assert "return onepass::launch<D, Causal>(" in SRC
    assert "KERNEL_CASES_64(fwd_d," in SRC and "return onepass::launch_fwd<D, Causal>(" in SRC
    assert "flash_bwd_dkv_tc<D, Causal>," in SRC and "template <int D, bool Causal>\n__global__" in SRC


# ---------------------------------------------------------------------------
# Shared memory and registers
# ---------------------------------------------------------------------------


def align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def dkv_smem(d: int) -> int:
    """sizeof(DkvSmem<D>): K and V as landed (kKv blocks), each warpgroup's
    K and V hi, the raw stages (Q, dO, lse, delta) and the operand stages
    (Q's, dO's, Qᵀ's and dOᵀ's hi, lse2, delta), each 128-byte aligned, then
    the mbarriers; the struct padded to its 128-byte alignment."""
    p = dkv_plan(d)
    off = p["bufs"] * 2 * ROWS * d * 4
    off = align(off, 128) + 2 * 2 * 64 * d * 4
    off = align(off, 128) + p["raw"] * (2 * TILE * d + 2 * TILE) * 4
    off = align(off, 128) + p["ring"] * (4 * TILE * d + 2 * TILE) * 4
    off += 8 * (2 * p["bufs"] + 2 * p["ring"])
    return align(off, 128)


@pytest.mark.parametrize("d", DIMS, ids=[f"Dkv{d}x{ctas(d)}" for d in DIMS])
def test_shared_memory_plan_fits_and_is_the_sources(d):
    size = dkv_smem(d)
    assert f"static_assert(sizeof(DkvSmem<{d}>) == {size} " in NS  # the source asserts the same bytes
    assert f"smem_fits({ctas(d)}, sizeof(DkvSmem<{d}>))" in NS
    assert size + 1024 <= SMEM_LIMIT
    assert ctas(d) * (size + 1024 + 1024) <= SMEM_SM  # 1 KB reserved a CTA, 1 KB to align
    if d == 16:  # two CTAs an SM
        assert 2 * (size + 1024 + 1024) <= SMEM_SM


@pytest.mark.parametrize("d", DIMS)
def test_setmaxnreg_fits_the_registers_the_cta_is_launched_with(d):
    # __launch_bounds__(384, kCtas): 65,536 / (384 · kCtas) rounded down to a
    # multiple of 8 a thread; setmaxnreg moves registers within that pool
    launch = REGISTERS // (THREADS * ctas(d)) // 8 * 8
    assert launch == {1: 168, 2: 80}[ctas(d)]
    producer, consumer = dkv_plan(d)["regs"]
    assert producer % 8 == 0 and consumer % 8 == 0 and producer >= 24
    assert PRODUCERS * producer + 256 * consumer <= THREADS * launch


@pytest.mark.parametrize("d", DIMS)
def test_a_chains_raw_stages_are_its_own(d):
    p = dkv_plan(d)
    c, raw = p["chains"], p["raw"]
    assert raw % c == 0
    stages = [{g % raw for g in range(h, 64, c)} for h in range(c)]
    assert all(not (stages[a] & stages[b]) for a in range(c) for b in range(a + 1, c))
    # tile g + kRaw − kChains, which a chain lands after storing its tile
    # g, goes into the stage the chain's last tile left
    assert all((g + raw - c) % raw == (g - c) % raw for g in range(c, 64))


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


def dkv_block(causal: bool, r: int, shift: int, s_q: int):
    """(key0, qt0, n_tiles, [(computed tiles, masked tiles) of each warpgroup]) of block r."""
    key0 = r * ROWS
    qt0 = min(max(key0 - shift, 0), s_q) // TILE * TILE if causal else 0
    n_tiles = (s_q - qt0) // TILE
    wgs = []
    for wg in range(2):
        wkey0 = key0 + 64 * wg
        skip = wkey0 - shift - TILE + 1 - qt0
        first = min(n_tiles, (skip + TILE - 1) // TILE) if causal and skip > 0 else 0
        masked = {it for it in range(first, n_tiles) if causal and wkey0 + 63 > qt0 + it * TILE + shift}
        wgs.append((range(first, n_tiles), masked))
    return key0, qt0, n_tiles, wgs


@pytest.mark.parametrize("shape", [(6144, 256, False), (128, 2048, True), (8, 1024, True), (5, 256, True)],
                         ids=["vit", "lm", "bh8", "bh5"])
def test_walk_covers_every_block_once_a_heads_blocks_side_by_side(shape):
    heads, s, causal = shape
    blocks = s // ROWS
    grid = min(heads * blocks, ctas(16) * SMS)
    seqs = walk(heads, blocks, grid)
    done = Counter((bh, r) for seq in seqs.values() for _, bh, r in seq)
    assert len(done) == heads * blocks and set(done.values()) == {1}
    per_cta = [len(seq) for seq in seqs.values()]
    assert max(per_cta) - min(per_cta) <= 1
    order = sorted(((n * grid + (c if n % 2 == 0 else grid - 1 - c)), bh, r)
                   for c, seq in seqs.items() for n, bh, r in seq)
    assert [bh for _, bh, _ in order] == sorted(bh for _, bh, _ in order)  # a head's blocks in a row
    if causal:  # within a head the heaviest block first (its first keys)
        for bh in range(heads):
            dkv = [dkv_block(True, r, 0, s)[2] for r in order_of(order, bh)]
            assert dkv == sorted(dkv, reverse=True)


def order_of(order, bh):
    """The blocks of head bh in the walk's order."""
    return [r for _, b, r in order if b == bh]


import chip_smoke  # noqa: E402  (the card's offsets, read by the tests below)

CASES = [(256, 256, 0, 0), (2048, 2048, 0, 0)] + [tuple(c) for c in chip_smoke.RECT_OFFSETS]


@pytest.mark.parametrize("case", CASES, ids=[f"{a}x{b}+{c}-{d}" for a, b, c, d in CASES])
def test_each_visible_pair_is_computed_once_and_masked_where_needed(case):
    s_q, s_kv, q_off, k_off = case
    shift = q_off - k_off
    i = np.arange(s_q)[:, None]
    j = np.arange(s_kv)[None, :]
    for causal in (True, False):
        visible = (j <= i + shift) if causal else np.ones((s_q, s_kv), bool)
        # 128-key blocks, 32-query tiles
        seen = np.zeros((s_q, s_kv), np.int32)
        for r in range(s_kv // ROWS):
            key0, qt0, n_tiles, wgs = dkv_block(causal, r, shift, s_q)
            assert qt0 + n_tiles * TILE == s_q  # tiles past Sq are never read
            for it in range(n_tiles):
                qs = slice(qt0 + it * TILE, qt0 + (it + 1) * TILE)
                assert visible[qs, key0:key0 + ROWS].any()  # no tile read for nothing
                for wg, (mine, masked) in enumerate(wgs):
                    keys = slice(key0 + 64 * wg, key0 + 64 * wg + 64)
                    if it not in mine:
                        assert not visible[qs, keys].any()  # a tile it does not compute it may not see
                        continue
                    if it in masked:
                        assert not visible[qs, keys].all()
                    else:
                        assert visible[qs, keys].all()  # no pair outside the mask computed unmasked
                    seen[qs, keys] += visible[qs, keys]
        assert (seen == visible).all()


def test_the_onepass_checks_offsets_are_covered():
    # onepass_check's rectangular causal cases (phase_flash_default) lie among CASES
    for case in ((256, 256, 0, 64), (128, 384, 256, 64)):
        assert case in CASES


# ---------------------------------------------------------------------------
# The barriers
# ---------------------------------------------------------------------------


class Barrier:
    """An mbarrier: `count` arrivals (and, for a copy's barrier, the bytes) complete a phase."""

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
    """One CTA's producer chains and its two consumer warpgroups as
    generators over the CTA's blocks; each yields the condition it waits
    for. `blocks` is the CTA's walk, a list of (n_tiles, [computed tiles of
    warpgroup 0, of warpgroup 1]) of the blocks with a tile. A chain stands
    for its threads, which meet on its named barrier every tile; its first
    thread lands the block buffers (K and V), which the consumers read
    as a block starts. `empty_waits` False drops the producer's waits for
    freed operand stages."""

    def __init__(self, blocks, ring, chains, nbufs, ahead, rng, empty_waits=True):
        self.blocks, self.ring, self.chains, self.nbufs, self.ahead = blocks, ring, chains, nbufs, ahead
        self.rng, self.empty_waits = rng, empty_waits
        self.tiles = [(b, it) for b, (n_tiles, _) in enumerate(blocks) for it in range(n_tiles)]
        self.buf_full = [Barrier(1) for _ in range(nbufs)]
        self.buf_empty = [Barrier(8) for _ in range(nbufs)]
        self.ready = [Barrier(1) for _ in range(ring)]  # a chain's warps' arrivals, as one
        self.empty = [Barrier(8) for _ in range(ring)]
        self.content = {}  # buffer -> (what it holds, writers still writing)
        self.readers = Counter()  # (buffer, what) -> readers now
        self.copies = []  # copies in flight: (buffer, what, barrier)

    def write(self, buf, what, writer):
        others = [w for (b, w), n in self.readers.items() if b == buf and n]
        assert not others, f"{buf} overwritten with {what} while read as {others}"
        self.content[buf] = (what, {writer})

    def written(self, buf, what, writer):
        assert self.content[buf][0] == what
        self.content[buf][1].discard(writer)

    def read_begin(self, buf, what):
        held = self.content.get(buf)
        assert held is not None and held[0] == what and not held[1], f"{buf} read as {what}, holds {held}"
        self.readers[buf, what] += 1

    def read_end(self, buf, what):
        self.readers[buf, what] -= 1

    def land_one(self):
        buf, what, bar = self.copies.pop(self.rng.randrange(len(self.copies)))
        self.written(buf, what, "copy")
        bar.complete_tx(1)

    def land_buf(self, b):
        """The b-th block's K and V by bulk copy, once block b − nbufs's consumers hold theirs."""
        if b >= self.nbufs:
            yield lambda: self.buf_empty[b % self.nbufs].done(((b - self.nbufs) // self.nbufs) & 1)
        bar = self.buf_full[b % self.nbufs]
        bar.expect(1)
        self.write(("buf", b % self.nbufs), b, "copy")
        self.copies.append((("buf", b % self.nbufs), b, bar))

    def producer(self, h):
        if not self.tiles:
            return
        if h == 0:  # thread p = 0: the first blocks' buffers
            for b in range(min(self.ahead, len(self.blocks))):
                yield from self.land_buf(b)
        for g in range(h, len(self.tiles), self.chains):
            b, it = self.tiles[g]
            if it == 0 and b + self.ahead < len(self.blocks):  # a block's first tile: the buffer kAhead blocks on
                yield from self.land_buf(b + self.ahead)
            st = g % self.ring
            if g >= self.ring and self.empty_waits:
                yield lambda st=st, g=g: self.empty[st].done((g // self.ring - 1) & 1)
            self.write(("st", st), g, "chain")
            yield lambda: True
            self.written(("st", st), g, "chain")
            self.ready[st].arrive()

    def consumer(self, wg):
        g0 = 0
        for b, (n_tiles, mine) in enumerate(self.blocks):
            yield lambda b=b: self.buf_full[b % self.nbufs].done((b // self.nbufs) & 1)
            self.read_begin(("buf", b % self.nbufs), b)  # its rows' hi, formed as the block starts
            yield lambda: True
            self.read_end(("buf", b % self.nbufs), b)
            self.buf_empty[b % self.nbufs].arrive(4)
            for it in range(n_tiles):
                g = g0 + it
                st = g % self.ring
                yield lambda st=st, g=g: self.ready[st].done((g // self.ring) & 1)
                if it in mine[wg]:
                    self.read_begin(("st", st), g)
                    yield lambda: True
                    self.read_end(("st", st), g)
                self.empty[st].arrive(4)
            g0 += n_tiles


def run_protocol(pr: Protocol, rng) -> int:
    agents = {f"chain{h}": pr.producer(h) for h in range(pr.chains)}
    agents.update({f"wg{w}": pr.consumer(w) for w in range(2)})
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


def cta_blocks(case, causal, heads=3, grid=2, cta=0):
    """The walk of CTA `cta` of `grid` over `heads` heads: its blocks with a tile."""
    s_q, s_kv, q_off, k_off = case
    shift = q_off - k_off
    out = []
    for _, _, r in walk(heads, s_kv // ROWS, grid)[cta]:
        _, _, n_tiles, wgs = dkv_block(causal, r, shift, s_q)
        if n_tiles:
            out.append((n_tiles, [set(m) for m, _ in wgs]))
    return out


PROTOCOL_CASES = [((256, 256, 0, 0), True), ((256, 256, 0, 0), False), ((256, 256, 0, 64), True),
                  ((128, 128, 0, 128), True), ((128, 384, 256, 64), True), ((128, 256, 37, 0), True),
                  ((512, 512, 0, 0), True)]
@pytest.mark.parametrize("d", DIMS, ids=[f"dkv{d}x{ctas(d)}" for d in DIMS])
@pytest.mark.parametrize("case", PROTOCOL_CASES,
                         ids=["causal", "noncausal", "shift-64", "future", "long-kv", "q37", "causal512"])
def test_barrier_parities_never_overwrite_a_stage_in_use(d, case):
    p = dkv_plan(d)
    shape, causal = case
    for cta in range(2):
        blocks = cta_blocks(shape, causal, cta=cta)
        for seed in range(6):
            rng = random.Random(seed)
            pr = Protocol(blocks, p["ring"], p["chains"], p["bufs"], p["ahead"], rng)
            assert run_protocol(pr, rng) >= 0


@pytest.mark.parametrize("d", DIMS, ids=[f"dkv{d}" for d in DIMS])
def test_a_producer_without_its_empty_waits_is_caught(d):
    p = dkv_plan(d)
    blocks = cta_blocks((256, 256, 0, 0), False)
    caught = 0
    for seed in range(20):
        rng = random.Random(seed)
        try:
            run_protocol(Protocol(blocks, p["ring"], p["chains"], p["bufs"], p["ahead"], rng, empty_waits=False), rng)
        except AssertionError:
            caught += 1
    assert caught > 0
