"""The launch plan of the one-pass f32 flash forward at D 16, replayed.

`onepass::flash_fwd_1p_tc<D, Causal, Cut>` (`csrc/flash_attention.cu`) is
persistent: a CTA an SM walks the blocks of 256 query rows (a head's last
block may hold 128), a head's blocks side by side, dealt out in a snake
(`fwd128::Walk`). Four consumer warpgroups own 64 rows each of a block; a
producer warpgroup of four warps that never wait for each other lands, by
bulk copy, warp w's quarter of each K/V tile kRaw tiles ahead and the 64 Q
rows of consumer warpgroup w a block ahead, and stores its quarter of each
tile's operands into a ring of kRing stages on `ready` / `empty` mbarriers.
Its decisions are integer arithmetic on block, tile and stage indices,
written out here as the kernel writes them:

* the plan's bytes at each head dim, laid out as the source lays out
  `FwdSmem<D>`, equal the bytes its static_asserts state and fit 232,448
  (with the 1 KB the launch adds to align) at one CTA an SM; the
  setmaxnreg split fits the CTA's launch registers; the key tile is the
  plain version's (`F32_FWD_KEYS`);
* the walk covers every (head, block) once at the ViT's and the LM's path
  shapes, a head's blocks side by side;
* each visible (query, key) pair is computed exactly once, masked only
  where a warpgroup's tile crosses its diagonal, the same tiles computed and
  masked as `flash_fwd_tc` computes and masks them for those rows (so the
  outputs are its bits), and no tile is landed for nothing, at the card's
  rectangular offsets (`chip_smoke.RECT_OFFSETS`) and those of
  `onepass_check`;
* the mbarriers' parities, replayed with the four producer warps and the
  four consumer warpgroups in random interleavings, the copies landing
  late, and every cut's path, never let a copy or the producer overwrite a
  Q buffer, a raw stage or an operand stage that is still read, nor let
  anyone read one before it is whole, and never deadlock; a producer
  without its `empty` waits is caught, and so is a producer that lands each
  block's Q with its first K/V tile instead of a block ahead (it deadlocks).

The constants are read from the source. Runs in seconds on the CPU.
"""

import random
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from federated_pytorch_test_tpu_torch.ops import flash_cuda as fc

SOURCE = Path(fc.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
SRC = SOURCE.read_text()
NS = SRC[SRC.rindex("namespace onepass {"):SRC.rindex("}  // namespace onepass")]
FWD = NS[NS.index("struct FwdPlan {"):]
SMS = 132  # an H100 SXM's
DIMS = (16,)
ROWS = 256  # query rows a block: FwdPlan::kRows
KEYS = 64  # keys a tile
CONSUMERS = 4
CUTS = ("full", "loads_only", "no_split")  # the cuts whose barrier path differs (no_exp, no_mma: as full)


def constexpr(name: str) -> int:
    m = re.search(rf"^constexpr int {name} = (\d+);", NS, re.M)
    assert m, f"{name} not found in onepass"
    return int(m.group(1))


PRODUCERS = constexpr("kProducers")
SMEM_LIMIT = constexpr("kSmemLimit")
SMEM_SM = constexpr("kSmemSm")
REGISTERS = constexpr("kRegisters")
THREADS = 128 * CONSUMERS + PRODUCERS


def fwd_plan(d: int) -> dict:
    """FwdPlan<D>, as the source states it."""
    return {"q": 2, "raw": 4, "ring": 8, "regs": (40, 104)}


def test_the_plan_is_the_sources():
    for line in ("static constexpr int kRows = 256;",
                 "static constexpr int kKeys = Plan<D>::kKeys;",
                 "static constexpr int kConsumers = 4;",
                 "static constexpr int kThreads = 128 * kConsumers + kProducers;",
                 "static constexpr int kQ = 2;",
                 "static constexpr int kRaw = 4;",
                 "static constexpr int kRing = 8;",
                 "static constexpr int kProducerRegs = 40, kConsumerRegs = 104;",
                 "__launch_bounds__(FwdPlan<D>::kThreads, 1)"):
        assert line in FWD, line
    # the one-pass forward at D 16 reaches this kernel; D 32 and 64 and the
    # split forward keep flash_fwd_tc
    assert 'static_assert(D == 16, "D = 32 and 64 keep flash_fwd_tc, D = 128 runs fwd128");' in FWD
    assert "if constexpr (!Split && D == 16)\n    return onepass::launch_fwd<D, Causal>(" in SRC
    assert "KERNEL_CASES_64(fwd_d," in SRC


@pytest.mark.parametrize("d", DIMS)
def test_the_key_tile_is_the_plain_versions(d):
    assert "static constexpr int kKeys = 64;      // keys a forward K/V tile" in SRC  # Plan<D>::kKeys
    assert fc.F32_FWD_KEYS[d] == KEYS


# ---------------------------------------------------------------------------
# Shared memory and registers
# ---------------------------------------------------------------------------


def align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def fwd_smem(d: int) -> int:
    """sizeof(FwdSmem<D>): kQ blocks' Q as landed, kRaw raw K/V tiles,
    kRing operand stages (K's hi, Vᵀ's hi with its D + 8 rows), each
    128-byte aligned, then the mbarriers (q_full and q_empty a consumer
    warpgroup and Q buffer, raw_full a producer warp and raw stage, ready
    and empty a stage); the struct padded to its 128-byte alignment."""
    p = fwd_plan(d)
    off = p["q"] * ROWS * d * 4
    off = align(off, 128) + p["raw"] * 2 * KEYS * d * 4
    off = align(off, 128) + p["ring"] * (KEYS * d + (d + 8) * KEYS) * 4
    off += 8 * (2 * CONSUMERS * p["q"] + 4 * p["raw"] + 2 * p["ring"])
    return align(off, 128)


@pytest.mark.parametrize("d", DIMS)
def test_shared_memory_plan_fits_and_is_the_sources(d):
    size = fwd_smem(d)
    assert f"static_assert(sizeof(FwdSmem<{d}>) == {size} && smem_fits(1, sizeof(FwdSmem<{d}>))" in NS
    assert size + 1024 <= SMEM_LIMIT  # the launch adds 1 KB to align
    assert size + 1024 + 1024 <= SMEM_SM  # and the SM reserves 1 KB a CTA


@pytest.mark.parametrize("d", DIMS)
def test_setmaxnreg_fits_the_registers_the_cta_is_launched_with(d):
    # __launch_bounds__(640, 1): 65,536 / 640 rounded down to a multiple of 8
    launch = REGISTERS // THREADS // 8 * 8
    assert THREADS == 640 and launch == 96
    assert "static constexpr int kLaunchRegs = kRegisters / kThreads / 8 * 8;" in FWD
    producer, consumer = fwd_plan(d)["regs"]
    assert producer % 8 == 0 and consumer % 8 == 0 and producer >= 24
    assert producer <= launch <= consumer  # setmaxnreg.dec, then .inc
    assert PRODUCERS * producer + 128 * CONSUMERS * consumer <= THREADS * launch


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


def blocks_of(s_q: int) -> int:
    return (s_q + ROWS - 1) // ROWS


def block(causal: bool, r: int, shift: int, s_q: int, s_kv: int):
    """(row0, n_tiles, [(present, computed tiles, masked tiles) of each
    consumer warpgroup]) of block r, as the kernel computes them."""
    row0 = ((blocks_of(s_q) - 1 - r) if causal else r) * ROWS
    kend = min(max(row0 + min(ROWS, s_q - row0) + shift, 0), s_kv) if causal else s_kv
    n_tiles = (kend + KEYS - 1) // KEYS
    wgs = []
    for wg in range(CONSUMERS):
        wrow0 = row0 + 64 * wg
        if wrow0 >= s_q:
            wgs.append((False, range(0), set()))
            continue
        n_vis = min(n_tiles, max(wrow0 + shift + 127, 0) // KEYS) if causal else n_tiles
        n_open = min(n_tiles, max(wrow0 + shift + 1, 0) // KEYS) if causal else n_tiles
        wgs.append((True, range(n_vis), set(range(n_open, n_vis))))
    return row0, n_tiles, wgs


def parent_tiles(causal: bool, wrow0: int, shift: int, s_kv: int):
    """The tiles flash_fwd_tc computes and masks for the 64 rows from wrow0:
    its 128-row block's tiles up to `key_end`, skipping those wholly in the
    warpgroup's future and masking those across its diagonal."""
    row0 = wrow0 // 128 * 128
    kend = min(max(row0 + 128 + shift, 0), s_kv) if causal else s_kv
    computed, masked = set(), set()
    for it in range((kend + KEYS - 1) // KEYS):
        kt = it * KEYS
        if causal and kt > wrow0 + 63 + shift:
            continue
        computed.add(it)
        if causal and kt + KEYS - 1 > wrow0 + shift:
            masked.add(it)
    return computed, masked


@pytest.mark.parametrize("shape", [(6144, 256, False), (128, 2048, True), (8, 384, True), (5, 128, True)],
                         ids=["vit", "lm", "bh8-384", "bh5-128"])
def test_walk_covers_every_block_once_a_heads_blocks_side_by_side(shape):
    heads, s, causal = shape
    blocks = blocks_of(s)
    grid = min(heads * blocks, SMS)
    seqs = walk(heads, blocks, grid)
    done = Counter((bh, r) for seq in seqs.values() for _, bh, r in seq)
    assert len(done) == heads * blocks and set(done.values()) == {1}
    per_cta = [len(seq) for seq in seqs.values()]
    assert max(per_cta) - min(per_cta) <= 1
    order = sorted(((n * grid + (c if n % 2 == 0 else grid - 1 - c)), bh, r)
                   for c, seq in seqs.items() for n, bh, r in seq)
    assert [bh for _, bh, _ in order] == sorted(bh for _, bh, _ in order)  # a head's blocks in a row
    if causal:  # within a head the block of the last rows (the most keys) first
        rows = [block(True, r, 0, s, s)[0] for _, b, r in order if b == 0]
        assert rows == sorted(rows, reverse=True)


CASES = [(256, 256, 0, 0), (2048, 2048, 0, 0), (384, 384, 0, 0), (1024, 1024, 0, 0)] + [
    tuple(c) for c in chip_smoke.RECT_OFFSETS]


@pytest.mark.parametrize("case", CASES, ids=[f"{a}x{b}+{c}-{d}" for a, b, c, d in CASES])
def test_each_visible_pair_is_computed_once_and_masked_as_the_parent_does(case):
    s_q, s_kv, q_off, k_off = case
    shift = q_off - k_off
    i = np.arange(s_q)[:, None]
    j = np.arange(s_kv)[None, :]
    for causal in (True, False):
        visible = (j <= i + shift) if causal else np.ones((s_q, s_kv), bool)
        seen = np.zeros((s_q, s_kv), np.int32)
        for r in range(blocks_of(s_q)):
            row0, n_tiles, wgs = block(causal, r, shift, s_q, s_kv)
            rows = slice(row0, min(row0 + ROWS, s_q))
            assert n_tiles * KEYS <= s_kv
            for it in range(n_tiles):  # no tile landed for nothing
                assert visible[rows, it * KEYS:(it + 1) * KEYS].any()
            assert not visible[rows, n_tiles * KEYS:].any()  # and none left out
            for wg, (present, computed, masked) in enumerate(wgs):
                wrow0 = row0 + 64 * wg
                if not present:
                    assert wrow0 >= s_q
                    continue
                assert (set(computed), masked) == parent_tiles(causal, wrow0, shift, s_kv)  # its bits
                qs = slice(wrow0, wrow0 + 64)
                for it in range(n_tiles):
                    keys = slice(it * KEYS, (it + 1) * KEYS)
                    if it not in computed:
                        assert not visible[qs, keys].any()  # a tile it skips it may not see
                        continue
                    if it in masked:
                        assert not visible[qs, keys].all()
                    else:
                        assert visible[qs, keys].all()  # no pair outside the mask computed unmasked
                    seen[qs, keys] += visible[qs, keys]
        assert (seen == visible).all()


def test_the_onepass_checks_offsets_are_covered():
    # onepass_check's cases (phase_flash_default): the aligned causal one at
    # S 1024, the rectangular ones at S 256 and at Sq 128 against Skv 384
    for case in ((1024, 1024, 0, 0), (256, 256, 0, 0), (256, 256, 0, 64), (128, 384, 256, 64)):
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
    """One CTA's four producer warps and four consumer warpgroups as
    generators over the CTA's blocks; each yields the condition it waits
    for. `blocks` is the CTA's walk: (n_tiles, [(present, computed tiles)
    of each warpgroup]) of the blocks with a tile. `empty_waits` False drops
    the producer's waits for freed operand stages; `q_with_tiles` lands a
    block's Q with its first K/V tile, kRaw tiles ahead, instead of a block
    ahead."""

    def __init__(self, blocks, plan, cut, rng, empty_waits=True, q_with_tiles=False):
        self.blocks, self.cut, self.rng = blocks, cut, rng
        self.kq, self.raw, self.ring = plan["q"], plan["raw"], plan["ring"]
        self.empty_waits, self.q_with_tiles = empty_waits, q_with_tiles
        self.tiles = [(b, it) for b, (n_tiles, _) in enumerate(blocks) for it in range(n_tiles)]
        self.q_full = [[Barrier(1) for _ in range(self.kq)] for _ in range(CONSUMERS)]
        self.q_empty = [[Barrier(4) for _ in range(self.kq)] for _ in range(CONSUMERS)]
        self.raw_full = [[Barrier(1) for _ in range(self.raw)] for _ in range(4)]
        self.ready = [Barrier(4) for _ in range(self.ring)]
        self.empty = [Barrier(4 * CONSUMERS) for _ in range(self.ring)]
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

    def copy(self, buf, what, bar):
        bar.expect(1)
        self.write(buf, what, "copy")
        self.copies.append((buf, what, bar))

    def land_one(self):
        buf, what, bar = self.copies.pop(self.rng.randrange(len(self.copies)))
        self.written(buf, what, "copy")
        bar.complete_tx(1)

    def producer(self, pw):
        if not self.tiles:
            return
        nq = 0

        def land_q(b):  # lane 0: consumer warpgroup pw's Q rows of block b
            nonlocal nq
            if not self.blocks[b][1][pw][0]:
                return
            if nq >= self.kq:
                yield lambda n=nq: self.q_empty[pw][n % self.kq].done(((n - self.kq) // self.kq) & 1)
            self.copy(("q", pw, nq % self.kq), b, self.q_full[pw][nq % self.kq])
            nq += 1

        def land_tile(g):  # lane 0: this warp's quarter of tile g into raw stage g % kRaw
            if g >= len(self.tiles):
                return
            b, it = self.tiles[g]
            if self.q_with_tiles and it == 0 and b > 0:
                yield from land_q(b)
            bar = self.raw_full[pw][g % self.raw]
            if self.cut == "no_split":
                bar.arrive()
            else:
                self.copy(("raw", pw, g % self.raw), g, bar)

        yield from land_q(0)
        for g in range(self.raw):
            yield from land_tile(g)
        g = 0
        for b, (n_tiles, _) in enumerate(self.blocks):
            if b + 1 < len(self.blocks) and not self.q_with_tiles:  # the next block's Q
                yield from land_q(b + 1)
            for _ in range(n_tiles):
                yield lambda g=g: self.raw_full[pw][g % self.raw].done((g // self.raw) & 1)
                if g >= self.ring and self.empty_waits:
                    yield lambda g=g: self.empty[g % self.ring].done((g // self.ring - 1) & 1)
                if self.cut != "no_split":
                    self.read_begin(("raw", pw, g % self.raw), g)
                self.write(("st", g % self.ring, pw), g, "warp")
                yield lambda: True
                self.written(("st", g % self.ring, pw), g, "warp")
                if self.cut != "no_split":
                    self.read_end(("raw", pw, g % self.raw), g)
                self.ready[g % self.ring].arrive()
                yield from land_tile(g + self.raw)
                g += 1

    def consumer(self, wg):
        g0, nq = 0, 0
        for b, (n_tiles, wgs) in enumerate(self.blocks):
            present, computed = wgs[wg]
            if present:
                yield lambda n=nq: self.q_full[wg][n % self.kq].done((n // self.kq) & 1)
                self.read_begin(("q", wg, nq % self.kq), b)  # its rows' hi into registers
                yield lambda: True
                self.read_end(("q", wg, nq % self.kq), b)
                self.q_empty[wg][nq % self.kq].arrive(4)
                nq += 1
            for it in range(n_tiles):
                g = g0 + it
                st = g % self.ring
                yield lambda st=st, g=g: self.ready[st].done((g // self.ring) & 1)
                # a block's first tile's scores are issued whether or not the
                # warpgroup computes that tile
                reads = present and (it in computed or it == 0) and self.cut != "loads_only"
                if reads:
                    for pw in range(4):  # the four warps' quarters
                        self.read_begin(("st", st, pw), g)
                    if it == 0 and b > 0:
                        yield lambda: True  # the last block's o and lse stored under these scores
                    yield lambda: True  # the scores
                if reads:
                    yield lambda: True  # the products
                    for pw in range(4):
                        self.read_end(("st", st, pw), g)
                self.empty[st].arrive(4)
            g0 += n_tiles


def run_protocol(pr: Protocol, rng) -> int:
    agents = {f"warp{w}": pr.producer(w) for w in range(4)}
    agents.update({f"wg{w}": pr.consumer(w) for w in range(CONSUMERS)})
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
    out = []
    for _, _, r in walk(heads, blocks_of(s_q), grid)[cta]:
        _, n_tiles, wgs = block(causal, r, q_off - k_off, s_q, s_kv)
        if n_tiles:
            out.append((n_tiles, [(present, set(computed)) for present, computed, _ in wgs]))
    return out


PROTOCOL_CASES = [((256, 256, 0, 0), True), ((256, 256, 0, 0), False), ((256, 256, 0, 64), True),
                  ((128, 128, 0, 128), True), ((128, 384, 256, 64), True), ((384, 256, 37, 0), True),
                  ((512, 512, 0, 0), True), ((256, 256, -192, 0), True)]


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("case", PROTOCOL_CASES,
                         ids=["causal", "noncausal", "shift-64", "future", "long-kv", "q384", "causal512", "one-tile"])
def test_barrier_parities_never_overwrite_a_buffer_in_use(case, d, cut):
    shape, causal = case
    for cta in range(2):
        blocks = cta_blocks(shape, causal, cta=cta)
        for seed in range(4):
            rng = random.Random(seed)
            assert run_protocol(Protocol(blocks, fwd_plan(d), cut, rng), rng) >= 0


@pytest.mark.parametrize("d", DIMS)
def test_a_producer_without_its_empty_waits_is_caught(d):
    blocks = cta_blocks((256, 256, 0, 0), False, heads=8, grid=1)  # 32 tiles: the ring wraps
    caught = 0
    for seed in range(20):
        rng = random.Random(seed)
        try:
            run_protocol(Protocol(blocks, fwd_plan(d), "full", rng, empty_waits=False), rng)
        except AssertionError:
            caught += 1
    assert caught > 0


def test_landing_q_with_the_tiles_deadlocks_on_blocks_of_one_tile():
    # blocks that see one tile each (causal, keys far behind the queries):
    # the kRaw tiles landed ahead reach kQ blocks past the one whose tiles
    # are stored, whose Q buffer frees only once the consumers have started
    # a block whose tile is not stored yet
    blocks = cta_blocks((256, 256, -192, 0), True, heads=6, grid=1)
    assert len(blocks) >= 4 and all(n_tiles == 1 for n_tiles, _ in blocks[:4])
    rng = random.Random(0)
    with pytest.raises(AssertionError, match="deadlock"):
        run_protocol(Protocol(blocks, fwd_plan(16), "full", rng, q_with_tiles=True), rng)
    rng = random.Random(0)
    assert run_protocol(Protocol(blocks, fwd_plan(16), "full", rng), rng) > 0
