"""A numpy model of the grouped GEMM kernel's split-TF32 arithmetic and layouts.

`csrc/grouped_gemm.cu` (`grouped_gemm_tc`) takes every product on the
tensor cores in TF32, as the flash kernels do (`test_torch_flash_split.py`,
whose `tf32`, `truncate`, `split` and `wgmma` this file uses): x = hi + lo
with hi = tf32(x) and lo = x − hi read truncated, a·b = lo·hi + hi·lo +
hi·hi, the small products of each 32-position stage first. Each tensor-core
instruction (8 products) is modelled as an exact sum rounded once to f32.
Each block of 64 contraction positions (two stages) sums in a fresh
accumulator, folded into the running f32 sum with one add; a split
contraction's partials are added in split order (`grouped_sum`). Held
against float64, the model keeps every role within 1e-5 of the largest
entry at the path's contraction lengths (64, 256, and a 1,024-slot split of
the weight gradient), where one TF32 pass misses that gate.

The index arithmetic of the kernel, as written, is checked too: the
cp.async staging of a stage (16-byte and 4-byte copies, an operand's
contraction axis contiguous or transposed), the split pass into wgmma's
K-major layout, the descriptors' strides per warpgroup and k8 step, and the
output's staging through shared memory.
"""

import numpy as np
import pytest

from federated_pytorch_test_tpu_torch.ops import grouped_gemm as gg
from test_torch_flash_split import cidx, split, tf32, truncate, wgmma

BK = 32  # kBK: contraction positions a stage
FOLD = 64  # kFold: positions summed in one fresh accumulator
PAD = 4  # kPad


def stage_product(a, b, part, passes=3):
    """part (+)= a [M, BK] · b [BK, N] in the kernel's order: over the
    stage's four k8 steps the small products, then the large ones. With
    part None the first instruction overwrites (a fresh accumulator)."""
    (ah, al), (bh, bl) = split(a), split(b)
    steps = [slice(k, k + 8) for k in range(0, BK, 8)]
    part = np.zeros((a.shape[0], b.shape[1]), np.float32) if part is None else part
    if passes == 3:
        for ks in steps:
            part = wgmma(part, al[:, ks], bh[ks])
            part = wgmma(part, ah[:, ks], bl[ks])
    for ks in steps:
        part = wgmma(part, ah[:, ks], bh[ks])
    return part


def kernel_model(a, b, k_chunk=None, passes=3):
    """a [M, K] · b [K, N] of one group as the kernel computes it: the
    contraction in splits of `k_chunk` (each a block's partial), stages of
    BK, fold blocks of FOLD, the splits added in order."""
    k = a.shape[1]
    chunk = k if k_chunk is None else k_chunk
    out = None
    for k_begin in range(0, k, chunk):
        k_end = min(k, k_begin + chunk)
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
        n_k = -(-(k_end - k_begin) // BK)
        part = None
        for it in range(n_k):
            lo, hi = k_begin + it * BK, min(k_end, k_begin + (it + 1) * BK)
            a_st = np.zeros((a.shape[0], BK), np.float32)
            b_st = np.zeros((BK, b.shape[1]), np.float32)
            a_st[:, : hi - lo], b_st[: hi - lo] = a[:, lo:hi], b[lo:hi]  # out of range lands as 0
            part = stage_product(a_st, b_st, None if it % (FOLD // BK) == 0 else part, passes)
            if it % (FOLD // BK) == FOLD // BK - 1 or it == n_k - 1:
                acc = (acc + part).astype(np.float32)
        out = acc if out is None else (out + acc).astype(np.float32)
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, k)).astype(np.float32), rng.normal(size=(k, n)).astype(np.float32)


def test_split_matches_the_flash_kernels_rounding():
    x = np.random.default_rng(0).normal(size=10_000).astype(np.float32)
    hi, lo = split(x)
    assert np.array_equal(hi, tf32(x)) and np.array_equal(lo, truncate(x - hi))


# (M, K, N, k_chunk): the path's contractions at a cut M — the fc1 forward
# and fc2's dA (K = 64, one fold block), the fc2 forward and fc1's dA (K =
# 256, four), one 1,024-slot split of each weight gradient (sixteen), two
# splits added in order, and a contraction that ends inside a stage
ROLES = [(128, 64, 256, None), (128, 256, 64, None), (64, 1024, 256, None), (256, 1024, 64, None),
         (64, 2048, 64, 1024), (40, 257, 9, None)]


@pytest.mark.parametrize("m,k,n,k_chunk", ROLES, ids=lambda v: str(v))
def test_split_tf32_roles_within_1e5_of_float64(m, k, n, k_chunk):
    a, b = _operands(m, k, n, seed=m + k + n)
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel(kernel_model(a, b, k_chunk), want) <= 1e-5


@pytest.mark.parametrize("m,k,n", [(128, 64, 256), (64, 1024, 256)])
def test_one_tf32_pass_misses_the_gate(m, k, n):
    a, b = _operands(m, k, n, seed=k)
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel(kernel_model(a, b, passes=1), want) > 1e-5
    assert _rel(kernel_model(a, b), want) <= 1e-5


def test_fold_blocks_keep_the_sum_closer_than_one_accumulator():
    # the weight gradient's 1,024-slot split in one tensor-core accumulator
    # against the kernel's fresh accumulator per 64 positions
    a, b = _operands(64, 1024, 64, seed=5)
    want = a.astype(np.float64) @ b.astype(np.float64)
    one = np.zeros((64, 64), np.float32)
    for lo in range(0, 1024, BK):
        one = stage_product(a[:, lo:lo + BK], b[lo:lo + BK], one)
    assert _rel(kernel_model(a, b), want) <= _rel(one, want)


# ---------------------------------------------------------------------------
# The kernel's index arithmetic, as written in csrc/grouped_gemm.cu.
# ---------------------------------------------------------------------------


def kraw(rows):
    """kRaw<R>: floats of a raw stage of an R-row operand."""
    return max(rows * (BK + PAD), BK * (rows + PAD))


def load_stage(src, ld, kc, rows_r, r0, rows, k0, kend, vec):
    """`load_stage<R, KC>`: the raw stage as the cp.async copies leave it.
    Element (r, k) of the operand is src[r·ld + k] (kc) or src[k·ld + r]."""
    raw = np.full(kraw(rows_r), np.nan)
    width = 4 if vec else 1
    for j in range(rows_r * BK // width):
        if vec:
            r, k = (j // (BK // 4), j % (BK // 4) * 4) if kc else (j % (rows_r // 4) * 4, j // (rows_r // 4))
        else:
            r, k = (j // BK, j % BK) if kc else (j % rows_r, j // rows_r)
        gr, gk = r0 + r, k0 + k
        ok = gr < rows and gk < kend
        dst = r * (BK + PAD) + k if kc else k * (rows_r + PAD) + r
        at = gr * ld + gk if kc else gk * ld + gr
        raw[dst:dst + width] = src[at:at + width] if ok else 0.0
    return raw


def split_stage(raw, rows_r, kc):
    """`split_stage<R, KC>` without the rounding: the operand layout it writes
    (64-row sub-blocks, `cidx<64>`)."""
    out = np.full(rows_r * BK, np.nan)
    for j in range(rows_r * BK // 4):
        r, c = j % rows_r, j // rows_r
        if kc:
            x = raw[r * (BK + PAD) + 4 * c:r * (BK + PAD) + 4 * c + 4]
        else:
            x = [raw[(4 * c + i) * (rows_r + PAD) + r] for i in range(4)]
        at = (r >> 6) * 64 * BK + cidx(64, r & 63, 4 * c)
        out[at:at + 4] = x
    return out


def wgmma_reads(buf, byte_off):
    """The [64, BK] operand a warpgroup's descriptors read from `buf` at
    `byte_off`: k8 step ks at byte_off + 2048·ks, element (r, c) at
    (c // 4)·LBO + (r // 8)·SBO + (r % 8)·16 + (c % 4)·4 bytes past it, with
    desc<64>'s LBO = 1024 and SBO = 128."""
    r, c = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
    steps = []
    for ks in range(BK // 8):
        addr = byte_off + 2048 * ks + (c // 4) * 1024 + (r // 8) * 128 + (r % 8) * 16 + (c % 4) * 4
        steps.append(buf[addr // 4])
    return np.concatenate(steps, 1)


@pytest.mark.parametrize("bm", [128, 64])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("vec", [True, False])
def test_staging_split_and_descriptors_read_the_operands(bm, transposed, vec):
    # A [M, K] row-major (KC) or transposed (M contiguous, RC), and B [K, N]
    # row-major (RC, the forward) or transposed (KC, dC·Bᵀ); a tile on the
    # ragged edge (rows past M, N; positions past K land as 0)
    bn = 64 if bm == 128 else 128
    assert gg.tiles(100, bn) == (bm, bn)
    m, k, n = 2 * bm - 12, 2 * BK + 20, 2 * bn - 8
    rng = np.random.default_rng(bm + vec)
    a, b = rng.normal(size=(m, k)), rng.normal(size=(k, n))
    a_kc, b_kc = not transposed, transposed
    a_src, lda = (a.ravel(), k) if a_kc else (a.T.ravel(), m)
    b_src, ldb = (b.T.ravel(), k) if b_kc else (b.ravel(), n)
    m0, n0, k0 = bm, bn, 2 * BK  # the last tile and stage of each
    a_op = split_stage(load_stage(a_src, lda, a_kc, bm, m0, m, k0, k, vec), bm, a_kc)
    b_op = split_stage(load_stage(b_src, ldb, b_kc, bn, n0, n, k0, k, vec), bn, b_kc)
    a_pad, b_pad = np.zeros((2 * bm, 3 * BK)), np.zeros((3 * BK, 2 * bn))
    a_pad[:m, :k], b_pad[:k, :n] = a, b
    for wg in range(2):
        wm, wn = (64 * wg, 0) if bm == 128 else (0, 64 * wg)
        got_a = wgmma_reads(a_op, 4 * BK * wm)
        got_b = wgmma_reads(b_op, 4 * BK * wn)
        np.testing.assert_array_equal(got_a, a_pad[m0 + wm:m0 + wm + 64, k0:k0 + BK])
        np.testing.assert_array_equal(got_b, b_pad[k0:k0 + BK, n0 + wn:n0 + wn + 64].T)


def test_staging_is_conflict_free():
    # the split pass: thread j takes row j % R, positions 4·(j // R); its
    # float4 reads of a KC stage and its float4 stores of the operands reach
    # 8 distinct 16-byte bank groups in each phase of 8 threads, and its four
    # scalar reads of a transposed (RC) stage 32 distinct banks a warp
    for rows_r in (64, 128):
        for j0 in range(0, rows_r * BK // 4, 8):
            j = np.arange(j0, j0 + 8)
            r, c = j % rows_r, j // rows_r
            stores = [(r_ >> 6) * 64 * BK + cidx(64, r_ & 63, 4 * c_) for r_, c_ in zip(r, c)]
            assert len({(x // 4) % 8 for x in stores}) == 8
            assert len({(x // 4) % 8 for x in r * (BK + PAD) + 4 * c}) == 8
        for j0 in range(0, rows_r * BK // 4, 32):
            j = np.arange(j0, j0 + 32)
            for i in range(4):
                assert len(set((((4 * (j // rows_r) + i) * (rows_r + PAD) + j % rows_r) % 32).tolist())) == 32


def test_output_staging_covers_the_tile_once():
    # accumulator fragment (warp w, lane: g, t) of a warpgroup's 64 x 64:
    # d[4j + e] = (16w + g, 8j + 2t + e), d[4j + 2 + e] the row + 8; staged at
    # row·(BN + 8) + wn + column, then read back as whole rows of float4s
    for bm in (128, 64):
        bn = 64 if bm == 128 else 128
        ld = bn + 8
        stage = np.full(bm * ld, -1.0)
        want = np.arange(bm * bn, dtype=float).reshape(bm, bn)
        for wg in range(2):
            wm, wn = (64 * wg, 0) if bm == 128 else (0, 64 * wg)
            for warp in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    ra = wm + 16 * warp + g
                    for j in range(8):
                        for e in range(2):
                            col = wn + 8 * j + 2 * t + e
                            for row in (ra, ra + 8):
                                assert stage[row * ld + col] == -1.0
                                stage[row * ld + col] = want[row, col]
        got = np.array([[stage[r * ld + 4 * q + i] for q in range(bn // 4) for i in range(4)] for r in range(bm)])
        np.testing.assert_array_equal(got, want)
        # the float2 stores of a half-warp (g < 4 or g >= 4) hit 32 distinct banks
        for g0 in (0, 4):
            banks = {(g * ld + 2 * t + e) % 32 for g in range(g0, g0 + 4) for t in range(4) for e in range(2)}
            assert len(banks) == 32


def test_shared_memory_fits_two_blocks_an_sm():
    for bm in (128, 64):
        bn = 64 if bm == 128 else 128
        floats = 2 * (kraw(bm) + kraw(bn)) + 2 * (bm + bn) * BK
        assert 2 * (4 * floats + 1024) <= 233_472  # the SM's 228 KB, 1 KB reserved a block
        assert bm * (bn + 8) <= 2 * (bm + bn) * BK  # the output stages in the operands' space
