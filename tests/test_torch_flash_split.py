"""A numpy model of the flash forward kernels' split-TF32 arithmetic.

`csrc/flash_attention.cu` computes the forward's two products on the tensor
cores in TF32, each operand x split as hi = tf32(x) (rounded to nearest)
and lo = x − hi, of which the tensor cores read the TF32 part truncated
(as they do any f32 operand: measured on the card), and a·b taken as
lo_a·hi_b + hi_a·lo_b + hi_a·hi_b. This file models that kernel in numpy:
the same rounding bit for bit (`tf32` is the kernel's), the same order of
products, 64-key tiles with the online softmax in base 2, each tile's
P·[V | 1] (the ones column gives the row sum l) summed apart and folded
into O and l as O·corr + P·V; at D = 128 a block owns 64 rows and a tile
holds 32 keys (`plan`, the kernel's `Plan<D>`). Each tensor-core instruction (8 products) is
modelled as an exact sum rounded once to f32. Held against float64, the model keeps o and lse within 1e-6
of the largest entry at D in {16, 32, 64, 128}, where one TF32 pass would miss
the forward's 1e-5 gate: the precision argument for the kernel before it
runs on the card. The layout index arithmetic the kernel uses (operand
layout and descriptor strides, the P fragment and the key order of Vᵀ) is
checked here too, as written in the kernel.
"""

import numpy as np
import pytest

LN2 = np.log(2.0)
LOG2E = np.float32(1.4426950408889634)


def _d128_constant(namespace, name):
    """`constexpr int name` of a head-dim-128 kernel's namespace in csrc/flash_attention.cu."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "federated_pytorch_test_tpu_torch" / "csrc"
           / "flash_attention.cu").read_text()
    ns = src[src.index(f"namespace {namespace} {{"):src.index(f"}}  // namespace {namespace}")]
    return int(re.search(rf"^constexpr int {name} = (\d+);", ns, re.M).group(1))


def plan(d):
    """(rows a block, keys a forward tile, keys a dq tile, queries a dk/dv
    tile) of the kernels at head dim d: `Plan<D>` in csrc/flash_attention.cu
    (at D 128 the kernels of their own: the forward's `fwd128::kKeys`, the
    dq's `dq128::kTile` and the dk/dv's `bwd128::kTile`, on blocks of 64
    rows)."""
    if d == 128:
        rows = {_d128_constant(ns, "kRows") for ns in ("fwd128", "dq128", "bwd128")}
        assert rows == {64}
        return 64, _d128_constant("fwd128", "kKeys"), _d128_constant("dq128", "kTile"), _d128_constant(
            "bwd128", "kTile")
    return 128, 64, 32 if d == 64 else 64, 32


def tf32(x):
    """Round f32 to TF32, to nearest with ties away: the kernel's `tf32`."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def truncate(x):
    """The TF32 part of f32 x as the tensor cores read it: the low 13 bits dropped."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, truncate(x - hi)  # x − hi is exact in f32


def wgmma(acc, a, b):
    """acc + a·b with one f32 rounding (a [M, 8] · b [8, N], exact products)."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def split_product(a, b, acc=None, passes=3):
    """a [M, K] · b [K, N] in the kernel's order: the small products over
    every k8 step, then the large ones. passes=1 is one TF32 pass."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32) if acc is None else acc
    steps = [slice(k, k + 8) for k in range(0, a.shape[1], 8)]
    if passes == 3:
        for ks in steps:
            acc = wgmma(acc, al[:, ks], bh[ks])
            acc = wgmma(acc, ah[:, ks], bl[ks])
    for ks in steps:
        acc = wgmma(acc, ah[:, ks], bh[ks])
    return acc


def kernel_model(q, k, v, scale, causal=False, shift=0, passes=3):
    """(o, lse) of one (batch·head) as the kernel computes them: q [Sq, D],
    k, v [Skv, D] f32; causal keeps (i, j) iff j <= i + shift."""
    s_q, s_kv = q.shape[0], k.shape[0]
    rows_a_block, keys_a_tile = plan(q.shape[1])[:2]
    c = np.float32(abs(scale)) * LOG2E
    q = np.float32(np.sign(scale) or 1.0) * q
    rows = np.arange(s_q)
    v1 = np.concatenate([v, np.ones((s_kv, 1), np.float32)], 1)
    acc = np.zeros((s_q, v1.shape[1]), np.float32)  # O and, last, the row sum l
    m = np.full(s_q, -1e30, np.float32)
    for row0 in range(0, s_q, rows_a_block):
        kend = min(max(row0 + rows_a_block + shift, 0), s_kv) if causal else s_kv
        blk = slice(row0, row0 + rows_a_block)
        for kt in range(0, kend, keys_a_tile):
            s = split_product(q[blk], k[kt:kt + keys_a_tile].T, passes=passes)
            keep = np.ones(s.shape, bool)
            if causal:
                keep = (kt + np.arange(keys_a_tile))[None, :] <= rows[blk, None] + shift
            s = np.where(keep, s, -np.inf).astype(np.float32)
            mn = np.maximum(m[blk], (s.max(1) * c).astype(np.float32))
            corr = np.exp2(m[blk] - mn).astype(np.float32)
            x = (s.astype(np.float64) * c - mn[:, None]).astype(np.float32)  # one FFMA
            p = np.where(keep, np.exp2(x), 0.0).astype(np.float32)
            pv = split_product(p, v1[kt:kt + keys_a_tile], passes=passes)  # P·[V | 1]
            acc[blk] = (acc[blk].astype(np.float64) * corr[:, None] + pv).astype(np.float32)  # one FFMA
            m[blk] = mn
    o, l = acc[:, :-1], acc[:, -1]
    live = l > 0
    inv = np.where(live, 1.0 / np.where(live, l, 1.0), 0.0).astype(np.float32)
    lse = np.where(live, m.astype(np.float64) * LN2 + np.log(np.where(live, l, 1.0)), -1e30).astype(np.float32)
    return (o * inv[:, None]).astype(np.float32), lse


def reference(q, k, v, scale, causal=False, shift=0):
    """float64 attention: (o, lse), rows that see no key o = 0, lse = −1e30."""
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) * scale
    keep = np.ones(s.shape, bool)
    if causal:
        keep = np.arange(k.shape[0])[None, :] <= np.arange(q.shape[0])[:, None] + shift
    s = np.where(keep, s, -np.inf)
    live = keep.any(1)
    mx = np.where(live, s.max(1), 0.0)
    p = np.exp(s - mx[:, None])
    l = np.where(live, p.sum(1), 1.0)
    o = np.where(live[:, None], (p @ v.astype(np.float64)) / l[:, None], 0.0)
    return o, np.where(live, mx + np.log(l), -1e30)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _qkv(s_q, s_kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(s_q, d)).astype(np.float32), rng.normal(size=(s_kv, d)).astype(np.float32),
            rng.normal(size=(s_kv, d)).astype(np.float32))


def test_split_is_two_tf32_values_within_2pow21():
    x = np.random.default_rng(0).normal(size=100_000).astype(np.float32) * np.float32(1e3)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()  # low 13 bits clear: TF32
    err = np.abs(x.astype(np.float64) - hi - lo) / np.abs(x.astype(np.float64))
    assert err.max() <= 2.0 ** -21
    assert tf32(np.float32(1 + 2 ** -11)) == np.float32(1 + 2 ** -10)  # a tie rounds away from zero


# (s_q, s_kv, causal, shift): the aligned causal forward, the non-causal
# rectangular one, and causal on offsets (rows with no key, shifts off the
# 128-row block and the 64-key tile grids)
CASES = [(256, 256, True, 0), (256, 256, False, 0), (128, 384, True, 192), (256, 256, True, -64), (128, 256, True, 37)]


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s_q,s_kv,causal,shift", CASES)
def test_split_tf32_forward_within_1e6_of_float64(d, s_q, s_kv, causal, shift):
    q, k, v = _qkv(s_q, s_kv, d, seed=d + s_q + shift)
    scale = 1.0 / np.sqrt(d)
    o, lse = kernel_model(q, k, v, scale, causal, shift)
    o_ref, lse_ref = reference(q, k, v, scale, causal, shift)
    live = lse_ref > -1e29
    assert _rel(o, o_ref) <= 1e-6
    assert _rel(lse[live], lse_ref[live]) <= 1e-6
    assert (o[~live] == 0).all() and (lse[~live] == np.float32(-1e30)).all()


@pytest.mark.parametrize("d", [16, 64])
def test_one_tf32_pass_misses_the_forward_gate(d):
    q, k, v = _qkv(128, 256, d, seed=d)
    o_ref, _ = reference(q, k, v, 0.25)
    assert _rel(kernel_model(q, k, v, 0.25, passes=1)[0], o_ref) > 1e-5
    assert _rel(kernel_model(q, k, v, 0.25)[0], o_ref) <= 1e-6


def test_negative_scale_folds_into_q():
    q, k, v = _qkv(128, 128, 16, seed=3)
    o, lse = kernel_model(q, k, v, -0.3, True, 0)
    o_ref, lse_ref = reference(q, k, v, -0.3, True, 0)
    assert _rel(o, o_ref) <= 1e-6 and _rel(lse, lse_ref) <= 1e-6


def cidx(rows, r, c):
    """The kernel's `cidx<R>`: float index of (r, c) in wgmma's K-major layout without swizzle."""
    return (((c >> 2) * (rows >> 3) + (r >> 3)) << 5) + ((r & 7) << 2) + (c & 3)


@pytest.mark.parametrize("rows", [16, 32, 64, 128, 136])
def test_operand_layout_matches_the_descriptor_strides(rows):
    # wgmma reads (r, c) of a k8 step at start + (c // 4)·LBO + (r // 8)·SBO + (r % 8)·16 + (c % 4)·4
    # bytes, with the kernel's LBO = rows/8 · 128 and SBO = 128
    lbo, sbo = rows // 8 * 128, 128
    r, c = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    for ks in range(4):
        start = 4 * cidx(rows, 0, 8 * ks)
        addr = start + (c // 4) * lbo + (r // 8) * sbo + (r % 8) * 16 + (c % 4) * 4
        assert (addr == 4 * cidx(rows, r, 8 * ks + c)).all()
    idx = cidx(rows, *np.meshgrid(np.arange(rows), np.arange(64), indexing="ij"))
    assert np.unique(idx).size == rows * 64 and idx.max() == rows * 64 - 1  # a permutation


def test_p_fragment_and_vt_key_order_give_p_times_v():
    # the S accumulator gives thread (g, t) of warp w rows 16w + g (+8) and keys 8j + 2t (+1); the
    # TF32 A fragment takes (row, position) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); the
    # kernel hands {d[4j], d[4j+2], d[4j+1], d[4j+3]} and stores key kappa of Vᵀ at position
    # (kappa & ~7) | ((kappa & 7) >> 1) | ((kappa & 1) << 2)
    rng = np.random.default_rng(1)
    p, v = rng.random((64, 64)), rng.normal(size=(64, 16))
    a = np.zeros((64, 64))
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            ra, rb = 16 * w + g, 16 * w + g + 8
            for j in range(8):
                d = [p[ra, 8 * j + 2 * t], p[ra, 8 * j + 2 * t + 1], p[rb, 8 * j + 2 * t], p[rb, 8 * j + 2 * t + 1]]
                frag = (d[0], d[2], d[1], d[3])
                for (row, pos), val in zip(((ra, t), (rb, t), (ra, t + 4), (rb, t + 4)), frag):
                    a[row, 8 * j + pos] = val
    kappa = np.arange(64)
    pos = (kappa & ~7) | ((kappa & 7) >> 1) | ((kappa & 1) << 2)
    vt = np.zeros((16, 64))
    vt[:, pos] = v.T
    np.testing.assert_allclose(a @ vt.T, p @ v, rtol=1e-12)


# ---------------------------------------------------------------------------
# The backward (`flash_bwd_dq_tc`, `flash_bwd_dkv_tc`, both families): the
# same split TF32, each of S, dP, dq += dS·K, dv += Pᵀ·dO and dk += dSᵀ·Q
# three passes, P = 2^(s·c − lse·log2 e) with c = scale·log2 e in one FFMA (a
# row that saw no key gets lse·log2 e = +inf, so P = 0), dS = P ∘ (dP −
# delta); the non-causal instances sum dq, dk and dv over every streamed
# tile in one accumulator, the causal ones sum each tile's product apart and
# add it to the running sum in f32.
# ---------------------------------------------------------------------------




def lse2(lse):
    """The kernels' `lse2`: lse in units of log2, +inf for a row that saw no key."""
    lse = np.asarray(lse, np.float32)
    return np.where(lse > np.float32(-0.5e30), lse * LOG2E, np.inf).astype(np.float32)


def _p(s, c, l2, keep):
    """P from the f32 scores: one FFMA, then exp2; exactly 0 where not kept."""
    p = np.exp2((s.astype(np.float64) * c - l2).astype(np.float32)).astype(np.float32)
    return np.where(keep, p, np.float32(0.0)).astype(np.float32)


def dq_model(q, k, v, do, lse, delta, scale, causal=False, shift=0, passes=3):
    """dq of one (batch·head) as `flash_bwd_dq_tc` computes it."""
    s_q, d = q.shape
    s_kv = k.shape[0]
    rows_a_block, _, t, _ = plan(d)
    c = np.float32(scale) * LOG2E
    l2 = lse2(lse)
    rows = np.arange(s_q)
    dq = np.zeros((s_q, d), np.float32)
    for row0 in range(0, s_q, rows_a_block):
        blk = slice(row0, row0 + rows_a_block)
        kend = min(max(row0 + rows_a_block + shift, 0), s_kv) if causal else s_kv
        acc = np.zeros((rows_a_block, d), np.float32)
        for kt in range(0, kend, t):
            keys = slice(kt, kt + t)
            s = split_product(q[blk], k[keys].T, passes=passes)
            dp = split_product(do[blk], v[keys].T, passes=passes)
            keep = (kt + np.arange(t))[None, :] <= rows[blk, None] + shift if causal else True
            p = _p(s, c, l2[blk, None], keep)
            ds = p * (dp - delta[blk, None])
            if causal:  # the tile's dS·K summed apart, then one f32 add
                acc = (acc + split_product(ds, k[keys], passes=passes)).astype(np.float32)
            else:
                acc = split_product(ds, k[keys], acc, passes)
        dq[blk] = acc * np.float32(scale)
    return dq


def dkv_model(q, k, v, do, lse, delta, scale, causal=False, shift=0, passes=3):
    """(dk, dv) of one (batch·head) as `flash_bwd_dkv_tc` computes them: Sᵀ
    and dPᵀ with the keys as rows, the queries' lse and delta per column."""
    s_q, d = q.shape
    s_kv = k.shape[0]
    rows_a_block, _, _, t = plan(d)
    c = np.float32(scale) * LOG2E
    l2 = lse2(lse)
    keys = np.arange(s_kv)
    dk, dv = np.zeros((s_kv, d), np.float32), np.zeros((s_kv, d), np.float32)
    for key0 in range(0, s_kv, rows_a_block):
        blk = slice(key0, key0 + rows_a_block)
        qt0 = min(max(key0 - shift, 0), s_q) // t * t if causal else 0
        dka, dva = np.zeros((rows_a_block, d), np.float32), np.zeros((rows_a_block, d), np.float32)
        for qt in range(qt0, s_q, t):
            qs = slice(qt, qt + t)
            st = split_product(k[blk], q[qs].T, passes=passes)
            dpt = split_product(v[blk], do[qs].T, passes=passes)
            keep = keys[blk, None] <= (qt + np.arange(t))[None, :] + shift if causal else True
            p = _p(st, c, l2[None, qs], keep)
            ds = p * (dpt - delta[None, qs])
            if causal:  # each product of the tile summed apart (64 columns at a time at D 128), then one f32 add
                dva = (dva + split_product(p, do[qs], passes=passes)).astype(np.float32)
                dka = (dka + split_product(ds, q[qs], passes=passes)).astype(np.float32)
            else:
                dva = split_product(p, do[qs], dva, passes)
                dka = split_product(ds, q[qs], dka, passes)
        dk[blk], dv[blk] = dka * np.float32(scale), dva
    return dk, dv


def bwd_reference(q, k, v, do, lse, delta, scale, causal=False, shift=0):
    """float64 (dq, dk, dv) from the same f32 inputs; P = 0 off the mask and on
    rows whose lse is −1e30."""
    q, k, v, do, lse, delta = (np.asarray(x, np.float64) for x in (q, k, v, do, lse, delta))
    keep = np.broadcast_to(lse[:, None] > -0.5e30, (q.shape[0], k.shape[0]))
    if causal:
        keep = keep & (np.arange(k.shape[0])[None, :] <= np.arange(q.shape[0])[:, None] + shift)
    p = np.exp(np.where(keep, (q @ k.T) * scale - lse[:, None], -np.inf))
    ds = p * (do @ v.T - delta[:, None])
    return ds @ k * scale, ds.T @ q * scale, p.T @ do


def _bwd_inputs(s_q, s_kv, d, scale, causal, shift, seed):
    """q, k, v, dO and the forward's lse and delta = rowsum(dO ∘ o), all f32."""
    q, k, v = _qkv(s_q, s_kv, d, seed)
    do = np.random.default_rng(seed + 1).normal(size=(s_q, d)).astype(np.float32)
    o, lse = reference(q, k, v, scale, causal, shift)
    delta = (do * o.astype(np.float32)).sum(1, dtype=np.float32)
    return q, k, v, do, lse.astype(np.float32), delta


def _bwd(q, k, v, do, lse, delta, scale, causal=False, shift=0, passes=3):
    return (dq_model(q, k, v, do, lse, delta, scale, causal, shift, passes),
            *dkv_model(q, k, v, do, lse, delta, scale, causal, shift, passes))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s_q,s_kv,causal,shift", CASES)
def test_split_tf32_backward_within_1e5_of_float64(d, s_q, s_kv, causal, shift):
    scale = 1.0 / np.sqrt(d)
    inputs = _bwd_inputs(s_q, s_kv, d, scale, causal, shift, seed=d + s_q + shift)
    got = _bwd(*inputs, scale, causal, shift)
    for a, b in zip(got, bwd_reference(*inputs, scale, causal, shift)):
        assert _rel(a, b) <= 1e-5
    dead = inputs[4] < -1e29
    assert (got[0][dead] == 0).all()  # rows that saw no key: dq exactly 0


def test_aligned_causal_backward_at_the_lm_length_within_1e6_of_float64():
    # the LM's S = 2048 at D = 16, each tile's products summed apart: one
    # (batch·head) of the aligned causal backward
    inputs = _bwd_inputs(2048, 2048, 16, 0.25, True, 0, seed=2048)
    for a, b in zip(_bwd(*inputs, 0.25, True, 0), bwd_reference(*inputs, 0.25, True, 0)):
        assert _rel(a, b) <= 1e-6


@pytest.mark.parametrize("d", [16, 64])
def test_one_tf32_pass_misses_the_gradient_gate(d):
    inputs = _bwd_inputs(128, 256, d, 0.25, False, 0, seed=d)
    want = bwd_reference(*inputs, 0.25)
    one, three = _bwd(*inputs, 0.25, passes=1), _bwd(*inputs, 0.25)
    assert max(_rel(a, b) for a, b in zip(one, want)) > 1e-4
    assert max(_rel(a, b) for a, b in zip(three, want)) <= 1e-5


def test_backward_takes_a_negative_scale_as_it_stands():
    inputs = _bwd_inputs(128, 128, 16, -0.3, True, 0, seed=3)
    for a, b in zip(_bwd(*inputs, -0.3, True, 0), bwd_reference(*inputs, -0.3, True, 0)):
        assert _rel(a, b) <= 1e-5


def _transposed_operand(x, d, t):
    """The kernels' `split_both` second pass: x [t, d] row-major into its
    transpose in operand layout (d rows by t positions, rows 0, 2, 4, 6, 1, 3,
    5, 7 of every 8), one 4-position chunk a thread."""
    out = np.zeros(d * t)
    for i in range(t * d // 4):
        dd, pg = i % d, i // d
        r0 = (pg >> 1) * 8 + (pg & 1)
        for m in range(4):
            out[cidx(d, dd, 4 * pg + m)] = x[r0 + 2 * m, dd]
    return out


def _a_fragments(x, t):
    """The A fragments the kernels hand `rs_split` from a [64, t] accumulator x:
    thread (g, t) of warp w holds x[16w + g (+8), 8j + 2t + e] as xs[4j + e]
    (+2), passed as {xs[4j], xs[4j+2], xs[4j+1], xs[4j+3]} to the fragment
    positions (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    frags = np.zeros((t // 8, 64, 8))
    for w in range(4):
        for lane in range(32):
            g, tt = lane // 4, lane % 4
            ra, rb = 16 * w + g, 16 * w + g + 8
            for j in range(t // 8):
                xs = [x[ra, 8 * j + 2 * tt], x[ra, 8 * j + 2 * tt + 1], x[rb, 8 * j + 2 * tt], x[rb, 8 * j + 2 * tt + 1]]
                frag = (xs[0], xs[2], xs[1], xs[3])
                for (row, pos), val in zip(((ra, tt), (rb, tt), (ra, tt + 4), (rb, tt + 4)), frag):
                    frags[j, row, pos] = val
    return frags


@pytest.mark.parametrize("d,t", [(16, 64), (32, 64), (64, 32), (128, 16), (16, 32), (32, 32)])
def test_transposed_operands_meet_the_register_fragments(d, t):
    # dq += dS·K against Kᵀ (t = the dq tile), and dv += Pᵀ·dO, dk += dSᵀ·Q
    # against dOᵀ, Qᵀ (t = the dk/dv tile), the same arithmetic: each k8 step
    # j reads the transposed operand through a descriptor at 32·D·j bytes
    # with LBO = D/8 · 128 and SBO = 128, and the S/dP operands at 32·R·ks
    # bytes for R rows, as the kernels write them
    rng = np.random.default_rng(d)
    ds, k = rng.normal(size=(64, t)), rng.normal(size=(t, d))
    kt = _transposed_operand(k, d, t)
    lbo, sbo = d // 8 * 128, 128
    n, c = np.meshgrid(np.arange(d), np.arange(8), indexing="ij")
    got = np.zeros((64, d))
    for j, a in enumerate(_a_fragments(ds, t)):
        start = 32 * d * j
        assert start == 4 * cidx(d, 0, 8 * j)
        b = kt[(start + (c // 4) * lbo + (n // 8) * sbo + (n % 8) * 16 + (c % 4) * 4) // 4]  # [d, 8]
        got += a @ b.T
    np.testing.assert_allclose(got, ds @ k, rtol=1e-12, atol=1e-9)
    for rows in (64, t):
        for ks in range(d // 8):
            assert 32 * rows * ks == 4 * cidx(rows, 0, 8 * ks)


@pytest.mark.parametrize("rows", [128, 136])
def test_wide_products_split_at_row_64(rows):
    # an N = 128 product from registers (dq's and dk/dv's at D 128) and the
    # forward's P·[V | 1 | 0] at D 128 (N = 136) are an m64n64 product on
    # rows 0 … 63 and one of the rest from row 64, through the same
    # descriptor plus 64 units (1 KB): row 64's first column sits 1 KB past
    # row 0's in every k8 step, and the two halves together read every row
    for ks in range(16):
        assert 4 * (cidx(rows, 64, 8 * ks) - cidx(rows, 0, 8 * ks)) == 64 * 16
    lbo, sbo = rows // 8 * 128, 128
    n, c = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    base, rel = np.where(n < 64, 0, 1024), np.where(n < 64, n, n - 64)  # the half's start, the row within it
    addr = base + (c // 4) * lbo + (rel // 8) * sbo + (rel % 8) * 16 + (c % 4) * 4
    assert (addr == 4 * cidx(rows, n, c)).all()
