// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package's ops/flash_attention.py
// under its `_flash3` custom VJP. Tensors are f32 and contiguous: q (and
// dO) [BH, Sq, D], k, v [BH, Skv, D], lse and delta [BH, Sq]. Two families:
//
//   aligned causal (Sq = Skv, shift 0; the path of
//   `flash_attention(..., causal=True)`, the LM)
//     _fwd_tri     :559 (_fwd_kernel_tri :253)      -> flash_fwd_launch      -> flash_fwd_tc<D, true>
//     _bwd_tri dq  :655 (_bwd_dq_kernel_tri :341)   -> flash_bwd_dq_launch   -> flash_bwd_dq_tc<D, true>
//     _bwd_tri dkv :673 (_bwd_dkv_kernel_tri :365)  -> flash_bwd_dkv_launch  -> flash_bwd_dkv_tc<D, true>
//   rectangular, non-causal or causal on global offsets (q_off, k_off)
//   (the path of `flash_attention(..., causal=False)`, the ViT, and of
//   `flash_block`)
//     _fwd         :601 (_fwd_kernel :395)          -> flash_fwd_rect_launch      -> flash_fwd_tc<D, ·>
//     _flash3_bwd  :721 (_bwd_dq_kernel :436)       -> flash_bwd_dq_rect_launch   -> flash_bwd_dq_tc<D, ·>
//     _flash3_bwd  :744 (_bwd_dkv_kernel :461)      -> flash_bwd_dkv_rect_launch  -> flash_bwd_dkv_tc<D, ·>
//
// o = softmax(q kᵀ·scale [, causal]) v with the natural-log row logsumexp
// lse; dq = scale · Σ_j dS_ij k_j, dv = Σ_i P_ijᵀ dO_i, dk = scale ·
// Σ_i dS_ijᵀ q_i with dS = P ∘ (dO vᵀ − delta), P recomputed from
// (q, k, lse) and delta = rowsum(dO ∘ o) formed by the caller.
//
// Forward: one kernel for both families (`flash_fwd_tc`); the aligned
// forward is the rectangular one with Sq = Skv and shift 0.
//   Bound on an H100 SXM. The TPU kernels' dots are f32 at
//   Precision.HIGHEST (several MXU passes). Here each product runs on the
//   tensor cores in split TF32: x = hi + lo with hi = tf32(x) rounded to
//   nearest and lo = x − hi, of which the tensor cores read the TF32 part
//   (they truncate f32 operands), a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b
//   summed in f32 (each operand kept to 2^-21 of itself, no lo·lo term).
//   Three products at 495 TFLOP/s: at the ViT path's shape (BH = 6144, S = 256,
//   D = 16, non-causal: 4.0e8 pairs, 25.8 GFLOP) 0.16 ms, against 0.10 ms
//   for the exps (16 a clock per SM) and 0.12 ms for the bytes; at the LM
//   path's (BH = 128, S = 2048, causal: 2.7e8 pairs) 0.10 ms. An f32 FFMA
//   design is held to 67 TFLOP/s there: 0.385 and 0.257 ms.
//   Design:
//   * A block owns 128 query rows of one (batch·head) as two consumer
//     warpgroups of 64 rows (256 threads). Q is split into hi/lo in shared
//     memory once.
//   * K and V stream in tiles of 64 keys through a ring of two stages
//     filled by cp.async: tile t + 2 is in flight while tiles t and t + 1
//     are computed. After a tile lands the block forms K's hi/lo and Vᵀ's
//     hi/lo in shared memory (TF32 wgmma reads only K-major operands, so V
//     is stored transposed).
//   * S = Q·Kᵀ: three m64n64k8 wgmmas for each 8 columns of D, both
//     operands in shared memory without swizzle (core matrices of 8 rows by
//     16 bytes).
//   * Online softmax on the accumulator fragments: row max over the quad of
//     threads that holds a row, exp2 with log2(e) folded into the scale (one
//     FFMA a score). m starts at the finite −1e30 and masked scores give
//     p = 0 exactly.
//   * P·[V | 1] with P split in registers as the A operand: Vᵀ carries a row
//     of ones, so the row sum l comes out of the tensor cores beside O (as
//     `_augmented_v` :527 does on the TPU) instead of 32 adds a thread and
//     tile. The
//     accumulator gives a thread keys {2t, 2t+1} of every 8 where the TF32 A
//     fragment takes contraction positions {t, t+4}; Vᵀ's keys are permuted
//     the same way in shared memory, so the product is unchanged. Each
//     tile's product sums in a fresh accumulator and joins O and l in FFMAs
//     (·corr + P·[V | 1]): the tensor cores' sums, whose error grows with the
//     terms they add, span one tile and not the whole row.
//   * The instructions each warp runs a tile, not the tensor cores, limit
//     it, so the loop keeps them few: the TF32 rounding is two integer
//     operations (cvt.rna.tf32.f32 lowers to compares and selects), and
//     descriptors are a base plus a constant.
//   * Causal: a block reads keys below `key_end`; a warpgroup skips tiles
//     wholly in its future and masks only tiles across its diagonal; the
//     non-causal instances carry no compare. Causal blocks launch heaviest
//     first.
//   * Each output row is summed by one thread quad in a fixed order: no
//     atomics, bitwise repeatable. A row that saw no key (l = 0) stores
//     o = 0 and lse = −1e30 exactly (`_fwd_kernel` :428-433).
//
// Backward, both families: dq (`flash_bwd_dq_tc`) and dk/dv (`flash_bwd_dkv_tc`)
// on the tensor cores, in the forward's split TF32 (lo·hi + hi·lo + hi·hi).
//   Bound on an H100 SXM: dq's three products (S, dP, dS·K) and dk/dv's four
//   (S, dP, Pᵀ·dO, dSᵀ·Q) at 2·D flops a pair each, three TF32 passes at
//   495 TFLOP/s: at the ViT path's 4.0e8 non-causal pairs (BH = 6144,
//   S = 256, D = 16) 0.234 and 0.312 ms, against 0.10 ms for the exps and
//   0.15 and 0.18 ms for the bytes; at the LM path's causal triangle
//   (BH = 128, S = 2048: 2.7e8 pairs) 0.156 and 0.208 ms. An f32 FFMA
//   design is held to 0.577 and 0.769 ms (ViT), 0.385 and 0.513 ms (LM).
//   Design (the forward's building blocks):
//   * A block owns 128 rows as two warpgroups of 64: query rows for dq, key
//     rows for dk/dv. Its own operands (Q and dO; K and V) are split into
//     hi/lo in shared memory once, as the A operands of S = Q·Kᵀ and
//     dP = dO·Vᵀ (Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for dk/dv).
//   * The other side streams through a two-stage cp.async ring: dq in
//     tiles of 64 keys (32 at D = 64, to stay within 227 KB of shared
//     memory), dk/dv in tiles of 32 queries (so that its two split register
//     operands fit in 128 registers together).
//     After a tile lands the block forms its hi/lo in operand layout (the B
//     operands of S and dP) and, of the tile that meets the register
//     operand, its transpose's hi/lo with the rows of every 8 stored as
//     0, 2, 4, 6, 1, 3, 5, 7 (Kᵀ for dq; Qᵀ and dOᵀ for dk/dv).
//   * P = 2^(s·scale·log2 e − lse·log2 e), one FFMA and an exp2 on the
//     accumulator fragments; dS = P ∘ (dP − delta). For dq a thread's two
//     rows carry their lse and delta in registers; for dk/dv the fragment's
//     columns are queries, whose lse and delta are read from shared memory.
//     A row that saw no key (lse = −1e30) carries lse·log2 e = +inf, so its
//     P is exactly 0 without a select.
//   * dS (dq += dS·K), Pᵀ (dv += Pᵀ·dO) and dSᵀ (dk += dSᵀ·Q) are split in
//     registers and fed as the A operand from registers of m64nDk8 wgmmas:
//     the accumulator's columns {2t, 2t+1} of every 8 meet the fragment's
//     positions {t, t+4}, which the transposed operand's order matches.
//     The non-causal instances sum the gradients over every tile in the
//     tensor cores' accumulator. The causal ones, which serve the LM's rows
//     of up to S = 2048 keys or queries, sum each tile's product in a fresh
//     accumulator and add it to the running sum in f32, as the forward does
//     for O. Summed over every tile in the tensor cores, dk and dv drifted
//     from float64 in proportion to S (up to 3.1e-5 of the largest entry at
//     S = 2048, 5.7e-5 at 4096, on an H100) and moved the LM's L-BFGS steps
//     by 1.8e-3; tile by tile they stay within 1e-6. There dk/dv issues its
//     two products one after the other, so that one partial sum and one
//     split operand are live at a time.
//   * Causal: a block reads only the tiles that can see it (`key_end` for
//     dq, from `qt0` for dk/dv); a warpgroup skips tiles wholly outside its
//     triangle and masks, by select, only tiles across its diagonal. Causal
//     blocks launch heaviest first: late query blocks for dq, early key
//     blocks for dk/dv.
//   * Each output row is summed by one warpgroup in a fixed order: no
//     atomics, bitwise repeatable.
//
// The aligned causal backward is the same two kernels at Sq = Skv and
// shift 0, as the aligned forward is `flash_fwd_tc` at shift 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace {

constexpr int kRows = 128;  // rows a block owns

bool shape_ok(int bh, int s) { return bh >= 1 && bh <= 65535 && s >= kRows && s % kRows == 0; }

// ---------------------------------------------------------------------------
// The rectangular family: q [BH, Sq, D] against k, v [BH, Skv, D], either
// non-causal (every query sees every key) or causal on global positions:
// query row i sits at q_off + i, key row j at k_off + j, and the pair is
// kept iff k_off + j <= q_off + i, i.e. j <= i + shift with
// shift = q_off − k_off. A row may then see no key at all (a block in its
// future, or an unaligned shift); it gets o = 0, lse = −1e30 and P = 0 in
// the backward, as the TPU kernels' masked-row guards give.
// ---------------------------------------------------------------------------

// keys [0, kend) can be seen by a query block whose last row is row0 + kRows − 1
__device__ __forceinline__ int key_end(int row0, int shift, int s_kv) {
  return min(max(row0 + kRows + shift, 0), s_kv);
}

bool rect_shape_ok(int bh, int s_q, int s_kv) { return shape_ok(bh, s_q) && shape_ok(bh, s_kv); }

// ---------------------------------------------------------------------------
// The tensor-core kernels: the forward and the backward of both families
// (see the notes at the top).
// ---------------------------------------------------------------------------
namespace tc {

using namespace tf32_wgmma;

constexpr int kWarpgroups = 2;               // consumer warpgroups a block, 64 query rows each
constexpr int kThreads = 128 * kWarpgroups;  // kRows query rows a block
constexpr int kKeys = 64;                    // keys a K/V tile
constexpr int kStages = 2;                   // depth of the K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// P·[V | 1 | 0]: the D + 8 columns of Vᵀ's operand (see Smem)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[(D + 8) / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (D == 16) {
    wgmma_rs_n24(d, a, b, accumulate);
  } else if constexpr (D == 32) {
    wgmma_rs_n40(d, a, b, accumulate);
  } else {
    wgmma_rs_n72(d, a, b, accumulate);
  }
}

template <int D>
struct Smem {
  float q_hi[kRows * D], q_lo[kRows * D];  // per warpgroup a 64-row operand
  float raw[kStages][2][kKeys * D];        // landed tiles: K (operand layout) and V (row-major)
  float k_hi[kKeys * D], k_lo[kKeys * D];  // operand layout, 64 rows (keys) by D
  // Vᵀ: D + 8 rows by 64 permuted keys; rows D … D + 7 hold [1 | 0] (ones in
  // row D of hi), so that P·V's column D is P's row sum
  float vt_hi[(D + 8) * kKeys], vt_lo[(D + 8) * kKeys];
};

template <int D>
constexpr int kTileChunks = kKeys * D / 4 / kThreads;  // 16-byte chunks of a K or V tile a thread moves

// cp.async of keys [kt, kt + kKeys) of K and V into ring stage `st`
template <int D>
__device__ __forceinline__ void load_kv(Smem<D>& sm, int st, const float* kb, const float* vb, int kt) {
  const float* kt_b = kb + (size_t)kt * D;
  const float* vt_b = vb + (size_t)kt * D;
#pragma unroll
  for (int n = 0; n < kTileChunks<D>; ++n) {
    const unsigned i = threadIdx.x + n * kThreads;  // chunk i: row i / (D/4), columns 4·(i % (D/4)) + 0..3
    cp_async16(&sm.raw[st][0][cidx<kKeys>(i / (D / 4), i % (D / 4) * 4)], kt_b + 4 * i);
    cp_async16(&sm.raw[st][1][4 * i], vt_b + 4 * i);
  }
}

// The landed stage `st` into the split operands: K's hi/lo at the same
// operand-layout index, and Vᵀ's hi/lo with the keys of every 8 in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (contraction position t holds key 2t, t + 4 key 2t + 1).
template <int D>
__device__ __forceinline__ void split_kv(Smem<D>& sm, int st) {
  const float4* kr = reinterpret_cast<const float4*>(sm.raw[st][0]);
#pragma unroll
  for (int n = 0; n < kTileChunks<D>; ++n) {
    const unsigned i = threadIdx.x + n * kThreads;
    float4 hi, lo;
    split4(kr[i], hi, lo);
    reinterpret_cast<float4*>(sm.k_hi)[i] = hi;
    reinterpret_cast<float4*>(sm.k_lo)[i] = lo;
  }
  const float* vr = sm.raw[st][1];
#pragma unroll
  for (int n = 0; n < kTileChunks<D>; ++n) {
    const unsigned i = threadIdx.x + n * kThreads;
    const unsigned d = i % D, pg = i / D;          // positions 4pg … 4pg + 3 of Vᵀ's row d
    const unsigned key0 = (pg >> 1) * 8 + (pg & 1);  // hold keys key0 + 0, 2, 4, 6
    float4 x = make_float4(vr[key0 * D + d], vr[(key0 + 2) * D + d], vr[(key0 + 4) * D + d],
                           vr[(key0 + 6) * D + d]);
    float4 hi, lo;
    split4(x, hi, lo);
    const unsigned at = cidx<D + 8>(d, 4 * pg);
    *reinterpret_cast<float4*>(&sm.vt_hi[at]) = hi;
    *reinterpret_cast<float4*>(&sm.vt_lo[at]) = lo;
  }
}

// Forward of q [BH, Sq, D] against k, v [BH, Skv, D]; causal keeps the pair
// (i, j) iff j <= i + shift. Grid (Sq / kRows, BH), kThreads threads,
// sizeof(Smem<D>) bytes of dynamic shared memory; two blocks an SM up to
// D = 32 (at most 128 registers a thread).
template <int D, bool Causal>
__global__ void __launch_bounds__(kThreads, D == 64 ? 1 : 2)
flash_fwd_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ o, float* __restrict__ lse, int s_q, int s_kv, int shift, float scale) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_bytes);
  const int bh = blockIdx.y;
  const int row0 = (Causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;  // causal: heaviest first
  const float* kb = k + (size_t)bh * s_kv * D;
  const float* vb = v + (size_t)bh * s_kv * D;
  const int kend = Causal ? key_end(row0, shift, s_kv) : s_kv;
  const int n_tiles = (kend + kKeys - 1) / kKeys;  // tiles past s_kv are never read: s_kv % kRows == 0

#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles) load_kv<D>(sm, st, kb, vb, st * kKeys);
    cp_async_commit();
  }
  // Q's hi/lo, its sign folded in so that the kernel scales by |scale|
  const float sgn = scale < 0.f ? -1.f : 1.f;
  const float4* qb = reinterpret_cast<const float4*>(q + ((size_t)bh * s_q + row0) * D);
#pragma unroll
  for (int n = 0; n < 2 * kTileChunks<D>; ++n) {
    const unsigned i = threadIdx.x + n * kThreads, r = i / (D / 4);
    float4 x = __ldg(qb + i), hi, lo;
    x = make_float4(sgn * x.x, sgn * x.y, sgn * x.z, sgn * x.w);
    split4(x, hi, lo);
    const unsigned at = r / 64 * 64 * D + cidx<64>(r % 64, i % (D / 4) * 4);
    *reinterpret_cast<float4*>(&sm.q_hi[at]) = hi;
    *reinterpret_cast<float4*>(&sm.q_lo[at]) = lo;
  }
  for (unsigned i = threadIdx.x; i < 8 * kKeys; i += kThreads) {  // Vᵀ's rows D … D + 7
    const unsigned r = D + i / kKeys, at = cidx<D + 8>(r, i % kKeys);
    sm.vt_hi[at] = r == D ? 1.f : 0.f;
    sm.vt_lo[at] = 0.f;
  }
  proxy_fence();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = row0 + 64 * wg;                     // this warpgroup's first query row
  const int row_a = wrow0 + 16 * warp + g, row_b = row_a + 8;  // the two rows this thread holds
  // descriptor bases: shared address / 16 of the block's shared memory, and of this warpgroup's Q rows
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t q16 = base16 + 64 * D * 4 / 16 * wg;
  using S = Smem<D>;
  const float c = fabsf(scale) * kLog2e;  // p = 2^(s·c − m): m is in units of log2

  float acc[(D + 8) / 2];  // O and, in column D, the row sum l
#pragma unroll
  for (int i = 0; i < (D + 8) / 2; ++i) acc[i] = 0.f;
  float m_a = -1e30f, m_b = -1e30f;  // finite: m − m_new is never inf − inf

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 1>();  // this thread's copies of tile `it` have landed
    __syncthreads();               // everyone's; and the last tile's wgmmas are done
    split_kv<D>(sm, it % kStages);
    proxy_fence();
    __syncthreads();
    if (it + kStages < n_tiles) load_kv<D>(sm, it % kStages, kb, vb, (it + kStages) * kKeys);
    cp_async_commit();

    const int kt = it * kKeys;
    if (Causal && kt > wrow0 + 63 + shift) continue;  // wholly in this warpgroup's future

    // S = Q·Kᵀ, small products first. s[4j + e] is (row_a, key kt + 8j + 2t + e),
    // s[4j + 2 + e] the same key on row_b.
    float s[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint32_t at = 4 * 512 * ks;  // bytes to columns 8ks … 8ks + 7 of a 64-row operand
      wgmma_ss_n64(s, desc<64>(q16, offsetof(S, q_lo) + at), desc<kKeys>(base16, offsetof(S, k_hi) + at), ks > 0);
      wgmma_ss_n64(s, desc<64>(q16, offsetof(S, q_hi) + at), desc<kKeys>(base16, offsetof(S, k_lo) + at), 1);
    }
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      wgmma_ss_n64(s, desc<64>(q16, offsetof(S, q_hi) + 4 * 512 * ks),
                   desc<kKeys>(base16, offsetof(S, k_hi) + 4 * 512 * ks), 1);
    wg_commit();
    wg_wait();
    pin(s);

    const bool mask = Causal && kt + kKeys - 1 > wrow0 + shift;  // the tile crosses the diagonal
    if (mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt + 8 * j + 2 * t + e;
          if (key > row_a + shift) s[4 * j + e] = -INFINITY;
          if (key > row_b + shift) s[4 * j + 2 + e] = -INFINITY;
        }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * c), mn_b = fmaxf(m_b, mx_b * c);  // fmaxf drops a NaN
    const float corr_a = exp2_ftz(m_a - mn_a), corr_b = exp2_ftz(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = exp2_ftz(fmaf(s[4 * j + e], c, -mn_a));
        float pb = exp2_ftz(fmaf(s[4 * j + 2 + e], c, -mn_b));
        if (mask) {  // exactly 0, whatever the scale
          pa = s[4 * j + e] == -INFINITY ? 0.f : pa;
          pb = s[4 * j + 2 + e] == -INFINITY ? 0.f : pb;
        }
        s[4 * j + e] = pa;
        s[4 * j + 2 + e] = pb;
      }

    // The tile's P·[V | 1] into a fresh accumulator, small products first,
    // then O = O·corr + P·V (and l = l·corr + Σ P) in FFMAs: the tensor
    // cores' own sums then span one tile, not the whole row (their rounding
    // grows with the terms they add).
    // The A fragment of keys 8j … 8j + 7 is (row_a, pos t), (row_b, pos t),
    // (row_a, pos t + 4), (row_b, pos t + 4).
    uint32_t ph[32], pl[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      ph[i] = tf32(s[i]);
      pl[i] = __float_as_uint(s[i] - __uint_as_float(ph[i]));
    }
    pin(ph);
    pin(pl);
    float pv[(D + 8) / 2];
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t a_lo[4] = {pl[4 * j], pl[4 * j + 2], pl[4 * j + 1], pl[4 * j + 3]};
      const uint32_t a_hi[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
      wgmma_pv<D>(pv, a_lo, desc<D + 8>(base16, offsetof(S, vt_hi) + 32 * (D + 8) * j), j > 0);
      wgmma_pv<D>(pv, a_hi, desc<D + 8>(base16, offsetof(S, vt_lo) + 32 * (D + 8) * j), 1);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t a_hi[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
      wgmma_pv<D>(pv, a_hi, desc<D + 8>(base16, offsetof(S, vt_hi) + 32 * (D + 8) * j), 1);
    }
    wg_commit();
    wg_wait();
    pin(pv);
#pragma unroll
    for (int j = 0; j < (D + 8) / 8; ++j) {
      acc[4 * j] = fmaf(acc[4 * j], corr_a, pv[4 * j]);
      acc[4 * j + 1] = fmaf(acc[4 * j + 1], corr_a, pv[4 * j + 1]);
      acc[4 * j + 2] = fmaf(acc[4 * j + 2], corr_b, pv[4 * j + 2]);
      acc[4 * j + 3] = fmaf(acc[4 * j + 3], corr_b, pv[4 * j + 3]);
    }
  }

  // l: column D, held by the quad's thread t = 0
  const float l_a = __shfl_sync(0xffffffffu, acc[D / 2], lane & ~3);
  const float l_b = __shfl_sync(0xffffffffu, acc[D / 2 + 2], lane & ~3);
  // masked-row guard: a row that saw no key has l == 0 and acc == 0
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f, inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  float* oa = o + ((size_t)bh * s_q + row_a) * D + 2 * t;
  float* ob = o + ((size_t)bh * s_q + row_b) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(oa + 8 * j) = make_float2(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    *reinterpret_cast<float2*>(ob + 8 * j) = make_float2(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
  }
  if (t == 0) {
    lse[(size_t)bh * s_q + row_a] = l_a > 0.f ? fmaf(m_a, kLn2, logf(l_a)) : -1e30f;
    lse[(size_t)bh * s_q + row_b] = l_b > 0.f ? fmaf(m_b, kLn2, logf(l_b)) : -1e30f;
  }
}

// One launch of the forward; the cudaError_t of the launch.
template <int D, bool Causal>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q, int s_kv,
               int shift, float scale, cudaStream_t st) {
  constexpr int kSmem = sizeof(Smem<D>);
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc<D, Causal>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_tc<D, Causal><<<dim3(s_q / kRows, bh), kThreads, kSmem, st>>>(q, k, v, o, lse, s_q, s_kv, shift,
                                                                            scale);
  return (int)cudaGetLastError();
}

int fwd(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q, int s_kv, int d,
        bool causal, int shift, float scale, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d * 2 + (causal ? 1 : 0)) {
    case 32: return launch_fwd<16, false>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    case 33: return launch_fwd<16, true>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    case 64: return launch_fwd<32, false>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    case 65: return launch_fwd<32, true>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    case 128: return launch_fwd<64, false>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    case 129: return launch_fwd<64, true>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The backward on the tensor cores, both families (see the note at the top).
// ---------------------------------------------------------------------------

// rows of the streamed operand a backward tile. dq streams 64 keys, 32 at
// D = 64, where 64 would take the block past the 227 KB of shared memory it
// can have. dk/dv streams 32 queries: then its two products' split register
// operands (2 · 32 registers) fit beside the accumulators in the 128
// registers of two blocks an SM, and are issued together.
template <int D>
constexpr int kDqTile = D == 64 ? 32 : 64;
constexpr int kDkvTile = 32;

// acc (+)= A·Bᵀ over D columns in split TF32, small products first: A is this
// warpgroup's 64-row operand (descriptor base a16, hi/lo at byte offsets
// a_hi, a_lo), B an N-row operand (base b16, offsets b_hi, b_lo), both in
// shared memory. The first product overwrites acc.
template <int D, int N>
__device__ __forceinline__ void ss_split(float (&acc)[N / 2], uint32_t a16, uint32_t a_hi, uint32_t a_lo,
                                         uint32_t b16, uint32_t b_hi, uint32_t b_lo) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {  // bytes to columns 8ks … 8ks + 7: 32·R·ks for R rows
    wgmma_ss<N>(acc, desc<64>(a16, a_lo + 2048 * ks), desc<N>(b16, b_hi + 32 * N * ks), ks > 0);
    wgmma_ss<N>(acc, desc<64>(a16, a_hi + 2048 * ks), desc<N>(b16, b_lo + 32 * N * ks), 1);
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
    wgmma_ss<N>(acc, desc<64>(a16, a_hi + 2048 * ks), desc<N>(b16, b_hi + 32 * N * ks), 1);
}

// x's TF32 hi and the rest lo, in registers (pinned: the wgmmas read them)
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32(x[i]);
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
  pin(hi);
  pin(lo);
}

// acc (+)= X·B over T contraction positions in split TF32, small products
// first; with accumulate = 0 the first product overwrites acc. X is the
// [64 x T] accumulator of an earlier product, split into xh/xl:
// a thread holds its columns 8j + 2t + e, which the TF32 A fragment takes at
// positions {t, t + 4}; B (N rows by T positions, base b16, hi/lo at b_hi,
// b_lo) stores each 8 of its positions in the order 0, 2, 4, 6, 1, 3, 5, 7 to
// match, so the registers are the fragment as they stand.
template <int N, int T>
__device__ __forceinline__ void rs_split(float (&acc)[N / 2], const uint32_t (&xh)[T / 2],
                                         const uint32_t (&xl)[T / 2], uint32_t b16, uint32_t b_hi, uint32_t b_lo,
                                         int accumulate = 1) {
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
    const uint32_t a_lo[4] = {xl[4 * j], xl[4 * j + 2], xl[4 * j + 1], xl[4 * j + 3]};
    const uint32_t a_hi[4] = {xh[4 * j], xh[4 * j + 2], xh[4 * j + 1], xh[4 * j + 3]};
    wgmma_rs<N>(acc, a_lo, desc<N>(b16, b_hi + 32 * N * j), j > 0 || accumulate);
    wgmma_rs<N>(acc, a_hi, desc<N>(b16, b_lo + 32 * N * j), 1);
  }
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
    const uint32_t a_hi[4] = {xh[4 * j], xh[4 * j + 2], xh[4 * j + 1], xh[4 * j + 3]};
    wgmma_rs<N>(acc, a_hi, desc<N>(b16, b_hi + 32 * N * j), 1);
  }
}

// rows [row0, row0 + kRows) of a [S, D] matrix (src at row0) split into hi/lo
// in the operand layout of two 64-row operands, one a warpgroup
template <int D>
__device__ __forceinline__ void split_rows(float* hi, float* lo, const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int n = 0; n < kRows * D / 4 / kThreads; ++n) {
    const unsigned i = threadIdx.x + n * kThreads, r = i / (D / 4);
    float4 h, l;
    split4(__ldg(s4 + i), h, l);
    const unsigned at = r / 64 * 64 * D + cidx<64>(r % 64, i % (D / 4) * 4);
    *reinterpret_cast<float4*>(&hi[at]) = h;
    *reinterpret_cast<float4*>(&lo[at]) = l;
  }
}

// cp.async of T rows of a [S, D] matrix (src at the first) into dst: row-major,
// or in the operand layout of a T-row operand
template <int D, int T, bool Operand>
__device__ __forceinline__ void load_rows(float* dst, const float* src) {
#pragma unroll
  for (unsigned i = threadIdx.x; i < T * D / 4; i += kThreads)  // chunk i: row i / (D/4), columns 4·(i % (D/4)) + 0..3
    cp_async16(dst + (Operand ? cidx<T>(i / (D / 4), i % (D / 4) * 4) : 4 * i), src + 4 * i);
}

// A landed tile in operand layout into its hi/lo at the same index.
template <int D, int T>
__device__ __forceinline__ void split_same(const float* raw, float* hi, float* lo) {
#pragma unroll
  for (unsigned i = threadIdx.x; i < T * D / 4; i += kThreads) {
    float4 h, l;
    split4(reinterpret_cast<const float4*>(raw)[i], h, l);
    reinterpret_cast<float4*>(hi)[i] = h;
    reinterpret_cast<float4*>(lo)[i] = l;
  }
}

// A landed row-major [T x D] tile into the hi/lo of two operands: itself (T
// rows by D, contraction over D) and its transpose (D rows by T positions,
// the rows of every 8 stored in the order 0, 2, 4, 6, 1, 3, 5, 7, as
// `rs_split` reads them).
template <int D, int T>
__device__ __forceinline__ void split_both(const float* raw, float* hi, float* lo, float* t_hi, float* t_lo) {
#pragma unroll
  for (unsigned i = threadIdx.x; i < T * D / 4; i += kThreads) {
    float4 h, l;
    split4(reinterpret_cast<const float4*>(raw)[i], h, l);
    const unsigned at = cidx<T>(i / (D / 4), i % (D / 4) * 4);
    *reinterpret_cast<float4*>(&hi[at]) = h;
    *reinterpret_cast<float4*>(&lo[at]) = l;
  }
#pragma unroll
  for (unsigned i = threadIdx.x; i < T * D / 4; i += kThreads) {
    const unsigned d = i % D, pg = i / D;          // positions 4pg … 4pg + 3 of the transpose's row d
    const unsigned r0 = (pg >> 1) * 8 + (pg & 1);  // hold rows r0 + 0, 2, 4, 6
    float4 x = make_float4(raw[r0 * D + d], raw[(r0 + 2) * D + d], raw[(r0 + 4) * D + d], raw[(r0 + 6) * D + d]);
    float4 h, l;
    split4(x, h, l);
    const unsigned at = cidx<D>(d, 4 * pg);
    *reinterpret_cast<float4*>(&t_hi[at]) = h;
    *reinterpret_cast<float4*>(&t_lo[at]) = l;
  }
}

// lse in units of log2, +inf for a row that saw no key (lse = −1e30): then
// P = 2^(s·c − lse2) is exactly 0 without a select
__device__ __forceinline__ float lse2(float lse) { return lse > -0.5e30f ? lse * kLog2e : INFINITY; }

template <int D>
struct SmemDq {
  static constexpr int T = kDqTile<D>;
  float q_hi[kRows * D], q_lo[kRows * D];    // per warpgroup a 64-row operand
  float do_hi[kRows * D], do_lo[kRows * D];  // the same for dO
  float raw[kStages][2][T * D];              // landed tiles: K (row-major) and V (operand layout)
  float k_hi[T * D], k_lo[T * D];            // operand layout, T rows (keys) by D
  float v_hi[T * D], v_lo[T * D];
  float kt_hi[D * T], kt_lo[D * T];          // Kᵀ: D rows by T permuted keys
};

template <int D>
struct SmemDkv {
  static constexpr int T = kDkvTile;
  float k_hi[kRows * D], k_lo[kRows * D];    // per warpgroup a 64-row operand
  float v_hi[kRows * D], v_lo[kRows * D];
  float raw[kStages][2][T * D];              // landed tiles: Q and dO, row-major
  float raw_stats[kStages][2][T];            // and the tile's lse and delta
  float q_hi[T * D], q_lo[T * D];            // operand layout, T rows (queries) by D
  float do_hi[T * D], do_lo[T * D];
  float qt_hi[D * T], qt_lo[D * T];          // Qᵀ and dOᵀ: D rows by T permuted queries
  float dot_hi[D * T], dot_lo[D * T];
  float lse2[T], delta[T];
};
static_assert(sizeof(SmemDq<64>) <= 232448 && sizeof(SmemDkv<64>) <= 232448, "over 227 KB of shared memory");

// dq of q, dO [BH, Sq, D] against k, v [BH, Skv, D]: dq = scale · Σ_j dS_ij k_j.
// Grid (Sq / kRows, BH), kThreads threads, sizeof(SmemDq<D>) bytes of
// dynamic shared memory; two blocks an SM at D = 16 (at most 128 registers).
template <int D, bool Causal>
__global__ void __launch_bounds__(kThreads, D == 16 ? 2 : 1)
flash_bwd_dq_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int s_q, int s_kv, int shift, float scale) {
  constexpr int T = kDqTile<D>;
  using S = SmemDq<D>;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int bh = blockIdx.y;
  const int row0 = (Causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;  // causal: heaviest first
  const float* kb = k + (size_t)bh * s_kv * D;
  const float* vb = v + (size_t)bh * s_kv * D;
  const int kend = Causal ? key_end(row0, shift, s_kv) : s_kv;
  const int n_tiles = (kend + T - 1) / T;  // tiles past s_kv are never read: s_kv % kRows == 0

#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles) {
      load_rows<D, T, false>(sm.raw[st][0], kb + (size_t)st * T * D);
      load_rows<D, T, true>(sm.raw[st][1], vb + (size_t)st * T * D);
    }
    cp_async_commit();
  }
  const size_t qrow = (size_t)bh * s_q + row0;
  split_rows<D>(sm.q_hi, sm.q_lo, q + qrow * D);
  split_rows<D>(sm.do_hi, sm.do_lo, dout + qrow * D);
  proxy_fence();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = row0 + 64 * wg;                            // this warpgroup's first query row
  const int row_a = wrow0 + 16 * warp + g, row_b = row_a + 8;  // the two rows this thread holds
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t a16 = base16 + 64 * D * 4 / 16 * wg;  // this warpgroup's rows of Q and dO
  const float c = scale * kLog2e;                       // P = 2^(s·c − lse2)
  const float lse_a = lse2(__ldg(lse + (size_t)bh * s_q + row_a)), lse_b = lse2(__ldg(lse + (size_t)bh * s_q + row_b));
  const float dl_a = __ldg(delta + (size_t)bh * s_q + row_a), dl_b = __ldg(delta + (size_t)bh * s_q + row_b);

  float acc[D / 2];  // dq / scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 1>();  // this thread's copies of tile `it` have landed
    __syncthreads();               // everyone's; and the last tile's wgmmas are done
    split_both<D, T>(sm.raw[st][0], sm.k_hi, sm.k_lo, sm.kt_hi, sm.kt_lo);
    split_same<D, T>(sm.raw[st][1], sm.v_hi, sm.v_lo);
    proxy_fence();
    __syncthreads();
    if (it + kStages < n_tiles) {
      load_rows<D, T, false>(sm.raw[st][0], kb + (size_t)(it + kStages) * T * D);
      load_rows<D, T, true>(sm.raw[st][1], vb + (size_t)(it + kStages) * T * D);
    }
    cp_async_commit();

    const int kt = it * T;
    if (Causal && kt > wrow0 + 63 + shift) continue;  // wholly in this warpgroup's future

    // S = Q·Kᵀ and dP = dO·Vᵀ. s[4j + e] is (row_a, key kt + 8j + 2t + e),
    // s[4j + 2 + e] the same key on row_b; dp likewise.
    float s[T / 2], dp[T / 2];
    wg_fence();
    ss_split<D, T>(s, a16, offsetof(S, q_hi), offsetof(S, q_lo), base16, offsetof(S, k_hi), offsetof(S, k_lo));
    ss_split<D, T>(dp, a16, offsetof(S, do_hi), offsetof(S, do_lo), base16, offsetof(S, v_hi), offsetof(S, v_lo));
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // dS = P ∘ (dP − delta) into s; masked pairs and dead rows have P = 0 exactly
    const bool mask = Causal && kt + T - 1 > wrow0 + shift;  // the tile crosses the diagonal
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = exp2_ftz(fmaf(s[4 * j + e], c, -lse_a));
        float pb = exp2_ftz(fmaf(s[4 * j + 2 + e], c, -lse_b));
        if (mask) {
          const int key = kt + 8 * j + 2 * t + e;
          pa = key > row_a + shift ? 0.f : pa;
          pb = key > row_b + shift ? 0.f : pb;
        }
        s[4 * j + e] = pa * (dp[4 * j + e] - dl_a);
        s[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl_b);
      }

    // dq += dS·K with dS in registers, against Kᵀ; causal: the tile's
    // product sums apart and joins acc in f32 adds
    uint32_t xh[T / 2], xl[T / 2];
    split_frag(s, xh, xl);
    wg_fence();
    if constexpr (Causal) {
      float part[D / 2];
      rs_split<D, T>(part, xh, xl, base16, offsetof(S, kt_hi), offsetof(S, kt_lo), 0);
      wg_commit();
      wg_wait();
      pin(part);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
    } else {
      rs_split<D, T>(acc, xh, xl, base16, offsetof(S, kt_hi), offsetof(S, kt_lo));
      wg_commit();
      wg_wait();
      pin(acc);
    }
  }

  float* da = dq + ((size_t)bh * s_q + row_a) * D + 2 * t;
  float* db = dq + ((size_t)bh * s_q + row_b) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(da + 8 * j) = make_float2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<float2*>(db + 8 * j) = make_float2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// dk, dv of k, v [BH, Skv, D] from the same inputs: dv = Σ_i P_ijᵀ dO_i,
// dk = scale · Σ_i dS_ijᵀ q_i. Grid (Skv / kRows, BH), kThreads threads,
// sizeof(SmemDkv<D>) bytes of dynamic shared memory; two blocks an SM at
// D = 16 (at most 128 registers).
template <int D, bool Causal>
__global__ void __launch_bounds__(kThreads, D == 16 ? 2 : 1)
flash_bwd_dkv_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int s_q, int s_kv, int shift, float scale) {
  constexpr int T = kDkvTile;
  using S = SmemDkv<D>;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kRows;  // causal: the first blocks see the most queries
  const float* qb = q + (size_t)bh * s_q * D;
  const float* dob = dout + (size_t)bh * s_q * D;
  const float* lseb = lse + (size_t)bh * s_q;
  const float* deltab = delta + (size_t)bh * s_q;
  // causal: query rows before key0 − shift see none of this block's keys
  const int qt0 = Causal ? min(max(key0 - shift, 0), s_q) / T * T : 0;
  const int n_tiles = (s_q - qt0) / T;

  auto load = [&](int st, int qt) {
    load_rows<D, T, false>(sm.raw[st][0], qb + (size_t)qt * D);
    load_rows<D, T, false>(sm.raw[st][1], dob + (size_t)qt * D);
    if (threadIdx.x < T) {
      cp_async4(&sm.raw_stats[st][0][threadIdx.x], lseb + qt + threadIdx.x);
      cp_async4(&sm.raw_stats[st][1][threadIdx.x], deltab + qt + threadIdx.x);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles) load(st, qt0 + st * T);
    cp_async_commit();
  }
  const size_t krow = (size_t)bh * s_kv + key0;
  split_rows<D>(sm.k_hi, sm.k_lo, k + krow * D);
  split_rows<D>(sm.v_hi, sm.v_lo, v + krow * D);
  proxy_fence();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wkey0 = key0 + 64 * wg;                            // this warpgroup's first key row
  const int key_a = wkey0 + 16 * warp + g, key_b = key_a + 8;  // the two key rows this thread holds
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t a16 = base16 + 64 * D * 4 / 16 * wg;  // this warpgroup's rows of K and V
  const float c = scale * kLog2e;                       // P = 2^(s·c − lse2)

  float dka[D / 2], dva[D / 2];  // dk / scale and dv
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 1>();
    __syncthreads();
    split_both<D, T>(sm.raw[st][0], sm.q_hi, sm.q_lo, sm.qt_hi, sm.qt_lo);
    split_both<D, T>(sm.raw[st][1], sm.do_hi, sm.do_lo, sm.dot_hi, sm.dot_lo);
    if (threadIdx.x < T) {
      sm.lse2[threadIdx.x] = lse2(sm.raw_stats[st][0][threadIdx.x]);
      sm.delta[threadIdx.x] = sm.raw_stats[st][1][threadIdx.x];
    }
    proxy_fence();
    __syncthreads();
    if (it + kStages < n_tiles) load(st, qt0 + (it + kStages) * T);
    cp_async_commit();

    const int qt = qt0 + it * T;
    if (Causal && qt + T - 1 < wkey0 - shift) continue;  // every query of the tile precedes this warpgroup's keys

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ. s[4j + e] is (key_a, query qt + 8j + 2t + e),
    // s[4j + 2 + e] the same query on key_b; dp likewise. The query's lse and
    // delta are per column.
    float s[T / 2], dp[T / 2];
    wg_fence();
    ss_split<D, T>(s, a16, offsetof(S, k_hi), offsetof(S, k_lo), base16, offsetof(S, q_hi), offsetof(S, q_lo));
    ss_split<D, T>(dp, a16, offsetof(S, v_hi), offsetof(S, v_lo), base16, offsetof(S, do_hi), offsetof(S, do_lo));
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // Pᵀ into s, dSᵀ = Pᵀ ∘ (dPᵀ − delta) into dp
    const bool mask = Causal && wkey0 + 63 > qt + shift;  // the tile crosses the diagonal
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse2[8 * j + 2 * t]);
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[8 * j + 2 * t]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = e ? l2.y : l2.x, d = e ? dl.y : dl.x;
        float pa = exp2_ftz(fmaf(s[4 * j + e], c, -l));
        float pb = exp2_ftz(fmaf(s[4 * j + 2 + e], c, -l));
        if (mask) {
          const int query = qt + 8 * j + 2 * t + e;
          pa = key_a > query + shift ? 0.f : pa;
          pb = key_b > query + shift ? 0.f : pb;
        }
        s[4 * j + e] = pa;
        s[4 * j + 2 + e] = pb;
        dp[4 * j + e] = pa * (dp[4 * j + e] - d);
        dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - d);
      }
    }

    // dv += Pᵀ·dO against dOᵀ and dk += dSᵀ·Q against Qᵀ, Pᵀ and dSᵀ in registers
    if constexpr (Causal) {
      // each product of the tile sums apart and joins dv, dk in f32 adds; one
      // after the other, so that one partial sum and one split operand are
      // live at a time beside the two accumulators
      float part[D / 2];
      uint32_t ph[T / 2], pl[T / 2];
      split_frag(s, ph, pl);
      wg_fence();
      rs_split<D, T>(part, ph, pl, base16, offsetof(S, dot_hi), offsetof(S, dot_lo), 0);
      wg_commit();
      wg_wait();
      pin(part);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dva[i] += part[i];
      uint32_t dh[T / 2], dl[T / 2];
      split_frag(dp, dh, dl);
      wg_fence();
      rs_split<D, T>(part, dh, dl, base16, offsetof(S, qt_hi), offsetof(S, qt_lo), 0);
      wg_commit();
      wg_wait();
      pin(part);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] += part[i];
    } else {
      uint32_t ph[T / 2], pl[T / 2], dh[T / 2], dl[T / 2];
      split_frag(s, ph, pl);
      split_frag(dp, dh, dl);
      wg_fence();
      rs_split<D, T>(dva, ph, pl, base16, offsetof(S, dot_hi), offsetof(S, dot_lo));
      rs_split<D, T>(dka, dh, dl, base16, offsetof(S, qt_hi), offsetof(S, qt_lo));
      wg_commit();
      wg_wait();
      pin(dva);
      pin(dka);
    }
  }

  float* ka = dk + ((size_t)bh * s_kv + key_a) * D + 2 * t;
  float* kb = dk + ((size_t)bh * s_kv + key_b) * D + 2 * t;
  float* va = dv + ((size_t)bh * s_kv + key_a) * D + 2 * t;
  float* vb = dv + ((size_t)bh * s_kv + key_b) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(ka + 8 * j) = make_float2(dka[4 * j] * scale, dka[4 * j + 1] * scale);
    *reinterpret_cast<float2*>(kb + 8 * j) = make_float2(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
    *reinterpret_cast<float2*>(va + 8 * j) = make_float2(dva[4 * j], dva[4 * j + 1]);
    *reinterpret_cast<float2*>(vb + 8 * j) = make_float2(dva[4 * j + 2], dva[4 * j + 3]);
  }
}

// One launch of a backward kernel with its dynamic shared memory; the
// cudaError_t of the launch.
template <typename Kernel, typename... Args>
int launch_bwd(Kernel kernel, int smem, dim3 grid, cudaStream_t st, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int D, bool Causal>
int bwd_dq_d(const float* q, const float* k, const float* v, const float* dout, const float* lse,
             const float* delta, float* dq, int bh, int s_q, int s_kv, int shift, float scale, cudaStream_t st) {
  return launch_bwd(flash_bwd_dq_tc<D, Causal>, (int)sizeof(SmemDq<D>), dim3(s_q / kRows, bh), st, q, k, v, dout,
                    lse, delta, dq, s_q, s_kv, shift, scale);
}

template <int D, bool Causal>
int bwd_dkv_d(const float* q, const float* k, const float* v, const float* dout, const float* lse,
              const float* delta, float* dk, float* dv, int bh, int s_q, int s_kv, int shift, float scale,
              cudaStream_t st) {
  return launch_bwd(flash_bwd_dkv_tc<D, Causal>, (int)sizeof(SmemDkv<D>), dim3(s_kv / kRows, bh), st, q, k, v,
                    dout, lse, delta, dk, dv, s_q, s_kv, shift, scale);
}

int bwd_dq(const float* q, const float* k, const float* v, const float* dout, const float* lse, const float* delta,
           float* dq, int bh, int s_q, int s_kv, int d, bool causal, int shift, float scale, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d * 2 + (causal ? 1 : 0)) {
    case 32: return bwd_dq_d<16, false>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    case 33: return bwd_dq_d<16, true>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    case 64: return bwd_dq_d<32, false>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    case 65: return bwd_dq_d<32, true>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    case 128: return bwd_dq_d<64, false>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    case 129: return bwd_dq_d<64, true>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bwd_dkv(const float* q, const float* k, const float* v, const float* dout, const float* lse, const float* delta,
            float* dk, float* dv, int bh, int s_q, int s_kv, int d, bool causal, int shift, float scale,
            void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d * 2 + (causal ? 1 : 0)) {
    case 32: return bwd_dkv_d<16, false>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    case 33: return bwd_dkv_d<16, true>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    case 64: return bwd_dkv_d<32, false>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    case 65: return bwd_dkv_d<32, true>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    case 128: return bwd_dkv_d<64, false>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    case 129: return bwd_dkv_d<64, true>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// Forward on `stream`: o [BH, S, D], lse [BH, S]. D in {16, 32, 64},
// S a multiple of 128. Returns the cudaError_t of the launch.
int flash_fwd_launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s,
                     int d, float scale, void* stream) {
  return tc::fwd(q, k, v, o, lse, bh, s, s, d, true, 0, scale, stream);
}

// dq [BH, S, D] from q, k, v, dO [BH, S, D] and lse, delta [BH, S].
int flash_bwd_dq_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                        const float* delta, float* dq, int bh, int s, int d, float scale, void* stream) {
  return tc::bwd_dq(q, k, v, dout, lse, delta, dq, bh, s, s, d, true, 0, scale, stream);
}

// dk, dv [BH, S, D] from the same inputs.
int flash_bwd_dkv_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                         const float* delta, float* dk, float* dv, int bh, int s, int d, float scale,
                         void* stream) {
  return tc::bwd_dkv(q, k, v, dout, lse, delta, dk, dv, bh, s, s, d, true, 0, scale, stream);
}

// Rectangular forward: o [BH, Sq, D], lse [BH, Sq] from q [BH, Sq, D] and
// k, v [BH, Skv, D]; `causal` masks on the global positions q_off + i,
// k_off + j. Sq and Skv multiples of 128, D in {16, 32, 64}.
int flash_fwd_rect_launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q,
                          int s_kv, int d, int causal, int q_off, int k_off, float scale, void* stream) {
  return tc::fwd(q, k, v, o, lse, bh, s_q, s_kv, d, causal != 0, q_off - k_off, scale, stream);
}

// Rectangular dq [BH, Sq, D] from q, dO [BH, Sq, D], k, v [BH, Skv, D] and lse, delta [BH, Sq].
int flash_bwd_dq_rect_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                             const float* delta, float* dq, int bh, int s_q, int s_kv, int d, int causal,
                             int q_off, int k_off, float scale, void* stream) {
  return tc::bwd_dq(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, causal != 0, q_off - k_off, scale, stream);
}

// Rectangular dk, dv [BH, Skv, D] from the same inputs.
int flash_bwd_dkv_rect_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                              const float* delta, float* dk, float* dv, int bh, int s_q, int s_kv, int d,
                              int causal, int q_off, int k_off, float scale, void* stream) {
  return tc::bwd_dkv(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, d, causal != 0, q_off - k_off, scale,
                     stream);
}

}  // extern "C"
