// Causal flash attention on bf16 inputs, forward and backward, for Hopper
// (sm_90a): the `cast16` branches of the JAX package's
// ops/flash_attention.py, taken there when q is bf16 and the precision is
// 'default' (`flash_attention` :860).
//
//   _fwd_tri     :559 (_fwd_kernel_tri :253, cast16, fuse_l)    -> flash_fwd_bf16_launch     -> flash_fwd_bf16_tc<D>
//   _bwd_tri dq  :655 (_bwd_dq_kernel_tri :341, cast16)         -> flash_bwd_dq_bf16_launch  -> flash_bwd_dq_bf16_tc<D>
//   _bwd_tri dkv :673 (_bwd_dkv_kernel_tri :365, cast16)        -> flash_bwd_dkv_bf16_launch -> flash_bwd_dkv_bf16_tc<D>
//
// What they compute, as the TPU kernels do (and the plain versions in
// ops/flash_cuda.py repeat):
//   * Q arrives pre-scaled into the base-2 score domain by the caller,
//     qs = bf16(f32(q) · scale·log2 e) (`_prescale_q` :537), so a score is
//     s = qs·kᵀ and P = 2^(s − m).
//   * Forward: per row the running max m and, per tile, P = 2^(s − m_new)
//     rounded to bf16 (to nearest even) before P·V; the row sum l is summed
//     over the ROUNDED P, through a ones column appended to V (`fuse_l`,
//     `_augmented_v` :527). o = acc / max(l, 1e-30) and
//     lse = (m + log2 l)·ln 2, both f32 (o stays f32 for delta; the caller
//     rounds the output to bf16).
//   * Backward, from (qs, k, v, dO in bf16, lse, delta = rowsum(dO∘o) in
//     f32): P = 2^(s − lse·log2 e), dP = dO·vᵀ, dS = P∘(dP − delta), P and
//     dS rounded to bf16 before their products; dq = scale·(dS·k),
//     dk = ln 2·(dSᵀ·qs) (qs carries scale·log2 e), dv = Pᵀ·dO, each rounded
//     once to bf16 at the end.
//
// Not a block-by-block carry-over of the TPU kernels (1024-row tiles and a
// triangular grid of tile pairs, sized for a v5e's VMEM). Bound on an H100
// SXM at the LM path's shape (BH = 128, S = 2048, D = 16, the causal
// triangle: 2.7e8 pairs): the products at 989 TFLOP/s bf16 take 0.017 ms
// (forward), 0.026 (dq), 0.035 (dk/dv), the bytes 0.013 ms or less, the
// exps (16 a clock per SM) 0.070 ms: the exps bound all three. The design:
//   * A block owns 128 rows (queries for the forward and dq, keys for
//     dk/dv) as two consumer warpgroups of 64, 256 threads, and loads its
//     own operands once. The other side streams in tiles of 64 rows through
//     a three-stage cp.async ring: tile t + 2 is in flight while tile t is
//     computed, and the tile a stage held is done with (the warpgroups
//     waited for their wgmmas before the barrier that opens iteration t).
//     Operands land straight in wgmma's K-major layout (16-byte chunks are
//     core-matrix rows); only operands read along their rows (Vᵀ, Kᵀ, Qᵀ,
//     dOᵀ) take a transpose pass in shared memory.
//   * Products are bf16 m64nNk16 wgmmas with f32 accumulators: the score
//     products from shared memory, the P and dS products with P or dS in
//     registers, whose accumulator fragment is the A fragment as it stands.
//     Sums over the streamed tiles stay in the tensor cores' accumulator.
//   * Causal: a block reads only the tiles that can see it; a warpgroup
//     skips a tile wholly outside its triangle and masks by select only a
//     tile across its diagonal. Blocks launch heaviest first.
//   * Each output row is summed by one warpgroup in a fixed order: no
//     atomics, bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"
#include "tf32_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf16_wgmma::bidx;
using bf16_wgmma::pack_a;
using bf16_wgmma::wgmma_rs_bf16;
using bf16_wgmma::wgmma_ss_bf16_n64;
using tf32_wgmma::cp_async16;
using tf32_wgmma::cp_async4;
using tf32_wgmma::cp_async_commit;
using tf32_wgmma::cp_async_wait;
using tf32_wgmma::desc;
using tf32_wgmma::pin;
using tf32_wgmma::proxy_fence;
using tf32_wgmma::wg_commit;
using tf32_wgmma::wg_fence;
using tf32_wgmma::wg_wait;

constexpr int kRows = 128;    // rows a block owns
constexpr int kThreads = 256;  // two warpgroups of 64 rows
constexpr int kTile = 64;     // rows of a streamed tile
constexpr int kStages = 3;    // depth of the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

bool shape_ok(int bh, int s) { return bh >= 1 && bh <= 65535 && s >= kRows && s % kRows == 0; }

// 2^x; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// cp.async of the R rows of a row-major [·, D] bf16 matrix (src at the
// first) into an R-row operand (K-major over D)
template <int D, int R>
__device__ __forceinline__ void load_operand(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < R * D / 8; i += kThreads) {  // chunk i: row i / (D/8), columns 8·(i % (D/8)) …
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    cp_async16(reinterpret_cast<float*>(dst + bidx<R>(r, c)), reinterpret_cast<const float*>(src + 8 * i));
  }
}

// rows [row0, row0 + kRows) of a [S, D] matrix into two 64-row operands, one a warpgroup
template <int D>
__device__ __forceinline__ void load_block(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < kRows * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8) * 8;
    cp_async16(reinterpret_cast<float*>(dst + r / 64 * 64 * D + bidx<64>(r % 64, c)),
               reinterpret_cast<const float*>(src + 8 * i));
  }
}

// The transpose of a T-row operand (T rows by D, K-major over D) as an
// N-row operand (rows d < D, K-major over the T rows): dst(d, r) = src(r, d)
template <int D, int T, int N>
__device__ __forceinline__ void transpose(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < T * D / 2; i += kThreads) {  // a pair of rows 2p, 2p + 1 at column d
    const int d = i % D, r = 2 * (i / D);
    __nv_bfloat162 x;
    x.x = src[bidx<T>(r, d)];
    x.y = src[bidx<T>(r + 1, d)];
    *reinterpret_cast<__nv_bfloat162*>(&dst[bidx<N>(d, r)]) = x;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D>
struct SmemFwd {
  bf16 q[kRows * D];              // two 64-row operands of qs
  bf16 k[kStages][kTile * D];     // landed K tiles, 64-row operands
  bf16 v[kStages][kTile * D];     // landed V tiles, the same layout
  bf16 vt[(D + 8) * kTile];       // [V | 1 | 0]ᵀ: D + 8 rows by 64 keys; row D all ones
};

// Grid (S / kRows, BH), kThreads threads, sizeof(SmemFwd<D>) bytes of
// dynamic shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_tc(const bf16* __restrict__ qs, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  float* __restrict__ o, float* __restrict__ lse, int s_len) {
  using S = SmemFwd<D>;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int bh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const size_t base = (size_t)bh * s_len * D;
  const int n_tiles = (row0 + kRows) / kTile;  // keys [0, row0 + kRows)

  auto load = [&](int st, int kt) {
    load_operand<D, kTile>(sm.k[st], k + base + (size_t)kt * D);
    load_operand<D, kTile>(sm.v[st], v + base + (size_t)kt * D);
  };
  load_block<D>(sm.q, qs + base + (size_t)row0 * D);
  load(0, 0);
  cp_async_commit();
  load(1, kTile);  // n_tiles >= 2
  cp_async_commit();
  for (int i = threadIdx.x; i < 8 * kTile; i += kThreads) {  // rows D … D + 7 of vt: [1 | 0]
    const int r = D + i / kTile;
    sm.vt[bidx<D + 8>(r, i % kTile)] = __float2bfloat16_rn(r == D ? 1.f : 0.f);
  }

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = row0 + 64 * wg;
  const int row_a = wrow0 + 16 * warp + g, row_b = row_a + 8;
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t q16 = base16 + 64 * D * 2 / 16 * wg;  // this warpgroup's rows of qs

  float acc[(D + 8) / 2];  // O and, in column D, the row sum l
#pragma unroll
  for (int i = 0; i < (D + 8) / 2; ++i) acc[i] = 0.f;
  float m_a = -1e30f, m_b = -1e30f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile `it` have landed
    __syncthreads();               // everyone's; and every wgmma of tile it − 1 is done
    if (it + 2 < n_tiles) load((it + 2) % kStages, (it + 2) * kTile);
    cp_async_commit();
    transpose<D, kTile, D + 8>(sm.vt, sm.v[st]);
    proxy_fence();
    __syncthreads();

    const int kt = it * kTile;
    if (kt > wrow0 + 63) continue;  // wholly in this warpgroup's future

    // s = qs·kᵀ (base 2). s[4j + e] is (row_a, key kt + 8j + 2t + e), s[4j + 2 + e] row_b.
    float s[32];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_bf16_n64(s, desc<64>(q16, 2048 * ks),
                        desc<kTile>(base16, offsetof(S, k) + st * kTile * D * 2 + 2048 * ks), ks > 0);
    wg_commit();
    wg_wait();
    pin(s);

    const bool mask = kt + kTile - 1 > wrow0;  // the tile crosses the diagonal
    if (mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt + 8 * j + 2 * t + e;
          if (key > row_a) s[4 * j + e] = -INFINITY;
          if (key > row_b) s[4 * j + 2 + e] = -INFINITY;
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
    // every row sees key kt here (kt <= wrow0 <= row), so the max is finite
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2_ftz(m_a - mn_a), corr_b = exp2_ftz(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2_ftz(s[4 * j + e] - mn_a);  // masked: 2^-inf = 0
        s[4 * j + 2 + e] = exp2_ftz(s[4 * j + 2 + e] - mn_b);
      }
#pragma unroll
    for (int j = 0; j < (D + 8) / 8; ++j) {
      acc[4 * j] *= corr_a;
      acc[4 * j + 1] *= corr_a;
      acc[4 * j + 2] *= corr_b;
      acc[4 * j + 3] *= corr_b;
    }
    // acc += bf16(P)·[V | 1 | 0], 16 keys a wgmma
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(s, kk, a[kk]);
    pin(a[0]);
    pin(a[1]);
    pin(a[2]);
    pin(a[3]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_bf16<D + 8>(acc, a[kk], desc<D + 8>(base16, offsetof(S, vt) + 32 * (D + 8) * kk), 1);
    wg_commit();
    wg_wait();
    pin(acc);
  }

  // l: column D, held by the quad's thread t = 0
  const float l_a = fmaxf(__shfl_sync(0xffffffffu, acc[D / 2], lane & ~3), 1e-30f);
  const float l_b = fmaxf(__shfl_sync(0xffffffffu, acc[D / 2 + 2], lane & ~3), 1e-30f);
  float* oa = o + base + (size_t)row_a * D + 2 * t;
  float* ob = o + base + (size_t)row_b * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(oa + 8 * j) = make_float2(acc[4 * j] / l_a, acc[4 * j + 1] / l_a);
    *reinterpret_cast<float2*>(ob + 8 * j) = make_float2(acc[4 * j + 2] / l_b, acc[4 * j + 3] / l_b);
  }
  if (t == 0) {
    lse[(size_t)bh * s_len + row_a] = (m_a + log2f(l_a)) * kLn2;
    lse[(size_t)bh * s_len + row_b] = (m_b + log2f(l_b)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// Backward: dq
// ---------------------------------------------------------------------------

template <int D>
struct SmemDq {
  bf16 q[kRows * D], dout[kRows * D];  // two 64-row operands each
  bf16 k[kStages][kTile * D];          // landed K tiles (64-row operands)
  bf16 v[kStages][kTile * D];          // landed V tiles
  bf16 kt[D * kTile];                  // Kᵀ: D rows by 64 keys
};

// dq of qs, dO against k, v: dq = scale · Σ_j bf16(dS_ij) k_j. Grid (S / kRows,
// BH), kThreads threads, sizeof(SmemDq<D>) bytes of dynamic shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_tc(const bf16* __restrict__ qs, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, int s_len, float scale) {
  using S = SmemDq<D>;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int bh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const size_t base = (size_t)bh * s_len * D;
  const int n_tiles = (row0 + kRows) / kTile;

  auto load = [&](int st, int kt) {
    load_operand<D, kTile>(sm.k[st], k + base + (size_t)kt * D);
    load_operand<D, kTile>(sm.v[st], v + base + (size_t)kt * D);
  };
  load_block<D>(sm.q, qs + base + (size_t)row0 * D);
  load_block<D>(sm.dout, dout + base + (size_t)row0 * D);
  load(0, 0);
  cp_async_commit();
  load(1, kTile);
  cp_async_commit();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = row0 + 64 * wg;
  const int row_a = wrow0 + 16 * warp + g, row_b = row_a + 8;
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t wg_off = 64 * D * 2 * wg;  // bytes to this warpgroup's rows of qs and dO
  const size_t srow = (size_t)bh * s_len;
  const float l2_a = __ldg(lse + srow + row_a) * kLog2e, l2_b = __ldg(lse + srow + row_b) * kLog2e;
  const float dl_a = __ldg(delta + srow + row_a), dl_b = __ldg(delta + srow + row_b);

  float acc[D / 2];  // dq / scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + 2 < n_tiles) load((it + 2) % kStages, (it + 2) * kTile);
    cp_async_commit();
    transpose<D, kTile, D>(sm.kt, sm.k[st]);
    proxy_fence();
    __syncthreads();

    const int kt = it * kTile;
    if (kt > wrow0 + 63) continue;

    // s = qs·kᵀ and dp = dO·vᵀ; s[4j + e] is (row_a, key kt + 8j + 2t + e)
    float s[32], dp[32];
    const uint32_t k_off = offsetof(S, k) + st * kTile * D * 2, v_off = offsetof(S, v) + st * kTile * D * 2;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_bf16_n64(s, desc<64>(base16, offsetof(S, q) + wg_off + 2048 * ks),
                        desc<kTile>(base16, k_off + 2048 * ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_bf16_n64(dp, desc<64>(base16, offsetof(S, dout) + wg_off + 2048 * ks),
                        desc<kTile>(base16, v_off + 2048 * ks), ks > 0);
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // dS = P ∘ (dP − delta) into s; masked pairs have P = 0
    const bool mask = kt + kTile - 1 > wrow0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = exp2_ftz(s[4 * j + e] - l2_a);
        float pb = exp2_ftz(s[4 * j + 2 + e] - l2_b);
        if (mask) {
          const int key = kt + 8 * j + 2 * t + e;
          pa = key > row_a ? 0.f : pa;
          pb = key > row_b ? 0.f : pb;
        }
        s[4 * j + e] = pa * (dp[4 * j + e] - dl_a);
        s[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl_b);
      }

    // acc += bf16(dS)·K against Kᵀ
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(s, kk, a[kk]);
    pin(a[0]);
    pin(a[1]);
    pin(a[2]);
    pin(a[3]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_bf16<D>(acc, a[kk], desc<D>(base16, offsetof(S, kt) + 32 * D * kk), 1);
    wg_commit();
    wg_wait();
    pin(acc);
  }

  bf16* da = dq + base + (size_t)row_a * D + 2 * t;
  bf16* db = dq + base + (size_t)row_b * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(da + 8 * j) = bf16_wgmma::pack2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<uint32_t*>(db + 8 * j) = bf16_wgmma::pack2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// ---------------------------------------------------------------------------
// Backward: dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct SmemDkv {
  bf16 k[kRows * D], v[kRows * D];  // two 64-row operands each
  bf16 q[kStages][kTile * D];       // landed qs tiles (64-row operands)
  bf16 dout[kStages][kTile * D];    // landed dO tiles
  float stats[kStages][2][kTile];   // the tiles' lse and delta
  bf16 qt[D * kTile], dot[D * kTile];  // qsᵀ and dOᵀ: D rows by 64 queries
};

// dk, dv of k, v from the same inputs: dv = Σ_i bf16(P_ij)ᵀ dO_i, dk = ln 2 ·
// Σ_i bf16(dS_ij)ᵀ qs_i. Grid (S / kRows, BH), kThreads threads,
// sizeof(SmemDkv<D>) bytes of dynamic shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_tc(const bf16* __restrict__ qs, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int s_len) {
  using S = SmemDkv<D>;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kRows;  // the first blocks see the most queries
  const size_t base = (size_t)bh * s_len * D;
  const size_t srow = (size_t)bh * s_len;
  const int n_tiles = (s_len - key0) / kTile;  // queries before key0 see none of these keys

  auto load = [&](int st, int qt) {
    load_operand<D, kTile>(sm.q[st], qs + base + (size_t)qt * D);
    load_operand<D, kTile>(sm.dout[st], dout + base + (size_t)qt * D);
    if (threadIdx.x < kTile) {
      cp_async4(&sm.stats[st][0][threadIdx.x], lse + srow + qt + threadIdx.x);
      cp_async4(&sm.stats[st][1][threadIdx.x], delta + srow + qt + threadIdx.x);
    }
  };
  load_block<D>(sm.k, k + base + (size_t)key0 * D);
  load_block<D>(sm.v, v + base + (size_t)key0 * D);
  load(0, key0);
  cp_async_commit();
  load(1, key0 + kTile);
  cp_async_commit();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wkey0 = key0 + 64 * wg;
  const int key_a = wkey0 + 16 * warp + g, key_b = key_a + 8;
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t wg_off = 64 * D * 2 * wg;

  float dka[D / 2], dva[D / 2];  // dk / ln 2 and dv
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + 2 < n_tiles) load((it + 2) % kStages, key0 + (it + 2) * kTile);
    cp_async_commit();
    transpose<D, kTile, D>(sm.qt, sm.q[st]);
    transpose<D, kTile, D>(sm.dot, sm.dout[st]);
    proxy_fence();
    __syncthreads();

    const int qt = key0 + it * kTile;
    if (qt + kTile - 1 < wkey0) continue;  // every query of the tile precedes this warpgroup's keys

    // sᵀ = k·qsᵀ and dpᵀ = v·dOᵀ; s[4j + e] is (key_a, query qt + 8j + 2t + e)
    float s[32], dp[32];
    const uint32_t q_off = offsetof(S, q) + st * kTile * D * 2, do_off = offsetof(S, dout) + st * kTile * D * 2;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_bf16_n64(s, desc<64>(base16, offsetof(S, k) + wg_off + 2048 * ks),
                        desc<kTile>(base16, q_off + 2048 * ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_bf16_n64(dp, desc<64>(base16, offsetof(S, v) + wg_off + 2048 * ks),
                        desc<kTile>(base16, do_off + 2048 * ks), ks > 0);
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // Pᵀ into s, dSᵀ = Pᵀ ∘ (dPᵀ − delta) into dp; the query's lse and delta are per column
    const bool mask = wkey0 + 63 > qt;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(&sm.stats[st][0][8 * j + 2 * t]);
      const float2 dl = *reinterpret_cast<const float2*>(&sm.stats[st][1][8 * j + 2 * t]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l2 = (e ? ls.y : ls.x) * kLog2e, d = e ? dl.y : dl.x;
        float pa = exp2_ftz(s[4 * j + e] - l2);
        float pb = exp2_ftz(s[4 * j + 2 + e] - l2);
        if (mask) {
          const int query = qt + 8 * j + 2 * t + e;
          pa = key_a > query ? 0.f : pa;
          pb = key_b > query ? 0.f : pb;
        }
        s[4 * j + e] = pa;
        s[4 * j + 2 + e] = pb;
        dp[4 * j + e] = pa * (dp[4 * j + e] - d);
        dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - d);
      }
    }

    // dv += bf16(P)ᵀ·dO against dOᵀ; dk += bf16(dS)ᵀ·qs against qsᵀ
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_a(s, kk, pa[kk]);
      pack_a(dp, kk, da[kk]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(pa[kk]);
      pin(da[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_bf16<D>(dva, pa[kk], desc<D>(base16, offsetof(S, dot) + 32 * D * kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_bf16<D>(dka, da[kk], desc<D>(base16, offsetof(S, qt) + 32 * D * kk), 1);
    wg_commit();
    wg_wait();
    pin(dva);
    pin(dka);
  }

  const size_t ra = base + (size_t)key_a * D + 2 * t, rb = base + (size_t)key_b * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(dk + ra + 8 * j) = bf16_wgmma::pack2(dka[4 * j] * kLn2, dka[4 * j + 1] * kLn2);
    *reinterpret_cast<uint32_t*>(dk + rb + 8 * j) = bf16_wgmma::pack2(dka[4 * j + 2] * kLn2, dka[4 * j + 3] * kLn2);
    *reinterpret_cast<uint32_t*>(dv + ra + 8 * j) = bf16_wgmma::pack2(dva[4 * j], dva[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dv + rb + 8 * j) = bf16_wgmma::pack2(dva[4 * j + 2], dva[4 * j + 3]);
  }
}

static_assert(sizeof(SmemFwd<64>) <= 232448 && sizeof(SmemDq<64>) <= 232448 && sizeof(SmemDkv<64>) <= 232448,
              "over 227 KB of shared memory");

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, dim3 grid, cudaStream_t st, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward on `stream`: o [BH, S, D] and lse [BH, S] f32 from qs, k, v
// [BH, S, D] bf16 (qs pre-scaled by scale·log2 e). D in {16, 32, 64}, S a
// multiple of 128. Returns the cudaError_t of the launch.
int flash_fwd_bf16_launch(const bf16* qs, const bf16* k, const bf16* v, float* o, float* lse, int bh, int s, int d,
                          void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(s / kRows, bh);
  switch (d) {
    case 16: return launch(flash_fwd_bf16_tc<16>, (int)sizeof(SmemFwd<16>), grid, st, qs, k, v, o, lse, s);
    case 32: return launch(flash_fwd_bf16_tc<32>, (int)sizeof(SmemFwd<32>), grid, st, qs, k, v, o, lse, s);
    case 64: return launch(flash_fwd_bf16_tc<64>, (int)sizeof(SmemFwd<64>), grid, st, qs, k, v, o, lse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq [BH, S, D] bf16 from qs, k, v, dO [BH, S, D] bf16 and lse, delta [BH, S] f32.
int flash_bwd_dq_bf16_launch(const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                             const float* delta, bf16* dq, int bh, int s, int d, float scale, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(s / kRows, bh);
  switch (d) {
    case 16: return launch(flash_bwd_dq_bf16_tc<16>, (int)sizeof(SmemDq<16>), grid, st, qs, k, v, dout, lse, delta, dq, s, scale);
    case 32: return launch(flash_bwd_dq_bf16_tc<32>, (int)sizeof(SmemDq<32>), grid, st, qs, k, v, dout, lse, delta, dq, s, scale);
    case 64: return launch(flash_bwd_dq_bf16_tc<64>, (int)sizeof(SmemDq<64>), grid, st, qs, k, v, dout, lse, delta, dq, s, scale);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv [BH, S, D] bf16 from the same inputs.
int flash_bwd_dkv_bf16_launch(const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                              const float* delta, bf16* dk, bf16* dv, int bh, int s, int d, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(s / kRows, bh);
  switch (d) {
    case 16: return launch(flash_bwd_dkv_bf16_tc<16>, (int)sizeof(SmemDkv<16>), grid, st, qs, k, v, dout, lse, delta, dk, dv, s);
    case 32: return launch(flash_bwd_dkv_bf16_tc<32>, (int)sizeof(SmemDkv<32>), grid, st, qs, k, v, dout, lse, delta, dk, dv, s);
    case 64: return launch(flash_bwd_dkv_bf16_tc<64>, (int)sizeof(SmemDkv<64>), grid, st, qs, k, v, dout, lse, delta, dk, dv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
