// Grouped f32 GEMM for Hopper (sm_90a): C[g] = A[g] · B[g] for every group g,
// on the tensor cores in split TF32.
//
// Replaces the JAX package's Pallas kernel in ops/grouped_gemm.py
// (grouped_matmul_pallas, pallas_call :74; _grouped_kernel :43): a grid
// over (group, 256-row M tile, 256-column N tile) with K untiled, f32
// products at Precision.HIGHEST.
//
//   grouped_gemm_launch  A [G, M, K] x B [G, K, N] -> C [G, M, N], or, split
//                        over the contraction, partials [S, G, M, N]
//   grouped_sum_launch   C = Σ_s partials[s], summed in split order
//
// Either operand, but not both, may be a transposed view: A with M
// contiguous (the backward's Aᵀ·dC) or B with K contiguous (the backward's
// dC·Bᵀ), so the wrapper never copies the saved operands. Each operand's
// group stride and leading (row) stride are arguments.
//
// Arithmetic. Each product is taken as the flash kernels take theirs
// (flash_attention.cu): x = hi + lo with hi = tf32(x) rounded to nearest and
// lo = x − hi, which the tensor cores read truncated; a·b = lo·hi + hi·lo +
// hi·hi with f32 accumulators, the small products of a stage first. The
// tensor cores' f32 sums drift with the number of terms they add, so each
// block of 64 contraction terms (two stages) is summed in a fresh
// accumulator and folded into the running f32 sum with FADDs.
//
// Bound on an H100 SXM at the switch-MoE ViT's shapes (G = 24, M = 20,480,
// K = 64, N = 256, or K = 256, N = 64): 16.1 GFLOP and ~631 MB moved. The
// bytes take 0.188 ms at 3.35 TB/s; three TF32 passes at 495 TFLOP/s take
// 0.098 ms, so the kernel is bound by its bytes (an f32 FFMA design by its
// operations: 0.240 ms). One tensor of 503 MB streams through each role:
// the fc1 forward's C, the fc2 forward's A, fc1's dA's dC. The weight
// gradient contracts over M = 20,480 rows into [64, 256] per group: only
// 48 output tiles, so the wrapper splits it into chunks (`split_k`).
//
// Design:
//   * One block of two warpgroups (256 threads) per (group, output tile,
//     contraction split); each warpgroup owns a 64 x 64 output (m64n64k8
//     wgmmas), side by side in N (a 64 x 128 tile, where N > 64) or
//     stacked in M (128 x 64). 102 KB of shared memory and at most 128
//     registers a thread: two blocks an SM, so one block's epilogue and
//     splits overlap the other's loads and products.
//   * The contraction streams in stages of 32 through a ring of two raw
//     buffers filled by cp.async (16 bytes where the rows allow it, else 4,
//     in the same kernel); out-of-range rows and positions land as zeros.
//     A landed stage is copied once into hi/lo operands in wgmma's K-major
//     layout without swizzle (`cidx`): TF32 wgmma reads only K-major shared
//     operands, so an operand whose rows are contiguous in device memory
//     (the forward's B, the weight gradient's Aᵀ and dC) is transposed by
//     that copy, four positions of a row a thread.
//   * The output is staged through shared memory and stored as whole rows
//     in 16-byte vectors; tails are masked.
//   * Every sum has a fixed order, and the splits are added in order by a
//     second launch: no atomics, so two launches give equal bits.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace {

using namespace tf32_wgmma;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBK = 32;        // contraction positions a stage
constexpr int kFold = 64;      // positions summed in one fresh accumulator
constexpr int kStages = 2;     // depth of the raw ring
constexpr int kPad = 4;        // padding of a raw row: conflict-free transposing reads, 16-byte rows

// floats of a raw stage of an R-row operand: [R][kBK + kPad] when its
// contraction axis is contiguous in device memory (KC), else [kBK][R + kPad]
template <int R>
constexpr int kRaw = R * (kBK + kPad) > kBK * (R + kPad) ? R * (kBK + kPad) : kBK * (R + kPad);

template <int BM>
struct Smem {
  static constexpr int BN = BM == 128 ? 64 : 128;  // output tile BM x BN
  float raw[kStages][kRaw<BM> + kRaw<BN>];          // landed stages: A, then B
  // operands in K-major layout, 64-row sub-blocks (one a warpgroup), kBK positions
  float a_hi[BM * kBK], a_lo[BM * kBK], b_hi[BN * kBK], b_lo[BN * kBK];
};
static_assert(sizeof(Smem<128>) <= 232448 / 2 - 1024 && sizeof(Smem<64>) <= 232448 / 2 - 1024,
              "two blocks an SM");
static_assert(128 * (64 + 8) <= 12288 && 64 * (128 + 8) <= 12288, "the output stages in the operands' space");

// cp.async of positions [k0, k0 + kBK) of an R-row operand into its raw
// stage. Element (r, k) is src[r·ld + k] when KC, else src[k·ld + r]; rows
// >= rows and positions >= kend land as 0. With `vec`, 16-byte copies:
// the launcher has checked that every 4-element chunk is aligned and wholly
// in or out of range, and that a group's offsets fit in 32 bits (fewer
// registers than 64-bit addresses: the kernel holds 128 a thread).
template <int R, bool KC>
__device__ __forceinline__ void load_stage(float* raw, const float* src, int ld, int r0, int rows, int k0,
                                           int kend, bool vec) {
  if (vec) {
#pragma unroll
    for (int n = 0; n < R * kBK / 4 / kThreads; ++n) {
      const int j = threadIdx.x + n * kThreads;
      const int r = KC ? j / (kBK / 4) : j % (R / 4) * 4, k = KC ? j % (kBK / 4) * 4 : j / (R / 4);
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < rows && gk < kend;
      const float* p = ok ? src + (KC ? gr * ld + gk : gk * ld + gr) : src;
      cp_async16_zfill(raw + (KC ? r * (kBK + kPad) + k : k * (R + kPad) + r), p, ok);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < R * kBK; e += kThreads) {
      const int r = KC ? e / kBK : e % R, k = KC ? e % kBK : e / R;
      const int gr = r0 + r, gk = k0 + k;
      const bool ok = gr < rows && gk < kend;
      const float* p = ok ? src + (KC ? gr * ld + gk : gk * ld + gr) : src;
      cp_async4_zfill(raw + (KC ? r * (kBK + kPad) + k : k * (R + kPad) + r), p, ok);
    }
  }
}

// A landed raw stage of an R-row operand into its hi/lo in operand layout:
// thread j takes row r = j % R and positions 4c … 4c + 3 (c = j / R), read as
// one float4 (KC) or four rows of the transposed stage, and writes them as
// one float4 each of hi and lo (conflict-free: neighbouring threads take
// neighbouring rows).
template <int R, bool KC>
__device__ __forceinline__ void split_stage(const float* raw, float* hi, float* lo) {
#pragma unroll
  for (int n = 0; n < R * kBK / 4 / kThreads; ++n) {
    const unsigned j = threadIdx.x + n * kThreads, r = j % R, c = j / R;
    float4 x;
    if (KC) {
      x = *reinterpret_cast<const float4*>(raw + r * (kBK + kPad) + 4 * c);
    } else {
      const float* p = raw + 4 * c * (R + kPad) + r;
      x = make_float4(p[0], p[R + kPad], p[2 * (R + kPad)], p[3 * (R + kPad)]);
    }
    float4 h, l;
    split4(x, h, l);
    const unsigned at = (r >> 6) * 64 * kBK + cidx<64>(r & 63, 4 * c);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// out[split, g] tile = A[g][:, chunk] · B[g][chunk, :]. Grid (output tiles,
// G, splits), kThreads threads, sizeof(Smem<BM>) bytes of dynamic shared
// memory. AKC: A's contraction axis is contiguous (A row-major); BKC: B's is
// (B a transposed view).
template <int BM, bool AKC, bool BKC>
__global__ void __launch_bounds__(kThreads, 2)
grouped_gemm_tc(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c, int M, int N,
                int K, int k_chunk, long long a_g, int lda, long long b_g, int ldb, long long c_split,
                int vec_a, int vec_b, int vec_c) {
  using S = Smem<BM>;
  constexpr int BN = S::BN;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);

  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int n_k = (k_end - k_begin + kBK - 1) / kBK;
  a += blockIdx.y * a_g;
  b += blockIdx.y * b_g;
  c += blockIdx.z * c_split + (long long)blockIdx.y * M * N;

  auto load = [&](int st, int it) {
    const int k0 = k_begin + it * kBK;
    load_stage<BM, AKC>(sm.raw[st], a, lda, m0, M, k0, k_end, vec_a);
    load_stage<BN, BKC>(sm.raw[st] + kRaw<BM>, b, ldb, n0, N, k0, k_end, vec_b);
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_k) load(st, st);
    cp_async_commit();
  }

  // this warpgroup's 64 x 64 output: rows wm … wm + 63, columns wn … wn + 63 of the tile
  const int wg = threadIdx.x / 128;
  const int wm = BM == 128 ? 64 * wg : 0, wn = BM == 128 ? 0 : 64 * wg;
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t a_lo = offsetof(S, a_lo) + 4 * kBK * wm, a_hi = offsetof(S, a_hi) + 4 * kBK * wm;
  const uint32_t b_lo = offsetof(S, b_lo) + 4 * kBK * wn, b_hi = offsetof(S, b_hi) + 4 * kBK * wn;

  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 1>();  // this thread's copies of stage `it` have landed
    __syncthreads();               // everyone's; and both warpgroups' last wgmmas are done
    split_stage<BM, AKC>(sm.raw[it % kStages], sm.a_hi, sm.a_lo);
    split_stage<BN, BKC>(sm.raw[it % kStages] + kRaw<BM>, sm.b_hi, sm.b_lo);
    proxy_fence();
    __syncthreads();
    if (it + kStages < n_k) load(it % kStages, it + kStages);
    cp_async_commit();

    // the stage's products into `part`, small products first; the first
    // stage of a fold block overwrites it
    const int fresh = it % (kFold / kBK) == 0;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {  // bytes to positions 8ks … 8ks + 7 of a 64-row operand: 2048·ks
      wgmma_ss_n64(part, desc<64>(base16, a_lo + 2048 * ks), desc<64>(base16, b_hi + 2048 * ks), !(fresh && ks == 0));
      wgmma_ss_n64(part, desc<64>(base16, a_hi + 2048 * ks), desc<64>(base16, b_lo + 2048 * ks), 1);
    }
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks)
      wgmma_ss_n64(part, desc<64>(base16, a_hi + 2048 * ks), desc<64>(base16, b_hi + 2048 * ks), 1);
    wg_commit();
    wg_wait();
    pin(part);
    if (it % (kFold / kBK) == kFold / kBK - 1 || it == n_k - 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
    }
  }

  // The tile through shared memory (the operands' space, row stride BN + 8:
  // the fragments' float2 stores are conflict-free), then whole rows out.
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kLd = BN + 8;
  float* stage = sm.a_hi;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ra = wm + 16 * warp + g;  // rows ra and ra + 8; columns wn + 8j + 2t, + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(stage + ra * kLd + wn + 8 * j + 2 * t) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stage + (ra + 8) * kLd + wn + 8 * j + 2 * t) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  constexpr int kQ = BN / 4;  // float4s a row
#pragma unroll 4
  for (int j = threadIdx.x; j < BM * kQ; j += kThreads) {
    const int r = j / kQ, q = j % kQ, m = m0 + r, n = n0 + 4 * q;
    if (m >= M || n >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(stage + r * kLd + 4 * q);
    float* row = c + (long long)m * N;
    if (vec_c && n + 3 < N) {
      *reinterpret_cast<float4*>(row + n) = v;
    } else {
      row[n] = v.x;
      if (n + 1 < N) row[n + 1] = v.y;
      if (n + 2 < N) row[n + 2] = v.z;
      if (n + 3 < N) row[n + 3] = v.w;
    }
  }
}

__global__ void grouped_sum_kernel(const float* __restrict__ part, float* __restrict__ out, long long n,
                                   int splits) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int p = 1; p < splits; ++p) s += part[p * n + i];
  out[i] = s;
}

template <int BM, bool AKC, bool BKC>
cudaError_t launch_tc(dim3 grid, cudaStream_t st, const float* a, const float* b, float* c, int M, int N, int K,
                      int k_chunk, long long a_g, int lda, long long b_g, int ldb, long long c_split,
                      int vec_a, int vec_b, int vec_c) {
  constexpr int smem = sizeof(Smem<BM>);
  const cudaError_t e = cudaFuncSetAttribute(grouped_gemm_tc<BM, AKC, BKC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  grouped_gemm_tc<BM, AKC, BKC><<<grid, kThreads, smem, st>>>(a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb,
                                                              c_split, vec_a, vec_b, vec_c);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_tile(bool at, bool bt, dim3 grid, cudaStream_t st, const float* a, const float* b, float* c,
                        int M, int N, int K, int k_chunk, long long a_g, int lda, long long b_g,
                        int ldb, long long c_split, int vec_a, int vec_b, int vec_c) {
  if (!at && !bt)
    return launch_tc<BM, true, false>(grid, st, a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb, c_split, vec_a,
                                      vec_b, vec_c);
  if (!at && bt)
    return launch_tc<BM, true, true>(grid, st, a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb, c_split, vec_a,
                                     vec_b, vec_c);
  if (at && !bt)
    return launch_tc<BM, false, false>(grid, st, a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb, c_split, vec_a,
                                       vec_b, vec_c);
  return cudaErrorInvalidValue;  // both transposed: the wrapper copies one operand
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the largest offset of an operand's element within a group, rows x cols with
// leading stride ld (rows) and unit stride (cols), fits in 32 bits
bool span32(long long rows, long long cols, long long ld) {
  return ld >= 0 && ld < 0x7fffffffLL && (rows - 1) * ld + cols - 1 < 0x7fffffffLL;
}

}  // namespace

extern "C" {

// out [splits, G, M, N] (splits = ceil(K / k_chunk); with one split, C
// itself): out[s, g] = A[g][:, chunk s] · B[g][chunk s, :]. A element
// (m, k) is a[g·a_g + m·lda + k], or a[g·a_g + k·lda + m] when a_t; B
// element (k, n) is b[g·b_g + k·ldb + n], or b[g·b_g + n·ldb + k] when b_t.
// (bm, bn) is the output tile: 128 x 64 or 64 x 128. Returns the
// cudaError_t of the launch.
int grouped_gemm_launch(const float* a, const float* b, float* out, int G, int M, int N, int K, int a_t,
                        long long a_g, long long lda, int b_t, long long b_g, long long ldb, int bm, int bn,
                        int k_chunk, void* stream) {
  if (G < 1 || M < 1 || N < 1 || K < 1 || k_chunk < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  if (!((bm == 128 && bn == 64) || (bm == 64 && bn == 128))) return (int)cudaErrorInvalidValue;
  const int splits = (K + k_chunk - 1) / k_chunk;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool at = a_t != 0, bt = b_t != 0;
  if (!span32(at ? K : M, at ? M : K, lda) || !span32(bt ? N : K, bt ? K : N, ldb))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, G, splits);
  const long long c_split = (long long)G * M * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies where every 4-element chunk along the contiguous axis is
  // aligned and wholly in or out of range
  const bool chunk4 = splits == 1 || k_chunk % 4 == 0;
  const int vec_a = aligned16(a) && a_g % 4 == 0 && lda % 4 == 0 && (at ? M : K) % 4 == 0 && chunk4;
  const int vec_b = aligned16(b) && b_g % 4 == 0 && ldb % 4 == 0 && (bt ? K : N) % 4 == 0 && chunk4;
  const int vec_c = aligned16(out) && N % 4 == 0;
  if (bm == 128)
    return (int)launch_tile<128>(at, bt, grid, st, a, b, out, M, N, K, k_chunk, a_g, (int)lda, b_g, (int)ldb,
                                 c_split, vec_a, vec_b, vec_c);
  return (int)launch_tile<64>(at, bt, grid, st, a, b, out, M, N, K, k_chunk, a_g, (int)lda, b_g, (int)ldb,
                              c_split, vec_a, vec_b, vec_c);
}

// out [n] = Σ_{s < splits} part[s·n + i], added in s order.
int grouped_sum_launch(const float* part, float* out, long long n, int splits, void* stream) {
  if (n < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;  // one output element a thread
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grouped_sum_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(part, out, n, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
