// Grouped bf16 GEMM for Hopper (sm_90a): C[g] = A[g] · B[g] for every group g,
// bf16 operands on the tensor cores, f32 accumulators, C rounded to bf16 once.
//
// Replaces the JAX package's Pallas kernel in ops/grouped_gemm.py
// (grouped_matmul_pallas, pallas_call :74; _grouped_kernel :43) on bf16
// operands: a dot at Precision.HIGHEST with f32 accumulation, written in
// lhs's dtype. The switch MoE runs its experts through it under
// compute_dtype bfloat16 (models/moe.py).
//
//   grouped_gemm_bf16_launch  A [G, M, K] x B [G, K, N] -> C [G, M, N] bf16, or,
//                             split over the contraction, partials [S, G, M, N] f32
//   grouped_sum_bf16_launch   C = bf16(Σ_s partials[s]), summed in split order
//
// Either operand, but not both, may be a transposed view: A with M
// contiguous (the backward's Aᵀ·dC) or B with K contiguous (the backward's
// dC·Bᵀ). Unlike TF32, bf16 wgmma reads a shared operand K-major or
// MN-major, so every layout is read as it lies: no transposing copy.
//
// Arithmetic. bf16 products are exact in f32; the tensor cores add them
// into f32 accumulators; the output is rounded to bf16 (to nearest even)
// once, after the last term. With a split contraction the chunks' f32
// partials are added in split order by a second launch, then rounded.
//
// Bound on an H100 SXM at the switch-MoE ViT's fc1 forward (G = 24,
// M = 20,480, K = 64, N = 256): it moves ~315 MB (A 63 MB, B 0.8 MB, C 252
// MB), 0.094 ms at 3.35 TB/s; its 16.1 GFLOP take 0.016 ms at 989 TFLOP/s.
// The bytes bound it, as at every MoE ViT shape.
//
// Design (a simple kernel first):
//   * One block of two warpgroups (256 threads) per (group, output tile,
//     contraction split); each warpgroup owns a 64 x 64 output (m64n64k16
//     wgmmas), side by side in N (a 64 x 128 tile, where N > 64) or
//     stacked in M (128 x 64), as the f32 kernel (grouped_gemm.cu).
//   * The contraction streams in stages of 64 positions through a ring of
//     four stages (24 KB each; two blocks an SM). A stage holds each
//     operand as 64 x 64 slabs whose 128-byte lines run along the operand's
//     contiguous axis: rows of a K-major operand, contraction positions of
//     an MN-major one. cp.async copies 16 bytes a thread straight into the
//     slab with the 128-byte swizzle that `desc_sw` reads (chunk q of line
//     l at chunk q ^ (l % 8)). Where the rows are not 16-byte aligned (N =
//     9 bf16 is 18 bytes) the same launch loads element by element with
//     ordinary loads and stores; out-of-range rows and positions land as
//     zeros either way.
//   * The output is staged through shared memory in f32 and stored as
//     whole rows (16 bytes where the rows allow it); tails are masked.
//   * Every sum has a fixed order and there are no atomics: two launches
//     give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"
#include "tf32_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf16_wgmma::desc_sw;
using bf16_wgmma::wgmma_ss_bf16_n64_t;
using tf32_wgmma::cp_async_commit;
using tf32_wgmma::cp_async_wait;
using tf32_wgmma::pin;
using tf32_wgmma::proxy_fence;
using tf32_wgmma::wg_commit;
using tf32_wgmma::wg_fence;
using tf32_wgmma::wg_wait;

constexpr int kThreads = 256;         // two warpgroups
constexpr int kBK = 64;               // contraction positions a stage: one 128-byte line
constexpr int kStages = 4;            // depth of the ring
constexpr int kSlab = 64 * 64;        // bf16 of a 64 x 64 slab (8 KB, a multiple of the swizzle's 1 KB)
constexpr int kSlabBytes = 2 * kSlab;

template <int BM>
struct Smem {
  static constexpr int BN = BM == 128 ? 64 : 128;  // output tile BM x BN
  // a stage: A's BM / 64 slabs, then B's BN / 64
  alignas(1024) bf16 ring[kStages][(BM + BN) * kBK];
};
static_assert(sizeof(Smem<128>) + 1024 <= 232448 / 2 - 1024 && sizeof(Smem<64>) + 1024 <= 232448 / 2 - 1024,
              "two blocks an SM");
static_assert(128 * (64 + 8) * 4 <= (int)sizeof(Smem<128>) && 64 * (128 + 8) * 4 <= (int)sizeof(Smem<64>),
              "the output stages in the ring's space");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Element offset of column c of line l in a slab: 16-byte chunk c / 8 of
// the line swizzled by the line's place in its 8-line (1 KB) group.
__device__ __forceinline__ int swz(int l, int c) { return l * 64 + ((((c >> 3) ^ (l & 7)) << 3) | (c & 7)); }

// Positions [k0, k0 + kBK) of an R-row operand into its R / 64 slabs of a
// stage. KC: the contraction axis is contiguous (element (r, k) at
// src[r·ld + k]): a slab's line is a row, its columns the positions. Else
// (element (r, k) at src[k·ld + r]) a line is a position, its columns 64
// rows. Rows >= rows and positions >= kend land as 0. With `vec`, 16-byte
// copies: the launcher has checked that every 8-element chunk along the
// contiguous axis is aligned and wholly in or out of range, and that a
// group's offsets fit in 32 bits.
template <int R, bool KC>
__device__ __forceinline__ void load_stage(bf16* dst, const bf16* src, int ld, int r0, int rows, int k0, int kend,
                                           bool vec) {
  if (vec) {
    const uint32_t base = smem_u32(dst);
#pragma unroll
    for (int n = 0; n < R * kBK / 8 / kThreads; ++n) {
      const int j = threadIdx.x + n * kThreads;
      const int q = j % 8, l = j / 8 % 64, s = j / 512;
      const int gr = r0 + 64 * s + (KC ? l : 8 * q), gk = k0 + (KC ? 8 * q : l);
      const bool ok = gr < rows && gk < kend;
      const bf16* p = ok ? src + (KC ? gr * ld + gk : gk * ld + gr) : src;
      cp_async16_zfill(base + 2 * (s * kSlab + l * 64 + ((q ^ (l & 7)) << 3)), p, ok);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < R * kBK; e += kThreads) {
      const int c = e % 64, l = e / 64 % 64, s = e / 4096;
      const int gr = r0 + 64 * s + (KC ? l : c), gk = k0 + (KC ? c : l);
      const bool ok = gr < rows && gk < kend;
      dst[s * kSlab + swz(l, c)] = ok ? src[KC ? gr * ld + gk : gk * ld + gr] : __float2bfloat16_rn(0.f);
    }
  }
}

// out tile = A[g][:, chunk] · B[g][chunk, :], as bf16 C (f32_out = 0) or
// f32 partials of split blockIdx.z. Grid (output tiles, G, splits),
// kThreads threads, sizeof(Smem<BM>) + 1024 bytes of dynamic shared memory.
// AKC: A's contraction axis is contiguous (A row-major: read K-major);
// BKC: B's is (B a transposed view: read K-major; else MN-major).
template <int BM, bool AKC, bool BKC>
__global__ void __launch_bounds__(kThreads, 2)
grouped_gemm_bf16_tc(const bf16* __restrict__ a, const bf16* __restrict__ b, void* __restrict__ c, int M, int N,
                     int K, int k_chunk, long long a_g, int lda, long long b_g, int ldb, int f32_out, int vec_a,
                     int vec_b, int vec_c) {
  using S = Smem<BM>;
  constexpr int BN = S::BN;
  constexpr int kStageElems = (BM + BN) * kBK;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024);

  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int n_k = (k_end - k_begin + kBK - 1) / kBK;
  a += blockIdx.y * a_g;
  b += blockIdx.y * b_g;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) {
      load_stage<BM, AKC>(sm.ring[st], a, lda, m0, M, k_begin + st * kBK, k_end, vec_a);
      load_stage<BN, BKC>(sm.ring[st] + BM * kBK, b, ldb, n0, N, k_begin + st * kBK, k_end, vec_b);
    }
    cp_async_commit();
  }

  // this warpgroup's 64 x 64 output: rows wm … wm + 63, columns wn … wn + 63 of the tile
  const int wg = threadIdx.x / 128;
  const int wm = BM == 128 ? 64 * wg : 0, wn = BM == 128 ? 0 : 64 * wg;
  const uint32_t ring = smem_u32(sm.ring[0]);
  // a k16 step moves 32 bytes along a K-major line, 16 lines (2 KB) down an MN-major slab
  constexpr uint32_t kStepA = AKC ? 32 : 2048, kStepB = BKC ? 32 : 2048;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage `it` have landed
    proxy_fence();                 // its copies and stores, visible to wgmma
    __syncthreads();               // everyone's; and both warpgroups' products of stage it - 1 are done
    const int next = it + kStages - 1;
    if (next < n_k) {
      bf16* st = sm.ring[next % kStages];
      load_stage<BM, AKC>(st, a, lda, m0, M, k_begin + next * kBK, k_end, vec_a);
      load_stage<BN, BKC>(st + BM * kBK, b, ldb, n0, N, k_begin + next * kBK, k_end, vec_b);
    }
    cp_async_commit();

    const uint32_t sa = ring + 2 * (it % kStages) * kStageElems + (wm / 64) * kSlabBytes;
    const uint32_t sb = ring + 2 * (it % kStages) * kStageElems + (BM / 64 + wn / 64) * kSlabBytes;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      wgmma_ss_bf16_n64_t<AKC ? 0 : 1, BKC ? 0 : 1>(acc, desc_sw<64>(sa + kStepA * ks), desc_sw<64>(sb + kStepB * ks),
                                                   it > 0 || ks > 0);
    wg_commit();
    wg_wait();
    pin(acc);
  }

  // The tile through shared memory in f32 (the ring's space, row stride
  // BN + 8: the fragments' float2 stores are conflict-free), then whole rows out.
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kLd = BN + 8;
  float* stage = reinterpret_cast<float*>(sm.ring[0]);
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ra = wm + 16 * warp + g;  // rows ra and ra + 8; columns wn + 8j + 2t, + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(stage + ra * kLd + wn + 8 * j + 2 * t) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stage + (ra + 8) * kLd + wn + 8 * j + 2 * t) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  if (f32_out) {
    float* out = static_cast<float*>(c) + ((long long)blockIdx.z * gridDim.y + blockIdx.y) * M * N;
    constexpr int kQ = BN / 4;  // float4s a row
#pragma unroll 4
    for (int j = threadIdx.x; j < BM * kQ; j += kThreads) {
      const int r = j / kQ, q = j % kQ, m = m0 + r, n = n0 + 4 * q;
      if (m >= M || n >= N) continue;
      const float4 v = *reinterpret_cast<const float4*>(stage + r * kLd + 4 * q);
      float* row = out + (long long)m * N;
      if (vec_c && n + 3 < N) {
        *reinterpret_cast<float4*>(row + n) = v;
      } else {
        row[n] = v.x;
        if (n + 1 < N) row[n + 1] = v.y;
        if (n + 2 < N) row[n + 2] = v.z;
        if (n + 3 < N) row[n + 3] = v.w;
      }
    }
  } else {
    bf16* out = static_cast<bf16*>(c) + (long long)blockIdx.y * M * N;
    constexpr int kQ = BN / 8;  // 16-byte vectors of 8 bf16 a row
#pragma unroll 4
    for (int j = threadIdx.x; j < BM * kQ; j += kThreads) {
      const int r = j / kQ, q = j % kQ, m = m0 + r, n = n0 + 8 * q;
      if (m >= M || n >= N) continue;
      const float* v = stage + r * kLd + 8 * q;
      bf16* row = out + (long long)m * N;
      if (vec_c && n + 7 < N) {
        const float4 lo = *reinterpret_cast<const float4*>(v), hi = *reinterpret_cast<const float4*>(v + 4);
        uint4 w;
        w.x = bf16_wgmma::pack2(lo.x, lo.y);
        w.y = bf16_wgmma::pack2(lo.z, lo.w);
        w.z = bf16_wgmma::pack2(hi.x, hi.y);
        w.w = bf16_wgmma::pack2(hi.z, hi.w);
        *reinterpret_cast<uint4*>(row + n) = w;
      } else {
        for (int e = 0; e < 8 && n + e < N; ++e) row[n + e] = __float2bfloat16_rn(v[e]);
      }
    }
  }
}

__global__ void grouped_sum_bf16_kernel(const float* __restrict__ part, bf16* __restrict__ out, long long n,
                                        int splits) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int p = 1; p < splits; ++p) s += part[p * n + i];
  out[i] = __float2bfloat16_rn(s);
}

template <int BM, bool AKC, bool BKC>
cudaError_t launch_tc(dim3 grid, cudaStream_t st, const bf16* a, const bf16* b, void* c, int M, int N, int K,
                      int k_chunk, long long a_g, int lda, long long b_g, int ldb, int f32_out, int vec_a, int vec_b,
                      int vec_c) {
  constexpr int smem = sizeof(Smem<BM>) + 1024;  // 1 KB to align the ring for the swizzle
  const cudaError_t e = cudaFuncSetAttribute(grouped_gemm_bf16_tc<BM, AKC, BKC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  grouped_gemm_bf16_tc<BM, AKC, BKC><<<grid, kThreads, smem, st>>>(a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb,
                                                                   f32_out, vec_a, vec_b, vec_c);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_tile(bool at, bool bt, dim3 grid, cudaStream_t st, const bf16* a, const bf16* b, void* c, int M,
                        int N, int K, int k_chunk, long long a_g, int lda, long long b_g, int ldb, int f32_out,
                        int vec_a, int vec_b, int vec_c) {
  if (!at && !bt)
    return launch_tc<BM, true, false>(grid, st, a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb, f32_out, vec_a,
                                      vec_b, vec_c);
  if (!at && bt)
    return launch_tc<BM, true, true>(grid, st, a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb, f32_out, vec_a,
                                     vec_b, vec_c);
  if (at && !bt)
    return launch_tc<BM, false, false>(grid, st, a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb, f32_out, vec_a,
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

// With one split (K <= k_chunk), out is C [G, M, N] bf16; else out is f32
// partials [splits, G, M, N] (splits = ceil(K / k_chunk)): out[s, g] =
// A[g][:, chunk s] · B[g][chunk s, :]. A element (m, k) is a[g·a_g + m·lda +
// k], or a[g·a_g + k·lda + m] when a_t; B element (k, n) is b[g·b_g + k·ldb +
// n], or b[g·b_g + n·ldb + k] when b_t. (bm, bn) is the output tile: 128 x
// 64 or 64 x 128. Returns the cudaError_t of the launch.
int grouped_gemm_bf16_launch(const bf16* a, const bf16* b, void* out, int G, int M, int N, int K, int a_t,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int f32_out = splits > 1;
  // 16-byte copies where every 8-element chunk along the contiguous axis is
  // aligned and wholly in or out of range
  const bool chunk8 = splits == 1 || k_chunk % 8 == 0;
  const int vec_a = aligned16(a) && a_g % 8 == 0 && lda % 8 == 0 && (at ? M : K) % 8 == 0 && chunk8;
  const int vec_b = aligned16(b) && b_g % 8 == 0 && ldb % 8 == 0 && (bt ? K : N) % 8 == 0 && chunk8;
  const int vec_c = aligned16(out) && N % (f32_out ? 4 : 8) == 0;
  if (bm == 128)
    return (int)launch_tile<128>(at, bt, grid, st, a, b, out, M, N, K, k_chunk, a_g, (int)lda, b_g, (int)ldb,
                                 f32_out, vec_a, vec_b, vec_c);
  return (int)launch_tile<64>(at, bt, grid, st, a, b, out, M, N, K, k_chunk, a_g, (int)lda, b_g, (int)ldb, f32_out,
                              vec_a, vec_b, vec_c);
}

// out [n] = bf16(Σ_{s < splits} part[s·n + i]), added in s order, rounded once.
int grouped_sum_bf16_launch(const float* part, bf16* out, long long n, int splits, void* stream) {
  if (n < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;  // one output element a thread
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grouped_sum_bf16_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(part, out, n,
                                                                                              splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
