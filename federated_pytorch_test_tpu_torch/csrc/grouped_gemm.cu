// Grouped f32 GEMM for Hopper (sm_90a): C[g] = A[g] · B[g] for every group g.
//
// Replaces the JAX package's Pallas kernel in ops/grouped_gemm.py
// (grouped_matmul_pallas, pallas_call :74; _grouped_kernel :43): a grid
// over (group, 256-row M tile, 256-column N tile) with K untiled, f32
// accumulation at Precision.HIGHEST.
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
// Bound on an H100 SXM at the switch-MoE ViT's shapes (G = 24, M = 20,480,
// K = 64, N = 256): 16.1 GFLOP and ~631 MB moved. The bytes take 0.19 ms
// at 3.35 TB/s, f32 FFMA at 67 TFLOP/s 0.24 ms, so an FFMA design is
// bounded by its operations. The weight gradient contracts over M = 20,480
// rows into [64, 256] per group: only 48 output tiles, so it is split.
//
// Design. The TPU kernel keeps K whole in VMEM and leaves M/N tails to
// block padding. On Hopper the blocks run in parallel with 227 KB of shared
// memory at most, so:
//   * one block per (group, BM x BN output tile, contraction split), BM x BN
//     one of 128 x 128, 128 x 64, 64 x 128 (the wrapper picks by M and N);
//     (BM/8)·(BN/8) threads, each owning an 8 x 8 register
//     tile (rows ty·4 + i and BM/2 + ty·4 + i, columns likewise, so the
//     float4 reads of shared memory are conflict-free);
//   * the contraction walks in chunks of 16 through two shared-memory
//     buffers: the next chunk is loaded into registers while the current
//     one is multiplied with FFMA, one barrier a chunk;
//   * tails are masked: out-of-range A, B elements load as 0 (so they add
//     +0 to a sum) and out-of-range C elements are not stored;
//   * every output is one thread's sequential fmaf over its split's
//     contraction, and the splits are added in order by a second launch:
//     no atomics, so two launches give equal bits.
// Split TF32 on wgmma and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTK = 16;  // contraction chunk staged in shared memory
constexpr int kPad = 4;  // row padding of the staged tiles: keeps float4 alignment, spreads the transposing stores

template <int BM, int BN, bool AT, bool BT>
__global__ void __launch_bounds__((BM / 8) * (BN / 8))
grouped_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c, int M,
                    int N, int K, int k_chunk, long long a_g, long long lda, long long b_g, long long ldb,
                    long long c_split) {
  constexpr int TX = BN / 8, TY = BM / 8, NT = TX * TY;
  constexpr int A_PER = BM * kTK / NT, B_PER = BN * kTK / NT;
  static_assert((BM * kTK) % NT == 0 && (BN * kTK) % NT == 0, "each thread loads an equal share of a chunk");
  __shared__ __align__(16) float As[2][kTK][BM + kPad];
  __shared__ __align__(16) float Bs[2][kTK][BN + kPad];

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * BM, n0 = (blockIdx.x % n_tiles) * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  a += blockIdx.y * a_g;
  b += blockIdx.y * b_g;
  c += blockIdx.z * c_split + (long long)blockIdx.y * M * N;

  float ra[A_PER], rb[B_PER];
  // Element r of this thread's share of a chunk: (row, col) in the tile.
  // A tile is BM x kTK, B tile kTK x BN; consecutive threads take the
  // operand's contiguous axis, so global loads are coalesced.
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const int i = tid + r * NT;
      const int mm = AT ? i % BM : i / kTK, kk = AT ? i / BM : i % kTK;
      const int m = m0 + mm, k = k0 + kk;
      const long long off = AT ? (long long)k * lda + m : (long long)m * lda + k;
      ra[r] = (m < M && k < k_end) ? __ldg(a + off) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < B_PER; ++r) {
      const int i = tid + r * NT;
      const int nn = BT ? i / kTK : i % BN, kk = BT ? i % kTK : i / BN;
      const int n = n0 + nn, k = k0 + kk;
      const long long off = BT ? (long long)n * ldb + k : (long long)k * ldb + n;
      rb[r] = (n < N && k < k_end) ? __ldg(b + off) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < A_PER; ++r) {
      const int i = tid + r * NT;
      As[buf][AT ? i / BM : i % kTK][AT ? i % BM : i / kTK] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < B_PER; ++r) {
      const int i = tid + r * NT;
      Bs[buf][BT ? i % kTK : i / BN][BT ? i / kTK : i % BN] = rb[r];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(k_begin);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    const bool next = k0 + kTK < k_end;
    if (next) load(k0 + kTK);
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][BN / 2 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  const bool vec = (N % 4) == 0;  // rows of C start on 16 bytes
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (m >= M) continue;
    float* row = c + (long long)m * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      if (vec && n + 3 < N) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) row[n + j] = acc[i][h * 4 + j];
      }
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

template <int BM, int BN>
cudaError_t launch_tile(bool at, bool bt, dim3 grid, cudaStream_t st, const float* a, const float* b, float* c,
                        int M, int N, int K, int k_chunk, long long a_g, long long lda, long long b_g,
                        long long ldb, long long c_split) {
  constexpr int threads = (BM / 8) * (BN / 8);
  if (!at && !bt)
    grouped_gemm_kernel<BM, BN, false, false><<<grid, threads, 0, st>>>(a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb, c_split);
  else if (!at && bt)
    grouped_gemm_kernel<BM, BN, false, true><<<grid, threads, 0, st>>>(a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb, c_split);
  else if (at && !bt)
    grouped_gemm_kernel<BM, BN, true, false><<<grid, threads, 0, st>>>(a, b, c, M, N, K, k_chunk, a_g, lda, b_g, ldb, c_split);
  else
    return cudaErrorInvalidValue;  // both transposed: the wrapper copies one operand
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [splits, G, M, N] (splits = ceil(K / k_chunk); with one split, C
// itself): out[s, g] = A[g][:, chunk s] · B[g][chunk s, :]. A element
// (m, k) is a[g·a_g + m·lda + k], or a[g·a_g + k·lda + m] when a_t; B
// element (k, n) is b[g·b_g + k·ldb + n], or b[g·b_g + n·ldb + k] when b_t.
// Returns the cudaError_t of the launch.
int grouped_gemm_launch(const float* a, const float* b, float* out, int G, int M, int N, int K, int a_t,
                        long long a_g, long long lda, int b_t, long long b_g, long long ldb, int bm, int bn,
                        int k_chunk, void* stream) {
  if (G < 1 || M < 1 || N < 1 || K < 1 || k_chunk < 1 || G > 65535) return (int)cudaErrorInvalidValue;
  const int splits = (K + k_chunk - 1) / k_chunk;
  if (splits > 65535) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, G, splits);
  const long long c_split = (long long)G * M * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool at = a_t != 0, bt = b_t != 0;
  if (bm == 128 && bn == 128)
    return (int)launch_tile<128, 128>(at, bt, grid, st, a, b, out, M, N, K, k_chunk, a_g, lda, b_g, ldb, c_split);
  if (bm == 128 && bn == 64)
    return (int)launch_tile<128, 64>(at, bt, grid, st, a, b, out, M, N, K, k_chunk, a_g, lda, b_g, ldb, c_split);
  if (bm == 64 && bn == 128)
    return (int)launch_tile<64, 128>(at, bt, grid, st, a, b, out, M, N, K, k_chunk, a_g, lda, b_g, ldb, c_split);
  return (int)cudaErrorInvalidValue;
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
