// Fused compact L-BFGS direction kernels for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas pair in ops/compact_pallas.py:
//
//   fused_gram_projections  (_gram_kernel)     -> compact_gram_launch
//     S Yᵀ, Y Yᵀ [m,m] and Sᵀg, Yᵀg [m] in ONE pass over S, Y [m,N], g [N]
//   fused_direction_assembly (_assembly_kernel) -> compact_assembly_launch
//     hg = γ·g + wᵀS − γ·(uᵀY) in ONE pass
//
// for K clients at once: S, Y are [K, m, N], g and hg [K, N], w and u
// [K, m], count (int32) and γ = h_diag (float) [K], all on the device, so
// no launch reads anything back to the host.
//
// Bound on an H100 SXM (3.35 TB/s): both kernels do ~2 flops per byte read,
// far below the f32 ridge, so bytes bound them.
//   gram:     (2·m·N + N)·4·K bytes read      -> at m=10, N=48,120, K=3:
//             12.1 MB, 3.6 µs
//   assembly: (2·m·N + 2·N)·4·K bytes moved   -> 12.7 MB, 3.8 µs
// At the main path's group sizes (456 … 48,120) a launch costs more than
// that, so launch overhead dominates; the design targets the large-N case
// (ResNet18 blocks, N in the millions) without tuning for it yet.
//
// Design. The TPU kernel walks N sequentially and accumulates in VMEM. On
// Hopper the blocks of a grid run in parallel and in no order, so:
//   * gram stage 1: a block per (N-chunk, client) stages (2m+1) rows x 256
//     columns of S, Y, g in shared memory (16-byte loads when rows are
//     16-byte aligned), then each thread owns one of the 2m²+2m outputs
//     and dots its two rows over the tile. A tile's sum is formed apart
//     and then added to the thread's running sum, which keeps rounding
//     error low over millions of columns. Each block writes its partials;
//   * gram stage 2: one thread per (client, output) sums the partials in
//     chunk order. No atomics: results are bitwise repeatable run to run;
//   * assembly: each thread owns 4 consecutive columns and sums over the
//     valid history rows — w and u sit in shared memory.
// Rows >= count[k] are masked by select (never loaded, treated as 0) and
// not by multiplication, because an invalid history row may hold NaN;
// columns >= N are masked the same way.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 16;      // history rows supported
constexpr int kThreads = 256;  // threads per block, every kernel
constexpr int kTile = 256;     // columns per shared-memory tile
constexpr int kStride = kTile + 1;  // padded row stride: conflict-free reads
constexpr int kOutPerThread = (2 * kMaxM * kMaxM + 2 * kMaxM + kThreads - 1) / kThreads;

// Output o of the 2m²+2m gram outputs -> the tile rows it dots together.
// Rows 0..m-1 hold S, m..2m-1 hold Y, 2m holds g.
// Layout: [S Yᵀ (m·m) | Y Yᵀ (m·m) | Sᵀg (m) | Yᵀg (m)].
__device__ __forceinline__ void gram_rows(int o, int m, int& a, int& b) {
  const int mm = m * m;
  if (o < mm) {
    a = o / m;
    b = m + o % m;
  } else if (o < 2 * mm) {
    const int r = o - mm;
    a = m + r / m;
    b = m + r % m;
  } else if (o < 2 * mm + m) {
    a = o - 2 * mm;
    b = 2 * m;
  } else {
    a = m + (o - 2 * mm - m);
    b = 2 * m;
  }
}

// Pointer to row r (0..2m) of client k, and whether the row is valid.
__device__ __forceinline__ const float* tile_row(const float* sk, const float* yk, const float* gk,
                                                 int r, int m, int cnt, long long n, bool& ok) {
  if (r < m) {
    ok = r < cnt;
    return sk + (long long)r * n;
  }
  if (r < 2 * m) {
    ok = (r - m) < cnt;
    return yk + (long long)(r - m) * n;
  }
  ok = true;
  return gk;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gram_partials_kernel(const float* __restrict__ s, const float* __restrict__ y,
                     const float* __restrict__ g, const int* __restrict__ count,
                     float* __restrict__ partial, int m, long long n, int chunks) {
  extern __shared__ float tile[];  // (2m+1) x kStride
  const int k = blockIdx.y;
  const int chunk = blockIdx.x;
  const int rows = 2 * m + 1;
  const int n_out = 2 * m * m + 2 * m;
  const int cnt = count[k];
  const float* sk = s + (long long)k * m * n;
  const float* yk = y + (long long)k * m * n;
  const float* gk = g + (long long)k * n;

  float acc[kOutPerThread];
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) acc[j] = 0.f;

  const long long n_tiles = (n + kTile - 1) / kTile;
  for (long long t = chunk; t < n_tiles; t += chunks) {
    const long long c0 = t * kTile;
    if (kVec) {
      // n % 4 == 0 and 16-byte aligned rows: a float4 is wholly in or out
      constexpr int kVecPerRow = kTile / 4;
      for (int e = threadIdx.x; e < rows * kVecPerRow; e += kThreads) {
        const int r = e / kVecPerRow;
        const int cv = e % kVecPerRow;
        const long long col = c0 + 4 * cv;
        bool ok;
        const float* base = tile_row(sk, yk, gk, r, m, cnt, n, ok);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok && col < n) v = __ldg(reinterpret_cast<const float4*>(base + col));
        float* dst = tile + r * kStride + 4 * cv;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      for (int e = threadIdx.x; e < rows * kTile; e += kThreads) {
        const int r = e / kTile;
        const int c = e % kTile;
        const long long col = c0 + c;
        bool ok;
        const float* base = tile_row(sk, yk, gk, r, m, cnt, n, ok);
        tile[r * kStride + c] = (ok && col < n) ? __ldg(base + col) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int o = threadIdx.x + j * kThreads;
      if (o < n_out) {
        int a, b;
        gram_rows(o, m, a, b);
        const float* A = tile + a * kStride;
        const float* B = tile + b * kStride;
        float part = 0.f;
#pragma unroll 8
        for (int c = 0; c < kTile; ++c) part = fmaf(A[c], B[c], part);
        acc[j] += part;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int o = threadIdx.x + j * kThreads;
    if (o < n_out) partial[((long long)k * chunks + chunk) * n_out + o] = acc[j];
  }
}

__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out, int n_out,
                   int chunks) {
  const int k = blockIdx.y;
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= n_out) return;
  const float* p = partial + (long long)k * chunks * n_out + o;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += p[(long long)c * n_out];
  out[(long long)k * n_out + o] = sum;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
assembly_kernel(const float* __restrict__ s, const float* __restrict__ y,
                const float* __restrict__ g, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ h_diag,
                const int* __restrict__ count, float* __restrict__ out, int m, long long n) {
  __shared__ float ws[kMaxM];
  __shared__ float us[kMaxM];
  const int k = blockIdx.y;
  if (threadIdx.x < m) {
    ws[threadIdx.x] = w[k * m + threadIdx.x];
    us[threadIdx.x] = u[k * m + threadIdx.x];
  }
  __syncthreads();
  const int rows = max(0, min(count[k], m));  // rows >= count are never read
  const float h = h_diag[k];
  const float* sk = s + (long long)k * m * n;
  const float* yk = y + (long long)k * m * n;
  const float* gk = g + (long long)k * n;
  float* ok_ = out + (long long)k * n;
  const long long col = 4 * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (col >= n) return;
  if (kVec) {
    const float4 gv = __ldg(reinterpret_cast<const float4*>(gk + col));
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < rows; ++i) {
      const float4 sv = __ldg(reinterpret_cast<const float4*>(sk + (long long)i * n + col));
      const float4 yv = __ldg(reinterpret_cast<const float4*>(yk + (long long)i * n + col));
      a.x = fmaf(ws[i], sv.x, a.x);
      a.y = fmaf(ws[i], sv.y, a.y);
      a.z = fmaf(ws[i], sv.z, a.z);
      a.w = fmaf(ws[i], sv.w, a.w);
      b.x = fmaf(us[i], yv.x, b.x);
      b.y = fmaf(us[i], yv.y, b.y);
      b.z = fmaf(us[i], yv.z, b.z);
      b.w = fmaf(us[i], yv.w, b.w);
    }
    float4 r;
    r.x = h * gv.x + a.x - h * b.x;
    r.y = h * gv.y + a.y - h * b.y;
    r.z = h * gv.z + a.z - h * b.z;
    r.w = h * gv.w + a.w - h * b.w;
    *reinterpret_cast<float4*>(ok_ + col) = r;
  } else {
    for (int c = 0; c < 4; ++c) {
      const long long cc = col + c;
      if (cc >= n) break;
      float a = 0.f, b = 0.f;
      for (int i = 0; i < rows; ++i) {
        a = fmaf(ws[i], __ldg(sk + (long long)i * n + cc), a);
        b = fmaf(us[i], __ldg(yk + (long long)i * n + cc), b);
      }
      ok_[cc] = h * __ldg(gk + cc) + a - h * b;
    }
  }
}

}  // namespace

extern "C" {

// Gram stage 1 + stage 2 on `stream`. partial: [K, chunks, 2m²+2m]
// scratch; out: [K, 2m²+2m]. Returns the cudaError_t of the launches.
int compact_gram_launch(const float* s, const float* y, const float* g, const int* count,
                        float* partial, float* out, int K, int m, long long n, int chunks,
                        int vec, void* stream) {
  if (m < 1 || m > kMaxM || K < 1 || chunks < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(2 * m + 1) * kStride * sizeof(float);
  const dim3 grid1(chunks, K);
  if (vec)
    gram_partials_kernel<true><<<grid1, kThreads, smem, st>>>(s, y, g, count, partial, m, n, chunks);
  else
    gram_partials_kernel<false><<<grid1, kThreads, smem, st>>>(s, y, g, count, partial, m, n, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_out = 2 * m * m + 2 * m;
  const dim3 grid2((n_out + kThreads - 1) / kThreads, K);
  gram_reduce_kernel<<<grid2, kThreads, 0, st>>>(partial, out, n_out, chunks);
  return (int)cudaGetLastError();
}

// Assembly on `stream`: out [K, N] = γ·g + wᵀS − γ·(uᵀY).
int compact_assembly_launch(const float* s, const float* y, const float* g, const float* w,
                            const float* u, const float* h_diag, const int* count, float* out,
                            int K, int m, long long n, int vec, void* stream) {
  if (m < 1 || m > kMaxM || K < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cols_per_block = 4LL * kThreads;
  const dim3 grid((unsigned)((n + cols_per_block - 1) / cols_per_block), K);
  if (vec)
    assembly_kernel<true><<<grid, kThreads, 0, st>>>(s, y, g, w, u, h_diag, count, out, m, n);
  else
    assembly_kernel<false><<<grid, kThreads, 0, st>>>(s, y, g, w, u, h_diag, count, out, m, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
