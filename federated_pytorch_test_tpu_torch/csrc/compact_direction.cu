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
// that: the gram's serial steps (a tile, the lane sums, the ticket, the
// chunk sum) take ~9 µs on an H100 even at N = 456, so launch and latency
// dominate there; at N in the millions (ResNet18 blocks) the bytes do.
//
// Design. The TPU kernel walks N sequentially and accumulates in VMEM. On
// Hopper the blocks of a grid run in parallel and in no order, so:
//   * gram, one launch: a block per (chunk of 256-column tiles, client)
//     stages (2m+1) rows x 256 columns of S, Y, g in shared memory (16-byte
//     cp.async copies when rows are 16-byte aligned, through a ring of
//     four tiles); each of 512 threads owns four rows of [S; Y] against
//     every row of [Y; g] over every 64th float4 of the tile's columns
//     (register-blocked, so shared-memory loads do not set the pace). The
//     block sums its column lanes in a fixed order and writes its
//     partials; the last block of the client to finish (a ticket counter)
//     adds them in chunk order. The ticket is the only atomic: results
//     are bitwise repeatable run to run;
//   * assembly: each thread owns 4 consecutive columns and sums over the
//     valid history rows — w and u sit in shared memory.
// Rows >= count[k] are masked by select (never loaded, treated as 0) and
// not by multiplication, because an invalid history row may hold NaN;
// columns >= N are masked the same way.

#include <cuda_runtime.h>

#include "tf32_wgmma.cuh"  // the cp.async helpers

namespace {

using namespace tf32_wgmma;

constexpr int kMaxM = 16;      // history rows supported
constexpr int kThreads = 256;  // threads per block of the assembly
constexpr int kTile = 256;     // columns per gram tile
constexpr int kStride = kTile + 4;  // padded row stride: 16-byte rows, conflict-free float4 reads
constexpr int kSlots = 8;     // gram row slots: thread t owns rows t % 8 + 8i of [S; Y]
constexpr int kRowsA = 2 * kMaxM / kSlots;  // ... i < kRowsA
constexpr int kGramThreads = 512;  // the gram's block: 16 warps an SM to hide its loads' and FMAs' latency
constexpr int kLanes = kGramThreads / kSlots;  // gram column lanes: thread t takes lane t / 8
constexpr int kMaxOut = 2 * kMaxM * kMaxM + 2 * kMaxM;  // gram outputs, at most
constexpr int kMaxChunks = 128;  // gram blocks per client, at most (the wrapper takes up to 44)
constexpr int kGramStages = 4;  // depth of the gram's tile ring: enough bytes in flight to stream

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

// The gram in one launch. With X = [S; Y; g] (rows 0..2m), its 2m²+2m
// outputs are the block of X Xᵀ with rows a in [0, 2m) (S and Y) and
// columns b in [0, m] (Y and g); output (a, b) sits at a·m + b for b < m
// (S Yᵀ, then Y Yᵀ) and at 2m² + a for b = m (Sᵀg, then Yᵀg).
//
// A block per (chunk of `tpb` column tiles, client). A tile (2m+1 rows x
// kTile columns) is staged in shared memory by cp.async through a ring of
// kGramStages buffers, the next tiles in flight while one is summed. Thread
// t owns rows a = t % 8 + 8i of [S; Y] against every b (register-blocked:
// per float4 of columns, 4 + m + 1 shared loads for 16·(m + 1) FMAs) over
// the columns 4·(t / 8) of each tile, so shared-memory loads do not set
// the pace. The block's 64 column lanes are summed in a fixed order
// (in groups of eight, then the groups), the block's partials
// written, and the last block of a client to finish (a ticket counter, the
// only atomic) adds the chunks' partials in chunk order and resets the
// ticket. Every sum has a fixed order: bitwise repeatable.
template <bool kVec>
__global__ void __launch_bounds__(kGramThreads, 1)
gram_kernel(const float* __restrict__ s, const float* __restrict__ y, const float* __restrict__ g,
            const int* __restrict__ count, float* __restrict__ partial, unsigned* __restrict__ ticket,
            float* __restrict__ out, int m, long long n, int tpb) {
  extern __shared__ __align__(16) float tile[];  // kGramStages buffers of (2m+1) x kStride; then the lanes' sums
  __shared__ bool last;
  const int k = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int rows = 2 * m + 1, n_out = 2 * m * m + 2 * m;
  const int cnt = count[k];
  const float* sk = s + (long long)k * m * n;
  const float* yk = y + (long long)k * m * n;
  const float* gk = g + (long long)k * n;
  const int p = threadIdx.x % kSlots, lane = threadIdx.x / kSlots;

  float acc[kRowsA][kMaxM + 1];
#pragma unroll
  for (int i = 0; i < kRowsA; ++i)
#pragma unroll
    for (int b = 0; b <= kMaxM; ++b) acc[i][b] = 0.f;

  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long t_begin = (long long)chunk * tpb, t_end = min(n_tiles, t_begin + tpb);
  // cp.async of tile t into buffer `buf`; invalid rows and columns past N
  // land as 0 without being read
  auto load = [&](long long t, int buf) {
    const long long c0 = t * kTile;
    float* dst = tile + buf * rows * kStride;
    if (kVec) {  // n % 4 == 0 and 16-byte aligned rows: a float4 is wholly in or out
      for (int e = threadIdx.x; e < rows * (kTile / 4); e += kGramThreads) {
        const int r = e / (kTile / 4), cv = e % (kTile / 4);
        const long long col = c0 + 4 * cv;
        bool ok;
        const float* base = tile_row(sk, yk, gk, r, m, cnt, n, ok);
        ok = ok && col < n;
        cp_async16_zfill(dst + r * kStride + 4 * cv, ok ? base + col : gk, ok);
      }
    } else {
      for (int e = threadIdx.x; e < rows * kTile; e += kGramThreads) {
        const int r = e / kTile, cc = e % kTile;
        const long long col = c0 + cc;
        bool ok;
        const float* base = tile_row(sk, yk, gk, r, m, cnt, n, ok);
        ok = ok && col < n;
        cp_async4_zfill(dst + r * kStride + cc, ok ? base + col : gk, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kGramStages - 1; ++i) {
    if (t_begin + i < t_end)
      load(t_begin + i, i);
    else
      cp_async_commit();
  }
  for (long long t = t_begin; t < t_end; ++t) {
    const int i = (int)(t - t_begin);
    if (t + kGramStages - 1 < t_end)  // in flight while this tile is summed
      load(t + kGramStages - 1, (i + kGramStages - 1) % kGramStages);
    else
      cp_async_commit();
    cp_async_wait<kGramStages - 1>();  // tile t has landed
    __syncthreads();
    const float* cur = tile + (i % kGramStages) * rows * kStride;
#pragma unroll
    for (int q = 0; q < kTile / 4 / kLanes; ++q) {
      const int col = 4 * lane + 4 * kLanes * q;
      float4 x[kRowsA];
#pragma unroll
      for (int r = 0; r < kRowsA; ++r)
        x[r] = p + kSlots * r < 2 * m ? *reinterpret_cast<const float4*>(cur + (p + kSlots * r) * kStride + col)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int b = 0; b <= kMaxM; ++b) {
        if (b > m) break;
        const float4 w = *reinterpret_cast<const float4*>(cur + (m + b) * kStride + col);
#pragma unroll
        for (int r = 0; r < kRowsA; ++r)
          if (kSlots * r < 2 * m)  // the same for every thread: slots past the rows are skipped
            acc[r][b] = fmaf(x[r].w, w.w, fmaf(x[r].z, w.z, fmaf(x[r].y, w.y, fmaf(x[r].x, w.x, acc[r][b]))));
      }
    }
    __syncthreads();
  }

  // the block's sum over its kLanes column lanes through shared memory, in
  // a fixed order: lanes 8j … 8j + 7 in order (eight groups at once), then
  // the groups in order
  float* lanes = tile;                    // [kLanes][n_out]
  float* groups = tile + kLanes * n_out;  // [kLanes / 8][n_out]
#pragma unroll
  for (int r = 0; r < kRowsA; ++r) {
    const int a = p + kSlots * r;
#pragma unroll
    for (int b = 0; b <= kMaxM; ++b)
      if (a < 2 * m && b <= m) lanes[lane * n_out + (b < m ? a * m + b : 2 * m * m + a)] = acc[r][b];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kLanes / 8 * n_out; e += kGramThreads) {
    const int o = e % n_out, j = e / n_out;
    float sum = lanes[8 * j * n_out + o];
#pragma unroll
    for (int l = 1; l < 8; ++l) sum += lanes[(8 * j + l) * n_out + o];
    groups[j * n_out + o] = sum;
  }
  __syncthreads();
  float* mine = partial + ((long long)k * chunks + chunk) * n_out;
  for (int o = threadIdx.x; o < n_out; o += kGramThreads) {
    float sum = groups[o];
#pragma unroll
    for (int j = 1; j < kLanes / 8; ++j) sum += groups[j * n_out + o];
    mine[o] = sum;
  }
  // the last block of this client to finish adds every chunk's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket + k, 1u) == (unsigned)chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the partials pass through shared memory (all loads in flight at once),
  // then each output adds them in chunk order
  const float* pk = partial + (long long)k * chunks * n_out;
  const int per_pass = kGramStages * rows * kStride / n_out;  // chunks staged at once
  constexpr int kOutPerThread = (kMaxOut + kGramThreads - 1) / kGramThreads;
  float sum[kOutPerThread];
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) sum[j] = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += per_pass) {
    const int nc = min(per_pass, chunks - c0);
#pragma unroll 16
    for (int e = threadIdx.x; e < nc * n_out; e += kGramThreads) tile[e] = __ldcg(pk + (long long)c0 * n_out + e);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int o = threadIdx.x + j * kGramThreads;
      if (o < n_out)
        for (int c = 0; c < nc; ++c) sum[j] += tile[c * n_out + o];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int o = threadIdx.x + j * kGramThreads;
    if (o < n_out) out[(long long)k * n_out + o] = sum[j];
  }
  if (threadIdx.x == 0) ticket[k] = 0u;  // ready for the next launch on the stream
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

// The gram on `stream`, one launch: out [K, 2m²+2m]. partial: [K, chunks,
// 2m²+2m] scratch; ticket: [K] counters, 0 before the launch and left 0
// after it. Returns the cudaError_t of the launch.
int compact_gram_launch(const float* s, const float* y, const float* g, const int* count, float* partial,
                        unsigned* ticket, float* out, int K, int m, long long n, int chunks, int tpb, int vec,
                        void* stream) {
  if (m < 1 || m > kMaxM || K < 1 || K > 65535 || chunks < 1 || chunks > kMaxChunks || tpb < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + kTile - 1) / kTile;
  if ((long long)(chunks - 1) * tpb >= n_tiles || (long long)chunks * tpb < n_tiles)
    return (int)cudaErrorInvalidValue;  // every block takes at least one tile, and they cover N
  const int n_out = 2 * m * m + 2 * m;
  const int smem = max(kGramStages * (2 * m + 1) * kStride, (kLanes + kLanes / 8) * n_out) * (int)sizeof(float);
  const dim3 grid(chunks, K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = vec ? gram_kernel<true> : gram_kernel<false>;
  // above 48 KB a kernel needs the opt-in, once per instance (for the
  // largest history; the process's one card)
  static bool opted_in[2] = {false, false};
  if (!opted_in[vec ? 1 : 0]) {
    constexpr int kMaxSmem = (kGramStages * (2 * kMaxM + 1) * kStride > (kLanes + kLanes / 8) * kMaxOut
                                  ? kGramStages * (2 * kMaxM + 1) * kStride
                                  : (kLanes + kLanes / 8) * kMaxOut) * (int)sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in[vec ? 1 : 0] = true;
  }
  kernel<<<grid, kGramThreads, smem, st>>>(s, y, g, count, partial, ticket, out, m, n, tpb);
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
