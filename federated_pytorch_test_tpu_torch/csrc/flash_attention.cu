// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Two families. The rectangular one (below the aligned kernels) replaces
// `_fwd` (pallas_call :601, `_fwd_kernel`) and `_flash3_bwd` (:721
// `_bwd_dq_kernel`, :744 `_bwd_dkv_kernel`): q [BH, Sq, D] against k, v
// [BH, Skv, D], non-causal or causal on global offsets (q_off, k_off) —
// the path of `flash_attention(..., causal=False)` (the ViT) and of
// `flash_block`. At the ViT path's shape (BH = 6144, S = 256, D = 16) the
// non-causal pairs are BH·S² = 4.0e8: 25.8, 38.7 and 51.5 GFLOP, 0.385,
// 0.577 and 0.769 ms at 67 TFLOP/s against ~30 µs per 100.7 MB operand,
// so operations bound them too. Same design as the aligned kernels; every
// block of a non-causal call does equal work, so blocks launch in order.
//
// The aligned family replaces the aligned-causal Pallas kernels of the JAX
// package's ops/flash_attention.py (the path `flash_attention(...,
// causal=True)` takes, through the `_flash3` custom VJP):
//
//   _fwd_tri     (_fwd_kernel_tri)     -> flash_fwd_launch
//     o = softmax(q kᵀ·scale, causal) v and the natural-log row
//     logsumexp lse, per (batch·head)
//   _bwd_tri dq  (_bwd_dq_kernel_tri)  -> flash_bwd_dq_launch
//     dq = scale · Σ_j dS_ij k_j,  dS = P ∘ (dO vᵀ − delta)
//   _bwd_tri dkv (_bwd_dkv_kernel_tri) -> flash_bwd_dkv_launch
//     dv = Σ_i P_ijᵀ dO_i,  dk = scale · Σ_i dS_ijᵀ q_i
//
// with P recomputed from (q, k, lse) and delta = rowsum(dO ∘ o) formed by
// the caller. Tensors are f32, contiguous [BH, S, D]; lse and delta [BH, S].
//
// Bound on an H100 SXM at the LM path's shape (BH = 128, S = 2048,
// D = 16): the causal triangle holds BH·S(S+1)/2 = 2.7e8 (query, key)
// pairs and each product costs 2·D flops per pair, so the forward's two
// products are 17.2 GFLOP, dq's three 25.8 and dk/dv's four 34.4: 0.26,
// 0.39 and 0.51 ms at the 67 TFLOP/s of f32 outside the tensor cores.
// Each operand is 16.8 MB, read once in ~5 µs: operations bound all three.
//
// Design (a plain FFMA kernel in f32; tensor cores are later work).
//   * A block owns 128 rows of one (batch·head): query rows for fwd and dq,
//     key rows for dk/dv. T = D/16 neighbouring threads share a row, each
//     holding 16 of its D columns in registers; a dot product is each
//     thread's 16 FMAs summed across its T lanes with warp shuffles.
//   * The other operand streams through shared memory in tiles of 64
//     rows. Every thread of a warp reads the same tile row at once, a
//     broadcast.
//   * Causal: a query block reads key tiles 0 … its diagonal, a key block
//     reads query tiles from its diagonal to S, so the ~S²/2 work of the
//     TPU's triangular grid is all that is done. Pairs past the diagonal
//     inside the diagonal tiles are masked by select, never by a branch.
//   * The forward keeps the running max m and sum l in registers and
//     rescales the accumulator once per 16 keys (online softmax in the
//     natural-log domain: the TPU path's exp2 prescale served bf16 only).
//   * Each output row is owned by one block: no atomics, bitwise repeatable.
//   * Query blocks launch heaviest first (the last rows see the most keys).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;  // rows a block owns
constexpr int kTile = 64;   // rows of the streamed operand per shared-memory tile
constexpr int kLane = 16;   // head-dim columns per thread
constexpr int kChunk = 16;  // keys per online-softmax rescale (forward)

// Sum over the T lanes that share a row (neighbouring lanes of one warp);
// every lane ends with the same, bitwise equal, value.
template <int T>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = T / 2; off >= 1; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load16(float* dst, const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = s4[i];
    dst[4 * i] = x.x;
    dst[4 * i + 1] = x.y;
    dst[4 * i + 2] = x.z;
    dst[4 * i + 3] = x.w;
  }
}

__device__ __forceinline__ void store16(float* dst, const float* src, float mul) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d4[i] = make_float4(src[4 * i] * mul, src[4 * i + 1] * mul, src[4 * i + 2] * mul, src[4 * i + 3] * mul);
}

__device__ __forceinline__ float dot16(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kLane; ++i) acc = fmaf(a[i], b[i], acc);
  return acc;
}

// rows [row0, row0 + kTile) of a [S, D] matrix into shared memory, 16 bytes a load
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0) {
  const float4* s4 = reinterpret_cast<const float4*>(src + (size_t)row0 * D);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < kTile * D / 4; i += blockDim.x) d4[i] = s4[i];
}

template <int D>
__global__ void __launch_bounds__(kRows * (D / kLane))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, float* __restrict__ lse, int S, float scale) {
  constexpr int T = D / kLane;
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const int r = threadIdx.x / T, t = threadIdx.x % T;
  const int row = row0 + r;
  const size_t base = (size_t)bh * S * D;
  const float* kb = k + base;
  const float* vb = v + base;

  float qr[kLane], acc[kLane];
  load16(qr, q + base + (size_t)row * D + t * kLane);
#pragma unroll
  for (int i = 0; i < kLane; ++i) acc[i] = 0.f;
  float m = -1e30f;  // finite: m − m_new is never inf − inf
  float l = 0.f;

  const int kend = row0 + kRows;  // keys past the block's last row are never read
  for (int kt = 0; kt < kend; kt += kTile) {
    __syncthreads();
    load_tile<D>(ks, kb, kt);
    load_tile<D>(vs, vb, kt);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float kr[kLane];
        load16(kr, ks + (c0 + c) * D + t * kLane);
        const float dot = row_sum<T>(dot16(qr, kr));
        s[c] = (kt + c0 + c <= row) ? dot * scale : -INFINITY;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < kLane; ++i) acc[i] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = expf(s[c] - m_new);  // 0 where masked
        l += p;
        float vr[kLane];
        load16(vr, vs + (c0 + c) * D + t * kLane);
#pragma unroll
        for (int i = 0; i < kLane; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
      }
      m = m_new;
    }
  }
  // every causal row sees its own key, so l >= 1
  store16(o + base + (size_t)row * D + t * kLane, acc, 1.f / l);
  if (t == 0) lse[(size_t)bh * S + row] = m + logf(l);
}

template <int D>
__global__ void __launch_bounds__(kRows * (D / kLane))
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int S, float scale) {
  constexpr int T = D / kLane;
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int r = threadIdx.x / T, t = threadIdx.x % T;
  const int row = row0 + r;
  const size_t base = (size_t)bh * S * D;
  const float* kb = k + base;
  const float* vb = v + base;

  float qr[kLane], dor[kLane], acc[kLane];
  load16(qr, q + base + (size_t)row * D + t * kLane);
  load16(dor, dout + base + (size_t)row * D + t * kLane);
#pragma unroll
  for (int i = 0; i < kLane; ++i) acc[i] = 0.f;
  const float lse_r = lse[(size_t)bh * S + row];
  const float delta_r = delta[(size_t)bh * S + row];

  const int kend = row0 + kRows;
  for (int kt = 0; kt < kend; kt += kTile) {
    __syncthreads();
    load_tile<D>(ks, kb, kt);
    load_tile<D>(vs, vb, kt);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kr[kLane], vr[kLane];
      load16(kr, ks + c * D + t * kLane);
      load16(vr, vs + c * D + t * kLane);
      const float sc = row_sum<T>(dot16(qr, kr)) * scale;
      const float dp = row_sum<T>(dot16(dor, vr));
      const float p = (kt + c <= row) ? expf(sc - lse_r) : 0.f;
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int i = 0; i < kLane; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
  }
  store16(dq + base + (size_t)row * D + t * kLane, acc, scale);
}

template <int D>
__global__ void __launch_bounds__(kRows * (D / kLane))
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                     int S, float scale) {
  constexpr int T = D / kLane;
  __shared__ __align__(16) float qs[kTile * D];
  __shared__ __align__(16) float dos[kTile * D];
  __shared__ float lses[kTile];
  __shared__ float deltas[kTile];
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;  // key rows; the first blocks see the most queries
  const int r = threadIdx.x / T, t = threadIdx.x % T;
  const int key = row0 + r;
  const size_t base = (size_t)bh * S * D;
  const float* qb = q + base;
  const float* dob = dout + base;

  float kr[kLane], vr[kLane], dka[kLane], dva[kLane];
  load16(kr, k + base + (size_t)key * D + t * kLane);
  load16(vr, v + base + (size_t)key * D + t * kLane);
#pragma unroll
  for (int i = 0; i < kLane; ++i) dka[i] = dva[i] = 0.f;

  // queries before row0 see none of this block's keys
  for (int qt = row0; qt < S; qt += kTile) {
    __syncthreads();
    load_tile<D>(qs, qb, qt);
    load_tile<D>(dos, dob, qt);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      lses[i] = lse[(size_t)bh * S + qt + i];
      deltas[i] = delta[(size_t)bh * S + qt + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float qv[kLane], dov[kLane];
      load16(qv, qs + c * D + t * kLane);
      load16(dov, dos + c * D + t * kLane);
      const float sc = row_sum<T>(dot16(kr, qv)) * scale;
      const float dp = row_sum<T>(dot16(vr, dov));
      const float p = (key <= qt + c) ? expf(sc - lses[c]) : 0.f;
      const float ds = p * (dp - deltas[c]);
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        dva[i] = fmaf(p, dov[i], dva[i]);
        dka[i] = fmaf(ds, qv[i], dka[i]);
      }
    }
  }
  store16(dk + base + (size_t)key * D + t * kLane, dka, scale);
  store16(dv + base + (size_t)key * D + t * kLane, dva, 1.f);
}

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

template <int D, bool Causal>
__global__ void __launch_bounds__(kRows * (D / kLane))
flash_fwd_rect_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      float* __restrict__ o, float* __restrict__ lse, int s_q, int s_kv, int shift,
                      float scale) {
  constexpr int T = D / kLane;
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;  // blocks are equal unless causal: plain order
  const int r = threadIdx.x / T, t = threadIdx.x % T;
  const int row = row0 + r;
  const size_t qbase = (size_t)bh * s_q * D;
  const float* kb = k + (size_t)bh * s_kv * D;
  const float* vb = v + (size_t)bh * s_kv * D;

  float qr[kLane], acc[kLane];
  load16(qr, q + qbase + (size_t)row * D + t * kLane);
#pragma unroll
  for (int i = 0; i < kLane; ++i) acc[i] = 0.f;
  float m = -1e30f;  // finite: m − m_new is never inf − inf, and exp(−inf − m) = 0
  float l = 0.f;

  const int kend = Causal ? key_end(row0, shift, s_kv) : s_kv;
  for (int kt = 0; kt < kend; kt += kTile) {
    __syncthreads();
    load_tile<D>(ks, kb, kt);
    load_tile<D>(vs, vb, kt);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float kr[kLane];
        load16(kr, ks + (c0 + c) * D + t * kLane);
        const float dot = row_sum<T>(dot16(qr, kr)) * scale;
        s[c] = (!Causal || kt + c0 + c <= row + shift) ? dot : -INFINITY;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < kLane; ++i) acc[i] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = expf(s[c] - m_new);  // 0 where masked
        l += p;
        float vr[kLane];
        load16(vr, vs + (c0 + c) * D + t * kLane);
#pragma unroll
        for (int i = 0; i < kLane; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
      }
      m = m_new;
    }
  }
  // masked-row guard: a row that saw no key has l == 0 and acc == 0
  const bool live = l > 0.f;
  store16(o + qbase + (size_t)row * D + t * kLane, acc, live ? 1.f / l : 0.f);
  if (t == 0) lse[(size_t)bh * s_q + row] = live ? m + logf(l) : -1e30f;
}

template <int D, bool Causal>
__global__ void __launch_bounds__(kRows * (D / kLane))
flash_bwd_dq_rect_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq, int s_q, int s_kv, int shift,
                         float scale) {
  constexpr int T = D / kLane;
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int r = threadIdx.x / T, t = threadIdx.x % T;
  const int row = row0 + r;
  const size_t qbase = (size_t)bh * s_q * D;
  const float* kb = k + (size_t)bh * s_kv * D;
  const float* vb = v + (size_t)bh * s_kv * D;

  float qr[kLane], dor[kLane], acc[kLane];
  load16(qr, q + qbase + (size_t)row * D + t * kLane);
  load16(dor, dout + qbase + (size_t)row * D + t * kLane);
#pragma unroll
  for (int i = 0; i < kLane; ++i) acc[i] = 0.f;
  const float lse_r = lse[(size_t)bh * s_q + row];
  const float delta_r = delta[(size_t)bh * s_q + row];
  // P = 0 guard: a causal row that saw no key carries lse = −1e30
  const bool live = !Causal || lse_r > -0.5e30f;

  const int kend = Causal ? key_end(row0, shift, s_kv) : s_kv;
  for (int kt = 0; kt < kend; kt += kTile) {
    __syncthreads();
    load_tile<D>(ks, kb, kt);
    load_tile<D>(vs, vb, kt);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kr[kLane], vr[kLane];
      load16(kr, ks + c * D + t * kLane);
      load16(vr, vs + c * D + t * kLane);
      const float sc = row_sum<T>(dot16(qr, kr)) * scale;
      const float dp = row_sum<T>(dot16(dor, vr));
      const bool keep = !Causal || (live && kt + c <= row + shift);
      const float p = keep ? expf(sc - lse_r) : 0.f;
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int i = 0; i < kLane; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
  }
  store16(dq + qbase + (size_t)row * D + t * kLane, acc, scale);
}

template <int D, bool Causal>
__global__ void __launch_bounds__(kRows * (D / kLane))
flash_bwd_dkv_rect_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                          int s_q, int s_kv, int shift, float scale) {
  constexpr int T = D / kLane;
  __shared__ __align__(16) float qs[kTile * D];
  __shared__ __align__(16) float dos[kTile * D];
  __shared__ float lses[kTile];
  __shared__ float deltas[kTile];
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kRows;  // key rows
  const int r = threadIdx.x / T, t = threadIdx.x % T;
  const int key = key0 + r;
  const size_t kbase = (size_t)bh * s_kv * D;
  const float* qb = q + (size_t)bh * s_q * D;
  const float* dob = dout + (size_t)bh * s_q * D;
  const float* lseb = lse + (size_t)bh * s_q;
  const float* deltab = delta + (size_t)bh * s_q;

  float kr[kLane], vr[kLane], dka[kLane], dva[kLane];
  load16(kr, k + kbase + (size_t)key * D + t * kLane);
  load16(vr, v + kbase + (size_t)key * D + t * kLane);
#pragma unroll
  for (int i = 0; i < kLane; ++i) dka[i] = dva[i] = 0.f;

  // causal: query rows before key0 − shift see none of this block's keys
  const int qt0 = Causal ? min(max(key0 - shift, 0), s_q) / kTile * kTile : 0;
  for (int qt = qt0; qt < s_q; qt += kTile) {
    __syncthreads();
    load_tile<D>(qs, qb, qt);
    load_tile<D>(dos, dob, qt);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      lses[i] = lseb[qt + i];
      deltas[i] = deltab[qt + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float qv[kLane], dov[kLane];
      load16(qv, qs + c * D + t * kLane);
      load16(dov, dos + c * D + t * kLane);
      const float sc = row_sum<T>(dot16(kr, qv)) * scale;
      const float dp = row_sum<T>(dot16(vr, dov));
      const bool keep = !Causal || (key <= qt + c + shift && lses[c] > -0.5e30f);
      const float p = keep ? expf(sc - lses[c]) : 0.f;
      const float ds = p * (dp - deltas[c]);
#pragma unroll
      for (int i = 0; i < kLane; ++i) {
        dva[i] = fmaf(p, dov[i], dva[i]);
        dka[i] = fmaf(ds, qv[i], dka[i]);
      }
    }
  }
  store16(dk + kbase + (size_t)key * D + t * kLane, dka, scale);
  store16(dv + kbase + (size_t)key * D + t * kLane, dva, 1.f);
}

bool rect_shape_ok(int bh, int s_q, int s_kv) { return shape_ok(bh, s_q) && shape_ok(bh, s_kv); }

// one launch of KERNEL<D, causal> for D in {16, 32, 64}; returns from the enclosing function
#define FLASH_RECT_DISPATCH(KERNEL, grid, d, causal, st, ...)                                              \
  switch ((d) * 2 + ((causal) ? 1 : 0)) {                                                                 \
    case 32: KERNEL<16, false><<<grid, kRows * 1, 0, st>>>(__VA_ARGS__); break;                           \
    case 33: KERNEL<16, true><<<grid, kRows * 1, 0, st>>>(__VA_ARGS__); break;                            \
    case 64: KERNEL<32, false><<<grid, kRows * 2, 0, st>>>(__VA_ARGS__); break;                           \
    case 65: KERNEL<32, true><<<grid, kRows * 2, 0, st>>>(__VA_ARGS__); break;                            \
    case 128: KERNEL<64, false><<<grid, kRows * 4, 0, st>>>(__VA_ARGS__); break;                          \
    case 129: KERNEL<64, true><<<grid, kRows * 4, 0, st>>>(__VA_ARGS__); break;                           \
    default: return (int)cudaErrorInvalidValue;                                                           \
  }                                                                                                       \
  return (int)cudaGetLastError();

}  // namespace

extern "C" {

// Forward on `stream`: o [BH, S, D], lse [BH, S]. D in {16, 32, 64},
// S a multiple of 128. Returns the cudaError_t of the launch.
int flash_fwd_launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s,
                     int d, float scale, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(s / kRows, bh);
  switch (d) {
    case 16: flash_fwd_kernel<16><<<grid, kRows * 1, 0, st>>>(q, k, v, o, lse, s, scale); break;
    case 32: flash_fwd_kernel<32><<<grid, kRows * 2, 0, st>>>(q, k, v, o, lse, s, scale); break;
    case 64: flash_fwd_kernel<64><<<grid, kRows * 4, 0, st>>>(q, k, v, o, lse, s, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dq [BH, S, D] from q, k, v, dO [BH, S, D] and lse, delta [BH, S].
int flash_bwd_dq_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                        const float* delta, float* dq, int bh, int s, int d, float scale, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(s / kRows, bh);
  switch (d) {
    case 16: flash_bwd_dq_kernel<16><<<grid, kRows * 1, 0, st>>>(q, k, v, dout, lse, delta, dq, s, scale); break;
    case 32: flash_bwd_dq_kernel<32><<<grid, kRows * 2, 0, st>>>(q, k, v, dout, lse, delta, dq, s, scale); break;
    case 64: flash_bwd_dq_kernel<64><<<grid, kRows * 4, 0, st>>>(q, k, v, dout, lse, delta, dq, s, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dk, dv [BH, S, D] from the same inputs.
int flash_bwd_dkv_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                         const float* delta, float* dk, float* dv, int bh, int s, int d, float scale,
                         void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(s / kRows, bh);
  switch (d) {
    case 16:
      flash_bwd_dkv_kernel<16><<<grid, kRows * 1, 0, st>>>(q, k, v, dout, lse, delta, dk, dv, s, scale);
      break;
    case 32:
      flash_bwd_dkv_kernel<32><<<grid, kRows * 2, 0, st>>>(q, k, v, dout, lse, delta, dk, dv, s, scale);
      break;
    case 64:
      flash_bwd_dkv_kernel<64><<<grid, kRows * 4, 0, st>>>(q, k, v, dout, lse, delta, dk, dv, s, scale);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Rectangular forward: o [BH, Sq, D], lse [BH, Sq] from q [BH, Sq, D] and
// k, v [BH, Skv, D]; `causal` masks on the global positions q_off + i,
// k_off + j. Sq and Skv multiples of 128, D in {16, 32, 64}.
int flash_fwd_rect_launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q,
                          int s_kv, int d, int causal, int q_off, int k_off, float scale, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(s_q / kRows, bh);
  FLASH_RECT_DISPATCH(flash_fwd_rect_kernel, grid, d, causal, st, q, k, v, o, lse, s_q, s_kv, q_off - k_off, scale)
}

// Rectangular dq [BH, Sq, D] from q, dO [BH, Sq, D], k, v [BH, Skv, D] and lse, delta [BH, Sq].
int flash_bwd_dq_rect_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                             const float* delta, float* dq, int bh, int s_q, int s_kv, int d, int causal,
                             int q_off, int k_off, float scale, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(s_q / kRows, bh);
  FLASH_RECT_DISPATCH(flash_bwd_dq_rect_kernel, grid, d, causal, st, q, k, v, dout, lse, delta, dq, s_q, s_kv,
                      q_off - k_off, scale)
}

// Rectangular dk, dv [BH, Skv, D] from the same inputs.
int flash_bwd_dkv_rect_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                              const float* delta, float* dk, float* dv, int bh, int s_q, int s_kv, int d,
                              int causal, int q_off, int k_off, float scale, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(s_kv / kRows, bh);
  FLASH_RECT_DISPATCH(flash_bwd_dkv_rect_kernel, grid, d, causal, st, q, k, v, dout, lse, delta, dk, dv, s_q,
                      s_kv, q_off - k_off, scale)
}

}  // extern "C"
