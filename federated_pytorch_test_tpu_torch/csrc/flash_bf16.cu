// Causal flash attention on bf16 inputs, forward and backward, for Hopper
// (sm_90a): the `cast16` branches of the JAX package's
// ops/flash_attention.py, taken there when q is bf16 and the precision is
// 'default' (`flash_attention` :860).
//
//   _fwd_tri     :559 (_fwd_kernel_tri :253, cast16, fuse_l)    -> flash_fwd_bf16_launch     -> flash_fwd_bf16_tc<D, Keys>
//   _bwd_tri dq  :655 (_bwd_dq_kernel_tri :341, cast16)         -> flash_bwd_dq_bf16_launch  -> flash_bwd_dq_bf16_tc<D, Keys>
//   _bwd_tri dkv :673 (_bwd_dkv_kernel_tri :365, cast16)        -> flash_bwd_dkv_bf16_launch -> flash_bwd_dkv_bf16_tc<D>
//
// What they compute, as the TPU kernels do (and the plain versions in
// ops/flash_cuda.py repeat):
//   * Q arrives pre-scaled into the base-2 score domain by the caller,
//     qs = bf16(f32(q) · scale·log2 e) (`_prescale_q` :537), so a score is
//     s = qs·kᵀ and P = 2^(s − m).
//   * Forward: per row the running max m and, per tile of Keys keys,
//     P = 2^(s − m_new) rounded to bf16 (to nearest even) before P·V; the
//     row sum l is summed over the ROUNDED P, on the tensor cores as the
//     JAX package's ones column appended to V does (`fuse_l`,
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
// SXM, the causal triangle of (BH, S) = (128, 2048) or (32, 4096), 2.7e8
// pairs: the exps (16 a clock per SM) take 0.070 ms; the bf16 products at
// 989 TFLOP/s 0.017 ms (forward, D 16) to 0.070 (forward, D 64), 0.104 (dq,
// D 64) and 0.139 (dk/dv, D 64); the bytes 0.013 ms or less. The forward is
// bound by the exps at every D, with the products level at D 64; dq and
// dk/dv by the products at D 64. Every block also re-reads the tiles before
// its diagonal (K/V for the forward and dq, qs/dO for dk/dv) from L2, 0.55
// GB for the forward at (32, 4096, 64).
//
// One design for the three (`chip_sweep.py bf16` times each whole and with
// its attribution cuts, the template argument Cut, which the shipped entry
// points never take):
//   * Persistent: a CTA an SM takes the 128-row blocks (queries for the
//     forward and dq, keys for dk/dv) heaviest first, dealt out in a snake
//     (`Schedule`). Its two consumer warpgroups own 64 rows each; a third,
//     producer warpgroup keeps a kRing-stage ring of the streamed tiles
//     (K and V for the forward and dq, qs and dO for dk/dv) full and
//     double-buffers each block's own rows (qs, qs and dO, or k and v),
//     running ahead across blocks so that a block's start and its epilogue
//     hide behind the next block's loads. One producer thread issues a TMA
//     copy a tile (and a bulk copy each for dk/dv's lse and delta) against
//     the stage's `full` mbarrier; a consumer warp frees a stage on its
//     `empty` mbarrier. The mainloop has no block-wide barrier, and
//     setmaxnreg moves the producer's registers to the consumers. dq's rows
//     read their lse and delta from device memory into registers.
//   * No transpose: the TMA lands each tile with the swizzle of its row
//     width (32, 64 or 128 bytes), which the tensor cores read as it landed,
//     K-major (qs·kᵀ and dO·vᵀ of the forward and dq; k·qsᵀ and v·dOᵀ of
//     dk/dv) or MN-major (imm-trans-b = 1: V for P·V, K for dq's dS·K, dO
//     and qs for Pᵀ·dO and dSᵀ·qs): `desc_sw`. The forward's row sum l over
//     the rounded P (`fuse_l`) is P·[1 | 0] on the warp's tensor cores
//     (mma.sync against a ones column held in registers), beside the
//     asynchronous P·V.
//   * Products overlap the exps. The two consumer warpgroups take turns to
//     issue their products (FA3's ping-pong, named barriers), so that one
//     warpgroup's products run under the other's exps; within a warpgroup
//     the forward issues tile t + 1's qs·kᵀ and tile t's P·V before tile
//     t + 1's softmax and waits for the scores alone (wgmma.wait_group 1),
//     and dq and dk/dv queue tile t + 1's score products right behind tile
//     t's dS (and P) products.
//   * Tiles: 128 keys a forward tile at every D (kFwdKeys; 64 measured
//     slower at D 16 and 64); kDqKeys keys a dq tile by D, by measurement;
//     dk/dv streams 64 queries a tile (128 would not fit its registers;
//     32 at D = 128, kDkvTile).
//   * D = 128 (kRing, kSlab, kDkvOverlap): a ring of two stages, not four,
//     and dq's tile 64 keys, so that each plan fits 227 KB (the
//     static_asserts state the bytes); every tile lands as 64-column slabs
//     with the 128-byte swizzle, two TMA boxes a tile, read K-major a slab
//     a k16 step and MN-major as two N = 64 products, one a slab; the row
//     sum l is the same sum of the rounded P as at D <= 64 (the JAX
//     package's l scratch, `fuse_l` false at D 128, sums the same terms);
//     dk/dv streams 32-query tiles, so that its next tile's scores fit in
//     flight beside the two 64-register accumulators (64-query tiles
//     spilled), and masks the first two tiles a warpgroup sees.
//   * Causal: a block reads only the tiles that can see it; a warpgroup
//     frees a tile wholly outside its triangle unread and masks by select
//     only the one tile across its diagonal, a separate compile-time branch
//     (a run-time one is if-converted into every tile).
//   * Each output row is summed by one warpgroup in a fixed order: no
//     atomics, bitwise repeatable.
//   * Products are bf16 m64nNk16 wgmmas with f32 accumulators: the score
//     products from shared memory, the P and dS products with P or dS in
//     registers, whose accumulator fragment is the A fragment as it stands.
//     Sums over the streamed tiles stay in the tensor cores' accumulator.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_wgmma.cuh"
#include "hopper_tma.cuh"
#include "tf32_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf16_wgmma::desc_sw;
using bf16_wgmma::pack_a;
using bf16_wgmma::wg_wait_group;
using bf16_wgmma::wgmma_rs_bf16;
using bf16_wgmma::wgmma_ss_bf16;
using bf16_wgmma::wgmma_ss_bf16_n64;
using hopper_tma::aligned_smem;
using hopper_tma::bar_arrive;
using hopper_tma::bar_expect;
using hopper_tma::bar_init;
using hopper_tma::bar_wait;
using hopper_tma::bulk_copy;
using hopper_tma::encode_tiled;
using hopper_tma::EncodeTiled;
using hopper_tma::launch;
using hopper_tma::persistent_grid;
using hopper_tma::regs_dec;
using hopper_tma::regs_inc;
using hopper_tma::smem_u32;
using hopper_tma::tma_box;
using tf32_wgmma::cols;
using tf32_wgmma::pin;
using tf32_wgmma::wg_commit;
using tf32_wgmma::wg_fence;

constexpr int kRows = 128;  // rows a block owns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Two consumer warpgroups and a producer warpgroup
constexpr int kWsThreads = 384;  // the producer warpgroup last
constexpr int kConsumerWarps = 8;  // each frees a stage with one arrival
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg: 128·24 + 256·240 <= 65,536
// queries a dk/dv tile, by head dim: 64, and 32 at D = 128, where dk's and
// dv's accumulators take 128 registers a thread and 64-query tiles spilled
// 36 bytes at the dv and dk products' issue; 32-query tiles halve the
// registers of sᵀ, dPᵀ and their bf16 fragments
template <int D>
constexpr int kDkvTile = D == 128 ? 32 : 64;
// keys a forward tile, by head dim (chip_sweep.py bf16 times 64 and 128; BF16_FWD_KEYS in ops/flash_cuda.py)
template <int D>
constexpr int kFwdKeys = 128;
// keys a dq tile, by head dim (chip_sweep.py bf16 times 64 and 128; the plain version takes any). At
// D = 128 a 128-key ring stage is 64 KB, and two of them beside the double-buffered qs and dO pass 227 KB
template <int D>
constexpr int kDqKeys = 128;
template <>
constexpr int kDqKeys<128> = 64;
// stages of the producer's ring, by head dim: four up to D = 64; two at D =
// 128, where a stage (a K and a V tile, or a qs and a dO tile) is 64 KB
// (forward), 32 KB (dq) or 16 KB (dk/dv) and the block's own rows take 64 KB
// a buffer (the plans' bytes stand in the static_asserts after the kernels)
template <int D>
constexpr int kRing = D == 128 ? 2 : 4;

// attribution cuts (the template argument Cut; the shipped entry points take kFull)
constexpr int kFull = 0, kNoExp = 1, kNoMma = 2, kLoadsOnly = 3, kMmaOnly = 4;

bool shape_ok(int bh, int s) { return bh >= 1 && bh <= 65535 && s >= kRows && s % kRows == 0; }

// 2^x; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// ---------------------------------------------------------------------------
// The producer's ring: mbarriers, TMA, setmaxnreg
// ---------------------------------------------------------------------------

// A tile of R rows in shared memory. Up to D = 64 a row is 2·D bytes,
// swizzled by its width (32, 64 or 128 bytes) as the TMA wrote it. At D =
// 128 a row (256 bytes) exceeds the 128-byte span of one swizzle, so the
// tile is two slabs of R rows by 64 columns (128 bytes, 128-byte swizzle):
// columns 0 … 63, then 64 … 127 at R·128 bytes, each landed by a TMA box of
// its own and read as `desc_sw<64>` reads a D = 64 tile.
template <int D>
constexpr int kSlab = D == 128 ? 64 : D;  // columns a slab

// rows [row, row + R) of `map` into the R-row tile at dst, a box a slab
template <int D, int R>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap& map, int row, uint64_t* bar) {
#pragma unroll
  for (int h = 0; h < D / kSlab<D>; ++h) tma_box(dst + h * R * kSlab<D>, map, h * kSlab<D>, row, bar);
}

// shared address of k16 step kk (columns 16kk … 16kk + 15) of the R-row tile at `tile`, read K-major
template <int D, int R>
__device__ __forceinline__ uint32_t k_step(uint32_t tile, int kk) {
  constexpr int kSteps = kSlab<D> / 16;  // k16 steps a slab
  return tile + kk / kSteps * R * 2 * kSlab<D> + 32 * (kk % kSteps);
}

// acc = A·Bᵀ over D, N columns: A the 64-row operand at `a` (rows of an
// RA-row tile), B the N-row tile at `b` (RB rows), both read K-major; issued
// into the open wgmma group
template <int N, int D, int RA, int RB>
__device__ __forceinline__ void ss_rows(float (&acc)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_bf16<N>(acc, desc_sw<kSlab<D>>(k_step<D, RA>(a, kk)), desc_sw<kSlab<D>>(k_step<D, RB>(b, kk)), kk > 0);
}

// acc += A·B over k16 step kk: A in registers, B the R-row tile at `tile`
// read MN-major (its rows 16kk … 16kk + 15 the contraction, its D columns
// the product's), a product a slab; issued into the open wgmma group
template <int D, int R>
__device__ __forceinline__ void rs_cols(float (&acc)[D / 2], const uint32_t (&a)[4], uint32_t tile, int kk) {
#pragma unroll
  for (int h = 0; h < D / kSlab<D>; ++h)
    wgmma_rs_bf16<kSlab<D>, 1>(cols<kSlab<D>>(acc, kSlab<D> * h), a,
                               desc_sw<kSlab<D>>(tile + h * R * 2 * kSlab<D> + 32 * kSlab<D> * kk), 1);
}

// shared address of warpgroup wg's 64 rows in a tile of R rows (D columns)
template <int D>
__device__ __forceinline__ uint32_t wg_rows(const bf16* tile, int wg) {
  return smem_u32(tile) + 64 * wg * 2 * kSlab<D>;
}

// Ping-pong of the two consumer warpgroups (FA3): warpgroup w issues its
// products only on its turn, `turn_wait` on named barrier 1 + w, and then
// hands the turn over (`turn_pass`), so that one warpgroup's products run
// on the tensor cores under the other's softmax. Without it the two start
// in step and stay there, and the exps and the products take turns.
__device__ __forceinline__ void turn_wait(int wg) { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); }
__device__ __forceinline__ void turn_pass(int wg) { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); }

// The ring's mbarriers, set up by thread 0 before the block's one barrier
template <int Ring>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < Ring; ++i) {
      bar_init(&full[i], 1);  // the producer's bar_expect; then the bytes
      bar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// A consumer warp's part: wait for the stage of tile `it` to be full / free it
template <int Ring>
__device__ __forceinline__ void wait_full(uint64_t* full, int it) { bar_wait(&full[it % Ring], (it / Ring) & 1); }
template <int Ring>
__device__ __forceinline__ void release(uint64_t* empty, int it) {
  if (threadIdx.x % 32 == 0) bar_arrive(&empty[it % Ring]);
}

// The producer's wait before it refills the stage of tile `it`: the stage's last tile freed
template <int Ring>
__device__ __forceinline__ void wait_empty(uint64_t* empty, int it) {
  if (it >= Ring) bar_wait(&empty[it % Ring], (it / Ring - 1) & 1);
}

// d += A·B on the warp's tensor cores (mma.sync m16n8k16): A this warp's 16
// rows of a wgmma A fragment, B 16 x 8 with b the lane's two registers.
// With B's column 0 all ones (b = two bf16 ones in lanes 0-3, else 0), d's
// column 0 (d[0], d[2] of lanes t = 0) sums each row of A in f32.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(b));
}

// The 128-row blocks of a launch in order of decreasing work (block row r
// of every head before row r + 1), dealt to the persistent CTAs in a
// snake — CTA c takes c, 2G − 1 − c, 2G + c, … of G CTAs — so that the
// causal rows' uneven work evens out across the CTAs.
struct Schedule {
  int heads, rows;  // BH, and 128-row blocks a head
  // this CTA's n-th block: head bh, block row r (0 the heaviest); false past the last
  __device__ __forceinline__ bool next(int n, int& bh, int& r) const {
    const int g = gridDim.x, c = blockIdx.x;
    const int idx = n * g + (n % 2 == 0 ? c : g - 1 - c);
    if (idx >= heads * rows) return false;
    r = idx / heads;
    bh = idx % heads;
    return true;
  }
};

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D, int T>
struct FwdStage {
  alignas(1024) bf16 k[T * D];  // a K tile as the TMA wrote it: read K-major for qs·kᵀ
  alignas(1024) bf16 v[T * D];  // the V tile, the same: read MN-major for P·V
};

template <int D, int T>
struct SmemFwd {
  FwdStage<D, T> st[kRing<D>];
  alignas(1024) bf16 q[2][kRows * D];  // two blocks' rows of qs as the TMA wrote them, one 64-row operand a warpgroup
  uint64_t full[kRing<D>], empty[kRing<D>], q_full[2], q_empty[2];
};

// Online softmax of a tile of T keys from key kt, in place: sc[4j + e] is
// (row_a, key kt + 8j + 2t + e) and sc[4j + 2 + e] row_a + 8. The running
// maxima move to the tile's, corr = 2^(m_old − m_new), and sc becomes
// 2^(sc − m_new), 0 where masked. Masked: the tile crosses this
// warpgroup's diagonal (a compile-time branch: the compiler if-converts a
// run-time one into every tile).
template <int T, int Cut, bool Masked>
__device__ __forceinline__ void online_softmax(float (&sc)[T / 2], int kt, int row_a, int t, float& m_a, float& m_b,
                                               float& corr_a, float& corr_b) {
  if constexpr (Masked) {
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt + 8 * j + 2 * t + e;
        if (key > row_a) sc[4 * j + e] = -INFINITY;
        if (key > row_a + 8) sc[4 * j + 2 + e] = -INFINITY;
      }
  }
  float mx_a[4], mx_b[4];  // four partial maxima a row: short dependency chains
#pragma unroll
  for (int i = 0; i < 4; ++i) mx_a[i] = mx_b[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
    mx_a[j % 4] = fmaxf(mx_a[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b[j % 4] = fmaxf(mx_b[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mxa = fmaxf(fmaxf(mx_a[0], mx_a[1]), fmaxf(mx_a[2], mx_a[3]));
  float mxb = fmaxf(fmaxf(mx_b[0], mx_b[1]), fmaxf(mx_b[2], mx_b[3]));
#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
  }
  // every row sees key 0 in its first tile, so the max is finite from there on
  const float mn_a = fmaxf(m_a, mxa), mn_b = fmaxf(m_b, mxb);
  corr_a = Cut == kNoExp ? 1.f : exp2_ftz(m_a - mn_a);
  corr_b = Cut == kNoExp ? 1.f : exp2_ftz(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (Cut == kNoExp) {
        sc[4 * j + e] -= mn_a;
        sc[4 * j + 2 + e] -= mn_b;
      } else {
        sc[4 * j + e] = exp2_ftz(sc[4 * j + e] - mn_a);  // masked: 2^-inf = 0
        sc[4 * j + 2 + e] = exp2_ftz(sc[4 * j + 2 + e] - mn_b);
      }
    }
}

// Persistent: grid min(SMs, blocks), kWsThreads threads,
// sizeof(SmemFwd<D, T>) + 1024 bytes of dynamic shared memory; a CTA takes
// the 128-row blocks of `Schedule` in turn, T keys a tile; qs, K and V
// through TMA maps of [BH·S, D] (qs in 128-row boxes, K and V in T-row ones).
template <int D, int T, int Cut = kFull>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_bf16_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, float* __restrict__ o, float* __restrict__ lse,
                  int bh_count, int s_len) {
  using S = SmemFwd<D, T>;
  constexpr int Ring = kRing<D>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const Schedule sched{bh_count, s_len / kRows};
  const int wg = threadIdx.x / 128;

  init_ring<Ring>(sm.full, sm.empty);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&sm.q_full[i], 1);
      bar_init(&sm.q_empty[i], kConsumerWarps);
    }
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy, running ahead across blocks
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      int gt = 0;  // tiles of this CTA so far: the ring's position
      for (int n = 0, bh, r; sched.next(n, bh, r); ++n) {
        const int row0 = (sched.rows - 1 - r) * kRows, n_tiles = (row0 + kRows) / T;
        if (n >= 2) bar_wait(&sm.q_empty[n % 2], (n / 2 - 1) & 1);
        bar_expect(&sm.q_full[n % 2], kRows * D * 2);
        tma_tile<D, kRows>(sm.q[n % 2], map_q, bh * s_len + row0, &sm.q_full[n % 2]);
        for (int it = 0; it < n_tiles; ++it, ++gt) {
          FwdStage<D, T>& stage = sm.st[gt % Ring];
          wait_empty<Ring>(sm.empty, gt);
          bar_expect(&sm.full[gt % Ring], 2 * T * D * 2);
          tma_tile<D, T>(stage.k, map_k, bh * s_len + it * T, &sm.full[gt % Ring]);
          tma_tile<D, T>(stage.v, map_v, bh * s_len + it * T, &sm.full[gt % Ring]);
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t ones = g == 0 ? 0x3F803F80u : 0u;  // B of l = bf16(P)·[1 | 0]: column 0 ones
  if (wg == 1 && Cut != kLoadsOnly) turn_pass(wg);  // warpgroup 0 goes first
  int gt = 0;
  for (int n = 0, bh, r; sched.next(n, bh, r); ++n) {
    const int row0 = (sched.rows - 1 - r) * kRows, n_tiles = (row0 + kRows) / T;
    const size_t base = (size_t)bh * s_len * D;
    const int wrow0 = row0 + 64 * wg;
    const int row_a = wrow0 + 16 * warp + g, row_b = row_a + 8;
    const int n_live = (wrow0 + 64 + T - 1) / T;  // the tiles holding a key these rows see
    const uint32_t q_addr = wg_rows<D>(sm.q[n % 2], wg);

    float acc[D / 2], l4[4][4];  // O, and l in column 0 of bf16(P)·[1 | 0], four partial sums
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) l4[i / 4][i % 4] = 0.f;
    float sc[T / 2];         // a tile's scores, then 2^(s − m) in place
    uint32_t pa[T / 16][4];  // bf16(P): A fragments of 16 keys each
    float m_a = -1e30f, m_b = -1e30f, corr_a = 1.f, corr_b = 1.f;

    // sc = qs·kᵀ of tile `it`, issued as one wgmma group
    auto scores = [&](int it) {
      wait_full<Ring>(sm.full, gt + it);
      if constexpr (Cut == kNoMma) {
#pragma unroll
        for (int i = 0; i < T / 2; ++i) sc[i] = 0.125f * (i & 7);
      } else {
        const uint32_t k_addr = smem_u32(sm.st[(gt + it) % Ring].k);
        wg_fence();
        ss_rows<T, D, kRows, T>(sc, q_addr, k_addr);
        wg_commit();
      }
    };
    // acc += bf16(P)·V of tile `it`, issued as one wgmma group
    auto pv = [&](int it) {
      if constexpr (Cut != kNoMma) {
        const uint32_t v_addr = smem_u32(sm.st[(gt + it) % Ring].v);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) rs_cols<D, T>(acc, pa[kk], v_addr, kk);
        wg_commit();
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= corr_a;
        acc[4 * j + 1] *= corr_a;
        acc[4 * j + 2] *= corr_b;
        acc[4 * j + 3] *= corr_b;
      }
    };
    // only the last tile these rows see crosses their diagonal (masked)
    auto softmax = [&](int it, auto masked) {
      if constexpr (Cut != kMmaOnly)
        online_softmax<T, Cut, decltype(masked)::value>(sc, it * T, row_a, t, m_a, m_b, corr_a, corr_b);
    };
    // P rounded to bf16 as A fragments, and l = l·corr + Σ bf16(P) (the plain version's order of updates)
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        l4[i][0] *= corr_a;
        l4[i][1] *= corr_a;
        l4[i][2] *= corr_b;
        l4[i][3] *= corr_b;
      }
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) pack_a(sc, kk, pa[kk]);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) mma_16816(l4[kk % 4], pa[kk], ones);
    };
    auto pin_pv = [&]() {  // P's registers stay untouched until its product is done
      pin(acc);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) pin(pa[kk]);
    };

    bar_wait(&sm.q_full[n % 2], (n / 2) & 1);
    if constexpr (Cut == kLoadsOnly) {
      for (int it = 0; it < n_tiles; ++it) {
        wait_full<Ring>(sm.full, gt + it);
        release<Ring>(sm.empty, gt + it);
      }
    } else {
      // n_tiles + 1 turns a warpgroup: the first scores, n_live − 1 of
      // scores and P·V, the last P·V, and an empty turn a tile these rows skip
      turn_wait(wg);
      scores(0);
      turn_pass(wg);
      wg_wait_group<0>();
      pin(sc);
      if (n_live == 1)
        softmax(0, std::true_type{});
      else
        softmax(0, std::false_type{});
      pack();
      for (int it = 1; it < n_live; ++it) {
        turn_wait(wg);
        scores(it);
        rescale();  // by tile it − 1's correction, under the score product
        pv(it - 1);
        turn_pass(wg);
        wg_wait_group<1>();  // the scores; P·V may still run
        pin(sc);
        if (it == n_live - 1)
          softmax(it, std::true_type{});
        else
          softmax(it, std::false_type{});
        wg_wait_group<0>();
        pin_pv();
        release<Ring>(sm.empty, gt + it - 1);
        pack();
      }
      turn_wait(wg);
      rescale();
      pv(n_live - 1);
      turn_pass(wg);
      wg_wait_group<0>();
      pin_pv();
      release<Ring>(sm.empty, gt + n_live - 1);
      for (int it = n_live; it < n_tiles; ++it) {  // wholly in these rows' future: free it unread
        turn_wait(wg);
        turn_pass(wg);
        wait_full<Ring>(sm.full, gt + it);
        release<Ring>(sm.empty, gt + it);
      }
    }
    if (lane == 0) bar_arrive(&sm.q_empty[n % 2]);  // every product that read this block's qs is done
    gt += n_tiles;

    // l: column 0 of bf16(P)·[1 | 0], held by the quad's thread t = 0
    const float l_a = fmaxf(__shfl_sync(0xffffffffu, (l4[0][0] + l4[1][0]) + (l4[2][0] + l4[3][0]), lane & ~3), 1e-30f);
    const float l_b = fmaxf(__shfl_sync(0xffffffffu, (l4[0][2] + l4[1][2]) + (l4[2][2] + l4[3][2]), lane & ~3), 1e-30f);
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
  if (wg == 0 && Cut != kLoadsOnly) turn_wait(wg);  // warpgroup 1's last pass
}

// ---------------------------------------------------------------------------
// Backward: dq
// ---------------------------------------------------------------------------

template <int D, int T>
struct DqStage {
  alignas(1024) bf16 k[T * D];  // a K tile as the TMA wrote it: K-major for qs·kᵀ, MN-major for dS·K
  alignas(1024) bf16 v[T * D];  // the V tile, the same: K-major for dO·vᵀ
};

template <int D, int T>
struct SmemDq {
  DqStage<D, T> st[kRing<D>];
  alignas(1024) bf16 q[2][kRows * D];     // two blocks' rows of qs as the TMA wrote them, one 64-row operand a warpgroup
  alignas(1024) bf16 dout[2][kRows * D];  // and of dO
  uint64_t full[kRing<D>], empty[kRing<D>], qd_full[2], qd_empty[2];
};

// dq of qs, dO against k, v: dq = scale · Σ_j bf16(dS_ij) k_j. Persistent:
// grid min(SMs, blocks), kWsThreads threads, sizeof(SmemDq<D, T>) + 1024
// bytes of dynamic shared memory; a CTA takes the 128-query blocks of
// `Schedule` in turn, T keys a tile; qs and dO through TMA maps of [BH·S,
// D] in 128-row boxes, K and V in T-row ones.
template <int D, int T, int Cut = kFull>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dq_bf16_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
                     int bh_count, int s_len, float scale) {
  using S = SmemDq<D, T>;
  constexpr int Ring = kRing<D>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const Schedule sched{bh_count, s_len / kRows};
  const int wg = threadIdx.x / 128;

  init_ring<Ring>(sm.full, sm.empty);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&sm.qd_full[i], 1);
      bar_init(&sm.qd_empty[i], kConsumerWarps);
    }
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy, running ahead across blocks
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      int gt = 0;  // tiles of this CTA so far: the ring's position
      for (int n = 0, bh, r; sched.next(n, bh, r); ++n) {
        const int row0 = (sched.rows - 1 - r) * kRows, n_tiles = (row0 + kRows) / T;
        if (n >= 2) bar_wait(&sm.qd_empty[n % 2], (n / 2 - 1) & 1);
        bar_expect(&sm.qd_full[n % 2], 2 * kRows * D * 2);
        tma_tile<D, kRows>(sm.q[n % 2], map_q, bh * s_len + row0, &sm.qd_full[n % 2]);
        tma_tile<D, kRows>(sm.dout[n % 2], map_do, bh * s_len + row0, &sm.qd_full[n % 2]);
        for (int it = 0; it < n_tiles; ++it, ++gt) {
          DqStage<D, T>& stage = sm.st[gt % Ring];
          wait_empty<Ring>(sm.empty, gt);
          bar_expect(&sm.full[gt % Ring], 2 * T * D * 2);
          tma_tile<D, T>(stage.k, map_k, bh * s_len + it * T, &sm.full[gt % Ring]);
          tma_tile<D, T>(stage.v, map_v, bh * s_len + it * T, &sm.full[gt % Ring]);
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  if (wg == 1 && Cut != kLoadsOnly) turn_pass(wg);  // warpgroup 0 goes first
  int gt = 0;
  for (int n = 0, bh, r; sched.next(n, bh, r); ++n) {
    const int row0 = (sched.rows - 1 - r) * kRows, n_tiles = (row0 + kRows) / T;
    const int wrow0 = row0 + 64 * wg;
    const int row_a = wrow0 + 16 * warp + g, row_b = row_a + 8;
    const int n_live = (wrow0 + 64 + T - 1) / T;  // the tiles holding a key these rows see
    const size_t srow = (size_t)bh * s_len;
    const float l2_a = __ldg(lse + srow + row_a) * kLog2e, l2_b = __ldg(lse + srow + row_b) * kLog2e;
    const float dl_a = __ldg(delta + srow + row_a), dl_b = __ldg(delta + srow + row_b);
    const uint32_t q_addr = wg_rows<D>(sm.q[n % 2], wg), do_addr = wg_rows<D>(sm.dout[n % 2], wg);

    float acc[D / 2];  // dq / scale
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[T / 2], dp[T / 2];  // s = qs·kᵀ and dp = dO·vᵀ of a tile: s[4j + e] is (row_a, key kt + 8j + 2t + e)
    uint32_t da[T / 16][4];     // bf16(dS): A fragments of 16 keys each

    // s and dp of tile `it`, issued as one wgmma group
    auto scores = [&](int it) {
      wait_full<Ring>(sm.full, gt + it);
      if constexpr (Cut == kNoMma) {
#pragma unroll
        for (int i = 0; i < T / 2; ++i) s[i] = dp[i] = 0.125f * (i & 7);
      } else {
        const DqStage<D, T>& stage = sm.st[(gt + it) % Ring];
        const uint32_t k_addr = smem_u32(stage.k), v_addr = smem_u32(stage.v);
        wg_fence();
        ss_rows<T, D, kRows, T>(s, q_addr, k_addr);
        ss_rows<T, D, kRows, T>(dp, do_addr, v_addr);
        wg_commit();
      }
    };
    // dS = P ∘ (dP − delta), P = 2^(s − lse·log2 e), rounded to bf16 as A
    // fragments. Only the last tile these rows see crosses their diagonal
    // (masked: a compile-time branch, as the forward's)
    auto elementwise = [&](int it, auto masked) {
#pragma unroll
      for (int j = 0; j < T / 8 * (Cut != kMmaOnly); ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p_a = Cut == kNoExp ? s[4 * j + e] - l2_a : exp2_ftz(s[4 * j + e] - l2_a);
          float p_b = Cut == kNoExp ? s[4 * j + 2 + e] - l2_b : exp2_ftz(s[4 * j + 2 + e] - l2_b);
          if constexpr (decltype(masked)::value) {
            const int key = it * T + 8 * j + 2 * t + e;
            p_a = key > row_a ? 0.f : p_a;
            p_b = key > row_b ? 0.f : p_b;
          }
          s[4 * j + e] = p_a * (dp[4 * j + e] - dl_a);
          s[4 * j + 2 + e] = p_b * (dp[4 * j + 2 + e] - dl_b);
        }
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) pack_a(s, kk, da[kk]);
    };
    auto pin_all = [&]() {
      pin(s);
      pin(dp);
      pin(acc);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) pin(da[kk]);
    };

    bar_wait(&sm.qd_full[n % 2], (n / 2) & 1);
    if constexpr (Cut == kLoadsOnly) {
      for (int it = 0; it < n_tiles; ++it) {
        wait_full<Ring>(sm.full, gt + it);
        release<Ring>(sm.empty, gt + it);
      }
    } else {
      // n_tiles + 1 turns a warpgroup: the first scores, then a tile's dS·K
      // with the next tile's scores, and an empty turn a tile these rows skip
      turn_wait(wg);
      scores(0);
      turn_pass(wg);
      wg_wait_group<0>();
      pin(s);
      pin(dp);
      for (int it = 0; it < n_live; ++it) {
        if (it == n_live - 1)
          elementwise(it, std::true_type{});
        else
          elementwise(it, std::false_type{});
        // acc += bf16(dS)·K, the K tile read MN-major as it landed
        turn_wait(wg);
        if constexpr (Cut != kNoMma) {
          const uint32_t k_addr = smem_u32(sm.st[(gt + it) % Ring].k);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk) rs_cols<D, T>(acc, da[kk], k_addr, kk);
          wg_commit();
        }
        if (it + 1 < n_live) scores(it + 1);  // queued right behind it
        turn_pass(wg);
        wg_wait_group<0>();
        pin_all();
        release<Ring>(sm.empty, gt + it);
      }
      for (int it = n_live; it < n_tiles; ++it) {  // wholly in these rows' future: free it unread
        turn_wait(wg);
        turn_pass(wg);
        wait_full<Ring>(sm.full, gt + it);
        release<Ring>(sm.empty, gt + it);
      }
    }
    if (lane == 0) bar_arrive(&sm.qd_empty[n % 2]);  // every product that read this block's qs and dO is done
    gt += n_tiles;

    const size_t ra = srow * D + (size_t)row_a * D + 2 * t, rb = srow * D + (size_t)row_b * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dq + ra + 8 * j) = bf16_wgmma::pack2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      *reinterpret_cast<uint32_t*>(dq + rb + 8 * j) = bf16_wgmma::pack2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
  if (wg == 0 && Cut != kLoadsOnly) turn_wait(wg);  // warpgroup 1's last pass
}

// ---------------------------------------------------------------------------
// Backward: dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvStage {
  static constexpr int T = kDkvTile<D>;
  alignas(1024) bf16 q[T * D];     // a qs tile as the TMA wrote it: K-major for k·qsᵀ, MN-major for dSᵀ·qs
  alignas(1024) bf16 dout[T * D];  // the dO tile, the same: v·dOᵀ, Pᵀ·dO
  float lse[T], delta[T];
};

template <int D>
struct SmemDkv {
  DkvStage<D> st[kRing<D>];
  alignas(1024) bf16 k[2][kRows * D];  // two blocks' rows of k as the TMA wrote them, one 64-row operand a warpgroup
  alignas(1024) bf16 v[2][kRows * D];  // and of v
  uint64_t full[kRing<D>], empty[kRing<D>], kv_full[2], kv_empty[2];
};

// dk, dv of k, v from the same inputs: dv = Σ_i bf16(P_ij)ᵀ dO_i, dk = ln 2 ·
// Σ_i bf16(dS_ij)ᵀ qs_i. Persistent: grid min(SMs, blocks), kWsThreads
// threads, sizeof(SmemDkv<D>) + 1024 bytes of dynamic shared memory; a CTA
// takes the 128-key blocks of `Schedule` in turn; qs and dO through TMA
// maps in kDkvTile<D>-row boxes, k and v in 128-row ones.
template <int D, int Cut = kFull>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_bf16_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int bh_count, int s_len) {
  using S = SmemDkv<D>;
  constexpr int Ring = kRing<D>, T = kDkvTile<D>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const Schedule sched{bh_count, s_len / kRows};
  const int wg = threadIdx.x / 128;

  init_ring<Ring>(sm.full, sm.empty);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&sm.kv_full[i], 1);
      bar_init(&sm.kv_empty[i], kConsumerWarps);
    }
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy, running ahead across blocks
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      int gt = 0;  // tiles of this CTA so far: the ring's position
      for (int n = 0, bh, r; sched.next(n, bh, r); ++n) {
        const int key0 = r * kRows, n_tiles = (s_len - key0) / T;  // the first blocks see the most queries
        if (n >= 2) bar_wait(&sm.kv_empty[n % 2], (n / 2 - 1) & 1);
        bar_expect(&sm.kv_full[n % 2], 2 * kRows * D * 2);
        tma_tile<D, kRows>(sm.k[n % 2], map_k, bh * s_len + key0, &sm.kv_full[n % 2]);
        tma_tile<D, kRows>(sm.v[n % 2], map_v, bh * s_len + key0, &sm.kv_full[n % 2]);
        for (int it = 0; it < n_tiles; ++it, ++gt) {
          const int row = bh * s_len + key0 + it * T;
          DkvStage<D>& stage = sm.st[gt % Ring];
          uint64_t* full = &sm.full[gt % Ring];
          wait_empty<Ring>(sm.empty, gt);
          bar_expect(full, 2 * T * D * 2 + 2 * T * 4);
          tma_tile<D, T>(stage.q, map_q, row, full);
          tma_tile<D, T>(stage.dout, map_do, row, full);
          bulk_copy(stage.lse, lse + row, T * 4, full);
          bulk_copy(stage.delta, delta + row, T * 4, full);
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int first = 64 * wg / T;  // the tiles before hold only queries that precede these keys
  if (wg == 1 && Cut != kLoadsOnly) turn_pass(wg);  // warpgroup 0 goes first
  int gt = 0;
  for (int n = 0, bh, r; sched.next(n, bh, r); ++n) {
    const int key0 = r * kRows, n_tiles = (s_len - key0) / T;
    const size_t base = (size_t)bh * s_len * D;
    const int wkey0 = key0 + 64 * wg;
    const int key_a = wkey0 + 16 * warp + g, key_b = key_a + 8;
    const uint32_t k_addr = wg_rows<D>(sm.k[n % 2], wg), v_addr = wg_rows<D>(sm.v[n % 2], wg);

    float s[T / 2], dp[T / 2];  // sᵀ = k·qsᵀ and dpᵀ = v·dOᵀ: s[4j + e] is (key_a, query qt + 8j + 2t + e)
    uint32_t pa[T / 16][4], da[T / 16][4];  // bf16(Pᵀ) and bf16(dSᵀ) as A fragments of 16 queries each
    float dka[D / 2], dva[D / 2];  // dk / ln 2 and dv
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    // sᵀ and dpᵀ of tile `it`, issued as one wgmma group
    auto scores = [&](int it) {
      wait_full<Ring>(sm.full, gt + it);
      if constexpr (Cut == kNoMma) {
#pragma unroll
        for (int i = 0; i < T / 2; ++i) s[i] = dp[i] = 0.125f * (i & 7);
      } else {
        const DkvStage<D>& stage = sm.st[(gt + it) % Ring];
        const uint32_t q_addr = smem_u32(stage.q), do_addr = smem_u32(stage.dout);
        wg_fence();
        ss_rows<T, D, kRows, T>(s, k_addr, q_addr);
        ss_rows<T, D, kRows, T>(dp, v_addr, do_addr);
        wg_commit();
      }
    };
    // Pᵀ into s, dSᵀ = Pᵀ ∘ (dPᵀ − delta) into dp; the query's lse and delta
    // are per column. Only the first 64 queries these keys see cross their
    // diagonal: the first tile, or the first two of 32 (masked: a
    // compile-time branch, as the forward's)
    auto elementwise = [&](int it, auto masked) {
      const int qt = key0 + it * T;
      const DkvStage<D>& stage = sm.st[(gt + it) % Ring];
#pragma unroll
      for (int j = 0; j < T / 8 * (Cut != kMmaOnly); ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(&stage.lse[8 * j + 2 * t]);
        const float2 dl = *reinterpret_cast<const float2*>(&stage.delta[8 * j + 2 * t]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = (e ? ls.y : ls.x) * kLog2e, d = e ? dl.y : dl.x;
          float p_a = Cut == kNoExp ? s[4 * j + e] - l2 : exp2_ftz(s[4 * j + e] - l2);
          float p_b = Cut == kNoExp ? s[4 * j + 2 + e] - l2 : exp2_ftz(s[4 * j + 2 + e] - l2);
          if constexpr (decltype(masked)::value) {
            const int query = qt + 8 * j + 2 * t + e;
            p_a = key_a > query ? 0.f : p_a;
            p_b = key_b > query ? 0.f : p_b;
          }
          s[4 * j + e] = p_a;
          s[4 * j + 2 + e] = p_b;
          dp[4 * j + e] = p_a * (dp[4 * j + e] - d);
          dp[4 * j + 2 + e] = p_b * (dp[4 * j + 2 + e] - d);
        }
      }
    };
    auto pin_all = [&]() {
      pin(s);
      pin(dp);
      pin(dka);
      pin(dva);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        pin(pa[kk]);
        pin(da[kk]);
      }
    };

    bar_wait(&sm.kv_full[n % 2], (n / 2) & 1);
    if constexpr (Cut == kLoadsOnly) {
      for (int it = 0; it < n_tiles; ++it) {
        wait_full<Ring>(sm.full, gt + it);
        release<Ring>(sm.empty, gt + it);
      }
    } else {
      // n_tiles + 1 turns a warpgroup: the first scores, then a tile's dv
      // and dk with the next tile's scores, and an empty turn a tile skipped
      for (int it = 0; it < first; ++it) {  // every query of these tiles precedes this warpgroup's keys
        turn_wait(wg);
        turn_pass(wg);
        wait_full<Ring>(sm.full, gt + it);
        release<Ring>(sm.empty, gt + it);
      }
      turn_wait(wg);
      scores(first);
      turn_pass(wg);
      wg_wait_group<0>();
      pin(s);
      pin(dp);
      for (int it = first; it < n_tiles; ++it) {
        if (it < first + 64 / T)
          elementwise(it, std::true_type{});
        else
          elementwise(it, std::false_type{});
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) {
          pack_a(s, kk, pa[kk]);
          pack_a(dp, kk, da[kk]);
        }
        // dv += bf16(Pᵀ)·dO and dk += bf16(dSᵀ)·qs, both tiles read MN-major as they landed
        turn_wait(wg);
        if constexpr (Cut != kNoMma) {
          const DkvStage<D>& stage = sm.st[(gt + it) % Ring];
          const uint32_t q_addr = smem_u32(stage.q), do_addr = smem_u32(stage.dout);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk) rs_cols<D, T>(dva, pa[kk], do_addr, kk);
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk) rs_cols<D, T>(dka, da[kk], q_addr, kk);
          wg_commit();
        }
        if (it + 1 < n_tiles) scores(it + 1);  // queued right behind them
        turn_pass(wg);
        wg_wait_group<0>();
        pin_all();
        release<Ring>(sm.empty, gt + it);
      }
    }
    if (lane == 0) bar_arrive(&sm.kv_empty[n % 2]);  // every product that read this block's k and v is done
    gt += n_tiles;

    const size_t ra = base + (size_t)key_a * D + 2 * t, rb = base + (size_t)key_b * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + ra + 8 * j) = bf16_wgmma::pack2(dka[4 * j] * kLn2, dka[4 * j + 1] * kLn2);
      *reinterpret_cast<uint32_t*>(dk + rb + 8 * j) = bf16_wgmma::pack2(dka[4 * j + 2] * kLn2, dka[4 * j + 3] * kLn2);
      *reinterpret_cast<uint32_t*>(dv + ra + 8 * j) = bf16_wgmma::pack2(dva[4 * j], dva[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dv + rb + 8 * j) = bf16_wgmma::pack2(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
  if (wg == 0 && Cut != kLoadsOnly) turn_wait(wg);  // warpgroup 1's last pass
}

static_assert(sizeof(SmemFwd<64, 128>) + 1024 <= 232448 && sizeof(SmemDq<64, 128>) + 1024 <= 232448 &&
                  sizeof(SmemDkv<64>) + 1024 <= 232448,
              "over 227 KB of shared memory");
// D = 128 (two-stage rings, 64-column slabs): the forward's 128-key tiles
// and the double-buffered qs, 197,632 bytes; dq's 64-key tiles beside qs and
// dO, 197,632; dk/dv's 32-query tiles (with their lse and delta) beside k
// and v, 166,912; each with the 1 KB the alignment takes
static_assert(sizeof(SmemFwd<128, kFwdKeys<128>>) == 197632 && sizeof(SmemDq<128, kDqKeys<128>>) == 197632 &&
                  sizeof(SmemDkv<128>) == 166912,
              "the D = 128 plans moved");
static_assert(sizeof(SmemFwd<128, kFwdKeys<128>>) + 1024 <= 232448 &&
                  sizeof(SmemDq<128, kDqKeys<128>>) + 1024 <= 232448 && sizeof(SmemDkv<128>) + 1024 <= 232448,
              "over 227 KB of shared memory");

// ---------------------------------------------------------------------------
// Host: TMA maps and launches
// ---------------------------------------------------------------------------

// `map`: the row-major [rows, D] bf16 matrix at `base` in boxes of `box`
// rows by kSlab<D> columns (whole rows up to D = 64), swizzled by the box's
// row width (desc_sw reads them)
template <int D>
int tensor_map(CUtensorMap* map, const bf16* base, int rows, int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {D, (cuuint64_t)rows}, strides[1] = {D * 2};
  const cuuint32_t boxes[2] = {kSlab<D>, (cuuint32_t)box}, unit[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = kSlab<D> == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : kSlab<D> == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims, strides, boxes,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int T, int Cut = kFull>
int launch_fwd(cudaStream_t st, const bf16* qs, const bf16* k, const bf16* v, float* o, float* lse, int bh, int s) {
  CUtensorMap map_q, map_k, map_v;
  int grid = 0;
  int e = tensor_map<D>(&map_q, qs, bh * s, kRows);
  if (e == 0) e = tensor_map<D>(&map_k, k, bh * s, T);
  if (e == 0) e = tensor_map<D>(&map_v, v, bh * s, T);
  if (e == 0) e = persistent_grid(bh * (s / kRows), &grid);
  if (e != 0) return e;
  return launch(flash_fwd_bf16_tc<D, T, Cut>, (int)sizeof(SmemFwd<D, T>) + 1024, dim3(grid), kWsThreads, st, map_q,
                map_k, map_v, o, lse, bh, s);
}

template <int D, int Cut = kFull>
int launch_dkv(cudaStream_t st, const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
               const float* delta, bf16* dk, bf16* dv, int bh, int s) {
  CUtensorMap map_q, map_do, map_k, map_v;
  int grid = 0;
  int e = tensor_map<D>(&map_q, qs, bh * s, kDkvTile<D>);
  if (e == 0) e = tensor_map<D>(&map_do, dout, bh * s, kDkvTile<D>);
  if (e == 0) e = tensor_map<D>(&map_k, k, bh * s, kRows);
  if (e == 0) e = tensor_map<D>(&map_v, v, bh * s, kRows);
  if (e == 0) e = persistent_grid(bh * (s / kRows), &grid);
  if (e != 0) return e;
  return launch(flash_bwd_dkv_bf16_tc<D, Cut>, (int)sizeof(SmemDkv<D>) + 1024, dim3(grid), kWsThreads, st, map_q,
                map_do, map_k, map_v, lse, delta, dk, dv, bh, s);
}

template <int D, int T, int Cut = kFull>
int launch_dq(cudaStream_t st, const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
              const float* delta, bf16* dq, int bh, int s, float scale) {
  CUtensorMap map_q, map_do, map_k, map_v;
  int grid = 0;
  int e = tensor_map<D>(&map_q, qs, bh * s, kRows);
  if (e == 0) e = tensor_map<D>(&map_do, dout, bh * s, kRows);
  if (e == 0) e = tensor_map<D>(&map_k, k, bh * s, T);
  if (e == 0) e = tensor_map<D>(&map_v, v, bh * s, T);
  if (e == 0) e = persistent_grid(bh * (s / kRows), &grid);
  if (e != 0) return e;
  return launch(flash_bwd_dq_bf16_tc<D, T, Cut>, (int)sizeof(SmemDq<D, T>) + 1024, dim3(grid), kWsThreads, st, map_q,
                map_do, map_k, map_v, lse, delta, dq, bh, s, scale);
}

}  // namespace

extern "C" {

// Forward on `stream`: o [BH, S, D] and lse [BH, S] f32 from qs, k, v
// [BH, S, D] bf16 (qs pre-scaled by scale·log2 e). D in {16, 32, 64, 128}, S a
// multiple of 128. Returns the cudaError_t of the launch.
int flash_fwd_bf16_launch(const bf16* qs, const bf16* k, const bf16* v, float* o, float* lse, int bh, int s, int d,
                          void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_fwd<16, kFwdKeys<16>>(st, qs, k, v, o, lse, bh, s);
    case 32: return launch_fwd<32, kFwdKeys<32>>(st, qs, k, v, o, lse, bh, s);
    case 64: return launch_fwd<64, kFwdKeys<64>>(st, qs, k, v, o, lse, bh, s);
    case 128: return launch_fwd<128, kFwdKeys<128>>(st, qs, k, v, o, lse, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq [BH, S, D] bf16 from qs, k, v, dO [BH, S, D] bf16 and lse, delta [BH, S] f32.
int flash_bwd_dq_bf16_launch(const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                             const float* delta, bf16* dq, int bh, int s, int d, float scale, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dq<16, kDqKeys<16>>(st, qs, k, v, dout, lse, delta, dq, bh, s, scale);
    case 32: return launch_dq<32, kDqKeys<32>>(st, qs, k, v, dout, lse, delta, dq, bh, s, scale);
    case 64: return launch_dq<64, kDqKeys<64>>(st, qs, k, v, dout, lse, delta, dq, bh, s, scale);
    case 128: return launch_dq<128, kDqKeys<128>>(st, qs, k, v, dout, lse, delta, dq, bh, s, scale);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv [BH, S, D] bf16 from the same inputs.
int flash_bwd_dkv_bf16_launch(const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                              const float* delta, bf16* dk, bf16* dv, int bh, int s, int d, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dkv<16>(st, qs, k, v, dout, lse, delta, dk, dv, bh, s);
    case 32: return launch_dkv<32>(st, qs, k, v, dout, lse, delta, dk, dv, bh, s);
    case 64: return launch_dkv<64>(st, qs, k, v, dout, lse, delta, dk, dv, bh, s);
    case 128: return launch_dkv<128>(st, qs, k, v, dout, lse, delta, dk, dv, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef FLASH_BF16_CUTS
// The attribution cuts (chip_sweep.py bf16), built only with -DFLASH_BF16_CUTS
// and never reached by the wrappers: the forward and dq at `keys` keys a
// tile and dk/dv, each with `cut` in kFull … kMmaOnly. Returns
// cudaErrorInvalidValue for a pair the source has no instance of.
int flash_fwd_bf16_cut_launch(const bf16* qs, const bf16* k, const bf16* v, float* o, float* lse, int bh, int s, int d,
                              int keys, int cut, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_CUT(DD, TT, CC) \
  if (d == DD && keys == TT && cut == CC) return launch_fwd<DD, TT, CC>(st, qs, k, v, o, lse, bh, s);
#define FWD_CUTS(DD, TT) FWD_CUT(DD, TT, kFull) FWD_CUT(DD, TT, kNoExp) FWD_CUT(DD, TT, kNoMma) FWD_CUT(DD, TT, kLoadsOnly) FWD_CUT(DD, TT, kMmaOnly)
  FWD_CUTS(16, 64) FWD_CUTS(16, 128) FWD_CUTS(32, 64) FWD_CUTS(32, 128) FWD_CUTS(64, 64) FWD_CUTS(64, 128)
  FWD_CUTS(128, 64) FWD_CUTS(128, 128)
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dq_bf16_cut_launch(const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                                 const float* delta, bf16* dq, int bh, int s, int d, float scale, int keys, int cut,
                                 void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ_CUT(DD, TT, CC) \
  if (d == DD && keys == TT && cut == CC) return launch_dq<DD, TT, CC>(st, qs, k, v, dout, lse, delta, dq, bh, s, scale);
#define DQ_CUTS(DD, TT) DQ_CUT(DD, TT, kFull) DQ_CUT(DD, TT, kNoExp) DQ_CUT(DD, TT, kNoMma) DQ_CUT(DD, TT, kLoadsOnly) DQ_CUT(DD, TT, kMmaOnly)
  DQ_CUTS(16, 64) DQ_CUTS(16, 128) DQ_CUTS(32, 64) DQ_CUTS(32, 128) DQ_CUTS(64, 64) DQ_CUTS(64, 128) DQ_CUTS(128, 64)
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dkv_bf16_cut_launch(const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                                  const float* delta, bf16* dk, bf16* dv, int bh, int s, int d, int cut, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV_CUT(DD, CC) \
  if (d == DD && cut == CC) return launch_dkv<DD, CC>(st, qs, k, v, dout, lse, delta, dk, dv, bh, s);
#define DKV_CUTS(DD) DKV_CUT(DD, kFull) DKV_CUT(DD, kNoExp) DKV_CUT(DD, kNoMma) DKV_CUT(DD, kLoadsOnly) DKV_CUT(DD, kMmaOnly)
  DKV_CUTS(16) DKV_CUTS(32) DKV_CUTS(64) DKV_CUTS(128)
  return (int)cudaErrorInvalidValue;
}
#endif

}  // extern "C"
