// Causal flash attention on bf16 inputs, forward and backward, for Hopper
// (sm_90a): the `cast16` branches of the JAX package's
// ops/flash_attention.py, taken there when q is bf16 and the precision is
// 'default' (`flash_attention` :860).
//
//   _fwd_tri     :559 (_fwd_kernel_tri :253, cast16, fuse_l)    -> flash_fwd_bf16_launch     -> flash_fwd_bf16_tc<D, Keys>
//                                                                  (D = 128: flash_fwd_bf16_d128_tc<Plan>)
//   _bwd_tri dq  :655 (_bwd_dq_kernel_tri :341, cast16)         -> flash_bwd_dq_bf16_launch  -> flash_bwd_dq_bf16_tc<D, Keys>
//   _bwd_tri dkv :673 (_bwd_dkv_kernel_tri :365, cast16)        -> flash_bwd_dkv_bf16_launch -> flash_bwd_dkv_bf16_tc<D>
//                                                                  (D = 128: flash_bwd_dkv_bf16_d128_tc<Ring>)
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
//     dk/dv streams 64 queries a tile (128 would not fit its registers).
//   * D = 128: every tile lands as 64-column slabs with the 128-byte
//     swizzle (kSlab), two TMA boxes a tile, read K-major a slab a k16 step
//     and MN-major as two N = 64 products, one a slab; the row sum l is the
//     same sum of the rounded P as at D <= 64 (the JAX package's l scratch,
//     `fuse_l` false at D 128, sums the same terms). At (BH, S) = (128,
//     2048) a tensor is 67 MB: K and V of every head do not fit the 50 MB
//     L2, and `Schedule`, which deals out block row r of every head before
//     row r + 1, reads them from device memory again for every block
//     (on an H100 the forward's producer alone took 0.41 of 0.60 ms,
//     dk/dv's 0.52 of 0.93; chip_sweep.py bf16). So the forward and dk/dv
//     at D 128 walk a head's blocks side by side (`HeadWalk`: 5 to 10 heads,
//     at most 15 MB, in flight), each with a plan of its own (the
//     static_asserts state the bytes):
//     - the forward (flash_fwd_bf16_d128_tc) keeps two 64-row warpgroups
//       a 128-query block, ping-pong and 128-key tiles, but frees K and V
//       apart (K after both warpgroups' scores, V after their P·V) from
//       rings of their own, K a tile ahead of V and a stage deeper, and
//       frees qs after the block's last scores (FwdDepth);
//     - dk/dv (flash_bwd_dkv_bf16_d128_tc) splits its consumers by role
//       on blocks of 64 keys: warpgroup 0 holds K as its A fragments, forms
//       Sᵀ = K·qsᵀ and Pᵀ, and sums dv += bf16(Pᵀ)·dO; warpgroup 1 holds V,
//       forms dPᵀ = V·dOᵀ and dSᵀ from Pᵀ, which it takes in f32 from
//       warpgroup 0 through two slots of shared memory (dS is formed from
//       the unrounded P), and sums dk += bf16(dSᵀ)·qs. The score products
//       read only qs or dO from shared memory (N = 64 queries a tile), the
//       accumulators take 64 registers a thread, and a ring of
//       kDkv128Ring qs/dO stages runs ahead.
//     dq keeps a ring of two stages (kRing) and 64-key tiles.
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
using hopper_tma::named_arrive;
using hopper_tma::named_sync;
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
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg
constexpr int kLaunchRegs = 65536 / kWsThreads / 8 * 8;   // a thread's registers at __launch_bounds__(384, 1): 168
// setmaxnreg moves registers within the pool the CTA is launched with
static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= kWsThreads * kLaunchRegs, "setmaxnreg over the CTA's pool");
// queries a dk/dv tile at every head dim (flash_bwd_dkv_bf16_tc up to D = 64,
// flash_bwd_dkv_bf16_d128_tc at D = 128)
template <int D>
constexpr int kDkvTile = 64;
// keys a forward tile, by head dim (chip_sweep.py bf16 times 64 and 128; BF16_FWD_KEYS in ops/flash_cuda.py)
template <int D>
constexpr int kFwdKeys = 128;
// keys a dq tile, by head dim (chip_sweep.py bf16 times 64 and 128; the plain version takes any). At
// D = 128 a 128-key ring stage is 64 KB, and two of them beside the double-buffered qs and dO pass 227 KB
template <int D>
constexpr int kDqKeys = 128;
template <>
constexpr int kDqKeys<128> = 64;
// stages of the producer's ring of the forward, dq and dk/dv up to D = 64
// (four), and of dq at D = 128 (two: a stage of a K and a V tile is 32 KB
// and the block's qs and dO take 64 KB a buffer; the plans' bytes stand in
// the static_asserts after the kernels)
template <int D>
constexpr int kRing = D == 128 ? 2 : 4;

// attribution cuts (the template argument Cut; the shipped entry points
// take kFull). kNoLoads, the consumers alone, only in the D-128 forward and
// dk/dv: the producer arrives on each full barrier without a copy
constexpr int kFull = 0, kNoExp = 1, kNoMma = 2, kLoadsOnly = 3, kMmaOnly = 4, kNoLoads = 5;

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
  static_assert(D <= 64, "D = 128 runs flash_fwd_bf16_d128_tc");
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
  static_assert(D <= 64, "D = 128 runs flash_bwd_dkv_bf16_d128_tc");
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

// ---------------------------------------------------------------------------
// D = 128: the forward and dk/dv (the note at the top)
// ---------------------------------------------------------------------------

constexpr int kSmemLimit = 232448;  // shared memory a block may have (227 KB)

// The walk of the D-128 forward and dk/dv: the blocks of a launch head by
// head (block r of head bh is item bh·rows + r, r = 0 the heaviest), dealt
// to the persistent CTAs in a snake as `Schedule` deals them, so that the
// CTAs work on a few heads at a time, whose rows stay in L2 while every
// block of the head reads them again.
struct HeadWalk {
  int heads, rows;  // BH, and blocks a head
  // this CTA's n-th block: head bh, block r (0 the heaviest); false past the last
  __device__ __forceinline__ bool next(int n, int& bh, int& r) const {
    const int g = gridDim.x, c = blockIdx.x;
    const int idx = n * g + (n % 2 == 0 ? c : g - 1 - c);
    if (idx >= heads * rows) return false;
    bh = idx / rows;
    r = idx % rows;
    return true;
  }
};

// The producer's copy of the x-th tile of a ring of Stages stages: R rows
// of `map` from `row` into stage x % Stages once its last tile is freed;
// without Copy (the kNoLoads cut) only the arrival
template <int Stages, int R, bool Copy>
__device__ __forceinline__ void land(bf16 (&ring)[Stages][R * 128], uint64_t* full, uint64_t* empty, int x,
                                     const CUtensorMap& map, int row) {
  wait_empty<Stages>(empty, x);
  if constexpr (Copy) {
    bar_expect(&full[x % Stages], R * 128 * 2);
    tma_tile<128, R>(ring[x % Stages], map, row, &full[x % Stages]);
  } else {
    bar_arrive(&full[x % Stages]);
  }
}

// Stages of the D-128 forward's rings by plan: K tiles, V tiles and blocks
// of qs, 32 KB each. Plan kFwd128Plan is shipped; chip_sweep.py bf16 times
// every plan.
template <int Plan>
struct FwdDepth;
template <>
struct FwdDepth<0> {
  static constexpr int k = 3, v = 2, q = 2;
};
template <>
struct FwdDepth<1> {
  static constexpr int k = 3, v = 3, q = 1;
};
template <>
struct FwdDepth<2> {
  static constexpr int k = 2, v = 2, q = 2;  // the depth of the D <= 64 plan at D = 128
};
constexpr int kFwd128Plan = 0;

template <int Plan>
struct SmemFwd128 {
  using P = FwdDepth<Plan>;
  alignas(1024) bf16 k[P::k][kFwdKeys<128> * 128];  // K tiles as the TMA wrote them: read K-major for qs·kᵀ
  alignas(1024) bf16 v[P::v][kFwdKeys<128> * 128];  // V tiles, the same: read MN-major for P·V
  alignas(1024) bf16 q[P::q][kRows * 128];          // blocks' rows of qs, one 64-row operand a warpgroup
  uint64_t k_full[P::k], k_empty[P::k], v_full[P::v], v_empty[P::v], q_full[P::q], q_empty[P::q];
};

// The forward at D = 128: flash_fwd_bf16_tc's products, softmax and
// epilogue in the same order (the same bits), from rings of their own for
// K, V and qs. Persistent: grid min(SMs, blocks), kWsThreads threads,
// sizeof(SmemFwd128<Plan>) + 1024 bytes of dynamic shared memory; a CTA
// takes the 128-row blocks of `HeadWalk` in turn, 128 keys a tile; qs, K
// and V through TMA maps of [BH·S, 128] in 128-row boxes of 64 columns.
template <int Plan, int Cut = kFull>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_bf16_d128_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, float* __restrict__ o, float* __restrict__ lse,
                       int bh_count, int s_len) {
  using S = SmemFwd128<Plan>;
  using P = FwdDepth<Plan>;
  constexpr int D = 128, T = kFwdKeys<128>;
  static_assert(T == kRows, "both warpgroups see every tile of their block: none is freed unread");
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const HeadWalk walk{bh_count, s_len / kRows};
  const int wg = threadIdx.x / 128;

  init_ring<P::k>(sm.k_full, sm.k_empty);
  init_ring<P::v>(sm.v_full, sm.v_empty);
  init_ring<P::q>(sm.q_full, sm.q_empty);
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy, K a tile ahead of V, running ahead across blocks
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      constexpr bool kCopy = Cut != kNoLoads;
      int g = 0, v_row = 0;  // tiles of this CTA so far; the row of tile g − 1, whose V follows tile g's K
      for (int n = 0, bh, r; walk.next(n, bh, r); ++n) {
        const int row0 = (walk.rows - 1 - r) * kRows, n_tiles = (row0 + kRows) / T;
        land<P::q, kRows, kCopy>(sm.q, sm.q_full, sm.q_empty, n, map_q, bh * s_len + row0);
        for (int it = 0; it < n_tiles; ++it, ++g) {
          land<P::k, T, kCopy>(sm.k, sm.k_full, sm.k_empty, g, map_k, bh * s_len + it * T);
          if (g > 0) land<P::v, T, kCopy>(sm.v, sm.v_full, sm.v_empty, g - 1, map_v, v_row);
          v_row = bh * s_len + it * T;
        }
      }
      if (g > 0) land<P::v, T, kCopy>(sm.v, sm.v_full, sm.v_empty, g - 1, map_v, v_row);
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t ones = g == 0 ? 0x3F803F80u : 0u;  // B of l = bf16(P)·[1 | 0]: column 0 ones
  if (wg == 1 && Cut != kLoadsOnly) turn_pass(wg);  // warpgroup 0 goes first
  int gt = 0;
  for (int n = 0, bh, r; walk.next(n, bh, r); ++n) {
    const int row0 = (walk.rows - 1 - r) * kRows, n_tiles = (row0 + kRows) / T;
    const size_t base = (size_t)bh * s_len * D;
    const int row_a = row0 + 64 * wg + 16 * warp + g, row_b = row_a + 8;
    const uint32_t q_addr = wg_rows<D>(sm.q[n % P::q], wg);

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
      if constexpr (Cut == kNoMma) {
#pragma unroll
        for (int i = 0; i < T / 2; ++i) sc[i] = 0.125f * (i & 7);
      } else {
        const uint32_t k_addr = smem_u32(sm.k[(gt + it) % P::k]);
        wg_fence();
        ss_rows<T, D, kRows, T>(sc, q_addr, k_addr);
        wg_commit();
      }
    };
    // acc += bf16(P)·V of tile `it`, issued as one wgmma group
    auto pv = [&](int it) {
      if constexpr (Cut != kNoMma) {
        const uint32_t v_addr = smem_u32(sm.v[(gt + it) % P::v]);
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
    // only the block's last tile crosses these rows' diagonal (masked)
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
    auto free_q = [&]() {  // every product that reads this block's qs is done
      if (lane == 0) bar_arrive(&sm.q_empty[n % P::q]);
    };

    wait_full<P::q>(sm.q_full, n);
    if constexpr (Cut == kLoadsOnly) {  // the whole kernel's waits and frees in its order (qs after the last K)
      for (int it = 0; it < n_tiles; ++it) {
        wait_full<P::k>(sm.k_full, gt + it);
        release<P::k>(sm.k_empty, gt + it);
        if (it == n_tiles - 1) free_q();
        if (it > 0) {
          wait_full<P::v>(sm.v_full, gt + it - 1);
          release<P::v>(sm.v_empty, gt + it - 1);
        }
      }
      wait_full<P::v>(sm.v_full, gt + n_tiles - 1);
      release<P::v>(sm.v_empty, gt + n_tiles - 1);
    } else {
      // n_tiles + 1 turns a warpgroup: the first scores, n_tiles − 1 of
      // scores and P·V, the last P·V. A K stage is freed after both
      // warpgroups' scores on it, a V stage after their P·V, qs after the
      // block's last scores; the data is waited for outside the turn
      wait_full<P::k>(sm.k_full, gt);
      turn_wait(wg);
      scores(0);
      turn_pass(wg);
      wg_wait_group<0>();
      pin(sc);
      release<P::k>(sm.k_empty, gt);
      if (n_tiles == 1) {
        free_q();
        softmax(0, std::true_type{});
      } else {
        softmax(0, std::false_type{});
      }
      pack();
      for (int it = 1; it < n_tiles; ++it) {
        wait_full<P::k>(sm.k_full, gt + it);
        wait_full<P::v>(sm.v_full, gt + it - 1);
        turn_wait(wg);
        scores(it);
        rescale();  // by tile it − 1's correction, under the score product
        pv(it - 1);
        turn_pass(wg);
        wg_wait_group<1>();  // the scores; P·V may still run
        pin(sc);
        release<P::k>(sm.k_empty, gt + it);
        if (it == n_tiles - 1) {
          free_q();
          softmax(it, std::true_type{});
        } else {
          softmax(it, std::false_type{});
        }
        wg_wait_group<0>();
        pin_pv();
        release<P::v>(sm.v_empty, gt + it - 1);
        pack();
      }
      wait_full<P::v>(sm.v_full, gt + n_tiles - 1);
      turn_wait(wg);
      rescale();
      pv(n_tiles - 1);
      turn_pass(wg);
      wg_wait_group<0>();
      pin_pv();
      release<P::v>(sm.v_empty, gt + n_tiles - 1);
    }
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

constexpr int kDkvKeys = 64;    // keys a dk/dv block at D = 128: one warpgroup's rows
constexpr int kDkv128Ring = 4;  // qs/dO stages of the dk/dv at D = 128 (chip_sweep.py bf16 times 3 too)
// named barriers of the dk/dv at D = 128 (0 is __syncthreads): a tile's Pᵀ
// handed from consumer 0 to consumer 1 through slot s (kPFull + s: written;
// kPFree + s: read)
constexpr int kPFull = 1, kPFree = 3;

template <int Ring>
struct SmemDkv128 {
  DkvStage<128> st[Ring];                     // qs, dO, lse and delta of a 64-query tile
  alignas(1024) bf16 k[kDkvKeys * 128];       // the block's k as the TMA wrote it, until consumer 0 holds it
  alignas(1024) bf16 v[kDkvKeys * 128];       // and v, until consumer 1 does
  float4 p[2][kDkvTile<128> / 8][128];        // a tile's Pᵀ, consumer 0's thread i to consumer 1's: [slot][j][i]
  uint64_t full[Ring], empty[Ring], kv_full, kv_empty;
};

// A warpgroup's [64 x 128] tile as the TMA wrote it (two slabs of 64 rows by
// 64 columns, 128-byte swizzle) as the A fragments of its score products, a
// k16 step each: step kk holds rows 16·warp + g (+ 8), columns 16kk + 2t
// (+ 1) and 16kk + 8 + 2t (+ 1), as `pack_a` lays a fragment out
__device__ __forceinline__ void take_a(const bf16* tile, uint32_t (&a)[8][4], int warp, int g, int t) {
  const char* base = reinterpret_cast<const char*>(tile);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + 8 * (e & 1), chunk = 2 * (kk % 4) + (e >> 1);  // row % 8 == g
      a[kk][e] = *reinterpret_cast<const uint32_t*>(base + kk / 4 * kDkvKeys * 128 + row * 128 + ((chunk ^ g) << 4) +
                                                    4 * t);
    }
}

// A consumer warpgroup's part of every block the CTA walks (the note at the
// top). Role 0: Sᵀ = K·qsᵀ, Pᵀ (handed to consumer 1), dv += bf16(Pᵀ)·dO;
// role 1: dPᵀ = V·dOᵀ, dSᵀ = Pᵀ ∘ (dPᵀ − delta), dk += bf16(dSᵀ)·qs; `out` is
// dv or dk. Each takes its K or V as A fragments as the block starts, then
// issues tile t's scores before tile t − 1's products, which run under
// tile t's exps (role 0) or its dSᵀ (role 1).
template <int Role, int Ring, int Cut>
__device__ __forceinline__ void dkv128_consume(SmemDkv128<Ring>& sm, const HeadWalk& walk, bf16* __restrict__ out,
                                               int s_len) {
  constexpr int D = 128, T = kDkvTile<128>;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  int gt = 0;
  for (int n = 0, bh, r; walk.next(n, bh, r); ++n) {
    const int key0 = r * kDkvKeys, n_tiles = (s_len - key0) / T;  // queries [key0, S): the first blocks see the most
    const int key_a = key0 + 16 * warp + g, key_b = key_a + 8;
    float acc[D / 2];  // dv (role 0) or dk / ln 2 (role 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    bar_wait(&sm.kv_full, n & 1);
    if constexpr (Cut == kLoadsOnly) {
      if (lane == 0) bar_arrive(&sm.kv_empty);
      for (int it = 0; it < n_tiles; ++it) {
        wait_full<Ring>(sm.full, gt + it);
        release<Ring>(sm.empty, gt + it);
      }
    } else {
      uint32_t a[8][4];  // K (role 0) or V (role 1): the score products' A fragments
      take_a(Role == 0 ? sm.k : sm.v, a, warp, g, t);
      if (lane == 0) bar_arrive(&sm.kv_empty);  // the next block's k and v may land
      float s[T / 2];         // Sᵀ or dPᵀ of a tile: s[4j + e] is (key_a, query qt + 8j + 2t + e), s[4j + 2 + e] key_b
      uint32_t x[T / 16][4];  // bf16(Pᵀ) or bf16(dSᵀ): A fragments of 16 queries each

      // s of tile `it` against the qs (role 0) or dO (role 1) tile read K-major, issued as one wgmma group
      auto scores = [&](int it) {
        if constexpr (Cut == kNoMma) {
#pragma unroll
          for (int i = 0; i < T / 2; ++i) s[i] = (Role == 0 ? 0.125f : 0.0625f) * (i & 7);
        } else {
          const DkvStage<D>& stage = sm.st[(gt + it) % Ring];
          const uint32_t b = smem_u32(Role == 0 ? stage.q : stage.dout);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_rs_bf16<T>(s, a[kk], desc_sw<kSlab<D>>(k_step<D, T>(b, kk)), kk > 0);
          wg_commit();
        }
      };
      // acc += x·(dO or qs) of tile `it`, the tile read MN-major as it landed, issued as one wgmma group
      auto products = [&](int it) {
        if constexpr (Cut != kNoMma) {
          const DkvStage<D>& stage = sm.st[(gt + it) % Ring];
          const uint32_t b = smem_u32(Role == 0 ? stage.dout : stage.q);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk) rs_cols<D, T>(acc, x[kk], b, kk);
          wg_commit();
        }
      };
      // role 0: Pᵀ in s (the query's lse per column; masked: the tile holds
      // the block's diagonal), then into slot (gt + it) % 2; role 1: dSᵀ in s
      // from that slot's Pᵀ and the queries' delta
      auto form = [&](int it, auto masked) {
        const int slot = (gt + it) & 1, qt = key0 + it * T;
        const DkvStage<D>& stage = sm.st[(gt + it) % Ring];
        if constexpr (Role == 0) {
#pragma unroll
          for (int j = 0; j < T / 8 * (Cut != kMmaOnly); ++j) {
            const float2 ls = *reinterpret_cast<const float2*>(&stage.lse[8 * j + 2 * t]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float l2 = (e ? ls.y : ls.x) * kLog2e;
              float p_a = Cut == kNoExp ? s[4 * j + e] - l2 : exp2_ftz(s[4 * j + e] - l2);
              float p_b = Cut == kNoExp ? s[4 * j + 2 + e] - l2 : exp2_ftz(s[4 * j + 2 + e] - l2);
              if constexpr (decltype(masked)::value) {
                const int query = qt + 8 * j + 2 * t + e;
                p_a = key_a > query ? 0.f : p_a;
                p_b = key_b > query ? 0.f : p_b;
              }
              s[4 * j + e] = p_a;
              s[4 * j + 2 + e] = p_b;
            }
          }
          if (gt + it >= 2) named_sync(kPFree + slot, 256);  // consumer 1 has read the slot's last Pᵀ
#pragma unroll
          for (int j = 0; j < T / 8; ++j)
            sm.p[slot][j][tid] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
          named_arrive(kPFull + slot, 256);
        } else {
          named_sync(kPFull + slot, 256);
#pragma unroll
          for (int j = 0; j < T / 8 * (Cut != kMmaOnly); ++j) {
            const float4 p = sm.p[slot][j][tid];
            const float2 dl = *reinterpret_cast<const float2*>(&stage.delta[8 * j + 2 * t]);
            s[4 * j] = p.x * (s[4 * j] - dl.x);
            s[4 * j + 1] = p.y * (s[4 * j + 1] - dl.y);
            s[4 * j + 2] = p.z * (s[4 * j + 2] - dl.x);
            s[4 * j + 3] = p.w * (s[4 * j + 3] - dl.y);
          }
          named_arrive(kPFree + slot, 256);
        }
      };
      auto pack = [&]() {
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) pack_a(s, kk, x[kk]);
      };
      auto pin_products = [&]() {  // x's registers stay untouched until its product is done
        pin(acc);
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) pin(x[kk]);
      };

      wait_full<Ring>(sm.full, gt);
      scores(0);
      wg_wait_group<0>();
      pin(s);
      form(0, std::true_type{});  // the first tile, queries key0 …, holds the block's diagonal
      pack();
      for (int it = 1; it < n_tiles; ++it) {
        wait_full<Ring>(sm.full, gt + it);
        scores(it);
        products(it - 1);
        wg_wait_group<1>();  // the scores; the products may still run
        pin(s);
        form(it, std::false_type{});
        wg_wait_group<0>();
        pin_products();
        release<Ring>(sm.empty, gt + it - 1);
        pack();
      }
      products(n_tiles - 1);
      wg_wait_group<0>();
      pin_products();
      release<Ring>(sm.empty, gt + n_tiles - 1);
    }
    gt += n_tiles;

    bf16* ra = out + ((size_t)bh * s_len + key_a) * D + 2 * t;
    bf16* rb = out + ((size_t)bh * s_len + key_b) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if constexpr (Role == 0) {
        *reinterpret_cast<uint32_t*>(ra + 8 * j) = bf16_wgmma::pack2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(rb + 8 * j) = bf16_wgmma::pack2(acc[4 * j + 2], acc[4 * j + 3]);
      } else {
        *reinterpret_cast<uint32_t*>(ra + 8 * j) = bf16_wgmma::pack2(acc[4 * j] * kLn2, acc[4 * j + 1] * kLn2);
        *reinterpret_cast<uint32_t*>(rb + 8 * j) = bf16_wgmma::pack2(acc[4 * j + 2] * kLn2, acc[4 * j + 3] * kLn2);
      }
    }
  }
  // consumer 1 freed the last two tiles' slots without a writer waiting: match them
  if constexpr (Role == 0 && Cut != kLoadsOnly)
    for (int x = max(gt - 2, 0); x < gt; ++x) named_sync(kPFree + (x & 1), 256);
}

// dk, dv at D = 128 as flash_bwd_dkv_bf16_tc computes them (each row summed
// in ascending query order a k16 step at a time: the same bits). Persistent:
// grid min(SMs, blocks), kWsThreads threads, sizeof(SmemDkv128<Ring>) + 1024
// bytes of dynamic shared memory; a CTA takes the 64-key blocks of
// `HeadWalk` in turn; qs, dO, k and v through TMA maps of [BH·S, 128] in
// 64-row boxes of 64 columns.
template <int Ring, int Cut = kFull>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_dkv_bf16_d128_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                           const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                           const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int bh_count, int s_len) {
  using S = SmemDkv128<Ring>;
  constexpr int D = 128, T = kDkvTile<128>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const HeadWalk walk{bh_count, s_len / kDkvKeys};  // block r of a head: keys r·64 …, the first ones heaviest

  init_ring<Ring>(sm.full, sm.empty);
  init_ring<1>(&sm.kv_full, &sm.kv_empty);
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer: one thread issues every copy, running ahead across blocks
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      int gt = 0;  // tiles of this CTA so far: the ring's position
      for (int n = 0, bh, r; walk.next(n, bh, r); ++n) {
        const int key0 = r * kDkvKeys, n_tiles = (s_len - key0) / T;
        if (n >= 1) bar_wait(&sm.kv_empty, (n - 1) & 1);  // both consumers hold the last block's k and v
        if constexpr (Cut != kNoLoads) {
          bar_expect(&sm.kv_full, 2 * kDkvKeys * D * 2);
          tma_tile<D, kDkvKeys>(sm.k, map_k, bh * s_len + key0, &sm.kv_full);
          tma_tile<D, kDkvKeys>(sm.v, map_v, bh * s_len + key0, &sm.kv_full);
        } else {
          bar_arrive(&sm.kv_full);
        }
        for (int it = 0; it < n_tiles; ++it, ++gt) {
          const int row = bh * s_len + key0 + it * T;
          DkvStage<D>& stage = sm.st[gt % Ring];
          uint64_t* full = &sm.full[gt % Ring];
          wait_empty<Ring>(sm.empty, gt);
          if constexpr (Cut != kNoLoads) {
            bar_expect(full, 2 * T * D * 2 + 2 * T * 4);
            tma_tile<D, T>(stage.q, map_q, row, full);
            tma_tile<D, T>(stage.dout, map_do, row, full);
            bulk_copy(stage.lse, lse + row, T * 4, full);
            bulk_copy(stage.delta, delta + row, T * 4, full);
          } else {
            bar_arrive(full);
          }
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  if (threadIdx.x < 128)
    dkv128_consume<0, Ring, Cut>(sm, walk, dv, s_len);
  else
    dkv128_consume<1, Ring, Cut>(sm, walk, dk, s_len);
}

// The D = 128 plans (64-column slabs), each with the 1 KB the alignment
// takes: the forward's K, V and qs rings of 32 KB tiles, 230,400 bytes
// (plans 0 and 1: 3, 2, 2 and 3, 3, 1 stages) and 197,632 (plan 2: 2, 2,
// 2); dq's two stages of 64-key tiles beside qs and dO, 197,632; dk/dv's
// four stages of 64 queries (qs, dO, lse, delta) beside k, v and the two
// Pᵀ slots, 201,728 (three stages: 167,936), and a fifth stage would not fit
static_assert(sizeof(SmemFwd128<0>) == 230400 && sizeof(SmemFwd128<1>) == 230400 &&
                  sizeof(SmemFwd128<2>) == 197632 && sizeof(SmemDq<128, kDqKeys<128>>) == 197632 &&
                  sizeof(SmemDkv128<4>) == 201728 && sizeof(SmemDkv128<3>) == 167936,
              "the D = 128 plans moved");
static_assert(sizeof(SmemFwd128<0>) + 1024 <= kSmemLimit && sizeof(SmemFwd128<1>) + 1024 <= kSmemLimit &&
                  sizeof(SmemDq<128, kDqKeys<128>>) + 1024 <= kSmemLimit &&
                  sizeof(SmemDkv128<kDkv128Ring>) + 1024 <= kSmemLimit,
              "over 227 KB of shared memory");
static_assert(sizeof(SmemDkv128<kDkv128Ring + 1>) + 1024 > kSmemLimit, "a deeper dk/dv ring would fit");

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

template <int Plan, int Cut = kFull>
int launch_fwd128(cudaStream_t st, const bf16* qs, const bf16* k, const bf16* v, float* o, float* lse, int bh, int s) {
  CUtensorMap map_q, map_k, map_v;
  int grid = 0;
  int e = tensor_map<128>(&map_q, qs, bh * s, kRows);
  if (e == 0) e = tensor_map<128>(&map_k, k, bh * s, kFwdKeys<128>);
  if (e == 0) e = tensor_map<128>(&map_v, v, bh * s, kFwdKeys<128>);
  if (e == 0) e = persistent_grid(bh * (s / kRows), &grid);
  if (e != 0) return e;
  return launch(flash_fwd_bf16_d128_tc<Plan, Cut>, (int)sizeof(SmemFwd128<Plan>) + 1024, dim3(grid), kWsThreads, st,
                map_q, map_k, map_v, o, lse, bh, s);
}

template <int Ring, int Cut = kFull>
int launch_dkv128(cudaStream_t st, const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                  const float* delta, bf16* dk, bf16* dv, int bh, int s) {
  CUtensorMap map_q, map_do, map_k, map_v;
  int grid = 0;
  int e = tensor_map<128>(&map_q, qs, bh * s, kDkvTile<128>);
  if (e == 0) e = tensor_map<128>(&map_do, dout, bh * s, kDkvTile<128>);
  if (e == 0) e = tensor_map<128>(&map_k, k, bh * s, kDkvKeys);
  if (e == 0) e = tensor_map<128>(&map_v, v, bh * s, kDkvKeys);
  if (e == 0) e = persistent_grid(bh * (s / kDkvKeys), &grid);
  if (e != 0) return e;
  return launch(flash_bwd_dkv_bf16_d128_tc<Ring, Cut>, (int)sizeof(SmemDkv128<Ring>) + 1024, dim3(grid), kWsThreads,
                st, map_q, map_do, map_k, map_v, lse, delta, dk, dv, bh, s);
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
    case 128: return launch_fwd128<kFwd128Plan>(st, qs, k, v, o, lse, bh, s);
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
    case 128: return launch_dkv128<kDkv128Ring>(st, qs, k, v, dout, lse, delta, dk, dv, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef FLASH_BF16_CUTS
// The attribution cuts (chip_sweep.py bf16), built only with -DFLASH_BF16_CUTS
// and never reached by the wrappers: up to D = 64 the forward and dq at
// `keys` keys a tile and dk/dv, each with `cut` in kFull … kMmaOnly (dq
// also at D = 128); at D = 128 the forward of each `plan` (FwdDepth) and
// dk/dv of `ring` stages, with `cut` in kFull … kNoLoads. Returns
// cudaErrorInvalidValue for a case the source has no instance of.
int flash_fwd_bf16_cut_launch(const bf16* qs, const bf16* k, const bf16* v, float* o, float* lse, int bh, int s, int d,
                              int keys, int cut, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_CUT(DD, TT, CC) \
  if (d == DD && keys == TT && cut == CC) return launch_fwd<DD, TT, CC>(st, qs, k, v, o, lse, bh, s);
#define FWD_CUTS(DD, TT) FWD_CUT(DD, TT, kFull) FWD_CUT(DD, TT, kNoExp) FWD_CUT(DD, TT, kNoMma) FWD_CUT(DD, TT, kLoadsOnly) FWD_CUT(DD, TT, kMmaOnly)
  FWD_CUTS(16, 64) FWD_CUTS(16, 128) FWD_CUTS(32, 64) FWD_CUTS(32, 128) FWD_CUTS(64, 64) FWD_CUTS(64, 128)
  return (int)cudaErrorInvalidValue;
}

int flash_fwd_bf16_d128_cut_launch(const bf16* qs, const bf16* k, const bf16* v, float* o, float* lse, int bh, int s,
                                   int plan, int cut, void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD128_CUT(PP, CC) \
  if (plan == PP && cut == CC) return launch_fwd128<PP, CC>(st, qs, k, v, o, lse, bh, s);
#define FWD128_CUTS(PP) FWD128_CUT(PP, kFull) FWD128_CUT(PP, kNoExp) FWD128_CUT(PP, kNoMma) FWD128_CUT(PP, kLoadsOnly) FWD128_CUT(PP, kMmaOnly) FWD128_CUT(PP, kNoLoads)
  FWD128_CUTS(0) FWD128_CUTS(1) FWD128_CUTS(2)
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
  DKV_CUTS(16) DKV_CUTS(32) DKV_CUTS(64)
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dkv_bf16_d128_cut_launch(const bf16* qs, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
                                       const float* delta, bf16* dk, bf16* dv, int bh, int s, int ring, int cut,
                                       void* stream) {
  if (!shape_ok(bh, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV128_CUT(RR, CC) \
  if (ring == RR && cut == CC) return launch_dkv128<RR, CC>(st, qs, k, v, dout, lse, delta, dk, dv, bh, s);
#define DKV128_CUTS(RR) DKV128_CUT(RR, kFull) DKV128_CUT(RR, kNoExp) DKV128_CUT(RR, kNoMma) DKV128_CUT(RR, kLoadsOnly) DKV128_CUT(RR, kMmaOnly) DKV128_CUT(RR, kNoLoads)
  DKV128_CUTS(4) DKV128_CUTS(3)
  return (int)cudaErrorInvalidValue;
}
#endif

}  // extern "C"
