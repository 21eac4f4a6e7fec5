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
// into f32 accumulators, 16 positions a product, in contraction order; the
// output is rounded to bf16 (to nearest even) once, after the last term.
// With a split contraction the chunks' f32 partials are added in split
// order by a second launch, then rounded. Every sum has a fixed order and
// there are no atomics: two launches give equal bits, whatever the grid.
//
// Bound on an H100 SXM at the switch-MoE ViT's fc1 forward (G = 24,
// M = 20,480, K = 64, N = 256): it moves ~315 MB (A 63 MB, B 0.8 MB, C 252
// MB), 0.094 ms at 3.35 TB/s; its 16.1 GFLOP take 0.016 ms at 989 TFLOP/s.
// The bytes bound it, as at every MoE ViT shape; at fc1's forward and fc2's
// input gradient the output is 80% of them.
//
// Design. The kernel of one block per output tile (ported first) ran each
// block's life in series at K = 64: one stage loaded, four products, the
// tile through shared memory in f32, then 16 KB of stores, with two blocks
// an SM to hide one another (0.51 of the bound). This one overlaps them:
//   * Persistent: min(SMs x kCtasPerSm, tiles) CTAs, a tile being one
//     output tile (BM x BN) of one group and one contraction chunk, in the
//     order (split, group, N tile, M tile), M fastest. CTA c takes tiles
//     c, c + G', c + 2G', …: the tiles in flight lie side by side, so the
//     card writes (and reads) one window of memory that moves along, as a
//     plain grid's blocks do. A CTA that walked a contiguous run of tiles
//     of its own instead, keeping B[g] resident through a group, measured
//     slower at every forward and input gradient while this design was
//     tuned: 132 streams far apart in memory.
//   * A producer warpgroup (one thread issues every TMA copy) keeps a ring
//     of stages of 64 contraction positions full on `full`/`empty`
//     mbarriers, running ahead across items; setmaxnreg moves its registers
//     to the two consumer warpgroups. A stage holds A's BM rows and B's BN
//     columns of its 64 positions (B from L2: 0.8 MB on the path), each
//     landed through a 3-D tensor map over [G, rows, cols] in 64 x 64 boxes
//     with the 128-byte swizzle `desc_sw` reads, K-major or MN-major as it
//     lies; the TMA's zero fill past the extents masks the M, N and K tails.
//   * Consumers: two warpgroups of BM / 2 output rows each (BM >= 128), or
//     of BN / 2 columns each (BM = 64); a warpgroup owns up to 64 x 256
//     outputs (128 f32 accumulators), issued as m64n64k16 products a
//     64-column slab (MN-major operands span one 128-byte swizzle atom a
//     slab). One wgmma group stays in flight: a stage is freed once the
//     products that read it have retired (wait_group 1).
//   * Epilogue: the accumulators are rounded to bf16 in registers, and each
//     warp writes its 16 rows into its part of the warpgroup's swizzled
//     output buffer and reads them back as 16-byte chunks, whole 128-byte
//     lines of C a warp instruction, stored with st.global.cs (streaming:
//     the output is read by the next kernel, not by this one). No warpgroup barrier,
//     and the buffer is free again once the warp has read it (a TMA store
//     epilogue from two buffers a warpgroup measured as fast or slower).
//     f32 partials, and bf16 rows not 16 bytes apart, are stored from
//     registers with masks.
//   * Ragged operands: rows not 16 bytes aligned (N = 9 bf16 is 18 bytes)
//     can have no tensor map; the producer warpgroup then loads that
//     operand element by element into the same swizzled slabs, zeros past
//     the extents, in the same launch and the same ring.
//   * The weight gradient's split (ops/grouped_gemm.py `split_k`): chunks
//     of a multiple of 64 positions, as many as the output tiles take the
//     card's 132 SMs in one round (5 chunks of 4,096 at the path's 20,480
//     slots, against 20 before: a quarter of the f32 partials).
//   * Tile plans (`Plan`, 224 KB of ring and output buffers each): (64, 256)
//     where N > 64 and (256, 64) where N <= 64 (`tiles`), and (128, 256),
//     (128, 64) for the sweep, which times all four.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"
#include "hopper_tma.cuh"
#include "tf32_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf16_wgmma::desc_sw;
using bf16_wgmma::pack2;
using bf16_wgmma::wg_wait_group;
using bf16_wgmma::wgmma_ss_bf16_n64_t;
using hopper_tma::bar_arrive;
using hopper_tma::bar_expect;
using hopper_tma::bar_init;
using hopper_tma::bar_wait;
using hopper_tma::launch;
using hopper_tma::named_sync;
using hopper_tma::persistent_grid;
using hopper_tma::regs_dec;
using hopper_tma::regs_inc;
using hopper_tma::smem_u32;
using hopper_tma::tensor_map_bf16_3d;
using hopper_tma::tma_box3;
using tf32_wgmma::cols;
using tf32_wgmma::pin;
using tf32_wgmma::proxy_fence;
using tf32_wgmma::wg_commit;
using tf32_wgmma::wg_fence;

constexpr int kThreads = 384;      // two consumer warpgroups, then the producer warpgroup
constexpr int kConsumerWarps = 8;  // each frees a stage with one arrival
constexpr int kCtasPerSm = 1;      // the shipped plans' CTAs an SM (2: a sweep's (128, 64) variant)
// setmaxnreg, by CTAs an SM. The consumers' increase draws on what the
// producer's decrease frees of the CTA's own registers, launched at 168 a
// thread (65,536 / 384; 80 at two CTAs): 128·(168 − 56) = 256·(224 − 168);
// 128·(80 − 24) >= 256·(104 − 80)
template <int Ctas>
constexpr int kProducerRegs = Ctas == 1 ? 56 : 24;
template <int Ctas>
constexpr int kConsumerRegs = Ctas == 1 ? 224 : 104;
static_assert(128 * (168 - kProducerRegs<1>) >= 256 * (kConsumerRegs<1> - 168) &&
                  128 * (80 - kProducerRegs<2>) >= 256 * (kConsumerRegs<2> - 80),
              "setmaxnreg would wait for registers the CTA does not hold");
constexpr int kBK = 64;               // contraction positions a stage: one 128-byte line
constexpr int kSlabBytes = 64 * 128;  // a 64 x 64 bf16 slab (8 KB, a multiple of the swizzle's 1 KB)
constexpr int kMaxRing = 8;           // stages of the ring at most
constexpr int kSmemLimit = 232448;    // an H100 block's shared memory
constexpr int kSmemSm = 233472;       // an H100 SM's, of which each block's reserve takes 1 KB

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The shared-memory plan of an output tile BM x BN at Ctas CTAs an SM:
// kData bytes, the ring from the front and, where C is staged, one output
// buffer a consumer warpgroup from the back, then the mbarriers.
template <int BM, int BN, int Ctas = kCtasPerSm>
struct Plan {
  // a consumer warpgroup's outputs: kWM rows (kRB blocks of 64) by kWN columns
  static constexpr int kWM = BM == 64 ? 64 : BM / 2;
  static constexpr int kRB = kWM / 64;
  static constexpr int kWN = BM == 64 ? BN / 2 : BN;
  static constexpr int kOut = kWM * kWN * 2;  // a warpgroup's output buffer: bf16
  static constexpr int kData = Ctas == 2 ? 106496 : 229376;
  static constexpr int kStage = (BM + BN) * kBK * 2;  // A's BM rows and B's BN columns
  // the ring beside the output buffers; without them (f32 partials, ragged C)
  static constexpr int kRing = cmin(kMaxRing, (kData - 2 * kOut) / kStage);
  static constexpr int kRingUnstaged = cmin(kMaxRing, kData / kStage);
  static constexpr int kBytes = kData + 2 * kMaxRing * 8;
};
static_assert(Plan<128, 256>::kBytes + 1024 <= kSmemLimit && 2 * (Plan<128, 64, 2>::kBytes + 2048) <= kSmemSm,
              "over the shared memory of an SM");
static_assert(Plan<128, 256>::kRing == 3 && Plan<128, 64>::kRing == 8 && Plan<64, 256>::kRing == 4 &&
                  Plan<256, 64>::kRing == 4 && Plan<128, 64, 2>::kRing == 3 && Plan<64, 256>::kRingUnstaged == 5 &&
                  Plan<256, 64>::kRingUnstaged == 5,
              "the rings moved");

struct Args {
  const bf16* a;  // element (m, k) of group g at a[g·a_g + m·lda + k], or a[g·a_g + k·lda + m] (A MN-major)
  const bf16* b;  // element (k, n) at b[g·b_g + k·ldb + n], or b[g·b_g + n·ldb + k] (B K-major)
  void* c;        // C [G, M, N] bf16, or partials [splits, G, M, N] f32
  long long a_g, b_g;
  int lda, ldb;
  int G, M, N, K, k_chunk;
  int m_tiles, n_tiles, tiles;  // tiles = splits · G · n_tiles · m_tiles
  int m_units;                  // 64-row units of M
  int tma_a, tma_b;             // operands through their tensor maps, else element by element
  int stage_c;                  // bf16 C with rows 16 bytes apart: staged, 16-byte stores; else from registers
  int f32_out, pair_c;          // partials out; C's rows allow two-element stores from registers
  // the sweep's settings (chip_sweep.py grouped_bf16), 0 in the shipped launch
  int ring_cap;  // stages of the ring at most
  int cut;       // attribution cut (kNoStores …), read only with GROUPED_BF16_SWEEP
};

// attribution cuts of the sweep build: the kernel whole, without its
// stores, without its loads (stages land unread), without its products
constexpr int kFull = 0, kNoStores = 1, kNoLoads = 2, kNoProducts = 3;

// The item of tile `tile` (M tiles fastest, then N tiles, groups, splits):
// split s, group g, N tile nt, rows m0 … m0 + 64·units − 1 (BM / 64 units
// of 64 rows, fewer in the last M tile)
struct Item {
  int s, g, nt, m0, units;
};
template <int BM>
__device__ __forceinline__ Item item_at(const Args& p, int tile) {
  Item t;
  const int mt = tile % p.m_tiles;
  int w = tile / p.m_tiles;
  t.nt = w % p.n_tiles;
  w /= p.n_tiles;
  t.g = w % p.G;
  t.s = w / p.G;
  t.m0 = BM * mt;
  t.units = min(BM / 64, p.m_units - mt * (BM / 64));
  return t;
}

// Element offset of column c of line l in a slab: 16-byte chunk c / 8 of
// the line swizzled by the line's place in its 8-line (1 KB) group, as the
// TMA's 128-byte swizzle lands it.
__device__ __forceinline__ int swz(int l, int c) { return l * 64 + ((((c >> 3) ^ (l & 7)) << 3) | (c & 7)); }

// Positions [k0, k0 + kBK) of an R-row operand element by element into its
// R / 64 slabs at dst, by the producer warpgroup's 128 threads (pt its
// thread). KC: the contraction axis is contiguous (element (r, k) at
// src[r·ld + k]): a slab's line is a row, its columns the positions. Else
// (element (r, k) at src[k·ld + r]) a line is a position, its columns 64
// rows. Rows >= rows and positions >= kend land as 0. The launcher has
// checked that a group's offsets fit in 32 bits.
template <int R, bool KC>
__device__ __forceinline__ void load_elems(bf16* dst, const bf16* src, int ld, int r0, int rows, int k0, int kend,
                                           int pt) {
#pragma unroll 1
  for (int e = pt; e < R * kBK; e += 128) {
    const int c = e % 64, l = e / 64 % 64, s = e / 4096;
    const int gr = r0 + 64 * s + (KC ? l : c), gk = k0 + (KC ? c : l);
    const bool ok = gr < rows && gk < kend;
    dst[s * 4096 + swz(l, c)] = ok ? src[KC ? gr * ld + gk : gk * ld + gr] : __float2bfloat16_rn(0.f);
  }
}

// The TMA boxes of positions [k, k + kBK) of an R-row operand into its
// R / 64 slabs at dst, a box of 64 rows by 64 positions each: (k, row)
// where the contraction is contiguous (K-major), else (row, k) (MN-major)
template <int R, bool KC>
__device__ __forceinline__ void tma_stage(unsigned char* dst, const CUtensorMap& map, int r0, int k, int g,
                                          uint64_t* bar) {
#pragma unroll
  for (int h = 0; h < R / 64; ++h)
    tma_box3(dst + h * kSlabBytes, map, KC ? k : r0 + 64 * h, KC ? r0 + 64 * h : k, g, bar);
}

// out tile = A[g][:, chunk] · B[g][chunk, :] of every tile this CTA takes,
// as bf16 C or f32 partials of the tile's split. Persistent: grid
// min(SMs x Ctas, tiles), kThreads threads, Plan<BM, BN, Ctas>::kBytes +
// 1024 bytes of dynamic shared memory; CTA c takes tiles c, c + gridDim.x,
// …. AKC: A's contraction axis is contiguous (A row-major: read K-major);
// BKC: B's is (B a transposed view: read K-major; else MN-major).
template <int BM, int BN, bool AKC, bool BKC, int Ctas = kCtasPerSm>
__global__ void __launch_bounds__(kThreads, Ctas)
grouped_gemm_bf16_tc(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                     const Args p) {
  using P = Plan<BM, BN, Ctas>;
  constexpr int WN = P::kWN, RB = P::kRB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + P::kData);
  uint64_t* empty = full + kMaxRing;
#ifdef GROUPED_BF16_SWEEP
  const int cut = p.cut;
#else
  constexpr int cut = kFull;
#endif
  const bool loads = cut != kNoLoads;
  const bool staged = p.stage_c;  // C through the output buffers
  const int ring_n = min(staged ? P::kRing : P::kRingUnstaged, p.ring_cap > 0 ? p.ring_cap : kMaxRing);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxRing; ++i) {
      bar_init(&full[i], 1);  // the producer's bar_expect; then the bytes
      bar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;

  if (wg == 2) {  // the producer, running ahead across tiles
    regs_dec<kProducerRegs<Ctas>>();
    const int pt = threadIdx.x - 256;
    const bool elems = !p.tma_a || !p.tma_b;  // then all 128 threads load, else thread 0 alone
    if (!elems && pt != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const Item t = item_at<BM>(p, tile);
      const int m0 = t.m0, n0 = t.nt * BN, k0 = t.s * p.k_chunk, kend = min(p.K, k0 + p.k_chunk);
      const int n_k = (kend - k0 + kBK - 1) / kBK;
      const bf16* a = p.a + t.g * p.a_g;
      const bf16* b = p.b + t.g * p.b_g;
      for (int kk = 0; kk < n_k; ++kk, ++it) {
        const int slot = it % ring_n;
        if (it >= ring_n) bar_wait(&empty[slot], (it / ring_n - 1) & 1);
        unsigned char* st = sm + slot * P::kStage;
        const int k = k0 + kk * kBK;
        // element loads first (every producer thread), made visible to the
        // tensor cores; then thread 0 arrives, expecting the TMA's bytes,
        // and issues the TMA copies
        if (elems) {
          if (!p.tma_a && loads) load_elems<BM, AKC>(reinterpret_cast<bf16*>(st), a, p.lda, m0, p.M, k, kend, pt);
          if (!p.tma_b && loads)
            load_elems<BN, BKC>(reinterpret_cast<bf16*>(st + BM * kBK * 2), b, p.ldb, n0, p.N, k, kend, pt);
          proxy_fence();
          named_sync(3, 128);
        }
        if (pt == 0) {
          const uint32_t tx = loads ? (p.tma_a ? BM * kBK * 2 : 0) + (p.tma_b ? BN * kBK * 2 : 0) : 0;
          if (tx > 0)
            bar_expect(&full[slot], tx);
          else
            bar_arrive(&full[slot]);
          if (p.tma_a && loads) tma_stage<BM, AKC>(st, map_a, m0, k, t.g, &full[slot]);
          if (p.tma_b && loads) tma_stage<BN, BKC>(st + BM * kBK * 2, map_b, n0, k, t.g, &full[slot]);
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs<Ctas>>();
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  // this warpgroup's outputs: rows wm … wm + 64·RB − 1, columns wn … wn + WN − 1 of the tile
  const int wm = BM == 64 ? 0 : P::kWM * wg, wn = BM == 64 ? WN * wg : 0;
  const uint32_t ring_u32 = smem_u32(sm);
  unsigned char* ob = sm + P::kData - (wg + 1) * P::kOut;  // this warpgroup's output buffer
  // a k16 step moves 32 bytes along a K-major line, 16 lines (2 KB) down an MN-major slab
  constexpr uint32_t kStepA = AKC ? 32 : 2048, kStepB = BKC ? 32 : 2048;

  float acc[RB * WN / 2];  // row block rb's 64 x WN at acc[rb·WN/2 …]
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Item t = item_at<BM>(p, tile);
    const int m0 = t.m0, n0 = t.nt * BN, k0 = t.s * p.k_chunk, kend = min(p.K, k0 + p.k_chunk);
    const int n_k = (kend - k0 + kBK - 1) / kBK;
#pragma unroll
    for (int i = 0; i < RB * WN / 2; ++i) acc[i] = 0.f;
    for (int kk = 0; kk < n_k; ++kk) {
      const int slot = (it + kk) % ring_n;
      bar_wait(&full[slot], ((it + kk) / ring_n) & 1);
      const uint32_t stage = ring_u32 + slot * P::kStage;
      const uint32_t sa = stage + (wm / 64) * kSlabBytes, sb = stage + BM * kBK * 2 + (wn / 64) * kSlabBytes;
      wg_fence();
      if (cut != kNoProducts) {
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
          for (int rb = 0; rb < RB; ++rb)
#pragma unroll
            for (int h = 0; h < WN / 64; ++h)
              wgmma_ss_bf16_n64_t<AKC ? 0 : 1, BKC ? 0 : 1>(
                  cols<64>(acc, 64 * (rb * (WN / 64) + h)), desc_sw<64>(sa + rb * kSlabBytes + kStepA * ks),
                  desc_sw<64>(sb + h * kSlabBytes + kStepB * ks), kk > 0 || ks > 0);
      }
      wg_commit();
      wg_wait_group<1>();  // the previous stage's products have retired: free its stage
      if (kk > 0 && lane == 0) bar_arrive(&empty[(it + kk - 1) % ring_n]);
    }
    wg_wait_group<0>();
    pin(acc);
    if (lane == 0) bar_arrive(&empty[(it + n_k - 1) % ring_n]);
    it += n_k;

    if (cut == kNoStores) continue;
    // the fragment of row block rb: acc[rb·WN/2 + 4j + e] is (row 64rb + r,
    // column 8j + 2tq + e), acc[rb·WN/2 + 4j + 2 + e] row 64rb + r + 8
    const int r = 16 * warp + gq;
    const int m_lim = min(p.M, m0 + 64 * t.units);
    if (staged) {
      // the warp's rows 16·warp … + 15 of each row block into its part of
      // the buffer (slab (rb, h): rows 64rb …, columns 64h …, the 128-byte
      // swizzle), then out as 16-byte chunks, a row's chunks a warp instruction
      __syncwarp();  // the warp's reads of its previous tile are done
#pragma unroll
      for (int j = 0; j < RB * WN / 8; ++j) {
        const int off = (j / 8) * kSlabBytes + ((((j % 8) ^ (r & 7)) << 4) | (4 * tq));
        *reinterpret_cast<uint32_t*>(ob + off + r * 128) = pack2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(ob + off + (r + 8) * 128) = pack2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      __syncwarp();
      bf16* out = static_cast<bf16*>(p.c) + (long long)t.g * p.M * p.N;
      constexpr int kQ = WN / 8;  // chunks a row
#pragma unroll 4
      for (int i = lane; i < RB * 16 * kQ; i += 32) {
        const int row16 = i / kQ, q = i % kQ, rb = row16 / 16, rr = 16 * warp + row16 % 16;
        const uint4 v = *reinterpret_cast<const uint4*>(ob + (rb * (WN / 64) + q / 8) * kSlabBytes + rr * 128 +
                                                        (((q % 8) ^ (rr & 7)) << 4));
        const int gm = m0 + wm + 64 * rb + rr, gn = n0 + wn + 8 * q;
        if (gm < m_lim && gn < p.N)
          asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(out + (long long)gm * p.N + gn), "r"(v.x),
                       "r"(v.y), "r"(v.z), "r"(v.w)
                       : "memory");
      }
    } else {
      const long long plane = (long long)(t.s * p.G + t.g) * p.M;
#pragma unroll
      for (int j = 0; j < RB * WN / 8; ++j) {
        const int row_a = m0 + wm + 64 * (j / (WN / 8)) + r, row_b = row_a + 8;
        const int col = n0 + wn + 8 * (j % (WN / 8)) + 2 * tq;
        if (col >= p.N) continue;
        const bool two = col + 1 < p.N;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row_b : row_a;
          if (row >= m_lim) continue;
          const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          const long long at = (plane + row) * p.N + col;
          if (p.f32_out) {
            float* out = static_cast<float*>(p.c) + at;
            if (two && p.pair_c) {
              *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
            } else {
              out[0] = v0;
              if (two) out[1] = v1;
            }
          } else {
            bf16* out = static_cast<bf16*>(p.c) + at;
            if (two && p.pair_c) {
              *reinterpret_cast<uint32_t*>(out) = pack2(v0, v1);
            } else {
              out[0] = __float2bfloat16_rn(v0);
              if (two) out[1] = __float2bfloat16_rn(v1);
            }
          }
        }
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the largest offset of an operand's element within a group, rows x cols with
// leading stride ld (rows) and unit stride (cols), fits in 32 bits
bool span32(long long rows, long long cols, long long ld) {
  return ld >= 0 && ld < 0x7fffffffLL && (rows - 1) * ld + cols - 1 < 0x7fffffffLL;
}

// Whether an operand [G][rows][cols] (cols contiguous, rows ld apart,
// groups `plane` apart) can have a tensor map: its rows and groups lie 16
// bytes apart
bool mappable(const void* base, int G, long long rows, long long cols, long long ld, long long plane) {
  return aligned16(base) && ld % 8 == 0 && ld >= cols && (G == 1 || (plane % 8 == 0 && plane >= rows * ld));
}

// Its map in boxes of 64 columns by 64 rows; 0, or the driver's refusal
int operand_map(CUtensorMap* map, const void* base, int G, long long rows, long long cols, long long ld,
                long long plane) {
  const long long dims[3] = {cols, rows, G};
  const int box[2] = {64, 64};
  return tensor_map_bf16_3d(map, base, dims, ld, G > 1 ? plane : rows * ld, box);
}

template <int BM, int BN, bool AKC, bool BKC, int Ctas = kCtasPerSm>
int launch_tc(cudaStream_t st, const Args& args) {
  CUtensorMap maps[2] = {};  // A, B; left zero where an operand takes element loads
  Args p = args;
  const int G = p.G;
  const long long a_rows = AKC ? p.M : p.K, a_cols = AKC ? p.K : p.M;
  const long long b_rows = BKC ? p.N : p.K, b_cols = BKC ? p.K : p.N;
  p.tma_a = mappable(p.a, G, a_rows, a_cols, p.lda, p.a_g);
  p.tma_b = mappable(p.b, G, b_rows, b_cols, p.ldb, p.b_g);
  p.stage_c = !p.f32_out && mappable(p.c, G, p.M, p.N, p.N, (long long)p.M * p.N);
  int e = 0;
  if (p.tma_a) e = operand_map(&maps[0], p.a, G, a_rows, a_cols, p.lda, p.a_g);
  if (e == 0 && p.tma_b) e = operand_map(&maps[1], p.b, G, b_rows, b_cols, p.ldb, p.b_g);
  if (e != 0) return e;
  // chunk boundaries inside a stage: only element loads stop at them
  if (p.f32_out && p.k_chunk % kBK != 0) p.tma_a = p.tma_b = 0;
  p.m_tiles = (p.M + BM - 1) / BM;
  p.tiles = (p.K + p.k_chunk - 1) / p.k_chunk * G * p.n_tiles * p.m_tiles;
  int grid = 0;
  e = persistent_grid((p.tiles + Ctas - 1) / Ctas, &grid);  // min(SMs x Ctas, tiles)
  if (e != 0) return e;
  grid = grid * Ctas < p.tiles ? grid * Ctas : p.tiles;
  return launch(grouped_gemm_bf16_tc<BM, BN, AKC, BKC, Ctas>, Plan<BM, BN, Ctas>::kBytes + 1024, dim3(grid), kThreads,
                st, maps[0], maps[1], p);
}

template <int BM, int BN, int Ctas = kCtasPerSm>
int launch_tile(bool at, bool bt, cudaStream_t st, const Args& p) {
  if (!at && !bt) return launch_tc<BM, BN, true, false, Ctas>(st, p);
  if (!at && bt) return launch_tc<BM, BN, true, true, Ctas>(st, p);
  if (at && !bt) return launch_tc<BM, BN, false, false, Ctas>(st, p);
  return (int)cudaErrorInvalidValue;  // both transposed: the wrapper copies one operand
}

// Args of a launch of C [G, M, N] (or its split partials), checked; false
// where the shapes, the tile or the strides are out of the kernel's range
bool make_args(Args* p, const bf16* a, const bf16* b, void* out, int G, int M, int N, int K, int a_t, long long a_g,
               long long lda, int b_t, long long b_g, long long ldb, int bm, int bn, int k_chunk) {
  if (G < 1 || M < 1 || N < 1 || K < 1 || k_chunk < 1) return false;
  if (!((bm == 128 && (bn == 256 || bn == 64)) || (bm == 64 && bn == 256) || (bm == 256 && bn == 64))) return false;
  const long long splits = (K + (long long)k_chunk - 1) / k_chunk;
  const long long m_units = (M + 63) / 64, n_tiles = (N + bn - 1) / bn;
  if (splits > 65535 || splits * G * m_units * n_tiles > 0x7fffffffLL) return false;
  const bool at = a_t != 0, bt = b_t != 0;
  if (!span32(at ? K : M, at ? M : K, lda) || !span32(bt ? N : K, bt ? K : N, ldb)) return false;
  *p = Args{};
  p->a = a;
  p->b = b;
  p->c = out;
  p->a_g = a_g;
  p->b_g = b_g;
  p->lda = (int)lda;
  p->ldb = (int)ldb;
  p->G = G;
  p->M = M;
  p->N = N;
  p->K = K;
  p->k_chunk = k_chunk;
  p->n_tiles = (int)n_tiles;
  p->m_units = (int)m_units;
  p->f32_out = splits > 1;
  p->pair_c = N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (p->f32_out ? 8 : 4) == 0;
  return true;
}

int launch_plan(bool at, bool bt, cudaStream_t st, const Args& p, int bm, int bn) {
  if (bm == 128 && bn == 256) return launch_tile<128, 256>(at, bt, st, p);
  if (bm == 128) return launch_tile<128, 64>(at, bt, st, p);
  if (bm == 256) return launch_tile<256, 64>(at, bt, st, p);
  return launch_tile<64, 256>(at, bt, st, p);
}

}  // namespace

extern "C" {

// With one split (K <= k_chunk), out is C [G, M, N] bf16; else out is f32
// partials [splits, G, M, N] (splits = ceil(K / k_chunk)): out[s, g] =
// A[g][:, chunk s] · B[g][chunk s, :]. A element (m, k) is a[g·a_g + m·lda +
// k], or a[g·a_g + k·lda + m] when a_t; B element (k, n) is b[g·b_g + k·ldb +
// n], or b[g·b_g + n·ldb + k] when b_t. (bm, bn) is the output tile: 128 x
// 256, 128 x 64, 64 x 256 or 256 x 64. Returns the cudaError_t of the launch.
int grouped_gemm_bf16_launch(const bf16* a, const bf16* b, void* out, int G, int M, int N, int K, int a_t,
                             long long a_g, long long lda, int b_t, long long b_g, long long ldb, int bm, int bn,
                             int k_chunk, void* stream) {
  Args p;
  if (!make_args(&p, a, b, out, G, M, N, K, a_t, a_g, lda, b_t, b_g, ldb, bm, bn, k_chunk))
    return (int)cudaErrorInvalidValue;
  return launch_plan(a_t != 0, b_t != 0, static_cast<cudaStream_t>(stream), p, bm, bn);
}

#ifdef GROUPED_BF16_SWEEP
// The sweep's entry (chip_sweep.py grouped_bf16), built only with
// -DGROUPED_BF16_SWEEP and never reached by the wrapper: the launch above
// with the ring cut to `ring` stages (0: the plan's), at the (128, 64)
// tile `ctas` CTAs an SM (1 or 2; a plan of 106,624 bytes at 2), and the
// attribution cut `cut` (kFull … kNoProducts).
int grouped_gemm_bf16_sweep_launch(const bf16* a, const bf16* b, void* out, int G, int M, int N, int K, int a_t,
                                   long long a_g, long long lda, int b_t, long long b_g, long long ldb, int bm,
                                   int bn, int k_chunk, int ring, int ctas, int cut, void* stream) {
  Args p;
  if (!make_args(&p, a, b, out, G, M, N, K, a_t, a_g, lda, b_t, b_g, ldb, bm, bn, k_chunk) || ring < 0 ||
      cut < kFull || cut > kNoProducts || (ctas != 1 && !(ctas == 2 && bm == 128 && bn == 64)))
    return (int)cudaErrorInvalidValue;
  p.ring_cap = ring;
  p.cut = cut;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ctas == 2) return launch_tile<128, 64, 2>(a_t != 0, b_t != 0, st, p);
  return launch_plan(a_t != 0, b_t != 0, st, p, bm, bn);
}
#endif

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
