// bf16 tensor-core helpers for Hopper (sm_90a), for the kernels that take
// bf16 operands on the tensor cores with f32 accumulators (flash_bf16.cu,
// grouped_gemm_bf16.cu).
//
// Operands live in shared memory as the TMA wrote them (or as cp.async
// copies placed them in the same pattern), with the swizzle of their row
// width (`desc_sw`, read K-major or MN-major), or in
// registers as the A fragment of the `wgmma_rs_bf16_*` forms. An f32
// accumulator's fragment is the A fragment of the next product as it
// stands (`pack_a`): no permutation of the contraction axis, unlike TF32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16_wgmma {

// two f32 as one register of two bf16, each rounded to nearest even; `lo`
// in the low half (the lower contraction position)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment of contraction positions 16·kk … 16·kk + 15 from an f32
// accumulator fragment x (columns 8j + 2t + e of rows g and g + 8 at
// x[4j + e], x[4j + 2 + e]), rounded to bf16
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N], int kk, uint32_t (&a)[4]) {
  a[0] = pack2(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack2(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack2(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack2(x[8 * kk + 6], x[8 * kk + 7]);
}

// D[64 x 64] (+)= A·Bᵀ, A and B bf16 in shared memory (K-major, descriptors)
__device__ __forceinline__ void wgmma_ss_bf16_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 32] (+)= A·Bᵀ, A and B bf16 in shared memory (K-major, descriptors)
__device__ __forceinline__ void wgmma_ss_bf16_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A·Bᵀ, A and B bf16 in shared memory (K-major, descriptors)
__device__ __forceinline__ void wgmma_ss_bf16_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A·B, A and B bf16 in shared memory, each read K-major
// (Trans = 0) or MN-major (Trans = 1: A with M contiguous, B with N
// contiguous), descriptors `desc_sw`
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_ss_bf16_n64_t(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TransA), "n"(TransB));
}

template <int N>
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 32) {
    wgmma_ss_bf16_n32(d, a, b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_ss_bf16_n64(d, a, b, accumulate);
  } else {
    static_assert(N == 128, "no wgmma_ss_bf16 instance of this width");
    wgmma_ss_bf16_n128(d, a, b, accumulate);
  }
}

// D[64 x N] (+)= A·B, A bf16 in registers (a0..a3: the A fragment of one
// k16 step), B bf16 in shared memory: K-major (B given as Bᵀ, TransB = 0)
// or MN-major (TransB = 1), descriptor `desc_sw`. One form a width N.
template <int TransB>
__device__ __forceinline__ void wgmma_rs_bf16_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs_bf16_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TransB));
}

template <int TransB>
__device__ __forceinline__ void wgmma_rs_bf16_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TransB));
}

template <int N, int TransB = 0>
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  if constexpr (N == 16) {
    wgmma_rs_bf16_n16<TransB>(d, a, b, accumulate);
  } else if constexpr (N == 32) {
    wgmma_rs_bf16_n32<TransB>(d, a, b, accumulate);
  } else {
    static_assert(N == 64, "no wgmma_rs_bf16 instance of this width");
    wgmma_rs_bf16_n64<TransB>(d, a, b, accumulate);
  }
}

// wgmma shared-memory descriptor of a [rows, D] tile as the TMA wrote it
// with the swizzle of its row width W = 2·D bytes (32, 64 or 128:
// CU_TENSOR_MAP_SWIZZLE_<W>B), rows back to back, the tile 1024-byte
// aligned; `addr` is the step's shared address. Read K-major (the rows are
// the product's M or N, the contraction runs along the row: a k16 step
// starts 32·step bytes in) or MN-major (TransB = 1: the rows are the
// contraction, a k16 step starts 16·W·step bytes in). Either way the 8-row
// groups lie 8·W bytes apart (stride byte offset); the leading byte offset
// is unused, since the product's extent along the row fits one swizzle atom.
template <int D>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr) {
  constexpr uint64_t kMode = D == 64 ? 1 : D == 32 ? 2 : 3;  // 128-, 64-, 32-byte swizzle
  static_assert(D == 16 || D == 32 || D == 64, "rows of 32, 64 or 128 bytes");
  return (kMode << 62) | ((uint64_t)(8 * 2 * D >> 4) << 32) | (1ull << 16) | ((addr >> 4) & 0x3FFFu);
}

// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

}  // namespace bf16_wgmma
