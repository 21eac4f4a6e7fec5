// Split-TF32 tensor-core helpers for Hopper (sm_90a), shared by the
// kernels that take f32 products on the tensor cores in three TF32 passes
// (flash_attention.cu, grouped_gemm.cu).
//
// Operands live in shared memory in wgmma's K-major layout without swizzle
// (`cidx`, `desc`), or in registers as the A fragment of the `wgmma_rs_*`
// forms; x = hi + lo with hi = tf32(x) rounded to nearest and lo = x − hi,
// of which the tensor cores read the TF32 part (`split`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32_wgmma {

// Float index of element (r, c) of an operand with R rows whose contraction
// axis is c, in wgmma's K-major layout without swizzle: core matrices of 8
// rows by 4 floats (16 bytes, 128 bytes in all), 8-row groups 128 bytes
// apart, 4-column groups R/8 core matrices apart.
template <int R>
__device__ __forceinline__ unsigned cidx(unsigned r, unsigned c) {
  return (((c >> 2) * (R >> 3) + (r >> 3)) << 5) + ((r & 7) << 2) + (c & 3);
}

// wgmma shared-memory descriptor of an R-row operand whose k8 step starts
// `off` bytes past shared address 16·base16: no swizzle, leading byte
// offset = the stride between the step's two 4-column core matrices, stride
// byte offset = the stride between 8-row groups. Shared memory lies below
// 256 KB, so base16 + off/16 fills the 14-bit address field without a
// carry; with `off` known at compile time the descriptor costs one add.
template <int R>
__device__ __forceinline__ uint64_t desc(uint32_t base16, uint32_t off) {
  constexpr uint32_t kLbo = (R / 8) * 128, kSbo = 128;
  return ((uint64_t)(kSbo >> 4) << 32) | (base16 + (off >> 4) + ((kLbo >> 4) << 16));
}

// wgmma shared-memory descriptor of a K-major operand whose rows are 32
// floats (128 bytes), as the TMA writes them with the 128-byte swizzle: rows
// back to back, 8-row groups 1 KB apart (stride byte offset), the slab 1 KB
// aligned; `addr` is the k8 step's shared address, 32 bytes a step along the
// row (the leading byte offset is unused: a step lies within one swizzle
// atom). The bits are those of a bf16 operand with 128-byte rows. The
// address field is the low 14 bits: an offset of a multiple of 16 bytes
// within shared memory adds to the descriptor as off / 16.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (1ull << 62) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 16) | ((addr >> 4) & 0x3FFFu);
}

// round to TF32, to nearest with ties away, as cvt.rna.tf32.f32 does for
// finite x: half of the 13 dropped bits' unit added to the magnitude, then
// the low 13 bits cleared (two integer operations)
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }


// x = hi + lo with hi = tf32(x) and lo = x − hi (exact in f32); the tensor
// cores read lo's TF32 part (they truncate), so the pair holds x to 2^-21 |x|
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float(tf32(x));
  lo = x - hi;
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
// cp.async of 16 (4) bytes that lands as zeros where `valid` is false: the
// source is then not read (src-size 0), so `src` need only be a mapped address
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy stores to shared memory made visible to wgmma (the async proxy)
__device__ __forceinline__ void proxy_fence() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Orders the compiler's uses of wgmma registers after the wait (the asm
// statements above write them synchronously as far as the compiler knows).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 64] (+)= A·Bᵀ, A and B tf32 in shared memory (K-major, descriptors)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 24] (+)= A·Bᵀ, A tf32 in registers (a0..a3), B tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n24(float (&d)[12], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 40] (+)= A·Bᵀ, A tf32 in registers (a0..a3), B tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 72] (+)= A·Bᵀ, A tf32 in registers (a0..a3), B tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}


// D[64 x 32] (+)= A·Bᵀ, A and B tf32 in shared memory (K-major, descriptors)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 16] (+)= A·Bᵀ, A tf32 in registers (a0..a3), B tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 32] (+)= A·Bᵀ, A tf32 in registers (a0..a3), B tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A·Bᵀ, A tf32 in registers (a0..a3), B tf32 in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 16] (+)= A·Bᵀ, A and B tf32 in shared memory (K-major, descriptors)
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The columns [c0, c0 + W) of an accumulator fragment as an array of their
// own: an N-column fragment holds columns 8j … 8j + 7 at [4j, 4j + 4), so a
// product of W columns from column c0 writes these registers as they stand.
template <int W, int N>
__device__ __forceinline__ auto cols(float (&d)[N], int c0) -> float (&)[W / 2] {
  return *reinterpret_cast<float(*)[W / 2]>(&d[c0 / 2]);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 16) {
    wgmma_ss_n16(d, a, b, accumulate);
  } else if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, accumulate);
  } else {
    static_assert(N == 64, "no wgmma_ss instance of this width");
    wgmma_ss_n64(d, a, b, accumulate);
  }
}

// N = 128 is two m64n64 products, on B's rows 0 … 63 and 64 … 127: B is then
// a 128-row operand (`desc<128>`), whose row 64 lies 1 KB (64 descriptor
// units) past its row 0.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, b, accumulate);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b, accumulate);
  } else {
    static_assert(N == 128, "no wgmma_rs instance of this width");
    wgmma_rs_n64(cols<64>(d, 0), a, b, accumulate);
    wgmma_rs_n64(cols<64>(d, 64), a, b + 64, accumulate);
  }
}


__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

}  // namespace tf32_wgmma
