// Hopper (sm_90a) building blocks of the kernels that feed the tensor cores
// through the Tensor Memory Accelerator (flash_bf16.cu, grouped_gemm_bf16.cu,
// the head-dim-128 forward and dk/dv of flash_attention.cu):
// mbarriers, TMA loads, bulk copies, setmaxnreg, named barriers, and on the host
// the tensor maps (cuTensorMapEncodeTiled, reached through the runtime, so a
// library links no libcuda), a launch with its dynamic shared memory, and
// the persistent grid.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper_tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// returns once the phase of `bar` with this parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the producer's arrival on a stage's `full` barrier, which then also waits for `bytes` to land
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// TMA from a 2-D map: the box at column `col`, row `row` into dst; lands on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap& map, int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// TMA from a 3-D map: the box at (x, y, z), x the contiguous axis, into
// dst; lands on `bar`. Elements past the map's extents land as zeros.
__device__ __forceinline__ void tma_box3(void* dst, const CUtensorMap& map, int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// a hint to bring the box at column `col`, row `row` of a 2-D map into L2 (no barrier, no shared memory)
__device__ __forceinline__ void tma_prefetch(const CUtensorMap& map, int col, int row) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(reinterpret_cast<uint64_t>(&map)),
               "r"(col), "r"(row)
               : "memory");
}

// bulk copy of `bytes` (a multiple of 16) of device memory into dst; lands on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barrier `id` (1 … 15) over `threads` threads, whole warps
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at named barrier `id` without waiting (the other `threads` − these sync on it)
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The block's shared storage S from the dynamic shared memory, 1024-byte
// aligned for the TMA's swizzle (the launch asks for 1 KB more)
template <typename S>
__device__ __forceinline__ S& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<S*>(raw + (1024 - smem_u32(raw) % 1024) % 1024);
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, reached through the runtime (the library links no libcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// `map`: a 3-D bf16 tensor at `base`, extents dims[0] (contiguous) x dims[1]
// x dims[2] elements, rows of dims[0] `ld` elements apart and planes `plane`
// elements apart, in boxes of box[0] x box[1] x 1 with the 128-byte swizzle
// (box[0] = 64: one 128-byte line a row, as `desc_sw<64>` reads it).
// Returns 0, or a cudaError_t where the driver refuses the map (strides not
// multiples of 16 bytes, an address not 16-byte aligned).
inline int tensor_map_bf16_3d(CUtensorMap* map, const void* base, const long long (&dims)[3], long long ld,
                              long long plane, const int (&box)[2]) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t extents[3] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1], (cuuint64_t)dims[2]};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)plane * 2};
  const cuuint32_t boxes[3] = {(cuuint32_t)box[0], (cuuint32_t)box[1], 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), extents, strides, boxes,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// `map`: a row-major f32 matrix of `rows` rows of `cols` elements at `base`,
// in boxes of box_cols x box_rows with the 128-byte swizzle (box_cols = 32:
// one 128-byte line a row, as `tf32_wgmma::desc_sw128` reads it). Returns
// 0, or a cudaError_t where the driver refuses the map.
inline int tensor_map_f32_2d(CUtensorMap* map, const void* base, long long rows, long long cols, int box_cols,
                             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t extents[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t boxes[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), extents, strides, boxes,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, dim3 grid, int threads, cudaStream_t st, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// the persistent grid: a CTA an SM, or one a block if there are fewer
inline int persistent_grid(int blocks, int* grid) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *grid = blocks < sms ? blocks : sms;
  return (int)e;
}

}  // namespace hopper_tma
