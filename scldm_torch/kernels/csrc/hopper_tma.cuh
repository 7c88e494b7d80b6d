// Hopper's tile machinery shared by the kernels that feed wgmma from
// TMA-written shared memory (decoder_tail_gen.cu, encoder_pool_gen.cu): the
// mbarrier-init fence and the 3-D TMA load beside hopper_wgmma.cuh's 2-D one,
// the 128-byte swizzle of a [64 rows][64 bf16] box and the descriptors of its
// k steps, wgmma m64n64 / m64n128 (A from shared memory or from registers)
// with their fences, the accumulator-to-A-fragment conversions, quad and
// column shuffles, and the tensor maps (cuTensorMapEncodeTiled through the
// CUDA runtime, no -lcuda).
//
// A source takes what it uses with using-declarations inside its own unnamed
// namespace, as for hopper_wgmma.cuh.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"
#include "tensor_core.cuh"

namespace hopper {

constexpr int kBox = 8192;  // one box: 64 rows of 64 bf16 in the 128-byte swizzle

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the box of a 3-D map at (c0, c1, c2) into shared `dst`, completing on `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// byte offset of bf16 element (row, col) of a [64 rows][64 cols] box in the
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r & 7)); col < 64 * boxes
__device__ __forceinline__ uint32_t sw(int row, int col) {
  const int box = col >> 6, c = col & 63;
  return box * kBox + row * 128 + ((((c >> 3) ^ (row & 7))) << 4) + ((c & 7) << 1);
}

// k step ks (16 deep) of a K-major operand whose k runs along its boxes
__device__ __forceinline__ uint64_t kd(uint32_t base, int ks) {
  return k_desc(base + (ks >> 2) * kBox + (ks & 3) * 32);
}
// k step kk (16 rows) of an MN-major operand: [k rows][64 mn] boxes kBox apart
__device__ __forceinline__ uint64_t md(uint32_t base, int kk) { return mn_desc(base + kk * 2048); }

// d (64 x 64, f32; scale_d 0: d = a b) += a (64 x 16) b (16 x 64), bf16, both
// from shared memory; kTA / kTB: the operand is MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wg_ss64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// the same with A (64 x 16) from registers in mma.sync's fragment order (warp
// w: rows 16 w..16 w + 15)
template <int kTB>
__device__ __forceinline__ void wg_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTB));
}

// 64 x 128
template <int kTA, int kTB>
__device__ __forceinline__ void wg_ss128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

template <int kTB>
__device__ __forceinline__ void wg_rs128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTB));
}

// N = EP (64 or 128) columns: the products whose columns are E
template <int EP, int kTA, int kTB>
__device__ __forceinline__ void wg_ss(float (&d)[EP / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (EP == 64) wg_ss64<kTA, kTB>(d, a, b, scale_d);
  else wg_ss128<kTA, kTB>(d, a, b, scale_d);
}
template <int EP, int kTB>
__device__ __forceinline__ void wg_rs(float (&d)[EP / 2], const uint32_t (&a)[4], uint64_t b,
                                      int scale_d) {
  if constexpr (EP == 64) wg_rs64<kTB>(d, a, b, scale_d);
  else wg_rs128<kTB>(d, a, b, scale_d);
}

// An m64nN accumulator: thread (warp w, gq, tq) of the warpgroup holds rows
// 16 w + gq (d[4 i], d[4 i + 1]) and 16 w + gq + 8 (d[4 i + 2], d[4 i + 3]) at
// columns 8 i + 2 tq, + 1. Tiles 2 kk and 2 kk + 1, rounded to bf16, are the A
// fragment of k step kk of a product that takes its columns as k.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = tc::pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = tc::pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = tc::pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = tc::pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}
// the same in three bf16 passes of an f32 operand
template <int N>
__device__ __forceinline__ void a_frag3(uint32_t (&a)[3][4], const float (&d)[N], int kk) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    tc::split3_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1], a[0][j], a[1][j], a[2][j]);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
// over the 8 lanes of one tq (the rows of a warp's tile)
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// A bf16 map of `rank` (2 or 3) dimensions, EP values a row: boxes of 64
// values by `box_rows` rows (by 1 in the third dimension), 128-byte swizzle;
// reads past an edge fill zeros
inline bool make_map(CUtensorMap* map, const void* base, int rank, long long EP, long long rows,
              long long depth, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr || rows < 1 || depth < 1) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)EP, (cuuint64_t)rows, (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)EP * 2, (cuuint64_t)(EP * 2 * rows)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
