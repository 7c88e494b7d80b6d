// Tensor-core and copy helpers shared by the kernels that run their products
// on mma.sync: the DiT block forward and backward (dit_tiled.cuh,
// dit_block.cu, dit_block_bwd.cu: TF32 with three passes a product), the
// decoder tail, forward and backward (decoder_tail.cu, bf16), and the narrow
// encoder pools, forward and backward (encoder_pool.cu, bf16).
//
// Fragment layouts (PTX ISA, mma.sync.m16n8k8 .tf32 and m16n8k16 .bf16), with
// lane = 4 gq + tq:
//   C/D (16 x 8, f32): c0, c1 at row gq, columns 2tq, 2tq + 1; c2, c3 at row
//     gq + 8, the same columns.
//   A tf32 (16 x 8): a0 (gq, tq), a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8,
//     tq + 4). B tf32 (8 x 8, k x n): b0 (tq, gq), b1 (tq + 4, gq).
//   A bf16 (16 x 16), two values a register, the lower k in the low half:
//     a0 (gq, 2tq..), a1 (gq + 8, 2tq..), a2 (gq, 2tq + 8..), a3 (gq + 8,
//     2tq + 8..). B bf16 (16 x 8): b0 (k 2tq.., n gq), b1 (k 2tq + 8.., n gq).
//   m16n8k8 bf16: A (16 x 8) a0 (gq, 2tq..), a1 (gq + 8, 2tq..); B (8 x 8)
//     b0 (k 2tq.., n gq).
//   ldmatrix .trans: lanes 8j..8j + 7 give the row addresses of 8 x 8 matrix
//     j (16 bytes each); lane 4 gq + tq receives its rows 2tq and 2tq + 1 at
//     column gq, so a matrix stored [k][n] (or [k][m]) loads as a B (or A)
//     fragment.
// So two C tiles side by side (columns 8j and 8j + 8) are, packed to bf16,
// the A fragment of one k16 step over those 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from `src` into shared `dst`, or 16 zero bytes where !in (src is
// then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes from `src` into shared `dst` (through the L1), or 4 zero bytes where
// !in (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo with hi = x rounded to TF32 and lo the f32 remainder, of which
// the tensor core reads the top 19 bits: three passes lo.hi + hi.lo + hi.hi
// keep f32 accuracy (a rounding of lo to TF32 here would cost an instruction
// a value and change the products by under 2^-21 of them)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16 x 8, row-major tf32) * b (8 x 8, column-major tf32), f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 16, row-major bf16) * b (16 x 8, column-major bf16), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row-major bf16) * b (8 x 8, column-major bf16), f32
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// four (or two: lanes 0-15 give the addresses) 8 x 8 b16 matrices from
// shared memory, transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(row)));
}

// two floats rounded to bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo to about 16 bits, both packed bf16 pairs: two bf16
// passes hi.b + lo.b of an f32 operand against a bf16 one
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// (x0, x1) = hi + mid + lo to about 24 bits, packed bf16 pairs: three bf16
// passes of an f32 operand whose products are rounded to bf16 next (one more
// pass keeps those roundings where f32 sums put them)
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(r0 - mf.x, r1 - mf.y);
}

// the 8 x 8 b16 matrix whose row gq, columns 2tq and 2tq + 1, lane 4 gq + tq
// holds, transposed across the warp
__device__ __forceinline__ uint32_t transpose8x8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t load_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace tc
