// Helpers of the any-width narrow-pool kernels (encoder_pool_gen.cu):
// operands packed once into the
// fragment order of mma.sync m16n8k16 bf16 (tensor_core.cuh gives the
// layouts), so that a warp loads each fragment it needs as one 8- or 16-byte
// read per lane from a buffer the L1 and L2 hold, and a fixed-order sum of
// per-unit partials. Every width is a runtime value: ragged sizes are zero-
// padded in the packed buffers, never in the caller.
//
// A packed B operand (a K x N matrix, k x n) is an array of 16 x 8 tiles,
// entry ((batch * KS + ks) * NT + nt) * 32 + lane = {b0, b1}; a packed A
// operand (M x K) an array of 16 x 16 tiles, entry ((batch * MT + mt) * KS +
// ks) * 32 + lane = {a0, a1, a2, a3}.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace ft {
namespace {  // each source that includes this keeps its own copies

// A matrix of f32 values read in place, as a packer sees it: batch = b * H +
// h; element (r, c) at p[b * sb + h * sh + r * ld + c], 0 at r >= rows or c
// >= cols. `trans` swaps the fragment's (row or k, column or n) into the
// matrix's (c, r). `pass` 0, 1 or 2 gives the hi, mid or lo bf16 part of the
// value (tc::split3_bf16), -1 the value.
struct Mat {
  const float* p;
  int H;
  long long sb, sh;
  int ld, rows, cols;
  int trans, pass;

  __device__ float operator()(int batch, int i, int j) const {
    const int r = trans ? j : i, c = trans ? i : j;
    const int b = batch / H, h = batch % H;
    if (r >= rows || c >= cols) return 0.f;
    const float x = p[b * sb + h * sh + (long long)r * ld + c];
    if (pass < 0) return x;
    const float hi = __bfloat162float(__float2bfloat16_rn(x));
    const float r0 = x - hi;
    const float mid = __bfloat162float(__float2bfloat16_rn(r0));
    return pass == 0 ? hi : pass == 1 ? mid : r0 - mid;
  }
};

__host__ __device__ inline Mat mat(const float* p, int H, long long sb, long long sh, int ld,
                                   int rows, int cols, bool trans = false, int pass = -1) {
  return Mat{p, H, sb, sh, ld, rows, cols, trans ? 1 : 0, pass};
}

// one thread an entry: nbatch x KS x NT tiles of B fragments
__global__ void __launch_bounds__(256) pack_b(uint2* __restrict__ dst, Mat m, int nbatch, int KS,
                                              int NT) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)nbatch * KS * NT * 32) return;
  const int lane = (int)(idx & 31);
  const long long t = idx >> 5;
  const int nt = (int)(t % NT), ks = (int)((t / NT) % KS), batch = (int)(t / ((long long)NT * KS));
  const int gq = lane >> 2, tq = lane & 3, k = 16 * ks + 2 * tq, n = 8 * nt + gq;
  dst[idx] = make_uint2(tc::pack_bf16(m(batch, k, n), m(batch, k + 1, n)),
                        tc::pack_bf16(m(batch, k + 8, n), m(batch, k + 9, n)));
}

// one thread an entry: nbatch x MT x KS tiles of A fragments
__global__ void __launch_bounds__(256) pack_a(uint4* __restrict__ dst, Mat m, int nbatch, int MT,
                                              int KS) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)nbatch * MT * KS * 32) return;
  const int lane = (int)(idx & 31);
  const long long t = idx >> 5;
  const int ks = (int)(t % KS), mt = (int)((t / KS) % MT), batch = (int)(t / ((long long)KS * MT));
  const int gq = lane >> 2, tq = lane & 3, r = 16 * mt + gq, k = 16 * ks + 2 * tq;
  dst[idx] = make_uint4(tc::pack_bf16(m(batch, r, k), m(batch, r, k + 1)),
                        tc::pack_bf16(m(batch, r + 8, k), m(batch, r + 8, k + 1)),
                        tc::pack_bf16(m(batch, r, k + 8), m(batch, r, k + 9)),
                        tc::pack_bf16(m(batch, r + 8, k + 8), m(batch, r + 8, k + 9)));
}

inline cudaError_t launch_pack_b(uint2* dst, Mat m, int nbatch, int KS, int NT, cudaStream_t s) {
  const long long n = (long long)nbatch * KS * NT * 32;
  if (n == 0) return cudaSuccess;
  pack_b<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(dst, m, nbatch, KS, NT);
  return cudaGetLastError();
}

inline cudaError_t launch_pack_a(uint4* dst, Mat m, int nbatch, int MT, int KS, cudaStream_t s) {
  const long long n = (long long)nbatch * MT * KS * 32;
  if (n == 0) return cudaSuccess;
  pack_a<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(dst, m, nbatch, MT, KS);
  return cudaGetLastError();
}

// fragment loads from a packed buffer
__device__ __forceinline__ uint2 ldb(const uint2* f, long long tile, int lane) {
  return __ldg(f + tile * 32 + lane);
}
__device__ __forceinline__ void lda(uint32_t (&a)[4], const uint4* f, long long tile, int lane) {
  const uint4 v = __ldg(f + tile * 32 + lane);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// c += a b for a B fragment
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  tc::mma_bf16(c, a, b.x, b.y);
}

// c += t entrywise: a product summed from zero on the tensor cores, added in
// f32 (an mma.sync chain accumulating many products in one register loses
// low bits at every mma)
__device__ __forceinline__ void add4(float (&c)[4], const float (&t)[4]) {
  c[0] += t[0];
  c[1] += t[1];
  c[2] += t[2];
  c[3] += t[3];
}

// the A fragment of one k16 step from the C tiles of its two 8-column halves
// (tensor_core.cuh), rounded to bf16
__device__ __forceinline__ void a_of_c(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = tc::pack_bf16(c0[0], c0[1]);
  a[1] = tc::pack_bf16(c0[2], c0[3]);
  a[2] = tc::pack_bf16(c1[0], c1[1]);
  a[3] = tc::pack_bf16(c1[2], c1[3]);
}

// the same in three bf16 passes (hi, mid, lo) of an f32 operand
__device__ __forceinline__ void a3_of_c(uint32_t (&a)[3][4], const float (&c0)[4],
                                        const float (&c1)[4]) {
  tc::split3_bf16(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  tc::split3_bf16(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  tc::split3_bf16(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  tc::split3_bf16(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

// c += a b over three passes of a, the smallest first
__device__ __forceinline__ void mma3a(float (&c)[4], const uint32_t (&a)[3][4], uint32_t b0,
                                      uint32_t b1) {
  tc::mma_bf16(c, a[2], b0, b1);
  tc::mma_bf16(c, a[1], b0, b1);
  tc::mma_bf16(c, a[0], b0, b1);
}

// The A fragment of the transposed product from C tiles: A's rows are the C
// tiles' columns (tile c0 rows 0-7 of A, c1 rows 8-15) and its k the C rows
// (16), each 8 x 8 block transposed across the warp.
__device__ __forceinline__ void at_of_c(uint32_t (&a)[4], uint32_t c0lo, uint32_t c0hi,
                                        uint32_t c1lo, uint32_t c1hi) {
  a[0] = tc::transpose8x8(c0lo);
  a[1] = tc::transpose8x8(c1lo);
  a[2] = tc::transpose8x8(c0hi);
  a[3] = tc::transpose8x8(c1hi);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
// over the 8 lanes of one tq (xor 4, 8, 16)
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// One reduction of partials, summed in index order: kind 0, out[i] = sum over
// p < P of part[p * pstride + i] for i < n, and with outer > 1 that for each
// o < outer from part + o * ostride into out + o * n; kind 1 (the decoder tail's
// dkfull), i over the compact (cell, row hm, d) head blocks, a = H*M, b = M,
// c = hd, d = E, written into the full (cell, hm, E) rows at head hm / M's
// columns; kind 2 (the pools' dqfull), i over the (Q*H, E) output, a = Q, b =
// hd, c = E, the partial read at (query, column), 0 off the head blocks.
struct Sum {
  const float* part;
  float* out;
  long long n, pstride;
  int P, kind, a, b, c, d;
  long long first;  // the job's first thread
  int outer;        // 0 or 1: one reduction
  long long ostride;
};
struct Sums {
  Sum job[6];
  int n;
};

__global__ void __launch_bounds__(256) sum_parts(const __grid_constant__ Sums s) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  int j = 0;
  while (j + 1 < s.n && idx >= s.job[j + 1].first) ++j;
  const Sum jb = s.job[j];
  long long i = idx - jb.first;
  if (i >= jb.n * (jb.outer > 1 ? jb.outer : 1)) return;
  const long long o = i / jb.n;
  i -= o * jb.n;
  const float* part = jb.part + o * jb.ostride;
  long long src = i, at = o * jb.n + i;
  if (jb.kind == 1) {
    const long long d = i % jb.c, hm = (i / jb.c) % jb.a, b = i / ((long long)jb.c * jb.a);
    at = (b * jb.a + hm) * jb.d + (hm / jb.b) * jb.c + d;
  } else if (jb.kind == 2) {
    const long long hq = i / jb.c, col = i % jb.c;
    if (col / jb.b != hq / jb.a) {
      jb.out[i] = 0.f;
      return;
    }
    src = (hq % jb.a) * jb.c + col;
  }
  float acc = 0.f;
  for (int p = 0; p < jb.P; ++p) acc += part[p * jb.pstride + src];
  jb.out[at] = acc;
}

inline cudaError_t launch_sums(Sums s, cudaStream_t stream) {
  long long total = 0;
  for (int j = 0; j < s.n; ++j) {
    s.job[j].first = total;
    total += s.job[j].n * (s.job[j].outer > 1 ? s.job[j].outer : 1);
  }
  if (total == 0) return cudaSuccess;
  sum_parts<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(s);
  return cudaGetLastError();
}

// A bump allocator over a workspace, 256-byte aligned pieces; with a null
// base it only counts.
struct Carve {
  char* base;
  long long used;
  template <class T>
  T* take(long long count) {
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += (count * (long long)sizeof(T) + 255) & ~255LL;
    return p;
  }
};

inline cudaError_t allow_smem(const void* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace
}  // namespace ft
