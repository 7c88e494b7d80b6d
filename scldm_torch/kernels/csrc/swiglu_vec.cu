// The SwiGLU up projection and gate, f32, forward and recompute backward, in
// two functions:
//
//   swiglu_vec:         s[r] = sum_j silu(x[r] . w1[:, j]) * (x[r] . w2[:, j]) * wv[j]
//   fused_swiglu_gate:  g[r, j] = silu(x[r] . w1[:, j]) * (x[r] . w2[:, j])
//
// with x (R, E), w12 = [w1 | w2] (E, 2Hd) and wv (Hd) row-major; s is (R), g
// (R, Hd). swiglu_vec is the decoder's algebraic tail (the gate contracted
// with the folded head vector); fused_swiglu_gate is the gate itself.
//
// Replaces the TPU kernels scldm_tpu/ops/fused_swiglu.py::swiglu_vec (Pallas
// body `_vec_fwd_kernel`) and `_vec_fused_bwd` (`_vec_bwd_kernel`), and
// fused_swiglu_gate (`_fwd_kernel`) and `_fused_bwd` (`_dx_kernel`,
// `_dw_kernel`). The math is `swiglu_vec_reference` and `swiglu_reference` in
// scldm_torch/ops/fused_swiglu.py. Each backward, given the gate's cotangent
// dg (swiglu_vec: dg[r, j] = ds[r] * wv[j]; the gate: the caller's (R, Hd)
// cotangent), recomputes u = x @ w12 and, with sg = sigmoid(u1),
//
//   du = [dg * u2 * sg * (1 + u1 * (1 - sg)) | dg * silu(u1)]   (R, 2Hd)
//   dx = du @ w12^T,  dw12 = x^T du,  and swiglu_vec's dwv = g^T ds.
//
// What bounds them on an H100: operations. At the census decoder (R = 16 x
// 36,601 = 585,616 rows, E = 512, Hd = 1,408) each forward is 1.69 TFLOP and
// each backward 5.07, against 1.2 GB of x read (and the gate's 3.3 GB of g
// written, or of dg read); f32 throughout, so the f32 FMA peak, not the
// tensor cores.
//
// What the design does about it. Every product is the register-tiled SGEMM
// main loop of sgemm_tile.cuh (a CTA of 256 threads per 128 x 128 output
// tile, 8 x 8 outputs a thread, double-buffered 16-deep slices).
// - swiglu_vec's forward: a CTA owns 128 rows and walks the hidden axis in
//   tiles of 64 columns; each tile's 128 columns are w1's and w2's columns
//   j0..j0+63, so a thread holds u1 and u2 of the same hidden column, and the
//   gate and the wv contraction are the epilogue. The per-row sum over hidden
//   tiles stays in registers, in order; at the end the 16 threads of a row
//   add their sums in a fixed butterfly. w12 (5.8 MB) does not fit on an SM
//   and is read from L2 by every CTA; nothing (R, Hd)-shaped reaches memory.
// - The gate's forward: a CTA per (128 rows, 64 hidden columns), the same
//   pairing of w1's and w2's columns; the epilogue writes the gated tile.
// - Both backwards, in chunks of kChunk rows: (1) the gate kernel, a CTA per
//   (128 rows, 64 hidden columns), recomputes u and writes du to a (kChunk,
//   2Hd) workspace (swiglu_vec: also the CTA's column sums of g * ds to a
//   partial of dwv); (2) dx of the chunk = du @ w12^T; (3) dw12's partial
//   sums x^T du over kSplit slices of the chunk's rows, each a CTA per 128 x
//   128 tile of dw12; (4) the partials are added to dw12 (and dwv) in a fixed
//   order, chunk after chunk. So no atomics: the sums do not depend on the
//   run, and the workspace is bounded by the chunk (369 MB at Hd = 1,408),
//   not by R.
// Ragged R, E and Hd are bounds-checked, nothing is padded; offsets into x,
// dx, g, dg and the workspace are 64-bit. Tensor cores and TMA are not used
// yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "sgemm_tile.cuh"

namespace {

// using-declarations, not `using namespace sgemm`: a using-directive would
// make nvcc's host stubs see two unnamed namespaces (this file's and
// sgemm's) and refuse the build
using sgemm::cdiv;
using sgemm::clamp4;
using sgemm::kBK;
using sgemm::kHalf;
using sgemm::kLd;
using sgemm::kRuns;
using sgemm::kThreads;
using sgemm::kTile;
using sgemm::load4;
using sgemm::mainloop;
using sgemm::Operand;
using sgemm::Smem;
using sgemm::sum_parts;
using sgemm::tile_row;
using sgemm::zero;

constexpr long long kChunk = 32768;  // backward: rows per workspace chunk
constexpr int kSplit = 8;            // backward: row slices of dw12's partial sums

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// The up projection's right operand for hidden columns j0..j0+63: tile column
// c < 64 is w1's column j0 + c, c >= 64 is w2's column j0 + c - 64.
struct UpWeights {
  const float* w12;
  int Hd;
  int j0;

  __device__ void load(float4 (&r)[kRuns], long long k0, int kn) const {
#pragma unroll
    for (int l = 0; l < kRuns; ++l) {
      const int q = threadIdx.x + l * kThreads;
      const int k = q >> 5, c = (q & 31) * 4;  // four columns inside one half
      const int j = j0 + (c & (kHalf - 1));
      r[l] = load4(w12 + (k0 + k) * 2LL * Hd + (c < kHalf ? j : Hd + j),
                   k < kn ? clamp4(Hd - j) : 0);
    }
  }

  __device__ void store(float (*s)[kLd], const float4 (&r)[kRuns]) const {
#pragma unroll
    for (int l = 0; l < kRuns; ++l) {
      const int q = threadIdx.x + l * kThreads;
      *reinterpret_cast<float4*>(&s[q >> 5][(q & 31) * 4]) = r[l];
    }
  }
};

// Forward: a CTA per 128 rows; out[r] = s[r].
__global__ void __launch_bounds__(kThreads, 2) swiglu_vec_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w12, const float* __restrict__ wv,
    float* __restrict__ out, long long R, int E, int Hd) {
  __shared__ __align__(16) Smem sm;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long r0 = (long long)blockIdx.x * kTile;
  const Operand<true> xa{x + r0 * E, E, R - r0};
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 0.0f;
  float acc[8][8];
  for (int j0 = 0; j0 < Hd; j0 += kHalf) {
    zero(acc);
    mainloop(xa, UpWeights{w12, Hd, j0}, 0, E, sm, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = j0 + tx * 4 + j;
        if (jj < Hd) {
          const float u1 = acc[i][j];
          part = fmaf(u1 * sigmoid(u1) * acc[i][j + 4], __ldg(wv + jj), part);
        }
      }
      s[i] += part;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = s[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const long long r = r0 + tile_row(ty, i);
    if (tx == 0 && r < R) out[r] = v;
  }
}

// fused_swiglu_gate's forward: a CTA per (128 rows, 64 hidden columns);
// out[r, j] = silu(u1[r, j]) * u2[r, j], written from the accumulators.
__global__ void __launch_bounds__(kThreads, 2) swiglu_gate_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ w12, float* __restrict__ out,
    long long R, int E, int Hd) {
  __shared__ __align__(16) Smem sm;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long r0 = (long long)blockIdx.x * kTile;
  const int j0 = blockIdx.y * kHalf;
  float acc[8][8];
  zero(acc);
  mainloop(Operand<true>{x + r0 * E, E, R - r0}, UpWeights{w12, Hd, j0}, 0, E, sm, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = r0 + tile_row(ty, i);
    if (r >= R) continue;
    float* orow = out + r * Hd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + tx * 4 + j;
      const float u1 = acc[i][j];
      if (jj < Hd) orow[jj] = u1 * sigmoid(u1) * acc[i][j + 4];
    }
  }
}

// Backward (1), over one chunk of `rows` rows: du (rows, 2Hd) for the gate's
// cotangent dg, which is ds[r] * wv[j] (kVec: swiglu_vec) or dgate[r, j]
// (fused_swiglu_gate); with kVec also, per CTA row tile t, part_v[t * Hd + j]
// = sum over its rows of g[r, j] * ds[r].
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) swiglu_vec_gate_kernel(
    const float* __restrict__ x, const float* __restrict__ w12, const float* __restrict__ wv,
    const float* __restrict__ ds, float* __restrict__ du, float* __restrict__ part_v,
    long long rows, int E, int Hd) {
  __shared__ __align__(16) Smem sm;
  __shared__ float red[16][kHalf];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long r0 = (long long)blockIdx.x * kTile;
  const int j0 = blockIdx.y * kHalf;
  float acc[8][8];
  zero(acc);
  mainloop(Operand<true>{x + r0 * E, E, rows - r0}, UpWeights{w12, Hd, j0}, 0, E, sm, acc);

  float colsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = r0 + tile_row(ty, i);
    if (r >= rows) continue;
    const float d = kVec ? __ldg(ds + r) : 0.0f;
    float* dur = du + r * 2LL * Hd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + tx * 4 + j;
      if (jj >= Hd) continue;
      const float u1 = acc[i][j], u2 = acc[i][j + 4];
      const float sg = sigmoid(u1);
      const float sl = u1 * sg;
      const float dg = kVec ? d * __ldg(wv + jj) : __ldg(ds + r * Hd + jj);
      dur[jj] = dg * u2 * (sg + sl * (1.0f - sg));
      dur[Hd + jj] = dg * sl;
      if (kVec) colsum[j] = fmaf(sl * u2, d, colsum[j]);
    }
  }
  if (!kVec) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx * 4 + j] = colsum[j];
  __syncthreads();
  if (threadIdx.x < kHalf && j0 + threadIdx.x < Hd) {
    float v = 0.0f;
    for (int t = 0; t < 16; ++t) v += red[t][threadIdx.x];
    part_v[(long long)blockIdx.x * Hd + j0 + threadIdx.x] = v;
  }
}

// The backward's workspace: du of one chunk, dw12's kSplit partials and (kVec)
// dwv's per-row-tile partials of one chunk.
long long workspace_floats(long long R, int E, int Hd, bool vec) {
  const long long rows = R < kChunk ? R : kChunk;
  return rows * 2LL * Hd + (long long)kSplit * E * 2LL * Hd + (vec ? cdiv(rows, kTile) * Hd : 0);
}

// Both backwards, chunk after chunk: (1) du, (2) dx = du @ w12^T, (3) dw12's
// partials x^T du, (4) their fixed-order sums (and, kVec, dwv's).
template <bool kVec>
int backward(const float* x, const float* w12, const float* wv, const float* ds, float* dx,
             float* dw12, float* dwv, float* workspace, long long R, int E, int Hd,
             cudaStream_t s) {
  if (R == 0) return (int)cudaErrorInvalidValue;
  const long long H2 = 2LL * Hd;
  float* du = workspace;
  float* part_w = du + (R < kChunk ? R : kChunk) * H2;
  float* part_v = part_w + (long long)kSplit * E * H2;
  cudaError_t err = cudaSuccess;
  for (long long c0 = 0; c0 < R && err == cudaSuccess; c0 += kChunk) {
    const long long rows = R - c0 < kChunk ? R - c0 : kChunk;
    const unsigned row_tiles = (unsigned)cdiv(rows, kTile);
    swiglu_vec_gate_kernel<kVec><<<dim3(row_tiles, (unsigned)cdiv(Hd, kHalf)), kThreads, 0, s>>>(
        x + c0 * E, w12, wv, ds + (kVec ? c0 : c0 * Hd), du, part_v, rows, E, Hd);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    // dx rows of the chunk: (rows, E) = du (rows, 2Hd) @ w12^T
    sgemm::gemm_kernel<false, true>
        <<<dim3((unsigned)cdiv(E, kTile), row_tiles, 1), kThreads, 0, s>>>(
            du, H2, w12, H2, dx + c0 * E, (int)rows, E, H2, H2);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    // dw12's partials: (E, 2Hd) = x^T (E, rows) @ du (rows, 2Hd), over kSplit row slices
    const long long k_per = cdiv(cdiv(rows, kSplit), kBK) * kBK;
    sgemm::gemm_kernel<true, false>
        <<<dim3((unsigned)cdiv(H2, kTile), (unsigned)cdiv(E, kTile), kSplit), kThreads, 0, s>>>(
            x + c0 * E, E, du, H2, part_w, E, (int)H2, rows, k_per);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    if ((err = sum_parts(part_w, kSplit, E * H2, dw12, c0 > 0, s)) != cudaSuccess) break;
    if (kVec) err = sum_parts(part_v, (int)row_tiles, Hd, dwv, c0 > 0, s);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Floats of swiglu_vec's backward workspace for R rows.
long long scldm_swiglu_vec_workspace_floats(long long R, int E, int Hd) {
  return workspace_floats(R, E, Hd, true);
}

// Forward: out (R) f32 from x (R, E), w12 (E, 2Hd), wv (Hd), contiguous f32.
// Launches on `stream`, on the current device; returns the CUDA error code of
// the launch (0 on success). Allocates nothing and does not synchronise.
int scldm_swiglu_vec_forward(const void* x, const void* w12, const void* wv, void* out,
                             long long R, int E, int Hd, void* stream) {
  if (R == 0) return 0;
  swiglu_vec_fwd_kernel<<<(unsigned)cdiv(R, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w12, (const float*)wv, (float*)out, R, E, Hd);
  return (int)cudaGetLastError();
}

// Backward: given ds (R), writes dx (R, E), dw12 (E, 2Hd) and dwv (Hd) whole,
// using `workspace` (scldm_swiglu_vec_workspace_floats floats). Same
// conventions as the forward; returns the first CUDA error code. R >= 1.
int scldm_swiglu_vec_backward(const void* x, const void* w12, const void* wv, const void* ds,
                              void* dx, void* dw12, void* dwv, void* workspace, long long R,
                              int E, int Hd, void* stream) {
  return backward<true>((const float*)x, (const float*)w12, (const float*)wv, (const float*)ds,
                        (float*)dx, (float*)dw12, (float*)dwv, (float*)workspace, R, E, Hd,
                        (cudaStream_t)stream);
}

// Floats of fused_swiglu_gate's backward workspace for R rows.
long long scldm_swiglu_gate_workspace_floats(long long R, int E, int Hd) {
  return workspace_floats(R, E, Hd, false);
}

// fused_swiglu_gate's forward: out (R, Hd) = silu(x @ w1) * (x @ w2) from x
// (R, E) and w12 = [w1 | w2] (E, 2Hd), contiguous f32. Same conventions as
// swiglu_vec's forward.
int scldm_swiglu_gate_forward(const void* x, const void* w12, void* out, long long R, int E,
                              int Hd, void* stream) {
  if (R == 0) return 0;
  swiglu_gate_fwd_kernel<<<dim3((unsigned)cdiv(R, kTile), (unsigned)cdiv(Hd, kHalf)), kThreads, 0,
                           (cudaStream_t)stream>>>((const float*)x, (const float*)w12, (float*)out,
                                                   R, E, Hd);
  return (int)cudaGetLastError();
}

// fused_swiglu_gate's backward: given the cotangent dg (R, Hd), writes dx (R,
// E) and dw12 = [dw1 | dw2] (E, 2Hd) whole, using `workspace`
// (scldm_swiglu_gate_workspace_floats floats). R >= 1.
int scldm_swiglu_gate_backward(const void* x, const void* w12, const void* dg, void* dx,
                               void* dw12, void* workspace, long long R, int E, int Hd,
                               void* stream) {
  return backward<false>((const float*)x, (const float*)w12, nullptr, (const float*)dg,
                         (float*)dx, (float*)dw12, nullptr, (float*)workspace, R, E, Hd,
                         (cudaStream_t)stream);
}

}  // extern "C"
