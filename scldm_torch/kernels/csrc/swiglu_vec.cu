// The SwiGLU up projection, gate and head-vector contraction of the decoder's
// algebraic tail, forward and recompute backward, f32:
//
//   s[r] = sum_j silu(x[r] . w1[:, j]) * (x[r] . w2[:, j]) * wv[j]
//
// with x (R, E), w12 = [w1 | w2] (E, 2Hd) and wv (Hd) row-major; s is (R).
//
// Replaces the TPU kernels scldm_tpu/ops/fused_swiglu.py::swiglu_vec (Pallas
// body `_vec_fwd_kernel`) and `_vec_fused_bwd` (`_vec_bwd_kernel`). The math
// is `swiglu_vec_reference` in scldm_torch/ops/fused_swiglu.py. The backward,
// given the cotangent ds (R), recomputes u = x @ w12 and, with sg = sigmoid(u1)
// and g = silu(u1) * u2,
//
//   du = [ds * wv * u2 * sg * (1 + u1 * (1 - sg)) | ds * wv * silu(u1)]   (R, 2Hd)
//   dx = du @ w12^T,  dw12 = x^T du,  dwv = g^T ds.
//
// What bounds it on an H100: operations. At the census decoder (R = 16 x
// 36,601 = 585,616 rows, E = 512, Hd = 1,408) the forward is 1.69 TFLOP and
// the backward 5.07, against 1.2 GB of x read; f32 throughout, so the f32 FMA
// peak, not the tensor cores.
//
// What the design does about it. Every product is a register-tiled SGEMM
// main loop: a CTA of 256 threads owns a 128 x 128 output tile, stages 16-deep
// slices of both operands in shared memory and gives each thread an 8 x 8
// micro-tile (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise
// from tx), 64 FMAs per four 16-byte shared loads; the next slice is loaded
// (16-byte loads where the edge and alignment allow) while the current one is
// computed, into a second shared buffer; 128 registers a thread keep two CTAs
// (16 warps) on each SM.
// - Forward: a CTA owns 128 rows and walks the hidden axis in tiles of 64
//   columns; each tile's 128 columns are w1's and w2's columns j0..j0+63, so
//   a thread holds u1 and u2 of the same hidden column, and the gate and the
//   wv contraction are the epilogue. The per-row sum over hidden tiles stays
//   in registers, in order; at the end the 16 threads of a row add their sums
//   in a fixed butterfly. w12 (5.8 MB) does not fit on an SM and is read from
//   L2 by every CTA; nothing (R, Hd)-shaped reaches memory.
// - Backward, in chunks of kChunk rows: (1) the gate kernel, a CTA per (128
//   rows, 64 hidden columns), recomputes u and writes du to a (kChunk, 2Hd)
//   workspace and the CTA's column sums of g * ds to a partial of dwv; (2) dx
//   of the chunk = du @ w12^T; (3) dw12's partial sums x^T du over kSplit
//   slices of the chunk's rows, each a CTA per 128 x 128 tile of dw12; (4) the
//   partials are added to dw12 and dwv in a fixed order, chunk after chunk. So
//   no atomics: the sums do not depend on the run, and the workspace is
//   bounded by the chunk (369 MB at Hd = 1,408), not by R.
// Ragged R, E and Hd are bounds-checked, nothing is padded; offsets into x,
// dx and the workspace are 64-bit. Tensor cores and TMA are not used yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;        // rows and columns of a CTA's output tile
constexpr int kHalf = kTile / 2;  // hidden columns per tile of the up projection
constexpr int kBK = 16;           // depth of a staged slice
constexpr int kLd = kTile + 4;    // row stride of a staged slice: 16-byte rows
constexpr long long kChunk = 32768;  // backward: rows per workspace chunk
constexpr int kSplit = 8;            // backward: row slices of dw12's partial sums

// Two slices of each operand: the main loop computes on one while the next
// is loaded into registers and then stored into the other.
struct Smem {
  float a[2][kBK][kLd];  // a[.][k][m]: the left operand's slice, transposed
  float b[2][kBK][kLd];  // b[.][k][n]: the right operand's slice
};

// The thread's micro-tile rows (i) and columns (j) within the CTA's tile.
__device__ __forceinline__ int tile_row(int ty, int i) { return (i >> 2) * 64 + ty * 4 + (i & 3); }
__device__ __forceinline__ int tile_col(int tx, int j) { return (j >> 2) * 64 + tx * 4 + (j & 3); }

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// The `valid` leading floats at p (0 to 4), zeros after them: one 16-byte
// load where all four are in range and p is 16-byte aligned.
__device__ __forceinline__ float4 load4(const float* p, int valid) {
  if (valid == 4 && (reinterpret_cast<size_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(p));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < valid ? __ldg(p + e) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ int clamp4(long long n) { return (int)(n < 0 ? 0 : n > 4 ? 4 : n); }

// A thread's share of a slice: kTile * kBK / kThreads = 8 floats, two runs of 4.
constexpr int kRuns = kTile * kBK / (4 * kThreads);
static_assert(kRuns == 2, "the staging maps assume two 4-float runs per thread");

// An operand whose tile element (t, k) lies at p[t * ld + k] (kUnitK) or at
// p[k * ld + t]; t < n is in range, t >= n and k >= kn read as 0. Each thread
// loads runs of 4 along the unit stride, so neighbours load neighbours.
template <bool kUnitK>
struct Operand {
  const float* p;
  long long ld;
  long long n;

  __device__ void load(float4 (&r)[kRuns], long long k0, int kn) const {
#pragma unroll
    for (int l = 0; l < kRuns; ++l) {
      const int q = threadIdx.x + l * kThreads;
      if (kUnitK) {  // t = q / 4, k = 4 * (q % 4)
        const int t = q >> 2, k = (q & 3) * 4;
        r[l] = load4(p + t * ld + k0 + k, t < n ? clamp4(kn - k) : 0);
      } else {  // k = q / 32, t = 4 * (q % 32)
        const int k = q >> 5, t = (q & 31) * 4;
        r[l] = load4(p + (k0 + k) * ld + t, k < kn ? clamp4(n - t) : 0);
      }
    }
  }

  __device__ void store(float (*s)[kLd], const float4 (&r)[kRuns]) const {
#pragma unroll
    for (int l = 0; l < kRuns; ++l) {
      const int q = threadIdx.x + l * kThreads;
      if (kUnitK) {
        const int t = q >> 2, k = (q & 3) * 4;
        s[k][t] = r[l].x;
        s[k + 1][t] = r[l].y;
        s[k + 2][t] = r[l].z;
        s[k + 3][t] = r[l].w;
      } else {
        *reinterpret_cast<float4*>(&s[q >> 5][(q & 31) * 4]) = r[l];
      }
    }
  }
};

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

// acc[i][j] += sum over k in [kb, ke) of A(row i, k) * B(k, column j). The
// next slice's loads are in flight while the current one is computed: one
// barrier per slice.
template <class OpA, class OpB>
__device__ void mainloop(const OpA& opa, const OpB& opb, long long kb, long long ke, Smem& sm,
                         float (&acc)[8][8]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  if (kb >= ke) return;
  float4 ra[kRuns], rb[kRuns];
  opa.load(ra, kb, (int)min((long long)kBK, ke - kb));
  opb.load(rb, kb, (int)min((long long)kBK, ke - kb));
  opa.store(sm.a[0], ra);
  opb.store(sm.b[0], rb);
  __syncthreads();
  int cur = 0;
  for (long long k0 = kb; k0 < ke; k0 += kBK) {
    const long long k1 = k0 + kBK;
    const bool more = k1 < ke;
    if (more) {
      opa.load(ra, k1, (int)min((long long)kBK, ke - k1));
      opb.load(rb, k1, (int)min((long long)kBK, ke - k1));
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[cur][k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[cur][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[cur][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      opa.store(sm.a[cur ^ 1], ra);
      opb.store(sm.b[cur ^ 1], rb);
    }
    __syncthreads();
    cur ^= 1;
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

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

// Backward (1), over one chunk of `rows` rows: du (rows, 2Hd) and, per CTA
// row tile t, part_v[t * Hd + j] = sum over its rows of g[r, j] * ds[r].
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
    const float d = __ldg(ds + r);
    float* dur = du + r * 2LL * Hd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + tx * 4 + j;
      if (jj >= Hd) continue;
      const float u1 = acc[i][j], u2 = acc[i][j + 4];
      const float sg = sigmoid(u1);
      const float sl = u1 * sg;
      const float dg = d * __ldg(wv + jj);
      dur[jj] = dg * u2 * (sg + sl * (1.0f - sg));
      dur[Hd + jj] = dg * sl;
      colsum[j] = fmaf(sl * u2, d, colsum[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx * 4 + j] = colsum[j];
  __syncthreads();
  if (threadIdx.x < kHalf && j0 + threadIdx.x < Hd) {
    float v = 0.0f;
    for (int t = 0; t < 16; ++t) v += red[t][threadIdx.x];
    part_v[(long long)blockIdx.x * Hd + j0 + threadIdx.x] = v;
  }
}

// C (M, N) row-major, slice z = blockIdx.z of kSplit-style partial sums at
// C + z * M * N: sum over k in [z * k_per, min(K, (z + 1) * k_per)) of
// A(m, k) * B(k, n), with A(m, k) at A[m * lda + k] (!kAT) or A[k * lda + m]
// and B(k, n) at B[k * ldb + n] (!kBT) or B[n * ldb + k].
template <bool kAT, bool kBT>
__global__ void __launch_bounds__(kThreads, 2) swiglu_vec_gemm_kernel(
    const float* __restrict__ A, long long lda, const float* __restrict__ B, long long ldb,
    float* __restrict__ C, int M, int N, long long K, long long k_per) {
  __shared__ __align__(16) Smem sm;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long m0 = (long long)blockIdx.y * kTile, n0 = (long long)blockIdx.x * kTile;
  const long long kb = (long long)blockIdx.z * k_per;
  const long long ke = min(K, kb + k_per);
  float acc[8][8];
  zero(acc);
  const Operand<!kAT> opa{kAT ? A + m0 : A + m0 * lda, lda, M - m0};
  const Operand<kBT> opb{kBT ? B + n0 * ldb : B + n0, ldb, N - n0};
  mainloop(opa, opb, kb, ke, sm, acc);
  float* out = C + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + tile_row(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long n = n0 + tile_col(tx, j);
      if (n < N) out[m * N + n] = acc[i][j];
    }
  }
}

// dst[i] = (accumulate ? dst[i] : 0) + sum over p, in order, of part[p * n + i].
__global__ void swiglu_vec_sum_kernel(const float* __restrict__ part, int nparts, long long n,
                                 float* __restrict__ dst, int accumulate) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int p = 0; p < nparts; ++p) v += part[p * n + i];
    dst[i] = accumulate ? dst[i] + v : v;
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

cudaError_t sum_parts(const float* part, int nparts, long long n, float* dst, bool accumulate,
                      cudaStream_t s) {
  const long long blocks = cdiv(n, 256) < 4096 ? cdiv(n, 256) : 4096;
  swiglu_vec_sum_kernel<<<(unsigned)blocks, 256, 0, s>>>(part, nparts, n, dst, accumulate ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the backward's workspace for R rows: du of one chunk, dw12's
// kSplit partials and dwv's per-row-tile partials of one chunk.
long long scldm_swiglu_vec_workspace_floats(long long R, int E, int Hd) {
  const long long rows = R < kChunk ? R : kChunk;
  return rows * 2LL * Hd + (long long)kSplit * E * 2LL * Hd + cdiv(rows, kTile) * Hd;
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
  if (R == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w12;
  const long long H2 = 2LL * Hd;
  float* du = (float*)workspace;
  float* part_w = du + (R < kChunk ? R : kChunk) * H2;
  float* part_v = part_w + (long long)kSplit * E * H2;
  cudaError_t err = cudaSuccess;
  for (long long c0 = 0; c0 < R && err == cudaSuccess; c0 += kChunk) {
    const long long rows = R - c0 < kChunk ? R - c0 : kChunk;
    const unsigned row_tiles = (unsigned)cdiv(rows, kTile);
    swiglu_vec_gate_kernel<<<dim3(row_tiles, (unsigned)cdiv(Hd, kHalf)), kThreads, 0, s>>>(
        xf + c0 * E, wf, (const float*)wv, (const float*)ds + c0, du, part_v, rows, E, Hd);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    // dx rows of the chunk: (rows, E) = du (rows, 2Hd) @ w12^T
    swiglu_vec_gemm_kernel<false, true>
        <<<dim3((unsigned)cdiv(E, kTile), row_tiles, 1), kThreads, 0, s>>>(
            du, H2, wf, H2, (float*)dx + c0 * E, (int)rows, E, H2, H2);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    // dw12's partials: (E, 2Hd) = x^T (E, rows) @ du (rows, 2Hd), over kSplit row slices
    const long long k_per = cdiv(cdiv(rows, kSplit), kBK) * kBK;
    swiglu_vec_gemm_kernel<true, false>
        <<<dim3((unsigned)cdiv(H2, kTile), (unsigned)cdiv(E, kTile), kSplit), kThreads, 0, s>>>(
            xf + c0 * E, E, du, H2, part_w, E, (int)H2, rows, k_per);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    if ((err = sum_parts(part_w, kSplit, E * H2, (float*)dw12, c0 > 0, s)) != cudaSuccess) break;
    err = sum_parts(part_v, (int)row_tiles, Hd, (float*)dwv, c0 > 0, s);
  }
  return (int)err;
}

}  // extern "C"
