// The register-tiled f32 SGEMM main loop of window_pool_wide.cu (the wide
// window pool), with a split-K product kernel over it and a fixed-order sum
// of partials.
//
// A CTA of 256 threads owns a 128 x 128 output tile, stages 16-deep slices of
// both operands in shared memory and gives each thread an 8 x 8 micro-tile
// (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise from tx), 64
// FMAs per four 16-byte shared loads; the next slice is loaded (16-byte loads
// where the edge and alignment allow) while the current one is computed, into
// a second shared buffer; 128 registers a thread keep two CTAs (16 warps) on
// each SM. Ragged edges are bounds-checked, nothing is padded.
//
// The kernels below sit in an unnamed namespace: each source that includes
// this header compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace sgemm {

constexpr int kThreads = 256;
constexpr int kTile = 128;        // rows and columns of a CTA's output tile
constexpr int kHalf = kTile / 2;  // the micro-tile's second half starts here
constexpr int kBK = 16;           // depth of a staged slice
constexpr int kLd = kTile + 4;    // row stride of a staged slice: 16-byte rows

// Two slices of each operand: the main loop computes on one while the next
// is loaded into registers and then stored into the other.
struct Smem {
  float a[2][kBK][kLd];  // a[.][k][m]: the left operand's slice, transposed
  float b[2][kBK][kLd];  // b[.][k][n]: the right operand's slice
};

// The thread's micro-tile rows (i) and columns (j) within the CTA's tile.
__device__ __forceinline__ int tile_row(int ty, int i) { return (i >> 2) * 64 + ty * 4 + (i & 3); }
__device__ __forceinline__ int tile_col(int tx, int j) { return (j >> 2) * 64 + tx * 4 + (j & 3); }

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

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

namespace {

// C (M, N) row-major, slice z = blockIdx.z of kSplit-style partial sums at
// C + z * M * N: sum over k in [z * k_per, min(K, (z + 1) * k_per)) of
// A(m, k) * B(k, n), with A(m, k) at A[m * lda + k] (!kAT) or A[k * lda + m]
// and B(k, n) at B[k * ldb + n] (!kBT) or B[n * ldb + k].
template <bool kAT, bool kBT>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(
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
__global__ void sum_parts_kernel(const float* __restrict__ part, int nparts, long long n,
                                 float* __restrict__ dst, int accumulate) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int p = 0; p < nparts; ++p) v += part[p * n + i];
    dst[i] = accumulate ? dst[i] + v : v;
  }
}

inline cudaError_t sum_parts(const float* part, int nparts, long long n, float* dst,
                             bool accumulate, cudaStream_t s) {
  const long long blocks = cdiv(n, 256) < 4096 ? cdiv(n, 256) : 4096;
  sum_parts_kernel<<<(unsigned)blocks, 256, 0, s>>>(part, nparts, n, dst, accumulate ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

}  // namespace sgemm
