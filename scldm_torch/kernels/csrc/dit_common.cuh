// Device helpers of the DiT block kernels (dit_tiled.cuh, dit_block.cu,
// dit_block_bwd.cu) and the whole-trunk kernels (fused_trunk.cu): silu,
// sigmoid, a warp sum and the dynamic shared memory allowance; and
// `weight_grads`, the trunk backward's weight-gradient kernel (row 11: f32
// FMA, a tiled U^T V over the token axis per gradient). The DiT block's own
// weight gradients run on the tensor cores (`tiled::grad_gemm`).
//
// The kernel sits in an unnamed namespace: each source that includes this
// header compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

namespace dit {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sets a kernel's dynamic shared memory limit on the current device, once
// per device and size: the attribute is set only when a launch needs more
// than 48 KB and more than the kernel was allowed before.
struct SmemAllowance {
  std::atomic<long long> bytes[kMaxDevices];
};

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, long long need, SmemAllowance& allowed) {
  if (need <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && need <= allowed.bytes[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
  if (err == cudaSuccess && dev < kMaxDevices) allowed.bytes[dev].store(need);
  return err;
}

namespace {

// One weight gradient: out (P, Q) = sum_n u[n, p] * v[n, q] over N rows, and
// bias (P) = sum_n u[n, p] when given; with v == nullptr, only bias (a
// column sum of u). tiles_q and tile0 are filled by plan_grad_jobs.
struct GradJob {
  const float* u;
  const float* v;
  float* out;
  float* bias;
  int P, Q, N, tiles_q, tile0;
};

template <int kMax>
struct GradJobs {
  GradJob job[kMax];
  int n;
};

constexpr int kTileP = 64, kTileQ = 64, kTileN = 16;

// Numbers the CTAs of each job (64 x 64 outputs each; a column sum takes one
// CTA per 64 columns) and returns how many the launch needs.
template <int kMax>
inline int plan_grad_jobs(GradJobs<kMax>& jobs) {
  int tiles = 0;
  for (int j = 0; j < jobs.n; ++j) {
    GradJob& jb = jobs.job[j];
    jb.tiles_q = jb.v != nullptr ? (jb.Q + kTileQ - 1) / kTileQ : 1;
    jb.tile0 = tiles;
    tiles += ((jb.P + kTileP - 1) / kTileP) * jb.tiles_q;
  }
  return tiles;
}

// Every job's gradient in one launch of plan_grad_jobs()'s CTAs, 256 threads
// each: a tiled U^T V over the N rows, 4 x 4 outputs per thread, 16 rows per
// shared-memory stage; the bias (column sum of U) is taken by the CTAs of the
// first column tile. No atomics: every sum is taken in a fixed order.
template <int kMax>
__global__ void __launch_bounds__(256) weight_grads(const __grid_constant__ GradJobs<kMax> jobs) {
  __shared__ __align__(16) float us[kTileN][kTileP];
  __shared__ __align__(16) float vs[kTileN][kTileQ];
  int j = 0;
  while (j + 1 < jobs.n && (int)blockIdx.x >= jobs.job[j + 1].tile0) ++j;
  const GradJob jb = jobs.job[j];
  const bool product = jb.v != nullptr;
  const int tile = blockIdx.x - jb.tile0;
  const int p0 = (tile / jb.tiles_q) * kTileP;
  const int q0 = (tile % jb.tiles_q) * kTileQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const bool with_bias = jb.bias != nullptr && q0 == 0;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  float bsum = 0.0f;

  for (int n0 = 0; n0 < jb.N; n0 += kTileN) {
    for (int i = tid; i < kTileN * kTileP; i += blockDim.x) {
      const int r = i / kTileP, col = i % kTileP;
      const int n = n0 + r;
      us[r][col] = (n < jb.N && p0 + col < jb.P) ? jb.u[(size_t)n * jb.P + p0 + col] : 0.0f;
      vs[r][col] = (product && n < jb.N && q0 + col < jb.Q)
                       ? jb.v[(size_t)n * jb.Q + q0 + col] : 0.0f;
    }
    __syncthreads();
    if (with_bias && tid < kTileP)
      for (int r = 0; r < kTileN; ++r) bsum += us[r][tid];
    if (product) {
#pragma unroll
      for (int r = 0; r < kTileN; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&us[r][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&vs[r][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
      }
    }
    __syncthreads();
  }
  if (product) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      if (p >= jb.P) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = q0 + tx * 4 + k;
        if (q < jb.Q) jb.out[(size_t)p * jb.Q + q] = acc[i][k];
      }
    }
  }
  if (with_bias && tid < kTileP && p0 + tid < jb.P) jb.bias[p0 + tid] = bsum;
}

}  // namespace

}  // namespace dit
