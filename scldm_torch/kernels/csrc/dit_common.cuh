// Device helpers shared by the DiT block kernels (dit_block.cu, forward, and
// dit_block_bwd.cu, its recompute backward). f32 throughout.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace dit {

constexpr int kThreads = 256;
constexpr int kTok = 16;  // tokens whose sums one thread keeps in registers

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[w][i] = sum_k in[(t0 + i) * K + k] * Ww[k * ldw + n]  for i < tn,
// with W0 (and W1 when NW == 2) row-major (K, ldw) in global memory and `in`
// in shared memory, 16-byte aligned, K % 4 == 0.
template <int NW>
__device__ __forceinline__ void dot_tile(const float* in, int K, int t0, int tn,
                                         const float* __restrict__ W0,
                                         const float* __restrict__ W1, int ldw,
                                         int n, float (&acc)[NW][kTok]) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < kTok; ++i) acc[w][i] = 0.0f;

#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float wv[NW][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wv[0][j] = __ldg(W0 + (size_t)(k + j) * ldw + n);
      if (NW == 2) wv[NW - 1][j] = __ldg(W1 + (size_t)(k + j) * ldw + n);
    }
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      if (i < tn) {
        const float4 a = *reinterpret_cast<const float4*>(in + (t0 + i) * K + k);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          acc[w][i] = fmaf(a.x, wv[w][0], acc[w][i]);
          acc[w][i] = fmaf(a.y, wv[w][1], acc[w][i]);
          acc[w][i] = fmaf(a.z, wv[w][2], acc[w][i]);
          acc[w][i] = fmaf(a.w, wv[w][3], acc[w][i]);
        }
      }
    }
  }
}

// dst[t, :] = LN(src[t, :]) * (1 + scale) + shift, one warp per token. With
// `mean` and `rstd` given, also stores each token's mean and 1/sqrt(var + eps).
__device__ inline void ln_modulate(const float* src, float* dst, int T, int E,
                                   const float* scale, const float* shift, float eps,
                                   float* mean_out = nullptr, float* rstd_out = nullptr) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < T; t += n_warps) {
    const float* r = src + t * E;
    float s = 0.0f;
    for (int e = lane; e < E; e += 32) s += r[e];
    const float mean = warp_sum(s) / E;
    float v = 0.0f;
    for (int e = lane; e < E; e += 32) {
      const float d = r[e] - mean;
      v += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(v) / E + eps);
    for (int e = lane; e < E; e += 32)
      dst[t * E + e] = (r[e] - mean) * inv * (1.0f + scale[e]) + shift[e];
    if (mean_out != nullptr && lane == 0) {
      mean_out[t] = mean;
      rstd_out[t] = inv;
    }
  }
}

}  // namespace dit
