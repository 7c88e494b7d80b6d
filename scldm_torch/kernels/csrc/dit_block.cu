// One adaLN-zero DiT block forward, f32, one CTA per DiT row.
//
// Replaces the TPU kernel scldm_tpu/ops/fused_dit.py::fused_dit_block
// (Pallas body `_block_kernel`, math `_block_math`):
//
//   mod = silu(c) @ wada + bada  -> scale_a, shift_a, gate_a, scale_m, shift_m, gate_m
//         (chunk 0 multiplies and chunk 1 shifts: the reference's swapped modulate)
//   h   = LN(x) * (1 + scale_a) + shift_a            (non-affine LN, eps given)
//   x   = x + gate_a * (attn(h @ wqkv + bqkv) @ wproj + bproj)
//   h2  = LN(x) * (1 + scale_m) + shift_m
//   out = x + gate_m * ((silu(h2 @ w1) * (h2 @ w2)) @ wmlp)
//
// What bounds it on an H100: f32 FMA. At the CFG sampler's shapes (R=384 rows,
// T=16 tokens, E=256, Hd=684) one block is about 10 GFLOP of f32 multiply-add
// against 4.7 MB of f32 weights, which every CTA re-reads from the 50 MB L2.
//
// What the design does about it: a CTA keeps its row's whole working set (x,
// the modulated h, qkv or the SwiGLU hidden, the attention scores) in shared
// memory, so activations touch device memory once on the way in and once on
// the way out. Each thread owns one output column of a product and holds the
// sums of 16 tokens in registers: one weight load from L2 feeds 16 FMAs, and a
// 16-byte shared-memory broadcast feeds four. The k loops are unrolled by
// four so that sixteen weight loads per product are in flight at once: one
// CTA is bound by the latency of L2, not by its FMA rate, and
// `__launch_bounds__` keeps two CTAs (16 warps) on each SM to hide it
// (unrolling by eight spills and is slower). The tensor cores (wgmma, TMA)
// are not used yet.
//
// Shared memory, in floats: x (T*E), h (T*E), qkv or hidden (T*max(3E, Hd)),
// silu(c) (E), mod (6E), scores (H*T*T). scldm_torch/ops/fused_dit.py
// computes the same size in dit_block_smem_bytes(); keep the two in step.
// Requires E % 4 == 0, Hd % 4 == 0 and E % H == 0 (the wrapper checks).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

#include "dit_common.cuh"

namespace {

using dit::dot_tile;
using dit::kThreads;
using dit::kTok;
using dit::ln_modulate;
using dit::silu;

__global__ void __launch_bounds__(kThreads, 2)
dit_block_kernel(const float* __restrict__ x, const float* __restrict__ c,
                 const float* __restrict__ wada, const float* __restrict__ bada,
                 const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                 const float* __restrict__ wproj, const float* __restrict__ bproj,
                 const float* __restrict__ w1, const float* __restrict__ w2,
                 const float* __restrict__ wmlp, float* __restrict__ out,
                 int T, int E, int H, int Hd, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int wide = max(3 * E, Hd);
  float* xs = smem;               // (T, E) residual stream
  float* hs = xs + T * E;         // (T, E) modulated LN output, then attention output
  float* big = hs + T * E;        // (T, 3E) qkv, then (T, Hd) SwiGLU hidden
  float* cs = big + T * wide;     // (E) silu(c)
  float* mods = cs + E;           // (6E) modulation
  float* sc = mods + 6 * E;       // (H, T, T) attention scores / probabilities

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t row = blockIdx.x;
  const float* xr = x + row * T * E;
  float* outr = out + row * T * E;

  for (int i = tid; i < T * E; i += nthr) xs[i] = xr[i];
  for (int i = tid; i < E; i += nthr) cs[i] = silu(c[row * E + i]);
  __syncthreads();

  // mod = silu(c) @ wada + bada
  const int E6 = 6 * E;
  for (int n = tid; n < E6; n += nthr) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = 0; k < E; k += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = fmaf(cs[k + j], __ldg(wada + (size_t)(k + j) * E6 + n), acc[j]);
    }
    mods[n] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + bada[n];
  }
  __syncthreads();
  const float* scale_a = mods;
  const float* shift_a = mods + E;
  const float* gate_a = mods + 2 * E;
  const float* scale_m = mods + 3 * E;
  const float* shift_m = mods + 4 * E;
  const float* gate_m = mods + 5 * E;

  // -- attention branch -------------------------------------------------------
  ln_modulate(xs, hs, T, E, scale_a, shift_a, eps);
  __syncthreads();

  const int E3 = 3 * E;
  for (int n = tid; n < E3; n += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(hs, E, t0, tn, wqkv, nullptr, E3, n, acc);
      const float b = bqkv[n];
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) big[(t0 + i) * E3 + n] = acc[0][i] + b;
    }
  }
  __syncthreads();

  const int hd = E / H;
  const float qk_scale = 1.0f / sqrtf((float)hd);
  for (int idx = tid; idx < H * T * T; idx += nthr) {
    const int h = idx / (T * T);
    const int i = (idx / T) % T;
    const int j = idx % T;
    const float* q = big + i * E3 + h * hd;
    const float* k = big + j * E3 + E + h * hd;
    float s = 0.0f;
    for (int d = 0; d < hd; ++d) s = fmaf(q[d], k[d], s);
    sc[idx] = s * qk_scale;
  }
  __syncthreads();

  for (int r = tid; r < H * T; r += nthr) {
    float* p = sc + r * T;
    float m = p[0];
    for (int j = 1; j < T; ++j) m = fmaxf(m, p[j]);
    float sum = 0.0f;
    for (int j = 0; j < T; ++j) {
      p[j] = expf(p[j] - m);
      sum += p[j];
    }
    for (int j = 0; j < T; ++j) p[j] /= sum;
  }
  __syncthreads();

  for (int idx = tid; idx < T * E; idx += nthr) {
    const int i = idx / E;
    const int col = idx % E;
    const float* p = sc + ((col / hd) * T + i) * T;
    const float* v = big + 2 * E + col;
    float s = 0.0f;
    for (int j = 0; j < T; ++j) s = fmaf(p[j], v[j * E3], s);
    hs[idx] = s;
  }
  __syncthreads();

  for (int n = tid; n < E; n += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(hs, E, t0, tn, wproj, nullptr, E, n, acc);
      const float b = bproj[n];
      const float g = gate_a[n];
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) xs[(t0 + i) * E + n] += g * (acc[0][i] + b);
    }
  }
  __syncthreads();

  // -- SwiGLU branch -----------------------------------------------------------
  ln_modulate(xs, hs, T, E, scale_m, shift_m, eps);
  __syncthreads();

  for (int n = tid; n < Hd; n += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[2][kTok];
      dot_tile<2>(hs, E, t0, tn, w1, w2, Hd, n, acc);
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) big[(t0 + i) * Hd + n] = silu(acc[0][i]) * acc[1][i];
    }
  }
  __syncthreads();

  for (int n = tid; n < E; n += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(big, Hd, t0, tn, wmlp, nullptr, E, n, acc);
      const float g = gate_m[n];
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) outr[(t0 + i) * E + n] = xs[(t0 + i) * E + n] + g * acc[0][i];
    }
  }
}

// The dynamic shared memory the kernel is already allowed, per device: the
// attribute is set only when a launch needs more than before.
constexpr int kMaxDevices = 64;
std::atomic<long long> g_smem_allowed[kMaxDevices];

}  // namespace

extern "C" {

// Launches one block forward on `stream`, on the current device: R CTAs of
// 256 threads with `smem_bytes` of dynamic shared memory. Returns the CUDA
// error code of the launch (0 on success). Allocates nothing and does not
// synchronise.
int scldm_dit_block_forward(const void* x, const void* c, const void* wada,
                            const void* bada, const void* wqkv, const void* bqkv,
                            const void* wproj, const void* bproj, const void* w1,
                            const void* w2, const void* wmlp, void* out, int R,
                            int T, int E, int H, int Hd, float eps,
                            long long smem_bytes, void* stream) {
  if (R == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem_bytes > g_smem_allowed[dev].load()) {
    err = cudaFuncSetAttribute(dit_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) g_smem_allowed[dev].store(smem_bytes);
  }
  dit_block_kernel<<<R, kThreads, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)c, (const float*)wada, (const float*)bada,
      (const float*)wqkv, (const float*)bqkv, (const float*)wproj,
      (const float*)bproj, (const float*)w1, (const float*)w2,
      (const float*)wmlp, (float*)out, T, E, H, Hd, eps);
  return (int)cudaGetLastError();
}

const char* scldm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
