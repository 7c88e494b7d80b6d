// One adaLN-zero DiT block forward, f32: one kernel per row where a row fits
// one CTA, four kernels where it does not.
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
// What bounds it on an H100: f32 FMA. One block is about 2*R*(6E^2 + T*(4E^2
// + 2TE + 3E*Hd)) operations (10 GFLOP at the dentate sampler's R=384 rows of
// T=16 tokens, E=256, Hd=684; 5 GFLOP at the census sampler's R=48 rows of
// T=64) against 4.7 MB of f32 weights, which the CTAs re-read from the 50 MB
// L2.
//
// What the design does about it. The Pallas kernel keeps a block of whole
// rows in VMEM. Two designs here, chosen by the wrapper
// (scldm_torch/ops/fused_dit.py, pick_design) by their shared memory:
//
// The row design (dit_block_kernel), where a row fits one CTA (the dentate
// DiT, T=16: 97 KB): the CTA keeps its row's whole working set in shared
// memory, so activations touch device memory once on the way in and once on
// the way out. At T=16 it is the faster of the two (PERF.md, section 6).
//
// The split design, where it does not: a CTA cannot hold one census row
// (T=64: the (H, T, T) scores alone take 131 KB, the row's working set 466
// KB), so the block is split by what each stage needs (dit_common.cuh):
//   1. rows_gemm: mod for kRowTile rows per CTA, one weight load feeding
//      eight rows;
//   2. ln_qkv: per (row, tile of kTok tokens): LN, modulate, the qkv product;
//   3. attention: per (row, head): scores, softmax, probabilities times v;
//   4. block_post (below): per (row, token tile): the projection and gated
//      residual, LN, modulate, the SwiGLU, the down projection and the gated
//      residual.
// qkv, the attention output and mod go through a device workspace
// (dit_block_workspace_floats() in scldm_torch/ops/fused_dit.py: R*6E + 4E per
// token).
//
// In both, each thread owns one output column of a product and keeps the
// sums of kTok tokens in registers: one weight load from L2 feeds 16 FMAs
// and a 16-byte shared-memory broadcast feeds four; the k loops are unrolled
// by four so that sixteen weight loads are in flight, and `__launch_bounds__`
// keeps two CTAs on each SM. The tensor cores (wgmma, TMA) are not used yet.
//
// Shared memory per CTA, in floats: the row kernel x (T*E), h (T*E), qkv or
// hidden (T*max(3E, Hd)), silu(c) (E), mod (6E), scores (H*T*T); the split's
// rows_gemm kRowTile*E + 2048, ln_qkv kTok*E, attention 2*T*hd + T*(hd + 1) +
// T*T, block_post kTok*(2E + Hd).
// Requires E % 4 == 0, Hd % 4 == 0 and E % H == 0 (the wrapper checks).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <algorithm>

#include "dit_common.cuh"

namespace {

using dit::allow_smem;
using dit::dot_tile;
using dit::kRowTile;
using dit::kThreads;
using dit::kTok;
using dit::ln_modulate;
using dit::silu;
using dit::SmemAllowance;

// The row design: one CTA per DiT row, its whole working set (x, the
// modulated h, qkv or the SwiGLU hidden, the attention scores) in shared
// memory, so activations touch device memory once on the way in and once on
// the way out. Taken where a row fits one CTA (the dentate DiT's T = 16):
// there it is faster than the four kernels below.
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

// The attention branch's projection and gated residual, then the SwiGLU
// branch, for the tokens of one (row, tile of kTok tokens); grid R *
// ceil(T / kTok).
__global__ void __launch_bounds__(kThreads, 2)
block_post(const float* __restrict__ x, const float* __restrict__ attn,
           const float* __restrict__ mod, const float* __restrict__ wproj,
           const float* __restrict__ bproj, const float* __restrict__ w1,
           const float* __restrict__ w2, const float* __restrict__ wmlp,
           float* __restrict__ out, int T, int E, int Hd, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // (kTok, E) x, then the residual stream x1
  float* hs = xs + kTok * E;   // (kTok, E) the attention output, then h2
  float* gs = hs + kTok * E;   // (kTok, Hd) the SwiGLU hidden
  const int nt = (T + kTok - 1) / kTok;
  const int row = blockIdx.x / nt;
  const int t0 = (blockIdx.x % nt) * kTok;
  const int tn = min(kTok, T - t0);
  const size_t tok = (size_t)row * T + t0;
  const float* mrow = mod + (size_t)row * 6 * E;
  const float* gate_a = mrow + 2 * E;
  const float* scale_m = mrow + 3 * E;
  const float* shift_m = mrow + 4 * E;
  const float* gate_m = mrow + 5 * E;
  const int tid = threadIdx.x;

  for (int i = tid; i < tn * E; i += kThreads) {
    xs[i] = x[tok * E + i];
    hs[i] = attn[tok * E + i];
  }
  __syncthreads();

  for (int n = tid; n < E; n += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(hs, E, 0, tn, wproj, nullptr, E, n, acc);
    const float b = bproj[n];
    const float g = gate_a[n];
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) xs[i * E + n] += g * (acc[0][i] + b);
  }
  __syncthreads();

  ln_modulate(xs, hs, tn, E, scale_m, shift_m, eps);
  __syncthreads();

  for (int n = tid; n < Hd; n += kThreads) {
    float acc[2][kTok];
    dot_tile<2>(hs, E, 0, tn, w1, w2, Hd, n, acc);
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) gs[i * Hd + n] = silu(acc[0][i]) * acc[1][i];
  }
  __syncthreads();

  for (int n = tid; n < E; n += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(gs, Hd, 0, tn, wmlp, nullptr, E, n, acc);
    const float g = gate_m[n];
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) out[(tok + i) * E + n] = xs[i * E + n] + g * acc[0][i];
  }
}

SmemAllowance g_row_smem, g_mod_smem, g_qkv_smem, g_attn_smem, g_post_smem;

}  // namespace

extern "C" {

// Launches one block forward on `stream`, on the current device, 256
// threads a CTA: with `row_design` the row kernel (R CTAs), otherwise the
// four kernels of the split, whose `workspace` holds R*6E + R*T*4E floats
// (mod, qkv, the attention output; unused by the row kernel). Returns the
// first CUDA error code (0 on success). Allocates nothing and does not
// synchronise.
int scldm_dit_block_forward(const void* x, const void* c, const void* wada,
                            const void* bada, const void* wqkv, const void* bqkv,
                            const void* wproj, const void* bproj, const void* w1,
                            const void* w2, const void* wmlp, void* out, void* workspace,
                            int R, int T, int E, int H, int Hd, float eps, int row_design,
                            void* stream) {
  using dit::RowsIn;
  using dit::RowsOut;
  if (R == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (row_design) {
    // x, h, qkv or hidden, silu(c), mod, the scores
    const long long smem = 4LL * (2 * T * E + T * std::max(3 * E, Hd) + 7 * E + H * T * T);
    if ((err = allow_smem(dit_block_kernel, smem, g_row_smem)) != cudaSuccess) return (int)err;
    dit_block_kernel<<<R, kThreads, smem, s>>>(
        (const float*)x, (const float*)c, (const float*)wada, (const float*)bada,
        (const float*)wqkv, (const float*)bqkv, (const float*)wproj, (const float*)bproj,
        (const float*)w1, (const float*)w2, (const float*)wmlp, (float*)out, T, E, H, Hd, eps);
    return (int)cudaGetLastError();
  }
  float* mod = (float*)workspace;
  float* qkv = mod + (size_t)R * 6 * E;
  float* att = qkv + (size_t)R * T * 3 * E;
  const int nt = (T + kTok - 1) / kTok;

  const long long mod_smem = 4LL * dit::rows_gemm_floats(E);
  const long long qkv_smem = 4LL * kTok * E;
  const long long attn_smem = 4LL * dit::attention_floats(T, E / H);
  const long long post_smem = 4LL * kTok * (2 * E + Hd);
  if ((err = allow_smem(dit::rows_gemm<RowsIn::kSilu, RowsOut::kBias>, mod_smem,
                        g_mod_smem)) != cudaSuccess ||
      (err = allow_smem(dit::ln_qkv, qkv_smem, g_qkv_smem)) != cudaSuccess ||
      (err = allow_smem(dit::attention, attn_smem, g_attn_smem)) != cudaSuccess ||
      (err = allow_smem(block_post, post_smem, g_post_smem)) != cudaSuccess)
    return (int)err;

  const dim3 mod_grid((6 * E + 31) / 32, (R + kRowTile - 1) / kRowTile);
  dit::rows_gemm<RowsIn::kSilu, RowsOut::kBias><<<mod_grid, kThreads, mod_smem, s>>>(
      (const float*)c, 1, (const float*)wada, (const float*)bada, mod, nullptr, R, E, 6 * E);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dit::ln_qkv<<<R * nt, kThreads, qkv_smem, s>>>((const float*)x, mod, (const float*)wqkv,
                                                 (const float*)bqkv, qkv, nullptr, T, E, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dit::attention<<<R * H, kThreads, attn_smem, s>>>(qkv, att, T, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  block_post<<<R * nt, kThreads, post_smem, s>>>(
      (const float*)x, att, mod, (const float*)wproj, (const float*)bproj, (const float*)w1,
      (const float*)w2, (const float*)wmlp, (float*)out, T, E, Hd, eps);
  return (int)cudaGetLastError();
}

const char* scldm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
