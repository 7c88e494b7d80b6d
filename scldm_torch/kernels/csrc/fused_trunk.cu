// The whole trunk of the VAE's encoder or decoder, f32: L plain pre-LN blocks
// (affine LayerNorm, fused-qkv self-attention, SwiGLU, no biases) in one
// forward launch, and their backward in two.
//
// Replaces the TPU kernels of scldm_tpu/ops/fused_trunk.py: fused_trunk_blocks
// (the forward, Pallas body `_trunk_kernel` with save=False), _fwd_saving (the
// same, also writing each layer's input) and _bwd_pallas (the whole-trunk
// backward, `_trunk_bwd_kernel`). The math is `_trunk_math`, per layer:
//
//   h  = LN(x) * g1 + b1
//   x += attn(h @ wqkv) @ wproj          (H heads of hd = E / H, softmax over T)
//   h2 = LN(x) * g2 + b2
//   x += (silu(h2 @ w1) * (h2 @ w2)) @ wmlp
//
// What bounds it on an H100: f32 FMA, 2 * L * (4E^2 + 2TE + 3E*Hd) operations
// per token (0.44 GFLOP forward at the VAE's R = 128 rows of T = 16 tokens,
// E = 32, Hd = 88, L = 8; the backward recomputes the forward and takes
// about three times that), against 2 MB of saved layer inputs and 0.4 MB of
// weights. At these widths a product has 32 to 96 outputs per token, so what
// costs is latency: of the L2, of shared memory and of the barriers between
// the stages of a block.
//
// What the design does about it. Rows are independent, so one CTA owns one
// row and runs all L layers with the row's (T, E) activations and every
// intermediate in shared memory: activations touch device memory once on
// the way in and once on the way out (and once per layer to save its input).
// The weights are read in nn.Linear's (out, in) layout through the L1 from
// the L2, where all of them stay; each thread of a product owns one output
// column for kTg tokens. The pointers to each layer's nine tensors ride in
// the kernel's parameters (kMaxLayers layers a launch; deeper trunks take
// one launch per kMaxLayers layers), so no weight is stacked or copied.
//
// The backward needs no grid-wide step: the dx chain is per row. One CTA per
// row walks the layers top-down, recomputes each layer's forward from its
// saved input, runs its backward with dx carried in shared memory, and writes
// the (activation, cotangent) pairs of the weight gradients to a device
// workspace (per token: h, dqkv, attn, dproj, h2, [da | db], g, dm; per row
// the LayerNorm affine partials). Then dit_common.cuh's weight_grads sums
// every layer's gradients over the R*T tokens in one launch, in a fixed
// order: no atomics, the same bits every run. Workspace:
// trunk_workspace_floats() (scldm_torch/ops/fused_trunk.py), 35 MB at the
// VAE's shapes.
//
// Shared memory per CTA, in floats: forward 2TE + T*max(3E + 1, Hd) +
// H*T*(T + 1); backward 4TE + T(3E + 1) + T*max(2Hd, 3E) + 2H*T*(T + 1) + 4T
// (trunk_smem_bytes() in scldm_torch/ops/fused_trunk.py states both and the
// wrapper checks them before launch). Requires E % 4 == 0, Hd % 4 == 0,
// E % H == 0 and every weight 16-byte aligned (the wrapper checks). The
// tensor cores are not used yet.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <algorithm>

#include "dit_common.cuh"

namespace {

using dit::allow_smem;
using dit::sigmoid;
using dit::silu;
using dit::SmemAllowance;
using dit::warp_sum;

constexpr int kThreads = 256;
constexpr int kTg = 2;           // tokens whose sums one thread of a product keeps
constexpr int kMaxLayers = 8;    // layers a launch: pointers and gradient jobs are parameters
constexpr int kNames = 9;        // TRUNK_WEIGHT_NAMES
enum { kG1, kB1, kQkv, kProj, kG2, kB2, kW1, kW2, kMlp };
constexpr int kJobs = 5 * kMaxLayers;

// Each layer's nine tensors, in TRUNK_WEIGHT_NAMES order: g1, b1 (E),
// wqkv (3E, E), wproj (E, E), g2, b2 (E), w1, w2 (Hd, E), wmlp (E, Hd).
struct Layers {
  const float* w[kMaxLayers][kNames];
};

inline int fwd_floats(int T, int E, int H, int Hd) {
  return 2 * T * E + T * std::max(3 * E + 1, Hd) + H * T * (T + 1);
}

inline int bwd_floats(int T, int E, int H, int Hd) {
  return 4 * T * E + T * (3 * E + 1) + T * std::max(2 * Hd, 3 * E) + 2 * H * T * (T + 1) + 4 * T;
}

// acc = sum_k in[t * K + k] * W0[n * K + k] (and the same against W1 when
// NW == 2), then epi(t, n, acc0, acc1), for t < T and n < N: one thread per
// output column n and kTg tokens. `in` is in shared memory, W0 and W1 are
// (N, K) row-major in global memory, both 16-byte aligned, K % 4 == 0.
template <int NW, class Epi>
__device__ __forceinline__ void linear(const float* in, int K, const float* __restrict__ W0,
                                       const float* __restrict__ W1, int N, int T, Epi epi) {
  const int groups = (T + kTg - 1) / kTg;
  for (int idx = threadIdx.x; idx < N * groups; idx += blockDim.x) {
    const int n = idx % N;
    const int t0 = (idx / N) * kTg;
    float acc[NW][kTg];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < kTg; ++i) acc[w][i] = 0.0f;
    const float4* w0 = reinterpret_cast<const float4*>(W0 + (size_t)n * K);
    const float4* w1 = NW == 2 ? reinterpret_cast<const float4*>(W1 + (size_t)n * K) : nullptr;
#pragma unroll 4
    for (int k4 = 0; k4 < K / 4; ++k4) {
      float4 wv[NW];
      wv[0] = __ldg(w0 + k4);
      if constexpr (NW == 2) wv[1] = __ldg(w1 + k4);
#pragma unroll
      for (int i = 0; i < kTg; ++i) {
        if (t0 + i < T) {
          const float4 a = reinterpret_cast<const float4*>(in + (t0 + i) * K)[k4];
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            acc[w][i] = fmaf(a.x, wv[w].x, acc[w][i]);
            acc[w][i] = fmaf(a.y, wv[w].y, acc[w][i]);
            acc[w][i] = fmaf(a.z, wv[w].z, acc[w][i]);
            acc[w][i] = fmaf(a.w, wv[w].w, acc[w][i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTg; ++i)
      if (t0 + i < T) epi(t0 + i, n, acc[0][i], acc[NW - 1][i]);
  }
}

// The products against a transposed weight: acc = sum_n in0[t * ld + n] *
// W0[n * K + k] (plus in1[t * ld + n] * W1[n * K + k] when NW == 2), then
// epi(t, k, acc), for t < T and k < K: one thread per output column k, so
// that a warp reads consecutive entries of each weight row.
template <int NW, class Epi>
__device__ __forceinline__ void linear_t(const float* in0, const float* in1, int ld, int N,
                                         const float* __restrict__ W0,
                                         const float* __restrict__ W1, int K, int T, Epi epi) {
  const int groups = (T + kTg - 1) / kTg;
  for (int idx = threadIdx.x; idx < K * groups; idx += blockDim.x) {
    const int k = idx % K;
    const int t0 = (idx / K) * kTg;
    float acc[kTg];
#pragma unroll
    for (int i = 0; i < kTg; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float w0 = __ldg(W0 + (size_t)n * K + k);
      float w1 = 0.0f;
      if constexpr (NW == 2) w1 = __ldg(W1 + (size_t)n * K + k);
#pragma unroll
      for (int i = 0; i < kTg; ++i) {
        if (t0 + i < T) {
          acc[i] = fmaf(in0[(t0 + i) * ld + n], w0, acc[i]);
          if constexpr (NW == 2) acc[i] = fmaf(in1[(t0 + i) * ld + n], w1, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTg; ++i)
      if (t0 + i < T) epi(t0 + i, k, acc[i]);
  }
}

// dst[t, :] = LN(src[t, :]) * g + b, one warp per token; with `mean` and
// `rstd` given, also each token's mean and 1/sqrt(var + eps).
__device__ void ln_affine(const float* src, float* dst, int T, int E,
                          const float* __restrict__ g, const float* __restrict__ b, float eps,
                          float* mean = nullptr, float* rstd = nullptr) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < T; t += blockDim.x >> 5) {
    const float* r = src + t * E;
    float s = 0.0f;
    for (int e = lane; e < E; e += 32) s += r[e];
    const float mu = warp_sum(s) / E;
    float v = 0.0f;
    for (int e = lane; e < E; e += 32) {
      const float d = r[e] - mu;
      v += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(v) / E + eps);
    for (int e = lane; e < E; e += 32)
      dst[t * E + e] = (r[e] - mu) * inv * __ldg(g + e) + __ldg(b + e);
    if (mean != nullptr && lane == 0) {
      mean[t] = mu;
      rstd[t] = inv;
    }
  }
}

// The affine LayerNorm's backward over the T tokens of one row, given d, the
// cotangent of its output, and its input src with their statistics:
// part[e] = sum_t d * xhat and part[E + e] = sum_t d (the row's share of dg
// and db), and acc[t, :] += rstd * (dxh - mean(dxh) - xhat * mean(dxh *
// xhat)) with dxh = d * g. `part` is in global memory.
__device__ void ln_affine_bwd(const float* d, const float* src, const float* mean,
                              const float* rstd, const float* __restrict__ g, int T, int E,
                              float* part, float* acc) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float dg = 0.0f, db = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float v = d[t * E + e];
      dg = fmaf(v, (src[t * E + e] - mean[t]) * rstd[t], dg);
      db += v;
    }
    part[e] = dg;
    part[E + e] = db;
  }
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < T; t += blockDim.x >> 5) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int e = lane; e < E; e += 32) {
      const float xh = (src[t * E + e] - mean[t]) * rstd[t];
      const float dxh = d[t * E + e] * __ldg(g + e);
      s1 += dxh;
      s2 = fmaf(dxh, xh, s2);
    }
    s1 = warp_sum(s1) / E;
    s2 = warp_sum(s2) / E;
    for (int e = lane; e < E; e += 32) {
      const float xh = (src[t * E + e] - mean[t]) * rstd[t];
      const float dxh = d[t * E + e] * __ldg(g + e);
      acc[t * E + e] += rstd[t] * (dxh - s1 - xh * s2);
    }
  }
}

// o = softmax(q_h k_h^T / sqrt(hd)) v_h for every head h, from qkv (T, ldq)
// = [q | k | v] (rows padded to ldq = 3E + 1, so that a warp reading the
// rows of k reads other banks); P (H, T, T + 1) keeps the probabilities, o
// is (T, E). The scores are taken as the plain version takes them, s *
// scale, then the max, the exponentials and their sum. Ends synchronised.
__device__ void attention(const float* qkv, int ldq, float* P, float* o, int T, int E, int H) {
  const int hd = E / H, ldp = T + 1;
  const float scale = 1.0f / sqrtf((float)hd);
  for (int idx = threadIdx.x; idx < H * T * T; idx += blockDim.x) {
    const int h = idx / (T * T), i = (idx / T) % T, j = idx % T;
    const float* q = qkv + i * ldq + h * hd;
    const float* k = qkv + j * ldq + E + h * hd;
    float s = 0.0f;
    for (int d = 0; d < hd; ++d) s = fmaf(q[d], k[d], s);
    P[(h * T + i) * ldp + j] = s * scale;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < H * T; r += blockDim.x) {
    float* p = P + r * ldp;
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
  for (int idx = threadIdx.x; idx < T * E; idx += blockDim.x) {
    const int t = idx / E, col = idx % E;
    const float* p = P + ((col / hd) * T + t) * ldp;
    const float* v = qkv + 2 * E + col;
    float s = 0.0f;
    for (int j = 0; j < T; ++j) s = fmaf(p[j], v[j * ldq], s);
    o[idx] = s;
  }
  __syncthreads();
}

// The forward of `nl` layers, one CTA per row: x (R, T, E) -> out (R, T, E);
// with kSave, also each layer's input to xs[l] (R, T, E). x and out may be
// the same buffer (each CTA reads its row before it writes it).
template <bool kSave>
__global__ void __launch_bounds__(kThreads)
trunk_forward(const float* x, float* out, float* __restrict__ xs, const __grid_constant__ Layers p,
              int nl, int R, int T, int E, int H, int Hd, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = 3 * E + 1;
  float* xr = smem;                        // (T, E) the residual stream
  float* hs = xr + T * E;                  // (T, E) LN output, then attention output
  float* big = hs + T * E;                 // (T, ldq) qkv, then (T, Hd) the SwiGLU hidden
  float* P = big + T * max(ldq, Hd);       // (H, T, T + 1) probabilities
  const size_t TE = (size_t)T * E;
  const size_t row = blockIdx.x;
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) xr[i] = x[row * TE + i];
  __syncthreads();

  for (int l = 0; l < nl; ++l) {
    if (kSave)
      for (int i = threadIdx.x; i < T * E; i += blockDim.x)
        xs[((size_t)l * R + row) * TE + i] = xr[i];
    // -- attention branch ----------------------------------------------------
    ln_affine(xr, hs, T, E, p.w[l][kG1], p.w[l][kB1], eps);
    __syncthreads();
    linear<1>(hs, E, p.w[l][kQkv], nullptr, 3 * E, T,
              [&](int t, int n, float a, float) { big[t * ldq + n] = a; });
    __syncthreads();
    attention(big, ldq, P, hs, T, E, H);
    linear<1>(hs, E, p.w[l][kProj], nullptr, E, T,
              [&](int t, int n, float a, float) { xr[t * E + n] += a; });
    __syncthreads();
    // -- SwiGLU branch -------------------------------------------------------
    ln_affine(xr, hs, T, E, p.w[l][kG2], p.w[l][kB2], eps);
    __syncthreads();
    linear<2>(hs, E, p.w[l][kW1], p.w[l][kW2], Hd, T,
              [&](int t, int n, float a, float b) { big[t * Hd + n] = silu(a) * b; });
    __syncthreads();
    linear<1>(big, Hd, p.w[l][kMlp], nullptr, E, T,
              [&](int t, int n, float a, float) { xr[t * E + n] += a; });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < T * E; i += blockDim.x) out[row * TE + i] = xr[i];
}

// One layer's slice of the backward's workspace: per token unless marked.
struct Slots {
  float* h;      // (N, E)   h, the input of wqkv
  float* dqkv;   // (N, 3E)  dqkv
  float* attn;   // (N, E)   the attention output, the input of wproj
  float* dproj;  // (N, E)   the cotangent of the attention branch's output
  float* h2;     // (N, E)   h2, the input of w1 and w2
  float* dab;    // (N, 2Hd) [da | db]
  float* g;      // (N, Hd)  silu(a) * b, the input of wmlp
  float* m;      // (N, E)   the cotangent of the SwiGLU branch's output
  float* ln;     // (R, 4E)  per row [dg1 | db1 | dg2 | db2], summed over its tokens
};

__host__ __device__ inline size_t layer_floats(int R, int T, int E, int Hd) {
  return (size_t)R * T * (8 * E + 3 * Hd) + (size_t)R * 4 * E;
}

__host__ __device__ inline Slots slots(float* ws, int i, int R, int T, int E, int Hd) {
  const size_t N = (size_t)R * T;
  Slots s;
  s.h = ws + i * layer_floats(R, T, E, Hd);
  s.dqkv = s.h + N * E;
  s.attn = s.dqkv + N * 3 * E;
  s.dproj = s.attn + N * E;
  s.h2 = s.dproj + N * E;
  s.dab = s.h2 + N * E;
  s.g = s.dab + N * 2 * Hd;
  s.m = s.g + N * Hd;
  s.ln = s.m + N * E;
  return s;
}

// The backward of `nl` layers, one CTA per row, layers top-down: each layer's
// forward recomputed from its saved input xs[l] (R, T, E), then its backward
// from the running cotangent (dy at the top), carried in shared memory; the
// weight gradients' pairs go to workspace slot l. dy and dx may be the same
// buffer (each CTA reads its row before it writes it).
__global__ void __launch_bounds__(kThreads)
trunk_backward_rows(const float* __restrict__ xs, const float* dy, float* dx,
                    const __grid_constant__ Layers p, int nl, float* ws, int R, int T, int E,
                    int H, int Hd, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = 3 * E + 1, E3 = 3 * E, Hd2 = 2 * Hd, hd = E / H, ldp = T + 1;
  const float scale = 1.0f / sqrtf((float)hd);
  float* xin = smem;                   // (T, E) the layer's input
  float* x1 = xin + T * E;             // (T, E) the residual stream after the attention branch
  float* dcur = x1 + T * E;            // (T, E) the running cotangent
  float* hs = dcur + T * E;            // (T, E) staging
  float* qkv = hs + T * E;             // (T, ldq)
  float* big = qkv + T * ldq;          // (T, 2Hd) [a | b], then [da | db]; then (T, 3E) dqkv
  float* P = big + T * max(Hd2, E3);   // (H, T, T + 1) probabilities
  float* dS = P + H * T * ldp;         // (H, T, T + 1) their cotangents, then the scores'
  float* mean1 = dS + H * T * ldp;     // (T) the LayerNorms' statistics
  float* rstd1 = mean1 + T;
  float* mean2 = rstd1 + T;
  float* rstd2 = mean2 + T;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const size_t TE = (size_t)T * E;
  const size_t row = blockIdx.x;
  const size_t tok = row * T;
  for (int i = tid; i < T * E; i += nthr) dcur[i] = dy[row * TE + i];

  for (int l = nl - 1; l >= 0; --l) {
    const Slots s = slots(ws, l, R, T, E, Hd);
    const float* const* w = p.w[l];
    // ===== the forward, recomputed; the gradients' inputs to the workspace ===
    for (int i = tid; i < T * E; i += nthr) xin[i] = xs[((size_t)l * R + row) * TE + i];
    __syncthreads();
    ln_affine(xin, hs, T, E, w[kG1], w[kB1], eps, mean1, rstd1);
    __syncthreads();
    for (int i = tid; i < T * E; i += nthr) s.h[tok * E + i] = hs[i];
    linear<1>(hs, E, w[kQkv], nullptr, E3, T,
              [&](int t, int n, float a, float) { qkv[t * ldq + n] = a; });
    __syncthreads();
    attention(qkv, ldq, P, hs, T, E, H);
    for (int i = tid; i < T * E; i += nthr) s.attn[tok * E + i] = hs[i];
    linear<1>(hs, E, w[kProj], nullptr, E, T,
              [&](int t, int n, float a, float) { x1[t * E + n] = xin[t * E + n] + a; });
    __syncthreads();
    ln_affine(x1, hs, T, E, w[kG2], w[kB2], eps, mean2, rstd2);
    __syncthreads();
    for (int i = tid; i < T * E; i += nthr) s.h2[tok * E + i] = hs[i];
    linear<2>(hs, E, w[kW1], w[kW2], Hd, T, [&](int t, int n, float a, float b) {
      big[t * Hd2 + n] = a;
      big[t * Hd2 + Hd + n] = b;
      s.g[(tok + t) * Hd + n] = silu(a) * b;
    });
    __syncthreads();

    // ===== the backward ========================================================
    // y = x1 + g @ wmlp^T: dm = dy, dx1 starts at dy; dg = dm @ wmlp, then
    // da = dg * b * silu'(a), db = dg * silu(a)
    for (int i = tid; i < T * E; i += nthr) s.m[tok * E + i] = dcur[i];
    linear_t<1>(dcur, nullptr, E, E, w[kMlp], nullptr, Hd, T, [&](int t, int j, float dg) {
      const float a = big[t * Hd2 + j], b = big[t * Hd2 + Hd + j];
      const float sg = sigmoid(a);
      const float da = dg * b * sg * (1.0f + a * (1.0f - sg));
      const float db = dg * a * sg;
      big[t * Hd2 + j] = da;
      big[t * Hd2 + Hd + j] = db;
      s.dab[(tok + t) * Hd2 + j] = da;
      s.dab[(tok + t) * Hd2 + Hd + j] = db;
    });
    __syncthreads();
    // dh2 = da @ w1 + db @ w2, then the second LayerNorm's backward into dx1
    linear_t<2>(big, big + Hd, Hd2, Hd, w[kW1], w[kW2], E, T,
                [&](int t, int k, float v) { hs[t * E + k] = v; });
    __syncthreads();
    ln_affine_bwd(hs, x1, mean2, rstd2, w[kG2], T, E, s.ln + row * 4 * E + 2 * E, dcur);
    __syncthreads();
    // x1 = x + attn @ wproj^T: dproj = dx1, d(attention output) = dproj @ wproj
    for (int i = tid; i < T * E; i += nthr) s.dproj[tok * E + i] = dcur[i];
    linear_t<1>(dcur, nullptr, E, E, w[kProj], nullptr, E, T,
                [&](int t, int k, float v) { hs[t * E + k] = v; });
    __syncthreads();
    // attention: dP = do v^T, dS = P * (dP - rowsum(dP * P))
    for (int idx = tid; idx < H * T * T; idx += nthr) {
      const int h = idx / (T * T), i = (idx / T) % T, j = idx % T;
      const float* o = hs + i * E + h * hd;
      const float* v = qkv + j * ldq + 2 * E + h * hd;
      float sum = 0.0f;
      for (int d = 0; d < hd; ++d) sum = fmaf(o[d], v[d], sum);
      dS[(h * T + i) * ldp + j] = sum;
    }
    __syncthreads();
    for (int r = tid; r < H * T; r += nthr) {
      const float* pr = P + r * ldp;
      float* d = dS + r * ldp;
      float dot = 0.0f;
      for (int j = 0; j < T; ++j) dot = fmaf(pr[j], d[j], dot);
      for (int j = 0; j < T; ++j) d[j] = pr[j] * (d[j] - dot);
    }
    __syncthreads();
    // dq = scale dS k, dk = scale dS^T q, dv = P^T do
    for (int idx = tid; idx < T * E; idx += nthr) {
      const int t = idx / E, col = idx % E, h = col / hd;
      float dq = 0.0f, dk = 0.0f, dv = 0.0f;
      for (int j = 0; j < T; ++j) {
        dq = fmaf(dS[(h * T + t) * ldp + j], qkv[j * ldq + E + col], dq);
        dk = fmaf(dS[(h * T + j) * ldp + t], qkv[j * ldq + col], dk);
        dv = fmaf(P[(h * T + j) * ldp + t], hs[j * E + col], dv);
      }
      big[t * E3 + col] = dq * scale;
      big[t * E3 + E + col] = dk * scale;
      big[t * E3 + 2 * E + col] = dv;
      float* o = s.dqkv + (tok + t) * E3 + col;
      o[0] = dq * scale;
      o[E] = dk * scale;
      o[2 * E] = dv;
    }
    __syncthreads();
    // dh = dqkv @ wqkv, then the first LayerNorm's backward into dx
    linear_t<1>(big, nullptr, E3, E3, w[kQkv], nullptr, E, T,
                [&](int t, int k, float v) { hs[t * E + k] = v; });
    __syncthreads();
    ln_affine_bwd(hs, xin, mean1, rstd1, w[kG1], T, E, s.ln + row * 4 * E, dcur);
    __syncthreads();
  }
  for (int i = tid; i < T * E; i += nthr) dx[row * TE + i] = dcur[i];
}

// Floats of one layer's gradients in the gradient buffer: [dg1 | db1 | dg2 |
// db2] (4E), dwqkv (3E, E), dwproj (E, E), dw1 and dw2 (Hd, E each), dwmlp
// (E, Hd), each in its parameter's layout.
inline size_t grad_floats(int E, int Hd) {
  return 4 * (size_t)E + 4 * (size_t)E * E + 3 * (size_t)Hd * E;
}

Layers layer_table(const void* const* weights, int l0, int nl) {
  Layers p = {};
  for (int l = 0; l < nl; ++l)
    for (int k = 0; k < kNames; ++k) p.w[l][k] = (const float*)weights[(l0 + l) * kNames + k];
  return p;
}

SmemAllowance g_fwd_smem, g_save_smem, g_bwd_smem;

}  // namespace

extern "C" {

// Launches the trunk's forward on `stream`, on the current device: one CTA
// of 256 threads per row, one launch per kMaxLayers layers. `weights` holds
// 9 * L pointers, layer by layer in TRUNK_WEIGHT_NAMES order. With `xs`
// (L, R, T, E) given, each layer's input is saved there. Returns the first
// CUDA error code (0 on success). Allocates nothing and does not synchronise.
int scldm_fused_trunk_forward(const void* x, const void* const* weights, void* out, void* xs,
                              int R, int T, int E, int H, int Hd, int L, float eps,
                              void* stream) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long smem = 4LL * fwd_floats(T, E, H, Hd);
  cudaError_t err;
  if ((err = xs != nullptr ? allow_smem(trunk_forward<true>, smem, g_save_smem)
                           : allow_smem(trunk_forward<false>, smem, g_fwd_smem)) != cudaSuccess)
    return (int)err;
  const float* in = (const float*)x;
  for (int l0 = 0; l0 < L; l0 += kMaxLayers) {
    const int nl = std::min(kMaxLayers, L - l0);
    const Layers p = layer_table(weights, l0, nl);
    if (xs != nullptr)
      trunk_forward<true><<<R, kThreads, smem, s>>>(
          in, (float*)out, (float*)xs + (size_t)l0 * R * T * E, p, nl, R, T, E, H, Hd, eps);
    else
      trunk_forward<false><<<R, kThreads, smem, s>>>(in, (float*)out, nullptr, p, nl, R, T, E,
                                                     H, Hd, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    in = (const float*)out;
  }
  return 0;
}

// Launches the trunk's backward on `stream`, on the current device: per
// kMaxLayers layers, top-down, the row kernel (one CTA of 256 threads per
// row) and the weight-gradient kernel. xs (L, R, T, E) holds each layer's
// input, as the saving forward wrote it; `weights` as for the forward. dx
// (R, T, E) and dw (L layers of grad_floats() each) are written whole.
// `workspace` holds min(L, kMaxLayers) * layer_floats() floats. Returns the
// first CUDA error code (0 on success). Allocates nothing and does not
// synchronise.
int scldm_fused_trunk_backward(const void* xs, const void* const* weights, const void* dy,
                               void* dx, void* dw, void* workspace, int R, int T, int E, int H,
                               int Hd, int L, float eps, void* stream) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long smem = 4LL * bwd_floats(T, E, H, Hd);
  cudaError_t err;
  if ((err = allow_smem(trunk_backward_rows, smem, g_bwd_smem)) != cudaSuccess) return (int)err;
  float* ws = (float*)workspace;
  const int N = R * T;
  const float* cot = (const float*)dy;
  for (int l0 = ((L - 1) / kMaxLayers) * kMaxLayers; l0 >= 0; l0 -= kMaxLayers) {
    const int nl = std::min(kMaxLayers, L - l0);
    trunk_backward_rows<<<R, kThreads, smem, s>>>(
        (const float*)xs + (size_t)l0 * R * T * E, cot, (float*)dx, layer_table(weights, l0, nl),
        nl, ws, R, T, E, H, Hd, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dit::GradJobs<kJobs> jobs;
    jobs.n = 0;
    for (int i = 0; i < nl; ++i) {
      const Slots sl = slots(ws, i, R, T, E, Hd);
      float* g = (float*)dw + (size_t)(l0 + i) * grad_floats(E, Hd);
      float* gqkv = g + 4 * E;
      float* gproj = gqkv + 3 * E * E;
      float* g12 = gproj + E * E;
      float* gmlp = g12 + 2 * Hd * E;
      const dit::GradJob layer[5] = {
          {sl.dqkv, sl.h, gqkv, nullptr, 3 * E, E, N, 0, 0},
          {sl.dproj, sl.attn, gproj, nullptr, E, E, N, 0, 0},
          {sl.dab, sl.h2, g12, nullptr, 2 * Hd, E, N, 0, 0},
          {sl.m, sl.g, gmlp, nullptr, E, Hd, N, 0, 0},
          {sl.ln, nullptr, nullptr, g, 4 * E, 1, R, 0, 0},  // column sums: the LN affine grads
      };
      for (const dit::GradJob& jb : layer) jobs.job[jobs.n++] = jb;
    }
    const int tiles = dit::plan_grad_jobs(jobs);
    dit::weight_grads<kJobs><<<tiles, 256, 0, s>>>(jobs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    cot = (const float*)dx;
  }
  return 0;
}

}  // extern "C"
