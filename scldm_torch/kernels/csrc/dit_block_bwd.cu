// The recompute backward of one adaLN-zero DiT block, f32: a row kernel where
// a row fits one CTA, seven kernels where it does not, then one for the
// weight gradients.
//
// Replaces the TPU kernel scldm_tpu/ops/fused_dit.py::_bwd_pallas (Pallas body
// `_block_bwd_kernel`, the in-kernel jax.vjp of `_block_math`): given x (R, T,
// E), c (R, E), the nine weights and dy (R, T, E), it computes dx, dc and the
// nine weight gradients, summed over every row. The forward it differentiates
// is dit_block.cu's:
//
//   mod = silu(c) @ wada + bada  -> scale_a, shift_a, gate_a, scale_m, shift_m, gate_m
//   h   = LN(x) * (1 + scale_a) + shift_a
//   x1  = x + gate_a * (attn(h @ wqkv + bqkv) @ wproj + bproj)
//   h2  = LN(x1) * (1 + scale_m) + shift_m
//   y   = x1 + gate_m * ((silu(h2 @ w1) * (h2 @ w2)) @ wmlp)
//
// What bounds it on an H100: f32 FMA. The recompute and the backward are
// about three times the forward's operations (10 GFLOP per block at the
// dentate LDM step's R=128 rows of T=16 tokens, E=256, Hd=684; 5 GFLOP at
// the census step's R=16 rows of T=64), against 4.7 MB of weights read and
// 4.7 MB of gradients written.
//
// What the design does about it. Both designs keep every per-token
// intermediate the weight gradients need in a device workspace (`carve`
// below; dit_block_bwd_workspace_floats() in scldm_torch/ops/fused_dit.py),
// so that the gradients, sums over all R*T tokens, are not summed by the
// CTAs that own the rows. The wrapper picks the design by shared memory, as
// for the forward. The row design (dit_block_bwd_rows), where a row fits one
// CTA (the dentate T=16: 112 KB), recomputes the forward and runs the
// backward for dx and dc with the whole row in shared memory; at T=16 it is
// the faster of the two (PERF.md, section 6). A census row does not fit (its
// scores and their cotangents alone take 262 KB), so the split design takes
// the forward's split (dit_common.cuh):
//   1. rows_gemm: mod (and silu(c)) for kRowTile rows per CTA;
//   2. ln_qkv: per (row, token tile): h and qkv;
//   3. attention: per (row, head): the attention output;
//   4. mlp_bwd: per (row, token tile): the rest of the forward (proj, x1, h2,
//      [a | b], g), then the backward from dy to d(attention output): dm,
//      [da | db], dx1 (into dx), dproj; its share of dmod's sums over tokens
//      goes to a per-tile partial;
//   5. attention_bwd: per (row, head): the probabilities recomputed, then dq,
//      dk and dv over q, k and v in the workspace;
//   6. qkv_bwd: per (row, token tile): dh = dqkv @ wqkv^T, the first
//      modulation's and LayerNorm's backward (into dx and the partials);
//   7. rows_gemm: dmod, the per-tile partials summed in order, and dc.
// Then, for both, dit_common.cuh's weight_grads: every weight gradient in one
// launch, a tiled U^T V over the token (or row) axis per gradient, 64x64
// outputs per CTA, 4x4 per thread, 16 tokens per shared-memory stage; the
// bias gradients are the column sums of U, taken by the CTAs of the first
// column tile. The gradients come out in nn.Linear's (out, in) layout.
// No atomics: every sum is taken in a fixed order. Products against a
// transposed weight read the weight in nn.Linear's (out, in) layout, so that
// one thread per output column reads it with coalesced loads, as the forward
// products read the (in, out) layout. The tensor cores are not used yet.
//
// Shared memory per CTA, in floats: the row kernel 2*T*E + T*max(3E, Hd) +
// 2*H*T*T + 13E + 4T; the split's rows_gemm kRowTile*K + 2048 (K = E, then
// 6E); ln_qkv kTok*E; attention 2*T*hd + T*(hd + 1) + T*T; mlp_bwd
// kTok*(2E + Hd) + 2*kTok; attention_bwd 2*T*hd + 2*T*(hd + 1) + 2*T*T;
// qkv_bwd kTok*5E + 2*kTok. Requires E % 4 == 0, Hd % 4 == 0 and E % H == 0
// (the wrapper checks).

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
using dit::sigmoid;
using dit::silu;
using dit::SmemAllowance;
using dit::warp_sum;

// The workspace's slots, each (tokens, width) row-major, or (rows, width).
struct Workspace {
  float* h;      // (N, E)   h, the input of wqkv
  float* qkv;    // (N, 3E)  qkv, then dqkv
  float* attn;   // (N, E)   attention output, the input of wproj
  float* proj;   // (N, E)   attn @ wproj + bproj, then dproj
  float* h2;     // (N, E)   h2, the input of w1 and w2
  float* ab;     // (N, 2Hd) [a | b], then [da | db]
  float* g;      // (N, Hd)  silu(a) * b, the input of wmlp
  float* m;      // (N, E)   dm
  float* dattn;  // (N, E)   d(attention output)
  float* cs;     // (R, E)   silu(c), the input of wada
  float* mod;    // (R, 6E)  mod, then dmod
  float* parts;  // (R, nt, 6E) each token tile's share of dmod
};

__host__ __device__ inline Workspace carve(float* ws, int R, int T, int E, int Hd) {
  const size_t N = (size_t)R * T;
  Workspace w;
  w.h = ws;
  w.qkv = w.h + N * E;
  w.attn = w.qkv + N * 3 * E;
  w.proj = w.attn + N * E;
  w.h2 = w.proj + N * E;
  w.ab = w.h2 + N * E;
  w.g = w.ab + N * 2 * Hd;
  w.m = w.g + N * Hd;
  w.dattn = w.m + N * E;
  w.cs = w.dattn + N * E;
  w.mod = w.cs + (size_t)R * E;
  w.parts = w.mod + (size_t)R * 6 * E;
  return w;
}

// The (row, token tile) of a token-wise CTA, grid R * ceil(T / kTok).
struct TokenTile {
  int row, tile, t0, tn;
  size_t tok;  // the tile's first token
};

__device__ inline TokenTile token_tile(int T) {
  const int nt = (T + kTok - 1) / kTok;
  TokenTile tt;
  tt.row = blockIdx.x / nt;
  tt.tile = blockIdx.x % nt;
  tt.t0 = tt.tile * kTok;
  tt.tn = min(kTok, T - tt.t0);
  tt.tok = (size_t)tt.row * T + tt.t0;
  return tt;
}

// The mean and 1/sqrt(var + eps) of each of the T rows of src (T, E), one
// warp per row, as ln_modulate takes them.
__device__ void ln_stats(const float* src, int T, int E, float eps, float* mean,
                         float* rstd) {
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
    if (lane == 0) {
      mean[t] = mu;
      rstd[t] = inv;
    }
  }
}

// dscale[e] = sum_t d[t, e] * xhat[t, e], dshift[e] = sum_t d[t, e], and d
// becomes d * (1 + scale): the modulation's backward, one thread per column.
// xhat[t, e] = (src[t, e] - mean[t]) * rstd[t].
__device__ void modulate_bwd(float* d, const float* src, const float* mean,
                             const float* rstd, const float* scale, int T, int E,
                             float* dscale, float* dshift) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float ds = 0.0f, dh = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float xh = (src[t * E + e] - mean[t]) * rstd[t];
      const float v = d[t * E + e];
      ds = fmaf(v, xh, ds);
      dh += v;
      d[t * E + e] = v * (1.0f + scale[e]);
    }
    dscale[e] = ds;
    dshift[e] = dh;
  }
}

// acc[t, :] += rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)): the
// non-affine LayerNorm's backward, one warp per token. `acc` is in global memory.
__device__ void layernorm_bwd(const float* dxh, const float* src, const float* mean,
                              const float* rstd, int T, int E, float* acc) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < T; t += n_warps) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int e = lane; e < E; e += 32) {
      const float xh = (src[t * E + e] - mean[t]) * rstd[t];
      const float d = dxh[t * E + e];
      s1 += d;
      s2 = fmaf(d, xh, s2);
    }
    s1 = warp_sum(s1) / E;
    s2 = warp_sum(s2) / E;
    for (int e = lane; e < E; e += 32) {
      const float xh = (src[t * E + e] - mean[t]) * rstd[t];
      acc[t * E + e] += rstd[t] * (dxh[t * E + e] - s1 - xh * s2);
    }
  }
}

// The row design: one CTA per row recomputes the forward and runs the
// backward for dx and dc with the row's whole working set in shared memory
// (x then x1, a staging tile, a wide staging tile, the probabilities and the
// score cotangents, silu(c), mod, dmod, the LayerNorm statistics), writing
// the same workspace slots as the kernels below and dmod straight to w.mod.
// Taken where a row fits one CTA (the dentate DiT's T = 16): there it is
// faster than the split below.
__global__ void __launch_bounds__(kThreads, 2)
dit_block_bwd_rows(const float* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ wada, const float* __restrict__ bada,
                   const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                   const float* __restrict__ wproj, const float* __restrict__ bproj,
                   const float* __restrict__ w1, const float* __restrict__ w2,
                   const float* __restrict__ wmlp, const float* __restrict__ wada_t,
                   const float* __restrict__ wqkv_t, const float* __restrict__ wproj_t,
                   const float* __restrict__ w1_t, const float* __restrict__ w2_t,
                   const float* __restrict__ wmlp_t, const float* __restrict__ dy,
                   float* __restrict__ dx, float* __restrict__ dc, float* ws, int R,
                   int T, int E, int H, int Hd, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int wide = max(3 * E, Hd);
  const int E3 = 3 * E, E6 = 6 * E, Hd2 = 2 * Hd;
  float* xs = smem;               // (T, E) x, then x1, then d(attention output)
  float* hs = xs + T * E;         // (T, E) staging
  float* big = hs + T * E;        // (T, wide) staging
  float* P = big + T * wide;      // (H, T, T) attention probabilities
  float* dS = P + H * T * T;      // (H, T, T) their cotangents, then the scores'
  float* cs = dS + H * T * T;     // (E) silu(c)
  float* mods = cs + E;           // (6E) modulation
  float* dmods = mods + E6;       // (6E) its cotangent
  float* mean1 = dmods + E6;      // (T) LayerNorm statistics
  float* rstd1 = mean1 + T;
  float* mean2 = rstd1 + T;
  float* rstd2 = mean2 + T;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t row = blockIdx.x;
  const size_t tok = row * T;
  const Workspace w = carve(ws, R, T, E, Hd);
  float* Wh = w.h + tok * E;
  float* Wqkv = w.qkv + tok * E3;
  float* Wattn = w.attn + tok * E;
  float* Wproj = w.proj + tok * E;
  float* Wh2 = w.h2 + tok * E;
  float* Wab = w.ab + tok * Hd2;
  float* Wg = w.g + tok * Hd;
  float* Wm = w.m + tok * E;
  const float* xr = x + tok * E;
  const float* dyr = dy + tok * E;
  float* dxr = dx + tok * E;  // also the running cotangent of x1

  // ===== the forward, recomputed; residuals to the workspace =================
  for (int i = tid; i < T * E; i += nthr) xs[i] = xr[i];
  for (int i = tid; i < E; i += nthr) {
    const float s = silu(c[row * E + i]);
    cs[i] = s;
    w.cs[row * E + i] = s;
  }
  __syncthreads();
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

  ln_modulate(xs, hs, T, E, scale_a, shift_a, eps, mean1, rstd1);
  __syncthreads();

  for (int i = tid; i < T * E; i += nthr) Wh[i] = hs[i];
  for (int n = tid; n < E3; n += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(hs, E, t0, tn, wqkv, nullptr, E3, n, acc);
      const float b = bqkv[n];
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) {
          big[(t0 + i) * E3 + n] = acc[0][i] + b;
          Wqkv[(t0 + i) * E3 + n] = acc[0][i] + b;
        }
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
    P[idx] = s * qk_scale;
  }
  __syncthreads();
  for (int r = tid; r < H * T; r += nthr) {
    float* p = P + r * T;
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
    const float* p = P + ((col / hd) * T + i) * T;
    const float* v = big + 2 * E + col;
    float s = 0.0f;
    for (int j = 0; j < T; ++j) s = fmaf(p[j], v[j * E3], s);
    hs[idx] = s;
    Wattn[idx] = s;
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
        if (i < tn) {
          const float pv = acc[0][i] + b;
          Wproj[(t0 + i) * E + n] = pv;
          xs[(t0 + i) * E + n] += g * pv;
        }
    }
  }
  __syncthreads();

  ln_modulate(xs, hs, T, E, scale_m, shift_m, eps, mean2, rstd2);
  __syncthreads();

  for (int i = tid; i < T * E; i += nthr) Wh2[i] = hs[i];
  for (int n = tid; n < Hd; n += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[2][kTok];
      dot_tile<2>(hs, E, t0, tn, w1, w2, Hd, n, acc);
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) {
          const int t = t0 + i;
          Wab[t * Hd2 + n] = acc[0][i];
          Wab[t * Hd2 + Hd + n] = acc[1][i];
          const float gv = silu(acc[0][i]) * acc[1][i];
          big[t * Hd + n] = gv;
          Wg[t * Hd + n] = gv;
        }
    }
  }
  __syncthreads();

  for (int n = tid; n < E; n += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(big, Hd, t0, tn, wmlp, nullptr, E, n, acc);
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) Wm[(t0 + i) * E + n] = acc[0][i];
    }
  }
  __syncthreads();

  // ===== the backward ============================================================
  // y = x1 + gate_m * m: dx1 = dy, dgate_m = sum_t dy * m, dm = dy * gate_m
  for (int e = tid; e < E; e += nthr) {
    float dg = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float d = dyr[t * E + e];
      dg = fmaf(d, Wm[t * E + e], dg);
      const float dm = d * gate_m[e];
      Wm[t * E + e] = dm;
      hs[t * E + e] = dm;
      dxr[t * E + e] = d;
    }
    dmods[5 * E + e] = dg;
  }
  __syncthreads();

  // dg = dm @ wmlp^T; da = dg * b * silu'(a), db = dg * silu(a)
  for (int j = tid; j < Hd; j += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(hs, E, t0, tn, wmlp_t, nullptr, Hd, j, acc);
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) {
          const int t = t0 + i;
          const float a = Wab[t * Hd2 + j];
          const float b = Wab[t * Hd2 + Hd + j];
          const float sg = sigmoid(a);
          const float da = acc[0][i] * b * sg * (1.0f + a * (1.0f - sg));
          Wab[t * Hd2 + j] = da;
          Wab[t * Hd2 + Hd + j] = acc[0][i] * a * sg;
          big[t * Hd + j] = da;
        }
    }
  }
  __syncthreads();

  // dh2 = da @ w1^T + db @ w2^T, one staged input at a time
  for (int e = tid; e < E; e += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(big, Hd, t0, tn, w1_t, nullptr, E, e, acc);
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) hs[(t0 + i) * E + e] = acc[0][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < T * Hd; i += nthr) big[i] = Wab[(i / Hd) * Hd2 + Hd + i % Hd];
  __syncthreads();
  for (int e = tid; e < E; e += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(big, Hd, t0, tn, w2_t, nullptr, E, e, acc);
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) hs[(t0 + i) * E + e] += acc[0][i];
    }
  }
  __syncthreads();

  // the second modulation and LayerNorm
  modulate_bwd(hs, xs, mean2, rstd2, scale_m, T, E, dmods + 3 * E, dmods + 4 * E);
  __syncthreads();
  layernorm_bwd(hs, xs, mean2, rstd2, T, E, dxr);
  __syncthreads();

  // x1 = x + gate_a * proj: dgate_a = sum_t dx1 * proj, dproj = dx1 * gate_a;
  // meanwhile qkv comes back into shared memory
  for (int e = tid; e < E; e += nthr) {
    float dg = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float d = dxr[t * E + e];
      dg = fmaf(d, Wproj[t * E + e], dg);
      const float dp = d * gate_a[e];
      Wproj[t * E + e] = dp;
      hs[t * E + e] = dp;
    }
    dmods[2 * E + e] = dg;
  }
  for (int i = tid; i < T * E3; i += nthr) big[i] = Wqkv[i];
  __syncthreads();

  // d(attention output) = dproj @ wproj^T, into xs (x1 is no longer needed)
  for (int e = tid; e < E; e += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(hs, E, t0, tn, wproj_t, nullptr, E, e, acc);
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) xs[(t0 + i) * E + e] = acc[0][i];
    }
  }
  __syncthreads();

  // attention: dP = do v^T, dS = P * (dP - rowsum(dP * P))
  for (int idx = tid; idx < H * T * T; idx += nthr) {
    const int h = idx / (T * T);
    const int i = (idx / T) % T;
    const int j = idx % T;
    const float* o = xs + i * E + h * hd;
    const float* v = big + j * E3 + 2 * E + h * hd;
    float s = 0.0f;
    for (int d = 0; d < hd; ++d) s = fmaf(o[d], v[d], s);
    dS[idx] = s;
  }
  __syncthreads();
  for (int r = tid; r < H * T; r += nthr) {
    const float* p = P + r * T;
    float* d = dS + r * T;
    float dot = 0.0f;
    for (int j = 0; j < T; ++j) dot = fmaf(p[j], d[j], dot);
    for (int j = 0; j < T; ++j) d[j] = p[j] * (d[j] - dot);
  }
  __syncthreads();
  // dq = scale dS k, dk = scale dS^T q, dv = P^T do, to the workspace
  for (int idx = tid; idx < T * E; idx += nthr) {
    const int t = idx / E;
    const int col = idx % E;
    const int h = col / hd;
    const float* ds_row = dS + (h * T + t) * T;  // dS[h, t, :]
    const float* ds_col = dS + h * T * T + t;    // dS[h, :, t], stride T
    const float* p_col = P + h * T * T + t;
    float dq = 0.0f, dk = 0.0f, dv = 0.0f;
    for (int j = 0; j < T; ++j) {
      dq = fmaf(ds_row[j], big[j * E3 + E + col], dq);
      dk = fmaf(ds_col[j * T], big[j * E3 + col], dk);
      dv = fmaf(p_col[j * T], xs[j * E + col], dv);
    }
    Wqkv[t * E3 + col] = dq * qk_scale;
    Wqkv[t * E3 + E + col] = dk * qk_scale;
    Wqkv[t * E3 + 2 * E + col] = dv;
  }
  __syncthreads();
  for (int i = tid; i < T * E3; i += nthr) big[i] = Wqkv[i];
  __syncthreads();

  // dh = dqkv @ wqkv^T
  for (int e = tid; e < E; e += nthr) {
    for (int t0 = 0; t0 < T; t0 += kTok) {
      const int tn = min(kTok, T - t0);
      float acc[1][kTok];
      dot_tile<1>(big, E3, t0, tn, wqkv_t, nullptr, E, e, acc);
#pragma unroll
      for (int i = 0; i < kTok; ++i)
        if (i < tn) hs[(t0 + i) * E + e] = acc[0][i];
    }
  }
  __syncthreads();

  // the first modulation and LayerNorm (x is read again from the input)
  modulate_bwd(hs, xr, mean1, rstd1, scale_a, T, E, dmods, dmods + E);
  __syncthreads();
  layernorm_bwd(hs, xr, mean1, rstd1, T, E, dxr);

  // mod = silu(c) @ wada + bada: dc = (dmod @ wada^T) * silu'(c)
  for (int n = tid; n < E6; n += nthr) w.mod[row * E6 + n] = dmods[n];
  for (int e = tid; e < E; e += nthr) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = 0; n < E6; n += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = fmaf(dmods[n + j], __ldg(wada_t + (size_t)(n + j) * E + e), acc[j]);
    }
    const float cv = c[row * E + e];
    const float sg = sigmoid(cv);
    dc[row * E + e] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) * sg * (1.0f + cv * (1.0f - sg));
  }
}

// Per (row, token tile): the forward from the attention output on (its
// residuals to the workspace), then the backward from dy down to
// d(attention output). dx gets dx1 = dy + the second LayerNorm's backward;
// this tile's sums over its tokens of dgate_a, dscale_m, dshift_m and
// dgate_m go to its partial of dmod.
__global__ void __launch_bounds__(kThreads, 2)
mlp_bwd(const float* __restrict__ x, const float* __restrict__ dy,
        const float* __restrict__ wproj, const float* __restrict__ bproj,
        const float* __restrict__ w1, const float* __restrict__ w2,
        const float* __restrict__ wmlp, const float* __restrict__ wproj_t,
        const float* __restrict__ w1_t, const float* __restrict__ w2_t,
        const float* __restrict__ wmlp_t, float* __restrict__ dx, const Workspace w, int T,
        int E, int Hd, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // (kTok, E) x, then x1
  float* hs = xs + kTok * E;       // (kTok, E) staging
  float* big = hs + kTok * E;      // (kTok, Hd) staging
  float* mean2 = big + kTok * Hd;  // (kTok) the second LayerNorm's statistics
  float* rstd2 = mean2 + kTok;

  const int tid = threadIdx.x;
  const TokenTile tt = token_tile(T);
  const int tn = tt.tn;
  const int Hd2 = 2 * Hd;
  const int nt = (T + kTok - 1) / kTok;
  const float* mrow = w.mod + (size_t)tt.row * 6 * E;
  const float* gate_a = mrow + 2 * E;
  const float* scale_m = mrow + 3 * E;
  const float* shift_m = mrow + 4 * E;
  const float* gate_m = mrow + 5 * E;
  float* part = w.parts + ((size_t)tt.row * nt + tt.tile) * 6 * E;
  const float* Wattn = w.attn + tt.tok * E;
  float* Wproj = w.proj + tt.tok * E;
  float* Wh2 = w.h2 + tt.tok * E;
  float* Wab = w.ab + tt.tok * Hd2;
  float* Wg = w.g + tt.tok * Hd;
  float* Wm = w.m + tt.tok * E;
  float* Wdattn = w.dattn + tt.tok * E;
  const float* xr = x + tt.tok * E;
  const float* dyr = dy + tt.tok * E;
  float* dxr = dx + tt.tok * E;  // the running cotangent of x1, then of x

  // ===== the forward, recomputed; residuals to the workspace =================
  for (int i = tid; i < tn * E; i += kThreads) {
    xs[i] = xr[i];
    hs[i] = Wattn[i];
  }
  __syncthreads();
  for (int n = tid; n < E; n += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(hs, E, 0, tn, wproj, nullptr, E, n, acc);
    const float b = bproj[n];
    const float g = gate_a[n];
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) {
        const float pv = acc[0][i] + b;
        Wproj[i * E + n] = pv;
        xs[i * E + n] += g * pv;
      }
  }
  __syncthreads();

  ln_modulate(xs, hs, tn, E, scale_m, shift_m, eps, mean2, rstd2);
  __syncthreads();

  for (int i = tid; i < tn * E; i += kThreads) Wh2[i] = hs[i];
  for (int n = tid; n < Hd; n += kThreads) {
    float acc[2][kTok];
    dot_tile<2>(hs, E, 0, tn, w1, w2, Hd, n, acc);
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) {
        Wab[i * Hd2 + n] = acc[0][i];
        Wab[i * Hd2 + Hd + n] = acc[1][i];
        const float gv = silu(acc[0][i]) * acc[1][i];
        big[i * Hd + n] = gv;
        Wg[i * Hd + n] = gv;
      }
  }
  __syncthreads();

  // ===== the backward ============================================================
  // m = g @ wmlp and y = x1 + gate_m * m: dgate_m = sum_t dy * m, dm = dy *
  // gate_m, and dx1 starts at dy
  for (int n = tid; n < E; n += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(big, Hd, 0, tn, wmlp, nullptr, E, n, acc);
    float dg = 0.0f;
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) {
        const float d = dyr[i * E + n];
        dg = fmaf(d, acc[0][i], dg);
        const float dm = d * gate_m[n];
        Wm[i * E + n] = dm;
        hs[i * E + n] = dm;
        dxr[i * E + n] = d;
      }
    part[5 * E + n] = dg;
  }
  __syncthreads();

  // dg = dm @ wmlp^T; da = dg * b * silu'(a), db = dg * silu(a)
  for (int j = tid; j < Hd; j += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(hs, E, 0, tn, wmlp_t, nullptr, Hd, j, acc);
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) {
        const float a = Wab[i * Hd2 + j];
        const float b = Wab[i * Hd2 + Hd + j];
        const float sg = sigmoid(a);
        const float da = acc[0][i] * b * sg * (1.0f + a * (1.0f - sg));
        Wab[i * Hd2 + j] = da;
        Wab[i * Hd2 + Hd + j] = acc[0][i] * a * sg;
        big[i * Hd + j] = da;
      }
  }
  __syncthreads();

  // dh2 = da @ w1^T + db @ w2^T, one staged input at a time
  for (int e = tid; e < E; e += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(big, Hd, 0, tn, w1_t, nullptr, E, e, acc);
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) hs[i * E + e] = acc[0][i];
  }
  __syncthreads();
  for (int i = tid; i < tn * Hd; i += kThreads) big[i] = Wab[(i / Hd) * Hd2 + Hd + i % Hd];
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(big, Hd, 0, tn, w2_t, nullptr, E, e, acc);
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) hs[i * E + e] += acc[0][i];
  }
  __syncthreads();

  // the second modulation and LayerNorm
  modulate_bwd(hs, xs, mean2, rstd2, scale_m, tn, E, part + 3 * E, part + 4 * E);
  __syncthreads();
  layernorm_bwd(hs, xs, mean2, rstd2, tn, E, dxr);
  __syncthreads();

  // x1 = x + gate_a * proj: dgate_a = sum_t dx1 * proj, dproj = dx1 * gate_a
  for (int e = tid; e < E; e += kThreads) {
    float dg = 0.0f;
    for (int i = 0; i < tn; ++i) {
      const float d = dxr[i * E + e];
      dg = fmaf(d, Wproj[i * E + e], dg);
      const float dp = d * gate_a[e];
      Wproj[i * E + e] = dp;
      hs[i * E + e] = dp;
    }
    part[2 * E + e] = dg;
  }
  __syncthreads();

  // d(attention output) = dproj @ wproj^T
  for (int e = tid; e < E; e += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(hs, E, 0, tn, wproj_t, nullptr, E, e, acc);
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) Wdattn[i * E + e] = acc[0][i];
  }
}

// Per (row, head), grid R * H: the attention's backward. The probabilities
// are recomputed from q and k; dP = do v^T, dS = P * (dP - rowsum(dP * P)),
// then dq = scale dS k, dk = scale dS^T q and dv = P^T do overwrite this
// head's q, k and v in the workspace.
__global__ void __launch_bounds__(kThreads)
attention_bwd(const Workspace w, int T, int E, int H) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = E / H, E3 = 3 * E, ldk = hd + 1;
  float* qs = smem;            // (T, hd)
  float* ks = qs + T * hd;     // (T, hd + 1)
  float* vs = ks + T * ldk;    // (T, hd + 1)
  float* dos = vs + T * ldk;   // (T, hd) d(attention output)
  float* ps = dos + T * hd;    // (T, T) probabilities
  float* dS = ps + T * T;      // (T, T) their cotangents, then the scores'
  const float scale = 1.0f / sqrtf((float)hd);
  float* base = w.qkv + (size_t)row * T * E3 + h * hd;
  const float* dbase = w.dattn + (size_t)row * T * E + h * hd;
  for (int i = threadIdx.x; i < T * hd; i += kThreads) {
    const int t = i / hd, d = i % hd;
    const float* s = base + (size_t)t * E3 + d;
    qs[i] = s[0];
    ks[t * ldk + d] = s[E];
    vs[t * ldk + d] = s[2 * E];
    dos[i] = dbase[(size_t)t * E + d];
  }
  __syncthreads();
  dit::scores_softmax(qs, ks, ldk, ps, T, hd, scale);
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * T; idx += kThreads) {
    const int i = idx / T, j = idx % T;
    float s = 0.0f;
    for (int d = 0; d < hd; ++d) s = fmaf(dos[i * hd + d], vs[j * ldk + d], s);
    dS[idx] = s;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < T; i += kThreads >> 5) {
    const float* p = ps + i * T;
    float* d = dS + i * T;
    float dot = 0.0f;
    for (int j = lane; j < T; j += 32) dot = fmaf(p[j], d[j], dot);
    dot = warp_sum(dot);
    for (int j = lane; j < T; j += 32) d[j] = p[j] * (d[j] - dot);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * hd; idx += kThreads) {
    const int t = idx / hd, d = idx % hd;
    float dq = 0.0f, dk = 0.0f, dv = 0.0f;
    for (int j = 0; j < T; ++j) {
      dq = fmaf(dS[t * T + j], ks[j * ldk + d], dq);
      dk = fmaf(dS[j * T + t], qs[j * hd + d], dk);
      dv = fmaf(ps[j * T + t], dos[j * hd + d], dv);
    }
    float* o = base + (size_t)t * E3 + d;
    o[0] = dq * scale;
    o[E] = dk * scale;
    o[2 * E] = dv;
  }
}

// Per (row, token tile): dh = dqkv @ wqkv^T, then the first modulation's
// backward (this tile's dscale_a and dshift_a to its partial of dmod) and
// the first LayerNorm's, added to dx.
__global__ void __launch_bounds__(kThreads, 2)
qkv_bwd(const float* __restrict__ x, const float* __restrict__ wqkv_t,
        float* __restrict__ dx, const Workspace w, int T, int E, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int E3 = 3 * E;
  float* big = smem;               // (kTok, 3E) dqkv
  float* hs = big + kTok * E3;     // (kTok, E) dh
  float* xs = hs + kTok * E;       // (kTok, E) x
  float* mean1 = xs + kTok * E;    // (kTok) the first LayerNorm's statistics
  float* rstd1 = mean1 + kTok;
  const TokenTile tt = token_tile(T);
  const int tn = tt.tn;
  const int nt = (T + kTok - 1) / kTok;
  const float* scale_a = w.mod + (size_t)tt.row * 6 * E;
  float* part = w.parts + ((size_t)tt.row * nt + tt.tile) * 6 * E;
  for (int i = threadIdx.x; i < tn * E3; i += kThreads) big[i] = w.qkv[tt.tok * E3 + i];
  for (int i = threadIdx.x; i < tn * E; i += kThreads) xs[i] = x[tt.tok * E + i];
  __syncthreads();
  ln_stats(xs, tn, E, eps, mean1, rstd1);
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(big, E3, 0, tn, wqkv_t, nullptr, E, e, acc);
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) hs[i * E + e] = acc[0][i];
  }
  __syncthreads();
  modulate_bwd(hs, xs, mean1, rstd1, scale_a, tn, E, part, part + E);
  __syncthreads();
  layernorm_bwd(hs, xs, mean1, rstd1, tn, E, dx + tt.tok * E);
}

SmemAllowance g_row_smem, g_mod_smem, g_qkv_smem, g_attn_smem, g_mlp_smem, g_attn_bwd_smem,
    g_qkv_bwd_smem, g_dc_smem;

// The split's first seven kernels (see the top of this file).
cudaError_t split_backward(const void* x, const void* c, const void* wada, const void* bada,
                           const void* wqkv, const void* bqkv, const void* wproj,
                           const void* bproj, const void* w1, const void* w2, const void* wmlp,
                           const void* wada_t, const void* wqkv_t, const void* wproj_t,
                           const void* w1_t, const void* w2_t, const void* wmlp_t,
                           const void* dy, void* dx, void* dc, const Workspace& w, int R, int T,
                           int E, int H, int Hd, float eps, cudaStream_t s) {
  using dit::RowsIn;
  using dit::RowsOut;
  const int nt = (T + kTok - 1) / kTok;
  const int hd = E / H;
  const float* fx = (const float*)x;
  cudaError_t err;
  const long long mod_smem = 4LL * dit::rows_gemm_floats(E);
  const long long qkv_smem = 4LL * kTok * E;
  const long long attn_smem = 4LL * dit::attention_floats(T, hd);
  const long long mlp_smem = 4LL * (kTok * (2 * E + Hd) + 2 * kTok);
  const long long attn_bwd_smem = 4LL * (2 * T * hd + 2 * T * (hd + 1) + 2 * T * T);
  const long long qkv_bwd_smem = 4LL * (kTok * 5 * E + 2 * kTok);
  const long long dc_smem = 4LL * dit::rows_gemm_floats(6 * E);
  if ((err = allow_smem(dit::rows_gemm<RowsIn::kSilu, RowsOut::kBias>, mod_smem,
                        g_mod_smem)) != cudaSuccess ||
      (err = allow_smem(dit::ln_qkv, qkv_smem, g_qkv_smem)) != cudaSuccess ||
      (err = allow_smem(dit::attention, attn_smem, g_attn_smem)) != cudaSuccess ||
      (err = allow_smem(mlp_bwd, mlp_smem, g_mlp_smem)) != cudaSuccess ||
      (err = allow_smem(attention_bwd, attn_bwd_smem, g_attn_bwd_smem)) != cudaSuccess ||
      (err = allow_smem(qkv_bwd, qkv_bwd_smem, g_qkv_bwd_smem)) != cudaSuccess ||
      (err = allow_smem(dit::rows_gemm<RowsIn::kSumParts, RowsOut::kSiluGrad>, dc_smem,
                        g_dc_smem)) != cudaSuccess)
    return err;

  // ===== the forward, recomputed up to the attention output ====================
  const dim3 mod_grid((6 * E + 31) / 32, (R + kRowTile - 1) / kRowTile);
  dit::rows_gemm<RowsIn::kSilu, RowsOut::kBias><<<mod_grid, kThreads, mod_smem, s>>>(
      (const float*)c, 1, (const float*)wada, (const float*)bada, w.mod, w.cs, R, E, 6 * E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dit::ln_qkv<<<R * nt, kThreads, qkv_smem, s>>>(fx, w.mod, (const float*)wqkv,
                                                 (const float*)bqkv, w.qkv, w.h, T, E, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dit::attention<<<R * H, kThreads, attn_smem, s>>>(w.qkv, w.attn, T, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // ===== the rest of the forward and the backward ==============================
  mlp_bwd<<<R * nt, kThreads, mlp_smem, s>>>(
      fx, (const float*)dy, (const float*)wproj, (const float*)bproj, (const float*)w1,
      (const float*)w2, (const float*)wmlp, (const float*)wproj_t, (const float*)w1_t,
      (const float*)w2_t, (const float*)wmlp_t, (float*)dx, w, T, E, Hd, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd<<<R * H, kThreads, attn_bwd_smem, s>>>(w, T, E, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  qkv_bwd<<<R * nt, kThreads, qkv_bwd_smem, s>>>(fx, (const float*)wqkv_t, (float*)dx, w, T, E,
                                                 eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dmod (the tiles' partials summed in order, to w.mod) and dc = (dmod @ wada^T) * silu'(c)
  const dim3 dc_grid((E + 31) / 32, (R + kRowTile - 1) / kRowTile);
  dit::rows_gemm<RowsIn::kSumParts, RowsOut::kSiluGrad><<<dc_grid, kThreads, dc_smem, s>>>(
      w.parts, nt, (const float*)wada_t, (const float*)c, (float*)dc, w.mod, R, 6 * E, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches one block backward on `stream`, on the current device, 256
// threads a CTA: with `row_design` the row kernel (R CTAs), otherwise the
// first seven kernels of the split; then the weight-gradient kernel. The
// (in, out) weights feed the recomputed forward; the `_t` weights are the
// same matrices in nn.Linear's (out, in) layout, as are the weight gradients
// written (dw12_t holds dw1_t over dw2_t, (2Hd, E)). `workspace` holds
// dit_block_bwd_workspace_floats() floats. Every output is written whole.
// Returns the first CUDA error code (0 on success). Allocates nothing and
// does not synchronise.
int scldm_dit_block_backward(
    const void* x, const void* c, const void* wada, const void* bada, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* w1,
    const void* w2, const void* wmlp, const void* wada_t, const void* wqkv_t,
    const void* wproj_t, const void* w1_t, const void* w2_t, const void* wmlp_t,
    const void* dy, void* dx, void* dc, void* dwada_t, void* dbada, void* dwqkv_t,
    void* dbqkv, void* dwproj_t, void* dbproj, void* dw12_t, void* dwmlp_t,
    void* workspace, int R, int T, int E, int H, int Hd, float eps, int row_design,
    void* stream) {
  if (R == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Workspace w = carve((float*)workspace, R, T, E, Hd);
  cudaError_t err;
  if (row_design) {
    // x, two staging tiles, the probabilities and their cotangents, silu(c),
    // mod, dmod, the LayerNorm statistics
    const long long smem =
        4LL * (2 * T * E + T * std::max(3 * E, Hd) + 2 * H * T * T + 13 * E + 4 * T);
    if ((err = allow_smem(dit_block_bwd_rows, smem, g_row_smem)) != cudaSuccess) return (int)err;
    dit_block_bwd_rows<<<R, kThreads, smem, s>>>(
        (const float*)x, (const float*)c, (const float*)wada, (const float*)bada,
        (const float*)wqkv, (const float*)bqkv, (const float*)wproj, (const float*)bproj,
        (const float*)w1, (const float*)w2, (const float*)wmlp, (const float*)wada_t,
        (const float*)wqkv_t, (const float*)wproj_t, (const float*)w1_t, (const float*)w2_t,
        (const float*)wmlp_t, (const float*)dy, (float*)dx, (float*)dc, (float*)workspace, R, T,
        E, H, Hd, eps);
  } else if ((err = split_backward(x, c, wada, bada, wqkv, bqkv, wproj, bproj, w1, w2, wmlp,
                                   wada_t, wqkv_t, wproj_t, w1_t, w2_t, wmlp_t, dy, dx, dc, w, R,
                                   T, E, H, Hd, eps, s)) != cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int N = R * T;
  dit::GradJobs<5> jobs = {{
      {w.mod, w.cs, (float*)dwada_t, (float*)dbada, 6 * E, E, R, 0, 0},
      {w.qkv, w.h, (float*)dwqkv_t, (float*)dbqkv, 3 * E, E, N, 0, 0},
      {w.proj, w.attn, (float*)dwproj_t, (float*)dbproj, E, E, N, 0, 0},
      {w.ab, w.h2, (float*)dw12_t, nullptr, 2 * Hd, E, N, 0, 0},
      {w.m, w.g, (float*)dwmlp_t, nullptr, E, Hd, N, 0, 0},
  }, 5};
  const int tiles = dit::plan_grad_jobs(jobs);
  dit::weight_grads<5><<<tiles, 256, 0, s>>>(jobs);
  return (int)cudaGetLastError();
}

}  // extern "C"
