// The recompute backward of one adaLN-zero DiT block, f32, in two kernels.
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
// What bounds it on an H100: f32 FMA. At the LDM training step's shapes (R=128
// rows, T=16, E=256, Hd=684) the recompute and the backward are about 10 GFLOP
// per block, against 4.7 MB of weights read and 4.7 MB of gradients written.
//
// What the design does about it. The weight gradients are sums over all R*T
// tokens (dwada over the R rows), so they are not summed by the CTAs that own
// the rows, which would take one atomic add per weight entry per CTA:
//
// (a) dit_block_bwd_rows, one CTA per row, recomputes the forward and runs the
//     backward for dx and dc. It writes each token's activation and cotangent
//     pairs to a device-memory workspace: h and dqkv, attn and dproj, h2 and
//     [da | db], g = silu(a) * b and dm, and per row silu(c) and dmod. The
//     forward's residuals (qkv, a | b, proj, m) sit in the same slots until
//     their cotangents overwrite them, so the shared-memory working set stays
//     that of the forward plus the score cotangents. Products against a
//     transposed weight read the weight in nn.Linear's (out, in) layout, so
//     that one thread per output column reads it with coalesced loads, as the
//     forward products read the (in, out) layout.
// (b) dit_weight_grads, one launch for all the weight gradients: a tiled
//     U^T V over the token (or row) axis per gradient, 64x64 outputs per CTA,
//     4x4 per thread, 16 tokens per shared-memory stage; the bias gradients
//     are the column sums of U, taken by the CTAs of the first column tile.
//     The gradients come out in nn.Linear's (out, in) layout.
//
// The tensor cores (wgmma, TMA) are not used yet.
//
// Shared memory of (a), in floats: x then x1 (T*E), a staging tile (T*E), a
// wide staging tile (T*max(3E, Hd)), the probabilities and the score
// cotangents (2*H*T*T), silu(c) (E), mod (6E), dmod (6E) and the LayerNorm
// statistics (4T). scldm_torch/ops/fused_dit.py computes the same size in
// dit_block_bwd_smem_bytes() and the workspace size in
// dit_block_bwd_workspace_floats(); keep them in step with carve() below.
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
using dit::sigmoid;
using dit::silu;
using dit::warp_sum;

// The workspace's slots, each (tokens, width) row-major, or (rows, width).
struct Workspace {
  float* h;     // (N, E)   h, the input of wqkv
  float* qkv;   // (N, 3E)  qkv, then dqkv
  float* attn;  // (N, E)   attention output, the input of wproj
  float* proj;  // (N, E)   attn @ wproj + bproj, then dproj
  float* h2;    // (N, E)   h2, the input of w1 and w2
  float* ab;    // (N, 2Hd) [a | b], then [da | db]
  float* g;     // (N, Hd)  silu(a) * b, the input of wmlp
  float* m;     // (N, E)   g @ wmlp, then dm
  float* cs;    // (R, E)   silu(c), the input of wada
  float* mod;   // (R, 6E)  dmod
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
  w.cs = w.m + N * E;
  w.mod = w.cs + (size_t)R * E;
  return w;
}

// dsum[e] = sum_t d[t, e] * xhat[t, e], dshift[e] = sum_t d[t, e], and d
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

// out (P, Q) = sum_n u[n, p] * v[n, q]; bias (P) = sum_n u[n, p] when given.
struct GradJob {
  const float* u;
  const float* v;
  float* out;
  float* bias;
  int P, Q, N, tiles_q, tile0;
};

constexpr int kMaxJobs = 5;
struct GradJobs {
  GradJob job[kMaxJobs];
  int n;
};

constexpr int kTileP = 64, kTileQ = 64, kTileN = 16;

__global__ void __launch_bounds__(256) dit_weight_grads(const GradJobs jobs) {
  __shared__ __align__(16) float us[kTileN][kTileP];
  __shared__ __align__(16) float vs[kTileN][kTileQ];
  int j = 0;
  while (j + 1 < jobs.n && (int)blockIdx.x >= jobs.job[j + 1].tile0) ++j;
  const GradJob jb = jobs.job[j];
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
      vs[r][col] = (n < jb.N && q0 + col < jb.Q) ? jb.v[(size_t)n * jb.Q + q0 + col] : 0.0f;
    }
    __syncthreads();
    if (with_bias && tid < kTileP)
      for (int r = 0; r < kTileN; ++r) bsum += us[r][tid];
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
    __syncthreads();
  }
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
  if (with_bias && tid < kTileP && p0 + tid < jb.P) jb.bias[p0 + tid] = bsum;
}

// The dynamic shared memory the row kernel is already allowed, per device.
constexpr int kMaxDevices = 64;
std::atomic<long long> g_smem_allowed[kMaxDevices];

}  // namespace

extern "C" {

// Launches one block backward on `stream`, on the current device: the row
// kernel (R CTAs of 256 threads, `smem_bytes` of dynamic shared memory) and
// then the weight-gradient kernel. The (in, out) weights feed the recomputed
// forward; the `_t` weights are the same matrices in nn.Linear's (out, in)
// layout, as are the weight gradients written (dw12_t holds dw1_t over dw2_t,
// (2Hd, E)). `workspace` holds dit_block_bwd_workspace_floats() floats. Every
// output is written whole. Returns the first CUDA error code (0 on success).
// Allocates nothing and does not synchronise.
int scldm_dit_block_backward(
    const void* x, const void* c, const void* wada, const void* bada, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* w1,
    const void* w2, const void* wmlp, const void* wada_t, const void* wqkv_t,
    const void* wproj_t, const void* w1_t, const void* w2_t, const void* wmlp_t,
    const void* dy, void* dx, void* dc, void* dwada_t, void* dbada, void* dwqkv_t,
    void* dbqkv, void* dwproj_t, void* dbproj, void* dw12_t, void* dwmlp_t,
    void* workspace, int R, int T, int E, int H, int Hd, float eps,
    long long smem_bytes, void* stream) {
  if (R == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem_bytes > g_smem_allowed[dev].load()) {
    err = cudaFuncSetAttribute(dit_block_bwd_rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) g_smem_allowed[dev].store(smem_bytes);
  }
  cudaStream_t s = (cudaStream_t)stream;
  float* ws = (float*)workspace;
  dit_block_bwd_rows<<<R, kThreads, (size_t)smem_bytes, s>>>(
      (const float*)x, (const float*)c, (const float*)wada, (const float*)bada,
      (const float*)wqkv, (const float*)bqkv, (const float*)wproj, (const float*)bproj,
      (const float*)w1, (const float*)w2, (const float*)wmlp, (const float*)wada_t,
      (const float*)wqkv_t, (const float*)wproj_t, (const float*)w1_t, (const float*)w2_t,
      (const float*)wmlp_t, (const float*)dy, (float*)dx, (float*)dc, ws, R, T, E, H, Hd,
      eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const Workspace w = carve(ws, R, T, E, Hd);
  const int N = R * T;
  const GradJob list[kMaxJobs] = {
      {w.mod, w.cs, (float*)dwada_t, (float*)dbada, 6 * E, E, R, 0, 0},
      {w.qkv, w.h, (float*)dwqkv_t, (float*)dbqkv, 3 * E, E, N, 0, 0},
      {w.proj, w.attn, (float*)dwproj_t, (float*)dbproj, E, E, N, 0, 0},
      {w.ab, w.h2, (float*)dw12_t, nullptr, 2 * Hd, E, N, 0, 0},
      {w.m, w.g, (float*)dwmlp_t, nullptr, E, Hd, N, 0, 0},
  };
  GradJobs jobs;
  jobs.n = kMaxJobs;
  int tiles = 0;
  for (int j = 0; j < kMaxJobs; ++j) {
    jobs.job[j] = list[j];
    jobs.job[j].tiles_q = (list[j].Q + kTileQ - 1) / kTileQ;
    jobs.job[j].tile0 = tiles;
    tiles += ((list[j].P + kTileP - 1) / kTileP) * jobs.job[j].tiles_q;
  }
  dit_weight_grads<<<tiles, 256, 0, s>>>(jobs);
  return (int)cudaGetLastError();
}

}  // extern "C"
