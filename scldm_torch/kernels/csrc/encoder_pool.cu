// The VAE encoder's front half, forward and recompute backward: per token the
// input embedding, affine LayerNorm, k/v projections and per-head scores
// against the 16 inducing queries; per (cell, query, head) the online-max
// softmax pooling (m, den, num). bf16 operands, f32 accumulation.
//
// Replaces the TPU kernels scldm_tpu/ops/fused_encoder.py::fused_encoder_pool
// (Pallas body `_fwd_kernel`) and `_fused_bwd` (`_bwd_kernel`), and the window
// variant fused_window_pool (`_wfwd_kernel`) and `_wfused_bwd` (`_wbwd_kernel`).
// One source, templated on where token t of cell b comes from:
//   dense  (kDense):  x = table[t] * log1p(counts[b, t]), t over every gene;
//   window (!kDense): x = emb[b, t], t over the packed window.
// The math is `_ln_kv_scores`, `_online_update`, `_numden_given_m` there and
// `encoder_pool_reference` / `window_pool_reference` in
// scldm_torch/ops/fused_encoder.py. With bf() a round to bf16 and head h owning
// columns [h*HD, (h+1)*HD) of E:
//
//   x2     = LN(x) * ln1g + ln1b                       (eps given)
//   k, v   = bf(x2) @ bf(wk), bf(x2) @ bf(wv)
//   s[h,i] = scale * sum_d bf(k[h*HD+d]) * bf(q[i, h*HD+d])   (q: the head blocks of qfull)
//   m      = max over tokens of s;  e = exp(s - m)
//   den    = sum_t e;  num[i, h*HD+d] = sum_t bf(e[h,i]) * bf(v[h*HD+d])
//
// num holds only the head-diagonal blocks that the caller reads, (B, Q, E);
// den and m are (B, Q*H), row h*Q + i. Ragged edges are bounds-checked, not
// padded: the caller's zero-row correction counts the rows streamed here.
//
// What bounds it on an H100: operations. Per token about 3.1k multiply-adds
// (2 E^2 for k and v, Q*E each for the scores and the pooled values), the
// backward about three times that; the inputs are small (dense) or one read of
// the (B, S, E) window (window: 100.7 MB at B=128, S=6,147).
//
// What the design does about it. Forward: one CTA per cell, 256 threads; a
// tile of 256 tokens, one per thread, computes LayerNorm, k, v and the 64
// scores in registers against bf(wk), bf(wv) and bf(q) staged once in shared
// memory (broadcast reads, 16-byte vectors), and stages the scores and bf(v);
// then each thread owns one (query, head) and a quarter of the tile's tokens
// for the online softmax: the four parts agree on the tile max through shared
// memory, keep their own partial sums under that common max, and add them at
// the end. Backward: a CTA owns 128 tokens and 16 cells (grid tokens x cells),
// recomputes the forward per token given the saved m, and runs the backward
// per token (dk, dv, the scores' cotangents, the projections, the LayerNorm);
// the weight and query gradients, sums over every token, go through shared
// memory: per cell the CTA stages bf(x2), bf(k), bf(dk), bf(dv) and the
// scores' cotangents of its tokens and reduces them as small products into
// per-thread accumulators, added to device memory once per CTA with atomics;
// dtable (dense) likewise, one atomic add per row and column per CTA, while
// the window variant writes demb. The exponentials' and the projections'
// cotangents are rounded to bf16 where the forward rounded their operands;
// the reduced gradients of qfull, wk and wv are rounded by the caller after
// the whole sum. Atomics make the sums order-dependent from run to run.
//
// Compiled for E=32, 4 heads, Q=16 (the reference encoder); the thread-to-
// output maps assume E == 32 and Q*H == 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

namespace {

constexpr int kE = 32, kH = 4, kQ = 16;
constexpr int kHD = kE / kH, kQH = kQ * kH;
constexpr int kFwdT = 256;             // forward: tokens per tile, one per thread
constexpr int kParts = kFwdT / kQH;    // forward: threads per (query, head) in the softmax pass
constexpr int kBwdT = 128;             // backward: tokens per CTA, one per thread
constexpr int kBwdRows = 16;           // backward: cells per CTA
constexpr int kBwdWarps = kBwdT / 32;
constexpr int kRS = kE + 4;            // row stride of a staged (token, E) tile: 16-byte rows
constexpr int kSS = kQH + 1;           // row stride of a staged (token, Q*H) tile: odd
static_assert(kE == 32 && kQH == 64 && kParts == 4, "the thread maps assume E=32, Q*H=64");

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void store_row(float* dst, const float (&x)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; e += 4)
    *reinterpret_cast<float4*>(dst + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
}

template <int N>
__device__ __forceinline__ void load_vec(const float* src, float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + e);
    x[e] = v.x;
    x[e + 1] = v.y;
    x[e + 2] = v.z;
    x[e + 3] = v.w;
  }
}

// sum_e x[e] * w[e], w 16-byte aligned in shared memory (a broadcast read)
__device__ __forceinline__ float dot32(const float (&x)[kE], const float* w) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int e = 0; e < kE; e += 4) {
    const float4 v = *reinterpret_cast<const float4*>(w + e);
    a0 = fmaf(x[e], v.x, a0);
    a1 = fmaf(x[e + 1], v.y, a1);
    a0 = fmaf(x[e + 2], v.z, a0);
    a1 = fmaf(x[e + 3], v.w, a1);
  }
  return a0 + a1;
}

// The weights both kernels stage once per CTA, in floats: bf(wk), bf(wv)
// (in, out), bf(q) (Q, E) (column block h of row i: head h of query i, the
// head blocks of qfull), ln1g, ln1b.
struct Weights {
  static constexpr int kFloats = 2 * kE * kE + kQ * kE + 2 * kE;
  float *wk, *wv, *q, *g, *b;
  __device__ explicit Weights(float* s) {
    wk = s;
    wv = wk + kE * kE;
    q = wv + kE * kE;
    g = q + kQ * kE;
    b = g + kE;
  }
  __device__ void stage(const float* wk_in, const float* wv_in, const float* qfull,
                        const float* g_in, const float* b_in) {
    for (int i = threadIdx.x; i < kE * kE; i += blockDim.x) {
      wk[i] = bf(wk_in[i]);
      wv[i] = bf(wv_in[i]);
    }
    for (int i = threadIdx.x; i < kQ * kE; i += blockDim.x) {
      const int qi = i / kE, c = i % kE;
      q[i] = bf(qfull[(size_t)((c / kHD) * kQ + qi) * kE + c]);
    }
    for (int i = threadIdx.x; i < kE; i += blockDim.x) {
      g[i] = g_in[i];
      b[i] = b_in[i];
    }
  }
};

// x = the embedding of token t of cell b; returns the dense variant's
// log1p(count), the factor of dtable (1 for the window)
template <bool kDense>
__device__ __forceinline__ float load_token(const float* counts, const float* src, int b, int t,
                                            int N, float (&x)[kE]) {
  const float* row = kDense ? src + (size_t)t * kE : src + ((size_t)b * N + t) * kE;
  const float lc = kDense ? log1pf(__ldg(counts + (size_t)b * N + t)) : 1.f;
#pragma unroll
  for (int e = 0; e < kE; e += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + e));
    x[e] = kDense ? v.x * lc : v.x;
    x[e + 1] = kDense ? v.y * lc : v.y;
    x[e + 2] = kDense ? v.z * lc : v.z;
    x[e + 3] = kDense ? v.w * lc : v.w;
  }
  return lc;
}

// x -> (x - mean) * rstd in place; returns rstd
__device__ __forceinline__ float normalize(float (&x)[kE], float eps) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e) s += x[e];
  const float mean = s / kE;
  float v = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    x[e] -= mean;
    v = fmaf(x[e], x[e], v);
  }
  const float rstd = rsqrtf(v / kE + eps);
#pragma unroll
  for (int e = 0; e < kE; ++e) x[e] *= rstd;
  return rstd;
}

// xb = bf(xhat * g + b), then k = xb @ wk and v = xb @ wv
__device__ __forceinline__ void ln_project(const float (&xhat)[kE], const Weights& w,
                                           float (&xb)[kE], float (&k)[kE], float (&v)[kE]) {
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    xb[e] = bf(__fadd_rn(__fmul_rn(xhat[e], w.g[e]), w.b[e]));
    k[e] = 0.f;
    v[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const float xe = xb[e];
#pragma unroll
    for (int o = 0; o < kE; o += 4) {
      const float4 a = *reinterpret_cast<const float4*>(w.wk + e * kE + o);
      const float4 c = *reinterpret_cast<const float4*>(w.wv + e * kE + o);
      k[o] = fmaf(xe, a.x, k[o]);
      k[o + 1] = fmaf(xe, a.y, k[o + 1]);
      k[o + 2] = fmaf(xe, a.z, k[o + 2]);
      k[o + 3] = fmaf(xe, a.w, k[o + 3]);
      v[o] = fmaf(xe, c.x, v[o]);
      v[o + 1] = fmaf(xe, c.y, v[o + 1]);
      v[o + 2] = fmaf(xe, c.z, v[o + 2]);
      v[o + 3] = fmaf(xe, c.w, v[o + 3]);
    }
  }
}

// sum_d kb[d] * q[d] over one head's HD columns
__device__ __forceinline__ float head_dot(const float* kb, const float* q) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kHD; ++d) acc = fmaf(kb[d], q[d], acc);
  return acc;
}

struct FwdSmem {
  // Weights, the parts' tile maxima (kParts, QH), scores (T, kSS), bf(v) (T, kRS)
  static constexpr int kFloats = Weights::kFloats + kParts * kQH + up4(kFwdT * kSS) + kFwdT * kRS;
};

template <bool kDense>
__global__ void __launch_bounds__(kFwdT)
pool_fwd_kernel(const float* __restrict__ counts, const float* __restrict__ src,
                const float* __restrict__ qfull, const float* __restrict__ ln1g,
                const float* __restrict__ ln1b, const float* __restrict__ wk,
                const float* __restrict__ wv, float* __restrict__ num, float* __restrict__ den,
                float* __restrict__ mout, int N, float eps, float scale) {
  extern __shared__ __align__(16) float smem[];
  Weights w(smem);
  w.stage(wk, wv, qfull, ln1g, ln1b);
  float* PM = smem + Weights::kFloats;
  float* S = PM + kParts * kQH;
  float* V = S + up4(kFwdT * kSS);

  const int b = blockIdx.x, tid = threadIdx.x;
  // softmax pass: thread -> (query-head hq, part); a warp shares its part, so
  // its 32 threads read 32 consecutive scores of one token
  const int part = tid / kQH, hq = tid % kQH, h = hq / kQ;
  float m = -INFINITY, dsum = 0.f, acc[kHD];
#pragma unroll
  for (int d = 0; d < kHD; ++d) acc[d] = 0.f;

  for (int t0 = 0; t0 < N; t0 += kFwdT) {
    __syncthreads();  // the weights are staged; the last tile's readers are done
    const int t = t0 + tid;
    if (t < N) {
      float x[kE], xb[kE], k[kE], v[kE];
      load_token<kDense>(counts, src, b, t, N, x);
      normalize(x, eps);
      ln_project(x, w, xb, k, v);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        k[e] = bf(k[e]);
        v[e] = bf(v[e]);
      }
      store_row(V + tid * kRS, v);
      float* srow = S + tid * kSS;
#pragma unroll
      for (int hh = 0; hh < kH; ++hh)
#pragma unroll
        for (int i = 0; i < kQ; ++i)
          srow[hh * kQ + i] = head_dot(k + hh * kHD, w.q + i * kE + hh * kHD) * scale;
    }
    __syncthreads();

    const int nt = min(kFwdT, N - t0);
    float tmax = -INFINITY;
    for (int j = part; j < nt; j += kParts) tmax = fmaxf(tmax, S[j * kSS + hq]);
    PM[part * kQH + hq] = tmax;
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kParts; ++p) tmax = fmaxf(tmax, PM[p * kQH + hq]);
    const float mnew = fmaxf(m, tmax);
    const float alpha = expf(m - mnew);  // 0 on the first tile, where m = -inf
    dsum *= alpha;
#pragma unroll
    for (int d = 0; d < kHD; ++d) acc[d] *= alpha;
    for (int j = part; j < nt; j += kParts) {
      const float e = expf(S[j * kSS + hq] - mnew);
      dsum += e;
      const float eb = bf(e);
      float vb[kHD];
      load_vec(V + j * kRS + h * kHD, vb);
#pragma unroll
      for (int d = 0; d < kHD; ++d) acc[d] = fmaf(eb, vb[d], acc[d]);
    }
    m = mnew;
  }

  // the parts share m: add their partial sums
  __syncthreads();
  float* P = S;  // (kParts, QH, 1 + HD)
  P[(part * kQH + hq) * (kHD + 1)] = dsum;
#pragma unroll
  for (int d = 0; d < kHD; ++d) P[(part * kQH + hq) * (kHD + 1) + 1 + d] = acc[d];
  __syncthreads();
  if (part == 0) {
    for (int p = 1; p < kParts; ++p) {
      const float* pp = P + (p * kQH + hq) * (kHD + 1);
      dsum += pp[0];
#pragma unroll
      for (int d = 0; d < kHD; ++d) acc[d] += pp[1 + d];
    }
    mout[(size_t)b * kQH + hq] = m;
    den[(size_t)b * kQH + hq] = dsum;
    float* nrow = num + ((size_t)b * kQ + hq % kQ) * kE + h * kHD;
#pragma unroll
    for (int d = 0; d < kHD; ++d) nrow[d] = acc[d];
  }
}

struct BwdSmem {
  // Weights; the cell's m, dden (QH each) and dnum (Q, E); the tile's bf(x2),
  // bf(k), bf(v), bf(dk), bf(dv) (T, kRS each); the scores' cotangents
  // (T, kSS); per warp dln1g, dln1b (E each)
  static constexpr int kFloats = Weights::kFloats + 2 * kQH + kQ * kE + 5 * kBwdT * kRS +
                                 up4(kBwdT * kSS) + kBwdWarps * 2 * kE;
};

template <bool kDense>
__global__ void __launch_bounds__(kBwdT)
pool_bwd_kernel(const float* __restrict__ counts, const float* __restrict__ src,
                const float* __restrict__ qfull, const float* __restrict__ ln1g,
                const float* __restrict__ ln1b, const float* __restrict__ wk,
                const float* __restrict__ wv, const float* __restrict__ mstat,
                const float* __restrict__ dnum, const float* __restrict__ dden,
                float* __restrict__ dsrc, float* __restrict__ dqfull, float* __restrict__ dln1g,
                float* __restrict__ dln1b, float* __restrict__ dwk, float* __restrict__ dwv, int B,
                int N, float eps, float scale) {
  extern __shared__ __align__(16) float smem[];
  Weights w(smem);
  float* M = smem + Weights::kFloats;
  float* DD = M + kQH;
  float* DN = DD + kQH;
  float* XB = DN + kQ * kE;
  float* KB = XB + kBwdT * kRS;
  float* VB = KB + kBwdT * kRS;
  float* DK = VB + kBwdT * kRS;
  float* DV = DK + kBwdT * kRS;
  float* DS = DV + kBwdT * kRS;
  float* VEC = DS + up4(kBwdT * kSS);

  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < kBwdWarps * 2 * kE; i += kBwdT) VEC[i] = 0.f;
  w.stage(wk, wv, qfull, ln1g, ln1b);
  float* vec = VEC + (tid >> 5) * 2 * kE;

  // a token past the edge recomputes the last one and takes live = 0: every
  // cotangent it makes is then 0
  const int t = blockIdx.x * kBwdT + tid;
  const bool valid = t < N;
  const int tt = valid ? t : N - 1;
  const float live = valid ? 1.f : 0.f;
  float* xrow = XB + tid * kRS;
  float* krow = KB + tid * kRS;
  float* vrow = VB + tid * kRS;
  float* dsrow = DS + tid * kSS;

  // the CTA products: thread -> rows e1 of dwk and dwv, columns o1..o1+7;
  // query-head hq2 of dqfull, columns c2..c2+3 of its head block
  const int e1 = tid >> 2, o1 = (tid & 3) * 8;
  const int hq2 = tid >> 1, c2 = (hq2 / kQ) * kHD + (tid & 1) * 4;
  float awk[8], awv[8], aq[4], dtab[kE];
#pragma unroll
  for (int c = 0; c < 8; ++c) awk[c] = awv[c] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) aq[c] = 0.f;
#pragma unroll
  for (int e = 0; e < kE; ++e) dtab[e] = 0.f;

  const int b1 = min(B, (int)(blockIdx.y + 1) * kBwdRows);
  for (int b = blockIdx.y * kBwdRows; b < b1; ++b) {
    __syncthreads();  // zeroed and staged; the last cell's readers are done
    for (int i = tid; i < kQH; i += kBwdT) {
      M[i] = mstat[(size_t)b * kQH + i];
      DD[i] = dden[(size_t)b * kQH + i];
    }
    for (int i = tid; i < kQ * kE; i += kBwdT) DN[i] = dnum[(size_t)b * kQ * kE + i];

    // -- recompute the forward: xhat in x, bf(x2), bf(k), bf(v) into the tile ---
    float x[kE];
    const float lc = load_token<kDense>(counts, src, b, tt, N, x);
    const float rstd = normalize(x, eps);
    {
      float xb[kE], k[kE], v[kE];
      ln_project(x, w, xb, k, v);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        k[e] = bf(k[e]);
        v[e] = bf(v[e]);
      }
      store_row(xrow, xb);
      store_row(krow, k);
      store_row(vrow, v);
    }
    __syncthreads();  // the cell's m, dden and dnum are staged

    // -- attention backward, own token: dk, dv, the scores' cotangents ----------
    float dk[kE], dv[kE];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      float kb[kHD], vb[kHD], dkh[kHD], dvh[kHD];
      load_vec(krow + h * kHD, kb);
      load_vec(vrow + h * kHD, vb);
#pragma unroll
      for (int d = 0; d < kHD; ++d) dkh[d] = dvh[d] = 0.f;
#pragma unroll 4
      for (int i = 0; i < kQ; ++i) {
        const int hq = h * kQ + i;
        const float* qr = w.q + i * kE + h * kHD;
        const float* dn = DN + i * kE + h * kHD;
        const float e = expf(head_dot(kb, qr) * scale - M[hq]);
        const float eb = live * bf(e);
        // d(e) = the num path's cotangent, rounded where e was, + dden
        const float dsp = live * (e * (bf(head_dot(vb, dn)) + DD[hq])) * scale;
#pragma unroll
        for (int d = 0; d < kHD; ++d) {
          dvh[d] = fmaf(eb, dn[d], dvh[d]);
          dkh[d] = fmaf(dsp, qr[d], dkh[d]);
        }
        dsrow[hq] = dsp;
      }
#pragma unroll
      for (int d = 0; d < kHD; ++d) {
        dk[h * kHD + d] = bf(dkh[d]);
        dv[h * kHD + d] = bf(dvh[d]);
      }
    }
    store_row(DK + tid * kRS, dk);
    store_row(DV + tid * kRS, dv);

    // -- through the projections (each use of bf(x2) rounded on its own) and
    //    the LayerNorm: demb into dx ----------------------------------------------
    float dx[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) dx[e] = bf(dot32(dk, w.wk + e * kE)) + bf(dot32(dv, w.wv + e * kE));
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const float tg = warp_sum(dx[e] * x[e]);
      const float tb = warp_sum(dx[e]);
      if (lane == 0) {
        vec[e] += tg;
        vec[kE + e] += tb;
      }
      dx[e] *= w.g[e];  // d(xhat)
      m1 += dx[e];
      m2 = fmaf(dx[e], x[e], m2);
    }
    m1 /= kE;
    m2 /= kE;
#pragma unroll
    for (int e = 0; e < kE; ++e) dx[e] = rstd * (dx[e] - m1 - x[e] * m2);
    if (kDense) {
#pragma unroll
      for (int e = 0; e < kE; ++e) dtab[e] = fmaf(dx[e], lc, dtab[e]);
    } else if (valid) {
      store_row(dsrc + ((size_t)b * N + t) * kE, dx);
    }
    __syncthreads();

    // -- the CTA products over the tile's tokens ------------------------------
    for (int j = 0; j < kBwdT; ++j) {
      const float xe = XB[j * kRS + e1];
      float dkj[8], dvj[8], kbj[4];
      load_vec(DK + j * kRS + o1, dkj);
      load_vec(DV + j * kRS + o1, dvj);
      load_vec(KB + j * kRS + c2, kbj);
      const float ds = DS[j * kSS + hq2];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        awk[c] = fmaf(xe, dkj[c], awk[c]);
        awv[c] = fmaf(xe, dvj[c], awv[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) aq[c] = fmaf(ds, kbj[c], aq[c]);
    }
  }

  // -- once per CTA: the sums into device memory -----------------------------------
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    atomicAdd(dwk + e1 * kE + o1 + c, awk[c]);
    atomicAdd(dwv + e1 * kE + o1 + c, awv[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) atomicAdd(dqfull + hq2 * kE + c2 + c, aq[c]);
  if (kDense && valid) {
#pragma unroll 4
    for (int e = 0; e < kE; ++e) atomicAdd(dsrc + (size_t)t * kE + e, dtab[e]);
  }
  __syncthreads();  // every warp's LayerNorm sums are in
  for (int i = tid; i < 2 * kE; i += kBwdT) {
    float s = 0.f;
    for (int wi = 0; wi < kBwdWarps; ++wi) s += VEC[wi * 2 * kE + i];
    atomicAdd(i < kE ? dln1g + i : dln1b + (i - kE), s);
  }
}

// The dynamic shared memory each kernel is already allowed, per device: the
// attribute is set only when a launch needs more than before.
constexpr int kMaxDevices = 64;
std::atomic<long long> g_allowed[4][kMaxDevices];

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<long long>* allowed, long long bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= allowed[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev].store(bytes);
  return err;
}

bool supported(int E, int H, int Q) { return E == kE && H == kH && Q == kQ; }

template <bool kDense>
int launch_fwd(const void* counts, const void* src, const void* qfull, const void* ln1g,
               const void* ln1b, const void* wk, const void* wv, void* num, void* den, void* m,
               int B, int N, int E, int H, int Q, float eps, float scale, void* stream) {
  if (B == 0) return 0;
  if (!supported(E, H, Q)) return (int)cudaErrorInvalidValue;
  auto kernel = pool_fwd_kernel<kDense>;
  const long long smem = 4LL * FwdSmem::kFloats;
  cudaError_t err = allow_smem(kernel, g_allowed[kDense ? 0 : 1], smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kFwdT, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)counts, (const float*)src, (const float*)qfull, (const float*)ln1g,
      (const float*)ln1b, (const float*)wk, (const float*)wv, (float*)num, (float*)den,
      (float*)m, N, eps, scale);
  return (int)cudaGetLastError();
}

template <bool kDense>
int launch_bwd(const void* counts, const void* src, const void* qfull, const void* ln1g,
               const void* ln1b, const void* wk, const void* wv, const void* m,
               const void* dnum, const void* dden, void* dsrc, void* dqfull, void* dln1g,
               void* dln1b, void* dwk, void* dwv, int B, int N, int E, int H, int Q, float eps,
               float scale, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (!supported(E, H, Q)) return (int)cudaErrorInvalidValue;
  auto kernel = pool_bwd_kernel<kDense>;
  const long long smem = 4LL * BwdSmem::kFloats;
  cudaError_t err = allow_smem(kernel, g_allowed[kDense ? 2 : 3], smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBwdT - 1) / kBwdT, (B + kBwdRows - 1) / kBwdRows);
  kernel<<<grid, kBwdT, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)counts, (const float*)src, (const float*)qfull, (const float*)ln1g,
      (const float*)ln1b, (const float*)wk, (const float*)wv, (const float*)m,
      (const float*)dnum, (const float*)dden, (float*)dsrc, (float*)dqfull, (float*)dln1g,
      (float*)dln1b, (float*)dwk, (float*)dwv, B, N, eps, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forwards: num (B, Q, E), den and m (B, Q*H), f32. Launch on `stream`, on the
// current device; return the CUDA error code of the launch (0 on success).
// Allocate nothing and do not synchronise. Pointers are contiguous f32:
// counts (B, G) and table (G, E), or emb (B, S, E); qfull (Q*H, E); ln1g,
// ln1b (E); wk, wv (E, E), (in, out). N is G or S.
int scldm_encoder_pool_forward(const void* counts, const void* table, const void* qfull,
                               const void* ln1g, const void* ln1b, const void* wk,
                               const void* wv, void* num, void* den, void* m, int B, int N, int E,
                               int H, int Q, float eps, float scale, void* stream) {
  return launch_fwd<true>(counts, table, qfull, ln1g, ln1b, wk, wv, num, den, m, B, N, E, H, Q,
                          eps, scale, stream);
}

int scldm_window_pool_forward(const void* emb, const void* qfull, const void* ln1g,
                              const void* ln1b, const void* wk, const void* wv, void* num,
                              void* den, void* m, int B, int N, int E, int H, int Q, float eps,
                              float scale, void* stream) {
  return launch_fwd<false>(nullptr, emb, qfull, ln1g, ln1b, wk, wv, num, den, m, B, N, E, H, Q,
                           eps, scale, stream);
}

// Backwards, given the forward's m and the cotangents dnum (B, Q, E) and
// dden (B, Q*H): add the gradients into dqfull (its head blocks), dln1g,
// dln1b, dwk, dwv and, dense, dtable (G, E), all zeroed by the caller; the
// window variant writes demb (B, S, E). Same conventions as the forwards.
int scldm_encoder_pool_backward(const void* counts, const void* table, const void* qfull,
                                const void* ln1g, const void* ln1b, const void* wk,
                                const void* wv, const void* m, const void* dnum,
                                const void* dden, void* dtable, void* dqfull, void* dln1g,
                                void* dln1b, void* dwk, void* dwv, int B, int N, int E, int H,
                                int Q, float eps, float scale, void* stream) {
  return launch_bwd<true>(counts, table, qfull, ln1g, ln1b, wk, wv, m, dnum, dden, dtable,
                          dqfull, dln1g, dln1b, dwk, dwv, B, N, E, H, Q, eps, scale, stream);
}

int scldm_window_pool_backward(const void* emb, const void* qfull, const void* ln1g,
                               const void* ln1b, const void* wk, const void* wv, const void* m,
                               const void* dnum, const void* dden, void* demb, void* dqfull,
                               void* dln1g, void* dln1b, void* dwk, void* dwv, int B, int N,
                               int E, int H, int Q, float eps, float scale, void* stream) {
  return launch_bwd<false>(nullptr, emb, qfull, ln1g, ln1b, wk, wv, m, dnum, dden, demb, dqfull,
                           dln1g, dln1b, dwk, dwv, B, N, E, H, Q, eps, scale, stream);
}

}  // extern "C"
