// The VAE decoder tail, forward and recompute backward: the NB-head mu
// logit of every (cell, gene) pair, with bf16 operands and f32 accumulation.
//
// Replaces the TPU kernels scldm_tpu/ops/fused_decoder.py::fused_decoder_tail
// (Pallas body `_fwd_kernel`) and `_fused_bwd` (`_bwd_kernel`); the math is
// `_tail_math` there and `decoder_tail_reference` in
// scldm_torch/ops/fused_decoder.py. Per pair (b, g), with bf() a round to
// bf16 and head h owning columns [h*HD, (h+1)*HD) of E:
//
//   s[h,m] = sum_d bf(k[b,m,h*HD+d]) * bf(qp[g,h*HD+d])   (the head blocks of kfull)
//   p[h,:] = softmax_m(s[h,:] * scale)
//   hh     = q[g] + sum_hm bf(p[hm]) * bf(vproj[b,hm,:])
//   hn     = LN(hh) * ln2g + ln2b                          (eps given)
//   a|c    = bf(hn) @ bf(w12)                              (E -> 2 Hd)
//   logit  = wmu . hh + sum_n silu(a[n]) c[n] wv[n] + bmu
//
// What bounds it on an H100: f32 FMA. At the VAE training step's shapes
// (B=128 cells, G=17,002 genes, E=32, 4 heads of 16 latent tokens, Hd=88)
// the forward is about 8.2k multiply-adds per pair, 18 G in all, and the
// backward about three times that; the inputs are a few MB.
//
// What the design does about it. A CTA of 128 threads owns 128 genes (one
// each) and 16 batch rows; it stages bf(w12) once and, per row, that row's
// head blocks of kfull (M x E) and vproj (H*M x E) in shared memory, so every
// thread reads the same address (a broadcast) and each 16-byte load feeds
// four FMAs from registers. Only the head blocks of kfull are read: the rest
// is zeros by construction, so the products skip them. Ragged gene and batch
// edges are bounds-checked, not padded.
//
// The backward recomputes the forward per pair and reduces:
//   - dqp, dq (sum over cells): per thread in shared memory across the CTA's
//     rows, then one atomicAdd per gene and column per CTA;
//   - dvproj, dkfull (sum over genes): per row, the CTA stages bf(p) and
//     d(hh), then ds and bf(qp), for its 128 genes in shared memory and
//     reduces them as small products, one atomicAdd per output per CTA;
//   - dw12 = sum hn^T [da | dc] over all pairs: the n loop runs in chunks of
//     16 columns; the CTA stages [da | dc] for the chunk and reduces it
//     against the staged bf(hn) into a shared-memory accumulator, added to
//     device memory once per CTA (not per pair: that would be 12 G atomics);
//   - the LN, wv, wmu and bmu gradients: warp shuffles, one shared-memory
//     slot per warp, one atomicAdd per CTA.
// The gradients of p and hn are rounded to bf16 where the forward rounded
// them; dqp, dkfull, dvproj and dw12 are rounded by the caller after the sum.
// Atomics make the sums order-dependent from run to run.
//
// Compiled for E=32, 4 heads, M=16 (the reference decoder); the thread-to-
// output maps of the CTA products assume E == 32 and H*M == 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

namespace {

constexpr int kGenes = 128;  // genes per CTA, one per thread
constexpr int kRows = 16;    // batch rows per CTA
constexpr int kNC = 16;      // SwiGLU columns per chunk of the backward's dw12 product
constexpr int kWarps = kGenes / 32;

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum_e x[e] * w[e], w 16-byte aligned in shared memory (a broadcast read)
template <int E>
__device__ __forceinline__ float dot(const float (&x)[E], const float* w) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int e = 0; e < E; e += 4) {
    const float4 v = *reinterpret_cast<const float4*>(w + e);
    a0 = fmaf(x[e], v.x, a0);
    a1 = fmaf(x[e + 1], v.y, a1);
    a0 = fmaf(x[e + 2], v.z, a0);
    a1 = fmaf(x[e + 3], v.w, a1);
  }
  return a0 + a1;
}

// dst = src row of a contiguous (., E) f32 matrix, optionally rounded to bf16
template <int E, bool kRound>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[E]) {
#pragma unroll
  for (int e = 0; e < E; e += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + e));
    dst[e] = kRound ? bf(v.x) : v.x;
    dst[e + 1] = kRound ? bf(v.y) : v.y;
    dst[e + 2] = kRound ? bf(v.z) : v.z;
    dst[e + 3] = kRound ? bf(v.w) : v.w;
  }
}

// Shared-memory layout shared by both kernels, in floats: bf(w12)^T (2Hd, E),
// wv (Hd), ln2g, ln2b, wmu (E each), then one row's kc (M, E) and vb (HM, E).
template <int E, int H, int M>
struct Common {
  float *w12t, *wv, *g, *b, *wmu, *kc, *vb;
  __device__ Common(float* s, int Hd) {
    w12t = s;
    wv = w12t + 2 * Hd * E;
    g = wv + up4(Hd);
    b = g + E;
    wmu = b + E;
    kc = wmu + E;
    vb = kc + M * E;
  }
  static __host__ __device__ int floats(int Hd) { return 2 * Hd * E + up4(Hd) + 3 * E + M * E + H * M * E; }

  __device__ void stage_weights(const float* w12, const float* ln2g, const float* ln2b,
                                const float* wv_in, const float* wmu_in, int Hd) {
    const int n2 = 2 * Hd;
    for (int i = threadIdx.x; i < n2 * E; i += blockDim.x) {
      const int n = i / E, e = i % E;
      w12t[i] = bf(w12[e * n2 + n]);
    }
    for (int i = threadIdx.x; i < Hd; i += blockDim.x) wv[i] = wv_in[i];
    for (int i = threadIdx.x; i < E; i += blockDim.x) {
      g[i] = ln2g[i];
      b[i] = ln2b[i];
      wmu[i] = wmu_in[i];
    }
  }

  // kc[m][e] = bf(kfull[row, (e / HD) * M + m, e]) (the head blocks), vb = bf(vproj[row])
  __device__ void stage_row(const float* kfull, const float* vproj, int row) {
    constexpr int HD = E / H, HM = H * M;
    const float* kr = kfull + (size_t)row * HM * E;
    const float* vr = vproj + (size_t)row * HM * E;
    for (int i = threadIdx.x; i < M * E; i += blockDim.x) {
      const int m = i / E, e = i % E;
      kc[i] = bf(kr[((e / HD) * M + m) * E + e]);
    }
    for (int i = threadIdx.x; i < HM * E; i += blockDim.x) vb[i] = bf(vr[i]);
  }
};

// y = sum_hm bf(p[hm]) vb[hm, :] with p the per-head softmax of the scores;
// p (f32) is written to prow[hm] when prow is given.
template <int E, int H, int M>
__device__ __forceinline__ void attend(const float* kc, const float* vb, const float (&qpb)[E],
                                       float scale, float (&y)[E], float* prow) {
  constexpr int HD = E / H;
#pragma unroll
  for (int e = 0; e < E; ++e) y[e] = 0.f;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    float s[M];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float* kr = kc + m * E + h * HD;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
        acc = fmaf(k4.x, qpb[h * HD + d], acc);
        acc = fmaf(k4.y, qpb[h * HD + d + 1], acc);
        acc = fmaf(k4.z, qpb[h * HD + d + 2], acc);
        acc = fmaf(k4.w, qpb[h * HD + d + 3], acc);
      }
      s[m] = acc * scale;
      mx = fmaxf(mx, s[m]);
    }
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      s[m] = expf(s[m] - mx);
      sum += s[m];
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float p = s[m] / sum;
      if (prow != nullptr) prow[h * M + m] = p;
      const float pb = bf(p);
      const float* vr = vb + (h * M + m) * E;
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(vr + e);
        y[e] = fmaf(pb, v.x, y[e]);
        y[e + 1] = fmaf(pb, v.y, y[e + 1]);
        y[e + 2] = fmaf(pb, v.z, y[e + 2]);
        y[e + 3] = fmaf(pb, v.w, y[e + 3]);
      }
    }
  }
}

// x -> (x - mean) * rstd in place; returns rstd
template <int E>
__device__ __forceinline__ float normalize(float (&x)[E], float eps) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s += x[e];
  const float mean = s / E;
  float v = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] -= mean;
    v = fmaf(x[e], x[e], v);
  }
  const float rstd = rsqrtf(v / E + eps);
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] *= rstd;
  return rstd;
}

template <int E, int H, int M>
__global__ void __launch_bounds__(kGenes)
decoder_tail_fwd_kernel(const float* __restrict__ qp, const float* __restrict__ q,
                        const float* __restrict__ kfull, const float* __restrict__ vproj,
                        const float* __restrict__ ln2g, const float* __restrict__ ln2b,
                        const float* __restrict__ w12, const float* __restrict__ wv,
                        const float* __restrict__ wmu, const float* __restrict__ bmu,
                        float* __restrict__ out, int B, int G, int Hd, float eps, float scale) {
  extern __shared__ __align__(16) float smem[];
  Common<E, H, M> sh(smem, Hd);
  sh.stage_weights(w12, ln2g, ln2b, wv, wmu, Hd);

  const int g = blockIdx.x * kGenes + threadIdx.x;
  const bool valid = g < G;
  const size_t gg = valid ? g : G - 1;
  float qpb[E], qv[E];
  load_row<E, true>(qp + gg * E, qpb);
  load_row<E, false>(q + gg * E, qv);
  const float bias = bmu[0];

  const int b1 = min(B, (int)(blockIdx.y + 1) * kRows);
  for (int row = blockIdx.y * kRows; row < b1; ++row) {
    __syncthreads();  // the weights are staged; the last row's readers are done
    sh.stage_row(kfull, vproj, row);
    __syncthreads();

    float x[E];
    attend<E, H, M>(sh.kc, sh.vb, qpb, scale, x, nullptr);
    float lin = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      x[e] = qv[e] + x[e];
      lin = fmaf(x[e], sh.wmu[e], lin);
    }
    normalize<E>(x, eps);
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = bf(__fadd_rn(__fmul_rn(x[e], sh.g[e]), sh.b[e]));

    float mlp = 0.f;
    for (int n = 0; n < Hd; ++n) {
      const float a = dot<E>(x, sh.w12t + n * E);
      const float c = dot<E>(x, sh.w12t + (Hd + n) * E);
      mlp = fmaf(a / (1.f + expf(-a)) * c, sh.wv[n], mlp);
    }
    if (valid) out[(size_t)row * G + g] = lin + mlp + bias;
  }
}

template <int E, int H, int M>
struct BwdSmem {
  static constexpr int HM = H * M;
  static constexpr int PS = HM + 1;     // odd row strides: a thread's own row is conflict-free
  static constexpr int XS = E + 1;
  static constexpr int DS = 2 * kNC + 1;
  static __host__ __device__ int nvec(int Hd) { return up4(3 * E + Hd + 1); }
  static __host__ __device__ int floats(int Hd) {
    return Common<E, H, M>::floats(Hd) + up4(kGenes * PS) + up4(kGenes * XS) + up4(kGenes * DS) +
           2 * Hd * E + 2 * up4(kGenes * XS) + kWarps * nvec(Hd);
  }
};

template <int E, int H, int M>
__global__ void __launch_bounds__(kGenes)
decoder_tail_bwd_kernel(const float* __restrict__ qp, const float* __restrict__ q,
                        const float* __restrict__ kfull, const float* __restrict__ vproj,
                        const float* __restrict__ ln2g, const float* __restrict__ ln2b,
                        const float* __restrict__ w12, const float* __restrict__ wv,
                        const float* __restrict__ wmu, const float* __restrict__ dy,
                        float* __restrict__ dqp, float* __restrict__ dq,
                        float* __restrict__ dkfull, float* __restrict__ dvproj,
                        float* __restrict__ dln2g, float* __restrict__ dln2b,
                        float* __restrict__ dw12, float* __restrict__ dwv,
                        float* __restrict__ dwmu, float* __restrict__ dbmu, int B, int G,
                        int Hd, float eps, float scale) {
  static_assert(E == 32 && H * M == 64 && kGenes == 128 && kNC == 16,
                "the CTA products' thread-to-output maps assume E=32, H*M=64, 128 threads");
  using S = BwdSmem<E, H, M>;
  constexpr int HD = E / H, HM = H * M, PS = S::PS, XS = S::XS, DS = S::DS;
  const int n2 = 2 * Hd;
  const int nvec = S::nvec(Hd);

  extern __shared__ __align__(16) float smem[];
  Common<E, H, M> sh(smem, Hd);
  float* P = smem + Common<E, H, M>::floats(Hd);  // (genes, HM): p, then ds
  float* X = P + up4(kGenes * PS);                // (genes, E): bf(hn), then d(hh), then bf(qp)
  float* DAB = X + up4(kGenes * XS);              // (genes, 2 kNC): [da | dc] of one chunk
  float* DW = DAB + up4(kGenes * DS);             // (E, 2Hd): dw12 accumulator
  float* DQP = DW + n2 * E;                       // (genes, E)
  float* DQ = DQP + up4(kGenes * XS);             // (genes, E)
  float* VEC = DQ + up4(kGenes * XS);             // per warp: dln2g, dln2b, dwmu (E each), dwv (Hd), dbmu

  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < n2 * E; i += kGenes) DW[i] = 0.f;
  for (int i = tid; i < up4(kGenes * XS); i += kGenes) DQP[i] = DQ[i] = 0.f;
  for (int i = tid; i < kWarps * nvec; i += kGenes) VEC[i] = 0.f;
  sh.stage_weights(w12, ln2g, ln2b, wv, wmu, Hd);
  float* vec = VEC + (tid >> 5) * nvec;

  const int g = blockIdx.x * kGenes + tid;
  const bool valid = g < G;
  const size_t gg = valid ? g : G - 1;
  float* prow = P + tid * PS;
  float* xrow = X + tid * XS;

  const int b1 = min(B, (int)(blockIdx.y + 1) * kRows);
  for (int row = blockIdx.y * kRows; row < b1; ++row) {
    __syncthreads();  // zeroed and staged; the last row's readers are done
    sh.stage_row(kfull, vproj, row);
    __syncthreads();

    // a gene past the edge takes dl = 0: every contribution it makes is then 0
    const float dl = valid ? dy[(size_t)row * G + g] : 0.f;
    {
      const float t = warp_sum(dl);
      if (lane == 0) vec[3 * E + Hd] += t;
    }

    // -- recompute the forward: p into P, hh, xhat, bf(hn) into X ----------------
    float x[E];
    {
      float qpb[E];
      load_row<E, true>(qp + gg * E, qpb);
      attend<E, H, M>(sh.kc, sh.vb, qpb, scale, x, prow);
    }
    {
      float qv[E];
      load_row<E, false>(q + gg * E, qv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[e] = qv[e] + x[e];
        const float t = warp_sum(dl * x[e]);
        if (lane == 0) vec[2 * E + e] += t;
      }
    }
    const float rstd = normalize<E>(x, eps);
    float hnb[E], dhn[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      hnb[e] = bf(__fadd_rn(__fmul_rn(x[e], sh.g[e]), sh.b[e]));
      xrow[e] = hnb[e];
      dhn[e] = 0.f;
    }

    // -- SwiGLU and its backward, in chunks of kNC columns ----------------------
    for (int n0 = 0; n0 < Hd; n0 += kNC) {
      for (int j = 0; j < kNC; ++j) {
        const int n = n0 + j;
        float da = 0.f, dc = 0.f;
        if (n < Hd) {
          const float a = dot<E>(hnb, sh.w12t + n * E);
          const float c = dot<E>(hnb, sh.w12t + (Hd + n) * E);
          const float sg = 1.f / (1.f + expf(-a));
          const float sl = a * sg;
          const float t = warp_sum(dl * (sl * c));
          if (lane == 0) vec[3 * E + n] += t;
          const float dg3 = dl * sh.wv[n];
          da = dg3 * c * (sg * (1.f + a * (1.f - sg)));
          dc = dg3 * sl;
          const float* w1r = sh.w12t + n * E;
          const float* w2r = sh.w12t + (Hd + n) * E;
#pragma unroll
          for (int e = 0; e < E; ++e) dhn[e] = fmaf(dc, w2r[e], fmaf(da, w1r[e], dhn[e]));
        }
        DAB[tid * DS + j] = da;
        DAB[tid * DS + kNC + j] = dc;
      }
      __syncthreads();
      // dw12 chunk: thread -> rows e0, e0+1 and chunk columns c0..c0+3 of 2 kNC
      {
        const int e0 = 2 * (tid >> 3), c0 = 4 * (tid & 7);
        float acc[2][4] = {};
        for (int gi = 0; gi < kGenes; ++gi) {
          const float x0 = X[gi * XS + e0], x1 = X[gi * XS + e0 + 1];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float d = DAB[gi * DS + c0 + c];
            acc[0][c] = fmaf(x0, d, acc[0][c]);
            acc[1][c] = fmaf(x1, d, acc[1][c]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + c;
          const int n = n0 + (col < kNC ? col : col - kNC);
          if (n < Hd) {
            const int out_col = col < kNC ? n : Hd + n;
            DW[e0 * n2 + out_col] += acc[0][c];
            DW[(e0 + 1) * n2 + out_col] += acc[1][c];
          }
        }
      }
      __syncthreads();  // DAB and X are rewritten next
    }

    // -- LayerNorm backward: d(hh) into X and DQ ----------------------------------
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dhn[e] = bf(dhn[e]);
      const float tg = warp_sum(dhn[e] * x[e]);
      const float tb = warp_sum(dhn[e]);
      if (lane == 0) {
        vec[e] += tg;
        vec[E + e] += tb;
      }
      dhn[e] *= sh.g[e];  // d(xhat)
      m1 += dhn[e];
      m2 = fmaf(dhn[e], x[e], m2);
    }
    m1 /= E;
    m2 /= E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dhn[e] = fmaf(dl, sh.wmu[e], rstd * (dhn[e] - m1 - x[e] * m2));  // d(hh)
      DQ[tid * XS + e] += dhn[e];
      xrow[e] = dhn[e];
    }
    __syncthreads();

    // -- dvproj[row] += sum over genes of bf(p) (x) d(hh): thread -> 4 hm x 4 e --------
    {
      const int hm0 = 4 * (tid >> 3), e0 = 4 * (tid & 7);
      float acc[4][4] = {};
      for (int gi = 0; gi < kGenes; ++gi) {
        float pb[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pb[i] = bf(P[gi * PS + hm0 + i]);
          xv[i] = X[gi * XS + e0 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pb[i], xv[j], acc[i][j]);
      }
      float* dst = dvproj + ((size_t)row * HM + hm0) * E + e0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(dst + i * E + j, acc[i][j]);
    }
    __syncthreads();  // P and X are rewritten next

    // -- attention backward, own gene: ds into P, dqp into DQP, bf(qp) into X ---
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float dp[M];
      float c = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float* vr = sh.vb + (h * M + m) * E;
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(vr + e);
          acc = fmaf(dhn[e], v.x, acc);
          acc = fmaf(dhn[e + 1], v.y, acc);
          acc = fmaf(dhn[e + 2], v.z, acc);
          acc = fmaf(dhn[e + 3], v.w, acc);
        }
        dp[m] = bf(acc);
        c = fmaf(prow[h * M + m], dp[m], c);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        dp[m] = prow[h * M + m] * (dp[m] - c) * scale;  // ds
        prow[h * M + m] = dp[m];
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < M; ++m) acc = fmaf(dp[m], sh.kc[m * E + h * HD + d], acc);
        DQP[tid * XS + h * HD + d] += acc;
      }
    }
    {
      float qpb[E];
      load_row<E, true>(qp + gg * E, qpb);
#pragma unroll
      for (int e = 0; e < E; ++e) xrow[e] = qpb[e];
    }
    __syncthreads();

    // -- dkfull[row] head blocks += sum over genes of ds (x) bf(qp): thread -> 1 hm x 4 d
    {
      const int hm = tid >> 1, h = hm / M, c0 = h * HD + 4 * (tid & 1);
      float acc[4] = {};
      for (int gi = 0; gi < kGenes; ++gi) {
        const float ds = P[gi * PS + hm];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(ds, X[gi * XS + c0 + j], acc[j]);
      }
      float* dst = dkfull + ((size_t)row * HM + hm) * E + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(dst + j, acc[j]);
    }
  }
  __syncthreads();

  // -- once per CTA: the per-gene and weight sums into device memory --------------
  if (valid) {
#pragma unroll 4
    for (int e = 0; e < E; ++e) {
      atomicAdd(dqp + gg * E + e, DQP[tid * XS + e]);
      atomicAdd(dq + gg * E + e, DQ[tid * XS + e]);
    }
  }
  for (int i = tid; i < n2 * E; i += kGenes) atomicAdd(dw12 + i, DW[i]);
  for (int i = tid; i < 3 * E + Hd + 1; i += kGenes) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += VEC[w * nvec + i];
    float* dst = i < E           ? dln2g + i
                 : i < 2 * E     ? dln2b + (i - E)
                 : i < 3 * E     ? dwmu + (i - 2 * E)
                 : i < 3 * E + Hd ? dwv + (i - 3 * E)
                                  : dbmu;
    atomicAdd(dst, s);
  }
}

// The dynamic shared memory each kernel is already allowed, per device: the
// attribute is set only when a launch needs more than before.
constexpr int kMaxDevices = 64;
std::atomic<long long> g_fwd_allowed[kMaxDevices];
std::atomic<long long> g_bwd_allowed[kMaxDevices];

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

bool supported(int E, int H, int M) { return E == 32 && H == 4 && M == 16; }

}  // namespace

extern "C" {

// Forward: out (B, G) f32 logits. Launches on `stream`, on the current device;
// returns the CUDA error code of the launch (0 on success). Allocates nothing
// and does not synchronise. Pointers are contiguous f32: qp, q (G, E); kfull,
// vproj (B, H*M, E); ln2g, ln2b, wmu (E); w12 (E, 2 Hd); wv (Hd); bmu (1).
int scldm_decoder_tail_forward(const void* qp, const void* q, const void* kfull,
                               const void* vproj, const void* ln2g, const void* ln2b,
                               const void* w12, const void* wv, const void* wmu,
                               const void* bmu, void* out, int B, int G, int E, int H, int M,
                               int Hd, float eps, float scale, void* stream) {
  if (B == 0 || G == 0) return 0;
  if (!supported(E, H, M)) return (int)cudaErrorInvalidValue;
  auto kernel = decoder_tail_fwd_kernel<32, 4, 16>;
  const long long smem = 4LL * Common<32, 4, 16>::floats(Hd);
  cudaError_t err = allow_smem(kernel, g_fwd_allowed, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + kGenes - 1) / kGenes, (B + kRows - 1) / kRows);
  kernel<<<grid, kGenes, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)qp, (const float*)q, (const float*)kfull, (const float*)vproj,
      (const float*)ln2g, (const float*)ln2b, (const float*)w12, (const float*)wv,
      (const float*)wmu, (const float*)bmu, (float*)out, B, G, Hd, eps, scale);
  return (int)cudaGetLastError();
}

// Backward: adds the gradients into dqp, dq (G, E), dkfull, dvproj (B, H*M, E)
// and the weight gradients (shapes as the weights), which the caller zeroes.
// Only the head blocks of dkfull are written. Same conventions as the forward.
int scldm_decoder_tail_backward(const void* qp, const void* q, const void* kfull,
                                const void* vproj, const void* ln2g, const void* ln2b,
                                const void* w12, const void* wv, const void* wmu,
                                const void* bmu, const void* dy, void* dqp, void* dq,
                                void* dkfull, void* dvproj, void* dln2g, void* dln2b,
                                void* dw12, void* dwv, void* dwmu, void* dbmu, int B, int G,
                                int E, int H, int M, int Hd, float eps, float scale,
                                void* stream) {
  (void)bmu;  // the logit's bias does not enter any gradient but its own
  if (B == 0 || G == 0) return 0;
  if (!supported(E, H, M)) return (int)cudaErrorInvalidValue;
  auto kernel = decoder_tail_bwd_kernel<32, 4, 16>;
  const long long smem = 4LL * BwdSmem<32, 4, 16>::floats(Hd);
  cudaError_t err = allow_smem(kernel, g_bwd_allowed, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + kGenes - 1) / kGenes, (B + kRows - 1) / kRows);
  kernel<<<grid, kGenes, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)qp, (const float*)q, (const float*)kfull, (const float*)vproj,
      (const float*)ln2g, (const float*)ln2b, (const float*)w12, (const float*)wv,
      (const float*)wmu, (const float*)dy, (float*)dqp, (float*)dq, (float*)dkfull,
      (float*)dvproj, (float*)dln2g, (float*)dln2b, (float*)dw12, (float*)dwv, (float*)dwmu,
      (float*)dbmu, B, G, Hd, eps, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
