// The VAE decoder tail, forward and recompute backward: the NB-head mu
// logit of every (cell, gene) pair, with bf16 operands and f32 accumulation,
// on the tensor cores (mma.sync bf16).
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
// What bounds it on an H100: operations. At the VAE training step's shapes
// (B=128 cells, G=17,002 genes, E=32, 4 heads of 16 latent tokens, Hd=88)
// the forward is about 8.2k multiply-adds a pair, 18 G in all (0.037 ms at
// the bf16 tensor-core peak); the inputs are a few MB. Every product takes
// bf16 operands in the reference, so one bf16 mma pass a product computes
// what it computes, in another summation order. One gene a thread in f32
// FMA, the forward took 1.87 ms.
//
// Both kernels (namespace `tail` below) share one layout: a CTA of four
// warps owns 64 genes (16 a warp, the mma M dimension) and a block of 16
// cells, which it walks in order; it stages bf(w12) once, and per cell that
// cell's head blocks of bf(kfull) and bf(vproj) in shared memory. The
// forward (`tail_fwd`) computes, per cell, in mma fragments (lane = 4 gq + tq
// holds genes gq and gq + 8): the scores bf(qp) kc^T (one k16 step a head,
// kc being 0 off its blocks), the softmax, y = bf(p) bf(vproj), hh = q + y,
// the LayerNorm, [a | c] = bf(hn) bf(w12) over 8 hidden columns at a time
// and the logit epilogue; hidden widths that are not a multiple of 8 are
// zero-padded in shared memory. The backward (`tail_bwd`) recomputes that
// forward and reduces, with no atomics: about 41k multiply-adds a pair as it
// runs them, 90 G at the training step's shape, 0.18 ms at the bf16 peak.
// One gene a thread in f32 FMA, the same work ran at 0.9% of the function's
// bound (12.8 ms), and atomic sums change the gradients' bits from run to
// run. The gradients of p and hn are rounded to bf16 where the forward
// rounded them; dqp, dkfull, dvproj and dw12 are rounded by the caller after
// the sum.
//
// Compiled for E=32, 4 heads, M=16 (the reference decoder); the backward
// also for Hd = 88 (its per-column sums are unrolled over Hd / 8 tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>
#include <initializer_list>

#include "tensor_core.cuh"

namespace {

// -- the backward on the tensor cores -------------------------------------------
//
// One CTA of four warps owns a tile of kGenes = 64 genes (16 a warp, the mma
// M dimension) and a block of kCells cells, which it walks in order. Per cell
// each warp recomputes its 16 pairs' forward and backward in mma fragments
// (lane = 4 gq + tq holds genes gq and gq + 8):
//   scores  bf(qp) kc^T              16 x 32 . 32 x 64, one bf16 pass, only the
//                                    k16 step of each head's block (kc is 0 off it)
//   y       bf(p) bf(vproj)          16 x 64 . 64 x 32, one bf16 pass
//   [a | c] bf(hn) bf(w12)           16 x 32 . 32 x 2Hd, one bf16 pass
//   d(hn)   [da | dc] bf(w12)^T      16 x 2Hd . 2Hd x 32: [da | dc] is f32, so three
//                                    bf16 passes (hi, mid, lo: tc::split3_bf16)
//   dp      d(hh) bf(vproj)^T        16 x 32 . 32 x 64, d(hh) f32: three passes
//   dqp    += ds kc                  16 x 64 . 64 x 32, ds f32: three passes, one
//                                    k16 step and one n-tile a head
// Both operands of the first three are rounded to bf16 in the reference, so
// one pass is exact per product; the rest take an f32 cotangent, which one
// bf16 pass would round (another function). Where the sum is rounded to bf16
// before it is used again (d(hn), dp: the gradients of bf(hn) and bf(p)),
// three passes, the operand to about 24 bits: with two (16 bits) those
// roundings fell elsewhere than the reference's often enough to move 4.4% of
// dqp's entries beyond 1e-4 of its largest (phase 1b's bound is 5%); ds,
// cheap, takes three too. Where only the final sum is rounded (dw12,
// dvproj), two (hi + lo). The products that sum over genes take
// the warps' fragments transposed (movmatrix) into shared memory and run with
// the 64 genes as K:
//   dw12   += bf(hn)^T [da | dc]     32 x 64 . 64 x 2Hd, two passes (hi, lo)
//   dvproj  = bf(p)^T d(hh)          64 x 64 . 64 x 32, two passes
//   dkfull  = ds^T bf(qp)            per head 16 x 64 . 64 x 8, three passes
// No atomics: dq and dqp (per gene, summed over the CTA's cells) and dw12
// and the LayerNorm, wv, wmu and bmu gradients (summed over its pairs) stay
// in registers across the cells; dvproj and dkfull for each cell are written
// per gene tile; each CTA writes its partials to a workspace, and
// `sum_partials` adds them in a fixed order. The gradients repeat their bits.
namespace tail {

constexpr int E = 32, H = 4, M = 16, HM = H * M, HD = E / H;
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kGenes = 16 * kWarps;  // genes a CTA
constexpr int kCells = 16;           // cells a CTA
constexpr int kLd32 = 40;            // bf16 pitch of 32-wide rows: fragment loads on 32 banks
constexpr int kLd64 = 72;            // bf16 pitch of 64-wide rows
constexpr int kNV = 3 * E + 1;       // dln2g, dln2b, dwmu, then dwv (Hd), then dbmu

__host__ __device__ constexpr int ld_w12(int Hd) { return 2 * Hd + 8; }

// floats of one CTA's dw12 and vector partials, padded to a multiple of 4
__host__ __device__ constexpr int wlen(int Hd) { return (E * 2 * Hd + kNV + Hd + 3) & ~3; }

// bf16 elements of shared memory, by array (each a multiple of 8)
struct Layout {
  int w12n, w12t, kc, kct, vv, vt, qpt, stage, total;
  __host__ __device__ explicit Layout(int Hd) {
    w12n = 0;                                    // bf(w12) (E, 2Hd)
    w12t = w12n + E * ld_w12(Hd);                // bf(w12)^T (2Hd, E)
    kc = w12t + 2 * Hd * kLd32;                  // the cell's head blocks of bf(kfull) (HM, E)
    kct = kc + HM * kLd32;                       // and transposed (E, HM)
    vv = kct + E * kLd64;                        // bf(vproj) (HM, E)
    vt = vv + HM * kLd32;                        // and transposed (E, HM)
    qpt = vt + E * kLd64;                        // bf(qp)^T of the gene tile (E, genes)
    stage = qpt + E * kLd64;                     // the transposed operands of the gene sums
    const int phase1 = (E + 2 * 2 * Hd) * kLd64;  // bf(hn)^T, [da | dc]^T hi and lo
    const int phase2 = (HM + 3 * HM + 2 * E) * kLd64;  // bf(p)^T, ds^T in 3, d(hh)^T in 2
    total = stage + (phase1 > phase2 ? phase1 : phase2);
  }
};

__host__ __device__ inline int smem_bytes(int Hd) {
  return 2 * Layout(Hd).total + 4 * (3 * E + Hd);  // + ln2g, ln2b, wmu, wv in f32
}

// rounds to bf16
__device__ __forceinline__ __nv_bfloat16 b16(float v) { return __float2bfloat16_rn(v); }

// stores the 8 x 8 block whose row gq, columns 2tq, 2tq + 1 this lane holds
// (packed) transposed: row-major at dst (pitch ld), lane 4 gq + tq writing
// row gq, columns 2tq, 2tq + 1 of the transpose
__device__ __forceinline__ void store_t(__nv_bfloat16* dst, int ld, uint32_t pair, int gq, int tq) {
  *reinterpret_cast<uint32_t*>(dst + gq * ld + 2 * tq) = tc::transpose8x8(pair);
}

// -- the forward ------------------------------------------------------------------

// bf16 elements of the forward's shared memory before its f32 arrays:
// bf(w12)^T with the hidden width padded to 8 NH (a rows, then c rows; 2 * 8
// NH x E), the cell's head blocks of bf(kfull) (HM, E) and bf(vproj)^T (E, HM)
__host__ __device__ inline int fwd_bf16_elems(int NH) {
  return 2 * 8 * NH * kLd32 + HM * kLd32 + E * kLd64;
}

// + ln2g, ln2b, wmu (E each) and wv (8 NH, zero-padded) in f32
__host__ __device__ inline int fwd_smem_bytes(int Hd) {
  const int NH = (Hd + 7) / 8;
  return 2 * fwd_bf16_elems(NH) + 4 * (3 * E + 8 * NH);
}

// One CTA: 64 genes (16 a warp) and the cells [16 blockIdx.y, + 16), grid
// (ceil(G / 64), ceil(B / 16)). Per cell each warp computes its 16 pairs'
// logits in mma fragments:
//   scores  bf(qp) kc^T      16 x 32 . 32 x 64, one k16 step a head's block
//   y       bf(p) bf(vproj)  16 x 64 . 64 x 32
//   [a | c] bf(hn) bf(w12)   16 x 32 . 32 x 2Hd, 8 hidden columns of each at a time
// each one bf16 pass with f32 sums; then logit = wmu . hh + sum silu(a) c wv +
// bmu, summed over the quad's columns.
__global__ void __launch_bounds__(kThreads)
tail_fwd(const float* __restrict__ qp, const float* __restrict__ q,
         const float* __restrict__ kfull, const float* __restrict__ vproj,
         const float* __restrict__ ln2g, const float* __restrict__ ln2b,
         const float* __restrict__ w12, const float* __restrict__ wv,
         const float* __restrict__ wmu, const float* __restrict__ bmu, float* __restrict__ out,
         int B, int G, int Hd, float eps, float scale) {
  const int NH = (Hd + 7) / 8, NP = 8 * NH;  // hidden tiles of 8; the padded width
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w12t = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (2 NP, E)
  __nv_bfloat16* kc = w12t + 2 * NP * kLd32;                          // (HM, E)
  __nv_bfloat16* vt = kc + HM * kLd32;                                // (E, HM)
  float* fg = reinterpret_cast<float*>(w12t + fwd_bf16_elems(NH));    // ln2g (E)
  float* fb = fg + E;                                                 // ln2b (E)
  float* fmu = fb + E;                                                // wmu (E)
  float* fwv = fmu + E;                                               // wv (NP)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int g0 = blockIdx.x * kGenes;
  const int b0 = blockIdx.y * kCells, b1 = min(B, b0 + kCells);

  // -- the weights, once --------------------------------------------------------
  for (int i = tid; i < E * NP; i += kThreads) {
    const int e = i / NP, n = i % NP;
    const bool in = n < Hd;
    w12t[n * kLd32 + e] = b16(in ? w12[(size_t)e * 2 * Hd + n] : 0.0f);
    w12t[(NP + n) * kLd32 + e] = b16(in ? w12[(size_t)e * 2 * Hd + Hd + n] : 0.0f);
  }
  for (int i = tid; i < 3 * E + NP; i += kThreads)
    fg[i] = i < E ? ln2g[i] : i < 2 * E ? ln2b[i - E] : i < 3 * E ? wmu[i - 2 * E]
          : i - 3 * E < Hd ? wv[i - 3 * E] : 0.0f;
  const float bias = bmu[0];

  // this lane's two genes (a gene past the edge reads the last one and is not written)
  int gene[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    gene[r] = g0 + 16 * warp + gq + 8 * r;
    valid[r] = gene[r] < G;
    if (!valid[r]) gene[r] = G - 1;
  }
  uint32_t qpa[2][4];  // bf(qp) as the scores' A fragments, k16 steps 0 and 1
  float qv[4][4];      // q in the accumulator layout: columns 8n + 2tq (+1), genes r
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 v = *reinterpret_cast<const float2*>(qp + (size_t)gene[r] * E + 16 * kk +
                                                          8 * hf + 2 * tq);
        qpa[kk][r + 2 * hf] = tc::pack_bf16(v.x, v.y);
      }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(q + (size_t)gene[r] * E + 8 * n + 2 * tq);
      qv[n][2 * r] = v.x;
      qv[n][2 * r + 1] = v.y;
    }

  for (int b = b0; b < b1; ++b) {
    __syncthreads();  // the weights are in; the last cell's readers of kc and vt are done
    {
      const float* kr = kfull + (size_t)b * HM * E;
      const float* vr = vproj + (size_t)b * HM * E;
      for (int i = tid; i < HM * E; i += kThreads) {
        const int hm = i / E, e = i % E;
        kc[hm * kLd32 + e] = b16(e / HD == hm / M ? kr[i] : 0.0f);  // the head blocks only
        vt[e * kLd64 + hm] = b16(vr[i]);
      }
    }
    __syncthreads();

    // scores, softmax
    float p[8][4];  // the probabilities, head h in tiles 2h and 2h + 1
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
      const int kk = j / 4;  // head j / 2's columns lie in k16 step j / 4
      const __nv_bfloat16* bp = kc + (8 * j + gq) * kLd32 + 16 * kk + 2 * tq;
      tc::mma_bf16(p[j], qpa[kk], tc::load_u32(bp), tc::load_u32(bp + 8));
    }
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* s0 = &p[2 * h][2 * r];
        float* s1 = &p[2 * h + 1][2 * r];
        s0[0] *= scale; s0[1] *= scale; s1[0] *= scale; s1[1] *= scale;
        float mx = fmaxf(fmaxf(s0[0], s0[1]), fmaxf(s1[0], s1[1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        s0[0] = expf(s0[0] - mx); s0[1] = expf(s0[1] - mx);
        s1[0] = expf(s1[0] - mx); s1[1] = expf(s1[1] - mx);
        float sum = (s0[0] + s0[1]) + (s1[0] + s1[1]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        s0[0] /= sum; s0[1] /= sum; s1[0] /= sum; s1[1] /= sum;
      }
    // hh = q + bf(p) bf(vproj); lin = wmu . hh; then the LayerNorm
    float x[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {tc::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                               tc::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                               tc::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                               tc::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
        const __nv_bfloat16* bp = vt + (8 * n + gq) * kLd64 + 16 * kk + 2 * tq;
        tc::mma_bf16(x[n], a, tc::load_u32(bp), tc::load_u32(bp + 8));
      }
    }
    float logit[2];
    uint32_t hna[2][4];  // bf(hn) as the up product's A fragments
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = 0.0f, lin = 0.0f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& v = x[n][2 * r + c];
          v += qv[n][2 * r + c];
          s += v;
          lin = fmaf(v, fmu[8 * n + 2 * tq + c], lin);
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const float mean = s / E;
      float var = 0.0f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          x[n][2 * r + c] -= mean;
          var = fmaf(x[n][2 * r + c], x[n][2 * r + c], var);
        }
      var += __shfl_xor_sync(0xffffffffu, var, 1);
      var += __shfl_xor_sync(0xffffffffu, var, 2);
      const float rstd = rsqrtf(var / E + eps);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 8 * n + 2 * tq;
        hna[n / 2][r + 2 * (n % 2)] =
            tc::pack_bf16(__fadd_rn(__fmul_rn(x[n][2 * r] * rstd, fg[col]), fb[col]),
                          __fadd_rn(__fmul_rn(x[n][2 * r + 1] * rstd, fg[col + 1]), fb[col + 1]));
      }
      logit[r] = lin;
    }
    // [a | c] over 8 hidden columns at a time, and sum silu(a) c wv
    float mlp[2] = {0.0f, 0.0f};
    for (int j = 0; j < NH; ++j) {
      float a[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const __nv_bfloat16* pa = w12t + (8 * j + gq) * kLd32 + 16 * kk + 2 * tq;
        const __nv_bfloat16* pc = pa + NP * kLd32;
        tc::mma_bf16(a, hna[kk], tc::load_u32(pa), tc::load_u32(pa + 8));
        tc::mma_bf16(c, hna[kk], tc::load_u32(pc), tc::load_u32(pc + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sl = a[e] / (1.0f + expf(-a[e]));
        mlp[e >> 1] = fmaf(sl * c[e], fwv[8 * j + 2 * tq + (e & 1)], mlp[e >> 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v = logit[r] + mlp[r];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tq == 0 && valid[r]) out[(size_t)b * G + gene[r]] = v + bias;
    }
  }
}

// -- the backward -----------------------------------------------------------------

template <int NH>  // Hd = 8 NH
__global__ void __launch_bounds__(kThreads, 2)
tail_bwd(const float* __restrict__ qp, const float* __restrict__ q,
         const float* __restrict__ kfull, const float* __restrict__ vproj,
         const float* __restrict__ ln2g, const float* __restrict__ ln2b,
         const float* __restrict__ w12, const float* __restrict__ wv,
         const float* __restrict__ wmu, const float* __restrict__ dy,
         float* __restrict__ part_qq, float* __restrict__ part_dv, float* __restrict__ part_dk,
         float* __restrict__ part_w, int B, int G, float eps, float scale) {
  constexpr int Hd = 8 * NH, N2 = 2 * Hd, LW = ld_w12(Hd);
  constexpr int NJ = (2 * NH + kWarps - 1) / kWarps;  // dw12 column tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(Hd);
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w12n = sh + L.w12n;
  __nv_bfloat16* w12t = sh + L.w12t;
  __nv_bfloat16* kc = sh + L.kc;
  __nv_bfloat16* kct = sh + L.kct;
  __nv_bfloat16* vv = sh + L.vv;
  __nv_bfloat16* vt = sh + L.vt;
  __nv_bfloat16* qpt = sh + L.qpt;
  __nv_bfloat16* st = sh + L.stage;
  float* fg = reinterpret_cast<float*>(sh + L.total);  // ln2g, ln2b, wmu (E each), wv (Hd)
  float* fb = fg + E;
  float* fmu = fb + E;
  float* fwv = fmu + E;
  // phase 1 of the stage: bf(hn)^T (E, genes), [da | dc]^T hi and lo (2Hd, genes)
  __nv_bfloat16* hnT = st;
  __nv_bfloat16* dadcH = hnT + E * kLd64;
  __nv_bfloat16* dadcL = dadcH + N2 * kLd64;
  // phase 2: bf(p)^T (HM, genes), ds^T hi, mid and lo (HM, genes), d(hh)^T hi and lo
  // (E, genes)
  __nv_bfloat16* pT = st;
  __nv_bfloat16* dsH = pT + HM * kLd64;
  __nv_bfloat16* dsM = dsH + HM * kLd64;
  __nv_bfloat16* dsL = dsM + HM * kLd64;
  __nv_bfloat16* dhH = dsL + HM * kLd64;
  __nv_bfloat16* dhL = dhH + E * kLd64;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int gt = blockIdx.x, cb = blockIdx.y;
  const int g0 = gt * kGenes;
  const int b0 = cb * kCells, b1 = min(B, b0 + kCells);

  // -- the weights and the gene tile, once ----------------------------------------
  for (int i = tid; i < E * N2; i += kThreads) {
    const int e = i / N2, n = i % N2;
    const __nv_bfloat16 w = b16(w12[i]);
    w12n[e * LW + n] = w;
    w12t[n * kLd32 + e] = w;
  }
  for (int i = tid; i < 3 * E + Hd; i += kThreads)
    fg[i] = i < E ? ln2g[i] : i < 2 * E ? ln2b[i - E] : i < 3 * E ? wmu[i - 2 * E] : wv[i - 3 * E];
  for (int i = tid; i < kGenes * E; i += kThreads) {
    const int gi = i / E, e = i % E;
    qpt[e * kLd64 + gi] = b16(g0 + gi < G ? qp[(size_t)(g0 + gi) * E + e] : 0.0f);
  }

  // this lane's two genes (a gene past the edge reads the last one and takes dl = 0:
  // every contribution it makes is then 0)
  int gene[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    gene[r] = g0 + 16 * warp + gq + 8 * r;
    valid[r] = gene[r] < G;
    if (!valid[r]) gene[r] = G - 1;
  }
  uint32_t qpa[2][4];  // bf(qp) as the scores' A fragments, k16 steps 0 and 1
  float qv[4][4];      // q in the accumulator layout: columns 8n + 2tq (+1), genes r
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 v = *reinterpret_cast<const float2*>(qp + (size_t)gene[r] * E + 16 * kk +
                                                          8 * hf + 2 * tq);
        qpa[kk][r + 2 * hf] = tc::pack_bf16(v.x, v.y);
      }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(q + (size_t)gene[r] * E + 8 * n + 2 * tq);
      qv[n][2 * r] = v.x;
      qv[n][2 * r + 1] = v.y;
    }

  float dq[4][4], dqp[4][4], dw[2][NJ][4];
  float vg[4][2], vb[4][2], vmu[4][2], vwv[NH][2], vbmu = 0.0f;  // per column
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = dqp[n][e] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dw[mt][j][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < 4; ++n) vg[n][0] = vg[n][1] = vb[n][0] = vb[n][1] = vmu[n][0] = vmu[n][1] = 0.0f;
#pragma unroll
  for (int j = 0; j < NH; ++j) vwv[j][0] = vwv[j][1] = 0.0f;

  for (int b = b0; b < b1; ++b) {
    __syncthreads();  // the last cell's readers of kc, vv and the stage are done
    {
      const float* kr = kfull + (size_t)b * HM * E;
      const float* vr = vproj + (size_t)b * HM * E;
      for (int i = tid; i < HM * E; i += kThreads) {
        const int hm = i / E, e = i % E;
        const __nv_bfloat16 k = b16(e / HD == hm / M ? kr[i] : 0.0f);  // the head blocks only
        const __nv_bfloat16 v = b16(vr[i]);
        kc[hm * kLd32 + e] = k;
        kct[e * kLd64 + hm] = k;
        vv[hm * kLd32 + e] = v;
        vt[e * kLd64 + hm] = v;
      }
    }
    __syncthreads();
    float dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) dl[r] = valid[r] ? dy[(size_t)b * G + gene[r]] : 0.0f;
    if (tq == 0) vbmu += dl[0] + dl[1];  // the quad's four lanes share the genes

    // -- the forward: scores, softmax, y, hh, LayerNorm ---------------------------
    float p[8][4];  // the probabilities, head h in tiles 2h and 2h + 1
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
      const int kk = j / 4;  // head j / 2's columns lie in k16 step j / 4
      const __nv_bfloat16* bp = kc + (8 * j + gq) * kLd32 + 16 * kk + 2 * tq;
      tc::mma_bf16(p[j], qpa[kk], tc::load_u32(bp), tc::load_u32(bp + 8));
    }
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* s0 = &p[2 * h][2 * r];
        float* s1 = &p[2 * h + 1][2 * r];
        s0[0] *= scale; s0[1] *= scale; s1[0] *= scale; s1[1] *= scale;
        float mx = fmaxf(fmaxf(s0[0], s0[1]), fmaxf(s1[0], s1[1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        s0[0] = expf(s0[0] - mx); s0[1] = expf(s0[1] - mx);
        s1[0] = expf(s1[0] - mx); s1[1] = expf(s1[1] - mx);
        float sum = (s0[0] + s0[1]) + (s1[0] + s1[1]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        s0[0] /= sum; s0[1] /= sum; s1[0] /= sum; s1[1] /= sum;
      }
    float x[4][4];  // hh, then xhat
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {tc::pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                               tc::pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                               tc::pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                               tc::pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
        const __nv_bfloat16* bp = vt + (8 * n + gq) * kLd64 + 16 * kk + 2 * tq;
        tc::mma_bf16(x[n], a, tc::load_u32(bp), tc::load_u32(bp + 8));
      }
    }
    float rstd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        x[n][2 * r] += qv[n][2 * r];
        x[n][2 * r + 1] += qv[n][2 * r + 1];
        s += x[n][2 * r] + x[n][2 * r + 1];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const float mean = s / E;
      float v = 0.0f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          vmu[n][c] = fmaf(dl[r], x[n][2 * r + c], vmu[n][c]);
          x[n][2 * r + c] -= mean;
          v = fmaf(x[n][2 * r + c], x[n][2 * r + c], v);
        }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      rstd[r] = rsqrtf(v / E + eps);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        x[n][2 * r] *= rstd[r];
        x[n][2 * r + 1] *= rstd[r];
      }
    }
    // bf(hn) as the up product's A fragments, and transposed into the stage
    uint32_t hna[2][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = 8 * n + 2 * tq;
        const uint32_t pr = tc::pack_bf16(__fadd_rn(__fmul_rn(x[n][2 * r], fg[col]), fb[col]),
                                          __fadd_rn(__fmul_rn(x[n][2 * r + 1], fg[col + 1]),
                                                    fb[col + 1]));
        hna[n / 2][r + 2 * (n % 2)] = pr;
        store_t(hnT + (8 * n) * kLd64 + 16 * warp + 8 * r, kLd64, pr, gq, tq);
      }

    // -- the SwiGLU and its backward, one tile of 8 hidden columns at a time -------
    float dhn[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) dhn[n][0] = dhn[n][1] = dhn[n][2] = dhn[n][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      float a[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const __nv_bfloat16* pa = w12t + (8 * j + gq) * kLd32 + 16 * kk + 2 * tq;
        const __nv_bfloat16* pc = pa + Hd * kLd32;
        tc::mma_bf16(a, hna[kk], tc::load_u32(pa), tc::load_u32(pa + 8));
        tc::mma_bf16(c, hna[kk], tc::load_u32(pc), tc::load_u32(pc + 8));
      }
      float da[4], dc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 8 * j + 2 * tq + (e & 1);
        const float d = dl[e >> 1];
        const float sg = 1.0f / (1.0f + expf(-a[e]));
        const float sl = a[e] * sg;
        vwv[j][e & 1] = fmaf(d, sl * c[e], vwv[j][e & 1]);
        const float dg3 = d * fwv[n];
        da[e] = dg3 * c[e] * (sg * (1.0f + a[e] * (1.0f - sg)));
        dc[e] = dg3 * sl;
      }
      // [da | dc] of the tile as one k16 step: hi, mid and lo for d(hn), whose
      // sums are rounded to bf16 next; hi and lo (mid + lo rounded) for dw12
      uint32_t ah[4], am[4], al[4];
      tc::split3_bf16(da[0], da[1], ah[0], am[0], al[0]);
      tc::split3_bf16(da[2], da[3], ah[1], am[1], al[1]);
      tc::split3_bf16(dc[0], dc[1], ah[2], am[2], al[2]);
      tc::split3_bf16(dc[2], dc[3], ah[3], am[3], al[3]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const __nv_bfloat16* bp = w12n + (8 * nn + gq) * LW + 8 * j + 2 * tq;
        const uint32_t bb0 = tc::load_u32(bp), bb1 = tc::load_u32(bp + Hd);
        tc::mma_bf16(dhn[nn], al, bb0, bb1);
        tc::mma_bf16(dhn[nn], am, bb0, bb1);
        tc::mma_bf16(dhn[nn], ah, bb0, bb1);
      }
      uint32_t dh[4], dlo[4];
      tc::split_bf16(da[0], da[1], dh[0], dlo[0]);
      tc::split_bf16(da[2], da[3], dh[1], dlo[1]);
      tc::split_bf16(dc[0], dc[1], dh[2], dlo[2]);
      tc::split_bf16(dc[2], dc[3], dh[3], dlo[3]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = 16 * warp + 8 * r;
        store_t(dadcH + (8 * j) * kLd64 + at, kLd64, dh[r], gq, tq);
        store_t(dadcL + (8 * j) * kLd64 + at, kLd64, dlo[r], gq, tq);
        store_t(dadcH + (Hd + 8 * j) * kLd64 + at, kLd64, dh[2 + r], gq, tq);
        store_t(dadcL + (Hd + 8 * j) * kLd64 + at, kLd64, dlo[2 + r], gq, tq);
      }
    }

    // -- the LayerNorm backward: d(hh) (in dhn) ---------------------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * n + 2 * tq + c;
          float& d = dhn[n][2 * r + c];
          d = __bfloat162float(b16(d));  // the gradient of bf(hn), rounded as the reference's
          vg[n][c] = fmaf(d, x[n][2 * r + c], vg[n][c]);
          vb[n][c] += d;
          d *= fg[col];  // d(xhat)
          m1 += d;
          m2 = fmaf(d, x[n][2 * r + c], m2);
        }
      m1 += __shfl_xor_sync(0xffffffffu, m1, 1);
      m1 += __shfl_xor_sync(0xffffffffu, m1, 2);
      m2 += __shfl_xor_sync(0xffffffffu, m2, 1);
      m2 += __shfl_xor_sync(0xffffffffu, m2, 2);
      m1 /= E;
      m2 /= E;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& d = dhn[n][2 * r + c];
          d = fmaf(dl[r], fmu[8 * n + 2 * tq + c], rstd[r] * (d - m1 - x[n][2 * r + c] * m2));
          dq[n][2 * r + c] += d;
        }
    }

    // -- dw12 += bf(hn)^T [da | dc] over the tile's 64 genes ------------------------
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int jn = warp + kWarps * jj;
      if (jn >= 2 * NH) break;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* bh = dadcH + (8 * jn + gq) * kLd64 + 16 * kk + 2 * tq;
        const __nv_bfloat16* bl = dadcL + (8 * jn + gq) * kLd64 + 16 * kk + 2 * tq;
        const uint32_t h0 = tc::load_u32(bh), h1 = tc::load_u32(bh + 8);
        const uint32_t l0 = tc::load_u32(bl), l1 = tc::load_u32(bl + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* ap = hnT + (16 * mt + gq) * kLd64 + 16 * kk + 2 * tq;
          const uint32_t a[4] = {tc::load_u32(ap), tc::load_u32(ap + 8 * kLd64),
                                 tc::load_u32(ap + 8), tc::load_u32(ap + 8 * kLd64 + 8)};
          tc::mma_bf16(dw[mt][jj], a, h0, h1);
          tc::mma_bf16(dw[mt][jj], a, l0, l1);
        }
      }
    }
    __syncthreads();  // phase 2 overwrites the stage

    // -- the attention backward: dp, ds, dqp --------------------------------------
    // d(hh) as A fragments in three passes for dp (rounded to bf16 next), and
    // as hi and lo (mid + lo rounded) transposed into the stage for dvproj
    uint32_t dha[2][4], dma[2][4], dla[2][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = r + 2 * (n % 2);
        tc::split3_bf16(dhn[n][2 * r], dhn[n][2 * r + 1], dha[n / 2][at], dma[n / 2][at],
                        dla[n / 2][at]);
        uint32_t hi, lo;
        tc::split_bf16(dhn[n][2 * r], dhn[n][2 * r + 1], hi, lo);
        store_t(dhH + (8 * n) * kLd64 + 16 * warp + 8 * r, kLd64, hi, gq, tq);
        store_t(dhL + (8 * n) * kLd64 + 16 * warp + 8 * r, kLd64, lo, gq, tq);
      }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float dp[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = 2 * h + t;
        dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const __nv_bfloat16* bp = vv + (8 * j + gq) * kLd32 + 16 * kk + 2 * tq;
          const uint32_t bb0 = tc::load_u32(bp), bb1 = tc::load_u32(bp + 8);
          tc::mma_bf16(dp[t], dla[kk], bb0, bb1);
          tc::mma_bf16(dp[t], dma[kk], bb0, bb1);
          tc::mma_bf16(dp[t], dha[kk], bb0, bb1);
        }
      }
      // ds = p (dp - sum_m p dp) scale, dp rounded as the gradient of bf(p)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float cs = 0.0f;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& d = dp[t][2 * r + c];
            d = __bfloat162float(b16(d));
            cs = fmaf(p[2 * h + t][2 * r + c], d, cs);
          }
        cs += __shfl_xor_sync(0xffffffffu, cs, 1);
        cs += __shfl_xor_sync(0xffffffffu, cs, 2);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            dp[t][2 * r + c] = p[2 * h + t][2 * r + c] * (dp[t][2 * r + c] - cs) * scale;
      }
      // dqp[head h's columns] += ds_h kc_h: k16 step h, n-tile h; bf(p) and ds
      // transposed into the stage
      uint32_t sh4[4], sm4[4], sl4[4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tc::split3_bf16(dp[t][2 * r], dp[t][2 * r + 1], sh4[r + 2 * t], sm4[r + 2 * t],
                          sl4[r + 2 * t]);
          const int row = 8 * (2 * h + t), at = 16 * warp + 8 * r;
          store_t(dsH + row * kLd64 + at, kLd64, sh4[r + 2 * t], gq, tq);
          store_t(dsM + row * kLd64 + at, kLd64, sm4[r + 2 * t], gq, tq);
          store_t(dsL + row * kLd64 + at, kLd64, sl4[r + 2 * t], gq, tq);
          store_t(pT + row * kLd64 + at, kLd64,
                  tc::pack_bf16(p[2 * h + t][2 * r], p[2 * h + t][2 * r + 1]), gq, tq);
        }
      const __nv_bfloat16* bp = kct + (8 * h + gq) * kLd64 + 16 * h + 2 * tq;
      const uint32_t bb0 = tc::load_u32(bp), bb1 = tc::load_u32(bp + 8);
      tc::mma_bf16(dqp[h], sl4, bb0, bb1);
      tc::mma_bf16(dqp[h], sm4, bb0, bb1);
      tc::mma_bf16(dqp[h], sh4, bb0, bb1);
    }
    __syncthreads();

    // -- dvproj (warp w: rows 16w.. of HM) and dkfull's head block w of this cell ---
    {
      float dv[4][4], dk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 4; ++n) dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k0 = 16 * kk + 2 * tq;
        const __nv_bfloat16* ap = pT + (16 * warp + gq) * kLd64 + k0;
        const uint32_t a[4] = {tc::load_u32(ap), tc::load_u32(ap + 8 * kLd64),
                               tc::load_u32(ap + 8), tc::load_u32(ap + 8 * kLd64 + 8)};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const __nv_bfloat16* bh = dhH + (8 * n + gq) * kLd64 + k0;
          const __nv_bfloat16* bl = dhL + (8 * n + gq) * kLd64 + k0;
          tc::mma_bf16(dv[n], a, tc::load_u32(bh), tc::load_u32(bh + 8));
          tc::mma_bf16(dv[n], a, tc::load_u32(bl), tc::load_u32(bl + 8));
        }
        const __nv_bfloat16* bq = qpt + (8 * warp + gq) * kLd64 + k0;
        const uint32_t q0 = tc::load_u32(bq), q1 = tc::load_u32(bq + 8);
#pragma unroll
        for (const __nv_bfloat16* part : {dsL, dsM, dsH}) {
          const __nv_bfloat16* sp = part + (16 * warp + gq) * kLd64 + k0;
          const uint32_t a[4] = {tc::load_u32(sp), tc::load_u32(sp + 8 * kLd64),
                                 tc::load_u32(sp + 8), tc::load_u32(sp + 8 * kLd64 + 8)};
          tc::mma_bf16(dk, a, q0, q1);
        }
      }
      float* pv = part_dv + ((size_t)gt * B + b) * HM * E;
      float* pk = part_dk + ((size_t)gt * B + b) * HM * HD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int hm = 16 * warp + gq + 8 * r;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<float2*>(pv + hm * E + 8 * n + 2 * tq) =
              make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
        *reinterpret_cast<float2*>(pk + hm * HD + 2 * tq) = make_float2(dk[2 * r], dk[2 * r + 1]);
      }
    }
  }

  // -- the CTA's partials -------------------------------------------------------
  {
    // dqp, dq of each gene over the CTA's cells: part_qq (cell blocks, 2, G, E)
    const size_t GE = (size_t)G * E;
    float* pq = part_qq + (size_t)cb * 2 * GE;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!valid[r]) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const size_t o = (size_t)gene[r] * E + 8 * n + 2 * tq;
        *reinterpret_cast<float2*>(pq + o) = make_float2(dqp[n][2 * r], dqp[n][2 * r + 1]);
        *reinterpret_cast<float2*>(pq + GE + o) = make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
      }
    }
  }
  // dw12 (E, 2Hd) and the vector sums, in part_w (CTAs, E * 2Hd + 3E + Hd + 1)
  const int nw = wlen(Hd);
  float* pw = part_w + ((size_t)cb * gridDim.x + gt) * nw;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int jn = warp + kWarps * jj;
    if (jn >= 2 * NH) break;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(pw + (16 * mt + gq + 8 * r) * N2 + 8 * jn + 2 * tq) =
            make_float2(dw[mt][jj][2 * r], dw[mt][jj][2 * r + 1]);
  }
  // the per-column sums over the lanes of one tq (xor 4, 8, 16), then the warps in order
  __syncthreads();
  float* red = reinterpret_cast<float*>(st);  // [kWarps][3E + Hd + 1]
  const int nv = 3 * E + Hd + 1;
  auto lanes = [&](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    return v + __shfl_xor_sync(0xffffffffu, v, 16);
  };
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * n + 2 * tq + c;
      const float g = lanes(vg[n][c]), bb = lanes(vb[n][c]), mu = lanes(vmu[n][c]);
      if (gq == 0) {
        red[warp * nv + col] = g;
        red[warp * nv + E + col] = bb;
        red[warp * nv + 2 * E + col] = mu;
      }
    }
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float w = lanes(vwv[j][c]);
      if (gq == 0) red[warp * nv + 3 * E + 8 * j + 2 * tq + c] = w;
    }
  {
    float s = lanes(vbmu);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (lane == 0) red[warp * nv + nv - 1] = s;
  }
  __syncthreads();
  for (int i = tid; i < nv; i += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * nv + i];
    pw[E * N2 + i] = s;
  }
}

// One reduction of partials: out[o, i] = sum over p < P, in order, of
// part[(o * P + p) * inner + i], for o < outer, i < inner; with `dk`, out is
// dkfull (B, HM, E) and the compact head blocks (B, HM, HD) land in theirs.
struct Sum {
  const float* part;
  float* out;
  long long inner;
  int P, outer, dk;
  long long first;  // the job's first thread
};

struct Sums {
  Sum job[4];
  int n;
};

__global__ void __launch_bounds__(256) sum_partials(const __grid_constant__ Sums s) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  int j = 0;
  while (j + 1 < s.n && idx >= s.job[j + 1].first) ++j;
  const Sum jb = s.job[j];
  const long long t = idx - jb.first;
  if (t >= jb.inner * jb.outer) return;
  const long long o = t / jb.inner, i = t % jb.inner;
  const float* src = jb.part + o * jb.P * jb.inner + i;
  float acc = 0.0f;
#pragma unroll 4
  for (int p = 0; p < jb.P; ++p) acc += src[(long long)p * jb.inner];
  long long at = o * jb.inner + i;
  if (jb.dk) {  // compact (b, hm, d) -> dkfull (b, hm, (hm / M) * HD + d)
    const long long hm = (at / HD) % HM, d = at % HD, bb = at / (HM * HD);
    at = (bb * HM + hm) * E + (hm / M) * HD + d;
  }
  jb.out[at] = acc;
}

cudaError_t launch_sums(Sums s, cudaStream_t stream) {
  long long total = 0;
  for (int j = 0; j < s.n; ++j) {
    s.job[j].first = total;
    total += s.job[j].inner * s.job[j].outer;
  }
  if (total == 0) return cudaSuccess;
  sum_partials<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(s);
  return cudaGetLastError();
}

// floats of the backward's workspace (the partials, then the dw12 and vector
// partials summed over gene tiles), in order: qq, dv, dk, w, w per cell block
long long workspace_floats(int B, int G, int Hd) {
  const long long n_gt = (G + kGenes - 1) / kGenes, n_cb = (B + kCells - 1) / kCells;
  const long long nw = wlen(Hd);
  return n_cb * 2 * G * E + n_gt * B * HM * (E + HD) + n_gt * n_cb * nw + n_cb * nw;
}

}  // namespace tail

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
  const long long smem = tail::fwd_smem_bytes(Hd);
  cudaError_t err = allow_smem(tail::tail_fwd, g_fwd_allowed, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G + tail::kGenes - 1) / tail::kGenes, (B + tail::kCells - 1) / tail::kCells);
  tail::tail_fwd<<<grid, tail::kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)qp, (const float*)q, (const float*)kfull, (const float*)vproj,
      (const float*)ln2g, (const float*)ln2b, (const float*)w12, (const float*)wv,
      (const float*)wmu, (const float*)bmu, (float*)out, B, G, Hd, eps, scale);
  return (int)cudaGetLastError();
}

// Backward, in three launches: the tensor-core kernel writes its partials to
// `workspace` (scldm_decoder_tail_backward_workspace_floats(B, G, Hd) floats)
// and two launches of sum_partials add them in a fixed order into qq (2, G,
// E): dqp then dq; dkfull (B, H*M, E), of which only the head blocks are
// written (the caller zeroes it); dvproj (B, H*M, E); and wvec: dw12 (E, 2Hd),
// dln2g, dln2b, dwmu (E each), dwv (Hd), dbmu (1), padded to a multiple of 4. Pointers as the forward's,
// dy (B, G). Compiled for Hd = 88 (cudaErrorInvalidValue otherwise).
int scldm_decoder_tail_backward(const void* qp, const void* q, const void* kfull,
                                const void* vproj, const void* ln2g, const void* ln2b,
                                const void* w12, const void* wv, const void* wmu,
                                const void* dy, void* qq, void* dkfull, void* dvproj,
                                void* wvec, void* workspace, int B, int G, int E, int H, int M,
                                int Hd, float eps, float scale, void* stream) {
  if (B == 0 || G == 0) return 0;
  if (!supported(E, H, M) || Hd != 88) return (int)cudaErrorInvalidValue;
  using tail::HD;
  using tail::HM;
  using tail::Sums;
  cudaStream_t s = (cudaStream_t)stream;
  auto kernel = tail::tail_bwd<11>;
  const long long smem = tail::smem_bytes(Hd);
  cudaError_t err = allow_smem(kernel, g_bwd_allowed, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_gt = (G + tail::kGenes - 1) / tail::kGenes;
  const int n_cb = (B + tail::kCells - 1) / tail::kCells;
  const long long nw = tail::wlen(Hd);
  float* part_qq = (float*)workspace;
  float* part_dv = part_qq + (long long)n_cb * 2 * G * E;
  float* part_dk = part_dv + (long long)n_gt * B * HM * E;
  float* part_w = part_dk + (long long)n_gt * B * HM * HD;
  float* sum_w = part_w + (long long)n_gt * n_cb * nw;
  kernel<<<dim3(n_gt, n_cb), tail::kThreads, (size_t)smem, s>>>(
      (const float*)qp, (const float*)q, (const float*)kfull, (const float*)vproj,
      (const float*)ln2g, (const float*)ln2b, (const float*)w12, (const float*)wv,
      (const float*)wmu, (const float*)dy, part_qq, part_dv, part_dk, part_w, B, G, eps, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  Sums first{};
  first.job[0] = {part_qq, (float*)qq, 2LL * G * E, n_cb, 1, 0, 0};
  first.job[1] = {part_dv, (float*)dvproj, (long long)B * HM * E, n_gt, 1, 0, 0};
  first.job[2] = {part_dk, (float*)dkfull, (long long)B * HM * HD, n_gt, 1, 1, 0};
  first.job[3] = {part_w, sum_w, nw, n_gt, n_cb, 0, 0};  // over gene tiles, per cell block
  first.n = 4;
  if ((err = tail::launch_sums(first, s)) != cudaSuccess) return (int)err;
  Sums second{};
  second.job[0] = {sum_w, (float*)wvec, nw, n_cb, 1, 0, 0};
  second.n = 1;
  return (int)tail::launch_sums(second, s);
}

long long scldm_decoder_tail_backward_workspace_floats(int B, int G, int Hd) {
  return tail::workspace_floats(B, G, Hd);
}

}  // extern "C"
