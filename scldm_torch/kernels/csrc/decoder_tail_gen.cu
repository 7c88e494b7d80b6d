// The VAE decoder tail at any width the JAX gate dispatches (E <= 128, any
// head count dividing E, 1 to 64 latent tokens, any SwiGLU hidden width):
// forward and recompute backward on mma.sync bf16 with f32 sums. The math
// is decoder_tail.cu's (`_tail_math` in scldm_tpu/ops/fused_decoder.py,
// `decoder_tail_reference` in scldm_torch/ops/fused_decoder.py); that file
// keeps its kernels for the dentate decoder (E = 32, 4 heads, 16 tokens,
// hidden 88), which it runs itself, and hands every other shape here.
//
// Design. Every operand a product reads as its B (or, transposed, A) side is
// packed once a launch into fragment order (frag_tile.cuh: bf(kfull)'s head
// blocks and bf(vproj) per cell and head, both ways round; bf(w12) three
// ways), zero-padded to E rounded up to 32, 64 or 128, M to a multiple of
// 16 and the hidden width to a multiple of 8, so ragged sizes cost nothing
// but the padding and LayerNorm statistics stay over the true E. A warp is
// the unit of work and owns its sums; no CTA shares anything. Each kernel's
// warps take their units one after another (a grid of the CTAs the device
// holds at once, `ft::resident_blocks`), so small units spread evenly over the
// SMs; which warp takes a unit changes no bit.
//   forward   a warp takes 16 genes and a block of cells: per cell and head
//             the scores bf(qp) kc^T over the head's k16 steps, the softmax
//             (keys past M at -inf), y += bf(p) bf(vproj); then hh = q + y,
//             the LayerNorm, [a | c] = bf(hn) bf(w12) 8 hidden columns at a
//             time and the logit.
//   backward  four kernels and a fixed-order sum, no atomics:
//     chain   per (16 genes, cell block): the forward again, d(hn) = [da |
//             dc] bf(w12)^T (three bf16 passes), its rounding to bf16, the
//             LayerNorm backward to d(hh), then per head dp = d(hh)
//             bf(vproj)^T (three passes), ds and dqp += ds kc (three); dq,
//             dqp and the dln2g, dln2b, dwmu, dbmu sums per warp; d(hh) (f32)
//             and bf(hn) written per pair to the workspace.
//     attn    per (cell, head, gene chunk, 32 columns of E), products with
//             the keys on the rows: s^T = kc bf(qp)^T, the softmax down the
//             columns, dvproj += bf(p)^T d(hh) (three passes: d(hh) f32); the
//             first column slice also dp^T = bf(vproj) d(hh)^T (three
//             passes), ds^T and dkfull's head block += ds^T bf(qp) (three).
//     w12     per (16 hidden columns, pair chunk): [a | c]^T = bf(w12)^T
//             bf(hn)^T from the saved bf(hn), [da | dc]^T, dwv, and dw12^T
//             += [da | dc]^T bf(hn) (three passes).
//     sums    `ft::sum_parts` adds every partial in index order (the vector
//             sums in two levels: per cell block, then over the blocks).
// The gradients repeat their bits. The workspace (`scldm_decoder_tail_gen_workspace_floats`)
// holds the packed operands, d(hh) and bf(hn) per pair (6 E bytes a pair) and
// the partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "frag_tile.cuh"

namespace tailg {
namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kMaxM = 64;         // latent tokens
constexpr int kST = kMaxM / 8;    // score tiles of 8 keys, at most
constexpr int kKM = kMaxM / 16;   // k16 steps over the keys, at most
// units of work a launch aims for: the chain's and the attention's (a warp takes
// them one after another, so many small units spread evenly over the SMs), and
// the w12 kernel's (each of its units writes an E x 2 Hd partial)
constexpr int kTargetUnits = 8192, kTargetW12 = 2048;

__host__ __device__ constexpr int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
__host__ __device__ constexpr int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// E rounded up to the kernels' widths
__host__ __device__ inline int padded_e(int E) { return E <= 32 ? 32 : E <= 64 ? 64 : 128; }

struct Dims {
  int B, G, E, H, M, Hd, hd;
  int EP, KE, NE;     // E padded, its k16 steps and 8-column tiles
  int MP, KM, NM;     // M padded to 16, likewise
  int NHT, HT16;      // hidden tiles of 8 and of 16
  int n_gt, Bc, n_cb;  // gene tiles of 16; cells a block and blocks (chain, forward)
  int NS, n_ch2;       // column slices of 32 and gene chunks (attn)
  int n_ch3;           // pair chunks (w12)
  float eps, scale;
};

Dims make_dims(int B, int G, int E, int H, int M, int Hd, float eps, float scale) {
  Dims d{};
  d.B = B, d.G = G, d.E = E, d.H = H, d.M = M, d.Hd = Hd, d.hd = E / H;
  d.EP = padded_e(E), d.KE = d.EP / 16, d.NE = d.EP / 8;
  d.MP = 16 * cdiv(M, 16), d.KM = d.MP / 16, d.NM = d.MP / 8;
  d.NHT = cdiv(Hd, 8), d.HT16 = cdiv(Hd, 16);
  d.n_gt = cdiv(G, 16);
  const int want_cb = clampi(cdiv(kTargetUnits, d.n_gt), 1, B);
  d.Bc = cdiv(B, want_cb);
  d.n_cb = cdiv(B, d.Bc);
  d.NS = d.EP / 32;
  d.n_ch2 = clampi(cdiv(kTargetUnits, (long long)B * H * d.NS), 1, d.n_gt);
  d.n_ch3 = clampi(cdiv(kTargetW12, d.HT16), 1, cdiv((long long)B * G, 16));
  d.eps = eps, d.scale = scale;
  return d;
}

// the packed operands (frag_tile.cuh's layouts; batch = cell * H + head)
struct Packs {
  const uint2 *kS, *kQ, *vY, *vP;  // kc: (k e, n m), (k m, n e); vproj likewise
  const uint4 *kA, *vA;            // kc, vproj as A: (rows m, k e)
  const uint2 *w1B, *w2B;          // bf(w1), bf(w2): (k e, n hidden)
  const uint2* w12T;               // [da | dc] steps: (k hidden 8 + 8, n e)
  const uint4 *w1A, *w2A;          // (rows hidden, k e)
};

struct Work {  // the backward's workspace pieces
  Packs pk;
  float* dhh;              // (B G, EP) f32
  __nv_bfloat16* hn;       // (B G, EP) bf16
  float *part_qq, *part_v, *part_vb, *part_dv, *part_dk, *part_w, *part_wv;
};

Work carve(const Dims& d, void* base, bool backward, long long* bytes) {
  ft::Carve c{(char*)base, 0};
  Work w{};
  const long long BH = (long long)d.B * d.H;
  w.pk.kS = c.take<uint2>(BH * d.KE * d.NM * 32);
  w.pk.vY = c.take<uint2>(BH * d.KM * d.NE * 32);
  w.pk.w1B = c.take<uint2>((long long)d.KE * d.NHT * 32);
  w.pk.w2B = c.take<uint2>((long long)d.KE * d.NHT * 32);
  if (backward) {
    const long long P = (long long)d.B * d.G;
    w.pk.kQ = c.take<uint2>(BH * d.KM * d.NE * 32);
    w.pk.vP = c.take<uint2>(BH * d.KE * d.NM * 32);
    w.pk.kA = c.take<uint4>(BH * d.KM * d.KE * 32);
    w.pk.vA = c.take<uint4>(BH * d.KM * d.KE * 32);
    w.pk.w12T = c.take<uint2>((long long)d.NHT * d.NE * 32);
    w.pk.w1A = c.take<uint4>((long long)d.HT16 * d.KE * 32);
    w.pk.w2A = c.take<uint4>((long long)d.HT16 * d.KE * 32);
    w.dhh = c.take<float>(P * d.EP);
    w.hn = c.take<__nv_bfloat16>(P * d.EP);
    w.part_qq = c.take<float>((long long)d.n_cb * 2 * d.G * d.E);
    w.part_v = c.take<float>((long long)d.n_gt * d.n_cb * (3 * d.E + 1));
    w.part_vb = c.take<float>((long long)d.n_cb * (3 * d.E + 1));
    w.part_dv = c.take<float>((long long)d.n_ch2 * d.B * d.H * d.M * d.E);
    w.part_dk = c.take<float>((long long)d.n_ch2 * d.B * d.H * d.M * d.hd);
    w.part_w = c.take<float>((long long)d.n_ch3 * d.E * 2 * d.Hd);
    w.part_wv = c.take<float>((long long)d.n_ch3 * d.Hd);
  }
  *bytes = c.used;
  return w;
}

cudaError_t pack(const Dims& d, Work& w, const float* kfull, const float* vproj,
                 const float* w12, bool backward, cudaStream_t s) {
  const int BH = d.B * d.H, HM = d.H * d.M;
  // kc's head blocks: (m, e) of head h at kfull[b][h M + m][e], columns of the head only
  ft::Mat kc = ft::mat(kfull, d.H, (long long)HM * d.E, (long long)d.M * d.E, d.E, d.M, d.E);
  kc.band_h = kc.band_w = d.hd;
  const ft::Mat vp = ft::mat(vproj, d.H, (long long)HM * d.E, (long long)d.M * d.E, d.E, d.M, d.E);
  ft::Mat kcT = kc, vpT = vp;
  kcT.trans = vpT.trans = 1;
  // bf(w1), bf(w2): (e, j) at w12[e][j] and w12[e][Hd + j]
  const ft::Mat w1 = ft::mat(w12, 1, 0, 0, 2 * d.Hd, d.E, d.Hd);
  const ft::Mat w2 = ft::mat(w12 + d.Hd, 1, 0, 0, 2 * d.Hd, d.E, d.Hd);
  cudaError_t err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.kS, kcT, BH, d.KE, d.NM, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.vY, vp, BH, d.KM, d.NE, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.w1B, w1, 1, d.KE, d.NHT, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.w2B, w2, 1, d.KE, d.NHT, s)) != cudaSuccess) return err;
  if (!backward) return cudaSuccess;
  ft::Mat w12t = ft::mat(w12, 1, 0, 0, 2 * d.Hd, d.E, 2 * d.Hd, true);
  w12t.inter = d.Hd;
  ft::Mat w1t = w1, w2t = w2;
  w1t.trans = w2t.trans = 1;
  if ((err = ft::launch_pack_b((uint2*)w.pk.kQ, kc, BH, d.KM, d.NE, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.vP, vpT, BH, d.KE, d.NM, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_a((uint4*)w.pk.kA, kc, BH, d.KM, d.KE, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_a((uint4*)w.pk.vA, vp, BH, d.KM, d.KE, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.w12T, w12t, 1, d.NHT, d.NE, s)) != cudaSuccess)
    return err;
  if ((err = ft::launch_pack_a((uint4*)w.pk.w1A, w1t, 1, d.HT16, d.KE, s)) != cudaSuccess)
    return err;
  return ft::launch_pack_a((uint4*)w.pk.w2A, w2t, 1, d.HT16, d.KE, s);
}

// -- the shared per-warp forward ----------------------------------------------------

// f32 values (x, y) of row `row` at columns c, c + 1 (0 at or past E)
__device__ __forceinline__ float2 ld2(const float* row, int c, int E) {
  return make_float2(c < E ? __ldg(row + c) : 0.f, c + 1 < E ? __ldg(row + c + 1) : 0.f);
}

// bf(qp) of the warp's genes as the A fragment of k16 step ks (rows gq, gq + 8)
__device__ __forceinline__ void qp_frag(uint32_t (&a)[4], const float* qp, const int (&gene)[2],
                                        int ks, int E, int tq) {
  const int c = 16 * ks + 2 * tq;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = ld2(qp + (size_t)gene[r] * E, c + 8 * hf, E);
      a[r + 2 * hf] = tc::pack_bf16(v.x, v.y);
    }
}

// the probabilities of head h for the warp's 16 genes and cell b: p[nt] the
// C tiles of keys 8 nt..; keys past M are 0
template <int EP>
__device__ __forceinline__ void head_probs(const Dims& d, const Packs& pk, const float* qp,
                                           const int (&gene)[2], int b, int h, float (&p)[kST][4]) {
  constexpr int KE = EP / 16;
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const long long bh = (long long)b * d.H + h;
  const int ks0 = (h * d.hd) / 16, ks1 = (h * d.hd + d.hd - 1) / 16;
#pragma unroll
  for (int nt = 0; nt < kST; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KE; ++ks) {
    if (ks < ks0 || ks > ks1) continue;
    uint32_t a[4];
    qp_frag(a, qp, gene, ks, d.E, tq);
#pragma unroll
    for (int nt = 0; nt < kST; ++nt)
      if (nt < d.NM) ft::mma(p[nt], a, ft::ldb(pk.kS, (bh * KE + ks) * d.NM + nt, lane));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kST; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool in = nt < d.NM && 8 * nt + 2 * tq + c < d.M;
        float& v = p[nt][2 * r + c];
        v = in ? v * d.scale : -INFINITY;
        mx = fmaxf(mx, v);
      }
    mx = ft::quad_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < kST; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& v = p[nt][2 * r + c];
        v = v == -INFINITY ? 0.f : expf(v - mx);
        sum += v;
      }
    sum = ft::quad_sum(sum);
#pragma unroll
    for (int nt = 0; nt < kST; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) p[nt][2 * r + c] /= sum;
  }
}

// hh = q + sum over heads bf(p) bf(vproj) in C tiles of 8 columns of E
template <int EP>
__device__ __forceinline__ void residual(const Dims& d, const Packs& pk, const float* qp,
                                         const float* q, const int (&gene)[2], int b,
                                         float (&x)[EP / 8][4]) {
  constexpr int NE = EP / 8;
  const int lane = threadIdx.x & 31, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NE; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = ld2(q + (size_t)gene[r] * d.E, 8 * nt + 2 * tq, d.E);
      x[nt][2 * r] = v.x;
      x[nt][2 * r + 1] = v.y;
    }
  }
  for (int h = 0; h < d.H; ++h) {
    float p[kST][4];
    head_probs<EP>(d, pk, qp, gene, b, h, p);
    const long long bh = (long long)b * d.H + h;
    float y[NE][4];
#pragma unroll
    for (int nt = 0; nt < NE; ++nt) y[nt][0] = y[nt][1] = y[nt][2] = y[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKM; ++ks) {
      if (ks >= d.KM) break;
      uint32_t a[4];
      ft::a_of_c(a, p[2 * ks], p[2 * ks + 1]);
#pragma unroll
      for (int nt = 0; nt < NE; ++nt) ft::mma(y[nt], a, ft::ldb(pk.vY, (bh * d.KM + ks) * NE + nt, lane));
    }
#pragma unroll
    for (int nt = 0; nt < NE; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[nt][i] += y[nt][i];
  }
}

// The LayerNorm of hh (in x) over the true E: x -> xhat (0 past E); bf(hn)
// as the up product's A fragments; returns the rows' rstd
template <int EP>
__device__ __forceinline__ void layer_norm(const Dims& d, const float* ln2g, const float* ln2b,
                                           float (&x)[EP / 8][4], uint32_t (&hna)[EP / 16][4],
                                           float (&rstd)[2]) {
  constexpr int NE = EP / 8;
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float s = 0.f;
#pragma unroll
    for (int nt = 0; nt < NE; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (8 * nt + 2 * tq + c < d.E) s += x[nt][2 * r + c];
    const float mean = ft::quad_sum(s) / d.E;
    float var = 0.f;
#pragma unroll
    for (int nt = 0; nt < NE; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& v = x[nt][2 * r + c];
        v = 8 * nt + 2 * tq + c < d.E ? v - mean : 0.f;
        var = fmaf(v, v, var);
      }
    rstd[r] = rsqrtf(ft::quad_sum(var) / d.E + d.eps);
#pragma unroll
    for (int nt = 0; nt < NE; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) x[nt][2 * r + c] *= rstd[r];
  }
  float hn[NE][4];
#pragma unroll
  for (int nt = 0; nt < NE; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 8 * nt + 2 * tq + (i & 1);
      hn[nt][i] = col < d.E ? __fadd_rn(__fmul_rn(x[nt][i], __ldg(ln2g + col)), __ldg(ln2b + col))
                            : 0.f;
    }
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks) ft::a_of_c(hna[ks], hn[2 * ks], hn[2 * ks + 1]);
}

// [a | c] of hidden tile j (8 columns each) from bf(hn)
template <int EP>
__device__ __forceinline__ void up_tile(const Packs& pk, const uint32_t (&hna)[EP / 16][4], int j,
                                        int NHT, float (&a)[4], float (&c)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = c[i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks) {
    float ta[4] = {0.f, 0.f, 0.f, 0.f}, tc_[4] = {0.f, 0.f, 0.f, 0.f};
    ft::mma(ta, hna[ks], ft::ldb(pk.w1B, (long long)ks * NHT + j, lane));
    ft::mma(tc_, hna[ks], ft::ldb(pk.w2B, (long long)ks * NHT + j, lane));
    ft::add4(a, ta);
    ft::add4(c, tc_);
  }
}

// the warp's unit: 16 genes of gene tile gt and the cells of block cb
__device__ __forceinline__ bool unit_genes(const Dims& d, int unit, int (&gene)[2], bool (&valid)[2],
                                           int& g0, int& b0, int& b1) {
  const int gt = unit % d.n_gt, cb = unit / d.n_gt;
  if (cb >= d.n_cb) return false;
  const int gq = (threadIdx.x & 31) >> 2;
  g0 = 16 * gt;
  b0 = cb * d.Bc;
  b1 = min(d.B, b0 + d.Bc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    gene[r] = g0 + gq + 8 * r;
    valid[r] = gene[r] < d.G;
    if (!valid[r]) gene[r] = d.G - 1;
  }
  return true;
}

// -- the forward ----------------------------------------------------------------------

template <int EP>
__global__ void __launch_bounds__(kThreads)
tail_fwd_gen(const Dims d, const Packs pk, const float* __restrict__ qp,
             const float* __restrict__ q, const float* __restrict__ ln2g,
             const float* __restrict__ ln2b, const float* __restrict__ wv,
             const float* __restrict__ wmu, const float* __restrict__ bmu,
             float* __restrict__ out) {
  constexpr int NE = EP / 8;
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const int units = d.n_gt * d.n_cb;  // a warp's units, one after another
  for (int unit = blockIdx.x * kWarps + (threadIdx.x >> 5); unit < units;
       unit += gridDim.x * kWarps) {
    int gene[2], g0, b0, b1;
    bool valid[2];
    if (!unit_genes(d, unit, gene, valid, g0, b0, b1)) continue;
    const float bias = __ldg(bmu);
    for (int b = b0; b < b1; ++b) {
      float x[NE][4], rstd[2];
      residual<EP>(d, pk, qp, q, gene, b, x);
      float lin[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NE; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * nt + 2 * tq + (i & 1);
          if (col < d.E) lin[i >> 1] = fmaf(x[nt][i], __ldg(wmu + col), lin[i >> 1]);
        }
      uint32_t hna[EP / 16][4];
      layer_norm<EP>(d, ln2g, ln2b, x, hna, rstd);
      float mlp[2] = {0.f, 0.f};
      for (int j = 0; j < d.NHT; ++j) {
        float a[4], c[4];
        up_tile<EP>(pk, hna, j, d.NHT, a, c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tq + (e & 1);
          const float sl = a[e] / (1.0f + expf(-a[e]));
          mlp[e >> 1] = fmaf(sl * c[e], col < d.Hd ? __ldg(wv + col) : 0.f, mlp[e >> 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = ft::quad_sum(lin[r] + mlp[r]);
        if (tq == 0 && valid[r]) out[(size_t)b * d.G + gene[r]] = v + bias;
      }
    }
  }
}

// -- the backward: the per-pair chain ---------------------------------------------------

// Thread-private accumulators in shared memory, a float4 slot (the four
// entries of a C tile) per lane: dqp, dq (NE slots each), dln2g, dln2b,
// dwmu (NE slots each, entries c and 2 + c summed as the rows go).
__host__ __device__ inline int chain_slots(int NE) { return 5 * NE; }

template <int EP>
__global__ void __launch_bounds__(kThreads)
tail_bwd_chain(const Dims d, const Packs pk, const float* __restrict__ qp,
               const float* __restrict__ q, const float* __restrict__ ln2g,
               const float* __restrict__ ln2b, const float* __restrict__ wv,
               const float* __restrict__ wmu, const float* __restrict__ dy,
               float* __restrict__ dhh_ws, __nv_bfloat16* __restrict__ hn_ws,
               float* __restrict__ part_qq, float* __restrict__ part_v) {
  constexpr int NE = EP / 8, KE = EP / 16;
  extern __shared__ __align__(16) float4 slots_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int units = d.n_gt * d.n_cb;  // a warp's units, one after another
  for (int unit = blockIdx.x * kWarps + warp; unit < units; unit += gridDim.x * kWarps) {
    int gene[2], g0, b0, b1;
    bool valid[2];
    if (!unit_genes(d, unit, gene, valid, g0, b0, b1)) continue;
    float4* slot = slots_raw + (size_t)warp * chain_slots(NE) * 32 + lane;  // slot i at [32 i]
    auto S = [&](int i) -> float4& { return slot[32 * i]; };
    for (int i = 0; i < chain_slots(NE); ++i) S(i) = make_float4(0.f, 0.f, 0.f, 0.f);
    float vbmu = 0.f;

    for (int b = b0; b < b1; ++b) {
      float dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) dl[r] = valid[r] ? __ldg(dy + (size_t)b * d.G + gene[r]) : 0.f;
      if (tq == 0) vbmu += dl[0] + dl[1];
      float x[NE][4], rstd[2];
      residual<EP>(d, pk, qp, q, gene, b, x);
#pragma unroll
      for (int nt = 0; nt < NE; ++nt) {  // dwmu += dl hh
        float4& v = S(4 * NE + nt);
        v.x = fmaf(dl[0], x[nt][0], v.x);
        v.y = fmaf(dl[0], x[nt][1], v.y);
        v.x = fmaf(dl[1], x[nt][2], v.x);
        v.y = fmaf(dl[1], x[nt][3], v.y);
      }
      uint32_t hna[KE][4];
      layer_norm<EP>(d, ln2g, ln2b, x, hna, rstd);
      // bf(hn) of the pair, for the w12 kernel
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!valid[r]) continue;
        uint32_t* row = reinterpret_cast<uint32_t*>(hn_ws + ((size_t)b * d.G + gene[r]) * EP);
#pragma unroll
        for (int ks = 0; ks < KE; ++ks) {
          row[8 * ks + tq] = hna[ks][r];
          row[8 * ks + 4 + tq] = hna[ks][2 + r];
        }
      }

      // the SwiGLU backward: d(hn) = [da | dc] bf(w12)^T, three passes a tile
      float dh[NE][4];
#pragma unroll
      for (int nt = 0; nt < NE; ++nt) dh[nt][0] = dh[nt][1] = dh[nt][2] = dh[nt][3] = 0.f;
      for (int j = 0; j < d.NHT; ++j) {
        float a[4], c[4], da[4], dc[4];
        up_tile<EP>(pk, hna, j, d.NHT, a, c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tq + (e & 1);
          const float sg = 1.0f / (1.0f + expf(-a[e]));
          const float sl = a[e] * sg;
          const float dg3 = dl[e >> 1] * (col < d.Hd ? __ldg(wv + col) : 0.f);
          da[e] = dg3 * c[e] * (sg * (1.0f + a[e] * (1.0f - sg)));
          dc[e] = dg3 * sl;
        }
        uint32_t a3[3][4];
        ft::a3_of_c(a3, da, dc);
#pragma unroll
        for (int nt = 0; nt < NE; ++nt) {
          const uint2 bb = ft::ldb(pk.w12T, (long long)j * NE + nt, lane);
          float t[4] = {0.f, 0.f, 0.f, 0.f};  // the tile from zero, added in f32
          ft::mma3a(t, a3, bb.x, bb.y);
          ft::add4(dh[nt], t);
        }
      }
      // the LayerNorm backward: d(hh), with the dl wmu of the linear term
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NE; ++nt) {
          float4& vg = S(2 * NE + nt);
          float4& vb = S(3 * NE + nt);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * nt + 2 * tq + c;
            float& v = dh[nt][2 * r + c];
            v = ft::bfr(v);  // the gradient of bf(hn), rounded as the reference's
            const float xh = x[nt][2 * r + c];
            (c ? vg.y : vg.x) = fmaf(v, xh, c ? vg.y : vg.x);
            (c ? vb.y : vb.x) += v;
            v *= col < d.E ? __ldg(ln2g + col) : 0.f;
            m1 += v;
            m2 = fmaf(v, xh, m2);
          }
        }
        m1 = ft::quad_sum(m1) / d.E;
        m2 = ft::quad_sum(m2) / d.E;
#pragma unroll
        for (int nt = 0; nt < NE; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * nt + 2 * tq + c;
            float& v = dh[nt][2 * r + c];
            v = col < d.E ? fmaf(dl[r], __ldg(wmu + col),
                                 rstd[r] * (v - m1 - x[nt][2 * r + c] * m2))
                          : 0.f;
          }
      }
#pragma unroll
      for (int nt = 0; nt < NE; ++nt) {  // dq += d(hh); d(hh) of the pair, for the attn kernel
        float4& v = S(NE + nt);
        v.x += dh[nt][0], v.y += dh[nt][1], v.z += dh[nt][2], v.w += dh[nt][3];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (valid[r])
            *reinterpret_cast<float2*>(dhh_ws + ((size_t)b * d.G + gene[r]) * EP + 8 * nt + 2 * tq) =
                make_float2(dh[nt][2 * r], dh[nt][2 * r + 1]);
      }

      // the attention backward, head by head: dp, ds, dqp += ds kc
      for (int h = 0; h < d.H; ++h) {
        const long long bh = (long long)b * d.H + h;
        float p[kST][4], dp[kST][4];
        head_probs<EP>(d, pk, qp, gene, b, h, p);
#pragma unroll
        for (int nt = 0; nt < kST; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KE; ++ks) {
          uint32_t a3[3][4];
          ft::a3_of_c(a3, dh[2 * ks], dh[2 * ks + 1]);
#pragma unroll
          for (int nt = 0; nt < kST; ++nt) {
            if (nt >= d.NM) break;
            const uint2 bb = ft::ldb(pk.vP, (bh * KE + ks) * d.NM + nt, lane);
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            ft::mma3a(t, a3, bb.x, bb.y);
            ft::add4(dp[nt], t);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float cs = 0.f;
#pragma unroll
          for (int nt = 0; nt < kST; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float& v = dp[nt][2 * r + c];
              v = ft::bfr(v);  // the gradient of bf(p)
              cs = fmaf(p[nt][2 * r + c], v, cs);
            }
          cs = ft::quad_sum(cs);
#pragma unroll
          for (int nt = 0; nt < kST; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              dp[nt][2 * r + c] = p[nt][2 * r + c] * (dp[nt][2 * r + c] - cs) * d.scale;
        }
        const int nt0 = (h * d.hd) / 8, nt1 = (h * d.hd + d.hd - 1) / 8;
        for (int nt = nt0; nt <= nt1; ++nt) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < kKM; ++ks) {
            if (ks >= d.KM) break;
            uint32_t a3[3][4];
            ft::a3_of_c(a3, dp[2 * ks], dp[2 * ks + 1]);
            const uint2 bb = ft::ldb(pk.kQ, (bh * d.KM + ks) * NE + nt, lane);
            ft::mma3a(acc, a3, bb.x, bb.y);
          }
          float4& v = S(nt);
          v.x += acc[0], v.y += acc[1], v.z += acc[2], v.w += acc[3];
        }
      }
    }

    // -- the unit's partials: dqp, dq of its genes over its cells; the vector sums
    const int cb = unit / d.n_gt;
    const size_t GE = (size_t)d.G * d.E;
    float* pq = part_qq + (size_t)cb * 2 * GE;
    for (int nt = 0; nt < NE; ++nt) {
      const float4 a = S(nt), c = S(NE + nt);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, col = 8 * nt + 2 * tq + (i & 1);
        if (valid[r] && col < d.E) {
          pq[(size_t)gene[r] * d.E + col] = av[i];
          pq[GE + (size_t)gene[r] * d.E + col] = cv[i];
        }
      }
    }
    float* pv = part_v + (size_t)unit * (3 * d.E + 1);
    for (int k = 0; k < 3; ++k)
      for (int nt = 0; nt < NE; ++nt) {
        const float4 v = S((2 + k) * NE + nt);
        const float s0 = ft::col_sum(v.x), s1 = ft::col_sum(v.y);
        const int col = 8 * nt + 2 * tq;
        if (gq == 0) {
          if (col < d.E) pv[k * d.E + col] = s0;
          if (col + 1 < d.E) pv[k * d.E + col + 1] = s1;
        }
      }
    const float s = ft::quad_sum(ft::col_sum(vbmu));
    if (lane == 0) pv[3 * d.E] = s;
  }
}

// -- the backward: keys on the rows ---------------------------------------------------

// dk accumulators in shared memory: KM x ceil(hd / 8) C tiles a warp
__host__ __device__ inline int attn_slots(int KM, int hd) { return KM * ((hd + 7) / 8); }

template <int EP>
__global__ void __launch_bounds__(kThreads, 3)  // 168 registers: three CTAs an SM
tail_bwd_attn(const Dims d, const Packs pk, const float* __restrict__ qp,
              const float* __restrict__ dhh_ws, float* __restrict__ part_dv,
              float* __restrict__ part_dk) {
  constexpr int KE = EP / 16;
  extern __shared__ __align__(16) float4 slots_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int units = d.B * d.H * d.n_ch2 * d.NS;  // a warp's units, one after another
  for (int u = blockIdx.x * kWarps + warp; u < units; u += gridDim.x * kWarps) {
    const int sl = u % d.NS, ch = (u / d.NS) % d.n_ch2;
    const int h = (u / (d.NS * d.n_ch2)) % d.H, b = u / (d.NS * d.n_ch2 * d.H);
    const long long bh = (long long)b * d.H + h;
    const int HDT = (d.hd + 7) / 8, nslots = attn_slots(d.KM, d.hd);
    float4* slot = slots_raw + (size_t)warp * nslots * 32 + lane;
    const bool keys = sl == 0;  // the first slice also takes dkfull
    if (keys)
      for (int i = 0; i < nslots; ++i) slot[32 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int tiles = cdiv(d.n_gt, d.n_ch2), t0 = ch * tiles, t1 = min(d.n_gt, t0 + tiles);
    const int ks0 = (h * d.hd) / 16, ks1 = (h * d.hd + d.hd - 1) / 16;
    const float* dh = dhh_ws + (size_t)b * d.G * EP;

    float dv[kKM][4][4];
#pragma unroll
    for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) dv[mt][nt][0] = dv[mt][nt][1] = dv[mt][nt][2] = dv[mt][nt][3] = 0.f;

    for (int t = t0; t < t1; ++t) {
      const int g0 = 16 * t;
      // s^T = kc bf(qp)^T: rows keys 16 mt + gq (+ 8), columns genes 8 nt + 2tq (+ 1)
      float p[kKM][2][4];
#pragma unroll
      for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) p[mt][nt][0] = p[mt][nt][1] = p[mt][nt][2] = p[mt][nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KE; ++ks) {
        if (ks < ks0 || ks > ks1) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int g = g0 + 8 * nt + gq;
          const float* row = qp + (size_t)min(g, d.G - 1) * d.E;
          const float2 lo = g < d.G ? ld2(row, 16 * ks + 2 * tq, d.E) : make_float2(0.f, 0.f);
          const float2 hi = g < d.G ? ld2(row, 16 * ks + 8 + 2 * tq, d.E) : make_float2(0.f, 0.f);
          const uint32_t b0 = tc::pack_bf16(lo.x, lo.y), b1 = tc::pack_bf16(hi.x, hi.y);
#pragma unroll
          for (int mt = 0; mt < kKM; ++mt) {
            if (mt >= d.KM) break;
            uint32_t a[4];
            ft::lda(a, pk.kA, (bh * d.KM + mt) * KE + ks, lane);
            tc::mma_bf16(p[mt][nt], a, b0, b1);
          }
        }
      }
      // the softmax down each column (gene), keys past M at -inf; 0 past G
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float mx = -INFINITY;
#pragma unroll
          for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& v = p[mt][nt][2 * r + c];
              v = mt < d.KM && 16 * mt + gq + 8 * r < d.M ? v * d.scale : -INFINITY;
              mx = fmaxf(mx, v);
            }
          mx = ft::col_max(mx);
          float sum = 0.f;
#pragma unroll
          for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& v = p[mt][nt][2 * r + c];
              v = v == -INFINITY ? 0.f : expf(v - mx);
              sum += v;
            }
          sum = ft::col_sum(sum);
          const bool live = g0 + 8 * nt + 2 * tq + c < d.G;
#pragma unroll
          for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& v = p[mt][nt][2 * r + c];
              v = live ? v / sum : 0.f;
            }
        }
      // dvproj (keys, this slice's 32 columns) += bf(p)^T d(hh): d(hh) f32 in three passes
      {
        uint32_t b0[4][3], b1[4][3];  // per column tile and pass: genes 2tq.. and 2tq + 8..
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int e = 32 * sl + 8 * nt + gq;
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int g = g0 + 2 * tq + (k & 1) + 8 * (k >> 1);
            v[k] = g < d.G ? dh[(size_t)g * EP + e] : 0.f;
          }
          tc::split3_bf16(v[0], v[1], b0[nt][0], b0[nt][1], b0[nt][2]);
          tc::split3_bf16(v[2], v[3], b1[nt][0], b1[nt][1], b1[nt][2]);
        }
#pragma unroll
        for (int mt = 0; mt < kKM; ++mt) {
          if (mt >= d.KM) break;
          uint32_t a[4];
          ft::a_of_c(a, p[mt][0], p[mt][1]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};  // the 16 genes from zero, added in f32
#pragma unroll
            for (int q = 2; q >= 0; --q) tc::mma_bf16(t, a, b0[nt][q], b1[nt][q]);
            ft::add4(dv[mt][nt], t);
          }
        }
      }
      if (!keys) continue;
      // dp^T = bf(vproj) d(hh)^T (d(hh) in three passes), rounded as the gradient of bf(p)
      float dp[kKM][2][4];
#pragma unroll
      for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) dp[mt][nt][0] = dp[mt][nt][1] = dp[mt][nt][2] = dp[mt][nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KE; ++ks) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int g = g0 + 8 * nt + gq;
          float2 lo = make_float2(0.f, 0.f), hi = lo;
          if (g < d.G) {
            lo = *reinterpret_cast<const float2*>(dh + (size_t)g * EP + 16 * ks + 2 * tq);
            hi = *reinterpret_cast<const float2*>(dh + (size_t)g * EP + 16 * ks + 8 + 2 * tq);
          }
          uint32_t b0[3], b1[3];
          tc::split3_bf16(lo.x, lo.y, b0[0], b0[1], b0[2]);
          tc::split3_bf16(hi.x, hi.y, b1[0], b1[1], b1[2]);
#pragma unroll
          for (int mt = 0; mt < kKM; ++mt) {
            if (mt >= d.KM) break;
            uint32_t a[4];
            ft::lda(a, pk.vA, (bh * d.KM + mt) * KE + ks, lane);
            float t[4] = {0.f, 0.f, 0.f, 0.f};
            tc::mma_bf16(t, a, b0[2], b1[2]);
            tc::mma_bf16(t, a, b0[1], b1[1]);
            tc::mma_bf16(t, a, b0[0], b1[0]);
            ft::add4(dp[mt][nt], t);
          }
        }
      }
      // ds^T = p (dp - sum over keys p dp) scale
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float cs = 0.f;
#pragma unroll
          for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& v = dp[mt][nt][2 * r + c];
              v = ft::bfr(v);
              cs = fmaf(p[mt][nt][2 * r + c], v, cs);
            }
          cs = ft::col_sum(cs);
#pragma unroll
          for (int mt = 0; mt < kKM; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& v = dp[mt][nt][2 * r + c];
              v = p[mt][nt][2 * r + c] * (v - cs) * d.scale;
            }
        }
      // dkfull's head block (keys, d) += ds^T bf(qp): three passes, k = the 16 genes
      for (int nt = 0; nt < HDT; ++nt) {
        const int col = h * d.hd + 8 * nt + gq;
        const bool in = 8 * nt + gq < d.hd;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int g = g0 + 2 * tq + (k & 1) + 8 * (k >> 1);
          v[k] = in && g < d.G ? __ldg(qp + (size_t)g * d.E + col) : 0.f;
        }
        const uint32_t q0 = tc::pack_bf16(v[0], v[1]), q1 = tc::pack_bf16(v[2], v[3]);
#pragma unroll
        for (int mt = 0; mt < kKM; ++mt) {
          if (mt >= d.KM) break;
          uint32_t a3[3][4];
          ft::a3_of_c(a3, dp[mt][0], dp[mt][1]);
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          ft::mma3a(acc, a3, q0, q1);
          float4& s = slot[32 * (mt * HDT + nt)];
          s.x += acc[0], s.y += acc[1], s.z += acc[2], s.w += acc[3];
        }
      }
    }

    // -- the unit's partials
    const int HM = d.H * d.M;
    float* pv = part_dv + ((size_t)ch * d.B + b) * HM * d.E;
#pragma unroll
    for (int mt = 0; mt < kKM; ++mt) {
      if (mt >= d.KM) break;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = 16 * mt + gq + 8 * (i >> 1), e = 32 * sl + 8 * nt + 2 * tq + (i & 1);
          if (m < d.M && e < d.E) pv[(size_t)(h * d.M + m) * d.E + e] = dv[mt][nt][i];
        }
    }
    if (!keys) continue;
    float* pk_ = part_dk + ((size_t)ch * d.B + b) * HM * d.hd;
    for (int mt = 0; mt < d.KM; ++mt)
      for (int nt = 0; nt < HDT; ++nt) {
        const float4 s = slot[32 * (mt * HDT + nt)];
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = 16 * mt + gq + 8 * (i >> 1), dd = 8 * nt + 2 * tq + (i & 1);
          if (m < d.M && dd < d.hd) pk_[(size_t)(h * d.M + m) * d.hd + dd] = sv[i];
        }
      }
  }
}

// -- the backward: the weight gradient of w12 ------------------------------------------

template <int EP>
__global__ void __launch_bounds__(kThreads)
tail_bwd_w12(const Dims d, const Packs pk, const __nv_bfloat16* __restrict__ hn_ws,
             const float* __restrict__ dy, const float* __restrict__ wv,
             float* __restrict__ part_w, float* __restrict__ part_wv) {
  constexpr int NE = EP / 8, KE = EP / 16;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int mt = unit % d.HT16, ch = unit / d.HT16;
  if (ch >= d.n_ch3) return;
  const long long P = (long long)d.B * d.G;
  const int n_pt = cdiv(P, 16), tiles = cdiv(n_pt, d.n_ch3);
  const int t0 = ch * tiles, t1 = min(n_pt, t0 + tiles);
  const uint16_t* hn = reinterpret_cast<const uint16_t*>(hn_ws);
  float w1[NE][4], w2[NE][4], vw[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NE; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) w1[nt][i] = w2[nt][i] = 0.f;
  float wvr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hid = 16 * mt + gq + 8 * r;
    wvr[r] = hid < d.Hd ? __ldg(wv + hid) : 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const long long p0 = 16LL * t;
    // [a | c]^T: rows hidden 16 mt + gq (+ 8), columns pairs 8 nt + 2tq (+ 1)
    float a[2][4], c[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[nt][i] = c[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KE; ++ks) {
      uint32_t a1[4], a2[4];
      ft::lda(a1, pk.w1A, (long long)mt * KE + ks, lane);
      ft::lda(a2, pk.w2A, (long long)mt * KE + ks, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const long long pr = p0 + 8 * nt + gq;
        uint32_t b0 = 0, b1 = 0;
        if (pr < P) {
          const uint32_t* row = reinterpret_cast<const uint32_t*>(hn + pr * EP);
          b0 = row[8 * ks + tq];
          b1 = row[8 * ks + 4 + tq];
        }
        tc::mma_bf16(a[nt], a1, b0, b1);
        tc::mma_bf16(c[nt], a2, b0, b1);
      }
    }
    // [da | dc]^T and dwv
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const long long pr = p0 + 8 * nt + 2 * tq + (i & 1);
        const float dl = pr < P ? __ldg(dy + pr) : 0.f;
        const float sg = 1.0f / (1.0f + expf(-a[nt][i]));
        const float sl = a[nt][i] * sg;
        vw[r] = fmaf(dl, sl * c[nt][i], vw[r]);
        const float dg3 = dl * wvr[r];
        a[nt][i] = dg3 * c[nt][i] * (sg * (1.0f + a[nt][i] * (1.0f - sg)));
        c[nt][i] = dg3 * sl;
      }
    // dw12^T += [da | dc]^T bf(hn): k = the 16 pairs, [da | dc] in three passes
    uint32_t a3[3][4], c3[3][4];
    ft::a3_of_c(a3, a[0], a[1]);
    ft::a3_of_c(c3, c[0], c[1]);
#pragma unroll
    for (int nt = 0; nt < NE; ++nt) {
      const int e = 8 * nt + gq;
      uint32_t bb[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long pr = p0 + 2 * tq + 8 * hf;
        const uint32_t lo = pr < P ? hn[pr * EP + e] : 0u;
        const uint32_t hi = pr + 1 < P ? hn[(pr + 1) * EP + e] : 0u;
        bb[hf] = lo | (hi << 16);
      }
      float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};  // the tile from zero
      ft::mma3a(t1, a3, bb[0], bb[1]);
      ft::mma3a(t2, c3, bb[0], bb[1]);
      ft::add4(w1[nt], t1);
      ft::add4(w2[nt], t2);
    }
  }

  // -- the unit's partials: dw12 (E, 2 Hd) at the tile's hidden columns, dwv
  float* pw = part_w + (size_t)ch * d.E * 2 * d.Hd;
#pragma unroll
  for (int nt = 0; nt < NE; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hid = 16 * mt + gq + 8 * (i >> 1), e = 8 * nt + 2 * tq + (i & 1);
      if (hid < d.Hd && e < d.E) {
        pw[(size_t)e * 2 * d.Hd + hid] = w1[nt][i];
        pw[(size_t)e * 2 * d.Hd + d.Hd + hid] = w2[nt][i];
      }
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float s = ft::quad_sum(vw[r]);
    const int hid = 16 * mt + gq + 8 * r;
    if (tq == 0 && hid < d.Hd) part_wv[(size_t)ch * d.Hd + hid] = s;
  }
}

// -- launches ---------------------------------------------------------------------------

template <int EP>
cudaError_t forward_ep(const Dims& d, const Work& w, const float* qp, const float* q,
                       const float* ln2g, const float* ln2b, const float* wv, const float* wmu,
                       const float* bmu, float* out, cudaStream_t s) {
  auto kernel = tail_fwd_gen<EP>;
  const int grid = ft::resident_blocks((const void*)kernel, kThreads, 0, (long long)d.n_gt * d.n_cb);
  kernel<<<grid, kThreads, 0, s>>>(d, w.pk, qp, q, ln2g, ln2b, wv, wmu, bmu, out);
  return cudaGetLastError();
}

template <int EP>
cudaError_t backward_ep(const Dims& d, const Work& w, const float* qp, const float* q,
                        const float* ln2g, const float* ln2b, const float* wv, const float* wmu,
                        const float* dy, cudaStream_t s) {
  cudaError_t err;
  {
    auto kernel = tail_bwd_chain<EP>;
    const long long smem = (long long)kWarps * chain_slots(EP / 8) * 32 * sizeof(float4);
    if ((err = ft::allow_smem((const void*)kernel, smem)) != cudaSuccess) return err;
    const int grid = ft::resident_blocks((const void*)kernel, kThreads, smem,
                                         (long long)d.n_gt * d.n_cb);
    kernel<<<grid, kThreads, (size_t)smem, s>>>(d, w.pk, qp, q, ln2g, ln2b, wv, wmu, dy, w.dhh,
                                                 w.hn, w.part_qq, w.part_v);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    auto kernel = tail_bwd_attn<EP>;
    const long long smem = (long long)kWarps * attn_slots(d.KM, d.hd) * 32 * sizeof(float4);
    if ((err = ft::allow_smem((const void*)kernel, smem)) != cudaSuccess) return err;
    const int grid = ft::resident_blocks((const void*)kernel, kThreads, smem,
                                         (long long)d.B * d.H * d.n_ch2 * d.NS);
    kernel<<<grid, kThreads, (size_t)smem, s>>>(d, w.pk, qp, w.dhh, w.part_dv, w.part_dk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const long long units = (long long)d.HT16 * d.n_ch3;
    tail_bwd_w12<EP><<<cdiv(units, kWarps), kThreads, 0, s>>>(d, w.pk, w.hn, dy, wv, w.part_w,
                                                              w.part_wv);
    return cudaGetLastError();
  }
}

}  // namespace
}  // namespace tailg

extern "C" {

// Whether the any-width kernels take (E, H, M, Hd): E from 1 to 128, H
// dividing E, 1 to 64 latent tokens, any hidden width.
int scldm_decoder_tail_gen_takes(int E, int H, int M, int Hd) {
  return E >= 1 && E <= 128 && H >= 1 && E % H == 0 && M >= 1 && M <= tailg::kMaxM && Hd >= 1;
}

// Floats of the forward's (backward = 0) or the backward's device workspace:
// the packed operands, and for the backward d(hh) and bf(hn) of every pair
// and the partials. 0 for a shape the kernels do not take.
long long scldm_decoder_tail_gen_workspace_floats(int B, int G, int E, int H, int M, int Hd,
                                                  int backward) {
  if (!scldm_decoder_tail_gen_takes(E, H, M, Hd) || B <= 0 || G <= 0) return 0;
  long long bytes = 0;
  tailg::carve(tailg::make_dims(B, G, E, H, M, Hd, 0.f, 1.f), nullptr, backward != 0, &bytes);
  return bytes / 4;
}

// Forward: out (B, G) f32 logits, as scldm_decoder_tail_forward, with a
// workspace of scldm_decoder_tail_gen_workspace_floats(..., 0) floats. Two
// kinds of launch: the packers, then the kernel.
int scldm_decoder_tail_gen_forward(const void* qp, const void* q, const void* kfull,
                                   const void* vproj, const void* ln2g, const void* ln2b,
                                   const void* w12, const void* wv, const void* wmu,
                                   const void* bmu, void* out, void* workspace, int B, int G,
                                   int E, int H, int M, int Hd, float eps, float scale,
                                   void* stream) {
  if (B == 0 || G == 0) return 0;
  if (!scldm_decoder_tail_gen_takes(E, H, M, Hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const tailg::Dims d = tailg::make_dims(B, G, E, H, M, Hd, eps, scale);
  long long bytes = 0;
  tailg::Work w = tailg::carve(d, workspace, false, &bytes);
  cudaError_t err = tailg::pack(d, w, (const float*)kfull, (const float*)vproj, (const float*)w12,
                                false, s);
  if (err != cudaSuccess) return (int)err;
  const float *fq = (const float*)qp, *fr = (const float*)q, *g = (const float*)ln2g,
              *bb = (const float*)ln2b, *v = (const float*)wv, *mu = (const float*)wmu,
              *bias = (const float*)bmu;
  switch (d.EP) {
    case 32: return (int)tailg::forward_ep<32>(d, w, fq, fr, g, bb, v, mu, bias, (float*)out, s);
    case 64: return (int)tailg::forward_ep<64>(d, w, fq, fr, g, bb, v, mu, bias, (float*)out, s);
    default: return (int)tailg::forward_ep<128>(d, w, fq, fr, g, bb, v, mu, bias, (float*)out, s);
  }
}

// Backward, as scldm_decoder_tail_backward (qq = dqp | dq, dkfull's head
// blocks, the caller zeroing the rest, dvproj, wvec), with a workspace of
// scldm_decoder_tail_gen_workspace_floats(..., 1) floats: the packers, the
// three kernels, two launches of the fixed-order sum.
int scldm_decoder_tail_gen_backward(const void* qp, const void* q, const void* kfull,
                                    const void* vproj, const void* ln2g, const void* ln2b,
                                    const void* w12, const void* wv, const void* wmu,
                                    const void* dy, void* qq, void* dkfull, void* dvproj,
                                    void* wvec, void* workspace, int B, int G, int E, int H, int M,
                                    int Hd, float eps, float scale, void* stream) {
  if (B == 0 || G == 0) return 0;
  if (!scldm_decoder_tail_gen_takes(E, H, M, Hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const tailg::Dims d = tailg::make_dims(B, G, E, H, M, Hd, eps, scale);
  long long bytes = 0;
  tailg::Work w = tailg::carve(d, workspace, true, &bytes);
  cudaError_t err = tailg::pack(d, w, (const float*)kfull, (const float*)vproj, (const float*)w12,
                                true, s);
  if (err != cudaSuccess) return (int)err;
  const float *fq = (const float*)qp, *fr = (const float*)q, *g = (const float*)ln2g,
              *bb = (const float*)ln2b, *v = (const float*)wv, *mu = (const float*)wmu,
              *fdy = (const float*)dy;
  switch (d.EP) {
    case 32: err = tailg::backward_ep<32>(d, w, fq, fr, g, bb, v, mu, fdy, s); break;
    case 64: err = tailg::backward_ep<64>(d, w, fq, fr, g, bb, v, mu, fdy, s); break;
    default: err = tailg::backward_ep<128>(d, w, fq, fr, g, bb, v, mu, fdy, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  // the fixed-order sums into the outputs; wvec = dw12 | dln2g | dln2b | dwmu | dwv | dbmu
  const long long HM = (long long)H * M, n12 = (long long)E * 2 * Hd, nv = 3LL * E + 1;
  float* out_w = (float*)wvec;
  ft::Sums sums{};
  sums.job[0] = {w.part_qq, (float*)qq, 2LL * G * E, 2LL * G * E, d.n_cb, 0, 0, 0, 0, 0, 0};
  sums.job[1] = {w.part_dv, (float*)dvproj, (long long)B * HM * E, (long long)B * HM * E,
                 d.n_ch2, 0, 0, 0, 0, 0, 0};
  sums.job[2] = {w.part_dk, (float*)dkfull, (long long)B * HM * d.hd, (long long)B * HM * d.hd,
                 d.n_ch2, 1, (int)HM, M, d.hd, E, 0};
  sums.job[3] = {w.part_w, out_w, n12, n12, d.n_ch3, 0, 0, 0, 0, 0, 0};
  // the vector sums in two levels, each in index order: the gene tiles of each
  // cell block, then the cell blocks
  sums.job[4] = {w.part_v, w.part_vb, nv, nv, d.n_gt, 0, 0, 0, 0, 0, 0, d.n_cb,
                 (long long)d.n_gt * nv};
  sums.job[5] = {w.part_wv, out_w + n12 + 3LL * E, (long long)Hd, (long long)Hd, d.n_ch3, 0, 0,
                 0, 0, 0, 0};
  sums.n = 6;
  if ((err = ft::launch_sums(sums, s)) != cudaSuccess) return (int)err;
  ft::Sums last{};
  last.job[0] = {w.part_vb, out_w + n12, 3LL * E, nv, d.n_cb, 0, 0, 0, 0, 0, 0};
  last.job[1] = {w.part_vb + 3LL * E, out_w + n12 + 3LL * E + Hd, 1, nv, d.n_cb, 0, 0, 0, 0, 0,
                 0};
  last.n = 2;
  return (int)ft::launch_sums(last, s);
}

}  // extern "C"
