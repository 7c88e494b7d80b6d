// The VAE encoder pools (dense and window) at any width the JAX gate
// dispatches to the narrow design (E <= 128, any head count dividing E, 1 to
// 64 inducing points): forward and recompute backward on mma.sync bf16 with
// f32 sums. The math is encoder_pool.cu's (`_ln_kv_scores`,
// `_numden_given_m` in scldm_tpu/ops/fused_encoder.py, `_pool` in
// scldm_torch/ops/fused_encoder.py); that file keeps its kernels for the
// reference encoder (E = 32, 4 heads, 16 inducing points) and the wrappers
// send every other width here. One source for both variants, templated on
// where token t of cell b comes from (kDense: table[t] * log1p(counts[b, t]);
// else emb[b, t]).
//
// Design. The B (or A) side of every product that reads a weight, a query or
// dnum is packed once a launch into fragment order (frag_tile.cuh), zero-
// padded to E rounded up to 32, 64 or 128, the head width to 16 and the
// queries to 16; the LayerNorm statistics stay over the true E. A warp takes
// 16 tokens at a time, rows gq and gq + 8 a thread.
//   forward   a CTA of 4 warps per (cell, head), two passes over the cell's
//             tokens: pass 1 the scores s^T = bf(q) bf(k)^T (queries on the
//             rows, k's C tiles the B operand as they stand) and each
//             query's largest and the token that first reaches it; m is that
//             token's score taken again exactly (k summed in f64, rounded
//             through f32 to bf16, as the plain version rounds the exact k)
//             times the scale; pass 2 e = exp(s scale - m), den and num +=
//             bf(e) bf(v) (v's C tiles transposed across the warp); the
//             warps' sums added in warp order.
//   backward  three kernels and a fixed-order sum, no atomics:
//     attn    per (cell, head, token chunk): the forward's k and v again, s,
//             e, dn = bf(v) dnum^T (dnum in three bf16 passes), ds = e
//             (bf(dn) + dden) scale, dv = bf(bf(e) dnum) and dk = bf(ds bf(q))
//             (three passes each) written per token to the workspace with
//             bf(x2); dqfull's head block += ds^T bf(k) (three passes).
//     tok     per token: dx2 = bf(bf(dk) bf(wk)^T) + bf(bf(dv) bf(wv)^T), the
//             LayerNorm backward into demb (or dtable's rows times
//             log1p(count), summed over a cell group); dln1g, dln1b.
//     w       dwk, dwv = bf(x2)^T [bf(dk) | bf(dv)] over every token.
//     sums    `ft::sum_parts` adds every partial in index order.
// The gradients repeat their bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "frag_tile.cuh"

namespace poolg {
namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kMaxQ = 64;          // inducing points
constexpr int kQT = kMaxQ / 8;     // 8-query tiles, at most
constexpr int kKQ = kMaxQ / 16;    // k16 steps over the queries, at most
constexpr int kTargetWarps = 2048;

__host__ __device__ constexpr int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
__host__ __device__ constexpr int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
__host__ __device__ inline int padded_e(int E) { return E <= 32 ? 32 : E <= 64 ? 64 : 128; }

struct Dims {
  int B, N, E, H, Q, hd;
  int EP, KE, NE;  // E padded, its k16 steps and 8-column tiles
  int KQ, NQ;      // queries padded to 16: k16 steps, 8-query tiles
  int KD, ND;      // head width: k16 steps, 8-column tiles
  int ntiles;      // 16-token tiles a cell
  int n_chA;       // token chunks a (cell, head): attn
  int n_chB, Bg, n_grp;  // tok: window token chunks a cell; dense cells a group, groups
  int n_chW;       // token chunks: w
  float eps, scale;
};

Dims make_dims(int B, int N, int E, int H, int Q, float eps, float scale) {
  Dims d{};
  d.B = B, d.N = N, d.E = E, d.H = H, d.Q = Q, d.hd = E / H;
  d.EP = padded_e(E), d.KE = d.EP / 16, d.NE = d.EP / 8;
  d.KQ = cdiv(Q, 16), d.NQ = 2 * d.KQ;
  d.KD = cdiv(d.hd, 16), d.ND = cdiv(d.hd, 8);
  d.ntiles = cdiv(N, 16);
  d.n_chA = clampi(cdiv(kTargetWarps, (long long)B * H), 1, d.ntiles);
  d.n_chB = clampi(cdiv(kTargetWarps, B), 1, d.ntiles);
  const int want = clampi(cdiv(kTargetWarps, d.ntiles), 1, B);
  d.Bg = cdiv(B, want);
  d.n_grp = cdiv(B, d.Bg);
  d.n_chW = clampi(cdiv(kTargetWarps, d.KE), 1, cdiv((long long)B * N, 16));
  d.eps = eps, d.scale = scale;
  return d;
}

struct Packs {
  const uint2 *wkB, *wvB;   // per head (k e, n d)
  const uint4* qA;          // per head (rows queries, k d)
  const uint2 *qB, *qK;     // per head (k d, n queries), (k queries, n d)
  const uint2 *wkT, *wvT;   // (k e_out, n e_in)
  const uint2 *dN, *dV;     // per (cell, head, pass): dnum (k d, n queries), (k queries, n d)
};

struct Work {
  Packs pk;
  __nv_bfloat16 *x2, *dk, *dv;  // (B N, EP) each
  float *part_dq, *part_ln, *part_w, *part_dt;
};

Work carve(const Dims& d, void* base, bool backward, bool dense, long long* bytes) {
  ft::Carve c{(char*)base, 0};
  Work w{};
  const long long H = d.H;
  w.pk.wkB = c.take<uint2>(H * d.KE * d.ND * 32);
  w.pk.wvB = c.take<uint2>(H * d.KE * d.ND * 32);
  if (!backward) {
    w.pk.qA = c.take<uint4>(H * d.KQ * d.KD * 32);
  } else {
    const long long BH = (long long)d.B * d.H, T = (long long)d.B * d.N;
    w.pk.qB = c.take<uint2>(H * d.KD * d.NQ * 32);
    w.pk.qK = c.take<uint2>(H * d.KQ * d.ND * 32);
    w.pk.wkT = c.take<uint2>((long long)d.KE * d.NE * 32);
    w.pk.wvT = c.take<uint2>((long long)d.KE * d.NE * 32);
    w.pk.dN = c.take<uint2>(BH * 3 * d.KD * d.NQ * 32);
    w.pk.dV = c.take<uint2>(BH * 3 * d.KQ * d.ND * 32);
    w.x2 = c.take<__nv_bfloat16>(T * d.EP);
    w.dk = c.take<__nv_bfloat16>(T * d.EP);
    w.dv = c.take<__nv_bfloat16>(T * d.EP);
    w.part_dq = c.take<float>((long long)d.B * d.n_chA * d.Q * d.E);
    const long long units = dense ? (long long)d.ntiles * d.n_grp : (long long)d.B * d.n_chB;
    w.part_ln = c.take<float>(units * 2 * d.E);
    w.part_w = c.take<float>((long long)d.n_chW * 2 * d.E * d.E);
    if (dense) w.part_dt = c.take<float>((long long)d.n_grp * d.N * d.E);
  }
  *bytes = c.used;
  return w;
}

cudaError_t pack(const Dims& d, Work& w, const float* qfull, const float* wk, const float* wv,
                 const float* dnum, bool backward, cudaStream_t s) {
  const int H = d.H, E = d.E, hd = d.hd, Q = d.Q;
  // head h's (e, d) block of wk, wv; its (query, d) block of qfull
  const ft::Mat wkh = ft::mat(wk, H, 0, hd, E, E, hd), wvh = ft::mat(wv, H, 0, hd, E, E, hd);
  const ft::Mat qh = ft::mat(qfull, H, 0, (long long)Q * E + hd, E, Q, hd);
  cudaError_t err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.wkB, wkh, H, d.KE, d.ND, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.wvB, wvh, H, d.KE, d.ND, s)) != cudaSuccess) return err;
  if (!backward) return ft::launch_pack_a((uint4*)w.pk.qA, qh, H, d.KQ, d.KD, s);
  ft::Mat qhT = qh;
  qhT.trans = 1;
  if ((err = ft::launch_pack_b((uint2*)w.pk.qB, qhT, H, d.KD, d.NQ, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.qK, qh, H, d.KQ, d.ND, s)) != cudaSuccess) return err;
  // (k e_out, n e_in) of wk, wv: the matrix (e_in, e_out) read transposed
  const ft::Mat wkt = ft::mat(wk, 1, 0, 0, E, E, E, true), wvt = ft::mat(wv, 1, 0, 0, E, E, E, true);
  if ((err = ft::launch_pack_b((uint2*)w.pk.wkT, wkt, 1, d.KE, d.NE, s)) != cudaSuccess) return err;
  if ((err = ft::launch_pack_b((uint2*)w.pk.wvT, wvt, 1, d.KE, d.NE, s)) != cudaSuccess) return err;
  const long long per = (long long)d.KD * d.NQ * 32, perv = (long long)d.KQ * d.ND * 32;
  for (int pass = 0; pass < 3; ++pass) {
    // batch b * H + h: cell b's (query, d) block of head h in dnum (B, Q, E)
    const ft::Mat dn = ft::mat(dnum, H, (long long)Q * E, hd, E, Q, hd, true, pass);
    ft::Mat dv = dn;
    dv.trans = 0;
    // pass-major: pass p of (cell, head) bh at tiles ((p B H + bh) KS + ks) NT + nt
    if ((err = ft::launch_pack_b((uint2*)w.pk.dN + pass * (long long)d.B * H * per, dn,
                                 d.B * H, d.KD, d.NQ, s)) != cudaSuccess)
      return err;
    if ((err = ft::launch_pack_b((uint2*)w.pk.dV + pass * (long long)d.B * H * perv, dv,
                                 d.B * H, d.KQ, d.ND, s)) != cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

// -- per-warp pieces -----------------------------------------------------------------

// Row r's 4 KE values of token `t` at the A fragment's columns: x[ks][u],
// column 16 ks + 8 (u >> 1) + 2 tq + (u & 1); 0 past E
template <int EP, bool kDense>
__device__ __forceinline__ void load_row(const Dims& d, const float* counts, const float* src,
                                         int b, int t, float (&x)[EP / 16][4]) {
  const int tq = threadIdx.x & 3;
  const float* row = src + ((kDense ? 0 : (size_t)b * d.N) + t) * (size_t)d.E;
  const float lc = kDense ? log1pf(__ldg(counts + (size_t)b * d.N + t)) : 1.f;
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 16 * ks + 8 * (u >> 1) + 2 * tq + (u & 1);
      const float v = c < d.E ? __ldg(row + c) : 0.f;
      x[ks][u] = kDense ? v * lc : v;
    }
}

// the LayerNorm of a row held as `load_row` holds it, over the true E, in a
// fixed order (the thread's columns in order, then the quad's sums as
// ft::quad_sum adds them); x -> xhat (0 past E); x2 = xhat g + b written as
// the row's halves of the A fragments; returns rstd. `exact_ln` repeats it.
template <int EP>
__device__ __forceinline__ float ln_row(const Dims& d, const float* g, const float* bb,
                                        float (&x)[EP / 16][4], int r, uint32_t (&ax)[EP / 16][4]) {
  const int tq = threadIdx.x & 3;
  float s = 0.f;
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks)
#pragma unroll
    for (int u = 0; u < 4; ++u) s += x[ks][u];  // 0 past E
  const float mean = ft::quad_sum(s) / d.E;
  float var = 0.f;
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 16 * ks + 8 * (u >> 1) + 2 * tq + (u & 1);
      x[ks][u] = c < d.E ? x[ks][u] - mean : 0.f;
      var = fmaf(x[ks][u], x[ks][u], var);
    }
  const float rstd = rsqrtf(ft::quad_sum(var) / d.E + d.eps);
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks) {
    float x2[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 16 * ks + 8 * (u >> 1) + 2 * tq + (u & 1);
      x[ks][u] *= rstd;
      x2[u] = c < d.E ? __fadd_rn(__fmul_rn(x[ks][u], __ldg(g + c)), __ldg(bb + c)) : 0.f;
    }
    ax[ks][r] = tc::pack_bf16(x2[0], x2[1]);
    ax[ks][2 + r] = tc::pack_bf16(x2[2], x2[3]);
  }
  return rstd;
}

// the warp's 16 tokens t0 + gq (+ 8) of cell b (rows at or past N read token
// N - 1): bf(x2)'s A fragments
template <int EP, bool kDense>
__device__ __forceinline__ void tile_x2(const Dims& d, const float* counts, const float* src,
                                        const float* g, const float* bb, int b, int t0,
                                        uint32_t (&ax)[EP / 16][4]) {
  const int gq = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x[EP / 16][4];
    load_row<EP, kDense>(d, counts, src, b, min(t0 + gq + 8 * r, d.N - 1), x);
    ln_row<EP>(d, g, bb, x, r, ax);
  }
}

// C tile nt (head columns 8 nt..) of bf(x2) W_h over the warp's tokens
template <int EP>
__device__ __forceinline__ void proj_tile(const uint2* wB, int h, int ND, int nt,
                                          const uint32_t (&ax)[EP / 16][4], float (&c)[4]) {
  const int lane = threadIdx.x & 31;
  c[0] = c[1] = c[2] = c[3] = 0.f;
  if (nt >= ND) return;
#pragma unroll
  for (int ks = 0; ks < EP / 16; ++ks)
    ft::mma(c, ax[ks], ft::ldb(wB, ((long long)h * (EP / 16) + ks) * ND + nt, lane));
}

// (score, token) replaced by (s, t) if s is larger, or as large at a smaller token
__device__ __forceinline__ void take_max(float& v, int& i, float s, int t) {
  if (s > v || (s == v && t < i)) {
    v = s;
    i = t;
  }
}

// The raw score of query i of head h against token t of cell b, taken
// exactly: x2 by `ln_row`'s order (its bits), k's head block summed in f64
// and rounded through f32 to bf16, the products with bf(q) summed in f64.
template <bool kDense>
__device__ float exact_score(const Dims& d, const float* counts, const float* src,
                             const float* qfull, const float* g, const float* bb,
                             const float* wk, int b, int h, int i, int t) {
  const float* row = src + ((kDense ? 0 : (size_t)b * d.N) + t) * (size_t)d.E;
  const float lc = kDense ? log1pf(__ldg(counts + (size_t)b * d.N + t)) : 1.f;
  auto xv = [&](int c) { const float v = __ldg(row + c); return kDense ? v * lc : v; };
  // the quad's four partial sums, each over its lane's columns in order
  float p[4];
  for (int tq = 0; tq < 4; ++tq) {
    float s = 0.f;
    for (int ks = 0; ks < d.KE; ++ks)
      for (int u = 0; u < 4; ++u) {
        const int c = 16 * ks + 8 * (u >> 1) + 2 * tq + (u & 1);
        s += c < d.E ? xv(c) : 0.f;
      }
    p[tq] = s;
  }
  const float mean = ((p[0] + p[1]) + (p[2] + p[3])) / d.E;
  for (int tq = 0; tq < 4; ++tq) {
    float v = 0.f;
    for (int ks = 0; ks < d.KE; ++ks)
      for (int u = 0; u < 4; ++u) {
        const int c = 16 * ks + 8 * (u >> 1) + 2 * tq + (u & 1);
        const float xc = c < d.E ? xv(c) - mean : 0.f;
        v = fmaf(xc, xc, v);
      }
    p[tq] = v;
  }
  const float rstd = rsqrtf(((p[0] + p[1]) + (p[2] + p[3])) / d.E + d.eps);
  const float* q = qfull + ((size_t)h * d.Q + i) * d.E + (size_t)h * d.hd;
  double s = 0.0;
  for (int dd = 0; dd < d.hd; ++dd) {
    double k = 0.0;
    const int col = h * d.hd + dd;
    for (int c = 0; c < d.E; ++c) {
      const float x2 = __fadd_rn(__fmul_rn((xv(c) - mean) * rstd, __ldg(g + c)), __ldg(bb + c));
      k = fma((double)ft::bfr(x2), (double)ft::bfr(__ldg(wk + (size_t)c * d.E + col)), k);
    }
    s += (double)ft::bfr(__double2float_rn(k)) * (double)ft::bfr(__ldg(q + dd));
  }
  return __double2float_rn(s);
}

// -- the forward ----------------------------------------------------------------------

// shared memory: the warps' (max, token) per query, their den per query, the
// cell's m, and each warp's num C tiles as thread-private float4 slots
__host__ __device__ inline long long fwd_smem_bytes(const Dims& d) {
  return (long long)kWarps * kMaxQ * (4 + 4 + 4) + kMaxQ * 4 +
         (long long)kWarps * d.KQ * d.ND * 32 * 16;
}

template <int EP, bool kDense>
__global__ void __launch_bounds__(kThreads)
pool_fwd_gen(const Dims d, const Packs pk, const float* __restrict__ counts,
             const float* __restrict__ src, const float* __restrict__ qfull,
             const float* __restrict__ ln1g, const float* __restrict__ ln1b,
             const float* __restrict__ wk, float* __restrict__ num, float* __restrict__ den,
             float* __restrict__ mout) {
  constexpr int KE = EP / 16;
  extern __shared__ __align__(16) float4 smem4[];
  float* wmax = reinterpret_cast<float*>(smem4);       // [kWarps][kMaxQ]
  int* warg = reinterpret_cast<int*>(wmax + kWarps * kMaxQ);
  float* wden = reinterpret_cast<float*>(warg + kWarps * kMaxQ);
  float* msh = wden + kWarps * kMaxQ;                  // [kMaxQ]
  float4* slots = smem4 + (kWarps * kMaxQ * 3 + kMaxQ) / 4;  // [kWarps][KQ ND][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / d.H, h = blockIdx.x % d.H;

  // -- pass 1: each query's raw score max over the cell, and where first reached
  float mx[kKQ][2];
  int arg[kKQ][2];
#pragma unroll
  for (int mt = 0; mt < kKQ; ++mt) mx[mt][0] = mx[mt][1] = -INFINITY, arg[mt][0] = arg[mt][1] = 0;
  for (int j = warp; j < d.ntiles; j += kWarps) {
    const int t0 = 16 * j;
    uint32_t ax[KE][4];
    tile_x2<EP, kDense>(d, counts, src, ln1g, ln1b, b, t0, ax);
    float st[kKQ][2][4];
#pragma unroll
    for (int mt = 0; mt < kKQ; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) st[mt][nt][0] = st[mt][nt][1] = st[mt][nt][2] = st[mt][nt][3] = 0.f;
    for (int kd = 0; kd < d.KD; ++kd) {
      float k0[4], k1[4];
      proj_tile<EP>(pk.wkB, h, d.ND, 2 * kd, ax, k0);
      proj_tile<EP>(pk.wkB, h, d.ND, 2 * kd + 1, ax, k1);
      // B (k d, n tokens): tokens 0-7 from the tiles' rows gq, 8-15 from rows gq + 8
      const uint32_t b00 = tc::pack_bf16(k0[0], k0[1]), b01 = tc::pack_bf16(k1[0], k1[1]);
      const uint32_t b10 = tc::pack_bf16(k0[2], k0[3]), b11 = tc::pack_bf16(k1[2], k1[3]);
#pragma unroll
      for (int mt = 0; mt < kKQ; ++mt) {
        if (mt >= d.KQ) break;
        uint32_t a[4];
        ft::lda(a, pk.qA, ((long long)h * d.KQ + mt) * d.KD + kd, lane);
        tc::mma_bf16(st[mt][0], a, b00, b01);
        tc::mma_bf16(st[mt][1], a, b10, b11);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kKQ; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = t0 + 8 * nt + 2 * tq + c;
            if (t < d.N) take_max(mx[mt][r], arg[mt][r], st[mt][nt][2 * r + c], t);
          }
  }
#pragma unroll
  for (int mt = 0; mt < kKQ; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        take_max(mx[mt][r], arg[mt][r], __shfl_xor_sync(0xffffffffu, mx[mt][r], o),
                 __shfl_xor_sync(0xffffffffu, arg[mt][r], o));
      const int i = 16 * mt + gq + 8 * r;
      if (tq == 0 && mt < d.KQ) {
        wmax[warp * kMaxQ + i] = mx[mt][r];
        warg[warp * kMaxQ + i] = arg[mt][r];
      }
    }
  __syncthreads();
  if (threadIdx.x < d.Q) {
    const int i = threadIdx.x;
    float v = wmax[i];
    int t = warg[i];
    for (int w = 1; w < kWarps; ++w) take_max(v, t, wmax[w * kMaxQ + i], warg[w * kMaxQ + i]);
    msh[i] = v == -INFINITY ? -INFINITY
                            : exact_score<kDense>(d, counts, src, qfull, ln1g, ln1b, wk, b, h, i,
                                                  t) * d.scale;
  }
  __syncthreads();

  // -- pass 2: e against m, den, num += bf(e) bf(v) ---------------------------------
  const int nslots = d.KQ * d.ND;
  float4* slot = slots + (size_t)warp * nslots * 32 + lane;
  for (int i = 0; i < nslots; ++i) slot[32 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float mrow[kKQ][2], dsum[kKQ][2];
#pragma unroll
  for (int mt = 0; mt < kKQ; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * mt + gq + 8 * r;
      mrow[mt][r] = i < d.Q ? msh[i] : INFINITY;
      dsum[mt][r] = 0.f;
    }
  for (int j = warp; j < d.ntiles; j += kWarps) {
    const int t0 = 16 * j;
    uint32_t ax[KE][4];
    tile_x2<EP, kDense>(d, counts, src, ln1g, ln1b, b, t0, ax);
    float st[kKQ][2][4];
#pragma unroll
    for (int mt = 0; mt < kKQ; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) st[mt][nt][0] = st[mt][nt][1] = st[mt][nt][2] = st[mt][nt][3] = 0.f;
    for (int kd = 0; kd < d.KD; ++kd) {
      float k0[4], k1[4];
      proj_tile<EP>(pk.wkB, h, d.ND, 2 * kd, ax, k0);
      proj_tile<EP>(pk.wkB, h, d.ND, 2 * kd + 1, ax, k1);
      const uint32_t b00 = tc::pack_bf16(k0[0], k0[1]), b01 = tc::pack_bf16(k1[0], k1[1]);
      const uint32_t b10 = tc::pack_bf16(k0[2], k0[3]), b11 = tc::pack_bf16(k1[2], k1[3]);
#pragma unroll
      for (int mt = 0; mt < kKQ; ++mt) {
        if (mt >= d.KQ) break;
        uint32_t a[4];
        ft::lda(a, pk.qA, ((long long)h * d.KQ + mt) * d.KD + kd, lane);
        tc::mma_bf16(st[mt][0], a, b00, b01);
        tc::mma_bf16(st[mt][1], a, b10, b11);
      }
    }
    // e = exp(s scale - m), 0 for tokens past N and queries past Q
#pragma unroll
    for (int mt = 0; mt < kKQ; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1, t = t0 + 8 * nt + 2 * tq + (i & 1);
          float& v = st[mt][nt][i];
          v = t < d.N && mrow[mt][r] != INFINITY ? expf(v * d.scale - mrow[mt][r]) : 0.f;
          dsum[mt][r] += v;
        }
    for (int nt = 0; nt < d.ND; ++nt) {
      float vt[4];
      proj_tile<EP>(pk.wvB, h, d.ND, nt, ax, vt);
      // B (k tokens, n d): v's C tile transposed across the warp
      const uint32_t b0 = tc::transpose8x8(tc::pack_bf16(vt[0], vt[1]));
      const uint32_t b1 = tc::transpose8x8(tc::pack_bf16(vt[2], vt[3]));
#pragma unroll
      for (int mt = 0; mt < kKQ; ++mt) {
        if (mt >= d.KQ) break;
        uint32_t a[4];
        ft::a_of_c(a, st[mt][0], st[mt][1]);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        tc::mma_bf16(acc, a, b0, b1);
        float4& s = slot[32 * (mt * d.ND + nt)];
        s.x += acc[0], s.y += acc[1], s.z += acc[2], s.w += acc[3];
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kKQ; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float s = ft::quad_sum(dsum[mt][r]);
      if (tq == 0 && mt < d.KQ) wden[warp * kMaxQ + 16 * mt + gq + 8 * r] = s;
    }
  __syncthreads();
  // the warps' sums in warp order: num (Q, hd) of head h, den, m
  for (int o = threadIdx.x; o < d.Q * d.hd; o += kThreads) {
    const int i = o / d.hd, dd = o % d.hd;
    const int mt = i / 16, rr = i % 16, nt = dd / 8, cc = dd % 8;
    const int ln = 4 * (rr % 8) + cc / 2, comp = 2 * (rr / 8) + (cc % 2);
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float4 s = slots[((size_t)w * nslots + mt * d.ND + nt) * 32 + ln];
      a += comp == 0 ? s.x : comp == 1 ? s.y : comp == 2 ? s.z : s.w;
    }
    num[((size_t)b * d.Q + i) * d.E + h * d.hd + dd] = a;
  }
  for (int i = threadIdx.x; i < d.Q; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wden[w * kMaxQ + i];
    den[(size_t)b * d.H * d.Q + h * d.Q + i] = s;
    mout[(size_t)b * d.H * d.Q + h * d.Q + i] = msh[i];
  }
}

// -- the backward: the attention per head -------------------------------------------------

// dqfull's accumulators: KQ x ND C tiles a warp, thread-private float4 slots
__host__ __device__ inline long long attn_smem_bytes(const Dims& d) {
  return (long long)kWarps * d.KQ * d.ND * 32 * 16;
}

// stores the bf16 pair (lo, hi) at columns c, c + 1 of a workspace row (c even)
__device__ __forceinline__ void put_pair(__nv_bfloat16* row, int c, uint32_t v) {
  *reinterpret_cast<uint32_t*>(row + c) = v;
}

template <int EP, bool kDense>
__global__ void __launch_bounds__(kThreads)
pool_bwd_attn(const Dims d, const Packs pk, const float* __restrict__ counts,
              const float* __restrict__ src, const float* __restrict__ ln1g,
              const float* __restrict__ ln1b, const float* __restrict__ mstat,
              const float* __restrict__ dden, __nv_bfloat16* __restrict__ x2_ws,
              __nv_bfloat16* __restrict__ dk_ws, __nv_bfloat16* __restrict__ dv_ws,
              float* __restrict__ part_dq) {
  constexpr int KE = EP / 16;
  extern __shared__ __align__(16) float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  int unit = blockIdx.x * kWarps + warp;
  const int ch = unit % d.n_chA;
  unit /= d.n_chA;
  const int h = unit % d.H, b = unit / d.H;
  if (b >= d.B) return;
  const long long bh = (long long)b * d.H + h;
  const int nslots = d.KQ * d.ND;
  float4* slot = smem4 + (size_t)warp * nslots * 32 + lane;
  for (int i = 0; i < nslots; ++i) slot[32 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int per = cdiv(d.ntiles, d.n_chA), j0 = ch * per, j1 = min(d.ntiles, j0 + per);
  const long long perN = (long long)d.KD * d.NQ, perV = (long long)d.KQ * d.ND;
  const long long BH = (long long)d.B * d.H;
  // this thread's queries: 8 nt + 2tq (+ 1)
  float mq[kQT][2], dq[kQT][2];
#pragma unroll
  for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = 8 * nt + 2 * tq + c;
      const bool in = nt < d.NQ && i < d.Q;
      mq[nt][c] = in ? __ldg(mstat + bh * d.Q + i) : INFINITY;
      dq[nt][c] = in ? __ldg(dden + bh * d.Q + i) : 0.f;
    }

  for (int j = j0; j < j1; ++j) {
    const int t0 = 16 * j;
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) live[r] = t0 + gq + 8 * r < d.N;
    uint32_t ax[KE][4];
    tile_x2<EP, kDense>(d, counts, src, ln1g, ln1b, b, t0, ax);
    // bf(x2) of the tokens at head h's columns, for the w kernel
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      __nv_bfloat16* row = x2_ws + ((size_t)b * d.N + t0 + gq + 8 * r) * EP;
#pragma unroll
      for (int ks = 0; ks < KE; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = 16 * ks + 8 * hf + 2 * tq;
          if (c / d.hd == h || (c + 1) / d.hd == h) {
            const uint32_t v = ax[ks][2 * hf + r];
            const bool lo = c / d.hd == h && c < d.E, hi = (c + 1) / d.hd == h && c + 1 < d.E;
            uint16_t* p = reinterpret_cast<uint16_t*>(row + c);
            if (lo) p[0] = (uint16_t)(v & 0xffffu);
            if (hi) p[1] = (uint16_t)(v >> 16);
          }
        }
    }
    // s = bf(k) bf(q)^T (tokens x queries); dn = bf(v) dnum^T, dnum in three passes
    float s[kQT][4], dn[kQT][4];
#pragma unroll
    for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dn[nt][i] = 0.f;
    for (int kd = 0; kd < d.KD; ++kd) {
      float k0[4], k1[4], v0[4], v1[4];
      proj_tile<EP>(pk.wkB, h, d.ND, 2 * kd, ax, k0);
      proj_tile<EP>(pk.wkB, h, d.ND, 2 * kd + 1, ax, k1);
      proj_tile<EP>(pk.wvB, h, d.ND, 2 * kd, ax, v0);
      proj_tile<EP>(pk.wvB, h, d.ND, 2 * kd + 1, ax, v1);
      uint32_t ka[4], va[4];
      ft::a_of_c(ka, k0, k1);
      ft::a_of_c(va, v0, v1);
#pragma unroll
      for (int nt = 0; nt < kQT; ++nt) {
        if (nt >= d.NQ) break;
        ft::mma(s[nt], ka, ft::ldb(pk.qB, ((long long)h * d.KD + kd) * d.NQ + nt, lane));
        float t[4] = {0.f, 0.f, 0.f, 0.f};  // the k16 step from zero, added in f32
#pragma unroll
        for (int p = 2; p >= 0; --p)
          ft::mma(t, va, ft::ldb(pk.dN, (p * BH + bh) * perN + (long long)kd * d.NQ + nt, lane));
        ft::add4(dn[nt], t);
      }
    }
    // e = exp(s scale - m) (0 on a dead row or query); ds = e (bf(dn) + dden) scale
#pragma unroll
    for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, c = i & 1;
        const float e = live[r] && mq[nt][c] != INFINITY ? expf(s[nt][i] * d.scale - mq[nt][c]) : 0.f;
        s[nt][i] = e;
        dn[nt][i] = e * (ft::bfr(dn[nt][i]) + dq[nt][c]) * d.scale;
      }
    // dv = bf(bf(e) dnum), dk = bf(ds bf(q)): per 8 columns of the head, written per token
    for (int nt = 0; nt < d.ND; ++nt) {
      float av[4] = {0.f, 0.f, 0.f, 0.f}, ak[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kq = 0; kq < kKQ; ++kq) {
        if (kq >= d.KQ) break;
        uint32_t ea[4], da3[3][4];
        ft::a_of_c(ea, s[2 * kq], s[2 * kq + 1]);
        ft::a3_of_c(da3, dn[2 * kq], dn[2 * kq + 1]);
#pragma unroll
        for (int p = 2; p >= 0; --p)
          ft::mma(av, ea, ft::ldb(pk.dV, (p * BH + bh) * perV + (long long)kq * d.ND + nt, lane));
        const uint2 qb = ft::ldb(pk.qK, ((long long)h * d.KQ + kq) * d.ND + nt, lane);
        ft::mma3a(ak, da3, qb.x, qb.y);
      }
      const int c = 8 * nt + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!live[r] || c >= d.hd) continue;
        const size_t at = ((size_t)b * d.N + t0 + gq + 8 * r) * EP + h * d.hd + c;
        const uint32_t pv = tc::pack_bf16(av[2 * r], av[2 * r + 1]);
        const uint32_t pk_ = tc::pack_bf16(ak[2 * r], ak[2 * r + 1]);
        uint16_t* dvp = reinterpret_cast<uint16_t*>(dv_ws + at);
        uint16_t* dkp = reinterpret_cast<uint16_t*>(dk_ws + at);
        dvp[0] = (uint16_t)(pv & 0xffffu);
        dkp[0] = (uint16_t)(pk_ & 0xffffu);
        if (c + 1 < d.hd) {
          dvp[1] = (uint16_t)(pv >> 16);
          dkp[1] = (uint16_t)(pk_ >> 16);
        }
      }
      // dqfull's block (queries, d tile nt) += ds^T bf(k): k = the 16 tokens
      float kt[4];
      proj_tile<EP>(pk.wkB, h, d.ND, nt, ax, kt);
      const uint32_t b0 = tc::transpose8x8(tc::pack_bf16(kt[0], kt[1]));
      const uint32_t b1 = tc::transpose8x8(tc::pack_bf16(kt[2], kt[3]));
#pragma unroll
      for (int mq = 0; mq < kKQ; ++mq) {
        if (mq >= d.KQ) break;
        uint32_t lo0[3], hi0[3], lo1[3], hi1[3];
        tc::split3_bf16(dn[2 * mq][0], dn[2 * mq][1], lo0[0], lo0[1], lo0[2]);
        tc::split3_bf16(dn[2 * mq][2], dn[2 * mq][3], hi0[0], hi0[1], hi0[2]);
        tc::split3_bf16(dn[2 * mq + 1][0], dn[2 * mq + 1][1], lo1[0], lo1[1], lo1[2]);
        tc::split3_bf16(dn[2 * mq + 1][2], dn[2 * mq + 1][3], hi1[0], hi1[1], hi1[2]);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 2; p >= 0; --p) {
          uint32_t a[4];
          ft::at_of_c(a, lo0[p], hi0[p], lo1[p], hi1[p]);
          tc::mma_bf16(acc, a, b0, b1);
        }
        float4& v = slot[32 * (mq * d.ND + nt)];
        v.x += acc[0], v.y += acc[1], v.z += acc[2], v.w += acc[3];
      }
    }
  }
  // the unit's dqfull block: part_dq[(b, ch)] (Q, E) at head h's columns
  float* pq = part_dq + ((size_t)b * d.n_chA + ch) * d.Q * d.E;
  for (int i = 0; i < nslots; ++i) {
    const int mq = i / d.ND, nt = i % d.ND;
    const float4 v = slot[32 * i];
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = 16 * mq + gq + 8 * (k >> 1), dd = 8 * nt + 2 * tq + (k & 1);
      if (q < d.Q && dd < d.hd) pq[(size_t)q * d.E + h * d.hd + dd] = vv[k];
    }
  }
}

// -- the backward: per token ---------------------------------------------------------

// the LayerNorm sums (dln1g, dln1b: NE slots each) and, dense, the genes'
// dtable rows (NE slots) as thread-private float4 slots
__host__ __device__ inline int tok_slots(int NE, bool dense) { return (dense ? 3 : 2) * NE; }

// bf16 pairs of a workspace row as the A fragment of k16 step ks, 0 past E
__device__ __forceinline__ uint32_t ws_pair(const __nv_bfloat16* row, int c, int E) {
  uint32_t v = *reinterpret_cast<const uint32_t*>(row + c);
  if (c >= E) return 0u;
  if (c + 1 >= E) v &= 0xffffu;
  return v;
}

template <int EP, bool kDense>
__global__ void __launch_bounds__(kThreads)
pool_bwd_tok(const Dims d, const Packs pk, const float* __restrict__ counts,
             const float* __restrict__ src, const float* __restrict__ ln1g,
             const float* __restrict__ ln1b, const __nv_bfloat16* __restrict__ dk_ws,
             const __nv_bfloat16* __restrict__ dv_ws, float* __restrict__ demb,
             float* __restrict__ part_ln, float* __restrict__ part_dt) {
  constexpr int KE = EP / 16, NE = EP / 8;
  extern __shared__ __align__(16) float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int unit = blockIdx.x * kWarps + warp;
  int b0, b1, j0, j1;
  if (kDense) {  // unit = (gene tile, cell group)
    const int gt = unit % d.ntiles, grp = unit / d.ntiles;
    if (grp >= d.n_grp) return;
    b0 = grp * d.Bg, b1 = min(d.B, b0 + d.Bg), j0 = gt, j1 = gt + 1;
  } else {  // unit = (cell, token chunk)
    const int ch = unit % d.n_chB;
    b0 = unit / d.n_chB, b1 = b0 + 1;
    if (b0 >= d.B) return;
    const int per = cdiv(d.ntiles, d.n_chB);
    j0 = ch * per, j1 = min(d.ntiles, j0 + per);
  }
  float4* slot = smem4 + (size_t)warp * tok_slots(NE, kDense) * 32 + lane;
  for (int i = 0; i < tok_slots(NE, kDense); ++i) slot[32 * i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int b = b0; b < b1; ++b)
    for (int j = j0; j < j1; ++j) {
      const int t0 = 16 * j;
      // dx2 = bf(bf(dk) bf(wk)^T) + bf(bf(dv) bf(wv)^T) in C tiles of 8 columns
      float dx[NE][4];
      {
        float dxv[NE][4];
#pragma unroll
        for (int nt = 0; nt < NE; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) dx[nt][i] = dxv[nt][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KE; ++ks) {
          uint32_t ak[4], av[4];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int t = min(t0 + gq + 8 * r, d.N - 1);
            const __nv_bfloat16* rk = dk_ws + ((size_t)b * d.N + t) * EP;
            const __nv_bfloat16* rv = dv_ws + ((size_t)b * d.N + t) * EP;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int c = 16 * ks + 8 * hf + 2 * tq;
              ak[2 * hf + r] = ws_pair(rk, c, d.E);
              av[2 * hf + r] = ws_pair(rv, c, d.E);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NE; ++nt) {
            ft::mma(dx[nt], ak, ft::ldb(pk.wkT, (long long)ks * NE + nt, lane));
            ft::mma(dxv[nt], av, ft::ldb(pk.wvT, (long long)ks * NE + nt, lane));
          }
        }
#pragma unroll
        for (int nt = 0; nt < NE; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) dx[nt][i] = ft::bfr(dx[nt][i]) + ft::bfr(dxv[nt][i]);
      }
      // the LayerNorm again, in the C tiles' columns, and its backward
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + gq + 8 * r;
        const bool live = t < d.N;
        const int tt = live ? t : d.N - 1;
        const float* row = src + ((kDense ? 0 : (size_t)b * d.N) + tt) * (size_t)d.E;
        const float lc = kDense ? log1pf(__ldg(counts + (size_t)b * d.N + tt)) : 1.f;
        float xh[NE][2];
        float s = 0.f;
#pragma unroll
        for (int nt = 0; nt < NE; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * nt + 2 * tq + c;
            const float v = col < d.E ? __ldg(row + col) : 0.f;
            xh[nt][c] = kDense ? v * lc : v;
            s += xh[nt][c];
          }
        const float mean = ft::quad_sum(s) / d.E;
        float var = 0.f;
#pragma unroll
        for (int nt = 0; nt < NE; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * nt + 2 * tq + c;
            xh[nt][c] = col < d.E ? xh[nt][c] - mean : 0.f;
            var = fmaf(xh[nt][c], xh[nt][c], var);
          }
        const float rstd = rsqrtf(ft::quad_sum(var) / d.E + d.eps);
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NE; ++nt) {
          float4& sl = slot[32 * nt];
          float4& sb = slot[32 * (NE + nt)];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * nt + 2 * tq + c;
            xh[nt][c] *= rstd;
            const float g2 = live ? dx[nt][2 * r + c] : 0.f;
            (c ? sl.y : sl.x) = fmaf(g2, xh[nt][c], c ? sl.y : sl.x);
            (c ? sb.y : sb.x) += g2;
            const float dxh = col < d.E ? g2 * __ldg(ln1g + col) : 0.f;
            dx[nt][2 * r + c] = dxh;
            m1 += dxh;
            m2 = fmaf(dxh, xh[nt][c], m2);
          }
        }
        m1 = ft::quad_sum(m1) / d.E;
        m2 = ft::quad_sum(m2) / d.E;
#pragma unroll
        for (int nt = 0; nt < NE; ++nt) {
          float g[2];
#pragma unroll
          for (int c = 0; c < 2; ++c)
            g[c] = rstd * (dx[nt][2 * r + c] - m1 - xh[nt][c] * m2);
          const int col = 8 * nt + 2 * tq;
          if (kDense) {
            float4& st = slot[32 * (2 * NE + nt)];
            (r ? st.z : st.x) = fmaf(g[0], lc, r ? st.z : st.x);
            (r ? st.w : st.y) = fmaf(g[1], lc, r ? st.w : st.y);
          } else if (live) {
            float* out = demb + ((size_t)b * d.N + t) * d.E;
            if (col < d.E) out[col] = g[0];
            if (col + 1 < d.E) out[col + 1] = g[1];
          }
        }
      }
    }

  // -- the unit's partials: the LayerNorm sums; dense, its genes' dtable rows
  float* pl = part_ln + (size_t)unit * 2 * d.E;
  for (int k = 0; k < 2; ++k)
    for (int nt = 0; nt < NE; ++nt) {
      const float4 v = slot[32 * (k * NE + nt)];
      const float s0 = ft::col_sum(v.x), s1 = ft::col_sum(v.y);
      const int col = 8 * nt + 2 * tq;
      if (gq == 0) {
        if (col < d.E) pl[k * d.E + col] = s0;
        if (col + 1 < d.E) pl[k * d.E + col + 1] = s1;
      }
    }
  if (kDense) {
    const int grp = unit / d.ntiles;
    float* pt = part_dt + (size_t)grp * d.N * d.E;
    for (int nt = 0; nt < NE; ++nt) {
      const float4 v = slot[32 * (2 * NE + nt)];
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 16 * j0 + gq + 8 * (k >> 1), col = 8 * nt + 2 * tq + (k & 1);
        if (t < d.N && col < d.E) pt[(size_t)t * d.E + col] = vv[k];
      }
    }
  }
}

// -- the backward: dwk, dwv --------------------------------------------------------------

template <int EP>
__global__ void __launch_bounds__(kThreads)
pool_bwd_w(const Dims d, const __nv_bfloat16* __restrict__ x2_ws,
           const __nv_bfloat16* __restrict__ dk_ws, const __nv_bfloat16* __restrict__ dv_ws,
           float* __restrict__ part_w) {
  constexpr int NE = EP / 8, KE = EP / 16;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int unit = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int mt = unit % KE, ch = unit / KE;
  if (ch >= d.n_chW) return;
  const long long T = (long long)d.B * d.N;
  const int n_tt = cdiv(T, 16), per = cdiv(n_tt, d.n_chW);
  const int j0 = ch * per, j1 = min(n_tt, j0 + per);
  const uint16_t* x2 = reinterpret_cast<const uint16_t*>(x2_ws);
  const uint16_t* dk = reinterpret_cast<const uint16_t*>(dk_ws);
  const uint16_t* dv = reinterpret_cast<const uint16_t*>(dv_ws);
  float wk[NE][4], wv[NE][4];
#pragma unroll
  for (int nt = 0; nt < NE; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) wk[nt][i] = wv[nt][i] = 0.f;
  // a 16-bit entry of a workspace row, 0 past T or E
  auto at = [&](const uint16_t* ws, long long t, int c) -> uint32_t {
    return t < T && c < d.E ? (uint32_t)ws[t * EP + c] : 0u;
  };
  for (int j = j0; j < j1; ++j) {
    const long long t0 = 16LL * j;
    // A (rows e_in 16 mt + gq (+ 8), k the 16 tokens) = bf(x2)^T
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 16 * mt + gq + 8 * (i & 1);
      const long long t = t0 + 2 * tq + 8 * (i >> 1);
      a[i] = at(x2, t, e) | (at(x2, t + 1, e) << 16);
    }
#pragma unroll
    for (int nt = 0; nt < NE; ++nt) {
      const int e = 8 * nt + gq;
      uint32_t bk[2], bv[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long t = t0 + 2 * tq + 8 * hf;
        bk[hf] = at(dk, t, e) | (at(dk, t + 1, e) << 16);
        bv[hf] = at(dv, t, e) | (at(dv, t + 1, e) << 16);
      }
      float tk[4] = {0.f, 0.f, 0.f, 0.f}, tv[4] = {0.f, 0.f, 0.f, 0.f};  // the tile from zero
      tc::mma_bf16(tk, a, bk[0], bk[1]);
      tc::mma_bf16(tv, a, bv[0], bv[1]);
      ft::add4(wk[nt], tk);
      ft::add4(wv[nt], tv);
    }
  }
  float* pw = part_w + (size_t)ch * 2 * d.E * d.E;
#pragma unroll
  for (int nt = 0; nt < NE; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ei = 16 * mt + gq + 8 * (i >> 1), eo = 8 * nt + 2 * tq + (i & 1);
      if (ei < d.E && eo < d.E) {
        pw[(size_t)ei * d.E + eo] = wk[nt][i];
        pw[(size_t)d.E * d.E + (size_t)ei * d.E + eo] = wv[nt][i];
      }
    }
}

// -- launches -----------------------------------------------------------------------------

template <int EP, bool kDense>
cudaError_t forward_ep(const Dims& d, const Work& w, const float* counts, const float* src,
                       const float* qfull, const float* ln1g, const float* ln1b, const float* wk,
                       float* num, float* den, float* m, cudaStream_t s) {
  auto kernel = pool_fwd_gen<EP, kDense>;
  const long long smem = fwd_smem_bytes(d);
  cudaError_t err = ft::allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<d.B * d.H, kThreads, (size_t)smem, s>>>(d, w.pk, counts, src, qfull, ln1g, ln1b, wk,
                                                    num, den, m);
  return cudaGetLastError();
}

template <int EP, bool kDense>
cudaError_t backward_ep(const Dims& d, const Work& w, const float* counts, const float* src,
                        const float* ln1g, const float* ln1b, const float* mstat,
                        const float* dden, float* dsrc, cudaStream_t s) {
  cudaError_t err;
  if (d.ntiles > 0) {
    auto kernel = pool_bwd_attn<EP, kDense>;
    const long long smem = attn_smem_bytes(d);
    if ((err = ft::allow_smem((const void*)kernel, smem)) != cudaSuccess) return err;
    const long long units = (long long)d.B * d.H * d.n_chA;
    kernel<<<cdiv(units, kWarps), kThreads, (size_t)smem, s>>>(
        d, w.pk, counts, src, ln1g, ln1b, mstat, dden, w.x2, w.dk, w.dv, w.part_dq);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto tok = pool_bwd_tok<EP, kDense>;
    const long long smem2 = (long long)kWarps * tok_slots(EP / 8, kDense) * 32 * 16;
    if ((err = ft::allow_smem((const void*)tok, smem2)) != cudaSuccess) return err;
    const long long units2 = kDense ? (long long)d.ntiles * d.n_grp : (long long)d.B * d.n_chB;
    tok<<<cdiv(units2, kWarps), kThreads, (size_t)smem2, s>>>(d, w.pk, counts, src, ln1g, ln1b,
                                                               w.dk, w.dv, dsrc, w.part_ln,
                                                               w.part_dt);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long units3 = (long long)(EP / 16) * d.n_chW;
    pool_bwd_w<EP><<<cdiv(units3, kWarps), kThreads, 0, s>>>(d, w.x2, w.dk, w.dv, w.part_w);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kDense>
int run_forward(const float* counts, const float* src, const float* qfull, const float* ln1g,
                const float* ln1b, const float* wk, const float* wv, float* num, float* den,
                float* m, void* workspace, int B, int N, int E, int H, int Q, float eps,
                float scale, cudaStream_t s) {
  const Dims d = make_dims(B, N, E, H, Q, eps, scale);
  long long bytes = 0;
  Work w = carve(d, workspace, false, kDense, &bytes);
  cudaError_t err = pack(d, w, qfull, wk, wv, nullptr, false, s);
  if (err != cudaSuccess) return (int)err;
  switch (d.EP) {
    case 32: return (int)forward_ep<32, kDense>(d, w, counts, src, qfull, ln1g, ln1b, wk, num, den, m, s);
    case 64: return (int)forward_ep<64, kDense>(d, w, counts, src, qfull, ln1g, ln1b, wk, num, den, m, s);
    default: return (int)forward_ep<128, kDense>(d, w, counts, src, qfull, ln1g, ln1b, wk, num, den, m, s);
  }
}

template <bool kDense>
int run_backward(const float* counts, const float* src, const float* qfull, const float* ln1g,
                 const float* ln1b, const float* wk, const float* wv, const float* mstat,
                 const float* dnum, const float* dden, float* dsrc, float* dqfull, float* dln1g,
                 float* dln1b, float* dwk, float* dwv, void* workspace, int B, int N, int E,
                 int H, int Q, float eps, float scale, cudaStream_t s) {
  const Dims d = make_dims(B, N, E, H, Q, eps, scale);
  long long bytes = 0;
  Work w = carve(d, workspace, true, kDense, &bytes);
  cudaError_t err = pack(d, w, qfull, wk, wv, dnum, true, s);
  if (err != cudaSuccess) return (int)err;
  switch (d.EP) {
    case 32: err = backward_ep<32, kDense>(d, w, counts, src, ln1g, ln1b, mstat, dden, dsrc, s); break;
    case 64: err = backward_ep<64, kDense>(d, w, counts, src, ln1g, ln1b, mstat, dden, dsrc, s); break;
    default: err = backward_ep<128, kDense>(d, w, counts, src, ln1g, ln1b, mstat, dden, dsrc, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  const long long EE = (long long)E * E;
  const int units2 = kDense ? d.ntiles * d.n_grp : B * d.n_chB;
  const bool any = d.ntiles > 0;
  ft::Sums sums{};
  // with no token every gradient is 0: partial counts of 0 write zeros
  sums.job[0] = {w.part_dq, dqfull, (long long)H * Q * E, (long long)Q * E, any ? B * d.n_chA : 0,
                 2, Q, d.hd, E, 0, 0};
  sums.job[1] = {w.part_ln, dln1g, (long long)E, 2LL * E, any ? units2 : 0, 0, 0, 0, 0, 0, 0};
  sums.job[2] = {w.part_ln + E, dln1b, (long long)E, 2LL * E, any ? units2 : 0, 0, 0, 0, 0, 0, 0};
  sums.job[3] = {w.part_w, dwk, EE, 2 * EE, any ? d.n_chW : 0, 0, 0, 0, 0, 0, 0};
  sums.job[4] = {w.part_w + EE, dwv, EE, 2 * EE, any ? d.n_chW : 0, 0, 0, 0, 0, 0, 0};
  sums.n = 5;
  if (kDense) sums.job[sums.n++] = {w.part_dt, dsrc, (long long)N * E, (long long)N * E, d.n_grp,
                                    0, 0, 0, 0, 0, 0};
  return (int)ft::launch_sums(sums, s);
}

}  // namespace
}  // namespace poolg

extern "C" {

// Whether the any-width narrow pool kernels take (E, H, Q): E from 1 to 128,
// H dividing E, 1 to 64 inducing points.
int scldm_encoder_pool_gen_takes(int E, int H, int Q) {
  return E >= 1 && E <= 128 && H >= 1 && E % H == 0 && Q >= 1 && Q <= poolg::kMaxQ;
}

// Floats of the device workspace of the forward (backward = 0) or the
// backward: the packed operands, and for the backward bf(x2), bf(dk) and
// bf(dv) of every token and the partials. 0 for a shape not taken.
long long scldm_encoder_pool_gen_workspace_floats(int B, int N, int E, int H, int Q, int dense,
                                                  int backward) {
  if (!scldm_encoder_pool_gen_takes(E, H, Q) || B <= 0 || N < 0) return 0;
  long long bytes = 0;
  poolg::carve(poolg::make_dims(B, N, E, H, Q, 0.f, 1.f), nullptr, backward != 0, dense != 0,
               &bytes);
  return bytes / 4;
}

// Forwards: num (B, Q, E), den and m (B, Q*H), as scldm_encoder_pool_forward
// and scldm_window_pool_forward, with a workspace of
// scldm_encoder_pool_gen_workspace_floats(..., 0) floats.
int scldm_encoder_pool_gen_forward(const void* counts, const void* table, const void* qfull,
                                   const void* ln1g, const void* ln1b, const void* wk,
                                   const void* wv, void* num, void* den, void* m,
                                   void* workspace, int B, int N, int E, int H, int Q, float eps,
                                   float scale, void* stream) {
  if (B == 0) return 0;
  if (!scldm_encoder_pool_gen_takes(E, H, Q) || N < 0) return (int)cudaErrorInvalidValue;
  return poolg::run_forward<true>((const float*)counts, (const float*)table, (const float*)qfull,
                                  (const float*)ln1g, (const float*)ln1b, (const float*)wk,
                                  (const float*)wv, (float*)num, (float*)den, (float*)m,
                                  workspace, B, N, E, H, Q, eps, scale, (cudaStream_t)stream);
}

int scldm_window_pool_gen_forward(const void* emb, const void* qfull, const void* ln1g,
                                  const void* ln1b, const void* wk, const void* wv, void* num,
                                  void* den, void* m, void* workspace, int B, int N, int E, int H,
                                  int Q, float eps, float scale, void* stream) {
  if (B == 0) return 0;
  if (!scldm_encoder_pool_gen_takes(E, H, Q) || N < 0) return (int)cudaErrorInvalidValue;
  return poolg::run_forward<false>(nullptr, (const float*)emb, (const float*)qfull,
                                   (const float*)ln1g, (const float*)ln1b, (const float*)wk,
                                   (const float*)wv, (float*)num, (float*)den, (float*)m,
                                   workspace, B, N, E, H, Q, eps, scale, (cudaStream_t)stream);
}

// Backwards, as scldm_encoder_pool_backward and scldm_window_pool_backward
// (every gradient written whole, each summed in a fixed order), with a
// workspace of scldm_encoder_pool_gen_workspace_floats(..., 1) floats.
int scldm_encoder_pool_gen_backward(const void* counts, const void* table, const void* qfull,
                                    const void* ln1g, const void* ln1b, const void* wk,
                                    const void* wv, const void* m, const void* dnum,
                                    const void* dden, void* dtable, void* dqfull, void* dln1g,
                                    void* dln1b, void* dwk, void* dwv, void* workspace, int B,
                                    int N, int E, int H, int Q, float eps, float scale,
                                    void* stream) {
  if (B == 0) return 0;
  if (!scldm_encoder_pool_gen_takes(E, H, Q) || N < 0) return (int)cudaErrorInvalidValue;
  return poolg::run_backward<true>(
      (const float*)counts, (const float*)table, (const float*)qfull, (const float*)ln1g,
      (const float*)ln1b, (const float*)wk, (const float*)wv, (const float*)m,
      (const float*)dnum, (const float*)dden, (float*)dtable, (float*)dqfull, (float*)dln1g,
      (float*)dln1b, (float*)dwk, (float*)dwv, workspace, B, N, E, H, Q, eps, scale,
      (cudaStream_t)stream);
}

int scldm_window_pool_gen_backward(const void* emb, const void* qfull, const void* ln1g,
                                   const void* ln1b, const void* wk, const void* wv,
                                   const void* m, const void* dnum, const void* dden, void* demb,
                                   void* dqfull, void* dln1g, void* dln1b, void* dwk, void* dwv,
                                   void* workspace, int B, int N, int E, int H, int Q, float eps,
                                   float scale, void* stream) {
  if (B == 0) return 0;
  if (!scldm_encoder_pool_gen_takes(E, H, Q) || N < 0) return (int)cudaErrorInvalidValue;
  return poolg::run_backward<false>(
      nullptr, (const float*)emb, (const float*)qfull, (const float*)ln1g, (const float*)ln1b,
      (const float*)wk, (const float*)wv, (const float*)m, (const float*)dnum,
      (const float*)dden, (float*)demb, (float*)dqfull, (float*)dln1g, (float*)dln1b,
      (float*)dwk, (float*)dwv, workspace, B, N, E, H, Q, eps, scale, (cudaStream_t)stream);
}

}  // extern "C"
