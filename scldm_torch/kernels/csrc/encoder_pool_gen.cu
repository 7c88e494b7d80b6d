// The VAE encoder pools (dense and window) at any width the JAX gate
// dispatches to the narrow design (E <= 128, any head count dividing E, any
// number of inducing points): forward and recompute backward on wgmma (bf16
// products, f32 sums) with TMA-fed shared memory, for sm_90a. Replaces the TPU
// kernels scldm_tpu/ops/fused_encoder.py::fused_encoder_pool (`_fused_fwd`)
// and `_fused_bwd`, and fused_window_pool with `_wfused_bwd`, at every narrow
// shape but the reference encoder's (E = 32, 4 heads, 16 inducing points),
// which encoder_pool.cu keeps. The math is `_ln_kv_scores` and
// `_numden_given_m` there, and `_pool` / `_plain_grads` in
// scldm_torch/ops/fused_encoder.py: x2 = LN(x), k = bf(x2) bf(wk), v = bf(x2)
// bf(wv), s = scale bf(k_h) . bf(q_h), m = the max over the cell's tokens, e =
// exp(s - m), den = sum e, num = sum bf(e) bf(v_h); one source for both
// variants, templated on where token t of cell b comes from (kDense:
// table[t] * log1p(counts[b, t]); else emb[b, t]).
//
// What bounds it on an H100: the bf16 tensor-core rate over the function's
// products (the k | v projection, 2 E^2 multiply-adds a token, and the scores
// and pooled values, 2 Q E), about 0.025 ms forward at the dense parse1m
// step (B = 128, G = 2,000, E = 128, 8 heads, Q = 64); the window variant at
// the dentate window (S = 6,147, E = 64) is bound by its 201 MB of emb.
// What the design does about it:
// - Each token's LayerNorm and projections run once a pass for all heads: a
//   warpgroup takes 64 tokens (their rows prefetched a tile ahead by cp.async
//   where shared memory allows), takes the LayerNorm a quad a row in PyTorch's
//   summation order (`row_sum`), writes bf(x2) into the 128-byte swizzle, and
//   runs the projection as one wgmma (64 tokens x E outputs, k16 steps over E)
//   against [wk | wv]^T, which TMA brings into shared memory once a CTA. k
//   (and v, or v^T, k^T) go back to shared memory as bf16, where the attention
//   products read them.
// - The queries are the 64 rows of the score and pooled-value products
//   (`poolw_q`): s^T (queries x 64 tokens) = bf(q) bf(k)^T takes q's
//   fragments at the head's k16 steps, masked to its columns (any head width),
//   and k from shared memory; e^T stays in registers as the A operand of num
//   += bf(e)^T bf(v_h), whose B is v^T's 8-row tiles of head h (m64n8k16).
//   Each thread holds two query rows: the max, den and the softmax need no
//   shuffles but the quad's, and every elementwise step is branch-free.
// - Any number of inducing points: the queries come in 64-query tiles, one
//   grid dimension. A cell's tokens may split over CTAs (chunks), so that
//   B x query tiles x chunks fills the card; two warpgroups a CTA take every
//   other tile of a chunk and add their sums in order.
// - Two passes, as the plain version rounds e against the cell's final max:
//   `kMax` takes each (head, query)'s max over a chunk's tokens and the first
//   token reaching it; `poolw_exact` takes that token's score again in the
//   plain version's f32 order (so m is the plain version's m); `kFwd` then
//   takes e, den and num. Partials of every chunk are added in chunk order.
// Backward (the forward recomputed given the saved m; every sum in a fixed
// order, no atomics, so it repeats its bits):
//   poolw_q<kDq>  queries on the rows again: s^T, e^T, dn^T = dnum_h bf(v)^T
//                 (dnum in three bf16 passes, the smallest first), ds^T = e
//                 (bf(dn) + dden) scale, dq += ds^T bf(k_h) (ds in three
//                 passes; k^T's 8-row tiles of head h as B); in the first
//                 query tile it also writes bf(k) and bf(v) of every token.
//   poolw_t       tokens on the rows, bf(k), bf(v) by TMA a tile ahead: s =
//                 bf(k_h) q^T, dn = bf(v_h) dnum^T, e, ds, then dv_h = bf(e)
//                 dnum_h and dk_h = ds bf(q_h) (the f32 operand in three
//                 passes, each summed from zero and the passes added in f32):
//                 bf16 with one query tile, else f32 per tile, which
//                 `poolw_dkv` adds in order and rounds.
//   poolw_tok     bf(dk), bf(dv) by TMA a tile ahead: dx2 = bf(bf(dk) bf(wk)^T)
//                 + bf(bf(dv) bf(wv)^T) (wgmma), the LayerNorm again and its
//                 backward into demb (or, dense, dtable's rows times
//                 log1p(count) summed over a cell group), dln1g, dln1b; bf(x2)
//                 to the workspace.
//   poolw_w       dwk | dwv = bf(x2)^T [bf(dk) | bf(dv)] over token chunks
//                 (both operands MN-major from a TMA ring).
//   poolw_sums    every partial added in index order.
// The caller rounds the reduced gradients of qfull, wk and wv to bf16.
//
// Tried and slower on an H100 80GB HBM3 at 700 W (device time by kernel): a
// head's whole 8-column tiles in one commit group (its pooled-value step 1.4k
// -> 2.2k cycles a head at E = 128, with more spills); two tiles paired into
// one m64n16k16 chain (the dq kernel 0.73 -> 0.99 ms at E = 128: ptxas
// serialises more of its wgmma for registers).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_tma.cuh"
#include "tensor_core.cuh"

namespace poolw {
namespace {

// (hopper_wgmma.cuh, hopper_tma.cuh)
using hopper::a_frag;
using hopper::bfr;
using hopper::fence_acc;
using hopper::fence_async_shared;
using hopper::fence_mbar_init;
using hopper::k_desc;
using hopper::kBox;
using hopper::make_map;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::md;
using hopper::named_sync;
using hopper::quad_sum;
using hopper::sw;
using hopper::tma_load;
using hopper::tma_load3;
using hopper::wg_commit;
using hopper::wg_fence;
using hopper::wg_rs64;
using hopper::wg_ss;
using hopper::wg_ss64;
using hopper::wg_wait0;

constexpr int kWG = 2;  // warpgroups a CTA of the attention and per-token kernels
constexpr int kSmemMax = 232448;
// CTAs the attention kernels aim for (one an SM), units of the per-token
// kernel (one a warpgroup, two an SM), chunks of the weight-gradient kernel
constexpr int kTargetAttn = 132, kTargetTok = 264, kTargetW = 132;
constexpr int kWStages = 3;  // token tiles in flight in poolw_w

enum Mode { kMax = 0, kFwd = 1, kDq = 2 };

__host__ __device__ constexpr int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
__host__ __device__ constexpr int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

struct Dims {
  int B, N, E, H, Q, hd;
  int EP, ke;          // E padded to 64 or 128; E's k16 steps
  int NQT, QP;         // 64-query tiles, Q padded to them
  int ntiles;          // 64-token tiles of a cell
  int nch, per;        // attention kernels: token chunks of a (cell, query tile), tiles a chunk
  int n_chB, perB;     // per-token kernel, window: chunks of a cell, tiles a chunk
  int Bg, n_grp;       // per-token kernel, dense: cells of a group, groups
  int n_tw, n_chW, perW;  // weight gradients: 64-token tiles of all B N tokens, chunks, tiles a chunk
  long long T;         // B N tokens
  float eps, scale;
  float inv_e;         // 1 / E: a mean is a sum times it, as PyTorch's CUDA mean takes it
};

Dims make_dims(int B, int N, int E, int H, int Q, float eps, float scale) {
  Dims d{};
  d.B = B, d.N = N, d.E = E, d.H = H, d.Q = Q, d.hd = E / H;
  d.EP = E <= 64 ? 64 : 128, d.ke = cdiv(E, 16);
  d.NQT = cdiv(Q, 64), d.QP = 64 * d.NQT;
  d.ntiles = cdiv(N, 64);
  const int tiles = d.ntiles > 0 ? d.ntiles : 1;
  d.nch = clampi(kTargetAttn / (B * d.NQT), 1, tiles);
  d.per = cdiv(d.ntiles, d.nch);
  d.nch = d.per > 0 ? cdiv(d.ntiles, d.per) : 1;
  d.n_chB = clampi(cdiv(kTargetTok, B), 1, tiles);
  d.perB = cdiv(d.ntiles, d.n_chB);
  d.n_chB = d.perB > 0 ? cdiv(d.ntiles, d.perB) : 1;
  d.n_grp = clampi(cdiv(kTargetTok, tiles), 1, B);
  d.Bg = cdiv(B, d.n_grp);
  d.n_grp = cdiv(B, d.Bg);
  d.T = (long long)B * N;
  d.n_tw = cdiv(d.T, 64);
  d.n_chW = clampi(kTargetW, 1, d.n_tw > 0 ? d.n_tw : 1);
  d.perW = cdiv(d.n_tw, d.n_chW);
  d.n_chW = d.perW > 0 ? cdiv(d.n_tw, d.perW) : 1;
  d.eps = eps, d.scale = scale, d.inv_e = 1.0f / (float)E;
  return d;
}

// per-token units of poolw_tok: window (cell, chunk); dense (gene tile, cell group)
__host__ __device__ inline int tok_units(const Dims& d, bool dense) {
  return dense ? d.ntiles * d.n_grp : d.B * d.n_chB;
}

struct Work {
  __nv_bfloat16 *wT, *wN;   // [wk | wv]^T and [wk | wv] as (2 EP, EP) rows, bf16
  __nv_bfloat16 *qM, *qT;   // q (QP, EP): query i's head-h slice in head h's columns; q^T
  __nv_bfloat16 *dN, *dNT;  // dnum's three bf16 parts (B 3, QP, EP), and transposed (B 3, EP, QP)
  float *pmax, *pnum, *pden;          // forward partials of the chunks
  int* parg;                          // the first token of each chunk's max
  float *pdq, *pdk, *pdv;             // backward: dq per chunk; past one query tile, dk and dv of each (f32)
  __nv_bfloat16 *kg, *vg;             // bf(k), bf(v) of every token (T, EP), for poolw_t
  __nv_bfloat16 *dk, *dv, *x2;        // bf(dk), bf(dv), bf(x2) of every token (T, EP)
  float *part_ln, *part_w, *part_dt;  // LayerNorm sums per unit; dW per chunk; dtable per group
};

struct Carve {
  char* base;
  long long used;
  template <class T>
  T* take(long long count) {
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += (count * (long long)sizeof(T) + 1023) & ~1023LL;
    return p;
  }
};

Work carve(const Dims& d, void* base, bool bwd, bool dense, long long* bytes) {
  Carve c{(char*)base, 0};
  Work w{};
  const long long chunks = (long long)d.B * d.NQT * d.nch, EE = (long long)d.EP * d.EP;
  w.wT = c.take<__nv_bfloat16>(2 * EE);
  w.qM = c.take<__nv_bfloat16>((long long)d.QP * d.EP);
  if (!bwd) {
    w.pmax = c.take<float>(chunks * d.H * 64);
    w.parg = c.take<int>(chunks * d.H * 64);
    w.pnum = c.take<float>(chunks * 64 * d.E);
    w.pden = c.take<float>(chunks * d.H * 64);
  } else {
    w.wN = c.take<__nv_bfloat16>(2 * EE);
    w.qT = c.take<__nv_bfloat16>((long long)d.QP * d.EP);
    w.dN = c.take<__nv_bfloat16>(3LL * d.B * d.QP * d.EP);
    w.dNT = c.take<__nv_bfloat16>(3LL * d.B * d.QP * d.EP);
    w.pdq = c.take<float>(chunks * 64 * d.E);
    w.pdk = c.take<float>(d.NQT > 1 ? (long long)d.NQT * d.T * d.E : 0);
    w.pdv = c.take<float>(d.NQT > 1 ? (long long)d.NQT * d.T * d.E : 0);
    w.kg = c.take<__nv_bfloat16>(d.T * d.EP);
    w.vg = c.take<__nv_bfloat16>(d.T * d.EP);
    w.dk = c.take<__nv_bfloat16>(d.T * d.EP);
    w.dv = c.take<__nv_bfloat16>(d.T * d.EP);
    w.x2 = c.take<__nv_bfloat16>(d.T * d.EP);
    w.part_ln = c.take<float>((long long)tok_units(d, dense) * 2 * d.E);
    w.part_w = c.take<float>((long long)d.n_chW * 2 * d.E * d.E);
    if (dense) w.part_dt = c.take<float>((long long)d.n_grp * d.N * d.E);
  }
  *bytes = c.used;
  return w;
}

// -- the packer ------------------------------------------------------------------------

struct PackArgs {
  const float *wk, *wv, *qfull, *dnum;
  Work w;
  long long n[6];  // wT, qM, then backward wN, qT, dN, dNT
};

// bf16 part `p` (0 hi, 1 mid, 2 lo) of x, as tc::split3_bf16 splits it
__device__ __forceinline__ float part3(float x, int p) {
  const float hi = bfr(x);
  if (p == 0) return hi;
  const float r = x - hi, mid = bfr(r);
  return p == 1 ? mid : r - mid;
}

__global__ void __launch_bounds__(256) poolw_pack(const Dims d, const PackArgs a) {
  const long long total = a.n[0] + a.n[1] + a.n[2] + a.n[3] + a.n[4] + a.n[5];
  const int EP = d.EP, QP = d.QP, E = d.E, Q = d.Q;
  for (long long idx = (long long)blockIdx.x * 256 + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * 256) {
    long long i = idx;
    int j = 0;
    while (i >= a.n[j]) i -= a.n[j++];
    float v = 0.f;
    __nv_bfloat16* dst;
    if (j == 0 || j == 2) {  // wT (row e_out, column e_in), wN (row e_in, column e_out)
      const int r = (int)(i / EP), c = (int)(i % EP), rr = r % EP;
      const float* W = r < EP ? a.wk : a.wv;
      if (rr < E && c < E) v = j == 0 ? W[(long long)c * E + rr] : W[(long long)rr * E + c];
      dst = (j == 0 ? a.w.wT : a.w.wN) + i;
    } else if (j == 1 || j == 3) {  // qM (query, column), qT (column, query)
      const int qi = (int)(j == 1 ? i / EP : i % QP), c = (int)(j == 1 ? i % EP : i / QP);
      if (qi < Q && c < E) v = a.qfull[((long long)(c / d.hd) * Q + qi) * E + c];
      dst = (j == 1 ? a.w.qM : a.w.qT) + i;
    } else {  // dN (cell part, query, column), dNT (cell part, column, query)
      const long long bp = i / ((long long)QP * EP), rem = i % ((long long)QP * EP);
      const int qi = (int)(j == 4 ? rem / EP : rem % QP), c = (int)(j == 4 ? rem % EP : rem / QP);
      if (qi < Q && c < E) v = part3(a.dnum[((bp / 3) * Q + qi) * E + c], (int)(bp % 3));
      dst = (j == 4 ? a.w.dN : a.w.dNT) + i;
    }
    *dst = __float2bfloat16_rn(v);
  }
}

// -- device pieces -------------------------------------------------------------------

// k step ks of a K-major operand in panels of `rows` rows (64 columns a panel)
__device__ __forceinline__ uint64_t kdp(uint32_t base, int ks, int rows) {
  return k_desc(base + (ks >> 2) * rows * 128 + (ks & 3) * 32);
}

// d (64 x 8, f32) += a (64 x 16, registers in mma.sync's fragment order) b (16 x 8)
__device__ __forceinline__ void wg_rs8(float& d0, float& d1, float& d2, float& d3,
                                       const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// keeps A fragment registers from being reused until the wgmma that reads them is done
__device__ __forceinline__ void hold(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
__device__ __forceinline__ void fence4(float& a, float& b, float& c, float& e) {
  asm volatile("" : "+f"(a), "+f"(b), "+f"(c), "+f"(e)::"memory");
}

// a bf16 pair at columns c, c + 1, each kept where it lies in [lo, hi)
__device__ __forceinline__ uint32_t keep_cols(uint32_t v, int c, int lo, int hi) {
  const uint32_t m0 = (c >= lo && c < hi) ? 0x0000ffffu : 0u;
  const uint32_t m1 = (c + 1 >= lo && c + 1 < hi) ? 0xffff0000u : 0u;
  return v & (m0 | m1);
}
// an A fragment of k step ks (columns 16 ks + 2 tq (+ 1, + 8, + 9)) masked to [lo, hi)
__device__ __forceinline__ void mask_frag(uint32_t (&o)[4], const uint32_t (&a)[4], int ks, int tq,
                                          int lo, int hi) {
  const int c = 16 * ks + 2 * tq;
  o[0] = keep_cols(a[0], c, lo, hi);
  o[1] = keep_cols(a[1], c, lo, hi);
  o[2] = keep_cols(a[2], c + 8, lo, hi);
  o[3] = keep_cols(a[3], c + 8, lo, hi);
}
// the A fragment of k step ks from a bf16 (rows, EP) row-major matrix: rows r0, r0 + 8
__device__ __forceinline__ void load_frag(uint32_t (&a)[4], const __nv_bfloat16* m, long long r0,
                                          int EP, int ks, int tq) {
  const __nv_bfloat16* p = m + r0 * EP + 16 * ks + 2 * tq;
  a[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  a[1] = __ldg(reinterpret_cast<const unsigned int*>(p + 8 * EP));
  a[2] = __ldg(reinterpret_cast<const unsigned int*>(p + 8));
  a[3] = __ldg(reinterpret_cast<const unsigned int*>(p + 8 * EP + 8));
}

// Token t of cell b's row of the input and its factor (dense: log1p(count))
template <bool kDense>
__device__ __forceinline__ const float* token_row(const Dims& d, const float* counts,
                                                  const float* src, int b, int t, float& lc) {
  lc = kDense ? log1pf(__ldg(counts + (size_t)b * d.N + t)) : 1.f;
  return src + ((kDense ? 0 : (size_t)b * d.N) + t) * (size_t)d.E;
}

// The raw rows of tokens t0.. t0 + 63 of cell b, as LayerNorm input: in place in
// device memory, or staged in shared memory by `stage_rows`. Row r at rows + r E;
// dense, its count at cnt[r] (the factor log1p(count) taken at use).
struct Rows {
  const float *rows, *cnt;
};
template <bool kDense>
__device__ __forceinline__ Rows rows_in_place(const Dims& d, const float* counts, const float* src,
                                              int b, int t0) {
  return Rows{src + ((kDense ? 0 : (size_t)b * d.N) + t0) * (size_t)d.E,
              kDense ? counts + (size_t)b * d.N + t0 : nullptr};
}
// cp.async of those rows into `stg` ([64][E] f32, then 64 counts), zeros past N;
// one commit group, by the warpgroup's 128 threads (t)
template <bool kDense>
__device__ __forceinline__ void stage_rows(const Dims& d, const float* counts, const float* src,
                                           int b, int t0, float* stg, int t) {
  const Rows g = rows_in_place<kDense>(d, counts, src, b, t0);
  const int E = d.E, n = 64 * E, live = min(64, d.N - t0) * E;
  if ((E & 3) == 0) {  // 16-byte rows (the wrappers check the base's alignment)
    for (int i = 4 * t; i < n; i += 4 * 128) tc::cp_async16(stg + i, g.rows + i, i < live);
  } else {
    for (int i = t; i < n; i += 128) tc::cp_async4(stg + i, g.rows + i, i < live);
  }
  if (kDense && t < 64) tc::cp_async4(stg + n + t, g.cnt + t, t0 + t < d.N);
  tc::cp_async_commit();
}

// A row of the LayerNorm input as a quad holds it: lane j (lane & 3) the float4
// chunks k of columns 16 k + 4 j.. + 3, 0 past E (dense: times lc). `vec`: 16-byte
// loads (the row 16-byte aligned and E a multiple of 4).
template <int EP>
__device__ __forceinline__ void quad_row(const float* row, int E, float lc, bool kDense, bool vec,
                                         int j, float (&x)[EP / 16][4]) {
#pragma unroll
  for (int k = 0; k < EP / 16; ++k) {
    const int c = 16 * k + 4 * j;
    if (vec && c < E) {
      const float4 v = *reinterpret_cast<const float4*>(row + c);
      x[k][0] = v.x, x[k][1] = v.y, x[k][2] = v.z, x[k][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[k][e] = c + e < E ? row[c + e] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) x[k][e] = kDense ? x[k][e] * lc : x[k][e];
  }
}
// A row's sum in PyTorch's order for a contiguous row of 64 or 128 floats
// (Reduce.cuh: a thread sums four contiguous values in order, then a shuffle-down
// tree over the threads at offsets 16 (or 8), 8, 4, 2, 1). Thread t = 4 k + j is
// this quad's lane j, chunk k: the chunks pairwise at offsets NC / 2, ..., 1, then
// the lanes xor 2, xor 1. The same order keeps the kernel's bf(x2) on the plain
// version's roundings where the two sums would otherwise round apart.
template <int NC>
__device__ __forceinline__ float row_sum(const float (&v)[NC][4]) {
  float t[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) t[k] = ((v[k][0] + v[k][1]) + v[k][2]) + v[k][3];
#pragma unroll
  for (int w = NC / 2; w >= 1; w /= 2)
#pragma unroll
    for (int k = 0; k < w; ++k) t[k] += t[k + w];
  float r = t[0];
  r += __shfl_xor_sync(0xffffffffu, r, 2);
  return r + __shfl_xor_sync(0xffffffffu, r, 1);
}
// its statistics: x -> x - mean (0 past E); returns rstd
template <int EP>
__device__ __forceinline__ float quad_norm(float (&x)[EP / 16][4], const Dims& d, int j) {
  const float mean = row_sum<EP / 16>(x) * d.inv_e;
  float sq[EP / 16][4];
#pragma unroll
  for (int k = 0; k < EP / 16; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[k][e] = 16 * k + 4 * j + e < d.E ? x[k][e] - mean : 0.f;
      sq[k][e] = __fmul_rn(x[k][e], x[k][e]);
    }
  return rsqrtf(row_sum<EP / 16>(sq) * d.inv_e + d.eps);
}
// x2 = ((x - mean) rstd) g + b, each rounded as the plain version rounds it; 0 past E
__device__ __forceinline__ float ln_out(float xc, float rstd, const float* g, const float* bb, int c,
                                       int E) {
  return c < E ? __fadd_rn(__fmul_rn(__fmul_rn(xc, rstd), g[c]), bb[c]) : 0.f;
}

// The LayerNorm of the 64 rows, a quad a row (this warp's 16 in two passes of 8),
// bf(x2) into the swizzled [64][EP] tile X; 0 past E and for tokens past N. g and
// bb: ln1g, ln1b in shared memory, zero-padded to EP.
template <int EP, bool kDense>
__device__ __forceinline__ void ln_rows(const Dims& d, const Rows in, bool staged, const float* g,
                                        const float* bb, int t0, uint8_t* X, int warp, int lane) {
  const int j = lane & 3;
  const bool vec = staged && (d.E & 3) == 0;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int r = 16 * warp + 8 * pass + (lane >> 2);
    const bool ok = t0 + r < d.N;
    const float lc = kDense && ok ? log1pf(in.cnt[r]) : 1.f;
    float x[EP / 16][4];
    quad_row<EP>(in.rows + (size_t)(ok ? r : 0) * d.E, d.E, lc, kDense, vec, j, x);
    const float rstd = quad_norm<EP>(x, d, j);
#pragma unroll
    for (int k = 0; k < EP / 16; ++k) {
      const int c = 16 * k + 4 * j;
      const float4 g4 = *reinterpret_cast<const float4*>(g + c);
      const float4 b4 = *reinterpret_cast<const float4*>(bb + c);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = ok ? __fadd_rn(__fmul_rn(__fmul_rn(x[k][e], rstd), gv[e]), bv[e]) : 0.f;
      *reinterpret_cast<uint2*>(X + sw(r, c)) = make_uint2(tc::pack_bf16(o[0], o[1]),
                                                           tc::pack_bf16(o[2], o[3]));
    }
  }
}

// the A fragment of k step ks, rows 16 warp.. of a swizzled [64][EP] bf16 tile
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const uint8_t* T, int ks, int warp,
                                       int lane) {
  const int row = 16 * warp + (lane & 15), col = 16 * ks + 8 * (lane >> 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(tc::smem_u32(T + sw(row, col))));
}

// copies valid rows of a swizzled [64][EP] bf16 tile to device rows (pitch EP), 16
// bytes a thread at a time
template <int EP>
__device__ __forceinline__ void tile_out(const uint8_t* T, __nv_bfloat16* dst, int rows, int t) {
  for (int i = t; i < 64 * (EP / 8); i += 128) {
    const int r = i / (EP / 8), c = i % (EP / 8);
    if (r >= rows) break;
    const uint4 v = *reinterpret_cast<const uint4*>(T + sw(r, 8 * c));
    *reinterpret_cast<uint4*>(dst + (long long)r * EP + 8 * c) = v;
  }
}

// an m64nN accumulator (rows 16 w + gq (+ 8), columns 8 i + 2 tq (+ 1)) to bf16
// rows row0.. of a swizzled tile of 64-column boxes (rows contiguous in a box
// column; boxes `rows` rows deep)
template <int N>
__device__ __forceinline__ void store_acc(uint8_t* T, int row0, int rows, const float (&acc)[N / 2],
                                          int warp, int gq, int tq) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + gq + 8 * r, col = 8 * i + 2 * tq;
      const uint32_t off = (col >> 6) * rows * 128 + sw(row, col & 63);
      *reinterpret_cast<uint32_t*>(T + off) = tc::pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
}

// acc (64 x EP) = A (64 x E, K-major [64][EP] tile) B^T, B (EP rows x E) K-major in
// panels of `brows` rows from row brow0
template <int EP>
__device__ __forceinline__ void proj(float (&acc)[EP / 2], uint32_t A, uint32_t B, int brows, int ke) {
  fence_acc(acc);
  wg_fence();
  for (int ks = 0; ks < ke; ++ks) wg_ss<EP, 0, 0>(acc, kdp(A, ks, 64), kdp(B, ks, brows), ks > 0);
  wg_commit();
  wg_wait0();
  fence_acc(acc);
}
// acc (64 x 64) = A (64 rows of W, K-major in panels of `arows` rows) X^T (X: [64][EP])
__device__ __forceinline__ void proj_t(float (&acc)[32], uint32_t A, int arows, uint32_t X, int ke) {
  fence_acc(acc);
  wg_fence();
  for (int ks = 0; ks < ke; ++ks) wg_ss64<0, 0>(acc, kdp(A, ks, arows), kdp(X, ks, 64), ks > 0);
  wg_commit();
  wg_wait0();
  fence_acc(acc);
}

// s (64 x 64) = A B^T over head [lo, hi)'s k16 steps: A from registers (a[ks], masked
// to the head), B K-major [64 rows][EP] at `b`; one k step in flight at a time
template <int KE>
__device__ __forceinline__ void head_product(float (&s)[32], const uint32_t (&a)[KE][4], uint32_t b,
                                             int lo, int hi, int tq, bool acc) {
  const int ks0 = lo >> 4, ks1 = (hi - 1) >> 4;
#pragma unroll
  for (int ks = 0; ks < KE; ++ks)
    if (ks >= ks0 && ks <= ks1) {
      uint32_t m[4];
      mask_frag(m, a[ks], ks, tq, lo, hi);
      fence_acc(s);
      wg_fence();
      hopper::wg_rs64<0>(s, m, kdp(b, ks, 64), acc || ks > ks0);
      wg_commit();
      wg_wait0();
      hold(m);
      fence_acc(s);
    }
}

// tile += A B over 64 k rows: A's four k16 steps a[kk] against one 8-row tile of B
// (K-major at b, panels of `brows` rows); from zero unless `acc`
__device__ __forceinline__ void tile_prod(float& d0, float& d1, float& d2, float& d3,
                                          const uint32_t (&a)[4][4], uint32_t b, int brows,
                                          bool acc) {
  fence4(d0, d1, d2, d3);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wg_rs8(d0, d1, d2, d3, a[kk], kdp(b, kk, brows), acc || kk > 0);
  wg_commit();
  wg_wait0();
  fence4(d0, d1, d2, d3);
}
// the same with A in three bf16 passes (a3[kk][p], the smallest first)
__device__ __forceinline__ void tile_prod3(float& d0, float& d1, float& d2, float& d3,
                                           const uint32_t (&a3)[4][3][4], uint32_t b, int brows,
                                           bool acc) {
  fence4(d0, d1, d2, d3);
  wg_fence();
#pragma unroll
  for (int p = 2; p >= 0; --p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_rs8(d0, d1, d2, d3, a3[kk][p], kdp(b, kk, brows), acc || p < 2 || kk > 0);
  wg_commit();
  wg_wait0();
  fence4(d0, d1, d2, d3);
}

// the same with A's fragments read at the head's k steps from a bf16 (rows, EP)
// matrix (rows r0, r0 + 8 of this thread), not held in registers
__device__ __forceinline__ void head_product_g(float (&s)[32], const __nv_bfloat16* m, long long r0,
                                               int EP, uint32_t b, int lo, int hi, int tq) {
  const int ks0 = lo >> 4, ks1 = (hi - 1) >> 4;
  for (int ks = ks0; ks <= ks1; ++ks) {
    uint32_t raw[4], a[4];
    load_frag(raw, m, r0, EP, ks, tq);
    mask_frag(a, raw, ks, tq, lo, hi);
    fence_acc(s);
    wg_fence();
    hopper::wg_rs64<0>(s, a, kdp(b, ks, 64), ks > ks0);
    wg_commit();
    wg_wait0();
    hold(a);
    fence_acc(s);
  }
}

// Head [lo, hi)'s 8-column tiles of an m64nEP accumulator `acc` += A B over 64 k
// rows (A: a[kk], or a3[kk][p] in three passes; B's tile c: 8 rows at b + 8 c rows,
// K-major in panels of `brows` rows). A tile inside the head accumulates in place;
// one it shares with another head is summed from zero and added where its columns
// are the head's.
template <int EP, bool k3>
__device__ __forceinline__ void head_tiles(float (&acc)[EP / 2], const uint32_t (&a)[4][4],
                                           const uint32_t (&a3)[4][3][4], uint32_t b, int brows,
                                           int lo, int hi, int tq) {
  const int c0 = lo >> 3, c1 = (hi - 1) >> 3;
#pragma unroll
  for (int c = 0; c < EP / 8; ++c)
    if (c >= c0 && c <= c1) {
      const uint32_t bc = b + 8 * c * 128;
      if (8 * c >= lo && 8 * c + 8 <= hi) {
        if (k3) tile_prod3(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3], a3, bc, brows, true);
        else tile_prod(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3], a, bc, brows, true);
      } else {
        float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
        if (k3) tile_prod3(t0, t1, t2, t3, a3, bc, brows, false);
        else tile_prod(t0, t1, t2, t3, a, bc, brows, false);
        const int col = 8 * c + 2 * tq;
        if (col >= lo && col < hi) acc[4 * c] += t0, acc[4 * c + 2] += t2;
        if (col + 1 >= lo && col + 1 < hi) acc[4 * c + 1] += t1, acc[4 * c + 3] += t3;
      }
    }
}

// A fragments (k16 step kk of the 64 columns) of an m64n64 accumulator in three
// bf16 passes
__device__ __forceinline__ void frags3(uint32_t (&a3)[4][3][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      tc::split3_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1], a3[kk][0][j], a3[kk][1][j],
                      a3[kk][2][j]);
}

// (score, token) replaced by (s, t) if s is larger, or as large at a smaller token
__device__ __forceinline__ void take_max(float& v, int& i, float s, int t) {
  if (s > v || (s == v && t < i)) {
    v = s;
    i = t;
  }
}

// m of each (cell, head, query): a block a (cell, query tile, head), a warp 8
// queries at a time; the chunks' maxima taken in chunk
// order, and the score of the first token that reaches it taken again in the
// plain version's arithmetic. The tensor cores' sums truncate and group their
// products, so k's bf16 roundings and the score's last bits differ from the
// plain version's f32 sums now and then, and such a difference at a row's max
// token would move m and with it every exponential of the row (and of the
// backward, which recomputes them against the saved m). So that token's x2 is
// taken again with `ln_rows`'s bits, k's head block and then the score summed in
// f32 in column order, each product of bf16 values exact: the order of a plain
// f32 GEMM, whose scores it reproduces bit for bit (benchmarks_torch/
// pool_max_order.py); m is the plain version's but where two tokens all but tie.
template <bool kDense, int NU>  // NU >= 8 hd / 32: (row, column) pairs a lane
__global__ void __launch_bounds__(256)
poolw_exact(const Dims d, const float* __restrict__ counts, const float* __restrict__ src,
            const float* __restrict__ qfull, const float* __restrict__ ln1g,
            const float* __restrict__ ln1b, const float* __restrict__ wk, const Work w,
            float* __restrict__ mout) {
  // a block a (cell, query tile, head): head h's columns of bf(wk) staged once;
  // a warp takes 8 queries together, a quad a query
  extern __shared__ float wsh[];        // [E][hd]
  __shared__ float xs[8][8][128];       // a warp's 8 rows of bf(x2), then of bf(k) bf(q)
  const int h = blockIdx.x % d.H, bq = blockIdx.x / d.H, qt = bq % d.NQT, b = bq / d.NQT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, HQ = d.H * 64;
  for (int i = threadIdx.x; i < d.E * d.hd; i += 256)
    wsh[i] = bfr(__ldg(wk + (long long)(i / d.hd) * d.E + h * d.hd + i % d.hd));
  __syncthreads();
  const int qd = lane >> 2, j = lane & 3, r = 8 * warp + qd, qi = 64 * qt + r;
  // the chunks' maxima in chunk order, and the first token reaching the max
  float v = -INFINITY;
  int tok = 0;
  if (qi < d.Q)
    for (int c = 0; c < d.nch; ++c) {
      const long long u = ((long long)(b * d.NQT + qt) * d.nch + c) * HQ + h * 64 + r;
      take_max(v, tok, w.pmax[u], w.parg[u]);
    }
  // x2 with `ln_rows`'s arithmetic (its bits: a quad's sums in its order, the plain
  // version's f32 roundings, rsqrtf included), bf16-rounded into the quad's row
  float* xw = xs[warp][qd];
  const bool live = v != -INFINITY;  // a token reached the max (not past Q or N = 0)
  {
    float lc = 1.f;
    const float* x = live ? token_row<kDense>(d, counts, src, b, tok, lc) : src;
    // (at EP = 64 the chunks past it hold zeros, which add nothing to the trees)
    float x8[8][4];
    quad_row<128>(x, live ? d.E : 0, lc, kDense, live && (d.E & 3) == 0, j, x8);
    const float rstd = quad_norm<128>(x8, d, j);
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * k + 4 * j + e;
        if (c < d.E) xw[c] = bfr(ln_out(x8[k][e], rstd, ln1g, ln1b, c, d.E));
      }
  }
  __syncwarp();
  // k's head block for the 8 rows: lane pairs (row, column) p = lane + 32 u, each
  // summed in f32 over c in order (a product of two bf16 values is exact in f32),
  // rounded to bf16, times bf(q)
  const int np = 8 * d.hd;
  float kq[NU];
  int rr[NU], dd[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int pr = lane + 32 * u;
    kq[u] = 0.f, rr[u] = pr < np ? pr / d.hd : 0, dd[u] = pr < np ? pr % d.hd : 0;
  }
  for (int c = 0; c < d.E; ++c)
#pragma unroll
    for (int u = 0; u < NU; ++u)
      kq[u] = __fadd_rn(kq[u], __fmul_rn(xs[warp][rr[u]][c], wsh[c * d.hd + dd[u]]));
  __syncwarp();  // every row's x2 read
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int pr = lane + 32 * u;
    if (pr < np && 64 * qt + 8 * warp + rr[u] < d.Q)
      xs[warp][rr[u]][dd[u]] = __fmul_rn(
          bfr(kq[u]),
          bfr(__ldg(qfull + ((long long)h * d.Q + 64 * qt + 8 * warp + rr[u]) * d.E + h * d.hd + dd[u])));
  }
  __syncwarp();
  // the score: those products over the head's columns in order, in f32
  if (j == 0 && qi < d.Q) {
    float sc = 0.f;
    for (int dd = 0; dd < d.hd; ++dd) sc = __fadd_rn(sc, xw[dd]);
    mout[((long long)b * d.H + h) * d.Q + qi] = live ? __fmul_rn(sc, d.scale) : v;
  }
}

// -- the attention kernels with the queries on the rows --------------------------------

// staged input rows of a warpgroup: [64][E] f32 and 64 counts, 16-byte aligned
__host__ __device__ inline int stage_bytes(int E) { return 64 * E * 4 + 256; }

struct QSmem {
  int w, tiles, tile, stage, stats, gb, total;  // byte offsets; a warpgroup's tiles `tile` bytes apart
  bool staged;                              // the next tile's rows prefetched into shared memory
};
__host__ __device__ inline QSmem q_smem(int NB, int E, int H, int mode, bool staged) {
  QSmem s;
  const int ntile = mode == kMax ? 1 : mode == kFwd ? 2 : 3;
  s.w = 0;
  s.tiles = s.w + 2 * NB * NB * kBox;
  s.tile = ntile * NB * kBox;
  s.stage = s.tiles + kWG * s.tile;
  s.stats = s.stage + (staged ? kWG * stage_bytes(E) : 0);
  // m then each warpgroup's den (kFwd), or each warpgroup's max and its first token (kMax)
  s.gb = s.stats + H * 64 * 4 * (mode == kMax ? 2 * kWG : mode == kFwd ? 1 + kWG : 0);
  s.total = s.gb + 2 * 128 * 4 + 64 + 1024;  // ln1g, ln1b padded
  s.staged = staged;
  return s;
}
// staged where shared memory allows
__host__ __device__ inline QSmem q_smem(int NB, int E, int H, int mode) {
  const QSmem s = q_smem(NB, E, H, mode, true);
  return s.total <= kSmemMax ? s : q_smem(NB, E, H, mode, false);
}

struct QArgs {
  const float *counts, *src, *ln1g, *ln1b, *mstat, *dden;
  float* mout;
  Work w;
};

// The (cell, query tile, chunk) units: kMax the chunk's max of each (head,
// query); kFwd e, den and num against the cell's max; kDq dq (and, in the first
// query tile, bf(k) and bf(v) of every token for poolw_t). Two warpgroups, each on
// every other 64-token tile of the chunk, added in warpgroup order.
template <int EP, bool kDense, int kMode>
__global__ void __launch_bounds__(128 * kWG, 1)
poolw_q(const __grid_constant__ CUtensorMap wm, const Dims d, const QArgs p) {
  constexpr int NB = EP / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sb = tc::smem_u32(smem);
  const QSmem L = q_smem(NB, d.E, d.H, kMode);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const int ch = blockIdx.x % d.nch, bq = blockIdx.x / d.nch, qt = bq % d.NQT, b = bq / d.NQT;
  const long long unit = (long long)blockIdx.x;  // ((b NQT + qt) nch + ch)
  const int HQ = d.H * 64;
  float* msh = reinterpret_cast<float*>(smem + L.stats);  // kFwd: m [H][64]
  float* st = msh + (kMode == kMax ? 0 : HQ);             // per warpgroup [H][64]: max or den
  int* sarg = reinterpret_cast<int*>(st + kWG * HQ);      // kMax: per warpgroup [H][64]
  float* stg = reinterpret_cast<float*>(smem + L.stage + wg * stage_bytes(d.E));
  float* gs = reinterpret_cast<float*>(smem + L.gb);  // ln1g, then ln1b at + 128
  const uint32_t bar = sb + L.total - 1024 - 64;
  uint8_t* X = smem + L.tiles + wg * L.tile;
  const uint32_t xs = sb + L.tiles + wg * L.tile, vs = xs + NB * kBox, kts = vs + NB * kBox;
  const int j0 = ch * d.per, j1 = min(d.ntiles, j0 + d.per);

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  for (int i = tid; i < 128; i += 128 * kWG) {
    gs[i] = i < d.E ? p.ln1g[i] : 0.f;
    gs[128 + i] = i < d.E ? p.ln1b[i] : 0.f;
  }
  if (L.staged && j0 + wg < j1) stage_rows<kDense>(d, p.counts, p.src, b, 64 * (j0 + wg), stg, t);
  // the statistics: m of the cell (poolw_exact's) and the sums
  for (int i = tid; i < HQ; i += 128 * kWG) {
    const int h = i / 64, qi = 64 * qt + i % 64;
    if (kMode == kFwd) {
      msh[i] = qi < d.Q ? p.mout[((long long)b * d.H + h) * d.Q + qi] : INFINITY;
      st[i] = st[HQ + i] = 0.f;
    } else if (kMode == kMax) {
      st[i] = st[HQ + i] = -INFINITY;
      sarg[i] = sarg[HQ + i] = 0;
    }
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * NB * NB * kBox);
    for (int cb = 0; cb < NB; ++cb)
      for (int rb = 0; rb < 2 * NB; ++rb)
        tma_load(sb + L.w + (cb * 2 * NB + rb) * kBox, &wm, 64 * cb, 64 * rb, bar);
  }
  const long long qrow = 64LL * qt + 16 * warp + gq;  // this thread's query rows (+ 8)
  float acc[EP / 2];
#pragma unroll
  for (int i = 0; i < EP / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar, 0);
  const uint32_t wk = sb + L.w, wv = wk + NB * kBox;  // wk^T rows 0.., wv^T rows EP..
  const int wrows = 2 * EP;

  for (int j = j0 + wg; j < j1; j += kWG) {
    const int t0 = 64 * j;
    if (L.staged) tc::cp_async_wait<0>();
    named_sync(1 + wg, 128);  // the rows are in; the last tile's products are done with X, V, KT
    ln_rows<EP, kDense>(d, L.staged ? Rows{stg, stg + 64 * d.E}
                                    : rows_in_place<kDense>(d, p.counts, p.src, b, t0),
                        L.staged, gs, gs + 128, t0, X, warp, lane);
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (L.staged && j + kWG < j1) stage_rows<kDense>(d, p.counts, p.src, b, t0 + 64 * kWG, stg, t);
    {
      float pr[EP / 2];
      if (kMode == kFwd) {  // v^T = wv^T bf(x2)^T: [EP rows][64 tokens]
#pragma unroll
        for (int mt = 0; mt < NB; ++mt) {
          float vt[32];
          proj_t(vt, wv + 64 * mt * 128, wrows, xs, d.ke);
          store_acc<64>(smem + (vs - sb), 64 * mt, EP, vt, warp, gq, tq);
        }
      }
      if (kMode == kDq) {  // v = bf(x2) wv: [64][EP]; k^T: [EP][64]
        proj<EP>(pr, xs, wv, wrows, d.ke);
        store_acc<EP>(smem + (vs - sb), 0, 64, pr, warp, gq, tq);
#pragma unroll
        for (int mt = 0; mt < NB; ++mt) {
          float kt[32];
          proj_t(kt, wk + 64 * mt * 128, wrows, xs, d.ke);
          store_acc<64>(smem + (kts - sb), 64 * mt, EP, kt, warp, gq, tq);
        }
      }
      proj<EP>(pr, xs, wk, wrows, d.ke);  // k = bf(x2) wk, into X
      named_sync(1 + wg, 128);
      store_acc<EP>(X, 0, 64, pr, warp, gq, tq);
    }
    fence_async_shared();
    named_sync(1 + wg, 128);
    if (kMode == kDq && qt == 0) {  // bf(k), bf(v) of the tile's tokens, for poolw_t
      const long long row0 = (long long)b * d.N + t0;
      tile_out<EP>(X, p.w.kg + row0 * EP, min(64, d.N - t0), t);
      tile_out<EP>(smem + (vs - sb), p.w.vg + row0 * EP, min(64, d.N - t0), t);
    }

    bool live[8][2];  // this thread's token columns 8 i + 2 tq + c
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) live[i][c] = t0 + 8 * i + 2 * tq + c < d.N;
    for (int h = 0; h < d.H; ++h) {
      const int lo = h * d.hd, hi = lo + d.hd;
      float s[32];
      // kDq: dnum's fragments at the head's first k step, loaded ahead of their use
      uint32_t pre[3][4];
      if (kMode == kDq) {
        const __nv_bfloat16* dnp = p.w.dN + (long long)b * 3 * d.QP * EP;
#pragma unroll
        for (int q = 0; q < 3; ++q) load_frag(pre[q], dnp + (long long)q * d.QP * EP, qrow, EP, lo >> 4, tq);
      }
      head_product_g(s, p.w.qM, qrow, EP, xs, lo, hi, tq);  // s^T = bf(q_h) bf(k_h)^T
      const int q0 = 16 * warp + gq;
      if (kMode == kMax) {  // the largest score and the first token reaching it
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v[16];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              v[2 * i + c] = live[i][c] ? __fmul_rn(s[4 * i + 2 * r + c], d.scale) : -INFINITY;
          float mx = v[0];
#pragma unroll
          for (int k = 1; k < 16; ++k) mx = fmaxf(mx, v[k]);
          int arg = 0x7fffffff;
#pragma unroll
          for (int k = 15; k >= 0; --k) arg = v[k] == mx ? t0 + 8 * (k >> 1) + 2 * tq + (k & 1) : arg;
#pragma unroll
          for (int o = 1; o < 4; o <<= 1)
            take_max(mx, arg, __shfl_xor_sync(0xffffffffu, mx, o),
                     __shfl_xor_sync(0xffffffffu, arg, o));
          const int at = wg * HQ + h * 64 + q0 + 8 * r;
          if (tq == 0) take_max(st[at], sarg[at], mx, arg);
        }
        continue;
      }
      // e = exp(s scale - m), 0 for tokens past N and queries past Q
      float dd[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = 64 * qt + q0 + 8 * r;
        const long long at = ((long long)b * d.H + h) * d.Q + qi;
        float m;
        if (kMode == kFwd) {
          m = msh[h * 64 + q0 + 8 * r];
        } else {
          m = qi < d.Q ? __ldg(p.mstat + at) : INFINITY;
          dd[r] = qi < d.Q ? __ldg(p.dden + at) : 0.f;
        }
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& v = s[4 * i + 2 * r + c];
            v = expf(live[i][c] ? __fsub_rn(__fmul_rn(v, d.scale), m) : -INFINITY);
            sum += v;
          }
        if (kMode == kFwd) {
          sum = quad_sum(sum);
          if (tq == 0) st[wg * HQ + h * 64 + q0 + 8 * r] += sum;
        }
      }
      if (kMode == kFwd) {  // num += bf(e)^T bf(v_h): v^T's 8-row tiles of the head
        uint32_t ea[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) a_frag<32>(ea[kk], s, kk);
        uint32_t none[4][3][4];
        head_tiles<EP, false>(acc, ea, none, vs, EP, lo, hi, tq);
        continue;
      }
      // kDq: dn^T = dnum_h bf(v)^T in three passes; ds^T = e (bf(dn) + dden) scale
      float dn[32];
      {
        const int ks0 = lo >> 4, ks1 = (hi - 1) >> 4;
        const __nv_bfloat16* dnp = p.w.dN + (long long)b * 3 * d.QP * EP;
        for (int ks = ks0; ks <= ks1; ++ks) {
          uint32_t a3[3][4];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            uint32_t raw[4];
            if (ks == ks0) raw[0] = pre[q][0], raw[1] = pre[q][1], raw[2] = pre[q][2], raw[3] = pre[q][3];
            else load_frag(raw, dnp + (long long)q * d.QP * EP, qrow, EP, ks, tq);
            mask_frag(a3[q], raw, ks, tq, lo, hi);
          }
          fence_acc(dn);
          wg_fence();
#pragma unroll
          for (int q = 2; q >= 0; --q) wg_rs64<0>(dn, a3[q], kdp(vs, ks, 64), ks > ks0 || q < 2);
          wg_commit();
          wg_wait0();
#pragma unroll
          for (int q = 0; q < 3; ++q) hold(a3[q]);
          fence_acc(dn);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int k = 4 * i + 2 * r + c;
            dn[k] = __fmul_rn(__fmul_rn(__fadd_rn(bfr(dn[k]), dd[r]), s[k]), d.scale);
          }
      uint32_t a3[4][3][4];
      frags3(a3, dn);
      uint32_t none[4][4];
      head_tiles<EP, true>(acc, none, a3, kts, EP, lo, hi, tq);  // dq += ds^T bf(k_h)
    }
  }

  // -- the chunk's partials, the warpgroups added in order
  __syncthreads();
  if (kMode != kMax) {
    float* scratch = reinterpret_cast<float*>(smem + L.tiles + L.tile);  // warpgroup 1's tiles
    if (wg == 1)
#pragma unroll
      for (int i = 0; i < EP / 2; ++i) scratch[i * 128 + t] = acc[i];
    __syncthreads();
    if (wg == 0) {
      float* out = (kMode == kFwd ? p.w.pnum + unit * 64 * d.E
                                  : p.w.pdq + (((long long)qt * d.B + b) * d.nch + ch) * 64 * d.E);
#pragma unroll
      for (int i = 0; i < EP / 8; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int row = 16 * warp + gq + 8 * (k >> 1), col = 8 * i + 2 * tq + (k & 1);
          const float v = acc[4 * i + k] + scratch[(4 * i + k) * 128 + t];
          if (col < d.E) out[(long long)row * d.E + col] = v;
        }
    }
  }
  if (kMode == kMax)
    for (int i = tid; i < HQ; i += 128 * kWG) {
      float v = st[i];
      int a = sarg[i];
      take_max(v, a, st[HQ + i], sarg[HQ + i]);
      p.w.pmax[unit * HQ + i] = v;
      p.w.parg[unit * HQ + i] = a;
    }
  if (kMode == kFwd)
    for (int i = tid; i < HQ; i += 128 * kWG) p.w.pden[unit * HQ + i] = st[i] + st[HQ + i];
}

// -- the attention backward with the tokens on the rows ---------------------------------

struct TSmem {
  int qm, qt, dn, dnt, kv, stats, total;  // a warpgroup's k | v stage at kv + wg 2 NB kBox
  bool staged;  // m and dden of the query tile in shared memory (where they fit)
};
__host__ __device__ inline TSmem t_smem(int NB, int H) {
  TSmem s;
  s.qm = 0;
  s.qt = s.qm + NB * kBox;
  s.dn = s.qt + NB * kBox;
  s.dnt = s.dn + 3 * NB * kBox;
  s.kv = s.dnt + 3 * NB * kBox;
  s.stats = s.kv + kWG * 2 * NB * kBox;
  s.staged = s.stats + H * 64 * 8 + 64 + 1024 <= kSmemMax;
  s.total = s.stats + (s.staged ? H * 64 * 8 : 0) + 64 + 1024;
  return s;
}

struct TArgs {
  const float *mstat, *dden;
  Work w;
};

// per (cell, query tile, chunk): dk_h and dv_h of every token of the chunk against
// the tile's queries: with one query tile bf16 into dk / dv [token][EP] (zero past
// E), else f32 into pdk / pdv [query tile][token][E]. bf(k) and bf(v) come from
// poolw_q<kDq> by TMA, a tile ahead.
template <int EP>
__global__ void __launch_bounds__(128 * kWG, 1)
poolw_t(const __grid_constant__ CUtensorMap qmm, const __grid_constant__ CUtensorMap qtm,
        const __grid_constant__ CUtensorMap dnm, const __grid_constant__ CUtensorMap dntm,
        const __grid_constant__ CUtensorMap km, const __grid_constant__ CUtensorMap vm,
        const Dims d, const TArgs p) {
  constexpr int NB = EP / 64, KE = EP / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sb = tc::smem_u32(smem);
  const TSmem L = t_smem(NB, d.H);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const int ch = blockIdx.x % d.nch, bq = blockIdx.x / d.nch, qt = bq % d.NQT, b = bq / d.NQT;
  const uint32_t bar = sb + L.total - 1024 - 64, bar_kv = bar + 8 + 8 * wg;
  float* sm = reinterpret_cast<float*>(smem + L.stats);  // staged: m [H][64], then dden
  const uint32_t kvs = sb + L.kv + wg * 2 * NB * kBox;
  const uint8_t* KV = smem + L.kv + wg * 2 * NB * kBox;
  const int j0 = ch * d.per, j1 = min(d.ntiles, j0 + d.per);
  auto issue_kv = [&](int j) {
    mbar_expect_tx(bar_kv, 2 * NB * kBox);
    for (int cb = 0; cb < NB; ++cb) {
      tma_load3(kvs + cb * kBox, &km, 64 * cb, 64 * j, b, bar_kv);
      tma_load3(kvs + (NB + cb) * kBox, &vm, 64 * cb, 64 * j, b, bar_kv);
    }
  };

  if (tid == 0) {
    mbar_init(bar, 1);
    for (int g = 0; g < kWG; ++g) mbar_init(bar + 8 + 8 * g, 1);
    fence_mbar_init();
  }
  const long long HQ = (long long)d.H * d.Q;
  if (L.staged)
    for (int i = tid; i < d.H * 64; i += 128 * kWG) {
      const int qi = 64 * qt + i % 64;
      const long long at = (long long)b * HQ + (long long)(i / 64) * d.Q + qi;
      sm[i] = qi < d.Q ? __ldg(p.mstat + at) : INFINITY;
      sm[d.H * 64 + i] = qi < d.Q ? __ldg(p.dden + at) : 0.f;
    }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (2 * NB + 6 * NB) * kBox);
    for (int j = 0; j < NB; ++j) {
      tma_load(sb + L.qm + j * kBox, &qmm, 64 * j, 64 * qt, bar);  // [64 q][EP]
      tma_load(sb + L.qt + j * kBox, &qtm, 64 * qt, 64 * j, bar);  // [EP][64 q]
      for (int q = 0; q < 3; ++q) {
        tma_load3(sb + L.dn + (q * NB + j) * kBox, &dnm, 64 * j, 64 * qt, 3 * b + q, bar);
        tma_load3(sb + L.dnt + (q * NB + j) * kBox, &dntm, 64 * qt, 64 * j, 3 * b + q, bar);
      }
    }
  }
  if (t == 0 && j0 + wg < j1) issue_kv(j0 + wg);
  mbar_wait(bar, 0);
  const bool one = d.NQT == 1;

  int it = 0;
  for (int j = j0 + wg; j < j1; j += kWG, ++it) {
    const int t0 = 64 * j;
    mbar_wait(bar_kv, it & 1);
    uint32_t kf[KE][4], vf[KE][4];  // bf(k), bf(v): A fragments, tokens on the rows
#pragma unroll
    for (int ks = 0; ks < KE; ++ks) {
      ldsm_a(kf[ks], KV, ks, warp, lane);
      ldsm_a(vf[ks], KV + NB * kBox, ks, warp, lane);
    }
    named_sync(1 + wg, 128);  // the stage is read: the next tile's k | v may come in
    if (t == 0 && j + kWG < j1) issue_kv(j + kWG);
    int tok[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tok[r] = t0 + 16 * warp + gq + 8 * r;
      live[r] = tok[r] < d.N;
    }
    for (int h = 0; h < d.H; ++h) {
      const int lo = h * d.hd, hi = lo + d.hd;
      float s[32], dn[32];
      head_product<KE>(s, kf, sb + L.qm, lo, hi, tq, false);  // s = bf(k_h) bf(q)^T
      {  // dn = bf(v_h) dnum^T, three passes of dnum
        const int ks0 = lo >> 4, ks1 = (hi - 1) >> 4;
#pragma unroll
        for (int ks = 0; ks < KE; ++ks)
          if (ks >= ks0 && ks <= ks1) {
            uint32_t m[4];
            mask_frag(m, vf[ks], ks, tq, lo, hi);
            fence_acc(dn);
            wg_fence();
#pragma unroll
            for (int q = 2; q >= 0; --q)
              wg_rs64<0>(dn, m, kdp(sb + L.dn + q * NB * kBox, ks, 64), ks > ks0 || q < 2);
            wg_commit();
            wg_wait0();
            hold(m);
            fence_acc(dn);
          }
      }
      // e and ds at this thread's query columns 8 i + 2 tq + c (m and dden of the head)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int ql = 8 * i + 2 * tq + c, qi = 64 * qt + ql;
          const long long at = (long long)b * HQ + (long long)h * d.Q + qi;
          const float mq = L.staged ? sm[h * 64 + ql] : qi < d.Q ? __ldg(p.mstat + at) : INFINITY;
          const float dd = L.staged ? sm[(d.H + h) * 64 + ql] : qi < d.Q ? __ldg(p.dden + at) : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int k = 4 * i + 2 * r + c;
            const float e = expf(live[r] ? __fsub_rn(__fmul_rn(s[k], d.scale), mq) : -INFINITY);
            s[k] = e;
            dn[k] = __fmul_rn(__fmul_rn(__fadd_rn(bfr(dn[k]), dd), e), d.scale);
          }
        }
      uint32_t ea[4][4], a3[4][3][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag<32>(ea[kk], s, kk);
      frags3(a3, dn);
      // dv_h = bf(e) dnum_h (dnum^T's parts), dk_h = ds bf(q_h) (q^T), 8 columns a tile:
      // each of the three bf16 passes summed from zero on the tensor cores (a chain of
      // four k16 steps) and the passes added in f32, the smallest first, so that the
      // tensor cores' truncating sums do not carry the full value through twelve steps
      const int c0 = lo >> 3, c1 = (hi - 1) >> 3;
      for (int c = c0; c <= c1; ++c) {
        float v4[3][4] = {}, k4[3][4] = {};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          fence4(v4[q][0], v4[q][1], v4[q][2], v4[q][3]);
          fence4(k4[q][0], k4[q][1], k4[q][2], k4[q][3]);
        }
        wg_fence();
#pragma unroll
        for (int q = 2; q >= 0; --q)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wg_rs8(v4[q][0], v4[q][1], v4[q][2], v4[q][3], ea[kk],
                   kdp(sb + L.dnt + q * NB * kBox + 8 * c * 128, kk, EP), kk > 0);
            wg_rs8(k4[q][0], k4[q][1], k4[q][2], k4[q][3], a3[kk][q],
                   kdp(sb + L.qt + 8 * c * 128, kk, EP), kk > 0);
          }
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          fence4(v4[q][0], v4[q][1], v4[q][2], v4[q][3]);
          fence4(k4[q][0], k4[q][1], k4[q][2], k4[q][3]);
        }
        const int col = 8 * c + 2 * tq;
        const bool in0 = col >= lo && col < hi, in1 = col + 1 >= lo && col + 1 < hi;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!live[r]) continue;
          const long long row = (long long)b * d.N + tok[r];
          float v[2], kv[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int i = 2 * r + k;
            v[k] = (v4[2][i] + v4[1][i]) + v4[0][i];
            kv[k] = (k4[2][i] + k4[1][i]) + k4[0][i];
          }
          if (one && in0 && in1) {  // both columns the head's: one 4-byte store each
            *reinterpret_cast<uint32_t*>(p.w.dv + row * EP + col) = tc::pack_bf16(v[0], v[1]);
            *reinterpret_cast<uint32_t*>(p.w.dk + row * EP + col) = tc::pack_bf16(kv[0], kv[1]);
            continue;
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (!(k ? in1 : in0)) continue;
            if (one) {
              p.w.dv[row * EP + col + k] = __float2bfloat16_rn(v[k]);
              p.w.dk[row * EP + col + k] = __float2bfloat16_rn(kv[k]);
            } else {
              const long long at = ((long long)qt * d.T + row) * d.E + col + k;
              p.w.pdv[at] = v[k];
              p.w.pdk[at] = kv[k];
            }
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hold(ea[kk]);
#pragma unroll
        for (int q = 0; q < 3; ++q) hold(a3[kk][q]);
      }
    }
    // zeros in E's last k16 step past E, which poolw_tok's products read
    if (one)
      for (int i = t; i < 64 * (16 * d.ke - d.E); i += 128) {
        const int r = i / (16 * d.ke - d.E), col = d.E + i % (16 * d.ke - d.E);
        if (t0 + r < d.N) {
          const long long at = ((long long)b * d.N + t0 + r) * EP + col;
          p.w.dk[at] = p.w.dv[at] = __float2bfloat16_rn(0.f);
        }
      }
  }
}

// past one query tile: dk, dv = the tiles' f32 parts added in order, to bf16 (T, EP),
// zero past E
__global__ void __launch_bounds__(256) poolw_dkv(const Dims d, const Work w) {
  const long long n = d.T * (d.EP / 2);
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n; i += (long long)gridDim.x * 256) {
    const long long row = i / (d.EP / 2);
    const int c = 2 * (int)(i % (d.EP / 2));
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int q = 0; q < d.NQT; ++q) {
      const long long at = ((long long)q * d.T + row) * d.E + c;
      if (c < d.E) k0 += w.pdk[at], v0 += w.pdv[at];
      if (c + 1 < d.E) k1 += w.pdk[at + 1], v1 += w.pdv[at + 1];
    }
    *reinterpret_cast<uint32_t*>(w.dk + row * d.EP + c) = tc::pack_bf16(k0, k1);
    *reinterpret_cast<uint32_t*>(w.dv + row * d.EP + c) = tc::pack_bf16(v0, v1);
  }
}

// -- the backward per token --------------------------------------------------------------

struct KSmem {
  int w, stage, slots, total;  // a warpgroup's dk | dv stage and its LayerNorm sums
};
__host__ __device__ inline KSmem k_smem(int NB) {
  KSmem s;
  s.w = 0;
  s.stage = s.w + 2 * NB * NB * kBox;
  s.slots = s.stage + kWG * 2 * NB * kBox;
  s.total = s.slots + kWG * 128 * (32 * NB) * 4 + 64 + 1024;
  return s;
}

struct KArgs {
  const float *counts, *src, *ln1g, *ln1b;
  float* demb;
  Work w;
};

// Per token tile: dx2 = bf(bf(dk) bf(wk)^T) + bf(bf(dv) bf(wv)^T) on wgmma (bf(dk),
// bf(dv) by TMA, a tile ahead), the LayerNorm again at the accumulator's columns
// and its backward: demb, or (dense) dtable's rows times log1p(count) summed over
// the unit's cells; dln1g, dln1b in per-thread sums; bf(x2) for poolw_w. A unit a
// warpgroup: window (cell, chunk of tiles), dense (gene tile, cell group).
template <int EP, bool kDense>
__global__ void __launch_bounds__(128 * kWG, 1)
poolw_tok(const __grid_constant__ CUtensorMap wnm, const __grid_constant__ CUtensorMap dkm,
          const __grid_constant__ CUtensorMap dvm, const Dims d, const KArgs p) {
  constexpr int NB = EP / 64, NE = EP / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sb = tc::smem_u32(smem);
  const KSmem L = k_smem(NB);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const uint32_t bar = sb + L.total - 1024 - 64, bar_kv = bar + 8 + 8 * wg;
  const uint32_t dks = sb + L.stage + wg * 2 * NB * kBox, dvs = dks + NB * kBox;
  float* slot = reinterpret_cast<float*>(smem + L.slots) + wg * 128 * (32 * NB);  // [EP / 2][128]

  const int unit = blockIdx.x * kWG + wg;
  const bool in = unit < tok_units(d, kDense);
  int b0 = 0, b1 = 0, j0 = 0, j1 = 0;
  if (in) {
    if (kDense) {
      const int gt = unit % d.ntiles, grp = unit / d.ntiles;
      b0 = grp * d.Bg, b1 = min(d.B, b0 + d.Bg), j0 = gt, j1 = gt + 1;
    } else {
      const int ch = unit % d.n_chB;
      b0 = unit / d.n_chB, b1 = b0 + 1, j0 = ch * d.perB, j1 = min(d.ntiles, j0 + d.perB);
    }
  }
  // the unit's tiles in order: (b, j), j fastest
  const int nj = j1 - j0, n = (b1 - b0) * nj;
  auto issue = [&](int i) {
    const int b = b0 + i / nj, j = j0 + i % nj;
    mbar_expect_tx(bar_kv, 2 * NB * kBox);
    for (int cb = 0; cb < NB; ++cb) {
      tma_load3(dks + cb * kBox, &dkm, 64 * cb, 64 * j, b, bar_kv);
      tma_load3(dvs + cb * kBox, &dvm, 64 * cb, 64 * j, b, bar_kv);
    }
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    for (int g = 0; g < kWG; ++g) mbar_init(bar + 8 + 8 * g, 1);
    fence_mbar_init();
  }
  for (int i = t; i < 128 * 32 * NB; i += 128) slot[i] = 0.f;
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * NB * NB * kBox);
    for (int cb = 0; cb < NB; ++cb)
      for (int rb = 0; rb < 2 * NB; ++rb)
        tma_load(sb + L.w + (cb * 2 * NB + rb) * kBox, &wnm, 64 * cb, 64 * rb, bar);
  }
  if (t == 0 && n > 0) issue(0);
  mbar_wait(bar, 0);
  const uint32_t wk = sb + L.w, wv = wk + NB * kBox;  // wk rows 0.. (e_in, e_out), wv rows EP..
  float dt[EP / 2];  // dense: the gene tile's dtable rows (the accumulator's layout)
#pragma unroll
  for (int i = 0; i < EP / 2; ++i) dt[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int b = b0 + i / nj, t0 = 64 * (j0 + i % nj);
    // this thread's two rows of the input, at the accumulator's columns
    float xh[2][NE][2], lc[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tk = t0 + 16 * warp + gq + 8 * r;
      live[r] = tk < d.N;
      const float* row = token_row<kDense>(d, p.counts, p.src, b, live[r] ? tk : 0, lc[r]);
#pragma unroll
      for (int k = 0; k < NE; ++k)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * k + 2 * tq + c;
          xh[r][k][c] = live[r] && col < d.E ? __ldg(row + col) : 0.f;
        }
    }
    mbar_wait(bar_kv, i & 1);
    // dx2 = bf(bf(dk) bf(wk)^T) + bf(bf(dv) bf(wv)^T)
    float dx[EP / 2];
    {
      float pr[EP / 2];
      proj<EP>(pr, dks, wk, 2 * EP, d.ke);
#pragma unroll
      for (int k = 0; k < EP / 2; ++k) dx[k] = bfr(pr[k]);
      proj<EP>(pr, dvs, wv, 2 * EP, d.ke);
#pragma unroll
      for (int k = 0; k < EP / 2; ++k) dx[k] += bfr(pr[k]);
    }
    named_sync(1 + wg, 128);  // the stage is read: the next tile's dk | dv may come in
    if (t == 0 && i + 1 < n) issue(i + 1);
    // the LayerNorm again, and its backward
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tk = t0 + 16 * warp + gq + 8 * r;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NE; ++k)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (kDense) xh[r][k][c] *= lc[r];
          s += xh[r][k][c];
        }
      const float mean = quad_sum(s) * d.inv_e;
      float var = 0.f;
#pragma unroll
      for (int k = 0; k < NE; ++k)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * k + 2 * tq + c;
          xh[r][k][c] = col < d.E ? xh[r][k][c] - mean : 0.f;
          var = fmaf(xh[r][k][c], xh[r][k][c], var);
        }
      const float rstd = rsqrtf(quad_sum(var) * d.inv_e + d.eps);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int k = 0; k < NE; ++k) {
        float x2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * k + 2 * tq + c;
          xh[r][k][c] *= rstd;
          const bool ok = live[r] && col < d.E;
          x2[c] = ok ? __fadd_rn(__fmul_rn(xh[r][k][c], __ldg(p.ln1g + col)), __ldg(p.ln1b + col))
                     : 0.f;
          const float g2 = ok ? dx[4 * k + 2 * r + c] : 0.f;
          slot[(2 * k + c) * 128 + t] = fmaf(g2, xh[r][k][c], slot[(2 * k + c) * 128 + t]);
          slot[(EP / 4 + 2 * k + c) * 128 + t] += g2;
          const float dxh = ok ? g2 * __ldg(p.ln1g + col) : 0.f;
          dx[4 * k + 2 * r + c] = dxh;
          m1 += dxh;
          m2 = fmaf(dxh, xh[r][k][c], m2);
        }
        if (live[r])
          *reinterpret_cast<uint32_t*>(p.w.x2 + ((long long)b * d.N + tk) * EP + 8 * k + 2 * tq) =
              tc::pack_bf16(x2[0], x2[1]);
      }
      m1 = quad_sum(m1) * d.inv_e;
      m2 = quad_sum(m2) * d.inv_e;
#pragma unroll
      for (int k = 0; k < NE; ++k)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * k + 2 * tq + c;
          const float g = rstd * (dx[4 * k + 2 * r + c] - m1 - xh[r][k][c] * m2);
          if (kDense) dt[4 * k + 2 * r + c] = fmaf(g, lc[r], dt[4 * k + 2 * r + c]);
          else if (live[r] && col < d.E) p.demb[((long long)b * d.N + tk) * d.E + col] = g;
        }
    }
  }

  // -- the unit's partials: dln1g, dln1b (its threads' sums in order); dense, dtable rows
  named_sync(1 + wg, 128);
  if (in) {
    float* pl = p.w.part_ln + (long long)unit * 2 * d.E;
    for (int col = t; col < d.E; col += 128) {
      const int k = col / 8, tq2 = (col % 8) / 2, c = col % 2;
      float g = 0.f, bsum = 0.f;
      for (int w = 0; w < 4; ++w)
        for (int q = 0; q < 8; ++q) {
          const int th = 32 * w + 4 * q + tq2;
          g += slot[(2 * k + c) * 128 + th];
          bsum += slot[(EP / 4 + 2 * k + c) * 128 + th];
        }
      pl[col] = g;
      pl[d.E + col] = bsum;
    }
    if (kDense) {
      const int grp = unit / d.ntiles;
      float* pt = p.w.part_dt + (long long)grp * d.N * d.E;
#pragma unroll
      for (int k = 0; k < NE; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tk = 64 * j0 + 16 * warp + gq + 8 * (e >> 1), col = 8 * k + 2 * tq + (e & 1);
          if (tk < d.N && col < d.E) pt[(long long)tk * d.E + col] = dt[4 * k + e];
        }
    }
  }
}

// -- the weight gradients ----------------------------------------------------------------

// dwk | dwv over a chunk of 64-token tiles: warpgroup mt the rows e_in 64 mt..; A =
// bf(x2)^T and B = bf(dk), bf(dv), both MN-major from a TMA ring
template <int EP>
__global__ void __launch_bounds__(EP * 2, 1)
poolw_w(const __grid_constant__ CUtensorMap x2m, const __grid_constant__ CUtensorMap dkm,
        const __grid_constant__ CUtensorMap dvm, const Dims d, float* __restrict__ part_w) {
  constexpr int NB = EP / 64, kStage = 3 * NB * kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sb = tc::smem_u32(smem);
  const uint32_t bar = sb + kWStages * kStage;
  const int tid = threadIdx.x, mt = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const int ch = blockIdx.x, j0 = ch * d.perW, n = min(d.n_tw, j0 + d.perW) - j0;
  auto issue = [&](int i) {
    const uint32_t st = sb + (i % kWStages) * kStage, br = bar + 8 * (i % kWStages);
    mbar_expect_tx(br, kStage);
    for (int cb = 0; cb < NB; ++cb) {
      tma_load(st + cb * kBox, &x2m, 64 * cb, 64 * (j0 + i), br);
      tma_load(st + (NB + cb) * kBox, &dkm, 64 * cb, 64 * (j0 + i), br);
      tma_load(st + (2 * NB + cb) * kBox, &dvm, 64 * cb, 64 * (j0 + i), br);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) mbar_init(bar + 8 * s, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(kWStages, n); ++i) issue(i);
  float ak[EP / 2], av[EP / 2];
#pragma unroll
  for (int i = 0; i < EP / 2; ++i) ak[i] = av[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const uint32_t st = sb + (i % kWStages) * kStage;
    mbar_wait(bar + 8 * (i % kWStages), (i / kWStages) & 1);
    fence_acc(ak);
    fence_acc(av);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg_ss<EP, 1, 1>(ak, md(st + mt * kBox, kk), md(st + NB * kBox, kk), 1);
      wg_ss<EP, 1, 1>(av, md(st + mt * kBox, kk), md(st + 2 * NB * kBox, kk), 1);
    }
    wg_commit();
    wg_wait0();
    fence_acc(ak);
    fence_acc(av);
    __syncthreads();  // every warpgroup is done with the stage
    if (tid == 0 && i + kWStages < n) issue(i + kWStages);
  }
  float* pw = part_w + (long long)ch * 2 * d.E * d.E;
#pragma unroll
  for (int i = 0; i < EP / 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ei = 64 * mt + 16 * warp + gq + 8 * (k >> 1), eo = 8 * i + 2 * tq + (k & 1);
      if (ei < d.E && eo < d.E) {
        pw[(long long)ei * d.E + eo] = ak[4 * i + k];
        pw[(long long)d.E * d.E + (long long)ei * d.E + eo] = av[4 * i + k];
      }
    }
}

// -- the fixed-order sums ----------------------------------------------------------------

enum SumKind { kFlat = 0, kNum = 1, kDen = 2, kDqs = 3 };
struct SumJob {
  const float* part;
  float* out;
  long long n, pstride, first;
  int P, kind;
};
struct Sums {
  SumJob job[6];
  int n;
};

// out[i] = sum over p < P of part[src(i) + p pstride], src by kind: flat (i); num
// (cell, query, column) from the chunks' [64][E] rows; den (cell, head, query) from
// their [H][64]; dq (head query, column) from every cell's chunks, 0 off the head
// blocks
__global__ void __launch_bounds__(256) poolw_sums(const Dims d, const __grid_constant__ Sums s) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  int j = 0;
  while (j + 1 < s.n && idx >= s.job[j + 1].first) ++j;
  const SumJob& jb = s.job[j];
  const long long i = idx - jb.first;
  if (i >= jb.n) return;
  long long src = i;
  if (jb.kind == kNum) {
    const long long c = i % d.E, qi = (i / d.E) % d.Q, b = i / ((long long)d.E * d.Q);
    src = ((b * d.NQT + qi / 64) * d.nch * 64 + qi % 64) * d.E + c;
  } else if (jb.kind == kDen) {
    const long long qi = i % d.Q, h = (i / d.Q) % d.H, b = i / ((long long)d.Q * d.H);
    src = ((b * d.NQT + qi / 64) * d.nch * d.H + h) * 64 + qi % 64;
  } else if (jb.kind == kDqs) {
    const long long c = i % d.E, hq = i / d.E, h = hq / d.Q, qi = hq % d.Q;
    if (c / d.hd != h) {
      jb.out[i] = 0.f;
      return;
    }
    src = ((qi / 64) * d.B * d.nch * 64 + qi % 64) * d.E + c;
  }
  float acc = 0.f;
  for (int p = 0; p < jb.P; ++p) acc += jb.part[src + p * jb.pstride];
  jb.out[i] = acc;
}

cudaError_t launch_sums(const Dims& d, Sums s, cudaStream_t stream) {
  long long total = 0;
  for (int j = 0; j < s.n; ++j) {
    s.job[j].first = total;
    total += s.job[j].n;
  }
  if (total == 0) return cudaSuccess;
  poolw_sums<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(d, s);
  return cudaGetLastError();
}

// -- launches --------------------------------------------------------------------------

template <class K>
cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t pack(const Dims& d, const Work& w, const float* wk, const float* wv,
                 const float* qfull, const float* dnum, bool bwd, cudaStream_t s) {
  const long long EE = (long long)d.EP * d.EP, QE = (long long)d.QP * d.EP;
  PackArgs a{wk, wv, qfull, dnum, w,
             {2 * EE, QE, bwd ? 2 * EE : 0, bwd ? QE : 0, bwd ? 3LL * d.B * QE : 0,
              bwd ? 3LL * d.B * QE : 0}};
  const long long total = a.n[0] + a.n[1] + a.n[2] + a.n[3] + a.n[4] + a.n[5];
  const long long blocks = cdiv(total, 256);
  poolw_pack<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(d, a);
  return cudaGetLastError();
}

template <int EP, bool kDense, int kMode>
cudaError_t launch_q(const Dims& d, const CUtensorMap& wm, const QArgs& a, cudaStream_t s) {
  const int smem = q_smem(EP / 64, d.E, d.H, kMode).total;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = allow(poolw_q<EP, kDense, kMode>, smem);
  if (err != cudaSuccess) return err;
  poolw_q<EP, kDense, kMode><<<d.B * d.NQT * d.nch, 128 * kWG, smem, s>>>(wm, d, a);
  return cudaGetLastError();
}

template <bool kDense, int NU>
cudaError_t exact_nu(const Dims& d, const Work& w, const float* counts, const float* src,
                     const float* qfull, const float* ln1g, const float* ln1b, const float* wk,
                     float* m, cudaStream_t s) {
  const int wbytes = d.E * d.hd * 4;  // at most 64 KB
  cudaError_t err = allow(poolw_exact<kDense, NU>, wbytes);
  if (err != cudaSuccess) return err;
  poolw_exact<kDense, NU><<<d.B * d.NQT * d.H, 256, wbytes, s>>>(d, counts, src, qfull, ln1g, ln1b,
                                                                 wk, w, m);
  return cudaGetLastError();
}

// poolw_exact with as many (row, column) pairs a lane as the head width needs
template <bool kDense>
cudaError_t exact_ep(const Dims& d, const Work& w, const float* counts, const float* src,
                     const float* qfull, const float* ln1g, const float* ln1b, const float* wk,
                     float* m, cudaStream_t s) {
  if (d.hd <= 16) return exact_nu<kDense, 4>(d, w, counts, src, qfull, ln1g, ln1b, wk, m, s);
  if (d.hd <= 32) return exact_nu<kDense, 8>(d, w, counts, src, qfull, ln1g, ln1b, wk, m, s);
  if (d.hd <= 64) return exact_nu<kDense, 16>(d, w, counts, src, qfull, ln1g, ln1b, wk, m, s);
  return exact_nu<kDense, 32>(d, w, counts, src, qfull, ln1g, ln1b, wk, m, s);
}

template <int EP, bool kDense>
cudaError_t forward_ep(const Dims& d, const Work& w, const float* counts, const float* src,
                       const float* qfull, const float* ln1g, const float* ln1b, const float* wk,
                       float* num, float* den, float* m, cudaStream_t s) {
  CUtensorMap wm;
  if (!make_map(&wm, w.wT, 2, EP, 2 * EP, 1, 64)) return cudaErrorInvalidValue;
  const QArgs a{counts, src, ln1g, ln1b, nullptr, nullptr, m, w};
  cudaError_t err = launch_q<EP, kDense, kMax>(d, wm, a, s);
  if (err != cudaSuccess) return err;
  if ((err = exact_ep<kDense>(d, w, counts, src, qfull, ln1g, ln1b, wk, m, s)) != cudaSuccess)
    return err;
  if ((err = launch_q<EP, kDense, kFwd>(d, wm, a, s)) != cudaSuccess) return err;
  Sums sums{};
  sums.job[0] = {w.pnum, num, (long long)d.B * d.Q * d.E, 64LL * d.E, 0, d.nch, kNum};
  sums.job[1] = {w.pden, den, (long long)d.B * d.H * d.Q, 64LL * d.H, 0, d.nch, kDen};
  sums.n = 2;
  return launch_sums(d, sums, s);
}

template <int EP, bool kDense>
cudaError_t backward_ep(const Dims& d, const Work& w, const float* counts, const float* src,
                        const float* ln1g, const float* ln1b, const float* mstat,
                        const float* dden, float* dsrc, float* dqfull, float* dln1g,
                        float* dln1b, float* dwk, float* dwv, cudaStream_t s) {
  constexpr int NB = EP / 64;
  const long long EE = (long long)d.E * d.E;
  const bool any = d.ntiles > 0;
  const int units = tok_units(d, kDense);
  cudaError_t err;
  if (any) {
    CUtensorMap wm, wnm, qmm, qtm, dnm, dntm, km, vm, x2m, dkm, dvm, dk3, dv3;
    if (!make_map(&wm, w.wT, 2, EP, 2 * EP, 1, 64) || !make_map(&wnm, w.wN, 2, EP, 2 * EP, 1, 64) ||
        !make_map(&qmm, w.qM, 2, EP, d.QP, 1, 64) || !make_map(&qtm, w.qT, 2, d.QP, EP, 1, 64) ||
        !make_map(&dnm, w.dN, 3, EP, d.QP, 3LL * d.B, 64) ||
        !make_map(&dntm, w.dNT, 3, d.QP, EP, 3LL * d.B, 64) ||
        !make_map(&km, w.kg, 3, EP, d.N, d.B, 64) || !make_map(&vm, w.vg, 3, EP, d.N, d.B, 64) ||
        !make_map(&dk3, w.dk, 3, EP, d.N, d.B, 64) || !make_map(&dv3, w.dv, 3, EP, d.N, d.B, 64) ||
        !make_map(&x2m, w.x2, 2, EP, d.T, 1, 64) || !make_map(&dkm, w.dk, 2, EP, d.T, 1, 64) ||
        !make_map(&dvm, w.dv, 2, EP, d.T, 1, 64))
      return cudaErrorInvalidValue;
    const QArgs qa{counts, src, ln1g, ln1b, mstat, dden, nullptr, w};
    if ((err = launch_q<EP, kDense, kDq>(d, wm, qa, s)) != cudaSuccess) return err;
    {
      const int smem = t_smem(NB, d.H).total;
      if ((err = allow(poolw_t<EP>, smem)) != cudaSuccess) return err;
      const TArgs ta{mstat, dden, w};
      poolw_t<EP><<<d.B * d.NQT * d.nch, 128 * kWG, smem, s>>>(qmm, qtm, dnm, dntm, km, vm, d, ta);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (d.NQT > 1) {
      poolw_dkv<<<4 * kTargetW, 256, 0, s>>>(d, w);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    {
      const int smem = k_smem(NB).total;
      if ((err = allow(poolw_tok<EP, kDense>, smem)) != cudaSuccess) return err;
      const KArgs ka{counts, src, ln1g, ln1b, dsrc, w};
      poolw_tok<EP, kDense><<<cdiv(units, kWG), 128 * kWG, smem, s>>>(wnm, dk3, dv3, d, ka);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    {
      const int smem = kWStages * 3 * NB * kBox + 64 + 1024;
      if ((err = allow(poolw_w<EP>, smem)) != cudaSuccess) return err;
      poolw_w<EP><<<d.n_chW, 2 * EP, smem, s>>>(x2m, dkm, dvm, d, w.part_w);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  // with no token every gradient is 0: partial counts of 0 write zeros
  Sums sums{};
  sums.job[0] = {w.pdq, dqfull, (long long)d.H * d.Q * d.E, 64LL * d.E, 0,
                 any ? d.B * d.nch : 0, kDqs};
  sums.job[1] = {w.part_ln, dln1g, (long long)d.E, 2LL * d.E, 0, any ? units : 0, kFlat};
  sums.job[2] = {w.part_ln + d.E, dln1b, (long long)d.E, 2LL * d.E, 0, any ? units : 0, kFlat};
  sums.job[3] = {w.part_w, dwk, EE, 2 * EE, 0, any ? d.n_chW : 0, kFlat};
  sums.job[4] = {w.part_w + EE, dwv, EE, 2 * EE, 0, any ? d.n_chW : 0, kFlat};
  sums.n = 5;
  if (kDense)
    sums.job[sums.n++] = {w.part_dt, dsrc, (long long)d.N * d.E, (long long)d.N * d.E, 0,
                          any ? d.n_grp : 0, kFlat};
  return launch_sums(d, sums, s);
}

template <bool kDense>
int run_forward(const float* counts, const float* src, const float* qfull, const float* ln1g,
                const float* ln1b, const float* wk, const float* wv, float* num, float* den,
                float* m, void* workspace, int B, int N, int E, int H, int Q, float eps,
                float scale, cudaStream_t s) {
  const Dims d = make_dims(B, N, E, H, Q, eps, scale);
  long long bytes = 0;
  const Work w = carve(d, workspace, false, kDense, &bytes);
  cudaError_t err = pack(d, w, wk, wv, qfull, nullptr, false, s);
  if (err != cudaSuccess) return (int)err;
  return (int)(d.EP == 64
                   ? forward_ep<64, kDense>(d, w, counts, src, qfull, ln1g, ln1b, wk, num, den, m, s)
                   : forward_ep<128, kDense>(d, w, counts, src, qfull, ln1g, ln1b, wk, num, den, m, s));
}

template <bool kDense>
int run_backward(const float* counts, const float* src, const float* qfull, const float* ln1g,
                 const float* ln1b, const float* wk, const float* wv, const float* mstat,
                 const float* dnum, const float* dden, float* dsrc, float* dqfull, float* dln1g,
                 float* dln1b, float* dwk, float* dwv, void* workspace, int B, int N, int E,
                 int H, int Q, float eps, float scale, cudaStream_t s) {
  const Dims d = make_dims(B, N, E, H, Q, eps, scale);
  long long bytes = 0;
  const Work w = carve(d, workspace, true, kDense, &bytes);
  cudaError_t err = pack(d, w, wk, wv, qfull, dnum, true, s);
  if (err != cudaSuccess) return (int)err;
  return (int)(d.EP == 64 ? backward_ep<64, kDense>(d, w, counts, src, ln1g, ln1b, mstat, dden,
                                                    dsrc, dqfull, dln1g, dln1b, dwk, dwv, s)
                          : backward_ep<128, kDense>(d, w, counts, src, ln1g, ln1b, mstat, dden,
                                                     dsrc, dqfull, dln1g, dln1b, dwk, dwv, s));
}

}  // namespace
}  // namespace poolw

extern "C" {

// Whether the any-width narrow pool kernels take (E, H, Q): E from 1 to 128,
// H dividing E, any number of inducing points.
int scldm_encoder_pool_gen_takes(int E, int H, int Q) {
  return E >= 1 && E <= 128 && H >= 1 && E % H == 0 && Q >= 1;
}

// Floats of the device workspace of the forward (backward = 0) or the
// backward: the packed bf16 operands, the partials, and for the backward
// dk and dv of every token per query tile (f32) and bf(x2), bf(dk), bf(dv).
// 0 for a shape not taken.
long long scldm_encoder_pool_gen_workspace_floats(int B, int N, int E, int H, int Q, int dense,
                                                  int backward) {
  if (!scldm_encoder_pool_gen_takes(E, H, Q) || B <= 0 || N < 0) return 0;
  long long bytes = 0;
  poolw::carve(poolw::make_dims(B, N, E, H, Q, 0.f, 1.f), nullptr, backward != 0, dense != 0,
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
  return poolw::run_forward<true>((const float*)counts, (const float*)table, (const float*)qfull,
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
  return poolw::run_forward<false>(nullptr, (const float*)emb, (const float*)qfull,
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
  return poolw::run_backward<true>(
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
  return poolw::run_backward<false>(
      nullptr, (const float*)emb, (const float*)qfull, (const float*)ln1g, (const float*)ln1b,
      (const float*)wk, (const float*)wv, (const float*)m, (const float*)dnum,
      (const float*)dden, (float*)demb, (float*)dqfull, (float*)dln1g, (float*)dln1b,
      (float*)dwk, (float*)dwv, workspace, B, N, E, H, Q, eps, scale, (cudaStream_t)stream);
}

}  // extern "C"
