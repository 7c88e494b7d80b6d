// The VAE decoder tail at any width the JAX gate dispatches (E <= 128, any
// head count dividing E, any number of latent tokens, any SwiGLU hidden
// width): forward and recompute backward on wgmma (bf16 products, f32 sums)
// with TMA-fed shared memory, for sm_90a. Replaces the TPU kernels
// scldm_tpu/ops/fused_decoder.py::fused_decoder_tail (`_fwd`) and `_fused_bwd`
// at every shape but the dentate decoder's (E = 32, 4 heads, 16 tokens,
// hidden 88), which decoder_tail.cu keeps. The math is `_tail_math` there and
// `decoder_tail_reference` in scldm_torch/ops/fused_decoder.py: kfull, qp, p,
// vproj, hn and w12 are rounded to bf16 before their products, and the
// gradients of those six are rounded to bf16 as the reference's autograd
// rounds them; products with an f32 cotangent (d(hh), ds, [da | dc]) run in
// three bf16 passes (hi, mid, lo; the smallest first).
//
// What bounds it on an H100: the bf16 tensor-core rate over the function's
// products (scores, p vproj, the up projection, three times that backward),
// 0.14 / 0.43 ms at the dentate step (E = 64, G = 17,002, B = 128). What
// the design does about it:
// - A warpgroup owns 64 genes (wgmma's M) over a block of cells. The rows and
//   q-side kernels run two or three warpgroups a CTA (three where 168
//   registers a thread hold the work: the forward and the q side at E <= 64)
//   on their own genes, sharing one pipeline of loads; each takes the ring's
//   slots at its own pace (the last one done with a slot refills it), so one
//   warpgroup's products overlap another's elementwise work. Every product is
//   a wgmma: the genes (or keys, or pairs) are its rows, its A operand comes
//   from registers where it was just computed (bf(p), bf(hn), [da | dc], ds)
//   or from shared memory.
// - Operands arrive by TMA into the 128-byte swizzle wgmma reads: one launch
//   first packs qp, kfull, vproj and w12^T to bf16 (E padded to 64 or 128,
//   w12^T's hidden rows to 32), then each (cell, head tile, 64-key tile) of
//   keys and values is one stage of a two-deep ring on mbarriers, so the next
//   stage's load overlaps this one's products; w12^T in chunks of 32 hidden
//   columns (w1's 32 rows, then w2's) stays resident where it fits (E <= 64
//   at every MLP width the configs use) and streams through a ring where it
//   does not (E = 128). One tile serves both ways: a [rows][64 x bf16] box is
//   K-major for one product and MN-major for its transpose (kfull for the
//   scores and for dqp, vproj for p vproj and for dp, w12^T for the up
//   projection and for d(hn), qp for the scores and for dkfull).
// - Head tiles: where a head has at most 32 keys, 64 / (M rounded up to 16)
//   heads share one 64-key tile (their keys side by side, each block-diagonal
//   in E, so one product over their columns gives each head's scores), and
//   the softmax runs per head within the tile; the products lose no columns
//   to padding and a cell takes half the stages or fewer.
// - Sums in registers: y, the up projection and d(hn) per cell, dqp across a
//   block of cells, dvproj and dkfull across a chunk of genes, dw12 across a
//   chunk of pairs. Each product is summed from zero over its own depth and
//   added in f32 (long tensor-core chains drop low bits).
// - Any number of keys: 64-key tiles. At one tile the softmax is exact in
//   registers; past 64 keys the rows kernel takes each row's max and sum in a
//   first pass and the probabilities in a second, and the backward reads
//   them (and D = sum p bf(dp), which the q-side kernel writes) from a small
//   workspace instead of passing twice more.
// Kernels (every launch on the caller's stream; no atomic sums, so every sum
// runs in a fixed order and the backward repeats its bits):
//   tailw_pack   qp, kfull, vproj, w12^T to bf16, zero-padded.
//   tailw_rows   forward: per (gene tile, cell block) the attention, the
//                residual, the LayerNorm, [a | c] = bf(hn) w12 and the logit.
//                backward: the same, then [da | dc], d(hn) = [da | dc] w12^T,
//                the LayerNorm backward to d(hh); d(hh) (f32) and bf(hn) of
//                each pair to the workspace; dln2g, dln2b, dwmu, dbmu per CTA.
//   tailw_qside  per (gene tile, cell block): s, p, dp = d(hh) vproj^T, ds,
//                dqp += ds kfull.
//   tailw_kside  per (cell, head tile, key tile, gene chunk): s, p, dp, ds
//                again, dvproj += bf(p)^T d(hh) and dkfull += ds^T bf(qp).
//   tailw_w12    per (32 hidden columns, pair chunk): [a | c] from the saved
//                bf(hn), [da | dc], dwv, dw12^T += [da | dc]^T bf(hn).
//   tailw_sums   every partial added in index order; dq = sum over cells of
//                d(hh).
// The workspace (`scldm_decoder_tail_gen_workspace_floats`): the packed
// operands, d(hh) and bf(hn) of every pair (6 EP bytes a pair), the softmax
// statistics past 64 keys, and the partials.
//
// Tried and slower on an H100 80GB HBM3 at 700 W (chip runs in turns): three
// warpgroups for the rows backward at E <= 64 (168 registers, spills: 9.46
// against 9.12 ms), or four for the forward (128 registers); three for the
// E = 128 forward (1.14 against 1.06 ms); a four-deep key / value ring at E
// <= 64 (no gain); the two k-side products in one batch (no gain); d(hn)
// summed in the tensor cores across chunks (4-6% faster, but its bf16
// gradient moved by up to 1e-3 of its largest); a segmented softmax for head
// tiles by runtime comparisons rather than templates (slower than one head a
// tile).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_tma.cuh"
#include "tensor_core.cuh"

namespace tailw {
namespace {

// (hopper_wgmma.cuh)
using hopper::fence_async_shared;
using hopper::k_desc;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::mn_desc;
using hopper::named_sync;
using hopper::tma_load;

// (hopper_tma.cuh)
using hopper::a_frag;
using hopper::a_frag3;
using hopper::bfr;
using hopper::col_sum;
using hopper::fence_acc;
using hopper::fence_mbar_init;
using hopper::kBox;
using hopper::kd;
using hopper::make_map;
using hopper::md;
using hopper::quad_max;
using hopper::quad_sum;
using hopper::sw;
using hopper::tma_load3;
using hopper::wg_commit;
using hopper::wg_fence;
using hopper::wg_rs;
using hopper::wg_rs64;
using hopper::wg_ss;
using hopper::wg_ss64;
using hopper::wg_wait0;
constexpr int kNS = 2;  // key / value stages in flight
// warpgroups a CTA of the rows and of the q-side kernel, each on its own 64
// genes: three where 168 registers a thread hold the work (the forward and the
// q side at E <= 64), else two
__host__ __device__ constexpr int rows_wg(int NB, bool bwd) { return NB == 1 && !bwd ? 3 : 2; }
__host__ __device__ constexpr int q_wg(int NB) { return NB == 1 ? 3 : 2; }
constexpr int kSmemMax = 232448;
// units a launch aims for: the rows and w12 kernels (about 16 waves of one
// CTA an SM, so the last wave's share is small), the q-side kernel (8), the
// k-side kernels
constexpr int kTargetRows = 2112, kTargetQ = 1056, kTargetK = 1056;

__host__ __device__ constexpr int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }
__host__ __device__ constexpr int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

struct Dims {
  int B, G, E, H, M, Hd, hd;
  int EP, NB;               // E padded to 64 or 128; its 64-column boxes
  int nkt;                  // 64-key tiles of a head
  int hpt, MP, HT, R;       // heads a tile (several where each has <= 32 keys), keys a
                            // head occupies in it (16, 32; 64 at one head a tile),
                            // head tiles of a cell, packed key rows of a head tile
  int HdP, nch;             // the hidden width padded to 32; its chunks
  int n_gtr, Bc, n_cb;      // rows kernel: gene tiles (64 a warpgroup), cells a block, blocks
  int n_gtq, Bq, n_cbq;     // q-side kernel: likewise
  int n_gt, tpc, n_gch;     // k-side kernels: 64-gene tiles, tiles a chunk, chunks
  long long P;              // pairs
  int n_pt, ppc, n_pc;      // w12 kernel: 64-pair tiles, tiles a chunk, chunks
  int nw;                   // w12^T slots of the rows kernel (nch: resident)
  float eps, scale;
};

// shared-memory layout of the rows kernel (byte offsets from a 1,024-aligned base)
struct RowsSmem {
  int qp, kv, w, x, vec, red, bar, cnt, total;
};
__host__ __device__ inline RowsSmem rows_smem(int NB, int nw, bool bwd) {
  RowsSmem s;
  s.qp = 0;
  s.kv = s.qp + rows_wg(NB, bwd) * NB * kBox;
  s.w = s.kv + kNS * 2 * NB * kBox;
  s.x = s.w + nw * NB * kBox;
  s.vec = s.x + (bwd ? rows_wg(NB, bwd) * 64 * 64 * NB * 4 : 0);
  s.red = s.vec + (bwd ? rows_wg(NB, bwd) * 4 * 3 * 64 * NB * 4 : 0);
  s.bar = s.red + 64;
  s.cnt = s.bar + 8 * (1 + kNS + nw);
  s.total = s.cnt + 4 * (kNS + nw) + 1024;
  return s;
}

Dims make_dims(int B, int G, int E, int H, int M, int Hd, float eps, float scale, bool bwd) {
  Dims d{};
  d.B = B, d.G = G, d.E = E, d.H = H, d.M = M, d.Hd = Hd, d.hd = E / H;
  d.EP = E <= 64 ? 64 : 128, d.NB = d.EP / 64;
  d.nkt = cdiv(M, 64);
  const int m16 = 16 * cdiv(M, 16);
  d.hpt = d.nkt == 1 && m16 <= 32 ? 64 / m16 : 1;
  d.MP = d.hpt > 1 ? m16 : 64;
  d.HT = cdiv(H, d.hpt);
  d.R = d.hpt > 1 ? d.hpt * d.MP : M;
  d.HdP = 32 * cdiv(Hd, 32), d.nch = d.HdP / 32;
  d.n_gtr = cdiv(G, 64 * rows_wg(d.NB, bwd));
  d.n_cb = clampi(cdiv(kTargetRows, d.n_gtr), 1, B);
  d.Bc = cdiv(B, d.n_cb);
  d.n_cb = cdiv(B, d.Bc);
  d.n_gtq = cdiv(G, 64 * q_wg(d.NB));
  d.n_cbq = clampi(cdiv(kTargetQ, d.n_gtq), 1, B);
  d.Bq = cdiv(B, d.n_cbq);
  d.n_cbq = cdiv(B, d.Bq);
  d.n_gt = cdiv(G, 64);
  d.n_gch = clampi(cdiv(kTargetK, (long long)B * d.HT * d.nkt), 1, d.n_gt);
  d.tpc = cdiv(d.n_gt, d.n_gch);
  d.n_gch = cdiv(d.n_gt, d.tpc);
  d.P = (long long)B * G;
  d.n_pt = cdiv(d.P, 64);
  d.n_pc = clampi(cdiv(kTargetRows, d.nch), 1, d.n_pt);
  d.ppc = cdiv(d.n_pt, d.n_pc);
  d.n_pc = cdiv(d.n_pt, d.ppc);
  const int fixed = rows_smem(d.NB, 0, bwd).total;
  d.nw = clampi((kSmemMax - fixed - 8 * 64) / (d.NB * kBox), 1, d.nch);
  d.eps = eps, d.scale = scale;
  return d;
}

struct Work {
  __nv_bfloat16 *qpb, *kb, *vb, *wt;  // the packed operands
  float* dhh;                          // (P, EP) f32
  __nv_bfloat16* hn;                   // (P, EP) bf16
  float* stats;                        // (B H, 3, G): m, l, D past 64 keys
  float *part_qp, *part_v, *part_dv, *part_dk, *part_w, *part_wv;
};

struct Carve {
  char* base;
  long long used;
  template <class T>
  T* take(long long count) {
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += (count * (long long)sizeof(T) + 255) & ~255LL;
    return p;
  }
};

Work carve(const Dims& d, void* base, bool bwd, long long* bytes) {
  Carve c{(char*)base, 0};
  Work w{};
  const long long BHM = (long long)d.B * d.H * d.M, rows = (long long)d.B * d.HT * d.R;
  w.qpb = c.take<__nv_bfloat16>((long long)d.G * d.EP);
  w.kb = c.take<__nv_bfloat16>(rows * d.EP);
  w.vb = c.take<__nv_bfloat16>(rows * d.EP);
  w.wt = c.take<__nv_bfloat16>(2LL * d.HdP * d.EP);
  if (bwd) {
    w.dhh = c.take<float>(d.P * d.EP);
    w.hn = c.take<__nv_bfloat16>(d.P * d.EP);
    w.stats = c.take<float>(d.nkt > 1 ? 3LL * d.B * d.H * d.G : 0);
    w.part_qp = c.take<float>((long long)d.n_cbq * d.G * d.E);
    w.part_v = c.take<float>((long long)d.n_gtr * d.n_cb * (3 * d.E + 1));
    w.part_dv = c.take<float>((long long)d.n_gch * BHM * d.E);
    w.part_dk = c.take<float>((long long)d.n_gch * BHM * d.hd);
    w.part_w = c.take<float>((long long)d.n_pc * d.E * 2 * d.Hd);
    w.part_wv = c.take<float>((long long)d.n_pc * d.Hd);
  }
  *bytes = c.used;
  return w;
}

struct Ptrs {
  const float *q, *ln2g, *ln2b, *wv, *wmu, *bmu, *dy;
  float* out;
  Work w;
};

// -- device helpers (the rest in hopper_tma.cuh) -------------------------------------

template <class T>
__device__ __forceinline__ T* at(uint8_t* base, uint32_t off) {
  return reinterpret_cast<T*>(base + off);
}

// s (genes x 64 keys) = bf(qp) kfull_h^T over the head's k steps: qp and the
// key tile K-major in shared memory
__device__ __forceinline__ void scores(float (&s)[32], uint32_t qp, uint32_t keys, int ks0,
                                       int ks1) {
  fence_acc(s);
  wg_fence();
  for (int ks = ks0; ks <= ks1; ++ks) wg_ss64<0, 0>(s, kd(qp, ks), kd(keys, ks), ks > ks0);
  wg_commit();
  wg_wait0();
  fence_acc(s);
}

// The columns of a tile: heads of 8 << sh keys side by side (sh 1 or 2: several
// heads of at most 32 keys in one 64-key tile; 3: one head, or 64 keys of a
// longer one), column c holding key c % (8 << sh) of the tile's head c >> (sh
// + 3); the first nkeys keys of each of its first nheads heads are real.
struct Cols {
  int sh, nkeys, nheads;
  __device__ bool ok(int c) const { return (c & ((8 << sh) - 1)) < nkeys && (c >> (sh + 3)) < nheads; }
  __device__ int ncols() const { return ((nheads - 1) << (sh + 3)) + nkeys; }
};

// head tile ht's key tile kt
__device__ __forceinline__ Cols cols_of(const Dims& d, int ht, int kt) {
  if (d.hpt == 1) return Cols{3, min(64, d.M - 64 * kt), 1};
  return Cols{d.MP == 16 ? 1 : 2, d.M, min(d.hpt, d.H - ht * d.hpt)};
}

// The probabilities of whole heads in one tile: per head (8 << SH columns) the
// scaled scores' row max and sum over the quad, exp against the max, divided.
template <int SH>
__device__ __forceinline__ void softmax_seg(float (&s)[32], const Cols& k, float scale, int tq) {
  constexpr int NS = 8 >> SH;  // heads a tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx[NS], sum[NS];
#pragma unroll
    for (int g = 0; g < NS; ++g) mx[g] = -INFINITY, sum[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& v = s[4 * i + 2 * r + c];
        v = k.ok(8 * i + 2 * tq + c) ? v * scale : -INFINITY;
        mx[i >> SH] = fmaxf(mx[i >> SH], v);
      }
#pragma unroll
    for (int g = 0; g < NS; ++g) mx[g] = quad_max(mx[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& v = s[4 * i + 2 * r + c];
        v = v == -INFINITY ? 0.f : expf(v - mx[i >> SH]);
        sum[i >> SH] += v;
      }
#pragma unroll
    for (int g = 0; g < NS; ++g) {
      const float t = quad_sum(sum[g]);
      sum[g] = t > 0.f ? 1.0f / t : 0.f;  // a head past H has no key
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) s[4 * i + 2 * r + c] *= sum[i >> SH];
  }
}

__device__ __forceinline__ void softmax_tile(float (&s)[32], const Cols& k, float scale, int tq) {
  if (k.sh == 3) softmax_seg<3>(s, k, scale, tq);
  else if (k.sh == 2) softmax_seg<2>(s, k, scale, tq);
  else softmax_seg<1>(s, k, scale, tq);
}

// past one tile: the running max m and sum l of each row over this tile's keys
__device__ __forceinline__ void stats_tile(const float (&s)[32], int nval, float scale, int tq,
                                           float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (8 * i + 2 * tq + c < nval) mx = fmaxf(mx, s[4 * i + 2 * r + c] * scale);
    const float mn = fmaxf(m[r], quad_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (8 * i + 2 * tq + c < nval) sum += expf(s[4 * i + 2 * r + c] * scale - mn);
    l[r] = l[r] * expf(m[r] - mn) + quad_sum(sum);
    m[r] = mn;
  }
}

// the probabilities of one tile against a row's max m and sum l
__device__ __forceinline__ void probs_tile(float (&s)[32], int nval, float scale, int tq,
                                           const float (&m)[2], const float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.0f / l[r];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& v = s[4 * i + 2 * r + c];
        v = 8 * i + 2 * tq + c < nval ? expf(v * scale - m[r]) * inv : 0.f;
      }
  }
}

// y (genes x EP) += bf(p) vproj_h: the value tile MN-major, k = the tile's keys
// (columns past ncols hold no key)
template <int EP>
__device__ __forceinline__ void pv(float (&y)[EP / 2], const float (&p)[32], uint32_t vals,
                                   int ncols) {
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) a_frag<32>(a[kk], p, kk);
  fence_acc(y);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (16 * kk < ncols) wg_rs<EP, 1>(y, a[kk], md(vals, kk), 1);
  wg_commit();
  wg_wait0();
  fence_acc(y);
}

// dp (genes x 64 keys) = d(hh) vproj_h^T: d(hh)'s three bf16 planes K-major
// (A), the value tile K-major (B); ke: E's k steps
template <int NB>
__device__ __forceinline__ void dp_of(float (&dp)[32], uint32_t planes, uint32_t vals, int ke) {
  fence_acc(dp);
  wg_fence();
  for (int ks = 0; ks < ke; ++ks)
#pragma unroll
    for (int q = 2; q >= 0; --q)
      wg_ss64<0, 0>(dp, kd(planes + q * NB * kBox, ks), kd(vals, ks), ks > 0 || q < 2);
  wg_commit();
  wg_wait0();
  fence_acc(dp);
}

// d(hh) rows (f32 in the workspace) as three bf16 planes (hi, mid, lo), each
// NB boxes of the warpgroup's 64 rows; rows past G are zero
template <int EP>
__device__ __forceinline__ void split_dhh(uint8_t* planes, const float* dhh, const long long (&row)[2],
                                          const bool (&valid)[2], int warp, int gq, int tq) {
  constexpr int NB = EP / 64;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int R = 16 * warp + gq + 8 * r;
#pragma unroll
    for (int i = 0; i < EP / 8; ++i) {
      const int col = 8 * i + 2 * tq;
      float2 v = make_float2(0.f, 0.f);
      if (valid[r]) v = *reinterpret_cast<const float2*>(dhh + row[r] * EP + col);
      uint32_t hi, mid, lo;
      tc::split3_bf16(v.x, v.y, hi, mid, lo);
      const uint32_t off = sw(R, col);
      *at<uint32_t>(planes, off) = hi;
      *at<uint32_t>(planes, NB * kBox + off) = mid;
      *at<uint32_t>(planes, 2 * NB * kBox + off) = lo;
    }
  }
}

// ds = p (bf(dp) - D) scale, in dp; D of each row is the sum over the head's
// keys of p bf(dp): `own` takes it from this tile (each head of it in the tile,
// 8 << SH columns), else from D (one head past 64 keys)
template <int SH>
__device__ __forceinline__ void ds_seg(float (&dp)[32], const float (&p)[32], const float (&D)[2],
                                       bool own, float scale) {
  constexpr int NS = 8 >> SH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cs[NS];
#pragma unroll
    for (int g = 0; g < NS; ++g) cs[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& v = dp[4 * i + 2 * r + c];
        v = bfr(v);  // the gradient of bf(p)
        cs[i >> SH] = fmaf(p[4 * i + 2 * r + c], v, cs[i >> SH]);
      }
#pragma unroll
    for (int g = 0; g < NS; ++g) cs[g] = own ? quad_sum(cs[g]) : D[r];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& v = dp[4 * i + 2 * r + c];
        v = p[4 * i + 2 * r + c] * (v - cs[i >> SH]) * scale;
      }
  }
}

__device__ __forceinline__ void ds_of(float (&dp)[32], const float (&p)[32], const float (&D)[2],
                                      bool own, int sh, float scale) {
  if (sh == 3) ds_seg<3>(dp, p, D, own, scale);
  else if (sh == 2) ds_seg<2>(dp, p, D, own, scale);
  else ds_seg<1>(dp, p, D, own, scale);
}

// sum over the tile of p bf(dp), a row (pass one of the backward past 64 keys)
__device__ __forceinline__ void d_part(const float (&dp)[32], const float (&p)[32], float (&D)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cs = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) cs = fmaf(p[4 * i + 2 * r + c], bfr(dp[4 * i + 2 * r + c]), cs);
    D[r] += quad_sum(cs);
  }
}

// A warpgroup is done with a ring slot: whether it is the last of the CTA's
// warpgroups to be (then its thread 0 refills the slot). Each warpgroup takes
// the slots in the same order at its own pace, so one can run ahead of the
// other by the depth of the ring while the other computes.
__device__ __forceinline__ bool last_of_slot(uint32_t* cnt, int wg, int t, int nwg) {
  named_sync(1 + wg, 128);  // the warpgroup's products have read the slot
  return t == 0 && (int)(atomicAdd(cnt, 1u) % (uint32_t)nwg) == nwg - 1;
}

// The key / value stage sequence of a (gene tile, cell block) unit: per cell
// and head tile one stage (its heads in one tile) or 2 nkt (the statistics
// pass, then the probabilities pass), stage i in slot i % kNS.
struct KvSeq {
  int b0, HT, nkt, per_ht;
  __device__ void of(int i, int& b, int& ht, int& kt) const {
    const int bt = i / per_ht;
    kt = (i % per_ht) % nkt;
    b = b0 + bt / HT;
    ht = bt % HT;
  }
};

template <int NB>
__device__ __forceinline__ void issue_kv(const KvSeq& sq, int i, uint32_t kv, uint32_t bar,
                                         const CUtensorMap* km, const CUtensorMap* vm) {
  int b, ht, kt;
  sq.of(i, b, ht, kt);
  const int slot = i % kNS;
  const uint32_t dst = kv + slot * 2 * NB * kBox, br = bar + 8 * slot;
  mbar_expect_tx(br, 2 * NB * kBox);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    tma_load3(dst + j * kBox, km, 64 * j, 64 * kt, b * sq.HT + ht, br);
    tma_load3(dst + (NB + j) * kBox, vm, 64 * j, 64 * kt, b * sq.HT + ht, br);
  }
}

// w12^T chunk c (w1's 32 rows, then w2's) into a 64-row slot
template <int NB>
__device__ __forceinline__ void issue_w(int c, uint32_t dst, uint32_t bar, const CUtensorMap* wm,
                                        int HdP) {
  mbar_expect_tx(bar, NB * kBox);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    tma_load(dst + j * kBox, wm, 64 * j, 32 * c, bar);
    tma_load(dst + j * kBox + 4096, wm, 64 * j, HdP + 32 * c, bar);
  }
}

// -- the rows kernel: forward, and the backward's per-pair chain -----------------------

template <int EP, bool kBwd>
__global__ void __launch_bounds__(128 * rows_wg(EP / 64, kBwd), 1)
tailw_rows(const __grid_constant__ CUtensorMap qpm, const __grid_constant__ CUtensorMap km,
           const __grid_constant__ CUtensorMap vm, const __grid_constant__ CUtensorMap wm,
           const Dims d, const Ptrs p) {
  constexpr int NB = EP / 64, NE8 = EP / 8, KE = EP / 16;
  constexpr int kNWG = rows_wg(NB, kBwd), kT2 = 128 * kNWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sb = tc::smem_u32(smem);
  const RowsSmem L = rows_smem(NB, d.nw, kBwd);
  const uint32_t bar_qp = sb + L.bar, bar_kv = bar_qp + 8, bar_w = bar_kv + 8 * kNS;
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const int gt = blockIdx.x % d.n_gtr, cb = blockIdx.x / d.n_gtr;
  const int g0 = 64 * kNWG * gt, b0 = cb * d.Bc, nb = min(d.B, b0 + d.Bc) - b0;
  const KvSeq sq{b0, d.HT, d.nkt, d.nkt == 1 ? 1 : 2 * d.nkt};
  const int n_kv = nb * d.HT * sq.per_ht;
  const bool resident = d.nw == d.nch;
  const int n_w = resident ? d.nch : nb * d.nch;

  if constexpr (kBwd) {
    float* vec = at<float>(smem, L.vec);
    for (int i = tid; i < kNWG * 4 * 3 * EP; i += kT2) vec[i] = 0.f;
  }
  uint32_t* cnt_kv = at<uint32_t>(smem, L.cnt);
  uint32_t* cnt_w = cnt_kv + kNS;
  if (tid == 0) {
    mbar_init(bar_qp, 1);
    for (int s = 0; s < kNS; ++s) mbar_init(bar_kv + 8 * s, 1), cnt_kv[s] = 0;
    for (int s = 0; s < d.nw; ++s) mbar_init(bar_w + 8 * s, 1), cnt_w[s] = 0;
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_qp, kNWG * NB * kBox);
    for (int g = 0; g < kNWG; ++g)
      for (int j = 0; j < NB; ++j)
        tma_load(sb + L.qp + (g * NB + j) * kBox, &qpm, 64 * j, g0 + 64 * g, bar_qp);
    for (int i = 0; i < min(kNS, n_kv); ++i) issue_kv<NB>(sq, i, sb + L.kv, bar_kv, &km, &vm);
    for (int i = 0; i < min(d.nw, n_w); ++i)
      issue_w<NB>(i % d.nch, sb + L.w + (i % d.nw) * NB * kBox, bar_w + 8 * (i % d.nw), &wm, d.HdP);
  }

  int gene[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    gene[r] = g0 + 64 * wg + 16 * warp + gq + 8 * r;
    valid[r] = gene[r] < d.G;
    if (!valid[r]) gene[r] = d.G - 1;
  }
  const int ke = cdiv(d.E, 16);  // E's k steps (the rest of EP is zero)
  const uint32_t my_qp = sb + L.qp + wg * NB * kBox;
  float dbm = 0.f;
  mbar_wait(bar_qp, 0);
  int i_kv = 0;

  for (int j = 0; j < nb; ++j) {
    const int b = b0 + j;
    // ---- the attention: y = sum over heads bf(p) bf(vproj) ----
    float y[EP / 2];
#pragma unroll
    for (int i = 0; i < EP / 2; ++i) y[i] = 0.f;
    for (int ht = 0; ht < d.HT; ++ht) {
      const int h0 = ht * d.hpt, nh = min(d.hpt, d.H - h0);
      const int ks0 = (h0 * d.hd) / 16, ks1 = ((h0 + nh) * d.hd - 1) / 16;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      for (int pass = d.nkt == 1 ? 1 : 0; pass < 2; ++pass)
        for (int kt = 0; kt < d.nkt; ++kt, ++i_kv) {
          const int slot = i_kv % kNS;
          mbar_wait(bar_kv + 8 * slot, (i_kv / kNS) & 1);
          const uint32_t keys = sb + L.kv + slot * 2 * NB * kBox, vals = keys + NB * kBox;
          const Cols cols = cols_of(d, ht, kt);
          float s[32];
          scores(s, my_qp, keys, ks0, ks1);
          if (pass == 0) {
            stats_tile(s, cols.nkeys, d.scale, tq, m, l);
          } else {
            if (d.nkt == 1) softmax_tile(s, cols, d.scale, tq);
            else probs_tile(s, cols.nkeys, d.scale, tq, m, l);
            pv<EP>(y, s, vals, cols.ncols());
          }
          if (last_of_slot(cnt_kv + slot, wg, t, kNWG) && i_kv + kNS < n_kv)
            issue_kv<NB>(sq, i_kv + kNS, sb + L.kv, bar_kv, &km, &vm);
        }
      if constexpr (kBwd) {
        if (d.nkt > 1 && tq == 0) {
          float* st = p.w.stats + ((long long)(b * d.H + h0) * 3) * d.G;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (valid[r]) {
              st[gene[r]] = m[r];
              st[d.G + gene[r]] = l[r];
            }
        }
      }
    }

    // ---- hh = q + y, its wmu dot, the LayerNorm; bf(hn) as the up product's A ----
    float x[NE8][4];
#pragma unroll
    for (int i = 0; i < NE8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * i + 2 * tq + (e & 1);
        x[i][e] = col < d.E ? __ldg(p.q + (size_t)gene[e >> 1] * d.E + col) + y[4 * i + e] : 0.f;
      }
    float lin[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    if constexpr (kBwd) {
#pragma unroll
      for (int r = 0; r < 2; ++r) dl[r] = valid[r] ? __ldg(p.dy + (size_t)b * d.G + gene[r]) : 0.f;
      if (tq == 0) dbm += dl[0] + dl[1];
    }
    float* vec = at<float>(smem, L.vec) + (wg * 4 + warp) * 3 * EP;
#pragma unroll
    for (int i = 0; i < NE8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * i + 2 * tq + c;
        const float wm_ = col < d.E ? __ldg(p.wmu + col) : 0.f;
        lin[0] = fmaf(x[i][c], wm_, lin[0]);
        lin[1] = fmaf(x[i][2 + c], wm_, lin[1]);
        if constexpr (kBwd) {  // dwmu += dl hh
          const float v = col_sum(fmaf(dl[0], x[i][c], dl[1] * x[i][2 + c]));
          if (gq == 0) vec[2 * EP + col] += v;
        }
      }
    float rstd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s_ = 0.f;
#pragma unroll
      for (int i = 0; i < NE8; ++i) s_ += x[i][2 * r] + x[i][2 * r + 1];
      const float mean = quad_sum(s_) / d.E;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < NE8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& v = x[i][2 * r + c];
          v = 8 * i + 2 * tq + c < d.E ? v - mean : 0.f;
          var = fmaf(v, v, var);
        }
      rstd[r] = rsqrtf(quad_sum(var) / d.E + d.eps);
#pragma unroll
      for (int i = 0; i < NE8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) x[i][2 * r + c] *= rstd[r];
    }
    uint32_t hna[KE][4];
#pragma unroll
    for (int kk = 0; kk < KE; ++kk) {
      float hn[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = 16 * kk + 8 * (e >> 2) + 2 * tq + (e & 1);
        const float xv = x[2 * kk + (e >> 2)][e & 3];
        hn[e] = col < d.E ? __fadd_rn(__fmul_rn(xv, __ldg(p.ln2g + col)), __ldg(p.ln2b + col)) : 0.f;
      }
      a_frag<8>(hna[kk], hn, 0);
    }
    if constexpr (kBwd) {
      // bf(hn) of the pair, for the w12 kernel; xhat kept for the LayerNorm backward
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!valid[r]) continue;
        uint32_t* row = reinterpret_cast<uint32_t*>(p.w.hn + ((size_t)b * d.G + gene[r]) * EP);
#pragma unroll
        for (int kk = 0; kk < KE; ++kk) {
          row[8 * kk + tq] = hna[kk][r];
          row[8 * kk + 4 + tq] = hna[kk][2 + r];
        }
      }
      float4* xs = at<float4>(smem, L.x) + wg * NE8 * 128 + t;
#pragma unroll
      for (int i = 0; i < NE8; ++i) xs[128 * i] = make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
    }

    // ---- the SwiGLU: [a | c] = bf(hn) bf(w12) 32 hidden columns at a time ----
    float mlp[2] = {0.f, 0.f};
    float dhn[EP / 2];
#pragma unroll
    for (int i = 0; i < EP / 2; ++i) dhn[i] = 0.f;
    for (int c = 0; c < d.nch; ++c) {
      const int tw = resident ? c : j * d.nch + c;
      const int slot = tw % d.nw;
      mbar_wait(bar_w + 8 * slot, (tw / d.nw) & 1);
      const uint32_t wsl = sb + L.w + slot * NB * kBox;
      float up[32];  // columns 0-31: a of hidden 32 c + col; 32-63: c of the same
      fence_acc(up);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KE; ++ks)
        if (ks < ke) wg_rs64<0>(up, hna[ks], kd(wsl, ks), ks > 0);
      wg_commit();
      wg_wait0();
      fence_acc(up);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hid = 32 * c + 8 * i + 2 * tq + (e & 1);
          const float wvh = hid < d.Hd ? __ldg(p.wv + hid) : 0.f;
          const float a = up[4 * i + e], cv = up[16 + 4 * i + e];
          const float sg = __frcp_rn(1.0f + expf(-a));
          const float sl = a * sg;
          if constexpr (!kBwd) {
            mlp[e >> 1] = fmaf(sl * cv, wvh, mlp[e >> 1]);
          } else {
            const float dg3 = dl[e >> 1] * wvh;
            up[4 * i + e] = dg3 * cv * (sg * (1.0f + a * (1.0f - sg)));
            up[16 + 4 * i + e] = dg3 * sl;
          }
        }
      if constexpr (kBwd) {
        // d(hn) += [da | dc] bf(w12)^T: three passes, k = the chunk's 64 columns,
        // half of them a batch (the fragments of all four k steps at once spill)
        float part[EP / 2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t a3[2][3][4];
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2) a_frag3<32>(a3[k2], up, 2 * half + k2);
          fence_acc(part);
          wg_fence();
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
            for (int q = 2; q >= 0; --q)
              wg_rs<EP, 1>(part, a3[k2][q], md(wsl, 2 * half + k2), half > 0 || k2 > 0 || q < 2);
          wg_commit();
          wg_wait0();
          fence_acc(part);
        }
#pragma unroll
        for (int i = 0; i < EP / 2; ++i) dhn[i] += part[i];
      }
      if (!resident && last_of_slot(cnt_w + slot, wg, t, kNWG) && tw + d.nw < n_w)
        issue_w<NB>((tw + d.nw) % d.nch, wsl, bar_w + 8 * slot, &wm, d.HdP);
    }

    if constexpr (!kBwd) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(lin[r] + mlp[r]);
        if (tq == 0 && valid[r]) p.out[(size_t)b * d.G + gene[r]] = v + __ldg(p.bmu);
      }
    } else {
      // ---- the LayerNorm backward to d(hh), with the dl wmu of the linear term ----
      const float4* xs = at<float4>(smem, L.x) + wg * NE8 * 128 + t;
#pragma unroll
      for (int i = 0; i < NE8; ++i) {
        const float4 v = xs[128 * i];
        x[i][0] = v.x, x[i][1] = v.y, x[i][2] = v.z, x[i][3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < EP / 2; ++i) dhn[i] = bfr(dhn[i]);  // the gradient of bf(hn)
#pragma unroll
      for (int i = 0; i < NE8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // dln2g += d(hn) xhat, dln2b += d(hn)
          const int col = 8 * i + 2 * tq + c;
          const float vg = col_sum(fmaf(dhn[4 * i + c], x[i][c], dhn[4 * i + 2 + c] * x[i][2 + c]));
          const float vb = col_sum(dhn[4 * i + c] + dhn[4 * i + 2 + c]);
          if (gq == 0) {
            vec[col] += vg;
            vec[EP + col] += vb;
          }
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int i = 0; i < NE8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * i + 2 * tq + c;
            float& v = dhn[4 * i + 2 * r + c];
            v *= col < d.E ? __ldg(p.ln2g + col) : 0.f;
            m1 += v;
            m2 = fmaf(v, x[i][2 * r + c], m2);
          }
        m1 = quad_sum(m1) / d.E;
        m2 = quad_sum(m2) / d.E;
#pragma unroll
        for (int i = 0; i < NE8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * i + 2 * tq + c;
            float& v = dhn[4 * i + 2 * r + c];
            v = col < d.E ? fmaf(dl[r], __ldg(p.wmu + col), rstd[r] * (v - m1 - x[i][2 * r + c] * m2))
                          : 0.f;
          }
        if (valid[r]) {
          float* row = p.w.dhh + ((size_t)b * d.G + gene[r]) * EP;
#pragma unroll
          for (int i = 0; i < NE8; ++i)
            *reinterpret_cast<float2*>(row + 8 * i + 2 * tq) =
                make_float2(dhn[4 * i + 2 * r], dhn[4 * i + 2 * r + 1]);
        }
      }
    }
  }

  if constexpr (kBwd) {
    // the CTA's vector sums: its warps' in warp order; dbmu from the lanes tq = 0
    float* red = at<float>(smem, L.red);
    const float s_ = col_sum(dbm);
    if (lane == 0) red[wg * 4 + warp] = s_;
    __syncthreads();
    const float* vec = at<float>(smem, L.vec);
    float* pv_ = p.w.part_v + (size_t)blockIdx.x * (3 * d.E + 1);
    for (int i = tid; i < 3 * d.E; i += kT2) {
      const int k = i / d.E, col = i % d.E;
      float acc = 0.f;
      for (int w = 0; w < kNWG * 4; ++w) acc += vec[(w * 3 + k) * EP + col];
      pv_[i] = acc;
    }
    if (tid == 0) {
      float acc = 0.f;
      for (int w = 0; w < kNWG * 4; ++w) acc += red[w];
      pv_[3 * d.E] = acc;
    }
  }
}

// -- the backward: dqp, per (gene tile, cell block) -----------------------------------

template <int EP>
__global__ void __launch_bounds__(128 * q_wg(EP / 64), 1)
tailw_qside(const __grid_constant__ CUtensorMap qpm, const __grid_constant__ CUtensorMap km,
            const __grid_constant__ CUtensorMap vm, const Dims d, const Ptrs p) {
  constexpr int NB = EP / 64, NE8 = EP / 8, kNWG = q_wg(NB);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sb = tc::smem_u32(smem);
  const uint32_t o_kv = kNWG * NB * kBox, o_pl = o_kv + kNS * 2 * NB * kBox;
  const uint32_t bar_qp = sb + o_pl + kNWG * 3 * NB * kBox, bar_kv = bar_qp + 8;
  uint32_t* cnt_kv = at<uint32_t>(smem, o_pl + kNWG * 3 * NB * kBox + 8 * (1 + kNS));
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int gt = blockIdx.x % d.n_gtq, cb = blockIdx.x / d.n_gtq;
  const int g0 = 64 * kNWG * gt, b0 = cb * d.Bq, nb = min(d.B, b0 + d.Bq) - b0;
  const KvSeq sq{b0, d.HT, d.nkt, d.nkt == 1 ? 1 : 2 * d.nkt};
  const int n_kv = nb * d.HT * sq.per_ht;

  if (tid == 0) {
    mbar_init(bar_qp, 1);
    for (int s = 0; s < kNS; ++s) mbar_init(bar_kv + 8 * s, 1), cnt_kv[s] = 0;
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_qp, kNWG * NB * kBox);
    for (int g = 0; g < kNWG; ++g)
      for (int j = 0; j < NB; ++j)
        tma_load(sb + (g * NB + j) * kBox, &qpm, 64 * j, g0 + 64 * g, bar_qp);
    for (int i = 0; i < min(kNS, n_kv); ++i) issue_kv<NB>(sq, i, sb + o_kv, bar_kv, &km, &vm);
  }
  int gene[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    gene[r] = g0 + 64 * wg + 16 * warp + gq + 8 * r;
    valid[r] = gene[r] < d.G;
    if (!valid[r]) gene[r] = d.G - 1;
  }
  const int ke = cdiv(d.E, 16);
  const uint32_t my_qp = sb + wg * NB * kBox, planes = sb + o_pl + wg * 3 * NB * kBox;
  uint8_t* planes_p = smem + o_pl + wg * 3 * NB * kBox;
  float acc[EP / 2];
#pragma unroll
  for (int i = 0; i < EP / 2; ++i) acc[i] = 0.f;
  mbar_wait(bar_qp, 0);
  int i_kv = 0;

  for (int j = 0; j < nb; ++j) {
    const int b = b0 + j;
    const long long row[2] = {(long long)b * d.G + gene[0], (long long)b * d.G + gene[1]};
    split_dhh<EP>(planes_p, p.w.dhh, row, valid, warp, gq, tq);
    fence_async_shared();
    named_sync(1 + wg, 128);
    float part[EP / 2];
#pragma unroll
    for (int i = 0; i < EP / 2; ++i) part[i] = 0.f;
    for (int ht = 0; ht < d.HT; ++ht) {
      const int h0 = ht * d.hpt, nh = min(d.hpt, d.H - h0);
      const int ks0 = (h0 * d.hd) / 16, ks1 = ((h0 + nh) * d.hd - 1) / 16;
      float m[2] = {0.f, 0.f}, l[2] = {1.f, 1.f}, D[2] = {0.f, 0.f};
      float* st = d.nkt > 1 ? p.w.stats + ((long long)(b * d.H + h0) * 3) * d.G : nullptr;
      if (st) {
#pragma unroll
        for (int r = 0; r < 2; ++r) m[r] = st[gene[r]], l[r] = st[d.G + gene[r]];
      }
      for (int pass = d.nkt == 1 ? 1 : 0; pass < 2; ++pass) {
        for (int kt = 0; kt < d.nkt; ++kt, ++i_kv) {
          const int slot = i_kv % kNS;
          mbar_wait(bar_kv + 8 * slot, (i_kv / kNS) & 1);
          const uint32_t keys = sb + o_kv + slot * 2 * NB * kBox, vals = keys + NB * kBox;
          const Cols cols = cols_of(d, ht, kt);
          float s[32], dp[32];
          scores(s, my_qp, keys, ks0, ks1);
          if (d.nkt == 1) softmax_tile(s, cols, d.scale, tq);
          else probs_tile(s, cols.nkeys, d.scale, tq, m, l);
          dp_of<NB>(dp, planes, vals, ke);
          if (pass == 0) {
            d_part(dp, s, D);
          } else {
            ds_of(dp, s, D, d.nkt == 1, cols.sh, d.scale);
            // dqp += ds bf(kfull_h): three passes, k = the tile's keys
            uint32_t a3[4][3][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) a_frag3<32>(a3[kk], dp, kk);
            fence_acc(part);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              if (16 * kk < cols.ncols())
#pragma unroll
                for (int q = 2; q >= 0; --q) wg_rs<EP, 1>(part, a3[kk][q], md(keys, kk), 1);
            wg_commit();
            wg_wait0();
            fence_acc(part);
          }
          if (last_of_slot(cnt_kv + slot, wg, tid & 127, kNWG) && i_kv + kNS < n_kv)
            issue_kv<NB>(sq, i_kv + kNS, sb + o_kv, bar_kv, &km, &vm);
        }
        if (pass == 0 && tq == 0) {  // D of each row, for the k-side kernels
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (valid[r]) st[2 * d.G + gene[r]] = D[r];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < EP / 2; ++i) acc[i] += part[i];
  }
  float* out = p.w.part_qp + (size_t)cb * d.G * d.E;
#pragma unroll
  for (int i = 0; i < NE8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + 2 * tq + (e & 1), r = e >> 1;
      if (valid[r] && col < d.E) out[(size_t)gene[r] * d.E + col] = acc[4 * i + e];
    }
}

// -- the backward: dvproj and dkfull, per (cell, head, key tile, gene chunk) -------

template <int NB>
struct KSmem {
  static constexpr int keys = 0, vals = NB * kBox, qp = vals + NB * kBox, planes = qp + 2 * NB * kBox,
                       pt = planes + 3 * NB * kBox, dsp = pt + kBox, bar = dsp + 3 * kBox,
                       total = bar + 64 + 1024;
};

template <int EP>
__global__ void __launch_bounds__(128, 1)
tailw_kside(const __grid_constant__ CUtensorMap qpm, const __grid_constant__ CUtensorMap km,
            const __grid_constant__ CUtensorMap vm, const Dims d, const Ptrs p) {
  constexpr int NB = EP / 64, NE8 = EP / 8;
  using L = KSmem<NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sb = tc::smem_u32(smem);
  const uint32_t bar_kv = sb + L::bar, bar_qp = bar_kv + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int ch = blockIdx.x % d.n_gch, rest = blockIdx.x / d.n_gch;
  const int kt = rest % d.nkt, bt = rest / d.nkt, ht = bt % d.HT, b = bt / d.HT;
  const int h0 = ht * d.hpt, nh = min(d.hpt, d.H - h0);
  const int t0 = ch * d.tpc, nt = min(d.n_gt, t0 + d.tpc) - t0;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_qp, 1);
    mbar_init(bar_qp + 8, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * NB * kBox);
    for (int j = 0; j < NB; ++j) {
      tma_load3(sb + L::keys + j * kBox, &km, 64 * j, 64 * kt, bt, bar_kv);
      tma_load3(sb + L::vals + j * kBox, &vm, 64 * j, 64 * kt, bt, bar_kv);
    }
    for (int li = 0; li < min(2, nt); ++li) {
      mbar_expect_tx(bar_qp + 8 * li, NB * kBox);
      for (int j = 0; j < NB; ++j)
        tma_load(sb + L::qp + (li * NB + j) * kBox, &qpm, 64 * j, 64 * (t0 + li), bar_qp + 8 * li);
    }
  }
  const int ke = cdiv(d.E, 16);
  const Cols cols = cols_of(d, ht, kt);
  const int ks0 = (h0 * d.hd) / 16, ks1 = ((h0 + nh) * d.hd - 1) / 16;
  const uint32_t keys = sb + L::keys, vals = sb + L::vals, planes = sb + L::planes;
  const uint32_t pt = sb + L::pt, dsp = sb + L::dsp;
  const float* st = d.nkt > 1 ? p.w.stats + ((long long)(b * d.H + h0) * 3) * d.G : nullptr;
  float acc_v[EP / 2], acc_k[EP / 2];
#pragma unroll
  for (int i = 0; i < EP / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int li = 0; li < nt; ++li) {
    const int slot = li & 1, g0 = 64 * (t0 + li);
    mbar_wait(bar_qp + 8 * slot, (li >> 1) & 1);
    const uint32_t qp = sb + L::qp + slot * NB * kBox;
    int gene[2];
    bool valid[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      gene[r] = g0 + 16 * warp + gq + 8 * r;
      valid[r] = gene[r] < d.G;
      if (!valid[r]) gene[r] = d.G - 1;
    }
    const long long row[2] = {(long long)b * d.G + gene[0], (long long)b * d.G + gene[1]};
    split_dhh<EP>(smem + L::planes, p.w.dhh, row, valid, warp, gq, tq);
    float s[32];
    scores(s, qp, keys, ks0, ks1);
    float m[2] = {0.f, 0.f}, l[2] = {1.f, 1.f}, D[2] = {0.f, 0.f};
    if (st) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = st[gene[r]], l[r] = st[d.G + gene[r]], D[r] = st[2 * d.G + gene[r]];
      }
    }
    if (d.nkt == 1) softmax_tile(s, cols, d.scale, tq);
    else probs_tile(s, cols.nkeys, d.scale, tq, m, l);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (!valid[r])
#pragma unroll
        for (int i = 0; i < 8; ++i) s[4 * i + 2 * r] = s[4 * i + 2 * r + 1] = 0.f;
    // bf(p) [genes][keys]: P^T's MN-major A
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *at<uint32_t>(smem + L::pt, sw(16 * warp + gq + 8 * r, 8 * i + 2 * tq)) =
            tc::pack_bf16(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
    fence_async_shared();
    __syncthreads();  // d(hh)'s planes and bf(p) are written
    float dp[32];
    dp_of<NB>(dp, planes, vals, ke);
    ds_of(dp, s, D, d.nkt == 1, cols.sh, d.scale);
    // ds's planes [genes][keys]: ds^T's MN-major A
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t hi, mid, lo;
        tc::split3_bf16(dp[4 * i + 2 * r], dp[4 * i + 2 * r + 1], hi, mid, lo);
        const uint32_t off = sw(16 * warp + gq + 8 * r, 8 * i + 2 * tq);
        *at<uint32_t>(smem + L::dsp, off) = hi;
        *at<uint32_t>(smem + L::dsp, kBox + off) = mid;
        *at<uint32_t>(smem + L::dsp, 2 * kBox + off) = lo;
      }
    fence_async_shared();
    __syncthreads();
    // dvproj (keys x E) += bf(p)^T d(hh), then dkfull (keys x E) += ds^T bf(qp);
    // each summed from zero over the tile's 64 genes and added in f32
    float part[EP / 2];
    fence_acc(part);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 2; q >= 0; --q)
        wg_ss<EP, 1, 1>(part, md(pt, kk), md(planes + q * NB * kBox, kk), kk > 0 || q < 2);
    wg_commit();
    wg_wait0();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < EP / 2; ++i) acc_v[i] += part[i];
    fence_acc(part);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 2; q >= 0; --q)
        wg_ss<EP, 1, 1>(part, md(dsp + q * kBox, kk), md(qp, kk), kk > 0 || q < 2);
    wg_commit();
    wg_wait0();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < EP / 2; ++i) acc_k[i] += part[i];
    __syncthreads();  // the qp slot, the planes, bf(p) and ds are free
    if (tid == 0 && li + 2 < nt) {
      mbar_expect_tx(bar_qp + 8 * slot, NB * kBox);
      for (int j = 0; j < NB; ++j)
        tma_load(qp + j * kBox, &qpm, 64 * j, 64 * (t0 + li + 2), bar_qp + 8 * slot);
    }
  }

  // row r of the accumulators: key r % (8 << sh) of the tile's head r >> (sh + 3)
  // (one head, key 64 kt + r, at one head a tile)
  const long long HM = (long long)d.H * d.M;
#pragma unroll
  for (int i = 0; i < NE8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + gq + 8 * (e >> 1), col = 8 * i + 2 * tq + (e & 1);
      const int h = h0 + (r >> (cols.sh + 3));
      const int mkey = d.hpt > 1 ? (r & (d.MP - 1)) : 64 * kt + r;
      if (!cols.ok(r) || col >= d.E) continue;
      const long long rowi = ((long long)ch * d.B + b) * HM + (long long)h * d.M + mkey;
      p.w.part_dv[rowi * d.E + col] = acc_v[4 * i + e];
      const int dd = col - h * d.hd;
      if (dd >= 0 && dd < d.hd) p.w.part_dk[rowi * d.hd + dd] = acc_k[4 * i + e];
    }
}

// -- the backward: dw12 and dwv, per (32 hidden columns, pair chunk) ------------------

template <int NB>
struct WSmem {
  static constexpr int w = 0, hn = NB * kBox, planes = hn + 2 * NB * kBox, red = planes + 3 * kBox,
                       bar = red + 4 * 32 * 4, total = bar + 64 + 1024;
};

template <int EP>
__global__ void __launch_bounds__(128, 1)
tailw_w12(const __grid_constant__ CUtensorMap hnm, const __grid_constant__ CUtensorMap wm,
          const Dims d, const Ptrs p) {
  constexpr int NB = EP / 64, NE8 = EP / 8;
  using L = WSmem<NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sb = tc::smem_u32(smem);
  const uint32_t bar_w = sb + L::bar, bar_hn = bar_w + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int hc = blockIdx.x % d.nch, pc = blockIdx.x / d.nch;
  const int t0 = pc * d.ppc, nt = min(d.n_pt, t0 + d.ppc) - t0;

  if (tid == 0) {
    mbar_init(bar_w, 1);
    mbar_init(bar_hn, 1);
    mbar_init(bar_hn + 8, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    issue_w<NB>(hc, sb + L::w, bar_w, &wm, d.HdP);
    for (int li = 0; li < min(2, nt); ++li) {
      mbar_expect_tx(bar_hn + 8 * li, NB * kBox);
      for (int j = 0; j < NB; ++j)
        tma_load(sb + L::hn + (li * NB + j) * kBox, &hnm, 64 * j, 64 * (t0 + li), bar_hn + 8 * li);
    }
  }
  const int ke = cdiv(d.E, 16);
  float wvh[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int hid = 32 * hc + 8 * (e >> 1) + 2 * tq + (e & 1);
    wvh[e] = hid < d.Hd ? __ldg(p.wv + hid) : 0.f;
  }
  float acc[EP / 2], vw[8];
#pragma unroll
  for (int i = 0; i < EP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) vw[e] = 0.f;
  const uint32_t wsl = sb + L::w, planes = sb + L::planes;
  mbar_wait(bar_w, 0);

  for (int li = 0; li < nt; ++li) {
    const int slot = li & 1;
    mbar_wait(bar_hn + 8 * slot, (li >> 1) & 1);
    const uint32_t hn = sb + L::hn + slot * NB * kBox;
    float up[32];
    fence_acc(up);
    wg_fence();
    for (int ks = 0; ks < ke; ++ks) wg_ss64<0, 0>(up, kd(hn, ks), kd(wsl, ks), ks > 0);
    wg_commit();
    wg_wait0();
    fence_acc(up);
    const long long pr0 = 64LL * (t0 + li) + 16 * warp + gq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long pr = pr0 + 8 * r;
      const float dl = pr < d.P ? __ldg(p.dy + pr) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float da[2], dc[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float a = up[4 * i + 2 * r + c], cv = up[16 + 4 * i + 2 * r + c];
          const float sg = __frcp_rn(1.0f + expf(-a));
          const float sl = a * sg;
          vw[2 * i + c] = fmaf(dl, sl * cv, vw[2 * i + c]);
          const float dg3 = dl * wvh[2 * i + c];
          da[c] = dg3 * cv * (sg * (1.0f + a * (1.0f - sg)));
          dc[c] = dg3 * sl;
        }
        const int R = 16 * warp + gq + 8 * r, col = 8 * i + 2 * tq;
        uint32_t hi, mid, lo;
        tc::split3_bf16(da[0], da[1], hi, mid, lo);
        *at<uint32_t>(smem + L::planes, sw(R, col)) = hi;
        *at<uint32_t>(smem + L::planes, kBox + sw(R, col)) = mid;
        *at<uint32_t>(smem + L::planes, 2 * kBox + sw(R, col)) = lo;
        tc::split3_bf16(dc[0], dc[1], hi, mid, lo);
        *at<uint32_t>(smem + L::planes, sw(R, 32 + col)) = hi;
        *at<uint32_t>(smem + L::planes, kBox + sw(R, 32 + col)) = mid;
        *at<uint32_t>(smem + L::planes, 2 * kBox + sw(R, 32 + col)) = lo;
      }
    }
    fence_async_shared();
    __syncthreads();
    // dw12^T (64 columns x E) += [da | dc]^T bf(hn): k = the 64 pairs
    float part[EP / 2];
    fence_acc(part);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 2; q >= 0; --q)
        wg_ss<EP, 1, 1>(part, md(planes + q * kBox, kk), md(hn, kk), kk > 0 || q < 2);
    wg_commit();
    wg_wait0();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < EP / 2; ++i) acc[i] += part[i];
    __syncthreads();  // the hn slot and the planes are free
    if (tid == 0 && li + 2 < nt) {
      mbar_expect_tx(bar_hn + 8 * slot, NB * kBox);
      for (int j = 0; j < NB; ++j)
        tma_load(hn + j * kBox, &hnm, 64 * j, 64 * (t0 + li + 2), bar_hn + 8 * slot);
    }
  }

  // dw12 (E, 2 Hd): row j of the accumulator is w1's hidden 32 hc + j (j < 32)
  // or w2's 32 hc + j - 32
  float* pw = p.w.part_w + (size_t)pc * d.E * 2 * d.Hd;
#pragma unroll
  for (int i = 0; i < NE8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jr = 16 * warp + gq + 8 * (e >> 1), col = 8 * i + 2 * tq + (e & 1);
      const int hid = 32 * hc + (jr & 31);
      if (hid < d.Hd && col < d.E) pw[(size_t)col * 2 * d.Hd + (jr < 32 ? 0 : d.Hd) + hid] = acc[4 * i + e];
    }
  float* red = at<float>(smem, L::red);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float v = col_sum(vw[e]);
    if (gq == 0) red[warp * 32 + 8 * (e >> 1) + 2 * tq + (e & 1)] = v;
  }
  __syncthreads();
  if (tid < 32 && 32 * hc + tid < d.Hd) {
    const float v = red[tid] + red[32 + tid] + red[64 + tid] + red[96 + tid];
    p.w.part_wv[(size_t)pc * d.Hd + 32 * hc + tid] = v;
  }
}

// -- packing and the fixed-order sums ---------------------------------------------------

// qp, kfull, vproj (rows of E) and w12^T (w1's rows, then w2's at HdP) to bf16,
// E padded to EP and w12^T's rows to HdP with zeros; kfull and vproj in head
// tiles: (cell, head tile, row r < R), row r holding head hpt ht + r / MP's key
// r % MP (at one head a tile, key r)
__global__ void __launch_bounds__(256)
tailw_pack(const float* __restrict__ qp, const float* __restrict__ kfull,
           const float* __restrict__ vproj, const float* __restrict__ w12, const Dims d, Work w) {
  const long long n0 = (long long)d.G * d.EP, n1 = (long long)d.B * d.HT * d.R * d.EP;
  const long long n3 = 2LL * d.HdP * d.EP, total = n0 + 2 * n1 + n3;
  // eight values of one row a thread (every row is EP long, EP a multiple of 8)
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; 8 * i < total;
       i += (long long)gridDim.x * 256) {
    long long k = 8 * i;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int e0 = (int)(k & (d.EP - 1));  // EP: 64 or 128
    __nv_bfloat16* dst;
    if (k < n0) {
      const float* src = qp + (k >> (d.NB + 5)) * d.E;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (e0 + j < d.E) v[j] = src[e0 + j];
      dst = w.qpb + k;
    } else if ((k -= n0) < 2 * n1) {
      const bool val = k >= n1;
      if (val) k -= n1;
      const int row = (int)(k >> (d.NB + 5));
      const int bt = row / d.R, r = row - bt * d.R;
      const int h = (bt % d.HT) * d.hpt + (d.hpt > 1 ? r / d.MP : 0);
      const int m = d.hpt > 1 ? r % d.MP : r;
      if (h < d.H && m < d.M) {
        const float* src = (val ? vproj : kfull) +
                           ((long long)(bt / d.HT) * d.H * d.M + (long long)h * d.M + m) * d.E;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (e0 + j < d.E) v[j] = src[e0 + j];
      }
      dst = (val ? w.vb : w.kb) + k;
    } else {
      k -= 2 * n1;
      const int row = (int)(k >> (d.NB + 5));
      const int half = row >= d.HdP, hid = row - half * d.HdP;
      if (hid < d.Hd)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (e0 + j < d.E) v[j] = w12[(long long)(e0 + j) * 2 * d.Hd + half * d.Hd + hid];
      dst = w.wt + k;
    }
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]), tc::pack_bf16(v[4], v[5]),
                   tc::pack_bf16(v[6], v[7]));
  }
}

// out[r * out_ld + c + off(r)] = sum over q < P of part[q * pstride + r * in_ld + c],
// r < n / cols, c < cols; off(r) = ((r % band_a) / band_b) * band_c where band_a > 0
struct Sum {
  const float* part;
  float* out;
  long long n, pstride, first;
  int P, cols, in_ld, out_ld, band_a, band_b, band_c;
};
struct Sums {
  Sum job[8];
  int n;
};

__global__ void __launch_bounds__(256) tailw_sums(const __grid_constant__ Sums s) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  int j = 0;
  while (j + 1 < s.n && idx >= s.job[j + 1].first) ++j;
  const Sum& jb = s.job[j];
  const long long i = idx - jb.first;
  if (i >= jb.n) return;
  const long long r = i / jb.cols, c = i % jb.cols;
  const float* src = jb.part + r * jb.in_ld + c;
  float acc = 0.f;
  for (int q = 0; q < jb.P; ++q) acc += src[q * jb.pstride];
  const long long off = jb.band_a > 0 ? ((r % jb.band_a) / jb.band_b) * jb.band_c : 0;
  jb.out[r * jb.out_ld + c + off] = acc;
}

cudaError_t launch_sums(Sums s, cudaStream_t stream) {
  long long total = 0;
  for (int j = 0; j < s.n; ++j) {
    s.job[j].first = total;
    total += s.job[j].n;
  }
  if (total == 0) return cudaSuccess;
  tailw_sums<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(s);
  return cudaGetLastError();
}

Sum flat(const float* part, float* out, long long n, int P, long long pstride) {
  return Sum{part, out, n, pstride, 0, P, (int)(n > 0 ? n : 1), 0, 0, 0, 1, 0};
}

// -- tensor maps and launches -----------------------------------------------------------

struct Maps {
  CUtensorMap qp, k, v, w, hn;
};

bool make_maps(const Dims& d, const Work& w, bool bwd, Maps* m) {
  const long long BT = (long long)d.B * d.HT;
  return make_map(&m->qp, w.qpb, 2, d.EP, d.G, 1, 64) &&
         make_map(&m->k, w.kb, 3, d.EP, d.R, BT, 64) && make_map(&m->v, w.vb, 3, d.EP, d.R, BT, 64) &&
         make_map(&m->w, w.wt, 2, d.EP, 2LL * d.HdP, 1, 32) &&
         (!bwd || make_map(&m->hn, w.hn, 2, d.EP, d.P, 1, 64));
}

template <class K>
cudaError_t allow(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t pack(const Dims& d, const Work& w, const float* qp, const float* kfull,
                 const float* vproj, const float* w12, cudaStream_t s) {
  const long long total = (long long)d.G * d.EP + 2LL * d.B * d.HT * d.R * d.EP + 2LL * d.HdP * d.EP;
  const long long blocks = cdiv(total / 8, 256);
  tailw_pack<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(qp, kfull, vproj, w12, d, w);
  return cudaGetLastError();
}

template <int EP>
cudaError_t forward_ep(const Dims& d, const Maps& m, const Ptrs& p, cudaStream_t s) {
  const int smem = rows_smem(EP / 64, d.nw, false).total;
  cudaError_t err = allow(tailw_rows<EP, false>, smem);
  if (err != cudaSuccess) return err;
  tailw_rows<EP, false><<<d.n_gtr * d.n_cb, 128 * rows_wg(EP / 64, false), smem, s>>>(m.qp, m.k, m.v,
                                                                                  m.w, d, p);
  return cudaGetLastError();
}

template <int EP>
cudaError_t backward_ep(const Dims& d, const Maps& m, const Ptrs& p, cudaStream_t s) {
  constexpr int NB = EP / 64;
  cudaError_t err;
  {
    const int smem = rows_smem(NB, d.nw, true).total;
    if ((err = allow(tailw_rows<EP, true>, smem)) != cudaSuccess) return err;
    tailw_rows<EP, true><<<d.n_gtr * d.n_cb, 128 * rows_wg(NB, true), smem, s>>>(m.qp, m.k, m.v, m.w,
                                                                               d, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const int smem = (q_wg(NB) * 4 + kNS * 2) * NB * kBox + 128 + 1024;
    if ((err = allow(tailw_qside<EP>, smem)) != cudaSuccess) return err;
    tailw_qside<EP><<<d.n_gtq * d.n_cbq, 128 * q_wg(NB), smem, s>>>(m.qp, m.k, m.v, d, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const int smem = KSmem<NB>::total;
    if ((err = allow(tailw_kside<EP>, smem)) != cudaSuccess) return err;
    tailw_kside<EP><<<d.B * d.HT * d.nkt * d.n_gch, 128, smem, s>>>(m.qp, m.k, m.v, d, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  {
    const int smem = WSmem<NB>::total;
    if ((err = allow(tailw_w12<EP>, smem)) != cudaSuccess) return err;
    tailw_w12<EP><<<d.nch * d.n_pc, 128, smem, s>>>(m.hn, m.w, d, p);
    return cudaGetLastError();
  }
}

}  // namespace
}  // namespace tailw

extern "C" {

// Whether the any-width kernels take (E, H, M, Hd): E from 1 to 128, H
// dividing E, any number of latent tokens, any hidden width.
int scldm_decoder_tail_gen_takes(int E, int H, int M, int Hd) {
  return E >= 1 && E <= 128 && H >= 1 && E % H == 0 && M >= 1 && Hd >= 1;
}

// Floats of the forward's (backward = 0) or the backward's device workspace:
// the packed operands, and for the backward d(hh) and bf(hn) of every pair,
// the softmax statistics past 64 keys and the partials. 0 for a shape the
// kernels do not take.
long long scldm_decoder_tail_gen_workspace_floats(int B, int G, int E, int H, int M, int Hd,
                                                  int backward) {
  if (!scldm_decoder_tail_gen_takes(E, H, M, Hd) || B <= 0 || G <= 0) return 0;
  long long bytes = 0;
  tailw::carve(tailw::make_dims(B, G, E, H, M, Hd, 0.f, 1.f, backward != 0), nullptr,
               backward != 0, &bytes);
  return bytes / 4;
}

// Forward: out (B, G) f32 logits, as scldm_decoder_tail_forward, with a
// workspace of scldm_decoder_tail_gen_workspace_floats(..., 0) floats: the
// packer, then the rows kernel.
int scldm_decoder_tail_gen_forward(const void* qp, const void* q, const void* kfull,
                                   const void* vproj, const void* ln2g, const void* ln2b,
                                   const void* w12, const void* wv, const void* wmu,
                                   const void* bmu, void* out, void* workspace, int B, int G,
                                   int E, int H, int M, int Hd, float eps, float scale,
                                   void* stream) {
  if (B == 0 || G == 0) return 0;
  if (!scldm_decoder_tail_gen_takes(E, H, M, Hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const tailw::Dims d = tailw::make_dims(B, G, E, H, M, Hd, eps, scale, false);
  long long bytes = 0;
  const tailw::Work w = tailw::carve(d, workspace, false, &bytes);
  tailw::Ptrs p{(const float*)q, (const float*)ln2g, (const float*)ln2b, (const float*)wv,
                (const float*)wmu, (const float*)bmu, nullptr, (float*)out, w};
  cudaError_t err = tailw::pack(d, w, (const float*)qp, (const float*)kfull, (const float*)vproj,
                                (const float*)w12, s);
  if (err != cudaSuccess) return (int)err;
  tailw::Maps m;
  if (!tailw::make_maps(d, w, false, &m)) return (int)cudaErrorInvalidValue;
  return (int)(d.EP == 64 ? tailw::forward_ep<64>(d, m, p, s) : tailw::forward_ep<128>(d, m, p, s));
}

// Backward, as scldm_decoder_tail_backward (qq = dqp | dq, dkfull's head
// blocks, the caller zeroing the rest, dvproj, wvec), with a workspace of
// scldm_decoder_tail_gen_workspace_floats(..., 1) floats: the packer, the rows,
// q-side, k-side and w12 kernels, and the fixed-order sums.
int scldm_decoder_tail_gen_backward(const void* qp, const void* q, const void* kfull,
                                    const void* vproj, const void* ln2g, const void* ln2b,
                                    const void* w12, const void* wv, const void* wmu,
                                    const void* dy, void* qq, void* dkfull, void* dvproj,
                                    void* wvec, void* workspace, int B, int G, int E, int H, int M,
                                    int Hd, float eps, float scale, void* stream) {
  if (B == 0 || G == 0) return 0;
  if (!scldm_decoder_tail_gen_takes(E, H, M, Hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const tailw::Dims d = tailw::make_dims(B, G, E, H, M, Hd, eps, scale, true);
  long long bytes = 0;
  const tailw::Work w = tailw::carve(d, workspace, true, &bytes);
  tailw::Ptrs p{(const float*)q, (const float*)ln2g, (const float*)ln2b, (const float*)wv,
                (const float*)wmu, nullptr, (const float*)dy, nullptr, w};
  cudaError_t err = tailw::pack(d, w, (const float*)qp, (const float*)kfull, (const float*)vproj,
                                (const float*)w12, s);
  if (err != cudaSuccess) return (int)err;
  tailw::Maps m;
  if (!tailw::make_maps(d, w, true, &m)) return (int)cudaErrorInvalidValue;
  err = d.EP == 64 ? tailw::backward_ep<64>(d, m, p, s) : tailw::backward_ep<128>(d, m, p, s);
  if (err != cudaSuccess) return (int)err;
  // wvec = dw12 | dln2g | dln2b | dwmu | dwv | dbmu; the rows kernel's vector
  // partials are dln2g | dln2b | dwmu | dbmu
  const long long GE = (long long)G * E, HM = (long long)H * M, n12 = (long long)E * 2 * Hd;
  const int hd = E / H, units = d.n_gtr * d.n_cb;
  float* out_w = (float*)wvec;
  tailw::Sums sums{};
  sums.job[0] = tailw::flat(w.part_qp, (float*)qq, GE, d.n_cbq, GE);
  // dq: d(hh) summed over the cells, rows of EP into rows of E
  sums.job[1] = tailw::Sum{w.dhh, (float*)qq + GE, GE, GE * d.EP / E, 0, B, E, d.EP, E, 0, 1, 0};
  sums.job[2] = tailw::flat(w.part_dv, (float*)dvproj, (long long)B * HM * E, d.n_gch,
                            (long long)B * HM * E);
  // dkfull: the compact (cell, row hm, d) head blocks into (cell, hm, E) at head hm / M
  sums.job[3] = tailw::Sum{w.part_dk, (float*)dkfull, (long long)B * HM * hd,
                           (long long)B * HM * hd, 0, d.n_gch, hd, hd, E, (int)HM, M, hd};
  sums.job[4] = tailw::flat(w.part_w, out_w, n12, d.n_pc, n12);
  sums.job[5] = tailw::flat(w.part_wv, out_w + n12 + 3LL * E, Hd, d.n_pc, Hd);
  sums.job[6] = tailw::flat(w.part_v, out_w + n12, 3LL * E, units, 3LL * E + 1);
  sums.job[7] = tailw::flat(w.part_v + 3LL * E, out_w + n12 + 3LL * E + Hd, 1, units, 3LL * E + 1);
  sums.n = 8;
  return (int)tailw::launch_sums(sums, s);
}

}  // extern "C"
