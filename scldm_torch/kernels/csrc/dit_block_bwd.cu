// The recompute backward of one adaLN-zero DiT block, f32: the forward's
// tiled stages recomputed into a workspace, then the backward on the same
// tensor-core GEMM, a streaming attention backward and per-token LayerNorm
// kernels, and the weight gradients as tensor-core GEMMs over the token axis.
// One design for every T.
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
// What bounds it on an H100: operations. The recompute, the backward's token
// products and the weight gradients are each about the forward's operations
// (10 GFLOP per block at the dentate LDM step's R = 128 rows of T = 16
// tokens, E = 256, Hd = 684; 5 GFLOP at the census step's R = 16 rows of T =
// 64; 99 GFLOP at the long-latent R = 16 rows of T = 1,024, where the
// attention's T^2 terms dominate), every product run as three TF32
// tensor-core passes: 3 x 3 x 3.3 GFLOP at 495 TFLOP/s, 0.06 ms at the
// dentate shape.
//
// What the design does about it (dit_tiled.cuh holds the shared stages):
// - The forward is recomputed with row 1's own stages (silu, the adaLN
//   product, the LayerNorms, the qkv, projection, SwiGLU and down products
//   on `tiled::gemm`, the streaming attention at every T, which here also
//   writes each query's log-sum-exp), keeping what the backward reads in the
//   workspace (`carve`): silu(c), mod, h, qkv, the attention output, proj,
//   x1, h2, [a | b], silu(a) b and the MLP output m.
// - The backward's token products run on the same GEMM, reading the weights
//   in nn.Linear's (out, in) layout: dm -> d[a | b] through wmlp (the SwiGLU
//   backward in the epilogue), d(h2) through [w1 | w2], d(attention output)
//   through wproj and dh through wqkv.
// - The attention backward streams 64-token tiles, its softmax statistics
//   from the recompute: `attention_dq` per (query tile, head) takes dq and
//   each query's delta = do . o; `attention_dkv` per (key tile, head) takes dk
//   and dv over the query tiles of its keys' rows. No atomics; a key scores
//   -inf outside its query's DiT row where one tile spans rows (T = 16).
// - `ln_bwd` (one warp a token, one CTA per row and 16 tokens) takes the two
//   LayerNorm-and-modulation backwards and the residual around the
//   attention branch, and its CTA's share of dmod's sums over tokens to a
//   partial; `sum_parts` adds the partials in order and `dc_rows` takes dc
//   through wada, both in f64 (|dc| reaches a few hundred at T = 1,024).
// - The weight gradients are U^T V over the token axis in one launch
//   (`tiled::grad_gemm`, dit_tiled.cuh, shared with the trunk backward): K =
//   R*T (2,048, 1,024 and 16,384 tokens at the three shapes; R for the adaLN
//   product) is cut into chunks where the output tiles are too few to fill
//   the card, each chunk's partial summed by `grad_reduce` in order; each
//   32-deep stage is summed from zero and added in f32; the bias gradients
//   are column sums of U.
// No atomics: every sum is taken in a fixed order, the same bits every run.
//
// Shared memory a CTA, in floats: the GEMMs 3 * (64 * 36 + 32 * 72), the
// attention 5 * 64 * (DP + 4) and its backward 6 * 64 * (DP + 4) + 4 * 64 (DP
// the head width padded to 16, 32 or 64), ln_bwd 8 * 4 * E; dc_rows 4 * 6E +
// 2,048 doubles; none grows with T. Requires E <= 512, Hd % 4 == 0 and a
// head width that is a multiple of 4 up to 64 (the wrapper checks;
// cudaErrorInvalidValue otherwise).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "dit_tiled.cuh"

namespace {

using dit::allow_smem;
using dit::SmemAllowance;
using dit::warp_sum;
using tiled::kGradSplits;
using tiled::kQ;
using tiled::kThreads;

constexpr int kTok = 16;          // tokens of one DiT row a CTA of ln_bwd takes
constexpr int kLnBwdWarps = 8;    // its warps, two tokens each
constexpr int kMaxVec = 4;        // float4s a lane of a token: E <= 512
constexpr int kDcRows = 4;        // rows a CTA of dc_rows
constexpr int kDcWarps = 16;      // its warps, each a sixteenth of the depth 6E

// The workspace's slots, each (tokens, width) row-major, or (rows, width).
struct Workspace {
  float* cs;     // (R, E)    silu(c)
  float* mod;    // (R, 6E)   mod
  float* dmod;   // (R, 6E)   dmod
  float* parts;  // (R, nt, 6E) each ln_bwd CTA's share of dmod
  float* lse;    // (N, H)    each query's log-sum-exp, base 2
  float* delta;  // (N, H)    each query's do . o
  float* h;      // (N, E)    h, the input of wqkv
  float* qkv;    // (N, 3E)
  float* attn;   // (N, E)    the attention output, the input of wproj
  float* proj;   // (N, E)    attn @ wproj + bproj
  float* x1;     // (N, E)
  float* h2;     // (N, E)    the input of w1 and w2
  float* ab;     // (N, 2Hd)  [a | b], then [da | db]
  float* g;      // (N, Hd)   silu(a) * b, the input of wmlp
  float* m;      // (N, E)    g @ wmlp
  float* dm;     // (N, E)    dy * gate_m
  float* dh;     // (N, E)    d(h2), then dh
  float* dproj;  // (N, E)
  float* dattn;  // (N, E)    d(attention output)
  float* dqkv;   // (N, 3E)
  float* grads;  // (kGradSplits, the weight gradients' P * Q + P) chunk partials
};

// P * Q + P of the five weight-gradient jobs: wada, wqkv, wproj, w1 | w2, wmlp
__host__ __device__ inline size_t grad_floats(int E, int Hd) {
  return (size_t)6 * E * E + 6 * E + 3 * E * E + 3 * E + E * E + E + 2 * Hd * E + 2 * Hd +
         (size_t)E * Hd + E;
}

// Carves the slots out of `ws` in the order above, each rounded up to 4
// floats (16-byte vectors); returns the floats they take before the weight
// gradients' partials (`ws` may be null to count them).
inline size_t carve(float* ws, int R, int T, int E, int H, int Hd, Workspace& w) {
  const size_t N = (size_t)R * T, nt = (T + kTok - 1) / kTok;
  size_t at = 0;
  auto take = [&](size_t n) {
    float* p = ws != nullptr ? ws + at : nullptr;
    at += (n + 3) & ~(size_t)3;
    return p;
  };
  w.cs = take((size_t)R * E);
  w.mod = take((size_t)R * 6 * E);
  w.dmod = take((size_t)R * 6 * E);
  w.parts = take(R * nt * 6 * E);
  w.lse = take(N * H);
  w.delta = take(N * H);
  w.h = take(N * E);
  w.qkv = take(N * 3 * E);
  w.attn = take(N * E);
  w.proj = take(N * E);
  w.x1 = take(N * E);
  w.h2 = take(N * E);
  w.ab = take(N * 2 * Hd);
  w.g = take(N * Hd);
  w.m = take(N * E);
  w.dm = take(N * E);
  w.dh = take(N * E);
  w.dproj = take(N * E);
  w.dattn = take(N * E);
  w.dqkv = take(N * 3 * E);
  w.grads = ws != nullptr ? ws + at : nullptr;
  return at;
}

size_t workspace_floats(int R, int T, int E, int H, int Hd) {
  Workspace w;
  return carve(nullptr, R, T, E, H, Hd, w) + kGradSplits * grad_floats(E, Hd);
}

// -- the attention backward ----------------------------------------------------------
//
// Both kernels take one head and 64 tokens of the flattened token axis a CTA
// (one warp 16), stream the other side's 64-token tiles over the DiT rows
// their tokens lie in through a cp.async ring, and run every product as
// three TF32 passes; a pair scores -inf unless query and key lie in one row,
// and 8-token blocks that share no row with a warp's tokens are skipped. The
// head width is zero-padded to DP. Each tile's products are summed from zero
// and added in f32. With s = q . k * scale (scale_log2 = log2(e) * scale), p
// = exp2(s * log2(e) - lse) and delta = do . o:
//   dq = scale * sum_k p (do . v - delta) k,   dk = scale * sum_q p (do . v - delta) q,
//   dv = sum_q p do.

__host__ __device__ constexpr int attn_bwd_smem_floats(int DP) {
  return 6 * kQ * tiled::attn_ld(DP) + 4 * kQ;
}

// 64 rows of `width` floats at column `col` of src (row pitch ld) from token
// tok0 into dst (pitch LD); rows at or past tok1 are zero-filled
__device__ __forceinline__ void stage_rows(float* dst, int LD, const float* src, int ld, int col,
                                           int tok0, int tok1, int width) {
  const int per_row = width / 4;
  for (int i = threadIdx.x; i < kQ * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * 4;
    const int tok = tok0 + r;
    const bool in = tok < tok1;
    tc::cp_async16(dst + r * LD + c, src + (in ? (size_t)tok * ld + col + c : 0), in);
  }
}

// A of one k-step (8 columns at kk) of the warp's 16 rows at p (pitch LD), split
template <int LD>
__device__ __forceinline__ void frag_a(const float* p, int kk, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const float* a = p + gq * LD + 8 * kk + tq;
  tc::split_tf32(a[0], hi[0], lo[0]);
  tc::split_tf32(a[8 * LD], hi[1], lo[1]);
  tc::split_tf32(a[4], hi[2], lo[2]);
  tc::split_tf32(a[8 * LD + 4], hi[3], lo[3]);
}

// d += A B^T for one k-step, B's 8 rows at p (pitch LD): three passes
template <int LD>
__device__ __forceinline__ void mma_bt(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const float* p, int kk) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const float* b = p + gq * LD + 8 * kk + tq;
  uint32_t bh0, bl0, bh1, bl1;
  tc::split_tf32(b[0], bh0, bl0);
  tc::split_tf32(b[4], bh1, bl1);
  tc::mma_tf32(d, al, bh0, bh1);
  tc::mma_tf32(d, ah, bl0, bl1);
  tc::mma_tf32(d, ah, bh0, bh1);
}

// part[n] += S B over the 64 tile columns: S (16 x 64) in accumulator layout,
// its k-step jj taking column 8jj + 2tq in slot tq and 8jj + 2tq + 1 in slot
// tq + 4; B's rows (the tile's tokens, pitch LD) follow that order
template <int DP>
__device__ __forceinline__ void mma_sv(float (&part)[DP / 8][4], const float (&s)[kQ / 8][4],
                                       const bool (&live)[kQ / 8], const float* b0) {
  constexpr int LD = tiled::attn_ld(DP);
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int jj = 0; jj < kQ / 8; ++jj) {
    if (!live[jj]) continue;
    uint32_t ah[4], al[4];
    tc::split_tf32(s[jj][0], ah[0], al[0]);
    tc::split_tf32(s[jj][2], ah[1], al[1]);
    tc::split_tf32(s[jj][1], ah[2], al[2]);
    tc::split_tf32(s[jj][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const float* b = b0 + (8 * jj + 2 * tq) * LD + 8 * n + gq;
      uint32_t bh0, bl0, bh1, bl1;
      tc::split_tf32(b[0], bh0, bl0);
      tc::split_tf32(b[LD], bh1, bl1);
      tc::mma_tf32(part[n], al, bh0, bh1);
      tc::mma_tf32(part[n], ah, bl0, bl1);
      tc::mma_tf32(part[n], ah, bh0, bh1);
    }
  }
}

// dq of one head and 64 queries (grid (ceil(N / 64), H)), and each query's
// delta = do . o to `delta` for attention_dkv.
template <int DP>
__global__ void __launch_bounds__(kThreads)
attention_dq(const float* __restrict__ qkv, const float* __restrict__ att,
             const float* __restrict__ datt, const float* __restrict__ lse,
             float* __restrict__ delta, float* __restrict__ dqkv, int Ntok, int T, int E, int hd,
             float scale_log2, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = tiled::attn_ld(DP);
  float* qt = smem;               // [kQ][LD] q
  float* dot = qt + kQ * LD;      // [kQ][LD] do
  float* ring = dot + kQ * LD;    // [2][k, v][kQ][LD]
  float* stat = ring + 4 * kQ * LD;  // [lse, delta][kQ]
  const int h = blockIdx.y, H = gridDim.y;
  const int q0 = blockIdx.x * kQ;
  const int qn = min(kQ, Ntok - q0);
  const int key0 = (q0 / T) * T;
  const int key1 = min(Ntok, ((q0 + qn - 1) / T + 1) * T);
  const int n_tiles = (key1 - key0 + kQ - 1) / kQ;
  const int E3 = 3 * E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  for (int i = tid; i < attn_bwd_smem_floats(DP) / 4; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // the pad columns stay zero: the copies write columns < hd only

  auto stage_keys = [&](int t) {
    float* st = ring + (t & 1) * 2 * kQ * LD;
    const int k0 = key0 + t * kQ;
    stage_rows(st, LD, qkv, E3, E + h * hd, k0, key1, hd);
    stage_rows(st + kQ * LD, LD, qkv, E3, 2 * E + h * hd, k0, key1, hd);
  };
  stage_rows(qt, LD, qkv, E3, h * hd, q0, Ntok, hd);
  stage_rows(dot, LD, datt, E, h * hd, q0, Ntok, hd);
  stage_keys(0);
  tc::cp_async_commit();
  if (tid < kQ) {
    const int tok = q0 + tid;
    float d = 0.0f, l = 0.0f;
    if (tok < Ntok) {
      const float* o = att + (size_t)tok * E + h * hd;
      const float* g = datt + (size_t)tok * E + h * hd;
      for (int k = 0; k < hd; ++k) d = fmaf(g[k], o[k], d);
      l = lse[(size_t)tok * H + h];
      delta[(size_t)tok * H + h] = d;
    }
    stat[tid] = l;
    stat[kQ + tid] = d;
  }

  const int wq0 = q0 + warp * 16;
  const bool active = wq0 < Ntok;
  const int wkey0 = (wq0 / T) * T, wkey1 = min(key1, (min(wq0 + 15, Ntok - 1) / T + 1) * T);
  int qkey0[2], qkey1[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qkey0[hh] = ((wq0 + gq + 8 * hh) / T) * T;
    qkey1[hh] = min(key1, qkey0[hh] + T);
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float L[2], D[2];
  const float* qw = qt + warp * 16 * LD;
  const float* dw = dot + warp * 16 * LD;

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if (t + 1 < n_tiles) stage_keys(t + 1);
    tc::cp_async_commit();
    if (!active) continue;
    if (t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        L[hh] = stat[warp * 16 + gq + 8 * hh];
        D[hh] = stat[kQ + warp * 16 + gq + 8 * hh];
      }
    }
    const float* kt = ring + (t & 1) * 2 * kQ * LD;
    const float* vt = kt + kQ * LD;
    const int k0 = key0 + t * kQ;
    bool live[kQ / 8];
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      const int kb = k0 + 8 * j;
      live[j] = kb < wkey1 && kb + 8 > wkey0;
    }
    // s = q k^T and dp = do v^T
    float s[kQ / 8][4], dp[kQ / 8][4];
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t qh[4], ql[4], gh[4], gl[4];
      frag_a<LD>(qw, kk, qh, ql);
      frag_a<LD>(dw, kk, gh, gl);
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
        if (!live[j]) continue;
        mma_bt<LD>(s[j], qh, ql, kt + 8 * j * LD, kk);
        mma_bt<LD>(dp[j], gh, gl, vt + 8 * j * LD, kk);
      }
    }
    // ds = p (dp - delta), in s
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * tq + (e & 1), r = e >> 1;
        const bool in = live[j] && key >= qkey0[r] && key < qkey1[r];
        const float p = in ? exp2f(s[j][e] * scale_log2 - L[r]) : 0.0f;
        s[j][e] = p * (dp[j][e] - D[r]);
      }
    float part[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
    mma_sv<DP>(part, s, live, kt);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
  tc::cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int tok = wq0 + gq + 8 * hh;
    if (tok >= Ntok) continue;
    float* o = dqkv + (size_t)tok * E3 + h * hd;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d < hd)
        *reinterpret_cast<float2*>(o + d) =
            make_float2(acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
    }
  }
}

// dk and dv of one head and 64 keys (grid (ceil(N / 64), H)), over the query
// tiles of the rows its keys lie in, with lse and delta of those queries.
template <int DP>
__global__ void __launch_bounds__(kThreads)
attention_dkv(const float* __restrict__ qkv, const float* __restrict__ datt,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dqkv, int Ntok, int T, int E, int hd, float scale_log2,
              float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = tiled::attn_ld(DP);
  float* kt = smem;                  // [kQ][LD] k
  float* vt = kt + kQ * LD;          // [kQ][LD] v
  float* ring = vt + kQ * LD;        // [2][q, do][kQ][LD]
  float* sring = ring + 4 * kQ * LD;  // [2][lse, delta][kQ]
  const int h = blockIdx.y, H = gridDim.y;
  const int k0b = blockIdx.x * kQ;
  const int kn = min(kQ, Ntok - k0b);
  const int qry0 = (k0b / T) * T;
  const int qry1 = min(Ntok, ((k0b + kn - 1) / T + 1) * T);
  const int n_tiles = (qry1 - qry0 + kQ - 1) / kQ;
  const int E3 = 3 * E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;

  for (int i = tid; i < attn_bwd_smem_floats(DP) / 4; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // tile t's queries, do, lse and delta into ring slot t & 1 (the statistics
  // by plain stores, which the next __syncthreads publishes)
  auto stage_queries = [&](int t) {
    float* st = ring + (t & 1) * 2 * kQ * LD;
    const int q0 = qry0 + t * kQ;
    stage_rows(st, LD, qkv, E3, h * hd, q0, qry1, hd);
    stage_rows(st + kQ * LD, LD, datt, E, h * hd, q0, qry1, hd);
    if (tid < kQ) {
      const int tok = q0 + tid;
      float* ss = sring + (t & 1) * 2 * kQ;
      const bool in = tok < qry1;
      ss[tid] = in ? lse[(size_t)tok * H + h] : 0.0f;
      ss[kQ + tid] = in ? delta[(size_t)tok * H + h] : 0.0f;
    }
  };
  stage_rows(kt, LD, qkv, E3, E + h * hd, k0b, Ntok, hd);
  stage_rows(vt, LD, qkv, E3, 2 * E + h * hd, k0b, Ntok, hd);
  stage_queries(0);
  tc::cp_async_commit();

  // the queries of the rows the warp's keys lie in, and of each of the
  // thread's two keys' rows
  const int kw0 = k0b + warp * 16;
  const bool active = kw0 < Ntok;
  const int wq0 = (kw0 / T) * T, wq1 = min(qry1, (min(kw0 + 15, Ntok - 1) / T + 1) * T);
  int krow0[2], krow1[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    krow0[hh] = ((kw0 + gq + 8 * hh) / T) * T;
    krow1[hh] = min(qry1, krow0[hh] + T);
  }
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  const float* kw = kt + warp * 16 * LD;
  const float* vw = vt + warp * 16 * LD;

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if (t + 1 < n_tiles) stage_queries(t + 1);
    tc::cp_async_commit();
    if (!active) continue;
    const float* qtile = ring + (t & 1) * 2 * kQ * LD;
    const float* gtile = qtile + kQ * LD;
    const float* ls = sring + (t & 1) * 2 * kQ;
    const int q0 = qry0 + t * kQ;
    bool live[kQ / 8];
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      const int qb = q0 + 8 * j;
      live[j] = qb < wq1 && qb + 8 > wq0;
    }
    // s^T = k q^T and dp^T = v do^T, keys as rows
    float s[kQ / 8][4], dp[kQ / 8][4];
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      frag_a<LD>(kw, kk, kh, kl);
      frag_a<LD>(vw, kk, vh, vl);
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
        if (!live[j]) continue;
        mma_bt<LD>(s[j], kh, kl, qtile + 8 * j * LD, kk);
        mma_bt<LD>(dp[j], vh, vl, gtile + 8 * j * LD, kk);
      }
    }
    // p^T in s, ds^T = p^T (dp^T - delta) in dp
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1), r = e >> 1;
        const int q = q0 + c;
        const bool in = live[j] && q >= krow0[r] && q < krow1[r];
        const float p = in ? exp2f(s[j][e] * scale_log2 - ls[c]) : 0.0f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ls[kQ + c]);
      }
    float pv[DP / 8][4], pk[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = pk[n][e] = 0.0f;
    mma_sv<DP>(pv, s, live, gtile);
    mma_sv<DP>(pk, dp, live, qtile);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv[n][e] += pv[n][e];
        dk[n][e] += pk[n][e];
      }
  }
  tc::cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int tok = kw0 + gq + 8 * hh;
    if (tok >= Ntok) continue;
    float* o = dqkv + (size_t)tok * E3 + h * hd;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d < hd) {
        *reinterpret_cast<float2*>(o + E + d) =
            make_float2(dk[n][2 * hh] * scale, dk[n][2 * hh + 1] * scale);
        *reinterpret_cast<float2*>(o + 2 * E + d) = make_float2(dv[n][2 * hh], dv[n][2 * hh + 1]);
      }
    }
  }
}

// -- the LayerNorm and modulation backwards -------------------------------------------
//
// One CTA per (DiT row, tile of kTok tokens), grid R * ceil(T / kTok), one
// warp a token (two each); xhat is recomputed from the LayerNorm's input
// `src` and its statistics. With kPost, the MLP branch's LayerNorm of x1 and
// the gated residual around the attention branch (d = d(h2)):
//   dx1 = dy + LN'(d (1 + scale_m)),  dproj = dx1 gate_a  -> dx, dproj;
//   sums of d xhat, d, dx1 proj and dy m  -> dscale_m, dshift_m, dgate_a, dgate_m.
// Otherwise the attention branch's LayerNorm of x (d = dh): dx += LN'(d (1 +
// scale_a)); sums of d xhat and d -> dscale_a, dshift_a. The sums over the
// CTA's tokens, the warps' added in order, go to its partial (R, nt, 6E).
template <bool kPost>
__global__ void __launch_bounds__(32 * kLnBwdWarps)
ln_bwd(const float* __restrict__ src, const float* __restrict__ d_in,
       const float* __restrict__ mod, const float* __restrict__ dy, const float* __restrict__ m,
       const float* __restrict__ proj, float* __restrict__ dx, float* __restrict__ dproj,
       float* __restrict__ parts, int T, int E, float eps) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kSums = kPost ? 4 : 2;
  float* red = smem;  // [kLnBwdWarps][kSums][E]
  const int nt = (T + kTok - 1) / kTok;
  const int row = blockIdx.x / nt, tile = blockIdx.x % nt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* mrow = mod + (size_t)row * 6 * E;
  const float* scale = mrow + (kPost ? 3 * E : 0);
  const float* gate_a = mrow + 2 * E;
  float4 sum[kSums][kMaxVec];
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) sum[k][i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int tt = warp; tt < kTok; tt += kLnBwdWarps) {
    const int t = tile * kTok + tt;
    if (t >= T) break;
    const size_t tok = (size_t)row * T + t;
    float4 xh[kMaxVec], d[kMaxVec];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int k = lane * 4 + i * 128;
      if (k < E) {
        xh[i] = *reinterpret_cast<const float4*>(src + tok * E + k);
        s += (xh[i].x + xh[i].y) + (xh[i].z + xh[i].w);
      }
    }
    const float mean = warp_sum(s) / E;
    float var = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      if (lane * 4 + i * 128 < E) {
        xh[i].x -= mean; xh[i].y -= mean; xh[i].z -= mean; xh[i].w -= mean;
        var += (xh[i].x * xh[i].x + xh[i].y * xh[i].y) + (xh[i].z * xh[i].z + xh[i].w * xh[i].w);
      }
    }
    const float rstd = 1.0f / sqrtf(warp_sum(var) / E + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int k = lane * 4 + i * 128;
      if (k < E) {
        xh[i].x *= rstd; xh[i].y *= rstd; xh[i].z *= rstd; xh[i].w *= rstd;
        const float4 g = *reinterpret_cast<const float4*>(d_in + tok * E + k);
        const float4 sc = *reinterpret_cast<const float4*>(scale + k);
        sum[0][i].x = fmaf(g.x, xh[i].x, sum[0][i].x);
        sum[0][i].y = fmaf(g.y, xh[i].y, sum[0][i].y);
        sum[0][i].z = fmaf(g.z, xh[i].z, sum[0][i].z);
        sum[0][i].w = fmaf(g.w, xh[i].w, sum[0][i].w);
        sum[1][i].x += g.x; sum[1][i].y += g.y; sum[1][i].z += g.z; sum[1][i].w += g.w;
        d[i] = make_float4(g.x * (1.0f + sc.x), g.y * (1.0f + sc.y), g.z * (1.0f + sc.z),
                           g.w * (1.0f + sc.w));
        s1 += (d[i].x + d[i].y) + (d[i].z + d[i].w);
        s2 += (d[i].x * xh[i].x + d[i].y * xh[i].y) + (d[i].z * xh[i].z + d[i].w * xh[i].w);
      }
    }
    s1 = warp_sum(s1) / E;
    s2 = warp_sum(s2) / E;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int k = lane * 4 + i * 128;
      if (k >= E) continue;
      float4 g = make_float4(
          rstd * (d[i].x - s1 - xh[i].x * s2), rstd * (d[i].y - s1 - xh[i].y * s2),
          rstd * (d[i].z - s1 - xh[i].z * s2), rstd * (d[i].w - s1 - xh[i].w * s2));
      float4* dxp = reinterpret_cast<float4*>(dx + tok * E + k);
      if constexpr (kPost) {
        const float4 y = *reinterpret_cast<const float4*>(dy + tok * E + k);
        const float4 mv = *reinterpret_cast<const float4*>(m + tok * E + k);
        const float4 pr = *reinterpret_cast<const float4*>(proj + tok * E + k);
        const float4 ga = *reinterpret_cast<const float4*>(gate_a + k);
        g.x += y.x; g.y += y.y; g.z += y.z; g.w += y.w;  // dx1
        *dxp = g;
        *reinterpret_cast<float4*>(dproj + tok * E + k) =
            make_float4(g.x * ga.x, g.y * ga.y, g.z * ga.z, g.w * ga.w);
        sum[2][i].x = fmaf(g.x, pr.x, sum[2][i].x);
        sum[2][i].y = fmaf(g.y, pr.y, sum[2][i].y);
        sum[2][i].z = fmaf(g.z, pr.z, sum[2][i].z);
        sum[2][i].w = fmaf(g.w, pr.w, sum[2][i].w);
        sum[3][i].x = fmaf(y.x, mv.x, sum[3][i].x);
        sum[3][i].y = fmaf(y.y, mv.y, sum[3][i].y);
        sum[3][i].z = fmaf(y.z, mv.z, sum[3][i].z);
        sum[3][i].w = fmaf(y.w, mv.w, sum[3][i].w);
      } else {
        const float4 x0 = *dxp;
        *dxp = make_float4(x0.x + g.x, x0.y + g.y, x0.z + g.z, x0.w + g.w);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      const int c = lane * 4 + i * 128;
      if (c < E) *reinterpret_cast<float4*>(red + (warp * kSums + k) * E + c) = sum[k][i];
    }
  __syncthreads();
  // the chunks of dmod these sums are: kPost scale_m, shift_m, gate_a and
  // gate_m; else scale_a and shift_a
  float* part = parts + ((size_t)row * nt + tile) * 6 * E;
  for (int i = threadIdx.x; i < kSums * E; i += blockDim.x) {
    float v = 0.0f;
    for (int w = 0; w < kLnBwdWarps; ++w) v += red[w * kSums * E + i];
    const int k = i / E;
    const int chunk = kPost ? (k == 0 ? 3 : k == 1 ? 4 : k == 2 ? 2 : 5) : k;
    part[chunk * E + i % E] = v;
  }
}

// dmod[r, i] = the sum over the row's token tiles, in order, of parts[r, p,
// i], in f64; one thread an entry.
__global__ void __launch_bounds__(256)
sum_parts(const float* __restrict__ parts, float* __restrict__ dmod, int R, int nt, int E6) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= R * E6) return;
  const int r = idx / E6, i = idx % E6;
  double v = 0.0;
  for (int p = 0; p < nt; ++p) v += parts[((size_t)r * nt + p) * E6 + i];
  dmod[idx] = (float)v;
}

// dc[r, e] = (dmod[r] . wada_t[:, e]) * silu'(c[r, e]), the dot in f64. A CTA
// takes kDcRows rows (staged as f64) and 32 columns, grid (ceil(E / 32),
// ceil(R / kDcRows)); warp w sums the w-th sixteenth of the depth 6E, one
// weight load feeding kDcRows FMAs, and the sixteen warps' sums are added in
// order. In f64 because at T = 1,024 |dc| reaches a few hundred while rtol =
// atol = 1e-4 holds each entry: an f32 sum of the 6E terms would spend part
// of that.
__global__ void __launch_bounds__(32 * kDcWarps)
dc_rows(const float* __restrict__ dmod, const float* __restrict__ wada_t,
        const float* __restrict__ c, float* __restrict__ dc, int R, int E) {
  extern __shared__ __align__(16) double dc_smem[];
  const int E6 = 6 * E;
  double* red = dc_smem;                          // [kDcWarps][kDcRows][32]
  double* rows = red + kDcWarps * kDcRows * 32;   // [kDcRows][6E]
  const int r0 = blockIdx.y * kDcRows, rn = min(kDcRows, R - r0);
  for (int i = threadIdx.x; i < kDcRows * E6; i += blockDim.x)
    rows[i] = i / E6 < rn ? (double)dmod[(size_t)r0 * E6 + i] : 0.0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * 32 + lane;
  const int per = (E6 + kDcWarps - 1) / kDcWarps;
  const int n0 = warp * per, n1 = min(E6, n0 + per);
  double acc[kDcRows];
#pragma unroll
  for (int r = 0; r < kDcRows; ++r) acc[r] = 0.0;
  if (e < E) {
#pragma unroll 4
    for (int n = n0; n < n1; ++n) {
      const double wv = wada_t[(size_t)n * E + e];
#pragma unroll
      for (int r = 0; r < kDcRows; ++r) acc[r] = fma(rows[r * E6 + n], wv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kDcRows; ++r) red[(warp * kDcRows + r) * 32 + lane] = acc[r];
  __syncthreads();
  if (warp >= rn || e >= E) return;  // warp r finishes row r
  double v = 0.0;
  for (int w = 0; w < kDcWarps; ++w) v += red[(w * kDcRows + warp) * 32 + lane];
  const size_t o = (size_t)(r0 + warp) * E + e;
  const float cv = c[o];
  const float sg = dit::sigmoid(cv);
  dc[o] = (float)v * sg * (1.0f + cv * (1.0f - sg));
}

template <int DP>
cudaError_t launch_attention_bwd(const Workspace& w, int N, int T, int E, int H,
                                 cudaStream_t s) {
  static SmemAllowance allowed_dq, allowed_dkv;
  const long long smem = 4LL * attn_bwd_smem_floats(DP);
  cudaError_t err;
  if ((err = allow_smem(attention_dq<DP>, smem, allowed_dq)) != cudaSuccess ||
      (err = allow_smem(attention_dkv<DP>, smem, allowed_dkv)) != cudaSuccess)
    return err;
  const int hd = E / H;
  const float scale = 1.0f / sqrtf((float)hd), scale_log2 = 1.4426950408889634f * scale;
  const dim3 grid((N + kQ - 1) / kQ, H);
  attention_dq<DP><<<grid, kThreads, smem, s>>>(w.qkv, w.attn, w.dattn, w.lse, w.delta, w.dqkv,
                                                 N, T, E, hd, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_dkv<DP><<<grid, kThreads, smem, s>>>(w.qkv, w.dattn, w.lse, w.delta, w.dqkv, N, T, E,
                                                  hd, scale_log2, scale);
  return cudaGetLastError();
}

template <bool kPost>
cudaError_t launch_ln_bwd(const float* src, const float* d_in, const Workspace& w,
                          const float* dy, float* dx, int R, int T, int E, float eps,
                          cudaStream_t s) {
  static SmemAllowance allowed;
  const long long smem = 4LL * kLnBwdWarps * (kPost ? 4 : 2) * E;
  cudaError_t err = allow_smem(ln_bwd<kPost>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int nt = (T + kTok - 1) / kTok;
  ln_bwd<kPost><<<R * nt, 32 * kLnBwdWarps, smem, s>>>(src, d_in, w.mod, dy, w.m, w.proj, dx,
                                                        w.dproj, w.parts, T, E, eps);
  return cudaGetLastError();
}

cudaError_t launch_backward(const float* x, const float* c, const float* wada, const float* bada,
                            const float* wqkv, const float* bqkv, const float* wproj,
                            const float* bproj, const float* w1, const float* w2,
                            const float* wmlp, const float* wada_t, const float* wqkv_t,
                            const float* wproj_t, const float* w1_t, const float* w2_t,
                            const float* wmlp_t, const float* dy, float* dx, float* dc,
                            float* dwada_t, float* dbada, float* dwqkv_t, float* dbqkv,
                            float* dwproj_t, float* dbproj, float* dw12_t, float* dwmlp_t,
                            float* ws, int R, int T, int E, int H, int Hd, float eps,
                            cudaStream_t s) {
  using tiled::launch_gemm;
  using tiled::Out;
  const int N = R * T, hd = E / H, nt = (T + kTok - 1) / kTok;
  if (E % 4 != 0 || E > 4 * 32 * kMaxVec || hd % 4 != 0 || hd > 64 || Hd % 4 != 0)
    return cudaErrorInvalidValue;
  Workspace w;
  carve(ws, R, T, E, H, Hd, w);
  cudaError_t err;
  tiled::Gemm g{};
  g.mod = w.mod;
  g.mod_ld = 6 * E;

  // ===== the forward, recomputed =================================================
  if ((err = tiled::launch_silu(c, w.cs, R * E, s)) != cudaSuccess) return err;
  g.a = w.cs; g.w0 = wada; g.bias = bada; g.out = w.mod; g.M = R; g.K = E; g.N = 6 * E; g.T = 1;
  if ((err = launch_gemm<Out::kBias>(g, s)) != cudaSuccess) return err;
  if ((err = tiled::launch_ln(x, w.mod, w.h, N, T, E, 0, E, eps, s)) != cudaSuccess) return err;
  g.a = w.h; g.w0 = wqkv; g.bias = bqkv; g.out = w.qkv; g.M = N; g.N = 3 * E; g.T = T;
  if ((err = launch_gemm<Out::kBias>(g, s)) != cudaSuccess) return err;
  if ((err = tiled::launch_attention(w.qkv, w.attn, w.lse, N, T, E, H, s)) != cudaSuccess)
    return err;
  // proj = attn wproj + bproj, x1 = x + gate_a proj
  g.a = w.attn; g.w0 = wproj; g.bias = bproj; g.resid = x; g.out = w.x1; g.aux = w.proj;
  g.N = E; g.gate = 2 * E;
  if ((err = launch_gemm<Out::kGatedBias>(g, s)) != cudaSuccess) return err;
  if ((err = tiled::launch_ln(w.x1, w.mod, w.h2, N, T, E, 3 * E, 4 * E, eps, s)) != cudaSuccess)
    return err;
  // [a | b] = h2 [w1 | w2], g = silu(a) b
  g.a = w.h2; g.w0 = w1; g.w1 = w2; g.out = w.g; g.aux = w.ab; g.N = Hd;
  if ((err = launch_gemm<Out::kSwiGLU>(g, s)) != cudaSuccess) return err;
  // m = g wmlp; dm = dy gate_m
  g.a = w.g; g.w0 = wmlp; g.w1 = nullptr; g.resid = dy; g.out = w.dm; g.aux = w.m; g.K = Hd;
  g.N = E; g.gate = 5 * E;
  if ((err = launch_gemm<Out::kDm>(g, s)) != cudaSuccess) return err;

  // ===== the backward ============================================================
  // dg = dm wmlp^T; [a | b] -> [da | db]
  g.a = w.dm; g.w0 = wmlp_t; g.out = w.ab; g.aux = nullptr; g.K = E; g.N = Hd;
  if ((err = launch_gemm<Out::kSwiGLUBwd>(g, s)) != cudaSuccess) return err;
  // d(h2) = da w1^T + db w2^T
  g.a = w.ab; g.w0 = w1_t; g.w1 = w2_t; g.ksplit = Hd; g.out = w.dh; g.K = 2 * Hd; g.N = E;
  if ((err = launch_gemm<Out::kPlain>(g, s)) != cudaSuccess) return err;
  g.w1 = nullptr;
  g.ksplit = 0;
  // dx1 (into dx), dproj, and the sums of dscale_m, dshift_m, dgate_a, dgate_m
  if ((err = launch_ln_bwd<true>(w.x1, w.dh, w, dy, dx, R, T, E, eps, s)) != cudaSuccess)
    return err;
  // d(attention output) = dproj wproj^T
  g.a = w.dproj; g.w0 = wproj_t; g.out = w.dattn; g.K = E;
  if ((err = launch_gemm<Out::kPlain>(g, s)) != cudaSuccess) return err;
  if (hd <= 16) err = launch_attention_bwd<16>(w, N, T, E, H, s);
  else if (hd <= 32) err = launch_attention_bwd<32>(w, N, T, E, H, s);
  else err = launch_attention_bwd<64>(w, N, T, E, H, s);
  if (err != cudaSuccess) return err;
  // dh = dqkv wqkv^T; dx += the first LayerNorm's backward
  g.a = w.dqkv; g.w0 = wqkv_t; g.out = w.dh; g.K = 3 * E;
  if ((err = launch_gemm<Out::kPlain>(g, s)) != cudaSuccess) return err;
  if ((err = launch_ln_bwd<false>(x, w.dh, w, dy, dx, R, T, E, eps, s)) != cudaSuccess)
    return err;
  // dmod, and dc = (dmod wada^T) silu'(c)
  sum_parts<<<(R * 6 * E + 255) / 256, 256, 0, s>>>(w.parts, w.dmod, R, nt, 6 * E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  {
    static SmemAllowance allowed;
    const long long smem = 8LL * (kDcWarps * kDcRows * 32 + kDcRows * 6 * E);
    if ((err = allow_smem(dc_rows, smem, allowed)) != cudaSuccess) return err;
    dc_rows<<<dim3((E + 31) / 32, (R + kDcRows - 1) / kDcRows), 32 * kDcWarps, smem, s>>>(
        w.dmod, wada_t, c, dc, R, E);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  // ===== the weight gradients, U^T V over the tokens (rows for wada) ============
  tiled::GradJobs<5> jobs{};
  jobs.job[0] = {w.dmod, w.cs, dwada_t, dbada, nullptr, 6 * E, E, R, 1, 0, 0, 0};
  jobs.job[1] = {w.dqkv, w.h, dwqkv_t, dbqkv, nullptr, 3 * E, E, N, 1, 0, 0, 0};
  jobs.job[2] = {w.dproj, w.attn, dwproj_t, dbproj, nullptr, E, E, N, 1, 0, 0, 0};
  jobs.job[3] = {w.ab, w.h2, dw12_t, nullptr, nullptr, 2 * Hd, E, N, 1, 0, 0, 0};
  jobs.job[4] = {w.dm, w.g, dwmlp_t, nullptr, nullptr, E, Hd, N, 1, 0, 0, 0};
  jobs.n = 5;
  return tiled::launch_weight_grads(jobs, w.grads, s);
}

}  // namespace

extern "C" {

// Launches one block backward on `stream`, on the current device: the
// forward recomputed (eight launches), the backward (ten) and the weight
// gradients (two). The (in, out) weights feed the recomputed forward; the `_t`
// weights are the same matrices in nn.Linear's (out, in) layout, as are the
// weight gradients written (dw12_t holds dw1_t over dw2_t, (2Hd, E)).
// `workspace` holds scldm_dit_block_backward_workspace_floats() floats. Every
// output is written whole. Returns the first CUDA error code (0 on success;
// cudaErrorInvalidValue for E > 512, or a head width or Hd that is not a
// multiple of 4, or a head width over 64). Allocates nothing and does not
// synchronise.
int scldm_dit_block_backward(
    const void* x, const void* c, const void* wada, const void* bada, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* w1,
    const void* w2, const void* wmlp, const void* wada_t, const void* wqkv_t,
    const void* wproj_t, const void* w1_t, const void* w2_t, const void* wmlp_t,
    const void* dy, void* dx, void* dc, void* dwada_t, void* dbada, void* dwqkv_t,
    void* dbqkv, void* dwproj_t, void* dbproj, void* dw12_t, void* dwmlp_t,
    void* workspace, int R, int T, int E, int H, int Hd, float eps, void* stream) {
  if (R == 0 || T == 0) return 0;
  return (int)launch_backward(
      (const float*)x, (const float*)c, (const float*)wada, (const float*)bada,
      (const float*)wqkv, (const float*)bqkv, (const float*)wproj, (const float*)bproj,
      (const float*)w1, (const float*)w2, (const float*)wmlp, (const float*)wada_t,
      (const float*)wqkv_t, (const float*)wproj_t, (const float*)w1_t, (const float*)w2_t,
      (const float*)wmlp_t, (const float*)dy, (float*)dx, (float*)dc, (float*)dwada_t,
      (float*)dbada, (float*)dwqkv_t, (float*)dbqkv, (float*)dwproj_t, (float*)dbproj,
      (float*)dw12_t, (float*)dwmlp_t, (float*)workspace, R, T, E, H, Hd, eps,
      (cudaStream_t)stream);
}

long long scldm_dit_block_backward_workspace_floats(int R, int T, int E, int H, int Hd) {
  return (long long)workspace_floats(R, T, E, H, Hd);
}

}  // extern "C"
