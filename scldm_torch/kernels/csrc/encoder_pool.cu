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
// The backward, given m and the cotangents dnum, dden: per token dv =
// bf(sum_i bf(e) dnum), ds = e (bf(v . dnum) + dden) scale, dk = bf(ds @ q),
// dx2 = bf(dk @ wk^T) + bf(dv @ wv^T), the LayerNorm backward into the
// token's gradient (demb, or dtable's row times log1p(count), summed over
// cells); summed over every token dwk = bf(x2)^T dk, dwv = bf(x2)^T dv, dqfull's
// head blocks ds^T bf(k), dln1g, dln1b. The caller rounds dqfull, dwk and dwv
// to bf16 after the whole sum.
//
// What bounds it on an H100. Forward: about 3.1k multiply-adds a token (2 E^2
// for k and v, Q*E each for the scores and the pooled values), which the bf16
// tensor cores would run in 1.6 us at parse1m (B=128, G=2,000), and the 64
// exponentials a token; the window's one read of the (B, S, E) embeddings
// (100.7 MB at B=128, S=6,147) takes 30 us. Backward: about 9.2k
// multiply-adds a token, which the bf16 tensor cores would run in 5 us at
// parse1m and 15 us at the dentate window; the window's bytes (the window read
// and demb written, 201 MB) take 60 us. As built, the forward's first pass
// over the window streams at the memory's rate and its second pass, like
// the dense forward and the backward, is bound by its instructions: each
// warp's 16-token tile is a chain of dependent instructions (products,
// exponentials, the LayerNorm, bf16 packing; about 1,100 in the backward) and
// 16 warps an SM (128 registers a thread) hide only part of it.
//
// What the design does about it. Both directions run every product on
// mma.sync bf16, one pass where both operands are bf16 roundings, 16 warps an
// SM. A warp runs 16 tokens of one cell in registers, rows gq and gq + 8 a
// thread (lane = 4 gq + tq; tensor_core.cuh): the LayerNorm on the thread's
// own 8 columns (a quad of lanes a row), bf(x2) as the A fragments of k =
// bf(x2) @ W with the k index permuted, k and v (`layer_norm_row`,
// `head_proj`: the same code, so the same bits, both ways).
// Forward: one CTA of 16 warps a cell, one CTA an SM (at B = 128 one wave;
// the bits depend on the shapes alone). The exponentials are rounded to bf16
// against the cell's final max, as the plain version rounds them, so the
// forward takes two passes over the cell's tokens: pass 1 the scores' row
// maxima, pass 2 e, den and num. (Rounding against a running max, as the TPU
// kernel does tile by tile, moves num away from the plain version by a bf16
// rounding of every exponential; at 16-token tiles that broke the plain
// version's bounds on num.) Per head the scores run transposed, s^T = bf(q)
// bf(k)^T on m16n8k8 with the queries on the rows (k's C fragment is the B
// operand as it stands; the products and their order over d are the
// backward's). Those sums truncate, so now and then they flip a bf16
// rounding of k that an f32 sum would not, and the backward scales a row's
// gradients with m: so m is the largest of the 4 scores, taken again exactly
// (k summed in f64, as `exact_max` does for the wide pool), of the tile and
// thread that first reach the row's max on the tensor cores; e =
// 2^(s scale log2(e) - m log2(e)) takes the backward's formula;
// num += bf(e) bf(v) on m16n8k16, bf(e) repacked from the C fragments as the
// A operand, bf(v)'s fragments transposed across the warp by movmatrix, each
// tile summed from zero and added in f32. A warp streams its tiles of rows
// (and dense, counts) through a 3-stage cp.async ring, two tiles in flight
// while it computes one, and keeps bf(x2) of its first kCacheTiles tiles in
// shared memory: pass 2 reads those and streams the rest again, last read
// first. The warps' (den, num) are added in warp order through shared
// memory. One launch, no workspace.
// Backward: a CTA takes 64 genes of 4 cells (dense: 32 x 32 CTAs at parse1m,
// two waves) or 512 window tokens of one cell, a stage of 64 tokens of one
// cell at a time. Per head the scores, e, v . dnum, dv, dk and the head's
// block of dqfull, each C fragment repacked (or transposed across the warp by
// movmatrix) as the next product's A or B fragment, then dx2 and the LayerNorm
// backward; it writes demb once (16-byte stores), keeps dqfull's blocks and
// the LayerNorm sums in registers, and stages bf(x2), bf(dk) and bf(dv). The
// CTA then adds the stage's dwk and dwv over its 64 tokens (token-axis
// products read by ldmatrix.trans), a warp per output block, the stage summed
// from zero on the tensor cores and added in f32. Where an operand is an f32
// cotangent (dnum in v . dnum and dv, ds in dk and dqfull) it runs as three
// bf16 passes (hi, mid, lo: the products are rounded to bf16 next, so f32
// accuracy keeps those roundings where f32 sums put them). No atomics: each
// CTA writes its partial sums (and, dense, its cell group's dtable rows) to a
// workspace, and a second kernel adds them in index order, so every gradient
// is written whole and repeats its bits. The workspace is sized by
// scldm_encoder_pool_workspace_floats.
//
// Compiled for E=32, 4 heads, Q=16 (the reference encoder); the thread-to-
// output maps assume E == 32 and Q*H == 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

#include "tensor_core.cuh"

namespace {

constexpr int kE = 32, kH = 4, kQ = 16;
constexpr int kHD = kE / kH, kQH = kQ * kH;
constexpr int kWarps = 4;  // the backward's CTA (and `stage_frags`'s thread maps)
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kHD == 8 && kQ == 16 && kE == 32, "the fragment maps assume heads of 8, 16 queries");

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 2^x; ftz: a result below 2^-126 is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A warp owns a tile of 16 tokens of one cell, rows gq and gq + 8 a thread. A
// thread holds its rows' embedding columns 4tq..4tq+3 and 16+4tq..16+4tq+3
// (value u = 0..7 at `own_col`), read and written as 16-byte vectors. Those
// are the columns its A fragments of bf(x2) hold once the k index of x2 @ W is
// permuted (k = 16j + 8h + 2t + l is column 16j + 4t + 2h + l: the B
// fragments of W are staged in that order), and the columns its C fragments
// of dx2 = dk @ W^T hold once the n index is permuted alike (`dx_col`), so the
// LayerNorm and its backward run on the thread's own values.
__device__ __forceinline__ int own_col(int tq, int u) { return 4 * tq + (u & 3) + 16 * (u >> 2); }

// The fragments both directions stage once per CTA (bf16): x2 @ [wk | wv]'s
// B fragments in the permuted k order (k step, n tile: 4 of k then 4 of v,
// lane), bf(q) per head (two 8-query halves, lane: the backward's B fragments
// of the scores, the forward's A fragments), ln1g and ln1b.
struct WeightFrags {
  uint32_t kv[2][8][32][2];
  uint32_t q8[kH][2][32];
  float g[kE], b[kE];
};

// The loops have fixed trip counts, so each thread's loads issue together.
__device__ void stage_frags(WeightFrags& W, const float* wk, const float* wv, const float* qfull,
                            const float* ln1g, const float* ln1b) {
  static_assert(2 * 8 * 32 == 4 * kThreads && kH * 2 * 32 == 2 * kThreads, "the staging maps");
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3, w4 = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = ((w4 + 4 * k) & 7), j = k >> 1;  // entry threadIdx.x + 128 k: [j][c][lane]
    const float* w = (c < 4 ? wk : wv) + 8 * (c & 3) + gq;  // column n of n tile c
    const int r = 16 * j + 4 * tq;  // the rows of k 2tq.. (b0) and 2tq + 8.. (b1)
    W.kv[j][c][lane][0] = tc::pack_bf16(w[r * kE], w[(r + 1) * kE]);
    W.kv[j][c][lane][1] = tc::pack_bf16(w[(r + 2) * kE], w[(r + 3) * kE]);
  }
  // q(i, col) = qfull[(head of col) * Q + i, col]
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int u = w4 & 1, h = (w4 >> 1) + 2 * k;
    const float* q = qfull + (size_t)(h * kQ + 8 * u + gq) * kE + h * kHD + 2 * tq;
    W.q8[h][u][lane] = tc::pack_bf16(q[0], q[1]);
  }
  if (threadIdx.x < kE) W.g[threadIdx.x] = ln1g[threadIdx.x];
  else if (threadIdx.x < 2 * kE) W.b[threadIdx.x - kE] = ln1b[threadIdx.x - kE];
}

// Row r (token gq + 8r of the warp's 16): x holds the thread's 8 values of x,
// at `own_col`. In place x -> xhat; writes bf(x2 = xhat ln1g + ln1b) as the
// row's entries of the A fragments of k steps 0 and 1; returns rstd.
__device__ __forceinline__ float layer_norm_row(const WeightFrags& W, float (&x)[8], float eps,
                                                int r, uint32_t (&ax)[2][4]) {
  const int tq = threadIdx.x & 3;
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) s += x[u];
  const float mean = quad_sum(s) / kE;
  float var = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    x[u] -= mean;
    var = fmaf(x[u], x[u], var);
  }
  const float rstd = rsqrtf(quad_sum(var) / kE + eps);
  float x2[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    x[u] *= rstd;  // xhat
    const int c = own_col(tq, u);
    x2[u] = __fadd_rn(__fmul_rn(x[u], W.g[c]), W.b[c]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    ax[j][r] = tc::pack_bf16(x2[4 * j], x2[4 * j + 1]);
    ax[j][2 + r] = tc::pack_bf16(x2[4 * j + 2], x2[4 * j + 3]);
  }
  return rstd;
}

// Head h's k (c = h) or v (c = 4 + h) over the warp's 16 tokens, rounded to
// bf16 and packed as the A fragments of an 8-deep step: rows the tokens gq
// ([0]) and gq + 8 ([1]), columns the head's 2tq, 2tq + 1.
__device__ __forceinline__ void head_proj(const WeightFrags& W, const uint32_t (&ax)[2][4], int c,
                                          uint32_t (&out)[2]) {
  const int lane = threadIdx.x & 31;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) tc::mma_bf16(acc, ax[j], W.kv[j][c][lane][0], W.kv[j][c][lane][1]);
  out[0] = tc::pack_bf16(acc[0], acc[1]);
  out[1] = tc::pack_bf16(acc[2], acc[3]);
}

// ---------------------------------------------------------------------------
// forward: tensor cores, a CTA a cell, sums in a fixed order
// ---------------------------------------------------------------------------

constexpr int kFwdWarps = 16, kFwdThreads = 32 * kFwdWarps;  // one CTA an SM
constexpr int kFwdStages = 3;   // a warp's cp.async ring of 16-token tiles
constexpr int kCacheTiles = 7;  // a warp's first tiles, whose bf(x2) pass 2 reads again
// a partial of the pooled sums: den (Q*H), then num's 8 columns a (query, head)
constexpr int kPd = 0, kPn = kQH, kPartF = kPn + kQH * kHD;

struct FwdSmem {
  WeightFrags w;
  union {
    struct {
      float rows[kFwdStages][16][kE];  // 16-byte chunk c of row r at c ^ 4 (r & 1)
      float counts[kFwdStages][16];
    } ring[kFwdWarps];
    float part[kFwdWarps][kPartF];  // the warps' (den, num) after their tiles
  };
  uint4 x2[kFwdWarps][kCacheTiles][2][32];  // bf(x2)'s A fragments: tile, k step, lane
  float wmax[kFwdWarps / 2][kQH];           // pairs of warps' raw score maxima,
  int wbase[kFwdWarps / 2][kQH];            // and where each is first reached (`mbase`)
  int base[kQH];                            // the cell's
  float exact[kQH][4];                      // its 4 candidates' exact scores
  uint32_t wkb[kE][kE / 2];                 // bf(wk), for those
  float m[kQH];                             // the cell's m, as written
};
static_assert(sizeof(FwdSmem) <= 227 * 1024, "one CTA an SM");

// cp.async of rows [t, t + 16) of the cell (and dense, their counts) into a
// ring slot: lane l copies 16-byte chunk l & 7 of rows l / 8 + 4k; `row` is
// that chunk of its first row at token 0 (dense: in the table; window: in the
// cell's embeddings), `count` the cell's counts (dense); a row at or past N
// takes token N - 1 again
template <bool kDense>
__device__ __forceinline__ void issue_tile(float (*rows)[kE], float* cnt, const float* row,
                                           const float* count, int t, int N) {
  const int lane = threadIdx.x & 31, r0 = lane >> 3, chunk = lane & 7;
  float* dst = &rows[r0][4 * (chunk ^ ((r0 & 1) << 2))];  // rows r0 + 4k: the same swizzle
  if (t + 16 <= N) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      tc::cp_async16(dst + 4 * k * kE, row + (size_t)(t + 4 * k) * kE, true);
    if (kDense && lane < 16) tc::cp_async4(cnt + lane, count + t + lane, true);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      tc::cp_async16(dst + 4 * k * kE,
                     row + (ptrdiff_t)(min(t + 4 * k + r0, N - 1) - r0) * kE, true);
    if (kDense && lane < 16) tc::cp_async4(cnt + lane, count + min(t + lane, N - 1), true);
  }
}

// A ring slot's 16 tokens: LayerNorm and bf(x2)'s A fragments
template <bool kDense>
__device__ __forceinline__ void slot_x2(const WeightFrags& W, const float (*rows)[kE],
                                        const float* cnt, float eps, uint32_t (&ax)[2][4]) {
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3, swz = (gq & 1) << 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = rows[gq + 8 * r];
    const float4 lo = *reinterpret_cast<const float4*>(row + 4 * (tq ^ swz));
    const float4 hi = *reinterpret_cast<const float4*>(row + 4 * ((4 + tq) ^ swz));
    float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (kDense) {
      const float lc = log1pf(cnt[gq + 8 * r]);
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] *= lc;
    }
    layer_norm_row(W, x, eps, r, ax);
  }
}

// s^T = bf(q) bf(k)^T of head h (m16n8k8, rows the queries gq and gq + 8, k
// over d: the backward's products in its order): s[n][2rr + l] is query gq +
// 8rr, token 8n + 2tq + l of the tile
__device__ __forceinline__ void head_scores(const WeightFrags& W, const uint32_t (&ka)[2], int h,
                                            float (&s)[2][4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t qa[2] = {W.q8[h][0][lane], W.q8[h][1][lane]};
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
    tc::mma_bf16_k8(s[n], qa, ka[n]);
  }
}

// (score, token) replaced by (s, t) if s is larger, or as large with the
// smaller token: in any order, the first token that reaches the max
__device__ __forceinline__ void take_max(float& v, int& i, float s, int t) {
  if (s > v || (s == v && t < i)) {
    v = s;
    i = t;
  }
}

// The scores of query i of head h against tokens t and t + 1 of cell b (N - 1
// past N), taken exactly: x2 by `layer_norm_row` (the bits the tensor-core
// path rounds), k's head block summed in f64 and rounded through f32 to
// bf16, as PyTorch rounds the exact k, and the 8 products (exact in f32)
// summed in f64. `wkb` is bf(wk) (in, out), a pair of columns a word. A quad
// of lanes the two tokens, as rows 0 and 1 of `layer_norm_row`'s layout;
// every lane of the quad returns them.
template <bool kDense>
__device__ float2 exact_scores(const WeightFrags& W, const uint32_t (*wkb)[kE / 2],
                               const float* counts, const float* src, const float* qfull, int b,
                               int t, int h, int i, int N, float eps) {
  const int tq = threadIdx.x & 3;
  float x[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tok = min(t + r, N - 1);
    const float* row = src + ((kDense ? 0 : (size_t)b * N) + tok) * kE;
    const float lc = kDense ? log1pf(__ldg(counts + (size_t)b * N + tok)) : 1.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + 16 * half + 4 * tq));
      x[r][4 * half] = kDense ? v.x * lc : v.x;
      x[r][4 * half + 1] = kDense ? v.y * lc : v.y;
      x[r][4 * half + 2] = kDense ? v.z * lc : v.z;
      x[r][4 * half + 3] = kDense ? v.w * lc : v.w;
    }
  }
  uint32_t ax[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) layer_norm_row(W, x[r], eps, r, ax);
  double k[2][kHD];
#pragma unroll
  for (int d = 0; d < kHD; ++d) k[0][d] = k[1][d] = 0.0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {  // the thread's x2 values, at `own_col`
    const uint4 wq = *reinterpret_cast<const uint4*>(&wkb[own_col(tq, u)][h * kHD / 2]);
    const uint32_t wp[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t pair = ax[u >> 2][(u & 2) ? 2 + r : r];
      const double x2 = __uint_as_float((u & 1) ? pair & 0xffff0000u : pair << 16);
#pragma unroll
      for (int d = 0; d < kHD; ++d)
        k[r][d] = fma(x2, (double)__uint_as_float((d & 1) ? wp[d >> 1] & 0xffff0000u
                                                          : wp[d >> 1] << 16), k[r][d]);
    }
  }
  const float* q = qfull + (size_t)(h * kQ + i) * kE + h * kHD;
  double sx[2] = {0.0, 0.0};
#pragma unroll
  for (int d = 0; d < kHD; ++d) {
    const float qd = bf(__ldg(q + d));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      k[r][d] += __shfl_xor_sync(0xffffffffu, k[r][d], 1);
      k[r][d] += __shfl_xor_sync(0xffffffffu, k[r][d], 2);
      sx[r] += (double)(bf(__double2float_rn(k[r][d])) * qd);
    }
  }
  return make_float2(__double2float_rn(sx[0]), __double2float_rn(sx[1]));
}

// A CTA a cell, warp w its tiles w, w + 16, ... (past N the last token
// again, which leaves the max as it is). Pass 1 takes each (query, head)
// row's score max over the cell, where a thread first reaches it (its 4
// token columns of one tile), and keeps each warp's first kCacheTiles tiles
// of bf(x2); m is then the largest of those 4 tokens' scores taken again
// exactly (`exact_score`: the tensor cores' sums truncate, so k's bf16
// roundings flip now and then, and the backward, given m, scales a row's
// gradients with it). Pass 2 takes the tiles again in reverse order,
// those past the cache streamed and normalised again first, for e against
// that max (0 past N), den and num; the warps' sums are added in warp order.
template <bool kDense>
__global__ void __launch_bounds__(kFwdThreads, 1)
pool_fwd_mma(const float* __restrict__ counts, const float* __restrict__ src,
             const float* __restrict__ qfull, const float* __restrict__ ln1g,
             const float* __restrict__ ln1b, const float* __restrict__ wk,
             const float* __restrict__ wv, float* __restrict__ num, float* __restrict__ den,
             float* __restrict__ mout, int N, float eps, float scale) {
  extern __shared__ __align__(16) float smem[];
  FwdSmem& S = *reinterpret_cast<FwdSmem*>(smem);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ntiles = (N + 15) >> 4;
  const int mine = ntiles > warp ? (ntiles - warp + kFwdWarps - 1) / kFwdWarps : 0;
  // load steps: pass 1's tiles, then pass 2's past the cache
  const int loads = mine + max(0, mine - kCacheTiles);
  auto& ring = S.ring[warp];
  const float* row = src + ((kDense ? 0 : (size_t)b * N) + (lane >> 3)) * kE + 4 * (lane & 7);
  const float* count = kDense ? counts + (size_t)b * N : nullptr;
  auto tile_t0 = [&](int i) { return 16 * (warp + kFwdWarps * i); };
  // load step j: pass 1's tile j, then pass 2's from the last tile down
  auto step_t0 = [&](int j) { return tile_t0(j < mine ? j : 2 * mine - 1 - j); };
  int issued = 0, slot_in = 0, slot_out = 0;  // load steps issued; the ring's next slots
  auto issue = [&]() {
    if (issued < loads)
      issue_tile<kDense>(ring.rows[slot_in], ring.counts[slot_in], row, count, step_t0(issued), N);
    tc::cp_async_commit();
    ++issued;
    slot_in = slot_in == kFwdStages - 1 ? 0 : slot_in + 1;
  };
  // wait for the next step's rows, put one more in flight; returns its slot
  auto advance = [&]() {
    tc::cp_async_wait<kFwdStages - 2>();
    __syncwarp();  // the rows are in for every lane, and the last slot is read
    issue();
    const int slot = slot_out;
    slot_out = slot_out == kFwdStages - 1 ? 0 : slot_out + 1;
    return slot;
  };

#pragma unroll
  for (int j = 0; j < kFwdStages - 1; ++j) issue();
  if (threadIdx.x < kThreads) stage_frags(S.w, wk, wv, qfull, ln1g, ln1b);
  for (int e = threadIdx.x; e < kE * kE / 2; e += kFwdThreads)
    S.wkb[e / (kE / 2)][e % (kE / 2)] = tc::pack_bf16(wk[2 * e], wk[2 * e + 1]);
  __syncthreads();  // the fragments are staged

  // -- pass 1: the raw score maxima of rows h, gq (+ 8) over the thread's tokens --
  float mraw[kH][2];
  int mbase[kH][2];  // the first token column of the tile where mraw was reached
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    mraw[h][0] = mraw[h][1] = -INFINITY;
    mbase[h][0] = mbase[h][1] = 0;
  }
  for (int j = 0; j < mine; ++j) {
    const int slot = advance();
    uint32_t ax[2][4];
    slot_x2<kDense>(S.w, ring.rows[slot], ring.counts[slot], eps, ax);
    if (j < kCacheTiles) {
#pragma unroll
      for (int k = 0; k < 2; ++k)
        S.x2[warp][j][k][lane] = make_uint4(ax[k][0], ax[k][1], ax[k][2], ax[k][3]);
    }
    const int t0 = tile_t0(j) + 2 * tq;  // the thread's token columns: t0 + l (+ 8)
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      uint32_t ka[2];
      head_proj(S.w, ax, h, ka);
      float s[2][4];
      head_scores(S.w, ka, h, s);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float tmax = fmaxf(fmaxf(s[0][2 * rr], s[0][2 * rr + 1]),
                                 fmaxf(s[1][2 * rr], s[1][2 * rr + 1]));
        mbase[h][rr] = tmax > mraw[h][rr] ? t0 : mbase[h][rr];
        mraw[h][rr] = fmaxf(mraw[h][rr], tmax);
      }
    }
  }
  // each row's max and where it is first reached: the quad, warps w + 8
  // into w, then those 8 warps
  const int pair = warp % (kFwdWarps / 2);
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
        take_max(mraw[h][rr], mbase[h][rr], __shfl_xor_sync(0xffffffffu, mraw[h][rr], o),
                 __shfl_xor_sync(0xffffffffu, mbase[h][rr], o));
  for (int half = 1; half >= 0; --half) {
    if (warp / (kFwdWarps / 2) == half && tq == 0) {
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int hq = h * kQ + gq + 8 * rr;
          if (half == 0) take_max(mraw[h][rr], mbase[h][rr], S.wmax[pair][hq], S.wbase[pair][hq]);
          S.wmax[pair][hq] = mraw[h][rr];
          S.wbase[pair][hq] = mbase[h][rr];
        }
    }
    __syncthreads();
  }
  if (threadIdx.x < kQH) {
    float M = S.wmax[0][threadIdx.x];
    int base = S.wbase[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kFwdWarps / 2; ++w)
      take_max(M, base, S.wmax[w][threadIdx.x], S.wbase[w][threadIdx.x]);
    S.m[threadIdx.x] = M * scale;  // -inf without a token
    S.base[threadIdx.x] = base;
  }
  __syncthreads();
  // m = the largest exact score of a row's 4 candidates, tokens base + {0,
  // 1, 8, 9}: quad q of the CTA takes row q / 2's (+ 8 if q is odd)
  if (N > 0) {
    static_assert(kFwdThreads / 4 == 2 * kQH, "two candidates a quad");
    const int qd = 8 * warp + gq, hq = qd >> 1;
    const float2 sx = exact_scores<kDense>(S.w, S.wkb, counts, src, qfull, b,
                                           S.base[hq] + 8 * (qd & 1), hq / kQ, hq % kQ, N, eps);
    if (tq == 0) {
      S.exact[hq][2 * (qd & 1)] = sx.x;
      S.exact[hq][2 * (qd & 1) + 1] = sx.y;
    }
    __syncthreads();
    if (threadIdx.x < kQH) {
      const float* x = S.exact[threadIdx.x];
      S.m[threadIdx.x] = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])) * scale;
    }
  }
  __syncthreads();

  // -- pass 2: e against m as the backward takes it, den, num ------------------------
  // e = 2^(s scale log2(e) - m log2(e)); rows h, gq (+ 8): den's partial over
  // the thread's tokens, num's C fragments (columns d = 2tq, 2tq + 1)
  const float c2 = scale * kLog2e;
  float m2[kH][2], dsum[kH][2], acc[kH][4];
#pragma unroll
  for (int h = 0; h < kH; ++h) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m2[h][rr] = S.m[h * kQ + gq + 8 * rr] * kLog2e;
      dsum[h][rr] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[h][c] = 0.f;
  }
  for (int k = 0; k < mine; ++k) {
    const int j = mine - 1 - k, lim = N - tile_t0(j);
    uint32_t ax[2][4];
    if (j >= kCacheTiles) {  // past the cache: its rows again
      const int slot = advance();
      slot_x2<kDense>(S.w, ring.rows[slot], ring.counts[slot], eps, ax);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 a = S.x2[warp][j][i][lane];
        ax[i][0] = a.x;
        ax[i][1] = a.y;
        ax[i][2] = a.z;
        ax[i][3] = a.w;
      }
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      uint32_t ka[2], va[2];
      head_proj(S.w, ax, h, ka);
      head_proj(S.w, ax, 4 + h, va);
      float s[2][4], e[2][4];
      head_scores(S.w, ka, h, s);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) e[n][c] = ex2(fmaf(s[n][c], c2, -m2[h][c >> 1]));
      if (lim < 16) {  // the cell's last tile: 0 for the tokens past N
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) e[n][c] = 8 * n + 2 * tq + (c & 1) < lim ? e[n][c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        dsum[h][rr] += (e[0][2 * rr] + e[0][2 * rr + 1]) + (e[1][2 * rr] + e[1][2 * rr + 1]);
      // num += bf(e) (rows queries, k the 16 tokens) @ bf(v) (k tokens, n d,
      // v's fragments transposed across the warp): the tile summed from zero,
      // added in f32
      const uint32_t ae[4] = {tc::pack_bf16(e[0][0], e[0][1]), tc::pack_bf16(e[0][2], e[0][3]),
                              tc::pack_bf16(e[1][0], e[1][1]), tc::pack_bf16(e[1][2], e[1][3])};
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      tc::mma_bf16(t, ae, tc::transpose8x8(va[0]), tc::transpose8x8(va[1]));
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[h][c] += t[c];
    }
  }

  // -- the warps' sums, added in warp order --------------------------------------------
  tc::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring, which `part` overlays
  float* P = S.part[warp];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int hq = h * kQ + gq + 8 * rr;
      const float d = quad_sum(dsum[h][rr]);
      *reinterpret_cast<float2*>(P + kPn + hq * kHD + 2 * tq) =
          make_float2(acc[h][2 * rr], acc[h][2 * rr + 1]);
      if (tq == 0) P[kPd + hq] = d;
    }
  __syncthreads();
  {
    static_assert(kQH * kHD == kFwdThreads, "a thread a (query, head) row's column");
    const int hq = threadIdx.x / kHD, d = threadIdx.x % kHD;
    float a = 0.f, dd = 0.f;
#pragma unroll
    for (int w = 0; w < kFwdWarps; ++w) {
      a += S.part[w][kPn + hq * kHD + d];
      if (d == 0) dd += S.part[w][kPd + hq];
    }
    num[((size_t)b * kQ + hq % kQ) * kE + (hq / kQ) * kHD + d] = a;
    if (d == 0) {
      den[(size_t)b * kQH + hq] = dd;
      mout[(size_t)b * kQH + hq] = S.m[hq];
    }
  }
}


// ---------------------------------------------------------------------------
// backward: tensor cores, fixed-order sums
// ---------------------------------------------------------------------------
//
// The warp tile is `own_col`'s. Per head the scores, exponentials and
// cotangents stay in C fragments, which repack as the next product's A
// fragments.

constexpr int kStageT = 16 * kWarps;     // tokens a stage: a 16-token tile a warp
constexpr int kDenseCells = 4;           // dense: cells a CTA, a stage each
constexpr int kWindowChunk = 512;        // window: tokens a CTA
constexpr int kBP = kE + 8;              // bf16 row pitch of a staged (token, E) tile: 80 bytes
// a CTA's partial sums: dwk, dwv (E, E) each, dqfull's head blocks (Q*H, HD),
// dln1g, dln1b (E each)
constexpr int kPartDq = 2 * kE * kE, kPartLn = kPartDq + kQH * kHD;
constexpr int kPartFloats = kPartLn + 2 * kE;
// the ordered sum's outputs: dqfull (Q*H, E) whole, dwk, dwv, dln1g, dln1b
constexpr int kSumOuts = kQH * kE + 2 * kE * kE + 2 * kE;
constexpr int kSumWBlocks = kSumOuts / 32;
static_assert(kSumOuts % 32 == 0 && kWindowChunk % kStageT == 0, "tiling");

// the embedding column of column n of n tile c of dx2's C fragments
__device__ __forceinline__ int dx_col(int c, int n) {
  return 4 * (n >> 1) + 2 * (c & 1) + (n & 1) + 16 * (c >> 1);
}

// The backward CTA's shared memory: B fragments staged per CTA (the weights
// and the queries, bf16) and per cell (dnum in three bf16 passes, m, dden);
// the stage of kStageT tokens that the CTA's weight gradients read (bf(x2),
// bf(dk), bf(dv), bf16).
struct BwdSmem {
  WeightFrags w;                // x2 @ [wk | wv], the scores' bf(q) (k = d), ln1g, ln1b
  uint32_t dx[2][2][4][32][2];  // dk @ wk^T, dv @ wv^T: matrix, k step, n tile, lane
  uint32_t q16[kH][32][2];      // dk = ds @ q (k = queries): head, lane
  uint32_t dn8[kH][2][3][32];   // v . dnum (k = d): head, n tile, pass (hi, mid, lo), lane
  uint32_t dn16[kH][3][32][2];  // dv = bf(e) @ dnum (k = queries): head, pass, lane
  float m[kQH], dd[kQH];  // m in base 2: m log2(e)
  uint16_t xb[kStageT][kBP], dk[kStageT][kBP], dv[kStageT][kBP];
};

__device__ __forceinline__ void store_pair(uint16_t* dst, uint32_t v) {
  *reinterpret_cast<uint32_t*>(dst) = v;
}

// the per-CTA fragments: `stage_frags`, then bf(wk), bf(wv) transposed and
// bf(q) with the queries on k
__device__ void stage_weights(BwdSmem& S, const float* wk, const float* wv, const float* qfull,
                              const float* ln1g, const float* ln1b) {
  static_assert(kH * 32 == kThreads && 2 * kQH == kThreads, "the staging maps");
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3, w4 = threadIdx.x >> 5;
  stage_frags(S.w, wk, wv, qfull, ln1g, ln1b);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = w4, j = k & 1, mat = k >> 1;  // entry threadIdx.x + 128 k: [mat][j][c][lane]
    const float* row = (mat ? wv : wk) + dx_col(c, gq) * kE + 16 * j + 2 * tq;
    S.dx[mat][j][c][lane][0] = tc::pack_bf16(row[0], row[1]);
    S.dx[mat][j][c][lane][1] = tc::pack_bf16(row[8], row[9]);
  }
  {
    const int h = w4;
    const float* q = qfull + (size_t)(h * kQ + 2 * tq) * kE + h * kHD + gq;
    S.q16[h][lane][0] = tc::pack_bf16(q[0], q[kE]);
    S.q16[h][lane][1] = tc::pack_bf16(q[8 * kE], q[9 * kE]);
  }
}

// the per-cell fragments of cell b: dnum (Q, E) in three bf16 passes; m, dden
__device__ void stage_cell(BwdSmem& S, const float* dnum, const float* dden, const float* mstat,
                           int b) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3, w4 = threadIdx.x >> 5;
  const float* dn = dnum + (size_t)b * kQ * kE;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int u = w4 & 1, h = (w4 >> 1) + 2 * k;
    const float* v = dn + (8 * u + gq) * kE + h * kHD + 2 * tq;
    tc::split3_bf16(v[0], v[1], S.dn8[h][u][0][lane], S.dn8[h][u][1][lane], S.dn8[h][u][2][lane]);
  }
  {
    const int h = w4;
    const float* v = dn + 2 * tq * kE + h * kHD + gq;
    tc::split3_bf16(v[0], v[kE], S.dn16[h][0][lane][0], S.dn16[h][1][lane][0],
                    S.dn16[h][2][lane][0]);
    tc::split3_bf16(v[8 * kE], v[9 * kE], S.dn16[h][0][lane][1], S.dn16[h][1][lane][1],
                    S.dn16[h][2][lane][1]);
  }
  if (threadIdx.x < kQH) S.m[threadIdx.x] = mstat[(size_t)b * kQH + threadIdx.x] * kLog2e;
  else S.dd[threadIdx.x - kQH] = dden[(size_t)b * kQH + threadIdx.x - kQH];
}

// One warp's 16 tokens t0 + gq (+ 8) of cell b, those below `tend` live:
// recompute the forward given m, run the backward to the token's gradient
// (window: written to demb; dense: added times log1p(count) into dt, the
// thread's two genes), add the LayerNorm sums into dlg and dlb and each
// head's block of dqfull, ds^T bf(k), into accq, and stage bf(x2), bf(dk)
// and bf(dv) at stage rows row0.. for the CTA's weight gradients. A row at
// or past `tend` recomputes token tend - 1 with its cotangents zeroed, so it
// adds nothing.
template <bool kDense>
__device__ __forceinline__ void token_tile(BwdSmem& S, const float* __restrict__ counts,
                                           const float* __restrict__ src, float* __restrict__ demb,
                                           int b, int t0, int tend, int N, int row0, float eps,
                                           float scale, float (&dlg)[8], float (&dlb)[8],
                                           float (&dt)[2][8], float (&accq)[kH][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float x[2][8], rstd[2], lc[2];
  bool live[2];
  uint32_t ax[2][4];  // bf(x2) as the A fragments of k steps 0 and 1

  // -- load, LayerNorm, bf(x2) -------------------------------------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + gq + 8 * r;
    live[r] = t < tend;
    const int tt = live[r] ? t : tend - 1;
    const float* row = kDense ? src + (size_t)tt * kE : src + ((size_t)b * N + tt) * kE;
    lc[r] = kDense ? log1pf(__ldg(counts + (size_t)b * N + tt)) : 1.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + 16 * half + 4 * tq));
      x[r][4 * half] = kDense ? v.x * lc[r] : v.x;
      x[r][4 * half + 1] = kDense ? v.y * lc[r] : v.y;
      x[r][4 * half + 2] = kDense ? v.z * lc[r] : v.z;
      x[r][4 * half + 3] = kDense ? v.w * lc[r] : v.w;
    }
    rstd[r] = layer_norm_row(S.w, x[r], eps, r, ax);  // x -> xhat
    uint16_t* xs = S.xb[row0 + gq + 8 * r];
    *reinterpret_cast<uint2*>(xs + 4 * tq) = make_uint2(ax[0][r], ax[0][2 + r]);
    *reinterpret_cast<uint2*>(xs + 16 + 4 * tq) = make_uint2(ax[1][r], ax[1][2 + r]);
  }

  // -- per head: k, v, the scores, e, dv, ds, dk ------------------------------
  uint32_t dkp[kH][2], dvp[kH][2];  // bf(dk), bf(dv): rows gq, gq + 8, columns 2tq..
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    uint32_t ka[2], va[2];
    head_proj(S.w, ax, h, ka);
    head_proj(S.w, ax, 4 + h, va);
    // n tile u of the scores and of v . dnum: queries 8u + 2tq (+ 1), rows gq
    // (entries 0, 1) and gq + 8 (2, 3)
    float sc[2][4], dn[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[u][c] = dn[u][c] = 0.f;
      tc::mma_bf16_k8(sc[u], ka, S.w.q8[h][u][lane]);
#pragma unroll
      for (int p = 2; p >= 0; --p) tc::mma_bf16_k8(dn[u], va, S.dn8[h][u][p][lane]);
    }
    float eb[2][4], ds[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int hq = h * kQ + 8 * u + 2 * tq;
      const float2 mq = *reinterpret_cast<const float2*>(&S.m[hq]);
      const float2 dq = *reinterpret_cast<const float2*>(&S.dd[hq]);
      // e = 2^(s log2(e) - m log2(e)), and 0 on a row past the edge
      const float mr[4] = {live[0] ? mq.x : INFINITY, live[0] ? mq.y : INFINITY,
                           live[1] ? mq.x : INFINITY, live[1] ? mq.y : INFINITY};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = ex2(fmaf(sc[u][c], scale * kLog2e, -mr[c]));
        eb[u][c] = e;
        // d(e) = the num path's cotangent, rounded where e was, + dden
        ds[u][c] = e * (bf(dn[u][c]) + ((c & 1) ? dq.y : dq.x)) * scale;
      }
    }
    const uint32_t ae[4] = {tc::pack_bf16(eb[0][0], eb[0][1]), tc::pack_bf16(eb[0][2], eb[0][3]),
                            tc::pack_bf16(eb[1][0], eb[1][1]), tc::pack_bf16(eb[1][2], eb[1][3])};
    uint32_t as[3][4];  // ds as A fragments (rows tokens, k queries): hi, mid, lo
#pragma unroll
    for (int f = 0; f < 4; ++f)
      tc::split3_bf16(ds[f >> 1][2 * (f & 1)], ds[f >> 1][2 * (f & 1) + 1], as[0][f], as[1][f],
                      as[2][f]);
    // dqfull's block: ds^T (rows queries, k tokens) @ bf(k), its fragments
    // transposed across the warp; the 16 tokens summed from zero
    const uint32_t bk0 = tc::transpose8x8(ka[0]), bk1 = tc::transpose8x8(ka[1]);
    float cdv[4] = {0.f, 0.f, 0.f, 0.f}, cdk[4] = {0.f, 0.f, 0.f, 0.f};
    float cq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 2; p >= 0; --p) {
      tc::mma_bf16(cdv, ae, S.dn16[h][p][lane][0], S.dn16[h][p][lane][1]);
      tc::mma_bf16(cdk, as[p], S.q16[h][lane][0], S.q16[h][lane][1]);
      const uint32_t at[4] = {tc::transpose8x8(as[p][0]), tc::transpose8x8(as[p][2]),
                              tc::transpose8x8(as[p][1]), tc::transpose8x8(as[p][3])};
      tc::mma_bf16(cq, at, bk0, bk1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) accq[h][i] += cq[i];
    dkp[h][0] = tc::pack_bf16(cdk[0], cdk[1]);
    dkp[h][1] = tc::pack_bf16(cdk[2], cdk[3]);
    dvp[h][0] = tc::pack_bf16(cdv[0], cdv[1]);
    dvp[h][1] = tc::pack_bf16(cdv[2], cdv[3]);
    store_pair(&S.dk[row0 + gq][h * kHD + 2 * tq], dkp[h][0]);
    store_pair(&S.dk[row0 + gq + 8][h * kHD + 2 * tq], dkp[h][1]);
    store_pair(&S.dv[row0 + gq][h * kHD + 2 * tq], dvp[h][0]);
    store_pair(&S.dv[row0 + gq + 8][h * kHD + 2 * tq], dvp[h][1]);
  }

  // -- dx2 = bf(dk @ wk^T) + bf(dv @ wv^T), n tiles in `dx_col` order ------------
  float dxk[4][4], dxv[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) dxk[c][i] = dxv[c][i] = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t ak[4] = {dkp[2 * j][0], dkp[2 * j][1], dkp[2 * j + 1][0], dkp[2 * j + 1][1]};
    const uint32_t av[4] = {dvp[2 * j][0], dvp[2 * j][1], dvp[2 * j + 1][0], dvp[2 * j + 1][1]};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      tc::mma_bf16(dxk[c], ak, S.dx[0][j][c][lane][0], S.dx[0][j][c][lane][1]);
      tc::mma_bf16(dxv[c], av, S.dx[1][j][c][lane][0], S.dx[1][j][c][lane][1]);
    }
  }

  // -- the LayerNorm backward: the token's gradient ---------------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float d[8], m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = u >> 1, i = 2 * r + (u & 1);
      const float dx2 = bf(dxk[c][i]) + bf(dxv[c][i]);
      dlg[u] = fmaf(dx2, x[r][u], dlg[u]);
      dlb[u] += dx2;
      d[u] = dx2 * S.w.g[own_col(tq, u)];  // d(xhat)
      m1 += d[u];
      m2 = fmaf(d[u], x[r][u], m2);
    }
    m1 = quad_sum(m1) / kE;
    m2 = quad_sum(m2) / kE;
#pragma unroll
    for (int u = 0; u < 8; ++u) d[u] = rstd[r] * (d[u] - m1 - x[r][u] * m2);
    if (kDense) {
#pragma unroll
      for (int u = 0; u < 8; ++u) dt[r][u] = fmaf(d[u], lc[r], dt[r][u]);
    } else if (live[r]) {
      float* out = demb + ((size_t)b * N + t0 + gq + 8 * r) * kE + 4 * tq;
      *reinterpret_cast<float4*>(out) = make_float4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<float4*>(out + 16) = make_float4(d[4], d[5], d[6], d[7]);
    }
  }
}

// The CTA's weight gradients over a stage's kStageT tokens: warp w adds dwk
// (w < 2) or dwv, rows 16 (w & 1) .. + 15, into acc (n tiles of 8 columns);
// the stage's k steps summed from zero on the tensor cores and added in f32.
__device__ __forceinline__ void stage_products(const BwdSmem& S, float (&acc)[4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint16_t(*grad)[kBP] = (warp >> 1) ? S.dv : S.dk;
  // ldmatrix rows: matrix lane >> 3 of an x4 load
  const int ra = (lane & 7) + 8 * (lane >> 4), ca = 16 * (warp & 1) + 8 * ((lane >> 3) & 1);
  const int rb = (lane & 7) + 8 * ((lane >> 3) & 1), cb = 8 * (lane >> 4);
  float t[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) t[c][i] = 0.f;
#pragma unroll
  for (int s = 0; s < kStageT / 16; ++s) {
    uint32_t a[4];  // bf(x2)^T: rows e, k = the 16 tokens
    tc::ldsm_x4_trans(a, &S.xb[16 * s + ra][ca]);
#pragma unroll
    for (int cp = 0; cp < 2; ++cp) {
      uint32_t bb[4];  // b0, b1 of n tiles 2cp and 2cp + 1
      tc::ldsm_x4_trans(bb, &grad[16 * s + rb][16 * cp + cb]);
      tc::mma_bf16(t[2 * cp], a, bb[0], bb[1]);
      tc::mma_bf16(t[2 * cp + 1], a, bb[2], bb[3]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] += t[c][i];
}

// Dense: a CTA takes genes [64 x, 64 x + 64) of cells [4 y, 4 y + 4), a stage a
// cell. Window: a CTA takes tokens [512 x, 512 x + 512) of cell y, a stage
// 64 tokens. Writes its partial sums to ws + (y * gridDim.x + x) *
// kPartFloats and, dense, its genes' dtable rows summed over its cells to
// the cell group's rows after every CTA's partials.
template <bool kDense>
__global__ void __launch_bounds__(kThreads, 4)
pool_bwd_kernel(const float* __restrict__ counts, const float* __restrict__ src,
                const float* __restrict__ qfull, const float* __restrict__ ln1g,
                const float* __restrict__ ln1b, const float* __restrict__ wk,
                const float* __restrict__ wv, const float* __restrict__ mstat,
                const float* __restrict__ dnum, const float* __restrict__ dden,
                float* __restrict__ demb, float* __restrict__ ws, int B, int N, float eps,
                float scale) {
  extern __shared__ __align__(16) float smem[];
  BwdSmem& S = *reinterpret_cast<BwdSmem*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  stage_weights(S, wk, wv, qfull, ln1g, ln1b);

  const int b0 = kDense ? blockIdx.y * kDenseCells : blockIdx.y;
  const int b1 = kDense ? min(B, b0 + kDenseCells) : b0 + 1;
  const int t0 = blockIdx.x * (kDense ? kStageT : kWindowChunk);
  const int tend = min(N, t0 + (kDense ? kStageT : kWindowChunk));
  float acc[4][4], accq[kH][4], dlg[8], dlb[8], dt[2][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c][i] = accq[c][i] = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) dlg[u] = dlb[u] = dt[0][u] = dt[1][u] = 0.f;

  for (int b = b0; b < b1; ++b) {
    stage_cell(S, dnum, dden, mstat, b);
    __syncthreads();  // the fragments are staged
    for (int t = t0; t < tend; t += kStageT) {
      token_tile<kDense>(S, counts, src, demb, b, t + 16 * warp, tend, N, 16 * warp, eps, scale,
                         dlg, dlb, dt, accq);
      __syncthreads();  // the stage is written
      stage_products(S, acc);
      __syncthreads();  // the stage and the cell's fragments are read
    }
  }

  // -- the CTA's partial sums ----------------------------------------------------
  float* part = ws + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kPartFloats;
  float* dw = part + (warp >> 1) * kE * kE + (16 * (warp & 1) + gq) * kE + 2 * tq;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    *reinterpret_cast<float2*>(dw + 8 * c) = make_float2(acc[c][0], acc[c][1]);
    *reinterpret_cast<float2*>(dw + 8 * kE + 8 * c) = make_float2(acc[c][2], acc[c][3]);
  }
  // dqfull's head blocks and the LayerNorm sums, per warp (the LayerNorm's
  // over the warp's rows: the lanes of one tq), then the warps in order
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      dlg[u] += __shfl_xor_sync(0xffffffffu, dlg[u], o);
      dlb[u] += __shfl_xor_sync(0xffffffffu, dlb[u], o);
    }
  constexpr int kRed = kPartFloats - kPartDq;  // a warp's dqfull blocks and LayerNorm sums
  static_assert(kWarps * kRed * 4 <= 3 * sizeof(BwdSmem::xb), "the reduction fits the stage");
  float* red = reinterpret_cast<float*>(&S.xb[0][0]) + warp * kRed;  // free since the last barrier
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    float* q = red + (h * kQ + gq) * kHD + 2 * tq;
    *reinterpret_cast<float2*>(q) = make_float2(accq[h][0], accq[h][1]);
    *reinterpret_cast<float2*>(q + 8 * kHD) = make_float2(accq[h][2], accq[h][3]);
  }
  if (gq == 0) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      red[kPartLn - kPartDq + own_col(tq, u)] = dlg[u];
      red[kPartLn - kPartDq + kE + own_col(tq, u)] = dlb[u];
    }
  }
  __syncthreads();
  red = reinterpret_cast<float*>(&S.xb[0][0]);
  for (int i = threadIdx.x; i < kRed; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * kRed + i];
    part[kPartDq + i] = s;
  }
  if (kDense) {
    float* tp = ws + (size_t)gridDim.x * gridDim.y * kPartFloats + (size_t)blockIdx.y * N * kE;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = t0 + 16 * warp + gq + 8 * r;
      if (g < tend) {
        float* out = tp + (size_t)g * kE + 4 * tq;
        *reinterpret_cast<float4*>(out) = make_float4(dt[r][0], dt[r][1], dt[r][2], dt[r][3]);
        *reinterpret_cast<float4*>(out + 16) = make_float4(dt[r][4], dt[r][5], dt[r][6], dt[r][7]);
      }
    }
  }
}

// The ordered sums of the CTAs' partials, with 32 x 32 threads a block:
// blocks [0, kSumWBlocks) take 32 outputs of (dqfull, dwk, dwv, dln1g, dln1b)
// each, thread (x, y) adding partials y, y + 32, ... in order, then row y = 0
// the 32 sums in order (dqfull's blocks off the head diagonal are written
// 0); the dense variant's further blocks take 1,024 entries of dtable each,
// adding the cell groups' rows in order.
__global__ void __launch_bounds__(1024)
pool_bwd_sum(const float* __restrict__ ws, int nparts, int ngroups, int N,
             float* __restrict__ dtable, float* __restrict__ dqfull, float* __restrict__ dwk,
             float* __restrict__ dwv, float* __restrict__ dln1g, float* __restrict__ dln1b) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (blockIdx.x >= kSumWBlocks) {
    const float* tp = ws + (size_t)nparts * kPartFloats;
    const size_t n = (size_t)N * kE, i = (size_t)(blockIdx.x - kSumWBlocks) * 1024 + ty * 32 + tx;
    if (i < n) {
      float v = 0.f;
      for (int g = 0; g < ngroups; ++g) v += tp[g * n + i];
      dtable[i] = v;
    }
    return;
  }
  __shared__ float red[32][33];
  const int o = blockIdx.x * 32 + tx;
  int ci;
  float* dst;
  if (o < kQH * kE) {
    const int hq = o / kE, c = o % kE;
    ci = c / kHD == hq / kQ ? kPartDq + hq * kHD + c % kHD : -1;
    dst = dqfull + o;
  } else if (o < kQH * kE + 2 * kE * kE) {
    ci = o - kQH * kE;
    dst = ci < kE * kE ? dwk + ci : dwv + (ci - kE * kE);
  } else {
    const int j = o - kQH * kE - 2 * kE * kE;
    ci = kPartLn + j;
    dst = j < kE ? dln1g + j : dln1b + (j - kE);
  }
  float v = 0.f;
  if (ci >= 0) {
#pragma unroll 4
    for (int p = ty; p < nparts; p += 32) v += ws[(size_t)p * kPartFloats + ci];
  }
  red[ty][tx] = v;
  __syncthreads();
  if (ty == 0) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < 32; ++y) s += red[y][tx];
    *dst = ci >= 0 ? s : 0.f;
  }
}

dim3 bwd_grid(int B, int N, bool dense) {
  if (B <= 0 || N <= 0) return dim3(0, 0);
  return dense ? dim3((N + kStageT - 1) / kStageT, (B + kDenseCells - 1) / kDenseCells)
               : dim3((N + kWindowChunk - 1) / kWindowChunk, B);
}

long long bwd_workspace_floats(int B, int N, bool dense) {
  const dim3 grid = bwd_grid(B, N, dense);
  return (long long)grid.x * grid.y * kPartFloats + (dense ? (long long)grid.y * N * kE : 0);
}

// The dynamic shared memory each kernel is already allowed, per device: the
// attribute is set only when a launch needs more than before (and, for the
// backward, the largest shared-memory carveout, so that four CTAs fit).
constexpr int kMaxDevices = 64;
std::atomic<long long> g_allowed[4][kMaxDevices];

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<long long>* allowed, long long bytes,
                       bool max_carveout = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= allowed[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && max_carveout)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
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
  auto kernel = pool_fwd_mma<kDense>;
  cudaError_t err =
      allow_smem(kernel, g_allowed[kDense ? 0 : 1], (long long)sizeof(FwdSmem), true);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kFwdThreads, sizeof(FwdSmem), (cudaStream_t)stream>>>(
      (const float*)counts, (const float*)src, (const float*)qfull, (const float*)ln1g,
      (const float*)ln1b, (const float*)wk, (const float*)wv, (float*)num, (float*)den,
      (float*)m, N, eps, scale);
  return (int)cudaGetLastError();
}

template <bool kDense>
int launch_bwd(const void* counts, const void* src, const void* qfull, const void* ln1g,
               const void* ln1b, const void* wk, const void* wv, const void* m,
               const void* dnum, const void* dden, void* dsrc, void* dqfull, void* dln1g,
               void* dln1b, void* dwk, void* dwv, void* ws, int B, int N, int E, int H, int Q,
               float eps, float scale, void* stream) {
  if (!supported(E, H, Q)) return (int)cudaErrorInvalidValue;
  const dim3 grid = bwd_grid(B, N, kDense);
  if (grid.x > 0) {
    auto kernel = pool_bwd_kernel<kDense>;
    cudaError_t err =
        allow_smem(kernel, g_allowed[kDense ? 2 : 3], (long long)sizeof(BwdSmem), true);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, sizeof(BwdSmem), (cudaStream_t)stream>>>(
        (const float*)counts, (const float*)src, (const float*)qfull, (const float*)ln1g,
        (const float*)ln1b, (const float*)wk, (const float*)wv, (const float*)m,
        (const float*)dnum, (const float*)dden, (float*)dsrc, (float*)ws, B, N, eps, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = kSumWBlocks + (kDense ? (int)(((long long)N * kE + 1023) / 1024) : 0);
  const dim3 threads(32, 32);
  pool_bwd_sum<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (int)(grid.x * grid.y), kDense ? (int)grid.y : 0, kDense ? N : 0,
      (float*)dsrc, (float*)dqfull, (float*)dwk, (float*)dwv, (float*)dln1g, (float*)dln1b);
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

// The token rows a cell of N tokens has the forwards read: every row in
// pass 1, the 4 candidates of each (query, head) row's max, and again in
// pass 2 the rows past the warps' bf(x2) caches.
long long scldm_encoder_pool_forward_rows(int N) {
  return N > 0 ? (long long)N + 4 * kQH + max(0, N - 16 * kFwdWarps * kCacheTiles) : 0;
}

// The floats of the backwards' device workspace at B cells of N tokens
// (dense: N genes), 0 where there is no token.
long long scldm_encoder_pool_workspace_floats(int B, int N, int dense) {
  return bwd_workspace_floats(B, N, dense != 0);
}

// Backwards, given the forward's m and the cotangents dnum (B, Q, E) and
// dden (B, Q*H): write dqfull (Q*H, E: its head blocks, 0 elsewhere), dln1g,
// dln1b (E), dwk, dwv (E, E) and dtable (G, E) (dense) or demb (B, S, E)
// (window), each summed in a fixed order; `workspace` holds
// scldm_encoder_pool_workspace_floats(B, N, dense) floats. Two launches.
// Same conventions as the forwards.
int scldm_encoder_pool_backward(const void* counts, const void* table, const void* qfull,
                                const void* ln1g, const void* ln1b, const void* wk,
                                const void* wv, const void* m, const void* dnum,
                                const void* dden, void* dtable, void* dqfull, void* dln1g,
                                void* dln1b, void* dwk, void* dwv, void* workspace, int B, int N,
                                int E, int H, int Q, float eps, float scale, void* stream) {
  return launch_bwd<true>(counts, table, qfull, ln1g, ln1b, wk, wv, m, dnum, dden, dtable,
                          dqfull, dln1g, dln1b, dwk, dwv, workspace, B, N, E, H, Q, eps, scale,
                          stream);
}

int scldm_window_pool_backward(const void* emb, const void* qfull, const void* ln1g,
                               const void* ln1b, const void* wk, const void* wv, const void* m,
                               const void* dnum, const void* dden, void* demb, void* dqfull,
                               void* dln1g, void* dln1b, void* dwk, void* dwv, void* workspace,
                               int B, int N, int E, int H, int Q, float eps, float scale,
                               void* stream) {
  return launch_bwd<false>(nullptr, emb, qfull, ln1g, ln1b, wk, wv, m, dnum, dden, demb, dqfull,
                           dln1g, dln1b, dwk, dwv, workspace, B, N, E, H, Q, eps, scale, stream);
}

}  // extern "C"
