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
// What bounds it on an H100. Forward: operations, about 3.1k multiply-adds a
// token (2 E^2 for k and v, Q*E each for the scores and the pooled values),
// or one read of the (B, S, E) window (window: 100.7 MB at B=128, S=6,147).
// Backward: about 9.2k multiply-adds a token, which the bf16 tensor cores
// would run in 5 us at parse1m (B=128, G=2,000) and 15 us at the dentate
// window; the window's bytes (the window read and demb written, 201 MB) take
// 60 us. As built, latency bounds it: each warp's 16-token tile is a chain of
// about 1,100 dependent instructions (products, exponentials, bf16 splits,
// the LayerNorm and its backward) and 16 warps an SM (128 registers a
// thread) hide only part of it.
//
// What the design does about it. Forward: one CTA per cell, 256 threads; a
// tile of 256 tokens, one per thread, computes LayerNorm, k, v and the 64
// scores in registers against bf(wk), bf(wv) and bf(q) staged once in shared
// memory (broadcast reads, 16-byte vectors), and stages the scores and bf(v);
// then each thread owns one (query, head) and a quarter of the tile's tokens
// for the online softmax: the four parts agree on the tile max through shared
// memory, keep their own partial sums under that common max, and add them at
// the end.
// Backward: every product on mma.sync bf16 (m16n8k16, m16n8k8 where a head's
// 8 columns are the depth). A CTA of 4 warps and 32 KB of shared memory, four
// on an SM (16 warps), takes 64 genes of 4 cells (dense: 32 x 32 CTAs at
// parse1m, two waves) or 512 window tokens of one cell, a stage of 64 tokens
// of one cell at a time. Each warp runs 16 tokens in registers: 16-byte loads
// of the rows, the LayerNorm on the thread's own 8 columns (a quad of lanes
// a row), the k/v recompute, then per head the scores, e, v . dnum, dv, dk
// and the head's block of dqfull, each C fragment repacked (or transposed
// across the warp by movmatrix) as the next product's A or B fragment, then
// dx2 and the LayerNorm backward; it writes demb once (16-byte stores), keeps
// dqfull's blocks and the LayerNorm sums in registers, and stages bf(x2),
// bf(dk) and bf(dv). The CTA then adds the stage's dwk and dwv over its 64
// tokens (token-axis products read by ldmatrix.trans), a warp per output
// block, the stage summed from zero on the tensor cores and added in f32.
// Where an operand is an f32 cotangent (dnum in v . dnum and dv, ds in dk and
// dqfull) it runs as three bf16 passes (hi, mid, lo: the products are rounded
// to bf16 next, so f32 accuracy keeps those roundings where f32 sums put
// them). No atomics: each CTA writes its partial sums (and, dense, its cell
// group's dtable rows) to a workspace, and a second kernel adds them in index
// order, so every gradient is written whole and repeats its bits. The
// workspace is sized by scldm_encoder_pool_workspace_floats.
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
constexpr int kFwdT = 256;             // forward: tokens per tile, one per thread
constexpr int kParts = kFwdT / kQH;    // forward: threads per (query, head) in the softmax pass
constexpr int kRS = kE + 4;            // row stride of a staged (token, E) tile: 16-byte rows
constexpr int kSS = kQH + 1;           // row stride of a staged (token, Q*H) tile: odd
static_assert(kE == 32 && kQH == 64 && kParts == 4, "the thread maps assume E=32, Q*H=64");

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// The weights the forward stages once per CTA, in floats: bf(wk), bf(wv)
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


// ---------------------------------------------------------------------------
// backward: tensor cores, fixed-order sums
// ---------------------------------------------------------------------------
//
// A warp owns a tile of 16 tokens of one cell, rows gq and gq + 8 a thread
// (lane = 4 gq + tq; tensor_core.cuh). A thread holds its rows' embedding
// columns 4tq..4tq+3 and 16+4tq..16+4tq+3 (value u = 0..7 at `own_col`), read
// and written as 16-byte vectors. Those are the columns its A fragments of
// bf(x2) hold once the k index of x2 @ W is permuted (k = 16j + 8h + 2t + l
// is column 16j + 4t + 2h + l: the B fragments of W are staged in that
// order), and the columns its C fragments of dx2 = dk @ W^T hold once the n
// index is permuted alike (`dx_col`), so the LayerNorm and its backward run
// on the thread's own values. Per head the scores, exponentials and
// cotangents stay in C fragments, which repack as the next product's A
// fragments.

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kStageT = 16 * kBwdWarps;  // tokens a stage: a 16-token tile a warp
constexpr int kDenseCells = 4;           // dense: cells a CTA, a stage each
constexpr int kWindowChunk = 512;        // window: tokens a CTA
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBP = kE + 8;              // bf16 row pitch of a staged (token, E) tile: 80 bytes
// a CTA's partial sums: dwk, dwv (E, E) each, dqfull's head blocks (Q*H, HD),
// dln1g, dln1b (E each)
constexpr int kPartDq = 2 * kE * kE, kPartLn = kPartDq + kQH * kHD;
constexpr int kPartFloats = kPartLn + 2 * kE;
// the ordered sum's outputs: dqfull (Q*H, E) whole, dwk, dwv, dln1g, dln1b
constexpr int kSumOuts = kQH * kE + 2 * kE * kE + 2 * kE;
constexpr int kSumWBlocks = kSumOuts / 32;
static_assert(kHD == 8 && kQ == 16, "the fragment maps assume heads of 8 and 16 queries");
static_assert(kSumOuts % 32 == 0 && kWindowChunk % kStageT == 0, "tiling");

// the embedding column of a thread's value u (quad lane tq)
__device__ __forceinline__ int own_col(int tq, int u) { return 4 * tq + (u & 3) + 16 * (u >> 2); }
// the embedding column of column n of n tile c of dx2's C fragments
__device__ __forceinline__ int dx_col(int c, int n) {
  return 4 * (n >> 1) + 2 * (c & 1) + (n & 1) + 16 * (c >> 1);
}

// The backward CTA's shared memory: B fragments staged per CTA (the weights
// and the queries, bf16) and per cell (dnum in three bf16 passes, m, dden);
// the stage of kStageT tokens that the CTA's weight gradients read (bf(x2),
// bf(dk), bf(dv), bf16).
struct BwdSmem {
  uint32_t kv[2][8][32][2];     // x2 @ [wk | wv]: k step, n tile (4 of k, 4 of v), lane
  uint32_t dx[2][2][4][32][2];  // dk @ wk^T, dv @ wv^T: matrix, k step, n tile, lane
  uint32_t q8[kH][2][32];       // the scores (m16n8k8, k = d): head, n tile of queries, lane
  uint32_t q16[kH][32][2];      // dk = ds @ q (k = queries): head, lane
  float g[kE], b[kE];
  uint32_t dn8[kH][2][3][32];   // v . dnum (k = d): head, n tile, pass (hi, mid, lo), lane
  uint32_t dn16[kH][3][32][2];  // dv = bf(e) @ dnum (k = queries): head, pass, lane
  float m[kQH], dd[kQH];  // m in base 2: m log2(e)
  uint16_t xb[kStageT][kBP], dk[kStageT][kBP], dv[kStageT][kBP];
};

__device__ __forceinline__ void store_pair(uint16_t* dst, uint32_t v) {
  *reinterpret_cast<uint32_t*>(dst) = v;
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

// the per-CTA fragments: bf(wk), bf(wv) both ways, bf(q); ln1g, ln1b. The
// loops have fixed trip counts, so each thread's loads issue together.
__device__ void stage_weights(BwdSmem& S, const float* wk, const float* wv, const float* qfull,
                              const float* ln1g, const float* ln1b) {
  static_assert(2 * 8 * 32 == 4 * kBwdThreads && kH * 2 * 32 == 2 * kBwdThreads &&
                    kH * 32 == kBwdThreads && 2 * kQH == kBwdThreads, "the staging maps");
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3, w4 = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = ((w4 + 4 * k) & 7), j = k >> 1;  // entry threadIdx.x + 128 k: [j][c][lane]
    const float* w = (c < 4 ? wk : wv) + 8 * (c & 3) + gq;  // column n of n tile c
    const int r = 16 * j + 4 * tq;  // the rows of k 2tq.. (b0) and 2tq + 8.. (b1)
    S.kv[j][c][lane][0] = tc::pack_bf16(w[r * kE], w[(r + 1) * kE]);
    S.kv[j][c][lane][1] = tc::pack_bf16(w[(r + 2) * kE], w[(r + 3) * kE]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = w4, j = k & 1, mat = k >> 1;  // entry threadIdx.x + 128 k: [mat][j][c][lane]
    const float* row = (mat ? wv : wk) + dx_col(c, gq) * kE + 16 * j + 2 * tq;
    S.dx[mat][j][c][lane][0] = tc::pack_bf16(row[0], row[1]);
    S.dx[mat][j][c][lane][1] = tc::pack_bf16(row[8], row[9]);
  }
  // q(i, col) = qfull[(head of col) * Q + i, col]
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int u = w4 & 1, h = (w4 >> 1) + 2 * k;
    const float* q = qfull + (size_t)(h * kQ + 8 * u + gq) * kE + h * kHD + 2 * tq;
    S.q8[h][u][lane] = tc::pack_bf16(q[0], q[1]);
  }
  {
    const int h = w4;
    const float* q = qfull + (size_t)(h * kQ + 2 * tq) * kE + h * kHD + gq;
    S.q16[h][lane][0] = tc::pack_bf16(q[0], q[kE]);
    S.q16[h][lane][1] = tc::pack_bf16(q[8 * kE], q[9 * kE]);
  }
  if (threadIdx.x < kE) S.g[threadIdx.x] = ln1g[threadIdx.x];
  else if (threadIdx.x < 2 * kE) S.b[threadIdx.x - kE] = ln1b[threadIdx.x - kE];
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
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) s += x[r][u];
    const float mean = quad_sum(s) / kE;
    float var = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[r][u] -= mean;
      var = fmaf(x[r][u], x[r][u], var);
    }
    rstd[r] = rsqrtf(quad_sum(var) / kE + eps);
    float x2[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[r][u] *= rstd[r];  // xhat
      const int c = own_col(tq, u);
      x2[u] = __fadd_rn(__fmul_rn(x[r][u], S.g[c]), S.b[c]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ax[j][r] = tc::pack_bf16(x2[4 * j], x2[4 * j + 1]);
      ax[j][2 + r] = tc::pack_bf16(x2[4 * j + 2], x2[4 * j + 3]);
    }
    uint16_t* xs = S.xb[row0 + gq + 8 * r];
    *reinterpret_cast<uint2*>(xs + 4 * tq) = make_uint2(ax[0][r], ax[0][2 + r]);
    *reinterpret_cast<uint2*>(xs + 16 + 4 * tq) = make_uint2(ax[1][r], ax[1][2 + r]);
  }

  // -- per head: k, v, the scores, e, dv, ds, dk ------------------------------
  uint32_t dkp[kH][2], dvp[kH][2];  // bf(dk), bf(dv): rows gq, gq + 8, columns 2tq..
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    float ck[4] = {0.f, 0.f, 0.f, 0.f}, cv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tc::mma_bf16(ck, ax[j], S.kv[j][h][lane][0], S.kv[j][h][lane][1]);
      tc::mma_bf16(cv, ax[j], S.kv[j][4 + h][lane][0], S.kv[j][4 + h][lane][1]);
    }
    const uint32_t ka[2] = {tc::pack_bf16(ck[0], ck[1]), tc::pack_bf16(ck[2], ck[3])};
    const uint32_t va[2] = {tc::pack_bf16(cv[0], cv[1]), tc::pack_bf16(cv[2], cv[3])};
    // n tile u of the scores and of v . dnum: queries 8u + 2tq (+ 1), rows gq
    // (entries 0, 1) and gq + 8 (2, 3)
    float sc[2][4], dn[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[u][c] = dn[u][c] = 0.f;
      tc::mma_bf16_k8(sc[u], ka, S.q8[h][u][lane]);
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
      d[u] = dx2 * S.g[own_col(tq, u)];  // d(xhat)
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
__global__ void __launch_bounds__(kBwdThreads, 4)
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
  static_assert(kBwdWarps * kRed * 4 <= 3 * sizeof(BwdSmem::xb), "the reduction fits the stage");
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
  for (int i = threadIdx.x; i < kRed; i += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) s += red[w * kRed + i];
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
               void* dln1b, void* dwk, void* dwv, void* ws, int B, int N, int E, int H, int Q,
               float eps, float scale, void* stream) {
  if (!supported(E, H, Q)) return (int)cudaErrorInvalidValue;
  const dim3 grid = bwd_grid(B, N, kDense);
  if (grid.x > 0) {
    auto kernel = pool_bwd_kernel<kDense>;
    cudaError_t err =
        allow_smem(kernel, g_allowed[kDense ? 2 : 3], (long long)sizeof(BwdSmem), true);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kBwdThreads, sizeof(BwdSmem), (cudaStream_t)stream>>>(
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
