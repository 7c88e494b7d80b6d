// One adaLN-zero DiT block forward, f32, as tensor-core GEMMs over all R*T
// tokens and an attention that streams the keys: one design for every T.
//
// Replaces the TPU kernel scldm_tpu/ops/fused_dit.py::fused_dit_block
// (Pallas body `_block_kernel`, math `_block_math`):
//
//   mod = silu(c) @ wada + bada  -> scale_a, shift_a, gate_a, scale_m, shift_m, gate_m
//         (chunk 0 multiplies and chunk 1 shifts: the reference's swapped modulate)
//   h   = LN(x) * (1 + scale_a) + shift_a            (non-affine LN, eps given)
//   x   = x + gate_a * (attn(h @ wqkv + bqkv) @ wproj + bproj)
//   h2  = LN(x) * (1 + scale_m) + shift_m
//   out = x + gate_m * ((silu(h2 @ w1) * (h2 @ w2)) @ wmlp)
//
// What bounds it on an H100: operations. One block is about 2*R*(6E^2 +
// T*(4E^2 + 2TE + 3E*Hd)) operations (10 GFLOP at the dentate sampler's R =
// 384 rows of T = 16 tokens, E = 256, Hd = 684; 5 GFLOP at the census
// sampler's R = 48 rows of T = 64), run as three TF32 tensor-core passes a
// product: 3 x 10 GFLOP at 495 TFLOP/s, 0.061 ms at the dentate shape.
//
// A CTA that holds a DiT row (or one head's (T, T) scores) re-reads the 4.7
// MB of weights from L2 for a handful of tokens and caps T; f32 FMA leaves
// the tensor cores idle. So this design (namespace `tiled`, nine launches,
// every intermediate in a device workspace of R*6E + R*T*(5E + Hd) floats):
// - The four token products (qkv, the projection, the SwiGLU's w1 | w2 and
//   its down projection) and the adaLN product over the R rows run as one
//   tiled GEMM kernel, `gemm`: a CTA of four warps takes 64 tokens by 64
//   output columns, so each weight tile staged in shared memory feeds 64
//   tokens (across DiT rows where T = 16), and the grid tiles the output
//   columns too (384 CTAs for the qkv product at the census R = 48, T = 64).
//   A and the weights stream through a ring of three 32-deep stages by
//   cp.async, two in flight while one is multiplied.
// - Products on mma.sync m16n8k8 with three TF32 passes a product, x = hi +
//   lo (tc::split_tf32): f32 accuracy (the output within about 2e-6 of its
//   largest magnitude). Each 32-deep stage is summed from zero on the tensor
//   cores and added to the running sums in f32, so no tensor-core sum runs
//   over more than 12 mma.
// - The bias, the gated residuals and silu(a) * b are the GEMM's epilogue
//   (`Out`); the w1 and w2 columns of a CTA are interleaved by groups of 8 so
//   that one thread holds a and b of the same hidden column. The LayerNorm
//   and modulate run in `ln_modulate_tokens` (one warp a token) before the
//   product that reads them, and silu(c) in `silu_rows`: folded into the
//   products' operand loads they cost more than they saved.
// - The attention (`attention`) takes one head and 64 tokens of the
//   flattened token axis a CTA and streams the keys of the DiT rows those
//   tokens lie in, 64 a tile, through a cp.async ring with an online
//   softmax; a key scores -inf unless it lies in its query's row, and key
//   blocks of 8 that share no row with a warp's 16 queries are skipped. So
//   shared memory does not grow with T: T = 16, 64 and 1,024 all run. From
//   T = kFlashMinT on, where every row fills whole query tiles, the stage
//   launches the port's long-axis flash attention kernel (flash_attention.cu,
//   the same three TF32 passes) on qkv's strided views instead: it was the
//   faster there.
// - No atomics: every sum runs in a fixed order, the same bits every run.
// Tried and slower on an H100 80GB HBM3 at 700 W: 128-token CTAs of eight
// warps (0.3198 against 0.2960 ms at T = 16, R = 384), four m16 tiles a warp
// (0.3170 against 0.3001), 128 registers a thread for four CTAs an SM
// (0.3070), 64-deep stages (2% faster, but each stage's 24-mma chain lost
// bits: 3.3e-5 against 2.4e-5 at most), and the LayerNorm folded into the
// products' prologue, the A rows kept whole in shared memory (0.59 ms: two
// CTAs an SM, and each CTA's LayerNorm ran before its first product). A
// first wgmma version (m64n64k8 .tf32 with A from registers; each stage's
// weights split into hi and lo K-major core matrices in shared memory by
// the CTA, then 12 wgmma, waited at the end of the stage) took 0.3324
// against 0.2993 ms and, summing every stage into one accumulator, 1.45e-4
// against 2.4e-5 at most: a pipelined, warp-specialised version is untried.
// Shared memory a CTA: the GEMM 55,296 bytes (three CTAs an SM at its 143
// to 151 registers a thread), the attention 5 * 64 * (DP + 4) floats (DP
// the head width padded to 16, 32 or 64). Requires E <= 512 and E, Hd and
// the head width multiples of 4, the head width at most 64 (the wrapper
// checks).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "dit_common.cuh"
#include "tensor_core.cuh"

// the long-axis flash attention (flash_attention.cu), which the attention
// stage takes where each DiT row fills whole query tiles
extern "C" int scldm_flash_attention_forward(const void* q, const void* k, const void* v,
                                             void* out, int B, int M, int S, int H, int D,
                                             long long qsb, long long qss, long long qsh,
                                             long long ksb, long long kss, long long ksh,
                                             long long vsb, long long vss, long long vsh,
                                             int bf16, void* stream);

namespace {

using dit::allow_smem;
using dit::silu;
using dit::SmemAllowance;
using dit::warp_sum;

namespace tiled {

constexpr int kWM = 2;              // m16 tiles a warp: 32 x 32 outputs
constexpr int kThreads = 128;       // four warps, 2 x 2 over the GEMM's CTA tile of 64 x 64
constexpr int kBM = 64;             // tokens a CTA: each staged weight tile feeds 64
constexpr int kBN = 64;             // output columns a CTA
constexpr int kBK = 32;             // depth of a stage
constexpr int kStages = 3;          // the ring of A and weight stages
constexpr int kLdb = kBN + 8;       // weight stage pitch: fragment loads on 32 banks
constexpr int kLda = kBK + 4;       // A stage pitch: the same
constexpr int kQ = 64;              // the attention's queries and keys a tile
// From this T on, the attention stage launches the long-axis flash attention
// kernel on qkv's (R, T, H, hd) views: 0.8363 against 0.9248 ms for the block
// at T = 1,024, R = 12 and 0.1529 against 0.1592 at T = 256, R = 8; at T =
// 64 it lost, 0.2157 against 0.1940 at R = 48 (chip run on an H100 80GB HBM3
// at 700 W). Below it `attention`, whose tiles span DiT rows, runs.
constexpr int kFlashMinT = 128;
constexpr int kLnWarps = 8;         // tokens a CTA of the LayerNorm kernel

// The epilogue: + bias; resid + gate * (acc + bias); resid + gate * acc; and
// silu(a) * b of the interleaved w1 | w2 columns.
enum class Out { kBias, kGatedBias, kGated, kSwiGLU };

struct Gemm {
  const float* a;      // (M, K) row-major
  const float* w0;     // (K, N) row-major; kSwiGLU: w1
  const float* w1;     // kSwiGLU: w2 (K, N)
  const float* bias;   // (N)
  const float* mod;    // (M / T, mod_ld): each DiT row's modulation
  const float* resid;  // (M, N)
  float* out;          // (M, N)
  int M, K, N, T;      // rows, depth, output columns, tokens a DiT row
  int mod_ld, gate;    // mod's row pitch and the gate chunk's offset
};

constexpr int gemm_smem_floats() { return kStages * (kBM * kLda + kBK * kLdb); }

// out = epilogue(A W) for a tile of 64 rows and 64 columns a CTA (32 hidden
// columns of w1 and of w2 for kSwiGLU, whose 8-column groups alternate), grid
// (ceil(M / 64), ceil(N / 64)). A and the weights stream through a ring of
// three 32-deep stages by cp.async, the next two in flight while one is
// multiplied; each warp takes 32 x 32 of the tile.
template <Out OUT>
__global__ void __launch_bounds__(kThreads) gemm(const __grid_constant__ Gemm g) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                          // [kStages][kBM][kLda]
  float* bs = smem + kStages * kBM * kLda;   // [kStages][kBK][kLdb]
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * (OUT == Out::kSwiGLU ? kBN / 2 : kBN);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int nk = (g.K + kBK - 1) / kBK;

  // stage kt of A and the weights into ring slot kt % kStages; the edges of
  // M, K and N are zero-filled (K, N and every row pitch are multiples of 4)
  auto load_stage = [&](int kt) {
    float* at = as + (kt % kStages) * kBM * kLda;
    float* bt = bs + (kt % kStages) * kBK * kLdb;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int r = id / (kBK / 4), c = (id % (kBK / 4)) * 4;
      const bool in = m0 + r < g.M && k0 + c < g.K;
      tc::cp_async16(at + r * kLda + c, g.a + (in ? (size_t)(m0 + r) * g.K + k0 + c : 0), in);
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int r = id / (kBN / 4), cg = id % (kBN / 4);
      const int k = k0 + r;
      const float* src;
      bool in;
      if constexpr (OUT == Out::kSwiGLU) {
        const int grp = cg >> 1;
        const int j = n0 + (grp >> 1) * 8 + (cg & 1) * 4;
        in = k < g.K && j < g.N;
        src = ((grp & 1) ? g.w1 : g.w0) + (in ? (size_t)k * g.N + j : 0);
      } else {
        const int n = n0 + cg * 4;
        in = k < g.K && n < g.N;
        src = g.w0 + (in ? (size_t)k * g.N + n : 0);
      }
      tc::cp_async16(bt + r * kLdb + cg * 4, src, in);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st);
    tc::cp_async_commit();
  }

  float acc[kWM][4][4];
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1's slot
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);
    tc::cp_async_commit();

    const float* at = as + (kt % kStages) * kBM * kLda + (wm * 16 * kWM + gq) * kLda + tq;
    const float* bt = bs + (kt % kStages) * kBK * kLdb + tq * kLdb + wn * 32 + gq;
    float part[kWM][4][4];
#pragma unroll
    for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      uint32_t ah[kWM][4], al[kWM][4];
#pragma unroll
      for (int mt = 0; mt < kWM; ++mt) {
        const float* ap = at + mt * 16 * kLda + kk * 8;
        tc::split_tf32(ap[0], ah[mt][0], al[mt][0]);
        tc::split_tf32(ap[8 * kLda], ah[mt][1], al[mt][1]);
        tc::split_tf32(ap[4], ah[mt][2], al[mt][2]);
        tc::split_tf32(ap[8 * kLda + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* bp = bt + kk * 8 * kLdb + nt * 8;
        uint32_t bh0, bl0, bh1, bl1;
        tc::split_tf32(bp[0], bh0, bl0);
        tc::split_tf32(bp[4 * kLdb], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < kWM; ++mt) {
          tc::mma_tf32(part[mt][nt], al[mt], bh0, bh1);
          tc::mma_tf32(part[mt][nt], ah[mt], bl0, bl1);
          tc::mma_tf32(part[mt][nt], ah[mt], bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  tc::cp_async_wait<0>();

  // the epilogue: each thread's pairs of adjacent columns (N is even)
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = m0 + wm * 16 * kWM + mt * 16 + gq + 8 * hh;
      if (t >= g.M) continue;
      if constexpr (OUT == Out::kSwiGLU) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int j = n0 + (wn * 2 + p) * 8 + 2 * tq;
          if (j >= g.N) continue;
          const float* a = &acc[mt][2 * p][2 * hh];
          const float* b = &acc[mt][2 * p + 1][2 * hh];
          *reinterpret_cast<float2*>(g.out + (size_t)t * g.N + j) =
              make_float2(silu(a[0]) * b[0], silu(a[1]) * b[1]);
        }
      } else {
        const float* gate = g.mod + (size_t)(t / g.T) * g.mod_ld + g.gate;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + wn * 32 + nt * 8 + 2 * tq;
          if (n >= g.N) continue;
          float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
          if constexpr (OUT == Out::kBias || OUT == Out::kGatedBias) {
            v0 += g.bias[n];
            v1 += g.bias[n + 1];
          }
          if constexpr (OUT == Out::kGatedBias || OUT == Out::kGated) {
            const float2 r = *reinterpret_cast<const float2*>(g.resid + (size_t)t * g.N + n);
            v0 = r.x + gate[n] * v0;
            v1 = r.y + gate[n + 1] * v1;
          }
          *reinterpret_cast<float2*>(g.out + (size_t)t * g.N + n) = make_float2(v0, v1);
        }
      }
    }
}

// out = silu(in), n float4s
__global__ void __launch_bounds__(256) silu_rows(const float* __restrict__ in, float* __restrict__ out,
                                                 int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float4 v = reinterpret_cast<const float4*>(in)[i];
  v.x = silu(v.x); v.y = silu(v.y); v.z = silu(v.z); v.w = silu(v.w);
  reinterpret_cast<float4*>(out)[i] = v;
}

// h = LN(x) * (1 + scale) + shift for each token, one warp a token: the
// non-affine LayerNorm of the reference, its two moments by shuffles, with
// the token's DiT row's modulation chunks (mod + scale, mod + shift).
__global__ void __launch_bounds__(32 * kLnWarps)
ln_modulate_tokens(const float* __restrict__ x, const float* __restrict__ mod,
                   float* __restrict__ h, int Ntok, int T, int E, int scale, int shift,
                   float eps) {
  constexpr int kMaxVec = 4;  // float4s a lane: E <= 512
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (t >= Ntok) return;
  const float* xr = x + (size_t)t * E;
  float4 v[kMaxVec];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int k = lane * 4 + i * 128;
    if (k < E) {
      v[i] = *reinterpret_cast<const float4*>(xr + k);
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
  }
  const float mean = warp_sum(s) / E;
  float var = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (lane * 4 + i * 128 < E) {
      v[i].x -= mean; v[i].y -= mean; v[i].z -= mean; v[i].w -= mean;
      var += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(var) / E + eps);
  const float* mrow = mod + (size_t)(t / T) * 6 * E;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int k = lane * 4 + i * 128;
    if (k < E) {
      const float4 sc = *reinterpret_cast<const float4*>(mrow + scale + k);
      const float4 sh = *reinterpret_cast<const float4*>(mrow + shift + k);
      float4 o;
      o.x = v[i].x * rstd * (1.0f + sc.x) + sh.x;
      o.y = v[i].y * rstd * (1.0f + sc.y) + sh.y;
      o.z = v[i].z * rstd * (1.0f + sc.z) + sh.z;
      o.w = v[i].w * rstd * (1.0f + sc.w) + sh.w;
      *reinterpret_cast<float4*>(h + (size_t)t * E + k) = o;
    }
  }
}

__host__ __device__ constexpr int attn_ld(int DP) { return DP + 4; }

__host__ __device__ constexpr int attention_smem_floats(int DP) {
  return (kQ + 2 * 2 * kQ) * attn_ld(DP);  // the queries, and a ring of two k / v stages
}

// softmax(q k^T / sqrt(hd)) v of one head over each DiT row, from qkv (R*T,
// 3E) to att (R*T, E); one CTA a head and a tile of 64 tokens of the
// flattened token axis, one warp 16 queries. Keys stream through the CTA in
// tiles of 64 over the rows its queries lie in (across rows where T < 64),
// an online softmax in base 2 folds them in, and a key scores -inf unless it
// lies in its query's row: shared memory is bounded by the tile, not by T.
// Key blocks of 8 that share no row with a warp's queries are skipped. The
// head width is zero-padded to DP.
template <int DP>
__global__ void __launch_bounds__(kThreads)
attention(const float* __restrict__ qkv, float* __restrict__ att, int Ntok, int T, int E,
          int hd, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = attn_ld(DP);
  float* qt = smem;            // [kQ][LD]
  float* ring = qt + kQ * LD;  // [2][k, v][kQ][LD]
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kQ;
  const int qn = min(kQ, Ntok - q0);
  const int key0 = (q0 / T) * T;
  const int key1 = min(Ntok, ((q0 + qn - 1) / T + 1) * T);
  const int n_tiles = (key1 - key0 + kQ - 1) / kQ;
  const int E3 = 3 * E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int per_row = hd / 4;  // 16-byte granules a row

  for (int i = tid; i < attention_smem_floats(DP) / 4; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();  // the pad columns stay zero: the copies write columns < hd only

  auto stage_rows = [&](float* dst, int tok0, int tok1, int col) {
    for (int i = tid; i < kQ * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * 4;
      const int tok = tok0 + r;
      const bool in = tok < tok1;
      tc::cp_async16(dst + r * LD + c, qkv + (in ? (size_t)tok * E3 + col + c : 0), in);
    }
  };
  auto stage_keys = [&](int t) {
    float* st = ring + (t & 1) * 2 * kQ * LD;
    const int k0 = key0 + t * kQ;
    stage_rows(st, k0, key1, E + h * hd);
    stage_rows(st + kQ * LD, k0, key1, 2 * E + h * hd);
  };
  stage_rows(qt, q0, Ntok, h * hd);
  stage_keys(0);
  tc::cp_async_commit();

  // the keys of the rows the warp's queries lie in, and of each of the
  // thread's two queries' rows
  const int wq0 = q0 + warp * 16;
  const bool active = wq0 < Ntok;
  const int wkey0 = (wq0 / T) * T, wkey1 = min(key1, (min(wq0 + 15, Ntok - 1) / T + 1) * T);
  int qkey0[2], qkey1[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qkey0[hh] = ((wq0 + gq + 8 * hh) / T) * T;
    qkey1[hh] = min(key1, qkey0[hh] + T);
  }

  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const float* qw = qt + warp * 16 * LD;

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if (t + 1 < n_tiles) stage_keys(t + 1);
    tc::cp_async_commit();
    if (!active) continue;
    const float* kt = ring + (t & 1) * 2 * kQ * LD;
    const float* vt = kt + kQ * LD;
    const int k0 = key0 + t * kQ;
    bool live[kQ / 8];
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      const int kb = k0 + 8 * j;
      live[j] = kb < wkey1 && kb + 8 > wkey0;
    }

    float s[kQ / 8][4];
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t ah[4], al[4];
      const float* a = qw + gq * LD + 8 * kk + tq;
      tc::split_tf32(a[0], ah[0], al[0]);
      tc::split_tf32(a[8 * LD], ah[1], al[1]);
      tc::split_tf32(a[4], ah[2], al[2]);
      tc::split_tf32(a[8 * LD + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
        if (!live[j]) continue;
        const float* b = kt + (8 * j + gq) * LD + 8 * kk + tq;
        uint32_t bh0, bl0, bh1, bl1;
        tc::split_tf32(b[0], bh0, bl0);
        tc::split_tf32(b[4], bh1, bl1);
        tc::mma_tf32(s[j], al, bh0, bh1);
        tc::mma_tf32(s[j], ah, bl0, bl1);
        tc::mma_tf32(s[j], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        const bool in = live[j] && key >= qkey0[e >> 1] && key < qkey1[e >> 1];
        s[j][e] = in ? s[j][e] * scale_log2 : -INFINITY;
      }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[hh], mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // no key of its row yet
      const float alpha = exp2f(m_i[hh] - m_use);
      m_i[hh] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
        s[j][2 * hh] = exp2f(s[j][2 * hh] - m_use);
        s[j][2 * hh + 1] = exp2f(s[j][2 * hh + 1] - m_use);
        sum += s[j][2 * hh] + s[j][2 * hh + 1];
      }
      l_i[hh] = l_i[hh] * alpha + sum;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }

    // p v over the tile's live key blocks, summed from zero and added in f32.
    // The k-step of block jj takes key 8jj + 2tq in slot tq and 8jj + 2tq + 1
    // in slot tq + 4 (the scores' accumulator order); v's rows follow it.
    float part[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
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
        const float* b = vt + (8 * jj + 2 * tq) * LD + 8 * n + gq;
        uint32_t bh0, bl0, bh1, bl1;
        tc::split_tf32(b[0], bh0, bl0);
        tc::split_tf32(b[LD], bh1, bl1);
        tc::mma_tf32(part[n], al, bh0, bh1);
        tc::mma_tf32(part[n], ah, bl0, bl1);
        tc::mma_tf32(part[n], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
  tc::cp_async_wait<0>();
  if (!active) return;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_i[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int tok = wq0 + gq + 8 * hh;
    if (tok >= Ntok) continue;
    float* o = att + (size_t)tok * E + h * hd;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d < hd) *reinterpret_cast<float2*>(o + d) = make_float2(acc[n][2 * hh] / l,
                                                                  acc[n][2 * hh + 1] / l);
    }
  }
}

}  // namespace tiled


template <tiled::Out OUT>
cudaError_t launch_gemm(const tiled::Gemm& g, cudaStream_t s) {
  static SmemAllowance allowed;  // one a kernel
  const long long smem = 4LL * tiled::gemm_smem_floats();
  cudaError_t err = allow_smem(tiled::gemm<OUT>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int bn = OUT == tiled::Out::kSwiGLU ? tiled::kBN / 2 : tiled::kBN;
  const dim3 grid((g.M + tiled::kBM - 1) / tiled::kBM, (g.N + bn - 1) / bn);
  tiled::gemm<OUT><<<grid, tiled::kThreads, smem, s>>>(g);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_attention(const float* qkv, float* att, int Ntok, int T, int E, int H,
                             cudaStream_t s) {
  static SmemAllowance allowed;
  const long long smem = 4LL * tiled::attention_smem_floats(DP);
  cudaError_t err = allow_smem(tiled::attention<DP>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int hd = E / H;
  const dim3 grid((Ntok + tiled::kQ - 1) / tiled::kQ, H);
  tiled::attention<DP><<<grid, tiled::kThreads, smem, s>>>(qkv, att, Ntok, T, E, hd,
                                                           1.4426950408889634f / sqrtf((float)hd));
  return cudaGetLastError();
}

cudaError_t launch_ln(const float* x, const float* mod, float* h, int Ntok, int T, int E,
                      int scale, int shift, float eps, cudaStream_t s) {
  tiled::ln_modulate_tokens<<<(Ntok + tiled::kLnWarps - 1) / tiled::kLnWarps,
                              32 * tiled::kLnWarps, 0, s>>>(x, mod, h, Ntok, T, E, scale, shift,
                                                            eps);
  return cudaGetLastError();
}

// The tiled design's nine launches; `ws` holds R*6E + R*T*(5E + Hd) floats:
// mod, then per token qkv (3E), h and the attention output (E, one slot),
// the residual stream after the attention branch (E) and the SwiGLU hidden
// (Hd); h2 takes qkv's slot once the attention has read it.
cudaError_t launch_tiled(const float* x, const float* c, const float* wada, const float* bada,
                         const float* wqkv, const float* bqkv, const float* wproj,
                         const float* bproj, const float* w1, const float* w2,
                         const float* wmlp, float* out, float* ws, int R, int T, int E, int H,
                         int Hd, float eps, cudaStream_t s) {
  using tiled::Out;
  const int N = R * T, hd = E / H;
  if (E % 4 != 0 || E > 512 || hd % 4 != 0 || hd > 64 || Hd % 4 != 0)
    return cudaErrorInvalidValue;
  float* mod = ws;
  float* qkv = mod + (size_t)R * 6 * E;
  float* hatt = qkv + (size_t)N * 3 * E;  // h, then the attention output
  float* x1 = hatt + (size_t)N * E;
  float* hid = x1 + (size_t)N * E;
  float* h2 = qkv;
  cudaError_t err;
  tiled::Gemm g{};
  g.mod = mod;
  g.mod_ld = 6 * E;

  // mod = silu(c) wada + bada, over the R rows; silu(c) in x1's slot
  tiled::silu_rows<<<(R * E / 4 + 255) / 256, 256, 0, s>>>(c, x1, R * E / 4);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  g.a = x1; g.w0 = wada; g.bias = bada; g.out = mod; g.M = R; g.K = E; g.N = 6 * E; g.T = 1;
  if ((err = launch_gemm<Out::kBias>(g, s)) != cudaSuccess) return err;
  // qkv = (LN(x) (1 + scale_a) + shift_a) wqkv + bqkv, over the tokens
  if ((err = launch_ln(x, mod, hatt, N, T, E, 0, E, eps, s)) != cudaSuccess) return err;
  g.a = hatt; g.w0 = wqkv; g.bias = bqkv; g.out = qkv; g.M = N; g.N = 3 * E; g.T = T;
  if ((err = launch_gemm<Out::kBias>(g, s)) != cudaSuccess) return err;
  if (T >= tiled::kFlashMinT) {  // q, k and v as (R, T, H, hd) views of qkv
    const long long E3 = 3LL * E, row = E3 * T;
    err = (cudaError_t)scldm_flash_attention_forward(qkv, qkv + E, qkv + 2 * E, hatt, R, T, T, H,
                                                     hd, row, E3, hd, row, E3, hd, row, E3, hd, 0,
                                                     s);
  } else if (hd <= 16) err = launch_attention<16>(qkv, hatt, N, T, E, H, s);
  else if (hd <= 32) err = launch_attention<32>(qkv, hatt, N, T, E, H, s);
  else err = launch_attention<64>(qkv, hatt, N, T, E, H, s);
  if (err != cudaSuccess) return err;
  // x1 = x + gate_a (att wproj + bproj)
  g.a = hatt; g.w0 = wproj; g.bias = bproj; g.resid = x; g.out = x1; g.N = E; g.gate = 2 * E;
  if ((err = launch_gemm<Out::kGatedBias>(g, s)) != cudaSuccess) return err;
  // hid = silu(h2 w1) * (h2 w2), h2 = LN(x1) (1 + scale_m) + shift_m
  if ((err = launch_ln(x1, mod, h2, N, T, E, 3 * E, 4 * E, eps, s)) != cudaSuccess) return err;
  g.a = h2; g.w0 = w1; g.w1 = w2; g.out = hid; g.N = Hd;
  if ((err = launch_gemm<Out::kSwiGLU>(g, s)) != cudaSuccess) return err;
  // out = x1 + gate_m (hid wmlp)
  g.a = hid; g.w0 = wmlp; g.resid = x1; g.out = out; g.K = Hd; g.N = E; g.gate = 5 * E;
  return launch_gemm<Out::kGated>(g, s);
}

}  // namespace

extern "C" {

// Launches one block forward on `stream`, on the current device: the tiled
// design's nine kernels, whose `workspace` holds R*6E + R*T*(5E + Hd)
// floats. Returns the first CUDA error code (0 on success;
// cudaErrorInvalidValue for E > 512, or a head width or Hd that is not a
// multiple of 4, or a head width over 64). Allocates nothing and does not
// synchronise.
int scldm_dit_block_forward(const void* x, const void* c, const void* wada,
                            const void* bada, const void* wqkv, const void* bqkv,
                            const void* wproj, const void* bproj, const void* w1,
                            const void* w2, const void* wmlp, void* out, void* workspace,
                            int R, int T, int E, int H, int Hd, float eps, void* stream) {
  if (R == 0 || T == 0) return 0;
  return (int)launch_tiled((const float*)x, (const float*)c, (const float*)wada,
                           (const float*)bada, (const float*)wqkv, (const float*)bqkv,
                           (const float*)wproj, (const float*)bproj, (const float*)w1,
                           (const float*)w2, (const float*)wmlp, (float*)out, (float*)workspace,
                           R, T, E, H, Hd, eps, (cudaStream_t)stream);
}

const char* scldm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
