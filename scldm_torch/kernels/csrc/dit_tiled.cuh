// The tiled stages of the DiT block, shared by its forward (dit_block.cu) and
// its recompute backward (dit_block_bwd.cu): a tensor-core GEMM over all R*T
// tokens with the block's epilogues, a LayerNorm-and-modulate kernel, silu,
// and an attention that streams the keys; and the weight gradients U^T V over
// the token axis (`grad_gemm` and `grad_reduce` on the GEMM's main loop,
// `tile_product`), which the DiT backward and the whole-trunk backward
// (fused_trunk.cu) share. f32 throughout.
//
// Products run on mma.sync m16n8k8 with three TF32 passes a product, x = hi +
// lo (tc::split_tf32): f32 accuracy. A CTA of four warps takes 64 rows by 64
// output columns, each warp 32 x 32; A and the weights stream through a ring
// of three 32-deep stages by cp.async, two in flight while one is multiplied.
// Each 32-deep stage is summed from zero on the tensor cores and added to the
// running sums in f32, so no tensor-core sum runs over more than 12 mma: a
// sum over thousands of tokens (the weight gradients at T = 1,024) keeps its
// low bits. No atomics: every sum runs in a fixed order, the same bits every
// run.
//
// The kernels sit in an unnamed namespace inside `tiled`: each source that
// includes this header compiles its own copy (launch them qualified,
// `tiled::gemm<...>`; a using-directive for `tiled` breaks nvcc's host stubs).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "dit_common.cuh"
#include "tensor_core.cuh"

namespace tiled {

namespace {

constexpr int kWM = 2;              // m16 tiles a warp: 32 x 32 outputs
constexpr int kThreads = 128;       // four warps, 2 x 2 over the GEMM's CTA tile of 64 x 64
constexpr int kBM = 64;             // rows (tokens) a CTA: each staged weight tile feeds 64
constexpr int kBN = 64;             // output columns a CTA
constexpr int kBK = 32;             // depth of a stage
constexpr int kStages = 3;          // the ring of A and weight stages
constexpr int kLdb = kBN + 8;       // weight stage pitch: fragment loads on 32 banks
constexpr int kLda = kBK + 4;       // A stage pitch: the same
constexpr int kLdaT = kBM + 8;      // a transposed A stage [kBK][kLdaT]: floats of [kBM][kLda]
constexpr int kQ = 64;              // the attention's queries and keys a tile
constexpr int kLnWarps = 8;         // tokens a CTA of the LayerNorm kernel

static_assert(kBK * kLdaT == kBM * kLda, "both A stage layouts take one slot of the ring");

// The epilogue of `gemm`, per output (t, n) with v the product:
//   kBias       out = v + bias
//   kGatedBias  out = resid + gate * (v + bias); aux (when given) = v + bias
//   kGated      out = resid + gate * v
//   kSwiGLU     out = silu(a) * b of the interleaved w1 | w2 columns; aux (when
//               given, (M, 2N)) = [a | b]
//   kPlain      out = v
//   kDm         out = resid * gate; aux = v (the MLP output and, from dy, its cotangent)
//   kSwiGLUBwd  out holds [a | b] (M, 2N) and becomes [da | db] for dg = v:
//               da = dg b silu'(a), db = dg silu(a)
enum class Out { kBias, kGatedBias, kGated, kSwiGLU, kPlain, kDm, kSwiGLUBwd };

struct Gemm {
  const float* a;      // (M, K) row-major
  const float* w0;     // (K, N) row-major (rows k < ksplit); kSwiGLU: w1
  const float* w1;     // kSwiGLU: w2 (K, N); otherwise rows k >= ksplit, (K - ksplit, N)
  const float* bias;   // (N)
  const float* mod;    // (M / T, mod_ld): each DiT row's modulation
  const float* resid;  // (M, N)
  float* out;          // (M, N)
  float* aux;          // see Out
  int M, K, N, T;      // rows, depth, output columns, tokens a DiT row
  int mod_ld, gate;    // mod's row pitch and the gate chunk's offset
  int ksplit;          // 0: w0 holds all K rows
};

__host__ __device__ constexpr int gemm_smem_floats() {
  return kStages * (kBM * kLda + kBK * kLdb);
}

// The operands of one CTA tile's product: A(m, k) = a[m * lda + k], or with
// kTransA a[k * lda + m]; B(k, n) = b0[k * ldb + n] for k < ksplit, else
// b1[(k - ksplit) * ldb + n]; rows m < M, columns n < N, depth k0 <= k < k1.
// With kSwiGLU, B's 8-column groups alternate between b0 and b1 (each (K,
// ldb)), so that a CTA's 64 columns are 32 hidden columns of each.
struct Operands {
  const float* a;
  size_t lda;
  const float* b0;
  const float* b1;
  int ldb, ksplit;
  int M, N, k0, k1;
};

// acc += A B over the tile of 64 x 64 outputs at (m0, n0) (n0: the first
// hidden column with kSwiGLU); B's rows from b1 past ksplit only with
// kSplitB; with `colsum` (kTransA only), thread t < 64 also sums column m0 +
// t of A over the depth, in order.
template <bool kTransA, bool kSwiGLU, bool kSplitB>
__device__ __forceinline__ void tile_product(const Operands& o, int m0, int n0,
                                             float (&acc)[kWM][4][4], bool colsum, float& csum) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                          // [kStages][kBM * kLda]
  float* bs = smem + kStages * kBM * kLda;   // [kStages][kBK][kLdb]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int nk = (o.k1 - o.k0 + kBK - 1) / kBK;

  // stage kt of A and the weights into ring slot kt % kStages; the edges of
  // M, the depth and N are zero-filled (N, every row pitch and the depth's
  // start are multiples of 4)
  auto load_stage = [&](int kt) {
    float* at = as + (kt % kStages) * kBM * kLda;
    float* bt = bs + (kt % kStages) * kBK * kLdb;
    const int kb = o.k0 + kt * kBK;
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      if constexpr (kTransA) {
        const int r = id / (kBM / 4), c = (id % (kBM / 4)) * 4;
        const bool in = kb + r < o.k1 && m0 + c < o.M;
        tc::cp_async16(at + r * kLdaT + c, o.a + (in ? (size_t)(kb + r) * o.lda + m0 + c : 0), in);
      } else {
        const int r = id / (kBK / 4), c = (id % (kBK / 4)) * 4;
        const bool in = m0 + r < o.M && kb + c < o.k1;
        tc::cp_async16(at + r * kLda + c, o.a + (in ? (size_t)(m0 + r) * o.lda + kb + c : 0), in);
      }
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / 4 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int r = id / (kBN / 4), cg = id % (kBN / 4);
      const int k = kb + r;
      const float* src;
      bool in;
      if constexpr (kSwiGLU) {
        const int grp = cg >> 1;
        const int j = n0 + (grp >> 1) * 8 + (cg & 1) * 4;
        in = k < o.k1 && j < o.N;
        src = ((grp & 1) ? o.b1 : o.b0) + (in ? (size_t)k * o.ldb + j : 0);
      } else {
        const int n = n0 + cg * 4;
        in = k < o.k1 && n < o.N;
        if constexpr (kSplitB)
          src = k < o.ksplit ? o.b0 + (in ? (size_t)k * o.ldb + n : 0)
                             : o.b1 + (in ? (size_t)(k - o.ksplit) * o.ldb + n : 0);
        else
          src = o.b0 + (in ? (size_t)k * o.ldb + n : 0);
      }
      tc::cp_async16(bt + r * kLdb + cg * 4, src, in);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st);
    tc::cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1's slot
    if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1);
    tc::cp_async_commit();

    const float* at0 = as + (kt % kStages) * kBM * kLda;
    if (kTransA && colsum && tid < kBM) {
#pragma unroll 8
      for (int r = 0; r < kBK; ++r) csum += at0[r * kLdaT + tid];
    }
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
        if constexpr (kTransA) {
          // A(m, k) at [k][m]: a0 (gq, tq), a1 (gq + 8, tq), a2 (gq, tq + 4), a3 (gq + 8, tq + 4)
          const float* ap = at0 + (kk * 8 + tq) * kLdaT + wm * 16 * kWM + mt * 16 + gq;
          tc::split_tf32(ap[0], ah[mt][0], al[mt][0]);
          tc::split_tf32(ap[8], ah[mt][1], al[mt][1]);
          tc::split_tf32(ap[4 * kLdaT], ah[mt][2], al[mt][2]);
          tc::split_tf32(ap[4 * kLdaT + 8], ah[mt][3], al[mt][3]);
        } else {
          const float* ap = at0 + (wm * 16 * kWM + mt * 16 + gq) * kLda + tq + kk * 8;
          tc::split_tf32(ap[0], ah[mt][0], al[mt][0]);
          tc::split_tf32(ap[8 * kLda], ah[mt][1], al[mt][1]);
          tc::split_tf32(ap[4], ah[mt][2], al[mt][2]);
          tc::split_tf32(ap[8 * kLda + 4], ah[mt][3], al[mt][3]);
        }
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
}

// out = epilogue(A W) for a tile of 64 rows and 64 columns a CTA (32 hidden
// columns of w1 and of w2 for kSwiGLU, whose 8-column groups alternate), grid
// (ceil(M / 64), ceil(N / 64)).
template <Out OUT>
__global__ void __launch_bounds__(kThreads) gemm(const __grid_constant__ Gemm g) {
  constexpr bool kSw = OUT == Out::kSwiGLU;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * (kSw ? kBN / 2 : kBN);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const Operands o{g.a, (size_t)g.K, g.w0, g.w1, g.N, g.ksplit > 0 ? g.ksplit : g.K,
                   g.M, g.N, 0, g.K};
  float acc[kWM][4][4];
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  float unused = 0.0f;
  tile_product<false, kSw, OUT == Out::kPlain>(o, m0, n0, acc, false, unused);

  // the epilogue: each thread's pairs of adjacent columns (N is even)
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = m0 + wm * 16 * kWM + mt * 16 + gq + 8 * hh;
      if (t >= g.M) continue;
      if constexpr (kSw) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int j = n0 + (wn * 2 + p) * 8 + 2 * tq;
          if (j >= g.N) continue;
          const float* a = &acc[mt][2 * p][2 * hh];
          const float* b = &acc[mt][2 * p + 1][2 * hh];
          *reinterpret_cast<float2*>(g.out + (size_t)t * g.N + j) =
              make_float2(dit::silu(a[0]) * b[0], dit::silu(a[1]) * b[1]);
          if (g.aux != nullptr) {
            float* ab = g.aux + (size_t)t * 2 * g.N + j;
            *reinterpret_cast<float2*>(ab) = make_float2(a[0], a[1]);
            *reinterpret_cast<float2*>(ab + g.N) = make_float2(b[0], b[1]);
          }
        }
      } else {
        constexpr bool kGate = OUT == Out::kGatedBias || OUT == Out::kGated || OUT == Out::kDm;
        const float* gate = kGate ? g.mod + (size_t)(t / g.T) * g.mod_ld + g.gate : nullptr;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + wn * 32 + nt * 8 + 2 * tq;
          if (n >= g.N) continue;
          float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
          const size_t at = (size_t)t * g.N + n;
          if constexpr (OUT == Out::kBias || OUT == Out::kGatedBias) {
            v0 += g.bias[n];
            v1 += g.bias[n + 1];
          }
          if constexpr (kGate) {
            const float2 r = *reinterpret_cast<const float2*>(g.resid + at);
            if (OUT != Out::kGated && g.aux != nullptr)
              *reinterpret_cast<float2*>(g.aux + at) = make_float2(v0, v1);
            if constexpr (OUT == Out::kDm) {
              v0 = r.x * gate[n];
              v1 = r.y * gate[n + 1];
            } else {
              v0 = r.x + gate[n] * v0;
              v1 = r.y + gate[n + 1] * v1;
            }
          }
          if constexpr (OUT == Out::kSwiGLUBwd) {
            float* ab = g.out + (size_t)t * 2 * g.N + n;
            const float2 a = *reinterpret_cast<const float2*>(ab);
            const float2 b = *reinterpret_cast<const float2*>(ab + g.N);
            const float s0 = dit::sigmoid(a.x), s1 = dit::sigmoid(a.y);
            *reinterpret_cast<float2*>(ab) =
                make_float2(v0 * b.x * s0 * (1.0f + a.x * (1.0f - s0)),
                            v1 * b.y * s1 * (1.0f + a.y * (1.0f - s1)));
            *reinterpret_cast<float2*>(ab + g.N) = make_float2(v0 * a.x * s0, v1 * a.y * s1);
            continue;
          }
          *reinterpret_cast<float2*>(g.out + at) = make_float2(v0, v1);
        }
      }
    }
}

// out = silu(in), n float4s
__global__ void __launch_bounds__(256) silu_rows(const float* __restrict__ in,
                                                 float* __restrict__ out, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float4 v = reinterpret_cast<const float4*>(in)[i];
  v.x = dit::silu(v.x); v.y = dit::silu(v.y); v.z = dit::silu(v.z); v.w = dit::silu(v.w);
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
  const float mean = dit::warp_sum(s) / E;
  float var = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (lane * 4 + i * 128 < E) {
      v[i].x -= mean; v[i].y -= mean; v[i].z -= mean; v[i].w -= mean;
      var += (v[i].x * v[i].x + v[i].y * v[i].y) + (v[i].z * v[i].z + v[i].w * v[i].w);
    }
  }
  const float rstd = 1.0f / sqrtf(dit::warp_sum(var) / E + eps);
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
// head width is zero-padded to DP. With `lse` (R*T, H) given, each query's
// log-sum-exp of its scaled scores in base 2 goes there (the backward's
// softmax statistics: p = exp2(s * scale_log2 - lse)).
template <int DP>
__global__ void __launch_bounds__(kThreads)
attention(const float* __restrict__ qkv, float* __restrict__ att, float* __restrict__ lse,
          int Ntok, int T, int E, int hd, float scale_log2) {
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
    if (lse != nullptr && tq == 0) lse[(size_t)tok * gridDim.y + h] = m_i[hh] + log2f(l);
  }
}

// -- the weight gradients -----------------------------------------------------------

constexpr int kGradSplits = 8;       // at most this many chunks of a weight gradient's tokens
constexpr int kGradSlots = 3 * 132;  // CTAs that fill the card (three a SM)

// One weight gradient: out (P, Q) = sum_n u[n, p] v[n, q] over the N tokens
// (or rows), and bias (P) = sum_n u[n, p] when given; with v == nullptr (and
// Q = 0) only the column sums into bias. With splits > 1 the token axis is
// cut into chunks of kchunk, each CTA writes its chunk's sums to `part`
// (splits, P * Q + P), and grad_reduce adds them in order.
struct GradJob {
  const float* u;
  const float* v;
  float* out;
  float* bias;
  float* part;
  int P, Q, N, splits, kchunk, tiles_q, tile0;
};

template <int kMax>
struct GradJobs {
  GradJob job[kMax];
  int n;
};

// Every job's gradient in one launch: a CTA per (64 x 64 output tile, K
// chunk) of a job, numbered by `tile0`; the bias (a column sum of U) is taken
// by the CTAs of the first column tile from U's staged tiles, or, for a job
// without V, by one thread a column over its chunk's rows, in order.
template <int kMax>
__global__ void __launch_bounds__(kThreads)
grad_gemm(const __grid_constant__ GradJobs<kMax> jobs) {
  int j = 0;
  while (j + 1 < jobs.n && (int)blockIdx.x >= jobs.job[j + 1].tile0) ++j;
  const GradJob jb = jobs.job[j];
  const int tile = blockIdx.x - jb.tile0;
  const int split = tile % jb.splits, rest = tile / jb.splits;
  const int p0 = (rest / jb.tiles_q) * kBM, q0 = (rest % jb.tiles_q) * kBN;
  const int k0 = split * jb.kchunk, k1 = min(jb.N, k0 + jb.kchunk);
  const size_t len = (size_t)jb.P * jb.Q;
  float* out = jb.splits == 1 ? jb.out : jb.part + split * (len + jb.P);
  float* bias = jb.splits == 1 ? jb.bias : jb.part + split * (len + jb.P) + len;
  if (jb.v == nullptr) {
    const int p = p0 + threadIdx.x;
    if (threadIdx.x < kBM && p < jb.P) {
      float s = 0.0f;
      for (int n = k0; n < k1; ++n) s += jb.u[(size_t)n * jb.P + p];
      bias[p] = s;
    }
    return;
  }
  const Operands o{jb.u, (size_t)jb.P, jb.v, jb.v, jb.Q, jb.N, jb.P, jb.Q, k0, k1};
  const bool with_bias = jb.bias != nullptr && q0 == 0;
  float acc[kWM][4][4];
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  float csum = 0.0f;
  tile_product<true, false, false>(o, p0, q0, acc, with_bias, csum);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mt = 0; mt < kWM; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = p0 + wm * 16 * kWM + mt * 16 + gq + 8 * hh;
      if (p >= jb.P) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int q = q0 + wn * 32 + nt * 8 + 2 * tq;
        if (q < jb.Q)
          *reinterpret_cast<float2*>(out + (size_t)p * jb.Q + q) =
              make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
      }
    }
  if (with_bias && threadIdx.x < kBM && p0 + threadIdx.x < jb.P)
    bias[p0 + threadIdx.x] = csum;
}

// For each job with splits > 1: out and bias = the sum of its chunks'
// partials, in chunk order; one thread an entry of (P * Q + P).
template <int kMax>
__global__ void __launch_bounds__(256) grad_reduce(const __grid_constant__ GradJobs<kMax> jobs,
                                                   long long total) {
  long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= total) return;
  for (int j = 0; j < jobs.n; ++j) {
    const GradJob jb = jobs.job[j];
    if (jb.splits == 1) continue;
    const long long len = (long long)jb.P * jb.Q, n = len + jb.P;
    if (idx >= n) {
      idx -= n;
      continue;
    }
    float s = 0.0f;
    for (int p = 0; p < jb.splits; ++p) s += jb.part[p * n + idx];
    if (idx < len) jb.out[idx] = s;
    else if (jb.bias != nullptr) jb.bias[idx - len] = s;
    return;
  }
}

// The weight gradients in two launches: grad_gemm over every job's tiles and
// K chunks, then grad_reduce over the chunked jobs' partials. The chunk depth
// is the same for every job: about kGradSlots * 2 CTAs of equal work in all,
// at most kGradSplits chunks a job. `part` holds kGradSplits * (P * Q + P)
// floats for each job, in job order.
template <int kMax>
cudaError_t launch_weight_grads(GradJobs<kMax> jobs, float* part, cudaStream_t s) {
  long long work = 0;
  for (int j = 0; j < jobs.n; ++j) {
    GradJob& jb = jobs.job[j];
    jb.tiles_q = jb.v != nullptr ? (jb.Q + kBN - 1) / kBN : 1;
    work += (long long)((jb.P + kBM - 1) / kBM) * jb.tiles_q * jb.N;
  }
  long long chunk = (work + 2 * kGradSlots - 1) / (2 * kGradSlots);
  chunk = chunk < 256 ? 256 : (chunk + kBK - 1) / kBK * kBK;
  int ctas = 0;
  long long reduce = 0;
  for (int j = 0; j < jobs.n; ++j) {
    GradJob& jb = jobs.job[j];
    jb.splits = (int)((jb.N + chunk - 1) / chunk);
    jb.splits = jb.splits < 1 ? 1 : jb.splits > kGradSplits ? kGradSplits : jb.splits;
    jb.kchunk = (jb.N + jb.splits - 1) / jb.splits;
    jb.kchunk = (jb.kchunk + kBK - 1) / kBK * kBK;
    jb.splits = (jb.N + jb.kchunk - 1) / jb.kchunk;
    jb.tile0 = ctas;
    ctas += ((jb.P + kBM - 1) / kBM) * jb.tiles_q * jb.splits;
    const long long len = (long long)jb.P * jb.Q + jb.P;
    jb.part = part;
    part += kGradSplits * len;
    if (jb.splits > 1) reduce += len;
  }
  static dit::SmemAllowance allowed;  // one an instantiation
  const long long smem = 4LL * gemm_smem_floats();
  cudaError_t err = dit::allow_smem(grad_gemm<kMax>, smem, allowed);
  if (err != cudaSuccess) return err;
  grad_gemm<kMax><<<ctas, kThreads, smem, s>>>(jobs);
  if ((err = cudaGetLastError()) != cudaSuccess || reduce == 0) return err;
  grad_reduce<kMax><<<(unsigned)((reduce + 255) / 256), 256, 0, s>>>(jobs, reduce);
  return cudaGetLastError();
}

// -- launches -------------------------------------------------------------------

template <Out OUT>
cudaError_t launch_gemm(const Gemm& g, cudaStream_t s) {
  static dit::SmemAllowance allowed;  // one a kernel
  const long long smem = 4LL * gemm_smem_floats();
  cudaError_t err = dit::allow_smem(gemm<OUT>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int bn = OUT == Out::kSwiGLU ? kBN / 2 : kBN;
  const dim3 grid((g.M + kBM - 1) / kBM, (g.N + bn - 1) / bn);
  gemm<OUT><<<grid, kThreads, smem, s>>>(g);
  return cudaGetLastError();
}

// `attention` over the R*T tokens of qkv, its head width padded to 16, 32 or 64
inline cudaError_t launch_attention(const float* qkv, float* att, float* lse, int Ntok, int T,
                                    int E, int H, cudaStream_t s) {
  static dit::SmemAllowance allowed[3];
  const int hd = E / H;
  const int pad = hd <= 16 ? 0 : hd <= 32 ? 1 : 2;
  const int DP = 16 << pad;
  const long long smem = 4LL * attention_smem_floats(DP);
  const dim3 grid((Ntok + kQ - 1) / kQ, H);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)hd);
  cudaError_t err;
  if (pad == 0) {
    if ((err = dit::allow_smem(attention<16>, smem, allowed[0])) != cudaSuccess) return err;
    attention<16><<<grid, kThreads, smem, s>>>(qkv, att, lse, Ntok, T, E, hd, scale_log2);
  } else if (pad == 1) {
    if ((err = dit::allow_smem(attention<32>, smem, allowed[1])) != cudaSuccess) return err;
    attention<32><<<grid, kThreads, smem, s>>>(qkv, att, lse, Ntok, T, E, hd, scale_log2);
  } else {
    if ((err = dit::allow_smem(attention<64>, smem, allowed[2])) != cudaSuccess) return err;
    attention<64><<<grid, kThreads, smem, s>>>(qkv, att, lse, Ntok, T, E, hd, scale_log2);
  }
  return cudaGetLastError();
}

inline cudaError_t launch_ln(const float* x, const float* mod, float* h, int Ntok, int T, int E,
                             int scale, int shift, float eps, cudaStream_t s) {
  ln_modulate_tokens<<<(Ntok + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, s>>>(
      x, mod, h, Ntok, T, E, scale, shift, eps);
  return cudaGetLastError();
}

inline cudaError_t launch_silu(const float* in, float* out, int n, cudaStream_t s) {
  silu_rows<<<(n / 4 + 255) / 256, 256, 0, s>>>(in, out, n / 4);
  return cudaGetLastError();
}

}  // namespace

}  // namespace tiled
