// The whole trunk of the VAE's encoder or decoder, f32: L plain pre-LN blocks
// (affine LayerNorm, fused-qkv self-attention, SwiGLU, no biases) in one
// forward launch, and their backward in three.
//
// Replaces the TPU kernels of scldm_tpu/ops/fused_trunk.py: fused_trunk_blocks
// (the forward, Pallas body `_trunk_kernel` with save=False), _fwd_saving (the
// same, also writing each layer's input) and _bwd_pallas (the whole-trunk
// backward, `_trunk_bwd_kernel`). The math is `_trunk_math`, per layer:
//
//   h  = LN(x) * g1 + b1
//   x += attn(h @ wqkv) @ wproj          (H heads of hd = E / H, softmax over T)
//   h2 = LN(x) * g2 + b2
//   x += (silu(h2 @ w1) * (h2 @ w2)) @ wmlp
//
// What bounds it on an H100: 2 * L * (4E^2 + 2TE + 3E*Hd) operations per
// token (0.44 GFLOP forward at the VAE's R = 128 rows of T = 16 tokens, E =
// 32, Hd = 88, L = 8; the backward recomputes the forward and takes about
// three times that), run as three TF32 tensor-core passes each: 2.7 us
// forward at 495 TFLOP/s, against 2 MB of saved layer inputs and 0.4 MB of
// weights. A product has 32 to 176 outputs per token, so what costs is
// latency: of the caches, of shared memory, of the barriers between the
// stages of a block, and of fetching the kernel's own instructions.
//
// What the design does about it. Rows are independent: one CTA of sixteen
// warps owns a row and runs all L layers with the row's activations and
// every intermediate in shared memory.
// - Products on mma.sync m16n8k8 with three TF32 passes (tc::split_tf32):
//   f32 accuracy; each k8 step is summed from zero and added in f32. A warp
//   takes one output tile (m16 x n8; for w1 | w2 the pair of a and b tiles,
//   so the SwiGLU runs in the epilogue) at a time over the whole depth. Rows
//   past the last token and columns past a width read as zeros.
// - The weights are read where they lie, in nn.Linear's (out, in) layout
//   (forward B = W^T, backward B = W), through the L1: the warps that the
//   projection leaves idle prefetch the next layer's lines into the L1
//   (`prefetch_layer`). A ring of shared-memory stages filled
//   by cp.async or by bulk copies was measured slower at the VAE's widths
//   (PERF.md): its copies, 16 bytes a thread or a row a bulk copy, stalled
//   the CTA at every chunk.
// - Attention in registers: one warp a (head, query tile), scores,
//   online softmax (base 2) and p v by mma and shuffles over 16-key blocks,
//   the head width padded to 8, keys past T scored -inf. The backward runs
//   one warp a head: dq over key blocks, then dk and dv over query
//   blocks (scores transposed, recomputed), no atomics.
// - LayerNorm one warp a token, two tokens at once; the affines by cp.async
//   into shared memory a layer ahead.
//
// The backward needs no grid-wide step: the dx chain is per row. One CTA per
// row walks the layers top-down, recomputes each layer's forward from its
// saved input, runs its backward with dx carried in shared memory, and writes
// the (activation, cotangent) pairs of the weight gradients to a device
// workspace (per token: h, dqkv, attn, dproj, h2, [da | db], g, dm; per row
// and kLnGroups token groups the LayerNorm affine partials). Then
// dit_tiled.cuh's grad_gemm (the DiT backward's tensor-core GEMM) sums every
// layer's gradients over the R*T tokens, the token axis cut into chunks
// summed in order by grad_reduce: no atomics, the same bits every run.
// Workspace: workspace_floats(), which scldm_fused_trunk_workspace_floats
// reports and the wrapper allocates.
//
// Shared memory per CTA: `act_floats`, which trunk_smem_bytes() in
// scldm_torch/ops/fused_trunk.py states (scldm_fused_trunk_smem_bytes here
// reports it) and the wrapper checks before launch. Requires E % 4 == 0, Hd
// % 4 == 0, E % H == 0 and every weight 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "dit_tiled.cuh"

namespace {

using dit::allow_smem;
using dit::sigmoid;
using dit::silu;
using dit::SmemAllowance;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxLayers = 8;    // layers a launch: pointers and gradient jobs are parameters
constexpr int kNames = 9;        // TRUNK_WEIGHT_NAMES
constexpr int kKB = 16;          // attention: keys (queries, for dk and dv) a block
constexpr int kDC = 8;           // attention: head columns a pass
constexpr int kLnGroups = 8;     // token groups of a row's LayerNorm affine partials
constexpr int kMaxSmemBytes = 232448;
enum { kG1, kB1, kQkv, kProj, kG2, kB2, kW1, kW2, kMlp };
// the products: forward use (B = W^T) and backward use (B = W) of each weight
enum { kQkvF, kProjF, kW12F, kMlpF, kMlpB, kW12B, kProjB, kQkvB };
constexpr int kJobs = 5 * kMaxLayers;

// Each layer's nine tensors, in TRUNK_WEIGHT_NAMES order: g1, b1 (E),
// wqkv (3E, E), wproj (E, E), g2, b2 (E), w1, w2 (Hd, E), wmlp (E, Hd).
struct Layers {
  const float* w[kMaxLayers][kNames];
};

__host__ __device__ inline int r8(int v) { return (v + 7) & ~7; }

struct Dims {
  int T, E, H, Hd, hd;
  int HdP;                   // Hd padded to 8
  int ldE, ldQ, ldF, ldB;    // pitches, = 4 mod 8 (fragment loads take 32 banks): E; qkv;
                             // qkv or the hidden; [a | b] (b at column HdP) or dqkv
};

__host__ __device__ inline Dims make_dims(int T, int E, int H, int Hd) {
  Dims d;
  d.T = T; d.E = E; d.H = H; d.Hd = Hd; d.hd = E / H;
  d.HdP = r8(Hd);
  d.ldE = r8(E) + 4;
  d.ldQ = r8(3 * E) + 4;
  d.ldF = d.ldQ > d.HdP + 4 ? d.ldQ : d.HdP + 4;
  d.ldB = d.ldQ > 2 * d.HdP + 4 ? d.ldQ : 2 * d.HdP + 4;
  return d;
}

// The activations' floats: forward x, h (then the attention output), qkv
// (then the SwiGLU hidden); backward x, x1, dx, a staging tile (h, the
// attention output, h2, dh2, do, dh), qkv, [a | b] (then dqkv); both the
// LayerNorm affines of two layers (8E, 16-byte aligned for cp.async); the
// backward then the softmax statistics and delta (T, H) and the LayerNorm
// statistics (4T).
__host__ __device__ inline int act_floats(const Dims& d, bool bwd) {
  if (bwd) return 4 * d.T * d.ldE + d.T * (d.ldQ + d.ldB) + 8 * d.E + 2 * d.T * d.H + 4 * d.T;
  return 2 * d.T * d.ldE + d.T * d.ldF + 8 * d.E;
}

// A product: C (M, nout) = A (M, kred) B with B from the weight `mat`: the
// forward use reads W (nout, kred) as W^T, the backward use W (kred, nout) as
// it lies. kW12F takes w1 and w2 side by side (two outputs a column); kW12B
// sums over w1's rows and then w2's (A = [da | db], db at column HdP).
struct Shape {
  int mat, nout, kred;
  bool dual, bwd;
};

__host__ __device__ constexpr Shape shape_of(int prod, int E, int Hd) {
  return prod == kQkvF   ? Shape{kQkv, 3 * E, E, false, false}
         : prod == kProjF ? Shape{kProj, E, E, false, false}
         : prod == kW12F  ? Shape{kW1, Hd, E, true, false}
         : prod == kMlpF  ? Shape{kMlp, E, Hd, false, false}
         : prod == kMlpB  ? Shape{kMlp, Hd, E, false, true}
         : prod == kW12B  ? Shape{kW1, E, Hd, true, true}
         : prod == kProjB ? Shape{kProj, E, E, false, true}
                          : Shape{kQkv, E, 3 * E, false, true};
}

// The weights of a layer toward the L1, each 128-byte line of its nine
// tensors once, spread over the CTA's threads from t0 on: issued a layer
// ahead, by the upper half of the warps while the projection, whose few
// output tiles the lower half takes, runs.
__device__ void prefetch_layer(const float* const* w, int E, int Hd, int t0) {
  const int sizes[kNames] = {E, E, 3 * E * E, E * E, E, E, Hd * E, Hd * E, E * Hd};
  if ((int)threadIdx.x < t0) return;
  for (int k = 0; k < kNames; ++k) {
    const int lines = (sizes[k] + 31) / 32;
    for (int i = threadIdx.x - t0; i <= lines; i += kThreads - t0)
      asm volatile("prefetch.global.L1 [%0];\n" ::"l"(w[k] + min(i * 32, sizes[k] - 1)));
  }
}

// C = A B for product kProd of layer `w`, over the row's T tokens: A in
// shared memory (pitch lda), rows past T and columns past kred read as 0; B
// from global memory. epi(m, n, c0, c1, b0, b1) takes each pair of adjacent
// outputs (m, n), (m, n + 1) for n < nout (b0, b1: the w2 outputs of
// kW12F), rows m >= T included.
template <int kProd, class Epi>
__device__ void product(const Dims& d, const float* const* w, const float* A, int lda, Epi epi) {
  constexpr Shape kS = shape_of(kProd, 1, 1);
  const Shape s = shape_of(kProd, d.E, d.Hd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int MT = (d.T + 15) >> 4, NT = r8(s.nout) >> 3, KS = r8(s.kred) >> 3;
  for (int unit = warp; unit < MT * NT; unit += kWarps) {
    const int mt = unit % MT, nt = unit / MT;
    const bool in0 = mt * 16 + gq < d.T, in1 = mt * 16 + gq + 8 < d.T;
    const int n = nt * 8 + gq;
    const bool nin = n < s.nout;
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int half = 0; half < (kS.dual && kS.bwd ? 2 : 1); ++half) {
      const float* W0 = w[kS.mat + half];
      const float* W1 = w[kS.mat + 1];
      const float* a = A + (mt * 16 + gq) * lda + half * d.HdP + tq;
#pragma unroll 2
      for (int kk = 0; kk < KS; ++kk, a += 8) {
        const int k = kk * 8 + tq;
        const bool lo = k < s.kred, hi = k + 4 < s.kred;
        uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
        tc::split_tf32(in0 && lo ? a[0] : 0.0f, ah[0], al[0]);
        tc::split_tf32(in1 && lo ? a[8 * lda] : 0.0f, ah[1], al[1]);
        tc::split_tf32(in0 && hi ? a[4] : 0.0f, ah[2], al[2]);
        tc::split_tf32(in1 && hi ? a[8 * lda + 4] : 0.0f, ah[3], al[3]);
        const size_t o0 = kS.bwd ? (size_t)k * s.nout + n : (size_t)n * s.kred + k;
        const size_t o1 = kS.bwd ? o0 + 4 * (size_t)s.nout : o0 + 4;
        tc::split_tf32(nin && lo ? __ldg(W0 + o0) : 0.0f, bh0, bl0);
        tc::split_tf32(nin && hi ? __ldg(W0 + o1) : 0.0f, bh1, bl1);
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        tc::mma_tf32(part, al, bh0, bh1);
        tc::mma_tf32(part, ah, bl0, bl1);
        tc::mma_tf32(part, ah, bh0, bh1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][e] += part[e];
        if constexpr (kS.dual && !kS.bwd) {
          tc::split_tf32(nin && lo ? __ldg(W1 + o0) : 0.0f, bh0, bl0);
          tc::split_tf32(nin && hi ? __ldg(W1 + o1) : 0.0f, bh1, bl1);
          float part2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          tc::mma_tf32(part2, al, bh0, bh1);
          tc::mma_tf32(part2, ah, bl0, bl1);
          tc::mma_tf32(part2, ah, bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[1][e] += part2[e];
        }
      }
    }
    const int nn = nt * 8 + 2 * tq;
    if (nn < s.nout) {
      epi(mt * 16 + gq, nn, acc[0][0], acc[0][1], acc[1][0], acc[1][1]);
      epi(mt * 16 + gq + 8, nn, acc[0][2], acc[0][3], acc[1][2], acc[1][3]);
    }
  }
}

// dst (T tokens of `width` floats, global) <- src (shared, pitch ld); and the
// other way
__device__ void to_global(int T, float* dst, const float* src, int ld, int width) {
  const int w4 = width / 4;
  for (int i = threadIdx.x; i < T * w4; i += kThreads) {
    const int c = (i % w4) * 4, m = i / w4;
    *reinterpret_cast<float4*>(dst + (size_t)m * width + c) =
        *reinterpret_cast<const float4*>(src + m * ld + c);
  }
}

__device__ void from_global(int T, float* dst, int ld, const float* src, int width) {
  const int w4 = width / 4;
  for (int i = threadIdx.x; i < T * w4; i += kThreads) {
    const int c = (i % w4) * 4, m = i / w4;
    *reinterpret_cast<float4*>(dst + m * ld + c) =
        *reinterpret_cast<const float4*>(src + (size_t)m * width + c);
  }
}

// g1, b1, g2, b2 of one layer into dst[0, 4E) by cp.async, one group
__device__ void load_affines(float* dst, const float* const* w, int E) {
  const int c4 = E / 4;
  for (int i = threadIdx.x; i < 4 * c4; i += kThreads) {
    const int which = i / c4, c = (i % c4) * 4;
    const int name = which == 0 ? kG1 : which == 1 ? kB1 : which == 2 ? kG2 : kB2;
    tc::cp_async16(dst + which * E + c, w[name] + c, true);
  }
  tc::cp_async_commit();
}

// the sums of a and of b over the warp, their shuffles interleaved
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// dst[m, :E] = LN(src[m, :E]) * g + b for the row's T tokens, one warp a
// token, tokens m and m + kWarps at once (pitch ldE both; g and b in shared
// memory); with `mean` given, also each token's mean and 1 / sqrt(var + eps).
__device__ void ln_fwd(const Dims& d, const float* src, float* dst, const float* g,
                       const float* b, float eps, float* mean, float* rstd) {
  const int lane = threadIdx.x & 31;
  for (int m0 = threadIdx.x >> 5; m0 < d.T; m0 += 2 * kWarps) {
    const int m1 = m0 + kWarps < d.T ? m0 + kWarps : m0;
    const float* r0 = src + m0 * d.ldE;
    const float* r1 = src + m1 * d.ldE;
    float s0 = 0.0f, s1 = 0.0f;
    for (int e = lane; e < d.E; e += 32) {
      s0 += r0[e];
      s1 += r1[e];
    }
    warp_sum2(s0, s1);
    const float mu0 = s0 / d.E, mu1 = s1 / d.E;
    float v0 = 0.0f, v1 = 0.0f;
    for (int e = lane; e < d.E; e += 32) {
      const float c0 = r0[e] - mu0, c1 = r1[e] - mu1;
      v0 += c0 * c0;
      v1 += c1 * c1;
    }
    warp_sum2(v0, v1);
    const float inv0 = 1.0f / sqrtf(v0 / d.E + eps), inv1 = 1.0f / sqrtf(v1 / d.E + eps);
    for (int e = lane; e < d.E; e += 32) {
      dst[m0 * d.ldE + e] = (r0[e] - mu0) * inv0 * g[e] + b[e];
      dst[m1 * d.ldE + e] = (r1[e] - mu1) * inv1 * g[e] + b[e];
    }
    if (mean != nullptr && lane == 0) {
      mean[m0] = mu0;
      rstd[m0] = inv0;
      mean[m1] = mu1;
      rstd[m1] = inv1;
    }
  }
}

// The affine LayerNorm's backward over the row, given dd, the cotangent of
// its output, and its input src with their statistics: for each token group
// q (tokens q, q + kLnGroups, ...), part[q * 4E + e] = sum dd * xhat and
// part[q * 4E + E + e] = sum dd (shares of dg and db, global), and acc[m, :]
// += rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)) with dxh = dd * g (g
// in shared memory), two tokens a warp at once.
__device__ void ln_bwd(const Dims& d, const float* dd, const float* src, const float* mean,
                       const float* rstd, const float* g, float* part, float* acc) {
  for (int i = threadIdx.x; i < kLnGroups * d.E; i += kThreads) {
    const int e = i % d.E, q = i / d.E;
    float dg = 0.0f, db = 0.0f;
    for (int m = q; m < d.T; m += kLnGroups) {
      const float v = dd[m * d.ldE + e];
      dg = fmaf(v, (src[m * d.ldE + e] - mean[m]) * rstd[m], dg);
      db += v;
    }
    part[q * 4 * d.E + e] = dg;
    part[q * 4 * d.E + d.E + e] = db;
  }
  const int lane = threadIdx.x & 31;
  for (int m0 = threadIdx.x >> 5; m0 < d.T; m0 += 2 * kWarps) {
    const bool two = m0 + kWarps < d.T;
    const int m1 = two ? m0 + kWarps : m0;
    const float* s0r = src + m0 * d.ldE;
    const float* s1r = src + m1 * d.ldE;
    const float* d0r = dd + m0 * d.ldE;
    const float* d1r = dd + m1 * d.ldE;
    float a0 = 0.0f, b0 = 0.0f, a1 = 0.0f, b1 = 0.0f;
    for (int e = lane; e < d.E; e += 32) {
      const float x0 = (s0r[e] - mean[m0]) * rstd[m0], x1 = (s1r[e] - mean[m1]) * rstd[m1];
      const float g0 = d0r[e] * g[e], g1 = d1r[e] * g[e];
      a0 += g0;
      b0 = fmaf(g0, x0, b0);
      a1 += g1;
      b1 = fmaf(g1, x1, b1);
    }
    warp_sum2(a0, a1);
    warp_sum2(b0, b1);
    a0 /= d.E; b0 /= d.E; a1 /= d.E; b1 /= d.E;
    for (int e = lane; e < d.E; e += 32) {
      const float x0 = (s0r[e] - mean[m0]) * rstd[m0];
      acc[m0 * d.ldE + e] += rstd[m0] * (d0r[e] * g[e] - a0 - x0 * b0);
      if (two) {
        const float x1 = (s1r[e] - mean[m1]) * rstd[m1];
        acc[m1 * d.ldE + e] += rstd[m1] * (d1r[e] * g[e] - a1 - x1 * b1);
      }
    }
  }
}

// -- attention in registers ------------------------------------------------------
// Fragments of the m16n8k8 TF32 product (tensor_core.cuh), lane = 4 gq + tq.
// Rows of a row's tokens past its T, and head columns past hd, read as 0.

__device__ __forceinline__ float at(const float* x, int ld, int row, int n, int c, int hd) {
  return row < n && c < hd ? x[row * ld + c] : 0.0f;
}

__device__ __forceinline__ void zero_tiles(float (&a)[kKB / 8][4]) {
#pragma unroll
  for (int i = 0; i < kKB / 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.0f;
}

// s[j] += A B over the head width: A the rows r0 + (gq, gq + 8) of x (< na),
// B(k = c, n = row) = y[row, c] for the 8-row blocks j of y from row j0 (<
// n): scores-like products, blocks with j0 + 8j < n only
__device__ __forceinline__ void rows_product(float (&s)[kKB / 8][4], const float* x, int ldx,
                                             int r0, int na, const float* y, int ldy, int j0,
                                             int n, int hd) {
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  for (int kk = 0; kk < r8(hd) / 8; ++kk) {
    const int c0 = kk * 8 + tq;
    uint32_t ah[4], al[4];
    tc::split_tf32(at(x, ldx, r0 + gq, na, c0, hd), ah[0], al[0]);
    tc::split_tf32(at(x, ldx, r0 + gq + 8, na, c0, hd), ah[1], al[1]);
    tc::split_tf32(at(x, ldx, r0 + gq, na, c0 + 4, hd), ah[2], al[2]);
    tc::split_tf32(at(x, ldx, r0 + gq + 8, na, c0 + 4, hd), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < kKB / 8; ++j) {
      if (j0 + 8 * j >= n) continue;
      const int row = j0 + 8 * j + gq;
      uint32_t bh0, bl0, bh1, bl1;
      tc::split_tf32(at(y, ldy, row, n, c0, hd), bh0, bl0);
      tc::split_tf32(at(y, ldy, row, n, c0 + 4, hd), bh1, bl1);
      tc::mma_tf32(s[j], al, bh0, bh1);
      tc::mma_tf32(s[j], ah, bl0, bl1);
      tc::mma_tf32(s[j], ah, bh0, bh1);
    }
  }
}

// acc += P Y for P in the accumulator layout of s (rows x the blocks' 8
// columns) and Y's rows j0 + ... (< n), head columns d0 .. d0 + 8: the k-step
// of block jj takes row 2tq in slot tq and 2tq + 1 in slot tq + 4 (the
// accumulator's order), so P needs no shuffle. Summed from zero, added in f32.
__device__ __forceinline__ void p_times(float (&acc)[4], const float (&s)[kKB / 8][4],
                                        const float* y, int ldy, int j0, int n, int d0, int hd) {
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int jj = 0; jj < kKB / 8; ++jj) {
    if (j0 + 8 * jj >= n) continue;
    uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
    tc::split_tf32(s[jj][0], ah[0], al[0]);
    tc::split_tf32(s[jj][2], ah[1], al[1]);
    tc::split_tf32(s[jj][1], ah[2], al[2]);
    tc::split_tf32(s[jj][3], ah[3], al[3]);
    const int row = j0 + 8 * jj + 2 * tq;
    tc::split_tf32(at(y, ldy, row, n, d0 + gq, hd), bh0, bl0);
    tc::split_tf32(at(y, ldy, row + 1, n, d0 + gq, hd), bh1, bl1);
    tc::mma_tf32(part, al, bh0, bh1);
    tc::mma_tf32(part, ah, bl0, bl1);
    tc::mma_tf32(part, ah, bh0, bh1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// o = softmax(q k^T / sqrt(hd)) v per head, from qkv (T, ldq) = [q | k |
// v] to o (T, ldE); with `lse` given, each query's log-sum-exp of its
// scaled scores in base 2 to lse[m * H + h]. One warp a (head, query tile of
// 16): scores of 16-key blocks, an online softmax in base 2, p v, eight head
// columns a pass.
__device__ void attention_fwd(const Dims& d, const float* qkv, int ldq, float* o, float* lse,
                              float scale_log2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int QT = (d.T + 15) / 16, T = d.T, hd = d.hd;
  for (int unit = warp; unit < d.H * QT; unit += kWarps) {
    const int qt = unit % QT, h = unit / QT;
    const float* q = qkv + h * hd;
    const float* k = q + d.E;
    const float* v = q + 2 * d.E;
    const int q0 = qt * 16;
    for (int d0 = 0; d0 < hd; d0 += kDC) {
      float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.0f, 0.0f};
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int kb = 0; kb < T; kb += kKB) {
        float s[kKB / 8][4];
        zero_tiles(s);
        rows_product(s, q, ldq, q0, T, k, ldq, kb, T, hd);
#pragma unroll
        for (int j = 0; j < kKB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = kb + 8 * j + 2 * tq + (e & 1) < T ? s[j][e] * scale_log2 : -INFINITY;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < kKB / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_i[hh], mx);  // finite: key 0 is in the first block
          const float alpha = exp2f(m_i[hh] - m_new);
          m_i[hh] = m_new;
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < kKB / 8; ++j) {
            s[j][2 * hh] = exp2f(s[j][2 * hh] - m_new);
            s[j][2 * hh + 1] = exp2f(s[j][2 * hh + 1] - m_new);
            sum += s[j][2 * hh] + s[j][2 * hh + 1];
          }
          l_i[hh] = l_i[hh] * alpha + sum;
          acc[2 * hh] *= alpha;
          acc[2 * hh + 1] *= alpha;
        }
        p_times(acc, s, v, ldq, kb, T, d0, hd);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float l = l_i[hh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int t = q0 + gq + 8 * hh;
        if (t >= T) continue;
        float* orow = o + t * d.ldE + h * hd;
        const int dc = d0 + 2 * tq;
        if (dc < hd) orow[dc] = acc[2 * hh] / l;
        if (dc + 1 < hd) orow[dc + 1] = acc[2 * hh + 1] / l;
        if (lse != nullptr && d0 == 0 && tq == 0) lse[t * d.H + h] = m_i[hh] + log2f(l);
      }
    }
  }
}

// The attention's backward per head, one warp each: from qkv, o (the row's
// tokens in global memory, pitch E) and do (its cotangent, pitch ldE) and the
// forward's lse, dq, dk and dv to dqkv (T, ldd); delta (T, H) = do . o per
// query. dq runs over key blocks (dS = P (dP - delta), dq = scale dS
// k), then dk and dv over query blocks with the scores transposed (dv = P^T
// do, dk = scale dS^T q).
__device__ void attention_bwd(const Dims& d, const float* qkv, const float* o, const float* dO,
                              const float* lse, float* delta, float* dqkv, int ldd,
                              float scale_log2, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int QT = (d.T + 15) / 16, T = d.T, hd = d.hd, H = d.H;
  for (int h = warp; h < H; h += kWarps) {
    const float* q = qkv + h * hd;
    const float* k = q + d.E;
    const float* v = q + 2 * d.E;
    const float* ob = o + h * hd;
    const float* dob = dO + h * hd;
    const float* lr = lse + h;
    float* dl = delta + h;
    // delta = do . o over the head's columns, four lanes a query
    for (int t0 = 0; t0 < T; t0 += 8) {
      const int t = t0 + gq;
      float s = 0.0f;
      if (t < T)
        for (int c = tq; c < hd; c += 4) s = fmaf(dob[t * d.ldE + c], ob[t * d.E + c], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (tq == 0 && t < T) dl[t * H] = s;
    }
    __syncwarp();
    // dq, a query tile at a time
    for (int qt = 0; qt < QT; ++qt) {
      const int q0 = qt * 16;
      float li[2], di[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = q0 + gq + 8 * hh;
        li[hh] = t < T ? lr[t * H] : 0.0f;
        di[hh] = t < T ? dl[t * H] : 0.0f;
      }
      for (int d0 = 0; d0 < hd; d0 += kDC) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int kb = 0; kb < T; kb += kKB) {
          float s[kKB / 8][4], dp[kKB / 8][4];
          zero_tiles(s);
          zero_tiles(dp);
          rows_product(s, q, d.ldQ, q0, T, k, d.ldQ, kb, T, hd);
          rows_product(dp, dob, d.ldE, q0, T, v, d.ldQ, kb, T, hd);
#pragma unroll
          for (int j = 0; j < kKB / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pv = kb + 8 * j + 2 * tq + (e & 1) < T
                                   ? exp2f(s[j][e] * scale_log2 - li[e >> 1]) : 0.0f;
              s[j][e] = pv * (dp[j][e] - di[e >> 1]);
            }
          p_times(acc, s, k, d.ldQ, kb, T, d0, hd);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = q0 + gq + 8 * hh;
          if (t >= T) continue;
          float* out = dqkv + t * ldd + h * hd;
          const int dc = d0 + 2 * tq;
          if (dc < hd) out[dc] = acc[2 * hh] * scale;
          if (dc + 1 < hd) out[dc + 1] = acc[2 * hh + 1] * scale;
        }
      }
    }
    // dk and dv, a key tile at a time, over the query blocks
    for (int kt = 0; kt < QT; ++kt) {
      const int k0 = kt * 16;
      for (int d0 = 0; d0 < hd; d0 += kDC) {
        float dk[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int qb = 0; qb < T; qb += kKB) {
          float s[kKB / 8][4], dp[kKB / 8][4];
          zero_tiles(s);
          zero_tiles(dp);
          rows_product(s, k, d.ldQ, k0, T, q, d.ldQ, qb, T, hd);     // S^T
          rows_product(dp, v, d.ldQ, k0, T, dob, d.ldE, qb, T, hd);  // dP^T
#pragma unroll
          for (int j = 0; j < kKB / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = qb + 8 * j + 2 * tq + (e & 1);
              const bool in = qi < T;
              const float pv = in ? exp2f(s[j][e] * scale_log2 - lr[qi * H]) : 0.0f;
              s[j][e] = pv;
              dp[j][e] = in ? pv * (dp[j][e] - dl[qi * H]) : 0.0f;
            }
          p_times(dv, s, dob, d.ldE, qb, T, d0, hd);
          p_times(dk, dp, q, d.ldQ, qb, T, d0, hd);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = k0 + gq + 8 * hh;
          if (t >= T) continue;
          float* out = dqkv + t * ldd + h * hd;
          const int dc = d0 + 2 * tq;
          if (dc < hd) {
            out[d.E + dc] = dk[2 * hh] * scale;
            out[2 * d.E + dc] = dv[2 * hh];
          }
          if (dc + 1 < hd) {
            out[d.E + dc + 1] = dk[2 * hh + 1] * scale;
            out[2 * d.E + dc + 1] = dv[2 * hh + 1];
          }
        }
      }
    }
  }
}

// The forward of `nl` layers, a row a CTA: x (R, T, E) -> out (R, T, E);
// with kSave, also each layer's input to xs[l] (R, T, E). x and out may be
// the same buffer (each CTA reads its row before it writes it).
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
trunk_forward_mma(const float* x, float* out, float* __restrict__ xs,
                  const __grid_constant__ Layers p, int nl, int R, int T, int E, int H, int Hd,
                  float eps) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = make_dims(T, E, H, Hd);
  float* xr = smem;                    // (T, ldE) the residual stream
  float* ha = xr + T * d.ldE;          // (T, ldE) LN output, then the attention output
  float* qkv = ha + T * d.ldE;         // (T, ldF) qkv, then the hidden silu(a) * b
  float* hid = qkv;
  float* lnp = qkv + T * d.ldF;        // [2][g1 | b1 | g2 | b2] this layer's and the next's
  const size_t tok0 = (size_t)blockIdx.x * T, RTE = (size_t)R * T * E;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d.hd);
  prefetch_layer(p.w[0], E, Hd, 0);
  load_affines(lnp, p.w[0], E);
  from_global(T, xr, d.ldE, x + tok0 * E, E);
  auto add_to_x = [&](int m, int n, float c0, float c1, float, float) {
    if (m >= T) return;
    float2* o = reinterpret_cast<float2*>(xr + m * d.ldE + n);
    const float2 v = *o;
    *o = make_float2(v.x + c0, v.y + c1);
  };

  for (int l = 0; l < nl; ++l) {
    const float* const* w = p.w[l];
    const float* aff = lnp + (l & 1) * 4 * E;
    tc::cp_async_wait<0>();  // this layer's affines
    __syncthreads();         // and the layer before is done
    if (l + 1 < nl) load_affines(lnp + ((l + 1) & 1) * 4 * E, p.w[l + 1], E);
    if (kSave) to_global(T, xs + l * RTE + tok0 * E, xr, d.ldE, E);
    // -- attention branch ----------------------------------------------------
    ln_fwd(d, xr, ha, aff, aff + E, eps, nullptr, nullptr);
    __syncthreads();
    product<kQkvF>(d, w, ha, d.ldE, [&](int m, int n, float c0, float c1, float, float) {
      if (m < T) *reinterpret_cast<float2*>(qkv + m * d.ldF + n) = make_float2(c0, c1);
    });
    __syncthreads();
    attention_fwd(d, qkv, d.ldF, ha, nullptr, scale_log2);
    __syncthreads();
    product<kProjF>(d, w, ha, d.ldE, add_to_x);
    if (l + 1 < nl) prefetch_layer(p.w[l + 1], E, Hd, kThreads / 2);
    __syncthreads();
    // -- SwiGLU branch -------------------------------------------------------
    ln_fwd(d, xr, ha, aff + 2 * E, aff + 3 * E, eps, nullptr, nullptr);
    __syncthreads();
    product<kW12F>(d, w, ha, d.ldE,
                   [&](int m, int n, float a0, float a1, float b0, float b1) {
                     if (m < T)
                       *reinterpret_cast<float2*>(hid + m * d.ldF + n) =
                           make_float2(silu(a0) * b0, silu(a1) * b1);
                   });
    __syncthreads();
    product<kMlpF>(d, w, hid, d.ldF, add_to_x);
  }
  __syncthreads();
  to_global(T, out + tok0 * E, xr, d.ldE, E);
}

// One layer's slice of the backward's workspace: per token unless marked.
struct Slots {
  float* h;      // (N, E)   h, the input of wqkv
  float* dqkv;   // (N, 3E)  dqkv
  float* attn;   // (N, E)   the attention output, the input of wproj
  float* dproj;  // (N, E)   the cotangent of the attention branch's output
  float* h2;     // (N, E)   h2, the input of w1 and w2
  float* dab;    // (N, 2Hd) [da | db]
  float* g;      // (N, Hd)  silu(a) * b, the input of wmlp
  float* m;      // (N, E)   the cotangent of the SwiGLU branch's output
  float* ln;     // (R * kLnGroups, 4E) [dg1 | db1 | dg2 | db2] over a row's token group
};

__host__ __device__ inline size_t layer_floats(int R, int T, int E, int Hd) {
  return (size_t)R * T * (8 * E + 3 * Hd) + (size_t)R * kLnGroups * 4 * E;
}

__host__ __device__ inline Slots slots(float* ws, int i, int R, int T, int E, int Hd) {
  const size_t N = (size_t)R * T;
  Slots s;
  s.h = ws + i * layer_floats(R, T, E, Hd);
  s.dqkv = s.h + N * E;
  s.attn = s.dqkv + N * 3 * E;
  s.dproj = s.attn + N * E;
  s.h2 = s.dproj + N * E;
  s.dab = s.h2 + N * E;
  s.g = s.dab + N * 2 * Hd;
  s.m = s.g + N * Hd;
  s.ln = s.m + N * E;
  return s;
}

// The backward of `nl` layers, a row a CTA, layers top-down: each
// layer's forward recomputed from its saved input xs[l] (R, T, E), then its
// backward from the running cotangent (dy at the top), carried in shared
// memory; the weight gradients' pairs go to workspace slot l. dy and dx may
// be the same buffer (each CTA reads its row before it writes it).
__global__ void __launch_bounds__(kThreads, 1)
trunk_backward_mma(const float* __restrict__ xs, const float* dy, float* dx,
                   const __grid_constant__ Layers p, int nl, float* ws, int R, int T, int E,
                   int H, int Hd, float eps) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = make_dims(T, E, H, Hd);
  float* xin = smem;                   // (T, ldE) the layer's input
  float* x1 = xin + T * d.ldE;         // (T, ldE) the residual stream after the attention branch
  float* dcur = x1 + T * d.ldE;        // (T, ldE) the running cotangent
  float* buf = dcur + T * d.ldE;       // (T, ldE) h, the attention output o, h2, dh2, do, dh
  float* qkv = buf + T * d.ldE;        // (T, ldQ)
  float* ab = qkv + T * d.ldQ;         // (T, ldB) [a | b], then [da | db] (b at column HdP)
  float* dqkv = ab;                    //          then dqkv
  float* lnp = ab + T * d.ldB;         // [2][g1 | b1 | g2 | b2] this layer's and the next's
  float* lse = lnp + 8 * E;            // (T, H) each query's log-sum-exp, base 2
  float* delta = lse + T * d.H;        // (T, H) do . o
  float* mean1 = delta + T * d.H;      // (T) the LayerNorms' statistics
  float* rstd1 = mean1 + T;
  float* mean2 = rstd1 + T;
  float* rstd2 = mean2 + T;
  const size_t tok0 = (size_t)blockIdx.x * T, RTE = (size_t)R * T * E;
  const float scale = 1.0f / sqrtf((float)d.hd), scale_log2 = 1.4426950408889634f * scale;
  prefetch_layer(p.w[nl - 1], E, Hd, 0);
  load_affines(lnp, p.w[nl - 1], E);
  from_global(T, dcur, d.ldE, dy + tok0 * E, E);
  auto to_buf = [&](int m, int n, float c0, float c1, float, float) {
    if (m < T) *reinterpret_cast<float2*>(buf + m * d.ldE + n) = make_float2(c0, c1);
  };

  for (int l = nl - 1; l >= 0; --l) {
    const Slots s = slots(ws, l, R, T, E, Hd);
    const float* const* w = p.w[l];
    const float* aff = lnp + ((nl - 1 - l) & 1) * 4 * E;
    float* ln_part = s.ln + (size_t)blockIdx.x * kLnGroups * 4 * E;
    // ===== the forward, recomputed; the gradients' inputs to the workspace ===
    tc::cp_async_wait<0>();  // this layer's affines
    __syncthreads();         // the layer above is done with xin and the other affines
    if (l > 0) load_affines(lnp + ((nl - l) & 1) * 4 * E, p.w[l - 1], E);
    from_global(T, xin, d.ldE, xs + l * RTE + tok0 * E, E);
    __syncthreads();
    ln_fwd(d, xin, buf, aff, aff + E, eps, mean1, rstd1);
    __syncthreads();
    product<kQkvF>(d, w, buf, d.ldE, [&](int m, int n, float c0, float c1, float, float) {
      if (m < T) *reinterpret_cast<float2*>(qkv + m * d.ldQ + n) = make_float2(c0, c1);
    });
    to_global(T, s.h + tok0 * E, buf, d.ldE, E);
    to_global(T, s.m + tok0 * E, dcur, d.ldE, E);
    __syncthreads();
    attention_fwd(d, qkv, d.ldQ, buf, lse, scale_log2);
    __syncthreads();
    product<kProjF>(d, w, buf, d.ldE, [&](int m, int n, float c0, float c1, float, float) {
      if (m >= T) return;
      const float2 v = *reinterpret_cast<const float2*>(xin + m * d.ldE + n);
      *reinterpret_cast<float2*>(x1 + m * d.ldE + n) = make_float2(v.x + c0, v.y + c1);
    });
    to_global(T, s.attn + tok0 * E, buf, d.ldE, E);
    __syncthreads();
    ln_fwd(d, x1, buf, aff + 2 * E, aff + 3 * E, eps, mean2, rstd2);
    __syncthreads();
    product<kW12F>(d, w, buf, d.ldE,
                   [&](int m, int n, float a0, float a1, float b0, float b1) {
                     if (m >= T) return;
                     *reinterpret_cast<float2*>(ab + m * d.ldB + n) = make_float2(a0, a1);
                     *reinterpret_cast<float2*>(ab + m * d.ldB + d.HdP + n) = make_float2(b0, b1);
                     *reinterpret_cast<float2*>(s.g + (tok0 + m) * Hd + n) =
                         make_float2(silu(a0) * b0, silu(a1) * b1);
                   });
    to_global(T, s.h2 + tok0 * E, buf, d.ldE, E);

    // ===== the backward ========================================================
    // y = x1 + g @ wmlp^T: dm = dy; dg = dm @ wmlp, da = dg b silu'(a), db = dg silu(a)
    __syncthreads();
    product<kMlpB>(d, w, dcur, d.ldE, [&](int m, int n, float g0, float g1, float, float) {
      if (m >= T) return;
      float2* pa = reinterpret_cast<float2*>(ab + m * d.ldB + n);
      float2* pb = reinterpret_cast<float2*>(ab + m * d.ldB + d.HdP + n);
      const float2 a = *pa, b = *pb;
      const float s0 = sigmoid(a.x), s1 = sigmoid(a.y);
      const float2 da = make_float2(g0 * b.x * s0 * (1.0f + a.x * (1.0f - s0)),
                                    g1 * b.y * s1 * (1.0f + a.y * (1.0f - s1)));
      const float2 db = make_float2(g0 * a.x * s0, g1 * a.y * s1);
      *pa = da;
      *pb = db;
      float* o = s.dab + (tok0 + m) * 2 * Hd + n;
      *reinterpret_cast<float2*>(o) = da;
      *reinterpret_cast<float2*>(o + Hd) = db;
    });
    // dh2 = da @ w1 + db @ w2, then the second LayerNorm's backward into dx1
    __syncthreads();
    product<kW12B>(d, w, ab, d.ldB, to_buf);
    __syncthreads();
    ln_bwd(d, buf, x1, mean2, rstd2, aff + 2 * E, ln_part + 2 * E, dcur);
    // x1 = x + attn @ wproj^T: dproj = dx1, d(attention output) = dproj @ wproj
    __syncthreads();
    product<kProjB>(d, w, dcur, d.ldE, to_buf);
    if (l > 0) prefetch_layer(p.w[l - 1], E, Hd, kThreads / 2);
    to_global(T, s.dproj + tok0 * E, dcur, d.ldE, E);
    __syncthreads();
    attention_bwd(d, qkv, s.attn + tok0 * E, buf, lse, delta, dqkv, d.ldB, scale_log2,
                  scale);
    // dh = dqkv @ wqkv, then the first LayerNorm's backward into dx
    __syncthreads();
    product<kQkvB>(d, w, dqkv, d.ldB, to_buf);
    to_global(T, s.dqkv + tok0 * 3 * E, dqkv, d.ldB, 3 * E);
    __syncthreads();
    ln_bwd(d, buf, xin, mean1, rstd1, aff, ln_part, dcur);
  }
  __syncthreads();
  to_global(T, dx + tok0 * E, dcur, d.ldE, E);
}

// Floats of one layer's gradients in the gradient buffer: [dg1 | db1 | dg2 |
// db2] (4E), dwqkv (3E, E), dwproj (E, E), dw1 and dw2 (Hd, E each), dwmlp
// (E, Hd), each in its parameter's layout.
inline size_t grad_floats(int E, int Hd) {
  return 4 * (size_t)E + 4 * (size_t)E * E + 3 * (size_t)Hd * E;
}

// Floats of one layer's weight-gradient chunk partials: kGradSplits * (P * Q
// + P) for each of its five jobs (tiled::launch_weight_grads)
inline size_t grad_part_floats(int E, int Hd) {
  return (size_t)tiled::kGradSplits *
         (4 * (size_t)E * E + 3 * (size_t)E * Hd + 9 * (size_t)E + 2 * (size_t)Hd);
}

// The backward's workspace: per layer of a launch its slots, then the weight
// gradients' chunk partials
size_t workspace_floats(int R, int T, int E, int Hd, int L) {
  return (size_t)std::min(L, kMaxLayers) * (layer_floats(R, T, E, Hd) + grad_part_floats(E, Hd));
}

Layers layer_table(const void* const* weights, int l0, int nl) {
  Layers p = {};
  for (int l = 0; l < nl; ++l)
    for (int k = 0; k < kNames; ++k) p.w[l][k] = (const float*)weights[(l0 + l) * kNames + k];
  return p;
}

// The CTA's dynamic shared memory in bytes, or -1 for a shape the kernels
// do not take
long long smem_bytes(int T, int E, int H, int Hd, bool backward) {
  if (T <= 0 || E <= 0 || H <= 0 || E % 4 || Hd % 4 || E % H) return -1;
  const long long bytes = 4LL * act_floats(make_dims(T, E, H, Hd), backward);
  return bytes <= kMaxSmemBytes ? bytes : -1;
}

SmemAllowance g_fwd_smem, g_save_smem, g_bwd_smem;

}  // namespace

extern "C" {

// The dynamic shared memory of one CTA of the forward (backward = 0) or of
// the backward's row kernel, in bytes; -1 where the kernels do not take the
// shape. trunk_smem_bytes() in scldm_torch/ops/fused_trunk.py states the same.
long long scldm_fused_trunk_smem_bytes(int T, int E, int H, int Hd, int backward) {
  return smem_bytes(T, E, H, Hd, backward != 0);
}

// The floats of the backward's workspace for L layers of R rows of T tokens;
// trunk_workspace_floats() in scldm_torch/ops/fused_trunk.py states the same.
long long scldm_fused_trunk_workspace_floats(int R, int T, int E, int Hd, int L) {
  return (long long)workspace_floats(R, T, E, Hd, L);
}

// Launches the trunk's forward on `stream`, on the current device: one CTA
// of 512 threads per row, one launch per kMaxLayers layers. `weights`
// holds 9 * L pointers, layer by layer in TRUNK_WEIGHT_NAMES order. With
// `xs` (L, R, T, E) given, each layer's input is saved there. Returns the
// first CUDA error code (0 on success; cudaErrorInvalidValue for a shape the
// kernels do not take). Allocates nothing and does not synchronise.
int scldm_fused_trunk_forward(const void* x, const void* const* weights, void* out, void* xs,
                              int R, int T, int E, int H, int Hd, int L, float eps,
                              void* stream) {
  if (R == 0 || T == 0) return L > 0 ? 0 : (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(T, E, H, Hd, false);
  if (L <= 0 || smem < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  err = xs != nullptr ? allow_smem(trunk_forward_mma<true>, smem, g_save_smem)
                      : allow_smem(trunk_forward_mma<false>, smem, g_fwd_smem);
  if (err != cudaSuccess) return (int)err;
  const float* in = (const float*)x;
  for (int l0 = 0; l0 < L; l0 += kMaxLayers) {
    const int nl = std::min(kMaxLayers, L - l0);
    const Layers p = layer_table(weights, l0, nl);
    if (xs != nullptr)
      trunk_forward_mma<true><<<R, kThreads, smem, s>>>(
          in, (float*)out, (float*)xs + (size_t)l0 * R * T * E, p, nl, R, T, E, H, Hd, eps);
    else
      trunk_forward_mma<false><<<R, kThreads, smem, s>>>(in, (float*)out, nullptr, p, nl, R,
                                                            T, E, H, Hd, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    in = (const float*)out;
  }
  return 0;
}

// Launches the trunk's backward on `stream`, on the current device: per
// kMaxLayers layers, top-down, the row kernel (one CTA of 512 threads per
// row) and the weight gradients (tiled::grad_gemm, then grad_reduce).
// xs (L, R, T, E) holds each layer's input, as the saving forward wrote it;
// `weights` as for the forward. dx (R, T, E) and dw (L layers of
// grad_floats() each) are written whole. `workspace` holds
// scldm_fused_trunk_workspace_floats() floats. Returns the
// first CUDA error code (0 on success; cudaErrorInvalidValue for a shape the
// kernels do not take). Allocates nothing and does not synchronise.
int scldm_fused_trunk_backward(const void* xs, const void* const* weights, const void* dy,
                               void* dx, void* dw, void* workspace, int R, int T, int E, int H,
                               int Hd, int L, float eps, void* stream) {
  if (R == 0 || T == 0) return L > 0 ? 0 : (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(T, E, H, Hd, true);
  if (L <= 0 || smem < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = allow_smem(trunk_backward_mma, smem, g_bwd_smem)) != cudaSuccess) return (int)err;
  float* ws = (float*)workspace;
  float* part = ws + std::min(L, kMaxLayers) * layer_floats(R, T, E, Hd);
  const int N = R * T;
  const float* cot = (const float*)dy;
  for (int l0 = ((L - 1) / kMaxLayers) * kMaxLayers; l0 >= 0; l0 -= kMaxLayers) {
    const int nl = std::min(kMaxLayers, L - l0);
    trunk_backward_mma<<<R, kThreads, smem, s>>>(
        (const float*)xs + (size_t)l0 * R * T * E, cot, (float*)dx, layer_table(weights, l0, nl),
        nl, ws, R, T, E, H, Hd, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    tiled::GradJobs<kJobs> jobs{};
    for (int i = 0; i < nl; ++i) {
      const Slots sl = slots(ws, i, R, T, E, Hd);
      float* g = (float*)dw + (size_t)(l0 + i) * grad_floats(E, Hd);
      float* gqkv = g + 4 * E;
      float* gproj = gqkv + 3 * E * E;
      float* g12 = gproj + E * E;
      float* gmlp = g12 + 2 * Hd * E;
      const tiled::GradJob layer[5] = {
          {sl.dqkv, sl.h, gqkv, nullptr, nullptr, 3 * E, E, N, 1, 0, 0, 0},
          {sl.dproj, sl.attn, gproj, nullptr, nullptr, E, E, N, 1, 0, 0, 0},
          {sl.dab, sl.h2, g12, nullptr, nullptr, 2 * Hd, E, N, 1, 0, 0, 0},
          {sl.m, sl.g, gmlp, nullptr, nullptr, E, Hd, N, 1, 0, 0, 0},
          // the LayerNorm affines' gradients: column sums of the rows' group partials
          {sl.ln, nullptr, nullptr, g, nullptr, 4 * E, 0, R * kLnGroups, 1, 0, 0, 0},
      };
      for (const tiled::GradJob& jb : layer) jobs.job[jobs.n++] = jb;
    }
    if ((err = tiled::launch_weight_grads(jobs, part, s)) != cudaSuccess) return (int)err;
    cot = (const float*)dx;
  }
  return 0;
}

}  // extern "C"
