// Device helpers and kernels shared by the DiT block kernels (dit_block.cu,
// the forward, and dit_block_bwd.cu, its recompute backward), and the
// weight-gradient kernel that dit_block_bwd.cu and fused_trunk.cu share
// (weight_grads). f32 throughout.
//
// The block is split over several kernels so that no CTA holds a whole DiT
// row: the token-wise stages run one CTA per (row, tile of kTok tokens), the
// attention one CTA per (row, head), the per-row products over tiles of
// kRowTile rows; what one kernel hands the next goes through device memory
// (a few MB at the training and sampling shapes, so it stays in the 50 MB
// L2). Shared memory is then bounded by a token tile and by one head's T x T
// scores, not by the row: scldm_torch/ops/fused_dit.py states each kernel's
// need (dit_block_smem_bytes, dit_block_bwd_smem_bytes) and checks it before
// launch; keep the two in step with the layouts here and in the two sources.
//
// The kernels below sit in an unnamed namespace: each source that includes
// this header compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

namespace dit {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTok = 16;     // tokens whose sums one thread keeps; a token-wise CTA's tile
constexpr int kRowTile = 8;  // rows per CTA of rows_gemm (kRowTile * 32 == kThreads)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[w][i] = sum_k in[(t0 + i) * K + k] * Ww[k * ldw + n]  for i < tn,
// with W0 (and W1 when NW == 2) row-major (K, ldw) in global memory and `in`
// in shared memory, 16-byte aligned, K % 4 == 0.
template <int NW>
__device__ __forceinline__ void dot_tile(const float* in, int K, int t0, int tn,
                                         const float* __restrict__ W0,
                                         const float* __restrict__ W1, int ldw,
                                         int n, float (&acc)[NW][kTok]) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < kTok; ++i) acc[w][i] = 0.0f;

#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float wv[NW][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wv[0][j] = __ldg(W0 + (size_t)(k + j) * ldw + n);
      if (NW == 2) wv[NW - 1][j] = __ldg(W1 + (size_t)(k + j) * ldw + n);
    }
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      if (i < tn) {
        const float4 a = *reinterpret_cast<const float4*>(in + (t0 + i) * K + k);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          acc[w][i] = fmaf(a.x, wv[w][0], acc[w][i]);
          acc[w][i] = fmaf(a.y, wv[w][1], acc[w][i]);
          acc[w][i] = fmaf(a.z, wv[w][2], acc[w][i]);
          acc[w][i] = fmaf(a.w, wv[w][3], acc[w][i]);
        }
      }
    }
  }
}

// dst[t, :] = LN(src[t, :]) * (1 + scale) + shift, one warp per token (dst
// may be src: each lane reads its entries before it writes them). With
// `mean` and `rstd` given, also stores each token's mean and 1/sqrt(var + eps).
__device__ inline void ln_modulate(const float* src, float* dst, int T, int E,
                                   const float* scale, const float* shift, float eps,
                                   float* mean_out = nullptr, float* rstd_out = nullptr) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < T; t += n_warps) {
    const float* r = src + t * E;
    float s = 0.0f;
    for (int e = lane; e < E; e += 32) s += r[e];
    const float mean = warp_sum(s) / E;
    float v = 0.0f;
    for (int e = lane; e < E; e += 32) {
      const float d = r[e] - mean;
      v += d * d;
    }
    const float inv = 1.0f / sqrtf(warp_sum(v) / E + eps);
    for (int e = lane; e < E; e += 32)
      dst[t * E + e] = (r[e] - mean) * inv * (1.0f + scale[e]) + shift[e];
    if (mean_out != nullptr && lane == 0) {
      mean_out[t] = mean;
      rstd_out[t] = inv;
    }
  }
}

// Floats of shared memory of the attention forward: q (T, hd), k (T, hd + 1),
// v (T, hd) and the scores (T, T).
__host__ __device__ inline int attention_floats(int T, int hd) {
  return 2 * T * hd + T * (hd + 1) + T * T;
}

// Floats of shared memory of rows_gemm: the staged input (kRowTile, K) and
// the warps' partial sums (kWarps, kRowTile, 32).
__host__ __device__ inline int rows_gemm_floats(int K) {
  return kRowTile * K + kWarps * kRowTile * 32;
}

// p = softmax(q k^T * scale) over each row of the (T, T) scores, with q (T,
// hd) and k (T, ldk) in shared memory (k padded so that the lanes of a warp,
// reading the rows of k, read other banks). The scores are taken as the
// plain version takes them, s * scale, then the max, the exponentials and
// their sum; one warp per query row.
__device__ inline void scores_softmax(const float* qs, const float* ks, int ldk, float* ps,
                                      int T, int hd, float scale) {
  for (int idx = threadIdx.x; idx < T * T; idx += blockDim.x) {
    const int i = idx / T, j = idx % T;
    float s = 0.0f;
    for (int d = 0; d < hd; ++d) s = fmaf(qs[i * hd + d], ks[j * ldk + d], s);
    ps[idx] = s * scale;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < T; i += blockDim.x >> 5) {
    float* p = ps + i * T;
    float m = -INFINITY;
    for (int j = lane; j < T; j += 32) m = fmaxf(m, p[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < T; j += 32) {
      p[j] = expf(p[j] - m);
      sum += p[j];
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) p[j] /= sum;
  }
}

// Sets a kernel's dynamic shared memory limit on the current device, once
// per device and size: the attribute is set only when a launch needs more
// than 48 KB and more than the kernel was allowed before.
struct SmemAllowance {
  std::atomic<long long> bytes[kMaxDevices];
};

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, long long need, SmemAllowance& allowed) {
  if (need <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && need <= allowed.bytes[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
  if (err == cudaSuccess && dev < kMaxDevices) allowed.bytes[dev].store(need);
  return err;
}

namespace {

enum class RowsIn { kSilu, kSumParts };
enum class RowsOut { kBias, kSiluGrad };

// out[r, n] = sum_k in(r, k) * W[k, n], then + aux[n] (kBias) or times
// silu'(aux[r, n]) (kSiluGrad), for r < R and n < N; W is row-major (K, N).
// in(r, k) is silu(src[r, k]) (kSilu, src (R, K)) or the sum over p < P, in
// order, of src[(r * P + p) * K + k] (kSumParts, src (R, P, K)); the CTAs of
// column block 0 also write in(r, k) to `staged` (R, K) when it is given.
// One CTA: kRowTile rows and 32 columns, grid (ceil(N / 32), ceil(R /
// kRowTile)); warp w sums the w-th eighth of K, one weight load feeding
// kRowTile FMAs, and the eight partial sums are added in order.
template <RowsIn In, RowsOut Out>
__global__ void __launch_bounds__(kThreads)
rows_gemm(const float* __restrict__ src, int P, const float* __restrict__ W,
          const float* __restrict__ aux, float* __restrict__ out, float* __restrict__ staged,
          int R, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  float* ins = smem;                 // (kRowTile, K)
  float* red = ins + kRowTile * K;   // (kWarps, kRowTile, 32)
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kRowTile;
  const int rn = min(kRowTile, R - r0);
  for (int i = tid; i < kRowTile * K; i += kThreads) {
    const int r = i / K, k = i % K;
    float v = 0.0f;
    if (r < rn) {
      const size_t at = (size_t)(r0 + r) * K + k;
      if (In == RowsIn::kSilu) {
        v = silu(src[at]);
      } else {
        for (int p = 0; p < P; ++p) v += src[((size_t)(r0 + r) * P + p) * K + k];
      }
      if (staged != nullptr && blockIdx.x == 0) staged[at] = v;
    }
    ins[i] = v;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int ks = (K + kWarps - 1) / kWarps;
  const int k0 = warp * ks, k1 = min(K, k0 + ks);
  float acc[kRowTile];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) acc[r] = 0.0f;
  if (n < N) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float w = __ldg(W + (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) acc[r] = fmaf(ins[r * K + k], w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) red[(warp * kRowTile + r) * 32 + lane] = acc[r];
  __syncthreads();
  const int r = warp;  // one output per thread: row `warp`, column `n`
  if (n < N && r < rn) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * kRowTile + r) * 32 + lane];
    const size_t o = (size_t)(r0 + r) * N + n;
    if (Out == RowsOut::kBias) {
      out[o] = s + aux[n];
    } else {
      const float cv = aux[o];
      const float sg = sigmoid(cv);
      out[o] = s * sg * (1.0f + cv * (1.0f - sg));
    }
  }
}

// For the tokens of one (row, tile of kTok tokens), grid R * ceil(T / kTok):
// h = LN(x) * (1 + scale_a) + shift_a, then qkv = h @ wqkv + bqkv; h also
// goes to `h_out` when given. mod (R, 6E) holds each row's modulation.
__global__ void __launch_bounds__(kThreads, 2)
ln_qkv(const float* __restrict__ x, const float* __restrict__ mod,
       const float* __restrict__ wqkv, const float* __restrict__ bqkv, float* __restrict__ qkv,
       float* __restrict__ h_out, int T, int E, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;  // (kTok, E) x, then h
  const int nt = (T + kTok - 1) / kTok;
  const int row = blockIdx.x / nt;
  const int t0 = (blockIdx.x % nt) * kTok;
  const int tn = min(kTok, T - t0);
  const size_t tok = (size_t)row * T + t0;
  const float* mrow = mod + (size_t)row * 6 * E;

  for (int i = threadIdx.x; i < tn * E; i += kThreads) hs[i] = x[tok * E + i];
  __syncthreads();
  ln_modulate(hs, hs, tn, E, mrow, mrow + E, eps);
  __syncthreads();
  if (h_out != nullptr)
    for (int i = threadIdx.x; i < tn * E; i += kThreads) h_out[tok * E + i] = hs[i];

  const int E3 = 3 * E;
  for (int n = threadIdx.x; n < E3; n += kThreads) {
    float acc[1][kTok];
    dot_tile<1>(hs, E, 0, tn, wqkv, nullptr, E3, n, acc);
    const float b = bqkv[n];
#pragma unroll
    for (int i = 0; i < kTok; ++i)
      if (i < tn) qkv[(tok + i) * E3 + n] = acc[0][i] + b;
  }
}

// o[t, h*hd:(h+1)*hd] = softmax(q_h k_h^T / sqrt(hd)) v_h for one (row, head),
// grid R * H, from qkv (R*T, 3E); o is (R*T, E).
__global__ void __launch_bounds__(kThreads)
attention(const float* __restrict__ qkv, float* __restrict__ o, int T, int E, int H) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = E / H, E3 = 3 * E, ldk = hd + 1;
  float* qs = smem;           // (T, hd)
  float* ks = qs + T * hd;    // (T, hd + 1)
  float* vs = ks + T * ldk;   // (T, hd)
  float* ps = vs + T * hd;    // (T, T) scores, then probabilities
  const float* base = qkv + (size_t)row * T * E3 + h * hd;
  for (int i = threadIdx.x; i < T * hd; i += kThreads) {
    const int t = i / hd, d = i % hd;
    const float* s = base + (size_t)t * E3 + d;
    qs[i] = s[0];
    ks[t * ldk + d] = s[E];
    vs[i] = s[2 * E];
  }
  __syncthreads();
  scores_softmax(qs, ks, ldk, ps, T, hd, 1.0f / sqrtf((float)hd));
  __syncthreads();
  for (int i = threadIdx.x; i < T * hd; i += kThreads) {
    const int t = i / hd, d = i % hd;
    const float* p = ps + t * T;
    float s = 0.0f;
    for (int j = 0; j < T; ++j) s = fmaf(p[j], vs[j * hd + d], s);
    o[((size_t)row * T + t) * E + h * hd + d] = s;
  }
}

// One weight gradient: out (P, Q) = sum_n u[n, p] * v[n, q] over N rows, and
// bias (P) = sum_n u[n, p] when given; with v == nullptr, only bias (a
// column sum of u). tiles_q and tile0 are filled by plan_grad_jobs.
struct GradJob {
  const float* u;
  const float* v;
  float* out;
  float* bias;
  int P, Q, N, tiles_q, tile0;
};

template <int kMax>
struct GradJobs {
  GradJob job[kMax];
  int n;
};

constexpr int kTileP = 64, kTileQ = 64, kTileN = 16;

// Numbers the CTAs of each job (64 x 64 outputs each; a column sum takes one
// CTA per 64 columns) and returns how many the launch needs.
template <int kMax>
inline int plan_grad_jobs(GradJobs<kMax>& jobs) {
  int tiles = 0;
  for (int j = 0; j < jobs.n; ++j) {
    GradJob& jb = jobs.job[j];
    jb.tiles_q = jb.v != nullptr ? (jb.Q + kTileQ - 1) / kTileQ : 1;
    jb.tile0 = tiles;
    tiles += ((jb.P + kTileP - 1) / kTileP) * jb.tiles_q;
  }
  return tiles;
}

// Every job's gradient in one launch of plan_grad_jobs()'s CTAs, 256 threads
// each: a tiled U^T V over the N rows, 4 x 4 outputs per thread, 16 rows per
// shared-memory stage; the bias (column sum of U) is taken by the CTAs of the
// first column tile. No atomics: every sum is taken in a fixed order.
template <int kMax>
__global__ void __launch_bounds__(256) weight_grads(const __grid_constant__ GradJobs<kMax> jobs) {
  __shared__ __align__(16) float us[kTileN][kTileP];
  __shared__ __align__(16) float vs[kTileN][kTileQ];
  int j = 0;
  while (j + 1 < jobs.n && (int)blockIdx.x >= jobs.job[j + 1].tile0) ++j;
  const GradJob jb = jobs.job[j];
  const bool product = jb.v != nullptr;
  const int tile = blockIdx.x - jb.tile0;
  const int p0 = (tile / jb.tiles_q) * kTileP;
  const int q0 = (tile % jb.tiles_q) * kTileQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const bool with_bias = jb.bias != nullptr && q0 == 0;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  float bsum = 0.0f;

  for (int n0 = 0; n0 < jb.N; n0 += kTileN) {
    for (int i = tid; i < kTileN * kTileP; i += blockDim.x) {
      const int r = i / kTileP, col = i % kTileP;
      const int n = n0 + r;
      us[r][col] = (n < jb.N && p0 + col < jb.P) ? jb.u[(size_t)n * jb.P + p0 + col] : 0.0f;
      vs[r][col] = (product && n < jb.N && q0 + col < jb.Q)
                       ? jb.v[(size_t)n * jb.Q + q0 + col] : 0.0f;
    }
    __syncthreads();
    if (with_bias && tid < kTileP)
      for (int r = 0; r < kTileN; ++r) bsum += us[r][tid];
    if (product) {
#pragma unroll
      for (int r = 0; r < kTileN; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&us[r][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&vs[r][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
      }
    }
    __syncthreads();
  }
  if (product) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      if (p >= jb.P) continue;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = q0 + tx * 4 + k;
        if (q < jb.Q) jb.out[(size_t)p * jb.Q + q] = acc[i][k];
      }
    }
  }
  if (with_bias && tid < kTileP && p0 + tid < jb.P) jb.bias[p0 + tid] = bsum;
}

}  // namespace

}  // namespace dit
