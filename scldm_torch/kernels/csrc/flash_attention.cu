// Long-axis flash attention, forward only: softmax(q k^T / sqrt(D)) v with a
// streaming softmax, no mask, not causal. f32 or bf16 operands, f32 scores,
// softmax and accumulator, the output in the operands' type.
//
// Replaces the TPU kernel scldm_tpu/ops/flash_attention.py::flash_attention
// (Pallas body `_flash_kernel`): q (B, M, H, D), k and v (B, S, H, D) -> out
// (B, M, H, D), with keys past S in the last tile masked. Like the TPU
// kernel it has no backward; `sdpa` (scldm_torch/ops/attention.py) takes it
// only where no gradient flows, once both the query and the key axis reach
// 1,024 tokens: the MCAB and the self-attention of a VAE or DiT over 1,024
// latent tokens.
//
// What bounds it on an H100: operations. The two products are 4*B*H*M*S*D
// operations (137 GFLOP at the long-latent MCAB, B = 16, M = 1,024, S =
// 4,096, H = 8, D = 64: 2.05 ms at the f32 peak of 67 TFLOP/s) against q, k,
// v and out read or written once (0.5 GB there: 0.16 ms at 3.35 TB/s). Like
// the TPU kernel it keeps the (B, H, M, S) scores out of device memory (2.1
// GB in f32 at that shape, and as much again for the probabilities).
//
// What the design does about it (a first, simple design: f32 FMA, no tensor
// cores, no asynchronous copies):
// - One CTA of 256 threads per (cell, head, tile of 64 queries); the grid's
//   sequential key axis becomes a loop inside the CTA over tiles of 64 keys.
// - The head width is zero-padded on load to a compiled width DP of 16, 32,
//   64 or 128 (the TPU kernel pads to 128 lanes); D > 128 is refused.
// - q (scaled by 1/sqrt(D)) and each k tile are staged transposed, d-major,
//   so that each thread reads its four query rows and four key columns as
//   one float4 each per d: a 4 x 4 register tile of scores, 16 FMA per two
//   shared-memory loads. Thread (ty, tx) owns query rows 4ty..4ty+3 and key
//   columns 4tx..4tx+3; a row's 64 scores lie on the 16 lanes of one half
//   warp, so its max is four shuffles.
// - The running (m, l, acc) stay in registers: m the row max, l each
//   thread's share of the row sum (summed over the half warp once, at the
//   end), acc the thread's 4 x DP/16 slice of the output rows. The
//   probabilities go through shared memory, transposed, into the second
//   product, which reads a float4 of them and DP/16 values of v per key.
// - Keys past S score -inf: exp gives 0, and every tile holds at least one
//   real key, so m is finite after the first tile and no l is 0. Queries
//   past M read zeros and store nothing.
// - The operands are read through their strides (cell, token, head; the
//   head width contiguous): the fused qkv and kv projections' chunk views,
//   whose token stride is 3E or 2E, need no copy.
// - No atomics: the sums run in a fixed order, the same bits every run.
// Shared memory: 4 * (2 * DP * 68 + 64 * DP + 64 * 68) bytes: 68,608 at DP =
// 64, 119,808 at DP = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;        // queries per CTA
constexpr int kBN = 64;        // keys per tile
constexpr int kLd = kBM + 4;   // a transposed row of 64, padded (float4-aligned)
constexpr int kMaxHeadDim = 128;

struct Strides {
  long long b, s, h;  // cell, token and head strides in elements; d is contiguous
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DP>
constexpr int smem_floats() {
  return 2 * DP * kLd + kBN * DP + kBN * kLd;
}

// x[0..NC) = p[0..NC), NC consecutive floats aligned to 4 * NC bytes (up to 16)
template <int NC>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[NC]) {
  if constexpr (NC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < NC; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      x[c] = t.x, x[c + 1] = t.y, x[c + 2] = t.z, x[c + 3] = t.w;
    }
  } else if constexpr (NC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int M, int S, int H, int D,
                        Strides qs, Strides ks, Strides vs, int n_qtiles, float scale) {
  constexpr int NC = DP / 16;  // output columns per thread
  extern __shared__ float4 smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [DP][kLd]: q, transposed and scaled
  float* kt = qt + DP * kLd;                         // [DP][kLd]: a k tile, transposed
  float* vt = kt + DP * kLd;                         // [kBN][DP]: a v tile
  float* pt = vt + kBN * DP;                         // [kBN][kLd]: probabilities, transposed

  const int bh = blockIdx.x / n_qtiles;
  const int m0 = (blockIdx.x % n_qtiles) * kBM;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;

  // the query tile: lanes along d, so a warp reads whole rows
  for (int e = tid; e < kBM * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    float x = 0.0f;
    if (m0 + r < M && d < D) x = load_f32(qb + (long long)(m0 + r) * qs.s + d) * scale;
    qt[d * kLd + r] = x;
  }

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int n0 = 0; n0 < S; n0 += kBN) {
    __syncthreads();  // the previous tile's probabilities and values are read
    for (int e = tid; e < kBN * DP; e += kThreads) {
      const int r = e / DP, d = e % DP;
      float xk = 0.0f, xv = 0.0f;
      if (n0 + r < S && d < D) {
        xk = load_f32(kb + (long long)(n0 + r) * ks.s + d);
        xv = load_f32(vb + (long long)(n0 + r) * vs.s + d);
      }
      kt[d * kLd + r] = xk;
      vt[r * DP + d] = xv;
    }
    __syncthreads();

    // scores: rows 4ty.., keys 4tx..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < DP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + 4 * tx + j >= S)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;

    // the online softmax: the row max over the half warp, then rescale
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      m_i[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        pt[(4 * tx + j) * kLd + 4 * ty + i] = p;
      }
      l_i[i] = l_i[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p v: rows 4ty.., columns NC*tx..
#pragma unroll 8
    for (int key = 0; key < kBN; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(pt + key * kLd + 4 * ty);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float vv[NC];
      load_cols<NC>(vt + key * DP + NC * tx, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  // each row's sum over its half warp, then out = acc / l
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int r = m0 + 4 * ty + i;
    if (r >= M) continue;
    T* o = out + (((long long)b * M + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = NC * tx + c;
      if (d < D) store_as(o + d, acc[i][c] / l);
    }
  }
}

// The dynamic shared memory each instance is already allowed, per device:
// the attribute is set only the first time an instance launches there.
constexpr int kMaxDevices = 64;

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int M, int S,
                   int H, int D, Strides qs, Strides ks, Strides vs, cudaStream_t stream) {
  static std::atomic<bool> allowed[kMaxDevices];
  constexpr int smem = 4 * smem_floats<DP>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev].load()) {
    err = cudaFuncSetAttribute(flash_attention_fwd<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev].store(true);
  }
  const int n_qtiles = (M + kBM - 1) / kBM;
  const long long blocks = (long long)B * H * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_attention_fwd<T, DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, M, S, H, D, qs, ks, vs, n_qtiles,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k, const void* v, void* out, int B, int M,
                         int S, int H, int D, Strides qs, Strides ks, Strides vs,
                         cudaStream_t stream) {
  if (D <= 16) return launch<T, 16>(q, k, v, out, B, M, S, H, D, qs, ks, vs, stream);
  if (D <= 32) return launch<T, 32>(q, k, v, out, B, M, S, H, D, qs, ks, vs, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, out, B, M, S, H, D, qs, ks, vs, stream);
  return launch<T, 128>(q, k, v, out, B, M, S, H, D, qs, ks, vs, stream);
}

}  // namespace

extern "C" {

// Launches the flash attention forward on `stream`, on the current device.
// q (B, M, H, D), k and v (B, S, H, D) are read through their strides (in
// elements: cell, token, head; the head width contiguous); out (B, M, H, D)
// is contiguous. All four are float32 (bf16 == 0) or bfloat16 (bf16 == 1).
// Returns the first CUDA error code (0 on success; cudaErrorInvalidValue for
// D outside 1..128 or S < 1). Allocates nothing and does not synchronise.
int scldm_flash_attention_forward(const void* q, const void* k, const void* v, void* out, int B,
                                  int M, int S, int H, int D, long long qsb, long long qss,
                                  long long qsh, long long ksb, long long kss, long long ksh,
                                  long long vsb, long long vss, long long vsh, int bf16,
                                  void* stream) {
  if (D < 1 || D > kMaxHeadDim || S < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0 || H == 0) return 0;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_width<__nv_bfloat16>(q, k, v, out, B, M, S, H, D, qs, ks, vs, s)
                    : launch_width<float>(q, k, v, out, B, M, S, H, D, qs, ks, vs, s));
}

}  // extern "C"
