// Flash cross-attention forward: many batch-shared queries into few keys,
// bf16 operands on the tensor cores, f32 accumulation.
//
// Replaces the TPU kernel scldm_tpu/ops/fused_cross.py::flash_cross_attention
// (Pallas body `_fwd_kernel`, launched by `_flash_fwd_impl`): for qp (G, E),
// k and v (B, M, E) and H heads of hd = E / H columns,
//
//   y[b, g, h*hd:(h+1)*hd] = softmax(qp_h[g] k_h[b]^T / sqrt(hd)) v_h[b]
//
// with qp, k and v rounded to bf16, the scores in f32, the probabilities
// rounded to bf16 before the second product, and y in f32. The census
// decoder's gene queries take it: G = 36,601 genes into M = 64 latent
// tokens, E = 512, 8 heads of 64.
//
// What bounds it on an H100: writing y, B*G*E*4 bytes (2.40 GB at the census
// sampler's 2B = 32 cells: 0.72 ms at 3.35 TB/s). The two products are
// 4*B*G*M*E operations (154 GFLOP, 0.16 ms at the bf16 tensor-core peak).
// Like the TPU kernel it keeps the (B, H, G, M) scores and probabilities out
// of device memory (2.4 GB each in f32 at that shape).
//
// What the design does about it:
// - The TPU kernel's block-diagonal kblk / vblk operands, which do H times
//   the attention work to keep the MXU full, are not carried over: each head
//   is its own pair of products on mma.sync m16n8k16 (bf16 in, f32
//   accumulate), which rounds exactly where the Pallas kernel rounds.
// - round_kv rounds k and v to bf16 once, into (B, H, M, hd) and, transposed,
//   (B, H, hd, M): the second product's B fragments are then adjacent pairs.
// - flash_cross_fwd: one CTA of 8 warps per (tile of kBatch batch elements,
//   tile of kRows = 128 genes), the batch tile fastest, so that the CTAs
//   reading the same qp rows run together and read them from L2. Per head a
//   warp loads its 16 rows of qp_h as A fragments, rounding to bf16, and
//   keeps them in registers across the batch elements (the TPU kernel's
//   resident qp tile). Per (head, batch element) the CTA stages k_h and
//   v_h^T in shared memory (18 KB with rows padded so that the fragment loads
//   hit 32 distinct banks); each warp takes its 16 x 64 scores (32 mma), the
//   softmax of each row in registers (a row's 64 scores lie on the four lanes
//   of a quad), rounds p to bf16 as the A fragments of the second product (no
//   trip through shared memory), takes 32 more mma and stores its 16 x 64
//   slice of y: 256 contiguous bytes a row, whole 32-byte sectors.
// - The ragged last gene tile reads zero queries and stores nothing for them;
//   a ragged batch tile skips the missing elements. Nothing is padded.
// Built for M = 64 keys and hd = 64 (kM, kHd); the wrapper
// (scldm_torch/ops/fused_cross.py) raises on other widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;            // head width
constexpr int kM = 64;             // keys (latent tokens)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // gene rows per CTA, 16 per warp
constexpr int kBatch = 8;           // batch elements per CTA
constexpr int kLd = 72;             // a staged row of 64 bf16, padded by 8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16 x 16, row-major bf16) * b (16 x 8, column-major bf16), f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kb[b, h, m, d] = bf16(k[b, m, h*hd + d]); vt[b, h, d, m] = bf16(v[b, m, h*hd + d]).
__global__ void round_kv(const float* __restrict__ k, const float* __restrict__ v,
                         __nv_bfloat16* __restrict__ kb, __nv_bfloat16* __restrict__ vt, int B,
                         int H) {
  const int E = H * kHd;
  const size_t n = (size_t)B * kM * E;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int e = (int)(i % E);
    const size_t bm = i / E;
    const int m = (int)(bm % kM);
    const size_t b = bm / kM;
    const size_t bh = b * H + e / kHd;
    const int d = e % kHd;
    kb[(bh * kM + m) * kHd + d] = __float2bfloat16_rn(k[i]);
    vt[(bh * kHd + d) * kM + m] = __float2bfloat16_rn(v[i]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
flash_cross_fwd(const float* __restrict__ qp, const __nv_bfloat16* __restrict__ kb,
                const __nv_bfloat16* __restrict__ vt, float* __restrict__ y, int G, int B, int H,
                float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kM * kLd];   // k_h, (M, hd)
  __shared__ __align__(16) __nv_bfloat16 vs[kHd * kLd];  // v_h^T, (hd, M)
  const int E = H * kHd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' group and thread in group
  const int b0 = blockIdx.x * kBatch;
  const int bn = min(kBatch, B - b0);
  const int ra = blockIdx.y * kRows + warp * 16 + gq;  // this lane's two rows
  const int rb = ra + 8;
  const bool va = ra < G, vb = rb < G;
  const float2 zero = make_float2(0.0f, 0.0f);

  for (int h = 0; h < H; ++h) {
    // the warp's 16 rows of qp_h as A fragments, 4 chunks of 16 columns
    uint32_t qa[kHd / 16][4];
    const float* qh = qp + h * kHd + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      const int col = 16 * kk;
      const float2 x0 = va ? *reinterpret_cast<const float2*>(qh + (size_t)ra * E + col) : zero;
      const float2 x1 = vb ? *reinterpret_cast<const float2*>(qh + (size_t)rb * E + col) : zero;
      const float2 x2 = va ? *reinterpret_cast<const float2*>(qh + (size_t)ra * E + col + 8) : zero;
      const float2 x3 = vb ? *reinterpret_cast<const float2*>(qh + (size_t)rb * E + col + 8) : zero;
      qa[kk][0] = pack_bf16(x0.x, x0.y);
      qa[kk][1] = pack_bf16(x1.x, x1.y);
      qa[kk][2] = pack_bf16(x2.x, x2.y);
      qa[kk][3] = pack_bf16(x3.x, x3.y);
    }

    for (int bi = 0; bi < bn; ++bi) {
      const size_t bh = (size_t)(b0 + bi) * H + h;
      __syncthreads();  // every warp is done with the previous tiles
      const uint4* ksrc = reinterpret_cast<const uint4*>(kb + bh * kM * kHd);
      const uint4* vsrc = reinterpret_cast<const uint4*>(vt + bh * kHd * kM);
      for (int i = threadIdx.x; i < kM * kHd / 8; i += kThreads) {
        const int r = i / (kHd / 8), c = (i % (kHd / 8)) * 8;
        *reinterpret_cast<uint4*>(ks + r * kLd + c) = ksrc[i];
        *reinterpret_cast<uint4*>(vs + r * kLd + c) = vsrc[i];
      }
      __syncthreads();

      // scores: 8 tiles of 8 keys; s[j][0..1] row ra, s[j][2..3] row rb,
      // keys 8j + 2tq and 8j + 2tq + 1
      float s[kM / 8][4];
#pragma unroll
      for (int j = 0; j < kM / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk)
#pragma unroll
        for (int j = 0; j < kM / 8; ++j) {
          const __nv_bfloat16* kr = ks + (8 * j + gq) * kLd + 16 * kk + 2 * tq;
          mma_bf16(s[j], qa[kk], load_pair(kr), load_pair(kr + 8));
        }

      // the softmax of rows ra and rb: s * scale, the max, exp, the sum
      float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
      for (int j = 0; j < kM / 8; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) s[j][q] *= scale;
        ma = fmaxf(ma, fmaxf(s[j][0], s[j][1]));
        mb = fmaxf(mb, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      }
      float sa = 0.0f, sb = 0.0f;
#pragma unroll
      for (int j = 0; j < kM / 8; ++j) {
        s[j][0] = expf(s[j][0] - ma);
        s[j][1] = expf(s[j][1] - ma);
        s[j][2] = expf(s[j][2] - mb);
        s[j][3] = expf(s[j][3] - mb);
        sa += s[j][0] + s[j][1];
        sb += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, o);
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
      }

      // p in bf16, already laid out as the A fragments of p @ v: key chunk kk
      // is score tiles 2kk and 2kk + 1
      uint32_t pa[kM / 16][4];
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0] / sa, s[2 * kk][1] / sa);
        pa[kk][1] = pack_bf16(s[2 * kk][2] / sb, s[2 * kk][3] / sb);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0] / sa, s[2 * kk + 1][1] / sa);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2] / sb, s[2 * kk + 1][3] / sb);
      }

      // y = p v: 8 tiles of 8 columns of the head
      float o[kHd / 8][4];
#pragma unroll
      for (int j = 0; j < kHd / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
        for (int j = 0; j < kHd / 8; ++j) {
          const __nv_bfloat16* vr = vs + (8 * j + gq) * kLd + 16 * kk + 2 * tq;
          mma_bf16(o[j], pa[kk], load_pair(vr), load_pair(vr + 8));
        }

      float* yb = y + (size_t)(b0 + bi) * G * E + h * kHd + 2 * tq;
#pragma unroll
      for (int j = 0; j < kHd / 8; ++j) {
        if (va)
          *reinterpret_cast<float2*>(yb + (size_t)ra * E + 8 * j) = make_float2(o[j][0], o[j][1]);
        if (vb)
          *reinterpret_cast<float2*>(yb + (size_t)rb * E + 8 * j) = make_float2(o[j][2], o[j][3]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the flash cross-attention forward on `stream`, on the current
// device: round_kv, then flash_cross_fwd. qp (G, E), k and v (B, M, E) and y
// (B, G, E) are contiguous f32; `workspace` holds 2*B*M*E bf16 (the rounded
// k and the rounded, transposed v). Returns the first CUDA error code (0 on
// success; cudaErrorInvalidValue for M or E / H other than 64). Allocates
// nothing and does not synchronise.
int scldm_flash_cross_forward(const void* qp, const void* k, const void* v, void* y,
                              void* workspace, int G, int B, int M, int E, int H, void* stream) {
  if (M != kM || E != H * kHd) return (int)cudaErrorInvalidValue;
  if (G == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  __nv_bfloat16* kb = (__nv_bfloat16*)workspace;
  __nv_bfloat16* vt = kb + (size_t)B * M * E;
  const size_t n = (size_t)B * M * E;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  round_kv<<<blocks, 256, 0, s>>>((const float*)k, (const float*)v, kb, vt, B, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kBatch - 1) / kBatch, (G + kRows - 1) / kRows);
  flash_cross_fwd<<<grid, kThreads, 0, s>>>((const float*)qp, kb, vt, (float*)y, G, B, H,
                                            1.0f / sqrtf((float)kHd));
  return (int)cudaGetLastError();
}

}  // extern "C"
