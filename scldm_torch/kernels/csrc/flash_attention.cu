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
// 4,096, H = 8, D = 64) against q, k, v and out read or written once (0.5
// GB there: 0.16 ms at 3.35 TB/s). Like the TPU kernel it keeps the (B, H,
// M, S) scores out of device memory (2.1 GB in f32 at that shape, and as
// much again for the probabilities).
//
// The first design did the products as f32 FMA, no tensor cores, at
// 24-32% of the 67 TFLOP/s FMA peak: 6.6223 ms at the MCAB against SDPA's
// 4.2045 (f32, CUTLASS's FMA kernel); every 64-key tile was staged
// synchronously by scalar loads into d-major shared memory, and the
// probabilities went through shared memory, transposed, behind a third
// __syncthreads a tile. This design:
// - Runs both products on the tensor cores with f32 accumulation. With f32
//   operands, three TF32 passes a product: x = hi + lo with hi =
//   cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a.b ~ lo_a.hi_b +
//   hi_a.lo_b + hi_a.hi_b (one pass misses the port's 2e-4 bound on the
//   output, three keep f32 accuracy): 3 x 137 GFLOP at the 495 TFLOP/s TF32
//   peak, 0.83 ms at the MCAB. With bf16 operands one bf16 pass, the
//   probabilities rounded to bf16 for the second product as the plain
//   version rounds them.
// - On mma.sync (m16n8k8 TF32, m16n8k16 bf16), not wgmma. Here the 3-pass
//   split happens in registers between the shared-memory load and the mma.
//   wgmma reads B (k, and v^T for the second product, both K-major for
//   .tf32) from shared memory, so each tile's hi and lo would have to be
//   written back there by the threads, in the descriptors' core-matrix
//   layout (v transposed, its keys permuted to the probabilities' fragment
//   order): a second pass over shared memory a tile, and layouts this code
//   has not yet brought up. mma.sync takes the fragments as they are: k and
//   v are read in their own (token, d) layout with no transpose, since the
//   probabilities' fragment order is free to permute the keys of a k-step
//   (key 2t <-> slot t, key 2t + 1 <-> slot t + 4).
// - One CTA per (cell, head, tile of 64 or 128 queries); the grid's
//   sequential key axis is a loop inside the CTA over tiles of 64 keys. A
//   group of 4 warps takes the queries, each warp one or two m16 tiles (two,
//   128 queries a CTA, for f32 with D <= 64 wherever the grid still fills two
//   CTAs an SM: each split k or v fragment then feeds both tiles). Where one
//   CTA per 64 queries would leave SMs idle (D <= 64), a second group of 4
//   warps takes every other key tile of the same queries, and the two
//   groups' (m, l, acc) are merged through shared memory at the end, in a
//   fixed order: self-attention at B = 2, H = 4, 1,024 tokens took 0.1072 ms
//   with one group and 0.0721 with two (SDPA 0.1059; chip run on an H100).
// - A ring of two k/v stages (a tile a key group) filled by cp.async
//   (16-byte granules where the bases, strides and width allow, else 8 or 4;
//   bf16 operands with 2-byte alignment take plain loads), the next stage in
//   flight while this one is computed: one __syncthreads a stage. Rows past S (and queries past M) are
//   zero-filled by the copies; the pad columns D..DP are zeroed once.
// - The probabilities stay in registers as the second product's A operand:
//   the scores' accumulator fragments are its A fragments.
// - Each tile's p v is summed on the tensor cores from zero and added to the
//   running output in f32 (add_tile). Summed into the running output on the
//   tensor cores, whose f32 sums lose low bits at every mma, the error grew
//   with the key axis: 3.9e-5 of the output's largest at S = 4,096 and
//   1.8e-4 at 16,384 against 2.4e-6 and 6.0e-6 this way, at the same speed
//   (chip runs on an H100).
// - The head width is zero-padded to a compiled width DP of 16, 32, 64 or
//   128 (the TPU kernel pads to 128 lanes); D > 128 is refused. Staged rows
//   are padded by 16 bytes (f32 DP + 4, bf16 DP + 8 elements), which puts
//   every fragment load on 32 distinct banks.
// - Keys past S score -inf: exp gives 0, and every tile holds at least one
//   real key, so m is finite after the first tile and no l is 0.
// - The operands are read through their strides (cell, token, head; the
//   head width contiguous): the fused qkv and kv projections' chunk views,
//   whose token stride is 3E or 2E, need no copy.
// - No atomics and no split of the key axis: the sums run in a fixed order,
//   the same bits every run (and whichever query tiling the grid takes).
// Shared memory: (BM + 4 * 64 * groups) rows of the padded width: 104,448
// bytes at f32, DP = 64, 128 queries (two CTAs an SM); 156,672 with two key
// groups; 168,960 at f32, DP = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kWarps = 4;    // warps a key group: 16 * RW queries each
constexpr int kBN = 64;      // keys per tile
constexpr int kStages = 2;   // the k / v ring
constexpr int kMaxHeadDim = 128;

struct Strides {
  long long b, s, h;  // cell, token and head strides in elements; d is contiguous
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `n` bytes (gran or 0: then zeros) of `src` into shared `dst`
__device__ __forceinline__ void copy_granule(void* dst, const void* src, int gran, bool in) {
  const uint32_t s = smem_u32(dst);
  const int n = in ? gran : 0;
  if (gran == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  } else if (gran == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  } else if (gran == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  } else {  // 2 bytes: bf16 whose strides or width are odd
    *reinterpret_cast<uint16_t*>(dst) = in ? *reinterpret_cast<const uint16_t*>(src) : 0;
  }
}

// rows 0..rows-1 of D elements each (row r at src + r * stride) into a tile
// of pitch LD; rows at or past `valid` are zero-filled
template <typename T, int LD, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride, int rows,
                                           int valid, int D, int gran) {
  const int per_row = D * (int)sizeof(T) / gran;
  if (NT % per_row == 0) {
    const int step = NT / per_row, c = (threadIdx.x % per_row) * gran;
    for (int r = threadIdx.x / per_row; r < rows; r += step) {
      const bool in = r < valid;
      copy_granule(reinterpret_cast<char*>(dst + r * LD) + c,
                   reinterpret_cast<const char*>(src + (in ? r * stride : 0)) + c, gran, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * per_row; i += NT) {
      const int r = i / per_row, c = (i - r * per_row) * gran;
      const bool in = r < valid;
      copy_granule(reinterpret_cast<char*>(dst + r * LD) + c,
                   reinterpret_cast<const char*>(src + (in ? r * stride : 0)) + c, gran, in);
    }
  }
}

// x = hi + lo, both TF32 (the low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a (16 x 8, row-major tf32) * b (8 x 8, column-major tf32), f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair_of(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

// The fragments below: lane = 4 gq + tq. s[r][j] holds the scores of query
// rows 16r + gq ([0], [1]) and 16r + gq + 8 ([2], [3]) of the warp's tile
// with keys 8j + 2tq ([0], [2]) and 8j + 2tq + 1 ([1], [3]); acc[r][n] the
// same rows' output columns 8n + 2tq and 8n + 2tq + 1.

// s = q_w k^T over the tile's 64 keys, f32 operands: three TF32 passes
template <int DP, int RW, int LD>
__device__ __forceinline__ void tile_scores(const float* qw, const float* kt,
                                            float (&s)[RW][kBN / 8][4], int gq, int tq) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ah[RW][4], al[RW][4];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float* a = qw + (16 * r + gq) * LD + 8 * kk + tq;
      split_tf32(a[0], ah[r][0], al[r][0]);
      split_tf32(a[8 * LD], ah[r][1], al[r][1]);
      split_tf32(a[4], ah[r][2], al[r][2]);
      split_tf32(a[8 * LD + 4], ah[r][3], al[r][3]);
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float* b = kt + (8 * j + gq) * LD + 8 * kk + tq;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b[0], bh0, bl0);
      split_tf32(b[4], bh1, bl1);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        mma_tf32(s[r][j], al[r], bh0, bh1);
        mma_tf32(s[r][j], ah[r], bl0, bl1);
        mma_tf32(s[r][j], ah[r], bh0, bh1);
      }
    }
  }
}

// the same with bf16 operands: one bf16 pass
template <int DP, int RW, int LD>
__device__ __forceinline__ void tile_scores(const __nv_bfloat16* qw, const __nv_bfloat16* kt,
                                            float (&s)[RW][kBN / 8][4], int gq, int tq) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[RW][4];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const __nv_bfloat16* ap = qw + (16 * r + gq) * LD + 16 * kk + 2 * tq;
      a[r][0] = load_pair(ap);
      a[r][1] = load_pair(ap + 8 * LD);
      a[r][2] = load_pair(ap + 8);
      a[r][3] = load_pair(ap + 8 * LD + 8);
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const __nv_bfloat16* b = kt + (8 * j + gq) * LD + 16 * kk + 2 * tq;
      const uint32_t b0 = load_pair(b), b1 = load_pair(b + 8);
#pragma unroll
      for (int r = 0; r < RW; ++r) mma_bf16(s[r][j], a[r], b0, b1);
    }
  }
}

// acc += t in f32: each tile's p v is summed on the tensor cores from zero
// and added here, so no tensor-core sum runs over more than one tile
template <int RW, int NT>
__device__ __forceinline__ void add_tile(float (&acc)[RW][NT][4], const float (&t)[RW][NT][4]) {
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][n][e] += t[r][n][e];
}

// acc += p v over the tile's 64 keys, f32: three TF32 passes. The k-step of
// keys 8jj.. takes score tile jj as its A fragment with key 8jj + 2tq in slot
// tq and key 8jj + 2tq + 1 in slot tq + 4; the B fragment reads the same
// keys' rows of v.
template <int DP, int RW, int LD>
__device__ __forceinline__ void tile_pv(const float (&p)[RW][kBN / 8][4], const float* vt,
                                        float (&acc)[RW][DP / 8][4], int gq, int tq) {
  float t[RW][DP / 8][4];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) t[r][n][0] = t[r][n][1] = t[r][n][2] = t[r][n][3] = 0.0f;
#pragma unroll
  for (int jj = 0; jj < kBN / 8; ++jj) {
    uint32_t ah[RW][4], al[RW][4];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      split_tf32(p[r][jj][0], ah[r][0], al[r][0]);
      split_tf32(p[r][jj][2], ah[r][1], al[r][1]);
      split_tf32(p[r][jj][1], ah[r][2], al[r][2]);
      split_tf32(p[r][jj][3], ah[r][3], al[r][3]);
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const float* b = vt + (8 * jj + 2 * tq) * LD + 8 * n + gq;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b[0], bh0, bl0);
      split_tf32(b[LD], bh1, bl1);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        mma_tf32(t[r][n], al[r], bh0, bh1);
        mma_tf32(t[r][n], ah[r], bl0, bl1);
        mma_tf32(t[r][n], ah[r], bh0, bh1);
      }
    }
  }
  add_tile(acc, t);
}

// the same with bf16 operands: p rounded to bf16, one pass; the k-step of
// keys 16kk.. takes score tiles 2kk and 2kk + 1
template <int DP, int RW, int LD>
__device__ __forceinline__ void tile_pv(const float (&p)[RW][kBN / 8][4],
                                        const __nv_bfloat16* vt, float (&acc)[RW][DP / 8][4],
                                        int gq, int tq) {
  float t[RW][DP / 8][4];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) t[r][n][0] = t[r][n][1] = t[r][n][2] = t[r][n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    uint32_t a[RW][4];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      a[r][0] = pack_bf16(p[r][2 * kk][0], p[r][2 * kk][1]);
      a[r][1] = pack_bf16(p[r][2 * kk][2], p[r][2 * kk][3]);
      a[r][2] = pack_bf16(p[r][2 * kk + 1][0], p[r][2 * kk + 1][1]);
      a[r][3] = pack_bf16(p[r][2 * kk + 1][2], p[r][2 * kk + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const __nv_bfloat16* b = vt + (16 * kk + 2 * tq) * LD + 8 * n + gq;
      const uint32_t b0 = pair_of(b, b + LD), b1 = pair_of(b + 8 * LD, b + 9 * LD);
#pragma unroll
      for (int r = 0; r < RW; ++r) mma_bf16(t[r][n], a[r], b0, b1);
    }
  }
  add_tile(acc, t);
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int DP>
__host__ __device__ constexpr int row_pitch() {
  return DP + 16 / (int)sizeof(T);  // 16 bytes of padding a row
}

template <typename T, int DP, int RW, int KS>
__host__ __device__ constexpr int smem_bytes() {
  return (16 * RW * kWarps + 2 * kStages * KS * kBN) * row_pitch<T, DP>() * (int)sizeof(T);
}

// KS key groups of kWarps warps share the CTA's queries: group g takes key
// tiles g, g + KS, ..., and the groups' (m, l, acc) are merged at the end,
// group 1 into group 0, in that order.
template <typename T, int DP, int RW, int KS>
__global__ void __launch_bounds__(32 * kWarps * KS, KS == 1 ? 2 : 1)
    flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, int M, int S, int H, int D,
                        Strides qs, Strides ks, Strides vs, int n_qtiles, float scale_log2,
                        int gran) {
  constexpr int NT = 32 * kWarps * KS;  // threads
  constexpr int BM = 16 * RW * kWarps;  // queries per CTA
  constexpr int LD = row_pitch<T, DP>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qt = reinterpret_cast<T*>(smem);  // [BM][LD]
  T* ring = qt + BM * LD;              // [kStages][KS][k, v][kBN][LD]

  const int bh = blockIdx.x / n_qtiles;
  const int m0 = (blockIdx.x % n_qtiles) * BM;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp / kWarps, wq = warp % kWarps;  // key group, query warp in it
  const int gq = lane >> 2, tq = lane & 3;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const int n_tiles = (S + kBN - 1) / kBN;
  const int n_steps = (n_tiles + KS - 1) / KS;  // KS tiles a step, one a group

  // the KS tiles of step t into its stage
  auto stage_step = [&](int t) {
    T* st = ring + (t % kStages) * KS * 2 * kBN * LD;
#pragma unroll
    for (int g = 0; g < KS; ++g) {
      const int n1 = (t * KS + g) * kBN;
      if (n1 >= S) break;
      stage_rows<T, LD, NT>(st + g * 2 * kBN * LD, kb + n1 * ks.s, ks.s, kBN, S - n1, D, gran);
      stage_rows<T, LD, NT>(st + (g * 2 + 1) * kBN * LD, vb + n1 * vs.s, vs.s, kBN, S - n1, D,
                            gran);
    }
  };

  // zero the whole of shared memory once: the pad columns stay zero
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < smem_bytes<T, DP, RW, KS>() / 16; i += NT)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  stage_rows<T, LD, NT>(qt, q + b * qs.b + h * qs.h + m0 * qs.s, qs.s, BM, M - m0, D, gran);
  stage_step(0);
  cp_async_commit();

  float m_i[RW][2], l_i[RW][2], acc[RW][DP / 8][4];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m_i[r][0] = m_i[r][1] = -INFINITY;
    l_i[r][0] = l_i[r][1] = 0.0f;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) acc[r][n][0] = acc[r][n][1] = acc[r][n][2] = acc[r][n][3] = 0.0f;
  }
  const T* qw = qt + wq * 16 * RW * LD;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait_all();
    __syncthreads();  // step t is in; every warp is done with step t - 1's stage
    if (t + 1 < n_steps) {
      stage_step(t + 1);
      cp_async_commit();
    }
    const int n_left = S - (t * KS + kg) * kBN;  // keys of the group's tile that exist
    if (n_left <= 0) continue;
    const T* kt = ring + ((t % kStages) * KS + kg) * 2 * kBN * LD;

    float s[RW][kBN / 8][4];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) s[r][j][0] = s[r][j][1] = s[r][j][2] = s[r][j][3] = 0.0f;
    tile_scores<DP, RW, LD>(qw, kt, s, gq, tq);

#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[r][j][e] *= scale_log2;
    if (n_left < kBN) {
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * tq + (e & 1) >= n_left) s[r][j][e] = -INFINITY;
    }

    // the online softmax, in base 2: each row's max over its quad, then rescale
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(s[r][j][2 * hh], s[r][j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[r][hh], mx);
        const float alpha = exp2f(m_i[r][hh] - m_new);
        m_i[r][hh] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          s[r][j][2 * hh] = exp2f(s[r][j][2 * hh] - m_new);
          s[r][j][2 * hh + 1] = exp2f(s[r][j][2 * hh + 1] - m_new);
          sum += s[r][j][2 * hh] + s[r][j][2 * hh + 1];
        }
        l_i[r][hh] = l_i[r][hh] * alpha + sum;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          acc[r][n][2 * hh] *= alpha;
          acc[r][n][2 * hh + 1] *= alpha;
        }
      }

    tile_pv<DP, RW, LD>(s, kt + kBN * LD, acc, gq, tq);
  }

  if constexpr (KS == 2) {
    // group 1 hands its lanes' (m, l, acc) to the same lanes of group 0
    // through the ring, which no copy writes any more
    constexpr int kPer = 4 * RW + 4 * RW * (DP / 8);  // floats a lane
    float* xs = reinterpret_cast<float*>(ring) + (wq * 32 + lane) * kPer;
    __syncthreads();
    if (kg == 1) {
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          xs[4 * r + 2 * hh] = m_i[r][hh];
          xs[4 * r + 2 * hh + 1] = l_i[r][hh];
#pragma unroll
          for (int n = 0; n < DP / 8; ++n) {
            xs[4 * RW + (r * (DP / 8) + n) * 4 + 2 * hh] = acc[r][n][2 * hh];
            xs[4 * RW + (r * (DP / 8) + n) * 4 + 2 * hh + 1] = acc[r][n][2 * hh + 1];
          }
        }
    }
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m1 = xs[4 * r + 2 * hh], l1 = xs[4 * r + 2 * hh + 1];
        const float mm = fmaxf(m_i[r][hh], m1);  // finite: group 0 took tile 0
        const float c0 = exp2f(m_i[r][hh] - mm), c1 = exp2f(m1 - mm);
        l_i[r][hh] = l_i[r][hh] * c0 + l1 * c1;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[r][n][2 * hh + e] = acc[r][n][2 * hh + e] * c0 +
                                    xs[4 * RW + (r * (DP / 8) + n) * 4 + 2 * hh + e] * c1;
      }
  }

  // each row's sum over its quad, then out = acc / l
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_i[r][hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = m0 + wq * 16 * RW + 16 * r + gq + 8 * hh;
      if (row >= M) continue;
      T* o = out + (((long long)b * M + row) * H + h) * D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * n + 2 * tq + e;
          if (d < D) store_as(o + d, acc[r][n][2 * hh + e] / l);
        }
    }
}

// The dynamic shared memory each instance is already allowed, per device:
// the attribute is set only the first time an instance launches there.
constexpr int kMaxDevices = 64;

template <typename T, int DP, int RW, int KS>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int M, int S,
                   int H, int D, Strides qs, Strides ks, Strides vs, int gran, int dev,
                   cudaStream_t stream) {
  static std::atomic<bool> allowed[kMaxDevices];
  constexpr int smem = smem_bytes<T, DP, RW, KS>();
  constexpr int BM = 16 * RW * kWarps;
  if (dev >= kMaxDevices || !allowed[dev].load()) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd<T, DP, RW, KS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev].store(true);
  }
  const int n_qtiles = (M + BM - 1) / BM;
  const long long blocks = (long long)B * H * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_attention_fwd<T, DP, RW, KS><<<(unsigned)blocks, 32 * kWarps * KS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, M, S, H, D, qs, ks, vs, n_qtiles,
      1.4426950408889634f / sqrtf((float)D), gran);
  return cudaGetLastError();
}

// The query tiling by the grid it gives (DP <= 64): 128 queries a CTA (two
// m16 tiles a warp, f32 only) wherever that still fills two CTAs on every
// SM; 64 queries a CTA with the key axis split between two groups of warps
// where one CTA per 64 queries would leave SMs idle; else 64 queries, one
// group. DP = 128 takes the last always.
template <typename T, int DP>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* out, int B, int M,
                        int S, int H, int D, Strides qs, Strides ks, Strides vs, int gran,
                        cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if constexpr (DP <= 64) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long tiles64 = (long long)B * H * ((M + 63) / 64);
    if constexpr (std::is_same<T, float>::value) {
      if ((long long)B * H * ((M + 127) / 128) >= 2LL * sms)
        return launch<T, DP, 2, 1>(q, k, v, out, B, M, S, H, D, qs, ks, vs, gran, dev, stream);
    }
    if (tiles64 < sms && S > kBN)
      return launch<T, DP, 1, 2>(q, k, v, out, B, M, S, H, D, qs, ks, vs, gran, dev, stream);
  }
  return launch<T, DP, 1, 1>(q, k, v, out, B, M, S, H, D, qs, ks, vs, gran, dev, stream);
}

template <typename T>
cudaError_t launch_width(const void* q, const void* k, const void* v, void* out, int B, int M,
                         int S, int H, int D, Strides qs, Strides ks, Strides vs,
                         cudaStream_t stream) {
  // the widest copy granule (16, 8 or 4 bytes; 2 for bf16) that every base,
  // stride and row width allows
  const long long elem = (long long)sizeof(T);
  unsigned long long bits = (unsigned long long)(uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                            (unsigned long long)(D * elem);
  for (const Strides& st : {qs, ks, vs})
    bits |= (unsigned long long)((st.b | st.s | st.h) * elem);
  int gran = 16;
  while (gran > elem && (bits & (unsigned long long)(gran - 1))) gran >>= 1;
  if (D <= 16) return launch_rows<T, 16>(q, k, v, out, B, M, S, H, D, qs, ks, vs, gran, stream);
  if (D <= 32) return launch_rows<T, 32>(q, k, v, out, B, M, S, H, D, qs, ks, vs, gran, stream);
  if (D <= 64) return launch_rows<T, 64>(q, k, v, out, B, M, S, H, D, qs, ks, vs, gran, stream);
  return launch_rows<T, 128>(q, k, v, out, B, M, S, H, D, qs, ks, vs, gran, stream);
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
