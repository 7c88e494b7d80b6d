// The VAE encoder's MCAB pooling over the packed (B, S, E) token window at
// wide embeddings (E a multiple of 64 from 256 to 1,024, head width 64, 1 to
// 1,024 inducing points, any S, up to 65,535 cells), forward and recompute backward, on
// Hopper's tensor cores. bf16 operands, f32 accumulation.
//
// Replaces the TPU kernels scldm_tpu/ops/fused_encoder.py::fused_window_pool
// (Pallas body `_wfwd_kernel`) and `_wfused_bwd` (`_wbwd_kernel`) at the
// widths where encoder_pool.cu's design (one CTA per cell, E = 32 and Q*H = 64
// in its thread maps) does not reach: the census encoder (E = 512, 8 cross
// heads, 64 inducing points) and the long-latent one (1,024). The math is that
// of `window_pool_reference` in scldm_torch/ops/fused_encoder.py; with bf() a
// round to bf16 and head h owning columns [h*64, (h+1)*64) of E:
//
//   x2     = LN(x) * ln1g + ln1b                       (eps given)
//   k, v   = bf(x2) @ bf(wk), bf(x2) @ bf(wv)
//   s[h,i] = scale * sum_d bf(k[h*64+d]) * bf(q[i, h*64+d])   (q: the head blocks of qfull)
//   m      = max over tokens of s;  e = exp(s - m)
//   den    = sum_t e;  num[i, h*64+d] = sum_t bf(e[h,i]) * bf(v[h*64+d])
//
// and the backward of that function given the forward's m: dv = bf(sum_i
// bf(e) dnum), de = bf(bf(v) . dnum) + dden, ds = e * de * scale, dk = bf(ds
// bf(q)), dq = sum_t ds bf(k), dx2 = bf(dk bf(wk)^T) + bf(dv bf(wv)^T), dwk =
// sum_t bf(x2) dk, dwv = sum_t bf(x2) dv, then the LayerNorm's backward.
//
// What bounds it on an H100: operations. At the census shape (B = 16 cells,
// S = 4,096 tokens, E = 512, Q = 64, H = 8) the forward is 77 GFLOP (the k/v
// projection 68.7 of it, the scores and the pooled values 4.3 each) against
// 134 MB of emb read; the backward about three times that. Every operand of
// those products is bf16-rounded already, so one bf16 tensor-core pass
// computes them, but for the four backward products that take an f32
// operand (dnum in dv and de, ds in dk and dq): those run as three bf16 passes
// (the operand split hi + mid + lo, about 24 bits), so the backward's
// attention runs 10 passes of the scores' size in its dk / dv kernel and 7
// in its dq kernel where the function has 5.
//
// What the design does about it:
//  1. prep kernels: W^T = bf([wk | wv])^T (2E, E) and, backward, bf(W) (E,
//     2E), bf16; the query head blocks as (H, Qp, 64) bf16 with Qp = Q rounded
//     up to 64 and zero rows (the attention tiles then need no query bounds);
//     backward, dnum's head blocks split hi, mid, lo (B, H, 3, Qp, 64) bf16
//     and m, dden padded (B, H, Qp).
//  2. ln_rows: bf(x2) (N, E) in bf16 for the N = B*S tokens, one warp per
//     token, the LayerNorm computed in f64 and x2 rounded once (f32 summation
//     orders alone put the same token's bf16 roundings apart often enough to
//     move row maxima), and, backward, each token's mean and 1/sqrt(var +
//     eps).
//  3. gemm_bf16<kProj>: KV = bf(x2) @ W (N, 2E), stored in bf16 (the function
//     rounds k and v before any use). One warp-specialised kernel for every
//     GEMM of the pool: a CTA of 128 x 128 outputs, warpgroup 0 a producer
//     whose one thread keeps TMA loads of 64-deep stages in flight through a
//     ring of four on mbarriers, warpgroups 1 and 2 consumers that each run
//     wgmma.m64n128k16.bf16 on 64 of the rows straight from the 128-byte
//     swizzled tiles TMA wrote, A and B both from shared memory; each stage
//     is summed from zero and added in f32. Persistent CTAs, one an SM, walk
//     the tiles, so the producer loads a tile while the consumers store the
//     last. TMA reads zeros past every ragged edge.
//  4. attn_fwd: flash attention over the tokens with the inducing points as
//     queries, mma.sync m16n8k16 bf16: a CTA of four warps per (cell, head,
//     64 queries, token split), each warp 16 queries; k and v tiles of 64
//     tokens in a cp.async double buffer, the scores, the online max (each
//     exponential rounded against the running max) with its token, and the
//     pooled values in registers, each tile's pooled values summed from zero
//     and added in f32. The split count comes from the grid size (about four
//     CTAs an SM), not from a fixed token count; with one split the CTA
//     writes (num, den, m), else a partial that attn_merge rescales to the
//     largest m and adds in split order, without atomics.
//  5. exact_max: the tensor cores' sums truncate, so k's bf16 roundings flip
//     against an f32 sum about ten times as often as the FMA kernels' did, and
//     a flip at a row's max token moves m, which the backward recomputes
//     every exponential against (by up to 1.3e-3 of m at the census shape).
//     So each row's max is taken again from its token's k, summed in f64 on
//     the CUDA cores in a fixed order, and (num, den) rescaled to it; m is
//     then the row max the backward recomputes from, and with 2 that of the
//     exact function (the plain version evaluated in f64) but where two
//     tokens all but tie. (f32 sums here and in 2 left m off the exact one
//     in enough rows at 1,024 queries to scale whole rows of gradients: 12-17%
//     of demb beyond 1e-4 of its largest against the f64 evaluation.)
// The backward runs 1-3 again (the forward saves nothing but m), then:
//  6. attn_dkdv: a CTA per (cell, head, 64 tokens) walks the query tiles
//     (double-buffered: q, dnum's three parts, m, dden), recomputes the
//     scores and exponentials given m, sums each tile's dk and dv from zero
//     and writes bf(dk) and bf(dv) of its tokens to DKV (N, 2E) in bf16;
//  7. attn_dq: a CTA per (cell, head, 64 queries, token split) walks the
//     split's tokens and writes its partial of dq, summed from zero a tile at
//     a time; sum_dq adds the partials in a fixed order into dqfull's blocks;
//  8. gemm_bf16<kDx2>: dx2 = bf(dk bf(wk)^T) + bf(dv bf(wv)^T), K-major both
//     ways, the two halves of K rounded apart and stored as bf16 halves
//     (N, 2E) where KV was;
//  9. ln_bwd: demb through the LayerNorm, one warp per token, and per CTA of
//     256 tokens a partial of (dln1g, dln1b), added in order by sum_parts;
// 10. gemm_bf16<kDw>: dW = bf(x2)^T DKV (E, 2E) over token slices chosen from
//     the grid size, both operands read MN-major (wgmma's transposed modes),
//     each 64-token stage summed from zero and added in f32; the slices'
//     partials added in order by sum_parts.
// No atomics anywhere: the sums do not depend on the run. The caller rounds
// the reduced gradients of qfull, wk and wv to bf16 after the whole sum.
// TMA needs 16-byte row pitches and box starts: every pitch here is a
// multiple of 64 bf16, and every region of the workspace starts on 1,024
// bytes.
// Tried and not kept (benchmarks_torch/ab_window_pool_wide.py, in turns on an
// H100 80GB HBM3 at 700 W): the projection accumulating across stages in
// the wgmma registers with one stage in flight (wait_group 1), 0.5342
// against 0.5389 ms forward, with about twice the gradients' rounding flips;
// each k step summed from zero in the attention backward, no fewer flips and
// 0.04 ms slower; a ring of six stages, 64-token LayerNorm-backward CTAs and
// twice the row-max CTAs, 0.5007 / 1.3059 against 0.4745 / 1.2712 ms.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"
#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHD = 64;              // head width
constexpr int kEMin = 256, kEMax = 1024;
constexpr int kQMax = 1024;          // inducing points
constexpr int kSMs = 132;            // the H100's: the split counts depend on the shapes alone
constexpr int kTargetCtas = 4 * kSMs;
constexpr int kMinSplit = 256;       // tokens a split at least
constexpr int kTT = 64;              // tokens or queries a tile of the attention kernels
constexpr int kNT = 128;             // threads of the attention kernels: a warp takes 16 rows
constexpr int kTile = kTT * kHD * 2; // bytes of a 64 x 64 bf16 tile
constexpr int kLnThreads = 256;      // the LayerNorm kernels: a warp a token
constexpr int kLnTokens = 256;       // LayerNorm backward: tokens a CTA

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma
// ---------------------------------------------------------------------------

// (hopper_wgmma.cuh)
using hopper::fence_regs;
using hopper::k_desc;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::mn_desc;
using hopper::named_sync;
using hopper::tma_load;
using hopper::wgmma_bf16;

// ---------------------------------------------------------------------------
// The GEMMs: one warp-specialised kernel, three modes
// ---------------------------------------------------------------------------

constexpr int kGThreads = 384;                // warpgroup 0 produces, 1 and 2 consume
constexpr int kGM = 128, kGN = 128, kGK = 64;  // a CTA's outputs; the depth of a stage
constexpr int kGStages = 4;
constexpr int kGHalf = 64 * kGK * 2;          // 8 KB: 64 rows (or 64 k) of 128 bytes
constexpr int kGStageBytes = 4 * kGHalf;      // A (128 x 64) and B (128 x 64)
constexpr int kGBarOff = kGStages * kGStageBytes;
constexpr int kGSmem = kGBarOff + 16 * kGStages + 1024;  // + the 1,024-byte alignment
static_assert(kGSmem <= 232448, "one CTA an SM");

// kProj: KV (N, 2E) = X2 (N, E) W^T^T, A = X2 and B = W^T (2E, E), both K-major.
// kDx2: DX2 (N, 2E) = [bf(DKV[:, :E] Wb[:, :E]^T) | bf(DKV[:, E:] Wb[:, E:]^T)],
//   A = DKV (N, 2E) and B = bf(W) (E, 2E), both K-major.
// kDw: the partial of slice z of dW (E, 2E) = X2^T DKV over its tokens, A =
//   X2 and B = DKV, both MN-major (the tokens are K).
enum GemmMode : int { kProj, kDx2, kDw };

struct GemmParams {
  long long rows;  // output rows: tokens (kProj, kDx2) or E (kDw)
  int cols;        // output columns of a half: 2E (kProj, kDw) or E (kDx2)
  int ctiles;      // kProj, kDx2: column tiles
  int ntiles;      // kProj, kDx2: tiles, row tile t / ctiles, column tile t % ctiles
  int nk;          // stages a tile (kProj, kDx2)
  int half;        // kDx2: the stage where the dv half of K begins
  long long kper;  // kDw: tokens a slice, a multiple of kGK
  long long ntok;  // kDw: the tokens
  int ldo;         // row pitch of out, elements
  void* out;       // kProj: KV (bf16); kDx2: DX2 (bf16); kDw: the partials (f32)
};

// kProj and kDx2: persistent CTAs, one an SM, walk tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... through one ring, so the producer loads the
// next tile's stages while the consumers store this one's. kDw: one tile a
// CTA, (column tile, row tile, token slice) from the grid.
template <int kMode>
__global__ void __launch_bounds__(kGThreads, 1)
    gemm_bf16(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
              const GemmParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sbase = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = sbase + kGBarOff, empty0 = full0 + 8 * kGStages;
  const int wg = threadIdx.x >> 7;
  const int first = kMode == kDw ? 0 : blockIdx.x, step = kMode == kDw ? 1 : gridDim.x;
  const int ntiles = kMode == kDw ? 1 : p.ntiles;
  long long k0 = 0;
  int nk = p.nk;
  if (kMode == kDw) {
    k0 = (long long)blockIdx.z * p.kper;
    const long long len = min(p.ntok, k0 + p.kper) - k0;
    nk = len > 0 ? (int)((len + kGK - 1) / kGK) : 0;
  }
  // the first output row and column of a tile
  auto origin = [&](int tile, long long& m0, int& n0) {
    if (kMode == kDw) {
      m0 = (long long)blockIdx.y * kGM;
      n0 = blockIdx.x * kGN;
    } else {
      m0 = (long long)(tile / p.ctiles) * kGM;
      n0 = (tile % p.ctiles) * kGN;
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every stage's loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = first; tile < ntiles; tile += step) {
      long long m0;
      int n0;
      origin(tile, m0, n0);
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t bar = full0 + 8 * s, st = sbase + s * kGStageBytes;
        mbar_expect_tx(bar, kGStageBytes);
        if (kMode == kDw) {
          const int k = (int)(k0 + (long long)kt * kGK);
          tma_load(st, &ma, (int)m0, k, bar);
          tma_load(st + kGHalf, &ma, (int)m0 + 64, k, bar);
          tma_load(st + 2 * kGHalf, &mb, n0, k, bar);
          tma_load(st + 3 * kGHalf, &mb, n0 + 64, k, bar);
        } else {
          tma_load(st, &ma, kt * kGK, (int)m0, bar);
          tma_load(st + 2 * kGHalf, &mb, kt * kGK, n0, bar);
        }
        if (++s == kGStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g takes rows [64 g, 64 g + 64) of each tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = wg - 1, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  int s = 0;
  uint32_t ph = 0;
  for (int tile = first; tile < ntiles; tile += step) {
    long long m0;
    int n0;
    origin(tile, m0, n0);
    // thread (warp, gq, tq) holds rows r0 (acc[4i], acc[4i + 1]) and r0 + 8
    // (acc[4i + 2], acc[4i + 3]), columns n0 + 8i + 2tq + {0, 1}
    const long long r0 = m0 + g * 64 + warp * 16 + gq;
    // out as bf16 pairs, kDx2's dv half `off` columns on
    auto store_bf16 = [&](const float (&v)[64], int off) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = n0 + 8 * i + 2 * tq;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long r = r0 + 8 * hr;
          if (r < p.rows && c < p.cols)
            *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + r * p.ldo + off + c) =
                tc::pack_bf16(v[4 * i + 2 * hr], v[4 * i + 2 * hr + 1]);
        }
      }
    };
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full0 + 8 * s, ph);
      const uint32_t a0 = sbase + s * kGStageBytes + g * kGHalf;
      const uint32_t b0 = sbase + s * kGStageBytes + 2 * kGHalf;
      // the stage summed from zero, then added in f32: no tensor-core sum runs
      // over more than 64 products (16-deep k steps: 32 bytes apart K-major,
      // 2,048 MN-major)
      fence_regs(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (kMode == kDw)
          wgmma_bf16<1, 1>(part, mn_desc(a0 + kk * 2048), mn_desc(b0 + kk * 2048), kk > 0);
        else
          wgmma_bf16<0, 0>(part, k_desc(a0 + kk * 32), k_desc(b0 + kk * 32), kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(part);
      named_sync(1 + g, 128);  // the warpgroup's wgmma have read stage s
      if (t == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      if constexpr (kMode == kDx2) {
        if (kt == p.half - 1) {  // the dk half: bf(dk bf(wk)^T), then the dv half from zero
          store_bf16(acc, 0);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
        }
      }
      if (++s == kGStages) {
        s = 0;
        ph ^= 1;
      }
    }

    if constexpr (kMode == kDw) {
      float* o = static_cast<float*>(p.out) + (long long)blockIdx.z * p.rows * p.ldo;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int c = n0 + 8 * i + 2 * tq;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long r = r0 + 8 * hr;
          if (r < p.rows && c < p.cols)
            *reinterpret_cast<float2*>(o + r * p.ldo + c) =
                make_float2(acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
        }
      }
    } else {
      store_bf16(acc, kMode == kDx2 ? p.cols : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// The attention kernels: mma.sync m16n8k16 bf16 on 64 x 64 tiles
// ---------------------------------------------------------------------------

// byte offset of 16-byte chunk c of row r of a 64 x 64 bf16 tile: rows of 128
// bytes, the chunks XOR-swizzled by the row (ldmatrix without bank conflicts)
__device__ __forceinline__ uint32_t sw(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// rows [0, 64) of a bf16 matrix at `src` (row pitch ld), 64 columns, into the
// tile at `dst`; rows from `nrows` on are zeros (src not read)
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long ld, int nrows) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = threadIdx.x + j * kNT, r = idx >> 3, c = idx & 7;
    const bool in = r < nrows;
    cp16(dst + sw(r, c), in ? src + r * ld + c * 8 : src, in);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A fragment (16 x 16) of rows [r0, r0 + 16), k step kk, of a tile stored [m][k]
__device__ __forceinline__ void frag_a(uint32_t tile, int r0, int kk, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm4(tile + sw(r0 + (lane & 15), 2 * kk + (lane >> 4)), a);
}

// B fragments of n tiles 2j and 2j + 1 (b[0], b[1] and b[2], b[3]), k step kk,
// of a tile stored [n][k]
__device__ __forceinline__ void frag_b_nk(uint32_t tile, int j, int kk, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm4(tile + sw(16 * j + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)), b);
}

// the same of a tile stored [k][n]
__device__ __forceinline__ void frag_b_kn(uint32_t tile, int j, int kk, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31;
  ldsm4t(tile + sw(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * j + (lane >> 4)), b);
}

// acc (16 x 64: eight n8 tiles) += a (16 x 16, k step kk) * the tile's k step
// kk, the tile stored [n][k] (kNK) or [k][n]
template <bool kNK>
__device__ __forceinline__ void mma_row(float (&acc)[8][4], const uint32_t (&a)[4], uint32_t tile,
                                        int kk) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b[4];
    if (kNK)
      frag_b_nk(tile, j, kk, b);
    else
      frag_b_kn(tile, j, kk, b);
    tc::mma_bf16(acc[2 * j], a, b[0], b[1]);
    tc::mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
  }
}

// the A fragment of k step kk from C tiles 2kk and 2kk + 1 (the same rows)
__device__ __forceinline__ void c_to_a(const float (&c)[8][4], int kk, uint32_t (&a)[4]) {
  a[0] = tc::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = tc::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = tc::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = tc::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// the same, f32 split into three bf16 parts (hi, mid, lo)
__device__ __forceinline__ void c_to_a3(const float (&c)[8][4], int kk, uint32_t (&a)[3][4]) {
  tc::split3_bf16(c[2 * kk][0], c[2 * kk][1], a[0][0], a[1][0], a[2][0]);
  tc::split3_bf16(c[2 * kk][2], c[2 * kk][3], a[0][1], a[1][1], a[2][1]);
  tc::split3_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1], a[0][2], a[1][2], a[2][2]);
  tc::split3_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3], a[0][3], a[1][3], a[2][3]);
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[n][q] = 0.0f;
}

__device__ __forceinline__ void add(float (&acc)[8][4], const float (&c)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] += c[n][q];
}

// the largest of the quad's (v, token) pairs, the first token where two tie
__device__ __forceinline__ void quad_argmax(float& v, int& tok) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int ot = __shfl_xor_sync(0xffffffffu, tok, o);
    if (ov > v || (ov == v && ot < tok)) {
      v = ov;
      tok = ot;
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The forward's attention over one split of one (cell, head, 64 queries):
// grid (nsplit, H * qtiles, B). Warp w takes queries 16w .. 16w + 15 of the
// tile: rows gq (C values 0, 1) and gq + 8 (2, 3), columns 8n + 2tq + {0, 1}.
// One split: num (B, Q, E), den and m (B, Q*H); else the split's partial,
// pnum (nsplit, B, H, Qp, 64) and pstat (m, den) (nsplit, B, H, Qp, 2).
__global__ void __launch_bounds__(kNT)
    attn_fwd(const bf16* __restrict__ KV, const bf16* __restrict__ Qb, float* __restrict__ num,
             float* __restrict__ den, float* __restrict__ mout, int* __restrict__ amax,
             float* __restrict__ pnum, float* __restrict__ pstat, int* __restrict__ parg, int B,
             int S, int E, int H, int Q, int Qp, int per_split, float scale) {
  __shared__ __align__(1024) uint8_t sm[5 * kTile];  // q, k (2), v (2)
  const uint32_t sq = tc::smem_u32(sm), sk0 = sq + kTile, sv0 = sq + 3 * kTile;
  const int qtiles = Qp / kTT;
  const int z = blockIdx.x, h = blockIdx.y / qtiles, qt = blockIdx.y % qtiles, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ts = z * per_split, te = min(S, ts + per_split);
  const int nt = (te - ts + kTT - 1) / kTT;
  const long long E2 = 2LL * E;
  const bf16* kbase = KV + ((long long)b * S + ts) * E2 + h * kHD;
  load_tile(sq, Qb + ((long long)h * Qp + qt * kTT) * kHD, kHD, kTT);
  load_tile(sk0, kbase, E2, min(kTT, te - ts));
  load_tile(sv0, kbase + E, E2, min(kTT, te - ts));
  tc::cp_async_commit();
  uint32_t qa[4][4];
  float o[8][4], mrow[2] = {-INFINITY, -INFINITY}, drow[2] = {0.0f, 0.0f};
  int marg[2] = {0, 0};  // the token of the running max, the first where two tie
  zero(o);
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) {
      const uint32_t buf = ((j + 1) & 1) * kTile;
      const bf16* kj = kbase + (long long)(j + 1) * kTT * E2;
      const int rows = min(kTT, te - ts - (j + 1) * kTT);
      load_tile(sk0 + buf, kj, E2, rows);
      load_tile(sv0 + buf, kj + E, E2, rows);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_a(sq, warp * 16, kk, qa[kk]);
    }
    const uint32_t sk = sk0 + (j & 1) * kTile, sv = sv0 + (j & 1) * kTile;
    float s[8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_row<true>(s, qa[kk], sk, kk);
    const int t0 = ts + j * kTT;
    float tmax[2] = {-INFINITY, -INFINITY};
    int targ[2] = {0, 0};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int tok = t0 + 8 * n + 2 * tq + (c & 1);
        const float v = tok < te ? s[n][c] * scale : -INFINITY;
        s[n][c] = v;
        if (v > tmax[c >> 1]) {
          tmax[c >> 1] = v;
          targ[c >> 1] = tok;
        }
      }
    float alpha[2], dsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      quad_argmax(tmax[r], targ[r]);
      const float mnew = fmaxf(mrow[r], tmax[r]);
      if (tmax[r] > mrow[r]) marg[r] = targ[r];
      alpha[r] = expf(mrow[r] - mnew);  // 0 on the first tile, where mrow = -inf
      mrow[r] = mnew;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[n][c] - mrow[c >> 1]);
        dsum[c >> 1] += e;
        s[n][c] = e;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) drow[r] = drow[r] * alpha[r] + dsum[r];
    // this tile's pooled values, summed from zero, then added to the rescaled sum
    float ot[8][4];
    zero(ot);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      c_to_a(s, kk, pa);
      mma_row<false>(ot, pa, sv, kk);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = o[n][c] * alpha[c >> 1] + ot[n][c];
    __syncthreads();  // the tile's buffers are read before the next load refills them
  }
  const bool whole = gridDim.x == 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float dn = quad_sum(drow[r]);
    const int i = qt * kTT + warp * 16 + gq + 8 * r;
    if (whole) {
      if (i >= Q) continue;
      float* dst = num + ((long long)b * Q + i) * E + h * kHD + 2 * tq;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (tq == 0) {
        const long long at = (long long)b * H * Q + h * Q + i;
        den[at] = dn;
        mout[at] = mrow[r];
        amax[((long long)b * H + h) * Qp + i] = marg[r];
      }
    } else {
      const long long row = (((long long)z * B + b) * H + h) * Qp + i;
      float* dst = pnum + row * kHD + 2 * tq;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (tq == 0) {
        *reinterpret_cast<float2*>(pstat + 2 * row) = make_float2(mrow[r], dn);
        parg[row] = marg[r];
      }
    }
  }
}

// The splits' partials rescaled to the largest m and added in split order:
// num (B, Q, E), den and m (B, Q*H), row h*Q + i; one thread an entry of num.
__global__ void attn_merge(const float* __restrict__ pnum, const float* __restrict__ pstat,
                           const int* __restrict__ parg, float* __restrict__ num,
                           float* __restrict__ den, float* __restrict__ mout,
                           int* __restrict__ amax, int B, int H, int Q, int Qp, int E,
                           int nsplit) {
  const long long n = (long long)B * Q * E, zs = (long long)B * H * Qp;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const int e = (int)(idx % E), h = e >> 6, d = e & 63;
    const long long bi = idx / E;
    const int i = (int)(bi % Q), b = (int)(bi / Q);
    const long long row0 = ((long long)b * H + h) * Qp + i;
    float M = -INFINITY;
    int arg = 0;
    for (int z = 0; z < nsplit; ++z) {
      const float mz = pstat[2 * (row0 + z * zs)];
      if (mz > M) {
        M = mz;
        arg = parg[row0 + z * zs];
      }
    }
    float nm = 0.0f, dn = 0.0f;
    for (int z = 0; z < nsplit; ++z) {
      const long long row = row0 + z * zs;
      const float mz = pstat[2 * row];
      const float w = mz == -INFINITY ? 0.0f : expf(mz - M);  // an empty split adds 0
      nm = fmaf(w, pnum[row * kHD + d], nm);
      dn = fmaf(w, pstat[2 * row + 1], dn);
    }
    num[idx] = nm;
    if (d == 0) {
      const long long at = (long long)b * H * Q + h * Q + i;
      den[at] = dn;
      mout[at] = M;
      amax[row0] = arg;
    }
  }
}

// The row max again from its token, that token's k head block summed in f64
// on the CUDA cores in a fixed order and rounded, and (num, den) rescaled to
// it: the tensor cores' truncating sums flip k's bf16 roundings about ten
// times as often as f32 sums, and a flip at the max token moves m, which the
// backward recomputes every exponential against. Grid (H, blocks), 256
// threads: the head's block of W^T (64 rows of E, padded by a bf16 pair so
// that the 32 lanes of a warp read 32 banks) in shared memory; four groups of
// 64 threads (thread d: k_d) take a row (cell, query) each, its token's row
// of bf(x2) staged in shared memory.
__global__ void __launch_bounds__(256)
    exact_max(const bf16* __restrict__ X2, const bf16* __restrict__ Wt,
              const bf16* __restrict__ Qb, const int* __restrict__ amax, float* __restrict__ num,
              float* __restrict__ den, float* __restrict__ mout, int B, int S, int E, int H, int Q,
              int Qp, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const int ld = E + 2;
  bf16* Wh = reinterpret_cast<bf16*>(smem_raw);        // [64][E + 2]
  bf16* xs = Wh + kHD * ld;                            // [4][E], 16-byte aligned
  float* red = reinterpret_cast<float*>(xs + 4 * E);  // [4][64], then 4 factors
  const int h = blockIdx.x, grp = threadIdx.x >> 6, d = threadIdx.x & 63;
  for (int idx = threadIdx.x; idx < kHD * E / 2; idx += blockDim.x) {
    const int dd = idx / (E / 2), e = 2 * (idx % (E / 2));
    *reinterpret_cast<uint32_t*>(Wh + dd * ld + e) =
        *reinterpret_cast<const uint32_t*>(Wt + (long long)(h * kHD + dd) * E + e);
  }
  const long long rows = (long long)B * Q;
  const __nv_bfloat162* w = reinterpret_cast<const __nv_bfloat162*>(Wh + d * ld);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(xs + grp * E);
  for (long long base = (long long)blockIdx.y * 4; base < rows; base += (long long)gridDim.y * 4) {
    const long long r = base + grp;
    const bool active = r < rows;
    const int b = active ? (int)(r / Q) : 0, i = active ? (int)(r % Q) : 0;
    if (active) {
      const int t = amax[((long long)b * H + h) * Qp + i];
      const uint4* src = reinterpret_cast<const uint4*>(X2 + ((long long)b * S + t) * E);
      for (int v = d; v < E / 8; v += kHD) reinterpret_cast<uint4*>(xs + grp * E)[v] = src[v];
    }
    __syncthreads();  // W^T's block (the first time) and the rows are staged
    if (active) {
      // each bf16 x bf16 product is exact in f32; their sum is taken in f64,
      // four chains in a fixed order, and rounded through f32 to bf16, as
      // PyTorch rounds the exact k
      double k4[4] = {0.0, 0.0, 0.0, 0.0};
      for (int e = 0; e < E / 2; e += 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 xv = __bfloat1622float2(x[e + c]), wv = __bfloat1622float2(w[e + c]);
          k4[c] += (double)(xv.x * wv.x) + (double)(xv.y * wv.y);
        }
      }
      const double k = (k4[0] + k4[1]) + (k4[2] + k4[3]);
      red[grp * kHD + d] =
          bf(__double2float_rn(k)) * __bfloat162float(Qb[((long long)h * Qp + i) * kHD + d]);
    }
    __syncthreads();
    if (active && d == 0) {
      double sum = 0.0;  // of products exact in f32
      for (int dd = 0; dd < kHD; ++dd) sum += red[grp * kHD + dd];
      const long long at = (long long)b * H * Q + h * Q + i;
      const float mnew = __double2float_rn(sum * scale), fac = expf(mout[at] - mnew);
      mout[at] = mnew;
      den[at] *= fac;
      red[4 * kHD + grp] = fac;
    }
    __syncthreads();
    if (active) num[((long long)b * Q + i) * E + h * kHD + d] *= red[4 * kHD + grp];
    __syncthreads();  // xs and red are read before the next rows write them
  }
}

// The dk / dv kernel's shared memory: k and v of its tokens, then two
// buffers of a query tile's q, dnum's three parts and (m, dden).
constexpr int kBufBytes = 4 * kTile + 1024;
constexpr int kDkdvSmem = 2 * kTile + 2 * kBufBytes + 1024;  // + the 1,024-byte alignment
// The dq kernel's: q and dnum's three parts, then k and v (two buffers each).
constexpr int kDqSmem = 4 * kTile + 4 * kTile + 1024;

// The backward's dk and dv of 64 tokens of one (cell, head), given m, dnum
// and dden, over every query tile: grid (S tiles, H, B). Warp w takes tokens
// 16w .. 16w + 15 of the tile (its rows), the queries are the columns.
// Writes bf(dk) and bf(dv) into DKV (N, 2E).
__global__ void __launch_bounds__(kNT)
    attn_dkdv(const bf16* __restrict__ KV, const bf16* __restrict__ Qb,
              const bf16* __restrict__ DNs, const float* __restrict__ Mp,
              const float* __restrict__ DDp, bf16* __restrict__ DKV, int S, int E, int H, int Qp,
              float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const uint32_t sk = base, sv = base + kTile, buf0 = base + 2 * kTile;
  const int t0 = blockIdx.x * kTT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int tn = min(kTT, S - t0), qtiles = Qp / kTT;
  const long long E2 = 2LL * E, bh = (long long)b * H + h;
  const bf16* kbase = KV + ((long long)b * S + t0) * E2 + h * kHD;
  load_tile(sk, kbase, E2, tn);
  load_tile(sv, kbase + E, E2, tn);
  auto load_q = [&](int qt, uint32_t buf) {
    load_tile(buf, Qb + ((long long)h * Qp + qt * kTT) * kHD, kHD, kTT);
    const bf16* dn = DNs + (bh * 3 * Qp + qt * kTT) * kHD;
#pragma unroll
    for (int p = 0; p < 3; ++p) load_tile(buf + (1 + p) * kTile, dn + (long long)p * Qp * kHD, kHD, kTT);
    if (threadIdx.x < 32) {  // m, then dden: 16 chunks of 16 bytes each
      const float* src = (threadIdx.x < 16 ? Mp : DDp) + bh * Qp + qt * kTT + (threadIdx.x & 15) * 4;
      cp16(buf + 4 * kTile + threadIdx.x * 16, src, true);
    }
  };
  load_q(0, buf0);
  tc::cp_async_commit();
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int qt = 0; qt < qtiles; ++qt) {
    if (qt + 1 < qtiles) {
      load_q(qt + 1, buf0 + ((qt + 1) & 1) * kBufBytes);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t sq = buf0 + (qt & 1) * kBufBytes, sdn = sq + kTile;
    const float* ms = reinterpret_cast<const float*>(smem_raw + (sq + 4 * kTile - raw));
    const float* dds = ms + kTT;
    // s^T (tokens x queries) = k q^T, then e = exp(s - m) (0 past the tokens)
    float s[8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      frag_a(sk, warp * 16, kk, a);
      mma_row<true>(s, a, sq, kk);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 8 * n + 2 * tq + (c & 1);
        s[n][c] = warp * 16 + gq + 8 * (c >> 1) < tn ? expf(s[n][c] * scale - ms[i]) : 0.0f;
      }
    // dv += bf(e) dnum (the queries are K), dnum in three passes; this query
    // tile's products summed from zero in `tmp`, then added in f32 (as dk's)
    float tmp[8][4];
    zero(tmp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      c_to_a(s, kk, pa);
#pragma unroll
      for (int p = 0; p < 3; ++p) mma_row<false>(tmp, pa, sdn + p * kTile, kk);
    }
    add(dv, tmp);
    // de^T = bf(v) dnum^T (d is K) into tmp, three passes; ds = e (bf(de) + dden) scale
    zero(tmp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      frag_a(sv, warp * 16, kk, a);
#pragma unroll
      for (int p = 0; p < 3; ++p) mma_row<true>(tmp, a, sdn + p * kTile, kk);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 8 * n + 2 * tq + (c & 1);
        s[n][c] = s[n][c] * (bf(tmp[n][c]) + dds[i]) * scale;
      }
    // dk += ds bf(q) (the queries are K), ds in three passes
    zero(tmp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a3[3][4];
      c_to_a3(s, kk, a3);
#pragma unroll
      for (int p = 0; p < 3; ++p) mma_row<false>(tmp, a3[p], sq, kk);
    }
    add(dk, tmp);
    __syncthreads();  // the buffer is read before the next load refills it
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = warp * 16 + gq + 8 * r;
    if (t >= tn) continue;
    bf16* row = DKV + ((long long)b * S + t0 + t) * E2 + h * kHD + 2 * tq;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(row + 8 * n) = tc::pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(row + E + 8 * n) =
          tc::pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// The backward's dq of 64 queries of one (cell, head) over one token split:
// grid (nsplit, H * qtiles, B). Warp w takes queries 16w .. 16w + 15 (its
// rows), the tokens are the columns. Writes the partial
// part_q[((b * nsplit + z) * H + h) * Qp + i][d].
__global__ void __launch_bounds__(kNT)
    attn_dq(const bf16* __restrict__ KV, const bf16* __restrict__ Qb,
            const bf16* __restrict__ DNs, const float* __restrict__ Mp,
            const float* __restrict__ DDp, float* __restrict__ part_q, int S, int E, int H,
            int Qp, int per_split, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (tc::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sdn = base + kTile, sk0 = base + 4 * kTile, sv0 = sk0 + 2 * kTile;
  const int qtiles = Qp / kTT;
  const int z = blockIdx.x, h = blockIdx.y / qtiles, qt = blockIdx.y % qtiles, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ts = z * per_split, te = min(S, ts + per_split);
  const int nt = (te - ts + kTT - 1) / kTT;
  const long long E2 = 2LL * E, bh = (long long)b * H + h;
  const bf16* kbase = KV + ((long long)b * S + ts) * E2 + h * kHD;
  load_tile(sq, Qb + ((long long)h * Qp + qt * kTT) * kHD, kHD, kTT);
  const bf16* dn = DNs + (bh * 3 * Qp + qt * kTT) * kHD;
#pragma unroll
  for (int p = 0; p < 3; ++p) load_tile(sdn + p * kTile, dn + (long long)p * Qp * kHD, kHD, kTT);
  load_tile(sk0, kbase, E2, min(kTT, te - ts));
  load_tile(sv0, kbase + E, E2, min(kTT, te - ts));
  tc::cp_async_commit();
  float mrow[2], ddrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = bh * Qp + qt * kTT + warp * 16 + gq + 8 * r;
    mrow[r] = Mp[at];
    ddrow[r] = DDp[at];
  }
  uint32_t qa[4][4];
  float dq[8][4];
  zero(dq);
  for (int j = 0; j < nt; ++j) {
    if (j + 1 < nt) {
      const uint32_t buf = ((j + 1) & 1) * kTile;
      const bf16* kj = kbase + (long long)(j + 1) * kTT * E2;
      const int rows = min(kTT, te - ts - (j + 1) * kTT);
      load_tile(sk0 + buf, kj, E2, rows);
      load_tile(sv0 + buf, kj + E, E2, rows);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_a(sq, warp * 16, kk, qa[kk]);
    }
    const uint32_t sk = sk0 + (j & 1) * kTile, sv = sv0 + (j & 1) * kTile;
    const int t0 = ts + j * kTT;
    // s = q k^T, e = exp(s - m) (0 past the split)
    float s[8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_row<true>(s, qa[kk], sk, kk);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[n][c] = t0 + 8 * n + 2 * tq + (c & 1) < te ? expf(s[n][c] * scale - mrow[c >> 1]) : 0.0f;
    // de = dnum bf(v)^T (d is K), dnum in three passes; ds = e (bf(de) + dden) scale
    float de[8][4];
    zero(de);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint32_t a[4];
        frag_a(sdn + p * kTile, warp * 16, kk, a);
        mma_row<true>(de, a, sv, kk);
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = s[n][c] * (bf(de[n][c]) + ddrow[c >> 1]) * scale;
    // dq += ds bf(k) (the tokens are K), ds in three passes, the tile summed
    // from zero, then added in f32
    float dqt[8][4];
    zero(dqt);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a3[3][4];
      c_to_a3(s, kk, a3);
#pragma unroll
      for (int p = 0; p < 3; ++p) mma_row<false>(dqt, a3[p], sk, kk);
    }
    add(dq, dqt);
    __syncthreads();  // the tile's buffers are read before the next load refills them
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = qt * kTT + warp * 16 + gq + 8 * r;
    float* dst = part_q + (((long long)b * gridDim.x + z) * H + h) * Qp * kHD + (long long)i * kHD + 2 * tq;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// dqfull's head blocks: dqfull[h*Q + i, h*64 + d] = the sum over the nparts
// partials, in order.
__global__ void sum_dq(const float* __restrict__ part_q, int nparts, int H, int Q, int Qp, int E,
                       float* __restrict__ dqfull) {
  const int n = H * Q * kHD;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += gridDim.x * blockDim.x) {
    const int h = idx / (Q * kHD), r = idx % (Q * kHD), i = r >> 6, d = r & 63;
    float v = 0.0f;
    for (int p = 0; p < nparts; ++p) v += part_q[(((long long)p * H + h) * Qp + i) * kHD + d];
    dqfull[(long long)(h * Q + i) * E + h * kHD + d] = v;
  }
}

// dst[i] = the sum over p of part[p * n + i] in a fixed order: a CTA of 32 x
// 8 threads takes 32 entries, thread (x, y) adds parts y, y + 8, ... in
// order, then the eight sums are added in order.
__global__ void __launch_bounds__(256) sum_parts_kernel(const float* __restrict__ part, int nparts,
                                                        long long n, float* __restrict__ dst) {
  __shared__ float red[8][33];
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  float v = 0.0f;
  if (i < n)
    for (int p = threadIdx.y; p < nparts; p += 8) v += part[p * n + i];
  red[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float sum = 0.0f;
#pragma unroll
    for (int y = 0; y < 8; ++y) sum += red[y][threadIdx.x];
    dst[i] = sum;
  }
}

// ---------------------------------------------------------------------------
// prep and LayerNorm kernels
// ---------------------------------------------------------------------------

// W = [wk | wv] (E, 2E) (in, out): Wt (2E, E) = bf(W)^T and, where Wb is
// given, Wb (E, 2E) = bf(W); grid (2E / 32, E / 32) of 32 x 8 threads.
__global__ void prep_weights(const float* __restrict__ wk, const float* __restrict__ wv,
                             bf16* __restrict__ Wt, bf16* __restrict__ Wb, int E) {
  __shared__ float tile[32][33];
  const int o0 = blockIdx.x * 32, i0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const long long i = i0 + r;
    const int o = o0 + threadIdx.x;
    const float v = bf(o < E ? wk[i * E + o] : wv[i * E + o - E]);
    tile[r][threadIdx.x] = v;
    if (Wb != nullptr) Wb[i * 2 * E + o] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8)
    Wt[(long long)(o0 + r) * E + i0 + threadIdx.x] = __float2bfloat16_rn(tile[threadIdx.x][r]);
}

// Qb (H, Qp, 64): query i's head-h block of qfull, rounded, zero rows from Q on.
__global__ void prep_q(const float* __restrict__ qfull, bf16* __restrict__ Qb, int H, int Q,
                       int Qp, int E) {
  const int n = H * Qp * kHD;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += gridDim.x * blockDim.x) {
    const int h = idx / (Qp * kHD), r = idx % (Qp * kHD), i = r >> 6, d = r & 63;
    Qb[idx] = __float2bfloat16_rn(i < Q ? qfull[(long long)(h * Q + i) * E + h * kHD + d] : 0.0f);
  }
}

// The backward's cotangents per (cell, head): dnum's head blocks split into
// three bf16 parts, DNs (B, H, 3, Qp, 64), and m, dden as Mp, DDp (B, H, Qp);
// zeros from Q on.
__global__ void prep_cotangents(const float* __restrict__ m, const float* __restrict__ dnum,
                                const float* __restrict__ dden, bf16* __restrict__ DNs,
                                float* __restrict__ Mp, float* __restrict__ DDp, int B, int H,
                                int Q, int Qp, int E) {
  const long long n = (long long)B * H * Qp * kHD;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long bh = idx / (Qp * kHD);
    const int r = (int)(idx % (Qp * kHD)), i = r >> 6, d = r & 63;
    const int b = (int)(bh / H), h = (int)(bh % H);
    const bool in = i < Q;
    const float x = in ? dnum[((long long)b * Q + i) * E + h * kHD + d] : 0.0f;
    const float hi = bf(x), mid = bf(x - hi);
    bf16* dst = DNs + bh * 3 * Qp * kHD + r;
    dst[0] = __float2bfloat16_rn(hi);
    dst[(long long)Qp * kHD] = __float2bfloat16_rn(mid);
    dst[2LL * Qp * kHD] = __float2bfloat16_rn(x - hi - mid);
    if (d == 0) {
      const long long at = (long long)b * H * Q + h * Q + i;
      Mp[bh * Qp + i] = in ? m[at] : 0.0f;
      DDp[bh * Qp + i] = in ? dden[at] : 0.0f;
    }
  }
}

// bf(x2) (N, E) in bf16 with x2 = LN(emb) * g + b and, where mean_out is
// given, each token's mean and rstd; one warp a token, a lane float2 values
// at columns 64j + 2 lane, j < E / 64 <= kLnV.
template <int kLnV>
__global__ void __launch_bounds__(kLnThreads)
    ln_rows(const float* __restrict__ emb, const float* __restrict__ g,
            const float* __restrict__ b, bf16* __restrict__ X2, float* __restrict__ mean_out,
            float* __restrict__ rstd_out, long long N, int E, float eps) {
  const long long t = (long long)blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, nv = E >> 6;
  if (t >= N) return;
  const float* row = emb + t * E;
  float2 x[kLnV];
  // the whole LayerNorm in f64, x2 rounded once to f32 and then to bf16 (as
  // PyTorch rounds f64 to bf16): x2's bf16 roundings then agree with the
  // exact LayerNorm's but for ties
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kLnV; ++j) {
    if (j >= nv) break;
    x[j] = __ldg(reinterpret_cast<const float2*>(row + j * 64 + lane * 2));
    s += (double)x[j].x + (double)x[j].y;
  }
  const double mean = warp_sum(s) / E;
  double var = 0.0;
#pragma unroll
  for (int j = 0; j < kLnV; ++j) {
    if (j >= nv) break;
    const double c0 = x[j].x - mean, c1 = x[j].y - mean;
    var += c0 * c0 + c1 * c1;
  }
  const double rstd = 1.0 / sqrt(warp_sum(var) / E + (double)eps);
#pragma unroll
  for (int j = 0; j < kLnV; ++j) {
    if (j >= nv) break;
    const int col = j * 64 + lane * 2;
    const float2 gv = __ldg(reinterpret_cast<const float2*>(g + col));
    const float2 bv = __ldg(reinterpret_cast<const float2*>(b + col));
    const float o0 = __double2float_rn((x[j].x - mean) * rstd * gv.x + bv.x);
    const float o1 = __double2float_rn((x[j].y - mean) * rstd * gv.y + bv.y);
    *reinterpret_cast<uint32_t*>(X2 + t * E + col) = tc::pack_bf16(o0, o1);
  }
  if (mean_out != nullptr && lane == 0) {
    mean_out[t] = (float)mean;
    rstd_out[t] = (float)rstd;
  }
}

// demb through the LayerNorm, one warp a token, given dx2 as its two bf16
// halves DX2 (N, 2E) and the token's mean and rstd; per CTA of kLnTokens
// tokens the partial column sums of dx2 * xhat (dln1g) and dx2 (dln1b) into
// part_ln[blockIdx.x] (2E), over the warps in order.
template <int kLnV>
__global__ void __launch_bounds__(kLnThreads)
    ln_bwd(const float* __restrict__ emb, const bf16* __restrict__ DX2,
           const float* __restrict__ g, const float* __restrict__ mean,
           const float* __restrict__ rstd, float* __restrict__ demb, float* __restrict__ part_ln,
           long long N, int E) {
  __shared__ __align__(16) float red[kLnThreads / 32][64 * kLnV];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nv = E >> 6;
  float2 cg[kLnV], cb[kLnV];
#pragma unroll
  for (int j = 0; j < kLnV; ++j) cg[j] = cb[j] = make_float2(0.0f, 0.0f);
  const long long tile0 = (long long)blockIdx.x * kLnTokens;
  for (int k = warp; k < kLnTokens; k += kLnThreads / 32) {
    const long long t = tile0 + k;
    if (t >= N) break;
    const float mu = mean[t], rs = rstd[t];
    float2 xh[kLnV], dxh[kLnV];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < kLnV; ++j) {
      if (j >= nv) break;
      const int col = j * 64 + lane * 2;
      const float2 xv = __ldg(reinterpret_cast<const float2*>(emb + t * E + col));
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(DX2 + t * 2 * E + col));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(DX2 + t * 2 * E + E + col));
      const float2 gv = __ldg(reinterpret_cast<const float2*>(g + col));
      const float d0 = a.x + c.x, d1 = a.y + c.y;
      xh[j] = make_float2((xv.x - mu) * rs, (xv.y - mu) * rs);
      cg[j].x = fmaf(d0, xh[j].x, cg[j].x);
      cg[j].y = fmaf(d1, xh[j].y, cg[j].y);
      cb[j].x += d0;
      cb[j].y += d1;
      dxh[j] = make_float2(d0 * gv.x, d1 * gv.y);
      s1 += dxh[j].x + dxh[j].y;
      s2 = fmaf(dxh[j].x, xh[j].x, fmaf(dxh[j].y, xh[j].y, s2));
    }
    const float m1 = warp_sum(s1) / E, m2 = warp_sum(s2) / E;
#pragma unroll
    for (int j = 0; j < kLnV; ++j) {
      if (j >= nv) break;
      *reinterpret_cast<float2*>(demb + t * E + j * 64 + lane * 2) =
          make_float2(rs * (dxh[j].x - m1 - xh[j].x * m2), rs * (dxh[j].y - m1 - xh[j].y * m2));
    }
  }
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < kLnV; ++j) {
      if (j >= nv) break;
      *reinterpret_cast<float2*>(&red[warp][j * 64 + lane * 2]) = pass ? cb[j] : cg[j];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < E; i += kLnThreads) {
      float v = 0.0f;
      for (int w = 0; w < kLnThreads / 32; ++w) v += red[w][i];
      part_ln[(long long)blockIdx.x * 2 * E + pass * E + i] = v;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool supported(int B, int S, int E, int H, int Q) {
  return B >= 1 && B <= 65535 && S >= 1 && E >= kEMin && E <= kEMax && E == H * kHD && Q >= 1 &&
         Q <= kQMax;
}

// the split of S tokens over about kTargetCtas CTAs given `tiles` of them a
// split: (count, tokens a split, a multiple of kTT); none empty
void split_tokens(int S, long long tiles, int& n, int& per) {
  long long want = cdiv(kTargetCtas, tiles), most = cdiv(S, kMinSplit);
  want = want < 1 ? 1 : (want > most ? most : want);
  per = (int)(cdiv(cdiv(S, want), kTT) * kTT);
  n = (int)cdiv(S, per);
}

// How the work is cut, from the shapes alone (so the sums' order is fixed).
struct Plan {
  long long N;         // tokens, B * S
  int Qp, qtiles;      // the queries padded to tiles of 64
  int nsplit, per;     // the forward's and dq's token splits per (cell, head, query tile)
  int ksplit;          // dW's token slices
  long long kper;      // tokens a slice
  long long ln_tiles;  // LayerNorm backward CTAs
  Plan(int B, int S, int E, int H, int Q) {
    N = (long long)B * S;
    qtiles = (int)cdiv(Q, kTT);
    Qp = qtiles * kTT;
    split_tokens(S, (long long)B * H * qtiles, nsplit, per);
    const long long wtiles = cdiv(2 * E, kGN) * cdiv(E, kGM);
    long long ks = kSMs / wtiles, most = cdiv(N, 1024);
    ks = ks < 1 ? 1 : (ks > most ? most : ks);
    kper = cdiv(cdiv(N, ks), kGK) * kGK;
    ksplit = (int)cdiv(N, kper);
    ln_tiles = cdiv(N, kLnTokens);
  }
};

// The workspace, in order, each region on 1,024 bytes: W^T (2E, E) bf16, the
// queries (H, Qp, 64) bf16, bf(x2) (N, E) bf16, KV (N, 2E) bf16; then the
// forward's partials (where it splits), or the backward's bf(W) (E, 2E), dnum's
// parts (B, H, 3, Qp, 64) bf16, m and dden (B, H, Qp), the token stats (N
// each), DKV (N, 2E) bf16, the dq, dW and LayerNorm partials (f32).
struct Workspace {
  bf16 *Wt, *Qb, *X2, *KV, *Wb, *DNs, *DKV;
  float *pnum, *pstat, *Mp, *DDp, *mean, *rstd, *part_q, *part_w, *part_ln;
  int *amax, *parg;
  long long bytes;
  Workspace(void* base, int B, int S, int E, int H, int Q, bool backward) {
    const Plan p(B, S, E, H, Q);
    const long long E2 = 2LL * E;
    bytes = 0;
    auto take = [&](long long n) -> void* {
      void* r = base != nullptr ? static_cast<uint8_t*>(base) + bytes : nullptr;
      bytes += (n + 1023) & ~1023LL;
      return r;
    };
    Wt = (bf16*)take(2 * E2 * E);
    Qb = (bf16*)take(2LL * H * p.Qp * kHD);
    X2 = (bf16*)take(2 * p.N * E);
    KV = (bf16*)take(2 * p.N * E2);
    Wb = DNs = DKV = nullptr;
    pnum = pstat = Mp = DDp = mean = rstd = part_q = part_w = part_ln = nullptr;
    amax = parg = nullptr;
    const long long rows = (long long)B * H * p.Qp;
    if (!backward) {
      amax = (int*)take(4 * rows);
      if (p.nsplit > 1) {
        pnum = (float*)take(4 * p.nsplit * rows * kHD);
        pstat = (float*)take(4 * p.nsplit * rows * 2);
        parg = (int*)take(4 * p.nsplit * rows);
      }
      return;
    }
    Wb = (bf16*)take(2 * E2 * E);
    DNs = (bf16*)take(2 * 3 * rows * kHD);
    Mp = (float*)take(4 * rows);
    DDp = (float*)take(4 * rows);
    mean = (float*)take(4 * p.N);
    rstd = (float*)take(4 * p.N);
    DKV = (bf16*)take(2 * p.N * E2);
    part_q = (float*)take(4 * p.nsplit * rows * kHD);
    part_w = (float*)take(4 * p.ksplit * E * E2);
    part_ln = (float*)take(4 * p.ln_tiles * E2);
  }
};

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// A map of the contiguous bf16 matrix at `base`, `outer` rows of `inner`
// values, read in boxes of box_inner (64: 128 bytes) x box_outer in the
// 128-byte swizzle; reads past the edges fill zeros.
bool make_map(CUtensorMap* map, const bf16* base, long long inner, long long outer, int box_outer) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr || inner < 1 || outer < 1) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kGK, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMode>
cudaError_t launch_gemm(dim3 grid, const CUtensorMap& ma, const CUtensorMap& mb,
                        const GemmParams& p, cudaStream_t s) {
  cudaError_t e =
      cudaFuncSetAttribute(gemm_bf16<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (e != cudaSuccess) return e;
  gemm_bf16<kMode><<<grid, kGThreads, kGSmem, s>>>(ma, mb, p);
  return cudaGetLastError();
}

// The LayerNorm kernels compiled for E up to 64 kLnV, the least of 4, 8, 12
// and 16 that holds E (registers a lane: 2 kLnV values a token).
template <int kLnV>
cudaError_t ln_pair(bool backward, const float* emb, const float* g, const float* b, bf16* X2,
                    float* mean, float* rstd, float* demb, float* part_ln, long long N, int E,
                    float eps, cudaStream_t s) {
  if (backward)
    ln_bwd<kLnV><<<(unsigned)cdiv(N, kLnTokens), kLnThreads, 0, s>>>(emb, X2, g, mean, rstd, demb,
                                                                       part_ln, N, E);
  else
    ln_rows<kLnV><<<(unsigned)cdiv(N, kLnThreads / 32), kLnThreads, 0, s>>>(emb, g, b, X2, mean,
                                                                            rstd, N, E, eps);
  return cudaGetLastError();
}

cudaError_t layer_norm(bool backward, const float* emb, const float* g, const float* b, bf16* X2,
                       float* mean, float* rstd, float* demb, float* part_ln, long long N, int E,
                       float eps, cudaStream_t s) {
  auto fn = E <= 256 ? ln_pair<4> : E <= 512 ? ln_pair<8> : E <= 768 ? ln_pair<12> : ln_pair<16>;
  return fn(backward, emb, g, b, X2, mean, rstd, demb, part_ln, N, E, eps, s);
}

// one CTA an SM, or a CTA a tile where there are fewer (which CTA takes a
// tile does not change its sums)
dim3 persistent_grid(int ntiles) {
  int dev = 0, sms = kSMs;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = kSMs;
  return dim3((unsigned)(ntiles < sms ? ntiles : sms));
}

unsigned blocks_for(long long n) { return (unsigned)(cdiv(n, 256) < 4096 ? cdiv(n, 256) : 4096); }

cudaError_t sum_parts(const float* part, int nparts, long long n, float* dst, cudaStream_t s) {
  sum_parts_kernel<<<(unsigned)cdiv(n, 32), dim3(32, 8), 0, s>>>(part, nparts, n, dst);
  return cudaGetLastError();
}

// Steps 1-3, shared by both directions: the weights, the queries, bf(x2)
// (with the token stats backward) and KV.
cudaError_t project(const float* emb, const float* qfull, const float* ln1g, const float* ln1b,
                    const float* wk, const float* wv, const Workspace& ws, const Plan& p, int E,
                    int H, int Q, float eps, cudaStream_t s) {
  prep_weights<<<dim3(2 * E / 32, E / 32), dim3(32, 8), 0, s>>>(wk, wv, ws.Wt, ws.Wb, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prep_q<<<blocks_for((long long)H * p.Qp * kHD), 256, 0, s>>>(qfull, ws.Qb, H, Q, p.Qp, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = layer_norm(false, emb, ln1g, ln1b, ws.X2, ws.mean, ws.rstd, nullptr, nullptr, p.N, E,
                        eps, s)) != cudaSuccess)
    return err;
  CUtensorMap ma, mb;
  if (!make_map(&ma, ws.X2, E, p.N, kGM) || !make_map(&mb, ws.Wt, E, 2 * E, kGN))
    return cudaErrorInvalidValue;
  GemmParams gp{};
  gp.rows = p.N;
  gp.cols = 2 * E;
  gp.ctiles = 2 * E / kGN;
  gp.ntiles = (int)(cdiv(p.N, kGM) * gp.ctiles);
  gp.nk = E / kGK;
  gp.ldo = 2 * E;
  gp.out = ws.KV;
  return launch_gemm<kProj>(persistent_grid(gp.ntiles), ma, mb, gp, s);
}

int forward(const float* emb, const float* qfull, const float* ln1g, const float* ln1b,
            const float* wk, const float* wv, float* num, float* den, float* m, void* workspace,
            int B, int S, int E, int H, int Q, float eps, float scale, cudaStream_t s) {
  const Plan p(B, S, E, H, Q);
  const Workspace ws(workspace, B, S, E, H, Q, false);
  cudaError_t err = project(emb, qfull, ln1g, ln1b, wk, wv, ws, p, E, H, Q, eps, s);
  if (err != cudaSuccess) return (int)err;
  attn_fwd<<<dim3(p.nsplit, H * p.qtiles, B), kNT, 0, s>>>(ws.KV, ws.Qb, num, den, m, ws.amax,
                                                          ws.pnum, ws.pstat, ws.parg, B, S, E, H,
                                                          Q, p.Qp, p.per, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (p.nsplit > 1) {
    attn_merge<<<blocks_for((long long)B * Q * E), 256, 0, s>>>(
        ws.pnum, ws.pstat, ws.parg, num, den, m, ws.amax, B, H, Q, p.Qp, E, p.nsplit);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int smem = 2 * kHD * (E + 2) + 2 * 4 * E + 4 * (4 * kHD + 4);
  if ((err = cudaFuncSetAttribute(exact_max, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return (int)err;
  const long long blocks = cdiv((long long)B * Q, 4), most = 2 * kSMs / H;
  exact_max<<<dim3(H, (unsigned)(blocks < most ? blocks : most)), 256, smem, s>>>(
      ws.X2, ws.Wt, ws.Qb, ws.amax, num, den, m, B, S, E, H, Q, p.Qp, scale);
  return (int)cudaGetLastError();
}

int backward(const float* emb, const float* qfull, const float* ln1g, const float* ln1b,
             const float* wk, const float* wv, const float* m, const float* dnum,
             const float* dden, float* demb, float* dqfull, float* dln, float* dw,
             void* workspace, int B, int S, int E, int H, int Q, float eps, float scale,
             cudaStream_t s) {
  const Plan p(B, S, E, H, Q);
  const Workspace ws(workspace, B, S, E, H, Q, true);
  cudaError_t err = project(emb, qfull, ln1g, ln1b, wk, wv, ws, p, E, H, Q, eps, s);
  if (err != cudaSuccess) return (int)err;
  prep_cotangents<<<blocks_for((long long)B * H * p.Qp * kHD), 256, 0, s>>>(
      m, dnum, dden, ws.DNs, ws.Mp, ws.DDp, B, H, Q, p.Qp, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(attn_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kDkdvSmem)) != cudaSuccess)
    return (int)err;
  attn_dkdv<<<dim3((unsigned)cdiv(S, kTT), H, B), kNT, kDkdvSmem, s>>>(
      ws.KV, ws.Qb, ws.DNs, ws.Mp, ws.DDp, ws.DKV, S, E, H, p.Qp, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(attn_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kDqSmem)) != cudaSuccess)
    return (int)err;
  attn_dq<<<dim3(p.nsplit, H * p.qtiles, B), kNT, kDqSmem, s>>>(
      ws.KV, ws.Qb, ws.DNs, ws.Mp, ws.DDp, ws.part_q, S, E, H, p.Qp, p.per, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_dq<<<blocks_for((long long)H * Q * kHD), 256, 0, s>>>(ws.part_q, B * p.nsplit, H, Q, p.Qp,
                                                           E, dqfull);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dx2 goes where KV was: the attention backward, KV's last reader, is done
  bf16* DX2 = ws.KV;
  CUtensorMap ma, mb;
  if (!make_map(&ma, ws.DKV, 2 * E, p.N, kGM) || !make_map(&mb, ws.Wb, 2 * E, E, kGN))
    return (int)cudaErrorInvalidValue;
  GemmParams gp{};
  gp.rows = p.N;
  gp.cols = E;
  gp.ctiles = (int)cdiv(E, kGN);
  gp.ntiles = (int)(cdiv(p.N, kGM) * gp.ctiles);
  gp.nk = 2 * E / kGK;
  gp.half = E / kGK;
  gp.ldo = 2 * E;
  gp.out = DX2;
  if ((err = launch_gemm<kDx2>(persistent_grid(gp.ntiles), ma, mb, gp, s)) != cudaSuccess)
    return (int)err;
  if ((err = layer_norm(true, emb, ln1g, nullptr, DX2, ws.mean, ws.rstd, demb, ws.part_ln, p.N, E,
                        eps, s)) != cudaSuccess)
    return (int)err;
  if ((err = sum_parts(ws.part_ln, (int)p.ln_tiles, 2LL * E, dln, s)) != cudaSuccess)
    return (int)err;
  // dW's partials: (E, 2E) = bf(x2)^T (E, N) DKV (N, 2E), over ksplit token slices
  if (!make_map(&ma, ws.X2, E, p.N, kGK) || !make_map(&mb, ws.DKV, 2 * E, p.N, kGK))
    return (int)cudaErrorInvalidValue;
  gp = GemmParams{};
  gp.rows = E;
  gp.cols = 2 * E;
  gp.kper = p.kper;
  gp.ntok = p.N;
  gp.ldo = 2 * E;
  gp.out = ws.part_w;
  if ((err = launch_gemm<kDw>(dim3(2 * E / kGN, (unsigned)cdiv(E, kGM), p.ksplit), ma, mb, gp,
                              s)) != cudaSuccess)
    return (int)err;
  return (int)sum_parts(ws.part_w, p.ksplit, 2LL * E * E, dw, s);
}

}  // namespace

extern "C" {

// Floats of the workspace of the forward (backward = 0) or the backward; 0
// for a shape the kernels do not take.
long long scldm_window_pool_wide_workspace_floats(int B, int S, int E, int H, int Q,
                                                  int backward) {
  if (!supported(B, S, E, H, Q)) return 0;
  return Workspace(nullptr, B, S, E, H, Q, backward != 0).bytes / 4;
}

// Forward: num (B, Q, E), den and m (B, Q*H), f32, from emb (B, S, E), qfull
// (Q*H, E), ln1g, ln1b (E), wk, wv (E, E) (in, out), contiguous f32, with
// `workspace` (scldm_window_pool_wide_workspace_floats(..., 0) floats,
// 16-byte aligned). Launches on `stream`, on the current device; returns the
// first CUDA error code (0 on success). Allocates nothing and does not
// synchronise.
int scldm_window_pool_wide_forward(const void* emb, const void* qfull, const void* ln1g,
                                   const void* ln1b, const void* wk, const void* wv, void* num,
                                   void* den, void* m, void* workspace, int B, int S, int E,
                                   int H, int Q, float eps, float scale, void* stream) {
  if (B == 0) return 0;
  if (!supported(B, S, E, H, Q)) return (int)cudaErrorInvalidValue;
  return forward((const float*)emb, (const float*)qfull, (const float*)ln1g, (const float*)ln1b,
                 (const float*)wk, (const float*)wv, (float*)num, (float*)den, (float*)m,
                 workspace, B, S, E, H, Q, eps, scale, (cudaStream_t)stream);
}

// Backward, given the forward's m and the cotangents dnum (B, Q, E) and dden
// (B, Q*H): writes demb (B, S, E), dqfull's head blocks (the caller zeroes
// the rest), dln = [dln1g | dln1b] (2E) and dw = [dwk | dwv] (E, 2E), with
// `workspace` (scldm_window_pool_wide_workspace_floats(..., 1) floats). Same
// conventions as the forward.
int scldm_window_pool_wide_backward(const void* emb, const void* qfull, const void* ln1g,
                                    const void* ln1b, const void* wk, const void* wv,
                                    const void* m, const void* dnum, const void* dden, void* demb,
                                    void* dqfull, void* dln, void* dw, void* workspace, int B,
                                    int S, int E, int H, int Q, float eps, float scale,
                                    void* stream) {
  if (!supported(B, S, E, H, Q)) return (int)cudaErrorInvalidValue;
  return backward((const float*)emb, (const float*)qfull, (const float*)ln1g, (const float*)ln1b,
                  (const float*)wk, (const float*)wv, (const float*)m, (const float*)dnum,
                  (const float*)dden, (float*)demb, (float*)dqfull, (float*)dln, (float*)dw,
                  workspace, B, S, E, H, Q, eps, scale, (cudaStream_t)stream);
}

}  // extern "C"
