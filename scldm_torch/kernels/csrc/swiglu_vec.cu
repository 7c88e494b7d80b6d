// The SwiGLU up projection and gate, f32, forward and recompute backward, in
// two functions:
//
//   swiglu_vec:         s[r] = sum_j silu(x[r] . w1[:, j]) * (x[r] . w2[:, j]) * wv[j]
//   fused_swiglu_gate:  g[r, j] = silu(x[r] . w1[:, j]) * (x[r] . w2[:, j])
//
// with x (R, E), w12 = [w1 | w2] (E, 2Hd) and wv (Hd) row-major; s is (R), g
// (R, Hd). swiglu_vec is the decoder's algebraic tail (the gate contracted
// with the folded head vector); fused_swiglu_gate is the gate itself.
//
// Replaces the TPU kernels scldm_tpu/ops/fused_swiglu.py::swiglu_vec (Pallas
// body `_vec_fwd_kernel`) and `_vec_fused_bwd` (`_vec_bwd_kernel`), and
// fused_swiglu_gate (`_fwd_kernel`) and `_fused_bwd` (`_dx_kernel`,
// `_dw_kernel`). The math is `swiglu_vec_reference` and `swiglu_reference` in
// scldm_torch/ops/fused_swiglu.py. Each backward, given the gate's cotangent
// dg (swiglu_vec: dg[r, j] = ds[r] * wv[j]; the gate: the caller's (R, Hd)
// cotangent), recomputes u = x @ w12 and, with sg = sigmoid(u1),
//
//   du = [dg * u2 * sg * (1 + u1 * (1 - sg)) | dg * silu(u1)]   (R, 2Hd)
//   dx = du @ w12^T,  dw12 = x^T du,  and swiglu_vec's dwv = g^T ds.
//
// What bounds them on an H100: operations. At the census decoder (R = 16 x
// 36,601 = 585,616 rows, E = 512, Hd = 1,408) each forward is 1.69 TFLOP and
// each backward 5.07, against 1.2 GB of x read. The products run on the
// tensor cores as three TF32 passes (x = hi + lo, hi.hi + hi.lo + lo.hi),
// the least that keeps f32 accuracy there: 3 x 1.69 TFLOP at the 495 TFLOP/s
// TF32 peak is 10.2 ms forward, 30.7 ms backward.
//
// What the design does about it. Every product is one warp-specialised
// kernel, `swiglu_tc<mode>`, on wgmma.m64n128k8.tf32 with A from registers:
// - A CTA of three warpgroups: warpgroup 0 is the producer (one thread keeps
//   TMA loads in flight through a ring of three stages on mbarriers), the
//   other two consume. A stage is 32 deep: one A tile of the CTA's 64 rows
//   and a raw B tile of 128 output columns for each consumer.
// - A consumer splits its raw B tile into hi and lo K-major tiles in the
//   128-byte swizzled layout wgmma reads (tf32 operands must be K-major), and
//   its A fragments into hi and lo in registers, then releases the ring
//   stage and issues 12 wgmma (four k8 steps, three passes) into a stage sum
//   from zero, which it adds to its f32 accumulators: no tensor-core sum runs
//   over more than 32 products, so sums over thousands of rows keep their
//   low bits. The two consumers take turns on the tensor cores: one splits
//   while the other's wgmma run.
// - The operands are read as stored: x (R, E) and du are K-major for the up
//   projection and for dx; w12 is read as (E, 2Hd) and transposed by the
//   split (the up projection), or K-major as it lies (dx = du w12^T); for
//   dw12 = x^T du the CTA's A is du read down its columns and its B is x
//   transposed by the split. TMA zero-fills every ragged edge.
// - The up projection's 128 columns of a consumer are w1's columns j..j+63
//   and w2's same columns, so each thread holds u1 and u2 of one hidden
//   column: the gate, its derivative and the wv contraction are the
//   epilogue. swiglu_vec's forward CTA walks the whole hidden axis over its
//   64 rows and keeps the per-row sums in registers; nothing (R, Hd)-shaped
//   reaches memory.
// - The backward runs in chunks of kChunk rows: (1) the up projection with
//   du written to a (kChunk, 2 H4) workspace (swiglu_vec: with the CTA's
//   column sums of g * ds, dwv's partials); (2) dx of the chunk = du w12^T;
//   (3) dw12's kSplit partials over slices of the chunk's rows, each added to
//   its partial of the chunks before; (4) after the last chunk the partials
//   are added in order (dwv's after each chunk). No atomics: every sum runs
//   in a fixed order, the same bits every run, and the workspace is bounded
//   by the chunk, not by R.
// Tried and slower on an H100 80GB HBM3 at 700 W (benchmarks_torch/ab_swiglu_vec.py
// against this design, in turns): a CTA of 128 rows by 128 columns whose two
// consumers share one split B tile, double-buffered so that the next stage
// is split while this one's wgmma run, one barrier a stage between them:
// 24.19 against 20.74 ms forward, 130.49 against 70.94 backward at the census
// shape (a warp producing and 224 registers a thread; at 168 ptxas reported
// its wgmma serialized, C7515). Alternating the two consumers' turns on the
// tensor cores with two named barriers: 21.49 against 20.68 ms forward,
// 70.79 against 67.75 backward.
// TMA needs 16-byte bases, row pitches and box starts: the wrapper passes x
// and w12 with pitches ldx and ldw that are multiples of 4 floats, and w12's
// w2 block at column H4 = Hd rounded up to a multiple of 4 (a padded copy
// where the caller's are not: zero columns between the blocks); du keeps the
// same layout, its pad columns zero; offsets are 64-bit.

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

// (hopper_wgmma.cuh)
using hopper::fence_async_shared;
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

constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kBM = 64;        // rows (M) a CTA: each consumer's wgmma takes all 64
constexpr int kWN = 128;       // output columns a consumer
constexpr int kBK = 32;        // depth of an f32 stage: one 128-byte swizzle row of f32
constexpr int kBK16 = 64;      // depth of a bf16 stage: the same 128 bytes, twice the k
constexpr int kStages = 3;
constexpr int kAFloats = kBM * kBK;                   // 8 KB
constexpr int kBFloats = kWN * kBK;                   // 16 KB
constexpr int kStageBytes = 4 * (kAFloats + 2 * kBFloats);
constexpr int kSplitOff = kStages * kStageBytes;      // each consumer's hi and lo tiles (f32)
constexpr int kBarOff = kSplitOff + 2 * 2 * 4 * kBFloats;
constexpr int kRedOff = kBarOff + 64;                 // 2 x kStages mbarriers
constexpr int kRedFloats = 2 * 4 * 64;
constexpr int kSmemBytes = kRedOff + 4 * kRedFloats + 1024;  // + the 1,024-byte alignment
constexpr long long kChunk = 32768;  // backward: rows per workspace chunk
constexpr int kSplit = 3;            // backward: row slices of dw12's partial sums

static_assert(kSmemBytes <= 232448, "one CTA an SM");

// What a launch computes (see the header): the up projection with one of four
// epilogues, or one of the backward's two other products.
enum Mode : int { kFwdVec, kFwdGate, kBwdVec, kBwdGate, kDx, kDw };

struct Params {
  long long rows;   // rows of x (the chunk's, in the backward)
  int E, Hd;
  int nk;           // stages of a tile (kDw: of a whole slice)
  int ntiles;       // kFwdVec: 128-column hidden tiles the CTA walks
  int kper;         // kDw: rows of a slice, a multiple of the stage depth
  int accumulate;   // kDw: add to the partials of the chunks before
  int ldu;          // du's row pitch, 2 H4
  int h4;           // the column of w2's (and du2's) block: Hd rounded up to 16 bytes
  const void* wv;   // (Hd), the operands' type
  const float* ds;  // kBwdVec: ds (rows); kBwdGate: dg (rows, Hd)
  void* out;        // kFwdVec: s (rows, f32); kFwdGate: g (rows, Hd); kBwd*: du (rows, ldu);
                    // kDx: dx (rows, E); kDw: kSplit partials (E, 2 H4), f32; the others
                    // in the operands' type
  float* part_v;    // kBwdVec: dwv's partials (row tiles, Hd)
};

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// round to bf16 and back: where the bf16 function rounds
__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <bool kBf16>
__device__ __forceinline__ float load_op(const void* p, long long i) {
  if constexpr (kBf16) {
    return __bfloat162float(static_cast<const bf16*>(p)[i]);
  } else {
    return __ldg(static_cast<const float*>(p) + i);
  }
}

template <bool kBf16>
__device__ __forceinline__ void store_op(void* p, long long i, float v) {
  if constexpr (kBf16) {
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// d (64 x 128, f32; scale_d 0: d = a b) += a (64 x 8 tf32, registers) * b (8 x 128 tf32,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// keeps the compiler from moving reads or writes of A's fragments across the
// wgmma: computed before the wgmma fence, not between the wgmma
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i >> 2][i & 3])::"memory");
}

__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  tc::split_tf32(v.x, h[0], l[0]);
  tc::split_tf32(v.y, h[1], l[1]);
  tc::split_tf32(v.z, h[2], l[2]);
  tc::split_tf32(v.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                   __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

// A consumer's raw B tile into hi and lo, [128 n][32 k] in the 128-byte
// swizzle (16-byte chunk c of row n at c ^ (n & 7)); t is the thread's index in
// its warpgroup. kKMajor: the raw tile is already that layout (one box), so
// the split is elementwise. Otherwise it is two boxes [32 k][64 n] (n < 64,
// then the rest), transposed here: thread t takes column n = t, so a warp
// reads 32 neighbouring floats and writes 16 bytes a lane on 32 banks.
template <bool kKMajor>
__device__ __forceinline__ void split_b(const float* raw, float* hi, float* lo, int t) {
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    float4 v;
    int q;
    if constexpr (kKMajor) {
      q = t + it * 128;
      v = reinterpret_cast<const float4*>(raw)[q];
    } else {
      const float* src = raw + (t >> 6) * (kBK * 64) + it * 4 * 64 + (t & 63);
      v = make_float4(src[0], src[64], src[128], src[192]);
      q = t * 8 + (it ^ (t & 7));
    }
    float4 h, l;
    split4(v, h, l);
    h4[q] = h;
    l4[q] = l;
  }
}

// Element (m, k) of the stage's A tile: [64 m][32 k] in the 128-byte swizzle
// (kAM false: x or du along its rows), or two boxes [32 k][32 m] in it (kAM:
// du down its columns, m = the column).
template <bool kAM>
__device__ __forceinline__ float a_elem(const float* a, int m, int k) {
  if constexpr (!kAM) {
    return a[m * kBK + ((((k >> 2) ^ (m & 7))) << 2) + (k & 3)];
  } else {
    const int ml = m & 31;
    return a[(m >> 5) * (kBK * 32) + k * kBK + ((((ml >> 2) ^ (k & 7))) << 2) + (ml & 3)];
  }
}

// The kernel of every product (see the header). Grid: kFwdVec (row tiles);
// kFwdGate, kBwdVec, kBwdGate (row tiles, 128-column hidden tiles); kDx
// (256-column tiles of E, row tiles); kDw (256-column tiles of E, 64-column
// tiles of 2Hd, kSplit). `ma` and `mb` map A and B for the producer.
// kBf16: bf16 operands, one wgmma.m64n128k16 pass straight from the swizzled
// TMA tiles (A K-major, or MN-major as kDw's du; B MN-major as w12 and x lie,
// or K-major as kDx's w12), 64-deep stages of the same bytes, no split.
template <int kMode, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    swiglu_tc(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
              const Params p) {
  constexpr bool kUp = kMode == kFwdVec || kMode == kFwdGate || kMode == kBwdVec ||
                       kMode == kBwdGate;
  constexpr int kK = kBf16 ? kBK16 : kBK;  // the depth of a stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = tc::smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = tc::smem_u32(smem);
  const uint32_t full0 = sbase + kBarOff, empty0 = full0 + 8 * kStages;
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  const int wg = threadIdx.x >> 7;

  const int ntiles = kMode == kFwdVec ? p.ntiles : 1;
  int nk = p.nk;
  if (kMode == kDw) {
    const long long len = min(p.rows, (long long)(blockIdx.z + 1) * p.kper) -
                          (long long)blockIdx.z * p.kper;
    nk = len > 0 ? (int)((len + kK - 1) / kK) : 0;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
    for (int tile = 0; tile < ntiles; ++tile) {
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t bar = full0 + 8 * s, st = sbase + s * kStageBytes;
        const uint32_t b0 = st + 4 * kAFloats;
        mbar_expect_tx(bar, kStageBytes);
        if constexpr (kMode == kDw) {
          const int k0 = blockIdx.z * p.kper + kt * kK, c0 = blockIdx.y * kBM;
          tma_load(st, &ma, c0, k0, bar);
          if constexpr (!kBf16) tma_load(st + 4 * kBK * 32, &ma, c0 + 32, k0, bar);
          for (int g = 0; g < 2; ++g) {
            const int e = blockIdx.x * 2 * kWN + g * kWN;
            tma_load(b0 + g * 4 * kBFloats, &mb, e, k0, bar);
            tma_load(b0 + g * 4 * kBFloats + 4 * kBK * 64, &mb, e + 64, k0, bar);
          }
        } else if constexpr (kMode == kDx) {
          tma_load(st, &ma, kt * kK, blockIdx.y * kBM, bar);
          for (int g = 0; g < 2; ++g)
            tma_load(b0 + g * 4 * kBFloats, &mb, kt * kK, blockIdx.x * 2 * kWN + g * kWN, bar);
        } else {
          tma_load(st, &ma, kt * kK, blockIdx.x * kBM, bar);
          const int jt = (kMode == kFwdVec ? tile : (int)blockIdx.y) * kWN;
          for (int g = 0; g < 2; ++g) {
            tma_load(b0 + g * 4 * kBFloats, &mb, jt + g * 64, kt * kK, bar);
            tma_load(b0 + g * 4 * kBFloats + 4 * kBK * 64, &mb, p.h4 + jt + g * 64, kt * kK,
                     bar);
          }
        }
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int g = wg - 1, t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
    float* hi = reinterpret_cast<float*>(smem + kSplitOff) + g * 2 * kBFloats;
    float* lo = hi + kBFloats;
    const uint32_t hi_addr = tc::smem_u32(hi), lo_addr = tc::smem_u32(lo);
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.0f;
    float s_row[2] = {0.0f, 0.0f};  // kFwdVec: the sums of rows gq and gq + 8
    int s = 0;
    uint32_t ph = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full0 + 8 * s, ph);
        if constexpr (kBf16) {
          // the stage's four k16 steps summed from zero, then added in f32
          const uint32_t a0 = sbase + s * kStageBytes;
          const uint32_t b0 = a0 + 4 * kAFloats + g * 4 * kBFloats;
          fence_regs(part);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if constexpr (kMode == kDw)
              wgmma_bf16<1, 1>(part, mn_desc(a0 + kk * 2048), mn_desc(b0 + kk * 2048), kk > 0);
            else if constexpr (kMode == kDx)
              wgmma_bf16<0, 0>(part, k_desc(a0 + kk * 32), k_desc(b0 + kk * 32), kk > 0);
            else
              wgmma_bf16<0, 1>(part, k_desc(a0 + kk * 32), mn_desc(b0 + kk * 2048), kk > 0);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_regs(part);
          named_sync(1 + g, 128);  // the warpgroup's wgmma have read stage s
          if (t == 0) mbar_arrive(empty0 + 8 * s);
        } else {
          const float* stage = reinterpret_cast<const float*>(smem + s * kStageBytes);
          split_b<kMode == kDx>(stage + kAFloats + g * kBFloats, hi, lo, t);
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int m = warp * 16 + gq, k = kk * 8 + tq;
            tc::split_tf32(a_elem<kMode == kDw>(stage, m, k), ah[kk][0], al[kk][0]);
            tc::split_tf32(a_elem<kMode == kDw>(stage, m + 8, k), ah[kk][1], al[kk][1]);
            tc::split_tf32(a_elem<kMode == kDw>(stage, m, k + 4), ah[kk][2], al[kk][2]);
            tc::split_tf32(a_elem<kMode == kDw>(stage, m + 8, k + 4), ah[kk][3], al[kk][3]);
          }
          fence_async_shared();
          named_sync(1 + g, 128);  // the warpgroup's hi and lo are written; stage s is read
          if (t == 0) mbar_arrive(empty0 + 8 * s);
          fence_regs(ah);
          fence_regs(al);
          fence_regs(part);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_tf32(part, ah[kk], k_desc(hi_addr + kk * 32), kk > 0);
            wgmma_tf32(part, ah[kk], k_desc(lo_addr + kk * 32), 1);
            wgmma_tf32(part, al[kk], k_desc(hi_addr + kk * 32), 1);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_regs(part);
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }

      // ---- epilogue: thread (warp, gq, tq) holds rows m = 16 warp + gq (acc[4i],
      // acc[4i + 1]) and m + 8 (acc[4i + 2], acc[4i + 3]), columns 8i + 2tq + {0, 1} ----
      const int m0 = warp * 16 + gq;
      if constexpr (kUp) {
        // columns n < 64: u1 of hidden column j = jw + n; n + 64: u2 of the same
        const int jw = (kMode == kFwdVec ? tile : (int)blockIdx.y) * kWN + g * 64;
        const long long r0 = (long long)blockIdx.x * kBM;
        float colsum[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) colsum[i] = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = jw + 8 * i + 2 * tq + (q & 1);
            const long long r = r0 + m0 + (q >> 1) * 8;
            const float u1 = acc[4 * i + q], u2 = acc[4 * (i + 8) + q];
            if constexpr (kMode == kBwdVec || kMode == kBwdGate) {
              if (j >= p.Hd && j < p.h4 && r < p.rows) {  // du's pad columns
                store_op<kBf16>(p.out, r * p.ldu + j, 0.0f);
                store_op<kBf16>(p.out, r * p.ldu + p.h4 + j, 0.0f);
              }
            }
            if (j >= p.Hd) continue;
            if constexpr (kMode == kFwdVec) {
              // bf16: g rounded before its product with wv, as the function rounds it
              const float gj = u1 * sigmoid(u1) * u2;
              s_row[q >> 1] = fmaf(kBf16 ? bfr(gj) : gj, load_op<kBf16>(p.wv, j), s_row[q >> 1]);
            } else {
              if (r >= p.rows) continue;
              const float sg = sigmoid(u1), sl = u1 * sg;
              if constexpr (kMode == kFwdGate) {
                static_cast<float*>(p.out)[r * p.Hd + j] = sl * u2;
              } else {
                float dg;
                if constexpr (kMode == kBwdVec) {
                  const float d = __ldg(p.ds + r);
                  dg = d * load_op<kBf16>(p.wv, j);
                  // bf16: dwv = bf(g)^T bf(ds), summed in f32
                  colsum[2 * i + (q & 1)] = kBf16
                      ? fmaf(bfr(sl * u2), bfr(d), colsum[2 * i + (q & 1)])
                      : fmaf(sl * u2, d, colsum[2 * i + (q & 1)]);
                } else {
                  dg = __ldg(p.ds + r * p.Hd + j);
                }
                // bf16: du rounded where it is stored, as the function rounds it
                store_op<kBf16>(p.out, r * p.ldu + j, dg * u2 * (sg + sl * (1.0f - sg)));
                store_op<kBf16>(p.out, r * p.ldu + p.h4 + j, dg * sl);
              }
            }
          }
        }
        if constexpr (kMode == kBwdVec) {
          // the CTA's column sums of g * ds, over its 64 rows in a fixed order
#pragma unroll
          for (int i = 0; i < 16; ++i) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              colsum[i] += __shfl_xor_sync(0xffffffffu, colsum[i], off);
          }
          if (gq == 0) {
#pragma unroll
            for (int i = 0; i < 16; ++i)
              red[g * 256 + warp * 64 + 8 * (i >> 1) + 2 * tq + (i & 1)] = colsum[i];
          }
          named_sync(1 + g, 128);
          if (t < 64 && jw + t < p.Hd) {
            const float* rg = red + g * 256 + t;
            p.part_v[(long long)blockIdx.x * p.Hd + jw + t] = ((rg[0] + rg[64]) + rg[128]) + rg[192];
          }
        }
      } else if constexpr (kMode == kDx) {
        const long long r0 = (long long)blockIdx.y * kBM;
        const int e0 = blockIdx.x * 2 * kWN + g * kWN;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const long long r = r0 + m0 + (q >> 1) * 8;
            const int e = e0 + 8 * i + 2 * tq + (q & 1);
            if (r < p.rows && e < p.E) store_op<kBf16>(p.out, r * p.E + e, acc[4 * i + q]);
          }
        }
      } else {  // kDw: partial z of dw12 in w12's padded layout (E, 2 H4), column c = 64 blockIdx.y + m
        const int c0 = blockIdx.y * kBM, e0 = blockIdx.x * 2 * kWN + g * kWN;
        const long long H2 = 2LL * p.h4;
        float* P = static_cast<float*>(p.out) + (long long)blockIdx.z * p.E * H2;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = c0 + m0 + (q >> 1) * 8;
            const int e = e0 + 8 * i + 2 * tq + (q & 1);
            if (c < H2 && e < p.E) {
              float* dst = P + e * H2 + c;
              *dst = p.accumulate ? *dst + acc[4 * i + q] : acc[4 * i + q];
            }
          }
        }
      }
    }
    if constexpr (kMode == kFwdVec) {
      // each row's sum: over the quad in a fixed butterfly, then the two consumers'
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s_row[h] += __shfl_xor_sync(0xffffffffu, s_row[h], 1);
        s_row[h] += __shfl_xor_sync(0xffffffffu, s_row[h], 2);
      }
      if (tq == 0) {
        red[g * 64 + warp * 16 + gq] = s_row[0];
        red[g * 64 + warp * 16 + gq + 8] = s_row[1];
      }
      named_sync(3, 256);
      const long long r = (long long)blockIdx.x * kBM + t;
      if (g == 0 && t < kBM && r < p.rows) static_cast<float*>(p.out)[r] = red[t] + red[64 + t];
    }
  }
}

// dst[i] = (accumulate ? dst[i] : 0) + sum over p, in order, of part[p * ldp + src(i)],
// with n = rows x w and src(i) = i (h4 = 0: the parts are (rows, w)), or,
// for dw12 (rows, w = 2Hd) from parts in the padded layout (rows, 2 h4),
// column c < Hd from c and the others from c - Hd + h4.
__global__ void swiglu_sum_parts(const float* __restrict__ part, int nparts, long long n,
                                 long long ldp, int w, int h4, float* __restrict__ dst,
                                 int accumulate) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long src = i;
    if (h4 > 0) {
      const long long row = i / w;
      const int c = (int)(i - row * w), hd = w / 2;
      src = row * 2LL * h4 + (c < hd ? c : c - hd + h4);
    }
    float v = 0.0f;
    for (int q = 0; q < nparts; ++q) v += part[q * ldp + src];
    dst[i] = accumulate ? dst[i] + v : v;
  }
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

cudaError_t sum_parts(const float* part, int nparts, long long n, long long ldp, int w, int h4,
                      float* dst, bool accumulate, cudaStream_t s) {
  const long long blocks = cdiv(n, 256) < 4096 ? cdiv(n, 256) : 4096;
  swiglu_sum_parts<<<(unsigned)blocks, 256, 0, s>>>(part, nparts, n, ldp, w, h4, dst,
                                                    accumulate ? 1 : 0);
  return cudaGetLastError();
}

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

// A map of the matrix at `base` (f32, or bf16 with kBf16): `outer` rows of
// `inner` values, `pitch` values apart (16 bytes' worth, base 16-byte
// aligned), read in boxes of box_inner x box_outer, with the 128-byte swizzle
// or none; reads past the edges fill zeros.
template <bool kBf16>
bool make_map(CUtensorMap* map, const void* base, long long inner, long long outer,
              long long pitch, int box_inner, int box_outer, bool swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr || inner < 1 || outer < 1) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * (kBf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A's and B's maps by role: x or du along its rows (A, swizzled), du down its
// columns (A of kDw), w12 read (E, 2Hd) in 64-column boxes (B of the up
// projection), w12 K-major (B of kDx), x's rows in 64-column boxes (B of kDw).
// Every box is a stage's depth of 128 bytes; f32 MN-major boxes are read raw
// (the consumers split and transpose them), bf16 ones swizzled for wgmma.
template <bool kBf16>
constexpr int stage_k() { return kBf16 ? kBK16 : kBK; }
template <bool kBf16>
bool map_rows_a(CUtensorMap* m, const void* a, long long rows, int width, int pitch) {
  return make_map<kBf16>(m, a, width, rows, pitch, stage_k<kBf16>(), kBM, true);
}
template <bool kBf16>
bool map_cols_a(CUtensorMap* m, const void* a, long long rows, int width, int pitch) {
  return make_map<kBf16>(m, a, width, rows, pitch, kBf16 ? 64 : 32, stage_k<kBf16>(), true);
}
template <bool kBf16>
bool map_mn_b(CUtensorMap* m, const void* b, long long rows, int width, int pitch) {
  return make_map<kBf16>(m, b, width, rows, pitch, 64, stage_k<kBf16>(), kBf16);
}
template <bool kBf16>
bool map_k_b(CUtensorMap* m, const void* b, long long rows, int width, int pitch) {
  return make_map<kBf16>(m, b, width, rows, pitch, stage_k<kBf16>(), kWN, true);
}

template <int kMode, bool kBf16>
cudaError_t launch(dim3 grid, const CUtensorMap& ma, const CUtensorMap& mb, const Params& p,
                   cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(swiglu_tc<kMode, kBf16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  swiglu_tc<kMode, kBf16><<<grid, kThreads, kSmemBytes, s>>>(ma, mb, p);
  return cudaGetLastError();
}

// The column of w2's block: Hd rounded up to 16 bytes (4 f32, 8 bf16).
template <bool kBf16>
int h4_of(int Hd) {
  constexpr int a = kBf16 ? 8 : 4;
  return (Hd + a - 1) / a * a;
}

// The backward's workspace in floats: du of one chunk (pitch 2 H4, in the
// operands' type), dw12's kSplit partials (E, 2 H4) and (vec) dwv's
// per-row-tile partials of one chunk, f32.
template <bool kBf16>
long long workspace_floats(long long R, int E, int Hd, bool vec) {
  const long long rows = R < kChunk ? R : kChunk, H2 = 2LL * h4_of<kBf16>(Hd);
  return (kBf16 ? rows * H2 / 2 : rows * H2) + kSplit * E * H2 +
         (vec ? cdiv(rows, kBM) * Hd : 0);
}

// The up projection with the kFwdVec or kFwdGate epilogue over all R rows.
template <int kMode, bool kBf16>
int forward(const void* x, int ldx, const void* w12, int ldw, const void* wv, float* out,
            long long R, int E, int Hd, cudaStream_t s) {
  if (R == 0) return 0;
  CUtensorMap ma, mb;
  const int h4 = h4_of<kBf16>(Hd);
  if (!map_rows_a<kBf16>(&ma, x, R, E, ldx) || !map_mn_b<kBf16>(&mb, w12, E, 2 * h4, ldw))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.rows = R;
  p.E = E;
  p.Hd = Hd;
  p.h4 = h4;
  p.nk = (int)cdiv(E, stage_k<kBf16>());
  p.ntiles = (int)cdiv(Hd, kWN);
  p.wv = wv;
  p.out = out;
  const dim3 grid = kMode == kFwdVec ? dim3((unsigned)cdiv(R, kBM))
                                     : dim3((unsigned)cdiv(R, kBM), (unsigned)cdiv(Hd, kWN));
  return (int)launch<kMode, kBf16>(grid, ma, mb, p, s);
}

// Both backwards, chunk after chunk: (1) du (and, kVec, dwv's partials), (2)
// dx = du w12^T, (3) dw12's partials x^T du, each added to the chunks'
// before; then their fixed-order sums. kBf16: x, w12, wv, du and dx bf16;
// ds, dw12, dwv and the partials f32.
template <bool kVec, bool kBf16>
int backward(const void* x, int ldx, const void* w12, int ldw, const void* wv, const float* ds,
             void* dx, float* dw12, float* dwv, float* workspace, long long R, int E, int Hd,
             cudaStream_t s) {
  if (R == 0) return (int)cudaErrorInvalidValue;
  constexpr int kK = stage_k<kBf16>();
  constexpr int kSize = kBf16 ? 2 : 4;  // bytes of an operand
  const int h4 = h4_of<kBf16>(Hd), ldu = 2 * h4;  // du's layout: w12's, padded
  const long long H2 = ldu;
  const long long chunk_rows = R < kChunk ? R : kChunk;
  void* du = workspace;
  float* part_w = workspace + (kBf16 ? chunk_rows * ldu / 2 : chunk_rows * ldu);
  float* part_v = part_w + (long long)kSplit * E * H2;
  CUtensorMap w_mn, w_k;
  if (!map_mn_b<kBf16>(&w_mn, w12, E, ldu, ldw) || !map_k_b<kBf16>(&w_k, w12, E, ldu, ldw))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  for (long long c0 = 0; c0 < R && err == cudaSuccess; c0 += kChunk) {
    const long long rows = R - c0 < kChunk ? R - c0 : kChunk;
    const void* xc = static_cast<const uint8_t*>(x) + c0 * ldx * kSize;
    CUtensorMap x_a, x_b, du_a, du_c;
    if (!map_rows_a<kBf16>(&x_a, xc, rows, E, ldx) || !map_mn_b<kBf16>(&x_b, xc, rows, E, ldx) ||
        !map_rows_a<kBf16>(&du_a, du, rows, ldu, ldu) ||
        !map_cols_a<kBf16>(&du_c, du, rows, ldu, ldu))
      return (int)cudaErrorInvalidValue;
    const unsigned row_tiles = (unsigned)cdiv(rows, kBM);
    Params p{};
    p.rows = rows;
    p.E = E;
    p.Hd = Hd;
    p.ldu = ldu;
    p.h4 = h4;
    p.ntiles = 1;
    // (1) du of the chunk
    p.nk = (int)cdiv(E, kK);
    p.wv = wv;
    p.ds = kVec ? ds + c0 : ds + c0 * Hd;
    p.out = du;
    p.part_v = part_v;
    err = launch<kVec ? kBwdVec : kBwdGate, kBf16>(dim3(row_tiles, (unsigned)cdiv(Hd, kWN)), x_a,
                                                   w_mn, p, s);
    if (err != cudaSuccess) break;
    // (2) dx rows of the chunk: (rows, E) = du (rows, 2Hd) @ w12^T
    p.nk = (int)cdiv(H2, kK);
    p.out = static_cast<uint8_t*>(dx) + c0 * E * kSize;
    err = launch<kDx, kBf16>(dim3((unsigned)cdiv(E, 2 * kWN), row_tiles), du_a, w_k, p, s);
    if (err != cudaSuccess) break;
    // (3) dw12's partials over kSplit slices of the chunk's rows
    p.kper = (int)(cdiv(cdiv(rows, kSplit), kK) * kK);
    p.nk = 0;  // per slice, in the kernel
    p.accumulate = c0 > 0;
    p.out = part_w;
    err = launch<kDw, kBf16>(dim3((unsigned)cdiv(E, 2 * kWN), (unsigned)cdiv(H2, kBM), kSplit),
                             du_c, x_b, p, s);
    if (err != cudaSuccess) break;
    if (kVec) err = sum_parts(part_v, (int)row_tiles, Hd, Hd, Hd, 0, dwv, c0 > 0, s);
  }
  if (err == cudaSuccess)
    err = sum_parts(part_w, kSplit, 2LL * E * Hd, E * H2, 2 * Hd, h4, dw12, false, s);
  return (int)err;
}

}  // namespace

extern "C" {

// Floats of swiglu_vec's backward workspace for R rows.
long long scldm_swiglu_vec_workspace_floats(long long R, int E, int Hd) {
  return workspace_floats<false>(R, E, Hd, true);
}

// Forward: out (R) f32 from x (R, E; row pitch ldx), w12 (E, 2 H4; pitch ldw:
// w1 in columns [0, Hd), w2 in [H4, H4 + Hd), H4 = Hd rounded up to a
// multiple of 4) and wv (Hd), f32, pitches multiples of 4 floats and bases
// 16-byte aligned.
// Launches on `stream`, on the current device; returns the CUDA error code of
// the launch (0 on success). Allocates nothing and does not synchronise.
int scldm_swiglu_vec_forward(const void* x, int ldx, const void* w12, int ldw, const void* wv,
                             void* out, long long R, int E, int Hd, void* stream) {
  return forward<kFwdVec, false>(x, ldx, w12, ldw, wv, (float*)out, R, E, Hd,
                                 (cudaStream_t)stream);
}

// Backward: given ds (R), writes dx (R, E), dw12 (E, 2Hd: [dw1 | dw2], not
// padded) and dwv (Hd) whole (contiguous), using `workspace` (scldm_swiglu_vec_workspace_floats floats).
// Same conventions as the forward; returns the first CUDA error code. R >= 1.
int scldm_swiglu_vec_backward(const void* x, int ldx, const void* w12, int ldw, const void* wv,
                              const void* ds, void* dx, void* dw12, void* dwv, void* workspace,
                              long long R, int E, int Hd, void* stream) {
  return backward<true, false>(x, ldx, w12, ldw, wv, (const float*)ds, dx, (float*)dw12,
                               (float*)dwv, (float*)workspace, R, E, Hd, (cudaStream_t)stream);
}

// Floats of the bf16 swiglu_vec backward's workspace for R rows.
long long scldm_swiglu_vec_bf16_workspace_floats(long long R, int E, int Hd) {
  return workspace_floats<true>(R, E, Hd, true);
}

// The bf16 forward: out (R) f32 from bf16 x, w12 and wv laid out as the f32
// forward's, with pitches of multiples of 8 values and H4 = Hd rounded up to
// a multiple of 8. The products are bf16 x bf16 summed in f32; g is rounded
// to bf16 before its product with wv.
int scldm_swiglu_vec_bf16_forward(const void* x, int ldx, const void* w12, int ldw,
                                  const void* wv, void* out, long long R, int E, int Hd,
                                  void* stream) {
  return forward<kFwdVec, true>(x, ldx, w12, ldw, wv, (float*)out, R, E, Hd,
                                (cudaStream_t)stream);
}

// The bf16 backward: given ds (R) f32, writes dx (R, E) bf16 and dw12 (E, 2Hd)
// and dwv (Hd) f32 (the caller rounds them to bf16), using `workspace`
// (scldm_swiglu_vec_bf16_workspace_floats floats). du is rounded to bf16 where
// it is stored. R >= 1.
int scldm_swiglu_vec_bf16_backward(const void* x, int ldx, const void* w12, int ldw,
                                   const void* wv, const void* ds, void* dx, void* dw12,
                                   void* dwv, void* workspace, long long R, int E, int Hd,
                                   void* stream) {
  return backward<true, true>(x, ldx, w12, ldw, wv, (const float*)ds, dx, (float*)dw12,
                              (float*)dwv, (float*)workspace, R, E, Hd, (cudaStream_t)stream);
}

// Floats of fused_swiglu_gate's backward workspace for R rows.
long long scldm_swiglu_gate_workspace_floats(long long R, int E, int Hd) {
  return workspace_floats<false>(R, E, Hd, false);
}

// fused_swiglu_gate's forward: out (R, Hd) = silu(x @ w1) * (x @ w2) from x
// and w12 = [w1 | w2] (laid out as swiglu_vec's). Same conventions as
// swiglu_vec's forward.
int scldm_swiglu_gate_forward(const void* x, int ldx, const void* w12, int ldw, void* out,
                              long long R, int E, int Hd, void* stream) {
  return forward<kFwdGate, false>(x, ldx, w12, ldw, nullptr, (float*)out, R, E, Hd,
                                  (cudaStream_t)stream);
}

// fused_swiglu_gate's backward: given the cotangent dg (R, Hd), writes dx (R,
// E) and dw12 = [dw1 | dw2] (E, 2Hd) whole, using `workspace`
// (scldm_swiglu_gate_workspace_floats floats). R >= 1.
int scldm_swiglu_gate_backward(const void* x, int ldx, const void* w12, int ldw, const void* dg,
                               void* dx, void* dw12, void* workspace, long long R, int E, int Hd,
                               void* stream) {
  return backward<false, false>(x, ldx, w12, ldw, nullptr, (const float*)dg, dx, (float*)dw12,
                                nullptr, (float*)workspace, R, E, Hd, (cudaStream_t)stream);
}

}  // extern "C"
