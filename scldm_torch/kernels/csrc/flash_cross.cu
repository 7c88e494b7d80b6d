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
// 4*B*G*M*E operations (154 GFLOP, 0.16 ms at the bf16 tensor-core peak), so
// mma.sync m16n8k16 (bf16 in, f32 accumulate, rounding exactly where the
// Pallas kernel rounds) is rate enough. Like the TPU kernel it keeps the
// (B, H, G, M) scores and probabilities out of device memory (2.4 GB each in
// f32 at that shape). The TPU kernel's block-diagonal kblk / vblk operands,
// which do H times the attention work to keep the MXU full, are not carried
// over: each head is its own pair of products.
//
// The first design lost 2.8x its bound (2.0550 ms against 0.7409 at
// 2B = 32, G = 36,601; SDPA in bf16 1.1755): every (head, cell) tile of k
// and v was staged synchronously between two __syncthreads, so the write
// stream stopped at every staging; y left registers as 8-byte stores; each
// 128-gene tile re-read all of its cells' k and v from L2 (1.2 GB beside the
// 2.4 GB written); round_kv wrote v^T with 2-byte stores. This design never
// stops the write stream:
// - round_kv: one CTA per (cell, head) rounds k_h and v_h to bf16 once and
//   writes k_h (M, hd) and v_h^T (hd, M), each an 8 KB tile with its 16-byte
//   chunks XOR-swizzled by row ((chunk ^ row % 8): the fragment loads then
//   hit 32 distinct banks with no padding), in whole 16-byte stores.
// - flash_cross_fwd: persistent CTAs of 8 warps, two an SM, walk items of
//   (256 genes, one head, 8 cells) in turn (4,576 items at the census
//   shape: 17.3 an SM pair, where a grid of one CTA per gene and cell tile
//   left a third wave 17% full). Each warp takes two m16 tiles of genes. Each
//   staged (cell, head) tile feeds 256 rows, so the L2 reads of k and v fall
//   to 143 gene tiles x 4 MB = 0.57 GB, a quarter of y. qp is read once per
//   item, rounded into the warp's A fragments and kept in registers across
//   its cells (the TPU kernel's resident qp tile; a pre-rounded bf16 copy of
//   qp, 37 MB more traffic, is not made). The B fragments of both products
//   come from the swizzled tiles by ldmatrix (x4: two n-tiles a load); the
//   softmax is exp2 of the log2(e)-scaled scores and a multiply by the
//   reciprocal of the sum.
// - The (head, cell) tiles stream through a ring of two stages: one thread
//   fills a stage with two 1-D bulk copies (cp.async.bulk) completing on the
//   stage's `full` mbarrier; every thread arrives on its `empty` mbarrier
//   once the products of its last m16 tile have consumed the stage's
//   fragments, and the filling thread waits on that before refilling it. No
//   __syncthreads after the prologue: warps run ahead of one another by up
//   to a stage.
// - Each warp stages a 16 x 64 slice of y in shared memory (rows padded to
//   288 bytes: conflict-free 8-byte stores), fences it to the async proxy,
//   and writes it with one 256-byte bulk store per row
//   (cp.async.bulk.global.shared::cta, no tensor map), two staging tiles a
//   warp in turn: the warp waits only for the store that last read a tile
//   (wait_group.read 1), never for its writes to land, before the next
//   tile's mma.
// Shared memory per CTA: the ring 2 x (8 + 8) KB = 32 KB, y staging 8 warps
// x 2 x 16 rows x 288 bytes = 72 KB, four mbarriers: 106,528 bytes, so two
// CTAs (16 warps) share an SM within its 228 KB.
// - The ragged last gene tile reads zero queries and stores nothing for
//   them; a ragged cell tile skips the missing cells. Nothing is padded.
// Built for M = 64 keys and hd = 64 (kM, kHd); the wrapper
// (scldm_torch/ops/fused_cross.py) raises on other widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kHd = 64;             // head width
constexpr int kM = 64;              // keys (latent tokens)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTilesPerWarp = 2;    // m16 tiles of genes a warp
constexpr int kRows = 16 * kTilesPerWarp * kWarps;  // 256 genes a CTA
constexpr int kBatch = 8;           // cells a CTA
constexpr int kStages = 2;          // the k / v ring
constexpr int kTile = kM * kHd;     // elements of one k_h or v_h^T tile
constexpr int kTileBytes = 2 * kTile;
constexpr int kYLd = kHd + 8;       // a staged row of y: 64 floats, padded to 288 bytes
constexpr int kYTile = 16 * kYLd;   // floats of one staged m16 tile
constexpr int kSmemKV = kStages * 2 * kTileBytes;
constexpr int kSmemY = kWarps * 2 * kYTile * 4;
constexpr int kSmem = kSmemKV + kSmemY + 2 * kStages * 8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// offset of element (r, c) of a swizzled 64 x 64 bf16 tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; lane l receives row l / 4, columns 2 (l % 4)
// and 2 (l % 4) + 1 of each: the B fragments of two m16n8k16 n-tiles
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");  // not to be moved past the stage's release
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` from global `src` into shared `dst`, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` from shared `src` to global `dst`, in this thread's open bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most one of this thread's bulk groups still reads shared memory
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// make this thread's shared-memory writes visible to the bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// kb[b, h] = swz(bf16(k_h[b])), (M, hd); vt[b, h] = swz(bf16(v_h[b])^T), (hd, M).
// One CTA of 256 threads per (cell, head); every store 16 bytes.
__global__ void __launch_bounds__(256)
round_kv(const float* __restrict__ k, const float* __restrict__ v, __nv_bfloat16* __restrict__ kb,
         __nv_bfloat16* __restrict__ vt, int H) {
  __shared__ float vs[kM][kHd + 1];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int E = H * kHd;
  const float* kh = k + (size_t)b * kM * E + h * kHd;
  const float* vh = v + (size_t)b * kM * E + h * kHd;
  __nv_bfloat16* kt = kb + (size_t)bh * kTile;
  __nv_bfloat16* vtt = vt + (size_t)bh * kTile;
  for (int i = threadIdx.x; i < kTile / 8; i += blockDim.x) {
    const int r = i >> 3, c = (i & 7) << 3;
    const float4 x0 = *reinterpret_cast<const float4*>(kh + (size_t)r * E + c);
    const float4 x1 = *reinterpret_cast<const float4*>(kh + (size_t)r * E + c + 4);
    *reinterpret_cast<uint4*>(kt + swz(r, c)) =
        make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w), pack_bf16(x1.x, x1.y),
                   pack_bf16(x1.z, x1.w));
  }
  for (int i = threadIdx.x; i < kTile / 4; i += blockDim.x) {
    const int r = i >> 4, c = (i & 15) << 2;
    const float4 x = *reinterpret_cast<const float4*>(vh + (size_t)r * E + c);
    vs[r][c] = x.x, vs[r][c + 1] = x.y, vs[r][c + 2] = x.z, vs[r][c + 3] = x.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile / 8; i += blockDim.x) {
    const int d = i >> 3, m = (i & 7) << 3;  // row d of v^T, keys m..m+7
    *reinterpret_cast<uint4*>(vtt + swz(d, m)) =
        make_uint4(pack_bf16(vs[m][d], vs[m + 1][d]), pack_bf16(vs[m + 2][d], vs[m + 3][d]),
                   pack_bf16(vs[m + 4][d], vs[m + 5][d]), pack_bf16(vs[m + 6][d], vs[m + 7][d]));
  }
}

// A persistent CTA walks items w = blockIdx.x, + gridDim.x, ...: item w is
// gene tile w / (H * n_chunks), head (w / n_chunks) % H, cells chunk *
// kBatch.. of chunk w % n_chunks, so the CTAs running together share a few
// gene tiles' qp rows and every cell's k and v in L2. Its (cell, head) tiles
// stream through the ring in the order the items give them.
__global__ void __launch_bounds__(kThreads, 2)
flash_cross_fwd(const float* __restrict__ qp, const __nv_bfloat16* __restrict__ kb,
                const __nv_bfloat16* __restrict__ vt, float* __restrict__ y, int G, int B, int H,
                float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][k_h, v_h^T][kTile]
  float* ystage = reinterpret_cast<float*>(smem + kSmemKV);      // [warp][2][kYTile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kSmemKV + kSmemY);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);

  const int E = H * kHd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' group and thread in group
  const int n_chunks = (B + kBatch - 1) / kBatch;
  const int n_items = (G + kRows - 1) / kRows * H * n_chunks;

  // thread 0's cursor over the CTA's (item, cell) tiles: fills the next one
  // into stage c % kStages, the c-th tile of the CTA
  int pw = blockIdx.x, pbi = 0;
  auto fill_next = [&](int c) {
    const int chunk = pw % n_chunks, h = pw / n_chunks % H;
    const size_t bh = (size_t)(chunk * kBatch + pbi) * H + h;
    const int s = c % kStages;
    const uint32_t bar = full0 + 8 * s;
    mbar_expect_tx(bar, 2 * kTileBytes);
    bulk_load(smem_u32(ring + 2 * s * kTile), kb + bh * kTile, kTileBytes, bar);
    bulk_load(smem_u32(ring + (2 * s + 1) * kTile), vt + bh * kTile, kTileBytes, bar);
    if (++pbi == min(kBatch, B - chunk * kBatch)) pbi = 0, pw += gridDim.x;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int c = 0; c < kStages && pw < n_items; ++c) fill_next(c);

  // this lane's ldmatrix row: matrix q = lane / 8 of an x4 load is n-tile
  // 2jp + q / 2, 16-byte chunk 2kk + q % 2 of a swizzled tile
  const int lq = lane >> 3, lr = lane & 7;
  const uint32_t lrow = (uint32_t)(8 * (lq >> 1) + lr) * 128;
  uint32_t lchunk[kHd / 16];
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) lchunk[kk] = (uint32_t)(((2 * kk + (lq & 1)) ^ lr) << 4);

  uint32_t qa[kTilesPerWarp][kHd / 16][4];  // qp_h rows of the warp, A fragments
  int ybuf = 0;                               // the warp's staging tile to fill next
  int c = 0;                                  // the CTA's tiles consumed
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int chunk = w % n_chunks, h = w / n_chunks % H, gt = w / (n_chunks * H);
    const int b0 = chunk * kBatch, bn = min(kBatch, B - b0);
    const int row0 = gt * kRows + warp * 16 * kTilesPerWarp;
    {
      const float* qh = qp + h * kHd + 2 * tq;
      const float2 zero = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int mt = 0; mt < kTilesPerWarp; ++mt) {
        const int ra = row0 + 16 * mt + gq, rb = ra + 8;
        const bool va = ra < G, vb = rb < G;
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          const int col = 16 * kk;
          const float2 x0 = va ? *reinterpret_cast<const float2*>(qh + (size_t)ra * E + col) : zero;
          const float2 x1 = vb ? *reinterpret_cast<const float2*>(qh + (size_t)rb * E + col) : zero;
          const float2 x2 =
              va ? *reinterpret_cast<const float2*>(qh + (size_t)ra * E + col + 8) : zero;
          const float2 x3 =
              vb ? *reinterpret_cast<const float2*>(qh + (size_t)rb * E + col + 8) : zero;
          qa[mt][kk][0] = pack_bf16(x0.x, x0.y);
          qa[mt][kk][1] = pack_bf16(x1.x, x1.y);
          qa[mt][kk][2] = pack_bf16(x2.x, x2.y);
          qa[mt][kk][3] = pack_bf16(x3.x, x3.y);
        }
      }
    }

    for (int bi = 0; bi < bn; ++bi, ++c) {
      const int s = c % kStages;
      mbar_wait(full0 + 8 * s, (c / kStages) & 1);
      const uint32_t ks = smem_u32(ring + 2 * s * kTile) + lrow;
      const uint32_t vs = ks + kTileBytes;
      float* yrow = y + (size_t)(b0 + bi) * G * E + h * kHd;

#pragma unroll
      for (int mt = 0; mt < kTilesPerWarp; ++mt) {
        // scores: 8 tiles of 8 keys; sc[j][0..1] row gq, sc[j][2..3] row
        // gq + 8, keys 8j + 2tq and 8j + 2tq + 1
        float sc[kM / 8][4];
#pragma unroll
        for (int j = 0; j < kM / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk)
#pragma unroll
          for (int jp = 0; jp < kM / 16; ++jp) {
            uint32_t b[4];
            ldsm_x4(ks + jp * 2048 + lchunk[kk], b);
            mma_bf16(sc[2 * jp], qa[mt][kk], b[0], b[1]);
            mma_bf16(sc[2 * jp + 1], qa[mt][kk], b[2], b[3]);
          }

        // the softmax of the lane's two rows: exp((s - max) / sqrt(hd)), the
        // sum over the quad, then p = e / sum
        float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
        for (int j = 0; j < kM / 8; ++j) {
          ma = fmaxf(ma, fmaxf(sc[j][0], sc[j][1]));
          mb = fmaxf(mb, fmaxf(sc[j][2], sc[j][3]));
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
        }
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int j = 0; j < kM / 8; ++j) {
          sc[j][0] = exp2f((sc[j][0] - ma) * scale_log2);
          sc[j][1] = exp2f((sc[j][1] - ma) * scale_log2);
          sc[j][2] = exp2f((sc[j][2] - mb) * scale_log2);
          sc[j][3] = exp2f((sc[j][3] - mb) * scale_log2);
          sa += sc[j][0] + sc[j][1];
          sb += sc[j][2] + sc[j][3];
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, o);
          sb += __shfl_xor_sync(0xffffffffu, sb, o);
        }
        const float ia = 1.0f / sa, ib = 1.0f / sb;

        // p in bf16, laid out as the A fragments of p @ v: key chunk kk is
        // score tiles 2kk and 2kk + 1
        uint32_t pa[kM / 16][4];
#pragma unroll
        for (int kk = 0; kk < kM / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[2 * kk][0] * ia, sc[2 * kk][1] * ia);
          pa[kk][1] = pack_bf16(sc[2 * kk][2] * ib, sc[2 * kk][3] * ib);
          pa[kk][2] = pack_bf16(sc[2 * kk + 1][0] * ia, sc[2 * kk + 1][1] * ia);
          pa[kk][3] = pack_bf16(sc[2 * kk + 1][2] * ib, sc[2 * kk + 1][3] * ib);
        }

        // y = p v: 8 tiles of 8 columns of the head
        float o[kHd / 8][4];
#pragma unroll
        for (int j = 0; j < kHd / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
          for (int jp = 0; jp < kHd / 16; ++jp) {
            uint32_t b[4];
            ldsm_x4(vs + jp * 2048 + lchunk[kk], b);
            mma_bf16(o[2 * jp], pa[kk], b[0], b[1]);
            mma_bf16(o[2 * jp + 1], pa[kk], b[2], b[3]);
          }

        // y through the warp's staging tile: wait until the store that last
        // read it is done reading, write it, hand it to the bulk copies
        float* yt = ystage + (warp * 2 + ybuf) * kYTile;
        bulk_wait_read_1();
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kHd / 8; ++j) {
          *reinterpret_cast<float2*>(yt + gq * kYLd + 8 * j + 2 * tq) =
              make_float2(o[j][0], o[j][1]);
          *reinterpret_cast<float2*>(yt + (gq + 8) * kYLd + 8 * j + 2 * tq) =
              make_float2(o[j][2], o[j][3]);
        }
        // the stage is released only here, after the staging stores that
        // consume the last ldmatrix's data: released right after that
        // ldmatrix, a refill overwrote tiles still being read (seen on the card)
        if (mt == kTilesPerWarp - 1) mbar_arrive(empty0 + 8 * s);
        fence_async_shared();
        __syncwarp();
        if (lane < 16) {
          const int r = row0 + 16 * mt + lane;
          if (r < G) bulk_store(yrow + (size_t)r * E, smem_u32(yt + lane * kYLd), kHd * 4);
          bulk_commit();
        }
        ybuf ^= 1;
      }

      // refill the stage just read with the CTA's tile kStages ahead, once
      // every thread has released it
      if (threadIdx.x == 0 && pw < n_items) {
        mbar_wait(empty0 + 8 * s, (c / kStages) & 1);
        fill_next(c + kStages);
      }
      __syncwarp();  // warp 0 whole again before the next tile's mma.sync
    }
  }
  bulk_wait_all();  // every store has landed before the CTA's shared memory goes
}

// The dynamic shared memory the kernel is already allowed, per device: the
// attribute is set only the first time it launches there.
constexpr int kMaxDevices = 64;

}  // namespace

extern "C" {

// Launches the flash cross-attention forward on `stream`, on the current
// device: round_kv, then flash_cross_fwd. qp (G, E), k and v (B, M, E) and y
// (B, G, E) are contiguous f32; `workspace` holds 2*B*M*E bf16 (the rounded
// k and the rounded, transposed v, swizzled). Returns the first CUDA error
// code (0 on success; cudaErrorInvalidValue for M or E / H other than 64).
// Allocates nothing and does not synchronise.
int scldm_flash_cross_forward(const void* qp, const void* k, const void* v, void* y,
                              void* workspace, int G, int B, int M, int E, int H, void* stream) {
  if (M != kM || E != H * kHd) return (int)cudaErrorInvalidValue;
  if (G == 0 || B == 0) return 0;
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !allowed[dev].load()) {
    err = cudaFuncSetAttribute(flash_cross_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) allowed[dev].store(true);
  }
  cudaStream_t s = (cudaStream_t)stream;
  __nv_bfloat16* kb = (__nv_bfloat16*)workspace;
  __nv_bfloat16* vt = kb + (size_t)B * M * E;
  round_kv<<<B * H, 256, 0, s>>>((const float*)k, (const float*)v, kb, vt, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)(G + kRows - 1) / kRows * H * ((B + kBatch - 1) / kBatch);
  const int grid = (int)(items < 2LL * sms ? items : 2LL * sms);  // two CTAs an SM
  flash_cross_fwd<<<grid, kThreads, kSmem, s>>>((const float*)qp, kb, vt, (float*)y, G, B, H,
                                                1.4426950408889634f / sqrtf((float)kHd));
  return (int)cudaGetLastError();
}

}  // extern "C"
