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
// the tensor cores idle. So this design (namespace `tiled`, in dit_tiled.cuh,
// which the backward dit_block_bwd.cu shares; nine launches, every
// intermediate in a device workspace of R*6E + R*T*(5E + Hd) floats):
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

#include "dit_tiled.cuh"

// the long-axis flash attention (flash_attention.cu), which the attention
// stage takes where each DiT row fills whole query tiles
extern "C" int scldm_flash_attention_forward(const void* q, const void* k, const void* v,
                                             void* out, int B, int M, int S, int H, int D,
                                             long long qsb, long long qss, long long qsh,
                                             long long ksb, long long kss, long long ksh,
                                             long long vsb, long long vss, long long vsh,
                                             int bf16, void* stream);

namespace {

// From this T on, the attention stage launches the long-axis flash attention
// kernel on qkv's (R, T, H, hd) views: 0.8363 against 0.9248 ms for the block
// at T = 1,024, R = 12 and 0.1529 against 0.1592 at T = 256, R = 8; at T =
// 64 it lost, 0.2157 against 0.1940 at R = 48 (chip run on an H100 80GB HBM3
// at 700 W). Below it `tiled::attention`, whose tiles span DiT rows, runs.
constexpr int kFlashMinT = 128;

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
  using tiled::launch_gemm;
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
  if ((err = tiled::launch_silu(c, x1, R * E, s)) != cudaSuccess) return err;
  g.a = x1; g.w0 = wada; g.bias = bada; g.out = mod; g.M = R; g.K = E; g.N = 6 * E; g.T = 1;
  if ((err = launch_gemm<Out::kBias>(g, s)) != cudaSuccess) return err;
  // qkv = (LN(x) (1 + scale_a) + shift_a) wqkv + bqkv, over the tokens
  if ((err = tiled::launch_ln(x, mod, hatt, N, T, E, 0, E, eps, s)) != cudaSuccess) return err;
  g.a = hatt; g.w0 = wqkv; g.bias = bqkv; g.out = qkv; g.M = N; g.N = 3 * E; g.T = T;
  if ((err = launch_gemm<Out::kBias>(g, s)) != cudaSuccess) return err;
  if (T >= kFlashMinT) {  // q, k and v as (R, T, H, hd) views of qkv
    const long long E3 = 3LL * E, row = E3 * T;
    err = (cudaError_t)scldm_flash_attention_forward(qkv, qkv + E, qkv + 2 * E, hatt, R, T, T, H,
                                                     hd, row, E3, hd, row, E3, hd, row, E3, hd, 0,
                                                     s);
  } else {
    err = tiled::launch_attention(qkv, hatt, nullptr, N, T, E, H, s);
  }
  if (err != cudaSuccess) return err;
  // x1 = x + gate_a (att wproj + bproj)
  g.a = hatt; g.w0 = wproj; g.bias = bproj; g.resid = x; g.out = x1; g.N = E; g.gate = 2 * E;
  if ((err = launch_gemm<Out::kGatedBias>(g, s)) != cudaSuccess) return err;
  // hid = silu(h2 w1) * (h2 w2), h2 = LN(x1) (1 + scale_m) + shift_m
  if ((err = tiled::launch_ln(x1, mod, h2, N, T, E, 3 * E, 4 * E, eps, s)) != cudaSuccess)
    return err;
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
