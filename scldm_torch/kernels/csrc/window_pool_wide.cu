// The VAE encoder's MCAB pooling over the packed (B, S, E) token window at
// wide embeddings (E = 256 or 512, head width 64, up to 64 inducing points),
// forward and recompute backward. bf16 operands, f32 accumulation.
//
// Replaces the TPU kernels scldm_tpu/ops/fused_encoder.py::fused_window_pool
// (Pallas body `_wfwd_kernel`) and `_wfused_bwd` (`_wbwd_kernel`) at the
// widths where encoder_pool.cu's design (one CTA per cell, E = 32 and Q*H = 64
// in its thread maps) does not reach: the census encoder, E = 512 with 8 cross
// heads over 64 inducing points. The math is that of encoder_pool.cu and of
// `window_pool_reference` in scldm_torch/ops/fused_encoder.py; with bf() a
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
// 134 MB of emb read; the backward about three times that.
//
// What the design does about it. The work is split into kernels, each with
// enough CTAs for 132 SMs, handing their results on through a workspace:
//  1. prep_weights: W = [bf(wk) | bf(wv)] (E, 2E).
//  2. ln_rows: bf(x2) (N, E) for the N = B*S tokens, one warp per token, and
//     each token's mean and 1/sqrt(var + eps).
//  3. The k/v projection KV = bf(x2) @ W (N, 2E), the register-tiled SGEMM of
//     sgemm_tile.cuh (exact on bf16-rounded operands: the products are exact
//     in f32). W (2 MB at census) stays in L2; only its K-slices are staged.
//  4. attn_fwd: a CTA per (cell, head, split of at most 512 tokens), so 1,024
//     CTAs at census rather than one per cell. It stages head h's 64 x 64
//     query block once, then per tile of 64 tokens the tile's bf(k) and bf(v)
//     of head h, takes the 64 x 64 scores, the online-max softmax (each
//     exponential rounded against the running max, as encoder_pool.cu does)
//     and the pooled values in 4 x 4 register tiles, and writes the split's
//     (m, den, num) partial.
//  5. attn_merge: per (cell, head, query) the splits' partials rescaled to the
//     largest m and added in split order, without atomics; m is the true row
//     max, which the backward recomputes from.
// The backward runs 1-3 again (the forward saves nothing but m), then:
//  6. attn_bwd: a CTA per (cell, head, 256 tokens), tiles of 64: recomputes
//     the scores and exponentials given m, writes bf(dk) and bf(dv) of its
//     tokens to DKV (N, 2E) and its partial of dq (64 x 64) to a workspace;
//  7. sum_dq: the dq partials added in a fixed order into dqfull's head
//     blocks;
//  8. dx2_kernel: dx2 = bf(dk bf(wk)^T) + bf(dv bf(wv)^T), the SGEMM main loop
//     over each half of DKV's columns, rounded per half;
//  9. ln_bwd: demb through the LayerNorm, one warp per token, and per CTA of
//     64 tokens a partial of (dln1g, dln1b), added in order by sum_parts;
// 10. dW = bf(x2)^T DKV (E, 2E) as split-K SGEMM partials over the N tokens,
//     added in order by sum_parts.
// No atomics anywhere: the sums do not depend on the run. The caller rounds
// the reduced gradients of qfull, wk and wv to bf16 after the whole sum.
// Products run in f32 FMA on bf16-rounded operands; tensor cores (mma.sync
// bf16 computes the same function) and TMA are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

#include "sgemm_tile.cuh"

namespace {

constexpr int kHD = 64;            // head width
constexpr int kQmax = 64;          // inducing points a CTA holds
constexpr int kTT = 64;            // tokens per tile of the attention kernels
constexpr int kTile2 = kTT * kHD;  // floats of a 64 x 64 tile
constexpr int kSplitTokens = 512;  // forward: tokens per CTA at most
constexpr int kBwdTokens = 256;    // backward: tokens per CTA
constexpr int kLnTokens = 64;      // LayerNorm backward: tokens per CTA
constexpr int kNT = 256;           // threads of the attention and LayerNorm kernels
constexpr int kPart = kTile2 + 2 * kQmax;  // a forward partial: m, den, num
constexpr int kFwdSmemFloats = 4 * kTile2 + 3 * kQmax;
constexpr int kBwdSmemFloats = 8 * kTile2 + 2 * kQmax;
static_assert(kQmax * 4 == kNT && kTT == 64 && kHD == 64, "the thread maps assume 64 x 64 tiles");

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 bf4(float4 v) {
  return make_float4(bf(v.x), bf(v.y), bf(v.z), bf(v.w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[a][c] += sum over k < 64 of A(ty*4 + a, k) * B(k, tx*4 + c) for the
// 64 x 64 shared-memory tiles A and B (row stride 64, 16-byte aligned), with
// A(r, k) at A[r * 64 + k] or, kAKMajor, at A[k * 64 + r], and B(k, n) at
// B[k * 64 + n]. The 16 threads of a half-warp share ty: A's reads broadcast.
template <bool kAKMajor>
__device__ __forceinline__ void mm64(const float* A, const float* B, float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int k = 0; k < 64; k += 4) {
    float av[4][4];  // av[a][kk] = A(ty*4 + a, k + kk)
    if (kAKMajor) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v = *reinterpret_cast<const float4*>(A + (k + kk) * 64 + ty * 4);
        av[0][kk] = v.x;
        av[1][kk] = v.y;
        av[2][kk] = v.z;
        av[3][kk] = v.w;
      }
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 v = *reinterpret_cast<const float4*>(A + (ty * 4 + a) * 64 + k);
        av[a][0] = v.x;
        av[a][1] = v.y;
        av[a][2] = v.z;
        av[a][3] = v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(B + (k + kk) * 64 + tx * 4);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a][kk], bv[c], acc[a][c]);
    }
  }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// W = [bf(wk) | bf(wv)] (E, 2E), (in, out).
__global__ void prep_weights(const float* __restrict__ wk, const float* __restrict__ wv,
                             float* __restrict__ W, int E) {
  const long long n = 2LL * E * E;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i / (2 * E);
    const int o = (int)(i % (2 * E));
    W[i] = bf(o < E ? wk[e * E + o] : wv[e * E + o - E]);
  }
}

// bf(x2) (N, E) with x2 = LN(emb) * g + b, and each token's mean and rstd;
// one warp per token, E = 128 * kV (kV 16-byte vectors a lane).
template <int kV>
__global__ void __launch_bounds__(kNT)
ln_rows(const float* __restrict__ emb, const float* __restrict__ g, const float* __restrict__ b,
        float* __restrict__ X2, float* __restrict__ mean_out, float* __restrict__ rstd_out,
        long long N, float eps) {
  constexpr int E = 128 * kV;
  const long long t = (long long)blockIdx.x * (kNT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= N) return;
  const float* row = emb + t * E;
  float x[kV][4];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + j * 128 + lane * 4));
    x[j][0] = v.x;
    x[j][1] = v.y;
    x[j][2] = v.z;
    x[j][3] = v.w;
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(s) / E;
  float var = 0.0f;
#pragma unroll
  for (int j = 0; j < kV; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[j][c] -= mean;
      var = fmaf(x[j][c], x[j][c], var);
    }
  const float rstd = rsqrtf(warp_sum(var) / E + eps);
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int col = j * 128 + lane * 4;
    const float4 gv = __ldg(reinterpret_cast<const float4*>(g + col));
    const float4 bv = __ldg(reinterpret_cast<const float4*>(b + col));
    const float gg[4] = {gv.x, gv.y, gv.z, gv.w}, bb[4] = {bv.x, bv.y, bv.z, bv.w};
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = bf(__fadd_rn(__fmul_rn(x[j][c] * rstd, gg[c]), bb[c]));
    store4(X2 + t * E + col, o);
  }
  if (lane == 0) {
    mean_out[t] = mean;
    rstd_out[t] = rstd;
  }
}

// Head h's rows of KV for tokens t0 .. t0 + tn - 1 of cell b, rounded to
// bf16: k into Ks (64, 64) and v into Vs; rows past tn are 0.
__device__ __forceinline__ void stage_kv(const float* __restrict__ KV, long long row0, int tn,
                                         int E, int h, float* Ks, float* Vs) {
  for (int idx = threadIdx.x; idx < kTT * (kHD / 4); idx += kNT) {
    const int t = idx >> 4, d = (idx & 15) * 4;
    float4 k = make_float4(0.f, 0.f, 0.f, 0.f), v = k;
    if (t < tn) {
      const float* row = KV + (row0 + t) * 2LL * E + h * kHD + d;
      k = bf4(__ldg(reinterpret_cast<const float4*>(row)));
      v = bf4(__ldg(reinterpret_cast<const float4*>(row + E)));
    }
    *reinterpret_cast<float4*>(Ks + t * 64 + d) = k;
    *reinterpret_cast<float4*>(Vs + t * 64 + d) = v;
  }
}

// The forward's attention over one split of one (cell, head): grid (nsplit,
// H, B). Writes part[(b*H + h)*nsplit + z] = (m (64), den (64), num (64, 64)).
__global__ void __launch_bounds__(kNT) attn_fwd(const float* __restrict__ KV,
                                                const float* __restrict__ qfull,
                                                float* __restrict__ part, int S, int E, int H,
                                                int Q, int per_split, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;               // bf(q) of head h, transposed: Qt[d][i]
  float* Ks = Qt + kTile2;      // Ks[t][d]
  float* Vs = Ks + kTile2;      // Vs[t][d]
  float* P = Vs + kTile2;       // scores, then bf(e): P[t][i]
  float* mrun = P + kTile2;     // running max per query
  float* drun = mrun + kQmax;   // running den per query
  float* alph = drun + kQmax;   // this tile's rescale per query
  const int z = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int zs = z * per_split, ze = min(S, zs + per_split);
  for (int idx = tid; idx < kTile2; idx += kNT) {
    const int i = idx >> 6, d = idx & 63;
    Qt[d * 64 + i] = i < Q ? bf(qfull[(long long)(h * Q + i) * E + h * kHD + d]) : 0.0f;
  }
  if (tid < kQmax) {
    mrun[tid] = -INFINITY;
    drun[tid] = 0.0f;
  }
  float acc[4][4];  // num[i = ty*4 + a][d = tx*4 + c]
  zero4(acc);
  for (int t0 = zs; t0 < ze; t0 += kTT) {
    const int tn = min(kTT, ze - t0);
    __syncthreads();  // staged; the last tile's readers are done
    stage_kv(KV, (long long)b * S + t0, tn, E, h, Ks, Vs);
    __syncthreads();
    {
      float s[4][4];
      zero4(s);
      mm64<false>(Ks, Qt, s);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty * 4 + a;
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = t < tn ? s[a][c] * scale : -INFINITY;
        store4(P + t * 64 + tx * 4, o);
      }
    }
    __syncthreads();
    {  // online softmax: thread -> query i, part p over tokens p, p + 4, ...
      const int i = tid >> 2, p = tid & 3;
      float tmax = -INFINITY;
      for (int t = p; t < tn; t += 4) tmax = fmaxf(tmax, P[t * 64 + i]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mold = mrun[i];
      const float mnew = fmaxf(mold, tmax);
      float dsum = 0.0f;
      for (int t = p; t < kTT; t += 4) {
        const float e = t < tn ? expf(P[t * 64 + i] - mnew) : 0.0f;
        dsum += e;
        P[t * 64 + i] = bf(e);
      }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      __syncwarp();
      if (p == 0) {
        const float al = expf(mold - mnew);  // 0 on the first tile, where mold = -inf
        alph[i] = al;
        drun[i] = drun[i] * al + dsum;
        mrun[i] = mnew;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float al = alph[ty * 4 + a];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] *= al;
    }
    mm64<true>(P, Vs, acc);  // num[i][d] += sum_t bf(e)[t][i] bf(v)[t][d]
  }
  __syncthreads();
  float* out = part + ((long long)(b * H + h) * gridDim.x + z) * kPart;
  if (tid < kQmax) {
    out[tid] = mrun[tid];
    out[kQmax + tid] = drun[tid];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) store4(out + 2 * kQmax + (ty * 4 + a) * 64 + tx * 4, acc[a]);
}

// Per (cell, head), grid B * H: the splits' partials rescaled to the largest
// m and added in split order. num (B, Q, E); den and m (B, Q*H), row h*Q + i.
__global__ void __launch_bounds__(kNT) attn_merge(const float* __restrict__ part,
                                                  float* __restrict__ num, float* __restrict__ den,
                                                  float* __restrict__ m, int H, int Q, int E,
                                                  int nsplit) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float* pp = part + (long long)blockIdx.x * nsplit * kPart;
  for (int idx = threadIdx.x; idx < Q * kHD; idx += kNT) {
    const int i = idx >> 6, d = idx & 63;
    float M = -INFINITY;
    for (int z = 0; z < nsplit; ++z) M = fmaxf(M, pp[z * kPart + i]);
    float dn = 0.0f, nm = 0.0f;
    for (int z = 0; z < nsplit; ++z) {
      const float* q = pp + z * kPart;
      const float w = q[i] == -INFINITY ? 0.0f : expf(q[i] - M);  // an empty split adds 0
      dn = fmaf(w, q[kQmax + i], dn);
      nm = fmaf(w, q[2 * kQmax + i * 64 + d], nm);
    }
    num[((long long)b * Q + i) * E + h * kHD + d] = nm;
    if (d == 0) {
      const long long at = (long long)b * H * Q + h * Q + i;
      den[at] = dn;
      m[at] = M;
    }
  }
}

// The backward's attention over 256 tokens of one (cell, head), given m,
// dnum and dden: grid (nchunk, H, B). Writes bf(dk) and bf(dv) of its tokens
// into DKV (N, 2E) and its partial of dq (64, 64) into
// part_q[(b*nchunk + c)*H + h].
__global__ void __launch_bounds__(kNT) attn_bwd(const float* __restrict__ KV,
                                                const float* __restrict__ qfull,
                                                const float* __restrict__ mstat,
                                                const float* __restrict__ dnum,
                                                const float* __restrict__ dden,
                                                float* __restrict__ DKV, float* __restrict__ part_q,
                                                int S, int E, int H, int Q, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;              // Qt[d][i] = bf(q)
  float* Qr = Qt + kTile2;     // Qr[i][d] = bf(q)
  float* DN = Qr + kTile2;     // DN[i][d] = dnum
  float* DNt = DN + kTile2;    // DNt[d][i] = dnum
  float* Ks = DNt + kTile2;    // Ks[t][d] = bf(k)
  float* Vs = Ks + kTile2;     // Vs[t][d] = bf(v)
  float* P = Vs + kTile2;      // P[t][i] = bf(e)
  float* DS = P + kTile2;      // DS[t][i] = the scores' cotangent times scale
  float* Ms = DS + kTile2;     // m per query
  float* DDs = Ms + kQmax;     // dden per query
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int QH = Q * H;
  for (int idx = tid; idx < kTile2; idx += kNT) {
    const int i = idx >> 6, d = idx & 63;
    const float q = i < Q ? bf(qfull[(long long)(h * Q + i) * E + h * kHD + d]) : 0.0f;
    const float dn = i < Q ? dnum[((long long)b * Q + i) * E + h * kHD + d] : 0.0f;
    Qr[i * 64 + d] = q;
    Qt[d * 64 + i] = q;
    DN[i * 64 + d] = dn;
    DNt[d * 64 + i] = dn;
  }
  if (tid < kQmax) {
    const long long at = (long long)b * QH + h * Q + tid;
    Ms[tid] = tid < Q ? mstat[at] : 0.0f;
    DDs[tid] = tid < Q ? dden[at] : 0.0f;
  }
  float dq[4][4];  // dq[i = ty*4 + a][d = tx*4 + c]
  zero4(dq);
  const int cs = c * kBwdTokens, ce = min(S, cs + kBwdTokens);
  for (int t0 = cs; t0 < ce; t0 += kTT) {
    const int tn = min(kTT, ce - t0);
    __syncthreads();  // staged; the last tile's readers are done
    stage_kv(KV, (long long)b * S + t0, tn, E, h, Ks, Vs);
    __syncthreads();
    {  // exponentials and the scores' cotangents; a token past tn gives 0 to both
      float s[4][4], vd[4][4];
      zero4(s);
      zero4(vd);
      mm64<false>(Ks, Qt, s);    // s[t][i] = bf(k) . bf(q)
      mm64<false>(Vs, DNt, vd);  // vd[t][i] = bf(v) . dnum
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty * 4 + a;
        float pe[4], pd[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = tx * 4 + cc;
          const float e = t < tn ? expf(s[a][cc] * scale - Ms[i]) : 0.0f;
          pe[cc] = bf(e);
          pd[cc] = e * (bf(vd[a][cc]) + DDs[i]) * scale;
        }
        store4(P + t * 64 + tx * 4, pe);
        store4(DS + t * 64 + tx * 4, pd);
      }
    }
    __syncthreads();
    {
      float dv[4][4], dk[4][4];
      zero4(dv);
      zero4(dk);
      mm64<false>(P, DN, dv);   // dv[t][d] = sum_i bf(e)[t][i] dnum[i][d]
      mm64<false>(DS, Qr, dk);  // dk[t][d] = sum_i ds[t][i] bf(q)[i][d]
      mm64<true>(DS, Ks, dq);   // dq[i][d] += sum_t ds[t][i] bf(k)[t][d]
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = ty * 4 + a;
        if (t >= tn) continue;
        float* row = DKV + ((long long)b * S + t0 + t) * 2LL * E + h * kHD + tx * 4;
        float ok[4], ov[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          ok[cc] = bf(dk[a][cc]);
          ov[cc] = bf(dv[a][cc]);
        }
        store4(row, ok);
        store4(row + E, ov);
      }
    }
  }
  float* out = part_q + ((long long)(b * gridDim.x + c) * H + h) * kTile2;
#pragma unroll
  for (int a = 0; a < 4; ++a) store4(out + (ty * 4 + a) * 64 + tx * 4, dq[a]);
}

// dqfull's head blocks: dqfull[h*Q + i, h*64 + d] = sum over the nparts
// partials, in order.
__global__ void sum_dq(const float* __restrict__ part_q, int nparts, int H, int Q, int E,
                       float* __restrict__ dqfull) {
  const int n = H * Q * kHD;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += gridDim.x * blockDim.x) {
    const int h = idx / (Q * kHD), r = idx % (Q * kHD), i = r >> 6, d = r & 63;
    float v = 0.0f;
    for (int p = 0; p < nparts; ++p) v += part_q[((long long)p * H + h) * kTile2 + i * 64 + d];
    dqfull[(long long)(h * Q + i) * E + h * kHD + d] = v;
  }
}

// dx2 (N, E) = bf(dk @ bf(wk)^T) + bf(dv @ bf(wv)^T) with DKV = [dk | dv]
// (N, 2E) and W = [bf(wk) | bf(wv)] (E, 2E): the SGEMM main loop over each
// half of the 2E columns, rounded per half; a CTA per 128 x 128 tile.
__global__ void __launch_bounds__(sgemm::kThreads, 2) dx2_kernel(const float* __restrict__ DKV,
                                                                 const float* __restrict__ W,
                                                                 float* __restrict__ DX2, int N,
                                                                 int E) {
  __shared__ __align__(16) sgemm::Smem smem;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long m0 = (long long)blockIdx.y * sgemm::kTile;
  const long long n0 = (long long)blockIdx.x * sgemm::kTile;
  const long long E2 = 2LL * E;
  const sgemm::Operand<true> opa{DKV + m0 * E2, E2, N - m0};
  const sgemm::Operand<true> opb{W + n0 * E2, E2, E - n0};
  float acc[8][8];
  for (int half = 0; half < 2; ++half) {
    sgemm::zero(acc);
    sgemm::mainloop(opa, opb, half * (long long)E, (half + 1) * (long long)E, smem, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + sgemm::tile_row(ty, i);
      if (m >= N) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long n = n0 + sgemm::tile_col(tx, j);
        if (n >= E) continue;
        float* o = DX2 + m * E + n;
        *o = half ? *o + bf(acc[i][j]) : bf(acc[i][j]);
      }
    }
  }
}

// demb through the LayerNorm, one warp per token, given dx2 and the token's
// mean and rstd; per CTA of kLnTokens tokens the partial column sums of
// dx2 * xhat (dln1g) and dx2 (dln1b) into part_ln[blockIdx.x] (2E).
template <int kV>
__global__ void __launch_bounds__(kNT) ln_bwd(const float* __restrict__ emb,
                                              const float* __restrict__ DX2,
                                              const float* __restrict__ g,
                                              const float* __restrict__ mean,
                                              const float* __restrict__ rstd,
                                              float* __restrict__ demb,
                                              float* __restrict__ part_ln, long long N) {
  constexpr int E = 128 * kV;
  __shared__ __align__(16) float red[kNT / 32][2 * E];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float cg[kV][4], cb[kV][4];
#pragma unroll
  for (int j = 0; j < kV; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) cg[j][c] = cb[j][c] = 0.0f;
  const long long tile0 = (long long)blockIdx.x * kLnTokens;
  for (int k = warp; k < kLnTokens; k += kNT / 32) {
    const long long t = tile0 + k;
    if (t >= N) break;
    const float mu = mean[t], rs = rstd[t];
    float xh[kV][4], dxh[kV][4];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int col = j * 128 + lane * 4;
      const float4 xv = __ldg(reinterpret_cast<const float4*>(emb + t * E + col));
      const float4 dv = __ldg(reinterpret_cast<const float4*>(DX2 + t * E + col));
      const float4 gv = __ldg(reinterpret_cast<const float4*>(g + col));
      const float xx[4] = {xv.x, xv.y, xv.z, xv.w}, dd[4] = {dv.x, dv.y, dv.z, dv.w};
      const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        xh[j][c] = (xx[c] - mu) * rs;
        cg[j][c] = fmaf(dd[c], xh[j][c], cg[j][c]);
        cb[j][c] += dd[c];
        dxh[j][c] = dd[c] * gg[c];
        s1 += dxh[j][c];
        s2 = fmaf(dxh[j][c], xh[j][c], s2);
      }
    }
    const float m1 = warp_sum(s1) / E, m2 = warp_sum(s2) / E;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] = rs * (dxh[j][c] - m1 - xh[j][c] * m2);
      store4(demb + t * E + j * 128 + lane * 4, o);
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    store4(&red[warp][j * 128 + lane * 4], cg[j]);
    store4(&red[warp][E + j * 128 + lane * 4], cb[j]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * E; i += kNT) {
    float v = 0.0f;
    for (int w = 0; w < kNT / 32; ++w) v += red[w][i];
    part_ln[(long long)blockIdx.x * 2 * E + i] = v;
  }
}

// The dynamic shared memory each attention kernel is already allowed, per
// device: the attribute is set only when a launch needs more than before.
constexpr int kMaxDevices = 64;
std::atomic<long long> g_allowed[2][kMaxDevices];

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<long long>* allowed, long long bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= allowed[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev].store(bytes);
  return err;
}

using sgemm::cdiv;

bool supported(int S, int E, int H, int Q) {
  return S >= 1 && (E == 256 || E == 512) && E == H * kHD && Q >= 1 && Q <= kQmax;
}

// How the work is cut, from the shapes alone (so the sums' order is fixed).
struct Plan {
  long long N;                 // tokens, B * S
  int nsplit, per_split;       // forward: token splits per (cell, head)
  int nchunk;                  // backward: 256-token chunks per (cell, head)
  int ksplit;                  // backward: row slices of dW's partial sums
  long long k_per;             // rows per slice
  long long ln_tiles;          // backward: LayerNorm CTAs
  Plan(int B, int S) {
    N = (long long)B * S;
    nsplit = (int)cdiv(S, kSplitTokens);
    per_split = (int)(cdiv(cdiv(S, nsplit), kTT) * kTT);
    nchunk = (int)cdiv(S, kBwdTokens);
    ksplit = (int)(N < 4096 ? 1 : (N >= 16 * 4096 ? 16 : cdiv(N, 4096)));
    k_per = cdiv(cdiv(N, ksplit), sgemm::kBK) * sgemm::kBK;
    ln_tiles = cdiv(N, kLnTokens);
  }
};

// The workspace, in floats, in order: W (E, 2E), X2 (N, E), mean and rstd
// (N each), KV (N, 2E); then the forward's partials, or the backward's DKV
// (N, 2E), dq partials, dW partials and LayerNorm partials.
struct Workspace {
  float *W, *X2, *mean, *rstd, *KV, *part, *DKV, *part_q, *part_w, *part_ln;
  long long floats;
  Workspace(float* base, int B, int S, int E, int H, bool backward) {
    const Plan p(B, S);
    const long long E2 = 2LL * E;
    long long at = 0;
    auto take = [&](long long n) {
      float* r = base != nullptr ? base + at : nullptr;
      at += (n + 3) & ~3LL;  // keep every region 16-byte aligned
      return r;
    };
    W = take(E * E2);
    X2 = take(p.N * E);
    mean = take(p.N);
    rstd = take(p.N);
    KV = take(p.N * E2);
    part = DKV = part_q = part_w = part_ln = nullptr;
    if (!backward) {
      part = take((long long)B * H * p.nsplit * kPart);
    } else {
      DKV = take(p.N * E2);
      part_q = take((long long)B * p.nchunk * H * kTile2);
      part_w = take((long long)p.ksplit * E * E2);
      part_ln = take(p.ln_tiles * E2);
    }
    floats = at;
  }
};

// Steps 1-3, shared by both directions: W, bf(x2) with the token stats, KV.
template <int kV>
cudaError_t project(const float* emb, const float* ln1g, const float* ln1b, const float* wk,
                    const float* wv, const Workspace& ws, long long N, float eps, cudaStream_t s) {
  constexpr int E = 128 * kV;
  prep_weights<<<(unsigned)cdiv(2LL * E * E, 256), 256, 0, s>>>(wk, wv, ws.W, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_rows<kV><<<(unsigned)cdiv(N, kNT / 32), kNT, 0, s>>>(emb, ln1g, ln1b, ws.X2, ws.mean, ws.rstd,
                                                         N, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sgemm::gemm_kernel<false, false>
      <<<dim3((unsigned)cdiv(2 * E, sgemm::kTile), (unsigned)cdiv(N, sgemm::kTile), 1),
         sgemm::kThreads, 0, s>>>(ws.X2, E, ws.W, 2 * E, ws.KV, (int)N, 2 * E, E, E);
  return cudaGetLastError();
}

template <int kV>
int forward(const float* emb, const float* qfull, const float* ln1g, const float* ln1b,
            const float* wk, const float* wv, float* num, float* den, float* m, float* workspace,
            int B, int S, int H, int Q, float eps, float scale, cudaStream_t s) {
  constexpr int E = 128 * kV;
  const Plan p(B, S);
  const Workspace ws(workspace, B, S, E, H, false);
  cudaError_t err = project<kV>(emb, ln1g, ln1b, wk, wv, ws, p.N, eps, s);
  if (err != cudaSuccess) return (int)err;
  const long long smem = 4LL * kFwdSmemFloats;
  if ((err = allow_smem(attn_fwd, g_allowed[0], smem)) != cudaSuccess) return (int)err;
  attn_fwd<<<dim3(p.nsplit, H, B), kNT, (size_t)smem, s>>>(ws.KV, qfull, ws.part, S, E, H, Q,
                                                           p.per_split, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_merge<<<B * H, kNT, 0, s>>>(ws.part, num, den, m, H, Q, E, p.nsplit);
  return (int)cudaGetLastError();
}

template <int kV>
int backward(const float* emb, const float* qfull, const float* ln1g, const float* ln1b,
             const float* wk, const float* wv, const float* m, const float* dnum,
             const float* dden, float* demb, float* dqfull, float* dln, float* dw,
             float* workspace, int B, int S, int H, int Q, float eps, float scale,
             cudaStream_t s) {
  constexpr int E = 128 * kV;
  const Plan p(B, S);
  const Workspace ws(workspace, B, S, E, H, true);
  cudaError_t err = project<kV>(emb, ln1g, ln1b, wk, wv, ws, p.N, eps, s);
  if (err != cudaSuccess) return (int)err;
  const long long smem = 4LL * kBwdSmemFloats;
  if ((err = allow_smem(attn_bwd, g_allowed[1], smem)) != cudaSuccess) return (int)err;
  attn_bwd<<<dim3(p.nchunk, H, B), kNT, (size_t)smem, s>>>(ws.KV, qfull, m, dnum, dden, ws.DKV,
                                                          ws.part_q, S, E, H, Q, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_dq<<<(unsigned)cdiv(H * Q * kHD, 256), 256, 0, s>>>(ws.part_q, B * p.nchunk, H, Q, E,
                                                          dqfull);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dx2 goes where KV was: the attention backward, KV's last reader, is done
  float* DX2 = ws.KV;
  dx2_kernel<<<dim3((unsigned)cdiv(E, sgemm::kTile), (unsigned)cdiv(p.N, sgemm::kTile)),
               sgemm::kThreads, 0, s>>>(ws.DKV, ws.W, DX2, (int)p.N, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ln_bwd<kV><<<(unsigned)p.ln_tiles, kNT, 0, s>>>(emb, DX2, ln1g, ws.mean, ws.rstd, demb,
                                                  ws.part_ln, p.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = sgemm::sum_parts(ws.part_ln, (int)p.ln_tiles, 2 * E, dln, false, s)) != cudaSuccess)
    return (int)err;
  // dW's partials: (E, 2E) = bf(x2)^T (E, N) @ DKV (N, 2E), over ksplit token slices
  sgemm::gemm_kernel<true, false>
      <<<dim3((unsigned)cdiv(2 * E, sgemm::kTile), (unsigned)cdiv(E, sgemm::kTile), p.ksplit),
         sgemm::kThreads, 0, s>>>(ws.X2, E, ws.DKV, 2 * E, ws.part_w, E, 2 * E, p.N, p.k_per);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sgemm::sum_parts(ws.part_w, p.ksplit, 2LL * E * E, dw, false, s);
}

}  // namespace

extern "C" {

// Floats of the workspace of the forward (backward = 0) or the backward.
long long scldm_window_pool_wide_workspace_floats(int B, int S, int E, int H, int Q,
                                                  int backward) {
  if (!supported(S, E, H, Q)) return 0;
  return Workspace(nullptr, B, S, E, H, backward != 0).floats;
}

// Forward: num (B, Q, E), den and m (B, Q*H), f32, from emb (B, S, E), qfull
// (Q*H, E), ln1g, ln1b (E), wk, wv (E, E) (in, out), contiguous f32, with
// `workspace` (scldm_window_pool_wide_workspace_floats(..., 0) floats).
// Launches on `stream`, on the current device; returns the first CUDA error
// code (0 on success). Allocates nothing and does not synchronise.
int scldm_window_pool_wide_forward(const void* emb, const void* qfull, const void* ln1g,
                                   const void* ln1b, const void* wk, const void* wv, void* num,
                                   void* den, void* m, void* workspace, int B, int S, int E,
                                   int H, int Q, float eps, float scale, void* stream) {
  if (B == 0) return 0;
  if (!supported(S, E, H, Q)) return (int)cudaErrorInvalidValue;
  auto fn = E == 256 ? forward<2> : forward<4>;
  return fn((const float*)emb, (const float*)qfull, (const float*)ln1g, (const float*)ln1b,
            (const float*)wk, (const float*)wv, (float*)num, (float*)den, (float*)m,
            (float*)workspace, B, S, H, Q, eps, scale, (cudaStream_t)stream);
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
  if (B == 0) return (int)cudaErrorInvalidValue;
  if (!supported(S, E, H, Q)) return (int)cudaErrorInvalidValue;
  auto fn = E == 256 ? backward<2> : backward<4>;
  return fn((const float*)emb, (const float*)qfull, (const float*)ln1g, (const float*)ln1b,
            (const float*)wk, (const float*)wv, (const float*)m, (const float*)dnum,
            (const float*)dden, (float*)demb, (float*)dqfull, (float*)dln, (float*)dw,
            (float*)workspace, B, S, H, Q, eps, scale, (cudaStream_t)stream);
}

}  // extern "C"
