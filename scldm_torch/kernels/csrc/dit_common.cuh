// Device helpers of the DiT block kernels (dit_tiled.cuh, dit_block.cu,
// dit_block_bwd.cu) and the whole-trunk kernels (fused_trunk.cu): silu,
// sigmoid, a warp sum and the dynamic shared memory allowance. The weight
// gradients of both backwards run on dit_tiled.cuh's tensor-core GEMM
// (`tiled::grad_gemm`).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <atomic>

namespace dit {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

}  // namespace dit
