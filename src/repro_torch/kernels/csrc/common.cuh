// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads f32 or bf16, accumulates in fp32, launches on the stream
// it is given, and each C entry point returns the cudaGetLastError() right
// after its launch (or -1 for arguments it does not take), which the Python
// wrapper turns into an exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avec {

enum DType : int { kF32 = 0, kBF16 = 1 };

// masked score, as in the reference (finite, so exp(masked - max) is 0 and
// never NaN)
constexpr float kNegInf = -1e30f;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kUnsupported = -1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max that propagates NaN, as torch.amax and jnp.max do (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Raise the dynamic shared-memory limit of `kernel` when `bytes` needs more
// than the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace avec

// Dynamic shared memory of every kernel in the library (one symbol).
extern __shared__ float avec_smem[];
