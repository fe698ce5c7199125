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

#include <type_traits>

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

// max that propagates NaN, as torch.amax and jnp.max do (fmaxf drops it):
// one instruction (PTX max.NaN, sm_80 and later)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Row kernels that hold a row in registers (rmsnorm, the int8 quantize).
// The host's plan (kernels/rowplan.py `row_plan`) gives PER 16-byte vectors
// a thread (0: the kernel's scalar loop), tpr threads a row (a power of two
// up to 32, or a multiple of 32) and rpb rows a block.

// 16 bytes at p (one vector of a row), through the read-only path
__device__ __forceinline__ uint4 load16(const void* __restrict__ p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the VEC values of type T in 16 loaded bytes, as floats
template <typename T, int VEC>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&out)[VEC]) {
  static_assert(sizeof(T) * VEC == 16, "16 bytes");
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_float(v[i]);
}

// VEC consecutive values of type T at p (16 bytes of a row, or the matching
// span of a per-column vector of another type) as floats
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  if constexpr (sizeof(T) * VEC == 16) {
    unpack16<T>(load16(p), out);
  } else if constexpr (sizeof(T) * VEC == 32) {  // VEC fp32 values beside a bf16 row
    const uint4 r0 = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 r1 = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    const T* v0 = reinterpret_cast<const T*>(&r0);
    const T* v1 = reinterpret_cast<const T*>(&r1);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      out[i] = to_float(v0[i]);
      out[i + VEC / 2] = to_float(v1[i]);
    }
  } else {  // 8 bytes: VEC bf16 values beside an fp32 row
    static_assert(sizeof(T) * VEC == 8, "16-byte rows");
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_float(v[i]);
  }
}

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct MaxNan {
  __device__ __forceinline__ float operator()(float a, float b) const { return max_nan(a, b); }
};

// v reduced by op over the tpr threads of each row; `partial` holds a float
// per warp.  0 must be op's identity on the values reduced (a sum, or a max
// of |x|): the cross-warp step starts from it.
template <typename Op>
__device__ __forceinline__ float row_reduce(float v, int tpr, float* partial, Op op) {
  const int width = tpr < 32 ? tpr : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < width) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (tpr > 32) {  // uniform across the block
    const int warp = threadIdx.x >> 5, per_row = tpr >> 5;
    if ((threadIdx.x & 31) == 0) partial[warp] = v;
    __syncthreads();
    const int first = warp - warp % per_row;
    v = 0.f;
    for (int w = 0; w < per_row; ++w) v = op(v, partial[first + w]);
  }
  return v;
}

// The plan's checks, shared by the entry points: tpr's form, at most 1024
// threads a block in whole warps, a grid that fits, and for the vector path
// (per > 0) a D that is a multiple of the vector and covered by per * tpr
// vectors
inline bool plan_supported(long long rows, int D, int per, int tpr, int rpb, int vec) {
  const bool tpr_ok = tpr > 0 && ((tpr <= 32 && (tpr & (tpr - 1)) == 0) || tpr % 32 == 0);
  if (D <= 0 || rows < 0 || !tpr_ok || rpb <= 0 || tpr * rpb > 1024 || (tpr * rpb) % 32 != 0 ||
      (rows + rpb - 1) / rpb > 0x7fffffffLL)
    return false;
  return per == 0 || (D % vec == 0 && (long long)per * tpr * vec >= D);
}

// f(std::integral_constant<int, PER>{}) for the plan's per: 0, 1, 2, 4 or 8
template <typename F>
inline int with_per(int per, F&& f) {
  switch (per) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return kUnsupported;
  }
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
