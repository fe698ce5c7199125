// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 reduce, cast to x's type.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py `rmsnorm`
// (`_rmsnorm_kernel`).  Bound by bytes: one read of x and one write of y
// (plus D floats of scale), a handful of operations per element.  Design:
// one block per row, the threads striding the row so neighbouring threads
// read neighbouring addresses; a warp-shuffle reduction then one across the
// warps through shared memory.  Any row count and any D: no padding of the
// rows to a block multiple as the Pallas grid needed.
#include "common.cuh"

namespace {

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               T* __restrict__ y, int D, long long x_row_stride,
                               long long y_row_stride, float eps) {
  using namespace avec;
  const T* xr = x + (long long)blockIdx.x * x_row_stride;
  T* yr = y + (long long)blockIdx.x * y_row_stride;
  float* partial = avec_smem;  // one float per warp

  float ss = 0.f;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const float v = to_float(xr[j]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) partial[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / (float)D + eps);
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    yr[j] = from_float<T>(to_float(xr[j]) * r * scale[j]);
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* y, long long rows, int D,
           long long xs, long long ys, float eps, cudaStream_t stream) {
  const int threads = D >= 256 ? 256 : ((D + 31) / 32) * 32;
  const size_t smem = 32 * sizeof(float);
  rmsnorm_kernel<T><<<(unsigned)rows, threads, smem, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(y), D, xs, ys, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int avec_rmsnorm(const void* x, const void* scale, void* y, int dtype,
                            long long rows, int D, long long x_row_stride,
                            long long y_row_stride, float eps, void* stream) {
  if (rows == 0) return 0;
  if (D <= 0 || rows > 0x7fffffffLL) return avec::kUnsupported;
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  switch (dtype) {
    case avec::kF32:
      return launch<float>(x, sc, y, rows, D, x_row_stride, y_row_stride, eps, s);
    case avec::kBF16:
      return launch<__nv_bfloat16>(x, sc, y, rows, D, x_row_stride, y_row_stride, eps, s);
    default:
      return avec::kUnsupported;
  }
}
