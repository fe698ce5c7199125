// Per-row symmetric int8 quantization and its inverse.
//
//   quantize:   scale = max(absmax_row, 1e-12) / 127,  q = clip(rint(x / scale), -127, 127)
//   dequantize: out = (float)q * scale, cast to the output type
//
// Replaces the Pallas kernels src/repro/kernels/comm_quant.py `quantize_int8`
// (`_quant_kernel`) and `dequantize_int8` (`_dequant_kernel`).  Both are bound
// by bytes: quantize reads 4 B (fp32) or 2 B (bf16) and writes 1 B per
// element plus 4 B per row; dequantize reads 1 B and writes 4 B (or 2 B).
//
// Design: one warp per row, rows walked by a grid-stride loop (row counts
// reach millions, past any grid's y limit, and a row can be as narrow as
// 24).  Quantize makes two passes over its row: a shuffle max-reduction of
// |x| in fp32, then the row again (by then in L1/L2) to write q; lane 0
// writes the scale.  Loads are scalar and coalesced (a warp reads 32
// neighbouring elements), so any width and any row start work.
//
// The contract is bit-exactness with the plain version: IEEE division
// (x / scale, never x * (1 / scale)), round half to even (rintf), the scale
// computed in fp32, and no --use_fast_math.  bf16 input is read directly:
// its conversion to fp32 is exact, so q and scale equal those of the fp32
// copy the JAX package quantizes.
//
// Non-finite input behaves as in the plain version: a NaN in a row makes
// its absmax and scale NaN (max_nan, not fmaxf), an Inf makes the scale Inf,
// and a NaN quotient (x / NaN, Inf / Inf) gives q = 0, what the JAX
// package's and the plain version's casts of NaN to int8 give on the CPU.  Such a row dequantizes to NaN, so a
// non-finite gradient stays non-finite through the compressed exchange.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM at most

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                float* __restrict__ scale, long long rows, int D,
                                long long x_row_stride, long long q_row_stride) {
  using namespace avec;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); r < rows;
       r += warps) {
    const T* xr = x + r * x_row_stride;
    int8_t* qr = q + r * q_row_stride;
    float m = 0.f;
    for (int j = lane; j < D; j += 32) m = max_nan(m, fabsf(to_float(xr[j])));
    m = warp_max(m);
    const float s = max_nan(m, 1e-12f) / 127.0f;
    for (int j = lane; j < D; j += 32) {
      const float v = rintf(to_float(xr[j]) / s);
      qr[j] = v != v ? (int8_t)0 : (int8_t)fminf(fmaxf(v, -127.f), 127.f);
    }
    if (lane == 0) scale[r] = s;
  }
}

template <typename T>
__global__ void dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                                  T* __restrict__ out, long long rows, int D,
                                  long long q_row_stride, long long out_row_stride) {
  using namespace avec;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); r < rows;
       r += warps) {
    const int8_t* qr = q + r * q_row_stride;
    T* orow = out + r * out_row_stride;
    const float s = scale[r];
    // four independent loads in flight per lane before the stores
    int j = lane;
    for (; j + 96 < D; j += 128) {
      const int8_t a = qr[j], b = qr[j + 32], c = qr[j + 64], d = qr[j + 96];
      orow[j] = from_float<T>((float)a * s);
      orow[j + 32] = from_float<T>((float)b * s);
      orow[j + 64] = from_float<T>((float)c * s);
      orow[j + 96] = from_float<T>((float)d * s);
    }
    for (; j < D; j += 32) orow[j] = from_float<T>((float)qr[j] * s);
  }
}

unsigned grid_for(long long rows) {
  const long long want = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

extern "C" int avec_quantize_int8(const void* x, void* q, void* scale, int dtype,
                                  long long rows, int D, long long x_row_stride,
                                  long long q_row_stride, void* stream) {
  if (rows == 0 || D == 0) return 0;
  if (D < 0 || rows < 0) return avec::kUnsupported;
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<int8_t*>(q);
  auto sp = static_cast<float*>(scale);
  switch (dtype) {
    case avec::kF32:
      quantize_kernel<float><<<grid_for(rows), kThreads, 0, s>>>(
          static_cast<const float*>(x), qp, sp, rows, D, x_row_stride, q_row_stride);
      break;
    case avec::kBF16:
      quantize_kernel<__nv_bfloat16><<<grid_for(rows), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), qp, sp, rows, D, x_row_stride, q_row_stride);
      break;
    default:
      return avec::kUnsupported;
  }
  return (int)cudaGetLastError();
}

extern "C" int avec_dequantize_int8(const void* q, const void* scale, void* out, int out_dtype,
                                    long long rows, int D, long long q_row_stride,
                                    long long out_row_stride, void* stream) {
  if (rows == 0 || D == 0) return 0;
  if (D < 0 || rows < 0) return avec::kUnsupported;
  auto s = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const int8_t*>(q);
  auto sp = static_cast<const float*>(scale);
  switch (out_dtype) {
    case avec::kF32:
      dequantize_kernel<float><<<grid_for(rows), kThreads, 0, s>>>(
          qp, sp, static_cast<float*>(out), rows, D, q_row_stride, out_row_stride);
      break;
    case avec::kBF16:
      dequantize_kernel<__nv_bfloat16><<<grid_for(rows), kThreads, 0, s>>>(
          qp, sp, static_cast<__nv_bfloat16*>(out), rows, D, q_row_stride, out_row_stride);
      break;
    default:
      return avec::kUnsupported;
  }
  return (int)cudaGetLastError();
}
