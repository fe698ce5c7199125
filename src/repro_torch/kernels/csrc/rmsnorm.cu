// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 reduce, cast to x's type.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py `rmsnorm`
// (`_rmsnorm_kernel`).  Bound by bytes: one read of x and one write of y
// (plus D values of scale), a handful of operations per element: 0.63 us
// at granite-3-2b's prefill shape (x (2,128,2048) bf16) at 3.35 TB/s.
//
// The first design ran one block of up to 256 threads per row (2 blocks on
// the card at decode's 2 rows), read the row twice with 2-byte scalar
// loads and chained its reduction through two barriers.  This one reads
// the row once, in 16-byte vectors (8 bf16 or 4 fp32 a load), and holds it
// in registers: each of the row's threads holds PER such vectors, the sum
// of squares is reduced in fp32 by shuffles (and one shared-memory step
// when a row spans several warps), and the row is normalised from the
// registers and written back in 16-byte vectors.  Threads per row follow D
// (a power of two up to 32, or a multiple of 32: D 2048 bf16 takes 256
// threads, D 768 bf16 96), and a block packs as many rows as bring it to
// about 256 threads.  The scale is read in its own type (fp32 or bf16).
// Rows that do not lie on 16 bytes, or a D that is not a multiple of the
// vector, take a scalar loop in the same kernel (PER = 0), which reads the
// row twice.  The host (rmsnorm.py `rmsnorm_plan`) chooses PER, the
// threads per row and the rows per block (kernels/rowplan.py, shared with
// the int8 quantize); any row count and any D.
#include "common.cuh"

namespace {

// PER > 0: each thread holds PER vectors of the row; PER == 0: the scalar loop
template <typename T, typename TS, int PER>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                               T* __restrict__ y, long long rows, int D, long long x_row_stride,
                               long long y_row_stride, float eps, int tpr) {
  using namespace avec;
  constexpr int VEC = 16 / sizeof(T);
  const int rib = threadIdx.x / tpr, q = threadIdx.x - rib * tpr;
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + rib;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * x_row_stride;
  T* yr = y + (live ? row : 0) * y_row_stride;

  if constexpr (PER > 0) {
    const int nvec = D / VEC;
    float v[PER][VEC];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = q + k * tpr;
      if (live && vi < nvec) {
        load_vec<VEC>(xr + vi * VEC, v[k]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) ss += v[k][i] * v[k][i];
      }
    }
    const float r = rsqrtf(row_reduce(ss, tpr, avec_smem, Add{}) / (float)D + eps);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = q + k * tpr;
      if (live && vi < nvec) {
        float s[VEC];
        load_vec<VEC>(scale + vi * VEC, s);
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[i] = from_float<T>(v[k][i] * r * s[i]);
        *reinterpret_cast<uint4*>(yr + vi * VEC) = out;
      }
    }
  } else {
    float ss = 0.f;
    if (live)
      for (int j = q; j < D; j += tpr) {
        const float v = to_float(xr[j]);
        ss += v * v;
      }
    const float r = rsqrtf(row_reduce(ss, tpr, avec_smem, Add{}) / (float)D + eps);
    if (live)
      for (int j = q; j < D; j += tpr)
        yr[j] = from_float<T>(to_float(xr[j]) * r * to_float(scale[j]));
  }
}

template <typename T, typename TS>
int launch(const void* x, const void* scale, void* y, long long rows, int D, long long xs,
           long long ys, float eps, int per, int tpr, int rpb, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + rpb - 1) / rpb);
  const int threads = tpr * rpb;
  const size_t smem = (threads / 32 + 1) * sizeof(float);
  auto xp = static_cast<const T*>(x);
  auto sp = static_cast<const TS*>(scale);
  auto yp = static_cast<T*>(y);
  auto go = [&](auto kernel) {
    kernel<<<blocks, threads, smem, stream>>>(xp, sp, yp, rows, D, xs, ys, eps, tpr);
    return (int)cudaGetLastError();
  };
  return avec::with_per(per,
                        [&](auto p) { return go(rmsnorm_kernel<T, TS, decltype(p)::value>); });
}

template <typename T>
int dispatch_scale(int scale_dtype, const void* x, const void* scale, void* y, long long rows,
                   int D, long long xs, long long ys, float eps, int per, int tpr, int rpb,
                   cudaStream_t s) {
  switch (scale_dtype) {
    case avec::kF32:
      return launch<T, float>(x, scale, y, rows, D, xs, ys, eps, per, tpr, rpb, s);
    case avec::kBF16:
      return launch<T, __nv_bfloat16>(x, scale, y, rows, D, xs, ys, eps, per, tpr, rpb, s);
    default:
      return avec::kUnsupported;
  }
}

}  // namespace

// per: 16-byte vectors a thread holds (1, 2, 4 or 8; 0 for the scalar
// loop, which any row takes), tpr: threads per row, rpb: rows per block.
// The vector path needs D a multiple of the vector, x and y rows and the
// scale on 16 bytes, and per * tpr vectors covering the row.
extern "C" int avec_rmsnorm(const void* x, const void* scale, void* y, int dtype,
                            int scale_dtype, long long rows, int D, long long x_row_stride,
                            long long y_row_stride, float eps, int per, int tpr, int rpb,
                            void* stream) {
  if (rows == 0) return 0;
  if (!avec::plan_supported(rows, D, per, tpr, rpb, dtype == avec::kF32 ? 4 : 8))
    return avec::kUnsupported;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case avec::kF32:
      return dispatch_scale<float>(scale_dtype, x, scale, y, rows, D, x_row_stride,
                                   y_row_stride, eps, per, tpr, rpb, s);
    case avec::kBF16:
      return dispatch_scale<__nv_bfloat16>(scale_dtype, x, scale, y, rows, D, x_row_stride,
                                           y_row_stride, eps, per, tpr, rpb, s);
    default:
      return avec::kUnsupported;
  }
}
