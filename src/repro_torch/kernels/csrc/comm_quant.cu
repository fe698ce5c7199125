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
// Quantize reads each row once, in 16-byte vectors (8 bf16 or 4 fp32 a
// load), all of a thread's loads issued before any arithmetic, and holds the
// row in registers as loaded (unpacked to fp32 once for the max and once for
// q, which keeps a bf16 thread at 47 registers, not 56: more blocks an SM,
// more bytes in flight).  The NaN-propagating max of |x| is reduced over the
// row's threads (shuffles, and one shared-memory step when a row spans
// warps), and q goes out from the registers as one 8-byte (bf16) or 4-byte
// (fp32) store per vector; the row's first thread writes the scale.  The
// host's plan (kernels/rowplan.py `row_plan`, shared with rmsnorm, with at
// least 4 vectors a thread: one a thread left a D 2048 bf16 row a third
// below the memory rate) sets the vectors a thread holds (PER), the threads
// per row (2 at D 64 bf16, 64 at D 2048, 256 at D 8192) and the rows per
// block (128, 4, 1).  Rows that do not lie on 16 bytes or a D that is not a
// multiple of the vector take a scalar loop in the same kernel (PER = 0),
// which reads the row twice.
//
// The contract is bit-exactness with the plain version: q = rint(x / scale)
// with the IEEE quotient, round half to even, the scale computed in fp32,
// no --use_fast_math.  bf16 input is read directly: its conversion to fp32
// is exact, so q and scale equal those of the fp32 copy the JAX package
// quantizes.  The epilogue keeps that without a division per element:
//
// * r = 1/scale once per row (correctly rounded), t = x * r per element.
//   |t - RN(x / scale)| <= 1.25 * 2^-16 for |x| <= absmax_row, so |t| < 128:
//   r and the product each add a relative error of at most 2^-24 (2^-16
//   absolute at |t| < 128), and RN(x / scale) lies within half an ulp
//   (2^-18) of x / scale.  Where t lies more than that from every k + 0.5,
//   t and RN(x / scale) are on the same side of it and round to the same
//   integer.  kTieGuard, 2^-12, is 12.8 times the bound: within it of a
//   half-integer the element takes the IEEE division (about 1 element in
//   2,000 of a uniform spread of t).
// * Rounding and conversion in one add: after the NaN test and the clamp,
//   c + 1.5 * 2^23 lies in [2^23, 2^24), where the fp32 ulp is 1, so the
//   add rounds c to an integer, half to even (1.5 * 2^23 is even), and the
//   sum's low byte is that integer as int8.  No rintf and no float-to-int
//   conversion, which issue at a quarter of the FMA rate.
//
// Non-finite input behaves as in the plain version: a NaN in a row makes
// its absmax and scale NaN (max.NaN, not fmaxf), an Inf makes the scale Inf,
// and a NaN quotient (x / NaN, Inf / Inf) gives q = 0, what the JAX
// package's and the plain version's casts of NaN to int8 give on the CPU.
// With r = 1/scale, an Inf scale gives r = 0 and a NaN scale r = NaN, so t
// is NaN exactly where x / scale is.  Such a row dequantizes to NaN, so a
// non-finite gradient stays non-finite through the compressed exchange.
//
// Dequantize: one warp per row, rows walked by a grid-stride loop, four
// independent loads in flight per lane.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM at most

constexpr float kRound = 12582912.0f;  // 1.5 * 2^23
constexpr float kTieGuard = 0x1p-12f;

// x -> a word whose low byte is q = clip(rint(x / s), -127, 127) (0 where
// x / s is NaN); r = 1/s, correctly rounded (the epilogue in the header)
__device__ __forceinline__ uint32_t quantize_one(float x, float s, float r) {
  float t = __fmul_rn(x, r);
  const float k = __fsub_rn(__fadd_rn(t, kRound), kRound);  // rint(t)
  if (fabsf(__fsub_rn(t, k)) >= 0.5f - kTieGuard) t = __fdiv_rn(x, s);
  const float c = t != t ? 0.f : fminf(fmaxf(t, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, kRound));
}

// the low bytes of a, b, c, d, in that order, as one word
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ float row_scale(float absmax) {
  return __fdiv_rn(avec::max_nan(absmax, 1e-12f), 127.0f);
}

// PER > 0: each thread holds PER vectors of the row; PER == 0: the scalar loop
template <typename T, int PER>
__global__ void quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                float* __restrict__ scale, long long rows, int D,
                                long long x_row_stride, long long q_row_stride, int tpr) {
  using namespace avec;
  constexpr int VEC = 16 / sizeof(T);
  const int rib = threadIdx.x / tpr, lane = threadIdx.x - rib * tpr;
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + rib;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * x_row_stride;
  int8_t* qr = q + (live ? row : 0) * q_row_stride;
  float m = 0.f;

  if constexpr (PER > 0) {
    const int nvec = D / VEC;
    // the PER loads go out before any use and with no branch around them (a
    // thread past the row's end, or of a dead row, reloads a vector of its
    // row or of row 0 and ignores it); the row stays as loaded and is
    // unpacked twice (the header says why)
    uint4 raw[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) raw[k] = load16(xr + min(lane + k * tpr, nvec - 1) * VEC);
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (live && lane + k * tpr < nvec) {
        float v[VEC];
        unpack16<T>(raw[k], v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) m = max_nan(m, fabsf(v[i]));
      }
    const float s = row_scale(row_reduce(m, tpr, avec_smem, MaxNan{}));
    const float r = __frcp_rn(s);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int vi = lane + k * tpr;
      if (live && vi < nvec) {
        float v[VEC];
        unpack16<T>(raw[k], v);
        uint32_t w[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) w[i] = quantize_one(v[i], s, r);
        if constexpr (VEC == 8)
          *reinterpret_cast<uint2*>(qr + vi * VEC) =
              make_uint2(low_bytes(w[0], w[1], w[2], w[3]), low_bytes(w[4], w[5], w[6], w[7]));
        else
          *reinterpret_cast<uint32_t*>(qr + vi * VEC) = low_bytes(w[0], w[1], w[2], w[3]);
      }
    }
    if (live && lane == 0) scale[row] = s;
  } else {
    if (live)
      for (int j = lane; j < D; j += tpr) m = max_nan(m, fabsf(to_float(xr[j])));
    const float s = row_scale(row_reduce(m, tpr, avec_smem, MaxNan{}));
    const float r = __frcp_rn(s);
    if (live)
      for (int j = lane; j < D; j += tpr)
        reinterpret_cast<uint8_t*>(qr)[j] = (uint8_t)quantize_one(to_float(xr[j]), s, r);
    if (live && lane == 0) scale[row] = s;
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

template <typename T>
int launch_quantize(const void* x, void* q, void* scale, long long rows, int D, long long xs,
                    long long qs, int per, int tpr, int rpb, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + rpb - 1) / rpb);
  const int threads = tpr * rpb;
  const size_t smem = (threads / 32 + 1) * sizeof(float);
  auto xp = static_cast<const T*>(x);
  auto qp = static_cast<int8_t*>(q);
  auto sp = static_cast<float*>(scale);
  return avec::with_per(per, [&](auto p) {
    quantize_kernel<T, decltype(p)::value><<<blocks, threads, smem, stream>>>(
        xp, qp, sp, rows, D, xs, qs, tpr);
    return (int)cudaGetLastError();
  });
}

unsigned grid_for(long long rows) {
  const long long want = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// per: 16-byte vectors a thread holds (1, 2, 4 or 8; 0 for the scalar loop,
// which any row takes), tpr: threads per row, rpb: rows per block
// (kernels/rowplan.py `row_plan`).  The vector path needs D a multiple of
// the vector, x rows on 16 bytes, q rows on the vector's bytes (8 for bf16,
// 4 for fp32), and per * tpr vectors covering the row.
extern "C" int avec_quantize_int8(const void* x, void* q, void* scale, int dtype,
                                  long long rows, int D, long long x_row_stride,
                                  long long q_row_stride, int per, int tpr, int rpb,
                                  void* stream) {
  if (rows == 0 || D == 0) return 0;
  const int size = dtype == avec::kF32 ? 4 : 2, vec = 16 / size;
  if (!avec::plan_supported(rows, D, per, tpr, rpb, vec)) return avec::kUnsupported;
  if (per > 0 && ((((uintptr_t)x | (uintptr_t)(x_row_stride * size)) % 16) != 0 ||
                  (((uintptr_t)q | (uintptr_t)q_row_stride) % vec) != 0))
    return avec::kUnsupported;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case avec::kF32:
      return launch_quantize<float>(x, q, scale, rows, D, x_row_stride, q_row_stride, per, tpr,
                                    rpb, s);
    case avec::kBF16:
      return launch_quantize<__nv_bfloat16>(x, q, scale, rows, D, x_row_stride, q_row_stride,
                                            per, tpr, rpb, s);
    default:
      return avec::kUnsupported;
  }
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
