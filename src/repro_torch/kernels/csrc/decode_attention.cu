// Decode attention: one query token per sequence against its KV cache,
// masked past kv_len[b].
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// `decode_attention` (`_decode_kernel`).  Bound by bytes: it reads the
// first kv_len rows of K and V once, about 4*G flops per byte read.
// Design: one block per (KV head, batch row) serving all G grouped query
// heads, so each K/V row is read from device memory once for the whole
// group.  The block reads its own kv_len[b] and loops over tiles of 32 keys
// up to it (rows past kv_len are never read), staging K and V in shared
// memory as fp32; an online softmax keeps m / l per query head and the fp32
// accumulator in shared memory.  Strided (batch, head, sequence) addressing
// reads the model's (B,S_max,K,D) cache in place.  With few (b, kv-head)
// pairs this fills few SMs; a split-K pass over the sequence is later work.
#include "common.cuh"

namespace {

constexpr int TK = 32;   // keys per tile (one warp lane per key)
constexpr int NT = 128;  // threads per block
constexpr int MAX_G = 64;

struct Strides {
  long long b, h, s;
};

template <int D>
size_t smem_floats(int G) {
  return 2 * (size_t)G * D + TK * (2 * D + 1) + (size_t)G * TK + 3 * (size_t)G;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NT)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int* __restrict__ kv_len,
              TQ* __restrict__ o, int G, int S, float scale, Strides qs_, Strides ks_,
              Strides vs_, Strides os_) {
  using namespace avec;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = NT / 32;
  const int len = min(max(kv_len[b], 0), S);

  float* qsh = avec_smem;              // [G][D]
  float* acc = qsh + G * D;            // [G][D]
  float* ksh = acc + G * D;            // [TK][D+1]
  float* vsh = ksh + TK * (D + 1);     // [TK][D]
  float* psh = vsh + TK * D;           // [G][TK]
  float* msh = psh + G * TK;           // [G]
  float* lsh = msh + G;                // [G]
  float* ash = lsh + G;                // [G] rescale of this tile

  // q is (B,K,G,D): stride s steps over the G grouped heads
  const TQ* qb = q + b * qs_.b + h * qs_.h;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    qsh[i] = to_float(qb[g * qs_.s + d]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    msh[g] = kNegInf;
    lsh[g] = 0.f;
  }
  const TKV* kb = k + b * ks_.b + h * ks_.h;
  const TKV* vb = v + b * vs_.b + h * vs_.h;

  for (int t0 = 0; t0 < len; t0 += TK) {
    const int n = min(TK, len - t0);
    __syncthreads();  // q staged / previous tile fully consumed
    for (int i = tid; i < TK * D; i += NT) {
      const int t = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (t < n) {
        kv = to_float(kb[(t0 + t) * ks_.s + d]);
        vv = to_float(vb[(t0 + t) * vs_.s + d]);
      }
      ksh[t * (D + 1) + d] = kv;
      vsh[t * D + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < G * TK; i += NT) {
      const int g = i / TK, t = i % TK;
      float s = kNegInf;
      if (t < n) {
        const float* qrow = qsh + g * D;
        const float* krow = ksh + t * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += qrow[d] * krow[d];
        s = dot * scale;
      }
      psh[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NW) {  // one warp per query head, one lane per key
      const float s = psh[g * TK + lane];
      const float m_prev = msh[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      psh[g * TK + lane] = p;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        ash[g] = a;
        lsh[g] = lsh[g] * a + sum;
        msh[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i % D;
      const float* prow = psh + g * TK;
      float a = acc[i] * ash[g];
      for (int t = 0; t < n; ++t) a += prow[t] * vsh[t * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  TQ* ob = o + b * os_.b + h * os_.h;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    ob[g * os_.s + d] = from_float<TQ>(acc[i] / fmaxf(lsh[g], 1e-30f));
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len, void* o, int B,
           int K, int G, int S, float scale, Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>(G) * sizeof(float);
  auto kernel = decode_kernel<TQ, TKV, D>;
  cudaError_t err = avec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(K, B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                                     static_cast<const TKV*>(v), kv_len, static_cast<TQ*>(o),
                                     G, S, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_d(int D, const void* q, const void* k, const void* v, const int* kv_len,
               void* o, int B, int K, int G, int S, float scale, Strides qs, Strides ks,
               Strides vs, Strides os, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<TQ, TKV, 16>(q, k, v, kv_len, o, B, K, G, S, scale, qs, ks, vs, os, stream);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, kv_len, o, B, K, G, S, scale, qs, ks, vs, os, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, kv_len, o, B, K, G, S, scale, qs, ks, vs, os, stream);
    default:
      return avec::kUnsupported;
  }
}

template <typename TQ>
int dispatch_kv(int kv_dtype, int D, const void* q, const void* k, const void* v,
                const int* kv_len, void* o, int B, int K, int G, int S, float scale,
                Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  switch (kv_dtype) {
    case avec::kF32:
      return dispatch_d<TQ, float>(D, q, k, v, kv_len, o, B, K, G, S, scale, qs, ks, vs, os,
                                   stream);
    case avec::kBF16:
      return dispatch_d<TQ, __nv_bfloat16>(D, q, k, v, kv_len, o, B, K, G, S, scale, qs, ks,
                                           vs, os, stream);
    default:
      return avec::kUnsupported;
  }
}

}  // namespace

// q (B,K,G,D), k/v (B,K,S,D), kv_len (B,) int32, o (B,K,G,D); strides in
// elements, (batch, head, group) for q and o and (batch, head, seq) for k/v.
extern "C" int avec_decode_attention(const void* q, const void* k, const void* v,
                                     const void* kv_len, void* o, int q_dtype, int kv_dtype,
                                     int B, int K, int G, int S, int D, float scale,
                                     long long q_sb, long long q_sh, long long q_sg,
                                     long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss,
                                     long long o_sb, long long o_sh, long long o_sg,
                                     void* stream) {
  if (B == 0 || K == 0 || G == 0) return 0;
  if (G > MAX_G || B > 65535) return avec::kUnsupported;
  const Strides qs{q_sb, q_sh, q_sg}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_sg};
  auto lens = static_cast<const int*>(kv_len);
  auto s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case avec::kF32:
      return dispatch_kv<float>(kv_dtype, D, q, k, v, lens, o, B, K, G, S, scale, qs, ks, vs,
                                os, s);
    case avec::kBF16:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, D, q, k, v, lens, o, B, K, G, S, scale, qs,
                                        ks, vs, os, s);
    default:
      return avec::kUnsupported;
  }
}
