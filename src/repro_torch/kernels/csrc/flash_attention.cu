// Flash attention forward (GQA), online softmax with fp32 m / l / acc.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// `flash_attention` (`_flash_kernel`).  Bound: at the main path's prompt
// lengths by bytes (q, k, v read once, o written once); the score and
// value products grow as Sq*Sk*D and pass the bytes only for long prompts.
// Design: one block per (query tile of 32 rows, head, batch row) -- the TPU
// grid's sequential KV axis becomes a loop inside the block, over K/V tiles
// of 32 keys staged in shared memory as fp32, which stops at the causal
// limit of the tile's last row.  Four threads share a query row: each owns
// 8 of the tile's scores and D/4 of the row's output columns, so the row's
// max and sum reduce with two shuffles.  The KV head is h / (H / K).  Ragged
// Sq / Sk tails are masked in the kernel (prompt lengths are arbitrary);
// every tensor is addressed through its (batch, head, sequence) strides,
// with a unit last stride, so the model's (B,S,H,D) layout needs no copy.
// This first version does its products on the CUDA cores; wgmma and TMA
// are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 32;   // query rows per block
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int NT = 128;  // threads: 4 per query row

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int H, int K, int Sq, int Sk, int causal, float scale,
             Strides qs_, Strides ks_, Strides vs_, Strides os_) {
  using namespace avec;
  static_assert(D % 4 == 0, "head_dim must be a multiple of 4");
  constexpr int DPT = D / 4;       // output columns per thread
  constexpr int SPT = BK / 4;      // scores per thread per tile

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int qi = q0 + r;

  float* qsh = avec_smem;                 // [BQ][D+1]
  float* ksh = qsh + BQ * (D + 1);        // [BK][D+1]
  float* vsh = ksh + BK * (D + 1);        // [BK][D]
  float* psh = vsh + BK * D;              // [BQ][BK+1]

  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + kvh * ks_.h;
  const T* vb = v + b * vs_.b + kvh * vs_.h;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i % D;
    const int row = q0 + rr;
    qsh[rr * (D + 1) + d] = row < Sq ? to_float(qb[row * qs_.s + d]) : 0.f;
  }

  // causal: row i sees key j <= i + (Sk - Sq); the tile's last row bounds the loop
  const int offset = Sk - Sq;
  int k_end = Sk;
  if (causal) {
    const int last_row = min(q0 + BQ, Sq) - 1;
    k_end = max(0, min(Sk, last_row + offset + 1));
  }

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // q staged / previous tile fully consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int t = i / D, d = i % D;
      const int key = k0 + t;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        kv = to_float(kb[key * ks_.s + d]);
        vv = to_float(vb[key * vs_.s + d]);
      }
      ksh[t * (D + 1) + d] = kv;
      vsh[t * D + d] = vv;
    }
    __syncthreads();

    float s[SPT];
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const int t = c + 4 * jj;
      const int key = k0 + t;
      const float* qrow = qsh + r * (D + 1);
      const float* krow = ksh + t * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qrow[d] * krow[d];
      const bool ok = key < Sk && (!causal || key <= qi + offset);
      s[jj] = ok ? dot * scale : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < SPT; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
      psh[r * (BK + 1) + c + 4 * jj] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's probabilities come from the 4 lanes of this warp

    const float* prow = psh + r * (BK + 1);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = c + 4 * j;
      float a = acc[j] * alpha;
      for (int t = 0; t < BK; ++t) a += prow[t] * vsh[t * D + d];
      acc[j] = a;
    }
  }

  if (qi < Sq) {
    T* orow = o + b * os_.b + h * os_.h + qi * os_.s;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[c + 4 * j] = from_float<T>(acc[j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
           int Sq, int Sk, int causal, float scale, Strides qs, Strides ks, Strides vs,
           Strides os, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_kernel<T, D>;
  cudaError_t err = avec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(o), H, K,
                                     Sq, Sk, causal, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
               int K, int Sq, int Sk, int causal, float scale, Strides qs, Strides ks,
               Strides vs, Strides os, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, K, Sq, Sk, causal, scale, qs, ks, vs, os, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, K, Sq, Sk, causal, scale, qs, ks, vs, os, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, K, Sq, Sk, causal, scale, qs, ks, vs, os, stream);
    default:
      return avec::kUnsupported;
  }
}

}  // namespace

// q (B,H,Sq,D), k/v (B,K,Sk,D), o (B,H,Sq,D); strides in elements.
extern "C" int avec_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int dtype, int B, int H, int K, int Sq, int Sk, int D,
                                    int causal, float scale, long long q_sb, long long q_sh,
                                    long long q_ss, long long k_sb, long long k_sh,
                                    long long k_ss, long long v_sb, long long v_sh,
                                    long long v_ss, long long o_sb, long long o_sh,
                                    long long o_ss, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (K <= 0 || H % K != 0 || B > 65535 || H > 65535) return avec::kUnsupported;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case avec::kF32:
      return dispatch_d<float>(D, q, k, v, o, B, H, K, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case avec::kBF16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, K, Sq, Sk, causal, scale, qs, ks,
                                       vs, os, s);
    default:
      return avec::kUnsupported;
  }
}
