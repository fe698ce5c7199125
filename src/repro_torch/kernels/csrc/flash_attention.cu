// Flash attention forward (GQA), online softmax with fp32 m / l / acc.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// `flash_attention` (`_flash_kernel`).  Bound: at the main paths' prompt
// lengths by bytes (q, k, v read once, o written once: 0.78 us at B 2,
// S 128 and 6.26 us at B 8, S 256 on the H100); the two products grow as
// Sq*Sk*D and pass the bytes only for long prompts.
//
// bfloat16 (the main paths): one block of one warpgroup (128 threads) per
// (64-row tile of packed query rows, KV head, batch row).  The G query heads
// of a KV head are packed into the tile's rows position-major (row = pos*G +
// g), so every K/V tile is read once for the whole group, and a tile spans
// 64/G positions, which keeps its causal limit tight.  K/V tiles of 64 keys
// stream through a two-stage ring in shared memory by 16-byte cp.async
// copies (no tensor map to encode on the host per call: the serving paths
// are host-bound), swizzled as wgmma reads them.  S = Q K^T runs on the
// tensor cores (wgmma m64n64k16, A = Q and B = K from shared memory, fp32
// accumulate); the online softmax works on the accumulator fragment in
// registers (row max and sum across the quad of threads owning a row, exp2
// by ex2.approx); P goes to bf16 in registers and is the register A operand
// of O += P V (B = V from shared memory through the MN-major descriptor).
// Only the tiles that cross the causal diagonal or the ragged Sk tail run
// the mask; tiles wholly above the diagonal are never loaded; rows past Sq
// are not stored; the row tiles with the most causal work are scheduled
// first.  Inputs are read through their (batch, head, sequence) strides, so
// the model's (B,S,H,D) layout is used in place; the wrapper guarantees
// 16-byte aligned rows (it copies a tensor that breaks the rule).
//
// float32 keeps a CUDA-core kernel: the tensor cores would round fp32 inputs
// to TF32 (about three decimal digits), which the fp32 hold of 2e-5 against
// the plain version does not allow.  One block per (query tile of 32 rows,
// head, batch row) walks K/V tiles of 32 keys staged in shared memory as
// fp32 up to the causal limit of the tile's last row; four threads share a
// query row (8 of the tile's scores and D/4 output columns each).
//
// Ragged Sq / Sk tails are masked in both kernels (prompt lengths are
// arbitrary).  The masked score is avec::kNegInf (finite), so exp of a
// masked score is 0 and never NaN.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 32;   // fp32: query rows per block
constexpr int BK = 32;   // fp32: keys per shared-memory tile
constexpr int NT = 128;  // fp32: threads, 4 per query row

constexpr int TC_M = 64;         // bf16: packed query rows per block (one warpgroup)
constexpr int TC_N = 64;         // bf16: keys per K/V tile
constexpr int TC_THREADS = 128;  // one warpgroup

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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * D * 2;
}

template <int D>
constexpr size_t tc_smem_bytes() {  // Q tile, two stages of K and V, 1 KB for alignment
  return 1024 + (size_t)tile_bytes<D>() * 5;
}

// Copy 64 rows of D bf16 (row r at `src(r)`, or zeros where `src(r)` is
// null) into a swizzled tile, 16 bytes per cp.async; `base` is any valid
// address, given for the zero-filled rows, which read nothing.
template <int D, typename RowPtr>
__device__ __forceinline__ void load_tile(uint8_t* tile, const __nv_bfloat16* base,
                                          RowPtr src) {
  using Tile = avec::hopper::SwizzledTile<D>;
  for (int i = threadIdx.x; i < 64 * Tile::CHUNKS; i += TC_THREADS) {
    const int r = i / Tile::CHUNKS, c = i % Tile::CHUNKS;
    const __nv_bfloat16* row = src(r);
    avec::hopper::cp_async16(tile + Tile::offset(64, r, c), row ? row + c * 8 : base,
                             row != nullptr);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int G,
                int Sq, int Sk, int causal, float scale, Strides qs_, Strides ks_,
                Strides vs_, Strides os_) {
  using namespace avec;
  using namespace avec::hopper;
  using Tile = SwizzledTile<D>;
  constexpr int W = Tile::W;
  constexpr int NC = D == 128 ? 2 : 1;    // N chunks of O (64 columns each, or 16)
  constexpr int NO = D == 16 ? 8 : 32;    // accumulator registers per chunk

  // first packed row (pos * G + g); the tiles with the most causal work go first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * TC_M;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int offset = Sk - Sq;             // causal: row pos sees keys <= pos + offset

  const int first_pos = r0 / G;
  const int last_pos = min((r0 + TC_M - 1) / G, Sq - 1);
  const int k_end = causal ? max(0, min(Sk, last_pos + offset + 1)) : Sk;
  const int n_tiles = (k_end + TC_N - 1) / TC_N;

  uint8_t* smem = reinterpret_cast<uint8_t*>(avec_smem);
  smem += (1024u - (smem_addr(smem) & 1023u)) & 1023u;
  uint8_t* qt = smem;   // then stage s: K at qt + (1 + 2s) tiles, V at qt + (2 + 2s) tiles
  auto kt = [&](int stage) { return qt + (1 + 2 * stage) * tile_bytes<D>(); };
  auto vt = [&](int stage) { return qt + (2 + 2 * stage) * tile_bytes<D>(); };

  const __nv_bfloat16* qb = q + b * qs_.b + (long long)kvh * G * qs_.h;
  const __nv_bfloat16* kb = k + b * ks_.b + kvh * ks_.h;
  const __nv_bfloat16* vb = v + b * vs_.b + kvh * vs_.h;
  auto kv_load = [&](int j, int stage) {
    const int k0 = j * TC_N;
    load_tile<D>(kt(stage), kb, [&](int r) {
      return k0 + r < Sk ? kb + (long long)(k0 + r) * ks_.s : nullptr;
    });
    load_tile<D>(vt(stage), vb, [&](int r) {
      return k0 + r < Sk ? vb + (long long)(k0 + r) * vs_.s : nullptr;
    });
  };

  if (n_tiles > 0) {
    load_tile<D>(qt, qb, [&](int r) {
      const int pr = r0 + r, pos = pr / G;
      return pos < Sq ? qb + (long long)(pr - pos * G) * qs_.h + (long long)pos * qs_.s
                      : nullptr;
    });
    kv_load(0, 0);
    cp_async_commit();
  }

  // this thread's two rows of the accumulator fragments: r and r + 8
  const int row_lo = warp * 16 + (lane >> 2);
  const int pos_lo = (r0 + row_lo) / G, pos_hi = (r0 + row_lo + 8) / G;
  const int col = 2 * (lane & 3);
  const float c_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x * log2 e)
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;  // l: this thread's part
  float s[32];
  float acc[NC][NO];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[c][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1, k0 = j * TC_N;
    if (j + 1 < n_tiles) {
      kv_load(j + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // S = Q K^T: K-major A and B, one k-step per 16 head dims
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk * 32 / W) * 64 * W + (kk * 32) % W;
      wgmma_m64n64k16_ss(s, desc<D>(qt + off), desc<D>(kt(stage) + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // online softmax on the fragment: s[4n + e] is key k0 + 8n + col + (e & 1)
    // of row row_lo (e < 2) or row_lo + 8
    const bool masked = k0 + TC_N > Sk || (causal && k0 + TC_N - 1 > first_pos + offset);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * n + e] * c_log2;
        if (masked) {
          const int key = k0 + 8 * n + col + (e & 1);
          const int pos = e < 2 ? pos_lo : pos_hi;
          if (key >= Sk || (causal && key > pos + offset)) x = kNegInf;
        }
        s[4 * n + e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * n], s[4 * n + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, w));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float a_lo = fast_exp2(m_lo - mn_lo), a_hi = fast_exp2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[4 * n] = fast_exp2(s[4 * n] - mn_lo);
      s[4 * n + 1] = fast_exp2(s[4 * n + 1] - mn_lo);
      s[4 * n + 2] = fast_exp2(s[4 * n + 2] - mn_hi);
      s[4 * n + 3] = fast_exp2(s[4 * n + 3] - mn_hi);
      sum_lo += s[4 * n] + s[4 * n + 1];
      sum_hi += s[4 * n + 2] + s[4 * n + 3];
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < NO; i += 4) {
        acc[c][i] *= a_lo;
        acc[c][i + 1] *= a_lo;
        acc[c][i + 2] *= a_hi;
        acc[c][i + 3] *= a_hi;
      }

    // P as bf16 A fragments: the accumulator layout of 16 keys is the
    // register A layout of one k-step
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // O += P V: V as the MN-major B operand, 16 keys per k-step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t bd = desc<D>(vt(stage) + c * 64 * W + kk * 16 * W);
        if constexpr (D == 16)
          wgmma_m64n16k16_rs(acc[c], pa[kk], bd);
        else
          wgmma_m64n64k16_rs(acc[c], pa[kk], bd);
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, w);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, w);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = r0 + row_lo + 8 * half, pos = half ? pos_hi : pos_lo;
    if (pos >= Sq) continue;
    const float inv = half ? inv_hi : inv_lo;
    __nv_bfloat16* orow =
        o + b * os_.b + (long long)(kvh * G + pr - pos * G) * os_.h + (long long)pos * os_.s;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        const float x0 = acc[c][4 * n + 2 * half] * inv, x1 = acc[c][4 * n + 2 * half + 1] * inv;
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 64 + 8 * n + col) =
            __floats2bfloat162_rn(x0, x1);
      }
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

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
              int Sq, int Sk, int causal, float scale, Strides qs, Strides ks, Strides vs,
              Strides os, cudaStream_t stream) {
  const int G = H / K;
  const long long rows = (long long)Sq * G;
  if ((rows + TC_M - 1) / TC_M > 0x7fffffffLL) return avec::kUnsupported;
  const size_t smem = tc_smem_bytes<D>();
  auto kernel = flash_tc_kernel<D>;
  cudaError_t err = avec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((rows + TC_M - 1) / TC_M), K, B);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), G, Sq, Sk, causal,
      scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <bool TC>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
               int K, int Sq, int Sk, int causal, float scale, Strides qs, Strides ks,
               Strides vs, Strides os, cudaStream_t stream) {
#define AVEC_FLASH_CASE(DIM)                                                                \
  case DIM:                                                                                 \
    return TC ? launch_tc<DIM>(q, k, v, o, B, H, K, Sq, Sk, causal, scale, qs, ks, vs, os,  \
                               stream)                                                      \
              : launch<float, DIM>(q, k, v, o, B, H, K, Sq, Sk, causal, scale, qs, ks, vs, \
                                   os, stream);
  switch (D) {
    AVEC_FLASH_CASE(16)
    AVEC_FLASH_CASE(64)
    AVEC_FLASH_CASE(128)
    default:
      return avec::kUnsupported;
  }
#undef AVEC_FLASH_CASE
}

}  // namespace

// q (B,H,Sq,D), k/v (B,K,Sk,D), o (B,H,Sq,D); strides in elements.  bf16 runs
// on the tensor cores (16-byte aligned rows required), f32 on the CUDA cores.
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
      return dispatch_d<false>(D, q, k, v, o, B, H, K, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    case avec::kBF16:
      return dispatch_d<true>(D, q, k, v, o, B, H, K, Sq, Sk, causal, scale, qs, ks, vs, os, s);
    default:
      return avec::kUnsupported;
  }
}
