// Decode attention: one query token per sequence against its KV cache,
// masked past kv_len[b].
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py
// `decode_attention` (`_decode_kernel`).  Bound by bytes: it reads the
// first kv_len rows of K and V once, about 4*G flops per byte read (0.17 us
// for granite-3-2b's decode at B 2, kv_len 136 on the H100), so what counts
// is how much of the card's memory system it keeps busy.
//
// Design: split-K.  The grid is (KV head, batch row, split): each block
// reads one split of `split_len` keys of its (b, kv head) -- the host picks
// split_len from the cache length S, B*K and the SM count, never from
// kv_len -- and serves all G query heads of the group, so each cache row is
// still read once.  A split that starts at or past kv_len[b] reads nothing
// and leaves an empty partial (m = -1e30, l = 0).  Inside a split, tiles of
// 32 keys stream through a two-stage ring in shared memory by 16-byte
// cp.async copies (bf16 or f32 as stored; rows padded by 16 bytes so a
// lane's 16-byte reads of its key row hit distinct banks).  One warp per
// query head: lane t scores key t of the tile, the online softmax reduces
// across the warp with shuffles, and P V gives each lane D/32 output
// columns; (m, l, acc) carry from tile to tile in shared memory.  Each
// block writes its (m, l, acc) partial per query head to fp32 scratch; the
// last block of a (b, kv head) to arrive -- found by an integer counter
// (acquire-release atomic), which it resets to 0 for the next call --
// merges the splits online in split order, in fp32, reading eight splits'
// partials at a time, and writes o in q's dtype.  No float atomics: two
// calls give bit-identical output.  The counters are one int per (b, kv
// head), owned by the wrapper; calls that run concurrently on two streams
// of one device must not share them.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TK = 32;            // keys per tile: one lane per key
constexpr int NT = 128;           // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_G = 64;

struct Strides {
  long long b, h, s;
};

template <typename TKV, int D>
struct KVTile {
  static constexpr int VEC = 16 / sizeof(TKV);   // values per 16-byte chunk
  static constexpr int CHUNKS = D / VEC;          // chunks per row
  static constexpr int RS = D + VEC;              // padded row stride (elements)
  static constexpr int ELEMS = TK * RS;
};

template <typename TKV, int D>
size_t smem_bytes(int G) {
  return (2 * (size_t)G * D + 2 * G) * sizeof(float) +
         4 * (size_t)KVTile<TKV, D>::ELEMS * sizeof(TKV);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ kv_len,
                    TQ* __restrict__ o, float* __restrict__ part, int* __restrict__ counter,
                    int G, int S, int split_len, float scale, Strides qs_, Strides ks_,
                    Strides vs_, Strides os_) {
  using namespace avec;
  using Tile = KVTile<TKV, D>;
  constexpr int DV = (D + 31) / 32;   // output columns per lane
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z, K = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(kv_len[b], 0), S);
  const int s0 = split * split_len;
  const int n_keys = max(0, min(split_len, len - s0));

  float* qsh = avec_smem;                                      // [G][D] fp32
  float* accsh = qsh + G * D;                                  // [G][D] acc between tiles
  TKV* kv = reinterpret_cast<TKV*>(accsh + G * D);             // stage s: K at 2s, V at 2s+1
  float* msh = reinterpret_cast<float*>(kv + 4 * Tile::ELEMS);  // [G] m between tiles
  float* lsh = msh + G;                                        // [G] l between tiles

  // scratch: (m, l) of every (b, kv head, split, g), then their acc rows
  const long long group = ((long long)b * K + h) * n_split;   // this (b, kv head)'s split 0
  float* gml = part + group * G * 2;
  float* gacc = part + (long long)gridDim.y * K * n_split * G * 2 + group * G * D;
  float* ml = gml + (long long)split * G * 2;
  float* pacc = gacc + (long long)split * G * D;

  const TKV* kb = k + b * ks_.b + h * ks_.h;
  const TKV* vb = v + b * vs_.b + h * vs_.h;
  auto load = [&](int t0, int stage) {
    for (int i = tid; i < 2 * TK * Tile::CHUNKS; i += NT) {
      const int which = i / (TK * Tile::CHUNKS), r = (i / Tile::CHUNKS) % TK,
                c = i % Tile::CHUNKS;
      const bool ok = t0 + r < n_keys;
      const TKV* base = which ? vb : kb;
      const long long stride = which ? vs_.s : ks_.s;
      TKV* dst = kv + (2 * stage + which) * Tile::ELEMS + r * Tile::RS + c * Tile::VEC;
      hopper::cp_async16(dst, ok ? base + (long long)(s0 + t0 + r) * stride + c * Tile::VEC : base,
                         ok);
    }
  };

  if (n_keys > 0) {
    load(0, 0);
    hopper::cp_async_commit();
    const TQ* qb = q + b * qs_.b + h * qs_.h;
    for (int i = tid; i < G * D; i += NT) qsh[i] = to_float(qb[(i / D) * qs_.s + i % D]);

    const int n_tiles = (n_keys + TK - 1) / TK;
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it & 1, t0 = it * TK, n = min(TK, n_keys - t0);
      const bool last_tile = it + 1 == n_tiles;
      if (!last_tile) {
        load(t0 + TK, stage ^ 1);
        hopper::cp_async_commit();
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      __syncthreads();
      const TKV* krow = kv + 2 * stage * Tile::ELEMS + lane * Tile::RS;
      const TKV* vs = kv + (2 * stage + 1) * Tile::ELEMS;
      for (int g = warp; g < G; g += NW) {   // one warp per query head, lane t: key t
        const float* qrow = qsh + g * D;
        float dot = 0.f;
#pragma unroll
        for (int d0 = 0; d0 < D; d0 += 8) {
          float kx[8], qx[8];
          load8(krow + d0, kx);
          load8(qrow + d0, qx);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot += qx[e] * kx[e];
        }
        const float s = lane < n ? dot * scale : kNegInf;
        const float m_old = it ? msh[g] : kNegInf;
        const float m_new = fmaxf(m_old, warp_max(s));
        const float alpha = expf(m_old - m_new);
        const float p = expf(s - m_new);
        const float l = (it ? lsh[g] * alpha : 0.f) + warp_sum(p);
        float a[DV];
#pragma unroll
        for (int i = 0; i < DV; ++i) {
          const int d = lane * DV + i;
          a[i] = it && d < D ? accsh[g * D + d] * alpha : 0.f;
        }
#pragma unroll 8
        for (int t = 0; t < n; ++t) {
          const float pt = __shfl_sync(0xffffffffu, p, t);
#pragma unroll
          for (int i = 0; i < DV; ++i) {
            const int d = lane * DV + i;
            if (d < D) a[i] += pt * to_float(vs[t * Tile::RS + d]);
          }
        }
        // carry (m, l, acc) to the next tile in shared memory, or write the partial
        float* m_dst = last_tile ? ml + 2 * g : msh + g;
        float* l_dst = last_tile ? ml + 2 * g + 1 : lsh + g;
        float* a_dst = last_tile ? pacc + g * D : accsh + g * D;
        if (lane == 0) {
          *m_dst = m_new;
          *l_dst = l;
        }
#pragma unroll
        for (int i = 0; i < DV; ++i) {
          const int d = lane * DV + i;
          if (d < D) a_dst[d] = a[i];
        }
      }
      __syncthreads();  // this stage is refilled by the next tile's prefetch
    }
  } else {
    for (int g = tid; g < G; g += NT) {  // an empty split: nothing to read
      ml[2 * g] = kNegInf;
      ml[2 * g + 1] = 0.f;
    }
  }

  // the last block of this (b, kv head) to arrive merges the splits: the
  // barrier orders the block's partial before thread 0's release, and thread
  // 0's acquire orders the other blocks' partials before the barrier
  __shared__ int is_last;
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(counter + b * K + h) : "memory");
    is_last = prev == n_split - 1;
    if (is_last) counter[b * K + h] = 0;  // every block of this call has arrived
  }
  __syncthreads();
  if (!is_last) return;
  TQ* ob = o + b * os_.b + h * os_.h;
  constexpr int CH = 8;   // splits whose partials are read at once
  for (int g = warp; g < G; g += NW) {
    // an online merge in split order; each chunk's reads are issued together
    float M = kNegInf, L = 0.f, out[DV];
#pragma unroll
    for (int i = 0; i < DV; ++i) out[i] = 0.f;
    for (int c0 = 0; c0 < n_split; c0 += CH) {
      float mv[CH], lv[CH], xv[CH][DV];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int sp = c0 + j;
        const bool ok = sp < n_split;
        mv[j] = ok ? __ldcg(gml + (sp * G + g) * 2) : kNegInf;
        lv[j] = ok ? __ldcg(gml + (sp * G + g) * 2 + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < DV; ++i) {
          const int d = lane * DV + i;
          xv[j][i] = ok && d < D ? __ldcg(gacc + ((long long)sp * G + g) * D + d) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        if (!(lv[j] > 0.f)) continue;   // an empty split (its acc row was never written)
        const float mn = fmaxf(M, mv[j]);
        const float a = expf(M - mn), w = expf(mv[j] - mn);
        L = L * a + lv[j] * w;
#pragma unroll
        for (int i = 0; i < DV; ++i) out[i] = out[i] * a + w * xv[j][i];
        M = mn;
      }
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const int d = lane * DV + i;
      if (d < D) ob[g * os_.s + d] = from_float<TQ>(out[i] * inv);
    }
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
           float* part, int* counter, int B, int K, int G, int S, int split_len, int n_split,
           float scale, Strides qs, Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV, D>(G);
  auto kernel = decode_split_kernel<TQ, TKV, D>;
  cudaError_t err = avec::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(K, B, n_split);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                                     static_cast<const TKV*>(v), kv_len, static_cast<TQ*>(o),
                                     part, counter, G, S, split_len, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int dispatch_d(int D, const void* q, const void* k, const void* v, const int* kv_len,
               void* o, float* part, int* counter, int B, int K, int G, int S, int split_len,
               int n_split, float scale, Strides qs, Strides ks, Strides vs, Strides os,
               cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<TQ, TKV, 16>(q, k, v, kv_len, o, part, counter, B, K, G, S, split_len,
                                 n_split, scale, qs, ks, vs, os, stream);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, kv_len, o, part, counter, B, K, G, S, split_len,
                                 n_split, scale, qs, ks, vs, os, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, kv_len, o, part, counter, B, K, G, S, split_len,
                                  n_split, scale, qs, ks, vs, os, stream);
    default:
      return avec::kUnsupported;
  }
}

template <typename TQ>
int dispatch_kv(int kv_dtype, int D, const void* q, const void* k, const void* v,
                const int* kv_len, void* o, float* part, int* counter, int B, int K, int G,
                int S, int split_len, int n_split, float scale, Strides qs, Strides ks,
                Strides vs, Strides os, cudaStream_t stream) {
  switch (kv_dtype) {
    case avec::kF32:
      return dispatch_d<TQ, float>(D, q, k, v, kv_len, o, part, counter, B, K, G, S, split_len,
                                   n_split, scale, qs, ks, vs, os, stream);
    case avec::kBF16:
      return dispatch_d<TQ, __nv_bfloat16>(D, q, k, v, kv_len, o, part, counter, B, K, G, S,
                                           split_len, n_split, scale, qs, ks, vs, os, stream);
    default:
      return avec::kUnsupported;
  }
}

}  // namespace

// q (B,K,G,D), k/v (B,K,S,D), kv_len (B,) int32, o (B,K,G,D); strides in
// elements, (batch, head, group) for q and o and (batch, head, seq) for k/v,
// whose rows must be 16-byte aligned.  part: fp32 scratch of
// B*K*n_split*G*(D+2) floats; counter: B*K ints, zero on entry and on return.
extern "C" int avec_decode_attention(const void* q, const void* k, const void* v,
                                     const void* kv_len, void* o, void* part, void* counter,
                                     int q_dtype, int kv_dtype, int B, int K, int G, int S,
                                     int D, int split_len, int n_split, float scale,
                                     long long q_sb, long long q_sh, long long q_sg,
                                     long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss,
                                     long long o_sb, long long o_sh, long long o_sg,
                                     void* stream) {
  if (B == 0 || K == 0 || G == 0) return 0;
  if (G > MAX_G || B > 65535 || n_split < 1 || n_split > 65535 || split_len % TK ||
      (long long)split_len * n_split < S)
    return avec::kUnsupported;
  const Strides qs{q_sb, q_sh, q_sg}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_sg};
  auto lens = static_cast<const int*>(kv_len);
  auto pt = static_cast<float*>(part);
  auto ct = static_cast<int*>(counter);
  auto s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case avec::kF32:
      return dispatch_kv<float>(kv_dtype, D, q, k, v, lens, o, pt, ct, B, K, G, S, split_len,
                                n_split, scale, qs, ks, vs, os, s);
    case avec::kBF16:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, D, q, k, v, lens, o, pt, ct, B, K, G, S,
                                        split_len, n_split, scale, qs, ks, vs, os, s);
    default:
      return avec::kUnsupported;
  }
}
