// Mamba2 SSD chunked scan: y and the final (P,N) state of
//   state_t = state_{t-1} * exp(dt_t A) + dt_t x_t B_t^T,   y_t = state_t C_t,
// computed chunk by chunk as in Mamba2's Listing 1, in fp32.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py `ssd_scan_kernel`
// (`_ssd_kernel`).  The TPU kernel runs a sequential grid axis over the chunks
// with the state in VMEM and keeps a whole (L,L) fp32 score matrix there; at
// L = 256 that matrix alone (256 KB) exceeds a Hopper block's 227 KB of shared
// memory.  Here the chunks are a loop inside the block, and each chunk is
// walked in 64-row tiles:
//
//   for each chunk:   cum = inclusive cumsum of dt*A        (block scan)
//     for each row tile i:  y_i  = sum_{j<=i} ((C_i B_j^T) * exp(cum_i - cum_j)[j<=i] * dt_j) x_j
//                           y_i += exp(cum_i) * C_i state^T
//     state = state * exp(cum_last) + x^T (B * exp(cum_last - cum) * dt)
//
// exp(cum_i - cum_j) is evaluated only for j <= i (above the diagonal it
// overflows, and inf * 0 is NaN).  One block per (batch row, head, 32-wide
// slice of the head dim P): the slice's part of the state (32 x N fp32) stays
// in shared memory across the chunks, and C B^T is recomputed per slice.
// Splitting P doubles the blocks at mamba2-130m's shapes (B 2, H 24, P 64:
// 96 blocks on 132 SMs instead of 48) for about 1.4x less work per block.
//
// Bound: by bytes at the main path's shapes (about 15 MB read and written
// against 3.4 GFLOP, 4.6 us against 3.4 us at the bf16 tensor rate).  This
// first design reads each B/C/x tile from L2 once per (row tile, column
// tile) pair and runs the products on the CUDA cores out of shared memory
// (padded rows, strided micro-tiles: no bank conflicts), so it is bound by
// shared-memory bandwidth far above that bound.  wgmma, TMA, and a
// chunk-parallel state pass are the way down.
//
// Layouts: x (B,S,H,P), dt (B,S,H) fp32, B/C (B,S,G,N), all read in place
// through their strides (unit last stride); head h reads group h / (H/G).
// Positions >= S read as x = 0, dt = 0 (so dA = 0) and write no y: the final
// state is then exactly the state after S steps, without padding copies.
// y (B,S,H,P) in x's type, state (B,H,P,N) fp32, both contiguous.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kTile = 64;      // positions per row or column tile
constexpr int kPT = 32;        // head-dim columns (P) per block
constexpr int kMaxN = 128;
constexpr int kMaxL = 2048;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* state;
  long long S;
  int H, P, G, N, L;
  long long xs_b, xs_s, xs_h;
  long long dts_b, dts_s, dts_h;
  long long bs_b, bs_s, bs_g;
  long long cs_b, cs_s, cs_g;
  long long ys_b, ys_s, ys_h;
};

size_t smem_floats(int N, int L) {
  const int NP = N + 1;
  return (size_t)2 * kTile * NP + (size_t)kPT * NP + (size_t)kTile * (kTile + 1) +
         (size_t)kTile * kPT + 3 * (size_t)L + kThreads / 32;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_scan_kernel(const Args a) {
  using namespace avec;
  const int b = blockIdx.z, h = blockIdx.y, p0 = blockIdx.x * kPT;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = a.N, L = a.L, P = a.P, NP = N + 1;

  float* Cs = avec_smem;                 // [kTile][NP]    C rows of the row tile
  float* Bs = Cs + kTile * NP;           // [kTile][NP]    B rows of the column tile
  float* St = Bs + kTile * NP;           // [kPT][NP]      carried state, this P slice
  float* Ss = St + kPT * NP;             // [kTile][kTile+1] masked, decayed scores
  float* Xs = Ss + kTile * (kTile + 1);  // [kTile][kPT]   x rows of the column tile
  float* cum = Xs + kTile * kPT;         // [L] inclusive cumsum of dt*A in the chunk
  float* dtv = cum + L;                  // [L] dt
  float* wv = dtv + L;                   // [L] exp(cum_last - cum) * dt
  float* part = wv + L;                  // [kThreads/32] scan partials

  const T* xb = static_cast<const T*>(a.x) + b * a.xs_b + h * a.xs_h;
  const float* dtb = a.dt + b * a.dts_b + h * a.dts_h;
  const T* Bb = static_cast<const T*>(a.Bm) + b * a.bs_b + g * a.bs_g;
  const T* Cb = static_cast<const T*>(a.Cm) + b * a.cs_b + g * a.cs_g;
  T* yb = static_cast<T*>(a.y) + b * a.ys_b + h * a.ys_h;
  const float Ah = a.A[h];

  for (int e = tid; e < kPT * NP; e += kThreads) St[e] = 0.f;

  const long long nc = (a.S + L - 1) / L;
  for (long long c = 0; c < nc; ++c) {
    const long long s0 = c * L;
    const int len = (int)min((long long)L, a.S - s0);  // valid positions in the chunk

    // ---- cumsum of dA: a segment per thread, then a scan of the segment sums
    const int per = (len + kThreads - 1) / kThreads;
    const int beg = min(tid * per, len), end = min(beg + per, len);
    float run = 0.f;
    for (int l = beg; l < end; ++l) {
      const float d = dtb[(s0 + l) * a.dts_s];
      dtv[l] = d;
      run += d * Ah;
      cum[l] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) part[warp] = incl;
    __syncthreads();
    float off = incl - run;
    for (int w = 0; w < warp; ++w) off += part[w];
    for (int l = beg; l < end; ++l) cum[l] += off;
    __syncthreads();
    const float cum_last = cum[len - 1];
    for (int l = tid; l < len; l += kThreads) wv[l] = expf(cum_last - cum[l]) * dtv[l];

    float upd[2][8];  // this thread's state entries: p = ty + 16q, n = tx + 16k
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int k = 0; k < 8; ++k) upd[q][k] = 0.f;

    const int nt = (len + kTile - 1) / kTile;
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kTile;
      __syncthreads();  // the last tile's reads of Cs are done
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        Cs[r * NP + n] = i0 + r < len ? to_float(Cb[(s0 + i0 + r) * a.cs_s + n]) : 0.f;
      }
      float acc[4][2];  // y rows i0 + ty + 16r, columns p0 + tx + 16q
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();  // the last column tile's reads of Bs, Xs, Ss are done
        for (int e = tid; e < kTile * N; e += kThreads) {
          const int r = e / N, n = e - r * N;
          Bs[r * NP + n] = j0 + r < len ? to_float(Bb[(s0 + j0 + r) * a.bs_s + n]) : 0.f;
        }
        for (int e = tid; e < kTile * kPT; e += kThreads) {
          const int r = e / kPT, q = e - r * kPT;
          Xs[e] = (j0 + r < len && p0 + q < P) ? to_float(xb[(s0 + j0 + r) * a.xs_s + p0 + q])
                                               : 0.f;
        }
        __syncthreads();

        // scores (C_i B_j^T) * decay * dt_j: rows ty + 16r, columns tx + 16k
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[r][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * NP + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = Bs[(tx + 16 * k) * NP + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) sc[r][k] += cv[r] * bv[k];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0 + tx + 16 * k;
            Ss[(ty + 16 * r) * (kTile + 1) + tx + 16 * k] =
                (j <= i && i < len) ? sc[r][k] * expf(cum[i] - cum[j]) * dtv[j] : 0.f;
          }
        }
        __syncthreads();

        // y_i += S x_j
        for (int j = 0; j < kTile; ++j) {
          const float x0 = Xs[j * kPT + tx], x1 = Xs[j * kPT + tx + 16];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float s = Ss[(ty + 16 * r) * (kTile + 1) + j];
            acc[r][0] += s * x0;
            acc[r][1] += s * x1;
          }
        }

        // the last row tile sweeps every column tile: fold in the state update
        if (it == nt - 1) {
          const int lmax = min(kTile, len - j0);
          for (int l = 0; l < lmax; ++l) {
            const float w = wv[j0 + l];
            const float xw0 = Xs[l * kPT + ty] * w, xw1 = Xs[l * kPT + ty + 16] * w;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int n = tx + 16 * k;
              const float bvv = n < N ? Bs[l * NP + n] : 0.f;
              upd[0][k] += xw0 * bvv;
              upd[1][k] += xw1 * bvv;
            }
          }
        }
      }

      // inter-chunk term from the state entering the chunk: exp(cum_i) C_i state^T
      float in[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) in[r][0] = in[r][1] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float s0v = St[tx * NP + n], s1v = St[(tx + 16) * NP + n];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cv = Cs[(ty + 16 * r) * NP + n];
          in[r][0] += cv * s0v;
          in[r][1] += cv * s1v;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= len) continue;
        const float e = expf(cum[i]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = p0 + tx + 16 * q;
          if (p < P) yb[(s0 + i) * a.ys_s + p] = from_float<T>(acc[r][q] + e * in[r][q]);
        }
      }
    }

    __syncthreads();  // every read of St for this chunk is done
    const float dec = expf(cum_last);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tx + 16 * k;
        if (n < N) St[(ty + 16 * q) * NP + n] = St[(ty + 16 * q) * NP + n] * dec + upd[q][k];
      }
  }

  __syncthreads();
  float* sb = a.state + ((long long)b * a.H + h) * (long long)P * N;
  for (int e = tid; e < kPT * N; e += kThreads) {
    const int q = e / N, n = e - q * N;
    if (p0 + q < P) sb[(long long)(p0 + q) * N + n] = St[q * NP + n];
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_floats(a.N, a.L) * sizeof(float);
  cudaError_t err = avec::allow_smem(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.P + kPT - 1) / kPT), (unsigned)a.H, (unsigned)batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int avec_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, void* y, void* state, int x_dtype, int bc_dtype,
                             int dt_dtype, int batch, long long S, int H, int P, int G, int N,
                             int L, long long xs_b, long long xs_s, long long xs_h,
                             long long dts_b, long long dts_s, long long dts_h, long long bs_b,
                             long long bs_s, long long bs_g, long long cs_b, long long cs_s,
                             long long cs_g, long long ys_b, long long ys_s, long long ys_h,
                             void* stream) {
  if (dt_dtype != avec::kF32 || x_dtype != bc_dtype) return avec::kUnsupported;
  if (batch < 0 || batch > 65535 || S < 0 || H <= 0 || H > 65535 || P <= 0 || G <= 0 ||
      H % G != 0 || N <= 0 || N > kMaxN || L <= 0 || L > kMaxL)
    return avec::kUnsupported;
  if (batch == 0) return 0;
  Args a{x,    static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm, y,
         static_cast<float*>(state), S, H, P, G, N, L, xs_b, xs_s, xs_h, dts_b, dts_s, dts_h,
         bs_b, bs_s, bs_g, cs_b, cs_s, cs_g, ys_b, ys_s, ys_h};
  auto s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case avec::kF32:
      return launch<float>(a, batch, s);
    case avec::kBF16:
      return launch<__nv_bfloat16>(a, batch, s);
    default:
      return avec::kUnsupported;
  }
}
