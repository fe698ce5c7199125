// Mamba2 SSD chunked scan: y and the final (P,N) state of
//   state_t = state_{t-1} * exp(dt_t A) + dt_t x_t B_t^T,   y_t = state_t C_t,
// computed chunk by chunk as in Mamba2's Listing 1, with fp32 sums.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py `ssd_scan_kernel`
// (`_ssd_kernel`).  The TPU kernel makes the chunks a sequential grid axis
// with the state in VMEM and a whole (L,L) fp32 score matrix beside it; on
// Hopper the chunks run in parallel, in the published SSD decomposition
// (Dao & Gu 2024: chunk state, state passing, chunk scan).  Per (batch row
// b, head h, chunk c), cum = the inclusive cumsum of dt*A over the chunk:
//
//   S_c      = x^T (B * exp(cum_last - cum) * dt)                (P,N)
//   in(c+1)  = in(c) * exp(cum_last(c)) + S_c,   in(0) = 0       (the only sequential part)
//   y_i      = sum_{j<=i} ((C_i B_j^T) * exp(cum_i - cum_j) * dt_j) x_j + exp(cum_i) C_i in(c)^T
//
// Bound at the main path's shape (mamba2-130m: B 2, S 1024, H 24, P 64,
// G 1, N 128, chunk 256, bf16): by bytes, 15.4 MB read and written once
// (x, B, C, dt in; y and the state out), 4.60 us at 3.35 TB/s, against
// 3.36 GFLOP, 3.4 us at the bf16 tensor rate.
//
// Two kernels, one per branch, chosen on the host (ssd_scan.py
// `tensor_core_branch`):
//
// * Tensor cores (bf16; P <= 128 and N <= 128, both multiples of 16; L a
//   multiple of 64; A <= 0 and dt >= 0, as Mamba2's A = -exp(A_log) and
//   softplus dt give): two launches.  The columns of P are independent (y[:,
//   p] needs only x[:, p] and row p of the state), so each block takes one
//   slice of at most 64 of them: a head of 128 (jamba-1.5-large) is two
//   slices, each with the registers and shared memory of a head of 64, and
//   each recomputing its own C_i B_j^T and cumsum.  Both kernels are
//   templates on kSliced: P <= 64 (one slice) keeps the unsliced index
//   arithmetic, with P read from the kernel's arguments, so slicing adds
//   nothing to that path (sliced, the chunk-state kernel spills more).
//   1. chunk_state_kernel, grid (slice x chunk, head, batch), 8 warps: cum
//      (kept in fp32 scratch with dt for the scan), w = exp(cum_last - cum)
//      * dt, and S_c = (x * w)^T B on mma.sync m16n8k16 over a three-stage
//      ring of tiles, written to fp32 scratch with the chunk's decay
//      exp(cum_last).  The last block of each (b, h, slice) to finish --
//      found by an acquire-release integer counter, never by waiting -- runs
//      the nc-step state recurrence of its rows in fp32 and writes each
//      chunk's entering state as a bf16 hi/lo pair and the final state.  (A
//      third launch would add a kernel boundary, about 3 us, and host time
//      on the host-bound serving path; the state passing in the scan's
//      prologue instead, every block of a chunk redoing it, measured slower.)
//   2. chunk_scan_kernel, one block per (64-row tile, chunk, head, batch,
//      slice), the tiles with the most work first: C_i B_j^T on the tensor cores
//      from C fragments held in registers, the decay and dt applied to the
//      accumulator in registers, then S x_j and C_i in(c)^T on the tensor
//      cores; tiles above the diagonal are never touched.  On the diagonal
//      tile exp(cum_i - cum_j) is taken only where j <= i (above the
//      diagonal it overflows, and inf * 0 is NaN); left of it, as
//      exp(cum_i - c0) exp(c0 - cum_j) with c0 = cum at the end of j's
//      tile, both factors at most 1 (cum falls along the chunk), so a
//      thread takes two exponentials per tile, not 32.  y is written in x's
//      type.
//   x, B and C (bf16) enter the tensor cores exactly.  The three fp32
//   operands -- the decayed scores, x * w, and the entering state -- each
//   enter as a bf16 pair hi + lo (hi = bf16(v), lo = bf16(v - hi): about 16
//   significant bits, two products into one fp32 accumulator); one bf16
//   each (8 bits) would put S x alone near 5e-4 * max|y|, over the 2e-4
//   hold.  The faults of the first design, and what this one does:
//   - 96 blocks walking four chunks in order -> 192 chunk-state blocks and
//     768 chunk-scan blocks, all chunks in parallel;
//   - every product on the CUDA cores out of shared memory -> mma.sync with
//     ldmatrix from padded rows (a 16-byte shift per row: no bank
//     conflicts), the fragments of a step loaded before its products;
//   - C B^T recomputed per 32-wide P slice -> one C B^T per (row tile,
//     column tile) per head; (G = 1 still shares it across the 24 heads
//     only through L2: the heads' decays differ);
//   - scalar loads widened to fp32 with an integer division per element ->
//     16-byte cp.async copies of bf16 rows in place, double- or
//     triple-buffered.
// * CUDA cores (fp32, where TF32 would break the 2e-4 hold; other P, N, a
//   ragged L): the first design, kept as it was.  One block per (batch row,
//   head, 32-wide slice of P), the chunks a loop inside the block with the
//   slice's state in shared memory, each chunk walked in 64-row tiles:
//
//   for each chunk:   cum = inclusive cumsum of dt*A        (block scan)
//     for each row tile i:  y_i  = sum_{j<=i} ((C_i B_j^T) * exp(cum_i - cum_j)[j<=i] * dt_j) x_j
//                           y_i += exp(cum_i) * C_i state^T
//     state = state * exp(cum_last) + x^T (B * exp(cum_last - cum) * dt)
//
//   bound by shared-memory bandwidth far above the byte bound.
//
// Layouts: x (B,S,H,P), dt (B,S,H) fp32, B/C (B,S,G,N), all read in place
// through their strides (unit last stride; the tensor-core branch also
// needs rows on 16 bytes, which the wrapper ensures); head h reads group
// h / (H/G).  Positions >= S read as x = 0, dt = 0 (so dA = 0) and write no
// y: the final state is then exactly the state after S steps, without
// padding copies.  y (B,S,H,P) in x's type, state (B,H,P,N) fp32, both
// contiguous.
#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core branch: chunk states (with the state passing in the last
// block of each (b, h)), then the chunk scan.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kStateThreads = 256;  // chunk states: 8 warps, 16 rows of P x 64 columns of N each
constexpr int kScanThreads = 128;   // chunk scan: 4 warps, 16 rows of the 64-row tile each
constexpr int kTile = 64;           // positions per tile
constexpr int kStages = 3;          // chunk states: tiles in flight
constexpr int kSliceP = 64;         // columns of P per block
constexpr int kMaxP = 128, kMaxN = 128, kMaxL = 2048;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  bf16* y;
  float* state;
  float* chunk_st;     // (B*H, nc, P, N) fp32: each chunk's own state S_c
  float* chunk_cum;    // (B*H, nc, L): cum, for the chunk scan
  float* chunk_dt;     // (B*H, nc, L): dt (0 past S)
  float* chunk_decay;  // (B*H, ns, nc): exp(cum_last), one copy per slice
  bf16* in_hi;         // (B*H, nc, P, N): the state entering each chunk, hi
  bf16* in_lo;         //   and lo halves (chunk 0's are never written or read)
  int* counter;        // (B*H, ns): zero on entry and on return
  long long S;
  int batch, H, P, G, N, L, nc, ns;  // ns: slices of P
  long long xs_b, xs_s, xs_h;
  long long dts_b, dts_s, dts_h;
  long long bs_b, bs_s, bs_g;
  long long cs_b, cs_s, cs_g;
  long long ys_b, ys_s, ys_h;
};

// cum[l] = inclusive cumsum of dt*A over the chunk's first `len` positions
// and dtv[l] = dt: 128 segments, one per thread of the first 128 (the rest
// of NT get none), then a scan of the segment sums (part: NT / 32 floats);
// positions len..L-1 (past S) get cum[len-1] and dt 0.  The same segments
// and sums at NT 128 and 256, so both kernels see the same cum bit for bit.
template <int NT>
__device__ void chunk_cumsum(const float* dtb, long long dts_s, long long s0, int len, int L,
                             float Ah, float* cum, float* dtv, float* part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (len + 127) / 128;
  const int beg = min(tid * per, len), end = min(beg + per, len);
  float run = 0.f;
  for (int l = beg; l < end; ++l) {
    const float d = dtb[(s0 + l) * dts_s];
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
  const float last = cum[len - 1];
  for (int l = len + tid; l < L; l += NT) {
    cum[l] = last;
    dtv[l] = 0.f;
  }
  __syncthreads();
}

// rows [0, nrows) of a bf16 matrix (row stride `stride` elements, `width`
// a multiple of 8) into shared memory with a row pitch of `pitch`
// elements, by 16-byte cp.async copies from NT threads; rows at or past
// `valid` are zero-filled and read nothing
template <int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, int pitch, const bf16* src, long long stride,
                                          int nrows, int valid, int width) {
  const int cpr = width >> 3;
  for (int e = threadIdx.x; e < nrows * cpr; e += NT) {
    const int r = e / cpr, q = e - r * cpr;
    const bool ok = r < valid;
    avec::hopper::cp_async16(dst + r * pitch + 8 * q, ok ? src + r * stride + 8 * q : src, ok);
  }
}

// fp32 words of shared memory ahead of the bf16 tiles: cum, dt (or w), and
// the scan's partials and a flag (keeps the tiles on 16 bytes)
__host__ __device__ inline size_t float_words(int L) { return 2 * (size_t)L + 16; }

// ---- 1. chunk states, and the state passing in the last block of a (b, h, slice)
template <bool kSliced>
__global__ void __launch_bounds__(kStateThreads, 2) chunk_state_kernel(const Args a) {
  using namespace avec::hopper;
  constexpr int NT = kStateThreads;
  const int c = kSliced ? blockIdx.x % a.nc : blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int sl = kSliced ? blockIdx.x / a.nc : 0;
  const int g = h / (a.H / a.G), bh = b * a.H + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  // this block's columns of P: p0 .. p0 + P - 1
  const int p0 = sl * kSliceP, P = kSliced ? min(kSliceP, a.P - p0) : a.P;
  const int N = a.N, L = a.L, NP = N + 8, PP = P + 8;
  const long long s0 = (long long)c * L;
  const int len = (int)min((long long)L, a.S - s0);

  float* cum = avec_smem;                                         // [L]
  float* wv = cum + L;                                            // [L] dt, then w
  float* part = wv + L;                                           // [16]: scan, flag
  bf16* Xs = reinterpret_cast<bf16*>(avec_smem + float_words(L));  // [3][64][PP] x tiles
  bf16* Bs = Xs + kStages * kTile * PP;                           // [3][64][NP] B tiles
  bf16* Wh = Bs + kStages * kTile * NP;                           // [64][PP] (x * w) hi
  bf16* Wl = Wh + kTile * PP;                                     // [64][PP] (x * w) lo

  const bf16* xb = a.x + b * a.xs_b + h * a.xs_h + s0 * a.xs_s + p0;
  const bf16* Bb = a.Bm + b * a.bs_b + g * a.bs_g + s0 * a.bs_s;
  const int nt = (len + kTile - 1) / kTile;
  // a ring of kStages tiles, two ahead; every step commits one group
  // (empty past the last tile), so waiting for all but the newest two
  // leaves tile jt in place
  auto load_tile = [&](int jt) {
    if (jt < nt) {
      const int j0 = jt * kTile, buf = jt % kStages;
      copy_rows<NT>(Xs + buf * kTile * PP, PP, xb + j0 * a.xs_s, a.xs_s, kTile, len - j0, P);
      copy_rows<NT>(Bs + buf * kTile * NP, NP, Bb + j0 * a.bs_s, a.bs_s, kTile, len - j0, N);
    }
    cp_async_commit();
  };
  load_tile(0);
  load_tile(1);

  chunk_cumsum<NT>(a.dt + b * a.dts_b + h * a.dts_h, a.dts_s, s0, len, L, a.A[h], cum, wv, part);
  const float cum_last = cum[L - 1];
  // this chunk's cum and dt, for the scan (slice 0's copy: every slice
  // computes the same values)
  const long long cl = ((long long)bh * a.nc + c) * L;
  for (int l = tid; l < L; l += NT) {
    if (sl == 0) {
      a.chunk_cum[cl + l] = cum[l];
      a.chunk_dt[cl + l] = wv[l];
    }
    wv[l] = expf(cum_last - cum[l]) * wv[l];
  }
  const int bhs = kSliced ? bh * a.ns + sl : bh;  // this (b, h, slice)
  if (tid == 0) a.chunk_decay[(long long)bhs * a.nc + c] = expf(cum_last);

  // S_c = (x * w)^T B: warp w owns rows pw..pw+15 of the slice and columns
  // n0..n0+63 of N
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int pw = (warp & 3) * 16, n0 = (warp >> 2) * 64;
  const bool active = pw < P && n0 < N;
  for (int jt = 0; jt < nt; ++jt) {
    const int buf = jt % kStages;
    load_tile(jt + 2);
    cp_async_wait<2>();
    __syncthreads();  // tile jt (and, the first time, w) visible to all
    const bf16* xt = Xs + buf * kTile * PP;
    const int cpr = P >> 3;
    for (int e = tid; e < kTile * cpr; e += NT) {
      const int r = e / cpr, q = e - r * cpr;
      const float w = wv[jt * kTile + r];
      const uint4 raw = *reinterpret_cast<const uint4*>(xt + r * PP + 8 * q);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(xv[k]);
        split_bf16(f.x * w, f.y * w, hi[k], lo[k]);
      }
      *reinterpret_cast<uint4*>(Wh + r * PP + 8 * q) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Wl + r * PP + 8 * q) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
    if (active) {
      const bf16* bt = Bs + buf * kTile * NP;
      const int ac = pw + (((lane >> 3) & 1) << 3), bcol = n0 + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        // A[p][pos] = (x w)[pos][p], stored by position: transposed
        uint32_t ah[4], al[4], bb[4][4];
        const int ar = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4<true>(ah, Wh + ar * PP + ac);
        ldmatrix_x4<true>(al, Wl + ar * PP + ac);
        // B[pos][n], stored by position: transposed; n-tiles 2 n2, 2 n2 + 1
        const int br = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2)
          if (n0 + n2 * 16 < N) ldmatrix_x4<true>(bb[n2], bt + br * NP + bcol + n2 * 16);
        // the fragments first, then eight independent products per half
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          if (n0 + n2 * 16 >= N) continue;
          mma_bf16_16816(acc[2 * n2], ah, bb[n2][0], bb[n2][1]);
          mma_bf16_16816(acc[2 * n2 + 1], ah, bb[n2][2], bb[n2][3]);
        }
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          if (n0 + n2 * 16 >= N) continue;
          mma_bf16_16816(acc[2 * n2], al, bb[n2][0], bb[n2][1]);
          mma_bf16_16816(acc[2 * n2 + 1], al, bb[n2][2], bb[n2][3]);
        }
      }
    }
    __syncthreads();  // tile jt's buffers are refilled on the next step
  }

  // (P, N) states of the whole head; this slice's rows start at p0 * N
  const long long PN = (long long)a.P * N, SN = (long long)P * N, off = (long long)p0 * N;
  float* st = a.chunk_st + ((long long)bh * a.nc + c) * PN + off;
  if (active) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n0 + n * 8 + 2 * tq;
      if (col >= N) continue;
      *reinterpret_cast<float2*>(st + (pw + gq) * N + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(st + (pw + gq + 8) * N + col) = make_float2(acc[n][2], acc[n][3]);
    }
  }

  // the last block of this (b, h, slice) to arrive passes the slice's rows
  // of the state along the chunks: the barrier orders every thread's S_c
  // before thread 0's release, and thread 0's acquire orders the other
  // blocks' S_c and decays before the barrier
  int* is_last = reinterpret_cast<int*>(part + 8);
  int* count = a.counter + bhs;
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(count) : "memory");
    *is_last = prev == a.nc - 1;
    if (*is_last) *count = 0;  // every block of this call has arrived
  }
  __syncthreads();
  if (!*is_last) return;
  // in(c+1) = in(c) * decay(c) + S_c over 8 float4 groups a thread at a
  // time, the next chunk's S read while this chunk's in(c) is stored
  const float* __restrict__ stb = a.chunk_st + (long long)bh * a.nc * PN + off;
  const float* __restrict__ dec = a.chunk_decay + (long long)bhs * a.nc;
  bf16* __restrict__ hib = a.in_hi + (long long)bh * a.nc * PN + off;
  bf16* __restrict__ lob = a.in_lo + (long long)bh * a.nc * PN + off;
  float* __restrict__ fin = a.state + (long long)bh * PN + off;
  constexpr int kGroups = 8;
  for (long long e0 = 4 * tid; e0 < SN; e0 += 4 * NT * kGroups) {
    float4 s[kGroups], u[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long e = e0 + 4LL * NT * k;
      s[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      u[k] = e < SN ? __ldcg(reinterpret_cast<const float4*>(stb + e)) : s[k];
    }
    for (int cc = 0; cc < a.nc; ++cc) {
      const float d = __ldcg(dec + cc);
      float4 next[kGroups];
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const long long e = e0 + 4LL * NT * k;
        next[k] = cc + 1 < a.nc && e < SN
                      ? __ldcg(reinterpret_cast<const float4*>(stb + (cc + 1) * PN + e))
                      : u[k];
      }
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        const long long e = e0 + 4LL * NT * k;
        if (e >= SN) continue;
        if (cc > 0) {
          uint32_t h0, l0, h1, l1;
          split_bf16(s[k].x, s[k].y, h0, l0);
          split_bf16(s[k].z, s[k].w, h1, l1);
          *reinterpret_cast<uint2*>(hib + cc * PN + e) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(lob + cc * PN + e) = make_uint2(l0, l1);
        }
        s[k].x = s[k].x * d + u[k].x;
        s[k].y = s[k].y * d + u[k].y;
        s[k].z = s[k].z * d + u[k].z;
        s[k].w = s[k].w * d + u[k].w;
        u[k] = next[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long e = e0 + 4LL * NT * k;
      if (e < SN) *reinterpret_cast<float4*>(fin + e) = s[k];
    }
  }
}

// ---- 2. chunk scan: one 64-row tile of y of one chunk of one (b, h, slice)
template <bool kSliced>
__global__ void __launch_bounds__(kScanThreads) chunk_scan_kernel(const Args a) {
  using namespace avec::hopper;
  constexpr int NT = kScanThreads;
  // the block index, slowest first: row tile (the last, with the most
  // column tiles, first), batch row, head, chunk, slice (the slices of a
  // tile side by side: they read the same rows of B and C)
  const int ns = kSliced ? a.ns : 1;
  const long long per_tile = (long long)ns * a.nc * a.H * a.batch;
  const int it = a.L / kTile - 1 - (int)(blockIdx.x / per_tile);
  const long long rest = blockIdx.x % per_tile;
  const int sl = (int)(rest % ns), c = (int)((rest / ns) % a.nc);
  const int h = (int)((rest / ((long long)ns * a.nc)) % a.H);
  const int b = (int)(rest / ((long long)ns * a.nc * a.H));
  const int g = h / (a.H / a.G), bh = b * a.H + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  // this block's columns of P: p0 .. p0 + P - 1
  const int p0 = sl * kSliceP, P = kSliced ? min(kSliceP, a.P - p0) : a.P;
  const int N = a.N, L = a.L, NP = N + 8, PP = P + 8;
  const long long s0 = (long long)c * L;
  const int len = (int)min((long long)L, a.S - s0);
  const int i0 = it * kTile;
  if (i0 >= len) return;  // a row tile past S (ragged last chunk)

  float* cum = avec_smem;                                         // [L]
  float* dtv = cum + L;                                           // [L] dt, then the column factors
  bf16* Cs = reinterpret_cast<bf16*>(avec_smem + float_words(L)); // [64][NP] C rows i0..
  bf16* Sh = Cs + kTile * NP;                                     // [P][NP] in(c) hi
  bf16* Sl = Sh + P * NP;                                         // [P][NP] in(c) lo
  bf16* Bs = Sl + P * NP;                                         // [2][64][NP] B tiles
  bf16* Xs = Bs + 2 * kTile * NP;                                 // [2][64][PP] x tiles

  const bf16* xb = a.x + b * a.xs_b + h * a.xs_h + s0 * a.xs_s + p0;
  const bf16* Bb = a.Bm + b * a.bs_b + g * a.bs_g + s0 * a.bs_s;
  const bf16* Cb = a.Cm + b * a.cs_b + g * a.cs_g + s0 * a.cs_s;
  const long long PN = (long long)a.P * N, off = (long long)p0 * N;
  // cum and dt of the chunk, as the chunk-state kernel left them
  const long long cl = ((long long)bh * a.nc + c) * L;
  for (int e = tid; e < L / 4; e += NT) {
    cp_async16(cum + 4 * e, a.chunk_cum + cl + 4 * e, true);
    cp_async16(dtv + 4 * e, a.chunk_dt + cl + 4 * e, true);
  }
  copy_rows<NT>(Cs, NP, Cb + i0 * a.cs_s, a.cs_s, kTile, len - i0, N);
  if (c > 0) {
    copy_rows<NT>(Sh, NP, a.in_hi + ((long long)bh * a.nc + c) * PN + off, N, P, P, N);
    copy_rows<NT>(Sl, NP, a.in_lo + ((long long)bh * a.nc + c) * PN + off, N, P, P, N);
  }
  cp_async_commit();
  auto load_tile = [&](int jt, int buf) {
    const int j0 = jt * kTile;
    copy_rows<NT>(Bs + buf * kTile * NP, NP, Bb + j0 * a.bs_s, a.bs_s, kTile, len - j0, N);
    copy_rows<NT>(Xs + buf * kTile * PP, PP, xb + j0 * a.xs_s, a.xs_s, kTile, len - j0, P);
    cp_async_commit();
  };
  load_tile(0, 0);
  cp_async_wait<1>();
  __syncthreads();  // cum, dt, C and the entering state are in

  // Below the diagonal tile, exp(cum_i - cum_j) = exp(cum_i - c0) exp(c0 -
  // cum_j) with c0 = cum at the end of j's column tile: cum falls along
  // the chunk (dt > 0, A < 0), so both factors are at most 1 and neither
  // overflows.  The column factors exp(c0 - cum_j) dt_j of the tiles left
  // of the diagonal replace dt there.
  for (int j = tid; j < i0; j += NT)
    dtv[j] *= fast_exp2((cum[(j | (kTile - 1))] - cum[j]) * kLog2e);

  // this warp's 16 rows of C as A fragments, held for the whole block
  const int m0 = warp * 16;
  uint32_t cf[kMaxN / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxN / 16; ++kk)
    if (kk * 16 < N)
      ldmatrix_x4<false>(cf[kk], Cs + (m0 + (lane & 15)) * NP + kk * 16 + ((lane >> 4) << 3));

  const int ia = i0 + m0 + gq, ib = ia + 8;  // this thread's two rows in the chunk
  const float ca = cum[ia], cb = cum[ib];
  __syncthreads();  // the column factors are in
  float acc[kSliceP / 8][4];
#pragma unroll
  for (int n = 0; n < kSliceP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // ldmatrix row and column of this lane for a B operand stored by its
  // n index (as is) and by its k index (transposed)
  const int br = (lane & 7) + ((lane >> 4) << 3), bc = ((lane >> 3) & 1) << 3;
  const int tr = (lane & 7) + (((lane >> 3) & 1) << 3), tcol = (lane >> 4) << 3;

  // inter-chunk term exp(cum_i) C_i in(c)^T (in(0) = 0)
  if (c > 0) {
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk) {
      if (kk * 16 >= N) continue;
      // B[n][p] = in[p][n], stored by p: as is; p-tiles 2 p2, 2 p2 + 1
      uint32_t bh4[kSliceP / 16][4], bl4[kSliceP / 16][4];
#pragma unroll
      for (int p2 = 0; p2 < kSliceP / 16; ++p2) {
        if (p2 * 16 >= P) continue;
        ldmatrix_x4<false>(bh4[p2], Sh + (p2 * 16 + br) * NP + kk * 16 + bc);
        ldmatrix_x4<false>(bl4[p2], Sl + (p2 * 16 + br) * NP + kk * 16 + bc);
      }
#pragma unroll
      for (int p2 = 0; p2 < kSliceP / 16; ++p2) {
        if (p2 * 16 >= P) continue;
        mma_bf16_16816(acc[2 * p2], cf[kk], bh4[p2][0], bh4[p2][1]);
        mma_bf16_16816(acc[2 * p2 + 1], cf[kk], bh4[p2][2], bh4[p2][3]);
      }
#pragma unroll
      for (int p2 = 0; p2 < kSliceP / 16; ++p2) {
        if (p2 * 16 >= P) continue;
        mma_bf16_16816(acc[2 * p2], cf[kk], bl4[p2][0], bl4[p2][1]);
        mma_bf16_16816(acc[2 * p2 + 1], cf[kk], bl4[p2][2], bl4[p2][3]);
      }
    }
    const float ea = expf(ca), eb = expf(cb);
#pragma unroll
    for (int n = 0; n < kSliceP / 8; ++n) {
      acc[n][0] *= ea;
      acc[n][1] *= ea;
      acc[n][2] *= eb;
      acc[n][3] *= eb;
    }
  }

  // intra-chunk term: column tiles 0..it (those above the diagonal are zero)
  for (int jt = 0; jt <= it; ++jt) {
    const int buf = jt & 1;
    if (jt < it) {
      load_tile(jt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile jt visible to all
    const bf16* bt = Bs + buf * kTile * NP;
    const bf16* xt = Xs + buf * kTile * PP;

    // scores C_i B_j^T: 16 rows x 64 columns a warp
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk) {
      if (kk * 16 >= N) continue;
      // B[n][j] = Bm[j][n], stored by j: as is; j-tiles 2 j2, 2 j2 + 1
      uint32_t bb[kTile / 16][4];
#pragma unroll
      for (int j2 = 0; j2 < kTile / 16; ++j2)
        ldmatrix_x4<false>(bb[j2], bt + (j2 * 16 + br) * NP + kk * 16 + bc);
#pragma unroll
      for (int j2 = 0; j2 < kTile / 16; ++j2) {
        mma_bf16_16816(s[2 * j2], cf[kk], bb[j2][0], bb[j2][1]);
        mma_bf16_16816(s[2 * j2 + 1], cf[kk], bb[j2][2], bb[j2][3]);
      }
    }
    // * exp(cum_i - cum_j) * dt_j: left of the diagonal as a row factor
    // times the column factor; on the diagonal tile where j <= i, else 0
    // (chosen before the exp)
    const int j0 = jt * kTile;
    if (jt < it) {
      const float c0 = cum[j0 + kTile - 1];
      const float ra = fast_exp2((ca - c0) * kLog2e), rb = fast_exp2((cb - c0) * kLog2e);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const float2 f = *reinterpret_cast<const float2*>(dtv + j0 + n * 8 + 2 * tq);
        s[n][0] *= ra * f.x;
        s[n][1] *= ra * f.y;
        s[n][2] *= rb * f.x;
        s[n][3] *= rb * f.y;
      }
    } else {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + n * 8 + 2 * tq + e;
          const float cj = cum[j], dj = dtv[j];
          s[n][e] = j <= ia ? s[n][e] * fast_exp2((ca - cj) * kLog2e) * dj : 0.f;
          s[n][2 + e] = j <= ib ? s[n][2 + e] * fast_exp2((cb - cj) * kLog2e) * dj : 0.f;
        }
      }
    }
    // y_i += S x_j, S as hi + lo (the accumulator layout of two j-tiles is
    // the A fragment of one 16-wide k step)
#pragma unroll
    for (int k2 = 0; k2 < kTile / 16; ++k2) {
      uint32_t ah[4], al[4], bb[kSliceP / 16][4];
      // B[j][p] = x[j][p], stored by j: transposed; p-tiles 2 p2, 2 p2 + 1
#pragma unroll
      for (int p2 = 0; p2 < kSliceP / 16; ++p2)
        if (p2 * 16 < P) ldmatrix_x4<true>(bb[p2], xt + (k2 * 16 + tr) * PP + p2 * 16 + tcol);
      split_bf16(s[2 * k2][0], s[2 * k2][1], ah[0], al[0]);
      split_bf16(s[2 * k2][2], s[2 * k2][3], ah[1], al[1]);
      split_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1], ah[2], al[2]);
      split_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3], ah[3], al[3]);
#pragma unroll
      for (int p2 = 0; p2 < kSliceP / 16; ++p2) {
        if (p2 * 16 >= P) continue;
        mma_bf16_16816(acc[2 * p2], ah, bb[p2][0], bb[p2][1]);
        mma_bf16_16816(acc[2 * p2 + 1], ah, bb[p2][2], bb[p2][3]);
      }
#pragma unroll
      for (int p2 = 0; p2 < kSliceP / 16; ++p2) {
        if (p2 * 16 >= P) continue;
        mma_bf16_16816(acc[2 * p2], al, bb[p2][0], bb[p2][1]);
        mma_bf16_16816(acc[2 * p2 + 1], al, bb[p2][2], bb[p2][3]);
      }
    }
    __syncthreads();  // tile jt's buffers are refilled two steps on
  }

  bf16* yb = a.y + b * a.ys_b + h * a.ys_h + s0 * a.ys_s + p0;
#pragma unroll
  for (int n = 0; n < kSliceP / 8; ++n) {
    if (n * 8 >= P) continue;
    const int p = n * 8 + 2 * tq;
    if (ia < len)
      *reinterpret_cast<__nv_bfloat162*>(yb + ia * a.ys_s + p) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (ib < len)
      *reinterpret_cast<__nv_bfloat162*>(yb + ib * a.ys_s + p) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

template <bool kSliced>
int launch(const Args& a, size_t smem_state, size_t smem_scan, cudaStream_t stream) {
  // the opt-in to more than 48 KB of shared memory, made once per kernel,
  // device and size rather than as a runtime API call on every scan
  constexpr int kMaxDevices = 64;
  static size_t state_set[kMaxDevices], scan_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= kMaxDevices || smem_state > state_set[dev])) {
    err = avec::allow_smem(chunk_state_kernel<kSliced>, smem_state);
    if (err == cudaSuccess && dev < kMaxDevices) state_set[dev] = smem_state;
  }
  if (err == cudaSuccess && (dev >= kMaxDevices || smem_scan > scan_set[dev])) {
    err = avec::allow_smem(chunk_scan_kernel<kSliced>, smem_scan);
    if (err == cudaSuccess && dev < kMaxDevices) scan_set[dev] = smem_scan;
  }
  if (err != cudaSuccess) return (int)err;
  chunk_state_kernel<kSliced><<<dim3((unsigned)(a.ns * a.nc), (unsigned)a.H,
                                     (unsigned)a.batch), kStateThreads, smem_state, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)(a.L / kTile) * a.ns * a.nc * a.H * a.batch;
  chunk_scan_kernel<kSliced><<<(unsigned)blocks, kScanThreads, smem_scan, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch(const Args& a, cudaStream_t stream) {
  // the widest slice's shared memory
  const size_t PS = a.P < kSliceP ? a.P : kSliceP, NP = a.N + 8, PP = PS + 8;
  const size_t f = float_words(a.L) * sizeof(float);
  const size_t smem_state =
      f + ((kStages + 2) * kTile * PP + kStages * kTile * NP) * sizeof(bf16);
  const size_t smem_scan = f + (3 * kTile * NP + 2 * PS * NP + 2 * kTile * PP) * sizeof(bf16);
  return a.ns > 1 ? launch<true>(a, smem_state, smem_scan, stream)
                  : launch<false>(a, smem_state, smem_scan, stream);
}

}  // namespace tc

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

// The tensor-core branch (see the note at the top): bf16 x, B, C with rows
// on 16 bytes; P <= 128 and N <= 128, multiples of 16; L a multiple of 64
// up to 2048; ns = ceil(P / 64) slices of P.  Scratch: chunk_st
// B*H*nc*(P*N + 2*L + ns) floats (the chunk states, then cum, dt and the
// decays), in_hi and in_lo B*H*nc*P*N bf16 each, counter B*H*ns ints, zero
// on entry and on return.
extern "C" int avec_ssd_scan_tc(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, void* y, void* state, void* chunk_st,
                                void* in_hi, void* in_lo, void* counter, int batch,
                                long long S, int H, int P, int G, int N, int L,
                                long long xs_b, long long xs_s, long long xs_h, long long dts_b,
                                long long dts_s, long long dts_h, long long bs_b, long long bs_s,
                                long long bs_g, long long cs_b, long long cs_s, long long cs_g,
                                long long ys_b, long long ys_s, long long ys_h, void* stream) {
  using tc::kTile;
  if (batch < 0 || batch > 65535 || S <= 0 || H <= 0 || H > 65535 || G <= 0 || H % G != 0 ||
      P <= 0 || P > tc::kMaxP || P % 16 != 0 || N <= 0 || N > tc::kMaxN || N % 16 != 0 ||
      L <= 0 || L > tc::kMaxL || L % kTile != 0)
    return avec::kUnsupported;
  if (batch == 0) return 0;
  const long long nc = (S + L - 1) / L;
  const int ns = (P + tc::kSliceP - 1) / tc::kSliceP;
  if (ns * nc * H * batch * (L / kTile) > 0x7fffffffLL) return avec::kUnsupported;
  const long long states = (long long)batch * H * nc * P * N;
  using tc::bf16;
  float* f32 = static_cast<float*>(chunk_st);
  const long long cums = (long long)batch * H * nc * L;
  tc::Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
             static_cast<const float*>(A), static_cast<const bf16*>(Bm),
             static_cast<const bf16*>(Cm), static_cast<bf16*>(y), static_cast<float*>(state),
             f32, f32 + states, f32 + states + cums, f32 + states + 2 * cums,
             static_cast<bf16*>(in_hi), static_cast<bf16*>(in_lo), static_cast<int*>(counter),
             S, batch, H, P, G, N, L, (int)nc, ns, xs_b, xs_s, xs_h, dts_b, dts_s, dts_h, bs_b, bs_s,
             bs_g, cs_b, cs_s, cs_g, ys_b, ys_s, ys_h};
  return tc::launch(a, static_cast<cudaStream_t>(stream));
}
