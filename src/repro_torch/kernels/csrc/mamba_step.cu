// One decode step of a Mamba-2 layer's mixer, between its input projections
// and its output projection `wo`, for each of B rows:
//
//   dt = softplus(u . wdt[:, h] + dt_bias)      (the fp32 dt projection)
//   dA = exp(-exp(A_log) * dt)
//   x, B, C = silu(causal depthwise conv over the window and the new x, B, C)
//   state = state * dA + dt * x (outer) B       (in place, fp32)
//   y = state . C + D * x
//   out = rmsnorm(y * silu(z)) * norm_scale     (over all d_inner channels)
//
// Replaces no TPU kernel: the JAX package's decode step is plain array code
// (repro/models/mamba.py `mamba_decode`, ssd.py `ssd_step`), and so was the
// port's, some 40 small kernels a layer between the projections and `wo`.
// Its bound is bytes: the state, read once and written once, is 4.2 MB a
// layer at granite-4.0-h-small's 128 heads of 64 x 128 (2.5 us at 3.35 TB/s),
// the rest a few KB.  At a B-1 decode its time is its launch and a chain of
// dependent memory round trips, not bandwidth.
//
// Design: one block per (head, slice of P, batch row).  Each block issues its
// slice's state loads (16-byte vectors, a warp a row of N = 128) before
// anything else, so they are in flight while it computes dt (its head's
// column of wdt against the row's input) and the conv of its slice's x
// channels and of its group's B and C channels (recomputed by every block of
// the group: cheaper than a second launch).  The x channels' conv window is
// shifted in place in the cache (each channel belongs to one block); then the
// state is updated and written back, y reduced over N by shuffles, and the
// gated value y * silu(z), times the norm's scale, written to fp32 scratch
// with the block's sum of the gated values' squares.  The gated RMSNorm spans
// all heads: the last block of the row to arrive -- found by an integer
// counter (acquire-release atomic), which it resets to 0 so the kernel can be
// replayed in a CUDA graph -- sums the blocks' partial sums in a fixed order
// (no float atomics: two calls give bit-identical output), normalises the row
// and writes it in the activations' type.  It also shifts the group channels'
// (B and C) conv window, which every block of the row read and which no block
// may change before all have.  Every load of a phase (the conv's taps with
// dt's product, the row's normalisation with the partial sums) is issued
// before its values are used, so that each phase costs one round trip.
// Everything between the inputs and the output stays in fp32.  The host
// (mamba_step.py `mamba_step_plan`) picks the slices from the shapes and the
// SM count.
#include "common.cuh"

namespace {

constexpr int NT = 256;       // threads a block
constexpr int NW = NT / 32;
constexpr int KMAX = 8;       // state rows a thread holds
constexpr int DU = 16;        // loads a thread keeps in flight in the dt product and the norm
constexpr int MAX_CK = 4;     // conv taps
constexpr int MAX_N = 128;
constexpr int MAX_PS = 128;   // rows of P a block

struct Args {
  const void *u, *z, *x, *bm, *cm;     // (B,dm), (B,di), (B,di), (B,gn), (B,gn): T
  const void* wdt;                     // (dm, H): TW
  const float *dt_bias, *a_log, *d_skip, *scale;   // (H,), (H,), (H,), (di,)
  const void *wx, *wb, *wc, *bx, *bb, *bc;         // (ck,di), (ck,gn) x2, (di,), (gn,) x2: TW
  void* conv;                          // (B, ck-1, di + 2 gn): TC, in place
  float* state;                        // (B, H, P, N), in place
  void* out;                           // (B, di): T
  float *gated, *partial;              // scratch: (B, di), (B, H * S)
  int* counter;                        // (B,), 0 on entry and on return
  int H, P, N, G, ck, dm, S;           // S slices of P
  long long u_sb, z_sb, x_sb, b_sb, c_sb, conv_sb, state_sb, out_sb;   // batch strides
  float eps;
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// four values to 4 consecutive elements of type T (16 or 8 bytes, aligned)
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = u;
}

// v summed over the block, in a fixed order; every thread gets the sum
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = avec::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) t += red[w];
  __syncthreads();
  return t;
}

// one channel's conv taps: the ck-1 cached values, the new value, the ck
// weights and the bias, as floats (loops unrolled with guards: registers)
struct Taps {
  float win[MAX_CK - 1], w[MAX_CK], nv, bias;
};

// channel j's taps: the window at win[k * cstride], weights w[k * wcols + j]
template <typename T, typename TW, typename TC>
__device__ __forceinline__ Taps load_taps(const TC* win, long long cstride, T nv, const TW* w,
                                          int wcols, int j, const TW* bias, int ck) {
  using namespace avec;
  Taps t;
#pragma unroll
  for (int k = 0; k < MAX_CK; ++k) {
    if (k < ck - 1) t.win[k] = to_float(win[k * cstride]);
    if (k < ck) t.w[k] = to_float(w[k * wcols + j]);
  }
  t.nv = to_float(nv);
  t.bias = to_float(bias[j]);
  return t;
}

// silu(the causal conv over the window and the new value, plus the bias)
__device__ __forceinline__ float conv_out(const Taps& t, int ck) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_CK - 1; ++k)
    if (k < ck - 1) acc = fmaf(t.win[k], t.w[k], acc);
#pragma unroll
  for (int k = 0; k < MAX_CK; ++k)
    if (k == ck - 1) acc = fmaf(t.nv, t.w[k], acc);
  return silu(acc + t.bias);
}

// the window at win[k * cstride] moved one step, the new value last
template <typename TC>
__device__ __forceinline__ void shift_window(TC* win, long long cstride, const Taps& t, int ck) {
  using namespace avec;
  if (ck < 2) return;
#pragma unroll
  for (int k = 0; k < MAX_CK - 2; ++k)
    if (k < ck - 2) win[k * cstride] = from_float<TC>(t.win[k + 1]);
  win[(ck - 2) * cstride] = from_float<TC>(t.nv);
}

template <typename T, typename TW, typename TC>
__global__ void __launch_bounds__(NT) mamba_step_kernel(const Args a) {
  using namespace avec;
  __shared__ float xs[MAX_PS], bs[MAX_N], cs[MAX_N], red[NW];
  __shared__ int is_last;
  const int tid = threadIdx.x, b = blockIdx.y;
  const int h = blockIdx.x / a.S, s = blockIdx.x - h * a.S;
  const int PS = a.P / a.S, c0 = h * a.P + s * PS;     // the slice's first x channel
  const int di = a.H * a.P, gn = a.G * a.N, cdim = di + 2 * gn;
  const int g = h / (a.H / a.G);
  TC* conv = static_cast<TC*>(a.conv) + b * a.conv_sb;

  // the slice's state rows: thread q-th vector of N in rows r0, r0 + RPP, ...
  // (and, for the first thread of a row, the row's z and norm scale)
  const int VPR = a.N / 4, RPP = NT / VPR, q = tid % VPR, r0 = tid / VPR;
  float* st = a.state + b * a.state_sb + (long long)c0 * a.N;
  const T* z = static_cast<const T*>(a.z) + b * a.z_sb;
  float4 v[KMAX];
  float zs[KMAX], sc[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int r = r0 + k * RPP;
    if (r < PS) {
      v[k] = *reinterpret_cast<const float4*>(st + r * a.N + 4 * q);
      if (q == 0) zs[k] = to_float(z[c0 + r]), sc[k] = a.scale[c0 + r];
    }
  }

  // the conv's taps: the group's B and C channels (their window moved by the
  // row's last block), one a thread, and the slice's x channels, one a
  // thread; loaded before dt's product so that both are in flight together
  const T* xin = static_cast<const T*>(a.x) + b * a.x_sb;
  const T* bin = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cin = static_cast<const T*>(a.cm) + b * a.c_sb;
  const bool isb = tid < a.N;
  Taps tbc, tx;
  if (tid < 2 * a.N) {
    const int j = g * a.N + (isb ? tid : tid - a.N);
    tbc = load_taps(conv + di + (isb ? 0 : gn) + j, cdim, isb ? bin[j] : cin[j],
                    static_cast<const TW*>(isb ? a.wb : a.wc), gn, j,
                    static_cast<const TW*>(isb ? a.bb : a.bc), a.ck);
  }
  if (tid < PS)
    tx = load_taps(conv + c0 + tid, cdim, xin[c0 + tid], static_cast<const TW*>(a.wx), di,
                   c0 + tid, static_cast<const TW*>(a.bx), a.ck);

  // dt's product, DU loads of u and of wdt's column a thread in flight
  const T* u = static_cast<const T*>(a.u) + b * a.u_sb;
  const TW* wdt = static_cast<const TW*>(a.wdt);
  float acc = 0.f;
  for (int i0 = 0; i0 < a.dm; i0 += NT * DU) {
    float uv[DU], wv[DU];
#pragma unroll
    for (int k = 0; k < DU; ++k) {
      const int i = i0 + tid + k * NT;
      uv[k] = i < a.dm ? to_float(u[i]) : 0.f;
      wv[k] = i < a.dm ? to_float(wdt[(long long)i * a.H + h]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < DU; ++k) acc = fmaf(uv[k], wv[k], acc);
  }

  if (tid < 2 * a.N) (isb ? bs : cs)[isb ? tid : tid - a.N] = conv_out(tbc, a.ck);
  if (tid < PS) {
    xs[tid] = conv_out(tx, a.ck);
    shift_window(conv + c0 + tid, cdim, tx, a.ck);
  }
  // (block_sum's barriers also publish xs, bs and cs)
  const float raw = block_sum(acc, red) + a.dt_bias[h];
  const float dt = raw > 20.f ? raw : log1pf(expf(raw));   // softplus, threshold 20
  const float dA = expf(dt * -expf(a.a_log[h]));

  // the state update, y = C . state + D x, the gate; the scratch takes the
  // gated value times the norm's scale, the block's partial sum the squares
  float bq[4], cq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bq[i] = bs[4 * q + i], cq[i] = cs[4 * q + i];
  const float dskip = a.d_skip[h];
  float* gated = a.gated + (long long)b * di;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k * RPP >= PS) continue;                  // uniform: no row of the block left
    const int r = r0 + k * RPP;
    const bool live = r < PS;
    const float xv = live ? xs[r] : 0.f, dtx = dt * xv;
    float y = 0.f;
    if (live) {
      float4 n = v[k];
      n.x = fmaf(n.x, dA, dtx * bq[0]);
      n.y = fmaf(n.y, dA, dtx * bq[1]);
      n.z = fmaf(n.z, dA, dtx * bq[2]);
      n.w = fmaf(n.w, dA, dtx * bq[3]);
      *reinterpret_cast<float4*>(st + r * a.N + 4 * q) = n;
      y = n.x * cq[0] + n.y * cq[1] + n.z * cq[2] + n.w * cq[3];
    }
    for (int o = VPR / 2; o > 0; o >>= 1) y += __shfl_xor_sync(0xffffffffu, y, o);
    if (live && q == 0) {
      const float gv = (y + dskip * xv) * silu(zs[k]);
      gated[c0 + r] = gv * sc[k];
      ss = fmaf(gv, gv, ss);
    }
  }
  ss = block_sum(ss, red);
  const int HS = a.H * a.S;
  if (tid == 0) a.partial[(long long)b * HS + blockIdx.x] = ss;

  // the last block of the row to arrive: the barrier orders the block's
  // writes before thread 0's release, thread 0's acquire orders the other
  // blocks' before the barrier
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(a.counter + b) : "memory");
    is_last = prev == HS - 1;
    if (is_last) a.counter[b] = 0;   // every block of this row has arrived
  }
  __syncthreads();
  if (!is_last) return;

  // the row's first NT * DU vectors of 16 bytes, the partial sums and the B
  // and C window, all loaded together; the window then moves one step (every
  // block has read it)
  const float4* g4 = reinterpret_cast<const float4*>(gated);
  const int nv4 = di / 4;
  float4 gv[DU];
#pragma unroll
  for (int k = 0; k < DU; ++k)
    if (tid + k * NT < nv4) gv[k] = __ldcg(g4 + tid + k * NT);
  float tot = 0.f;
  for (int i = tid; i < HS; i += NT) tot += __ldcg(a.partial + (long long)b * HS + i);
  if (a.ck > 1)
    for (int j = tid; j < 2 * gn; j += NT) {
      TC* win = conv + di + j;
      const T nv = j < gn ? bin[j] : cin[j - gn];
#pragma unroll
      for (int k = 0; k < MAX_CK - 2; ++k)
        if (k < a.ck - 2) win[k * cdim] = win[(k + 1) * cdim];
      win[(a.ck - 2) * cdim] = from_float<TC>(to_float(nv));
    }
  const float rs = rsqrtf(block_sum(tot, red) / (float)di + a.eps);
  T* out = static_cast<T*>(a.out) + b * a.out_sb;
  for (int i0 = 0; i0 < nv4; i0 += NT * DU) {
    if (i0 > 0) {                          // rows past NT * DU vectors
#pragma unroll
      for (int k = 0; k < DU; ++k)
        if (i0 + tid + k * NT < nv4) gv[k] = __ldcg(g4 + i0 + tid + k * NT);
    }
#pragma unroll
    for (int k = 0; k < DU; ++k) {
      const int i = i0 + tid + k * NT;
      if (i < nv4) store4(out + 4 * i, gv[k].x * rs, gv[k].y * rs, gv[k].z * rs, gv[k].w * rs);
    }
  }
}

template <typename T, typename TW, typename TC>
int launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(a.H * a.S, B);
  mamba_step_kernel<T, TW, TC><<<grid, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename TW>
int dispatch_cache(int tc, const Args& a, int B, cudaStream_t s) {
  switch (tc) {
    case avec::kF32: return launch<T, TW, float>(a, B, s);
    case avec::kBF16: return launch<T, TW, __nv_bfloat16>(a, B, s);
    default: return avec::kUnsupported;
  }
}

template <typename T>
int dispatch_weights(int tw, int tc, const Args& a, int B, cudaStream_t s) {
  switch (tw) {
    case avec::kF32: return dispatch_cache<T, float>(tc, a, B, s);
    case avec::kBF16: return dispatch_cache<T, __nv_bfloat16>(tc, a, B, s);
    default: return avec::kUnsupported;
  }
}

}  // namespace

// Pointers as in `Args`, every tensor contiguous past its batch stride
// (strides in elements); the state on 16 bytes.  dtype: the activations
// (u, z, x, B, C, out), w_dtype: wdt and the conv weights and biases,
// conv_dtype: the conv cache; f32 or bf16 each.  P a multiple of 4; S
// slices of P, each at most MAX_PS rows, with (P / S) * N / 4 <= KMAX * NT;
// N a multiple of 4 whose quarter divides 32, up to MAX_N; G divides H;
// 1 <= ck <= MAX_CK.  gated: B * H * P floats, partial: B * H * S floats,
// counter: B ints.
extern "C" int avec_mamba_step(const void* u, const void* z, const void* x, const void* bm,
                               const void* cm, const void* wdt, const void* dt_bias,
                               const void* a_log, const void* d_skip, const void* wx,
                               const void* wb, const void* wc, const void* bx, const void* bb,
                               const void* bc, const void* scale, void* conv, void* state,
                               void* out, void* gated, void* partial, void* counter, int dtype,
                               int w_dtype, int conv_dtype, int B, int H, int P, int N, int G,
                               int ck, int dm, int S, long long u_sb, long long z_sb,
                               long long x_sb, long long b_sb, long long c_sb,
                               long long conv_sb, long long state_sb, long long out_sb,
                               float eps, void* stream) {
  if (B == 0) return 0;
  const int vpr = N / 4;
  if (B < 0 || B > 65535 || H <= 0 || G <= 0 || H % G || P <= 0 || P % 4 || S <= 0 ||
      P % S || P / S > MAX_PS || N <= 0 || N % 4 || N > MAX_N || 32 % vpr ||
      (P / S) * vpr > KMAX * NT ||
      ck < 1 || ck > MAX_CK || dm <= 0)
    return avec::kUnsupported;
  Args a{u, z, x, bm, cm, wdt,
         static_cast<const float*>(dt_bias), static_cast<const float*>(a_log),
         static_cast<const float*>(d_skip), static_cast<const float*>(scale),
         wx, wb, wc, bx, bb, bc, conv, static_cast<float*>(state), out,
         static_cast<float*>(gated), static_cast<float*>(partial), static_cast<int*>(counter),
         H, P, N, G, ck, dm, S, u_sb, z_sb, x_sb, b_sb, c_sb, conv_sb, state_sb, out_sb, eps};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case avec::kF32: return dispatch_weights<float>(w_dtype, conv_dtype, a, B, s);
    case avec::kBF16: return dispatch_weights<__nv_bfloat16>(w_dtype, conv_dtype, a, B, s);
    default: return avec::kUnsupported;
  }
}
