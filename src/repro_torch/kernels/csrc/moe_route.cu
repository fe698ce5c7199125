// A dropless MoE's routing and combine at a decode, one launch each, for
// the T*k assignments of T tokens to their top k of E experts:
//
//   moe_route:   probs = softmax(x . router)       (fp32, x widened in registers)
//                top k of probs, an exact tie to the lower expert id
//                w = the top k over their sum       (fp32)
//                the assignments stably sorted by expert id:
//                  rows[i] = x[order[i] / k], w in bf16, order, and each
//                  expert's end row `ends` (for ops.moe_experts)
//   moe_combine: y[t] = sum over j of bf16(out[i] * w[i]), i the sorted row of
//                assignment t*k + j, summed in fp32 in j order and rounded
//                once; then + the shared expert's output, rounded again
//
// Replaces no TPU kernel: the JAX package routes with plain array code
// (repro/models/moe.py), and so did the port's dropless dispatch, some twenty
// small kernels a layer (the router's GEMV, softmax, top-k, a radix sort, a
// search, gathers, scatters and a sum), which at a B-1 decode cost their
// launches and the gaps between them, not their bytes: the router is 1.18 MB
// fp32 at granite-4.0-h-small's d 4096 and E 72 (0.35 us at 3.35 TB/s), the
// k rows of x and of the experts' output 80 KB each.
//
// moe_route: one block per (slice of rb router rows, token).  Each
// thread loads its rows' 16-byte vectors of the router and the matching
// values of x, all in flight at once, and the block writes the slice's fp32
// partial logits to scratch.  The last block to arrive -- found by an integer
// counter (acquire-release atomic), which it resets to 0 so that the kernel
// can be replayed in a CUDA graph -- sums each logit's partials in a fixed
// order (no float atomics: two calls give bit-identical output); a warp a
// token takes the softmax; each probability's rank among its token's gives
// the top k at once, one thread an expert; then the renormalisation.  The
// block counts the assignments of each expert, scans the counts into start
// rows, places each assignment after the earlier ones of its expert (the
// stable order), and copies x's rows into place, each vector loaded once and
// stored k times.  The last block does all of that alone: MAX_ROWS bounds
// what it sorts in shared memory and what it copies (at a B-1 decode its
// work is a few round trips; at B 32 the copy of 2.6 MB through one SM is
// most of its time).
//
// moe_combine: one block per (slice of CT * 8 columns, token).  The block
// finds its token's k sorted rows by a scan of `order`; each thread then
// loads its 8 columns of the k rows (16 bytes each) and the k weights
// together, and writes its 8 columns of y.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;           // threads of a route block
constexpr int NW = NT / 32;
constexpr int MAX_E = 256;        // experts, a multiple of 4
constexpr int MAX_K = 32;         // experts a token
constexpr int MAX_ROWS = 512;     // assignments, T * k
constexpr int MAX_TE = 4096;      // logits the last block holds at once
constexpr int DU = 16;            // loads a thread keeps in flight
constexpr int PRE = 4;            // vectors of x's rows a thread of the last block loads first
constexpr int EPL = MAX_E / 32;   // experts a lane holds in the softmax
constexpr int CT = 128;           // threads of a combine block
constexpr int KC = 16;            // rows a combine thread loads at once

struct RouteArgs {
  const bf16* x;          // (T, d), rows at stride x_sb, on 16 bytes
  const float* router;    // (d, E), contiguous, on 16 bytes
  bf16* rows;             // (T*k, d), contiguous
  int* ends;              // (E,)
  bf16* w;                // (T*k,)
  int* order;             // (T*k,)
  float* partial;         // scratch: (T, S, E)
  int* counter;           // 1 int, 0 on entry and on return
  long long x_sb;
  int T, d, E, k, rb, S;  // S slices of rb router rows
};

__global__ void __launch_bounds__(NT) moe_route_kernel(const RouteArgs a) {
  using namespace avec;
  __shared__ __align__(16) float red[NT * 4];
  __shared__ float lg[MAX_TE], sel_p[MAX_ROWS];
  __shared__ int sel_e[MAX_ROWS], dest[MAX_ROWS], cnt[MAX_E], start[MAX_E];
  __shared__ int is_last;
  const int tid = threadIdx.x, s = blockIdx.x, t = blockIdx.y;

  // the slice's partial logits: thread (lane, q) sums rows lane, lane + L, ...
  // of the slice against experts 4q .. 4q+3
  const int VPR = a.E / 4, L = NT / VPR, q = tid % VPR, lane = tid / VPR;
  const int r0 = s * a.rb, nr = min(a.rb, a.d - r0);
  const float4* rt = reinterpret_cast<const float4*>(a.router) + (long long)r0 * VPR + q;
  const bf16* xr = a.x + t * a.x_sb + r0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < L) {
    for (int j0 = lane; j0 < nr; j0 += L * DU) {
      float4 v[DU];
      float xv[DU];
#pragma unroll
      for (int u = 0; u < DU; ++u) {
        const int r = j0 + u * L;
        if (r < nr) v[u] = rt[(long long)r * VPR], xv[u] = to_float(xr[r]);
      }
#pragma unroll
      for (int u = 0; u < DU; ++u) {
        if (j0 + u * L < nr) {
          acc.x = fmaf(xv[u], v[u].x, acc.x);
          acc.y = fmaf(xv[u], v[u].y, acc.y);
          acc.z = fmaf(xv[u], v[u].z, acc.z);
          acc.w = fmaf(xv[u], v[u].w, acc.w);
        }
      }
    }
    *reinterpret_cast<float4*>(red + lane * a.E + 4 * q) = acc;
  }
  __syncthreads();
  for (int e = tid; e < a.E; e += NT) {
    float sum = 0.f;
    for (int l = 0; l < L; ++l) sum += red[l * a.E + e];
    a.partial[((long long)t * a.S + s) * a.E + e] = sum;
  }

  // the last block to arrive: the barrier orders the block's writes before
  // thread 0's release, thread 0's acquire orders the other blocks' before
  // the barrier
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(a.counter) : "memory");
    is_last = prev == a.S * a.T - 1;
    if (is_last) a.counter[0] = 0;   // every block has arrived
  }
  __syncthreads();
  if (!is_last) return;

  // the first PRE vectors a thread of x's rows, loaded now: they wait on
  // nothing, and the copy below waits on the sort
  const int vpr = a.d / 8, nv = a.T * vpr;
  const uint4* x4 = reinterpret_cast<const uint4*>(a.x);
  const long long xs4 = a.x_sb / 8;
  uint4 pre[PRE];
#pragma unroll
  for (int u = 0; u < PRE; ++u) {
    const int v = tid + u * NT, tk = v / vpr;
    if (v < nv) pre[u] = x4[tk * xs4 + (v - tk * vpr)];
  }

  const int warp = tid >> 5, ln = tid & 31, Tk = a.T * a.k;
  const float ninf = __int_as_float(0xff800000);
  const int tch = MAX_TE / a.E;    // tokens whose logits fit at once
  for (int t0 = 0; t0 < a.T; t0 += tch) {
    const int nt = min(tch, a.T - t0), np = nt * a.E;
    // each logit: its slices' partials summed in slice order, in G groups of
    // consecutive slices (then the groups in order) where the logits alone
    // would leave threads idle
    const int G = max(1, min(NT / np, a.S)), SG = (a.S + G - 1) / G;
    for (int p = tid; p < np * G; p += NT) {
      const int g = p / np, pe = p - g * np, tt = pe / a.E, e = pe - tt * a.E;
      const float* pp = a.partial + (long long)(t0 + tt) * a.S * a.E + e;
      const int s1 = min(a.S, (g + 1) * SG);
      float sum = 0.f;
      for (int s0 = g * SG; s0 < s1; s0 += DU) {
        float v[DU];
#pragma unroll
        for (int u = 0; u < DU; ++u)
          if (s0 + u < s1) v[u] = __ldcg(pp + (long long)(s0 + u) * a.E);
#pragma unroll
        for (int u = 0; u < DU; ++u)
          if (s0 + u < s1) sum += v[u];
      }
      (G > 1 ? red : lg)[p] = sum;     // np * G <= NT <= the size of red
    }
    __syncthreads();
    if (G > 1) {
      for (int p = tid; p < np; p += NT) {
        float sum = 0.f;
        for (int g = 0; g < G; ++g) sum += red[g * np + p];
        lg[p] = sum;
      }
      __syncthreads();
    }
    // a warp a token: the softmax, lane l holding experts l, l + 32, ...;
    // the probabilities replace the logits
    for (int tt = warp; tt < nt; tt += NW) {
      float* l = lg + tt * a.E;
      float v[EPL];
      float mx = ninf;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int e = ln + 32 * i;
        v[i] = e < a.E ? l[e] : ninf;
        mx = max_nan(mx, v[i]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        if (ln + 32 * i < a.E) v[i] = expf(v[i] - mx), sum += v[i];
      sum = warp_sum(sum);
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        if (ln + 32 * i < a.E) l[ln + 32 * i] = v[i] / sum;
    }
    __syncthreads();
    // the top k: each probability's rank among its token's, larger first and
    // an exact tie to the lower expert id (a NaN ranks as -inf: the ranks are
    // a permutation whatever the values); rank j < k is the j-th choice
    for (int p = tid; p < np; p += NT) {
      const int tt = p / a.E, e = p - tt * a.E;
      const float* pr = lg + tt * a.E;
      const float pv = pr[e], v = isnan(pv) ? ninf : pv;
      int rank = 0;
      for (int f = 0; f < a.E; ++f) {
        const float u = isnan(pr[f]) ? ninf : pr[f];
        rank += u > v || (u == v && f < e);
      }
      if (rank < a.k) sel_e[(t0 + tt) * a.k + rank] = e, sel_p[(t0 + tt) * a.k + rank] = pv;
    }
    __syncthreads();
    // the renormalisation: the k choices over their sum, taken in order
    for (int tt = tid; tt < nt; tt += NT) {
      float* sp = sel_p + (t0 + tt) * a.k;
      float tot = 0.f;
      for (int j = 0; j < a.k; ++j) tot += sp[j];
      for (int j = 0; j < a.k; ++j) sp[j] = sp[j] / tot;
    }
    __syncthreads();
  }

  // the stable counting sort: each expert's count, its start row (a warp's
  // scan, 8 experts a lane), and each assignment after the earlier ones of
  // its expert
  for (int e = tid; e < a.E; e += NT) cnt[e] = 0;
  __syncthreads();
  for (int i = tid; i < Tk; i += NT) atomicAdd(&cnt[sel_e[i]], 1);
  __syncthreads();
  if (warp == 0) {
    int c[MAX_E / 32], own = 0;
#pragma unroll
    for (int u = 0; u < MAX_E / 32; ++u) {
      const int e = ln * (MAX_E / 32) + u;
      c[u] = e < a.E ? cnt[e] : 0;
      own += c[u];
    }
    int inc = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, inc, o);
      if (ln >= o) inc += n;
    }
    int run = inc - own;
#pragma unroll
    for (int u = 0; u < MAX_E / 32; ++u) {
      const int e = ln * (MAX_E / 32) + u;
      if (e < a.E) start[e] = run, run += c[u], a.ends[e] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < Tk; i += NT) {
    const int e = sel_e[i];
    int rank = 0;
    for (int j = 0; j < i - i % a.k; ++j) rank += sel_e[j] == e;   // earlier tokens'
    const int pos = start[e] + rank;
    a.order[pos] = i;
    a.w[pos] = __float2bfloat16(sel_p[i]);
    dest[i] = pos;
  }
  __syncthreads();

  // x's rows into place: each 16-byte vector of a token's row loaded once
  // (those past the first PRE a thread DU at a time) and stored at its k
  // places
  uint4* o4 = reinterpret_cast<uint4*>(a.rows);
#pragma unroll
  for (int u = 0; u < PRE; ++u) {
    const int v = tid + u * NT, tk = v / vpr;
    if (v < nv)
      for (int j = 0; j < a.k; ++j)
        o4[(long long)dest[tk * a.k + j] * vpr + (v - tk * vpr)] = pre[u];
  }
  for (int v0 = PRE * NT; v0 < nv; v0 += NT * DU) {
    uint4 buf[DU];
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      const int v = v0 + tid + u * NT, tk = v / vpr;
      if (v < nv) buf[u] = x4[tk * xs4 + (v - tk * vpr)];
    }
#pragma unroll
    for (int u = 0; u < DU; ++u) {
      const int v = v0 + tid + u * NT, tk = v / vpr;
      if (v < nv)
        for (int j = 0; j < a.k; ++j)
          o4[(long long)dest[tk * a.k + j] * vpr + (v - tk * vpr)] = buf[u];
    }
  }
}

struct CombineArgs {
  const bf16* out;        // (T*k, d), contiguous, on 16 bytes
  const bf16* w;          // (T*k,)
  const int* order;       // (T*k,)
  const bf16* shared;     // (T, d) at row stride shared_sb, on 16 bytes; or null
  bf16* y;                // (T, d), contiguous
  long long shared_sb;
  int T, d, k;
};

__global__ void __launch_bounds__(CT) moe_combine_kernel(const CombineArgs a) {
  using namespace avec;
  __shared__ int pos[MAX_K];
  const int tid = threadIdx.x, t = blockIdx.y, Tk = a.T * a.k;
  for (int p = tid; p < Tk; p += CT) {
    const int o = a.order[p];
    if (o / a.k == t) pos[o - t * a.k] = p;
  }
  __syncthreads();
  const int vpr = a.d / 8, v = blockIdx.x * CT + tid;
  if (v >= vpr) return;
  const uint4* o4 = reinterpret_cast<const uint4*>(a.out) + v;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < a.k; j0 += KC) {
    uint4 r[KC];
    float wj[KC];
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      if (j0 + u < a.k) {
        const int p = pos[j0 + u];
        r[u] = o4[(long long)p * vpr];
        wj[u] = to_float(a.w[p]);
      }
    }
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      if (j0 + u < a.k) {
        const bf16* h = reinterpret_cast<const bf16*>(&r[u]);
#pragma unroll
        for (int c = 0; c < 8; ++c)   // each product rounded to bf16, as out * w is
          acc[c] += to_float(from_float<bf16>(to_float(h[c]) * wj[u]));
      }
    }
  }
  float sh[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (a.shared) unpack16<bf16>(load16(a.shared + t * a.shared_sb + 8 * v), sh);
  uint4 res;
  bf16* yv = reinterpret_cast<bf16*>(&res);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float sum = to_float(from_float<bf16>(acc[c]));   // the routed sum, rounded once
    yv[c] = from_float<bf16>(a.shared ? sum + sh[c] : sum);
  }
  reinterpret_cast<uint4*>(a.y + (long long)t * a.d)[v] = res;
}

}  // namespace

// x (T, d) and rows (T*k, d) bf16, router (d, E) fp32 contiguous, both on 16
// bytes; ends (E,), order (T*k,) int32, w (T*k,) bf16.  E a multiple of 4 up
// to MAX_E, 1 <= k <= min(E, MAX_K), T * k <= MAX_ROWS, d and x_sb multiples
// of 8, S = ceil(d / rb).  partial: T * S * E floats, counter: 1 int.
extern "C" int avec_moe_route(const void* x, const void* router, void* rows, void* ends,
                              void* w, void* order, void* partial, void* counter, int T, int d,
                              int E, int k, int rb, int S, long long x_sb, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || T > MAX_ROWS || E <= 0 || E > MAX_E || E % 4 || k <= 0 || k > MAX_K || k > E ||
      T * k > MAX_ROWS || d <= 0 || d % 8 || x_sb < d || x_sb % 8 || rb <= 0 ||
      S != (d + rb - 1) / rb)
    return avec::kUnsupported;
  const RouteArgs a{static_cast<const bf16*>(x), static_cast<const float*>(router),
                    static_cast<bf16*>(rows), static_cast<int*>(ends), static_cast<bf16*>(w),
                    static_cast<int*>(order), static_cast<float*>(partial),
                    static_cast<int*>(counter), x_sb, T, d, E, k, rb, S};
  moe_route_kernel<<<dim3(S, T), NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// out (T*k, d) bf16 contiguous, w (T*k,) bf16, order (T*k,) int32, shared
// (T, d) bf16 at row stride shared_sb or null, y (T, d) bf16 contiguous; out,
// shared and y on 16 bytes.  1 <= k <= MAX_K, T * k <= MAX_ROWS, d and
// shared_sb multiples of 8.
extern "C" int avec_moe_combine(const void* out, const void* w, const void* order,
                                const void* shared, void* y, int T, int d, int k,
                                long long shared_sb, void* stream) {
  if (T == 0) return 0;
  if (T < 0 || T > MAX_ROWS || k <= 0 || k > MAX_K || T * k > MAX_ROWS || d <= 0 || d % 8 ||
      (shared && (shared_sb < d || shared_sb % 8)))
    return avec::kUnsupported;
  const CombineArgs a{static_cast<const bf16*>(out), static_cast<const bf16*>(w),
                      static_cast<const int*>(order), static_cast<const bf16*>(shared),
                      static_cast<bf16*>(y), shared_sb, T, d, k};
  const dim3 grid((d / 8 + CT - 1) / CT, T);
  moe_combine_kernel<<<grid, CT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
