// Hopper building blocks for the hand-written kernels, in inline PTX:
// 16-byte cp.async copies, the swizzled shared-memory tile layout that
// wgmma reads, wgmma matrix descriptors, the three warpgroup products of
// the flash kernel, and the warp-level mma.sync product with its
// ldmatrix loads and the bf16 hi/lo split the SSD scan uses (bf16 in, fp32
// accumulate).  sm_90a only.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace avec {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `valid` false zero-fills the
// destination and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of the generic proxy (cp.async, st.shared) become
// visible to the async proxy (wgmma operand reads) after this fence and a
// barrier.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A tile of ROWS rows of D bf16 values is stored as column blocks of
// W = min(D, 64) * 2 bytes per row (64 rows x W bytes each, 1024-byte
// aligned), and within a block each 16-byte chunk is XOR-swizzled the way
// the matching wgmma layout (128B swizzle for W 128, 32B for W 32) expects:
// byte offset bits [4, 4+B) ^= bits [7, 7+B), B = log2(W / 16).
template <int D>
struct SwizzledTile {
  static_assert(D == 16 || D == 64 || D == 128, "head_dim 16, 64 or 128");
  static constexpr int W = (D < 64 ? D : 64) * 2;        // bytes per row of a column block
  static constexpr int BITS = W == 128 ? 3 : 1;          // swizzle bits
  static constexpr uint64_t LAYOUT = W == 128 ? 1 : 3;   // descriptor: 1 = 128B, 3 = 32B
  static constexpr int CHUNKS = D / 8;                   // 16-byte chunks per row

  // byte offset of chunk `c` (8 values from column 8c) of row `r` in a tile of `rows` rows
  __device__ static __forceinline__ uint32_t offset(int rows, int r, int c) {
    const uint32_t byte = c * 16;
    const uint32_t off = (byte / W) * rows * W + r * W + byte % W;
    return off ^ (((off >> 7) & ((1u << BITS) - 1)) << 4);
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout.  The stride byte offset is
// the distance between 8-row groups (8 rows of W bytes); for the swizzled
// layouts used here the leading offset is either unused (K-major) or spans
// one 64-wide block (MN-major, only one block per instruction), so both
// carry the 8-row stride.
template <int D>
__device__ __forceinline__ uint64_t desc(const void* p) {
  constexpr uint64_t stride = (8 * SwizzledTile<D>::W) >> 4;
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (stride << 16) | (stride << 32) |
         (SwizzledTile<D>::LAYOUT << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x by the special-function unit (about 2 ulp; exp2(-1e30) is 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#define AVEC_R8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64x64 fp32) (+)= A (64x16, shared, K-major) * B (16x64, shared, K-major
// as B^T rows); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : AVEC_R8(0), AVEC_R8(8), AVEC_R8(16), AVEC_R8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64x64 fp32) += A (64x16 bf16 in registers, the accumulator layout of
// a previous product) * B (16x64, shared, MN-major: rows of B contiguous).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : AVEC_R8(0), AVEC_R8(8), AVEC_R8(16), AVEC_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same with N = 16 (head_dim 16).
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : AVEC_R8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef AVEC_R8

// ---- warp-level tensor-core products (mma.sync m16n8k16, bf16 in, fp32 sum)
//
// Fragments of one warp, g = lane / 4, t = lane % 4:
//   A (16x16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] = (g, 2t+8..),
//                         a[3] = (g+8, 2t+8..)
//   B (16x8, k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g)
//   C/D (16x8, fp32):     d[0..1] = (g, 2t..2t+1), d[2..3] = (g+8, 2t..2t+1)
// (two bf16 per 32-bit register, the lower index in the low half).

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes); register i receives
// matrix i, (row g, columns 2t, 2t+1), or with TRANS (rows 2t, 2t+1, column g).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row_addr) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row_addr)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row_addr)));
}

// d += a * b
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v0, v1 as bf16 pairs hi + lo: hi = bf16(v), lo = bf16(v - hi), so hi + lo
// carries about 16 significant bits of v (one bf16 carries 8)
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace hopper
}  // namespace avec
