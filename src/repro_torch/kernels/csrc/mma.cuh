// Tensor-core and copy helpers shared by the kernels (flash_attention.cu,
// flash_attention_bwd.cu, gemm.cu, ssd.cu; hopper.cuh builds on them): one
// mma.sync m16n8k16 (bf16 in, f32 accumulate) and one m16n8k8 (TF32 in, f32
// accumulate) with the split that keeps f32 products on it (3xTF32), the
// packing of two bf16 values (or of two floats rounded to bf16) into one
// 32-bit fragment register, ldmatrix fragment loads from shared memory, and
// cp.async copies from device memory into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// m16n8k8 with TF32 operands. Fragments (g = lane / 4, q = lane % 4): A
// a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); B b0 (k q,
// n g), b1 (k q + 4, n g); D d0 (g, 2 q), d1 (g, 2 q + 1), d2 (g + 8, 2 q),
// d3 (g + 8, 2 q + 1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + lo + e with hi and lo TF32 (the low 13 mantissa bits clear) and
// |e| < 2^-20 |v|: hi truncates v, lo truncates the exact rest v - hi.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a b from split operands (3xTF32): a_lo b_hi + a_hi b_lo + a_hi b_hi,
// the small terms first; every product of two TF32 values is exact in f32.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: four 8 x 8 b16 matrices from shared memory. Lane l gives the
// address of one 16-byte row: row l % 8 of matrix l / 8. Lane l receives,
// of matrix i, in r[i]: (row l / 4, cols 2 (l % 4) + {0, 1}); with .trans,
// (rows 2 (l % 4) + {0, 1}, col l / 4). For a 16 x 16 tile at p of a
// row-major array with pitch P (elements) the lane addresses are
//   A fragment, or B of a (k, n) array with .trans:
//     p + (l % 16) * P + 8 * (l / 16)
//     -> {a0, a1, a2, a3}; or b0, b1 of n 0-7 and b0, b1 of n 8-15
//   B fragments of an (n, k) array, without .trans:
//     p + (l % 8 + 8 * (l / 16)) * P + 8 * ((l / 8) % 2)
//     -> b0, b1 of n 0-7 and b0, b1 of n 8-15
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// cp.async of 16 (or 4) bytes; when ok is false nothing is read and the
// destination is zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
