// Warp-level bf16 tensor-core helpers for Hopper (sm_90a): ldmatrix from
// shared memory and mma.sync m16n8k16 with f32 accumulators. Included by
// csrc/lstm_fwd.cu and csrc/lstm_bwd.cu (build.py digests every .cuh of
// csrc/ into each library's name, so an edit here rebuilds both).
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + t):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
//                           a2 = A[g][2t+8..],   a3 = A[g+8][2t+8..]
//   B (16 x 8):             b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C, D (16 x 8, f32):     d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][..]
// Each register of A and B holds two bf16, the lower index in the low half.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register j receives matrix j's (lane / 4, 2 (lane % 4) ..)
// pair (with .trans, the pair of the transposed matrix).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += A B on one 16 x 8 x 16 tile, bf16 operands, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's row address for an A fragment (16 rows x 16 columns at
// (r0, c0)) of a row-major tile with row stride `ld` elements: ldsm_x4
// then gives a0..a3.
__device__ __forceinline__ const bf16* a_addr(const bf16* base, int ld,
                                              int r0, int c0, int lane) {
  return base + (size_t)(r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + c0 +
         8 * (lane >> 4);
}
// The lane's row address for the B fragments of two n-tiles (rows n0 ..
// n0+15 of a tile stored [n][k], columns k0 .. k0+15): ldsm_x4 gives b0,
// b1 of n-tile n0 and b0, b1 of n-tile n0+8.
__device__ __forceinline__ const bf16* b_addr(const bf16* base, int ld,
                                              int n0, int k0, int lane) {
  return base + (size_t)(n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 +
         8 * ((lane >> 3) & 1);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

}  // namespace mma_bf16
