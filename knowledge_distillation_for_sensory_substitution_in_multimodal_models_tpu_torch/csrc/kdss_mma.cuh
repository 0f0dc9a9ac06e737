// Shared device helpers of the port's kernels: the log constants, bf16
// packing, and the mma.sync m16n8k16 bf16 -> f32 product with its 32-bit
// fragment loads from shared memory (the forward of the fused CE and KL,
// csrc/kdss_vocab.cuh).
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * gi + ti):
//   A (16 x 16, row-major): a0 = A[gi][2ti..2ti+1],     a1 = A[gi+8][2ti..],
//                           a2 = A[gi][2ti+8..2ti+9],   a3 = A[gi+8][2ti+8..]
//   B (16 x 8, col-major):  b0 = B[2ti..2ti+1][gi],     b1 = B[2ti+8..2ti+9][gi]
//   C (16 x 8, f32):        c0,c1 = C[gi][2ti..2ti+1],  c2,c3 = C[gi+8][2ti..]
// wgmma's register fragments (csrc/kdss_sm90.cuh) share this layout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kdss {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent bf16 (a row-major A fragment, or a B fragment whose k runs
// along the stored row).
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16x16, row-major) * b (16x8, column-major); f32 accumulators.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of the 16 rows starting at `row0` of a row-major shared tile
// (row stride `ld` elements), k-chunk starting at column `k0`.
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s, int ld, int row0,
                                       int k0, int gi, int ti) {
  const __nv_bfloat16* p0 = s + (row0 + gi) * ld + k0 + ti * 2;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// B fragment (16 x 8) whose n runs along the rows of a row-major shared
// tile: B[k][n] = S[n0 + n][k0 + k].
__device__ __forceinline__ void load_b_rows(uint32_t b[2], const __nv_bfloat16* s, int ld, int n0,
                                            int k0, int gi, int ti) {
  const __nv_bfloat16* p = s + (n0 + gi) * ld + k0 + ti * 2;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

}  // namespace kdss
