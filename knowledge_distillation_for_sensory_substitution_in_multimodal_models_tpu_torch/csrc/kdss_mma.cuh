// Shared device helpers of the port's kernels: bf16 packing, 32-bit
// fragment loads from shared memory, the mma.sync m16n8k16 bf16 -> f32 and
// m16n8k32 s8 -> s32 tensor-core products, the zero-filling tile copy of
// the flash kernels, and the asynchronous 16-byte copy (cp.async) of the
// int8 GEMMs.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * gi + ti):
//   A (16 x 16, row-major): a0 = A[gi][2ti..2ti+1],     a1 = A[gi+8][2ti..],
//                           a2 = A[gi][2ti+8..2ti+9],   a3 = A[gi+8][2ti+8..]
//   B (16 x 8, col-major):  b0 = B[2ti..2ti+1][gi],     b1 = B[2ti+8..2ti+9][gi]
//   C (16 x 8, f32):        c0,c1 = C[gi][2ti..2ti+1],  c2,c3 = C[gi+8][2ti..]
// So the accumulators of n-tiles 2c and 2c + 1 are exactly the A fragment
// of k-chunk c of the next product (the flash "P V" trick).

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

// Two bf16 from two rows (a B fragment whose k runs down the stored column).
__device__ __forceinline__ uint32_t ld16x2(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// c += a (16x16, row-major) * b (16x8, column-major); f32 accumulators.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a (16x32, row-major) * b (32x8, column-major); s8 operands, exact
// s32 accumulators.  Its fragments hold the same bytes, lane for lane, as
// the bf16 m16n8k16 ones above (4 int8 where those hold 2 bf16):
//   a0 = A[gi][4ti..4ti+3], a1 = A[gi+8][4ti..], a2 = A[gi][4ti+16..],
//   a3 = A[gi+8][4ti+16..];  b0 = B[4ti..4ti+3][gi], b1 = B[4ti+16..][gi];
//   c0,c1 = C[gi][2ti..2ti+1], c2,c3 = C[gi+8][2ti..].
__device__ __forceinline__ void mma16832_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 b16 matrices (each 8 rows of 16 bytes) from shared memory:
// lane l gives the address of row l % 8 of matrix l / 8, and register i of
// lane (gi, ti) receives bytes 4ti..4ti+3 of row gi of matrix i, which is
// the fragment layout of both mma products above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* s) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes from global to shared memory without passing through registers;
// `pred` false zero-fills the 16 bytes and reads nothing (`g` must still be
// a valid address).
__device__ __forceinline__ void cp_async16(void* s, const void* g, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(g),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// B fragment (16 x 8) whose k runs down the rows of a row-major shared
// tile: B[k][n] = S[k0 + k][n0 + n].
__device__ __forceinline__ void load_b_cols(uint32_t b[2], const __nv_bfloat16* s, int ld, int k0,
                                            int n0, int gi, int ti) {
  const __nv_bfloat16* p = s + (k0 + ti * 2) * ld + n0 + gi;
  b[0] = ld16x2(p, p + ld);
  b[1] = ld16x2(p + 8 * ld, p + 9 * ld);
}

// Head-dim bookkeeping of the flash kernels.
template <int D>
struct FlashDims {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int DP = (D + 15) / 16 * 16;  // zero-filled to the mma depth
  static constexpr int LD = DP + 8;              // shared row stride, elements
  static constexpr int KC = DP / 16;             // k-chunks over the head dim
  static constexpr int NT = DP / 8;              // n-tiles over the head dim
  static constexpr int VEC = D / 8;              // 16-byte vectors per row in memory
};

// Copy rows [s0, s0 + ROWS) of one head (row stride `stride` elements) into
// a [ROWS][LD] shared tile; rows past S and columns past D are zero-filled.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* g, int s0,
                                          int S, long stride) {
  using Dm = FlashDims<D>;
  constexpr int VPR = Dm::DP / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = i - r * VPR;
    const int s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S && c < Dm::VEC) val = *reinterpret_cast<const uint4*>(g + s * stride + c * 8);
    *reinterpret_cast<uint4*>(smem + r * Dm::LD + c * 8) = val;
  }
}

}  // namespace kdss
