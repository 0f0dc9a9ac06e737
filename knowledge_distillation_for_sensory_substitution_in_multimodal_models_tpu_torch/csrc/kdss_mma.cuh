// Shared device constants and helpers of the port's kernels: the full warp
// mask, the log constants and bf16 packing.  The mma.sync product that gave
// this header its name is gone (every kernel runs wgmma, csrc/kdss_sm90.cuh);
// the register fragment layout it shared with wgmma is kept here, as
// csrc/kdss_sm90.cuh refers to it.
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

}  // namespace kdss
