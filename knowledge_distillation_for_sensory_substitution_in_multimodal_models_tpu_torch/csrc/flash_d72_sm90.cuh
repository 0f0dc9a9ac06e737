// The head-dim-72 tile layout of SigLIP's flash kernels on Hopper (sm_90a),
// shared by the forward (flash_fwd_sm90.cu, K1) and the backward
// (flash_bwd_d72_sm90.cu, K2).
//
// d = 72 does not fit the layout of kdss_sm90.cuh: a row of 72 bf16 is 144
// bytes, past one 128-byte swizzle atom, and 72 is not a multiple of
// wgmma's depth 16.  Each 64-row tile of q, k, v or dO is therefore loaded
// as two TMA boxes of 64 columns with the 128-byte swizzle (the "two boxes"
// of kdss_sm90.cuh): box 0 holds columns 0-63 and box 1 columns 64-127, of
// which TMA writes 64-71 from memory and zero-fills 72-127 without reading
// memory (the bytes still count on the barrier).  So every product reuses
// the header's one descriptor type:
//   * a contraction over d (S = Q K^T, dP = dO V^T and their transposes)
//     takes 4 k16 steps from box 0 and 1 from box 1 (columns 64-79, 72-79
//     zero): 80 columns computed for 72;
//   * a product whose N is d (O += P V, dV, dK, dQ) runs at n = 72 with the
//     B operand N-major over both boxes (desc_nmajor_wide): nothing wasted.
// Box 1 is 7/8 zeros in shared memory (8 KB a 64-row tile); the options that
// avoid it (a 16-column box with the 32-byte swizzle, or d as 9 x 8 in the
// unswizzled core-matrix layout) need a second descriptor type and, for the
// first, a second n = 8 product on the N = d side.  Shared memory is not
// what limits these kernels (two blocks fit an SM), so the layout that
// reuses the header as it is was taken.
#pragma once

#include "kdss_mma.cuh"
#include "kdss_sm90.cuh"

namespace kdss_d72 {

using namespace kdss_sm90;
using bf = __nv_bfloat16;

constexpr int D = 72;
constexpr int BT = 64;             // rows of a tile
constexpr int BOX = BT * 128;      // one 64-row box: 8 KB, 1024-aligned
constexpr int TILE = 2 * BOX;      // a 64-row tile: box 0 then box 1
constexpr uint32_t TX_TILE = TILE; // bytes a tile announces on its barrier (zero fill included)

// Both boxes of the 64-row tile at rows (c1 = head, c2 = row0, c3 = batch)
// of a rank-4 map into `dst` (box 0) and `dst + box1` (box 1).
__device__ __forceinline__ void tma_tile(unsigned char* dst, int box1, const CUtensorMap* map, uint64_t* bar, int h,
                                         int row0, int b) {
  tma_load_4d(dst, map, bar, 0, h, row0, b);
  tma_load_4d(dst + box1, map, bar, 64, h, row0, b);
}

// x = A B^T over d (64 x 64 out), A and B two-box tiles read K-major: box 0
// of A at a0 and box 1 at a1 (likewise B).  Issues the five wgmmas only; the
// caller fences, commits and waits.
__device__ __forceinline__ void ss_d72(float (&x)[32], const void* a0, const void* a1, const void* b0,
                                       const void* b1) {
  const uint64_t da = desc_kmajor(a0), db = desc_kmajor(b0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64_ss(x, da + 2 * kk, db + 2 * kk, kk);
  wgmma_m64n64_ss(x, desc_kmajor(a1), desc_kmajor(b1), 1);
}

// acc += A B (64 x 72 out) over 64 rows: A the bf16 fragments a[kk] of
// columns 16 kk .. 16 kk + 15, B a 64-row two-box tile read N-major.
// Issues the four wgmmas only.
__device__ __forceinline__ void rs_n72(float (&acc)[36], uint32_t (&a)[4][4], const void* b) {
  const uint64_t db = desc_nmajor_wide(b, BOX);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n72_rs<1>(acc, a[kk], db + 128 * kk, 1);
}

}  // namespace kdss_d72

namespace kdss_d72_host {

// A rank-4 map of x [B, S, H, 72] bf16 (contiguous, 16-byte aligned): dims
// {72, H, S, B}, a box of 64 columns x `rows` rows of one head.  Rows are
// H x 144 bytes apart, a multiple of 16 as TMA needs.
inline cudaError_t head_map(CUtensorMap* map, const void* x, int B, int S, int H, int rows) {
  const uint64_t dims[4] = {kdss_d72::D, static_cast<uint64_t>(H), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t row = kdss_d72::D * 2;
  const uint64_t strides[3] = {row, row * H, row * H * S};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return kdss_sm90_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace kdss_d72_host
