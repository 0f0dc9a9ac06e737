// The mma.sync vocab-streaming forward that the fused CE (K5,
// csrc/fused_ce.cu) and the temperature KL (K7, csrc/fused_kl.cu) share:
// rows of hidden states h [N, DM] against a head w [V, DM] (bf16, "vd"),
// whose [N, V] logits are never written to device memory.  Their backwards
// (K6, K8) run on the Hopper vocab core, csrc/kdss_vocab_sm90.cuh.
//
// One block of 4 warps per (64 rows, vocab split); each warp owns 16 rows
// and walks 128-column vocab tiles, `logits_tile` computing its 16 x 128
// logits with mma.sync m16n8k16 into C fragments; the loss keeps its own
// per-row online accumulators and merges the four threads of a row with
// `quad_sum` / `quad_max`.  Columns v >= V of a ragged last tile read
// zero-filled head rows; the losses mask them.

#pragma once

#include "kdss_mma.cuh"

namespace kdss {
namespace {

using bf = __nv_bfloat16;

constexpr int F_BM = 64, F_BV = 128, F_BK = 64, F_LD = F_BK + 8, F_THREADS = 128;
constexpr int NT = F_BV / 8;  // n-tiles of 8 columns per vocab tile

// Copy a [ROWS][64] column chunk (columns k0..k0+63 of row-major [S][DM])
// into shared memory with row stride F_LD; rows >= S are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_chunk(bf* s, const bf* g, int r0, int S, int DM, int k0) {
  for (int i = threadIdx.x; i < ROWS * (F_BK / 8); i += F_THREADS) {
    const int r = i / (F_BK / 8), c = i - r * (F_BK / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(g + (long)(r0 + r) * DM + k0 + c * 8);
    *reinterpret_cast<uint4*>(s + r * F_LD + c * 8) = val;
  }
}

// The raw student logits h w^T of rows n0..n0+63 and vocab rows
// v0..v0+127: this warp's 16 rows x 128 columns in acc (C fragments).
template <int DM>
__device__ __forceinline__ void logits_tile(float (&acc)[NT][4], bf* Hs, bf* Ws, const bf* h,
                                            const bf* w, int n0, int v0, int N, int V, int warp,
                                            int gi, int ti) {
  static_assert(DM % F_BK == 0, "model dim must be a multiple of 64");
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int k0 = 0; k0 < DM; k0 += F_BK) {
    __syncthreads();
    load_chunk<F_BM>(Hs, h, n0, N, DM, k0);
    load_chunk<F_BV>(Ws, w, v0, V, DM, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; kk += 16) {
      uint32_t a[4];
      load_a(a, Hs, F_LD, warp * 16, kk, gi, ti);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        load_b_rows(b, Ws, F_LD, nt * 8, kk, gi, ti);
        mma16816(acc[nt], a, b);
      }
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

// A running maximum as an exp2 base: -inf (nothing seen) shifts by 0, so
// exp2(-inf - 0) = 0 and nothing turns into NaN.
__device__ __forceinline__ float base_of(float m) { return m == -INFINITY ? 0.f : m; }

}  // namespace
}  // namespace kdss
