// The vocab-streaming machinery that the fused losses share (the fused CE,
// csrc/fused_ce.cu; the combined LoCa + CE, csrc/fused_loca_ce.cu; the
// temperature KL, csrc/fused_kl.cu): rows of hidden states h [N, DM]
// against a head w [V, DM] (bf16, "vd"), whose [N, V] logits are never
// written to device memory.
//
// Forward: one block of 4 warps per (64 rows, vocab split); each warp owns
// 16 rows and walks 128-column vocab tiles, `logits_tile` computing its
// 16 x 128 logits with mma.sync m16n8k16 into C fragments; the loss keeps
// its own per-row online accumulators and merges the four threads of a row
// with `quad_sum` / `quad_max`.
//
// Backward: given a loss's `Rows` policy, which stages its per-row factors
// in shared memory and turns a raw logit into d_logit,
//   `dh_kernel`: one block of 8 warps per (32 rows, vocab split).  The dh
//     accumulator [32, 896] f32 is spread over the 8 warps by columns; the
//     rows' h and one 64-row head tile sit in dynamic shared memory (~179
//     KB).  Per tile the warps compute the 32 x 64 logits, write d_logits
//     rounded to bf16 to shared memory (where the JAX kernels round them),
//     then accumulate d_logits . w_tile.  `reduce_dh` sums the splits' f32
//     partials in a fixed order, so dh is deterministic;
//   `dw_kernel`: one block of 8 warps per 32 head rows, walking all N rows
//     in chunks of 64, the same structure transposed (no split).
// Columns v >= V of a ragged last tile read zero-filled head rows; the
// policies mask them.
//
// A Rows policy is a struct passed by value to the kernels, with
//   static constexpr int NSTAT;  // 4-byte words per row in shared memory
//   __device__ void stage(float* f, int rows, int n0, int N) const;
//       // every thread: the factors of rows n0 .. n0 + rows - 1 into f
//   __device__ float dlogit(const float* f, int rows, int r, long n, int col,
//                           int V, float x) const;
//       // d_logit of block-local row r (global row n), head row col, from
//       // the raw logit x; 0 for col >= V and rows past N.

#pragma once

#include "kdss_mma.cuh"

namespace kdss {
namespace {

using bf = __nv_bfloat16;

// ---- forward ------------------------------------------------------------

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

// ---- backward -----------------------------------------------------------

constexpr int B_THREADS = 256;  // 8 warps
constexpr int DH_BM = 32, DH_BV = 64;   // dh: rows per block, head rows per tile
constexpr int DW_BV = 32, DW_BN = 64;   // dW: head rows per block, rows per chunk
constexpr int P_LD = 64 + 8;            // d_logits tile row stride

// Copy full rows [r0, r0 + ROWS) of a row-major [S][DM] matrix into shared
// memory with row stride DM + 8; rows >= S are zero-filled.
template <int DM, int ROWS>
__device__ __forceinline__ void load_rows(bf* s, const bf* g, int r0, int S) {
  constexpr int VPR = DM / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += B_THREADS) {
    const int r = i / VPR, c = i - r * VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(g + (long)(r0 + r) * DM + c * 8);
    *reinterpret_cast<uint4*>(s + r * (DM + 8) + c * 8) = val;
  }
}

template <int DM, class Rows>
constexpr int dh_smem_bytes() {
  return (DH_BM + DH_BV) * (DM + 8) * 2 + DH_BM * P_LD * 2 + Rows::NSTAT * DH_BM * 4;
}

template <int DM, class Rows>
constexpr int dw_smem_bytes() {
  return (DW_BV + DW_BN) * (DM + 8) * 2 + DW_BV * P_LD * 2 + Rows::NSTAT * DW_BN * 4;
}

template <int DM, class Rows>
__global__ void __launch_bounds__(B_THREADS)
    dh_kernel(const bf* __restrict__ h, const bf* __restrict__ w, const Rows rows,
              float* __restrict__ dh_part, int N, int V, int tiles_per_split) {
  static_assert(DM % 64 == 0, "model dim must be a multiple of 64 (8 warps x 8 columns)");
  constexpr int LDD = DM + 8, NTW = DM / 64;  // n-tiles of 8 columns per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Hs = reinterpret_cast<bf*>(smem);
  bf* Ws = Hs + DH_BM * LDD;
  bf* Ps = Ws + DH_BV * LDD;
  float* f = reinterpret_cast<float*>(Ps + DH_BM * P_LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int n0 = blockIdx.x * DH_BM, split = blockIdx.y;
  const int n_vt = (V + DH_BV - 1) / DH_BV;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, n_vt);

  load_rows<DM, DH_BM>(Hs, h, n0, N);
  rows.stage(f, DH_BM, n0, N);

  const int wr = warp & 1, wc = warp >> 1;  // logits: 16 rows x 16 head rows per warp
  const int d0 = warp * (DM / 8);           // dh: this warp's columns
  float acc[2][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int v0 = t * DH_BV;
    __syncthreads();  // the previous tile's Ws and Ps are consumed
    load_rows<DM, DH_BV>(Ws, w, v0, V);
    __syncthreads();

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int kc = 0; kc < DM; kc += 16) {
      uint32_t a[4], b0[2], b1[2];
      load_a(a, Hs, LDD, wr * 16, kc, gi, ti);
      load_b_rows(b0, Ws, LDD, wc * 16, kc, gi, ti);
      load_b_rows(b1, Ws, LDD, wc * 16 + 8, kc, gi, ti);
      mma16816(s[0], a, b0);
      mma16816(s[1], a, b1);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wr * 16 + gi + hr * 8;
        const int c = wc * 16 + j * 8 + ti * 2;
        const long n = n0 + r;
        const float d0v = rows.dlogit(f, DH_BM, r, n, v0 + c, V, s[j][2 * hr]);
        const float d1v = rows.dlogit(f, DH_BM, r, n, v0 + c + 1, V, s[j][2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(Ps + r * P_LD + c) = pack_bf16(d0v, d1v);
      }
    }
    __syncthreads();

    // dh[32, DM] += d_logits[32, 64] . w_tile[64, DM], this warp's columns.
#pragma unroll
    for (int c = 0; c < DH_BV; c += 16) {
      uint32_t a0[4], a1[4];
      load_a(a0, Ps, P_LD, 0, c, gi, ti);
      load_a(a1, Ps, P_LD, 16, c, gi, ti);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        uint32_t b[2];
        load_b_cols(b, Ws, LDD, c, d0 + nt * 8, gi, ti);
        mma16816(acc[0][nt], a0, b);
        mma16816(acc[1][nt], a1, b);
      }
    }
  }

  float* out = dh_part + (long)split * N * DM;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int n = n0 + mt * 16 + gi + hr * 8;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        *reinterpret_cast<float2*>(out + (long)n * DM + d0 + nt * 8 + ti * 2) =
            make_float2(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
    }
  }
}

__global__ void reduce_dh(const float* __restrict__ dh_part, bf* __restrict__ dh, long count,
                          int nsplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += dh_part[s * count + i];
  dh[i] = __float2bfloat16(acc);
}

template <int DM, class Rows>
__global__ void __launch_bounds__(B_THREADS)
    dw_kernel(const bf* __restrict__ h, const bf* __restrict__ w, const Rows rows,
              bf* __restrict__ dw, int N, int V) {
  static_assert(DM % 64 == 0, "model dim must be a multiple of 64 (8 warps x 8 columns)");
  constexpr int LDD = DM + 8, NTW = DM / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Ws = reinterpret_cast<bf*>(smem);
  bf* Hs = Ws + DW_BV * LDD;
  bf* Pt = Hs + DW_BN * LDD;  // d_logits transposed: [head row][row]
  float* f = reinterpret_cast<float*>(Pt + DW_BV * P_LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int v0 = blockIdx.x * DW_BV;

  load_rows<DM, DW_BV>(Ws, w, v0, V);

  const int wr = warp & 3, wc = warp >> 2;  // logits: 16 rows x 16 head rows per warp
  const int d0 = warp * (DM / 8);
  float acc[2][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int n0 = 0; n0 < N; n0 += DW_BN) {
    __syncthreads();  // the previous chunk's Hs, Pt and row factors are consumed
    load_rows<DM, DW_BN>(Hs, h, n0, N);
    rows.stage(f, DW_BN, n0, N);
    __syncthreads();

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int kc = 0; kc < DM; kc += 16) {
      uint32_t a[4], b0[2], b1[2];
      load_a(a, Hs, LDD, wr * 16, kc, gi, ti);
      load_b_rows(b0, Ws, LDD, wc * 16, kc, gi, ti);
      load_b_rows(b1, Ws, LDD, wc * 16 + 8, kc, gi, ti);
      mma16816(s[0], a, b0);
      mma16816(s[1], a, b1);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr * 16 + gi + (e >> 1) * 8;
        const int c = wc * 16 + j * 8 + ti * 2 + (e & 1);
        Pt[c * P_LD + r] = __float2bfloat16(rows.dlogit(f, DW_BN, r, (long)n0 + r, v0 + c, V, s[j][e]));
      }
    }
    __syncthreads();

    // dW[32, DM] += d_logits^T[32, 64] . h_chunk[64, DM], this warp's columns.
#pragma unroll
    for (int c = 0; c < DW_BN; c += 16) {
      uint32_t a0[4], a1[4];
      load_a(a0, Pt, P_LD, 0, c, gi, ti);
      load_a(a1, Pt, P_LD, 16, c, gi, ti);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        uint32_t b[2];
        load_b_cols(b, Hs, LDD, c, d0 + nt * 8, gi, ti);
        mma16816(acc[0][nt], a0, b);
        mma16816(acc[1][nt], a1, b);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int v = v0 + mt * 16 + gi + hr * 8;
      if (v >= V) continue;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        *reinterpret_cast<uint32_t*>(dw + (long)v * DM + d0 + nt * 8 + ti * 2) =
            pack_bf16(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
    }
  }
}

// dh (through `dh_part` [nsplit, N, DM] f32) and, unless dw is null, dW.
template <int DM, class Rows>
cudaError_t launch_bwd(const bf* h, const bf* w, const Rows& rows, float* dh_part, bf* dh, bf* dw,
                       int N, int V, int nsplit, cudaStream_t st) {
  constexpr int dh_smem = dh_smem_bytes<DM, Rows>(), dw_smem = dw_smem_bytes<DM, Rows>();
  cudaError_t err = cudaFuncSetAttribute(dh_kernel<DM, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, dh_smem);
  if (err != cudaSuccess) return err;
  const int n_vt = (V + DH_BV - 1) / DH_BV;
  const int per = (n_vt + nsplit - 1) / nsplit;
  dh_kernel<DM, Rows><<<dim3((N + DH_BM - 1) / DH_BM, nsplit), B_THREADS, dh_smem, st>>>(
      h, w, rows, dh_part, N, V, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long count = (long)N * DM;
  reduce_dh<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(dh_part, dh, count, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || dw == nullptr) return err;
  err = cudaFuncSetAttribute(dw_kernel<DM, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return err;
  dw_kernel<DM, Rows><<<(V + DW_BV - 1) / DW_BV, B_THREADS, dw_smem, st>>>(h, w, rows, dw, N, V);
  return cudaGetLastError();
}

}  // namespace
}  // namespace kdss
