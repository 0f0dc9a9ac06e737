// Vocab-streaming fused cross-entropy for Hopper (sm_90a): per-row
// logsumexp and gold logit over the tied head, and their backward, without
// ever writing a [N, V] logits tensor to device memory.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/fused_ce.py
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/):
//   * K5, `_lse_gold_impl` (kernel `_fwd_kernel`): lse[n] and gold[n];
//   * K6, `_lse_gold_bwd` (kernels `_dh_kernel`, `_dw_kernel`): d_hidden and
//     d_W from the cotangents (g_lse, g_gold) of (lse, gold).
// h [N, DM] and the head w [V, DM] ("vd", the tied embedding's own layout)
// are bf16; labels int32 [N] (the wrapper maps ignored rows to label 0 and
// zeroes their cotangents); lse, gold, g_lse, g_gold f32 [N].
//
// Every kernel recomputes its logits tile h w^T itself with mma.sync
// m16n8k16 (bf16 x bf16 -> f32); no tile is read from a stored logits
// tensor.  The vocab is not padded: columns v >= V of the last tile read
// zero-filled head rows and are masked out of the softmax and the
// gradients (the JAX `_masked_w` / `cols < v_real` masks).
//
//   K5  `ce_fwd_kernel`: one block of 4 warps per (64 rows, vocab split);
//       each warp owns 16 rows and walks 128-column vocab tiles, keeping an
//       online (max, sum) and the gold logit per row in registers; a
//       128-thread `ce_fwd_combine` merges the splits.  The vocab is split
//       across blocks because 48 row tiles alone would leave most of the
//       132 SMs idle (the JAX grid runs its vocab axis in sequence).
//   K6  `ce_dh_kernel`: one block of 8 warps per (32 rows, vocab split).  The
//       dh accumulator [32, 896] f32 does not fit one warp's registers, so
//       it is spread over the 8 warps by columns (112 each, 112 registers a
//       thread); the rows' h and one 64-row head tile sit in dynamic shared
//       memory (179 KB of the 227 KB a block may opt into).  Per tile the
//       warps compute the 32 x 64 logits, write dlogits = g_lse * p +
//       g_gold * onehot as bf16 to shared memory (the JAX kernel rounds to
//       h's dtype there too), then accumulate dlogits . w_tile.  The splits'
//       f32 partials are summed by `ce_reduce_dh` in a fixed order, so dh is
//       deterministic.
//       `ce_dw_kernel`: one block of 8 warps per 32 head rows, walking all N
//       rows in chunks of 64 with the same structure transposed (dW rows are
//       vocab rows; no split, no reduction).
//
// What bounds it on the H100: at N = 3072, DM = 896, V = 151936 each of the
// three sweeps is 0.84 TFLOP of logits (the backward sweeps another 0.84
// each for dh and dW), so they are tensor-core bound on paper; this first
// version feeds mma.sync from synchronous shared-memory loads (no cp.async
// ring, no wgmma), and re-reads h (5.5 MB, L2-resident) once per head tile.

#include "kdss_mma.cuh"

namespace {

using namespace kdss;
using bf = __nv_bfloat16;

// ---- K5: forward --------------------------------------------------------

constexpr int F_BM = 64, F_BV = 128, F_BK = 64, F_LD = F_BK + 8, F_THREADS = 128;

// Copy a [ROWS][64] column chunk (columns k0..k0+63 of row-major [S][DM])
// into shared memory with row stride F_LD; rows >= S are zero-filled.
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void load_chunk(bf* s, const bf* g, int r0, int S, int DM, int k0) {
  for (int i = threadIdx.x; i < ROWS * (F_BK / 8); i += NTHREADS) {
    const int r = i / (F_BK / 8), c = i - r * (F_BK / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(g + (long)(r0 + r) * DM + k0 + c * 8);
    *reinterpret_cast<uint4*>(s + r * F_LD + c * 8) = val;
  }
}

template <int DM>
__global__ void __launch_bounds__(F_THREADS)
    ce_fwd_kernel(const bf* __restrict__ h, const bf* __restrict__ w,
                  const int* __restrict__ labels, float* __restrict__ lse_part,
                  float* __restrict__ gold_part, int N, int V, int tiles_per_split) {
  static_assert(DM % F_BK == 0, "model dim must be a multiple of 64");
  __shared__ __align__(16) bf Hs[F_BM * F_LD];
  __shared__ __align__(16) bf Ws[F_BV * F_LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int n0 = blockIdx.x * F_BM, split = blockIdx.y;
  const int n_vt = (V + F_BV - 1) / F_BV;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, n_vt);

  const int rows[2] = {n0 + warp * 16 + gi, n0 + warp * 16 + gi + 8};
  int lab[2];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) lab[i] = rows[i] < N ? labels[rows[i]] : -1;

  for (int t = t0; t < t1; ++t) {
    const int v0 = t * F_BV;
    float acc[F_BV / 8][4];
#pragma unroll
    for (int nt = 0; nt < F_BV / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

    for (int k0 = 0; k0 < DM; k0 += F_BK) {
      __syncthreads();
      load_chunk<F_BM, F_THREADS>(Hs, h, n0, N, DM, k0);
      load_chunk<F_BV, F_THREADS>(Ws, w, v0, V, DM, k0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < F_BK; kk += 16) {
        uint32_t a[4];
        load_a(a, Hs, F_LD, warp * 16, kk, gi, ti);
#pragma unroll
        for (int nt = 0; nt < F_BV / 8; ++nt) {
          uint32_t b[2];
          load_b_rows(b, Ws, F_LD, nt * 8, kk, gi, ti);
          mma16816(acc[nt], a, b);
        }
      }
    }

    // Online logsumexp in the log2 domain; the gold logit in natural units.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < F_BV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = v0 + nt * 8 + ti * 2 + (e & 1);
        if (col == lab[r]) gold[r] += acc[nt][e];
        const float x = col < V ? acc[nt][e] * LOG2E : -INFINITY;
        acc[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      base[i] = (mx[i] == -INFINITY) ? 0.f : mx[i];
      l[i] *= exp2f(m[i] - base[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < F_BV / 8; ++nt) {
      l[0] += exp2f(acc[nt][0] - base[0]) + exp2f(acc[nt][1] - base[0]);
      l[1] += exp2f(acc[nt][2] - base[1]) + exp2f(acc[nt][3] - base[1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i], gt = gold[i];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    gt += __shfl_xor_sync(FULL, gt, 1);
    gt += __shfl_xor_sync(FULL, gt, 2);
    if (ti == 0 && rows[i] < N) {
      lse_part[(long)split * N + rows[i]] = lt > 0.f ? (m[i] + log2f(lt)) * LN2 : -INFINITY;
      gold_part[(long)split * N + rows[i]] = gt;
    }
  }
}

__global__ void ce_fwd_combine(const float* __restrict__ lse_part, const float* __restrict__ gold_part,
                               float* __restrict__ lse, float* __restrict__ gold, int N, int nsplit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float mx = -INFINITY, g = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    mx = fmaxf(mx, lse_part[(long)s * N + n]);
    g += gold_part[(long)s * N + n];
  }
  float sum = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float x = lse_part[(long)s * N + n];
    if (x != -INFINITY) sum += expf(x - mx);
  }
  lse[n] = mx + logf(sum);
  gold[n] = g;
}

// ---- K6: backward -------------------------------------------------------

constexpr int B_THREADS = 256;  // 8 warps
constexpr int DH_BM = 32, DH_BV = 64;   // dh: rows per block, head rows per tile
constexpr int DW_BV = 32, DW_BN = 64;   // dW: head rows per block, rows per chunk
constexpr int P_LD = 64 + 8;            // dlogits tile row stride

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

// Per-row factors of dlogits: lse (log2 domain), g_lse, g_gold, label.
struct RowStats {
  float* l2;
  float* g1;
  float* g2;
  int* lab;
};

__device__ __forceinline__ void load_row_stats(const RowStats& rs, int rows, int n0, int N,
                                               const float* lse, const float* g_lse,
                                               const float* g_gold, const int* labels) {
  for (int i = threadIdx.x; i < rows; i += B_THREADS) {
    const int n = n0 + i;
    const bool in = n < N;
    rs.l2[i] = in ? lse[n] * LOG2E : INFINITY;  // padding rows: p = 0
    rs.g1[i] = in ? g_lse[n] : 0.f;
    rs.g2[i] = in ? g_gold[n] : 0.f;
    rs.lab[i] = in ? labels[n] : -1;
  }
}

// dlogit for row r (block-local) and head row col from its logit x.
__device__ __forceinline__ float dlogit(const RowStats& rs, int r, int col, int V, float x) {
  if (col >= V) return 0.f;
  const float p = exp2f(x * LOG2E - rs.l2[r]);
  return rs.g1[r] * p + (col == rs.lab[r] ? rs.g2[r] : 0.f);
}

template <int DM>
constexpr int dh_smem_bytes() {
  return (DH_BM + DH_BV) * (DM + 8) * 2 + DH_BM * P_LD * 2 + 4 * DH_BM * 4;
}

template <int DM>
constexpr int dw_smem_bytes() {
  return (DW_BV + DW_BN) * (DM + 8) * 2 + DW_BV * P_LD * 2 + 4 * DW_BN * 4;
}

template <int DM>
__global__ void __launch_bounds__(B_THREADS)
    ce_dh_kernel(const bf* __restrict__ h, const bf* __restrict__ w, const int* __restrict__ labels,
                 const float* __restrict__ lse, const float* __restrict__ g_lse,
                 const float* __restrict__ g_gold, float* __restrict__ dh_part, int N, int V,
                 int tiles_per_split) {
  static_assert(DM % 64 == 0, "model dim must be a multiple of 64 (8 warps x 8 columns)");
  constexpr int LDD = DM + 8, NTW = DM / 64;  // n-tiles of 8 columns per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Hs = reinterpret_cast<bf*>(smem);
  bf* Ws = Hs + DH_BM * LDD;
  bf* Ps = Ws + DH_BV * LDD;
  float* f = reinterpret_cast<float*>(Ps + DH_BM * P_LD);
  const RowStats rs{f, f + DH_BM, f + 2 * DH_BM, reinterpret_cast<int*>(f + 3 * DH_BM)};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int n0 = blockIdx.x * DH_BM, split = blockIdx.y;
  const int n_vt = (V + DH_BV - 1) / DH_BV;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, n_vt);

  load_rows<DM, DH_BM>(Hs, h, n0, N);
  load_row_stats(rs, DH_BM, n0, N, lse, g_lse, g_gold, labels);

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
        const float d0v = dlogit(rs, r, v0 + c, V, s[j][2 * hr]);
        const float d1v = dlogit(rs, r, v0 + c + 1, V, s[j][2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(Ps + r * P_LD + c) = pack_bf16(d0v, d1v);
      }
    }
    __syncthreads();

    // dh[32, DM] += dlogits[32, 64] . w_tile[64, DM], this warp's columns.
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

__global__ void ce_reduce_dh(const float* __restrict__ dh_part, bf* __restrict__ dh, long count,
                             int nsplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += dh_part[s * count + i];
  dh[i] = __float2bfloat16(acc);
}

template <int DM>
__global__ void __launch_bounds__(B_THREADS)
    ce_dw_kernel(const bf* __restrict__ h, const bf* __restrict__ w, const int* __restrict__ labels,
                 const float* __restrict__ lse, const float* __restrict__ g_lse,
                 const float* __restrict__ g_gold, bf* __restrict__ dw, int N, int V) {
  static_assert(DM % 64 == 0, "model dim must be a multiple of 64 (8 warps x 8 columns)");
  constexpr int LDD = DM + 8, NTW = DM / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Ws = reinterpret_cast<bf*>(smem);
  bf* Hs = Ws + DW_BV * LDD;
  bf* Pt = Hs + DW_BN * LDD;  // dlogits transposed: [head row][row]
  float* f = reinterpret_cast<float*>(Pt + DW_BV * P_LD);
  const RowStats rs{f, f + DW_BN, f + 2 * DW_BN, reinterpret_cast<int*>(f + 3 * DW_BN)};

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
    __syncthreads();  // the previous chunk's Hs and Pt are consumed
    load_rows<DM, DW_BN>(Hs, h, n0, N);
    load_row_stats(rs, DW_BN, n0, N, lse, g_lse, g_gold, labels);
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
        Pt[c * P_LD + r] = __float2bfloat16(dlogit(rs, r, v0 + c, V, s[j][e]));
      }
    }
    __syncthreads();

    // dW[32, DM] += dlogits^T[32, 64] . h_chunk[64, DM], this warp's columns.
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

template <int DM>
cudaError_t fwd(const void* h, const void* w, const void* labels, float* lse_part,
                float* gold_part, float* lse, float* gold, int N, int V, int nsplit,
                cudaStream_t st) {
  const int n_vt = (V + F_BV - 1) / F_BV;
  const int per = (n_vt + nsplit - 1) / nsplit;
  const dim3 grid((N + F_BM - 1) / F_BM, nsplit);
  ce_fwd_kernel<DM><<<grid, F_THREADS, 0, st>>>(static_cast<const bf*>(h), static_cast<const bf*>(w),
                                                static_cast<const int*>(labels), lse_part, gold_part,
                                                N, V, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_combine<<<(N + 127) / 128, 128, 0, st>>>(lse_part, gold_part, lse, gold, N, nsplit);
  return cudaGetLastError();
}

template <int DM>
cudaError_t bwd(const void* h, const void* w, const void* labels, const float* lse,
                const float* g_lse, const float* g_gold, float* dh_part, void* dh, void* dw, int N,
                int V, int nsplit, cudaStream_t st) {
  constexpr int dh_smem = dh_smem_bytes<DM>(), dw_smem = dw_smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(ce_dh_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, dh_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_dw_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return err;
  const bf* hb = static_cast<const bf*>(h);
  const bf* wb = static_cast<const bf*>(w);
  const int* lb = static_cast<const int*>(labels);

  const int n_vt = (V + DH_BV - 1) / DH_BV;
  const int per = (n_vt + nsplit - 1) / nsplit;
  ce_dh_kernel<DM><<<dim3((N + DH_BM - 1) / DH_BM, nsplit), B_THREADS, dh_smem, st>>>(
      hb, wb, lb, lse, g_lse, g_gold, dh_part, N, V, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long count = (long)N * DM;
  ce_reduce_dh<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(dh_part, static_cast<bf*>(dh), count, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_dw_kernel<DM><<<(V + DW_BV - 1) / DW_BV, B_THREADS, dw_smem, st>>>(
      hb, wb, lb, lse, g_lse, g_gold, static_cast<bf*>(dw), N, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5.  lse_part / gold_part: f32 scratch [nsplit, N]; lse / gold: f32 [N].
// Returns a cudaError_t (cudaErrorInvalidValue for shapes not compiled).
int kdss_ce_fwd(const void* h, const void* w, const void* labels, void* lse_part, void* gold_part,
                void* lse, void* gold, int N, int V, int DM, int nsplit, void* stream) {
  if (N <= 0 || V <= 0 || nsplit <= 0 || nsplit > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *lp = static_cast<float*>(lse_part), *gp = static_cast<float*>(gold_part);
  float *l = static_cast<float*>(lse), *g = static_cast<float*>(gold);
  if (DM != 896) return static_cast<int>(cudaErrorInvalidValue);  // the 0.5B student's width
  return static_cast<int>(fwd<896>(h, w, labels, lp, gp, l, g, N, V, nsplit, st));
}

// K6.  dh_part: f32 scratch [nsplit, N, DM]; dh [N, DM] and dw [V, DM] bf16.
int kdss_ce_bwd(const void* h, const void* w, const void* labels, const void* lse,
                const void* g_lse, const void* g_gold, void* dh_part, void* dh, void* dw, int N,
                int V, int DM, int nsplit, void* stream) {
  if (N <= 0 || V <= 0 || nsplit <= 0 || nsplit > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *l = static_cast<const float*>(lse), *g1 = static_cast<const float*>(g_lse),
              *g2 = static_cast<const float*>(g_gold);
  float* part = static_cast<float*>(dh_part);
  if (DM != 896) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bwd<896>(h, w, labels, l, g1, g2, part, dh, dw, N, V, nsplit, st));
}

}  // extern "C"
