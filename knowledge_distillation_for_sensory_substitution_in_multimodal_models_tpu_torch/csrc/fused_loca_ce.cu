// Combined LoCa-KL + cross-entropy over the vocabulary for Hopper (sm_90a):
// the distillation loss of double-trouble phases 2/3 and logit_based, and
// its backward, without ever writing the student's [N, V] logits.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/fused_loca.py
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/),
// K11 in its single-device "materialize" form:
//   * forward, `_loca_ce_rows_kernels` (kernels `_stats_ce_kernel`,
//     `_klts_fwd_kernel`): per-row statistics, then the calibrated-KL row
//     sums and tsum (the sum of the live calibrated probabilities);
//   * backward, `_loca_ce_rows_bwd` (kernels `_dhs_ce_kernel`,
//     `_dws_ce_kernel`): d_hidden and d_head from the cotangents (g_kl, g_ce)
//     of the KL and CE rows.
// h [N, DM] and the student head w [V, DM] ("vd", the tied embedding) are
// bf16; tmat [N, V] f32 is the teacher's logits already scaled by 1/T and
// truncated to the student vocab (computed once outside, as the JAX
// `_materialize_t` does, and only read here); lab (LoCa, unshifted) and
// lab_ce (CE, shifted) are int32 [N], -1 where ignored.
//
// Per row, at temperature T (sT = s / T, natural logs):
//   pass 1: lse_sT, lse_s1 (student at T and at 1), lse_t, the teacher's
//           gold logit at lab, the student's gold at lab_ce and the
//           teacher's top-2 (m1, m2; a duplicated max gives m2 = m1, the
//           torch.topk(2) rule); then scale = alpha / (1 - p_gt + p_2nd),
//           tval = 1 - scale * (1 - p_gt), ce = lse_s1 - gold_s1;
//   pass 2: loca_j = scale * p_t,j (tval at the label; the raw p_t where lab
//           < 0), kl = sum_j loca_j (log loca_j - max(log p_sT,j, log eps))
//           over loca_j > 0, tsum = sum of loca_j where also
//           log p_sT,j > log eps;
//   backward: ds = (p_sT * tsum - live * loca) * g_kl / T
//               + (p_s1 - onehot_ce) * g_ce   (rows with lab_ce >= 0),
//           rounded to bf16 (as the JAX kernels round it), then
//           dh = ds w and dW = ds^T h.
// Columns v >= V of a ragged last tile are masked everywhere; rows past N
// are never read from tmat and give ds = 0.
//
// Layout, as the fused CE of csrc/fused_ce.cu (K5/K6), whose tiling this
// follows: the forward passes run one block of 4 warps per (64 rows, vocab
// split); each warp owns 16 rows and walks 128-column tiles, computing the
// student logits tile with mma.sync m16n8k16 and reading the matching f32
// tmat entries straight from device memory into registers (each thread its
// own columns).  Each thread keeps online (max, sum) pairs and the top-2
// over its own columns; the four threads of a row merge at the end, and a
// per-row combine kernel merges the vocab splits in a fixed order.  The
// backward's dh kernel (8 warps, 32 rows, vocab split, f32 partials summed
// in a fixed order) and dW kernel (8 warps, 32 head rows, all N rows) are
// K6's with the combined ds.
//
// What bounds it on the H100, at N = 3072, DM = 896, V = 151936: the least
// work is one logits product (0.84 TFLOP, 0.85 ms at 989 TFLOP/s) in the
// forward and three (2.51 TFLOP, 2.54 ms) in the backward, against 1.87 GB
// of tmat (0.56 ms at 3.35 TB/s): tensor-core bound.  This first version
// computes the logits twice in the forward (pass 2 needs pass 1's row
// statistics) and once in each backward kernel, feeds mma.sync from
// synchronous shared-memory loads, and reads tmat four times (7.5 GB).

#include "kdss_mma.cuh"

namespace {

using namespace kdss;
using bf = __nv_bfloat16;

// ---- forward ------------------------------------------------------------

constexpr int F_BM = 64, F_BV = 128, F_BK = 64, F_LD = F_BK + 8, F_THREADS = 128;
constexpr int NT = F_BV / 8;  // n-tiles of 8 columns per vocab tile
// Pass-1 partials per (split, row): lse_s1, lse_sT, lse_t, m1, m2, gold_t,
// gold_s1.  Pass 2 reuses the first two planes for kl and tsum.
constexpr int NPART = 7;
// Row statistics handed from the forward to the backward, f32 [NROWS, N].
enum Row { R_LSE_ST = 0, R_LSE_T, R_SCALE, R_TVAL, R_LSE_S1, R_TSUM, NROWS };

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

// This thread's tmat entries of the tile, in the layout of acc; -inf for
// columns >= V and rows >= N (never read).
__device__ __forceinline__ void load_teacher(float (&tv)[NT][4], const float* tmat, const int rows[2],
                                             int v0, int N, int V, int ti) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = rows[e >> 1], col = v0 + nt * 8 + ti * 2 + (e & 1);
      tv[nt][e] = (row < N && col < V) ? tmat[(long)row * V + col] : -INFINITY;
    }
  }
}

// Top-2 of the union of two top-2 pairs (a1 >= a2, b1 >= b2): a tie of the
// maxima keeps both, so a duplicated max gives m2 = m1.
__device__ __forceinline__ void top2_merge(float& m1, float& m2, float b1, float b2) {
  const float second = fmaxf(fminf(m1, b1), fmaxf(m2, b2));
  m1 = fmaxf(m1, b1);
  m2 = second;
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

template <int DM>
__global__ void __launch_bounds__(F_THREADS)
    loca_stats_kernel(const bf* __restrict__ h, const bf* __restrict__ w,
                      const float* __restrict__ tmat, const int* __restrict__ lab,
                      const int* __restrict__ lab_ce, float* __restrict__ part, int N, int V,
                      int tiles_per_split, float inv_t) {
  static_assert(DM % F_BK == 0, "model dim must be a multiple of 64");
  __shared__ __align__(16) bf Hs[F_BM * F_LD];
  __shared__ __align__(16) bf Ws[F_BV * F_LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int n0 = blockIdx.x * F_BM, split = blockIdx.y, nsplit = gridDim.y;
  const int n_vt = (V + F_BV - 1) / F_BV;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, n_vt);
  const float cT = inv_t * LOG2E;

  const int rows[2] = {n0 + warp * 16 + gi, n0 + warp * 16 + gi + 8};
  int lt[2], lc[2];
  // Over this thread's columns: the student's raw max and its sums at T = 1
  // and at T (one max serves both: T > 0), the teacher's top-2 and its sum
  // with base m1, and the two gold logits.
  float ms[2] = {-INFINITY, -INFINITY}, l1[2] = {0.f, 0.f}, lT[2] = {0.f, 0.f};
  float m1[2] = {-INFINITY, -INFINITY}, m2[2] = {-INFINITY, -INFINITY}, lt_sum[2] = {0.f, 0.f};
  float gold_t[2] = {0.f, 0.f}, gold_s[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lt[i] = rows[i] < N ? lab[rows[i]] : -1;
    lc[i] = rows[i] < N ? lab_ce[rows[i]] : -1;
  }

  for (int t = t0; t < t1; ++t) {
    const int v0 = t * F_BV;
    float acc[NT][4], tv[NT][4];
    logits_tile<DM>(acc, Hs, Ws, h, w, n0, v0, N, V, warp, gi, ti);
    load_teacher(tv, tmat, rows, v0, N, V, ti);

    float tile_max[2] = {-INFINITY, -INFINITY}, m1_old[2] = {m1[0], m1[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = v0 + nt * 8 + ti * 2 + (e & 1);
        if (col < V) {
          tile_max[r] = fmaxf(tile_max[r], acc[nt][e]);
          if (col == lc[r]) gold_s[r] += acc[nt][e];
          if (col == lt[r]) gold_t[r] += tv[nt][e];
          top2_merge(m1[r], m2[r], tv[nt][e], -INFINITY);
        } else {
          acc[nt][e] = -INFINITY;
        }
      }
    }
    float bs[2], bt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float nm = fmaxf(ms[r], tile_max[r]);
      bs[r] = base_of(nm);
      l1[r] *= exp2f((ms[r] - bs[r]) * LOG2E);
      lT[r] *= exp2f((ms[r] - bs[r]) * cT);
      ms[r] = nm;
      bt[r] = base_of(m1[r]);
      lt_sum[r] *= exp2f((m1_old[r] - bt[r]) * LOG2E);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        l1[r] += exp2f((acc[nt][e] - bs[r]) * LOG2E);
        lT[r] += exp2f((acc[nt][e] - bs[r]) * cT);
        lt_sum[r] += exp2f((tv[nt][e] - bt[r]) * LOG2E);
      }
    }
  }

  // Merge the four threads of each row, then write this split's partials.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float M = quad_max(ms[r]), bM = base_of(M);
    const float s1 = quad_sum(l1[r] * exp2f((ms[r] - bM) * LOG2E));
    const float sT = quad_sum(lT[r] * exp2f((ms[r] - bM) * cT));
    float q1 = m1[r], q2 = m2[r];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float b1 = __shfl_xor_sync(FULL, q1, off), b2 = __shfl_xor_sync(FULL, q2, off);
      top2_merge(q1, q2, b1, b2);
    }
    const float st = quad_sum(lt_sum[r] * exp2f((m1[r] - base_of(q1)) * LOG2E));
    const float gt = quad_sum(gold_t[r]), gs = quad_sum(gold_s[r]);
    if (ti == 0 && rows[r] < N) {
      const long o = (long)split * N + rows[r], plane = (long)nsplit * N;
      part[0 * plane + o] = s1 > 0.f ? M + log2f(s1) * LN2 : -INFINITY;
      part[1 * plane + o] = sT > 0.f ? M * inv_t + log2f(sT) * LN2 : -INFINITY;
      part[2 * plane + o] = st > 0.f ? q1 + log2f(st) * LN2 : -INFINITY;
      part[3 * plane + o] = q1;
      part[4 * plane + o] = q2;
      part[5 * plane + o] = gt;
      part[6 * plane + o] = gs;
    }
  }
}

// logsumexp of the splits' partial logsumexps (-inf where a split saw nothing).
__device__ __forceinline__ float merge_lse(const float* p, long plane_stride, int n, int N, int nsplit) {
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, p[plane_stride + (long)s * N + n]);
  float sum = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float x = p[plane_stride + (long)s * N + n];
    if (x != -INFINITY) sum += expf(x - mx);
  }
  return mx + logf(sum);
}

__global__ void loca_stats_combine(const float* __restrict__ part, const int* __restrict__ lab,
                                   const int* __restrict__ lab_ce, float* __restrict__ rowstats,
                                   float* __restrict__ ce, int N, int nsplit, float alpha) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long plane = (long)nsplit * N;
  const float lse_s1 = merge_lse(part, 0 * plane, n, N, nsplit);
  const float lse_sT = merge_lse(part, 1 * plane, n, N, nsplit);
  const float lse_t = merge_lse(part, 2 * plane, n, N, nsplit);
  float m1 = -INFINITY, m2 = -INFINITY, gold_t = 0.f, gold_s = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long o = (long)s * N + n;
    top2_merge(m1, m2, part[3 * plane + o], part[4 * plane + o]);
    gold_t += part[5 * plane + o];
    gold_s += part[6 * plane + o];
  }
  const float p_gt = expf(gold_t - lse_t), p_2nd = expf(m2 - lse_t);
  const float scale = alpha / (1.f - p_gt + p_2nd);
  rowstats[R_LSE_ST * (long)N + n] = lse_sT;
  rowstats[R_LSE_T * (long)N + n] = lse_t;
  rowstats[R_SCALE * (long)N + n] = scale;
  rowstats[R_TVAL * (long)N + n] = 1.f - scale * (1.f - p_gt);
  rowstats[R_LSE_S1 * (long)N + n] = lse_s1;
  ce[n] = lab_ce[n] >= 0 ? lse_s1 - gold_s : 0.f;
}

// The calibrated teacher probability at one column, and its log (natural).
struct LocaRow {
  float lse_sT, lse_t, scale, log_scale, tval, log_tval;
  int lab;
};

__device__ __forceinline__ LocaRow loca_row(const float* rowstats, const int* lab, int n, int N) {
  LocaRow q;
  q.lse_sT = rowstats[R_LSE_ST * (long)N + n];
  q.lse_t = rowstats[R_LSE_T * (long)N + n];
  q.scale = rowstats[R_SCALE * (long)N + n];
  q.tval = rowstats[R_TVAL * (long)N + n];
  q.log_scale = logf(q.scale);
  q.log_tval = q.tval > 0.f ? logf(q.tval) : 0.f;
  q.lab = lab[n];
  return q;
}

// loca at column col from the teacher logit t (already at 1/T); log_loca
// is exact algebra on the same quantities (log of scale * p_t).
__device__ __forceinline__ float calibrated(const LocaRow& q, int col, float t, float& log_loca) {
  const float lpt = t - q.lse_t;
  if (q.lab < 0) {
    log_loca = lpt;
    return expf(lpt);
  }
  if (col == q.lab) {
    log_loca = q.log_tval;
    return q.tval;
  }
  log_loca = q.log_scale + lpt;
  return q.scale * expf(lpt);
}

template <int DM>
__global__ void __launch_bounds__(F_THREADS)
    loca_kl_kernel(const bf* __restrict__ h, const bf* __restrict__ w,
                   const float* __restrict__ tmat, const int* __restrict__ lab,
                   const float* __restrict__ rowstats, float* __restrict__ part, int N, int V,
                   int tiles_per_split, float inv_t, float log_eps) {
  __shared__ __align__(16) bf Hs[F_BM * F_LD];
  __shared__ __align__(16) bf Ws[F_BV * F_LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int n0 = blockIdx.x * F_BM, split = blockIdx.y, nsplit = gridDim.y;
  const int n_vt = (V + F_BV - 1) / F_BV;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, n_vt);

  const int rows[2] = {n0 + warp * 16 + gi, n0 + warp * 16 + gi + 8};
  LocaRow q[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) q[r] = loca_row(rowstats, lab, rows[r] < N ? rows[r] : 0, N);
  float kl[2] = {0.f, 0.f}, ts[2] = {0.f, 0.f};

  for (int t = t0; t < t1; ++t) {
    const int v0 = t * F_BV;
    float acc[NT][4], tv[NT][4];
    logits_tile<DM>(acc, Hs, Ws, h, w, n0, v0, N, V, warp, gi, ti);
    load_teacher(tv, tmat, rows, v0, N, V, ti);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = v0 + nt * 8 + ti * 2 + (e & 1);
        if (col >= V) continue;
        float log_loca;
        const float loca = calibrated(q[r], col, tv[nt][e], log_loca);
        const float log_ps = acc[nt][e] * inv_t - q[r].lse_sT;
        if (loca > 0.f) {
          kl[r] += loca * (log_loca - fmaxf(log_ps, log_eps));
          if (log_ps > log_eps) ts[r] += loca;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float k = quad_sum(kl[r]), s = quad_sum(ts[r]);
    if (ti == 0 && rows[r] < N) {
      const long o = (long)split * N + rows[r];
      part[o] = k;
      part[(long)nsplit * N + o] = s;
    }
  }
}

__global__ void loca_kl_combine(const float* __restrict__ part, float* __restrict__ kl,
                                float* __restrict__ rowstats, int N, int nsplit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float k = 0.f, s = 0.f;
  for (int i = 0; i < nsplit; ++i) {
    k += part[(long)i * N + n];
    s += part[(long)(nsplit + i) * N + n];
  }
  kl[n] = k;
  rowstats[R_TSUM * (long)N + n] = s;
}

// ---- backward -----------------------------------------------------------

constexpr int B_THREADS = 256;  // 8 warps
constexpr int DH_BM = 32, DH_BV = 64;   // dh: rows per block, head rows per tile
constexpr int DW_BV = 32, DW_BN = 64;   // dW: head rows per block, rows per chunk
constexpr int P_LD = 64 + 8;            // ds tile row stride
constexpr int NSTAT = 11;               // floats of per-row state below

// Rows' factors of ds in shared memory, block-local row r.
struct BwdRows {
  float *lse_sT, *lse_t, *scale, *tval, *lse_s1, *gk, *gc, *tsum;
  int *lab, *lab_ce, *live;  // live: the row is < N
};

__device__ __forceinline__ BwdRows bwd_rows(float* f, int rows) {
  return BwdRows{f, f + rows, f + 2 * rows, f + 3 * rows, f + 4 * rows, f + 5 * rows, f + 6 * rows,
                 f + 7 * rows, reinterpret_cast<int*>(f + 8 * rows),
                 reinterpret_cast<int*>(f + 9 * rows), reinterpret_cast<int*>(f + 10 * rows)};
}

__device__ __forceinline__ void load_bwd_rows(const BwdRows& b, int rows, int n0, int N,
                                              const float* rowstats, const int* lab,
                                              const int* lab_ce, const float* g_kl,
                                              const float* g_ce, float inv_t) {
  for (int i = threadIdx.x; i < rows; i += B_THREADS) {
    const int n = n0 + i;
    const bool in = n < N;
    b.lse_sT[i] = in ? rowstats[R_LSE_ST * (long)N + n] : 0.f;
    b.lse_t[i] = in ? rowstats[R_LSE_T * (long)N + n] : 0.f;
    b.scale[i] = in ? rowstats[R_SCALE * (long)N + n] : 0.f;
    b.tval[i] = in ? rowstats[R_TVAL * (long)N + n] : 0.f;
    b.lse_s1[i] = in ? rowstats[R_LSE_S1 * (long)N + n] : 0.f;
    b.tsum[i] = in ? rowstats[R_TSUM * (long)N + n] : 0.f;
    b.gk[i] = in ? g_kl[n] * inv_t : 0.f;
    const int lc = in ? lab_ce[n] : -1;
    b.gc[i] = lc >= 0 ? g_ce[n] : 0.f;
    b.lab[i] = in ? lab[n] : -1;
    b.lab_ce[i] = lc;
    b.live[i] = in;
  }
}

// ds for block-local row r (global row n), head row col, from the raw
// student logit x: the JAX `_combined_ds`.
__device__ __forceinline__ float dlogit(const BwdRows& b, int r, long n, int col, int V, float x,
                                        const float* tmat, float inv_t, float log_eps) {
  if (col >= V || !b.live[r]) return 0.f;
  const float t = tmat[n * V + col];
  const float log_ps = x * inv_t - b.lse_sT[r];
  const float p_sT = exp2f(log_ps * LOG2E);
  const float p_t = expf(t - b.lse_t[r]);
  const int lab = b.lab[r];
  const float loca = lab < 0 ? p_t : (col == lab ? b.tval[r] : b.scale[r] * p_t);
  const bool live = log_ps > log_eps && loca > 0.f;
  float ds = (p_sT * b.tsum[r] - (live ? loca : 0.f)) * b.gk[r];
  const float p_s1 = exp2f((x - b.lse_s1[r]) * LOG2E);
  ds += (p_s1 - (col == b.lab_ce[r] ? 1.f : 0.f)) * b.gc[r];
  return ds;
}

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

template <int DM>
constexpr int dh_smem_bytes() {
  return (DH_BM + DH_BV) * (DM + 8) * 2 + DH_BM * P_LD * 2 + NSTAT * DH_BM * 4;
}

template <int DM>
constexpr int dw_smem_bytes() {
  return (DW_BV + DW_BN) * (DM + 8) * 2 + DW_BV * P_LD * 2 + NSTAT * DW_BN * 4;
}

template <int DM>
__global__ void __launch_bounds__(B_THREADS)
    loca_dh_kernel(const bf* __restrict__ h, const bf* __restrict__ w,
                   const float* __restrict__ tmat, const int* __restrict__ lab,
                   const int* __restrict__ lab_ce, const float* __restrict__ rowstats,
                   const float* __restrict__ g_kl, const float* __restrict__ g_ce,
                   float* __restrict__ dh_part, int N, int V, int tiles_per_split, float inv_t,
                   float log_eps) {
  static_assert(DM % 64 == 0, "model dim must be a multiple of 64 (8 warps x 8 columns)");
  constexpr int LDD = DM + 8, NTW = DM / 64;  // n-tiles of 8 columns per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Hs = reinterpret_cast<bf*>(smem);
  bf* Ws = Hs + DH_BM * LDD;
  bf* Ps = Ws + DH_BV * LDD;
  const BwdRows rs = bwd_rows(reinterpret_cast<float*>(Ps + DH_BM * P_LD), DH_BM);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int n0 = blockIdx.x * DH_BM, split = blockIdx.y;
  const int n_vt = (V + DH_BV - 1) / DH_BV;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, n_vt);

  load_rows<DM, DH_BM>(Hs, h, n0, N);
  load_bwd_rows(rs, DH_BM, n0, N, rowstats, lab, lab_ce, g_kl, g_ce, inv_t);

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
        const float d0v = dlogit(rs, r, n, v0 + c, V, s[j][2 * hr], tmat, inv_t, log_eps);
        const float d1v = dlogit(rs, r, n, v0 + c + 1, V, s[j][2 * hr + 1], tmat, inv_t, log_eps);
        *reinterpret_cast<uint32_t*>(Ps + r * P_LD + c) = pack_bf16(d0v, d1v);
      }
    }
    __syncthreads();

    // dh[32, DM] += ds[32, 64] . w_tile[64, DM], this warp's columns.
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

__global__ void loca_reduce_dh(const float* __restrict__ dh_part, bf* __restrict__ dh, long count,
                               int nsplit) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += dh_part[s * count + i];
  dh[i] = __float2bfloat16(acc);
}

template <int DM>
__global__ void __launch_bounds__(B_THREADS)
    loca_dw_kernel(const bf* __restrict__ h, const bf* __restrict__ w,
                   const float* __restrict__ tmat, const int* __restrict__ lab,
                   const int* __restrict__ lab_ce, const float* __restrict__ rowstats,
                   const float* __restrict__ g_kl, const float* __restrict__ g_ce,
                   bf* __restrict__ dw, int N, int V, float inv_t, float log_eps) {
  static_assert(DM % 64 == 0, "model dim must be a multiple of 64 (8 warps x 8 columns)");
  constexpr int LDD = DM + 8, NTW = DM / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Ws = reinterpret_cast<bf*>(smem);
  bf* Hs = Ws + DW_BV * LDD;
  bf* Pt = Hs + DW_BN * LDD;  // ds transposed: [head row][row]
  const BwdRows rs = bwd_rows(reinterpret_cast<float*>(Pt + DW_BV * P_LD), DW_BN);

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
    load_bwd_rows(rs, DW_BN, n0, N, rowstats, lab, lab_ce, g_kl, g_ce, inv_t);
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
        Pt[c * P_LD + r] = __float2bfloat16(
            dlogit(rs, r, (long)n0 + r, v0 + c, V, s[j][e], tmat, inv_t, log_eps));
      }
    }
    __syncthreads();

    // dW[32, DM] += ds^T[32, 64] . h_chunk[64, DM], this warp's columns.
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
cudaError_t fwd(const bf* h, const bf* w, const float* tmat, const int* lab, const int* lab_ce,
                float* part, float* rowstats, float* kl, float* ce, int N, int V, int nsplit,
                float inv_t, float alpha, float log_eps, cudaStream_t st) {
  const int n_vt = (V + F_BV - 1) / F_BV;
  const int per = (n_vt + nsplit - 1) / nsplit;
  const dim3 grid((N + F_BM - 1) / F_BM, nsplit);
  const int cblocks = (N + 127) / 128;
  loca_stats_kernel<DM><<<grid, F_THREADS, 0, st>>>(h, w, tmat, lab, lab_ce, part, N, V, per, inv_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  loca_stats_combine<<<cblocks, 128, 0, st>>>(part, lab, lab_ce, rowstats, ce, N, nsplit, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  loca_kl_kernel<DM><<<grid, F_THREADS, 0, st>>>(h, w, tmat, lab, rowstats, part, N, V, per, inv_t,
                                                 log_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  loca_kl_combine<<<cblocks, 128, 0, st>>>(part, kl, rowstats, N, nsplit);
  return cudaGetLastError();
}

template <int DM>
cudaError_t bwd(const bf* h, const bf* w, const float* tmat, const int* lab, const int* lab_ce,
                const float* rowstats, const float* g_kl, const float* g_ce, float* dh_part, bf* dh,
                bf* dw, int N, int V, int nsplit, float inv_t, float log_eps, cudaStream_t st) {
  constexpr int dh_smem = dh_smem_bytes<DM>(), dw_smem = dw_smem_bytes<DM>();
  cudaError_t err = cudaFuncSetAttribute(loca_dh_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, dh_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(loca_dw_kernel<DM>, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return err;

  const int n_vt = (V + DH_BV - 1) / DH_BV;
  const int per = (n_vt + nsplit - 1) / nsplit;
  loca_dh_kernel<DM><<<dim3((N + DH_BM - 1) / DH_BM, nsplit), B_THREADS, dh_smem, st>>>(
      h, w, tmat, lab, lab_ce, rowstats, g_kl, g_ce, dh_part, N, V, per, inv_t, log_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long count = (long)N * DM;
  loca_reduce_dh<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(dh_part, dh, count, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  loca_dw_kernel<DM><<<(V + DW_BV - 1) / DW_BV, B_THREADS, dw_smem, st>>>(
      h, w, tmat, lab, lab_ce, rowstats, g_kl, g_ce, dw, N, V, inv_t, log_eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K11 forward.  part: f32 scratch [7, nsplit, N]; rowstats: f32 [6, N]
// (lse_sT, lse_t, scale, tval, lse_s1, tsum); kl, ce: f32 [N].  Returns a
// cudaError_t (cudaErrorInvalidValue for shapes not compiled).
int kdss_loca_ce_fwd(const void* h, const void* w, const void* tmat, const void* lab,
                     const void* lab_ce, void* part, void* rowstats, void* kl, void* ce, int N,
                     int V, int DM, int nsplit, float inv_t, float alpha, float log_eps,
                     void* stream) {
  if (N <= 0 || V <= 0 || nsplit <= 0 || nsplit > 65535 || !(inv_t > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (DM != 896) return static_cast<int>(cudaErrorInvalidValue);  // the 0.5B student's width
  return static_cast<int>(fwd<896>(
      static_cast<const bf*>(h), static_cast<const bf*>(w), static_cast<const float*>(tmat),
      static_cast<const int*>(lab), static_cast<const int*>(lab_ce), static_cast<float*>(part),
      static_cast<float*>(rowstats), static_cast<float*>(kl), static_cast<float*>(ce), N, V,
      nsplit, inv_t, alpha, log_eps, static_cast<cudaStream_t>(stream)));
}

// K11 backward.  dh_part: f32 scratch [nsplit, N, DM]; dh [N, DM] and
// dw [V, DM] bf16; g_kl, g_ce f32 [N].
int kdss_loca_ce_bwd(const void* h, const void* w, const void* tmat, const void* lab,
                     const void* lab_ce, const void* rowstats, const void* g_kl, const void* g_ce,
                     void* dh_part, void* dh, void* dw, int N, int V, int DM, int nsplit,
                     float inv_t, float log_eps, void* stream) {
  if (N <= 0 || V <= 0 || nsplit <= 0 || nsplit > 65535 || !(inv_t > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (DM != 896) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bwd<896>(
      static_cast<const bf*>(h), static_cast<const bf*>(w), static_cast<const float*>(tmat),
      static_cast<const int*>(lab), static_cast<const int*>(lab_ce),
      static_cast<const float*>(rowstats), static_cast<const float*>(g_kl),
      static_cast<const float*>(g_ce), static_cast<float*>(dh_part), static_cast<bf*>(dh),
      static_cast<bf*>(dw), N, V, nsplit, inv_t, log_eps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
