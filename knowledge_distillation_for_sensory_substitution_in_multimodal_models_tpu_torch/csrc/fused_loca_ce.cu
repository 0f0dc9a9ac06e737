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
// Layout: the shared vocab-streaming tiling of csrc/kdss_vocab.cuh.  The
// forward passes read the f32 tmat entries of each logits tile straight
// from device memory into registers (each thread its own columns).  Each
// thread keeps online (max, sum) pairs and the top-2 over its own columns;
// the four threads of a row merge at the end, and a per-row combine kernel
// merges the vocab splits in a fixed order.  The backward is the shared dh
// and dW kernels with the combined ds (`LocaCERows`).
//
// What bounds it on the H100, at N = 3072, DM = 896, V = 151936: the least
// work is one logits product (0.84 TFLOP, 0.85 ms at 989 TFLOP/s) in the
// forward and three (2.51 TFLOP, 2.54 ms) in the backward, against 1.87 GB
// of tmat (0.56 ms at 3.35 TB/s): tensor-core bound.  This first version
// computes the logits twice in the forward (pass 2 needs pass 1's row
// statistics) and once in each backward kernel, feeds mma.sync from
// synchronous shared-memory loads, and reads tmat four times (7.5 GB).

#include "kdss_vocab.cuh"

// A named namespace: the shared kernels are instantiated with this file's
// Rows policy, and nvcc's host stubs cannot name a type of an unnamed one.
namespace kdss_loca_ce {

using namespace kdss;

// ---- forward ------------------------------------------------------------

// Pass-1 partials per (split, row): lse_s1, lse_sT, lse_t, m1, m2, gold_t,
// gold_s1.  Pass 2 reuses the first two planes for kl and tsum.
constexpr int NPART = 7;
// Row statistics handed from the forward to the backward, f32 [NROWS, N].
enum Row { R_LSE_ST = 0, R_LSE_T, R_SCALE, R_TVAL, R_LSE_S1, R_TSUM, NROWS };

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

template <int DM>
__global__ void __launch_bounds__(F_THREADS)
    loca_stats_kernel(const bf* __restrict__ h, const bf* __restrict__ w,
                      const float* __restrict__ tmat, const int* __restrict__ lab,
                      const int* __restrict__ lab_ce, float* __restrict__ part, int N, int V,
                      int tiles_per_split, float inv_t) {
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

// The combined ds of the JAX `_combined_ds` from the forward's row
// statistics and the cotangents (g_kl, g_ce) of the KL and CE rows.
struct LocaCERows {
  // lse_sT, lse_t, scale, tval, lse_s1, g_kl / T, g_ce, tsum, then (int)
  // lab, lab_ce, live (the row is < N)
  static constexpr int NSTAT = 11;
  const float *tmat, *rowstats, *g_kl, *g_ce;
  const int *lab, *lab_ce;
  float inv_t, log_eps;

  __device__ void stage(float* f, int rows, int n0, int N) const {
    int* fi = reinterpret_cast<int*>(f + 8 * rows);
    for (int i = threadIdx.x; i < rows; i += B_THREADS) {
      const int n = n0 + i;
      const bool in = n < N;
      f[i] = in ? rowstats[R_LSE_ST * (long)N + n] : 0.f;
      f[rows + i] = in ? rowstats[R_LSE_T * (long)N + n] : 0.f;
      f[2 * rows + i] = in ? rowstats[R_SCALE * (long)N + n] : 0.f;
      f[3 * rows + i] = in ? rowstats[R_TVAL * (long)N + n] : 0.f;
      f[4 * rows + i] = in ? rowstats[R_LSE_S1 * (long)N + n] : 0.f;
      f[5 * rows + i] = in ? g_kl[n] * inv_t : 0.f;
      const int lc = in ? lab_ce[n] : -1;
      f[6 * rows + i] = lc >= 0 ? g_ce[n] : 0.f;
      f[7 * rows + i] = in ? rowstats[R_TSUM * (long)N + n] : 0.f;
      fi[i] = in ? lab[n] : -1;
      fi[rows + i] = lc;
      fi[2 * rows + i] = in;
    }
  }

  __device__ float dlogit(const float* f, int rows, int r, long n, int col, int V, float x) const {
    const int* fi = reinterpret_cast<const int*>(f + 8 * rows);
    if (col >= V || !fi[2 * rows + r]) return 0.f;
    const float t = tmat[n * V + col];
    const float log_ps = x * inv_t - f[r];
    const float p_sT = exp2f(log_ps * LOG2E);
    const float p_t = expf(t - f[rows + r]);
    const int lab_r = fi[r];
    const float loca = lab_r < 0 ? p_t : (col == lab_r ? f[3 * rows + r] : f[2 * rows + r] * p_t);
    const bool live = log_ps > log_eps && loca > 0.f;
    float ds = (p_sT * f[7 * rows + r] - (live ? loca : 0.f)) * f[5 * rows + r];
    const float p_s1 = exp2f((x - f[4 * rows + r]) * LOG2E);
    ds += (p_s1 - (col == fi[rows + r] ? 1.f : 0.f)) * f[6 * rows + r];
    return ds;
  }
};

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

}  // namespace kdss_loca_ce

using namespace kdss_loca_ce;

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
  const LocaCERows rows{static_cast<const float*>(tmat), static_cast<const float*>(rowstats),
                        static_cast<const float*>(g_kl), static_cast<const float*>(g_ce),
                        static_cast<const int*>(lab), static_cast<const int*>(lab_ce), inv_t, log_eps};
  return static_cast<int>(launch_bwd<896>(static_cast<const bf*>(h), static_cast<const bf*>(w), rows,
                                          static_cast<float*>(dh_part), static_cast<bf*>(dh),
                                          static_cast<bf*>(dw), N, V, nsplit,
                                          static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
