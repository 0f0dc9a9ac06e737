// Combined LoCa-KL + cross-entropy over the vocabulary for Hopper (sm_90a):
// the distillation loss of double-trouble phases 2/3 and logit_based, and
// its backward, without ever keeping the student's f32 [N, V] logits; and,
// with the template flag CE = false, the LoCa-KL rows alone.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/fused_loca.py
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/)
// in their single-device "materialize" form:
//   K11 (CE = true):
//   * forward, `_loca_ce_rows_kernels` (kernels `_stats_ce_kernel`,
//     `_klts_fwd_kernel`): per-row statistics, then the calibrated-KL row
//     sums and tsum (the sum of the live calibrated probabilities);
//   * backward, `_loca_ce_rows_bwd` (kernels `_dhs_ce_kernel`,
//     `_dws_ce_kernel`): d_hidden and d_head from the cotangents (g_kl, g_ce)
//     of the KL and CE rows.
//   K9 (CE = false), LoCa without CE:
//   * forward, `_row_stats` (kernel `_stats_kernel`) and `_call_rows` with
//     `_kl_fwd_kernel`: the same statistics without lse_s1, the student's
//     gold logit or the CE rows (lab_ce is never read), then the KL rows;
//   * backward, `_call_rows` with `_tsum_kernel`, `_dhs_kernel` and
//     `_dws_kernel`: d_hidden and d_head from the cotangent g of the KL rows
//     alone.  The TPU computes tsum in a separate backward sweep
//     (`_tsum_kernel`); here the forward's KL pass sums it, as for K11: it
//     is the same sum over the same live calibrated probabilities, and it
//     needs the same logits that pass already holds.
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
//               + (p_s1 - onehot_ce) * g_ce   (rows with lab_ce >= 0; K11 only),
//           rounded to bf16 (as the JAX kernels round it), then
//           dh = ds w and dW = ds^T h.
// Columns v >= V of a ragged last tile are masked everywhere; rows past N
// are never written.
//
// Layout: the vocab-streaming core of csrc/kdss_vocab_sm90.cuh (wgmma fed
// by TMA under mbarriers; 64 rows a block, their h in shared memory, two
// consumer warpgroups taking 128-wide vocab tiles in turns, the teacher
// tile loaded into registers while its products run).  Each thread keeps
// online (max, sum) pairs and the top-2 over its own columns of its two
// rows; the four threads of a row merge at the end, and a per-row combine
// kernel merges the partials of every (vocab split, warpgroup) in a fixed
// order.  The forward is two sweeps (pass 2 needs pass 1's lse_sT and
// scale, and the max(log p_sT, log eps) clamp does not split).  The
// backward is one sweep that recomputes the logits, reads tmat once and
// writes ds [N, V] in bf16 (`DsEpi`), then the two products dh = ds w
// (split over the vocab, f32 partials summed in split order) and
// dW = ds^T h on the core's GEMM.
//
// What bounds it on the H100, at N = 3072, DM = 896, V = 151936 (K9 and
// K11 alike): the least work is one logits product (0.84 TFLOP, 0.85 ms at
// 989 TFLOP/s) in the forward and three (2.51 TFLOP, 2.54 ms) in the
// backward, against 1.87 GB of tmat (0.56 ms at 3.35 TB/s): tensor-core
// bound.  The design does two products and reads tmat twice in the
// forward; three products, one tmat read and 0.93 GB of ds written and
// read back in the backward.

#include "kdss_vocab_sm90.cuh"

// A named namespace: the core's kernels are instantiated with this file's
// epilogue policies, and nvcc's host stubs cannot name a type of an
// unnamed one.
namespace kdss_loca_ce {

using namespace kdss_vocab90;

// Pass-1 partials, f32 [7, nsplit, N]: per (split, row) lse_s1, lse_sT,
// lse_t, m1, m2, gold_t, gold_s1 (planes 0 and 6 are left unwritten when
// CE = false), a split being one consumer warpgroup's tiles of one vocab
// split of the sweep.  Pass 2 reuses the first two planes for kl and tsum.

// Row statistics handed from the forward to the backward, f32 [NROWS, N].
enum Row { R_LSE_ST = 0, R_LSE_T, R_SCALE, R_TVAL, R_LSE_S1, R_TSUM, NROWS };

// Top-2 of the union of two top-2 pairs (a1 >= a2, b1 >= b2): a tie of the
// maxima keeps both, so a duplicated max gives m2 = m1.
__device__ __forceinline__ void top2_merge(float& m1, float& m2, float b1, float b2) {
  const float second = fmaxf(fminf(m1, b1), fmaxf(m2, b2));
  m1 = fmaxf(m1, b1);
  m2 = second;
}

// ---- forward ------------------------------------------------------------

// Pass 1: over this thread's columns, the student's raw max and its sums at
// T = 1 and at T (one max serves both: T > 0), the teacher's top-2 and its
// sum with base m1, and the two gold logits.
template <bool CE>
struct StatsEpi {
  static constexpr bool TEACHER = true;
  const int *lab, *lab_ce;
  float* part;
  float inv_t;

  struct State {
    float ms[2], l1[2], lT[2], m1[2], m2[2], lt_sum[2], gold_t[2], gold_s[2];
    int lt[2], lc[2];
  };

  __device__ void begin(State& q, const int rows[2], int N) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      q.ms[r] = q.m1[r] = q.m2[r] = -INFINITY;
      q.l1[r] = q.lT[r] = q.lt_sum[r] = q.gold_t[r] = q.gold_s[r] = 0.f;
      q.lt[r] = rows[r] < N ? lab[rows[r]] : -1;
      q.lc[r] = CE && rows[r] < N ? lab_ce[rows[r]] : -1;
    }
  }

  template <class View>
  __device__ void tile(State& q, const float (&acc)[64], const View& view, const int rows[2], int N) const {
    const float cT = inv_t * LOG2E;
    float tile_max[2] = {-INFINITY, -INFINITY}, m1_old[2] = {q.m1[0], q.m1[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = view.col(j, e);
        if (view.in(j, e)) {
          const float x = acc[4 * j + e], tv = view.teacher(j, e);
          tile_max[r] = fmaxf(tile_max[r], x);
          if (CE && col == q.lc[r]) q.gold_s[r] += x;
          if (col == q.lt[r]) q.gold_t[r] += tv;
          top2_merge(q.m1[r], q.m2[r], tv, -INFINITY);
        }
      }
    }
    float bs[2], bt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float nm = fmaxf(q.ms[r], tile_max[r]);
      bs[r] = base_of(nm);
      if (CE) q.l1[r] *= exp2f((q.ms[r] - bs[r]) * LOG2E);
      q.lT[r] *= exp2f((q.ms[r] - bs[r]) * cT);
      q.ms[r] = nm;
      bt[r] = base_of(q.m1[r]);
      q.lt_sum[r] *= exp2f((m1_old[r] - bt[r]) * LOG2E);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = view.in(j, e) ? acc[4 * j + e] : -INFINITY;
        if (CE) q.l1[r] += fast_exp2((x - bs[r]) * LOG2E);
        q.lT[r] += fast_exp2((x - bs[r]) * cT);
        q.lt_sum[r] += fast_exp2((view.teacher(j, e) - bt[r]) * LOG2E);
      }
    }
  }

  // Merge the four threads of each row, then write this split's partials.
  __device__ void end(State& q, const int rows[2], int split, int nsplit, int N, int ti) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float M = quad_max(q.ms[r]), bM = base_of(M);
      const float s1 = CE ? quad_sum(q.l1[r] * exp2f((q.ms[r] - bM) * LOG2E)) : 0.f;
      const float sT = quad_sum(q.lT[r] * exp2f((q.ms[r] - bM) * (inv_t * LOG2E)));
      float q1 = q.m1[r], q2 = q.m2[r];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float b1 = __shfl_xor_sync(FULL, q1, off), b2 = __shfl_xor_sync(FULL, q2, off);
        top2_merge(q1, q2, b1, b2);
      }
      const float st = quad_sum(q.lt_sum[r] * exp2f((q.m1[r] - base_of(q1)) * LOG2E));
      const float gt = quad_sum(q.gold_t[r]), gs = CE ? quad_sum(q.gold_s[r]) : 0.f;
      if (ti == 0 && rows[r] < N) {
        const long o = static_cast<long>(split) * N + rows[r], plane = static_cast<long>(nsplit) * N;
        if (CE) part[0 * plane + o] = s1 > 0.f ? M + log2f(s1) * LN2 : -INFINITY;
        part[1 * plane + o] = sT > 0.f ? M * inv_t + log2f(sT) * LN2 : -INFINITY;
        part[2 * plane + o] = st > 0.f ? q1 + log2f(st) * LN2 : -INFINITY;
        part[3 * plane + o] = q1;
        part[4 * plane + o] = q2;
        part[5 * plane + o] = gt;
        if (CE) part[6 * plane + o] = gs;
      }
    }
  }
};

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

// CE = false leaves lse_s1 at 0 and neither reads lab_ce nor writes ce.
template <bool CE>
__global__ void loca_stats_combine(const float* __restrict__ part, const int* __restrict__ lab_ce,
                                   float* __restrict__ rowstats, float* __restrict__ ce, int N,
                                   int nsplit, float alpha) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long plane = (long)nsplit * N;
  const float lse_s1 = CE ? merge_lse(part, 0 * plane, n, N, nsplit) : 0.f;
  const float lse_sT = merge_lse(part, 1 * plane, n, N, nsplit);
  const float lse_t = merge_lse(part, 2 * plane, n, N, nsplit);
  float m1 = -INFINITY, m2 = -INFINITY, gold_t = 0.f, gold_s = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long o = (long)s * N + n;
    top2_merge(m1, m2, part[3 * plane + o], part[4 * plane + o]);
    gold_t += part[5 * plane + o];
    if (CE) gold_s += part[6 * plane + o];
  }
  const float p_gt = expf(gold_t - lse_t), p_2nd = expf(m2 - lse_t);
  const float scale = alpha / (1.f - p_gt + p_2nd);
  rowstats[R_LSE_ST * (long)N + n] = lse_sT;
  rowstats[R_LSE_T * (long)N + n] = lse_t;
  rowstats[R_SCALE * (long)N + n] = scale;
  rowstats[R_TVAL * (long)N + n] = 1.f - scale * (1.f - p_gt);
  rowstats[R_LSE_S1 * (long)N + n] = lse_s1;
  if (CE) ce[n] = lab_ce[n] >= 0 ? lse_s1 - gold_s : 0.f;
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
    return fast_exp2(lpt * LOG2E);
  }
  if (col == q.lab) {
    log_loca = q.log_tval;
    return q.tval;
  }
  log_loca = q.log_scale + lpt;
  return q.scale * fast_exp2(lpt * LOG2E);
}

// Pass 2: the calibrated-KL row sums and tsum.
struct KlEpi {
  static constexpr bool TEACHER = true;
  const int* lab;
  const float* rowstats;
  float* part;
  float inv_t, log_eps;

  struct State {
    LocaRow q[2];
    float kl[2], ts[2];
  };

  __device__ void begin(State& s, const int rows[2], int N) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s.q[r] = loca_row(rowstats, lab, rows[r] < N ? rows[r] : 0, N);
      s.kl[r] = s.ts[r] = 0.f;
    }
  }

  template <class View>
  __device__ void tile(State& s, const float (&acc)[64], const View& view, const int rows[2], int N) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = view.col(j, e);
        if (!view.in(j, e)) continue;
        float log_loca;
        const float loca = calibrated(s.q[r], col, view.teacher(j, e), log_loca);
        const float log_ps = acc[4 * j + e] * inv_t - s.q[r].lse_sT;
        if (loca > 0.f) {
          s.kl[r] += loca * (log_loca - fmaxf(log_ps, log_eps));
          if (log_ps > log_eps) s.ts[r] += loca;
        }
      }
    }
  }

  __device__ void end(State& s, const int rows[2], int split, int nsplit, int N, int ti) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float k = quad_sum(s.kl[r]), t = quad_sum(s.ts[r]);
      if (ti == 0 && rows[r] < N) {
        const long o = static_cast<long>(split) * N + rows[r];
        part[o] = k;
        part[static_cast<long>(nsplit) * N + o] = t;
      }
    }
  }
};

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
// statistics and the cotangents (g_kl, g_ce) of the KL and CE rows, rounded
// to bf16 and stored into ds [N, ld] (columns < V); with CE = false (K9)
// the LoCa part alone, the JAX `_dhs_kernel` / `_dws_kernel` ds, and
// neither lab_ce nor g_ce is read.
template <bool CE>
struct DsEpi {
  static constexpr bool TEACHER = true;
  const float *rowstats, *g_kl, *g_ce;
  const int *lab, *lab_ce;
  bf* ds;
  long ld;
  float inv_t, log_eps;

  struct State {
    float lse_sT[2], lse_t[2], scale[2], tval[2], lse_s1[2], gk[2], gc[2], tsum[2];
    int lab[2], lc[2];
  };

  __device__ void begin(State& q, const int rows[2], int N) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = rows[r];
      const bool in = n < N;
      q.lse_sT[r] = in ? rowstats[R_LSE_ST * (long)N + n] : 0.f;
      q.lse_t[r] = in ? rowstats[R_LSE_T * (long)N + n] : 0.f;
      q.scale[r] = in ? rowstats[R_SCALE * (long)N + n] : 0.f;
      q.tval[r] = in ? rowstats[R_TVAL * (long)N + n] : 0.f;
      q.lse_s1[r] = CE && in ? rowstats[R_LSE_S1 * (long)N + n] : 0.f;
      q.gk[r] = in ? g_kl[n] * inv_t : 0.f;
      q.lc[r] = CE && in ? lab_ce[n] : -1;
      q.gc[r] = q.lc[r] >= 0 ? g_ce[n] : 0.f;
      q.tsum[r] = in ? rowstats[R_TSUM * (long)N + n] : 0.f;
      q.lab[r] = in ? lab[n] : -1;
    }
  }

  __device__ __forceinline__ float dlogit(const State& q, int r, int col, float x, float t) const {
    const float log_ps = x * inv_t - q.lse_sT[r];
    const float p_sT = fast_exp2(log_ps * LOG2E);
    const float p_t = fast_exp2((t - q.lse_t[r]) * LOG2E);
    const int lab_r = q.lab[r];
    const float loca = lab_r < 0 ? p_t : (col == lab_r ? q.tval[r] : q.scale[r] * p_t);
    const bool live = log_ps > log_eps && loca > 0.f;
    float d = (p_sT * q.tsum[r] - (live ? loca : 0.f)) * q.gk[r];
    if constexpr (CE) {
      const float p_s1 = fast_exp2((x - q.lse_s1[r]) * LOG2E);
      d += (p_s1 - (col == q.lc[r] ? 1.f : 0.f)) * q.gc[r];
    }
    return d;
  }

  template <class View>
  __device__ void tile(State& q, const float (&acc)[64], const View& view, const int rows[2], int N) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = view.col(j, 2 * r);  // even; V % 4 == 0, so col < V covers col + 1
        if (rows[r] >= N || !view.in(j, 2 * r)) continue;
        const float d0 = dlogit(q, r, col, acc[4 * j + 2 * r], view.teacher(j, 2 * r));
        const float d1 = dlogit(q, r, col + 1, acc[4 * j + 2 * r + 1], view.teacher(j, 2 * r + 1));
        *reinterpret_cast<uint32_t*>(ds + rows[r] * ld + col) = kdss::pack_bf16(d0, d1);
      }
    }
  }

  __device__ void end(State&, const int*, int, int, int, int) const {}
};

// The forward; CE = false takes lab_ce and ce as null.
template <int DM, bool CE>
cudaError_t fwd(const void* h, const void* w, const float* tmat, const int* lab, const int* lab_ce, float* part,
                float* rowstats, float* kl, float* ce, int N, int V, int nsplit, float inv_t, float alpha,
                float log_eps, cudaStream_t st) {
  const int cblocks = (N + 127) / 128, sweep_splits = nsplit / CONSUMERS;
  cudaError_t err =
      kdss_vocab90_host::sweep<DM>(h, w, tmat, StatsEpi<CE>{lab, lab_ce, part, inv_t}, N, V, sweep_splits, st);
  if (err != cudaSuccess) return err;
  loca_stats_combine<CE><<<cblocks, 128, 0, st>>>(part, lab_ce, rowstats, ce, N, nsplit, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = kdss_vocab90_host::sweep<DM>(h, w, tmat, KlEpi{lab, rowstats, part, inv_t, log_eps}, N, V, sweep_splits,
                                     st);
  if (err != cudaSuccess) return err;
  loca_kl_combine<<<cblocks, 128, 0, st>>>(part, kl, rowstats, N, nsplit);
  return cudaGetLastError();
}

// The backward: the ds sweep, then dh and (unless dw is null) dW.
template <int DM, bool CE>
cudaError_t bwd(const void* h, const void* w, const float* tmat, const DsEpi<CE>& epi, float* dh_part, bf* dh,
                bf* dw, int N, int V, int nsplit_ds, int nsplit_dh, cudaStream_t st) {
  cudaError_t err = kdss_vocab90_host::sweep<DM>(h, w, tmat, epi, N, V, nsplit_ds, st);
  if (err != cudaSuccess) return err;
  return kdss_vocab90_host::ds_products<DM, DsEpi<CE>>(h, w, epi.ds, epi.ld, dh_part, dh, dw, N, V, nsplit_dh, st);
}

inline bool bad_args(int N, int V, int DM, int nsplit, float inv_t) {
  // DM: the 0.5B student's width, the one compiled; V % 4: tmat's row
  // stride must be a multiple of 16 bytes for TMA
  return N <= 0 || V <= 0 || V % 4 != 0 || nsplit <= 0 || nsplit > 65535 || !(inv_t > 0.f) || DM != 896;
}

inline bool bad_ds(int V, long ld_ds, int nsplit_dh) {
  // ds rows must be 16-byte aligned for TMA and hold V columns
  return ld_ds < V || ld_ds % 8 != 0 || nsplit_dh <= 0 || nsplit_dh > 65535;
}

}  // namespace kdss_loca_ce

using namespace kdss_loca_ce;

extern "C" {

// K11 forward.  part: f32 scratch [7, nsplit, N] (nsplit: twice the
// sweep's vocab splits, one partial per consumer warpgroup); rowstats: f32 [6, N]
// (lse_sT, lse_t, scale, tval, lse_s1, tsum); kl, ce: f32 [N].  Returns a
// cudaError_t (cudaErrorInvalidValue for shapes not compiled or a tensor
// map the driver refuses).
int kdss_loca_ce_fwd(const void* h, const void* w, const void* tmat, const void* lab,
                     const void* lab_ce, void* part, void* rowstats, void* kl, void* ce, int N,
                     int V, int DM, int nsplit, float inv_t, float alpha, float log_eps,
                     void* stream) {
  if (bad_args(N, V, DM, nsplit, inv_t) || nsplit % CONSUMERS) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd<896, true>(
      h, w, static_cast<const float*>(tmat), static_cast<const int*>(lab), static_cast<const int*>(lab_ce),
      static_cast<float*>(part), static_cast<float*>(rowstats), static_cast<float*>(kl), static_cast<float*>(ce),
      N, V, nsplit, inv_t, alpha, log_eps, static_cast<cudaStream_t>(stream)));
}

// K11 backward.  ds: bf16 scratch [N, ld_ds] (ld_ds >= V, a multiple of 8);
// dh_part: f32 scratch [nsplit_dh, N, DM]; dh [N, DM] and dw [V, DM] bf16;
// g_kl, g_ce f32 [N]; nsplit_ds vocab splits of the ds sweep.
int kdss_loca_ce_bwd(const void* h, const void* w, const void* tmat, const void* lab,
                     const void* lab_ce, const void* rowstats, const void* g_kl, const void* g_ce,
                     void* ds, void* dh_part, void* dh, void* dw, int N, int V, int DM, long ld_ds,
                     int nsplit_ds, int nsplit_dh, float inv_t, float log_eps, void* stream) {
  if (bad_args(N, V, DM, nsplit_ds, inv_t) || bad_ds(V, ld_ds, nsplit_dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const DsEpi<true> epi{static_cast<const float*>(rowstats), static_cast<const float*>(g_kl),
                        static_cast<const float*>(g_ce), static_cast<const int*>(lab),
                        static_cast<const int*>(lab_ce), static_cast<bf*>(ds), ld_ds, inv_t, log_eps};
  return static_cast<int>(bwd<896, true>(h, w, static_cast<const float*>(tmat), epi, static_cast<float*>(dh_part), static_cast<bf*>(dh),
                                         static_cast<bf*>(dw), N, V, nsplit_ds, nsplit_dh,
                                         static_cast<cudaStream_t>(stream)));
}

// K9 forward (LoCa alone).  part: f32 scratch [7, nsplit, N] as for K11; rowstats: f32
// [6, N] in K11's order, lse_s1 left at 0; kl: f32 [N].
int kdss_loca_fwd(const void* h, const void* w, const void* tmat, const void* lab, void* part,
                  void* rowstats, void* kl, int N, int V, int DM, int nsplit, float inv_t,
                  float alpha, float log_eps, void* stream) {
  if (bad_args(N, V, DM, nsplit, inv_t) || nsplit % CONSUMERS) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd<896, false>(h, w, static_cast<const float*>(tmat), static_cast<const int*>(lab),
                                          nullptr, static_cast<float*>(part), static_cast<float*>(rowstats),
                                          static_cast<float*>(kl), nullptr, N, V, nsplit, inv_t, alpha, log_eps,
                                          static_cast<cudaStream_t>(stream)));
}

// K9 backward.  ds and dh_part as for K11; dh [N, DM] bf16 and, unless dw
// is null, dw [V, DM] bf16; g f32 [N], the cotangent of the KL rows.
int kdss_loca_bwd(const void* h, const void* w, const void* tmat, const void* lab,
                  const void* rowstats, const void* g, void* ds, void* dh_part, void* dh, void* dw, int N,
                  int V, int DM, long ld_ds, int nsplit_ds, int nsplit_dh, float inv_t, float log_eps,
                  void* stream) {
  if (bad_args(N, V, DM, nsplit_ds, inv_t) || bad_ds(V, ld_ds, nsplit_dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const DsEpi<false> epi{static_cast<const float*>(rowstats), static_cast<const float*>(g), nullptr,
                         static_cast<const int*>(lab), nullptr, static_cast<bf*>(ds), ld_ds, inv_t, log_eps};
  return static_cast<int>(bwd<896, false>(h, w, static_cast<const float*>(tmat), epi, static_cast<float*>(dh_part), static_cast<bf*>(dh),
                                          static_cast<bf*>(dw), N, V, nsplit_ds, nsplit_dh,
                                          static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
