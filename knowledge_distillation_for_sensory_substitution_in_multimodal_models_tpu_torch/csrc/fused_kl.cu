// Temperature KL(p_T || p_S) over the vocabulary for Hopper (sm_90a): the
// soft-target term of double-trouble phase 1 and feature_based, and its
// backward, without ever writing the student's [N, V] logits.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/fused_kl.py
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/)
// in their single-device "materialize" form:
//   * K7, forward, `_kl_rows_impl` (kernel `_kl_fwd1_kernel`): the KL row
//     sums in one sweep, with the student's and the teacher's lse at 1/T;
//   * K8, backward, `_kl_rows_bwd` (kernels `_kl_dhs_kernel`,
//     `_kl_dws_kernel`): d_hidden and d_head from the cotangent g of the KL
//     rows.
// h [N, DM] and the student head w [V, DM] ("vd", the tied embedding) are
// bf16; tmat [N, V] f32 is the teacher's logits already scaled by 1/T and
// truncated to the student vocab (computed once outside, as the JAX
// `_materialize_t` does, and only read here).
//
// Per row, with sT = s / T and t = tmat (natural logs):
//   forward: one sweep keeps the student's online (max, sum) of e^sT and,
//            under one running teacher max mt, Zt = sum e^(t - mt),
//            U = sum e^(t - mt) t and W = sum e^(t - mt) sT, all rescaled
//            like a flash-attention accumulator when a max grows; then
//            lse_s = ms + log Zs, lse_t = mt + log Zt and
//            KL = (U - W) / Zt - lse_t + lse_s  (= sum p_t (log p_t - log p_sT));
//   backward: ds = (e^(sT - lse_s) - e^(t - lse_t)) g / T, rounded to bf16
//            (as the JAX kernels round it), then dh = ds w and dW = ds^T h.
// Columns v >= V of a ragged last tile are masked everywhere, the products
// p t and p sT included (e^-inf * -inf is NaN); rows past N are never read
// from tmat and are never written.
//
// Layout: the Hopper vocab core of csrc/kdss_vocab_sm90.cuh (wgmma fed by
// TMA under mbarriers; 64 rows a block, their h in shared memory, two
// consumer warpgroups taking 128-wide vocab tiles in turns, the teacher
// tile loaded into registers while its products run).
//   K7  one sweep (`kdss_kl_fwd90::StatsEpi`): each thread keeps the six
//       statistics over its own columns of its two rows, the scales folded
//       into per-row constants (e^(x/T - ms) as one FMA and one ex2, U and
//       W as FMAs on the teacher's weight); the four threads of a row merge
//       at the end and each (vocab split, warpgroup) writes its partials;
//       `kl_fwd_combine` rescales them to the row's common maxima and sums
//       them in a fixed order.  Its teacher statistics are the step's own,
//       not calibrated, so one sweep suffices.
//   K8  one sweep that recomputes the logits, reads the teacher tile and
//       writes ds [N, V] in bf16 once (`kdss_kl90::DsEpi`: two exponentials
//       and a subtract a logit, the scales folded into per-row constants);
//       then the core's products dh = ds w (split over the vocab, f32
//       partials summed in split order) and, unless the head needs no
//       gradient (dw == nullptr), dW = ds^T h.
// Both take V a multiple of 4 (tmat read in 8-byte pairs).
//
// What bounds it on the H100, at N = 3072, DM = 896, V = 151936: the least
// work is one logits product (0.84 TFLOP, 0.85 ms at 989 TFLOP/s) in the
// forward and three (2.51 TFLOP, 2.54 ms; two without dW) in the backward,
// against 1.87 GB of tmat (0.56 ms at 3.35 TB/s): tensor-core bound.  The
// backward also writes and reads back 0.93 GB of ds.

#include "kdss_vocab_sm90.cuh"

// Named namespaces: the core's kernels are instantiated with this file's
// epilogue policies, and nvcc's host stubs cannot name a type of an unnamed
// one.  The forward's and the backward's policies live apart, so that a
// profile tells their kernels apart by name.
namespace kdss_kl_fwd90 {

using namespace kdss_vocab90;

// ---- K7: forward --------------------------------------------------------

// Forward partials per (split, row), the planes of `part`: the student's
// max and sum at 1/T (natural units), and the teacher's max with Zt, U, W
// under it.
enum Part { P_MS = 0, P_ZS, P_MT, P_ZT, P_U, P_W, NPART };

// The six statistics over this thread's columns, the student's kept at the
// raw logit x (its max; W sums p x): at the end the max is scaled by 1/T
// and W multiplied by it, exact algebra on the same sums.
struct StatsEpi {
  static constexpr bool TEACHER = true;
  float* part;
  float inv_t;

  struct State {
    float ms[2], zs[2], mt[2], zt[2], u[2], w[2];
  };

  __device__ void begin(State& q, const int*, int) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      q.ms[r] = q.mt[r] = -INFINITY;
      q.zs[r] = q.zt[r] = q.u[r] = q.w[r] = 0.f;
    }
  }

  template <class View>
  __device__ void tile(State& q, const float (&acc)[64], const View& view, const int*, int) const {
    const float cs = inv_t * LOG2E;
    float smax[2] = {-INFINITY, -INFINITY}, tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!view.in(j, e)) continue;
        smax[e >> 1] = fmaxf(smax[e >> 1], acc[4 * j + e]);
        tmax[e >> 1] = fmaxf(tmax[e >> 1], view.teacher(j, e));
      }
    }
    float bs[2], bt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ns = fmaxf(q.ms[r], smax[r]), nt = fmaxf(q.mt[r], tmax[r]);
      q.zs[r] *= exp2f((q.ms[r] - base_of(ns)) * cs);
      const float a = exp2f((q.mt[r] - base_of(nt)) * LOG2E);
      q.zt[r] *= a;
      q.u[r] *= a;
      q.w[r] *= a;
      q.ms[r] = ns;
      q.mt[r] = nt;
      bs[r] = base_of(ns) * cs;
      bt[r] = base_of(nt) * LOG2E;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked column adds nothing: its -inf teacher logit would make
        // p t and p x NaN (e^-inf * -inf)
        if (!view.in(j, e)) continue;
        const int r = e >> 1;
        const float x = acc[4 * j + e], t = view.teacher(j, e);
        const float p = fast_exp2(fmaf(t, LOG2E, -bt[r]));
        q.zs[r] += fast_exp2(fmaf(x, cs, -bs[r]));
        q.zt[r] += p;
        q.u[r] = fmaf(p, t, q.u[r]);
        q.w[r] = fmaf(p, x, q.w[r]);
      }
    }
  }

  // Merge the four threads of each row, then write this split's partials
  // (rows past N, whose teacher logits read -inf, are never written).
  __device__ void end(State& q, const int rows[2], int split, int nsplit, int N, int ti) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float MS = quad_max(q.ms[r]), MT = quad_max(q.mt[r]);
      const float cs = exp2f((q.ms[r] - base_of(MS)) * (inv_t * LOG2E));
      const float ct = exp2f((q.mt[r] - base_of(MT)) * LOG2E);
      const float zs = quad_sum(q.zs[r] * cs), zt = quad_sum(q.zt[r] * ct);
      const float u = quad_sum(q.u[r] * ct), w = quad_sum(q.w[r] * ct);
      if (ti == 0 && rows[r] < N) {
        const long o = static_cast<long>(split) * N + rows[r], plane = static_cast<long>(nsplit) * N;
        part[P_MS * plane + o] = MS * inv_t;
        part[P_ZS * plane + o] = zs;
        part[P_MT * plane + o] = MT;
        part[P_ZT * plane + o] = zt;
        part[P_U * plane + o] = u;
        part[P_W * plane + o] = w * inv_t;
      }
    }
  }
};

// Rescale the partials of every (split, warpgroup) to the row's common
// maxima and sum them in that order: lse_s, lse_t and the KL row.
__global__ void kl_fwd_combine(const float* __restrict__ part, float* __restrict__ kl,
                               float* __restrict__ lse_s, float* __restrict__ lse_t, int N,
                               int nsplit) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const long plane = (long)nsplit * N;
  float MS = -INFINITY, MT = -INFINITY;
  for (int s = 0; s < nsplit; ++s) {
    MS = fmaxf(MS, part[P_MS * plane + (long)s * N + n]);
    MT = fmaxf(MT, part[P_MT * plane + (long)s * N + n]);
  }
  float zs = 0.f, zt = 0.f, u = 0.f, w = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long o = (long)s * N + n;
    const float ms = part[P_MS * plane + o], mt = part[P_MT * plane + o];
    if (ms != -INFINITY) zs += part[P_ZS * plane + o] * expf(ms - MS);
    if (mt != -INFINITY) {
      const float c = expf(mt - MT);
      zt += part[P_ZT * plane + o] * c;
      u += part[P_U * plane + o] * c;
      w += part[P_W * plane + o] * c;
    }
  }
  const float ls = MS + logf(zs), lt = MT + logf(zt);
  lse_s[n] = ls;
  lse_t[n] = lt;
  kl[n] = (u - w) / zt - lt + ls;
}

// The sweep, then the combine; nsplit partials a row (two per vocab split
// of the sweep, one per consumer warpgroup).
template <int DM>
cudaError_t fwd(const void* h, const void* w, const float* tmat, float* part, float* kl, float* lse_s,
                float* lse_t, int N, int V, int nsplit, float inv_t, cudaStream_t st) {
  cudaError_t err =
      kdss_vocab90_host::sweep<DM>(h, w, tmat, StatsEpi{part, inv_t}, N, V, nsplit / CONSUMERS, st);
  if (err != cudaSuccess) return err;
  kl_fwd_combine<<<(N + 127) / 128, 128, 0, st>>>(part, kl, lse_s, lse_t, N, nsplit);
  return cudaGetLastError();
}

}  // namespace kdss_kl_fwd90

// ---- K8: backward ---------------------------------------------------------

namespace kdss_kl90 {

using namespace kdss_vocab90;

// ds = (exp(s / T - lse_s) - exp(t - lse_t)) g / T (the JAX
// `_kl_dhs_kernel`'s ds) from the forward's lse_s, lse_t and the cotangent g
// of the KL rows, rounded to bf16 and stored into ds [N, ld] (columns < V).
// Per row, lse_s log2(e), lse_t log2(e) and g / T are folded into constants.
struct DsEpi {
  static constexpr bool TEACHER = true;
  const float *lse_s, *lse_t, *g;
  bf* ds;
  long ld;
  float inv_t;

  struct State {
    float bs[2], bt[2], gt[2];
  };

  __device__ void begin(State& q, const int rows[2], int N) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = rows[r];
      const bool in = n < N;
      q.bs[r] = in ? lse_s[n] * LOG2E : 0.f;
      q.bt[r] = in ? lse_t[n] * LOG2E : 0.f;
      q.gt[r] = in ? g[n] * inv_t : 0.f;
    }
  }

  template <class View>
  __device__ void tile(State& q, const float (&acc)[64], const View& view, const int rows[2], int N) const {
    const float cs = inv_t * LOG2E;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = view.col(j, 2 * r);  // even; V % 4 == 0, so col < V covers col + 1
        if (rows[r] >= N || !view.in(j, 2 * r)) continue;
        float d[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          d[c] = (fast_exp2(fmaf(acc[4 * j + e], cs, -q.bs[r])) -
                  fast_exp2(fmaf(view.teacher(j, e), LOG2E, -q.bt[r]))) * q.gt[r];
        }
        *reinterpret_cast<uint32_t*>(ds + rows[r] * ld + col) = kdss::pack_bf16(d[0], d[1]);
      }
    }
  }

  __device__ void end(State&, const int*, int, int, int, int) const {}
};

// The ds sweep, then dh and (unless dw is null) dW.
template <int DM>
cudaError_t bwd(const void* h, const void* w, const float* tmat, const DsEpi& epi, float* dh_part, bf* dh, bf* dw,
                int N, int V, int nsplit_ds, int nsplit_dh, cudaStream_t st) {
  cudaError_t err = kdss_vocab90_host::sweep<DM>(h, w, tmat, epi, N, V, nsplit_ds, st);
  if (err != cudaSuccess) return err;
  return kdss_vocab90_host::ds_products<DM, DsEpi>(h, w, epi.ds, epi.ld, dh_part, dh, dw, N, V, nsplit_dh, st);
}

}  // namespace kdss_kl90

extern "C" {

// K7.  part: f32 scratch [6, nsplit, N] (nsplit: twice the sweep's vocab
// splits, one partial per consumer warpgroup); kl, lse_s, lse_t: f32 [N];
// V a multiple of 4.  Returns a cudaError_t (cudaErrorInvalidValue for
// shapes not compiled or a tensor map the driver refuses).
int kdss_kl_fwd(const void* h, const void* w, const void* tmat, void* part, void* kl, void* lse_s,
                void* lse_t, int N, int V, int DM, int nsplit, float inv_t, void* stream) {
  if (N <= 0 || V <= 0 || V % 4 != 0 || DM != 896 || nsplit <= 0 || nsplit % kdss_vocab90::CONSUMERS ||
      nsplit / kdss_vocab90::CONSUMERS > 65535 || !(inv_t > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kdss_kl_fwd90::fwd<896>(h, w, static_cast<const float*>(tmat), static_cast<float*>(part),
                                                   static_cast<float*>(kl), static_cast<float*>(lse_s),
                                                   static_cast<float*>(lse_t), N, V, nsplit, inv_t,
                                                   static_cast<cudaStream_t>(stream)));
}

// K8.  ds: bf16 scratch [N, ld_ds] (ld_ds >= V, a multiple of 8); dh_part:
// f32 scratch [nsplit_dh, N, DM]; dh [N, DM] bf16; dw [V, DM] bf16, or null
// to skip dW; lse_s, lse_t, g f32 [N]; nsplit_ds vocab splits of the ds
// sweep; V a multiple of 4.
int kdss_kl_bwd(const void* h, const void* w, const void* tmat, const void* lse_s, const void* lse_t,
                const void* g, void* ds, void* dh_part, void* dh, void* dw, int N, int V, int DM, long ld_ds,
                int nsplit_ds, int nsplit_dh, float inv_t, void* stream) {
  if (N <= 0 || V <= 0 || V % 4 != 0 || DM != 896 || nsplit_ds <= 0 || nsplit_ds > 65535 || nsplit_dh <= 0 ||
      nsplit_dh > 65535 || ld_ds < V || ld_ds % 8 != 0 || !(inv_t > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const kdss_kl90::DsEpi epi{static_cast<const float*>(lse_s), static_cast<const float*>(lse_t),
                             static_cast<const float*>(g), static_cast<__nv_bfloat16*>(ds), ld_ds, inv_t};
  return static_cast<int>(kdss_kl90::bwd<896>(h, w, static_cast<const float*>(tmat), epi,
                                               static_cast<float*>(dh_part), static_cast<__nv_bfloat16*>(dh),
                                               static_cast<__nv_bfloat16*>(dw), N, V, nsplit_ds, nsplit_dh,
                                               static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
