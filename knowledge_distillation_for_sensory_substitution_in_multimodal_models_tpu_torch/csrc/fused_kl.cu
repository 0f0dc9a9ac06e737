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
// Layout.  The forward (K7) runs on the mma.sync tiling of
// csrc/kdss_vocab.cuh: it reads the f32 tmat entries of each logits tile
// straight from device memory into registers; each thread keeps six
// accumulators per row over its own columns; the four threads of a row
// merge at the end, and a per-row combine kernel rescales the splits'
// partials to a common max and sums them in a fixed order.  The backward
// (K8) runs on the Hopper vocab core of csrc/kdss_vocab_sm90.cuh (wgmma fed
// by TMA under mbarriers): one sweep recomputes the logits, reads the
// teacher tile into registers while its products run and writes ds [N, V]
// in bf16 once (`DsEpi`: two exponentials and a subtract a logit, the
// scales folded into per-row constants); then the core's products dh = ds w
// (split over the vocab, f32 partials summed in split order) and, unless
// the head needs no gradient (dw == nullptr), dW = ds^T h.  The backward
// takes V a multiple of 4 (tmat read in 8-byte pairs).
//
// What bounds it on the H100, at N = 3072, DM = 896, V = 151936: the least
// work is one logits product (0.84 TFLOP, 0.85 ms at 989 TFLOP/s) in the
// forward and three (2.51 TFLOP, 2.54 ms; two without dW) in the backward,
// against 1.87 GB of tmat (0.56 ms at 3.35 TB/s): tensor-core bound.  The
// backward also writes and reads back 0.93 GB of ds.

#include "kdss_vocab.cuh"
#include "kdss_vocab_sm90.cuh"

// Named namespaces: the core's kernels are instantiated with this file's
// epilogue policy, and nvcc's host stubs cannot name a type of an unnamed
// one.  The forward (on kdss_vocab.cuh) and the backward (on
// kdss_vocab_sm90.cuh) live apart: the two headers name their helpers alike.
namespace kdss_kl {

using namespace kdss;

// ---- forward ------------------------------------------------------------

// Forward partials per (split, row), the planes of `part`.
enum Part { P_MS = 0, P_ZS, P_MT, P_ZT, P_U, P_W, NPART };

__device__ __forceinline__ float exp_(float x) { return exp2f(x * LOG2E); }

template <int DM>
__global__ void __launch_bounds__(F_THREADS)
    kl_fwd_kernel(const bf* __restrict__ h, const bf* __restrict__ w,
                  const float* __restrict__ tmat, float* __restrict__ part, int N, int V,
                  int tiles_per_split, float inv_t) {
  __shared__ __align__(16) bf Hs[F_BM * F_LD];
  __shared__ __align__(16) bf Ws[F_BV * F_LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int n0 = blockIdx.x * F_BM, split = blockIdx.y, nsplit = gridDim.y;
  const int n_vt = (V + F_BV - 1) / F_BV;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, n_vt);

  const int rows[2] = {n0 + warp * 16 + gi, n0 + warp * 16 + gi + 8};
  const bool in[2] = {rows[0] < N, rows[1] < N};
  // Over this thread's columns: the student's max and sum at 1/T, and the
  // teacher's max with Zt, U, W under it.
  float ms[2] = {-INFINITY, -INFINITY}, zs[2] = {0.f, 0.f};
  float mt[2] = {-INFINITY, -INFINITY}, zt[2] = {0.f, 0.f}, u[2] = {0.f, 0.f}, ws[2] = {0.f, 0.f};

  for (int t = t0; t < t1; ++t) {
    const int v0 = t * F_BV;
    float acc[NT][4], tv[NT][4];
    logits_tile<DM>(acc, Hs, Ws, h, w, n0, v0, N, V, warp, gi, ti);
    float smax[2] = {-INFINITY, -INFINITY}, tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = v0 + nt * 8 + ti * 2 + (e & 1);
        const bool ok = col < V && in[r];
        acc[nt][e] = ok ? acc[nt][e] * inv_t : -INFINITY;
        tv[nt][e] = ok ? tmat[(long)rows[r] * V + col] : -INFINITY;
        smax[r] = fmaxf(smax[r], acc[nt][e]);
        tmax[r] = fmaxf(tmax[r], tv[nt][e]);
      }
    }
    float bs[2], bt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float ns = fmaxf(ms[r], smax[r]), nm = fmaxf(mt[r], tmax[r]);
      bs[r] = base_of(ns);
      bt[r] = base_of(nm);
      zs[r] *= exp_(ms[r] - bs[r]);
      const float a = exp_(mt[r] - bt[r]);
      zt[r] *= a;
      u[r] *= a;
      ws[r] *= a;
      ms[r] = ns;
      mt[r] = nm;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float s = acc[nt][e], tt = tv[nt][e];
        if (tt == -INFINITY) continue;  // a masked column (or row): no products
        const float p = exp_(tt - bt[r]);
        zs[r] += exp_(s - bs[r]);
        zt[r] += p;
        u[r] += p * tt;
        ws[r] += p * s;
      }
    }
  }

  // Merge the four threads of each row, then write this split's partials.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float MS = quad_max(ms[r]), MT = quad_max(mt[r]);
    const float cs = exp_(ms[r] - base_of(MS)), ct = exp_(mt[r] - base_of(MT));
    const float zs_r = quad_sum(zs[r] * cs), zt_r = quad_sum(zt[r] * ct);
    const float u_r = quad_sum(u[r] * ct), w_r = quad_sum(ws[r] * ct);
    if (ti == 0 && in[r]) {
      const long o = (long)split * N + rows[r], plane = (long)nsplit * N;
      part[P_MS * plane + o] = MS;
      part[P_ZS * plane + o] = zs_r;
      part[P_MT * plane + o] = MT;
      part[P_ZT * plane + o] = zt_r;
      part[P_U * plane + o] = u_r;
      part[P_W * plane + o] = w_r;
    }
  }
}

// Rescale the splits' partials to the row's common maxima and sum them in
// split order: lse_s, lse_t and the KL row.
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

template <int DM>
cudaError_t fwd(const bf* h, const bf* w, const float* tmat, float* part, float* kl, float* lse_s,
                float* lse_t, int N, int V, int nsplit, float inv_t, cudaStream_t st) {
  const int n_vt = (V + F_BV - 1) / F_BV;
  const int per = (n_vt + nsplit - 1) / nsplit;
  kl_fwd_kernel<DM><<<dim3((N + F_BM - 1) / F_BM, nsplit), F_THREADS, 0, st>>>(h, w, tmat, part, N, V,
                                                                               per, inv_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kl_fwd_combine<<<(N + 127) / 128, 128, 0, st>>>(part, kl, lse_s, lse_t, N, nsplit);
  return cudaGetLastError();
}

}  // namespace kdss_kl

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

// K7.  part: f32 scratch [6, nsplit, N]; kl, lse_s, lse_t: f32 [N].
// Returns a cudaError_t (cudaErrorInvalidValue for shapes not compiled).
int kdss_kl_fwd(const void* h, const void* w, const void* tmat, void* part, void* kl, void* lse_s,
                void* lse_t, int N, int V, int DM, int nsplit, float inv_t, void* stream) {
  if (N <= 0 || V <= 0 || nsplit <= 0 || nsplit > 65535 || !(inv_t > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (DM != 896) return static_cast<int>(cudaErrorInvalidValue);  // the 0.5B student's width
  return static_cast<int>(kdss_kl::fwd<896>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(tmat),
      static_cast<float*>(part), static_cast<float*>(kl), static_cast<float*>(lse_s),
      static_cast<float*>(lse_t), N, V, nsplit, inv_t, static_cast<cudaStream_t>(stream)));
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
