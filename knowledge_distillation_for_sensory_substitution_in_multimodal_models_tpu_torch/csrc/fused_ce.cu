// Vocab-streaming fused cross-entropy for Hopper (sm_90a): per-row
// logsumexp and gold logit over the tied head, and their backward, without
// ever writing the [N, V] logits to device memory.
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
//   K5  `ce_fwd_kernel`, on the mma.sync tiling of csrc/kdss_vocab.cuh: one
//       block of 4 warps per (64 rows, vocab split); each warp owns 16 rows
//       and walks 128-column vocab tiles, keeping an online (max, sum) and
//       the gold logit per row in registers; a 128-thread `ce_fwd_combine`
//       merges the splits.  The vocab is split across blocks because 48 row
//       tiles alone would leave most of the 132 SMs idle (the JAX grid runs
//       its vocab axis in sequence).  Columns v >= V of the last tile read
//       zero-filled head rows and are masked out (the JAX `_masked_w` /
//       `cols < v_real` masks).
//   K6  on the Hopper vocab core of csrc/kdss_vocab_sm90.cuh (wgmma fed by
//       TMA under mbarriers): one sweep recomputes the logits and writes
//       d_logits = g_lse * p + g_gold * onehot(label), rounded to bf16 as
//       the JAX kernels round them, into ds [N, V] once (`DsEpi`: one
//       exponential and one compare a logit; no teacher tile is loaded);
//       then the core's two products dh = ds w (split over the vocab, f32
//       partials summed in split order) and dW = ds^T h.  Columns v >= V of
//       a ragged last tile are never written (the products' tensor maps
//       read zeros there); rows past N are never written.
//
// What bounds it on the H100, at N = 3072, DM = 896, V = 151936: the forward
// is one logits product (0.84 TFLOP, 0.85 ms at 989 TFLOP/s), the backward
// three (2.51 TFLOP, 2.54 ms) against 0.93 GB of bf16 ds written and read
// back (~0.56 ms at 3.35 TB/s): tensor-core bound.  K5 still feeds mma.sync
// from synchronous shared-memory loads.

#include "kdss_vocab.cuh"
#include "kdss_vocab_sm90.cuh"

// Named namespaces: the core's kernels are instantiated with this file's
// epilogue policy, and nvcc's host stubs cannot name a type of an unnamed
// one.  The forward (on kdss_vocab.cuh) and the backward (on
// kdss_vocab_sm90.cuh) live apart: the two headers name their helpers alike.
namespace kdss_ce {

using namespace kdss;

// ---- K5: forward --------------------------------------------------------

template <int DM>
__global__ void __launch_bounds__(F_THREADS)
    ce_fwd_kernel(const bf* __restrict__ h, const bf* __restrict__ w,
                  const int* __restrict__ labels, float* __restrict__ lse_part,
                  float* __restrict__ gold_part, int N, int V, int tiles_per_split) {
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
    float acc[NT][4];
    logits_tile<DM>(acc, Hs, Ws, h, w, n0, v0, N, V, warp, gi, ti);

    // Online logsumexp in the log2 domain; the gold logit in natural units.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
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
    for (int nt = 0; nt < NT; ++nt) {
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

}  // namespace kdss_ce

// ---- K6: backward ---------------------------------------------------------

namespace kdss_ce90 {

using namespace kdss_vocab90;

// ds = g_lse * exp(s - lse) + (col == label ? g_gold : 0), rounded to bf16
// and stored into ds [N, ld] (columns < V); per row, lse * log2(e) is folded
// into one constant, so a logit costs one FMA, one exponential and a compare.
struct DsEpi {
  static constexpr bool TEACHER = false;
  const float *lse, *g_lse, *g_gold;
  const int* labels;
  bf* ds;
  long ld;

  struct State {
    float b[2], gl[2], gg[2];
    int lab[2];
  };

  __device__ void begin(State& q, const int rows[2], int N) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = rows[r];
      const bool in = n < N;
      q.b[r] = in ? lse[n] * LOG2E : 0.f;
      q.gl[r] = in ? g_lse[n] : 0.f;
      q.gg[r] = in ? g_gold[n] : 0.f;
      q.lab[r] = in ? labels[n] : -1;
    }
  }

  __device__ __forceinline__ float dlogit(const State& q, int r, int col, float x) const {
    return fast_exp2(fmaf(x, LOG2E, -q.b[r])) * q.gl[r] + (col == q.lab[r] ? q.gg[r] : 0.f);
  }

  template <class View>
  __device__ void tile(State& q, const float (&acc)[64], const View& view, const int rows[2], int N) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // col is even and ld a multiple of 8 >= V, so the pair stays in the row
        const int col = view.col(j, 2 * r);
        if (rows[r] >= N || !view.in(j, 2 * r)) continue;
        const float d0 = dlogit(q, r, col, acc[4 * j + 2 * r]);
        const float d1 = dlogit(q, r, col + 1, acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(ds + rows[r] * ld + col) = kdss::pack_bf16(d0, d1);
      }
    }
  }

  __device__ void end(State&, const int*, int, int, int, int) const {}
};

// The ds sweep (no teacher), then dh and dW.
template <int DM>
cudaError_t bwd(const void* h, const void* w, const DsEpi& epi, float* dh_part, bf* dh, bf* dw, int N, int V,
                int nsplit_ds, int nsplit_dh, cudaStream_t st) {
  cudaError_t err = kdss_vocab90_host::sweep<DM>(h, w, nullptr, epi, N, V, nsplit_ds, st);
  if (err != cudaSuccess) return err;
  return kdss_vocab90_host::ds_products<DM, DsEpi>(h, w, epi.ds, epi.ld, dh_part, dh, dw, N, V, nsplit_dh, st);
}

}  // namespace kdss_ce90

extern "C" {

// K5.  lse_part / gold_part: f32 scratch [nsplit, N]; lse / gold: f32 [N].
// Returns a cudaError_t (cudaErrorInvalidValue for shapes not compiled).
int kdss_ce_fwd(const void* h, const void* w, const void* labels, void* lse_part, void* gold_part,
                void* lse, void* gold, int N, int V, int DM, int nsplit, void* stream) {
  if (N <= 0 || V <= 0 || nsplit <= 0 || nsplit > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (DM != 896) return static_cast<int>(cudaErrorInvalidValue);  // the 0.5B student's width
  return static_cast<int>(kdss_ce::fwd<896>(h, w, labels, static_cast<float*>(lse_part),
                                            static_cast<float*>(gold_part), static_cast<float*>(lse),
                                            static_cast<float*>(gold), N, V, nsplit,
                                            static_cast<cudaStream_t>(stream)));
}

// K6.  ds: bf16 scratch [N, ld_ds] (ld_ds >= V, a multiple of 8); dh_part: f32
// scratch [nsplit_dh, N, DM]; dh [N, DM] and dw [V, DM] bf16; nsplit_ds vocab
// splits of the ds sweep.
int kdss_ce_bwd(const void* h, const void* w, const void* labels, const void* lse, const void* g_lse,
                const void* g_gold, void* ds, void* dh_part, void* dh, void* dw, int N, int V, int DM,
                long ld_ds, int nsplit_ds, int nsplit_dh, void* stream) {
  if (N <= 0 || V <= 0 || DM != 896 || nsplit_ds <= 0 || nsplit_ds > 65535 || nsplit_dh <= 0 ||
      nsplit_dh > 65535 || ld_ds < V || ld_ds % 8 != 0 || dw == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const kdss_ce90::DsEpi epi{static_cast<const float*>(lse), static_cast<const float*>(g_lse),
                             static_cast<const float*>(g_gold), static_cast<const int*>(labels),
                             static_cast<__nv_bfloat16*>(ds), ld_ds};
  return static_cast<int>(kdss_ce90::bwd<896>(h, w, epi, static_cast<float*>(dh_part),
                                               static_cast<__nv_bfloat16*>(dh), static_cast<__nv_bfloat16*>(dw),
                                               N, V, nsplit_ds, nsplit_dh, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
