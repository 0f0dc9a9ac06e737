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
// Both run on the Hopper vocab core of csrc/kdss_vocab_sm90.cuh (wgmma fed
// by TMA under mbarriers: 64 rows a block, their h in shared memory, two
// consumer warpgroups taking 128-wide vocab tiles in turns); neither loads
// a teacher tile (`TEACHER = false`), so V may be any size.
//   K5  one sweep (`kdss_ce_fwd90::LseGoldEpi`): each thread keeps an
//       online (max, sum) over its own columns of its two rows (one FMA and
//       one ex2 a logit) and the gold logit, read only in the tile that
//       holds the label (each column belongs to one thread, so the sum has
//       one nonzero addend); the four threads of a row merge at the end and
//       each (vocab split, warpgroup) writes its partial lse and gold;
//       `ce_fwd_combine` merges them in a fixed order.  The vocab is split
//       across blocks because 48 row blocks alone would leave most of the
//       132 SMs idle (the JAX grid runs its vocab axis in sequence).
//   K6  one sweep recomputes the logits and writes d_logits = g_lse * p +
//       g_gold * onehot(label), rounded to bf16 as the JAX kernels round
//       them, into ds [N, V] once (`kdss_ce90::DsEpi`: one exponential and
//       one compare a logit); then the core's two products dh = ds w (split
//       over the vocab, f32 partials summed in split order) and dW = ds^T h.
// Columns v >= V of a ragged last tile read zero-filled head rows and are
// masked out (the JAX `_masked_w` / `cols < v_real` masks); ds is never
// written there, and rows past N are never written.
//
// What bounds it on the H100, at N = 3072, DM = 896, V = 151936: the forward
// is one logits product (0.84 TFLOP, 0.85 ms at 989 TFLOP/s), the backward
// three (2.51 TFLOP, 2.54 ms) against 0.93 GB of bf16 ds written and read
// back (~0.56 ms at 3.35 TB/s): tensor-core bound.

#include "kdss_vocab_sm90.cuh"

// Named namespaces: the core's kernels are instantiated with this file's
// epilogue policies, and nvcc's host stubs cannot name a type of an unnamed
// one.  The forward's and the backward's policies live apart, so that a
// profile tells their kernels apart by name.
namespace kdss_ce_fwd90 {

using namespace kdss_vocab90;

// ---- K5: forward --------------------------------------------------------

// Over this thread's columns of its two rows: the online max and sum of
// e^s, and the gold logit.
struct LseGoldEpi {
  static constexpr bool TEACHER = false;
  const int* labels;
  float *lse_part, *gold_part;

  struct State {
    float m[2], l[2], gold[2];
    int lab[2];
  };

  __device__ void begin(State& q, const int rows[2], int N) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      q.m[r] = -INFINITY;
      q.l[r] = q.gold[r] = 0.f;
      q.lab[r] = rows[r] < N ? labels[rows[r]] : -1;
    }
  }

  template <class View>
  __device__ void tile(State& q, const float (&acc)[64], const View& view, const int*, int) const {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (view.in(j, e)) mx[e >> 1] = fmaxf(mx[e >> 1], acc[4 * j + e]);
    }
    float b[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float nm = fmaxf(q.m[r], mx[r]);
      q.l[r] *= exp2f((q.m[r] - base_of(nm)) * LOG2E);
      q.m[r] = nm;
      b[r] = base_of(nm) * LOG2E;
      // the gold logit: only in the one tile of the split that holds the label
      if (static_cast<unsigned>(q.lab[r] - view.v0) < static_cast<unsigned>(BN)) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (view.col(j, 2 * r + c) == q.lab[r]) q.gold[r] += acc[4 * j + 2 * r + c];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!view.in(j, e)) continue;
        q.l[e >> 1] += fast_exp2(fmaf(acc[4 * j + e], LOG2E, -b[e >> 1]));
      }
    }
  }

  // Merge the four threads of each row, then write this split's partials.
  __device__ void end(State& q, const int rows[2], int split, int, int N, int ti) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float M = quad_max(q.m[r]);
      const float s = quad_sum(q.l[r] * exp2f((q.m[r] - base_of(M)) * LOG2E));
      const float g = quad_sum(q.gold[r]);
      if (ti == 0 && rows[r] < N) {
        const long o = static_cast<long>(split) * N + rows[r];
        lse_part[o] = s > 0.f ? M + log2f(s) * LN2 : -INFINITY;
        gold_part[o] = g;
      }
    }
  }
};

// lse = the logsumexp of the partial lse of every (split, warpgroup) (-inf
// where one saw nothing), gold = the sum of theirs, both in that order.
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

// The sweep (no teacher), then the combine; nsplit partials a row (two per
// vocab split of the sweep, one per consumer warpgroup).
template <int DM>
cudaError_t fwd(const void* h, const void* w, const int* labels, float* lse_part, float* gold_part, float* lse,
                float* gold, int N, int V, int nsplit, cudaStream_t st) {
  cudaError_t err = kdss_vocab90_host::sweep<DM>(h, w, nullptr, LseGoldEpi{labels, lse_part, gold_part}, N, V,
                                                 nsplit / CONSUMERS, st);
  if (err != cudaSuccess) return err;
  ce_fwd_combine<<<(N + 127) / 128, 128, 0, st>>>(lse_part, gold_part, lse, gold, N, nsplit);
  return cudaGetLastError();
}

}  // namespace kdss_ce_fwd90

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

// K5.  lse_part / gold_part: f32 scratch [nsplit, N] (nsplit: twice the
// sweep's vocab splits, one partial per consumer warpgroup); lse / gold:
// f32 [N].  Returns a cudaError_t (cudaErrorInvalidValue for shapes not
// compiled or a tensor map the driver refuses).
int kdss_ce_fwd(const void* h, const void* w, const void* labels, void* lse_part, void* gold_part,
                void* lse, void* gold, int N, int V, int DM, int nsplit, void* stream) {
  if (N <= 0 || V <= 0 || DM != 896 || nsplit <= 0 || nsplit % kdss_vocab90::CONSUMERS ||
      nsplit / kdss_vocab90::CONSUMERS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kdss_ce_fwd90::fwd<896>(h, w, static_cast<const int*>(labels), static_cast<float*>(lse_part),
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
