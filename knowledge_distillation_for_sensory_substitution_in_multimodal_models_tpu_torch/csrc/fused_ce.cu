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
//   K6  the shared `dh_kernel` (one block of 8 warps per (32 rows, vocab
//       split), the [32, 896] f32 dh accumulator spread over the warps by
//       columns, h and one 64-row head tile in ~179 KB of dynamic shared
//       memory, dlogits = g_lse * p + g_gold * onehot rounded to bf16 as
//       the JAX kernel rounds them, the splits summed in a fixed order by
//       `reduce_dh`) and `dw_kernel` (8 warps per 32 head rows, all N rows
//       in chunks of 64).
//
// The tiling, the helpers and the K6 kernels are shared with the other
// vocab-streaming losses (csrc/kdss_vocab.cuh); K6 supplies its d_logits
// (`CERows`).
//
// What bounds it on the H100: at N = 3072, DM = 896, V = 151936 each of the
// three sweeps is 0.84 TFLOP of logits (the backward sweeps another 0.84
// each for dh and dW), so they are tensor-core bound on paper; this first
// version feeds mma.sync from synchronous shared-memory loads (no cp.async
// ring, no wgmma), and re-reads h (5.5 MB, L2-resident) once per head tile.

#include "kdss_vocab.cuh"

// A named namespace: the shared kernels are instantiated with this file's
// Rows policy, and nvcc's host stubs cannot name a type of an unnamed one.
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

// ---- K6: backward -------------------------------------------------------

// d_logits = g_lse * p + g_gold * onehot(label) from lse and the cotangents.
struct CERows {
  static constexpr int NSTAT = 4;  // lse (log2 domain), g_lse, g_gold, (int) label
  const float *lse, *g_lse, *g_gold;
  const int* labels;

  __device__ void stage(float* f, int rows, int n0, int N) const {
    int* lab = reinterpret_cast<int*>(f + 3 * rows);
    for (int i = threadIdx.x; i < rows; i += B_THREADS) {
      const int n = n0 + i;
      const bool in = n < N;
      f[i] = in ? lse[n] * LOG2E : INFINITY;  // padding rows: p = 0
      f[rows + i] = in ? g_lse[n] : 0.f;
      f[2 * rows + i] = in ? g_gold[n] : 0.f;
      lab[i] = in ? labels[n] : -1;
    }
  }

  __device__ float dlogit(const float* f, int rows, int r, long, int col, int V, float x) const {
    if (col >= V) return 0.f;
    const float p = exp2f(x * LOG2E - f[r]);
    return f[rows + r] * p + (col == reinterpret_cast<const int*>(f + 3 * rows)[r] ? f[2 * rows + r] : 0.f);
  }
};

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

using namespace kdss_ce;

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
  if (DM != 896) return static_cast<int>(cudaErrorInvalidValue);
  const CERows rows{static_cast<const float*>(lse), static_cast<const float*>(g_lse),
                    static_cast<const float*>(g_gold), static_cast<const int*>(labels)};
  return static_cast<int>(launch_bwd<896>(static_cast<const bf*>(h), static_cast<const bf*>(w), rows,
                                          static_cast<float*>(dh_part), static_cast<bf*>(dh),
                                          static_cast<bf*>(dw), N, V, nsplit,
                                          static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
