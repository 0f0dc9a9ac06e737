// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from the saved
// row logsumexp, bf16 in and out, f32 accumulation.
//
// Replaces two Pallas TPU kernel families of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/
// ops/flash_attention.py):
//   * K2, `_flash_vjp_bwd` (kernels `_dq_kernel`, `_dkv_kernel`): the MHA
//     backward of every SigLIP layer (d = 72, non-causal);
//   * K4, `_flash_gqa_vjp_bwd` (kernels `_gqa_dq_kernel`, `_gqa_dkv_kernel`):
//     the GQA backward of every Qwen2 layer (d = 64, 14 q / 2 kv heads,
//     causal, kv-padding mask).
// Both compute one function at group size G = Hq / Hkv.  The C entry below
// routes D = 72 (K2) to this file's templated pair of mma.sync kernels and
// D = 64 (K4) to the wgmma/TMA kernels of flash_bwd_sm90.cu.
//
// Inputs: q/dout [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] bf16 contiguous,
// kv_mask uint8 [B, Skv] or null, lse and delta f32 [B, Hq, Sq].  lse is
// the forward's natural-log row logsumexp; delta = rowsum(dout * out) is
// computed outside (as the JAX backward does), and rows with no valid key
// arrive neutralized (lse = +huge, delta = 0), so their P and dS are exactly
// 0 with no row guard here.  Causality is top-left aligned (query i attends
// key j iff i >= j), as in the forward.
//
// Math (s = scale):  P = exp(s Q K^T - lse),  dV = P^T dO,  dP = dO V^T,
//                    dS = s * P * (dP - delta),  dQ = dS K,  dK = dS^T Q.
// As in the JAX kernels, P is rounded to bf16 before P^T dO and dS before
// dS K and dS^T Q (`_dq_kernel` :478, `_dkv_kernel` :529).
//
// Design (first, simple version), two kernels like the JAX pair:
//   * dq: one block of 4 warps per (64-row q tile, q head, batch), walking
//     the 64-row K/V tiles (only up to the diagonal under causality); each
//     warp owns 16 q rows and keeps its Q and dO fragments in registers.
//   * dk/dv: one block per (64-row kv tile, kv head, batch) that loops over
//     the G query heads of its kv head and over their q tiles (from the
//     diagonal on under causality); each warp owns 16 kv rows and computes
//     S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T are already
//     the A operands of dV and dK.  Summing the G heads inside the block
//     gives GQA's dk/dv with no atomics, deterministically, as
//     `_gqa_dkv_kernel` does.
// All products are mma.sync m16n8k16 (bf16 x bf16 -> f32).  D = 72 is
// zero-filled to 80 columns in shared memory.  The dK/dV accumulators of a
// 64-row kv tile at D = 80 are 2 x 64 x 80 f32 per block, 80 registers per
// thread, held in registers; K and V fragments are re-read from shared
// memory instead of being held, to leave room for them.  Four 64 x 88 bf16
// tiles use 45 KB of static shared memory.
//
// What bounds it on the H100: the backward does 2.5x the forward's matrix
// work (five products against two), so like the forward it is bound by
// tensor-core issue from synchronous loads; wgmma with a TMA ring, as
// flash_bwd_sm90.cu does at D = 64, is the next step for D = 72.

#include "kdss_mma.cuh"

namespace {

using namespace kdss;

constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // kv rows per tile
constexpr int NTHREADS = 128;

template <int D, bool CAUSAL, bool MASK>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
                        int Skv, int Hq, int Hkv, int group, float scale, float scale_log2) {
  using Dm = FlashDims<D>;
  __shared__ __align__(16) __nv_bfloat16 Qs[BM * Dm::LD];
  __shared__ __align__(16) __nv_bfloat16 dOs[BM * Dm::LD];
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * Dm::LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BN * Dm::LD];
  __shared__ uint8_t Ms[BN];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;

  const long qstride = (long)Hq * D, kstride = (long)Hkv * D;
  const long qoff = ((long)b * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long)b * Skv * Hkv + hk) * D;

  load_tile<D, BM, NTHREADS>(Qs, q + qoff, q0, Sq, qstride);
  load_tile<D, BM, NTHREADS>(dOs, dout + qoff, q0, Sq, qstride);
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qf[Dm::KC][4], df[Dm::KC][4];
#pragma unroll
  for (int kc = 0; kc < Dm::KC; ++kc) {
    load_a(qf[kc], Qs, Dm::LD, r0, kc * 16, gi, ti);
    load_a(df[kc], dOs, Dm::LD, r0, kc * 16, gi, ti);
  }

  const int row_a = q0 + r0 + gi, row_b = row_a + 8;
  float l2[2], dl[2];  // lse in the log2 domain, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    const long idx = ((long)b * Hq + h) * Sq + row;
    l2[i] = row < Sq ? lse[idx] * LOG2E : INFINITY;  // padding rows: P = 0
    dl[i] = row < Sq ? delta[idx] : 0.f;
  }

  float acc[Dm::NT][4];
#pragma unroll
  for (int nt = 0; nt < Dm::NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  int n_tiles = (Skv + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();
    load_tile<D, BN, NTHREADS>(Ks, kb, k0, Skv, kstride);
    load_tile<D, BN, NTHREADS>(Vs, vb, k0, Skv, kstride);
    if (MASK) {
      for (int i = threadIdx.x; i < BN; i += NTHREADS)
        Ms[i] = (k0 + i < Skv) ? kv_mask[(long)b * Skv + k0 + i] : 0;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys.
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < Dm::KC; ++kc) {
        uint32_t bk[2], bv[2];
        load_b_rows(bk, Ks, Dm::LD, nt * 8, kc * 16, gi, ti);
        load_b_rows(bv, Vs, Dm::LD, nt * 8, kc * 16, gi, ti);
        mma16816(s[nt], qf[kc], bk);
        mma16816(dp[nt], df[kc], bv);
      }
    }

    // P from the saved lse, then dS (kept in s).
    const bool edge = (k0 + BN > Skv) || MASK || (CAUSAL && k0 + BN - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        bool ok = true;
        if (edge) {
          const int c = nt * 8 + ti * 2 + (e & 1);
          const int col = k0 + c;
          ok = col < Skv;
          if (MASK) ok = ok && Ms[c] != 0;
          if (CAUSAL) ok = ok && col <= (r == 0 ? row_a : row_b);
        }
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - l2[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[r]) * scale;
      }
    }

    // dQ += dS K.
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * c][0], s[2 * c][1]), pack_bf16(s[2 * c][2], s[2 * c][3]),
          pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]), pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int nt = 0; nt < Dm::NT; ++nt) {
        uint32_t bk[2];
        load_b_cols(bk, Ks, Dm::LD, c * 16, nt * 8, gi, ti);
        mma16816(acc[nt], pa, bk);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < Dm::NT; ++nt) {
    const int col = nt * 8 + ti * 2;
    if (col >= D) continue;
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(dq + qoff + (long)row_a * qstride + col) =
          pack_bf16(acc[nt][0], acc[nt][1]);
    if (row_b < Sq)
      *reinterpret_cast<uint32_t*>(dq + qoff + (long)row_b * qstride + col) =
          pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

template <int D, bool CAUSAL, bool MASK>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
                         int group, float scale, float scale_log2) {
  using Dm = FlashDims<D>;
  __shared__ __align__(16) __nv_bfloat16 Ks[BN * Dm::LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BN * Dm::LD];
  __shared__ __align__(16) __nv_bfloat16 Qs[BM * Dm::LD];
  __shared__ __align__(16) __nv_bfloat16 dOs[BM * Dm::LD];
  __shared__ float Ls[BM], Ds[BM];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int k0 = blockIdx.x * BN;
  const int hk = blockIdx.y, b = blockIdx.z;

  const long qstride = (long)Hq * D, kstride = (long)Hkv * D;
  const long koff = ((long)b * Skv * Hkv + hk) * D;
  load_tile<D, BN, NTHREADS>(Ks, k + koff, k0, Skv, kstride);
  load_tile<D, BN, NTHREADS>(Vs, v + koff, k0, Skv, kstride);

  // This thread's two kv rows: in range and not masked out.
  const int r0 = warp * 16;
  const int kpos[2] = {k0 + r0 + gi, k0 + r0 + gi + 8};
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kok[i] = kpos[i] < Skv;
    if (MASK && kok[i]) kok[i] = kv_mask[(long)b * Skv + kpos[i]] != 0;
  }

  float dka[Dm::NT][4], dva[Dm::NT][4];
#pragma unroll
  for (int nt = 0; nt < Dm::NT; ++nt) {
    dka[nt][0] = dka[nt][1] = dka[nt][2] = dka[nt][3] = 0.f;
    dva[nt][0] = dva[nt][1] = dva[nt][2] = dva[nt][3] = 0.f;
  }

  const int n_q = (Sq + BM - 1) / BM;
  const int j0 = CAUSAL ? k0 / BM : 0;  // q tiles wholly above the diagonal see no key here
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long qoff = ((long)b * Sq * Hq + h) * D;
    const long loff = ((long)b * Hq + h) * Sq;
    for (int jq = j0; jq < n_q; ++jq) {
      const int q0 = jq * BM;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D, BM, NTHREADS>(Qs, q + qoff, q0, Sq, qstride);
      load_tile<D, BM, NTHREADS>(dOs, dout + qoff, q0, Sq, qstride);
      for (int i = threadIdx.x; i < BM; i += NTHREADS) {
        const int row = q0 + i;
        Ls[i] = row < Sq ? lse[loff + row] * LOG2E : INFINITY;  // padding rows: P = 0
        Ds[i] = row < Sq ? delta[loff + row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows x 64 q.
      float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < Dm::KC; ++kc) {
        uint32_t ka[4], va[4];
        load_a(ka, Ks, Dm::LD, r0, kc * 16, gi, ti);
        load_a(va, Vs, Dm::LD, r0, kc * 16, gi, ti);
#pragma unroll
        for (int nt = 0; nt < BM / 8; ++nt) {
          uint32_t bq[2], bd[2];
          load_b_rows(bq, Qs, Dm::LD, nt * 8, kc * 16, gi, ti);
          load_b_rows(bd, dOs, Dm::LD, nt * 8, kc * 16, gi, ti);
          mma16816(s[nt], ka, bq);
          mma16816(dp[nt], va, bd);
        }
      }

      // P^T (kept in s) and dS^T (kept in dp).
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int c = nt * 8 + ti * 2 + (e & 1);
          bool ok = kok[r];
          if (CAUSAL) ok = ok && q0 + c >= kpos[r];
          const float p = ok ? exp2f(s[nt][e] * scale_log2 - Ls[c]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - Ds[c]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q (contraction over the 64 q rows).
#pragma unroll
      for (int c = 0; c < BM / 16; ++c) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * c][0], s[2 * c][1]), pack_bf16(s[2 * c][2], s[2 * c][3]),
            pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]), pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
        const uint32_t sa[4] = {
            pack_bf16(dp[2 * c][0], dp[2 * c][1]), pack_bf16(dp[2 * c][2], dp[2 * c][3]),
            pack_bf16(dp[2 * c + 1][0], dp[2 * c + 1][1]),
            pack_bf16(dp[2 * c + 1][2], dp[2 * c + 1][3])};
#pragma unroll
        for (int nt = 0; nt < Dm::NT; ++nt) {
          uint32_t bd[2], bq[2];
          load_b_cols(bd, dOs, Dm::LD, c * 16, nt * 8, gi, ti);
          load_b_cols(bq, Qs, Dm::LD, c * 16, nt * 8, gi, ti);
          mma16816(dva[nt], pa, bd);
          mma16816(dka[nt], sa, bq);
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < Dm::NT; ++nt) {
    const int col = nt * 8 + ti * 2;
    if (col >= D) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kpos[i] >= Skv) continue;
      const long o = koff + (long)kpos[i] * kstride + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[nt][2 * i], dka[nt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[nt][2 * i], dva[nt][2 * i + 1]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *kv_mask, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Skv, Hq, Hkv;
  float scale;
};

template <int D, bool CAUSAL, bool MASK>
cudaError_t launch(const BwdArgs& a, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const float sl2 = a.scale * LOG2E;
  const int group = a.Hq / a.Hkv;
  const dim3 gq((a.Sq + BM - 1) / BM, a.Hq, a.B);
  flash_bwd_dq_kernel<D, CAUSAL, MASK><<<gq, NTHREADS, 0, st>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      static_cast<const uint8_t*>(a.kv_mask), static_cast<const bf*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), static_cast<bf*>(a.dq),
      a.Sq, a.Skv, a.Hq, a.Hkv, group, a.scale, sl2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gk((a.Skv + BN - 1) / BN, a.Hkv, a.B);
  flash_bwd_dkv_kernel<D, CAUSAL, MASK><<<gk, NTHREADS, 0, st>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      static_cast<const uint8_t*>(a.kv_mask), static_cast<const bf*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), static_cast<bf*>(a.dk),
      static_cast<bf*>(a.dv), a.Sq, a.Skv, a.Hq, a.Hkv, group, a.scale, sl2);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const BwdArgs& a, int causal, cudaStream_t st) {
  if (causal) return a.kv_mask ? launch<D, true, true>(a, st) : launch<D, true, false>(a, st);
  return a.kv_mask ? launch<D, false, true>(a, st) : launch<D, false, false>(a, st);
}

}  // namespace

cudaError_t kdss_flash_bwd_d64(const void* q, const void* k, const void* v, const void* kv_mask,
                               const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                               void* dv, void* part, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                               float scale, cudaStream_t st);

extern "C" {

// dq [B, Sq, Hq, D], dk/dv [B, Skv, Hkv, D] bf16 are written in full (rows
// of masked keys get zeros).  `part` is D = 64's f32 workspace [2, Hq / Hkv,
// B, Skv, Hkv, 64] (unused at D = 72).  Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for shapes the kernels do not take, else the first
// failing launch's cudaGetLastError().
int kdss_flash_bwd(const void* q, const void* k, const void* v, const void* kv_mask,
                   const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                   void* dv, void* part, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                   float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, kv_mask, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(kdss_flash_bwd_d64(q, k, v, kv_mask, dout, lse, delta, dq, dk, dv, part, B, Sq,
                                                 Skv, Hq, Hkv, causal, scale, st));
    case 72:
      return static_cast<int>(dispatch<72>(a, causal, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
