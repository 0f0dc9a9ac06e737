// Flash-attention forward for Hopper (sm_90a), bf16 in and out, f32 softmax.
//
// Replaces two Pallas TPU kernel families of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/
// ops/flash_attention.py):
//   * K1, `flash_attention` -> `_flash` -> `_flash_fwd_impl` (kernels
//     `_fwd_kernel`, `_fwd_kernel_stream` + `_rowmax_kernel`,
//     `_fwd_kernel_sbound`): non-causal MHA in every SigLIP layer;
//   * K3, `flash_attention_gqa` -> `_flash_gqa` -> `_flash_gqa_fwd_impl`
//     (kernels `_gqa_fwd_kernel`, `_gqa_fwd_kernel_stream` +
//     `_gqa_rowmax_kernel`, `_gqa_fwd_kernel_sbound`, `_gqa_fwd_kernel_ilp`):
//     causal GQA with a kv-padding mask at the Qwen2 prefill: the 0.5B
//     student (14 q / 2 kv heads, D = 64) and the frozen 7B teacher of the
//     KD step (28 q / 4 kv heads, D = 128, forward only, no lse).
// Both compute one function -- attention with an optional kv mask and
// optional causality, at group size G = Hq / Hkv -- so they share this one
// templated kernel.  The TPU-only variants (scalar-shift "bound" mode and its
// NaN poison, D padded to 128 lanes, packed head pairs) are not carried over.
//
// Layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D], out like q, all contiguous
// bf16; kv_mask uint8 [B, Skv] or null.  Causality is top-left aligned:
// query row i attends key j iff i >= j.  A row with no valid key outputs 0.
// lse, f32 [B, Hq, Sq] or null: the natural-log logsumexp of each row's
// scaled scores, which the backward (flash_bwd.cu) recomputes P from; -inf
// for a row with no valid key.  Serving passes null, as the JAX forward's
// with_lse=False drops it.
//
// Design (first, simple version).  One block of 4 warps per
// (64-row q tile, q head, batch).  The q tile is staged through shared
// memory into registers once; the block then walks 64-row K/V tiles through
// shared memory.  Each warp owns 16 q rows: S = Q K^T and O += P V run on
// mma.sync m16n8k16 (bf16 x bf16 -> f32), and the softmax is an exact online
// softmax in f32 (log2 domain, scale folded into exp2).  Under causality the
// K/V tiles wholly above the diagonal are skipped.  D = 72 is not a multiple
// of the mma depth 16: tiles are zero-filled to 80 columns in shared memory,
// and shared rows are padded by 8 more elements so fragment loads hit 32
// distinct banks.  K/V are read by kv head h / G and never repeated.  The
// Q, K and V tiles live in dynamic shared memory: at D = 128 they take
// 3 x 64 x 136 x 2 B = 52 KB, past the 48 KB a block may hold statically;
// the o[16][4] accumulator and the q fragments qf[8][4] double from D = 64
// (the build log's ptxas lines show the registers and any spill).
//
// What bounds it on the H100.  The SigLIP case (S = 729, D = 72, 16 heads x
// 10 tiles) is small per (tile, head): 12 q tiles x 12 kv tiles, 153 MFLOP,
// 24.5 GFLOP per layer against 50 MB of q/k/v -- compute-bound on paper, but
// each block runs only 12 short kv steps, so the q-tile prologue, the
// epilogue and the zero-filled columns (80 computed for 72) weigh on it.  The
// prefill (Sq = 3072, Skv = 3104, 14 q / 2 kv heads, D = 64) is ~17 GFLOP of
// causal work per layer and is bound by tensor-core issue; this version
// feeds the tensor cores with synchronous loads and mma.sync, so it reaches
// a fraction of the wgmma peak.  The teacher's prefill (Sq = Skv = 3072,
// 28 q / 4 kv heads, D = 128) is ~68 GFLOP of causal work per layer, bound
// the same way.  wgmma, TMA, a multi-stage K/V ring and warp specialisation
// are the later steps.

#include "kdss_mma.cuh"

namespace {

using namespace kdss;

constexpr int BM = 64;  // q rows per block (16 per warp)
constexpr int BN = 64;  // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <int D>
constexpr int smem_bytes() {
  return (BM + 2 * BN) * FlashDims<D>::LD * 2 + BN;  // Q, K, V tiles and the kv mask
}

template <int D, bool CAUSAL, bool MASK>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq, int Skv,
                     int Hq, int Hkv, int group, float scale_log2) {
  using Dm = FlashDims<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BM * Dm::LD;
  __nv_bfloat16* Vs = Ks + BN * Dm::LD;
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + BN * Dm::LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;  // mma group id / thread in group
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;

  const long qstride = (long)Hq * D, kstride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long)b * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long)b * Skv * Hkv + hk) * D;

  load_tile<D, BM, NTHREADS>(Qs, qb, q0, Sq, qstride);
  __syncthreads();

  const int r0 = warp * 16 + gi;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[Dm::KC][4];
#pragma unroll
  for (int kc = 0; kc < Dm::KC; ++kc) load_a(qf[kc], Qs, Dm::LD, warp * 16, kc * 16, gi, ti);

  float o[Dm::NT][4];
#pragma unroll
  for (int nt = 0; nt < Dm::NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums; quad-reduced at the end
  const int row_a = q0 + r0, row_b = row_a + 8;

  int n_tiles = (Skv + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, BN, NTHREADS>(Ks, kb, k0, Skv, kstride);
    load_tile<D, BN, NTHREADS>(Vs, vb, k0, Skv, kstride);
    if (MASK) {
      for (int i = threadIdx.x; i < BN; i += NTHREADS)
        Ms[i] = (k0 + i < Skv) ? kv_mask[(long)b * Skv + k0 + i] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < Dm::KC; ++kc) {
        uint32_t bk[2];
        load_b_rows(bk, Ks, Dm::LD, nt * 8, kc * 16, gi, ti);
        mma16816(s[nt], qf[kc], bk);
      }
    }

    // Scale into the log2 domain and mask.
    const bool edge = (k0 + BN > Skv) || MASK || (CAUSAL && k0 + BN - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int c = nt * 8 + ti * 2 + (e & 1);
          const int col = k0 + c;
          bool ok = col < Skv;
          if (MASK) ok = ok && Ms[c] != 0;
          if (CAUSAL) ok = ok && col <= ((e < 2) ? row_a : row_b);
          if (!ok) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }

    // Online softmax: new running max per row (reduced over the quad).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      // A row with no valid key yet keeps m = -inf; shift by 0 so that
      // exp2(-inf - 0) = 0 and nothing turns into NaN.
      base[i] = (mx[i] == -INFINITY) ? 0.f : mx[i];
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - base[0]);
      s[nt][1] = exp2f(s[nt][1] - base[0]);
      s[nt][2] = exp2f(s[nt][2] - base[1]);
      s[nt][3] = exp2f(s[nt][3] - base[1]);
      l[0] += s[nt][0] + s[nt][1];
      l[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int nt = 0; nt < Dm::NT; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P V.  The S accumulators of n-tiles 2c and 2c + 1 are exactly the
    // A fragment of k-chunk c; V's B fragment pairs two keys per register.
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * c][0], s[2 * c][1]), pack_bf16(s[2 * c][2], s[2 * c][3]),
          pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]), pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int nt = 0; nt < Dm::NT; ++nt) {
        uint32_t bv[2];
        load_b_cols(bv, Vs, Dm::LD, c * 16, nt * 8, gi, ti);
        mma16816(o[nt], pa, bv);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    inv[i] = lt > 0.f ? 1.f / lt : 0.f;  // no valid key -> zeros
    const int row = i == 0 ? row_a : row_b;
    if (lse != nullptr && ti == 0 && row < Sq)
      lse[((long)b * Hq + h) * Sq + row] = lt > 0.f ? (m[i] + log2f(lt)) * LN2 : -INFINITY;
  }
#pragma unroll
  for (int nt = 0; nt < Dm::NT; ++nt) {
    const int col = nt * 8 + ti * 2;
    if (col >= D) continue;
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(out + ((long)b * Sq + row_a) * qstride + (long)h * D + col) =
          pack_bf16(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    if (row_b < Sq)
      *reinterpret_cast<uint32_t*>(out + ((long)b * Sq + row_b) * qstride + (long)h * D + col) =
          pack_bf16(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
}

template <int D, bool CAUSAL, bool MASK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                   float* lse, int B, int Sq, int Skv, int Hq, int Hkv, float scale_log2,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, CAUSAL, MASK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, Hq, B);
  flash_fwd_kernel<D, CAUSAL, MASK><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, Hq, Hkv, Hq / Hkv, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                     float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale_log2,
                     cudaStream_t st) {
  if (causal) {
    if (kv_mask) return launch<D, true, true>(q, k, v, kv_mask, out, lse, B, Sq, Skv, Hq, Hkv, scale_log2, st);
    return launch<D, true, false>(q, k, v, kv_mask, out, lse, B, Sq, Skv, Hq, Hkv, scale_log2, st);
  }
  if (kv_mask) return launch<D, false, true>(q, k, v, kv_mask, out, lse, B, Sq, Skv, Hq, Hkv, scale_log2, st);
  return launch<D, false, false>(q, k, v, kv_mask, out, lse, B, Sq, Skv, Hq, Hkv, scale_log2, st);
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on success, cudaErrorInvalidValue for shapes the
// kernel does not take, else the launch's cudaGetLastError().
int kdss_flash_fwd(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                   void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal, float scale,
                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(dispatch<64>(q, k, v, kv_mask, out, static_cast<float*>(lse), B, Sq, Skv, Hq, Hkv, causal, scale_log2, st));
    case 72:
      return static_cast<int>(dispatch<72>(q, k, v, kv_mask, out, static_cast<float*>(lse), B, Sq, Skv, Hq, Hkv, causal, scale_log2, st));
    case 128:
      return static_cast<int>(dispatch<128>(q, k, v, kv_mask, out, static_cast<float*>(lse), B, Sq, Skv, Hq, Hkv, causal, scale_log2, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kdss_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
