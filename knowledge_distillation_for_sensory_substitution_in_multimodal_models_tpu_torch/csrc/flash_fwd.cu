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
// optional causality, at group size G = Hq / Hkv.  The C entry below routes
// each head dim to one kernel: D = 72 (K1) to the wgmma/TMA kernel of
// flash_fwd_sm90.cu, D = 64 and 128 (K3) to this file's templated mma.sync
// kernel (flash_fwd.cuh, shared with K13's arms).  The TPU-only variants
// (scalar-shift "bound" mode and its NaN poison, D padded to 128 lanes,
// packed head pairs) are not carried over.
//
// Layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D], out like q, all contiguous
// bf16; kv_mask uint8 [B, Skv] or null.  Causality is top-left aligned:
// query row i attends key j iff i >= j.  A row with no valid key outputs 0.
// lse, f32 [B, Hq, Sq] or null: the natural-log logsumexp of each row's
// scaled scores, which the backward (flash_bwd.cu) recomputes P from; -inf
// for a row with no valid key.  Serving passes null, as the JAX forward's
// with_lse=False drops it.
//
// Design of the mma.sync kernel (first, simple version).  One block of 4
// warps per (64-row q tile, q head, batch).  The q tile is staged through
// shared memory into registers once; the block then walks 64-row K/V tiles
// through shared memory.  Each warp owns 16 q rows: S = Q K^T and O += P V
// run on mma.sync m16n8k16 (bf16 x bf16 -> f32), and the softmax is an exact
// online softmax in f32 (log2 domain, scale folded into exp2).  Under
// causality the K/V tiles wholly above the diagonal are skipped.  Shared
// rows are padded by 8 elements so fragment loads hit 32 distinct banks.
// K/V are read by kv head h / G and never repeated.  The Q, K and V tiles
// live in dynamic shared memory: at D = 128 they take 3 x 64 x 136 x 2 B =
// 52 KB, past the 48 KB a block may hold statically; the o[16][4]
// accumulator and the q fragments qf[8][4] double from D = 64 (the build
// log's ptxas lines show the registers and any spill).
//
// What bounds it on the H100.  The prefill (Sq = 3072, Skv = 3104, 14 q /
// 2 kv heads, D = 64) is ~17 GFLOP of causal work per layer and is bound by
// tensor-core issue; this version feeds the tensor cores with synchronous
// loads and mma.sync, so it reaches a fraction of the wgmma peak.  The teacher's prefill (Sq = Skv = 3072,
// 28 q / 4 kv heads, D = 128) is ~68 GFLOP of causal work per layer, bound
// the same way.  wgmma, TMA, a multi-stage K/V ring and warp specialisation,
// as flash_fwd_sm90.cu has them at D = 72, are the later steps here.

#include "flash_fwd.cuh"

namespace {

using namespace kdss;

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

cudaError_t kdss_flash_fwd_d72(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                               float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale_log2,
                               cudaStream_t st);

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
      return static_cast<int>(kdss_flash_fwd_d72(q, k, v, kv_mask, out, static_cast<float*>(lse), B, Sq, Skv, Hq, Hkv, causal, scale_log2, st));
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
