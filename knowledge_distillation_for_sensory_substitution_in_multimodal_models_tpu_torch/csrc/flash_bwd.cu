// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from the saved
// row logsumexp, bf16 in and out, f32 accumulation.  This file is the C
// entry; the kernels live in two sources, one per head dim.
//
// Replaces two Pallas TPU kernel families of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/
// ops/flash_attention.py):
//   * K2, `_flash_vjp_bwd` (kernels `_dq_kernel`, `_dkv_kernel`): the MHA
//     backward of every SigLIP layer (d = 72, non-causal), in
//     flash_bwd_d72_sm90.cu;
//   * K4, `_flash_gqa_vjp_bwd` (kernels `_gqa_dq_kernel`, `_gqa_dkv_kernel`):
//     the GQA backward of every Qwen2 layer (d = 64, 14 q / 2 kv heads,
//     causal, kv-padding mask), in flash_bwd_sm90.cu.
// Both compute one function at group size G = Hq / Hkv, on wgmma fed by TMA.
//
// Inputs: q/dout [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] bf16 contiguous,
// kv_mask uint8 [B, Skv] or null, lse and delta f32 [B, Hq, Sq].  lse is
// the forward's natural-log row logsumexp; delta = rowsum(dout * out) is
// computed outside (as the JAX backward does), and rows with no valid key
// arrive neutralized (lse = +huge, delta = 0), so their P and dS are exactly
// 0 with no row guard.  Causality is top-left aligned (query i attends key
// j iff i >= j), as in the forward.
//
// Math (s = scale):  P = exp(s Q K^T - lse),  dV = P^T dO,  dP = dO V^T,
//                    dS = s * P * (dP - delta),  dQ = dS K,  dK = dS^T Q.
// As in the JAX kernels, P is rounded to bf16 before P^T dO and dS before
// dS K and dS^T Q (`_dq_kernel` :478, `_dkv_kernel` :529).

#include <cuda_runtime.h>

cudaError_t kdss_flash_bwd_d64(const void* q, const void* k, const void* v, const void* kv_mask,
                               const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                               void* dv, void* part, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                               float scale, cudaStream_t st);
cudaError_t kdss_flash_bwd_d72(const void* q, const void* k, const void* v, const void* kv_mask,
                               const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                               void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
                               cudaStream_t st);

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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(kdss_flash_bwd_d64(q, k, v, kv_mask, dout, lse, delta, dq, dk, dv, part, B, Sq,
                                                 Skv, Hq, Hkv, causal, scale, st));
    case 72:
      return static_cast<int>(kdss_flash_bwd_d72(q, k, v, kv_mask, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq,
                                                 Hkv, causal, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
