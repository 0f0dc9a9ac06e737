// Flash-attention forward for Hopper (sm_90a), bf16 in and out, f32 softmax:
// the C entry of the port's flash forward kernels.
//
// Replaces two Pallas TPU kernel families of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/
// ops/flash_attention.py):
//   * K1, `flash_attention` -> `_flash` -> `_flash_fwd_impl`: non-causal MHA
//     in every SigLIP layer (d = 72);
//   * K3, `flash_attention_gqa` -> `_flash_gqa` -> `_flash_gqa_fwd_impl`:
//     causal GQA with a kv-padding mask at the Qwen2 prefill: the 0.5B
//     student (14 q / 2 kv heads, D = 64) and the frozen 7B teacher of the
//     KD step (28 q / 4 kv heads, D = 128, forward only, no lse).
// Both compute one function -- attention with an optional kv mask and
// optional causality, at group size G = Hq / Hkv -- and every head dim runs
// a persistent wgmma kernel fed by TMA under mbarriers: D = 72 (K1)
// flash_fwd_sm90.cu's, in d = 72's two-box layout; D = 64 and 128 (K3)
// flash_gqa_sm90.cuh's (instantiated in flash_fwd_gqa_d64.cu and
// flash_fwd_gqa_d128.cu), whose template parameter ARM is K13.  Each file
// states what bounds its kernel and what its design does about it.  The
// TPU-only variants (scalar-shift "bound" mode and its NaN poison, D padded
// to 128 lanes, packed head pairs) are not carried over.
//
// Layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D], out like q, all contiguous
// bf16; kv_mask uint8 [B, Skv] or null.  Causality is top-left aligned:
// query row i attends key j iff i >= j.  A row with no valid key outputs 0.
// lse, f32 [B, Hq, Sq] or null: the natural-log logsumexp of each row's
// scaled scores, which the backward (flash_bwd.cu) recomputes P from; -inf
// for a row with no valid key.  Serving passes null, as the JAX forward's
// with_lse=False drops it.

#include <cuda_runtime.h>
#include <stdint.h>

cudaError_t kdss_flash_fwd_d72(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                               float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale_log2,
                               cudaStream_t st);
cudaError_t kdss_flash_fwd_gqa_d64(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                                   float* lse, int* next_tile, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                                   float scale_log2, cudaStream_t st);
cudaError_t kdss_flash_fwd_gqa_d128(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                                    float* lse, int* next_tile, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                                    float scale_log2, cudaStream_t st);

extern "C" {

// next_tile: one int of device memory, the D = 64 / 128 kernels' tile
// counter (unread at D = 72).  Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for shapes the kernels do not take, else the
// launch's cudaGetLastError().
int kdss_flash_fwd(const void* q, const void* k, const void* v, const void* kv_mask, void* out, void* lse,
                   void* next_tile, int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal, float scale,
                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  int* nt = static_cast<int*>(next_tile);
  switch (D) {
    case 64:
      if (nt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(kdss_flash_fwd_gqa_d64(q, k, v, kv_mask, out, l, nt, B, Sq, Skv, Hq, Hkv, causal,
                                                     scale_log2, st));
    case 72:
      return static_cast<int>(kdss_flash_fwd_d72(q, k, v, kv_mask, out, l, B, Sq, Skv, Hq, Hkv, causal, scale_log2,
                                                 st));
    case 128:
      if (nt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(kdss_flash_fwd_gqa_d128(q, k, v, kv_mask, out, l, nt, B, Sq, Skv, Hq, Hkv, causal,
                                                      scale_log2, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* kdss_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
