// K13's arms at head dim 128 (the 7B's Qwen2), and the C entry point of both
// head dims; see flash_phase_ablation.cuh.
#include "flash_phase_ablation.cuh"

namespace kdss_k13 {

cudaError_t ablate_d128(int arm, const void* q, const void* k, const void* v, void* out,
                        const float* shift, int B, int S, int Hq, int Hkv, float scale_log2,
                        cudaStream_t st) {
  return ablate<128>(arm, q, k, v, out, shift, B, S, Hq, Hkv, scale_log2, st);
}

}  // namespace kdss_k13

extern "C" {

// q, k, v, out bf16 [B, S, H, D] contiguous (k, v with Hkv heads); shift: one
// f32 in device memory (ARM_STREAMING_SMEM's c, in nats), else unread.
// Returns a cudaError_t: cudaErrorInvalidValue for an arm, a head dim or a
// shape the kernel does not take, else the launch's cudaGetLastError().
int kdss_flash_phase_ablation(const void* q, const void* k, const void* v, void* out,
                              const void* shift, int B, int S, int Hq, int Hkv, int D, int arm,
                              float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 || arm < 0 ||
      arm >= ARM_N_ARMS || (arm == ARM_STREAMING_SMEM && shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;  // as kdss_flash_fwd computes it
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(shift);
  switch (D) {
    case 64:
      return static_cast<int>(kdss_k13::ablate_d64(arm, q, k, v, out, c, B, S, Hq, Hkv, scale_log2, st));
    case 128:
      return static_cast<int>(kdss_k13::ablate_d128(arm, q, k, v, out, c, B, S, Hq, Hkv, scale_log2, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
