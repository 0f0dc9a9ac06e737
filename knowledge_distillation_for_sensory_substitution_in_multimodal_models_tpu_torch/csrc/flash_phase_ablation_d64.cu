// K13's arms at head dim 64 (the 0.5B student's Qwen2); see
// flash_phase_ablation.cuh.
#include "flash_phase_ablation.cuh"

namespace kdss_k13 {

cudaError_t ablate_d64(int arm, const void* q, const void* k, const void* v, void* out,
                       const float* shift, int B, int S, int Hq, int Hkv, float scale_log2,
                       cudaStream_t st) {
  return ablate<64>(arm, q, k, v, out, shift, B, S, Hq, Hkv, scale_log2, st);
}

}  // namespace kdss_k13
