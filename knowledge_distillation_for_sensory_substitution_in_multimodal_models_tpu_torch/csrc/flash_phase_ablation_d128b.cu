// K13's arms 8-15 at head dim 128; see flash_phase_ablation.cuh.
#include "flash_phase_ablation.cuh"

namespace kdss_k13 {

cudaError_t ablate_d128b(int arm, const void* q, const void* k, const void* v, void* out, int* next_tile,
                         const float* shift, int B, int S, int Hq, int Hkv, float scale_log2, cudaStream_t st) {
  return ablate<128, 8, 8>(arm, q, k, v, out, next_tile, shift, B, S, Hq, Hkv, scale_log2, st);
}

}  // namespace kdss_k13
