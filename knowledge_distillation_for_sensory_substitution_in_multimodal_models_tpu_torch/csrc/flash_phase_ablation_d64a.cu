// K13's arms 0-7 at head dim 64; see flash_phase_ablation.cuh.
#include "flash_phase_ablation.cuh"

namespace kdss_k13 {

cudaError_t ablate_d64a(int arm, const void* q, const void* k, const void* v, void* out, int* next_tile,
                        const float* shift, int B, int S, int Hq, int Hkv, float scale_log2, cudaStream_t st) {
  return ablate<64, 0, 8>(arm, q, k, v, out, next_tile, shift, B, S, Hq, Hkv, scale_log2, st);
}

}  // namespace kdss_k13
