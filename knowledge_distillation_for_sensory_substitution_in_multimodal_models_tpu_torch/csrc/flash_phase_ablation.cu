// The C entry point of K13, the phase-ablation arms of the flash forward, at
// both head dims; see flash_phase_ablation.cuh.
#include "flash_phase_ablation.cuh"

extern "C" {

// q, k, v, out bf16 [B, S, H, D] contiguous (k, v with Hkv heads); next_tile
// one int of device memory (the kernel's tile counter); shift: one f32 in
// device memory (ARM_STREAMING_SMEM's c, in nats), else unread.  Returns a
// cudaError_t: cudaErrorInvalidValue for an arm, a head dim or a shape the
// kernel does not take, else the launch's cudaGetLastError().
int kdss_flash_phase_ablation(const void* q, const void* k, const void* v, void* out, void* next_tile,
                              const void* shift, int B, int S, int Hq, int Hkv, int D, int arm, float scale,
                              void* stream) {
  using namespace kdss_gqa90;
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535 || arm < 0 || arm >= ARM_N_ARMS ||
      next_tile == nullptr || (arm == ARM_STREAMING_SMEM && shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;  // as kdss_flash_fwd computes it
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(shift);
  int* nt = static_cast<int*>(next_tile);
  cudaError_t (*ablate)(int, const void*, const void*, const void*, void*, int*, const float*, int, int, int, int,
                        float, cudaStream_t);
  switch (D) {
    case 64:
      ablate = arm < 8 ? kdss_k13::ablate_d64a : kdss_k13::ablate_d64b;
      break;
    case 128:
      ablate = arm < 8 ? kdss_k13::ablate_d128a : kdss_k13::ablate_d128b;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(ablate(arm, q, k, v, out, nt, c, B, S, Hq, Hkv, scale_log2, st));
}

}  // extern "C"
