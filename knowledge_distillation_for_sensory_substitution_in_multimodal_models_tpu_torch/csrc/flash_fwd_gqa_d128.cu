// K3 at head dim 128, the 7B teacher's Qwen2 (28 q / 4 kv heads): the four causal / kv-mask
// instantiations of flash_gqa_sm90.cuh's kernel at ARM_FULL, called by
// flash_fwd.cu's C entry.  One source a head dim, so that the build's one
// nvcc a source compiles them in parallel.
#include "flash_gqa_sm90.cuh"

cudaError_t kdss_flash_fwd_gqa_d128(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                                   float* lse, int* next_tile, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
                                   float scale_log2, cudaStream_t st) {
  using kdss_gqa90::ARM_FULL;
  using kdss_gqa90_host::launch;
  if (causal)
    return kv_mask ? launch<128, true, true, ARM_FULL>(q, k, v, kv_mask, out, lse, next_tile, B, Sq, Skv, Hq, Hkv,
                                                      scale_log2, nullptr, st)
                   : launch<128, true, false, ARM_FULL>(q, k, v, kv_mask, out, lse, next_tile, B, Sq, Skv, Hq, Hkv,
                                                       scale_log2, nullptr, st);
  return kv_mask ? launch<128, false, true, ARM_FULL>(q, k, v, kv_mask, out, lse, next_tile, B, Sq, Skv, Hq, Hkv,
                                                     scale_log2, nullptr, st)
                 : launch<128, false, false, ARM_FULL>(q, k, v, kv_mask, out, lse, next_tile, B, Sq, Skv, Hq, Hkv,
                                                      scale_log2, nullptr, st);
}
