// K13: the phase-ablation arms of the flash forward (flash_gqa_sm90.cuh,
// `enum Arm`), launched as the JAX script scripts/flash_phase_ablation.py
// builds them: causal, Sq == Skv, no kv mask, no lse.  Replaces the script's
// `pl.pallas_call` of `_streaming_smem_kernel` (:336) and of
// `_variant_kernel` / the shipped `_gqa_fwd_kernel` (:375).  The arms are a
// profiling instrument: no path of the package launches them.  What bounds
// them is what bounds K3: the tensor cores' rate; each arm's time minus
// ARM_FULL's is what one phase costs K3.  The 16 arms x 2 head dims are
// split over four sources (flash_phase_ablation_d64a.cu / _d64b.cu /
// _d128a.cu / _d128b.cu, arms 0-7 and 8-15) so that the build's one nvcc a
// source compiles them in parallel; the C entry is flash_phase_ablation.cu.
#pragma once

#include <utility>

#include "flash_gqa_sm90.cuh"

namespace kdss_k13 {

// Launch `arm` if it is one of FIRST + I at head dim D, else return
// cudaErrorInvalidValue.
template <int D, int FIRST, int... I>
cudaError_t dispatch_arm(int arm, std::integer_sequence<int, I...>, const void* q, const void* k, const void* v,
                         void* out, int* next_tile, const float* shift, int B, int S, int Hq, int Hkv,
                         float scale_log2, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((arm == FIRST + I
              ? (err = kdss_gqa90_host::launch<D, true, false, FIRST + I>(q, k, v, nullptr, out, nullptr, next_tile,
                                                                         B, S, S, Hq, Hkv, scale_log2, shift, st),
                 true)
              : false) ||
         ...);
  return err;
}

template <int D, int FIRST, int COUNT>
cudaError_t ablate(int arm, const void* q, const void* k, const void* v, void* out, int* next_tile,
                   const float* shift, int B, int S, int Hq, int Hkv, float scale_log2, cudaStream_t st) {
  return dispatch_arm<D, FIRST>(arm, std::make_integer_sequence<int, COUNT>{}, q, k, v, out, next_tile, shift, B, S,
                                Hq, Hkv, scale_log2, st);
}

// The arms of each source: head dim 64 or 128, arms 0-7 (a) or 8-15 (b).
cudaError_t ablate_d64a(int arm, const void* q, const void* k, const void* v, void* out, int* next_tile,
                        const float* shift, int B, int S, int Hq, int Hkv, float scale_log2, cudaStream_t st);
cudaError_t ablate_d64b(int arm, const void* q, const void* k, const void* v, void* out, int* next_tile,
                        const float* shift, int B, int S, int Hq, int Hkv, float scale_log2, cudaStream_t st);
cudaError_t ablate_d128a(int arm, const void* q, const void* k, const void* v, void* out, int* next_tile,
                         const float* shift, int B, int S, int Hq, int Hkv, float scale_log2, cudaStream_t st);
cudaError_t ablate_d128b(int arm, const void* q, const void* k, const void* v, void* out, int* next_tile,
                         const float* shift, int B, int S, int Hq, int Hkv, float scale_log2, cudaStream_t st);

}  // namespace kdss_k13
