// K13: the phase-ablation arms of the flash forward (flash_fwd.cuh, `enum
// Arm`), launched as the JAX script scripts/flash_phase_ablation.py builds
// them: causal, Sq == Skv, no kv mask, no lse.  Replaces the script's
// `pl.pallas_call` of `_streaming_smem_kernel` (:336) and of
// `_variant_kernel` / the shipped `_gqa_fwd_kernel` (:375).  The arms are a
// profiling instrument: no path of the package launches them.  What bounds
// them is what bounds K3 (flash_fwd.cu): tensor-core issue, at a fraction of
// the wgmma peak; each arm's time minus ARM_FULL's is what one phase costs
// this kernel.  The instantiations are split by head dim over two sources
// (flash_phase_ablation_d64.cu, _d128.cu) so that the build's one nvcc per
// source compiles them in parallel.
#pragma once

#include <utility>

#include "flash_fwd.cuh"

namespace kdss_k13 {

// Launch ARM at head dim D; the same arguments as kdss_flash_phase_ablation.
template <int D, int ARM>
cudaError_t launch_arm(const void* q, const void* k, const void* v, void* out, const float* shift,
                       int B, int S, int Hq, int Hkv, float scale_log2, cudaStream_t st) {
  constexpr int smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D, true, false, ARM>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, Hq, B);
  kernel<<<grid, NTHREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), nullptr, static_cast<__nv_bfloat16*>(out), nullptr, S, S,
      Hq, Hkv, Hq / Hkv, scale_log2, shift);
  return cudaGetLastError();
}

template <int D, int... A>
cudaError_t dispatch_arm(int arm, std::integer_sequence<int, A...>, const void* q, const void* k,
                         const void* v, void* out, const float* shift, int B, int S, int Hq, int Hkv,
                         float scale_log2, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((arm == A ? (err = launch_arm<D, A>(q, k, v, out, shift, B, S, Hq, Hkv, scale_log2, st),
                      true)
                   : false) ||
         ...);
  return err;
}

template <int D>
cudaError_t ablate(int arm, const void* q, const void* k, const void* v, void* out,
                   const float* shift, int B, int S, int Hq, int Hkv, float scale_log2,
                   cudaStream_t st) {
  return dispatch_arm<D>(arm, std::make_integer_sequence<int, ARM_N_ARMS>{}, q, k, v, out, shift, B,
                         S, Hq, Hkv, scale_log2, st);
}

cudaError_t ablate_d64(int arm, const void* q, const void* k, const void* v, void* out,
                       const float* shift, int B, int S, int Hq, int Hkv, float scale_log2,
                       cudaStream_t st);
cudaError_t ablate_d128(int arm, const void* q, const void* k, const void* v, void* out,
                        const float* shift, int B, int S, int Hq, int Hkv, float scale_log2,
                        cudaStream_t st);

}  // namespace kdss_k13
