// The KD teacher's logits from its int8 head, for Hopper (sm_90a):
// out [N, V] f32 = ((h wq^T) * ws) * (1 / T), with the final-norm hidden
// states h [N, D] bf16, the vocab-major int8 head wq [V, D] (per-row f32
// scale ws [V]) and V the student's vocab (a leading row slice of the
// teacher's [Vt, D] head: the logits are truncated to the student's vocab
// without a copy of the head).
//
// Replaces the Pallas TPU kernel K10 of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/):
// ops/fused_loca.py::_materialize_t_int8 (kernel `_materialize_kernel` over
// `_t_block`'s int8 form).  As there, each int8 head tile becomes bf16 (exact:
// |q| <= 127 fits bf16's 8 significant bits) and meets the bf16 hidden
// states in a bf16 x bf16 -> f32 product; the per-row scale factors out of
// the dot exactly and is applied after it, then 1/T, in that order; no
// dense bf16 copy of the head ever exists.  The result is the f32 tmat that
// the loss kernels K11 and K7/K8 read.  Unlike the TPU grid (n // BN row
// blocks, which drops trailing rows when N is not a multiple of BN), rows
// past N are zero-filled on load and masked on store, so any N is whole.
//
// One block of 4 warps per 128 x 128 output tile, D in steps of 64 through
// a 3-stage cp.async ring (hidden tile bf16, head tile int8, both
// D-contiguous; rows past N or V and columns past D zero-filled); each warp
// computes a 64 x 64 sub-tile with mma.sync m16n8k16, its hidden fragments
// by ldmatrix, its head fragments converted from int8 to bf16 as it loads
// them from shared memory.  Row tiles run fastest, so a wave of blocks
// shares its head tiles in L2 and the head is read from device memory about
// once.
//
// What bounds it on the H100: at N = 3072 rows, D = 3584, V = 151936 the
// product is 3.35 TFLOP against 0.57 GB of inputs and a 1.87 GB f32 output,
// so it is bound by the bf16 tensor-core rate (989 TFLOP/s: 3.4 ms); the
// f32 output alone is 0.56 ms of device-memory time.  With mma.sync the
// fragments pass through shared memory and registers for every product
// (3 KB per k16 step of a 64 x 64 warp tile, and an int8 -> bf16 conversion
// in every warp that reads a head fragment), which caps this design; wgmma
// and TMA are the next steps.

#include "kdss_mma.cuh"

namespace kdss_tmat {

using namespace kdss;
using bf = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 128;
constexpr int LDA = BK + 8;   // hidden tile row stride, bf16 elements (144 bytes: conflict-free ldmatrix)
constexpr int LDB = BK + 16;  // head tile row stride, bytes
constexpr int NT = 8;         // n-tiles of 8 vocab columns per warp
constexpr int A_BYTES = BM * LDA * 2, B_BYTES = BN * LDB;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES;  // 86016 bytes, dynamic: two blocks share an SM

__device__ __forceinline__ void load_stage(unsigned char* s, const bf* h, const int8_t* wq, int r0, int N,
                                           int c0, int V, int k0, int D) {
  bf* as = reinterpret_cast<bf*>(s);
  int8_t* bs = reinterpret_cast<int8_t*>(s + A_BYTES);
  // hidden: 128 rows x 8 chunks of 8 bf16
  for (int i = threadIdx.x; i < BM * (BK / 8); i += THREADS) {
    const int r = i / (BK / 8), c = i % (BK / 8);
    const int row = r0 + r, k = k0 + c * 8;
    const bool ok = row < N && k < D;
    cp_async16(as + r * LDA + c * 8, ok ? h + (long)row * D + k : h, ok);
  }
  // head: 128 rows x 4 chunks of 16 int8
  for (int i = threadIdx.x; i < BN * (BK / 16); i += THREADS) {
    const int r = i / (BK / 16), c = i % (BK / 16);
    const int row = c0 + r, k = k0 + c * 16;
    const bool ok = row < V && k < D;
    cp_async16(bs + r * LDB + c * 16, ok ? wq + (long)row * D + k : wq, ok);
  }
}

// Two adjacent int8 of a head row (one 16-bit shared load; p is even) as a
// packed bf16 pair, the first in the low half (exact).
__device__ __forceinline__ uint32_t bf16x2_of_s8(const int8_t* p) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(p);
  return pack_bf16(static_cast<float>(static_cast<int8_t>(v & 0xffu)),
                   static_cast<float>(static_cast<int8_t>(v >> 8)));
}

__global__ void __launch_bounds__(THREADS, 2)
    tmat_int8_kernel(const bf* __restrict__ h, const int8_t* __restrict__ wq, const float* __restrict__ ws,
                     float* __restrict__ out, int N, int V, int D, float inv_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int wm = warp / 2, wn = warp % 2;  // 2 x 2 warps of 64 rows x 64 vocab columns
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int nkt = (D + BK - 1) / BK;
  // this lane's ldmatrix row and column (see kdss_mma.cuh::ldmatrix_x4)
  const int a_off = (wm * 64 + (lane % 8) + 8 * ((lane / 8) % 2)) * LDA + 8 * (lane / 16);

  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load_stage(smem + s * STAGE_BYTES, h, wq, r0, N, c0, V, s * BK, D);
    cp_async_commit();
  }

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int next = kt + STAGES - 1;
    if (next < nkt) load_stage(smem + (next % STAGES) * STAGE_BYTES, h, wq, r0, N, c0, V, next * BK, D);
    cp_async_commit();

    const unsigned char* s = smem + (kt % STAGES) * STAGE_BYTES;
    const bf* as = reinterpret_cast<const bf*>(s);
    const int8_t* bs = reinterpret_cast<const int8_t*>(s + A_BYTES);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(af[mt], as + a_off + mt * 16 * LDA + ks);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* p = bs + (wn * 8 * NT + nt * 8 + gi) * LDB + ks + ti * 2;
        bfr[nt][0] = bf16x2_of_s8(p);
        bfr[nt][1] = bf16x2_of_s8(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma16816(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  cp_async_wait<0>();

  // ((acc * ws) * inv_t); V is even, so a pair never straddles V.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = c0 + wn * 8 * NT + nt * 8 + ti * 2;
    if (col >= V) continue;
    const float s0 = ws[col], s1 = ws[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + wm * 64 + mt * 16 + gi + hh * 8;
        if (row >= N) continue;
        const float v0 = __fmul_rn(__fmul_rn(acc[mt][nt][2 * hh], s0), inv_t);
        const float v1 = __fmul_rn(__fmul_rn(acc[mt][nt][2 * hh + 1], s1), inv_t);
        *reinterpret_cast<float2*>(out + (long)row * V + col) = make_float2(v0, v1);
      }
    }
  }
}

}  // namespace kdss_tmat

using namespace kdss_tmat;

extern "C" {

// K10.  h bf16 [N, D], wq int8 [V, D] (row stride D), ws f32 [V], out f32
// [N, V]; D a multiple of 16, V even.  Returns a cudaError_t
// (cudaErrorInvalidValue for shapes it does not take).
int kdss_tmat_int8(const void* h, const void* wq, const void* ws, void* out, int N, int V, int D,
                   float inv_t, void* stream) {
  if (N <= 0 || V <= 0 || V % 2 != 0 || D <= 0 || D % 16 != 0 || (V + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(tmat_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BM - 1) / BM, (V + BN - 1) / BN);
  tmat_int8_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(h), static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<float*>(out), N, V, D, inv_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
