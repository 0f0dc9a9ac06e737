// w8a8 int8 matrix product for Hopper (sm_90a): y = x W^T with x [N, K]
// bf16 quantized per row on the fly, W [M, K] int8 with a per-output-channel
// f32 scale, an exact int32 product on the tensor cores, the scales applied
// in f32, and y [N, M] in bf16 or f32.
//
// Replaces the Pallas TPU kernel K12 of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/):
// ops/int8.py::int8_matmul_pallas (kernel `_int8_mm_kernel`), and computes
// the XLA form ops/int8.py::int8_matmul_xla as well.  The two differ only in
// how the activations are scaled:
//   * the XLA form (what every JAX CLI runs): one absmax per row over all of
//     K, y = (acc * (amax / 127)) * ws;
//   * K12's own form: one absmax per row per K block of `k_block` columns
//     (`_pick_block(K, 512)` in the JAX package), y = (sum over the blocks,
//     in order, of acc_b * (amax_b * (1 / 127))) * ws.
// Both are one `k_block` argument here: k_block = K is the XLA form (and
// divides the scale, `div_scale`), a smaller k_block is K12's.  In both,
// xq = clip(rint(x * (127 / max(amax, 1e-6))), -127, 127), rounding half
// to even as jnp.round does, with IEEE division (no fast math); the sums
// and products of the epilogue are __fadd_rn / __fmul_rn in the JAX order,
// so the result matches the plain version bit for bit up to the output
// rounding.
//
// Two kernels, one launch each:
//   `quantize_rows`: one warp per row; for each K block, a pass for the
//     absmax and a pass that writes the int8 row and the block's scale
//     (amax / 127) to f32 [N, nkb].  The XLA form needs a row's whole
//     absmax before any of its products, so it runs as this pre-pass, and
//     K12's form shares it: one quantization per element, instead of one
//     per output tile if the GEMM quantized its bf16 tile on every load,
//     for N*K int8 bytes written and read back (~1/4 of the GEMM's input
//     bytes at the 7B teacher's shapes);
//   `int8_gemm`: one block of 4 warps per 128 x 128 output tile (128 x 64
//     in K12's form), K in steps of 64 through a 3-stage cp.async ring of
//     int8 tiles (rows past N, rows past M and columns past K zero-filled; K
//     need only be a multiple of 16, so SigLIP's K = 4304 takes a partial
//     last step and its M = 4304 a masked last tile); each warp takes its
//     fragments with ldmatrix and runs mma.sync m16n8k32 s8 x s8 -> s32
//     over a 64 x 64 sub-tile (64 x 32 in K12's form, which also carries an
//     f32 sum that takes the s32 sums at each K-block end).  The s32 sum is
//     exact (|acc| <= 127 * 127 * 18944 < 2^31).
//
// What bounds it on the H100: at the 7B teacher's projections (N = 3072
// rows, K and M of 3584 and 18944) the product is 70-417 GOP against
// 30-206 MB of operands and output, so it is bound by the int8 tensor-core
// rate (1979 TOP/s: 0.21 ms for gate_proj); decode (N = 1) is bound by the
// weight bytes.  With mma.sync the operands pass through shared memory and
// registers for every product: a k32 step of a 64 x 64 warp tile loads 4 KB
// of fragments for 131072 multiply-adds, so shared-memory bandwidth, not
// the tensor cores, caps this design.  Two blocks of 4 warps share an SM.  wgmma, which reads B from shared memory without the register file,
// and TMA are the next steps.

#include "kdss_mma.cuh"

namespace kdss_int8 {

using namespace kdss;
using bf = __nv_bfloat16;

constexpr int Q_WARPS = 8;  // rows per block of the quantize pass
constexpr int BM = 128, BK = 64, STAGES = 3;
constexpr int LDS = BK + 16;  // shared row stride in bytes: conflict-free ldmatrix rows

// The GEMM's tiling: 2 x 2 warps, each 64 rows x (8 NT) columns.  The XLA
// form folds its s32 sums into f32 once, in the epilogue, so its warps take
// 64 columns (128 s32 accumulators a thread); K12's form also carries the
// f32 sum over K blocks, so its warps take 32.
template <bool KBLOCK>
struct Tiling {
  static constexpr int NT = KBLOCK ? 4 : 8;  // n-tiles of 8 columns per warp
  static constexpr int BN = 2 * 8 * NT;      // 128 or 64 columns per block
  static constexpr int THREADS = 128;
  static constexpr int STAGE = (BM + BN) * LDS;
  static constexpr int SMEM = STAGES * STAGE;  // 61440 or 46080 bytes, dynamic
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__global__ void __launch_bounds__(Q_WARPS * 32)
    quantize_rows(const bf* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int N,
                  int K, int k_block, int nkb, int div_scale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * Q_WARPS + warp;
  if (row >= N) return;
  const bf* xr = x + (long)row * K;
  int8_t* qr = xq + (long)row * K;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * k_block, k1 = min(k0 + k_block, K);
    float amax = 0.f;
    for (int k = k0 + lane * 8; k < k1; k += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
      const bf* e = reinterpret_cast<const bf*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
    }
    amax = fmaxf(warp_max(amax), 1e-6f);
    const float mul = 127.0f / amax;
    for (int k = k0 + lane * 8; k < k1; k += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
      const bf* e = reinterpret_cast<const bf*>(&v);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = min(127, max(-127, __float2int_rn(__fmul_rn(__bfloat162float(e[i]), mul))));
        w[i / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i % 4));
      }
      *reinterpret_cast<uint2*>(qr + k) = make_uint2(w[0], w[1]);
    }
    if (lane == 0) xs[(long)row * nkb + kb] = div_scale ? amax / 127.0f : __fmul_rn(amax, 1.0f / 127.0f);
  }
}

// Rows [r0, r0 + ROWS) x bytes [k0, k0 + 64) of a row-major [R, K] int8
// matrix into a [ROWS][LDS] stage; rows >= R and bytes >= K zero-filled.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_stage(int8_t* s, const int8_t* g, int r0, int R, int k0, int K) {
  constexpr int CHUNKS = BK / 16;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int row = r0 + r, k = k0 + c * 16;
    const bool ok = row < R && k < K;
    cp_async16(s + r * LDS + c * 16, ok ? g + (long)row * K + k : g, ok);
  }
}

template <bool KBLOCK>
__global__ void __launch_bounds__(Tiling<KBLOCK>::THREADS, 2)
    int8_gemm(const int8_t* __restrict__ xq, const float* __restrict__ xs, const int8_t* __restrict__ wq,
              const float* __restrict__ ws, void* __restrict__ out, int N, int K, int M, int k_block,
              int nkb, int out_f32) {
  using T = Tiling<KBLOCK>;
  constexpr int NT = T::NT;
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  const int wm = warp / 2, wn = warp % 2;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * T::BN;
  const int nkt = (K + BK - 1) / BK;
  // this lane's ldmatrix row and byte offsets (see kdss_mma.cuh::ldmatrix_x4)
  const int a_off = (wm * 64 + (lane % 8) + 8 * ((lane / 8) % 2)) * LDS + 16 * (lane / 16);
  const int b_off = (wn * 8 * NT + (lane % 8) + 8 * (lane / 16)) * LDS + 16 * ((lane / 8) % 2);

  int acc[4][NT][4];
  float accf[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0, accf[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) {
      load_stage<BM, T::THREADS>(smem + s * T::STAGE, xq, r0, N, s * BK, K);
      load_stage<T::BN, T::THREADS>(smem + s * T::STAGE + BM * LDS, wq, c0, M, s * BK, K);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int next = kt + STAGES - 1;
    if (next < nkt) {
      int8_t* s = smem + (next % STAGES) * T::STAGE;
      load_stage<BM, T::THREADS>(s, xq, r0, N, next * BK, K);
      load_stage<T::BN, T::THREADS>(s + BM * LDS, wq, c0, M, next * BK, K);
    }
    cp_async_commit();

    const int8_t* as = smem + (kt % STAGES) * T::STAGE;
    const int8_t* bs = as + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[4][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(af[mt], as + a_off + mt * 16 * LDS + ks);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + b_off + np * 16 * LDS + ks);
        bfr[2 * np][0] = r[0], bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2], bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma16832_s8(acc[mt][nt], af[mt], bfr[nt]);
    }

    // K12's form, at the end of a K block (k_block a multiple of BK, or
    // the end of K): fold the exact s32 sums into f32 with the rows'
    // scales of this block.
    if (KBLOCK && (kt == nkt - 1 || ((kt + 1) * BK) % k_block == 0)) {
      const int kb = kt * BK / k_block;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int ra = r0 + wm * 64 + mt * 16 + gi, rb = ra + 8;
        const float sa = ra < N ? xs[(long)ra * nkb + kb] : 0.f;
        const float sb = rb < N ? xs[(long)rb * nkb + kb] : 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            accf[mt][nt][e] = __fadd_rn(accf[mt][nt][e],
                                        __fmul_rn(__int2float_rn(acc[mt][nt][e]), e < 2 ? sa : sb));
            acc[mt][nt][e] = 0;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // y = (acc * row scale) * ws per output channel (the XLA form: its one
  // K block's sum), or accf * ws (K12's); M is even, so a pair never
  // straddles M.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wm * 64 + mt * 16 + gi + h * 8;
      if (row >= N) continue;
      const float srow = KBLOCK ? 1.f : xs[row];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = c0 + wn * 8 * NT + nt * 8 + ti * 2;
        if (col >= M) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float sum = KBLOCK ? accf[mt][nt][2 * h + j]
                                   : __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + j]), srow);
          v[j] = __fmul_rn(sum, ws[col + j]);
        }
        const long o = (long)row * M + col;
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v[0], v[1]);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf*>(out) + o) = pack_bf16(v[0], v[1]);
      }
    }
  }
}

template <bool KBLOCK>
cudaError_t launch_gemm(const void* xq, const void* xs, const void* wq, const void* ws, void* out, int N,
                        int K, int M, int k_block, int nkb, int out_f32, cudaStream_t st) {
  using T = Tiling<KBLOCK>;
  if ((M + T::BN - 1) / T::BN > 65535) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(int8_gemm<KBLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BM - 1) / BM, (M + T::BN - 1) / T::BN);  // row tiles fastest: W is read ~once
  int8_gemm<KBLOCK><<<grid, T::THREADS, T::SMEM, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), out, N, K, M, k_block, nkb, out_f32);
  return cudaGetLastError();
}

int n_blocks(int K, int k_block) { return (K + k_block - 1) / k_block; }

bool shapes_ok(int N, int K, int k_block) {
  return N > 0 && K > 0 && K % 16 == 0 && k_block > 0 && k_block % 8 == 0 &&
         (k_block >= K || k_block % BK == 0);
}

}  // namespace kdss_int8

using namespace kdss_int8;

extern "C" {

// Pass 1 of K12.  x bf16 [N, K] -> xq int8 [N, K] and xs f32 [N, nkb]
// (nkb = ceil(K / k_block)), the scale of each row's K block: amax / 127
// (div_scale, the XLA form, k_block = K) or amax * (1 / 127) (K12's form).
// Returns a cudaError_t (cudaErrorInvalidValue for shapes it does not take).
int kdss_int8_quantize(const void* x, void* xq, void* xs, int N, int K, int k_block, int div_scale,
                       void* stream) {
  if (!shapes_ok(N, K, k_block)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (N + Q_WARPS - 1) / Q_WARPS;
  quantize_rows<<<grid, Q_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), N, K, k_block,
      n_blocks(K, k_block), div_scale);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 of K12.  out [N, M] (f32 if out_f32, else bf16) from xq, xs (pass
// 1's, same k_block), wq int8 [M, K] and ws f32 [M]; M a multiple of 8.
int kdss_int8_gemm(const void* xq, const void* xs, const void* wq, const void* ws, void* out, int N,
                   int K, int M, int k_block, int out_f32, void* stream) {
  if (!shapes_ok(N, K, k_block) || M <= 0 || M % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nkb = n_blocks(K, k_block);
  return static_cast<int>(nkb == 1 ? launch_gemm<false>(xq, xs, wq, ws, out, N, K, M, k_block, nkb, out_f32, st)
                                   : launch_gemm<true>(xq, xs, wq, ws, out, N, K, M, k_block, nkb, out_f32, st));
}

}  // extern "C"
