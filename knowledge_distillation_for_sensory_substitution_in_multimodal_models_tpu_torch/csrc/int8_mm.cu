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
//   `gemm_kernel`: s8 x s8 -> s32 wgmma (k32 steps), both operands K-major
//     from 128-byte-swizzled TMA boxes of 128 K bytes (x [N, K] and W [M,
//     K] are both row-major over K, as int8 wgmma requires).  A persistent
//     block an SM: one producer warp streams the A and B tiles of a STAGES-
//     deep ring under mbarriers, across output tiles, and WGS consumer
//     warpgroups of 64 A rows each multiply them.  Rows past N or M and
//     bytes past K load as zeros (TMA's fill), so SigLIP's K = 4304 takes a
//     partial last box and its M = 4304 a masked last tile; K need only be a
//     multiple of 16 (the row stride TMA takes).  The output tiles run A
//     tiles fastest, so the blocks in flight share a few W tiles, which stay
//     in L2.  The s32 sums are exact (|acc| <= 127 * 127 * 18944 < 2^31):
//     the XLA form keeps one through K; K12's form folds it into an f32 sum
//     at each K-block end, in the JAX order.
//   Three shapes of the GEMM: the XLA form at N > 8 (A = x, 128 rows of two
//   warpgroups, B = a 256-row W tile: 128 s32 accumulators a thread); K12's
//   form at N > 8 (B = 128 W rows, so that the f32 sum fits beside the s32
//   one); and N <= 8, decode (A and B swapped: A = 64 W rows, B = the x rows
//   at n = 8, zero-filled past N), where a 64-row x tile would waste 63/64
//   of the tensor cores' work on zeros and the weight bytes bound the time.
//
// The split form (ops/int8.py::int8_matmul_rowwise), for a projection whose
// K is split over a tensor-parallel group, runs the XLA form in four
// launches with two all-reduces between them, so that the sharded product
// equals the one-device one bit for bit:
//   `row_absmax`: one warp per row writes the local max |x| of the rank's K
//     columns, f32 [N], unclamped (the group then takes the MAX);
//   `quantize_rows<GIVEN = true>`: reads that global amax instead of
//     computing one, clamps it to 1e-6 and quantizes and scales as above
//     (xs = amax / 127, the XLA form's division);
//   `gemm_kernel<G, S32 = true>`: the same mainloop, the raw s32
//     accumulators written to int32 [N, M] and the epilogue skipped (the
//     group then SUMs them, exact in int32 at every width of the repo);
//   `scale_epilogue`: y = (float(acc) * xs) * ws with __fmul_rn in the JAX
//     order, cast to bf16 or f32; four elements a thread, bound by bytes.
// GIVEN and S32 are template parameters, so the fused K12's instantiations
// (false) compile to the code they had before the split form.
//
// What bounds it on the H100: at the 7B teacher's projections (N = 3072
// rows, K and M of 3584 and 18944) the product is 70-417 GOP against
// 30-206 MB of operands and output, so it is bound by the int8 tensor-core
// rate (1979 TOP/s: 0.21 ms for gate_proj); decode (N = 1) is bound by the
// weight bytes.  The mma.sync kernel this replaces passed every
// operand through shared memory and registers (a k32 step of a 64 x 64 warp
// tile loaded 4 KB of fragments for 131072 multiply-adds), so shared-memory
// bandwidth capped it at ~25% of the int8 peak; wgmma reads both operands
// from shared memory without the register file, and TMA issues a tile's
// copy from one thread.

#include "kdss_sm90.cuh"

namespace kdss_int8 {

using namespace kdss_sm90;
using kdss::FULL;
using bf = __nv_bfloat16;

constexpr int Q_WARPS = 8;  // rows per block of the quantize pass
constexpr int BK = 128;     // K bytes a stage: one 128-byte swizzle row

// The GEMM's block: WGS consumer warpgroups of 64 A rows, B tiles of BN rows,
// a ring of STAGES stages.  SWAP: A = W (output channels), B = x rows.
template <int WGS_, int BN_, int STAGES_, bool SWAP_, bool KBLOCK_>
struct Gemm {
  static constexpr int WGS = WGS_, BN = BN_, STAGES = STAGES_;
  static constexpr bool SWAP = SWAP_, KBLOCK = KBLOCK_;
  static constexpr int BM = 64 * WGS;  // A rows of a tile
  static constexpr int CONSUMERS = 128 * WGS, THREADS = CONSUMERS + 32;
  static constexpr int ABYTES = BM * BK, STAGE = ABYTES + BN * BK;  // 1024-byte multiples
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;  // full[STAGES], empty[STAGES], alignment slack
  static constexpr int NACC = BN / 2;                        // s32 accumulators a thread (64 x BN / 128)
  static_assert(SMEM <= 232448, "shared memory of one block");
};
using GemmXla = Gemm<2, 256, 4, false, false>;
using GemmKBlock = Gemm<2, 128, 6, false, true>;
using GemmDecode = Gemm<1, 8, 8, true, false>;
using GemmDecodeKBlock = Gemm<1, 8, 8, true, true>;
// The N at and below which the GEMM swaps A and B.
constexpr int DECODE_ROWS = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// This lane's part of max |x| over columns [k0, k1) of a row (8 bf16 a load).
__device__ __forceinline__ float lane_absmax(const bf* __restrict__ xr, int k0, int k1, int lane) {
  float amax = 0.f;
  for (int k = k0 + lane * 8; k < k1; k += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const bf* e = reinterpret_cast<const bf*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
  }
  return amax;
}

// The split form's first pass: amax[row] = max |x| over the row, unclamped.
__global__ void __launch_bounds__(Q_WARPS * 32)
    row_absmax(const bf* __restrict__ x, float* __restrict__ amax, int N, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * Q_WARPS + warp;
  if (row >= N) return;
  const float a = warp_max(lane_absmax(x + (long)row * K, 0, K, lane));
  if (lane == 0) amax[row] = a;
}

// GIVEN: `given` (f32 [N], the split form's all-reduced amax, k_block = K)
// replaces the computed absmax of each row.
template <bool GIVEN>
__global__ void __launch_bounds__(Q_WARPS * 32)
    quantize_rows(const bf* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, int N,
                  int K, int k_block, int nkb, int div_scale, const float* __restrict__ given) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * Q_WARPS + warp;
  if (row >= N) return;
  const bf* xr = x + (long)row * K;
  int8_t* qr = xq + (long)row * K;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * k_block, k1 = min(k0 + k_block, K);
    float amax;
    if constexpr (GIVEN)
      amax = fmaxf(given[row], 1e-6f);
    else
      amax = fmaxf(warp_max(lane_absmax(xr, k0, k1, lane)), 1e-6f);
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


// acc (+)= A (64 x 32) B^T (BN x 32) for the four k32 steps of one stage;
// scale_d = 0 on the first step overwrites acc.  Issues the wgmmas only.
template <class G>
__device__ __forceinline__ void mma_stage(int (&acc)[G::NACC], const unsigned char* a, const unsigned char* b,
                                          bool fresh) {
  const uint64_t da = desc_kmajor(a), db = desc_kmajor(b);
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk) {
    const int scale_d = fresh && kk == 0 ? 0 : 1;
    if constexpr (G::BN == 256)
      wgmma_m64n256k32_s8(acc, da + 2 * kk, db + 2 * kk, scale_d);
    else if constexpr (G::BN == 128)
      wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, scale_d);
    else
      wgmma_m64n8k32_s8(acc, da + 2 * kk, db + 2 * kk, scale_d);
  }
}

// S32 (the split form, XLA form only): out is int32 [N, M], the raw sums.
template <class G, bool S32>
__global__ void __launch_bounds__(G::THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const float* __restrict__ xs, const float* __restrict__ ws, void* __restrict__ out, int N, int K,
                int M, int k_block, int nkb, int out_f32, int n_at, int n_tiles) {
  static_assert(!(S32 && G::KBLOCK), "the split form is the XLA form");
  constexpr int STAGES = G::STAGES, NACC = G::NACC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BARS);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);                    // the producer, with the stage's bytes
      mbar_init(empty + s, G::CONSUMERS / 32);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int nkt = (K + BK - 1) / BK;

  if (threadIdx.x >= G::CONSUMERS) {  // producer: one thread streams every tile's stages
    if (threadIdx.x != G::CONSUMERS) return;
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int a0 = t % n_at * G::BM, b0 = t / n_at * G::BN;
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(empty + s, phase ^ 1);
        mbar_arrive_expect_tx(full + s, G::STAGE);
        unsigned char* st = smem + s * G::STAGE;
        tma_load_2d(st, &map_a, full + s, kt * BK, a0);
        tma_load_2d(st + G::ABYTES, &map_b, full + s, kt * BK, b0);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: A rows a0 + 64 wg + 16 warp + gi (+ 8) of each tile
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  int s = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int a0 = t % n_at * G::BM, b0 = t / n_at * G::BN;
    // accumulator i of this thread: A row ar + 8 ((i / 2) % 2), B row br + 8 (i / 4) + (i % 2)
    const int ar = a0 + 64 * wg + 16 * warp + gi, br = b0 + 2 * ti;
    auto x_row = [&](int i) { return G::SWAP ? br + 8 * (i / 4) + (i % 2) : ar + 8 * ((i / 2) % 2); };
    int acc[NACC];
    float accf[NACC];  // K12's form: the f32 sum over K blocks
    if constexpr (G::KBLOCK) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) accf[i] = 0.f;
    }
    bool fresh = true;
    int prev = 0;
    for (int kt = 0; kt < nkt; ++kt) {
      mbar_wait(full + s, phase);
      const unsigned char* st = smem + s * G::STAGE;
      wgmma_fence();
      mma_stage<G>(acc, st + wg * 64 * BK, st + G::ABYTES, fresh);
      wgmma_commit();
      fresh = false;
      if constexpr (G::KBLOCK) {
        // Every stage's products end here (a wait that depends on the K
        // block, to keep one group in flight between folds, made ptxas
        // serialize the wgmmas: slower, PERF.md).
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + s);
        // at a K-block end (k_block a multiple of BK, or the end of K):
        // fold the exact s32 sums into f32 with the rows' scales of this block
        if (kt == nkt - 1 || (kt + 1) * BK % k_block == 0) {
          const int kb = kt * BK / k_block;
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            const int xr = x_row(i);
            const float sc = xr < N ? xs[static_cast<long>(xr) * nkb + kb] : 0.f;
            accf[i] = __fadd_rn(accf[i], __fmul_rn(__int2float_rn(acc[i]), sc));
          }
          fresh = true;
        }
      } else {
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kt > 0 && lane == 0) mbar_arrive(empty + prev);
        prev = s;
      }
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    if constexpr (!G::KBLOCK) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + prev);
    }

    if constexpr (S32) {
      // the split form: the raw s32 sums, no epilogue
#pragma unroll
      for (int i = 0; i < NACC; i += 2) {
        const int xr = x_row(i);
        if constexpr (G::SWAP) {
          const int ch = ar + 8 * ((i / 2) % 2);
          if (ch >= M) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (xr + e < N) static_cast<int*>(out)[static_cast<long>(xr + e) * M + ch] = acc[i + e];
        } else {
          const int col = b0 + 8 * (i / 4) + 2 * ti;
          if (xr >= N || col >= M) continue;
          *reinterpret_cast<int2*>(static_cast<int*>(out) + static_cast<long>(xr) * M + col) =
              make_int2(acc[i], acc[i + 1]);
        }
      }
      continue;
    }

    // y = (acc * row scale) * ws per output channel (the XLA form: its one
    // K block's sum), or accf * ws (K12's).
#pragma unroll
    for (int i = 0; i < NACC; i += 2) {
      const int xr = x_row(i);
      if constexpr (G::SWAP) {
        const int ch = ar + 8 * ((i / 2) % 2);
        if (ch >= M) continue;
        const float w = ws[ch];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (xr + e >= N) continue;
          const float sum = G::KBLOCK ? accf[i + e] : __fmul_rn(__int2float_rn(acc[i + e]), xs[xr + e]);
          const float y = __fmul_rn(sum, w);
          const long o = static_cast<long>(xr + e) * M + ch;
          if (out_f32)
            static_cast<float*>(out)[o] = y;
          else
            static_cast<bf*>(out)[o] = __float2bfloat16_rn(y);
        }
      } else {
        const int col = b0 + 8 * (i / 4) + 2 * ti;  // M is even, so a pair never straddles M
        if (xr >= N || col >= M) continue;
        const float srow = G::KBLOCK ? 1.f : xs[xr];
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sum = G::KBLOCK ? accf[i + e] : __fmul_rn(__int2float_rn(acc[i + e]), srow);
          v[e] = __fmul_rn(sum, ws[col + e]);
        }
        const long o = static_cast<long>(xr) * M + col;
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v[0], v[1]);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf*>(out) + o) = kdss::pack_bf16(v[0], v[1]);
      }
    }
  }
}

// The split form's epilogue: out[r, c] = (float(acc[r, c]) * xs[r]) * ws[c],
// four consecutive elements of a row a thread (M a multiple of 8).
__global__ void __launch_bounds__(256)
    scale_epilogue(const int* __restrict__ acc, const float* __restrict__ xs, const float* __restrict__ ws,
                   void* __restrict__ out, int N, int M, int out_f32) {
  const long quads = static_cast<long>(N) * M / 4;
  for (long q = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; q < quads;
       q += static_cast<long>(gridDim.x) * blockDim.x) {
    const long e0 = q * 4;
    const int row = static_cast<int>(e0 / M), col = static_cast<int>(e0 % M);
    const int4 a = reinterpret_cast<const int4*>(acc)[q];
    const int av[4] = {a.x, a.y, a.z, a.w};
    const float s = xs[row];
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = __fmul_rn(__fmul_rn(__int2float_rn(av[j]), s), ws[col + j]);
    if (out_f32)
      reinterpret_cast<float4*>(out)[q] = make_float4(y[0], y[1], y[2], y[3]);
    else
      reinterpret_cast<uint2*>(out)[q] = make_uint2(kdss::pack_bf16(y[0], y[1]), kdss::pack_bf16(y[2], y[3]));
  }
}

// A 2-D map of an int8 matrix [rows, K] (row-major, 16-byte aligned, K a
// multiple of 16): dims {K, rows}, boxes of 128 K bytes x `box_rows` rows
// with the 128-byte swizzle; ops/int8.py::tma_map states the same map.
inline cudaError_t int8_map(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(K)};
  const uint32_t box[2] = {BK, static_cast<uint32_t>(box_rows)};
  return kdss_sm90_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
}

template <class G, bool S32 = false>
cudaError_t launch_gemm(const void* xq, const void* xs, const void* wq, const void* ws, void* out, int N, int K,
                        int M, int k_block, int nkb, int out_f32, cudaStream_t st) {
  const int ra = G::SWAP ? M : N, rb = G::SWAP ? N : M;
  CUtensorMap map_a, map_b;
  cudaError_t err = int8_map(&map_a, G::SWAP ? wq : xq, ra, K, G::BM);
  if (err == cudaSuccess) err = int8_map(&map_b, G::SWAP ? xq : wq, rb, K, G::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_kernel<G, S32>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_at = (ra + G::BM - 1) / G::BM;
  const long n_tiles = static_cast<long>(n_at) * ((rb + G::BN - 1) / G::BN);
  if (n_tiles > (1L << 30)) return cudaErrorInvalidValue;
  const int grid = n_tiles < sms ? static_cast<int>(n_tiles) : sms;
  gemm_kernel<G, S32><<<grid, G::THREADS, G::SMEM, st>>>(map_a, map_b, static_cast<const float*>(xs),
                                                         static_cast<const float*>(ws), out, N, K, M, k_block, nkb,
                                                         out_f32, n_at, static_cast<int>(n_tiles));
  return cudaGetLastError();
}

int n_blocks(int K, int k_block) { return (K + k_block - 1) / k_block; }

bool shapes_ok(int N, int K, int k_block) {
  return N > 0 && K > 0 && K % 16 == 0 && k_block > 0 && (k_block >= K || k_block % BK == 0);
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
  quantize_rows<false><<<grid, Q_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), N, K, k_block,
      n_blocks(K, k_block), div_scale, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 of K12.  out [N, M] (f32 if out_f32, else bf16) from xq, xs (pass
// 1's, same k_block), wq int8 [M, K] and ws f32 [M]; M a multiple of 8, K of
// 16, k_block >= K or a multiple of 128.
int kdss_int8_gemm(const void* xq, const void* xs, const void* wq, const void* ws, void* out, int N,
                   int K, int M, int k_block, int out_f32, void* stream) {
  if (!shapes_ok(N, K, k_block) || M <= 0 || M % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nkb = n_blocks(K, k_block);
  cudaError_t err;
  if (N <= DECODE_ROWS)
    err = nkb == 1 ? launch_gemm<GemmDecode>(xq, xs, wq, ws, out, N, K, M, k_block, nkb, out_f32, st)
                   : launch_gemm<GemmDecodeKBlock>(xq, xs, wq, ws, out, N, K, M, k_block, nkb, out_f32, st);
  else
    err = nkb == 1 ? launch_gemm<GemmXla>(xq, xs, wq, ws, out, N, K, M, k_block, nkb, out_f32, st)
                   : launch_gemm<GemmKBlock>(xq, xs, wq, ws, out, N, K, M, k_block, nkb, out_f32, st);
  return static_cast<int>(err);
}

// The split form (ops/int8.py::int8_matmul_rowwise), four launches:
// amax f32 [N] = max |x| of each row of x bf16 [N, K], unclamped.
int kdss_int8_absmax(const void* x, void* amax, int N, int K, void* stream) {
  if (N <= 0 || K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  row_absmax<<<(N + Q_WARPS - 1) / Q_WARPS, Q_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(x), static_cast<float*>(amax), N, K);
  return static_cast<int>(cudaGetLastError());
}

// xq int8 [N, K] and xs f32 [N] = max(amax, 1e-6) / 127 with the given amax
// f32 [N] (the group's MAX of kdss_int8_absmax's).
int kdss_int8_quantize_given(const void* x, const void* amax, void* xq, void* xs, int N, int K, void* stream) {
  if (!shapes_ok(N, K, K) || amax == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows<true><<<(N + Q_WARPS - 1) / Q_WARPS, Q_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), N, K, K, 1, 1,
      static_cast<const float*>(amax));
  return static_cast<int>(cudaGetLastError());
}

// acc int32 [N, M] = xq [N, K] . wq [M, K]^T, the raw sums (the XLA form's
// GEMM, epilogue skipped); M a multiple of 8, K of 16.
int kdss_int8_gemm_s32(const void* xq, const void* wq, void* acc, int N, int K, int M, void* stream) {
  if (!shapes_ok(N, K, K) || M <= 0 || M % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      N <= DECODE_ROWS ? launch_gemm<GemmDecode, true>(xq, nullptr, wq, nullptr, acc, N, K, M, K, 1, 0, st)
                       : launch_gemm<GemmXla, true>(xq, nullptr, wq, nullptr, acc, N, K, M, K, 1, 0, st);
  return static_cast<int>(err);
}

// out [N, M] (f32 if out_f32, else bf16) = (float(acc) * xs[row]) * ws[col];
// M a multiple of 8.
int kdss_int8_epilogue(const void* acc, const void* xs, const void* ws, void* out, int N, int M, int out_f32,
                       void* stream) {
  if (N <= 0 || M <= 0 || M % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long quads = static_cast<long>(N) * M / 4;
  const long blocks = (quads + 255) / 256;
  scale_epilogue<<<static_cast<int>(blocks < 8192 ? blocks : 8192), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(acc), static_cast<const float*>(xs), static_cast<const float*>(ws), out, N, M,
      out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
