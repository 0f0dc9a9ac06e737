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
// `_t_block`'s int8 form).  As there, each int8 head element becomes bf16
// (exact: |q| <= 127 fits bf16's 8 significant bits) and meets the bf16
// hidden states in a bf16 x bf16 -> f32 product; the per-row scale factors
// out of the dot exactly and is applied after it, then 1/T, in that order;
// no dense bf16 copy of the head ever exists.  Unlike the TPU grid (n // BN
// row blocks, which drops trailing rows when N is not a multiple of BN),
// rows past N are zero-filled on load and masked on store, so any N is whole.
//
// What bounds it on the H100: at N = 3072 rows, D = 3584, V = 151936 the
// product is 3.35 TFLOP against 0.57 GB of inputs and a 1.87 GB f32 output,
// so it is bound by the bf16 tensor-core rate (989 TFLOP/s: 3.4 ms); the f32
// output alone is 0.56 ms of device-memory time.
//
// Design: the transposed product out^T = W h^T, the vocab as wgmma's M.
// One persistent block per SM, 3 warpgroups: a producer (one thread) streams
// the int8 head tile [128 vocab x 64 k] and the hidden tile [256 rows x 64 k]
// of each k step through a 4-stage TMA ring under mbarriers; each of two
// consumer warpgroups owns 64 vocab rows x 256 hidden rows (128 f32
// accumulators a thread).  A consumer thread reads its two head rows' 16
// bytes of the k step with one 16-byte shared load each, converts every
// byte once (an offset-binary float trick: byte_perm, one subtraction, a
// bf16x2 pack) while the previous step's products run, and hands them to
// wgmma m64n256k16 as the register A operand; B is the hidden tile from
// shared memory (128-byte swizzle, as TMA wrote it).  For the 16 contiguous
// bytes of a thread to be exactly its A fragments of the step's four k16
// products, the k order inside each 64-wide k block is permuted, and the wrapper hands the kernel h with its columns
// permuted the same way (ops/fused_loca.py::k10_hidden_layout: logical k
// 16 c + l of a block reads physical column 16 ti + 4 c + m, ti = (l % 8) / 2,
// m = l % 2 + 2 (l / 8)); the dot over k is unchanged.  Tiles are walked with
// the 256-row hidden tiles fastest, so the ~12 blocks on one vocab tile at a
// time read its head rows from device memory once and the 22 MB of hidden
// states stay in L2.  The epilogue scales each accumulator by ws[v] and then
// 1/T and stores it from registers (8 lanes write 32 contiguous bytes);
// meanwhile the producer has the next tile's first stages in flight.
// ptxas gives the kernel 168 registers a thread, which this tile fits with
// no spill; a 256 x 128 tile (20% fewer operand bytes from L2 per product)
// needs ~210 and spilled, with or without setmaxnreg, and ran slower.

#include "kdss_sm90.cuh"

namespace kdss_tmat {

using namespace kdss_sm90;
using bf = __nv_bfloat16;

constexpr int BV = 128, BN = 256, BK = 64, STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int W_BYTES = BV * BK;      // int8 head tile, dense 64-byte rows (conflict-free 16-byte reads)
constexpr int H_BYTES = BN * BK * 2;  // bf16 hidden tile, 128-byte rows, 128-byte swizzle
constexpr int RING = STAGES * (W_BYTES + H_BYTES);
constexpr int SMEM = 1024 + RING + 2 * STAGES * 8;  // alignment slack, the ring, full/empty barriers

// Four int8 (one 32-bit word, byte 0 first) as two packed bf16 pairs:
// bytes 0-1 into `lo`, bytes 2-3 into `hi`, each first in the low half.
// 0x4B000000 | (b + 128) is the float 2^23 + b + 128, exactly.
__device__ __forceinline__ void s8x4_to_bf16(uint32_t x, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = x ^ 0x80808080u;
  constexpr float OFF = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - OFF;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - OFF;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - OFF;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - OFF;
  __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1), b = __floats2bfloat162_rn(f2, f3);
  lo = *reinterpret_cast<uint32_t*>(&a);
  hi = *reinterpret_cast<uint32_t*>(&b);
}

__global__ void __launch_bounds__(THREADS, 1)
    tmat_int8_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap h_map,
                     const float* __restrict__ ws, float* __restrict__ out, int N, int V, int nk, float inv_t) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* h_tiles = smem;                         // STAGES x H_BYTES, each 1024-aligned
  unsigned char* w_tiles = smem + STAGES * H_BYTES;      // STAGES x W_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);                // the producer's arrive with the ring's bytes
      mbar_init(empty + s, CONSUMERS * 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((V + BV - 1) / BV);

  if (wg == CONSUMERS) {  // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = (t % tiles_n) * BN, v0 = (t / tiles_n) * BV;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty + s, phase ^ 1);
          mbar_arrive_expect_tx(full + s, W_BYTES + H_BYTES);
          tma_load_2d(w_tiles + s * W_BYTES, &w_map, full + s, kt * BK, v0);
          tma_load_2d(h_tiles + s * H_BYTES, &h_map, full + s, kt * BK, n0);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroups 0 and 1: vocab rows 64 wg .. 64 wg + 63 of the tile
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int gi = lane >> 2, ti = lane & 3;
    const int row = wg * 64 + warp * 16 + gi;  // and row + 8
    int s = 0;
    uint32_t phase = 0;
    float acc[128];
    // This thread's A fragments of the ring stage `st` (its head rows `row`
    // and `row + 8`, the four k16 products of the stage).
    auto fragments = [&](int st, uint32_t (&a)[4][4]) {
      const unsigned char* wt = w_tiles + st * W_BYTES;
      const uint4 ra = *reinterpret_cast<const uint4*>(wt + row * BK + 16 * ti);
      const uint4 rb = *reinterpret_cast<const uint4*>(wt + (row + 8) * BK + 16 * ti);
      const uint32_t wa[4] = {ra.x, ra.y, ra.z, ra.w}, wb[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s8x4_to_bf16(wa[c], a[c][0], a[c][2]);
        s8x4_to_bf16(wb[c], a[c][1], a[c][3]);
      }
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t % tiles_n) * BN, v0 = (t / tiles_n) * BV;
      uint32_t a[4][4], next[4][4];
      mbar_wait(full + s, phase);
      fragments(s, a);
      for (int kt = 0; kt < nk; ++kt) {
        const uint64_t db = desc_kmajor(h_tiles + s * H_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c) wgmma_m64n256_rs<0>(acc, a[c], db + 2 * c, (kt | c) != 0);
        wgmma_commit();
        // the next stage's head bytes convert while these products run
        const int s1 = s + 1 == STAGES ? 0 : s + 1;
        const uint32_t phase1 = s1 == 0 ? phase ^ 1 : phase;
        if (kt + 1 < nk) {
          mbar_wait(full + s1, phase1);
          fragments(s1, next);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (lane == 0) mbar_arrive(empty + s);
        s = s1;
        phase = phase1;
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) a[c][i] = next[c][i];
      }
      // ((acc * ws) * inv_t), transposed into out [N, V].
      const int va = v0 + row, vb = va + 8;
      const float sa = va < V ? ws[va] : 0.f, sb = vb < V ? ws[vb] : 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 8 * j + 2 * ti + (e & 1);
          const int v = e < 2 ? va : vb;
          if (n < N && v < V)
            out[static_cast<long>(n) * V + v] = __fmul_rn(__fmul_rn(acc[4 * j + e], e < 2 ? sa : sb), inv_t);
        }
      }
    }
  }
}

}  // namespace kdss_tmat

using namespace kdss_tmat;

extern "C" {

// K10.  hp bf16 [N, Dp]: h with its columns zero-padded to Dp (a multiple
// of 64) and permuted inside each 64-column block (see the note above);
// wq int8 [V, D] (row stride D, a multiple of 16, 16-byte aligned), ws f32
// [V], out f32 [N, V].  Returns a cudaError_t (cudaErrorInvalidValue for
// shapes it does not take or a tensor map the driver refuses).
int kdss_tmat_int8(const void* hp, const void* wq, const void* ws, void* out, int N, int V, int D, int Dp,
                   float inv_t, void* stream) {
  if (N <= 0 || V <= 0 || D <= 0 || D % 16 != 0 || Dp % BK != 0 || Dp < D)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap w_map, h_map;
  {
    const uint64_t dims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(V)};
    const uint64_t strides[1] = {static_cast<uint64_t>(D)};
    const uint32_t box[2] = {BK, BV};
    const cudaError_t err = kdss_sm90_host::make_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, dims, strides,
                                                     box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    const uint64_t dims[2] = {static_cast<uint64_t>(Dp), static_cast<uint64_t>(N)};
    const uint64_t strides[1] = {static_cast<uint64_t>(Dp) * 2};
    const uint32_t box[2] = {BK, BN};
    const cudaError_t err = kdss_sm90_host::make_map(&h_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, hp, dims,
                                                     strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tmat_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = static_cast<long>((N + BN - 1) / BN) * ((V + BV - 1) / BV);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  tmat_int8_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      w_map, h_map, static_cast<const float*>(ws), static_cast<float*>(out), N, V, Dp / BK, inv_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
