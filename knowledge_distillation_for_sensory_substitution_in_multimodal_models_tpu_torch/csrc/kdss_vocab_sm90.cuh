// The vocab-streaming core of the fused losses on Hopper (sm_90a): rows of
// hidden states h [N, DM] against a head w [V, DM] (bf16, "vd") whose
// logits S = h w^T are never written to device memory, computed on wgmma
// fed by TMA under mbarriers.  Every fused vocabulary loss runs on it: K11
// and K9 (csrc/fused_loca_ce.cu), the fused CE forward and backward (K5, K6,
// csrc/fused_ce.cu) and the temperature KL forward and backward (K7, K8,
// csrc/fused_kl.cu).
//
// `sweep_kernel<DM, Epi>`: one block per (64 rows, vocab split), three
// warpgroups.  The block's h rows [64, DM] stay in shared memory for the
// whole sweep (DM / 64 boxes, 128-byte swizzle, K-major, loaded once).  The
// producer warpgroup (one thread) streams the head box [128 vocab rows x
// 64] of every k step of every vocab tile of the split through a
// SWEEP_STAGES-deep ring.  The two consumer warpgroups take the split's
// vocab tiles in turns (even and odd), each the whole 64 x 128 logits tile
// (wgmma m64n128k16, both operands from shared memory), two rows a thread,
// so an `Epi` policy keeps its per-row online statistics in registers, as
// a flash-attention forward over a head of width DM does.  The ring is
// filled in tile order and the consumers issue their products in tile
// order too (an order barrier each), so while one warpgroup runs its tile's
// epilogue the other runs the next tile's products (ping-pong), and the
// tensor cores wait on neither.  A consumer asks for its tile's f32 teacher logits
// (streaming loads straight into registers, in the accumulators' layout:
// each warp's load reads eight whole 32-byte sectors) before its products,
// so they arrive while the products run.  Each consumer keeps its own
// statistics: a block writes two partials per split (`split * 2 + wg`).
//
// `gemm_kernel<A_MN, OUT_F32>`: a plain TMA/wgmma product out [M, Nn] =
// A [M, K] B [K, Nn] in 128 x 128 tiles (two consumer warpgroups of
// m64n128, a producer thread, a GEMM_STAGES-deep ring), B stored N-major
// (the head or h, [K rows, Nn] row-major), A stored K-major ([M, K]
// row-major) or, with A_MN, M-major ([K, M] row-major: ds read as ds^T);
// split over K by blockIdx.z into f32 partials, or one bf16 output.  The
// backward's products dh = ds w and dW = ds^T h run on it.  Its `Tag` (the
// loss's ds policy) only names the kernels after the loss whose ds they
// read, so a profile can tell the losses' products apart.
//
// An `Epi` policy (passed by value) has
//   static constexpr bool TEACHER;      // false: no teacher tile is loaded (tmat may be null)
//   struct State;                       // per-thread, two rows
//   __device__ void begin(State&, const int rows[2], int N) const;
//   template <class View>               // TileView<FULL>
//   __device__ void tile(State&, const float (&acc)[64], const View&, const int rows[2],
//                        int N) const;  // acc[4 j + 2 h + c]: row rows[h], column v0 + 8 j + 2 ti + c
//   __device__ void end(State&, const int rows[2], int split, int nsplit, int N, int ti) const;
// View::teacher(j, e) is the teacher logit of acc[4 j + e] (-inf past V;
// read only when TEACHER), View::in(j, e) whether its column is < V.

#pragma once

#include "kdss_sm90.cuh"

namespace kdss_vocab90 {

using namespace kdss_sm90;
using bf = __nv_bfloat16;
using kdss::FULL;
using kdss::LN2;
using kdss::LOG2E;

// The products' tile: 128 rows (two consumer warpgroups of 64) x 128
// columns, 64-wide k steps, the bytes of one ring stage; the sweep's block
// of rows (its h stays in shared memory) and the head box of its ring.
constexpr int BM = 128, BN = 128, BK = 64, CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SWEEP_STAGES = 7, GEMM_STAGES = 5;
constexpr int SWEEP_BM = 64;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BOX64 = 64 * 128;  // a 64-row box of 128-byte rows
template <int DM>
constexpr int sweep_smem() {
  return 1024 + SWEEP_BM * DM * 2 + SWEEP_STAGES * B_BYTES + (1 + 2 * SWEEP_STAGES + CONSUMERS) * 8;
}
constexpr int GEMM_SMEM = 1024 + GEMM_STAGES * STAGE_BYTES + 2 * GEMM_STAGES * 8;

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error ~2^-22, denormal
// results flushed to 0), for the per-logit loops; exp2f adds a denormal
// rescale around the same instruction.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A running maximum as an exp2 base: -inf (nothing seen) shifts by 0, so
// exp2(-inf - 0) = 0 and nothing turns into NaN.
__device__ __forceinline__ float base_of(float m) { return m == -INFINITY ? 0.f : m; }

// d[64] (+)= A (64 x 16) * B (16 x 128), both from shared memory; TA / TB = 1:
// stored M- / N-major (MN-major descriptors), 0: K-major.  scale_d = 0 overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128_ss_t(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// This thread's teacher logits of a vocab tile, in the layout of the
// accumulators (tv[4 j + 2 h + c]: row rows[h], column v0 + 8 j + 2 ti + c),
// -inf past N or V (FULL: the tile ends at or before V).  Streaming loads
// (tmat is read once a sweep): a warp's load reads eight rows x 32
// contiguous bytes.  V % 4 == 0 keeps the pairs 8-byte aligned.
template <bool FULL>
__device__ __forceinline__ void load_teacher(float (&tv)[64], const float* __restrict__ tmat, const int rows[2],
                                             int v0, int N, int V, int ti) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = v0 + 8 * j + 2 * ti;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 x = make_float2(-INFINITY, -INFINITY);
      if (rows[h] < N && (FULL || col < V))
        x = __ldcs(reinterpret_cast<const float2*>(tmat + static_cast<long>(rows[h]) * V + col));
      tv[4 * j + 2 * h] = x.x;
      tv[4 * j + 2 * h + 1] = x.y;
    }
  }
}

// A vocab tile as an epilogue sees it; FULL: every column is < V, so the
// per-logit loops need no mask.
template <bool FULL>
struct TileView {
  const float (&tv)[64];
  int ti, v0, V;

  // acc[4 j + e]: row 16 warp + gi + 8 (e / 2), column v0 + 8 j + 2 ti + (e % 2).
  __device__ __forceinline__ int col(int j, int e) const { return v0 + 8 * j + 2 * ti + (e & 1); }
  __device__ __forceinline__ bool in(int j, int e) const { return FULL || col(j, e) < V; }
  __device__ __forceinline__ float teacher(int j, int e) const { return tv[4 * j + e]; }
};

template <int DM, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    sweep_kernel(const __grid_constant__ CUtensorMap h_map, const __grid_constant__ CUtensorMap w_map,
                 const float* __restrict__ tmat, const Epi epi, int N, int V, int tiles_per_split) {
  static_assert(DM % BK == 0, "the model dim must be a multiple of the k step");
  constexpr int NK = DM / BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* h_rows = aligned_smem(smem_raw);  // NK boxes [64 rows x 64]
  unsigned char* ring = h_rows + NK * BOX64;        // SWEEP_STAGES head boxes [128 vocab rows x 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SWEEP_STAGES * B_BYTES);
  uint64_t* empty = full + SWEEP_STAGES;
  uint64_t* h_full = empty + SWEEP_STAGES;
  uint64_t* order = h_full + 1;  // order[w]: the other consumer has issued its tile's products
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SWEEP_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // one arrival per warp of the consumer that took the stage
    }
    mbar_init(h_full, 1);
    for (int c = 0; c < CONSUMERS; ++c) mbar_init(order + c, 4);
    fence_barrier_init();
  }
  __syncthreads();

  const int n0 = blockIdx.x * SWEEP_BM, split = blockIdx.y, nsplit = gridDim.y;
  const int n_vt = (V + BN - 1) / BN;
  const int t0 = split * tiles_per_split, t1 = min(t0 + tiles_per_split, n_vt);

  if (wg == CONSUMERS) {  // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_arrive_expect_tx(h_full, NK * BOX64);
      for (int kt = 0; kt < NK; ++kt) tma_load_2d(h_rows + kt * BOX64, &h_map, h_full, kt * BK, n0);
      int s = 0;
      uint32_t phase = 0;
      for (int t = t0; t < t1; ++t) {
        for (int kt = 0; kt < NK; ++kt) {
          mbar_wait(empty + s, phase ^ 1);
          mbar_arrive_expect_tx(full + s, B_BYTES);
          tma_load_2d(ring + s * B_BYTES, &w_map, full + s, kt * BK, t * BN);
          if (++s == SWEEP_STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroups: vocab tiles t0 + wg, t0 + wg + 2, ... of the block's 64 rows
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int gi = lane >> 2, ti = lane & 3;
    const int rows[2] = {n0 + 16 * warp + gi, n0 + 16 * warp + gi + 8};
    typename Epi::State st;
    epi.begin(st, rows, N);
    float acc[64], tv[64];
    mbar_wait(h_full, 0);
    for (int i = wg; t0 + i < t1; i += CONSUMERS) {
      const int v0 = (t0 + i) * BN;
      const bool full_tile = v0 + BN <= V;
      if constexpr (Epi::TEACHER) {
        if (full_tile)
          load_teacher<true>(tv, tmat, rows, v0, N, V, ti);
        else
          load_teacher<false>(tv, tmat, rows, v0, N, V, ti);
      }
      // The products of the split's tiles are issued in tile order, the two
      // consumers in turns: a stage's full barrier is then never more than
      // one phase ahead of its waiter (parity tells only adjacent phases).
      if (i > 0) mbar_wait(order + wg, ((i - 1) / CONSUMERS) & 1);
      fence_regs(acc);
      int prev = 0;
      for (int kt = 0; kt < NK; ++kt) {
        const int g = i * NK + kt;  // the stage's place in the ring's sequence
        const int s = g % SWEEP_STAGES;
        mbar_wait(full + s, (g / SWEEP_STAGES) & 1);
        const uint64_t da = desc_kmajor(h_rows + kt * BOX64);
        const uint64_t db = desc_kmajor(ring + s * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n128_ss_t<0, 0>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous k step's products are done: free its stage
        if (kt > 0 && lane == 0) mbar_arrive(empty + prev);
        prev = s;
      }
      if (lane == 0) mbar_arrive(order + (wg ^ 1));  // the other consumer's next tile may start
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + prev);
      if (full_tile)
        epi.tile(st, acc, TileView<true>{tv, ti, v0, V}, rows, N);
      else
        epi.tile(st, acc, TileView<false>{tv, ti, v0, V}, rows, N);
    }
    epi.end(st, rows, split * CONSUMERS + wg, nsplit * CONSUMERS, N, ti);
  }
}

template <bool A_MN, bool OUT_F32, class Tag>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                void* __restrict__ out, int M, int Nn, int K, int ksteps_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + GEMM_STAGES * STAGE_BYTES);
  uint64_t* empty = full + GEMM_STAGES;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GEMM_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int nk = (K + BK - 1) / BK;
  const int k0 = split * ksteps_per_split, k1 = min(k0 + ksteps_per_split, nk);

  if (wg == CONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int kt = k0; kt < k1; ++kt) {
        unsigned char* st = ring + s * STAGE_BYTES;
        mbar_wait(empty + s, phase ^ 1);
        mbar_arrive_expect_tx(full + s, STAGE_BYTES);
        if (A_MN) {  // two boxes [64 k x 64 m], one per consumer
          tma_load_2d(st, &a_map, full + s, m0, kt * BK);
          tma_load_2d(st + BOX64, &a_map, full + s, m0 + 64, kt * BK);
        } else {  // one box [128 m x 64 k]
          tma_load_2d(st, &a_map, full + s, kt * BK, m0);
        }
        tma_load_2d(st + A_BYTES, &b_map, full + s, n0, kt * BK);  // two boxes [64 k x 64 n]
        tma_load_2d(st + A_BYTES + BOX64, &b_map, full + s, n0 + 64, kt * BK);
        if (++s == GEMM_STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int gi = lane >> 2, ti = lane & 3;
    int s = 0, prev = 0;
    uint32_t phase = 0;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int kt = k0; kt < k1; ++kt) {
      mbar_wait(full + s, phase);
      const unsigned char* st = ring + s * STAGE_BYTES;
      // A: K-major, k16 step kk 32 bytes along the row; M-major, 2048 bytes (16 k rows) down the box
      const uint64_t da = A_MN ? desc_nmajor(st + wg * BOX64) : desc_kmajor(st + wg * BOX64);
      const uint64_t db = desc_nmajor_wide(st + A_BYTES, BOX64);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128_ss_t<A_MN ? 1 : 0, 1>(acc, da + (A_MN ? 128 : 2) * kk, db + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > k0 && lane == 0) mbar_arrive(empty + prev);
      prev = s;
      if (++s == GEMM_STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (k1 > k0 && lane == 0) mbar_arrive(empty + prev);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * ti;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * wg + 16 * warp + gi + 8 * h;
        if (m >= M || n >= Nn) continue;
        const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
        if (OUT_F32) {
          float* o = static_cast<float*>(out) + (static_cast<long>(split) * M + m) * Nn + n;
          *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
        } else {
          bf* o = static_cast<bf*>(out) + static_cast<long>(m) * Nn + n;
          *reinterpret_cast<uint32_t*>(o) = kdss::pack_bf16(x0, x1);
        }
      }
    }
  }
}

// dh = the sum of the K splits' f32 partials [nsplit, count], in split order.
template <class Tag>
__global__ void reduce_splits(const float* __restrict__ part, bf* __restrict__ out, long count, int nsplit) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += part[s * count + i];
  out[i] = __float2bfloat16(acc);
}

}  // namespace kdss_vocab90

// ---- host: the tensor maps and launches ------------------------------------

namespace kdss_vocab90_host {

using namespace kdss_vocab90;

// A row-major bf16 [rows, cols] tensor (row stride `ld` elements) in boxes
// of 64 columns (one 128-byte swizzle row) x `box_rows` rows; out-of-range
// boxes load zeros.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, long rows, long cols, long ld, int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(ld) * 2};
  const uint32_t box[2] = {64, static_cast<uint32_t>(box_rows)};
  return kdss_sm90_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// One sweep of h [N, DM] against w [V, DM] with the teacher tmat [N, V]
// under `epi`: grid (N / 64 row blocks, nsplit vocab splits); a forward
// epilogue writes 2 * nsplit partials a row.
template <int DM, class Epi>
cudaError_t sweep(const void* h, const void* w, const float* tmat, const Epi& epi, int N, int V, int nsplit,
                  cudaStream_t st) {
  CUtensorMap h_map, w_map;
  cudaError_t err = bf16_map(&h_map, h, N, DM, DM, SWEEP_BM);
  if (err == cudaSuccess) err = bf16_map(&w_map, w, V, DM, DM, BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_kernel<DM, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, sweep_smem<DM>());
  if (err != cudaSuccess) return err;
  const int n_vt = (V + BN - 1) / BN;
  const int per = (n_vt + nsplit - 1) / nsplit;
  sweep_kernel<DM, Epi><<<dim3((N + SWEEP_BM - 1) / SWEEP_BM, nsplit), THREADS, sweep_smem<DM>(), st>>>(
      h_map, w_map, tmat, epi, N, V, per);
  return cudaGetLastError();
}

// out [M, Nn] (f32 partials [nsplit, M, Nn], or bf16 with nsplit = 1) =
// A B over K, from the maps' boxes (see gemm_kernel).
template <bool A_MN, bool OUT_F32, class Tag>
cudaError_t gemm(const CUtensorMap& a_map, const CUtensorMap& b_map, void* out, int M, int Nn, int K, int nsplit,
                 cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(gemm_kernel<A_MN, OUT_F32, Tag>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const int nk = (K + BK - 1) / BK;
  const int per = (nk + nsplit - 1) / nsplit;
  gemm_kernel<A_MN, OUT_F32, Tag><<<dim3((Nn + BN - 1) / BN, (M + BM - 1) / BM, nsplit), THREADS, GEMM_SMEM, st>>>(
      a_map, b_map, out, M, Nn, K, per);
  return cudaGetLastError();
}

// The backward's two products from the bf16 d_logits ds [N, V] (row stride
// ld_ds): dh [N, DM] = ds w through f32 partials [nsplit, N, DM] summed in
// split order, and, unless dw is null, dW [V, DM] = ds^T h; `Tag` names the
// kernels (see gemm_kernel).
template <int DM, class Tag>
cudaError_t ds_products(const void* h, const void* w, const void* ds, long ld_ds, float* dh_part, bf* dh, bf* dw,
                        int N, int V, int nsplit, cudaStream_t st) {
  CUtensorMap a_map, b_map;
  cudaError_t err = bf16_map(&a_map, ds, N, V, ld_ds, BM);  // [128 rows x 64 vocab] boxes, K-major
  if (err == cudaSuccess) err = bf16_map(&b_map, w, V, DM, DM, 64);
  if (err == cudaSuccess) err = gemm<false, true, Tag>(a_map, b_map, dh_part, N, DM, V, nsplit, st);
  if (err != cudaSuccess) return err;
  const long count = static_cast<long>(N) * DM;
  reduce_splits<Tag><<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(dh_part, dh, count, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || dw == nullptr) return err;
  err = bf16_map(&a_map, ds, N, V, ld_ds, 64);  // [64 rows x 64 vocab] boxes, read M-major
  if (err == cudaSuccess) err = bf16_map(&b_map, h, N, DM, DM, 64);
  if (err == cudaSuccess) err = gemm<true, false, Tag>(a_map, b_map, dw, V, DM, N, 1, st);
  return err;
}

}  // namespace kdss_vocab90_host
