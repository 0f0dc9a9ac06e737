// The causal grouped-query flash forward at head dims 64 and 128 for Hopper
// (sm_90a), redesigned around wgmma fed by TMA under mbarriers: out =
// softmax(s Q K^T) V in bf16 with an exact online softmax in f32, and
// optionally the natural-log row logsumexp.  K3 (flash_fwd_gqa_d64.cu,
// flash_fwd_gqa_d128.cu, routed by flash_fwd.cu) instantiates it at
// ARM_FULL; K13's phase-ablation arms (flash_phase_ablation*.cu) are its
// template parameter ARM, so K13's `full` arm is K3's kernel.
//
// Replaces the Pallas TPU kernel K3 of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/
// ops/flash_attention.py): `flash_attention_gqa` -> `_flash_gqa` ->
// `_flash_gqa_fwd_impl` (kernels `_gqa_fwd_kernel`, `_gqa_fwd_kernel_stream`
// + `_gqa_rowmax_kernel`, `_gqa_fwd_kernel_sbound`, `_gqa_fwd_kernel_ilp`;
// the TPU-only variants are not carried over), the Qwen2 prefill of the
// 0.5B student (14 q / 2 kv heads, d = 64) and of the frozen 7B teacher (28
// q / 4 kv heads, d = 128); and K13, the JAX script
// scripts/flash_phase_ablation.py's `_variant_kernel` (:375) and
// `_streaming_smem_kernel` (:336).  The function: q [B, Sq, Hq, D], k/v [B,
// Skv, Hkv, D] bf16 contiguous, kv_mask uint8 [B, Skv] or null, causality
// top-left aligned (query row i attends key j iff i >= j), K/V read by kv
// head h / G; a row with no valid key outputs zeros and lse -inf; lse f32
// [B, Hq, Sq] written only when the caller passes it (training: K4 reads it).
//
// What bounds it on the H100: 4 x (attended pairs) x Hq x D operations, 17
// GFLOP at the student's prefill (0.017 ms at the bf16 peak) and 68 GFLOP at
// the teacher's (0.068 ms), against 3-15 MB of operands: operations.  The
// mma.sync kernel it replaces copied each tile synchronously before its
// products and fed the tensor cores from registers; K13's ablation of it
// showed it kept 89-95% of its time with no softmax at all: the time was in
// the operand path.
//
// Design (flash_fwd_sm90.cu's, K1 at d = 72, at these widths): a persistent
// kernel, one block an SM, WGS consumer warpgroups of 64 q rows each and one
// producer warp.  The producer takes the block's next (BQ-row q tile, q
// head, batch) tile from a counter in device memory (atomicAdd; the first
// one is blockIdx.x), longest first under causality, so a block that drew
// short tiles draws more (the causal tiles of one launch differ 16-fold in
// length); the q heads of one kv head are next to each other in that order,
// so their K/V tiles are read from L2.  It loads each tile's q by TMA into
// one of two q buffers and streams the K and V tiles (and their kv-mask
// bytes) through a STAGES-deep ring under mbarriers, across tile
// boundaries.  A row of 64 bf16 is one 128-byte swizzle row: at d = 64 a
// tile is one TMA box, at d = 128 two (columns 0-63, 64-127; the
// kdss_sm90.cuh layout).  Each consumer computes S = Q K^T with wgmma from
// shared memory (D / 16 k16 steps), masks without branches (ptxas
// serializes wgmma when a mask writes accumulators in a branch), runs the
// online softmax in registers (log2 domain, the scale folded into one FFMA
// before exp2), packs P to bf16 as the register A operand and accumulates O
// += P V with wgmma at n = D, V read N-major.  Under causality a warpgroup
// stops at the last kv tile that reaches its own 64 rows and only releases
// the rest of its tile's stages.  Registers cap the shape: ptxas gives each
// of an SM's four sub-partitions an equal share, 128 registers a thread at
// 416 threads and 168 at 288, and a d = 128 warpgroup's O alone takes 64;
// Shape below is the block at each width (PERF.md: the sweep).
#pragma once

#include "kdss_sm90.cuh"

namespace kdss_gqa90 {

using namespace kdss_sm90;
using bf = __nv_bfloat16;
using kdss::FULL;
using kdss::LN2;
using kdss::LOG2E;

// K13, the phase-ablation arms of the JAX script scripts/flash_phase_ablation.py
// (`_variant_kernel`, `_streaming_smem_kernel`): each keeps this kernel's
// schedule, tiles and memory traffic and drops or replaces one phase of the
// online softmax, so that differences of times attribute cost per phase.
// ARM_FULL is K3 itself.  The order is ops/flash_phase_ablation.py's ARMS.
// The script's arms are defined on natural-log quantities; the arms keep
// scores in the log2 domain (x2 = s * scale * log2 e), so each natural-log
// constant c enters as c * LOG2E and each linear map of a natural-log
// argument x = x2 * LN2 takes that factor (see `arm_exp`).  Every other arm
// starts its running max at -1e30 nats, as the script's `_variant_kernel`
// does, and ends with out = acc / (l == 0 ? 1 : l), as acc times one
// reciprocal a row.  No tile that a warpgroup visits leaves one of its rows
// without a valid key (causal, no kv mask, 64-row warpgroups starting at
// multiples of 64 and kv tiles at multiples of BK), so the script's
// `where(m_new > -5e29, p, 0)` selects p everywhere and is not emitted.
enum Arm {
  ARM_FULL = 0,
  ARM_NOEXP,           // exp(x) -> 0.125 x in both softmax exps
  ARM_NORED,           // row max, row sum and the alpha rescale -> constants; p = exp(s 1e-4)
  ARM_NOMAX,           // the row max -> the constant 4
  ARM_NOSUM,           // the row sum -> 1
  ARM_NOSUB,           // p = exp(s 1e-2): no subtraction of the running max
  ARM_NOALPHA,         // no alpha rescale of l and acc
  ARM_NOSTOREM,        // the running max is not stored (m <- m * 1.0000001)
  ARM_NOMAXSUM,        // ARM_NOMAX and ARM_NOSUM together
  ARM_REDONLY,         // both reductions kept and folded into l, the recurrence cut
  ARM_LOCAL,           // tile-local softmax, merged after the PV product
  ARM_BOUND,           // the shift from |q| and the tile's max |k|, merged as ARM_LOCAL
  ARM_STREAMING,       // one global shift of 4: no rescale at all
  ARM_STREAMING_ROWM,  // a per-row shift from |q| and a global |k| bound of 20
  ARM_STREAMING_SMEM,  // ARM_STREAMING with the shift read from device memory
  ARM_MXU,             // p = s: no softmax at all
  ARM_N_ARMS
};

// The softmax exp of an arm, on a log2-domain argument x2: exp(x2 ln 2) is
// exp2(x2); ARM_NOEXP's 0.125 x of the natural-log argument is 0.125 ln 2 x2.
template <int ARM>
__device__ __forceinline__ float arm_exp(float x2) {
  if constexpr (ARM == ARM_NOEXP)
    return (0.125f * LN2) * x2;
  else
    return exp2f(x2);
}

// The block at head dim D: WGS consumer warpgroups of 64 q rows, kv tiles of
// BK rows, a ring of STAGES K/V stages (scripts/torch_kernel_sweep.py timed
// the others: PERF.md).  At d = 128 the 128-row kv tile halves the softmax's
// per-tile overhead and fills shared memory with two stages (two q buffers
// and the ring: 192 KB); its 160 accumulator and fragment registers meet the
// 168 cap with a 16-byte spill.
template <int D>
struct Shape;
template <>
struct Shape<64> {
  static constexpr int WGS = 3, BK = 64, STAGES = 4;
};
template <>
struct Shape<128> {
  static constexpr int WGS = 2, BK = 128, STAGES = 2;
};

template <int D>
struct Cfg {
  static constexpr int WGS = Shape<D>::WGS, BK = Shape<D>::BK, STAGES = Shape<D>::STAGES;
  static constexpr int NB = D / 64;                 // 64-column boxes of a row
  static constexpr int BQ = 64 * WGS;               // q rows of a tile
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;    // and one producer warp
  static constexpr int QBOX = BQ * 128, QBYTES = NB * QBOX;    // a q tile: box 0 of BQ rows, then box 1
  static constexpr int KVBOX = BK * 128, KVTILE = NB * KVBOX;  // a K or V tile
  // Shared memory: two q buffers, the K/V ring, the ring's kv-mask bytes,
  // ARM_BOUND's per-warp maxima, the two buffers' tile indices, the barriers.
  static constexpr int RING = 2 * QBYTES;
  static constexpr int MASK = RING + STAGES * 2 * KVTILE;
  static constexpr int RED = MASK + STAGES * BK;
  static constexpr int TILE_ID = RED + WGS * 4 * 4;
  static constexpr int BARS = TILE_ID + 16;
  static constexpr int BYTES = BARS + (4 + 2 * STAGES) * 8;  // q_full[2], q_empty[2], full[STAGES], empty[STAGES]
  static constexpr int SMEM = BYTES + 1024;                  // alignment slack
  static_assert(BK == 64 || BK == 128, "kv tiles of 64 or 128 rows");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

struct Maps {
  CUtensorMap q, k, v;
};

// The q tile at index t of the longest-first order: head h of batch b from
// row q0, and the kv tiles the tile needs.  The q heads of one kv head are
// consecutive (h fastest).
struct Tile {
  int h, b, q0, n_kv;
};

template <int D, bool CAUSAL>
__device__ __forceinline__ Tile tile_at(int t, int Sq, int Skv, int Hq, int B) {
  using C = Cfg<D>;
  const int n_qt = (Sq + C::BQ - 1) / C::BQ;
  Tile x;
  x.q0 = (n_qt - 1 - t / (Hq * B)) * C::BQ;
  x.h = t % Hq;
  x.b = t / Hq % B;
  x.n_kv = (Skv + C::BK - 1) / C::BK;
  if (CAUSAL) x.n_kv = min(x.n_kv, (x.q0 + C::BQ - 1) / C::BK + 1);
  return x;
}

// bar.sync on a named barrier of the 128 threads of one warpgroup.
__device__ __forceinline__ void wg_sync(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// S = Q K^T (64 x BK): the warpgroup's q rows at qa (box b at qa + b QBOX)
// against the K tile at ks (box b at ks + b KVBOX), both K-major; D / 16
// k16 steps, 4 a box.  Issues the wgmmas only.
template <int D>
__device__ __forceinline__ void qk(float (&st)[Cfg<D>::BK / 2], const unsigned char* qa, const unsigned char* ks) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = desc_kmajor(qa + (kk / 4) * C::QBOX) + 2 * (kk % 4);
    const uint64_t db = desc_kmajor(ks + (kk / 4) * C::KVBOX) + 2 * (kk % 4);
    if constexpr (C::BK == 64)
      wgmma_m64n64_ss(st, da, db, kk > 0);
    else
      wgmma_m64n128_ss(st, da, db, kk > 0);
  }
}

// acc += P V (64 x D) over the BK kv rows: P the bf16 fragments pa[kk] of
// kv columns 16 kk .. 16 kk + 15, V the tile at vs read N-major (at d = 128
// over both boxes, the leading byte offset the box distance).  Issues the
// wgmmas only.
template <int D>
__device__ __forceinline__ void pv(float (&acc)[D / 2], uint32_t (&pa)[Cfg<D>::BK / 16][4], const unsigned char* vs) {
  using C = Cfg<D>;
  const uint64_t db = D == 64 ? desc_nmajor(vs) : desc_nmajor_wide(vs, C::KVBOX);
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    if constexpr (D == 64)
      wgmma_m64n64_rs<1>(acc, pa[kk], db + 128 * kk, 1);
    else
      wgmma_m64n128_rs<1>(acc, pa[kk], db + 128 * kk, 1);
  }
}

// The sum of squares of one row of `nb` 128-byte boxes `box` bytes apart
// (the swizzle permutes 16-byte chunks within a row, so a whole row's sum
// reads it in any order): |q|^2 of a q row, |k|^2 of a key.
__device__ __forceinline__ float row_sq(const unsigned char* row, int nb, int box, int c0, int c1) {
  float ss = 0.f;
  for (int b = 0; b < nb; ++b)
    for (int c = c0; c < c1; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + b * box + 16 * c);
      const bf* e = reinterpret_cast<const bf*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = __bfloat162float(e[i]);
        ss += x * x;
      }
    }
  return ss;
}

template <int D, bool CAUSAL, bool MASK, int ARM = ARM_FULL>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    fwd_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ kv_mask, bf* __restrict__ out,
               float* __restrict__ lse, int* __restrict__ next_tile, int B, int Sq, int Skv, int Hq, int Hkv,
               int n_tiles, float scale_log2, const float* __restrict__ shift) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, STAGES = C::STAGES, CONSUMERS = C::CONSUMERS, NB = C::NB;
  constexpr int NJ = BK / 8, NO = D / 2;  // n8 column blocks of S; O accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t *q_full = bars, *q_empty = bars + 2, *full = bars + 4, *empty = bars + 4 + STAGES;
  volatile int* tile_id = reinterpret_cast<int*>(smem + C::TILE_ID);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, CONSUMERS / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 32);                 // the producer warp's lanes, lane 0 with the tiles' bytes
      mbar_init(empty + s, CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int group = Hq / Hkv;

  if (threadIdx.x >= CONSUMERS) {  // producer warp: each tile's q, then its K/V tiles through the ring
    const int lane = threadIdx.x - CONSUMERS;
    int s = 0;
    uint32_t phase = 0;
    for (int it = 0;; ++it) {
      int t = 0;
      if (lane == 0)
        t = it == 0 ? static_cast<int>(blockIdx.x) : static_cast<int>(gridDim.x) + atomicAdd(next_tile, 1);
      t = __shfl_sync(FULL, t, 0);
      const int qb = it & 1;
      const Tile x = tile_at<D, CAUSAL>(min(t, n_tiles - 1), Sq, Skv, Hq, B);
      if (lane == 0) {
        mbar_wait(q_empty + qb, ((it >> 1) & 1) ^ 1);
        tile_id[qb] = t;
        if (t < n_tiles) {
          mbar_arrive_expect_tx(q_full + qb, C::QBYTES);
#pragma unroll
          for (int b = 0; b < NB; ++b)
            tma_load_4d(smem + qb * C::QBYTES + b * C::QBOX, &maps.q, q_full + qb, 64 * b, x.h, x.q0, x.b);
        } else {
          mbar_arrive(q_full + qb);  // no tile left: the consumers stop
        }
      }
      if (t >= n_tiles) break;
      for (int j = 0; j < x.n_kv; ++j) {
        const int k0 = j * BK;
        uint8_t keep[BK / 32];  // this lane's mask bytes, read before the wait
        if (MASK) {
#pragma unroll
          for (int i = 0; i < BK / 32; ++i) {
            const int col = k0 + lane + 32 * i;
            keep[i] = col < Skv && kv_mask[static_cast<long>(x.b) * Skv + col] != 0;
          }
        }
        mbar_wait(empty + s, phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + s, 2 * C::KVTILE);
          unsigned char* ring = smem + C::RING + s * 2 * C::KVTILE;
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            tma_load_4d(ring + b * C::KVBOX, &maps.k, full + s, 64 * b, x.h / group, k0, x.b);
            tma_load_4d(ring + C::KVTILE + b * C::KVBOX, &maps.v, full + s, 64 * b, x.h / group, k0, x.b);
          }
        }
        if (MASK) {
          uint8_t* ms = smem + C::MASK + s * BK;
#pragma unroll
          for (int i = 0; i < BK / 32; ++i) ms[lane + 32 * i] = keep[i];
        }
        mbar_arrive(full + s);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows q0 + 64 wg + 16 warp + gi (+ 8) of each tile
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  // K13 state: the scale in nats, and the shift read from device memory
  // (ARM_STREAMING_SMEM), in log2 units.
  [[maybe_unused]] const float scale = scale_log2 * LN2;
  [[maybe_unused]] float c2 = 0.f;
  if constexpr (ARM == ARM_STREAMING_SMEM) c2 = *shift * LOG2E;
  int s = 0;
  uint32_t phase = 0;
  for (int it = 0;; ++it) {
    const int qb = it & 1;
    mbar_wait(q_full + qb, (it >> 1) & 1);
    const int t = tile_id[qb];
    if (t >= n_tiles) break;
    const Tile x = tile_at<D, CAUSAL>(t, Sq, Skv, Hq, B);
    const int r0 = x.q0 + 64 * wg;
    const int row[2] = {r0 + 16 * warp + gi, r0 + 16 * warp + gi + 8};
    // the kv tiles that reach this warpgroup's rows; the rest are released unread
    int n_own = r0 < Sq ? x.n_kv : 0;
    if (CAUSAL) n_own = min(n_own, (r0 + 63) / BK + 1);
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // per-thread partial row sums; quad-reduced at the end
    const unsigned char* qa = smem + qb * C::QBYTES + wg * 64 * 128;
    // K13: each row's |q| (ARM_STREAMING_ROWM, ARM_BOUND)
    [[maybe_unused]] float qn[2] = {0.f, 0.f};
    if constexpr (ARM != ARM_FULL) m[0] = m[1] = -1e30f * LOG2E;
    if constexpr (ARM == ARM_STREAMING_ROWM || ARM == ARM_BOUND) {
#pragma unroll
      for (int i = 0; i < 2; ++i) qn[i] = sqrtf(row_sq(qa + (16 * warp + gi + 8 * i) * 128, NB, C::QBOX, 0, 8));
    }

    for (int j = 0; j < n_own; ++j) {
      const int k0 = j * BK;
      mbar_wait(full + s, phase);
      const unsigned char* ks = smem + C::RING + s * 2 * C::KVTILE;
      const uint8_t* ms = smem + C::MASK + s * BK;

      float st[BK / 2];  // S = Q K^T: q rows x kv columns
      wgmma_fence();
      qk<D>(st, qa, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);

      // Masking without branches: key column c of row r is valid iff c <
      // lim[r] (the tile's end, and under causality the row's diagonal)
      // and, with a kv mask, its byte is set.
      int lim[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lim[i] = Skv - k0;
        if (CAUSAL) lim[i] = min(lim[i], row[i] - k0 + 1);
        lim[i] -= 2 * ti;
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = 8 * jj + (e & 1) < lim[e >> 1];
          if (MASK) ok = ok && ms[8 * jj + 2 * ti + (e & 1)] != 0;
          st[4 * jj + e] = ok ? st[4 * jj + e] : -INFINITY;
        }
      }

      // O (+)= P V into `acc`, P = st packed to bf16.
      auto pv_into = [&](float (&acc)[NO]) {
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) a_frag(pa[kk], st, kk);
        wgmma_fence();
        pv<D>(acc, pa, ks + C::KVTILE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_frags(pa);
      };

      if constexpr (ARM == ARM_FULL) {
        // The online softmax.  The running max is kept in the log2 domain;
        // the scale is positive, so the max of the raw scores scales to the
        // max of the scaled ones, and p = exp2(s * scale_log2 - m) is one
        // FFMA and one exp2.
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], st[i]);
        float alpha[2], base[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
          mx[i] = fmaxf(m[i], mx[i] * scale_log2);
          // A row with no valid key yet keeps m = -inf; shift by 0 so that
          // exp2(-inf - 0) = 0 and nothing turns into NaN.
          base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
          alpha[i] = exp2f(m[i] - base[i]);
          m[i] = mx[i];
          l[i] *= alpha[i];
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          st[i] = exp2f(fmaf(st[i], scale_log2, -base[(i >> 1) & 1]));
          l[(i >> 1) & 1] += st[i];
        }
#pragma unroll
        for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
        pv_into(o);
      } else {
        // K13's arms, on log2-domain scores x = s * scale_log2.
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) st[i] *= scale_log2;
        // Each row's max of this tile and of mx's values (log2 units), over the quad.
        auto row_max = [&](float (&mx)[2]) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], st[i]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
          }
        };
        // p = f(s, row) in place; adds each row's sum to `sum`.
        auto map_p = [&](auto f, float (&sum)[2]) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            st[i] = f(st[i], (i >> 1) & 1);
            sum[(i >> 1) & 1] += st[i];
          }
        };
        auto rescale = [&](float (&acc)[NO], const float (&a)[2]) {
#pragma unroll
          for (int i = 0; i < NO; ++i) acc[i] *= a[(i >> 1) & 1];
        };

        if constexpr (ARM == ARM_MXU) {
          // p = s, the natural-log score, straight into the PV product
          float unused[2] = {0.f, 0.f};
          map_p([](float v, int) { return v * LN2; }, unused);
          pv_into(o);
        } else if constexpr (ARM == ARM_NORED) {
          float unused[2] = {0.f, 0.f};
          map_p([](float v, int) { return exp2f(v * 1e-4f); }, unused);
          if (ti == 0) l[0] += 1.f, l[1] += 1.f;  // once per row: l is summed over the quad
          pv_into(o);
        } else if constexpr (ARM == ARM_STREAMING || ARM == ARM_STREAMING_SMEM) {
          const float c = ARM == ARM_STREAMING ? 4.f * LOG2E : c2;
          map_p([c](float v, int) { return exp2f(v - c); }, l);
          pv_into(o);
          if constexpr (ARM == ARM_STREAMING) m[0] = m[1] = 4.f * LOG2E;
        } else if constexpr (ARM == ARM_STREAMING_ROWM) {
          float mj[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) mj[i] = (qn[i] * (20.f * scale) - 20.f) * LOG2E;
          map_p([&mj](float v, int i) { return exp2f(v - mj[i]); }, l);
          pv_into(o);
          m[0] = mj[0], m[1] = mj[1];
        } else if constexpr (ARM == ARM_LOCAL || ARM == ARM_BOUND) {
          float mj[2];
          if constexpr (ARM == ARM_LOCAL) {
            mj[0] = mj[1] = -INFINITY;
            row_max(mj);
          } else {
            // the tile's max |k|^2: 128 / BK threads a key row, then over the
            // warpgroup through shared memory
            float* red = reinterpret_cast<float*>(smem + C::RED) + 4 * wg;
            constexpr int TPR = 128 / BK;  // threads a key row
            const int tid = threadIdx.x % 128, kr = tid / TPR, part = tid % TPR;
            float ss = row_sq(ks + kr * 128, NB, C::KVBOX, part * 8 / TPR, (part + 1) * 8 / TPR);
            if constexpr (TPR == 2) ss += __shfl_xor_sync(FULL, ss, 1);
#pragma unroll
            for (int w = TPR; w < 32; w <<= 1) ss = fmaxf(ss, __shfl_xor_sync(FULL, ss, w));
            if (lane == 0) red[warp] = ss;
            wg_sync(1 + wg);
            const float kn2 = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
            wg_sync(1 + wg);  // every warp has read red before the next tile writes it
#pragma unroll
            for (int i = 0; i < 2; ++i) mj[i] = (qn[i] * (sqrtf(kn2) * scale) - 40.f) * LOG2E;
          }
          float base[2], lj[2] = {0.f, 0.f}, mn[2], ap[2], aj[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) base[i] = mj[i] == -INFINITY ? 0.f : mj[i];  // p = 0 in a dead row
          map_p([&base](float v, int i) { return exp2f(v - base[i]); }, lj);
          float oj[NO];
#pragma unroll
          for (int i = 0; i < NO; ++i) oj[i] = 0.f;
          pv_into(oj);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mn[i] = fmaxf(m[i], mj[i]);
            ap[i] = exp2f(m[i] - mn[i]);
            aj[i] = exp2f(mj[i] - mn[i]);
            l[i] = l[i] * ap[i] + lj[i] * aj[i];
            m[i] = mn[i];
          }
#pragma unroll
          for (int i = 0; i < NO; ++i) o[i] = o[i] * ap[(i >> 1) & 1] + oj[i] * aj[(i >> 1) & 1];
        } else {
          // The script's default body (ARM_NOEXP, ARM_NOMAX, ARM_NOSUM, ARM_NOSUB, ARM_NOALPHA,
          // ARM_NOSTOREM, ARM_NOMAXSUM, ARM_REDONLY): m_new, p, alpha, l, acc, m.
          float mn[2];
          if constexpr (ARM == ARM_NOMAX || ARM == ARM_NOMAXSUM) {
            mn[0] = fmaxf(m[0], 4.f * LOG2E);
            mn[1] = fmaxf(m[1], 4.f * LOG2E);
          } else {
            mn[0] = m[0], mn[1] = m[1];
            row_max(mn);
          }
          float psum[2] = {0.f, 0.f};
          if constexpr (ARM == ARM_NOSUB || ARM == ARM_REDONLY) {
            map_p([](float v, int) { return exp2f(v * 1e-2f); }, psum);
          } else {
            map_p([&mn](float v, int i) { return arm_exp<ARM>(v - mn[i]); }, psum);
          }
          if constexpr (ARM == ARM_REDONLY) {
            // both reductions consumed into l; m is never updated
            if (ti == 0) psum[0] += mn[0] * LN2 * 1e-9f, psum[1] += mn[1] * LN2 * 1e-9f;
            l[0] += psum[0], l[1] += psum[1];
            pv_into(o);
          } else {
            float alpha[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              alpha[i] = arm_exp<ARM>(m[i] - mn[i]);
              // ARM_NOSUM: the row sum is the constant 1 (added once per row)
              if constexpr (ARM == ARM_NOSUM || ARM == ARM_NOMAXSUM) psum[i] = ti == 0 ? alpha[i] * 0.f + 1.f : 0.f;
              if constexpr (ARM == ARM_NOALPHA)
                l[i] += psum[i];
              else
                l[i] = l[i] * alpha[i] + psum[i];
              if constexpr (ARM == ARM_NOSTOREM)
                m[i] = m[i] * 1.0000001f;
              else
                m[i] = mn[i];
            }
            if constexpr (ARM != ARM_NOALPHA) rescale(o, alpha);
            pv_into(o);
          }
        }
      }
      if (lane == 0) mbar_arrive(empty + s);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    for (int j = n_own; j < x.n_kv; ++j) {  // the tile's stages past this warpgroup's rows
      mbar_wait(full + s, phase);
      if (lane == 0) mbar_arrive(empty + s);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    if (lane == 0) mbar_arrive(q_empty + qb);  // the next tile but one may load its q here

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lt = l[i];
      lt += __shfl_xor_sync(FULL, lt, 1);
      lt += __shfl_xor_sync(FULL, lt, 2);
      if constexpr (ARM == ARM_FULL) {
        inv[i] = lt > 0.f ? 1.f / lt : 0.f;  // no valid key -> zeros
        if (lse != nullptr && ti == 0 && row[i] < Sq)
          lse[(static_cast<long>(x.b) * Hq + x.h) * Sq + row[i]] = lt > 0.f ? (m[i] + log2f(lt)) * LN2 : -INFINITY;
      } else {
        inv[i] = 1.f / (lt == 0.f ? 1.f : lt);  // the script's acc / l_safe, as one reciprocal
      }
    }
    const long qstride = static_cast<long>(Hq) * D;
    bf* ob = out + (static_cast<long>(x.b) * Sq * Hq + x.h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= Sq) continue;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(ob + row[r] * qstride + 8 * jj + 2 * ti) =
            kdss::pack_bf16(o[4 * jj + 2 * r] * inv[r], o[4 * jj + 2 * r + 1] * inv[r]);
    }
  }
}

}  // namespace kdss_gqa90

namespace kdss_gqa90_host {

// A rank-4 map of x [B, S, H, D] bf16 (contiguous, 16-byte aligned): dims
// {D, H, S, B}, a box of 64 columns x `rows` rows of one head (two boxes a
// row at D = 128).  Rows are H x D x 2 bytes apart, a multiple of 16 as TMA
// needs; ops/flash_attention.py::tma_head_map states the same map.
inline cudaError_t head_map(CUtensorMap* map, const void* x, int B, int S, int H, int D, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(H), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t row = static_cast<uint64_t>(D) * 2;
  const uint64_t strides[3] = {row, row * H, row * H * S};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return kdss_sm90_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launch fwd_kernel<D, CAUSAL, MASK, ARM>: q [B, Sq, Hq, D], k/v [B, Skv, Hkv,
// D], kv_mask uint8 [B, Skv] or null, out like q, lse f32 [B, Hq, Sq] or
// null, next_tile one int of device memory (set to 0 here, on the stream),
// shift one f32 of device memory (ARM_STREAMING_SMEM) or null.
template <int D, bool CAUSAL, bool MASK, int ARM>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_mask, void* out, float* lse,
                   int* next_tile, int B, int Sq, int Skv, int Hq, int Hkv, float scale_log2, const float* shift,
                   cudaStream_t st) {
  using namespace kdss_gqa90;
  using C = Cfg<D>;
  Maps maps;
  cudaError_t err = head_map(&maps.q, q, B, Sq, Hq, D, C::BQ);
  if (err == cudaSuccess) err = head_map(&maps.k, k, B, Skv, Hkv, D, C::BK);
  if (err == cudaSuccess) err = head_map(&maps.v, v, B, Skv, Hkv, D, C::BK);
  auto kernel = fwd_kernel<D, CAUSAL, MASK, ARM>;
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(next_tile, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  const long n_tiles = static_cast<long>((Sq + C::BQ - 1) / C::BQ) * Hq * B;
  if (n_tiles > (1L << 30)) return cudaErrorInvalidValue;
  const int grid = n_tiles < sms ? static_cast<int>(n_tiles) : sms;
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(
      maps, static_cast<const uint8_t*>(kv_mask), static_cast<bf*>(out), lse, next_tile, B, Sq, Skv, Hq, Hkv,
      static_cast<int>(n_tiles), scale_log2, shift);
  return cudaGetLastError();
}

}  // namespace kdss_gqa90_host
