// The flash-attention forward at head dim 72 for Hopper (sm_90a), redesigned
// around wgmma and TMA: out = softmax(s Q K^T) V in bf16 with an exact online
// softmax in f32, and optionally the natural-log row logsumexp.
// flash_fwd.cu routes D = 72 here; D = 64 and 128 (K3) run the wgmma/TMA
// kernel of flash_gqa_sm90.cuh, which K13's arms share.
//
// Replaces the Pallas TPU kernel K1 of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/
// ops/flash_attention.py): `flash_attention` -> `_flash` -> `_flash_fwd_impl`
// (kernel `_fwd_kernel`; its TPU-only stream and scalar-bound variants are
// not carried over), the non-causal MHA of every SigLIP layer: 10 anyres
// tiles x 729 tokens, 16 heads, d = 72.  The function is flash_fwd.cu's:
// q [B, Sq, Hq, 72], k/v [B, Skv, Hkv, 72] bf16 contiguous, kv_mask uint8
// [B, Skv] or null, causality top-left aligned, K/V read by kv head h / G; a
// row with no valid key outputs zeros and lse -inf; lse f32 [B, Hq, Sq] is
// written only when the caller passes it (the backward's input).
//
// What bounds it on the H100: 4 x pairs x Hq x 72 operations, 24.5 GFLOP at
// the SigLIP shape, 0.025 ms at the bf16 peak, against 8.4 MB of operands
// (0.0025 ms): operations.  The mma.sync kernel it replaces copied each tile
// synchronously before its products (no load overlapped a product), read
// every operand through registers, and computed 80 columns for 72 on both
// products.  At S = 729 a q tile meets only 12 kv tiles, so what a tile
// costs besides its products (loading q, the first K/V tiles, the epilogue)
// weighs as much as the products' rate.
//
// Design: a persistent kernel, one block an SM walking the (192-row q tile,
// q head, batch) tiles in turn, longest first under causality: three
// consumer warpgroups of 64 q rows each and one producer warp.  The
// producer loads each tile's q by TMA into one of two q buffers (the next
// tile's q lands while the current tile runs) and streams the K and V tiles
// (and, with a kv mask, their mask bytes, read before it waits for the
// stage) through a 4-stage ring under mbarriers, across tile boundaries, so
// one tile's epilogue overlaps the next tile's loads.  Each consumer
// computes S = Q K^T with wgmma m64n64k16 from shared memory (five k16 steps
// over d, flash_d72_sm90.cuh), masks without branches and runs the online
// softmax (log2 domain, the scale folded into one FFMA before exp2) on the
// accumulators in registers, packs P to bf16 as the register A operand and
// accumulates O += P V with wgmma m64n72k16, V read N-major over its two
// boxes, so the N = d side computes exactly 72 columns.  Three warpgroups
// share each K/V tile (a third of the ring's traffic per q row against
// 64-row blocks).  Under causality the kv tiles wholly above a tile's last
// row are not loaded.  In a sweep on the H100 (PERF.md), 2 blocks an
// SM of 2 warpgroups, 1 or 4 warpgroups, q in registers, overlapping the
// softmax with the previous tile's P V, and ping-pong scheduling between
// the warpgroups were each slower than this shape, and persistence faster.

#include "flash_d72_sm90.cuh"

namespace kdss_fwd90 {

using namespace kdss_d72;
using kdss::LN2;
using kdss::FULL;

// The block's shape: WGS consumer warpgroups of 64 q rows each and a ring of
// STAGES K/V stages, one block an SM.
struct Cfg {
  static constexpr int WGS = 3, STAGES = 4;
  static constexpr int BQ = 64 * WGS;              // q rows of a tile
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
  static constexpr int QBYTES = 2 * BQ * 128;      // a q tile: box 0 of BQ rows, then box 1
  // Shared memory: two q-tile buffers, the K/V ring, the ring's kv-mask
  // bytes and the barriers.
  static constexpr int RING = 2 * QBYTES;          // STAGES x (K tile, V tile)
  static constexpr int MASK = RING + STAGES * 2 * TILE;
  static constexpr int BARS = MASK + STAGES * BT;  // q_full[2], q_empty[2], full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + (4 + 2 * STAGES) * 8;
  static constexpr int SMEM = BYTES + 1024;        // alignment slack
};

struct Maps {
  CUtensorMap q, k, v;
};

// The q tile at index t of the longest-first order: head h of batch b from
// row q0, and its kv tile count.
struct Tile {
  int h, b, q0, n_kv;
};

template <bool CAUSAL>
__device__ __forceinline__ Tile tile_at(int t, int Sq, int Skv, int Hq, int B) {
  const int n_qt = (Sq + Cfg::BQ - 1) / Cfg::BQ;
  Tile x;
  x.q0 = (n_qt - 1 - t / (Hq * B)) * Cfg::BQ;  // longest first under causality
  x.h = t % (Hq * B) % Hq;
  x.b = t % (Hq * B) / Hq;
  x.n_kv = (Skv + BT - 1) / BT;
  if (CAUSAL) x.n_kv = min(x.n_kv, (x.q0 + Cfg::BQ - 1) / BT + 1);
  return x;
}

template <bool CAUSAL, bool MASK>
__global__ void __launch_bounds__(Cfg::THREADS, 1)
    fwd_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ kv_mask, bf* __restrict__ out,
               float* __restrict__ lse, int B, int Sq, int Skv, int Hq, int Hkv, int n_tiles, float scale_log2) {
  constexpr int BQ = Cfg::BQ, CONSUMERS = Cfg::CONSUMERS, STAGES = Cfg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Cfg::BARS);
  uint64_t *q_full = bars, *q_empty = bars + 2, *full = bars + 4, *empty = bars + 4 + STAGES;
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
    int s = 0, it = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
      const Tile x = tile_at<CAUSAL>(t, Sq, Skv, Hq, B);
      if (lane == 0) {
        const int qb = it & 1;
        mbar_wait(q_empty + qb, ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(q_full + qb, Cfg::QBYTES);
        unsigned char* qs = smem + qb * Cfg::QBYTES;
        tma_load_4d(qs, &maps.q, q_full + qb, 0, x.h, x.q0, x.b);
        tma_load_4d(qs + BQ * 128, &maps.q, q_full + qb, 64, x.h, x.q0, x.b);
      }
      for (int j = 0; j < x.n_kv; ++j) {
        const int k0 = j * BT;
        uint8_t keep[BT / 32];  // this lane's mask bytes, read before the wait
        if (MASK) {
#pragma unroll
          for (int i = 0; i < BT / 32; ++i) {
            const int col = k0 + lane + 32 * i;
            keep[i] = col < Skv && kv_mask[static_cast<long>(x.b) * Skv + col] != 0;
          }
        }
        mbar_wait(empty + s, phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + s, 2 * TX_TILE);
          unsigned char* ring = smem + Cfg::RING + s * 2 * TILE;
          tma_tile(ring, BOX, &maps.k, full + s, x.h / group, k0, x.b);
          tma_tile(ring + TILE, BOX, &maps.v, full + s, x.h / group, k0, x.b);
        }
        if (MASK) {
          uint8_t* ms = smem + Cfg::MASK + s * BT;
#pragma unroll
          for (int i = 0; i < BT / 32; ++i) ms[lane + 32 * i] = keep[i];
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
  int s = 0, it = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const Tile x = tile_at<CAUSAL>(t, Sq, Skv, Hq, B);
    const int r0 = x.q0 + 64 * wg;
    const int row[2] = {r0 + 16 * warp + gi, r0 + 16 * warp + gi + 8};
    float o[36];
#pragma unroll
    for (int i = 0; i < 36; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // per-thread partial row sums; quad-reduced at the end
    const int qb = it & 1;
    const unsigned char* qa0 = smem + qb * Cfg::QBYTES + wg * BOX;
    const unsigned char* qa1 = qa0 + BQ * 128;
    mbar_wait(q_full + qb, (it >> 1) & 1);

    for (int j = 0; j < x.n_kv; ++j) {
      const int k0 = j * BT;
      mbar_wait(full + s, phase);
      const unsigned char* ks = smem + Cfg::RING + s * 2 * TILE;
      const uint8_t* ms = smem + Cfg::MASK + s * BT;

      float st[32];  // S = Q K^T: q rows x kv columns
      wgmma_fence();
      ss_d72(st, qa0, qa1, ks, ks + BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);

      // The online softmax, without branches: key column c of row r is
      // valid iff c < lim[r] (the tile's end, and under causality the row's
      // diagonal) and, with a kv mask, its byte is set.  The running max is
      // kept in the log2 domain; the scale is positive, so the max of the
      // raw scores scales to the max of the scaled ones, and p =
      // exp2(s * scale_log2 - m) is one FFMA and one exp2.
      int lim[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lim[i] = Skv - k0;
        if (CAUSAL) lim[i] = min(lim[i], row[i] - k0 + 1);
        lim[i] -= 2 * ti;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = 8 * jj + (e & 1) < lim[e >> 1];
          if (MASK) ok = ok && ms[8 * jj + 2 * ti + (e & 1)] != 0;
          st[4 * jj + e] = ok ? st[4 * jj + e] : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], st[4 * jj + e]);
        }
      }
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
      for (int i = 0; i < 32; ++i) {
        st[i] = exp2f(fmaf(st[i], scale_log2, -base[(i >> 1) & 1]));
        l[(i >> 1) & 1] += st[i];
      }
#pragma unroll
      for (int i = 0; i < 36; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V (contraction over the 64 kv rows), P packed to bf16.
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(pa[kk], st, kk);
      wgmma_fence();
      rs_n72(o, pa, ks + TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_frags(pa);
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
      inv[i] = lt > 0.f ? 1.f / lt : 0.f;  // no valid key -> zeros
      if (lse != nullptr && ti == 0 && row[i] < Sq)
        lse[(static_cast<long>(x.b) * Hq + x.h) * Sq + row[i]] = lt > 0.f ? (m[i] + log2f(lt)) * LN2 : -INFINITY;
    }
    const long qstride = static_cast<long>(Hq) * D;
    bf* ob = out + (static_cast<long>(x.b) * Sq * Hq + x.h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= Sq) continue;
#pragma unroll
      for (int jj = 0; jj < 9; ++jj)
        *reinterpret_cast<uint32_t*>(ob + row[r] * qstride + 8 * jj + 2 * ti) =
            kdss::pack_bf16(o[4 * jj + 2 * r] * inv[r], o[4 * jj + 2 * r + 1] * inv[r]);
    }
  }
}

template <bool CAUSAL, bool MASK>
cudaError_t launch(const Maps& maps, const uint8_t* mask, bf* out, float* lse, int B, int Sq, int Skv, int Hq,
                   int Hkv, float scale_log2, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(fwd_kernel<CAUSAL, MASK>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_tiles = (Sq + Cfg::BQ - 1) / Cfg::BQ * Hq * B;
  fwd_kernel<CAUSAL, MASK><<<min(n_tiles, sms), Cfg::THREADS, Cfg::SMEM, st>>>(maps, mask, out, lse, B, Sq, Skv,
                                                                              Hq, Hkv, n_tiles, scale_log2);
  return cudaGetLastError();
}

}  // namespace kdss_fwd90

// K1 at D = 72 (called by kdss_flash_fwd): q [B, Sq, Hq, 72], k/v [B, Skv,
// Hkv, 72] bf16 contiguous and 16-byte aligned, kv_mask uint8 [B, Skv] or
// null, out like q, lse f32 [B, Hq, Sq] or null.
cudaError_t kdss_flash_fwd_d72(const void* q, const void* k, const void* v, const void* kv_mask, void* out,
                               float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale_log2,
                               cudaStream_t st) {
  using namespace kdss_fwd90;
  Maps maps;
  cudaError_t err = kdss_d72_host::head_map(&maps.q, q, B, Sq, Hq, Cfg::BQ);
  if (err == cudaSuccess) err = kdss_d72_host::head_map(&maps.k, k, B, Skv, Hkv, BT);
  if (err == cudaSuccess) err = kdss_d72_host::head_map(&maps.v, v, B, Skv, Hkv, BT);
  if (err != cudaSuccess) return err;
  const auto* m = static_cast<const uint8_t*>(kv_mask);
  auto* o = static_cast<bf*>(out);
  if (causal)
    return m ? launch<true, true>(maps, m, o, lse, B, Sq, Skv, Hq, Hkv, scale_log2, st)
             : launch<true, false>(maps, m, o, lse, B, Sq, Skv, Hq, Hkv, scale_log2, st);
  return m ? launch<false, true>(maps, m, o, lse, B, Sq, Skv, Hq, Hkv, scale_log2, st)
           : launch<false, false>(maps, m, o, lse, B, Sq, Skv, Hq, Hkv, scale_log2, st);
}
