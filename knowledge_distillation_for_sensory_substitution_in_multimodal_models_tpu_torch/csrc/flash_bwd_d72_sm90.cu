// The flash-attention backward at head dim 72 for Hopper (sm_90a), on K4's
// design (flash_bwd_sm90.cu): dq, dk, dv from the saved row logsumexp, bf16
// in and out, f32 accumulation.  flash_bwd.cu routes D = 72 here.
//
// Replaces the Pallas TPU kernel K2 of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/
// ops/flash_attention.py): `_flash_vjp_bwd` (kernels `_dq_kernel`,
// `_dkv_kernel`), the MHA backward of every SigLIP layer (10 tiles x 729
// tokens, 16 heads, d = 72, non-causal).  The function is flash_bwd.cu's:
// P = exp(s Q K^T - lse), dV = P^T dO, dP = dO V^T, dS = s P (dP - delta),
// dQ = dS K, dK = dS^T Q, P rounded to bf16 before P^T dO and dS before
// dS K and dS^T Q as the JAX kernels do; dead rows arrive neutralized
// (lse = +huge, delta = 0); causality top-left aligned; dk and dv summed
// over the G query heads of each kv head (G = 1 in SigLIP).
// Deterministic: no atomics, every sum in a fixed order.
//
// What bounds it on the H100: ~10 x pairs x Hq x 72 operations, 61 GFLOP at
// the SigLIP shape, 0.062 ms at the bf16 peak, against ~17 MB of operands.
// The mma.sync pair it replaces had the parallelism (1920 blocks each) but
// lost its time in the operand path: synchronous tile copies before each
// product, every operand through registers, 80 columns computed for 72.
// Being deterministic costs products: dq is a kernel of its own that
// recomputes S and dP (7 products in all, where one kernel accumulating dq
// with float atomics needs 5).
//
// Design: two persistent kernels, one block an SM, each walking its tiles
// in turn; a block is one producer warp and consumer warpgroups of 64 rows
// each; 64-row tiles in the two-box layout of flash_d72_sm90.cuh:
//   * dk/dv: tiles of 128 kv rows (two warpgroups) of one kv head and
//     batch.  The producer loads a tile's K and V once, into one of two
//     buffers (the next tile's land while the current one runs), and streams
//     the Q and dO tiles of each (query head of the group, q tile) through a
//     2-stage TMA ring across tile boundaries, its lanes writing each tile's
//     lse (log2 domain) and delta beside it (read before the wait for the
//     stage).  Each consumer computes S^T = K Q^T and dP^T = V dO^T with
//     wgmma m64n64k16 from shared memory, P^T and dS^T in the accumulators'
//     registers, then dV += P^T dO and dK += dS^T Q with wgmma m64n72k16, the
//     packed accumulators as the register A operand and dO, Q read N-major
//     over their two boxes.  A tile owns its kv rows across the whole group,
//     so it writes bf16 dk and dv directly: no f32 partials, no reduce
//     kernel.
//   * dq: tiles of 192 q rows (three warpgroups) of one q head and batch,
//     longest first under causality; one buffer of Q and dO, a 3-stage ring
//     of K, V and their kv-mask bytes; S = Q K^T and dP = dO V^T from shared
//     memory, dQ += dS K with dS from registers and K read N-major.
// In a sweep on the H100 (PERF.md) one warpgroup a block (K4's
// shape), overlapping the exp with dP's products, ping-pong between the
// warpgroups, and K, Q or dO as register A operands (which spill) were
// each slower; sharing the streamed tiles between warpgroups gained most.

#include "flash_d72_sm90.cuh"

namespace kdss_bwd72 {

using namespace kdss_d72;
using kdss::LOG2E;

// The maps of one kernel: its two fixed operands (boxes of a tile's BR
// rows) and its two streamed operands (64-row boxes).
struct Maps {
  CUtensorMap fix_a, fix_b, ring_a, ring_b;
};

// A block's shape: WGS consumer warpgroups of 64 fixed rows each (a tile
// of BR rows), a ring of STAGES stages, FIXBUF buffers of the fixed tiles;
// one block an SM.  Shared memory: the fixed buffers (each: operand a's box
// 0 of BR rows, its box 1, then operand b's), the ring, the side rows and
// the barriers.
template <int WGS_, int STAGES_, int FIXBUF_>
struct Cfg {
  static constexpr int WGS = WGS_, STAGES = STAGES_, FIXBUF = FIXBUF_;
  static constexpr int BR = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;           // and one producer warp
  static constexpr int FIXBYTES = 4 * BR * 128;
  static constexpr int RING = FIXBUF * FIXBYTES;           // STAGES x (tile 0, tile 1)
  static constexpr int SIDE = RING + STAGES * 2 * TILE;    // STAGES x 2 x 64 f32 (or 64 bytes)
  static constexpr int BARS = SIDE + STAGES * 2 * BT * 4;  // fix_full, fix_empty[FIXBUF], full, empty[STAGES]
  static constexpr int BYTES = BARS + (2 * FIXBUF + 2 * STAGES) * 8;
  static constexpr int SMEM = BYTES + 1024;                // alignment slack
};

// The barriers of a block: fix_full/fix_empty per fixed buffer, full/empty
// per ring stage.
template <class C>
struct Bars {
  uint64_t *fix_full, *fix_empty, *full, *empty;
  __device__ __forceinline__ explicit Bars(unsigned char* smem) {
    fix_full = reinterpret_cast<uint64_t*>(smem + C::BARS);
    fix_empty = fix_full + C::FIXBUF;
    full = fix_empty + C::FIXBUF;
    empty = full + C::STAGES;
    if (threadIdx.x == 0) {
      for (int i = 0; i < C::FIXBUF; ++i) {
        mbar_init(fix_full + i, 1);
        mbar_init(fix_empty + i, C::CONSUMERS / 32);  // one arrival per consumer warp
      }
      for (int s = 0; s < C::STAGES; ++s) {
        mbar_init(full + s, 32);                      // the producer warp's lanes, lane 0 with the bytes
        mbar_init(empty + s, C::CONSUMERS / 32);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
};

// Producer: the fixed operands of the it-th tile (BR rows from row0) into
// buffer it % FIXBUF once the consumers have released it.  One lane.
template <class C>
__device__ __forceinline__ void load_fixed(unsigned char* smem, const Maps& maps, const Bars<C>& bars, int it, int h,
                                           int row0, int b) {
  const int fb = it % C::FIXBUF;
  mbar_wait(bars.fix_empty + fb, ((it / C::FIXBUF) & 1) ^ 1);
  mbar_arrive_expect_tx(bars.fix_full + fb, C::FIXBYTES);
  unsigned char* dst = smem + fb * C::FIXBYTES;
  tma_tile(dst, C::BR * 128, &maps.fix_a, bars.fix_full + fb, h, row0, b);
  tma_tile(dst + 2 * C::BR * 128, C::BR * 128, &maps.fix_b, bars.fix_full + fb, h, row0, b);
}

template <class C, bool CAUSAL>
__global__ void __launch_bounds__(C::THREADS, 1)
    dkv_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ kv_mask, const float* __restrict__ lse,
               const float* __restrict__ delta, bf* __restrict__ dk, bf* __restrict__ dv, int B, int Sq, int Skv,
               int Hq, int Hkv, int n_tiles, float scale, float scale_log2) {
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Bars<C> bars(smem);
  const int n_q = (Sq + BT - 1) / BT, group = Hq / Hkv;

  if (threadIdx.x >= C::CONSUMERS) {  // producer warp: K, V fixed; Q, dO and lse, delta streamed
    const int lane = threadIdx.x - C::CONSUMERS;
    int s = 0, it = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      const int k0 = tile / (Hkv * B) * C::BR, hk = tile % (Hkv * B) % Hkv, b = tile % (Hkv * B) / Hkv;
      const int j0 = CAUSAL ? k0 / BT : 0;  // q tiles wholly above the diagonal see no key here
      const int per_head = n_q - j0, n_steps = group * per_head;
      if (lane == 0) load_fixed<C>(smem, maps, bars, it, hk, k0, b);
      for (int t = 0; t < n_steps; ++t) {
        const int h = hk * group + t / per_head, q0 = (j0 + t % per_head) * BT;
        const long loff = (static_cast<long>(b) * Hq + h) * Sq;
        float l2[BT / 32], dl[BT / 32];  // this lane's rows' lse (log2 domain) and delta, read before the wait
#pragma unroll
        for (int i = 0; i < BT / 32; ++i) {
          const int row = q0 + lane + 32 * i;
          l2[i] = row < Sq ? lse[loff + row] * LOG2E : INFINITY;  // padding rows: P = 0
          dl[i] = row < Sq ? delta[loff + row] : 0.f;
        }
        mbar_wait(bars.empty + s, phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(bars.full + s, 2 * TX_TILE);
          unsigned char* ring = smem + C::RING + s * 2 * TILE;
          tma_tile(ring, BOX, &maps.ring_a, bars.full + s, h, q0, b);
          tma_tile(ring + TILE, BOX, &maps.ring_b, bars.full + s, h, q0, b);
        }
        float* side = reinterpret_cast<float*>(smem + C::SIDE + s * 2 * BT * 4);
#pragma unroll
        for (int i = 0; i < BT / 32; ++i) {
          side[lane + 32 * i] = l2[i];
          side[BT + lane + 32 * i] = dl[i];
        }
        mbar_arrive(bars.full + s);
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: kv rows k0 + 64 wg + 16 warp + gi (+ 8) of each tile
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;
  int s = 0, it = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int k0 = tile / (Hkv * B) * C::BR, hk = tile % (Hkv * B) % Hkv, b = tile % (Hkv * B) / Hkv;
    const int j0 = CAUSAL ? k0 / BT : 0;
    const int per_head = n_q - j0, n_steps = group * per_head;
    int kpos[2];
    bool kok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      kpos[r] = k0 + 64 * wg + warp * 16 + gi + 8 * r;
      kok[r] = kpos[r] < Skv && (kv_mask == nullptr || kv_mask[static_cast<long>(b) * Skv + kpos[r]] != 0);
    }
    float dka[36], dva[36];
#pragma unroll
    for (int i = 0; i < 36; ++i) dka[i] = dva[i] = 0.f;
    const int fb = it % C::FIXBUF;
    const unsigned char* ks0 = smem + fb * C::FIXBYTES + wg * BOX;
    const unsigned char* ks1 = ks0 + C::BR * 128;
    const unsigned char* vs0 = ks0 + 2 * C::BR * 128;
    const unsigned char* vs1 = ks0 + 3 * C::BR * 128;
    mbar_wait(bars.fix_full + fb, (it / C::FIXBUF) & 1);

    for (int t = 0; t < n_steps; ++t) {
      const int q0 = (j0 + t % per_head) * BT;
      mbar_wait(bars.full + s, phase);
      const unsigned char* qs = smem + C::RING + s * 2 * TILE;
      const unsigned char* dos = qs + TILE;
      const float* side = reinterpret_cast<const float*>(smem + C::SIDE + s * 2 * BT * 4);

      float st[32], dpt[32];  // S^T and dP^T: kv rows x q columns
      wgmma_fence();
      ss_d72(st, ks0, ks1, qs, qs + BOX);
      ss_d72(dpt, vs0, vs1, dos, dos + BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * j + 2 * ti + (e & 1);
          bool ok = kok[r];
          if (CAUSAL) ok = ok && q0 + c >= kpos[r];
          const float p = ok ? exp2f(st[4 * j + e] * scale_log2 - side[c]) : 0.f;
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - side[BT + c]) * scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q (contraction over the 64 q rows).
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        a_frag(pa[kk], st, kk);
        a_frag(sa[kk], dpt, kk);
      }
      wgmma_fence();
      rs_n72(dva, pa, dos);
      rs_n72(dka, sa, qs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      fence_frags(pa);
      fence_frags(sa);
      if (lane == 0) mbar_arrive(bars.empty + s);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    if (lane == 0) mbar_arrive(bars.fix_empty + fb);

    // dk, dv [B, Skv, Hkv, 72]: rows of masked keys are zeros.
    const long kstride = static_cast<long>(Hkv) * D;
    const long koff = (static_cast<long>(b) * Skv * Hkv + hk) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kpos[r] >= Skv) continue;
      const long o = koff + kpos[r] * kstride;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const int col = 8 * j + 2 * ti;
        *reinterpret_cast<uint32_t*>(dk + o + col) = kdss::pack_bf16(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + col) = kdss::pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <class C, bool CAUSAL>
__global__ void __launch_bounds__(C::THREADS, 1)
    dq_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ kv_mask, const float* __restrict__ lse,
              const float* __restrict__ delta, bf* __restrict__ dq, int B, int Sq, int Skv, int Hq, int Hkv,
              int n_tiles, float scale, float scale_log2) {
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const Bars<C> bars(smem);
  const int n_qb = (Sq + C::BR - 1) / C::BR, group = Hq / Hkv;
  // the it-th tile: q block jq (longest first under causality) of head h of batch b
  auto decode = [&](int tile, int& q0, int& h, int& b, int& n_kv) {
    q0 = (n_qb - 1 - tile / (Hq * B)) * C::BR;
    h = tile % (Hq * B) % Hq;
    b = tile % (Hq * B) / Hq;
    n_kv = (Skv + BT - 1) / BT;
    if (CAUSAL) n_kv = min(n_kv, (q0 + C::BR - 1) / BT + 1);
  };

  if (threadIdx.x >= C::CONSUMERS) {  // producer warp: Q, dO fixed; K, V and the mask bytes streamed
    const int lane = threadIdx.x - C::CONSUMERS;
    int s = 0, it = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
      int q0, h, b, n_kv;
      decode(tile, q0, h, b, n_kv);
      if (lane == 0) load_fixed<C>(smem, maps, bars, it, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int k0 = j * BT;
        uint8_t keep[BT / 32];  // this lane's mask bytes, read before the wait
#pragma unroll
        for (int i = 0; i < BT / 32; ++i) {
          const int col = k0 + lane + 32 * i;
          keep[i] = col < Skv && (kv_mask == nullptr || kv_mask[static_cast<long>(b) * Skv + col] != 0);
        }
        mbar_wait(bars.empty + s, phase ^ 1);
        if (lane == 0) {
          mbar_expect_tx(bars.full + s, 2 * TX_TILE);
          unsigned char* ring = smem + C::RING + s * 2 * TILE;
          tma_tile(ring, BOX, &maps.ring_a, bars.full + s, h / group, k0, b);
          tma_tile(ring + TILE, BOX, &maps.ring_b, bars.full + s, h / group, k0, b);
        }
        uint8_t* ms = smem + C::SIDE + s * 2 * BT * 4;
#pragma unroll
        for (int i = 0; i < BT / 32; ++i) ms[lane + 32 * i] = keep[i];
        mbar_arrive(bars.full + s);
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
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    int q0, h, b, n_kv;
    decode(tile, q0, h, b, n_kv);
    int row[2];
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = q0 + 64 * wg + warp * 16 + gi + 8 * r;
      const long idx = (static_cast<long>(b) * Hq + h) * Sq + row[r];
      l2[r] = row[r] < Sq ? lse[idx] * LOG2E : INFINITY;  // padding rows: P = 0
      dl[r] = row[r] < Sq ? delta[idx] : 0.f;
    }
    float acc[36];
#pragma unroll
    for (int i = 0; i < 36; ++i) acc[i] = 0.f;
    const int fb = it % C::FIXBUF;
    const unsigned char* qs0 = smem + fb * C::FIXBYTES + wg * BOX;
    const unsigned char* qs1 = qs0 + C::BR * 128;
    const unsigned char* dos0 = qs0 + 2 * C::BR * 128;
    const unsigned char* dos1 = qs0 + 3 * C::BR * 128;
    mbar_wait(bars.fix_full + fb, (it / C::FIXBUF) & 1);

    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * BT;
      mbar_wait(bars.full + s, phase);
      const unsigned char* ks = smem + C::RING + s * 2 * TILE;
      const unsigned char* vs = ks + TILE;
      const uint8_t* ms = smem + C::SIDE + s * 2 * BT * 4;

      float st[32], dp[32];  // S and dP: q rows x kv columns
      wgmma_fence();
      ss_d72(st, qs0, qs1, ks, ks + BOX);
      ss_d72(dp, dos0, dos1, vs, vs + BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dp);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, c = 8 * jj + 2 * ti + (e & 1);
          bool ok = ms[c] != 0;
          if (CAUSAL) ok = ok && k0 + c <= row[r];
          const float p = ok ? exp2f(st[4 * jj + e] * scale_log2 - l2[r]) : 0.f;
          st[4 * jj + e] = p * (dp[4 * jj + e] - dl[r]) * scale;
        }
      }
      // dQ += dS K (contraction over the 64 kv rows).
      uint32_t sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(sa[kk], st, kk);
      wgmma_fence();
      rs_n72(acc, sa, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(sa);
      if (lane == 0) mbar_arrive(bars.empty + s);
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    if (lane == 0) mbar_arrive(bars.fix_empty + fb);

    const long qstride = static_cast<long>(Hq) * D;
    bf* out = dq + (static_cast<long>(b) * Sq * Hq + h) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= Sq) continue;
#pragma unroll
      for (int jj = 0; jj < 9; ++jj)
        *reinterpret_cast<uint32_t*>(out + row[r] * qstride + 8 * jj + 2 * ti) =
            kdss::pack_bf16(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
    }
  }
}

// Maps of q/dout [B, Sq, Hq, 72] and k/v [B, Skv, Hkv, 72]: the fixed pair
// (a, b) in boxes of `fixed_rows` rows, the streamed pair in 64-row boxes.
inline cudaError_t make_maps(Maps* m, const void* fa, const void* fb, int Sf, int Hf, int fixed_rows,
                             const void* ra, const void* rb, int Sr, int Hr, int B) {
  cudaError_t err = kdss_d72_host::head_map(&m->fix_a, fa, B, Sf, Hf, fixed_rows);
  if (err == cudaSuccess) err = kdss_d72_host::head_map(&m->fix_b, fb, B, Sf, Hf, fixed_rows);
  if (err == cudaSuccess) err = kdss_d72_host::head_map(&m->ring_a, ra, B, Sr, Hr, BT);
  if (err == cudaSuccess) err = kdss_d72_host::head_map(&m->ring_b, rb, B, Sr, Hr, BT);
  return err;
}

// dq's and dk/dv's block shapes.
using CfgQ = Cfg<3, 3, 1>;
using CfgKV = Cfg<2, 2, 2>;

template <bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const uint8_t* mask,
                   const float* lse, const float* delta, bf* dq, bf* dk, bf* dv, int B, int Sq, int Skv, int Hq,
                   int Hkv, float scale, cudaStream_t st) {
  const float sl2 = scale * LOG2E;
  Maps mq, mkv;
  int dev = 0, sms = 0;
  cudaError_t err = make_maps(&mq, q, dout, Sq, Hq, CfgQ::BR, k, v, Skv, Hkv, B);
  if (err == cudaSuccess) err = make_maps(&mkv, k, v, Skv, Hkv, CfgKV::BR, q, dout, Sq, Hq, B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<CfgQ, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, CfgQ::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel<CfgKV, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, CfgKV::SMEM);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nq = (Sq + CfgQ::BR - 1) / CfgQ::BR * Hq * B, nkv = (Skv + CfgKV::BR - 1) / CfgKV::BR * Hkv * B;
  dq_kernel<CfgQ, CAUSAL><<<min(nq, sms), CfgQ::THREADS, CfgQ::SMEM, st>>>(mq, mask, lse, delta, dq, B, Sq, Skv, Hq,
                                                                          Hkv, nq, scale, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<CfgKV, CAUSAL><<<min(nkv, sms), CfgKV::THREADS, CfgKV::SMEM, st>>>(mkv, mask, lse, delta, dk, dv, B, Sq,
                                                                               Skv, Hq, Hkv, nkv, scale, sl2);
  return cudaGetLastError();
}

}  // namespace kdss_bwd72

// K2 at D = 72 (called by kdss_flash_bwd): q/dout [B, Sq, Hq, 72], k/v
// [B, Skv, Hkv, 72] bf16 contiguous and 16-byte aligned, kv_mask uint8
// [B, Skv] or null, lse/delta f32 [B, Hq, Sq].
cudaError_t kdss_flash_bwd_d72(const void* q, const void* k, const void* v, const void* kv_mask, const void* dout,
                               const void* lse, const void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                               int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t st) {
  using namespace kdss_bwd72;
  const auto* m = static_cast<const uint8_t*>(kv_mask);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(delta);
  auto *q_ = static_cast<bf*>(dq), *k_ = static_cast<bf*>(dk), *v_ = static_cast<bf*>(dv);
  return causal ? launch<true>(q, k, v, dout, m, l, d, q_, k_, v_, B, Sq, Skv, Hq, Hkv, scale, st)
                : launch<false>(q, k, v, dout, m, l, d, q_, k_, v_, B, Sq, Skv, Hq, Hkv, scale, st);
}
