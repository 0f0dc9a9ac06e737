// The flash-attention backward at head dim 64 for Hopper (sm_90a), redesigned
// around wgmma and TMA: dq, dk, dv from the saved row logsumexp, bf16 in and
// out, f32 accumulation.  flash_bwd.cu routes D = 64 here and D = 72 (K2,
// SigLIP) to flash_bwd_d72_sm90.cu, which takes this design at G = 1.
//
// Replaces the Pallas TPU kernel K4 of the JAX package
// (knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu/
// ops/flash_attention.py): `_flash_gqa_vjp_bwd` (kernels `_gqa_dq_kernel`,
// `_gqa_dkv_kernel`), the GQA backward of every Qwen2 layer (d = 64, 14 q /
// 2 kv heads, causal, kv-padding mask).  The function is flash_bwd.cu's:
// P = exp(s Q K^T - lse), dV = P^T dO, dP = dO V^T, dS = s P (dP - delta),
// dQ = dS K, dK = dS^T Q, P rounded to bf16 before P^T dO and dS before
// dS K and dS^T Q as the JAX kernels do; dead rows arrive neutralized
// (lse = +huge, delta = 0); causality top-left aligned; dk and dv summed
// over the G query heads of each kv head.  Deterministic: no atomics, every
// sum in a fixed order.
//
// What bounds it on the H100: ~10 * pairs * Hq * 64 operations (pairs =
// attended (query, key) pairs), 0.04 ms at the training shape, against
// ~15 MB of operands.  The mma.sync pair it replaces spent its time in
// synchronous tile loads and in the dk/dv grid: (Skv / 64) x Hkv = 96
// blocks for 132 SMs, the block of kv tile 0 walking 7 heads x 48 q tiles
// in series.
//
// Design, three kernels, 64-row tiles of 128-byte rows (128-byte swizzle):
//   * dk/dv: one block per (kv tile, q head, batch), (Skv / 64) x Hq x B
//     blocks (672 at the training shape), ordered longest first (kv tile 0
//     first under causality).  Warps 0-3 are one consumer warpgroup, warp 4
//     a producer: it loads the block's K and V tiles once and streams the Q
//     and dO tiles of each q tile through a 2-stage TMA ring, its lanes
//     writing the tile's lse (log2 domain) and delta beside them, under
//     mbarriers.  The consumer computes S^T = K Q^T and dP^T = V dO^T with
//     wgmma m64n64k16 from shared memory, P^T and dS^T in the accumulators'
//     registers, then dV += P^T dO and dK += dS^T Q with wgmma's register A
//     operand (the bf16-packed accumulators) and B = dO, Q from shared
//     memory read N-major.  Each block writes its head's f32 dk/dv partial.
//   * reduce: dk, dv = bf16(sum over the G heads of the partials, g = 0, 1,
//     ...), a fixed order.
//   * dq: one block per (q tile, q head, batch), longest first; the
//     producer streams K, V and the tile's kv-mask bytes; S = Q K^T and
//     dP = dO V^T from shared memory, dQ += dS K with dS from registers.
// The f32 partials [2, G, B, Skv, Hkv, 64] are the wrapper's workspace.

#include "kdss_mma.cuh"
#include "kdss_sm90.cuh"

namespace kdss_bwd90 {

using namespace kdss_sm90;
using kdss::LOG2E;
using kdss::pack_bf16;
using bf = __nv_bfloat16;

constexpr int D = 64, BT = 64, STAGES = 2;
constexpr int THREADS = 160;  // one consumer warpgroup and a producer warp
constexpr int TILE = BT * D * 2;  // 8 KB, 1024-aligned
constexpr uint32_t TX2 = 2 * TILE;

struct Maps {
  CUtensorMap q, k, v, dout;
};

// Shared memory: two fixed tiles, then the ring, then the side rows and the barriers.
struct Layout {
  static constexpr int FIXED0 = 0, FIXED1 = TILE;
  static constexpr int RING = 2 * TILE;                         // STAGES x (tile 0, tile 1)
  static constexpr int SIDE = RING + STAGES * 2 * TILE;         // STAGES x 2 x 64 f32 (or 64 bytes)
  static constexpr int BARS = SIDE + STAGES * 2 * BT * 4;       // fixed_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + (1 + 2 * STAGES) * 8;
  static constexpr int SMEM = BYTES + 1024;                     // alignment slack
};

__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);  // the fixed tiles
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 1 + s, 32);           // the producer warp's lanes, lane 0 with the tiles' bytes
      mbar_init(bars + 1 + STAGES + s, 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// Two 64 x 64 (x 64) products from shared memory: x = A0 B0^T, y = A1 B1^T.
__device__ __forceinline__ void two_ss(float (&x)[32], float (&y)[32], const void* a0, const void* b0,
                                       const void* a1, const void* b1) {
  const uint64_t da0 = desc_kmajor(a0), db0 = desc_kmajor(b0), da1 = desc_kmajor(a1), db1 = desc_kmajor(b1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64_ss(x, da0 + 2 * kk, db0 + 2 * kk, kk);
    wgmma_m64n64_ss(y, da1 + 2 * kk, db1 + 2 * kk, kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(x);
  fence_regs(y);
}

template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
    dkv_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ kv_mask, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ part, int B, int Sq, int Skv, int Hq, int Hkv,
               float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Layout::BARS);
  uint64_t *fixed_full = bars, *full = bars + 1, *empty = bars + 1 + STAGES;
  init_barriers(bars);

  const int n_q = (Sq + BT - 1) / BT;
  const int jk = blockIdx.x / (Hq * B), rest = blockIdx.x % (Hq * B);
  const int h = rest % Hq, b = rest / Hq, group = Hq / Hkv, hk = h / group;
  const int k0 = jk * BT;
  const int j0 = CAUSAL ? k0 / BT : 0;  // q tiles wholly above the diagonal see no key here
  const long loff = (static_cast<long>(b) * Hq + h) * Sq;

  if (threadIdx.x >= 128) {  // producer warp
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_arrive_expect_tx(fixed_full, TX2);
      tma_load_4d(smem + Layout::FIXED0, &maps.k, fixed_full, 0, hk, k0, b);
      tma_load_4d(smem + Layout::FIXED1, &maps.v, fixed_full, 0, hk, k0, b);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int jq = j0; jq < n_q; ++jq) {
      const int q0 = jq * BT;
      mbar_wait(empty + s, phase ^ 1);
      float* side = reinterpret_cast<float*>(smem + Layout::SIDE + s * 2 * BT * 4);
      for (int i = lane; i < BT; i += 32) {
        const int row = q0 + i;
        side[i] = row < Sq ? lse[loff + row] * LOG2E : INFINITY;  // padding rows: P = 0
        side[BT + i] = row < Sq ? delta[loff + row] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full + s, TX2);
        unsigned char* ring = smem + Layout::RING + s * 2 * TILE;
        tma_load_4d(ring, &maps.q, full + s, 0, h, q0, b);
        tma_load_4d(ring + TILE, &maps.dout, full + s, 0, h, q0, b);
      } else {
        mbar_arrive(full + s);
      }
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup: kv rows k0 + 16 warp + gi (+ 8)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gi = lane >> 2, ti = lane & 3;
  int kpos[2];
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = k0 + warp * 16 + gi + 8 * r;
    kok[r] = kpos[r] < Skv && (kv_mask == nullptr || kv_mask[static_cast<long>(b) * Skv + kpos[r]] != 0);
  }
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(fixed_full, 0);
  const unsigned char* ks = smem + Layout::FIXED0;
  const unsigned char* vs = smem + Layout::FIXED1;

  int s = 0;
  uint32_t phase = 0;
  for (int jq = j0; jq < n_q; ++jq) {
    const int q0 = jq * BT;
    mbar_wait(full + s, phase);
    const unsigned char* qs = smem + Layout::RING + s * 2 * TILE;
    const unsigned char* dos = qs + TILE;
    const float* side = reinterpret_cast<const float*>(smem + Layout::SIDE + s * 2 * BT * 4);

    float st[32], dpt[32];  // S^T and dP^T: kv rows x q columns
    two_ss(st, dpt, ks, qs, vs, dos);
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
    const uint64_t ddo = desc_nmajor(dos), dqs = desc_nmajor(qs);
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_frag(pa[kk], st, kk);
      a_frag(sa[kk], dpt, kk);
    }
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n64_rs<1>(dv, pa[kk], ddo + 128 * kk, 1);
      wgmma_m64n64_rs<1>(dk, sa[kk], dqs + 128 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }

  // This head's f32 partials: part[0 (dk) / 1 (dv), g, b, kpos, hk, :].
  const long plane = static_cast<long>(group) * B * Skv * Hkv * D;
  const int g = h % group;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Skv) continue;
    float* pk = part + (((static_cast<long>(g) * B + b) * Skv + kpos[r]) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * ti;
      *reinterpret_cast<float2*>(pk + col) = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(pk + plane + col) = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// dk, dv [B, Skv, Hkv, 64] bf16 = the sums over g = 0 .. G - 1, in that
// order, of the partials; four elements a thread.
__global__ void reduce_kernel(const float* __restrict__ part, bf* __restrict__ dk, bf* __restrict__ dv,
                              long n4, int group) {
  const long plane = n4 * 4 * group;
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int g = 0; g < group; ++g) {
      const float4 a = reinterpret_cast<const float4*>(part)[g * n4 + i];
      const float4 c = reinterpret_cast<const float4*>(part + plane)[g * n4 + i];
      sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
      sv.x += c.x, sv.y += c.y, sv.z += c.z, sv.w += c.w;
    }
    reinterpret_cast<uint2*>(dk)[i] = make_uint2(pack_bf16(sk.x, sk.y), pack_bf16(sk.z, sk.w));
    reinterpret_cast<uint2*>(dv)[i] = make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  }
}

template <bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 2)
    dq_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ kv_mask, const float* __restrict__ lse,
              const float* __restrict__ delta, bf* __restrict__ dq, int B, int Sq, int Skv, int Hq, int Hkv,
              float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Layout::BARS);
  uint64_t *fixed_full = bars, *full = bars + 1, *empty = bars + 1 + STAGES;
  init_barriers(bars);

  const int n_q = (Sq + BT - 1) / BT;
  const int jq = n_q - 1 - static_cast<int>(blockIdx.x / (Hq * B));  // longest first under causality
  const int rest = blockIdx.x % (Hq * B);
  const int h = rest % Hq, b = rest / Hq, hk = h / (Hq / Hkv);
  const int q0 = jq * BT;
  int n_kv = (Skv + BT - 1) / BT;
  if (CAUSAL) n_kv = min(n_kv, (q0 + BT - 1) / BT + 1);

  if (threadIdx.x >= 128) {  // producer warp
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_arrive_expect_tx(fixed_full, TX2);
      tma_load_4d(smem + Layout::FIXED0, &maps.q, fixed_full, 0, h, q0, b);
      tma_load_4d(smem + Layout::FIXED1, &maps.dout, fixed_full, 0, h, q0, b);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * BT;
      mbar_wait(empty + s, phase ^ 1);
      uint8_t* ms = smem + Layout::SIDE + s * 2 * BT * 4;
      for (int i = lane; i < BT; i += 32) {
        const int col = k0 + i;
        ms[i] = col < Skv && (kv_mask == nullptr || kv_mask[static_cast<long>(b) * Skv + col] != 0);
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(full + s, TX2);
        unsigned char* ring = smem + Layout::RING + s * 2 * TILE;
        tma_load_4d(ring, &maps.k, full + s, 0, hk, k0, b);
        tma_load_4d(ring + TILE, &maps.v, full + s, 0, hk, k0, b);
      } else {
        mbar_arrive(full + s);
      }
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup: q rows q0 + 16 warp + gi (+ 8)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gi = lane >> 2, ti = lane & 3;
  int row[2];
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + warp * 16 + gi + 8 * r;
    const long idx = (static_cast<long>(b) * Hq + h) * Sq + row[r];
    l2[r] = row[r] < Sq ? lse[idx] * LOG2E : INFINITY;  // padding rows: P = 0
    dl[r] = row[r] < Sq ? delta[idx] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mbar_wait(fixed_full, 0);
  const unsigned char* qs = smem + Layout::FIXED0;
  const unsigned char* dos = smem + Layout::FIXED1;

  int s = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BT;
    mbar_wait(full + s, phase);
    const unsigned char* ks = smem + Layout::RING + s * 2 * TILE;
    const unsigned char* vs = ks + TILE;
    const uint8_t* ms = smem + Layout::SIDE + s * 2 * BT * 4;

    float st[32], dp[32];  // S and dP: q rows x kv columns
    two_ss(st, dp, qs, ks, dos, vs);
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
    const uint64_t dkd = desc_nmajor(ks);
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(sa[kk], st, kk);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64_rs<1>(acc, sa[kk], dkd + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }

  const long qstride = static_cast<long>(Hq) * D;
  bf* out = dq + (static_cast<long>(b) * Sq * Hq + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<uint32_t*>(out + row[r] * qstride + 8 * jj + 2 * ti) =
          pack_bf16(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
  }
}

// A rank-4 map of x [B, S, H, 64] bf16 (contiguous): dims {64, H, S, B},
// one 64-row box of one head.
cudaError_t head_map(CUtensorMap* map, const void* x, int B, int S, int H) {
  const uint64_t dims[4] = {D, static_cast<uint64_t>(H), static_cast<uint64_t>(S), static_cast<uint64_t>(B)};
  const uint64_t row = D * 2;
  const uint64_t strides[3] = {row, row * H, row * H * S};
  const uint32_t box[4] = {D, 1, BT, 1};
  return kdss_sm90_host::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides, box,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool CAUSAL>
cudaError_t launch(const Maps& maps, const uint8_t* mask, const float* lse, const float* delta, bf* dq, bf* dk,
                   bf* dv, float* part, int B, int Sq, int Skv, int Hq, int Hkv, float scale, cudaStream_t st) {
  const float sl2 = scale * LOG2E;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkv_kernel<CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q = (Sq + BT - 1) / BT, n_kv = (Skv + BT - 1) / BT;
  dq_kernel<CAUSAL><<<n_q * Hq * B, THREADS, Layout::SMEM, st>>>(maps, mask, lse, delta, dq, B, Sq, Skv, Hq, Hkv,
                                                                 scale, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_kernel<CAUSAL><<<n_kv * Hq * B, THREADS, Layout::SMEM, st>>>(maps, mask, lse, delta, part, B, Sq, Skv, Hq,
                                                                   Hkv, scale, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long n4 = static_cast<long>(B) * Skv * Hkv * D / 4;
  const long want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  reduce_kernel<<<blocks, 256, 0, st>>>(part, dk, dv, n4, Hq / Hkv);
  return cudaGetLastError();
}

}  // namespace kdss_bwd90

// K4 at D = 64 (called by kdss_flash_bwd): q/dout [B, Sq, Hq, 64], k/v
// [B, Skv, Hkv, 64] bf16 contiguous and 16-byte aligned, kv_mask uint8
// [B, Skv] or null, lse/delta f32 [B, Hq, Sq], part f32 [2, Hq / Hkv, B,
// Skv, Hkv, 64] (workspace).
cudaError_t kdss_flash_bwd_d64(const void* q, const void* k, const void* v, const void* kv_mask, const void* dout,
                               const void* lse, const void* delta, void* dq, void* dk, void* dv, void* part, int B,
                               int Sq, int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t st) {
  using namespace kdss_bwd90;
  if (part == nullptr) return cudaErrorInvalidValue;
  Maps maps;
  cudaError_t err = head_map(&maps.q, q, B, Sq, Hq);
  if (err == cudaSuccess) err = head_map(&maps.dout, dout, B, Sq, Hq);
  if (err == cudaSuccess) err = head_map(&maps.k, k, B, Skv, Hkv);
  if (err == cudaSuccess) err = head_map(&maps.v, v, B, Skv, Hkv);
  if (err != cudaSuccess) return err;
  const auto* m = static_cast<const uint8_t*>(kv_mask);
  const auto* l = static_cast<const float*>(lse);
  const auto* d = static_cast<const float*>(delta);
  auto* p = static_cast<float*>(part);
  return causal ? launch<true>(maps, m, l, d, static_cast<bf*>(dq), static_cast<bf*>(dk), static_cast<bf*>(dv), p, B,
                               Sq, Skv, Hq, Hkv, scale, st)
                : launch<false>(maps, m, l, d, static_cast<bf*>(dq), static_cast<bf*>(dk), static_cast<bf*>(dv), p,
                                B, Sq, Skv, Hq, Hkv, scale, st);
}
