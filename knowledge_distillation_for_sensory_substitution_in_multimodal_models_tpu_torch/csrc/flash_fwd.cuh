// The flash-attention forward kernel of flash_fwd.cu (K1/K3), shared with the
// phase-ablation arms of flash_phase_ablation_d*.cu (K13).  The design, the
// layout and what bounds the kernel are described in flash_fwd.cu; the ARM
// template parameter (default ARM_FULL: the shipped kernel, unchanged) at
// `enum Arm` below.
#pragma once

#include "kdss_mma.cuh"

namespace {

using namespace kdss;

constexpr int BM = 64;  // q rows per block (16 per warp)
constexpr int BN = 64;  // kv rows per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <int D>
constexpr int smem_bytes() {
  return (BM + 2 * BN) * FlashDims<D>::LD * 2 + BN;  // Q, K, V tiles and the kv mask
}

// K13, the phase-ablation arms of the JAX script
// scripts/flash_phase_ablation.py (`_variant_kernel`, `_streaming_smem_kernel`):
// each keeps this kernel's grid, tiles and memory traffic and drops or
// replaces one phase of the online softmax, so that differences of times
// attribute cost per phase.  ARM_FULL is the shipped kernel itself.  The
// order is ops/flash_phase_ablation.py's ARMS.  The script's arms are defined
// on natural-log quantities; this kernel keeps scores in the log2 domain
// (x2 = s * scale * log2 e), so each natural-log constant c enters as
// c * LOG2E and each linear map of a natural-log argument x = x2 * LN2 takes
// that factor (see `arm_exp`).  Every other arm starts its running max at
// -1e30 nats, as the script's `_variant_kernel` does, and ends with
// out = acc / (l == 0 ? 1 : l), as acc times one reciprocal a row.  No
// visited tile leaves a row without a valid key here (BM == BN, causal, no
// kv mask), so the script's `where(m_new > -5e29, p, 0)` selects p
// everywhere and is not emitted.
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

template <int D, bool CAUSAL, bool MASK, int ARM = ARM_FULL>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq, int Skv,
                     int Hq, int Hkv, int group, float scale_log2,
                     const float* __restrict__ shift = nullptr) {
  using Dm = FlashDims<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BM * Dm::LD;
  __nv_bfloat16* Vs = Ks + BN * Dm::LD;
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + BN * Dm::LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gi = lane >> 2, ti = lane & 3;  // mma group id / thread in group
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;

  const long qstride = (long)Hq * D, kstride = (long)Hkv * D;
  const __nv_bfloat16* qb = q + ((long)b * Sq * Hq + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Skv * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((long)b * Skv * Hkv + hk) * D;

  load_tile<D, BM, NTHREADS>(Qs, qb, q0, Sq, qstride);
  __syncthreads();

  const int r0 = warp * 16 + gi;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[Dm::KC][4];
#pragma unroll
  for (int kc = 0; kc < Dm::KC; ++kc) load_a(qf[kc], Qs, Dm::LD, warp * 16, kc * 16, gi, ti);

  float o[Dm::NT][4];
#pragma unroll
  for (int nt = 0; nt < Dm::NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums; quad-reduced at the end
  const int row_a = q0 + r0, row_b = row_a + 8;

  // K13 state: the scale in nats, each row's |q| (ARM_STREAMING_ROWM, ARM_BOUND) and
  // the shift read from device memory (ARM_STREAMING_SMEM), in log2 units.
  [[maybe_unused]] const float scale = scale_log2 * LN2;
  [[maybe_unused]] float qn[2] = {0.f, 0.f};
  [[maybe_unused]] float c2 = 0.f;
  if constexpr (ARM != ARM_FULL) m[0] = m[1] = -1e30f * LOG2E;
  if constexpr (ARM == ARM_STREAMING_ROWM || ARM == ARM_BOUND) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* row = Qs + (r0 + 8 * i) * Dm::LD;
      float ss = 0.f;
      for (int c = 0; c < D; ++c) {
        const float x = __bfloat162float(row[c]);
        ss += x * x;
      }
      qn[i] = sqrtf(ss);
    }
  }
  if constexpr (ARM == ARM_STREAMING_SMEM) c2 = *shift * LOG2E;

  int n_tiles = (Skv + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, BN, NTHREADS>(Ks, kb, k0, Skv, kstride);
    load_tile<D, BN, NTHREADS>(Vs, vb, k0, Skv, kstride);
    if (MASK) {
      for (int i = threadIdx.x; i < BN; i += NTHREADS)
        Ms[i] = (k0 + i < Skv) ? kv_mask[(long)b * Skv + k0 + i] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < Dm::KC; ++kc) {
        uint32_t bk[2];
        load_b_rows(bk, Ks, Dm::LD, nt * 8, kc * 16, gi, ti);
        mma16816(s[nt], qf[kc], bk);
      }
    }

    // Scale into the log2 domain and mask.
    const bool edge = (k0 + BN > Skv) || MASK || (CAUSAL && k0 + BN - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int c = nt * 8 + ti * 2 + (e & 1);
          const int col = k0 + c;
          bool ok = col < Skv;
          if (MASK) ok = ok && Ms[c] != 0;
          if (CAUSAL) ok = ok && col <= ((e < 2) ? row_a : row_b);
          if (!ok) x = -INFINITY;
        }
        s[nt][e] = x;
      }
    }

    // O += P V with P = s, into `acc`.  The S accumulators of n-tiles 2c and
    // 2c + 1 are exactly the A fragment of k-chunk c; V's B fragment pairs
    // two keys per register.
    auto pv = [&](float (&acc)[Dm::NT][4]) {
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * c][0], s[2 * c][1]), pack_bf16(s[2 * c][2], s[2 * c][3]),
            pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]), pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int nt = 0; nt < Dm::NT; ++nt) {
          uint32_t bv[2];
          load_b_cols(bv, Vs, Dm::LD, c * 16, nt * 8, gi, ti);
          mma16816(acc[nt], pa, bv);
        }
      }
    };
    // Each row's max of this tile and of mx's values (log2 units), over the quad.
    auto row_max = [&](float (&mx)[2]) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
      }
    };
    // p = f(s, row) in place; returns nothing, adds each row's sum to `sum`.
    auto map_p = [&](auto f, float (&sum)[2]) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = f(s[nt][e], e >> 1);
          sum[e >> 1] += s[nt][e];
        }
      }
    };
    auto rescale = [&](float (&acc)[Dm::NT][4], const float (&a)[2]) {
#pragma unroll
      for (int nt = 0; nt < Dm::NT; ++nt) {
        acc[nt][0] *= a[0];
        acc[nt][1] *= a[0];
        acc[nt][2] *= a[1];
        acc[nt][3] *= a[1];
      }
    };

    if constexpr (ARM == ARM_FULL) {
      // Online softmax: new running max per row (reduced over the quad).
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float alpha[2], base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        // A row with no valid key yet keeps m = -inf; shift by 0 so that
        // exp2(-inf - 0) = 0 and nothing turns into NaN.
        base[i] = (mx[i] == -INFINITY) ? 0.f : mx[i];
        alpha[i] = exp2f(m[i] - base[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - base[0]);
        s[nt][1] = exp2f(s[nt][1] - base[0]);
        s[nt][2] = exp2f(s[nt][2] - base[1]);
        s[nt][3] = exp2f(s[nt][3] - base[1]);
        l[0] += s[nt][0] + s[nt][1];
        l[1] += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int nt = 0; nt < Dm::NT; ++nt) {
        o[nt][0] *= alpha[0];
        o[nt][1] *= alpha[0];
        o[nt][2] *= alpha[1];
        o[nt][3] *= alpha[1];
      }
      pv(o);
    } else if constexpr (ARM == ARM_MXU) {
      // p = s, the natural-log score, straight into the PV product
      float unused[2] = {0.f, 0.f};
      map_p([](float x, int) { return x * LN2; }, unused);
      pv(o);
    } else if constexpr (ARM == ARM_NORED) {
      float unused[2] = {0.f, 0.f};
      map_p([](float x, int) { return exp2f(x * 1e-4f); }, unused);
      if (ti == 0) l[0] += 1.f, l[1] += 1.f;  // once per row: l is summed over the quad
      pv(o);
    } else if constexpr (ARM == ARM_STREAMING || ARM == ARM_STREAMING_SMEM) {
      const float c = ARM == ARM_STREAMING ? 4.f * LOG2E : c2;
      map_p([c](float x, int) { return exp2f(x - c); }, l);
      pv(o);
      if constexpr (ARM == ARM_STREAMING) m[0] = m[1] = 4.f * LOG2E;
    } else if constexpr (ARM == ARM_STREAMING_ROWM) {
      float mj[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) mj[i] = (qn[i] * (20.f * scale) - 20.f) * LOG2E;
      map_p([&mj](float x, int i) { return exp2f(x - mj[i]); }, l);
      pv(o);
      m[0] = mj[0], m[1] = mj[1];
    } else if constexpr (ARM == ARM_LOCAL || ARM == ARM_BOUND) {
      float mj[2];
      if constexpr (ARM == ARM_LOCAL) {
        mj[0] = mj[1] = -INFINITY;
        row_max(mj);
      } else {
        // the tile's max |k|^2: two threads a key row, then over the block
        __shared__ float red[NWARPS];
        const int kr = threadIdx.x >> 1, half = threadIdx.x & 1;
        const __nv_bfloat16* row = Ks + kr * Dm::LD + half * (D / 2);
        float ss = 0.f;
        for (int c = 0; c < D / 2; ++c) {
          const float x = __bfloat162float(row[c]);
          ss += x * x;
        }
        ss += __shfl_xor_sync(FULL, ss, 1);
#pragma unroll
        for (int w = 2; w < 32; w <<= 1) ss = fmaxf(ss, __shfl_xor_sync(FULL, ss, w));
        if (lane == 0) red[warp] = ss;
        __syncthreads();
        float kn2 = red[0];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) kn2 = fmaxf(kn2, red[w]);
#pragma unroll
        for (int i = 0; i < 2; ++i) mj[i] = (qn[i] * (sqrtf(kn2) * scale) - 40.f) * LOG2E;
      }
      float base[2], lj[2] = {0.f, 0.f}, mn[2], ap[2], aj[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) base[i] = (mj[i] == -INFINITY) ? 0.f : mj[i];  // p = 0 in a dead row
      map_p([&base](float x, int i) { return exp2f(x - base[i]); }, lj);
      float oj[Dm::NT][4];
#pragma unroll
      for (int nt = 0; nt < Dm::NT; ++nt) oj[nt][0] = oj[nt][1] = oj[nt][2] = oj[nt][3] = 0.f;
      pv(oj);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mn[i] = fmaxf(m[i], mj[i]);
        ap[i] = exp2f(m[i] - mn[i]);
        aj[i] = exp2f(mj[i] - mn[i]);
        l[i] = l[i] * ap[i] + lj[i] * aj[i];
        m[i] = mn[i];
      }
#pragma unroll
      for (int nt = 0; nt < Dm::NT; ++nt) {
        o[nt][0] = o[nt][0] * ap[0] + oj[nt][0] * aj[0];
        o[nt][1] = o[nt][1] * ap[0] + oj[nt][1] * aj[0];
        o[nt][2] = o[nt][2] * ap[1] + oj[nt][2] * aj[1];
        o[nt][3] = o[nt][3] * ap[1] + oj[nt][3] * aj[1];
      }
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
        map_p([](float x, int) { return exp2f(x * 1e-2f); }, psum);
      } else {
        map_p([&mn](float x, int i) { return arm_exp<ARM>(x - mn[i]); }, psum);
      }
      if constexpr (ARM == ARM_REDONLY) {
        // both reductions consumed into l; m is never updated
        if (ti == 0) psum[0] += mn[0] * LN2 * 1e-9f, psum[1] += mn[1] * LN2 * 1e-9f;
        l[0] += psum[0], l[1] += psum[1];
        pv(o);
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
        pv(o);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(FULL, lt, 1);
    lt += __shfl_xor_sync(FULL, lt, 2);
    if constexpr (ARM == ARM_FULL) {
      inv[i] = lt > 0.f ? 1.f / lt : 0.f;  // no valid key -> zeros
      const int row = i == 0 ? row_a : row_b;
      if (lse != nullptr && ti == 0 && row < Sq)
        lse[((long)b * Hq + h) * Sq + row] = lt > 0.f ? (m[i] + log2f(lt)) * LN2 : -INFINITY;
    } else {
      inv[i] = 1.f / (lt == 0.f ? 1.f : lt);  // the script's acc / l_safe, as one reciprocal
    }
  }
#pragma unroll
  for (int nt = 0; nt < Dm::NT; ++nt) {
    const int col = nt * 8 + ti * 2;
    if (col >= D) continue;
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(out + ((long)b * Sq + row_a) * qstride + (long)h * D + col) =
          pack_bf16(o[nt][0] * inv[0], o[nt][1] * inv[0]);
    if (row_b < Sq)
      *reinterpret_cast<uint32_t*>(out + ((long)b * Sq + row_b) * qstride + (long)h * D + col) =
          pack_bf16(o[nt][2] * inv[1], o[nt][3] * inv[1]);
  }
}

}  // namespace
