// The per-edge, per-head attention score shared by the attention kernels
// (attention_pin.cu, fused_attention.cu, winatt.cu): graphax's
// `_score_math` (graphax/kernels/pallas_attention.py:73-107) for one edge
// and one head, in f32, from the head's q and k slices of dk values each;
// and the row walk's scoring of a batch of edges against the f32 K table
// (the pin and the CSR flash kernels).
//
// att_type: 0 scaled_dot (q pre-scaled by 1/sqrt(dk) by the caller),
// 1 cosine_sim, 2 pearson, 3 exp_kernel (ov2 * exp(-|q - k|^2 * inv2l2))
// in score() and score_head(); 4 beltrami_exp in the kernels' instances
// of their own (the template flag BEL), scored by bel_sum below:
// Beltrami's product of two Gaussian kernels, the head's slice of 2 * (dk
// / 2) values its feature half then its positional half (the host
// interleaves graphax's [feature A | positional A] layout per head), ov2 *
// exp(-|qx - kx|^2 * inv2l2) * ov2p * exp(-|qp - kp|^2 * inv2l2p)
// (graphax's combined-weight trick, graphax/kernels/pallas_attention.py:
// 80-91, 893-915). score() does not score it: every C entry point sends
// att_type 4 to a BEL instance or refuses it.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "row_walk.cuh"

namespace gx_att {

constexpr float COS_EPS = 1e-5f;

// the score's scalars: exp_kernel's (ov2, inv2l2), and beltrami_exp's
// positional pair (ov2p, inv2l2p) beside them
struct Scal {
  float ov2, inv2l2, ov2p, inv2l2p;
};

__device__ __forceinline__ float val(float v) { return v; }
__device__ __forceinline__ float val(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// q's head slice in f32 or the state dtype (its values are exact in f32)
template <typename Q>
__device__ __forceinline__ float score(const Q* q, const float* k, int dk,
                                       int att_type, Scal scal) {
  if (att_type == 0) {
    float s = 0.f;
    for (int i = 0; i < dk; ++i) s += val(q[i]) * k[i];
    return s;
  }
  if (att_type == 3) {
    float sq = 0.f;
    for (int i = 0; i < dk; ++i) {
      const float t = val(q[i]) - k[i];
      sq += t * t;
    }
    return scal.ov2 * expf(-sq * scal.inv2l2);
  }
  float qm = 0.f, km = 0.f;
  if (att_type == 2) {
    for (int i = 0; i < dk; ++i) { qm += val(q[i]); km += k[i]; }
    qm /= (float)dk;
    km /= (float)dk;
  }
  float dot = 0.f, qq = 0.f, kk = 0.f;
  for (int i = 0; i < dk; ++i) {
    const float a = val(q[i]) - qm, b = k[i] - km;
    dot += a * b;
    qq += a * a;
    kk += b * b;
  }
  const float qn = fmaxf(sqrtf(qq), COS_EPS), kn = fmaxf(sqrtf(kk), COS_EPS);
  return dot / (qn * kn);
}

// max and sum over groups of G lanes (xor butterflies of width G)
template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, G));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, G);
  return v;
}

__device__ __forceinline__ float warp_max(float v) { return group_max<32>(v); }
__device__ __forceinline__ float warp_sum(float v) { return group_sum<32>(v); }

// the head's score of one edge: q's head slice (in f32 shared memory, or
// the state dtype in device memory with QV), the K row in device memory,
// read for scaled_dot with kvec (dk % 4 == 0, the table on 16 bytes; with
// QV also q's slice) by 16-byte loads, four of K (and with QV 16 values of
// q) in flight before their products, in the order of score()
template <typename Q = float, bool QV = false>
__device__ __forceinline__ float score_head(const Q* q, const float* kr,
                                            int dk, int att_type,
                                            Scal scal, int kvec) {
  if (att_type == 0 && kvec) {
    constexpr int QE = 16 / (int)sizeof(Q);   // q values in 16 bytes
    float s = 0.f;
    for (int i0 = 0; i0 < dk; i0 += 16) {
      float4 k[4];
      float qf[16];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (i0 + 4 * t < dk)
          k[t] = __ldg(reinterpret_cast<const float4*>(kr + i0 + 4 * t));
      if constexpr (QV) {
#pragma unroll
        for (int t = 0; t < 16 / QE; ++t)
          if (i0 + QE * t < dk) {
            const uint4 v =
                __ldg(reinterpret_cast<const uint4*>(q + i0 + QE * t));
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
            gx_rows::unpack<Q, 16>(w, qf + QE * t);
          }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = i0 + 4 * t;
        if (i < dk) {
          float qv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if constexpr (QV) qv[c] = qf[4 * t + c];
            else qv[c] = val(q[i + c]);
          }
          s += qv[0] * k[t].x;
          s += qv[1] * k[t].y;
          s += qv[2] * k[t].z;
          s += qv[3] * k[t].w;
        }
      }
    }
    return s;
  }
  return score(q, kr, dk, att_type, scal);
}

// ---------------------------------------------------------------------
// beltrami_exp in the kernels' instances (BEL: the pin's, flash's, gmax's
// and the norm's)
// ---------------------------------------------------------------------
//
// Each half's squared distance summed in index order (t = q - k, s += t *
// t), the product ov2 exp(-sx inv2l2) ov2p exp(-sp inv2l2p) left to
// right, so every instance gives every other's scores bit for bit (and
// those of the first form, a __noinline__ helper reading K one value at a
// time, which these replaced: inlined, its loops raised the registers of
// every kernel that scores, whatever its type), inlined into instances
// that score nothing else and, on the vector route, with a half's K
// values read by 16-byte loads, all of them issued before its arithmetic.

// the sum over hk values of (q - k)^2 in index order: one half of a head's
// slice, q and k at the half's first value. vec: hk % 4 == 0 and the half
// of k and q on 16 bytes, 16-byte loads: four float4 of K for 16 values,
// issued before any arithmetic; q f32 in shared memory read by float4
// where it is used, or with QV in the state dtype in device memory by
// uint4, loaded beside K (which needs hk values of q to fill whole 16-byte
// words). Else one value at a time
template <typename Q, bool QV>
__device__ __forceinline__ float bel_sum(const Q* q, const float* k, int hk,
                                         int vec) {
  static_assert(QV || std::is_same<Q, float>::value,
                "q in shared memory is f32");
  float s = 0.f;
  if (!vec) {
    for (int i = 0; i < hk; ++i) {
      const float d = val(q[i]) - k[i];
      s += d * d;
    }
    return s;
  }
  constexpr int QE = 16 / (int)sizeof(Q);   // q values in 16 bytes
  for (int j0 = 0; j0 < hk; j0 += 16) {
    float4 kv[4];
    float qf[QV ? 16 : 1];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + 4 * u < hk)
        kv[u] = __ldg(reinterpret_cast<const float4*>(k + j0 + 4 * u));
    if constexpr (QV) {
#pragma unroll
      for (int u = 0; u < 16 / QE; ++u)
        if (j0 + QE * u < hk) {
          const uint4 v =
              __ldg(reinterpret_cast<const uint4*>(q + j0 + QE * u));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
          gx_rows::unpack<Q, 16>(w, qf + QE * u);
        }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + 4 * u < hk) {
        float qq[4];
        if constexpr (QV) {
#pragma unroll
          for (int c = 0; c < 4; ++c) qq[c] = qf[4 * u + c];
        } else {
          const float4 v = *reinterpret_cast<const float4*>(q + j0 + 4 * u);
          qq[0] = v.x; qq[1] = v.y; qq[2] = v.z; qq[3] = v.w;
        }
        const float kk[4] = {kv[u].x, kv[u].y, kv[u].z, kv[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float d = qq[c] - kk[c];
          s += d * d;
        }
      }
  }
  return s;
}

// the score of a (edge, head) pair on one lane: q's and K's head slices
// (q in the state dtype in device memory, QV; vec as bel_sum's, for each
// half), both halves' squared distances, then ov2 exp(-sx inv2l2) times
// ov2p times exp(-sp inv2l2p), left to right
template <typename Q>
__device__ __forceinline__ float bel_score(const Q* q, const float* k, int dk,
                                           int vec, Scal scal) {
  const int hk = dk >> 1;
  const float sx = bel_sum<Q, true>(q, k, hk, vec);
  const float sp = bel_sum<Q, true>(q + hk, k + hk, hk, vec);
  const float u = scal.ov2 * expf(-sx * scal.inv2l2);
  return u * scal.ov2p * expf(-sp * scal.inv2l2p);
}

// the score of a (edge, head) pair held by two neighbouring lanes, each
// with its half's squared distance sq (half 0 the feature half): the even
// lane's ov2 exp(-sx inv2l2) times ov2p times the odd lane's exp(-sp
// inv2l2p), bel_score's product in its order; valid on the even lane.
// Every lane of the warp calls it (one shuffle)
__device__ __forceinline__ float bel_lanes_score(float sq, int half,
                                                 Scal scal) {
  const float u = half ? expf(-sq * scal.inv2l2p)
                       : scal.ov2 * expf(-sq * scal.inv2l2);
  return u * scal.ov2p * __shfl_xor_sync(0xffffffffu, u, 1);
}

// floats of one warp's shared memory in the row walk's scoring kernels (the
// pin's and flash's): q [a], two per-head tables [h] each, the batch's
// scores [BATCH, h]; the beltrami_exp instances (bel) round it up to 4, so
// every warp's q starts on 16 bytes for bel_sum's float4 reads (the host's
// fused_attention.flash_warps counts the same)
__host__ __device__ __forceinline__ int warp_stride(int a, int h, bool bel) {
  const int f = a + 2 * h + gx_rows::BATCH * h;
  return bel ? (f + 3) & ~3 : f;
}

// the batch's edges e0 + j, j < cnt, one per lane: lane j loads edge j's
// column (or takes `pre`, loaded ahead by the caller, when pre >= 0) and
// returns it; then lanes over the batch's (edge, head) pairs write the
// scores against the row's q in shared memory (times the reweight value)
// to ws[j * h + hh]. BEL: beltrami_exp's instance, two lanes a pair (lane
// 2p the feature half of pair p, 2p + 1 its positional half; kvec:
// bel_sum's vector route, which needs q's row in shared memory on 16
// bytes)
template <bool BEL = false>
__device__ __forceinline__ int batch_scores(
    const float* qs, const float* __restrict__ kt, const int* __restrict__ idx,
    const float* __restrict__ ew, int e0, int cnt, int a, int h, int att_type,
    Scal scal, int kvec, float* ws, int lane, int pre = -1) {
  __syncwarp();  // every lane is done with the last batch's ws
  int col = 0;
  if (lane < cnt) col = pre >= 0 ? pre : idx[e0 + lane];
  const int dk = a / h, pairs = cnt * h;
  if constexpr (BEL) {
    const int hk = dk >> 1;
    for (int p0 = 0; p0 < 2 * pairs; p0 += 32) {
      const int hp = p0 + lane, p = hp >> 1, half = hp & 1;
      const int j = p / h, hh = p - j * h;
      const int c = __shfl_sync(0xffffffffu, col, j & 31);
      float sq = 0.f;
      if (p < pairs) {
        const int o = hh * dk + half * hk;
        sq = bel_sum<float, false>(qs + o, kt + (size_t)c * a + o, hk, kvec);
      }
      float s = bel_lanes_score(sq, half, scal);
      if (p < pairs && !half) {
        if (ew != nullptr) s *= ew[e0 + j];
        ws[p] = s;
      }
    }
  } else {
    for (int p0 = 0; p0 < pairs; p0 += 32) {
      const int p = p0 + lane, j = p / h, hh = p - j * h;
      const int c = __shfl_sync(0xffffffffu, col, j & 31);
      if (p < pairs) {
        float s = score_head(qs + hh * dk, kt + (size_t)c * a + hh * dk, dk,
                             att_type, scal, kvec);
        if (ew != nullptr) s *= ew[e0 + j];
        ws[p] = s;
      }
    }
  }
  __syncwarp();
  return col;
}

}  // namespace gx_att
