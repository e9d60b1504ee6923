// The per-edge, per-head attention score shared by the attention kernels
// (attention_pin.cu, fused_attention.cu, winatt.cu): graphax's
// `_score_math` (graphax/kernels/pallas_attention.py:73-107) for one edge
// and one head, in f32, from the head's q and k slices of dk values each;
// and the row walk's scoring of a batch of edges against the f32 K table
// (the pin and the CSR flash kernels).
//
// att_type: 0 scaled_dot (q pre-scaled by 1/sqrt(dk) by the caller),
// 1 cosine_sim, 2 pearson, 3 exp_kernel (ov2 * exp(-|q - k|^2 * inv2l2)),
// 4 beltrami_exp: Beltrami's product of two Gaussian kernels, the head's
// slice of 2 * (dk / 2) values its feature half then its positional half
// (the host interleaves graphax's [feature A | positional A] layout per
// head), ov2 * exp(-|qx - kx|^2 * inv2l2) * ov2p * exp(-|qp - kp|^2 *
// inv2l2p) (graphax's combined-weight trick,
// graphax/kernels/pallas_attention.py:80-91, 893-915).

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

// beltrami_exp: exp_kernel's arithmetic on each half of the head's slice,
// the product in graphax's order. Not inlined: inlined, its second loop
// and scalars raised the register count of every kernel that scores (the
// pin kernel spilled at its 48-register bound), whatever its score type.
// Reading K here by 16-byte loads slowed the other score types' kernels by
// 10-22 % (PERF.md), so the loop reads one value at a time
template <typename Q>
__device__ __noinline__ float beltrami(const Q* q, const float* k, int dk,
                                       float ov2, float inv2l2, float ov2p,
                                       float inv2l2p) {
  const int hk = dk >> 1;
  float sx = 0.f, sp = 0.f;
  for (int i = 0; i < hk; ++i) {
    const float t = val(q[i]) - k[i];
    sx += t * t;
  }
  for (int i = hk; i < dk; ++i) {
    const float t = val(q[i]) - k[i];
    sp += t * t;
  }
  return ov2 * expf(-sx * inv2l2) * ov2p * expf(-sp * inv2l2p);
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
  if (att_type == 4)
    return beltrami(q, k, dk, scal.ov2, scal.inv2l2, scal.ov2p, scal.inv2l2p);
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

// the batch's edges e0 + j, j < cnt, one per lane: lane j loads edge j's
// column (or takes `pre`, loaded ahead by the caller, when pre >= 0) and
// returns it; then lanes over the batch's (edge, head) pairs write the
// scores against the row's q in shared memory (times the reweight value)
// to ws[j * h + hh]
__device__ __forceinline__ int batch_scores(
    const float* qs, const float* __restrict__ kt, const int* __restrict__ idx,
    const float* __restrict__ ew, int e0, int cnt, int a, int h, int att_type,
    Scal scal, int kvec, float* ws, int lane, int pre = -1) {
  __syncwarp();  // every lane is done with the last batch's ws
  int col = 0;
  if (lane < cnt) col = pre >= 0 ? pre : idx[e0 + lane];
  const int dk = a / h, pairs = cnt * h;
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
  __syncwarp();
  return col;
}

}  // namespace gx_att
