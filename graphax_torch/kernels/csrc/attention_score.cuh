// The per-edge, per-head attention score shared by the attention kernels
// (attention_pin.cu, fused_attention.cu): graphax's `_score_math`
// (graphax/kernels/pallas_attention.py:73-107) for one edge and one head, in
// f32, from the head's q and k slices of dk values each.
//
// att_type: 0 scaled_dot (q pre-scaled by 1/sqrt(dk) by the caller),
// 1 cosine_sim, 2 pearson, 3 exp_kernel (ov2 * exp(-|q - k|^2 * inv2l2)).

#pragma once

#include <math.h>

namespace gx_att {

constexpr float COS_EPS = 1e-5f;

__device__ __forceinline__ float score(const float* q, const float* k, int dk,
                                       int att_type, float ov2, float inv2l2) {
  if (att_type == 0) {
    float s = 0.f;
    for (int i = 0; i < dk; ++i) s += q[i] * k[i];
    return s;
  }
  if (att_type == 3) {
    float sq = 0.f;
    for (int i = 0; i < dk; ++i) {
      const float t = q[i] - k[i];
      sq += t * t;
    }
    return ov2 * expf(-sq * inv2l2);
  }
  float qm = 0.f, km = 0.f;
  if (att_type == 2) {
    for (int i = 0; i < dk; ++i) { qm += q[i]; km += k[i]; }
    qm /= (float)dk;
    km /= (float)dk;
  }
  float dot = 0.f, qq = 0.f, kk = 0.f;
  for (int i = 0; i < dk; ++i) {
    const float a = q[i] - qm, b = k[i] - km;
    dot += a * b;
    qq += a * a;
    kk += b * b;
  }
  const float qn = fmaxf(sqrtf(qq), COS_EPS), kn = fmaxf(sqrtf(kk), COS_EPS);
  return dot / (qn * kn);
}

}  // namespace gx_att
