// GRAND-nl's windowed attention kernel (K5): the in-window part of the
// per-step attention RHS on the windowed layout.
//
// Replaces graphax/kernels/pallas_winatt.py `_make_winatt_kernel` (:43,
// called by `_winatt_call` :113 from `_make_winatt` :156-238). Per row r and
// head h, over the row's in-window cells c (its tile's window):
//   s_c   = the score of q[r] and k[c] (scaled_dot: the f32 dot product of
//           the unscaled q and k over sqrt(dk); cosine_sim and pearson in
//           f32; exp_kernel ov2 exp(-(|q|^2 + |k|^2 - 2 q.k) inv2l2)), times
//           the cell's weight with reweight (:60-92);
//   shift = max(max_c s_c, r0 - 70), 0 if it is <= NEG/2 (:94-95), r0 the
//           residual scores' global max;
//   e_c   = exp(s_c - shift);
//   d     = sum_c e_c + d_res[r, h] exp(clip(r0 - shift, +-70)) (:97-98),
//           d_res the residual's row sums in r0's frame;
//   pbar_c += e_c / (d > 0 ? d : 1)                                  (:99)
//   den[r, h] = d exp(clip(shift - r0, +-70)), the combined denominator
//           back in r0's frame (:100);
// then out[r] = sum_c rnd(pbar_c / H) x[c] in f32 (:102-104), rnd the state
// dtype's rounding.
//
// Design. graphax's kernel walks each 128-row tile's dense [128, W] block of
// the window (W = 512 on ogbn-arxiv: 86.7 M cells, 0.66 % of them set),
// computing the scores of every cell on the MXU and masking the empty ones.
// Here one warp owns a row and walks only its occupied cells (the layout's
// in-window CSR, WindowLayout.in_window: each cell once, in column order):
// the empty cells add zeros to every sum, so the function is the same.
// Pass 1, lanes over the row's (cell, head) pairs, writes the f32 scores to
// an [Ew, H] scratch; per head a warp max, a warp sum of e and the
// denominator (lane 0 writes den); pass 2, lanes over columns (8 per lane,
// 256-wide chunks of D), walks the cells in order and sums rnd(pbar / H) *
// x[c] into f32 registers (a bf16 x bf16 product is exact in f32). No
// atomics: the results do not depend on the schedule.
//
// What bounds it on an H100 at ogbn-arxiv's shapes (N = 169,343, 575,621
// in-window edges, D = 162, A = 32, H = 2, bf16): bytes. It must read q, k
// and x (76 MB), the cell lists (3 MB), d_res, and write the f32 output and
// den (111 MB): ~0.057 ms at 3.35 TB/s, against ~0.2 GFLOP. This simple
// version gathers k[c] and x[c] per cell (rows of one window stay in L2) and
// walks each row serially per warp, as flash_kernel does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_score.cuh"

namespace {

constexpr int WPB = 8;    // warps (rows in flight) per block
constexpr int CPL = 8;    // columns per lane in one pass-2 chunk (256 wide)
constexpr float NEG = -1e30f;
constexpr float CLIP = 70.f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float clip(float v) {
  return fminf(fmaxf(v, -CLIP), CLIP);
}

// K5's score of the row's q head slice (f32, shared memory) against k[c]'s
// head slice in the state dtype
template <typename T>
__device__ __forceinline__ float win_score(const float* qh, const T* kh,
                                           int dk, int att_type, float sqrt_dk,
                                           float ov2, float inv2l2) {
  if (att_type == 0) {
    float dot = 0.f;
    for (int i = 0; i < dk; ++i) dot += qh[i] * to_f(kh[i]);
    return dot / sqrt_dk;
  }
  if (att_type == 3) {
    float qq = 0.f, kk = 0.f, qk = 0.f;
    for (int i = 0; i < dk; ++i) {
      const float kv = to_f(kh[i]);
      qq += qh[i] * qh[i];
      kk += kv * kv;
      qk += qh[i] * kv;
    }
    return ov2 * expf(-((qq + kk) - 2.f * qk) * inv2l2);
  }
  float qm = 0.f, km = 0.f;
  if (att_type == 2) {
    for (int i = 0; i < dk; ++i) { qm += qh[i]; km += to_f(kh[i]); }
    qm /= (float)dk;
    km /= (float)dk;
  }
  float dot = 0.f, qq = 0.f, kk = 0.f;
  for (int i = 0; i < dk; ++i) {
    const float u = qh[i] - qm, v = to_f(kh[i]) - km;
    dot += u * v;
    qq += u * u;
    kk += v * v;
  }
  const float qn = fmaxf(sqrtf(qq), gx_att::COS_EPS);
  const float kn = fmaxf(sqrtf(kk), gx_att::COS_EPS);
  return dot / (qn * kn);
}

template <typename T>
__global__ void __launch_bounds__(WPB * 32)
winatt_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
              const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ x, const float* __restrict__ ew,
              const float* __restrict__ dres, const float* __restrict__ r0p,
              float* __restrict__ sc, float* __restrict__ out,
              float* __restrict__ den, int n, int d, int a, int h,
              int att_type, float ov2, float inv2l2) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem + (size_t)w * (a + 2 * h);  // [a] q of the row
  float* ms = qs + a;                          // [h] shift per head
  float* ds = ms + h;                          // [h] d, zero-selected
  const int r = blockIdx.x * WPB + w;
  if (r >= n) return;
  const int beg = ptr[r], end = ptr[r + 1];
  const float r0 = *r0p;
  const int dk = a / h;
  const float sqrt_dk = sqrtf((float)dk);
  for (int i = lane; i < a; i += 32) qs[i] = to_f(q[(size_t)r * a + i]);
  __syncwarp();

  // pass 1: the scores of every (cell, head) pair
  const int pairs = (end - beg) * h;
  for (int p = lane; p < pairs; p += 32) {
    const int e = beg + p / h, hh = p % h;
    float s = win_score<T>(qs + hh * dk, k + (size_t)idx[e] * a + hh * dk, dk,
                           att_type, sqrt_dk, ov2, inv2l2);
    if (ew != nullptr) s *= ew[e];
    sc[(size_t)e * h + hh] = s;
  }
  __syncwarp();
  // per head: the shift, the denominator merged with the residual's, den
  for (int hh = 0; hh < h; ++hh) {
    float m = -INFINITY;
    for (int e = beg + lane; e < end; e += 32) m = fmaxf(m, sc[(size_t)e * h + hh]);
    m = warp_max(m);
    float shift = fmaxf(m, r0 - CLIP);
    if (shift <= NEG * 0.5f) shift = 0.f;
    float sum = 0.f;
    for (int e = beg + lane; e < end; e += 32) sum += expf(sc[(size_t)e * h + hh] - shift);
    sum = warp_sum(sum);
    if (lane == 0) {
      const float dd = sum + dres[(size_t)r * h + hh] * expf(clip(r0 - shift));
      den[(size_t)r * h + hh] = dd * expf(clip(shift - r0));
      ms[hh] = shift;
      ds[hh] = dd > 0.f ? dd : 1.f;
    }
  }
  __syncwarp();

  // pass 2: out[r] = sum_c rnd(pbar_c / H) x[c], in cell order
  const float inv_h = 1.f / (float)h;
  float* orow = out + (size_t)r * d;
  for (int c0 = 0; c0 < d; c0 += 32 * CPL) {
    float acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
    for (int e = beg; e < end; ++e) {
      float pb = 0.f;
      for (int hh = 0; hh < h; ++hh)
        pb += expf(sc[(size_t)e * h + hh] - ms[hh]) / ds[hh];
      const float wt = rnd<T>(pb * inv_h);
      const T* xr = x + (size_t)idx[e] * d;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int i = c0 + lane + 32 * j;
        if (i < d) acc[j] += wt * to_f(xr[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int i = c0 + lane + 32 * j;
      if (i < d) orow[i] = acc[j];
    }
  }
}

template <typename T>
cudaError_t run_winatt(const void* ptr, const void* idx, const void* q,
                       const void* k, const void* x, const void* ew,
                       const void* dres, const void* r0, void* sc, void* out,
                       void* den, int n, int d, int a, int h, int att_type,
                       float ov2, float inv2l2, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)WPB * (a + 2 * h);
  winatt_kernel<T><<<(n + WPB - 1) / WPB, WPB * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)k,
      (const T*)x, (const float*)ew, (const float*)dres, (const float*)r0,
      (float*)sc, (float*)out, (float*)den, n, d, a, h, att_type, ov2,
      inv2l2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptr [n + 1] and idx [Ew] int32: the in-window cells of each row (idx the
// column); q (unscaled), k [n, a] and x [n, d] in one dtype (0 float32, 1
// bfloat16); ew [Ew] float32 cell weights or null; dres [n, h] float32; r0
// [1] float32; sc [Ew, h] float32 scratch; out [n, d] and den [n, h] float32.
int gx_winatt(const void* ptr, const void* idx, const void* q, const void* k,
              const void* x, const void* ew, const void* dres, const void* r0,
              void* sc, void* out, void* den, int n, int d, int a, int h,
              int att_type, int reweight, float ov2, float inv2l2, int dtype,
              void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const void* ewp = reweight ? ew : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)run_winatt<float>(ptr, idx, q, k, x, ewp, dres, r0, sc, out,
                                  den, n, d, a, h, att_type, ov2, inv2l2, s);
  if (dtype == 1)
    return (int)run_winatt<__nv_bfloat16>(ptr, idx, q, k, x, ewp, dres, r0,
                                          sc, out, den, n, d, a, h, att_type,
                                          ov2, inv2l2, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
