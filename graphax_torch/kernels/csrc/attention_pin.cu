// Attention pin: per-edge head-mean of the row-softmax transformer attention.
//
// Replaces graphax/kernels/pallas_attention.py: `_make_scores_kernel` (K1,
// :114, called by `_scores_call` :160: k = x[col] Wk + bk per edge, the
// per-edge per-head scores of `_score_math` :73-107 with optional reweight,
// and the per-(row, head) max), `_make_norm_kernel` (K2, :197, called by
// `_norm_call` :235, softmax mode: exp(s - rowmax) and the per-(row, head)
// denominators) and the normalise-and-mean of `attention_edge_means_pallas`
// (:976-991: att = e / where(d > 0, d, 1), mean over heads).
//
// What bounds it on an H100: neither side by much at the slice's shapes.
// Per edge it gathers one source row (D values), projects it through Wk
// (2*D*A flops: 10.4 kflop at D=162, A=32) and writes one f32 value, so it
// does ~30 flops per byte of device memory, below the ~300 needed to be
// compute-bound on tensor cores but above what the CUDA cores (67 TFLOP/s
// f32) sustain per byte at 3.35 TB/s (~20). This simple version runs the
// projection on the CUDA cores in f32, so it is bound by f32 operations.
//
// Design: one warp per destination row walks the row's CSR segment, so the
// row max and the denominators need no atomics and no second kernel:
//   pass 1 (per edge): the warp stages x[col] in shared memory, each lane
//     computes k[a] for its attention columns against Wk held in shared
//     memory for the whole block (loaded once per block; the grid strides
//     over rows), one lane per head scores the edge, stores the score in
//     an [E, H] f32 scratch and keeps the running max;
//   pass 2 (per head lane): sum exp(s - max) over the row in edge order;
//   pass 3 (lanes over edges): mean_h exp(s - max_h) / where(d_h > 0, d_h, 1).
// The scratch round trip is E*H*8 bytes, small beside the row gathers.
// The Q projection stays a dense matmul outside (graphax leaves it to XLA).
//
// Not yet done (later work): the projection on tensor cores (mma.sync /
// wgmma over a tile of gathered rows), or computing K = x Wk once per node
// and gathering K rows (A values instead of D per edge).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_score.cuh"

namespace {

constexpr int WPB = 8;  // warps (rows in flight) per block

using gx_att::score;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(WPB * 32)
pin_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
           const T* __restrict__ q, const T* __restrict__ x,
           const T* __restrict__ wk, const float* __restrict__ bk,
           const float* __restrict__ ew, float* __restrict__ scores,
           float* __restrict__ out, int n, int d, int a_dim, int h_dim,
           int att_type, float ov2, float inv2l2) {
  extern __shared__ float smem[];
  float* wk_s = smem;                       // [d, a]
  float* bk_s = wk_s + (size_t)d * a_dim;   // [a]
  const int per_warp = d + 2 * a_dim + 2 * h_dim;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = bk_s + a_dim + w * per_warp;  // [d] gathered source row
  float* qs = xs + d;                       // [a] q of the row
  float* ks = qs + a_dim;                   // [a] k of the edge
  float* ms = ks + a_dim;                   // [h] row max per head
  float* ds = ms + h_dim;                   // [h] denominator per head

  for (int i = threadIdx.x; i < d * a_dim; i += blockDim.x) wk_s[i] = to_f(wk[i]);
  for (int i = threadIdx.x; i < a_dim; i += blockDim.x) bk_s[i] = bk[i];
  __syncthreads();

  const int dk = a_dim / h_dim;
  for (int r = blockIdx.x * WPB + w; r < n; r += gridDim.x * WPB) {
    const int beg = ptr[r], end = ptr[r + 1];
    if (beg == end) continue;
    for (int i = lane; i < a_dim; i += 32) qs[i] = to_f(q[(size_t)r * a_dim + i]);
    float m = -INFINITY;
    for (int e = beg; e < end; ++e) {
      const T* xr = x + (size_t)idx[e] * d;
      __syncwarp();
      for (int i = lane; i < d; i += 32) xs[i] = to_f(xr[i]);
      __syncwarp();
      for (int i = lane; i < a_dim; i += 32) {
        float acc = 0.f;
        for (int j = 0; j < d; ++j) acc += xs[j] * wk_s[j * a_dim + i];
        ks[i] = acc + bk_s[i];
      }
      __syncwarp();
      if (lane < h_dim) {
        float s = score(qs + lane * dk, ks + lane * dk, dk, att_type, ov2, inv2l2);
        if (ew != nullptr) s *= ew[e];
        scores[(size_t)e * h_dim + lane] = s;
        m = fmaxf(m, s);
      }
    }
    if (lane < h_dim) {
      float den = 0.f;
      for (int e = beg; e < end; ++e) den += expf(scores[(size_t)e * h_dim + lane] - m);
      ms[lane] = m;
      ds[lane] = den;
    }
    __syncwarp();
    for (int e = beg + lane; e < end; e += 32) {
      float sum = 0.f;
      for (int h = 0; h < h_dim; ++h) {
        const float den = ds[h];
        sum += expf(scores[(size_t)e * h_dim + h] - ms[h]) / (den > 0.f ? den : 1.f);
      }
      out[e] = sum / (float)h_dim;
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t run(const void* ptr, const void* idx, const void* q, const void* x,
                const void* wk, const void* bk, const void* ew, void* scores,
                void* out, int n, int d, int a_dim, int h_dim, int att_type,
                float ov2, float inv2l2, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((size_t)d * a_dim + a_dim + (size_t)WPB * (d + 2 * a_dim + 2 * h_dim));
  cudaError_t err = cudaFuncSetAttribute(
      pin_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int grid = (n + WPB - 1) / WPB;
  const int cap = sms > 0 ? sms * 8 : 1024;
  if (grid > cap) grid = cap;
  pin_kernel<T><<<grid, WPB * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)x, (const T*)wk,
      (const float*)bk, (const float*)ew, (float*)scores, (float*)out, n, d,
      a_dim, h_dim, att_type, ov2, inv2l2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [n, a], x [n, d], wk [d, a] share dtype (0 float32, 1 bfloat16); bk [a]
// float32; ew [E] float32 reweight values or null; scores [E, h] float32
// scratch; out [E] float32 head-mean attention per CSR slot. Rows with no
// edge are skipped. Returns the cudaError_t of the launch.
int gx_attention_pin(const void* ptr, const void* idx, const void* q,
                     const void* x, const void* wk, const void* bk,
                     const void* ew, void* scores, void* out, int n, int d,
                     int a_dim, int h_dim, int att_type, int reweight,
                     float ov2, float inv2l2, int dtype, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const void* ewp = reweight ? ew : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)run<float>(ptr, idx, q, x, wk, bk, ewp, scores, out, n, d,
                           a_dim, h_dim, att_type, ov2, inv2l2, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(ptr, idx, q, x, wk, bk, ewp, scores, out, n,
                                   d, a_dim, h_dim, att_type, ov2, inv2l2, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
