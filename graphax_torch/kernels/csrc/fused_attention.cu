// GRAND-nl's evaluation RHS: graph flash attention over the CSR layout.
//
// Replaces graphax/kernels/pallas_attention.py:
//   - `_make_flash_kernel` (:359, called by `_flash_call` :448): per row
//     tile, the K projection of the gathered sources, the per-edge per-head
//     scores of `_score_math`, an online row softmax (or squareplus with a
//     fixed global shift), the per-(row, head) denominators, the weighted
//     value sums and their head mean, out = mean_h acc / (d + 1e-16);
//   - `_make_gmax_kernel` (:481, called by `_gmax_call` :509): the global max
//     of the scores, squareplus's shift, 0 when no edge is real.
//
// Three kernels here:
//   kproj_kernel  K[N, A] = x Wk + bk in f32, once per node. graphax projects
//                 every gathered source row inside its kernels (E rows); the
//                 per-node pass computes the same values (f32 sums of exact
//                 state-dtype products, in another order) from N rows:
//                 2*N*D*A flops instead of 2*E*D*A.
//   gmax_kernel   one warp per CSR row scores its edges against K[col]; a
//                 warp max, a block max, one atomicMax per block on an
//                 order-preserving integer encoding (max is order-free, so
//                 the result does not depend on the schedule); the last block
//                 to finish decodes it and applies graphax's NEG/2 rule.
//   flash_kernel  one warp per CSR row, two passes over the row's edges:
//                 pass 1 scores every (edge, head) pair (lanes over pairs)
//                 into an [E, H] f32 scratch; then per head the row max
//                 (softmax; squareplus takes the global shift) and the
//                 denominator d, each a warp reduction; pass 2 walks the
//                 edges in order, lanes over columns (8 per lane, 256-wide
//                 chunks of D), and sums c_h * rnd(x[col] * rnd(e_h)) with
//                 c_h = 1 / (H (d_h + 1e-16)) into f32 registers. rnd() is
//                 graphax's rounding point (:435): e cast to the state dtype
//                 and multiplied in it. No atomics; a row with no edge
//                 writes 0.
//
// Semantics against graphax: the softmax shift is the row's final max (two
// passes), where graphax's online recurrence shifts each 128-row tile's
// block of edges by the running max and rescales; in f32 the two agree to
// rounding, in bf16 the rounded e differ by a bf16 rounding of their own.
//
// What bounds them on an H100 at the slice's shapes (N = 169,343, E =
// 1,354,429, D = 162, A = 32, H = 2, bf16): bytes. The flash kernel must read
// x, q, K and the CSR once and write the f32 output (~200 MB, 0.06 ms at
// 3.35 TB/s) against ~1 GFLOP; kproj reads x once and writes K (~77 MB)
// against 1.76 GFLOP on CUDA cores. This simple version gathers K[col] and
// x[col] per edge (L2-resident K, 22 MB) and walks each row serially per
// warp; it is latency-bound on those gathers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_score.cuh"

namespace {

constexpr int WPB = 8;     // warps (rows in flight) per block
constexpr int CPL = 8;     // columns per lane in one pass-2 chunk (256 wide)
constexpr int KROWS = 4;   // rows per warp at a time in the K projection
constexpr float EPS = 1e-16f;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// one rounding to the state dtype T
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

// softmax: exp(z); squareplus: (z + sqrt(z^2 + 4)) / 2
template <bool SQP>
__device__ __forceinline__ float weight(float z) {
  return SQP ? (z + sqrtf(z * z + 4.f)) * 0.5f : expf(z);
}

// monotone map of floats onto unsigned ints; 0 lies below every float
__device__ __forceinline__ unsigned enc(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float dec(unsigned v) {
  return __uint_as_float((v & 0x80000000u) ? (v & 0x7fffffffu) : ~v);
}

// the score of edge e, head hh, against the row's q in shared memory
__device__ __forceinline__ float edge_score(const float* qs, const float* kt,
                                            const int* idx, const float* ew,
                                            int e, int hh, int a, int dk,
                                            int att_type, float ov2,
                                            float inv2l2) {
  float s = gx_att::score(qs + hh * dk, kt + (size_t)idx[e] * a + hh * dk, dk,
                          att_type, ov2, inv2l2);
  if (ew != nullptr) s *= ew[e];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(WPB * 32)
kproj_kernel(const T* __restrict__ x, const T* __restrict__ wk,
             const float* __restrict__ bk, float* __restrict__ kt, int n,
             int d, int a) {
  extern __shared__ float smem[];
  float* wk_s = smem;                                    // [d, a]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = wk_s + (size_t)d * a + (size_t)w * KROWS * d;  // [KROWS, d]
  for (int i = threadIdx.x; i < d * a; i += blockDim.x) wk_s[i] = to_f(wk[i]);
  __syncthreads();
  const int stride = gridDim.x * WPB * KROWS;
  for (int r0 = (blockIdx.x * WPB + w) * KROWS; r0 < n; r0 += stride) {
    const int nr = min(KROWS, n - r0);
    __syncwarp();
    for (int i = lane; i < nr * d; i += 32) xs[i] = to_f(x[(size_t)r0 * d + i]);
    __syncwarp();
    for (int c = lane; c < a; c += 32) {
      float acc[KROWS];
#pragma unroll
      for (int r = 0; r < KROWS; ++r) acc[r] = 0.f;
      for (int j = 0; j < d; ++j) {
        const float wv = wk_s[j * a + c];
#pragma unroll
        for (int r = 0; r < KROWS; ++r)
          if (r < nr) acc[r] += xs[r * d + j] * wv;
      }
      const float b = bk[c];
#pragma unroll
      for (int r = 0; r < KROWS; ++r)
        if (r < nr) kt[(size_t)(r0 + r) * a + c] = acc[r] + b;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(WPB * 32)
gmax_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
            const T* __restrict__ q, const float* __restrict__ kt,
            const float* __restrict__ ew, unsigned* __restrict__ state,
            float* __restrict__ out, int n, int a, int h, int att_type,
            float ov2, float inv2l2) {
  extern __shared__ float smem[];
  __shared__ unsigned bmax;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem + (size_t)w * a;
  if (threadIdx.x == 0) bmax = 0u;
  __syncthreads();
  const int dk = a / h;
  float m = -INFINITY;
  for (int r = blockIdx.x * WPB + w; r < n; r += gridDim.x * WPB) {
    const int beg = ptr[r], end = ptr[r + 1];
    if (beg == end) continue;
    __syncwarp();
    for (int i = lane; i < a; i += 32) qs[i] = to_f(q[(size_t)r * a + i]);
    __syncwarp();
    const int pairs = (end - beg) * h;
    for (int p = lane; p < pairs; p += 32) {
      const int e = beg + p / h, hh = p % h;
      m = fmaxf(m, edge_score(qs, kt, idx, ew, e, hh, a, dk, att_type, ov2,
                              inv2l2));
    }
  }
  m = warp_max(m);
  if (lane == 0 && m > -INFINITY) atomicMax(&bmax, enc(m));
  __syncthreads();
  if (threadIdx.x == 0) {
    if (bmax != 0u) atomicMax(&state[0], bmax);
    __threadfence();
    if (atomicAdd(&state[1], 1u) == gridDim.x - 1) {
      const unsigned v = atomicAdd(&state[0], 0u);
      const float g = v != 0u ? dec(v) : 0.f;
      *out = g <= NEG * 0.5f ? 0.f : g;
    }
  }
}

template <typename T, bool SQP>
__global__ void __launch_bounds__(WPB * 32)
flash_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
             const T* __restrict__ q, const T* __restrict__ x,
             const float* __restrict__ kt, const float* __restrict__ ew,
             const float* __restrict__ gshift, float* __restrict__ sc,
             float* __restrict__ out, int n, int d, int a, int h,
             int att_type, float ov2, float inv2l2) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = smem + (size_t)w * (a + 2 * h);  // [a] q of the row
  float* ms = qs + a;                          // [h] shift per head
  float* cs = ms + h;                          // [h] 1 / (H (d + EPS))
  const int r = blockIdx.x * WPB + w;
  if (r >= n) return;
  const int beg = ptr[r], end = ptr[r + 1];
  float* orow = out + (size_t)r * d;
  if (beg == end) {
    for (int i = lane; i < d; i += 32) orow[i] = 0.f;
    return;
  }
  const int dk = a / h;
  for (int i = lane; i < a; i += 32) qs[i] = to_f(q[(size_t)r * a + i]);
  __syncwarp();

  // pass 1: scores of every (edge, head) pair of the row
  const int pairs = (end - beg) * h;
  for (int p = lane; p < pairs; p += 32) {
    const int e = beg + p / h, hh = p % h;
    sc[(size_t)e * h + hh] =
        edge_score(qs, kt, idx, ew, e, hh, a, dk, att_type, ov2, inv2l2);
  }
  __syncwarp();

  // per head: the shift and the denominator (f32 e, not rounded)
  const float g = SQP ? *gshift : 0.f;
  for (int hh = 0; hh < h; ++hh) {
    float m = g;
    if (!SQP) {
      m = -INFINITY;
      for (int e = beg + lane; e < end; e += 32) m = fmaxf(m, sc[(size_t)e * h + hh]);
      m = warp_max(m);
    }
    float den = 0.f;
    for (int e = beg + lane; e < end; e += 32) den += weight<SQP>(sc[(size_t)e * h + hh] - m);
    den = warp_sum(den);
    if (lane == 0) {
      ms[hh] = m;
      cs[hh] = 1.f / ((float)h * (den + EPS));
    }
  }
  __syncwarp();

  // pass 2: the head mean of the normalised weighted sums, in edge order
  for (int c0 = 0; c0 < d; c0 += 32 * CPL) {
    float acc[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[k] = 0.f;
    for (int e = beg; e < end; ++e) {
      const T* xr = x + (size_t)idx[e] * d;
      float xv[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int i = c0 + lane + 32 * k;
        xv[k] = i < d ? to_f(xr[i]) : 0.f;
      }
      for (int hh = 0; hh < h; ++hh) {
        const float wt = rnd<T>(weight<SQP>(sc[(size_t)e * h + hh] - ms[hh]));
        const float c = cs[hh];
#pragma unroll
        for (int k = 0; k < CPL; ++k) acc[k] += c * rnd<T>(xv[k] * wt);
      }
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int i = c0 + lane + 32 * k;
      if (i < d) orow[i] = acc[k];
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

template <typename T>
cudaError_t run_kproj(const void* x, const void* wk, const void* bk, void* kt,
                      int n, int d, int a, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)d * a + (size_t)WPB * KROWS * d);
  cudaError_t err = cudaFuncSetAttribute(
      kproj_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int grid = (n + WPB * KROWS - 1) / (WPB * KROWS);
  const int cap = sm_count() * 8;
  if (grid > cap) grid = cap;
  kproj_kernel<T><<<grid, WPB * 32, smem, s>>>((const T*)x, (const T*)wk,
                                               (const float*)bk, (float*)kt, n,
                                               d, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_gmax(const void* ptr, const void* idx, const void* q,
                     const void* kt, const void* ew, void* state, void* out,
                     int n, int a, int h, int att_type, float ov2,
                     float inv2l2, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)WPB * a;
  int grid = (n + WPB - 1) / WPB;
  const int cap = sm_count() * 8;
  if (grid > cap) grid = cap;
  gmax_kernel<T><<<grid, WPB * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const float*)kt,
      (const float*)ew, (unsigned*)state, (float*)out, n, a, h, att_type, ov2,
      inv2l2);
  return cudaGetLastError();
}

template <typename T, bool SQP>
cudaError_t run_flash(const void* ptr, const void* idx, const void* q,
                      const void* x, const void* kt, const void* ew,
                      const void* gshift, void* sc, void* out, int n, int d,
                      int a, int h, int att_type, float ov2, float inv2l2,
                      cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)WPB * (a + 2 * h);
  const int grid = (n + WPB - 1) / WPB;
  flash_kernel<T, SQP><<<grid, WPB * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)x,
      (const float*)kt, (const float*)ew, (const float*)gshift, (float*)sc,
      (float*)out, n, d, a, h, att_type, ov2, inv2l2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, d] and wk [d, a] share dtype (0 float32, 1 bfloat16); bk [a] float32;
// kt [n, a] float32 out.
int gx_attention_kproj(const void* x, const void* wk, const void* bk, void* kt,
                       int n, int d, int a, int dtype, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)run_kproj<float>(x, wk, bk, kt, n, d, a, s);
  if (dtype == 1) return (int)run_kproj<__nv_bfloat16>(x, wk, bk, kt, n, d, a, s);
  return (int)cudaErrorInvalidValue;
}

// q [n, a] in the state dtype (pre-scaled for scaled_dot); kt [n, a] float32
// from gx_attention_kproj; ew [E] float32 reweight values or null; state [2]
// uint32 scratch, zeroed by the caller; out [1] float32: the max score over
// every edge and head, 0 when no row has an edge.
int gx_attention_gmax(const void* ptr, const void* idx, const void* q,
                      const void* kt, const void* ew, void* state, void* out,
                      int n, int a, int h, int att_type, int reweight,
                      float ov2, float inv2l2, int dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const void* ewp = reweight ? ew : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)run_gmax<float>(ptr, idx, q, kt, ewp, state, out, n, a, h,
                                att_type, ov2, inv2l2, s);
  if (dtype == 1)
    return (int)run_gmax<__nv_bfloat16>(ptr, idx, q, kt, ewp, state, out, n,
                                        a, h, att_type, ov2, inv2l2, s);
  return (int)cudaErrorInvalidValue;
}

// q [n, a] and x [n, d] in one dtype; kt [n, a] float32; ew as above;
// gshift [1] float32 (squareplus only, from gx_attention_gmax); sc [E, h]
// float32 scratch; out [n, d] float32.
int gx_flash_attention(const void* ptr, const void* idx, const void* q,
                       const void* x, const void* kt, const void* ew,
                       const void* gshift, void* sc, void* out, int n, int d,
                       int a, int h, int att_type, int reweight,
                       int square_plus, float ov2, float inv2l2, int dtype,
                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const void* ewp = reweight ? ew : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return square_plus
        ? (int)run_flash<float, true>(ptr, idx, q, x, kt, ewp, gshift, sc, out,
                                      n, d, a, h, att_type, ov2, inv2l2, s)
        : (int)run_flash<float, false>(ptr, idx, q, x, kt, ewp, gshift, sc,
                                       out, n, d, a, h, att_type, ov2, inv2l2,
                                       s);
  if (dtype == 1)
    return square_plus
        ? (int)run_flash<__nv_bfloat16, true>(ptr, idx, q, x, kt, ewp, gshift,
                                              sc, out, n, d, a, h, att_type,
                                              ov2, inv2l2, s)
        : (int)run_flash<__nv_bfloat16, false>(ptr, idx, q, x, kt, ewp,
                                               gshift, sc, out, n, d, a, h,
                                               att_type, ov2, inv2l2, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
