// CSR SpMM and SDDMM for the laplacian RHS and its backward.
//
// Replaces graphax/kernels/pallas_tiled.py: `_spmm_kernel` (:79, called by
// `_spmm_call` :107; forward y = A x and, on the transpose layout, the
// backward dx = A^T g) and `_sddmm_kernel` (:146, called by `_sddmm_call`
// :157; the edge-value gradient dw_e = g[row_e] . x[col_e]).
//
// What bounds them on an H100: bytes. Per call the SpMM reads each edge's
// source row x[idx_e] (D values) plus its index and value, and writes N rows:
// E*(D*b + 8) + N*D*b bytes for b bytes per value, against 2*E*D flops, far
// below the card's ~300 flops per byte. The gather of x rows is random
// (8-12 edges per row on the ogbn-arxiv graph), so the achievable rate is
// that of scattered row reads.
//
// Design: one warp per destination row walks the row's CSR segment, so the
// sum needs no atomics and each output row is written once. Lanes split the
// D columns in pairs (bf16x2 / float2, 4- or 8-byte loads; the wrapper
// falls back to scalar loads when D is odd or a row is misaligned), which
// keeps neighbouring lanes on neighbouring addresses of the gathered row.
// Each pair-slot of a lane holds its accumulators in registers for up to
// 256 columns per pass. Products are rounded to the state type before the
// f32 accumulation, as the TPU kernel multiplies in the state type and
// accumulates in f32; the f32 sum is cast once to the state type.
// The SDDMM keeps g[row] in registers for the whole segment, so g is read
// once per row and x once per edge, and reduces each dot product across
// the warp with shuffles.
//
// Not yet done (later work): prefetching the segment's indices with one
// coalesced load per 32 edges, several rows per warp for short rows, and
// TMA/cp.async staging of the gathered rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int CHUNK = 4;  // vectors of V values per lane per pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// product in f32, rounded to the state type T (the TPU kernel's
// `xg * w.astype(xg.dtype)`), returned as f32 for the accumulator
template <typename T> __device__ __forceinline__ float round_prod(float w, float x) {
  return to_f(from_f<T>(__fmul_rn(w, x)));
}

template <typename T, int V> struct Vec;
template <typename T> struct Vec<T, 1> {
  T v[1];
  __device__ __forceinline__ void load(const T* p) { v[0] = p[0]; }
};
template <> struct Vec<float, 2> {
  float v[2];
  __device__ __forceinline__ void load(const float* p) {
    float2 t = *reinterpret_cast<const float2*>(p); v[0] = t.x; v[1] = t.y;
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  __nv_bfloat16 v[2];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = t.x; v[1] = t.y;
  }
};

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* a) {
#pragma unroll
  for (int k = 0; k < V; ++k) p[k] = from_f<T>(a[k]);
}

// y[r, :] = sum_{j in [ptr[r], ptr[r+1])} val[j] * x[idx[j], :]
template <typename T, int V>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
spmm_csr_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
                const T* __restrict__ val, const T* __restrict__ x,
                T* __restrict__ y, int n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int beg = ptr[r], end = ptr[r + 1];
  const int nv = d / V;
  for (int v0 = 0; v0 < nv; v0 += 32 * CHUNK) {
    float acc[CHUNK][V];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[j][k] = 0.f;
    for (int e = beg; e < end; ++e) {
      const int c = idx[e];
      const float w = to_f(val[e]);
      const T* xr = x + (size_t)c * d;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int v = v0 + j * 32 + lane;
        if (v < nv) {
          Vec<T, V> xv;
          xv.load(xr + v * V);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[j][k] += round_prod<T>(w, to_f(xv.v[k]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int v = v0 + j * 32 + lane;
      if (v < nv) store<T, V>(y + (size_t)r * d + v * V, acc[j]);
    }
  }
}

// out[j] = g[r, :] . x[idx[j], :] in f32, for every slot j of row r
template <typename T, int V>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sddmm_csr_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
                 const T* __restrict__ g, const T* __restrict__ x,
                 float* __restrict__ out, int n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int beg = ptr[r], end = ptr[r + 1];
  const int nv = d / V;
  for (int v0 = 0; v0 < nv; v0 += 32 * CHUNK) {
    float gr[CHUNK][V];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int v = v0 + j * 32 + lane;
      Vec<T, V> gv;
      if (v < nv) gv.load(g + (size_t)r * d + v * V);
#pragma unroll
      for (int k = 0; k < V; ++k) gr[j][k] = v < nv ? to_f(gv.v[k]) : 0.f;
    }
    for (int e = beg; e < end; ++e) {
      const T* xr = x + (size_t)idx[e] * d;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int v = v0 + j * 32 + lane;
        if (v < nv) {
          Vec<T, V> xv;
          xv.load(xr + v * V);
#pragma unroll
          for (int k = 0; k < V; ++k) part += gr[j][k] * to_f(xv.v[k]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) out[e] = (v0 == 0) ? part : out[e] + part;
    }
  }
}

template <template <typename, int> class K>
cudaError_t launch(const void* ptr, const void* idx, const void* a,
                   const void* x, void* out, int n_rows, int d, int dtype,
                   int vec, cudaStream_t s) {
  if (n_rows <= 0) return cudaSuccess;
  const dim3 block(WARPS_PER_BLOCK * 32);
  const dim3 grid((n_rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const int* p = static_cast<const int*>(ptr);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0) {
    using T = float;
    if (vec == 2)
      K<T, 2>::run(grid, block, s, p, ix, (const T*)a, (const T*)x, out, n_rows, d);
    else
      K<T, 1>::run(grid, block, s, p, ix, (const T*)a, (const T*)x, out, n_rows, d);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    if (vec == 2)
      K<T, 2>::run(grid, block, s, p, ix, (const T*)a, (const T*)x, out, n_rows, d);
    else
      K<T, 1>::run(grid, block, s, p, ix, (const T*)a, (const T*)x, out, n_rows, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int V> struct SpmmK {
  static void run(dim3 g, dim3 b, cudaStream_t s, const int* p, const int* ix,
                  const T* val, const T* x, void* out, int n, int d) {
    spmm_csr_kernel<T, V><<<g, b, 0, s>>>(p, ix, val, x, (T*)out, n, d);
  }
};
template <typename T, int V> struct SddmmK {
  static void run(dim3 g, dim3 b, cudaStream_t s, const int* p, const int* ix,
                  const T* gg, const T* x, void* out, int n, int d) {
    sddmm_csr_kernel<T, V><<<g, b, 0, s>>>(p, ix, gg, x, (float*)out, n, d);
  }
};

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (val, x and y share it). vec: 1 or 2 values
// per load. Returns the cudaError_t of the launch.
int gx_spmm_csr(const void* ptr, const void* idx, const void* val,
                const void* x, void* y, int n_rows, int d, int dtype, int vec,
                void* stream) {
  return (int)launch<SpmmK>(ptr, idx, val, x, y, n_rows, d, dtype, vec,
                            (cudaStream_t)stream);
}

// g and x share dtype; out is float32 with one value per CSR slot.
int gx_sddmm_csr(const void* ptr, const void* idx, const void* g,
                 const void* x, void* out, int n_rows, int d, int dtype,
                 int vec, void* stream) {
  return (int)launch<SddmmK>(ptr, idx, g, x, out, n_rows, d, dtype, vec,
                             (cudaStream_t)stream);
}

}  // extern "C"
