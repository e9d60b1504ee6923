// CSR SpMM and SDDMM for the laplacian RHS and its backward.
//
// Replaces graphax/kernels/pallas_tiled.py: `_spmm_kernel` (:79, called by
// `_spmm_call` :107; forward y = A x and, on the transpose layout, the
// backward dx = A^T g) and `_sddmm_kernel` (:146, called by `_sddmm_call`
// :157; the edge-value gradient dw_e = g[row_e] . x[col_e]).
//
// What bounds them on an H100: bytes. Per call the SpMM must read x, the
// CSR and its values once and write N rows: 2*N*D*b + E*(b + 4) bytes for b
// bytes per value (0.035 ms on the arxiv graph in bf16), against 2*E*D
// flops, far below the card's ~300 flops per byte. But it gathers one x
// row per edge (8-12 edges per row on the ogbn-arxiv graph), and x in bf16
// at D = 162 is 55 MB, more than the 50 MB L2: gathered whole, almost every
// row comes from device memory, E*D*b bytes (the "all-miss count", 0.15 ms
// there).
//
// Design:
// - The row walk of row_walk.cuh (shared with fused_attention.cu's
//   attspmm_kernel): one warp owns a row and takes its edges in batches of
//   32, each lane loading one edge's column and value in one coalesced
//   load; lanes hold VPL load vectors of each row (D up to 96 vectors in
//   one pass), and the walk gathers U rows of the batch, all their
//   vectors, before it multiplies any, the edge's value as the weight.
//   Loads are VB bytes (the widest that every row and the view allow: the
//   host's gather_width). Column slabs of x sized to L2 (every row of one
//   slab before the next) measured slower at every count above one, in
//   bf16 and f32: each extra walk over the CSR costs more than the L2 hits
//   save (PERF.md), so the walk takes all of D in one pass.
// - Long rows in segments: rows of more than `split` edges (a most-cited
//   paper's CSC column has thousands) are walked in segments of `split`
//   edges by a warp each (spmm_seg_sum, its f32 partial sums), and
//   row_walk.cuh's seg_combine adds a row's partials in segment order and
//   rounds once, so no row's serial walk sets the launch's length.
// Numerics (graphax's `xg * w.astype(xg.dtype)`): each product w_e * x is
// rounded to the state type T once (bf16: one bf16x2 multiply of two
// values, round to nearest even, the exact product rounded; f32: __fmul_rn,
// no fused multiply-add), summed in f32 in edge order (a long row: each
// segment in edge order, the segments in order) and the sum rounded once to
// T. A row with no edge gives 0.
//
// The SDDMM (no launch on any path: the pin needs no value gradient) keeps
// g[row] in registers for the whole segment, so g is read once per row and
// x once per edge, and reduces each dot product across the warp with
// shuffles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "row_walk.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int CHUNK = 4;  // the SDDMM's vectors of V values per lane per pass
// blocks of the walk per SM: rows in flight per SM, not bytes, set a row
// walk's pace (fused_attention.cu). Measured on the arxiv graph (PERF.md):
// bf16 fastest at 8 (32 registers a thread), f32 at 6 (40)
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 2 ? 8 : 6; }
// gathered rows in flight per warp with VPL load vectors a lane
template <int VPL> constexpr int U = 6 / VPL;
// the output's type for store_chunk: 0 f32, 1 bf16
template <typename T> constexpr int OTYPE = sizeof(T) == 2 ? 1 : 0;

using gx_rows::BATCH;
using gx_rows::clear;
using gx_rows::gather;
using gx_rows::seg_combine;
using gx_rows::segment;
using gx_rows::store_chunk;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------
// the SpMM walk
// ---------------------------------------------------------------------

// one warp's f32 sums of the vectors [v0, v0 + 32 VPL) over the edges
// [sb, se), each batch's columns and values in one load a lane
template <typename T, int VB, int VPL>
__device__ __forceinline__ void walk(
    float (&acc)[VPL][gx_rows::Vec<T, VB>::E], const int* __restrict__ idx,
    const T* __restrict__ val, const T* __restrict__ x, int sb, int se,
    int d, int v0, int nvec, int lane) {
  clear(acc);
  for (int b0 = sb; b0 < se; b0 += BATCH) {
    const int cnt = min(BATCH, se - b0);
    int col = 0;
    float wl = 0.f;
    if (lane < cnt) {
      col = idx[b0 + lane];
      wl = to_f(val[b0 + lane]);
    }
    gather<T, VB, VPL, U<VPL>>(acc, x, col, wl, cnt, d, v0, nvec, lane);
  }
}

// y[r] = sum_j rnd(val[j] * x[idx[j]]): warp r of the blocks; rows of more
// than `split` edges are the segment kernels'
template <typename T, int VB, int VPL>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, min_blocks<T>())
spmm_walk(const int* __restrict__ ptr, const int* __restrict__ idx,
          const T* __restrict__ val, const T* __restrict__ x,
          T* __restrict__ y, int n, int d, int split) {
  constexpr int E = gx_rows::Vec<T, VB>::E;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (r >= n) return;
  const int beg = ptr[r], end = ptr[r + 1];
  if (end - beg > split) return;
  const int nvec = d / E;
  for (int v0 = 0; v0 < nvec; v0 += 32 * VPL) {
    float acc[VPL][E];
    walk<T, VB, VPL>(acc, idx, val, x, beg, end, d, v0, nvec, lane);
    store_chunk<T, VB, VPL>(acc, y, OTYPE<T>, nullptr, (size_t)r * d, v0,
                            nvec, lane);
  }
}

// segment j of the long rows: its f32 partial sums into part [nseg, d]
template <typename T, int VB, int VPL>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
spmm_seg_sum(const int* __restrict__ ptr, const int* __restrict__ idx,
             const T* __restrict__ val, const T* __restrict__ x,
             const int* __restrict__ plan, float* __restrict__ part,
             int nlong, int nseg, int d, int split) {
  constexpr int E = gx_rows::Vec<T, VB>::E;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (j >= nseg) return;
  int r, sb, se, i;
  segment(ptr, plan, nlong, split, j, r, sb, se, i);
  const int nvec = d / E;
  for (int v0 = 0; v0 < nvec; v0 += 32 * VPL) {
    float acc[VPL][E];
    walk<T, VB, VPL>(acc, idx, val, x, sb, se, d, v0, nvec, lane);
    store_chunk<T, VB, VPL>(acc, part, 0, nullptr, (size_t)j * d, v0, nvec,
                            lane);
  }
}

template <typename T, int VB, int VPL>
cudaError_t run_walk(const void* ptr, const void* idx, const void* val,
                     const void* x, void* y, const void* plan, void* part,
                     int n, int d, int split, int nlong, int nseg,
                     cudaStream_t s) {
  const int block = WARPS_PER_BLOCK * 32;
  spmm_walk<T, VB, VPL>
      <<<(n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, block, 0, s>>>(
          (const int*)ptr, (const int*)idx, (const T*)val, (const T*)x,
          (T*)y, n, d, split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  spmm_seg_sum<T, VB, VPL>
      <<<(nseg + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, block, 0, s>>>(
          (const int*)ptr, (const int*)idx, (const T*)val, (const T*)x,
          (const int*)plan, (float*)part, nlong, nseg, d, split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seg_combine<<<(nlong + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, block, 0,
                s>>>((const int*)plan, (const float*)part, nullptr, y,
                     OTYPE<T>, nlong, d);
  return cudaGetLastError();
}

// the walk whose VPL vectors a lane cover a row's nvec vectors in one pass
// (at most 3: wider rows take several passes of 96 vectors)
template <typename T, int VB>
cudaError_t run_spmm(const void* ptr, const void* idx, const void* val,
                     const void* x, void* y, const void* plan, void* part,
                     int n, int d, int split, int nlong, int nseg,
                     cudaStream_t s) {
  const int nvec = d / gx_rows::Vec<T, VB>::E;
  if (nvec <= 32)
    return run_walk<T, VB, 1>(ptr, idx, val, x, y, plan, part, n, d, split,
                              nlong, nseg, s);
  if (nvec <= 64)
    return run_walk<T, VB, 2>(ptr, idx, val, x, y, plan, part, n, d, split,
                              nlong, nseg, s);
  return run_walk<T, VB, 3>(ptr, idx, val, x, y, plan, part, n, d, split,
                            nlong, nseg, s);
}

// ---------------------------------------------------------------------
// the SDDMM
// ---------------------------------------------------------------------

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

template <typename T, int V>
void run_sddmm(const void* ptr, const void* idx, const void* g, const void* x,
               void* out, int n_rows, int d, cudaStream_t s) {
  const dim3 grid((n_rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  sddmm_csr_kernel<T, V><<<grid, WARPS_PER_BLOCK * 32, 0, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)g, (const T*)x,
      (float*)out, n_rows, d);
}

}  // namespace

extern "C" {

// y [n, d] = A x over the CSR (ptr, idx) with one value per slot: val, x
// and y share dtype (0 float32, 1 bfloat16). vb: bytes per gathered load
// (f32 4 or 8, bf16 2, 4 or 8; every row of x and x itself aligned to it);
// rows of more than `split` edges in the nseg segments of `plan` (nlong
// rows), their f32 partials in part [nseg, d]. Returns the cudaError_t of
// the launch.
int gx_spmm_csr(const void* ptr, const void* idx, const void* val,
                const void* x, void* y, const void* plan, void* part,
                int n_rows, int d, int dtype, int vb, int split, int nlong,
                int nseg, void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (vb == 4)
      return (int)run_spmm<float, 4>(ptr, idx, val, x, y, plan, part, n_rows,
                                     d, split, nlong, nseg, s);
    if (vb == 8)
      return (int)run_spmm<float, 8>(ptr, idx, val, x, y, plan, part, n_rows,
                                     d, split, nlong, nseg, s);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    if (vb == 2)
      return (int)run_spmm<B, 2>(ptr, idx, val, x, y, plan, part, n_rows, d,
                                 split, nlong, nseg, s);
    if (vb == 4)
      return (int)run_spmm<B, 4>(ptr, idx, val, x, y, plan, part, n_rows, d,
                                 split, nlong, nseg, s);
    if (vb == 8)
      return (int)run_spmm<B, 8>(ptr, idx, val, x, y, plan, part, n_rows, d,
                                 split, nlong, nseg, s);
  }
  return (int)cudaErrorInvalidValue;
}

// g and x share dtype; out is float32 with one value per CSR slot. vec: 1
// or 2 values per load.
int gx_sddmm_csr(const void* ptr, const void* idx, const void* g,
                 const void* x, void* out, int n_rows, int d, int dtype,
                 int vec, void* stream) {
  if (n_rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (vec == 2) run_sddmm<float, 2>(ptr, idx, g, x, out, n_rows, d, s);
    else run_sddmm<float, 1>(ptr, idx, g, x, out, n_rows, d, s);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    if (vec == 2) run_sddmm<B, 2>(ptr, idx, g, x, out, n_rows, d, s);
    else run_sddmm<B, 1>(ptr, idx, g, x, out, n_rows, d, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
