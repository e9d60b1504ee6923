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
// The SDDMM (the pinned values' gradient in _SpMM's backward, once per
// adjoint NFE of the attention block) must read g and x once, the CSR
// once and write one value a slot: 2*N*D*b + 8*E bytes with an f32 output
// (0.036 ms on the arxiv graph in bf16), and gathers an x row per slot as
// the SpMM does. It takes work items, a warp each, as bwd_rows_kernel in
// fused_attention.cu does: the rows of at most 32 edges, then the 32-edge
// segments of the longer rows (the host's row_split_plan(ptr, 32, 32)),
// so no hub row's serial walk sets the launch's length; a segment writes
// its own slots, so nothing is combined. Lane j holds edge j's column from
// one coalesced load; g_r's chunk sits in registers at the host's
// gather_width; the batch's x rows are gathered SD_ROWS at a time
// (row_walk.cuh's batch_dots, shared with bwd_rows_kernel), each lane's
// partials over its vectors and a warp sum per edge leave dw_j in lane j,
// D past one chunk adds up in that register, and the batch's values leave
// in one coalesced store, rounded once to the output type (graphax's
// `.astype(wb.dtype)`). The first body (a warp per whole row, its edges one
// at a time, one x row in flight, a read-modify-write of out per pass
// over D) took 0.1696 ms in bf16 there (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "row_walk.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
// blocks of the walk (and of the SDDMM) per SM: rows in flight per SM, not
// bytes, set a row walk's pace (fused_attention.cu). Measured on the arxiv
// graph (PERF.md): bf16 fastest at 8 (32 registers a thread), f32 at 6
// (40), in both kernels
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 2 ? 8 : 6; }
// gathered rows in flight per warp with VPL load vectors a lane
template <int VPL> constexpr int U = 6 / VPL;
// the output's type for store_chunk: 0 f32, 1 bf16
template <typename T> constexpr int OTYPE = sizeof(T) == 2 ? 1 : 0;

using gx_rows::BATCH;
using gx_rows::batch_dots;
using gx_rows::clear;
using gx_rows::gather;
using gx_rows::seg_combine;
using gx_rows::segment;
using gx_rows::store_chunk;
using gx_rows::store_vec;

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

// x rows in flight per warp in the batch dot products: 2 measured fastest
// with min_blocks<T>() in bf16 and f32 on the arxiv graph (PERF.md; 4 rows
// spill in f32). ptxas at the arxiv width: 32 registers in bf16, 40 in
// f32, no spills (bf16's 8-byte loads at 3 vectors a lane spill 60 bytes)
constexpr int SD_ROWS = 2;

// dw[j] = g[r] . x[idx[j]] in f32 for every slot j of row r, rounded once
// to the output type (otype 0 f32, 1 bf16). Items, a warp each: the rows
// of at most BATCH edges (item r < n; an empty row or a longer one
// returns), the BATCH-edge segments of the longer rows (item n + j), then
// the output's tail past the slots (item n + nseg + t: BATCH zeros each)
template <typename T, int VB, int VPL>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32, min_blocks<T>())
sddmm_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
             const T* __restrict__ g, const T* __restrict__ x,
             const int* __restrict__ plan, void* __restrict__ out, int otype,
             int n, int d, int nlong, int nseg, int slots, int length) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  int r, sb, cnt;
  if (item < n) {
    r = item;
    sb = ptr[r];
    cnt = ptr[r + 1] - sb;
    if (cnt == 0 || cnt > BATCH) return;   // nothing, or the segments'
  } else if (item < n + nseg) {
    int se, i;
    segment(ptr, plan, nlong, BATCH, item - n, r, sb, se, i);
    cnt = se - sb;
  } else {
    const int t = slots + (item - n - nseg) * BATCH + lane;
    float zero = 0.f;
    if (t < length) store_vec<1>(out, otype, nullptr, (size_t)t, &zero);
    return;
  }
  const int col = lane < cnt ? idx[sb + lane] : 0;
  float dw = batch_dots<T, VB, VPL, SD_ROWS>(g + (size_t)r * d, x, col, cnt,
                                             d, lane);
  if (lane < cnt) store_vec<1>(out, otype, nullptr, (size_t)sb + lane, &dw);
}

// the kernel whose VPL vectors a lane cover a row's nvec vectors in one
// chunk (at most 3: wider rows take several chunks of 96 vectors)
template <typename T, int VB>
cudaError_t run_sddmm(const void* ptr, const void* idx, const void* g,
                      const void* x, const void* plan, void* out, int otype,
                      int n, int d, int nlong, int nseg, int slots,
                      int length, cudaStream_t s) {
  const int nvec = d / gx_rows::Vec<T, VB>::E;
  const long long items =
      (long long)n + nseg + (length - slots + BATCH - 1) / BATCH;
  const dim3 grid((unsigned)((items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK));
  const dim3 block(WARPS_PER_BLOCK * 32);
  const int* p = (const int*)ptr;
  const int* ix = (const int*)idx;
  const int* pl = (const int*)plan;
  if (nvec <= 32)
    sddmm_kernel<T, VB, 1><<<grid, block, 0, s>>>(
        p, ix, (const T*)g, (const T*)x, pl, out, otype, n, d, nlong, nseg,
        slots, length);
  else if (nvec <= 64)
    sddmm_kernel<T, VB, 2><<<grid, block, 0, s>>>(
        p, ix, (const T*)g, (const T*)x, pl, out, otype, n, d, nlong, nseg,
        slots, length);
  else
    sddmm_kernel<T, VB, 3><<<grid, block, 0, s>>>(
        p, ix, (const T*)g, (const T*)x, pl, out, otype, n, d, nlong, nseg,
        slots, length);
  return cudaGetLastError();
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

// dw [length] = g[row_j] . x[idx[j]] per CSR slot j < slots (= ptr[n]),
// 0 past them: g and x share dtype (0 float32, 1 bfloat16), out f32
// (otype 0) or bf16 (otype 1); vb: bytes per load of a g or x row (as
// gx_spmm_csr's); rows of more than 32 edges in the nseg 32-edge segments
// of `plan` (nlong rows). Returns the cudaError_t of the launch.
int gx_sddmm_csr(const void* ptr, const void* idx, const void* g,
                 const void* x, const void* plan, void* out, int n_rows,
                 int d, int dtype, int vb, int otype, int nlong, int nseg,
                 int slots, int length, void* stream) {
  if (otype != 0 && otype != 1) return (int)cudaErrorInvalidValue;
  if (length <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (vb == 4)
      return (int)run_sddmm<float, 4>(ptr, idx, g, x, plan, out, otype,
                                      n_rows, d, nlong, nseg, slots, length,
                                      s);
    if (vb == 8)
      return (int)run_sddmm<float, 8>(ptr, idx, g, x, plan, out, otype,
                                      n_rows, d, nlong, nseg, slots, length,
                                      s);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    if (vb == 2)
      return (int)run_sddmm<B, 2>(ptr, idx, g, x, plan, out, otype, n_rows,
                                  d, nlong, nseg, slots, length, s);
    if (vb == 4)
      return (int)run_sddmm<B, 4>(ptr, idx, g, x, plan, out, otype, n_rows,
                                  d, nlong, nseg, slots, length, s);
    if (vb == 8)
      return (int)run_sddmm<B, 8>(ptr, idx, g, x, plan, out, otype, n_rows,
                                  d, nlong, nseg, slots, length, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
