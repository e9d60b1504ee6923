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
// What bounds it on an H100 at ogbn-arxiv's shapes (N = 169,343, 575,621
// in-window cells, D = 162, A = 32, H = 2, bf16): bytes. It must read q, k
// and x (76 MB), the cell lists (3 MB), d_res, and write the f32 output and
// den (111 MB): 0.057 ms at 3.35 TB/s, against ~0.2 GFLOP. With k and x
// gathered once per cell from device memory it moves ~350 MB (0.104 ms);
// a window's rows stay in L2, so the gathers mostly hit there.
//
// Design. graphax's kernel walks each 128-row tile's dense [128, W] block of
// the window (W = 512 on ogbn-arxiv: 86.7 M cells, 0.66 % of them set).
// Here a group of G = LANES = 16 lanes owns a row and walks only its
// occupied cells (the layout's in-window CSR, WindowLayout.in_window: each
// cell once, in column order): the empty cells add zeros to every sum, so
// the function is the same. It is the CSR row walk of fused_attention.cu's
// flash kernel (row_walk.cuh) with K5's arithmetic: two rows per warp, lane
// l of a row's group holding the row's cell l.
//
// - Scores: each lane loads its cell's column (and weight) in one coalesced
//   load, then q[r]'s and k[c]'s head slices two heads at a time, by
//   16-byte loads where the host allows (scaled_dot, the slices on 16
//   bytes: `kvec`), and computes the scores in registers in
//   win_score()'s order. No [Ew, H] scratch and no staged q row.
// - Per head, the shift and the sum of e are group reductions over the
//   lanes' registers (xor butterflies of width G); each lane then holds its
//   cell's sum over the heads of e / d and rounds pbar / H once.
// - The aggregate: the group gathers its batch's x rows U at a time (U
//   rows of VPL loads of VB bytes a lane, the host's gather_width), each
//   cell's weight and column handed round by __shfl_sync, and each
//   column's f32 sum runs over the cells in order (fmaf of a weight and an
//   x value: exact products in bf16, as graphax's f32 dot).
// - A row of more than G cells goes to the segment kernels, as the flash
//   kernel's long rows do: its cells in segments of BATCH (the host's
//   row_split_plan), a warp each. winatt_seg_stats writes each segment's
//   per-head max and sum of exp(s - max); winatt_seg_sum combines its
//   row's segments in order into the shift and the denominator (den by
//   the row's first segment), weighs its cells and writes f32 partial
//   sums, which seg_combine adds in segment order. So no row's serial walk
//   sets the launch's length.
//
// The first body (a warp per row, an [Ew, H] score scratch read back three
// times, pass 2 one cell at a time) took 0.269 ms (bf16) on the H100 at the
// arxiv stand-in's shapes, whose rows hold 3.4 in-window cells on average
// and at most 12. This one takes 0.133 at G = 16: latency rules it, the
// chain ptr -> idx -> q, k -> two butterflies a head -> x, and rows in
// flight hide it; with G = 32 the score phase alone took 0.12 ms, with
// G = 16 0.065, with G = 8 0.052, where its own gather's registers spill
// (G = 8 with wider gathers: faster in bf16, slower in f32). Long rows first walked their batches three times in
// their group: on chip_smoke's long_row_windows (rows of up to 512 cells)
// 0.857 ms against the first body's 0.51; in segments 0.102 (PERF.md,
// scripts/torch_kernel_ablations.py).
//
// No atomics: each row is written by the group (or its segments' warps)
// that owns it, so the results do not depend on the schedule. A row of at
// most G cells sums e by the butterfly over one e a lane, the parent's
// kernel's order (its lanes past the row's cells add zeros), so its results
// are the parent's bit for bit; a longer row sums its denominator by
// segments, another association.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_score.cuh"
#include "row_walk.cuh"

namespace {

using gx_att::group_max;
using gx_att::group_sum;
using gx_rows::FULL;
using gx_rows::Vec;
using gx_rows::clear;
using gx_rows::ldv;
using gx_rows::rnd;
using gx_rows::store_vec;
using gx_rows::unpack;

constexpr int WPB = 8;       // warps per block
constexpr int LANES = 16;    // lanes a row (two rows a warp); the host's
                             // winatt.LANES
constexpr int BATCH = gx_rows::BATCH;  // cells of a long row's segment
constexpr int CHUNK = 96;    // load vectors of a row a group holds at once
constexpr float NEG = -1e30f;
constexpr float CLIP = 70.f;
// blocks per SM the registers allow (64 a thread at 4)
constexpr int MIN_BLOCKS = 4;
// 32-bit words of gathered x rows in flight per lane
constexpr int WORDS = 12;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float clip(float v) {
  return fminf(fmaxf(v, -CLIP), CLIP);
}

// K5's score of one head: q's and k's head slices in the state dtype, read
// one value at a time
template <typename T>
__device__ __forceinline__ float win_score(const T* __restrict__ qh,
                                           const T* __restrict__ kh, int dk,
                                           int att_type, float sqrt_dk,
                                           float ov2, float inv2l2) {
  if (att_type == 0) {
    float dot = 0.f;
    for (int i = 0; i < dk; ++i) dot += to_f(qh[i]) * to_f(kh[i]);
    return dot / sqrt_dk;
  }
  if (att_type == 3) {
    float qq = 0.f, kk = 0.f, qk = 0.f;
    for (int i = 0; i < dk; ++i) {
      const float qv = to_f(qh[i]), kv = to_f(kh[i]);
      qq += qv * qv;
      kk += kv * kv;
      qk += qv * kv;
    }
    return ov2 * expf(-((qq + kk) - 2.f * qk) * inv2l2);
  }
  float qm = 0.f, km = 0.f;
  if (att_type == 2) {
    for (int i = 0; i < dk; ++i) { qm += to_f(qh[i]); km += to_f(kh[i]); }
    qm /= (float)dk;
    km /= (float)dk;
  }
  float dot = 0.f, qq = 0.f, kk = 0.f;
  for (int i = 0; i < dk; ++i) {
    const float u = to_f(qh[i]) - qm, v = to_f(kh[i]) - km;
    dot += u * v;
    qq += u * u;
    kk += v * v;
  }
  const float qn = fmaxf(sqrtf(qq), gx_att::COS_EPS);
  const float kn = fmaxf(sqrtf(kk), gx_att::COS_EPS);
  return dot / (qn * kn);
}

// the 16 bytes at p as floats
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  unpack<T, 16>(w, f);
}

// the scores of heads h0 and h0 + 1 (nh of them) of one cell: q's row qr
// and k's row kr; scaled_dot with kvec by 16-byte loads, two a head in
// flight, the dot product in win_score()'s order; times the cell's weight
// cw when reweighting (rw)
template <typename T>
__device__ __forceinline__ void cell_scores(float (&s)[2], const T* qr,
                                            const T* kr, int h0, int nh,
                                            int dk, int att_type,
                                            float sqrt_dk, float ov2,
                                            float inv2l2, int kvec, bool rw,
                                            float cw) {
  if (att_type == 0 && kvec) {
    constexpr int EV = 16 / (int)sizeof(T);
    float dot[2] = {0.f, 0.f};
    for (int i0 = 0; i0 < dk; i0 += 2 * EV) {
      uint4 qv[2][2], kv[2][2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = (h0 + t) * dk + i0 + u * EV;
          if (t < nh && i0 + u * EV < dk) {
            qv[t][u] = __ldg(reinterpret_cast<const uint4*>(qr + i));
            kv[t][u] = __ldg(reinterpret_cast<const uint4*>(kr + i));
          }
        }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (t < nh && i0 + u * EV < dk) {
            float qf[EV], kf[EV];
            unpack16<T>(qv[t][u], qf);
            unpack16<T>(kv[t][u], kf);
#pragma unroll
            for (int j = 0; j < EV; ++j) dot[t] += qf[j] * kf[j];
          }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) s[t] = dot[t] / sqrt_dk;
  } else {
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (t < nh)
        s[t] = win_score<T>(qr + (h0 + t) * dk, kr + (h0 + t) * dk, dk,
                            att_type, sqrt_dk, ov2, inv2l2);
  }
  if (rw) {
#pragma unroll
    for (int t = 0; t < 2; ++t) s[t] *= cw;
  }
}

// a batch of cnt cells gathered by a group of G lanes (cmax the most of
// any group of the warp): acc += wt * x[col] over its cells in order, U
// gathered rows at a time, the group's lanes l over the columns; cell e's
// column and weight (a value of T) held by the warp's lane first + e
template <typename T, int VB, int G>
__device__ __forceinline__ void gather_batch(
    float (&acc)[CHUNK / G][Vec<T, VB>::E], const T* __restrict__ x, int col,
    float wt, int first, int cnt, int cmax, int d, int v0, int nvec, int l) {
  using V = Vec<T, VB>;
  constexpr int VPL = CHUNK / G;
  constexpr int U = WORDS / (VPL * V::W) > 0 ? WORDS / (VPL * V::W) : 1;
  const T* xl = x + (size_t)(v0 + l) * V::E;
  for (int e0 = 0; e0 < cmax; e0 += U) {
    uint32_t raw[U][VPL][V::W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = __shfl_sync(FULL, col, (first + e0 + u) & 31);
      if (e0 + u < cnt) {
        const T* xr = xl + (size_t)c * d;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          if (v0 + v * G + l < nvec) ldv<VB>(xr + v * G * V::E, raw[u][v]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float w = __shfl_sync(FULL, wt, (first + e0 + u) & 31);
      if (e0 + u < cnt) {
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          if (v0 + v * G + l < nvec) {
            float f[V::E];
            unpack<T, VB>(raw[u][v], f);
#pragma unroll
            for (int k = 0; k < V::E; ++k) acc[v][k] += w * f[k];
          }
      }
    }
  }
}

// one group's chunk of output columns [v0, v0 + CHUNK) of row r
template <typename T, int VB, int G>
__device__ __forceinline__ void store_row(
    float (&acc)[CHUNK / G][Vec<T, VB>::E], float* out, size_t row, int v0,
    int nvec, int l) {
  constexpr int E = Vec<T, VB>::E;
#pragma unroll
  for (int v = 0; v < CHUNK / G; ++v) {
    const int vi = v0 + v * G + l;
    if (vi < nvec) store_vec<E>(out, 0, nullptr, row + (size_t)vi * E, acc[v]);
  }
}

// A long row's segment j of at most BATCH cells (the host's plan, as
// fused_attention.cu's long rows: gx_rows::segment), a warp each, lane l
// holding cell l: per head the segment's max m_j and sum of exp(s - m_j),
// into st [nseg, 2 h] (maxima, then sums)
template <typename T>
__global__ void __launch_bounds__(WPB * 32)
winatt_seg_stats(const int* __restrict__ ptr, const int* __restrict__ idx,
                 const T* __restrict__ q, const T* __restrict__ k,
                 const float* __restrict__ ew, const int* __restrict__ plan,
                 float* __restrict__ st, int nlong, int nseg, int a, int h,
                 int att_type, float ov2, float inv2l2, int kvec) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WPB + (threadIdx.x >> 5);
  if (j >= nseg) return;
  int r, sb, se, i;
  gx_rows::segment(ptr, plan, nlong, BATCH, j, r, sb, se, i);
  const bool act = lane < se - sb;
  int col = 0;
  float cw = 1.f;
  if (act) {
    col = idx[sb + lane];
    if (ew != nullptr) cw = ew[sb + lane];
  }
  const int dk = a / h;
  const float sqrt_dk = sqrtf((float)dk);
  for (int h0 = 0; h0 < h; h0 += 2) {
    const int nh = min(2, h - h0);
    float s[2] = {-INFINITY, -INFINITY};
    if (act)
      cell_scores<T>(s, q + (size_t)r * a, k + (size_t)col * a, h0, nh, dk,
                     att_type, sqrt_dk, ov2, inv2l2, kvec, ew != nullptr,
                     cw);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t >= nh) break;
      const float m = group_max<32>(act ? s[t] : -INFINITY);
      const float sum = group_sum<32>(act ? expf(s[t] - m) : 0.f);
      if (lane == 0) {
        st[(size_t)j * 2 * h + h0 + t] = m;
        st[(size_t)j * 2 * h + h + h0 + t] = sum;
      }
    }
  }
}

// A long row's segment j: the row's shift and denominator per head from
// its segments' (m, sum) in segment order (d = sum_j sum_j exp(m_j -
// shift), then the residual's share), den by the row's first segment, then
// its cells' weights rnd(pbar / H) and their f32 partial sums, the whole
// warp over the columns, into part [nseg, d] (summed by seg_combine)
template <typename T, int VB>
__global__ void __launch_bounds__(WPB * 32)
winatt_seg_sum(const int* __restrict__ ptr, const int* __restrict__ idx,
               const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ x, const float* __restrict__ ew,
               const float* __restrict__ dres, const float* __restrict__ r0p,
               const int* __restrict__ plan, const float* __restrict__ st,
               float* __restrict__ part, float* __restrict__ den, int nlong,
               int nseg, int d, int a, int h, int att_type, float ov2,
               float inv2l2, int kvec) {
  using V = Vec<T, VB>;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WPB + (threadIdx.x >> 5);
  if (j >= nseg) return;
  int r, sb, se, i;
  gx_rows::segment(ptr, plan, nlong, BATCH, j, r, sb, se, i);
  const int p0 = plan[nlong + i], p1 = plan[nlong + i + 1];
  const int cnt = se - sb;
  const bool act = lane < cnt;
  int col = 0;
  float cw = 1.f;
  if (act) {
    col = idx[sb + lane];
    if (ew != nullptr) cw = ew[sb + lane];
  }
  const float r0 = __ldg(r0p);
  const int dk = a / h;
  const float sqrt_dk = sqrtf((float)dk), inv_h = 1.f / (float)h;
  float pb = 0.f;
  for (int h0 = 0; h0 < h; h0 += 2) {
    const int nh = min(2, h - h0);
    float s[2] = {-INFINITY, -INFINITY};
    if (act)
      cell_scores<T>(s, q + (size_t)r * a, k + (size_t)col * a, h0, nh, dk,
                     att_type, sqrt_dk, ov2, inv2l2, kvec, ew != nullptr,
                     cw);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t >= nh) break;
      const int hh = h0 + t;
      float shift = -INFINITY;
      for (int jj = p0; jj < p1; ++jj)
        shift = fmaxf(shift, st[(size_t)jj * 2 * h + hh]);
      shift = fmaxf(shift, r0 - CLIP);
      if (shift <= NEG * 0.5f) shift = 0.f;
      float dd = 0.f;
      for (int jj = p0; jj < p1; ++jj)
        dd += st[(size_t)jj * 2 * h + h + hh] *
              expf(st[(size_t)jj * 2 * h + hh] - shift);
      dd += dres[(size_t)r * h + hh] * expf(clip(r0 - shift));
      if (j == p0 && lane == 0)
        den[(size_t)r * h + hh] = dd * expf(clip(shift - r0));
      if (act) pb += expf(s[t] - shift) / (dd > 0.f ? dd : 1.f);
    }
  }
  const float wt = rnd<T>(pb * inv_h);
  const int nvec = d / V::E;
  for (int v0 = 0; v0 < nvec; v0 += CHUNK) {
    float acc[CHUNK / 32][V::E];
    clear(acc);
    gather_batch<T, VB, 32>(acc, x, col, wt, 0, cnt, cnt, d, v0, nvec, lane);
    store_row<T, VB, 32>(acc, part, (size_t)j * d, v0, nvec, lane);
  }
}

template <typename T, int VB>
__global__ void __launch_bounds__(WPB * 32, MIN_BLOCKS)
winatt_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
              const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ x, const float* __restrict__ ew,
              const float* __restrict__ dres, const float* __restrict__ r0p,
              float* __restrict__ out, float* __restrict__ den, int n, int d,
              int a, int h, int att_type, float ov2, float inv2l2, int kvec) {
  using V = Vec<T, VB>;
  constexpr int G = LANES;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = lane & (G - 1), grp = lane / G;
  const int r0w = (blockIdx.x * WPB + w) * (32 / G);
  if (r0w >= n) return;  // the whole warp
  const int r = r0w + grp;
  // this group's row, unless it has more than G cells (the segment
  // kernels' then); lane l holds cell l throughout
  int beg = 0, len = 0;
  if (r < n) {
    beg = ptr[r];
    len = ptr[r + 1] - beg;
  }
  const bool valid = r < n && len <= G;
  if (!valid) len = 0;
  const float r0 = __ldg(r0p);
  const int dk = a / h;
  const float sqrt_dk = sqrtf((float)dk), inv_h = 1.f / (float)h;
  const bool act = l < len;
  int col = 0;
  float cw = 1.f;
  if (act) {
    col = idx[beg + l];
    if (ew != nullptr) cw = ew[beg + l];
  }
  const T* qr = q + (size_t)r * a;
  const T* kr = k + (size_t)col * a;
  float pb = 0.f;
  for (int h0 = 0; h0 < h; h0 += 2) {
    const int nh = min(2, h - h0);
    float s[2] = {-INFINITY, -INFINITY};
    if (act)
      cell_scores<T>(s, qr, kr, h0, nh, dk, att_type, sqrt_dk, ov2, inv2l2,
                     kvec, ew != nullptr, cw);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t >= nh) break;
      const int hh = h0 + t;
      float shift = fmaxf(group_max<G>(act ? s[t] : -INFINITY), r0 - CLIP);
      if (shift <= NEG * 0.5f) shift = 0.f;
      const float e = act ? expf(s[t] - shift) : 0.f;
      const float dd = group_sum<G>(e) +
          (valid ? dres[(size_t)r * h + hh] : 0.f) * expf(clip(r0 - shift));
      if (valid && l == 0)
        den[(size_t)r * h + hh] = dd * expf(clip(shift - r0));
      pb += e / (dd > 0.f ? dd : 1.f);
    }
  }
  const float wt = rnd<T>(pb * inv_h);
  // the aggregate: each group its own row, its cells' columns and weights
  // on its lanes
  const int nvec = d / V::E;
  const int cmax = __reduce_max_sync(FULL, len);
  for (int v0 = 0; v0 < nvec; v0 += CHUNK) {
    float acc[CHUNK / G][V::E];
    clear(acc);
    gather_batch<T, VB, G>(acc, x, col, wt, grp * G, len, cmax, d, v0, nvec,
                           l);
    if (valid) store_row<T, VB, G>(acc, out, (size_t)r * d, v0, nvec, l);
  }
}

template <typename T, int VB>
cudaError_t launch(const void* ptr, const void* idx, const void* q,
                   const void* k, const void* x, const void* ew,
                   const void* dres, const void* r0, const void* plan,
                   void* st, void* part, void* out, void* den, int n, int d,
                   int a, int h, int att_type, float ov2, float inv2l2,
                   int kvec, int nlong, int nseg, cudaStream_t s) {
  const int rows = WPB * (32 / LANES);
  winatt_kernel<T, VB><<<(n + rows - 1) / rows, WPB * 32, 0, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)k,
      (const T*)x, (const float*)ew, (const float*)dres, (const float*)r0,
      (float*)out, (float*)den, n, d, a, h, att_type, ov2, inv2l2, kvec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  const int blocks = (nseg + WPB - 1) / WPB;
  winatt_seg_stats<T><<<blocks, WPB * 32, 0, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)k,
      (const float*)ew, (const int*)plan, (float*)st, nlong, nseg, a, h,
      att_type, ov2, inv2l2, kvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  winatt_seg_sum<T, VB><<<blocks, WPB * 32, 0, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)k,
      (const T*)x, (const float*)ew, (const float*)dres, (const float*)r0,
      (const int*)plan, (const float*)st, (float*)part, (float*)den, nlong,
      nseg, d, a, h, att_type, ov2, inv2l2, kvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gx_rows::seg_combine<<<(nlong + WPB - 1) / WPB, WPB * 32, 0, s>>>(
      (const int*)plan, (const float*)part, nullptr, out, 0, nlong, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptr [n + 1] and idx [Ew] int32: the in-window cells of each row (idx the
// column); q (unscaled), k [n, a] and x [n, d] in one dtype (0 float32, 1
// bfloat16); ew [Ew] float32 cell weights or null; dres [n, h] float32; r0
// [1] float32; out [n, d] and den [n, h] float32. vb: bytes of one x load
// (the host's gather_width: 4 or 8 for float32, 2, 4 or 8 for bfloat16);
// kvec: q and k head slices on 16 bytes (scaled_dot's scores by 16-byte
// loads); att_type one of win_score's four (K5 has no beltrami_exp
// instance: 4 is refused); plan: the segments of BATCH cells of the rows
// of more than LANES cells (nlong rows, nseg segments; the host's
// row_split_plan), st [nseg, 2 h] and part [nseg, d] float32 scratch.
int gx_winatt(const void* ptr, const void* idx, const void* q, const void* k,
              const void* x, const void* ew, const void* dres, const void* r0,
              const void* plan, void* st, void* part, void* out, void* den,
              int n, int d, int a, int h, int att_type, int reweight,
              float ov2, float inv2l2, int dtype, int vb, int kvec,
              int nlong, int nseg, void* stream) {
  if (att_type < 0 || att_type > 3) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const void* ewp = reweight ? ew : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
#define GX_WINATT(T, VB)                                                     \
  launch<T, VB>(ptr, idx, q, k, x, ewp, dres, r0, plan, st, part, out, den, \
                n, d, a, h, att_type, ov2, inv2l2, kvec, nlong, nseg, s)
  if (dtype == 0) {
    if (vb == 4) return (int)GX_WINATT(float, 4);
    if (vb == 8) return (int)GX_WINATT(float, 8);
  } else if (dtype == 1) {
    if (vb == 2) return (int)GX_WINATT(__nv_bfloat16, 2);
    if (vb == 4) return (int)GX_WINATT(__nv_bfloat16, 4);
    if (vb == 8) return (int)GX_WINATT(__nv_bfloat16, 8);
  }
#undef GX_WINATT
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
