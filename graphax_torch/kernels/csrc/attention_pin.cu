// Attention pin: per-edge head-mean of the row-softmax transformer attention.
//
// Replaces graphax/kernels/pallas_attention.py: `_make_scores_kernel` (K1,
// :114, called by `_scores_call` :160: k = x[col] Wk + bk per edge, the
// per-edge per-head scores of `_score_math` :73-107 with optional reweight,
// and the per-(row, head) max), `_make_norm_kernel` (K2, :197, called by
// `_norm_call` :235, softmax mode: exp(s - rowmax) and the per-(row, head)
// denominators) and the normalise-and-mean of `attention_edge_means_pallas`
// (:976-991: att = e / where(d > 0, d, 1), mean over heads), Beltrami's
// `beltrami_exp` scores included (an instance of each kernel, below).
//
// The K projection is not here: the wrapper computes K = x Wk + bk [N, A]
// in f32 once per node through fused_attention.cu's attention_kproj (bf16
// on the tensor cores), where graphax projects every gathered source row
// (E/N, about 8, times the work). This file walks the CSR against that
// table.
//
// What bounds it on an H100: bytes. The pin must read x, q, Wk and the CSR
// once and write one f32 per edge: at the arxiv shapes (N = 169,343, E =
// 1,354,429, D = 162, A = 32, H = 2, bf16) about 77 MB, 0.023 ms. This
// walk reads q, K [N, A] f32 and the CSR and writes the output; it gathers
// one K row (A*4 bytes) per edge, and K (22 MB) stays in L2.
//
// Design: the row walk of fused_attention.cu's flash kernel, without the x
// gather. One warp owns a CSR row of at most 32 edges (pin_kernel): lane j
// loads edge j's column while the row's q comes into shared memory, then
// lanes over the batch's (edge, head) pairs score it (batch_scores, K rows
// by 16-byte loads), the per-head max and denominator are warp reductions,
// and lane j writes mean_h exp(s_h - m_h) / where(d_h > 0, d_h, 1) for its
// edge. No [E, H] scratch and no second pass over device memory. Longer
// rows go to segments of `seg` edges, a warp each (the host's plan,
// row_walk.cuh): pin_seg_stats writes each segment's running per-head
// (max, sum) over its batches, the sum rescaled by exp(old - new max);
// pin_seg_write combines its row's segments in order into the row's max
// and denominator and recomputes its batches' scores (K rows hit L2) for
// the write. No atomics: the result does not depend on the schedule.
//
// beltrami_exp (att_type 4) takes the kernels' instances of their own
// (the template flag BEL), on flash's design (fused_attention.cu): two
// lanes a (edge, head) pair, one half of the head's slice each (2 x 32
// values at BLEND's arxiv shapes: 128 bytes of K a pair), each half's K
// by four 16-byte loads in flight (batch_scores<true>, bel_sum), the
// product formed across the pair by one shuffle; each warp's shared row
// rounded up to 4 floats (gx_att::warp_stride) so q's halves sit on 16
// bytes. The other types' instances compile from the same code as before
// it. The first form (a __noinline__ helper shared by every type, K read
// one value at a time) took 0.479 ms in bf16 at those shapes on the H100
// (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_score.cuh"
#include "row_walk.cuh"

namespace {

// blocks of pin_kernel per SM (48 registers a thread): faster on the arxiv
// graph than 64 or 32 registers (PERF.md); BEL_MIN_BLOCKS the
// beltrami_exp instance's (40 registers a thread: faster than 5 blocks
// and 4, PERF.md)
constexpr int MIN_BLOCKS = 5;
constexpr int BEL_MIN_BLOCKS = 6;

using gx_att::batch_scores;
using gx_att::warp_max;
using gx_att::warp_stride;
using gx_att::warp_sum;
using gx_rows::BATCH;
using gx_rows::segment;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ void stage_q(const T* __restrict__ q, int r,
                                        int a, float* qs, int lane) {
  for (int i = lane; i < a; i += 32) qs[i] = to_f(q[(size_t)r * a + i]);
  __syncwarp();
}

// lane j < cnt: edge j's mean_h exp(s_h - m_h) / where(d_h > 0, d_h, 1)
// from the batch's scores ws and the row's max ms and denominators ds
__device__ __forceinline__ float edge_mean(const float* ws, const float* ms,
                                           const float* ds, int h, int lane) {
  float sum = 0.f;
  for (int hh = 0; hh < h; ++hh) {
    const float den = ds[hh];
    sum += expf(ws[lane * h + hh] - ms[hh]) / (den > 0.f ? den : 1.f);
  }
  return sum / (float)h;
}

// the rows of at most BATCH edges, one batch each; longer rows are the
// segment kernels'. BEL: beltrami_exp's instance (batch_scores<true>, the
// warp stride of gx_att::warp_stride, BEL_MIN_BLOCKS blocks an SM)
template <typename T, bool BEL>
__global__ void __launch_bounds__(256, BEL ? BEL_MIN_BLOCKS : MIN_BLOCKS)
pin_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
           const T* __restrict__ q, const float* __restrict__ kt,
           const float* __restrict__ ew, float* __restrict__ out, int n,
           int a, int h, int att_type, gx_att::Scal scal, int kvec) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + w;
  if (r >= n) return;
  const int beg = ptr[r], len = ptr[r + 1] - beg;
  if (len == 0 || len > BATCH) return;
  float* qs = smem + (size_t)w * warp_stride(a, h, BEL);
  float* ms = qs + a;
  float* ds = ms + h;
  float* ws = ds + h;
  // the columns, loaded while q comes in
  const int col = lane < len ? idx[beg + lane] : 0;
  stage_q(q, r, a, qs, lane);
  batch_scores<BEL>(qs, kt, idx, ew, beg, len, a, h, att_type, scal, kvec,
                    ws, lane, col);
  for (int hh = 0; hh < h; ++hh) {
    const float s = lane < len ? ws[lane * h + hh] : -INFINITY;
    const float m = warp_max(s);
    const float den = warp_sum(lane < len ? expf(s - m) : 0.f);
    if (lane == 0) {
      ms[hh] = m;
      ds[hh] = den;
    }
  }
  __syncwarp();
  if (lane < len) out[beg + lane] = edge_mean(ws, ms, ds, h, lane);
}

// a long row's segment j: its running (max, sum) per head into st [nseg,
// 2h]; BEL as pin_kernel's
template <typename T, bool BEL>
__global__ void __launch_bounds__(256)
pin_seg_stats(const int* __restrict__ ptr, const int* __restrict__ idx,
              const T* __restrict__ q, const float* __restrict__ kt,
              const float* __restrict__ ew, const int* __restrict__ plan,
              float* __restrict__ st, int nlong, int nseg, int a, int h,
              int att_type, gx_att::Scal scal, int kvec, int seg) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + w;
  if (j >= nseg) return;
  int r, sb, se, i;
  segment(ptr, plan, nlong, seg, j, r, sb, se, i);
  float* qs = smem + (size_t)w * warp_stride(a, h, BEL);
  float* ms = qs + a;
  float* ds = ms + h;
  float* ws = ds + h;
  stage_q(q, r, a, qs, lane);
  for (int b0 = sb; b0 < se; b0 += BATCH) {
    const int cnt = min(BATCH, se - b0);
    batch_scores<BEL>(qs, kt, idx, ew, b0, cnt, a, h, att_type, scal, kvec,
                      ws, lane);
    for (int hh = 0; hh < h; ++hh) {
      const float s = lane < cnt ? ws[lane * h + hh] : -INFINITY;
      const float m_old = b0 == sb ? -INFINITY : ms[hh];
      const float m = fmaxf(m_old, warp_max(s));
      const float sum = warp_sum(lane < cnt ? expf(s - m) : 0.f);
      const float den = b0 == sb ? sum : ds[hh] * expf(m_old - m) + sum;
      __syncwarp();  // every lane has read ms[hh] and ds[hh]
      if (lane == 0) {
        ms[hh] = m;
        ds[hh] = den;
      }
      __syncwarp();
    }
  }
  for (int hh = lane; hh < h; hh += 32) {
    st[(size_t)j * 2 * h + hh] = ms[hh];
    st[(size_t)j * 2 * h + h + hh] = ds[hh];
  }
}

// a long row's segment j: the row's max and denominators from its
// segments' (max, sum) in segment order, then its edges' means, each
// batch's scores recomputed (by the same batch_scores as pin_seg_stats's,
// so the same bits); BEL as pin_kernel's
template <typename T, bool BEL>
__global__ void __launch_bounds__(256)
pin_seg_write(const int* __restrict__ ptr, const int* __restrict__ idx,
              const T* __restrict__ q, const float* __restrict__ kt,
              const float* __restrict__ ew, const int* __restrict__ plan,
              const float* __restrict__ st, float* __restrict__ out,
              int nlong, int nseg, int a, int h, int att_type,
              gx_att::Scal scal, int kvec, int seg) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + w;
  if (j >= nseg) return;
  int r, sb, se, i;
  segment(ptr, plan, nlong, seg, j, r, sb, se, i);
  float* qs = smem + (size_t)w * warp_stride(a, h, BEL);
  float* ms = qs + a;
  float* ds = ms + h;
  float* ws = ds + h;
  const int p0 = plan[nlong + i], p1 = plan[nlong + i + 1];
  for (int hh = lane; hh < h; hh += 32) {
    float m = -INFINITY;
    for (int s = p0; s < p1; ++s) m = fmaxf(m, st[(size_t)s * 2 * h + hh]);
    float den = 0.f;
    for (int s = p0; s < p1; ++s)
      den += st[(size_t)s * 2 * h + h + hh] *
             expf(st[(size_t)s * 2 * h + hh] - m);
    ms[hh] = m;
    ds[hh] = den;
  }
  stage_q(q, r, a, qs, lane);
  for (int b0 = sb; b0 < se; b0 += BATCH) {
    const int cnt = min(BATCH, se - b0);
    batch_scores<BEL>(qs, kt, idx, ew, b0, cnt, a, h, att_type, scal, kvec,
                      ws, lane);
    if (lane < cnt) out[b0 + lane] = edge_mean(ws, ms, ds, h, lane);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, bool BEL>
cudaError_t run(const void* ptr, const void* idx, const void* q,
                const void* kt, const void* ew, const void* plan, void* st,
                void* out, int n, int a, int h, int att_type,
                gx_att::Scal scal, int kvec, int wpb, int seg, int nlong,
                int nseg, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)wpb * warp_stride(a, h, BEL);
  cudaError_t err = allow_smem(pin_kernel<T, BEL>, smem);
  if (err != cudaSuccess) return err;
  pin_kernel<T, BEL><<<(n + wpb - 1) / wpb, wpb * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const float*)kt,
      (const float*)ew, (float*)out, n, a, h, att_type, scal, kvec);
  err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  const int grid = (nseg + wpb - 1) / wpb;
  if ((err = allow_smem(pin_seg_stats<T, BEL>, smem)) != cudaSuccess)
    return err;
  pin_seg_stats<T, BEL><<<grid, wpb * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const float*)kt,
      (const float*)ew, (const int*)plan, (float*)st, nlong, nseg, a, h,
      att_type, scal, kvec, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(pin_seg_write<T, BEL>, smem)) != cudaSuccess)
    return err;
  pin_seg_write<T, BEL><<<grid, wpb * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const float*)kt,
      (const float*)ew, (const int*)plan, (const float*)st, (float*)out,
      nlong, nseg, a, h, att_type, scal, kvec, seg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [n, a] in dtype (0 float32, 1 bfloat16); kt [n, a] float32 keys (the
// K projection's); ew [E] float32 reweight values or null; out [E] float32
// head-mean attention per CSR slot; ov2, inv2l2 (exp_kernel's and
// beltrami_exp's feature kernel) and ov2p, inv2l2p (beltrami_exp's
// positional kernel; att_type 4 takes the kernels' BEL instances). kvec:
// the host's fused_attention.flash_kvec, kt on 16 bytes and scaled_dot's
// dk % 4 == 0 (its 16-byte loads) or beltrami_exp's dk / 2 % 4 == 0 (each
// half's); wpb warps per block (fused_attention.flash_warps, beltrami_exp's
// rounded stride counted); rows of more than 32 edges in the nseg segments
// of `seg` edges of `plan` (nlong rows), their (max, sum) in st [nseg,
// 2h].
// Returns the cudaError_t of the launch.
int gx_attention_pin(const void* ptr, const void* idx, const void* q,
                     const void* kt, const void* ew, const void* plan,
                     void* st, void* out, int n, int a, int h, int att_type,
                     float ov2, float inv2l2, float ov2p, float inv2l2p,
                     int dtype, int kvec, int wpb, int seg, int nlong,
                     int nseg, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const gx_att::Scal scal{ov2, inv2l2, ov2p, inv2l2p};
  cudaStream_t s = (cudaStream_t)stream;
  const bool bel = att_type == 4;
  if (dtype == 0)
    return (int)(bel ? &run<float, true> : &run<float, false>)(
        ptr, idx, q, kt, ew, plan, st, out, n, a, h, att_type, scal, kvec,
        wpb, seg, nlong, nseg, s);
  if (dtype == 1)
    return (int)(bel ? &run<__nv_bfloat16, true>
                     : &run<__nv_bfloat16, false>)(
        ptr, idx, q, kt, ew, plan, st, out, n, a, h, att_type, scal, kvec,
        wpb, seg, nlong, nseg, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
