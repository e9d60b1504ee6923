// GRAND-nl's attention RHS over the CSR layout: graph flash attention for
// evaluation, and the training forward with its two backward kernels.
//
// Replaces graphax/kernels/pallas_attention.py:
//   - `_make_flash_kernel` (:359, called by `_flash_call` :448): per row
//     tile, the K projection of the gathered sources, the per-edge per-head
//     scores of `_score_math`, an online row softmax (or squareplus with a
//     fixed global shift), the per-(row, head) denominators, the weighted
//     value sums and their head mean, out = mean_h acc / (d + 1e-16);
//   - `_make_gmax_kernel` (:481, called by `_gmax_call` :509): the global max
//     of the scores, squareplus's shift, 0 when no edge is real;
//   - K1 `_make_scores_kernel` (:114), K2 `_make_norm_kernel` (:197) and K3
//     `_make_attspmm_kernel` (:266, its row-denominator form) as the custom
//     VJP's forward with residuals (`_make_fused`, :1206-1213, :1070-1109):
//     fwd_res_kernel;
//   - B1 `_bwd1_kernel` (:576) and B2 `_make_bwd2_kernel` (:659): the
//     row-side backward, bwd_rows_kernel;
//   - B3 `_make_bwd3_kernel` (:727, called at :1241-1260): the column-side
//     backward, bwd_cols_kernel, over the CSC layout;
//   - K1 + K2 in their global-shift form (`_scores_call` + `_norm_call` with
//     one shift for every row, :1078-1087 under column normalisation and
//     graphax/kernels/pallas_winatt.py:199-207 on the windowed residual):
//     norm_kernel;
//   - K3 with denominators handed to it (`_attspmm_call`, :266), both forms:
//     a row table (the windowed residual against K5's combined
//     denominators, pallas_winatt.py:234-236) and, per edge, a column table
//     read at col[e] (`per_edge_denom=True`, :1089-1108): attspmm_kernel.
//
// The scores are `_score_math`'s (attention_score.cuh), Beltrami's
// `beltrami_exp` among them (:80-91: q and the K table 2A wide, each head's
// slice its feature half then its positional half), which the flash and
// gmax kernels take as graphax's do (`fused_path_applicable`, the pin's
// `attention_means_supported`); the training kernels score scaled_dot only.
//
// Eight kernels here:
//   kproj_kernel  K[N, A] = x Wk + bk in f32, once per node. graphax projects
//                 every gathered source row inside its kernels (E rows); the
//                 per-node pass computes the same values (f32 sums of exact
//                 state-dtype products, in another order) from N rows:
//                 2*N*D*A flops instead of 2*E*D*A. f32 (and bf16 shapes
//                 whose x tile does not fit shared memory) on CUDA-core
//                 FMAs, no TF32: at the arxiv widths in f32 its bytes (110
//                 MB of x in, 22 MB of K out, 0.039 ms at 3.35 TB/s) and its
//                 1.76 GFLOP (0.026 ms at 67 TFLOP/s) lie close, so x must
//                 stream at full rate while the FMA pipes stay busy. The
//                 first body (a lane per output column, x staged by scalar
//                 loads, two shared loads per FMA, all of Wk in shared
//                 memory: the D*A limit) took 0.168 ms on the H100; this one
//                 is a register-tiled GEMM for a skinny output, x and Wk
//                 streamed together in chunks of 32 along D through a
//                 3-stage cp.async ring (no D*A limit), 4 x 4 or 4 x 8
//                 outputs a thread from 16-byte shared loads, persistent
//                 over 128-row tiles: 0.099 ms there (PERF.md: its products
//                 wait on shared memory about as long as its staging waits
//                 on device memory). bf16 on the tensor cores,
//                 kproj_tc_kernel: bound
//                 by bytes (55 MB of x in, 22 MB of f32 K out at the arxiv
//                 shapes, 0.023 ms), so x streams in whole 128-row tiles by
//                 16-byte cp.async and the products (1.76 GFLOP) go
//                 through mma.sync.
//   gmax_kernel   flat over the layout's (slot, head) pairs, not rows (a
//                 max is order-free): each thread scores its pairs against
//                 K[col] by 16-byte loads of q and K, its slot's row from the
//                 layout's seg; a warp max, a block max, one atomicMax per
//                 block on an order-preserving integer encoding (the result
//                 does not depend on the schedule); the last block to finish
//                 decodes it, applies graphax's NEG/2 rule and resets the
//                 state. It must read q, K and the layout once (0.0115 ms on
//                 the arxiv windowed residual, 778,808 slots, bf16), and
//                 gathers K's 128 bytes a slot, mostly from L2 (100 MB,
//                 0.034 ms were all of it from device memory). The first
//                 body, a warp per row with q staged in shared memory and
//                 the row's (edge, head) pairs over the lanes (9 of 32 busy
//                 at 4.6 edges a row), took 0.114 ms there.
//   flash_kernel  one warp per CSR row, the row walk below (batches of 32
//                 edges, one per lane: indices, scores and weights first,
//                 then the gather with several x rows in flight): per head
//                 the shift (the row's max, or the global shift g under
//                 squareplus) and the f32 denominator d of the unrounded
//                 weights, then out = sum_e sum_h c_h rnd(x[col] rnd(e_h))
//                 with c_h = 1 / (H (d_h + 1e-16)), in f32, leaving as f32
//                 or bf16 with one rounding. rnd() is graphax's rounding
//                 point (:435): e cast to the state dtype and multiplied in
//                 it. No atomics; a row with no edge writes 0. Rows of
//                 more than 32 edges go to flash_seg_stats, flash_seg_sum
//                 and seg_combine.
//   fwd_res_kernel  the training forward for the configs the backward
//                 covers (scaled_dot, row softmax, no reweight), on the
//                 row walk: a warp per CSR row of at most 32 edges, one
//                 edge a lane, the scores of the row's (edge, head) pairs
//                 as flash takes them, kept as the [E, H] f32 residual
//                 beside the per-(row, head) shift (the row max, 0 for a
//                 row with no edge) and denominator (f32 sum of unrounded
//                 e), both by warp reductions. Then graphax's K3 rounding
//                 points: alpha = e / (denom > 0 ? denom : 1) (K3's
//                 zero-select, :287-290, not flash's +1e-16), w_e =
//                 rnd(mean_h alpha), out = sum rnd(x[col] * w_e) in f32,
//                 cast once to the state dtype. So it is not flash's
//                 function: the head mean is taken before the rounding.
//                 Longer rows go to flash's segment kernels in their
//                 residual form and seg_combine. The first body (the
//                 scores written and read back for the max and the sum,
//                 then the row walked an edge at a time, each weight
//                 recomputed and one x row in flight a warp) took 0.661 ms in bf16 at the arxiv stand-in's
//                 shapes on the H100 (PERF.md).
//   bwd_rows_kernel B1 + B2 on the row walk: a warp per CSR row of at most
//                 32 edges (longer ones in segments of 32), one edge a
//                 lane. alpha from the kept scores; da_e = g_r . x[col_e]
//                 in f32 (g exact in f32, as graphax's cast at :1219), the
//                 x rows gathered two at a time against g_r in registers
//                 and each lane's partials finished by a warp sum an edge;
//                 rho_rh = sum alpha_eh da_e / H; then ds_eh =
//                 alpha_eh (da_e / H - rho_rh) and dq_r = sum ds_eh K[col_e]
//                 in f32. The warp owns the row (a long row's segments add
//                 their rho partials in segment order before ds), so B1 and
//                 B2 are one kernel (graphax measured that fusion 2.3x
//                 slower on its TPU grid; here no sum crosses blocks).
//                 Reads K[col] from the K projection's f32 table where
//                 graphax's B2 projects each gathered row: the same f32
//                 sums of exact products, in another order. The first body
//                 (the row walked an edge at a time, a warp sum an edge, da
//                 kept in an [E] scratch, exp recomputed per column) took
//                 0.795 ms (PERF.md).
//   bwd_cols_kernel B3 over the CSC layout (the rows r of column c's slots:
//                 no slot permutation, as graphax's node-table gathers,
//                 :1232-1240), on the row walk: a warp per column of at most
//                 32 slots (longer ones in segments of 32, summed in order),
//                 one slot a lane. Recomputes s from q[r] and K[c] with the
//                 forward's score function, alpha from shift[r] and
//                 denom[r], then gathers the g rows several at a time: dxv_c
//                 = sum rnd(g[r] * rnd(mean_h alpha)) and da = g[r] . x[c];
//                 ds = alpha (da / H - rho[r]), dk_c = sum ds_h q[r]_h, f32.
//                 graphax's B3 takes k = x Wk + bk computed in the state
//                 dtype (:1242); this kernel takes the f32 K table, so its
//                 alpha is the forward's alpha exactly (in bf16 graphax's
//                 B3 alpha differs from its K1 alpha by k's rounding). The
//                 first body (a warp walking its column a slot at a time, q
//                 staged in shared memory, the scores on min(H, 32) lanes)
//                 took 1.17 ms in bf16 at the arxiv stand-in's shapes on
//                 the H100 (PERF.md).
//   norm_kernel   a group of 8 lanes a CSR row (longer rows in segments),
//                 one slot a lane: the score of `_score_math` from q[r] and
//                 K[col] in registers (q pre-scaled for scaled_dot, the f32
//                 K table, the optional reweight), then e = exp(s - g) or
//                 squareplus(s - g) with g ONE f32 value for every row (a
//                 0-d device tensor, from gmax_kernel), written to e [E, H]
//                 f32 unrounded as K2 writes it; per head the row's
//                 denominator sum e by a butterfly of width 8 (0 for a row
//                 with no edge). The first body (a warp a row, q staged in
//                 shared memory, lanes over the row's (edge, head) pairs, e
//                 read back for the sums) took 0.101 ms on the windowed
//                 residual (PERF.md).
//   attspmm_kernel one warp per CSR row, the row walk below: lane j of a
//                 batch computes edge j's w_e = rnd(mean_h e_eh / (den > 0 ?
//                 den : 1)) with K3's zero-select (:287-293), den from a
//                 per-row table [N, H] (den[r]) or a per-node column table
//                 read at the edge's column (den[col_e], the per-edge form
//                 without an [E, H] copy); out = (add + sum rnd(x[col] w_e))
//                 in f32, an optional f32 addend (the windowed route's K5
//                 half), leaving as f32 or bf16 with one rounding. A row
//                 with no edge writes the addend (or 0). Rows longer than the
//                 host's split go to attspmm_seg_sum and seg_combine.
//   The beltrami_exp instances (the template flag BEL of flash_kernel, its
//                 two segment kernels, gmax_kernel and norm_kernel;
//                 att_type 4 reaches only them, and the other types'
//                 instances compile from the same code as before them):
//                 Beltrami's split score over a head slice of 2 hk values,
//                 2 x 32 wide at BLEND's arxiv shapes, so 128 bytes of the
//                 f32 K table (43 MB, mostly L2-resident) a (edge, head)
//                 pair. In flash and gmax two lanes take a pair, one half
//                 each, its four float4 of K in flight (q by float4 from
//                 the warp's shared row in flash, by uint4 of the state
//                 dtype in gmax); each half summed in index order
//                 (attention_score.cuh's bel_sum), the product formed
//                 across the lane pair by one shuffle. The norm keeps its
//                 slot a lane and scores both halves on that lane
//                 (bel_score, q by uint4 of the state dtype). Every
//                 instance gives the same scores bit for bit. One lane a
//                 pair, its eight float4 in flight, spilled at flash's 48
//                 and gmax's 64 registers and measured slower. The first
//                 form (a __noinline__ helper, K a value at a time) took
//                 0.555 ms (flash, bf16) and 0.379 ms (gmax) on the H100
//                 (PERF.md).
//
// None of them uses atomics on floats: every output row is written by the
// one warp that owns it (a long row's segments are summed in order by one
// warp), so the results do not depend on the schedule.
//
// Semantics against graphax: the softmax shift is the row's final max, where
// graphax's online recurrence shifts each 128-row tile's block of edges by
// the running max and rescales; in f32 the two agree to rounding, in bf16 the
// rounded e differ by a bf16 rounding of their own.
//
// What bounds them on an H100 at the slice's shapes (N = 169,343, E =
// 1,354,429, D = 162, A = 32, H = 2, bf16): bytes. The flash kernel must read
// x, q, K and the CSR once and write the output (~200 MB with an f32 output,
// 0.06 ms at 3.35 TB/s) against ~1 GFLOP; gathered per edge, x is 439 MB
// (55 MB of x against a 50 MB L2, so some gathers miss), ~0.15 ms. The row
// walk keeps no [E, H] scratch, reads K[col] (L2-resident, 22 MB) by 16-byte
// loads and keeps several x rows in flight per warp, so it is bound by the
// gathers' bytes rather than by the latency of one row at a time; attspmm
// walks the same way. kproj reads x once and writes K (~77 MB) against 1.76
// GFLOP (on the tensor cores in bf16). The training kernels: the forward
// with residuals must move ~162 MB (0.048 ms), the row backward ~175 MB
// (0.052 ms), the column backward ~284 MB (0.085 ms), each against a few
// GFLOP; all three walk a batch of 32 edges (slots) at a time with several
// gathered rows in flight, so they wait on the latency of each row's chain
// of loads (ptr, indices, scores, the gathers) rather than on bytes.
// norm_kernel must read q, K and the CSR once and write e [E, H] and the
// [N, H] denominators (~47 MB over the whole arxiv CSR in bf16, 0.014 ms);
// attspmm_kernel must read e, a denominator table, x and the CSR and write
// the f32 output (~186 MB, 0.056 ms): both bytes-bound, both gathering per
// edge.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_score.cuh"
#include "row_walk.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int WPB = 8;     // warps (rows in flight) per block
constexpr float EPS = 1e-16f;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

using gx_att::batch_scores;
using gx_att::warp_max;
using gx_att::warp_stride;
using gx_att::warp_sum;
using gx_rows::BATCH;
using gx_rows::FULL;
using gx_rows::clear;
using gx_rows::gather;
using gx_rows::load_rows;
using gx_rows::products;
using gx_rows::rnd;
using gx_rows::seg_combine;
using gx_rows::segment;
using gx_rows::store_chunk;
using gx_rows::store_vec;
using gx_rows::Vec;

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

// The CUDA-core K projection (f32, and bf16 shapes whose x tile the
// tensor-core kernel cannot hold): a register-tiled GEMM for a skinny
// output. A CTA of 256 threads walks 128-row tiles of x (persistent over
// them) for KC_BN = 8 TN output columns (gridDim.y splits wider A); thread
// (ty, tx) of 32 x 8 holds rows ty + 32 i (i < 4) by columns 32 j + 4 tx ..
// + 3 (j < TN / 4): 4 TN f32 accumulators. x and Wk stream together in
// chunks of KC_BK = 32 along D, one chunk's x rows [128][KC_BK] and Wk rows
// [KC_BK][KC_BN] a stage, through a ring of KC_STAGES stages that the next
// tile's first chunks enter while this tile's last ones are multiplied.
// Copies are cp.async of vx (vw) bytes, 16, 8 or 4, the widest that divides
// a row's bytes and the operand's start (zero-filled past D, N or A), or
// one value at a time (0: odd D or A in bf16, a view that starts
// mid-pair). Each step of 4 along D reads 4 x vectors and TN Wk vectors of
// 4 values (16- or 8-byte shared loads: x's pitch of KC_BK + 16 bytes puts
// a warp's 4 rows in distinct banks, and its 8 column groups read 128
// contiguous bytes of Wk) for 16 TN FMAs. Each output is the f32 sum of
// the exact products in D's order (no TF32), bk added last; rows leave as
// 16-byte stores, a warp's 8 column groups one 128-byte row segment.
constexpr int KC_THREADS = 256, KC_TM = 4, KC_BM = 32 * KC_TM, KC_BK = 32,
              KC_STAGES = 3;

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v / 2);
}
// x's shared row pitch (KC_BK values + 16 bytes) and a stage's values
template <typename T> __host__ __device__ constexpr int kc_px() {
  return KC_BK + 16 / (int)sizeof(T);
}
template <typename T, int BN> __host__ __device__ constexpr int kc_stage() {
  return KC_BM * kc_px<T>() + KC_BK * BN;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// S [R][P] (R x C, C a power of two) = src[r * ld + c] for r < rows and c <
// cols, else 0: cp.async of vb bytes (16, 8 or 4; cols and C divide by its
// values), or one value per plain copy where vb == 0
template <typename T, int R, int C>
__device__ __forceinline__ void kc_stage_rows(T* S, int P, const T* src,
                                              size_t ld, int rows, int cols,
                                              int vb, int tid) {
  constexpr int LC = ilog2(C);
  if (vb == 0) {
    for (int i = tid; i < R * C; i += KC_THREADS) {
      const int r = i >> LC, c = i & (C - 1);
      S[r * P + c] = r < rows && c < cols ? src[r * ld + c] : from_f<T>(0.f);
    }
    return;
  }
  const int lp = __ffs(vb) - 1 - (sizeof(T) == 4 ? 2 : 1);  // log2 values a copy
  const int lcpr = LC - lp;
  for (int i = tid; i < (R << lcpr); i += KC_THREADS) {
    const int r = i >> lcpr, c = (i & ((1 << lcpr) - 1)) << lp;
    const bool ok = r < rows && c < cols;
    T* dst = S + r * P + c;
    const T* s = ok ? src + r * ld + c : src;
    if (vb == 16)
      gx_tc::cp_async16_zfill(dst, s, ok);
    else if (vb == 8)
      gx_tc::cp_async8_zfill(dst, s, ok);
    else
      gx_tc::cp_async4_zfill(dst, s, ok);
  }
}

template <typename T, int TN>
__global__ void __launch_bounds__(KC_THREADS)
kproj_kernel(const T* __restrict__ x, const T* __restrict__ wk,
             const float* __restrict__ bk, float* __restrict__ kt, int n,
             int d, int a, int vx, int vw) {
  constexpr int BN = 8 * TN, PX = kc_px<T>(), STAGE = kc_stage<T, BN>();
  extern __shared__ __align__(16) unsigned char smem_kc[];
  T* ring = reinterpret_cast<T*>(smem_kc);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int c0 = blockIdx.y * BN, nc = min(BN, a - c0);
  const int tiles = (n + KC_BM - 1) / KC_BM, nkc = (d + KC_BK - 1) / KC_BK;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * nkc;
  // the stage of step f (the CTA's tiles in turn, each chunk by chunk)
  int it = 0, ik = 0;  // tile (of this CTA's) and chunk of the next issue
  auto issue = [&](int f) {
    if (f < total) {
      T* xs = ring + (f % KC_STAGES) * STAGE;
      const int r0 = ((int)blockIdx.x + it * (int)gridDim.x) * KC_BM;
      const int k0 = ik * KC_BK, kw = min(KC_BK, d - k0);
      kc_stage_rows<T, KC_BM, KC_BK>(xs, PX, x + (size_t)r0 * d + k0, d,
                                     min(KC_BM, n - r0), kw, vx, tid);
      kc_stage_rows<T, KC_BK, BN>(xs + KC_BM * PX, BN,
                                  wk + (size_t)k0 * a + c0, a, kw, nc, vw,
                                  tid);
      if (++ik == nkc) {
        ik = 0;
        ++it;
      }
    }
    gx_tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < KC_STAGES - 1; ++s) issue(s);
  float bkr[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = 32 * (j >> 2) + 4 * tx + (j & 3);
    bkr[j] = c < nc ? bk[c0 + c] : 0.f;
  }
  float acc[KC_TM][TN];
#pragma unroll
  for (int i = 0; i < KC_TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int kc = 0, tl = blockIdx.x;  // chunk and tile of step f
  for (int f = 0; f < total; ++f) {
    gx_tc::cp_async_wait<KC_STAGES - 2>();
    __syncthreads();  // step f is in; step f - 1's stage is free
    issue(f + KC_STAGES - 1);
    const T* xs = ring + (f % KC_STAGES) * STAGE;
    const T* ws = xs + KC_BM * PX;
    const int kend = min(KC_BK, d - kc * KC_BK);
#pragma unroll
    for (int k = 0; k < KC_BK; k += 4) {
      if (k < kend) {  // columns past D are zeros on both sides
        float4 xv[KC_TM];
#pragma unroll
        for (int i = 0; i < KC_TM; ++i) xv[i] = ld4(xs + (ty + 32 * i) * PX + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 wv[TN / 4];
#pragma unroll
          for (int g = 0; g < TN / 4; ++g)
            wv[g] = ld4(ws + (k + kk) * BN + 32 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < KC_TM; ++i) {
            const float xk = comp(xv[i], kk);
#pragma unroll
            for (int g = 0; g < TN / 4; ++g) {
              acc[i][4 * g] = fmaf(xk, wv[g].x, acc[i][4 * g]);
              acc[i][4 * g + 1] = fmaf(xk, wv[g].y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(xk, wv[g].z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(xk, wv[g].w, acc[i][4 * g + 3]);
            }
          }
        }
      }
    }
    if (++kc == nkc) {  // the tile's last chunk: K rows out, sums reset
      const int r0 = tl * KC_BM;
#pragma unroll
      for (int i = 0; i < KC_TM; ++i) {
        const int r = r0 + ty + 32 * i;
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const int c = 32 * g + 4 * tx;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] = acc[i][4 * g + e] + bkr[4 * g + e];
            acc[i][4 * g + e] = 0.f;
          }
          if (r >= n || c >= nc) continue;
          float* p = kt + (size_t)r * a + c0 + c;
          if ((a & 3) == 0 && c + 3 < nc) {
            *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c + e < nc) p[e] = v[e];
          }
        }
      }
      kc = 0;
      tl += gridDim.x;
    }
  }
  gx_tc::cp_async_wait<0>();
}

// The bf16 K projection on the tensor cores: a persistent walk over
// 128-row tiles of x, staged by 16-byte cp.async (a tile of 128 rows is
// one contiguous 16-byte-aligned byte range of x whatever D; element
// copies for odd D or a misaligned view) into a ring of KP_STAGES shared
// buffers. Wk [D, A] is staged once per CTA, transposed, WkT [n][k]
// zero-padded to a multiple of 16 in k and in n, with 16-byte-aligned rows
// of 4 mod 8 words; B fragments come from it by ldmatrix, two at a time. Eight warps of 16 rows run mma.sync
// m16n8k16 over up to 64 output columns (gridDim.y splits wider A). A
// fragment's rows g and g+8 are staged rows 4 apart (warp pairs interleave
// over 32 rows), so with D's odd pitch in words (D = 162: 81) its 32-bit
// shared loads are free of bank conflicts. bk is added to the f32 sums in
// the epilogue and K leaves as 16-byte stores. One stage, four CTAs per
// SM, measured faster than two or three stages at fewer CTAs per SM: the
// other CTAs' loads fill the wait (PERF.md).
constexpr int KP_WARPS = 8, KP_ROWS = 16 * KP_WARPS, KP_NC = 64,
              KP_STAGES = 1;

__global__ void __launch_bounds__(KP_WARPS * 32)
kproj_tc_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ wk,
                const float* __restrict__ bk, float* __restrict__ kt, int n,
                int d, int a, int P, int PK, int vec) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_kp[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.y * KP_NC, nc = min(KP_NC, a - c0);
  const int nf = (nc + 7) >> 3, nr = (nc + 15) & ~15, kp = (d + 15) & ~15;
  bf* wt = reinterpret_cast<bf*>(smem_kp);  // [nr][PK]
  bf* xs = wt + nr * PK;                     // [KP_STAGES][KP_ROWS][P] + 16
  const int tiles = (n + KP_ROWS - 1) / KP_ROWS;
  auto issue = [&](int it) {
    const int tl = blockIdx.x + it * gridDim.x;
    if (tl < tiles) {
      const int r0 = tl * KP_ROWS;
      gx_tc::stage_rows(xs + (it % KP_STAGES) * KP_ROWS * P,
                        x + (size_t)r0 * d, min(KP_ROWS, n - r0), d, 0, d, P,
                        vec, tid, KP_WARPS * 32);
    }
    gx_tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < KP_STAGES - 1; ++s) issue(s);
  // WkT, 8 loads per thread in flight at a time
  const int nw = kp * nr;
  for (int i0 = tid; i0 < nw; i0 += 8 * KP_WARPS * 32) {
    bf v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * KP_WARPS * 32;
      const int k = i / nr, j = i - k * nr;
      v[u] = (i < nw && k < d && j < nc) ? wk[(size_t)k * a + c0 + j]
                                         : gx_tc::bzero();
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * KP_WARPS * 32;
      const int k = i / nr, j = i - k * nr;
      if (i < nw) wt[j * PK + k] = v[u];
    }
  }
  // this warp's fragment rows g, g+8: tile rows rw + 4g, rw + 4g + 1
  const int rw = (warp >> 1) * 32 + (warp & 1) * 2;
  const int g4 = 4 * (lane >> 2);
  for (int it = 0; blockIdx.x + it * gridDim.x < tiles; ++it) {
    issue(it + KP_STAGES - 1);
    gx_tc::cp_async_wait<KP_STAGES - 1>();
    __syncthreads();  // this tile (and, first time round, WkT) in place
    const bf* xt = xs + (it % KP_STAGES) * KP_ROWS * P;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kp; kk += 16) {
      uint32_t af[4];
      gx_tc::load_a(af, xt, P, rw + g4, rw + g4 + 1, kk, d, lane);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        if (j < nf) {
          uint32_t b[4];
          gx_tc::load_b2(b, wt, PK, j * 8, kk, lane);
          gx_tc::mma_bf16(acc[j], af, b[0], b[1]);
          if (j + 1 < nf) gx_tc::mma_bf16(acc[j + 1], af, b[2], b[3]);
        }
      }
    }
    const int r0 = (blockIdx.x + it * gridDim.x) * KP_ROWS + rw;
    const bool vec_out = (a & 3) == 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nf) {
        float v[4];
        int dr, dc;
        gx_tc::quad(acc[j], lane, v, dr, dc);
        // fragment row m = g + dr is tile row rw + 4 (m % 8) + m / 8
        const int r = r0 + g4 + (dr >> 3), c = j * 8 + dc;
        if (r < n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < nc) v[e] += bk[c0 + c + e];
          float* p = kt + (size_t)r * a + c0 + c;
          if (vec_out && c + 3 < nc) {
            gx_tc::store4(p, v);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (c + e < nc) p[e] = v[e];
          }
        }
      }
    }
    __syncthreads();  // the next issue() refills this tile's buffer
  }
  gx_tc::cp_async_wait<0>();
}

// The global max of the scores, flat over the layout's (slot, head) pairs
// (a max is order-free, so nothing ties it to rows): thread p takes pairs
// p, p + stride, ..., its slot's row from seg (int64) and column from idx,
// each score by gx_att::score_head from q's head slice (state dtype) and
// the K table's (f32), by 16-byte loads of both where qvec, in
// gx_att::score's arithmetic. A thread max, a warp max, a block max, one
// atomicMax a block on the order-preserving encoding; the last block to
// finish decodes it, applies graphax's NEG/2 rule and resets the state
// (state [2]: the encoded max, the blocks done) to zeros for the next call
// (the host keeps one state per stream, so no two launches share one).
// BEL: beltrami_exp's instance, by 16-byte loads of q and K where qvec
// (gx_att::bel_sum), two threads a pair: the flat index over half-pairs
// (thread 2p the feature half of pair p, 2p + 1 its positional half,
// gx_att::bel_lanes_score), each warp's loop uniform so the pair's
// shuffle sees both lanes; att_type 4 takes it and no other instance
// scores beltrami_exp.
constexpr int GM_THREADS = 256;
constexpr int GM_MIN_BLOCKS = 4;   // blocks an SM the registers allow (64
                                   // a thread; the beltrami_exp instance
                                   // measured fastest here too, PERF.md)

template <typename T, bool BEL>
__global__ void __launch_bounds__(GM_THREADS, GM_MIN_BLOCKS)
gmax_kernel(const long long* __restrict__ seg, const int* __restrict__ idx,
            const T* __restrict__ q, const float* __restrict__ kt,
            const float* __restrict__ ew, unsigned* __restrict__ state,
            float* __restrict__ out, long long pairs, int a, int h,
            int att_type, gx_att::Scal scal, int qvec) {
  __shared__ float wmax[GM_THREADS / 32];
  const int dk = a / h;
  float m = -INFINITY;
  const long long stride = (long long)gridDim.x * GM_THREADS;
  if constexpr (BEL) {
    const int hk = dk >> 1, lane = threadIdx.x & 31;
    for (long long w0 = (long long)blockIdx.x * GM_THREADS +
                        (threadIdx.x & ~31);
         w0 < 2 * pairs; w0 += stride) {
      const long long hp = w0 + lane, p = hp >> 1;
      const int half = (int)(hp & 1);
      const bool live = hp < 2 * pairs;
      long long e = 0;
      float sq = 0.f;
      if (live) {
        e = p / h;
        const int o = (int)(p - e * h) * dk + half * hk;
        sq = gx_att::bel_sum<T, true>(q + (size_t)__ldg(seg + e) * a + o,
                                      kt + (size_t)__ldg(idx + e) * a + o, hk,
                                      qvec);
      }
      float s = gx_att::bel_lanes_score(sq, half, scal);
      if (live && !half) {
        if (ew != nullptr) s *= __ldg(ew + e);
        m = fmaxf(m, s);
      }
    }
  } else {
    for (long long p = (long long)blockIdx.x * GM_THREADS + threadIdx.x;
         p < pairs; p += stride) {
      const long long e = p / h;
      const int hh = (int)(p - e * h);
      const T* qh = q + (size_t)__ldg(seg + e) * a + hh * dk;
      const float* kh = kt + (size_t)__ldg(idx + e) * a + hh * dk;
      float s = gx_att::score_head<T, true>(qh, kh, dk, att_type, scal,
                                            qvec);
      if (ew != nullptr) s *= __ldg(ew + e);
      m = fmaxf(m, s);
    }
  }
  m = warp_max(m);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) wmax[w] = m;
  __syncthreads();
  if (w == 0) {
    m = lane < GM_THREADS / 32 ? wmax[lane] : -INFINITY;
    m = warp_max(m);
    if (lane == 0) {
      if (m > -INFINITY) atomicMax(&state[0], enc(m));
      __threadfence();
      if (atomicAdd(&state[1], 1u) == gridDim.x - 1) {
        const unsigned v = atomicExch(&state[0], 0u);
        atomicExch(&state[1], 0u);
        const float g = v != 0u ? dec(v) : 0.f;
        *out = g <= NEG * 0.5f ? 0.f : g;
      }
    }
  }
}

// ---------------------------------------------------------------------
// The row walk of flash_kernel and attspmm_kernel
// ---------------------------------------------------------------------
//
// The walk itself (batches of 32 edges, U gathered x rows in flight per
// warp, loads of the host's gather_width, products rounded once, each
// column's f32 sum in edge order, segments of long rows and seg_combine) is
// row_walk.cuh's, shared with spmm.cu. Here lane j of a batch computes edge
// j's weight: in attspmm rnd(mean_h e / (den or 1)); in flash the lanes
// take the batch's (edge, head) pairs, each score from the row's q in
// shared memory and K[col] by 16-byte loads of the f32 K table, and the
// gather reads the per-(edge, head) weights by a broadcast read of the
// warp's shared batch. Lanes hold VPL vectors of a column chunk each; D up
// to 32 * VPL vectors is one chunk. The output leaves in f32 or bf16,
// optionally after an f32 addend, with one rounding.
//
// Flash's shift and denominators come before its gather. flash_kernel
// takes the rows of at most 32 edges, one batch each (the scores of the
// batch's (edge, head) pairs one per lane, then the per-head max and sum as
// warp reductions, the weights kept in shared memory for the gather: one
// walk). The weight is graphax's rnd(e) against the row's final max, c_h =
// 1 / (H (d_h + 1e-16)) folds the head mean into one f32 sum per column:
// out = sum_e sum_h c_h rnd(x[col] rnd(e_h)).
//
// Longer rows go to the segment kernels, planned by the host (`plan`:
// long_rows [nlong], long_ptr [nlong + 1] over the segments, seg_long
// [nseg]), one warp per segment of `seg` edges, so no row's serial walk
// sets the launch's length (a hub of a power-law graph): flash_seg_stats
// writes each segment's running (max, sum) per head over its batches, the
// sum rescaled by exp(old - new max); flash_seg_sum recombines its row's in
// segment order and recomputes each batch's scores (K is L2-resident) for
// its f32 partial sums, so x rows are still read once; seg_combine adds a
// row's partials in segment order (no float atomics: the result does not
// depend on the schedule). attspmm's rows longer than `split` edges take
// the same segments (attspmm_seg_sum, seg_combine). Keeping the multi-batch
// walk out of the one-batch kernel keeps that kernel within 64 registers.

constexpr int VPL = 3;      // x vectors per lane in one column chunk
// x rows in flight per warp: U edges' loads of VPL vectors of VB bytes
template <int VB> constexpr int U = VB <= 4 ? 4 : 2;
// blocks per SM the walk kernels' registers allow: more rows in flight on
// each SM measured faster than more x rows in flight per warp. The
// one-batch flash kernel fits 48 registers a thread (5 blocks; its
// beltrami_exp instance spills at 6 and measured slower there, PERF.md);
// attspmm's walk spills there and keeps 64 (4 blocks).
constexpr int FLASH_MIN_BLOCKS = 5;
constexpr int MIN_BLOCKS = 4;

// flash: the batch's scores into the running per-head shift ms (the max;
// squareplus: the global shift g) and sum ds of weight(s - shift), the sum
// rescaled by exp(old - new max); with `keep` (the row's only batch) the
// rounded weights rnd(e) replace the scores
template <typename T, bool SQP>
__device__ __forceinline__ void batch_stats(float* ws, float* ms, float* ds,
                                            int cnt, int h, float g,
                                            bool first, bool keep, int lane) {
  for (int hh = 0; hh < h; ++hh) {
    const float s = lane < cnt ? ws[lane * h + hh] : -INFINITY;
    const float m_old = first ? -INFINITY : ms[hh];
    const float m = SQP ? g : fmaxf(m_old, warp_max(s));
    const float e = lane < cnt ? weight<SQP>(s - m) : 0.f;
    const float sum = warp_sum(e);
    const float den =
        first ? sum : (SQP ? ds[hh] : ds[hh] * expf(m_old - m)) + sum;
    __syncwarp();  // every lane has read ms[hh] and ds[hh]
    if (lane == 0) {
      ms[hh] = m;
      ds[hh] = den;
    }
    if (keep && lane < cnt) ws[lane * h + hh] = rnd<T>(e);
  }
  __syncwarp();
}

// flash: the batch's rounded weights from its scores and the row's shift
template <typename T, bool SQP>
__device__ __forceinline__ void batch_weights(float* ws, const float* ms,
                                              int cnt, int h, int lane) {
  if (lane < cnt)
    for (int hh = 0; hh < h; ++hh)
      ws[lane * h + hh] = rnd<T>(weight<SQP>(ws[lane * h + hh] - ms[hh]));
  __syncwarp();
}

// flash: the denominators ds become the head scales 1 / (H (d + EPS))
__device__ __forceinline__ void head_scales(float* cs, int h, int lane) {
  for (int hh = lane; hh < h; hh += 32)
    cs[hh] = 1.f / ((float)h * (cs[hh] + EPS));
  __syncwarp();
}

// flash: acc += c_h rnd(x[col] w_eh) over the batch's edges and heads
template <typename T, int VB>
__device__ __forceinline__ void gather_flash(
    float (&acc)[VPL][Vec<T, VB>::E], const T* __restrict__ x, int col,
    int cnt, const float* ws, const float* cs, int h, int d, int v0,
    int nvec, int lane) {
  using V = Vec<T, VB>;
  for (int e0 = 0; e0 < cnt; e0 += U<VB>) {
    uint32_t raw[U<VB>][VPL][V::W];
    load_rows<T, VB, VPL, U<VB>>(raw, x, col, e0, cnt, d, v0, nvec, lane);
#pragma unroll
    for (int u = 0; u < U<VB>; ++u) {
      if (e0 + u < cnt) {
        const float* we = ws + (e0 + u) * h;
        for (int hh = 0; hh < h; ++hh) {
          const float wt = we[hh], c = cs[hh];
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            float p[V::E];
            products<T, VB>(raw[u][v], wt, p);
#pragma unroll
            for (int k = 0; k < V::E; ++k) acc[v][k] += c * p[k];
          }
        }
      }
    }
  }
}

// the rows of at most BATCH edges, one batch each: the scores, the shift
// and the denominators, then the gather of the weights kept in shared
// memory; longer rows are the segment kernels'. One row per warp: walking
// rows r, r + stride, ... with the next row's bounds and columns loaded
// ahead measured slower here than at the attspmm kernel (PERF.md). BEL:
// beltrami_exp's instance (batch_scores<true>, the warp stride of
// gx_att::warp_stride); att_type 4 takes it and no other instance scores
// beltrami_exp, so the others compile from the same code as before it.
template <typename T, int VB, bool SQP, bool BEL>
__global__ void __launch_bounds__(WPB * 32, FLASH_MIN_BLOCKS)
flash_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
             const T* __restrict__ q, const T* __restrict__ x,
             const float* __restrict__ kt, const float* __restrict__ ew,
             const float* __restrict__ gshift, void* __restrict__ out,
             int otype, int n, int d, int a, int h, int att_type,
             gx_att::Scal scal, int kvec) {
  using V = Vec<T, VB>;
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + w;
  if (r >= n) return;
  const int beg = ptr[r], len = ptr[r + 1] - beg;
  if (len > BATCH) return;
  float* qs = smem + (size_t)w * warp_stride(a, h, BEL);
  float* ms = qs + a;
  float* cs = ms + h;
  float* ws = cs + h;
  // the columns, loaded while q comes in
  const int col = lane < len ? idx[beg + lane] : 0;
  if (len > 0) {
    for (int i = lane; i < a; i += 32) qs[i] = to_f(q[(size_t)r * a + i]);
    __syncwarp();
    batch_scores<BEL>(qs, kt, idx, ew, beg, len, a, h, att_type, scal, kvec,
                      ws, lane, col);
    batch_stats<T, SQP>(ws, ms, cs, len, h, SQP ? *gshift : 0.f, true, true,
                        lane);
    head_scales(cs, h, lane);
  }
  const int nvec = d / V::E;
  for (int v0 = 0; v0 < nvec; v0 += 32 * VPL) {
    float acc[VPL][V::E];
    clear(acc);
    gather_flash<T, VB>(acc, x, col, len, ws, cs, h, d, v0, nvec, lane);
    store_chunk<T, VB, VPL>(acc, out, otype, nullptr, (size_t)r * d, v0, nvec,
                       lane);
  }
}

// a long row's segment j: its running (max, sum) per head into st [nseg,
// 2h]; with RES (the training forward) also its scores into sc [E, h];
// BEL as flash_kernel's (never with RES: the training kernels score
// scaled_dot only)
template <typename T, bool SQP, bool RES, bool BEL>
__global__ void __launch_bounds__(WPB * 32)
flash_seg_stats(const int* __restrict__ ptr, const int* __restrict__ idx,
                const T* __restrict__ q, const float* __restrict__ kt,
                const float* __restrict__ ew, const float* __restrict__ gshift,
                const int* __restrict__ plan, float* __restrict__ st,
                float* __restrict__ sc, int nlong, int nseg, int a, int h,
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
  for (int t = lane; t < a; t += 32) qs[t] = to_f(q[(size_t)r * a + t]);
  __syncwarp();
  const float g = SQP ? *gshift : 0.f;
  for (int b0 = sb; b0 < se; b0 += BATCH) {
    const int cnt = min(BATCH, se - b0);
    batch_scores<BEL>(qs, kt, idx, ew, b0, cnt, a, h, att_type, scal, kvec,
                      ws, lane);
    if (RES)
      for (int p = lane; p < cnt * h; p += 32) sc[(size_t)b0 * h + p] = ws[p];
    batch_stats<T, SQP>(ws, ms, ds, cnt, h, g, b0 == sb, false, lane);
  }
  for (int hh = lane; hh < h; hh += 32) {
    st[(size_t)j * 2 * h + hh] = ms[hh];
    st[(size_t)j * 2 * h + h + hh] = ds[hh];
  }
}

// a long row's segment j: the row's shift and denominators from its
// segments' (max, sum) in segment order, then the segment's f32 partial
// sums into part [nseg, d], each batch's scores recomputed for its
// weights. With RES (the training forward) the row's first segment writes
// shift and denom [n, h], and the weights are K3's, rnd(mean_h exp(s -
// shift) / (den or 1)), from the scores kept in sc. BEL as
// flash_seg_stats's
template <typename T, int VB, bool SQP, bool RES, bool BEL>
__global__ void __launch_bounds__(WPB * 32)
flash_seg_sum(const int* __restrict__ ptr, const int* __restrict__ idx,
              const T* __restrict__ q, const T* __restrict__ x,
              const float* __restrict__ kt, const float* __restrict__ ew,
              const float* __restrict__ gshift, const int* __restrict__ plan,
              const float* __restrict__ st, const float* __restrict__ sc,
              float* __restrict__ shift, float* __restrict__ denom,
              float* __restrict__ part, int nlong, int nseg, int d, int a,
              int h, int att_type, gx_att::Scal scal, int kvec,
              int seg) {
  using V = Vec<T, VB>;
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + w;
  if (j >= nseg) return;
  int r, sb, se, i;
  segment(ptr, plan, nlong, seg, j, r, sb, se, i);
  float* qs = smem + (size_t)w * warp_stride(a, h, BEL);
  float* ms = qs + a;
  float* cs = ms + h;
  float* ws = cs + h;
  if (!RES)
    for (int t = lane; t < a; t += 32) qs[t] = to_f(q[(size_t)r * a + t]);
  const int p0 = plan[nlong + i], p1 = plan[nlong + i + 1];
  for (int hh = lane; hh < h; hh += 32) {
    float m = SQP ? *gshift : -INFINITY;
    if (!SQP)
      for (int s = p0; s < p1; ++s) m = fmaxf(m, st[(size_t)s * 2 * h + hh]);
    float den = 0.f;
    for (int s = p0; s < p1; ++s) {
      const float ds = st[(size_t)s * 2 * h + h + hh];
      den += SQP ? ds : ds * expf(st[(size_t)s * 2 * h + hh] - m);
    }
    if (RES && j == p0) {
      shift[(size_t)r * h + hh] = m;
      denom[(size_t)r * h + hh] = den;
    }
    ms[hh] = m;
    cs[hh] = RES && !(den > 0.f) ? 1.f : den;
  }
  __syncwarp();
  if (!RES) head_scales(cs, h, lane);
  const int nvec = d / V::E;
  for (int v0 = 0; v0 < nvec; v0 += 32 * VPL) {
    float acc[VPL][V::E];
    clear(acc);
    for (int b0 = sb; b0 < se; b0 += BATCH) {
      const int cnt = min(BATCH, se - b0);
      if constexpr (RES) {
        int col = 0;
        float wl = 0.f;
        if (lane < cnt) {
          col = idx[b0 + lane];
          float wsum = 0.f;
          for (int hh = 0; hh < h; ++hh)
            wsum += expf(sc[(size_t)(b0 + lane) * h + hh] - ms[hh]) / cs[hh];
          wl = rnd<T>(wsum / (float)h);
        }
        gather<T, VB, VPL, U<VB>>(acc, x, col, wl, cnt, d, v0, nvec, lane);
      } else {
        const int col = batch_scores<BEL>(qs, kt, idx, ew, b0, cnt, a, h,
                                          att_type, scal, kvec, ws, lane);
        batch_weights<T, SQP>(ws, ms, cnt, h, lane);
        gather_flash<T, VB>(acc, x, col, cnt, ws, cs, h, d, v0, nvec, lane);
      }
    }
    store_chunk<T, VB, VPL>(acc, part, 0, nullptr, (size_t)j * d, v0, nvec, lane);
  }
}

// ---------------------------------------------------------------------
// K1 + K2 + K3 with residuals (fwd_res_kernel) and B1 + B2
// (bwd_rows_kernel) on the row walk
// ---------------------------------------------------------------------
//
// fwd_res_kernel gives a warp each CSR row of at most BATCH edges, one
// edge a lane: the lane loads its column; lanes over the batch's (edge,
// head) pairs score them as flash does (batch_scores: q in the warp's
// shared memory, K[col] by 16-byte loads where KV, in score()'s order),
// into the warp's shared batch and from there to sc; per head the shift m
// (warp_max; 0 for a row with no edge) and den = sum exp(s - m)
// (warp_sum), then lane j's K3 weight w_j = rnd((sum_h exp(s_jh - m_h) /
// (den_h or 1)) / H), the heads summed in order, divided by H and rounded
// once (graphax's order, pallas_attention.py:287-293). The gather is
// attspmm's (row_walk.cuh's gather: U x rows in flight, products rounded
// once, f32 sums in edge order, cast once to T). So on such rows sc, shift,
// den and the bf16 out are the first body's bit for bit. The longer rows
// go in segments of `seg` edges through flash's segment kernels with RES:
// flash_seg_stats (a warp a segment, its batches scored as above and
// written to sc, its running max and sum of exp(s - max) per head),
// flash_seg_sum (the row's shift, its max over the segments, and den, the
// segments' sums rescaled to it in segment order, both written by the
// row's first segment; sc read back for K3's weights; f32 partials) and
// seg_combine.
//
// bwd_rows_kernel takes work items, a warp each: the CSR rows of at most
// BATCH edges, then the BATCH-edge segments of the longer rows. Lane j
// holds edge j: its column, and alpha_jh = exp(s - shift) / (denom or 1)
// per head in the warp's shared batch [BATCH, h]. g_r's chunk sits in
// registers while the batch's x rows are gathered BR_ROWS at a time
// (row_walk.cuh's batch_dots, shared with spmm.cu's SDDMM: load_rows, then
// each lane's partials of those dot products through row_dots), after
// which lane j holds da_j = g_r . x[col_j] in f32. rho_h = sum_j alpha_jh
// da_j / H is a warp sum; ds_jh = alpha_jh
// (da_j / H - rho_h) replaces alpha in the batch, and dq_r = sum_j ds_jh
// K[col_j] goes by lanes over A (lane_sums, UQ K rows in flight), the
// edges in order. A segment's item writes its da (dab) and its rho
// partial (pr) instead; bwd_rows_seg_dq (a warp a segment) adds the row's
// rho partials in segment order (the row's first segment writes rho[r]),
// forms ds from the kept da and writes its dq partial, which seg_combine
// adds in segment order.

// blocks an SM the registers allow: 64 registers a thread for the
// forward, 40 for the row backward (more rows in flight measured faster
// there than more registers: PERF.md). ptxas -v on the H100's toolkit:
// fwd_res_kernel 46-56 registers, no spills; the residual form of
// flash_seg_stats 64, none, of flash_seg_sum 48-64, 4 bytes of spill
// stores and loads at bf16's 2-byte and f32's 4-byte loads;
// bwd_rows_kernel 40, 8 bytes of spill stores and loads at bf16's 4-byte
// loads (the arxiv width) and at 2 and f32's 4, 12/12 at f32's 8-byte
// ones (the arxiv width in f32), 36/72 at bf16's 8-byte ones;
// bwd_rows_seg_dq 48, none
constexpr int FR_MIN_BLOCKS = 4;
constexpr int BR_MIN_BLOCKS = 6;
constexpr int BR_ROWS = 2;   // x rows in flight in the row backward
constexpr int UQ = 8;        // table rows in flight in lane_sums

// out[i] = sum_j ws[j h + i / (a / h)] tab[row_j a + i] over the cnt slots
// j of a batch in order (lane j holding row_j), lanes over the a columns,
// UQ table rows (q in T, or the f32 K table) in flight: B3's dk and the
// row backward's dq
template <typename Q>
__device__ __forceinline__ void lane_sums(const float* ws,
                                          const Q* __restrict__ tab, int row,
                                          int cnt, int a, int h,
                                          float* __restrict__ out, int lane) {
  const int dkh = a / h;
  for (int i0 = 0; i0 < a; i0 += 32) {
    const int i = i0 + lane;
    const float* wi = ws + (i < a ? i / dkh : 0);
    float s = 0.f;
    for (int j0 = 0; j0 < cnt; j0 += UQ) {
      float qv[UQ];
#pragma unroll
      for (int u = 0; u < UQ; ++u) {
        const int rj = __shfl_sync(FULL, row, (j0 + u) & 31);
        qv[u] = j0 + u < cnt && i < a ? to_f(tab[(size_t)rj * a + i]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UQ; ++u)
        if (j0 + u < cnt) s += wi[(j0 + u) * h] * qv[u];
    }
    if (i < a) out[i] = s;
  }
}

// the rows of at most BATCH edges, one batch each (a longer row's warp
// returns: the segment kernels'): the scores (flash's batch_scores: lanes
// over the batch's (edge, head) pairs, q in the warp's shared memory), the
// residuals, the weights, the gather; out in T (otype 0 f32, 1 bf16). Each
// warp's shared memory holds the batch's scores [BATCH, h] and q [a]
template <typename T, int VB, bool KV>
__global__ void __launch_bounds__(WPB * 32, FR_MIN_BLOCKS)
fwd_res_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
               const T* __restrict__ q, const T* __restrict__ x,
               const float* __restrict__ kt, float* __restrict__ sc,
               float* __restrict__ shift, float* __restrict__ denom,
               void* __restrict__ out, int otype, int n, int d, int a,
               int h) {
  using V = Vec<T, VB>;
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + w;
  if (r >= n) return;
  const int beg = ptr[r], len = ptr[r + 1] - beg;
  if (len > BATCH) return;
  const int col = lane < len ? idx[beg + lane] : 0;
  float* ws = smem + (size_t)w * (BATCH * h + a);
  if (len > 0) {
    float* qs = ws + BATCH * h;
    for (int i = lane; i < a; i += 32) qs[i] = to_f(q[(size_t)r * a + i]);
    __syncwarp();
    batch_scores(qs, kt, idx, nullptr, beg, len, a, h, 0, gx_att::Scal{},
                 KV ? 1 : 0, ws, lane, col);
    for (int p = lane; p < len * h; p += 32) sc[(size_t)beg * h + p] = ws[p];
  }
  float wsum = 0.f;
  for (int hh = 0; hh < h; ++hh) {
    const float s = lane < len ? ws[lane * h + hh] : -INFINITY;
    const float m = len > 0 ? warp_max(s) : 0.f;
    const float e = lane < len ? expf(s - m) : 0.f;
    const float den = warp_sum(e);
    if (lane == 0) {
      shift[(size_t)r * h + hh] = m;
      denom[(size_t)r * h + hh] = den;
    }
    wsum += e / (den > 0.f ? den : 1.f);
  }
  const float wt = rnd<T>(wsum / (float)h);
  const int nvec = d / V::E;
  for (int v0 = 0; v0 < nvec; v0 += 32 * VPL) {
    float acc[VPL][V::E];
    clear(acc);
    gather<T, VB, VPL, U<VB>>(acc, x, col, wt, len, d, v0, nvec, lane);
    store_chunk<T, VB, VPL>(acc, out, otype, nullptr, (size_t)r * d, v0, nvec,
                            lane);
  }
}

// alpha of edge e's head hh in row r: exp(s - shift) / (denom or 1)
__device__ __forceinline__ float alpha_of(const float* __restrict__ sc,
                                          const float* __restrict__ shift,
                                          const float* __restrict__ denom,
                                          int e, int r, int hh, int h) {
  const float dn = __ldg(denom + (size_t)r * h + hh);
  return expf(__ldg(sc + (size_t)e * h + hh) -
              __ldg(shift + (size_t)r * h + hh)) /
         (dn > 0.f ? dn : 1.f);
}

// one row-backward batch: the edges [sb, sb + cnt) (cnt <= BATCH) of row
// r, lane j holding edge j and its column col: alpha_jh into ws [BATCH,
// h], and returned da_j = g_r . x[col_j] in f32 (g exact in f32)
template <typename T, int VB>
__device__ __forceinline__ float rows_batch(
    const float* __restrict__ sc, const float* __restrict__ shift,
    const float* __restrict__ denom, const T* __restrict__ g,
    const T* __restrict__ x, int r, int sb, int cnt, int d, int h,
    float* ws, int col, int lane) {
  if (lane < cnt)
    for (int hh = 0; hh < h; ++hh)
      ws[lane * h + hh] = alpha_of(sc, shift, denom, sb + lane, r, hh, h);
  return gx_rows::batch_dots<T, VB, VPL, BR_ROWS>(g + (size_t)r * d, x, col,
                                                cnt, d, lane);
}

// the row backward's items, a warp each: the rows of at most BATCH edges
// (item r < n; a longer row's item returns), then the BATCH-edge segments
// of the longer ones (item n + j: its da into dab [nseg, BATCH], its rho
// partial into pr [nseg, h])
template <typename T, int VB>
__global__ void __launch_bounds__(WPB * 32, BR_MIN_BLOCKS)
bwd_rows_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
                const float* __restrict__ sc, const float* __restrict__ shift,
                const float* __restrict__ denom, const T* __restrict__ g,
                const T* __restrict__ x, const float* __restrict__ kt,
                const int* __restrict__ plan, float* __restrict__ dab,
                float* __restrict__ pr, float* __restrict__ dq,
                float* __restrict__ rho, int n, int d, int a, int h,
                int nlong, int nseg) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + w;
  float* ws = smem + (size_t)w * BATCH * h;
  int r, sb, cnt, j = -1;
  if (item < n) {
    r = item;
    sb = ptr[r];
    cnt = ptr[r + 1] - sb;
    if (cnt > BATCH) return;   // the segments'
  } else if (item < n + nseg) {
    int se, i;
    j = item - n;
    segment(ptr, plan, nlong, BATCH, j, r, sb, se, i);
    cnt = se - sb;
  } else {
    return;
  }
  const int col = lane < cnt ? idx[sb + lane] : 0;
  const float da = rows_batch<T, VB>(sc, shift, denom, g, x, r, sb, cnt, d,
                                     h, ws, col, lane);
  const float dah = da / (float)h;
  for (int hh = 0; hh < h; ++hh) {
    const float t = warp_sum(lane < cnt ? ws[lane * h + hh] * dah : 0.f);
    if (lane == 0) {
      if (j >= 0) pr[(size_t)j * h + hh] = t;
      else rho[(size_t)r * h + hh] = t;
    }
    if (j < 0 && lane < cnt) ws[lane * h + hh] *= dah - t;
  }
  if (j >= 0) {
    if (lane < cnt) dab[(size_t)j * BATCH + lane] = da;
    return;
  }
  __syncwarp();
  lane_sums(ws, kt, col, cnt, a, h, dq + (size_t)r * a, lane);
}

// a long row's segment j: rho from the row's partials in segment order
// (the first segment writes rho[r]), ds from the kept da, the segment's dq
// partial into pq [nseg, a]
__global__ void __launch_bounds__(WPB * 32)
bwd_rows_seg_dq(const int* __restrict__ ptr, const int* __restrict__ idx,
                const float* __restrict__ sc, const float* __restrict__ shift,
                const float* __restrict__ denom, const float* __restrict__ kt,
                const int* __restrict__ plan, const float* __restrict__ dab,
                const float* __restrict__ pr, float* __restrict__ pq,
                float* __restrict__ rho, int nlong, int nseg, int a, int h) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + w;
  if (j >= nseg) return;
  float* ws = smem + (size_t)w * BATCH * h;
  int r, sb, se, i;
  segment(ptr, plan, nlong, BATCH, j, r, sb, se, i);
  const int cnt = se - sb, p0 = plan[nlong + i], p1 = plan[nlong + i + 1];
  const int col = lane < cnt ? idx[sb + lane] : 0;
  const float dah = lane < cnt ? dab[(size_t)j * BATCH + lane] / (float)h
                               : 0.f;
  for (int hh = 0; hh < h; ++hh) {
    float t = 0.f;
    for (int s = p0; s < p1; ++s) t += pr[(size_t)s * h + hh];
    if (j == p0 && lane == 0) rho[(size_t)r * h + hh] = t;
    if (lane < cnt)
      ws[lane * h + hh] =
          alpha_of(sc, shift, denom, sb + lane, r, hh, h) * (dah - t);
  }
  __syncwarp();
  lane_sums(ws, kt, col, cnt, a, h, pq + (size_t)j * a, lane);
}

// ---------------------------------------------------------------------
// B3 (bwd_cols_kernel) and K1 + K2 under one shift (norm_kernel) on the
// row walk
// ---------------------------------------------------------------------
//
// bwd_cols_kernel takes work items, a warp each: the CSC columns of at
// most BATCH slots, then the segments of BATCH slots of the longer columns
// (the host's row_split_plan on the CSC ptr), whose f32 partials pk [nseg,
// a] and pv [nseg, d] seg_combine adds in segment order. Each item is one
// batch, lane j holding slot j: its row r, per head alpha = exp(s -
// shift[r]) / (denom[r] or 1) with s scored from q[r] (16-byte loads of
// the state dtype) and the column's K row (one address for the whole warp:
// an L1 broadcast), in gx_att::score's order, so alpha and w = rnd(mean_h
// alpha) are the forward's. Then the g rows of the batch are gathered U at
// a time (row_walk.cuh's load_rows over the column chunk, x[c]'s chunk in
// registers): each adds rnd(g[r] w) to dxv's f32 sums in slot order and
// its partial of da = g[r] . x[c], finished by a warp sum per slot (lane j
// keeps slot j's). Last ds_h = alpha_h (da / H - rho[r, h]) goes to the
// warp's shared batch [BATCH, h], and lanes over A sum ds_h q[r]_h over
// the batch's slots in order into dk.
//
// norm_kernel gives a group of NM_LANES lanes each work item: the rows of
// at most NM_CUT slots, then the segments of NM_SEG slots of the longer
// rows (their per-head partial sums [nseg, h] added in order by
// seg_combine). The group walks the item's slots a batch of NM_LANES at a
// time, one slot a lane, each score from q[r] and K[col] in registers
// (gx_att::score_head, 16-byte loads where kvec), e = weight(s - g)
// written unrounded, and per head the sum of e by a butterfly of width
// NM_LANES. A row of at most 2 NM_LANES slots sums as the first body's
// warp a row did (lane l: e_l + e_(l + NM_LANES), its butterfly's step at
// NM_LANES, then the same steps below it; its lanes past the row added
// zeros), so den is that kernel's bit for bit there. Fewer lanes a row
// measured faster (more rows in flight, fewer idle lanes: PERF.md).

// blocks an SM the registers allow (64 a thread at 4)
constexpr int B3_MIN_BLOCKS = 4;
constexpr int B3_WORDS = 12;   // 32-bit words of g rows in flight a lane

// one B3 item: the slots [sb, sb + cnt) (cnt <= BATCH) of column c, their
// dk into dk_out [a] and dxv into dxv_out [d] (the column's rows, or a
// segment's partials); ws the warp's [BATCH, h] floats. KV: the scores by
// 16-byte loads (the host's kvec)
template <typename T, int VB, bool KV>
__device__ __forceinline__ void bwd_cols_batch(
    const int* __restrict__ idx, const T* __restrict__ q,
    const T* __restrict__ g, const T* __restrict__ x,
    const float* __restrict__ kt, const float* __restrict__ shift,
    const float* __restrict__ denom, const float* __restrict__ rho, int c,
    int sb, int cnt, float* __restrict__ dk_out, float* __restrict__ dxv_out,
    int d, int a, int h, float* ws, int lane) {
  using V = Vec<T, VB>;
  // g rows in flight: B3_WORDS words a lane
  constexpr int U = B3_WORDS / (VPL * V::W) > 0 ? B3_WORDS / (VPL * V::W) : 1;
  const int dkh = a / h;
  const float fh = (float)h;
  const int nvec = d / V::E;
  const int r = lane < cnt ? idx[sb + lane] : 0;
  // lane j's slot: alpha per head (into ws) and w
  float w = 0.f;
  if (lane < cnt) {
    const T* qr = q + (size_t)r * a;
    const float* kc = kt + (size_t)c * a;
    float wsum = 0.f;
    for (int hh = 0; hh < h; ++hh) {
      const float s = gx_att::score_head<T, true>(
          qr + hh * dkh, kc + hh * dkh, dkh, 0, gx_att::Scal{}, KV ? 1 : 0);
      const float dn = __ldg(denom + (size_t)r * h + hh);
      const float al =
          expf(s - __ldg(shift + (size_t)r * h + hh)) / (dn > 0.f ? dn : 1.f);
      ws[lane * h + hh] = al;
      wsum += al;
    }
    w = rnd<T>(wsum / fh);
  }
  // the gather: dxv's sums and lane j's da
  float da = 0.f;
  const T* xc = x + (size_t)c * d;
  for (int v0 = 0; v0 < nvec; v0 += 32 * VPL) {
    float xs[VPL][V::E];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int vi = v0 + v * 32 + lane;
      uint32_t raw[V::W];
      if (vi < nvec) {
        gx_rows::ldv<VB>(xc + (size_t)vi * V::E, raw);
        gx_rows::unpack<T, VB>(raw, xs[v]);
      } else {
#pragma unroll
        for (int k = 0; k < V::E; ++k) xs[v][k] = 0.f;
      }
    }
    float acc[VPL][V::E];
    clear(acc);
    // U gathered rows from e0: dxv's products, each row's da partial
    auto rows = [&](uint32_t (&raw)[U][VPL][V::W], int e0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float wt = __shfl_sync(FULL, w, (e0 + u) & 31);
        if (e0 + u < cnt) {   // the same for the whole warp
          float p = 0.f;
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            if (v0 + v * 32 + lane < nvec) {
              float pr[V::E], f[V::E];
              products<T, VB>(raw[u][v], wt, pr);
              gx_rows::unpack<T, VB>(raw[u][v], f);
#pragma unroll
              for (int k = 0; k < V::E; ++k) {
                acc[v][k] += pr[k];
                p += f[k] * xs[v][k];
              }
            }
          }
          p = warp_sum(p);
          if (lane == e0 + u) da += p;
        }
      }
    };
    for (int e0 = 0; e0 < cnt; e0 += U) {
      uint32_t raw[U][VPL][V::W];
      load_rows<T, VB, VPL, U>(raw, g, r, e0, cnt, d, v0, nvec, lane);
      rows(raw, e0);
    }
    store_chunk<T, VB, VPL>(acc, dxv_out, 0, nullptr, 0, v0, nvec, lane);
  }
  // ds per head into ws, then dk: lanes over A, the slots in order
  if (lane < cnt)
    for (int hh = 0; hh < h; ++hh)
      ws[lane * h + hh] *= da / fh - __ldg(rho + (size_t)r * h + hh);
  __syncwarp();
  lane_sums(ws, q, r, cnt, a, h, dk_out, lane);
}

// B3's items, a warp each: the columns of at most BATCH slots (item c <
// n; a longer column's item returns), then the segments of BATCH slots of
// the longer ones (item n + j) into the partials pk and pv
template <typename T, int VB, bool KV>
__global__ void __launch_bounds__(WPB * 32, B3_MIN_BLOCKS)
bwd_cols_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
                const T* __restrict__ q, const T* __restrict__ g,
                const T* __restrict__ x, const float* __restrict__ kt,
                const float* __restrict__ shift,
                const float* __restrict__ denom,
                const float* __restrict__ rho, const int* __restrict__ plan,
                float* __restrict__ pk, float* __restrict__ pv,
                float* __restrict__ dk, float* __restrict__ dxv, int n,
                int d, int a, int h, int nlong, int nseg) {
  extern __shared__ float smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + w;
  float* ws = smem + (size_t)w * BATCH * h;
  if (item < n) {
    const int beg = ptr[item], len = ptr[item + 1] - beg;
    if (len > BATCH) return;   // the segments'
    bwd_cols_batch<T, VB, KV>(idx, q, g, x, kt, shift, denom, rho, item, beg,
                              len, dk + (size_t)item * a,
                              dxv + (size_t)item * d, d, a, h, ws, lane);
  } else if (item < n + nseg) {
    const int j = item - n;
    int c, sb, se, i;
    segment(ptr, plan, nlong, BATCH, j, c, sb, se, i);
    bwd_cols_batch<T, VB, KV>(idx, q, g, x, kt, shift, denom, rho, c, sb,
                              se - sb, pk + (size_t)j * a, pv + (size_t)j * d,
                              d, a, h, ws, lane);
  }
}

constexpr int NM_LANES = 8;    // lanes a work item (four a warp)
constexpr int NM_CUT = 32;     // rows of more slots go to segments; the
                               // host's fused_attention.NORM_CUT
constexpr int NM_SEG = 32;     // their segments' slots; NORM_SEG
constexpr int NM_MIN_BLOCKS = 4;   // blocks an SM the registers allow
constexpr int NM_BEL_MIN_BLOCKS = 4;   // the beltrami_exp instance's

// one norm item: the slots [sb, se) of row r walked by a group of G lanes
// (lane l holding slot sb + l of each batch), e into eo, and per head the
// sum of the item's e into dst [h] (when dst is given). KV: scaled_dot's
// scores by 16-byte loads (the host's kvec); else any score type of
// score(). BEL: beltrami_exp's instance (bel_score on the slot's lane,
// each half by 16-byte loads where KV)
template <typename T, bool SQP, bool KV, int G, bool BEL>
__device__ __forceinline__ void norm_range(
    const int* __restrict__ idx, const T* __restrict__ q,
    const float* __restrict__ kt, const float* __restrict__ ew, float g,
    float* __restrict__ eo, int r, int sb, int se, float* __restrict__ dst,
    int a, int h, int att_type, gx_att::Scal scal, int l) {
  const int dk = a / h;
  const T* qr = q + (size_t)r * a;
  // the first batch's column and weight, read once for every head
  int c1 = 0;
  float w1 = 1.f;
  if (sb + l < se) {
    c1 = idx[sb + l];
    if (ew != nullptr) w1 = ew[sb + l];
  }
  for (int hh = 0; hh < h; ++hh) {
    float part = 0.f;
    for (int b0 = sb; b0 < se; b0 += G) {
      const int e = b0 + l;
      float v = 0.f;
      if (e < se) {
        int c = c1;
        float cw = w1;
        if (b0 != sb) {
          c = idx[e];
          if (ew != nullptr) cw = ew[e];
        }
        const float* kh = kt + (size_t)c * a + hh * dk;
        float s;
        if constexpr (BEL)
          s = gx_att::bel_score<T>(qr + hh * dk, kh, dk, KV ? 1 : 0, scal);
        else
          s = KV ? gx_att::score_head<T, true>(qr + hh * dk, kh, dk, 0, scal,
                                               1)
                 : gx_att::score_head<T, true>(qr + hh * dk, kh, dk,
                                               att_type, scal, 0);
        if (ew != nullptr) s *= cw;
        v = weight<SQP>(s - g);
        eo[(size_t)e * h + hh] = v;
      }
      part += v;
    }
    part = gx_att::group_sum<G>(part);
    if (dst != nullptr && l == 0) dst[hh] = part;
  }
}

// K1 + K2 with one shift g for every row: the rows of at most NM_CUT slots
// (item r < n; a longer row's item walks nothing), then the segments of
// NM_SEG slots of the longer ones (item n + j) into part [nseg, h]. BEL:
// beltrami_exp's instance (NM_BEL_MIN_BLOCKS blocks an SM); att_type 4
// takes it and no other instance scores beltrami_exp
template <typename T, bool SQP, bool KV, bool BEL>
__global__ void __launch_bounds__(WPB * 32,
                                  BEL ? NM_BEL_MIN_BLOCKS : NM_MIN_BLOCKS)
norm_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
            const T* __restrict__ q, const float* __restrict__ kt,
            const float* __restrict__ ew, const float* __restrict__ gshift,
            const int* __restrict__ plan, float* __restrict__ part,
            float* __restrict__ eo, float* __restrict__ den, int n, int a,
            int h, int att_type, gx_att::Scal scal, int nlong,
            int nseg) {
  constexpr int G = NM_LANES;
  const int lane = threadIdx.x & 31, l = lane & (G - 1);
  const int first = (blockIdx.x * WPB + (threadIdx.x >> 5)) * (32 / G);
  if (first >= n + nseg) return;   // the whole warp
  const int item = first + lane / G;
  int r = 0, sb = 0, se = 0;
  float* dst = nullptr;
  if (item < n) {
    r = item;
    sb = ptr[r];
    se = ptr[r + 1];
    if (se - sb > NM_CUT) se = sb;   // the segments'
    else dst = den + (size_t)r * h;
  } else if (item < n + nseg) {
    int i;
    segment(ptr, plan, nlong, NM_SEG, item - n, r, sb, se, i);
    dst = part + (size_t)(item - n) * h;
  }
  norm_range<T, SQP, KV, G, BEL>(idx, q, kt, ew, __ldg(gshift), eo, r, sb,
                                 se, dst, a, h, att_type, scal, l);
}

// attspmm's weight of edge e (column col, row r): rnd(mean_h e / (den or
// 1)), den at the row or at the edge's column
template <typename T, bool PERCOL>
__device__ __forceinline__ float attspmm_weight(const float* __restrict__ eo,
                                                const float* __restrict__ den,
                                                int e, int col, int r,
                                                int h) {
  const float* dn = den + (size_t)(PERCOL ? col : r) * h;
  float wsum = 0.f;
  for (int hh = 0; hh < h; ++hh) {
    const float v = dn[hh];
    wsum += eo[(size_t)e * h + hh] / (v > 0.f ? v : 1.f);
  }
  return rnd<T>(wsum / (float)h);
}

// attspmm over the edges [sb, se) of row r: the chunk sums into out at
// element offset `row`, after the addend `add`, as f32 or bf16
template <typename T, int VB, bool PERCOL>
__device__ __forceinline__ void attspmm_range(
    const int* __restrict__ idx, const float* __restrict__ eo,
    const float* __restrict__ den, const T* __restrict__ x, int r, int sb,
    int se, void* out, int otype, const float* __restrict__ add, size_t row,
    int d, int h, int lane) {
  using V = Vec<T, VB>;
  const int nvec = d / V::E;
  for (int v0 = 0; v0 < nvec; v0 += 32 * VPL) {
    float acc[VPL][V::E];
    clear(acc);
    for (int b0 = sb; b0 < se; b0 += BATCH) {
      const int cnt = min(BATCH, se - b0);
      int col = 0;
      float wl = 0.f;
      if (lane < cnt) {
        col = idx[b0 + lane];
        wl = attspmm_weight<T, PERCOL>(eo, den, b0 + lane, col, r, h);
      }
      gather<T, VB, VPL, U<VB>>(acc, x, col, wl, cnt, d, v0, nvec, lane);
    }
    store_chunk<T, VB, VPL>(acc, out, otype, add, row, v0, nvec, lane);
  }
}

// the rows of at most `split` edges, walked
// as flash_kernel walks its rows: the next row's bounds load while this
// row's first weights do, and its first columns while this row's x rows do
template <typename T, int VB, bool PERCOL>
__global__ void __launch_bounds__(WPB * 32, MIN_BLOCKS)
attspmm_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
               const float* __restrict__ eo, const float* __restrict__ den,
               const T* __restrict__ x, const float* __restrict__ add,
               void* __restrict__ out, int otype, int n, int d, int h,
               int split) {
  using V = Vec<T, VB>;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WPB;
  const int nvec = d / V::E;
  int r = blockIdx.x * WPB + (threadIdx.x >> 5);
  int beg = 0, len = 0, col = 0;
  if (r < n) {
    beg = ptr[r];
    len = ptr[r + 1] - beg;
    col = lane < min(len, BATCH) ? idx[beg + lane] : 0;
  }
  for (; r < n; r += stride) {
    const int rn = r + stride;
    int nbeg = 0, nlen = 0;
    if (rn < n) {
      nbeg = ptr[rn];
      nlen = ptr[rn + 1] - nbeg;
    }
    const bool mine = len <= split;
    int ncol = 0;
    for (int v0 = 0; v0 < nvec; v0 += 32 * VPL) {
      float acc[VPL][V::E];
      clear(acc);
      for (int b0 = beg; mine && b0 < beg + len; b0 += BATCH) {
        const int cnt = min(BATCH, beg + len - b0);
        const int c = b0 == beg ? col : lane < cnt ? idx[b0 + lane] : 0;
        const float wl =
            lane < cnt ? attspmm_weight<T, PERCOL>(eo, den, b0 + lane, c, r, h)
                       : 0.f;
        if (b0 == beg && v0 == 0)
          ncol = lane < min(nlen, BATCH) ? idx[nbeg + lane] : 0;
        gather<T, VB, VPL, U<VB>>(acc, x, c, wl, cnt, d, v0, nvec, lane);
      }
      if (mine)
        store_chunk<T, VB, VPL>(acc, out, otype, add, (size_t)r * d, v0, nvec,
                           lane);
    }
    if (len == 0 || !mine)  // no batch loaded the next row's columns
      ncol = lane < min(nlen, BATCH) ? idx[nbeg + lane] : 0;
    beg = nbeg;
    len = nlen;
    col = ncol;
  }
}

// a long row's segment j: its f32 partial sums into part [nseg, d]
template <typename T, int VB, bool PERCOL>
__global__ void __launch_bounds__(WPB * 32)
attspmm_seg_sum(const int* __restrict__ ptr, const int* __restrict__ idx,
                const float* __restrict__ eo, const float* __restrict__ den,
                const T* __restrict__ x, const int* __restrict__ plan,
                float* __restrict__ part, int nlong, int nseg, int d, int h,
                int split) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WPB + (threadIdx.x >> 5);
  if (j >= nseg) return;
  int r, sb, se, i;
  segment(ptr, plan, nlong, split, j, r, sb, se, i);
  attspmm_range<T, VB, PERCOL>(idx, eo, den, x, r, sb, se, part, 0, nullptr,
                               (size_t)j * d, d, h, lane);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

template <typename T, int TN>
cudaError_t run_kproj(const void* x, const void* wk, const void* bk, void* kt,
                      int n, int d, int a, int vx, int vw, cudaStream_t s) {
  const int smem = KC_STAGES * kc_stage<T, 8 * TN>() * (int)sizeof(T);
  static int resident = 0;  // CTAs resident on the card, once
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kproj_kernel<T, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kproj_kernel<T, TN>, KC_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sm_count() * per_sm;
  }
  const int gy = (a + 8 * TN - 1) / (8 * TN);
  const int tiles = (n + KC_BM - 1) / KC_BM;
  int gx = resident / gy;
  if (gx < 1) gx = 1;
  if (gx > tiles) gx = tiles;
  kproj_kernel<T, TN><<<dim3(gx, gy), KC_THREADS, smem, s>>>(
      (const T*)x, (const T*)wk, (const float*)bk, (float*)kt, n, d, a, vx,
      vw);
  return cudaGetLastError();
}

// 4 output columns a thread up to 32 keys, 8 beyond (64 a CTA)
template <typename T>
cudaError_t run_kproj(const void* x, const void* wk, const void* bk, void* kt,
                      int n, int d, int a, int vx, int vw, cudaStream_t s) {
  if (a <= 32) return run_kproj<T, 4>(x, wk, bk, kt, n, d, a, vx, vw, s);
  return run_kproj<T, 8>(x, wk, bk, kt, n, d, a, vx, vw, s);
}

// the shared-memory bytes of kproj_tc_kernel: WkT and the ring
size_t kproj_tc_smem(int d, int a, int* P, int* PK) {
  const int nc = a < KP_NC ? a : KP_NC;
  *P = d + (d & 1);
  *PK = ((d + 15) & ~15) + 8;
  return sizeof(__nv_bfloat16) *
         ((size_t)((nc + 15) & ~15) * *PK + (size_t)KP_STAGES * KP_ROWS * *P +
          16);
}

cudaError_t run_kproj_tc(const void* x, const void* wk, const void* bk,
                         void* kt, int n, int d, int a, int vec,
                         cudaStream_t s) {
  int P, PK;
  const size_t smem = kproj_tc_smem(d, a, &P, &PK);
  static size_t smem_set = 0, grid_smem = 0;
  static int resident = 0;
  if (smem > smem_set) {  // the opt-in, once per size
    cudaError_t err = cudaFuncSetAttribute(
        kproj_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (smem != grid_smem) {  // CTAs resident on the card at this size
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kproj_tc_kernel, KP_WARPS * 32, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sm_count() * per_sm;
    grid_smem = smem;
  }
  const int tiles = (n + KP_ROWS - 1) / KP_ROWS;
  const int grid = resident < tiles ? resident : tiles;
  const dim3 blocks(grid, (a + KP_NC - 1) / KP_NC);
  kproj_tc_kernel<<<blocks, KP_WARPS * 32, smem, s>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wk, (const float*)bk,
      (float*)kt, n, d, a, P, PK, vec);
  return cudaGetLastError();
}

// a launch with `smem` bytes of dynamic shared memory, opted into above 48 KB
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// T and VB (bytes per gathered load) of a walk launch: float with 4 or 8,
// bfloat16 with 2, 4 or 8; f(T*, integral_constant<VB>)
template <typename F>
cudaError_t by_width(int dtype, int vb, F&& f) {
  using I2 = std::integral_constant<int, 2>;
  using I4 = std::integral_constant<int, 4>;
  using I8 = std::integral_constant<int, 8>;
  if (dtype == 0) {
    if (vb == 4) return f((float*)nullptr, I4{});
    if (vb == 8) return f((float*)nullptr, I8{});
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    if (vb == 2) return f((B*)nullptr, I2{});
    if (vb == 4) return f((B*)nullptr, I4{});
    if (vb == 8) return f((B*)nullptr, I8{});
  }
  return cudaErrorInvalidValue;
}

// blocks of `threads` threads with `smem` bytes the card holds at once
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  return per_sm * sm_count();
}

// the rows of more than BATCH edges of a flash or (RES) training-forward
// launch, in segments of `seg` edges: flash_seg_stats, flash_seg_sum and
// seg_combine; BEL the beltrami_exp instances
template <typename T, int VB, bool SQP, bool RES, bool BEL>
cudaError_t run_flash_segs(const void* ptr, const void* idx, const void* q,
                           const void* x, const void* kt, const void* ew,
                           const void* gshift, const void* plan, void* st,
                           void* part, void* sc, void* shift, void* denom,
                           void* out, int otype, int d, int a, int h,
                           int att_type, gx_att::Scal scal, int kvec,
                           int wpb, int seg, int nlong, int nseg,
                           cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)wpb * warp_stride(a, h, BEL);
  const int grid = (nseg + wpb - 1) / wpb;
  cudaError_t err = allow_smem(flash_seg_stats<T, SQP, RES, BEL>, smem);
  if (err != cudaSuccess) return err;
  flash_seg_stats<T, SQP, RES, BEL><<<grid, wpb * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const float*)kt,
      (const float*)ew, (const float*)gshift, (const int*)plan, (float*)st,
      (float*)sc, nlong, nseg, a, h, att_type, scal, kvec, seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(flash_seg_sum<T, VB, SQP, RES, BEL>, smem)) !=
      cudaSuccess)
    return err;
  flash_seg_sum<T, VB, SQP, RES, BEL><<<grid, wpb * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)x,
      (const float*)kt, (const float*)ew, (const float*)gshift,
      (const int*)plan, (const float*)st, (const float*)sc, (float*)shift,
      (float*)denom, (float*)part, nlong, nseg, d, a, h, att_type, scal, kvec,
      seg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seg_combine<<<(nlong + WPB - 1) / WPB, WPB * 32, 0, s>>>(
      (const int*)plan, (const float*)part, nullptr, out, otype, nlong, d);
  return cudaGetLastError();
}

template <typename T, int VB, bool KV>
cudaError_t run_fwd_res(const void* ptr, const void* idx, const void* q,
                        const void* x, const void* kt, const void* plan,
                        void* st, void* part, void* sc, void* shift,
                        void* denom, void* out, int n, int d, int a, int h,
                        int wpb, int seg, int nlong, int nseg,
                        cudaStream_t s) {
  const int otype = std::is_same<T, float>::value ? 0 : 1;
  const size_t fsmem = sizeof(float) * (size_t)wpb * (BATCH * h + a);
  cudaError_t err = allow_smem(fwd_res_kernel<T, VB, KV>, fsmem);
  if (err != cudaSuccess) return err;
  fwd_res_kernel<T, VB, KV><<<(n + wpb - 1) / wpb, wpb * 32, fsmem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)x,
      (const float*)kt, (float*)sc, (float*)shift, (float*)denom, out, otype,
      n, d, a, h);
  err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  return run_flash_segs<T, VB, false, true, false>(
      ptr, idx, q, x, kt, nullptr, nullptr, plan, st, part, sc, shift, denom,
      out, otype, d, a, h, 0, gx_att::Scal{}, KV ? 1 : 0, wpb, seg, nlong,
      nseg, s);
}

template <typename T, int VB>
cudaError_t run_bwd_rows(const void* ptr, const void* idx, const void* sc,
                         const void* shift, const void* denom, const void* g,
                         const void* x, const void* kt, const void* plan,
                         void* dab, void* pr, void* pq, void* dq, void* rho,
                         int n, int d, int a, int h, int wpb, int nlong,
                         int nseg, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)wpb * BATCH * h;
  cudaError_t err = allow_smem(bwd_rows_kernel<T, VB>, smem);
  if (err != cudaSuccess) return err;
  const int items = n + nseg;
  bwd_rows_kernel<T, VB><<<(items + wpb - 1) / wpb, wpb * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const float*)sc,
      (const float*)shift, (const float*)denom, (const T*)g, (const T*)x,
      (const float*)kt, (const int*)plan, (float*)dab, (float*)pr,
      (float*)dq, (float*)rho, n, d, a, h, nlong, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  if ((err = allow_smem(bwd_rows_seg_dq, smem)) != cudaSuccess) return err;
  bwd_rows_seg_dq<<<(nseg + wpb - 1) / wpb, wpb * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const float*)sc,
      (const float*)shift, (const float*)denom, (const float*)kt,
      (const int*)plan, (const float*)dab, (const float*)pr, (float*)pq,
      (float*)rho, nlong, nseg, a, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seg_combine<<<(nlong + WPB - 1) / WPB, WPB * 32, 0, s>>>(
      (const int*)plan, (const float*)pq, nullptr, dq, 0, nlong, a);
  return cudaGetLastError();
}

template <typename T, int VB, bool KV>
cudaError_t run_bwd_cols(const void* ptr, const void* idx, const void* q,
                         const void* g, const void* x, const void* kt,
                         const void* shift, const void* denom, const void* rho,
                         const void* plan, void* pk, void* pv, void* dk,
                         void* dxv, int n, int d, int a, int h, int wpb,
                         int nlong, int nseg, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)wpb * BATCH * h;
  cudaError_t err = allow_smem(bwd_cols_kernel<T, VB, KV>, smem);
  if (err != cudaSuccess) return err;
  const int items = n + nseg;
  bwd_cols_kernel<T, VB, KV><<<(items + wpb - 1) / wpb, wpb * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)g,
      (const T*)x, (const float*)kt, (const float*)shift,
      (const float*)denom, (const float*)rho, (const int*)plan, (float*)pk,
      (float*)pv, (float*)dk, (float*)dxv, n, d, a, h, nlong, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  const int grid = (nlong + WPB - 1) / WPB;
  seg_combine<<<grid, WPB * 32, 0, s>>>((const int*)plan, (const float*)pk,
                                        nullptr, dk, 0, nlong, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seg_combine<<<grid, WPB * 32, 0, s>>>((const int*)plan, (const float*)pv,
                                        nullptr, dxv, 0, nlong, d);
  return cudaGetLastError();
}

template <typename T, bool SQP, bool KV, bool BEL>
cudaError_t run_norm(const void* ptr, const void* idx, const void* q,
                     const void* kt, const void* ew, const void* gshift,
                     const void* plan, void* part, void* eo, void* den, int n,
                     int a, int h, int att_type, gx_att::Scal scal,
                     int nlong, int nseg, cudaStream_t s) {
  const int items = n + nseg, per_block = WPB * (32 / NM_LANES);
  norm_kernel<T, SQP, KV, BEL><<<(items + per_block - 1) / per_block,
                                 WPB * 32, 0, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const float*)kt,
      (const float*)ew, (const float*)gshift, (const int*)plan, (float*)part,
      (float*)eo, (float*)den, n, a, h, att_type, scal, nlong, nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  seg_combine<<<(nlong + WPB - 1) / WPB, WPB * 32, 0, s>>>(
      (const int*)plan, (const float*)part, nullptr, den, 0, nlong, h);
  return cudaGetLastError();
}

template <typename T, bool BEL>
cudaError_t run_gmax(const void* seg, const void* idx, const void* q,
                     const void* kt, const void* ew, void* state, void* out,
                     long long e, int a, int h, int att_type,
                     gx_att::Scal scal, int qvec, cudaStream_t s) {
  const long long pairs = e * h;
  static const int resident =
      resident_blocks(gmax_kernel<T, BEL>, GM_THREADS, 0);
  const long long items = BEL ? 2 * pairs : pairs;
  long long grid = (items + GM_THREADS - 1) / GM_THREADS;
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;   // the last block writes the result
  gmax_kernel<T, BEL><<<(int)grid, GM_THREADS, 0, s>>>(
      (const long long*)seg, (const int*)idx, (const T*)q, (const float*)kt,
      (const float*)ew, (unsigned*)state, (float*)out, pairs, a, h, att_type,
      scal, qvec);
  return cudaGetLastError();
}

template <typename T, int VB, bool SQP, bool BEL>
cudaError_t run_flash(const void* ptr, const void* idx, const void* q,
                      const void* x, const void* kt, const void* ew,
                      const void* gshift, const void* plan, void* st,
                      void* part, void* out, int otype, int n, int d, int a,
                      int h, int att_type, gx_att::Scal scal, int kvec,
                      int wpb, int seg, int nlong, int nseg,
                      cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)wpb * warp_stride(a, h, BEL);
  cudaError_t err = allow_smem(flash_kernel<T, VB, SQP, BEL>, smem);
  if (err != cudaSuccess) return err;
  flash_kernel<T, VB, SQP, BEL><<<(n + wpb - 1) / wpb, wpb * 32, smem, s>>>(
      (const int*)ptr, (const int*)idx, (const T*)q, (const T*)x,
      (const float*)kt, (const float*)ew, (const float*)gshift, out, otype, n,
      d, a, h, att_type, scal, kvec);
  err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  return run_flash_segs<T, VB, SQP, false, BEL>(
      ptr, idx, q, x, kt, ew, gshift, plan, st, part, nullptr, nullptr,
      nullptr, out, otype, d, a, h, att_type, scal, kvec, wpb, seg,
      nlong, nseg, s);
}

template <typename T, int VB, bool PERCOL>
cudaError_t run_attspmm(const void* ptr, const void* idx, const void* eo,
                        const void* den, const void* x, const void* add,
                        const void* plan, void* part, void* out, int otype,
                        int n, int d, int h, int split, int nlong, int nseg,
                        cudaStream_t s) {
  static const int resident =
      resident_blocks(attspmm_kernel<T, VB, PERCOL>, WPB * 32, 0);
  const int rows = (n + WPB - 1) / WPB;
  attspmm_kernel<T, VB, PERCOL>
      <<<rows < resident ? rows : resident, WPB * 32, 0, s>>>(
          (const int*)ptr, (const int*)idx, (const float*)eo,
          (const float*)den, (const T*)x, (const float*)add, out, otype, n, d,
          h, split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 0) return err;
  attspmm_seg_sum<T, VB, PERCOL>
      <<<(nseg + WPB - 1) / WPB, WPB * 32, 0, s>>>(
          (const int*)ptr, (const int*)idx, (const float*)eo,
          (const float*)den, (const T*)x, (const int*)plan, (float*)part,
          nlong, nseg, d, h, split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seg_combine<<<(nlong + WPB - 1) / WPB, WPB * 32, 0, s>>>(
      (const int*)plan, (const float*)part, (const float*)add, out, otype,
      nlong, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, d] and wk [d, a] share dtype (0 float32, 1 bfloat16); bk [a] float32;
// kt [n, a] float32 out, on CUDA-core FMAs. vx, vw: the bytes of x's and
// wk's staged copies (16, 8 or 4: a row's bytes and the operand's start
// divide by it), or 0 for one value per copy.
int gx_attention_kproj(const void* x, const void* wk, const void* bk, void* kt,
                       int n, int d, int a, int dtype, int vx, int vw,
                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)run_kproj<float>(x, wk, bk, kt, n, d, a, vx, vw, s);
  if (dtype == 1)
    return (int)run_kproj<__nv_bfloat16>(x, wk, bk, kt, n, d, a, vx, vw, s);
  return (int)cudaErrorInvalidValue;
}

// kt [n, a] float32 = x [n, d] wk [d, a] + bk [a] on the tensor cores; x
// and wk bfloat16, bk float32; vec != 0 lets 16-byte-aligned tiles of even
// d be staged by 16-byte copies.
int gx_attention_kproj_tc(const void* x, const void* wk, const void* bk,
                          void* kt, int n, int d, int a, int vec,
                          void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return (int)run_kproj_tc(x, wk, bk, kt, n, d, a, vec,
                           (cudaStream_t)stream);
}

// seg [e] int64 and idx [e] int32: each slot's row and column; q [n, a] in
// the state dtype (pre-scaled for scaled_dot); kt [n, a] float32 from
// gx_attention_kproj; ew [e] float32 reweight values or null; state [2]
// uint32, zeros, left as zeros by the launch; out [1] float32: the max score
// over every slot and head, 0 when there is none; qvec: 16-byte loads of
// q's and K's head slices (scaled_dot), or of each half of them
// (beltrami_exp, att_type 4, which takes gmax_kernel's BEL instance).
int gx_attention_gmax(const void* seg, const void* idx, const void* q,
                      const void* kt, const void* ew, void* state, void* out,
                      long long e, int a, int h, int att_type, int reweight,
                      float ov2, float inv2l2, float ov2p, float inv2l2p,
                      int dtype, int qvec, void* stream) {
  if (e < 0) return (int)cudaErrorInvalidValue;
  const gx_att::Scal scal{ov2, inv2l2, ov2p, inv2l2p};
  const void* ewp = reweight ? ew : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  const bool bel = att_type == 4;
  if (dtype == 0)
    return (int)(bel ? &run_gmax<float, true>
                     : &run_gmax<float, false>)(seg, idx, q, kt, ewp, state,
                                                out, e, a, h, att_type, scal,
                                                qvec, s);
  if (dtype == 1)
    return (int)(bel ? &run_gmax<__nv_bfloat16, true>
                     : &run_gmax<__nv_bfloat16, false>)(
        seg, idx, q, kt, ewp, state, out, e, a, h, att_type, scal, qvec, s);
  return (int)cudaErrorInvalidValue;
}

// q [n, a] and x [n, d] in one dtype; kt [n, a] float32; ew as above;
// gshift [1] float32 (squareplus only, from gx_attention_gmax); out [n, d]
// float32 (out_dtype 0) or bfloat16 (1). vec_bytes: the bytes of one x load
// (float: 4 or 8; bfloat16: 2, 4 or 8, dividing a row's bytes and x's
// offset); kvec: scaled_dot's K rows by 16-byte loads (dk % 4 == 0, kt on
// 16 bytes), or beltrami_exp's halves (dk / 2 % 4 == 0, kt on 16 bytes;
// att_type 4 takes the flash kernels' BEL instances); ov2p, inv2l2p:
// beltrami_exp's; wpb
// warps per block. Rows of more than 32 edges go through the segment
// kernels, in segments of `seg` edges: plan [2 nlong + 1 + nseg] int32
// (long rows, their segment offsets, each segment's long row), st [nseg,
// 2h] and part [nseg, d] float32 scratch.
int gx_flash_attention(const void* ptr, const void* idx, const void* q,
                       const void* x, const void* kt, const void* ew,
                       const void* gshift, const void* plan, void* st,
                       void* part, void* out, int n, int d, int a, int h,
                       int att_type, int reweight, int square_plus,
                       float ov2, float inv2l2, float ov2p, float inv2l2p,
                       int dtype, int out_dtype, int vec_bytes, int kvec,
                       int wpb, int seg, int nlong, int nseg, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const gx_att::Scal scal{ov2, inv2l2, ov2p, inv2l2p};
  if (wpb < 1 || wpb > WPB) return (int)cudaErrorInvalidValue;
  const void* ewp = reweight ? ew : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(dtype, vec_bytes, [&](auto t, auto vb) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int VB = decltype(vb)::value;
    auto run = square_plus ? (att_type == 4 ? &run_flash<T, VB, true, true>
                                            : &run_flash<T, VB, true, false>)
                           : (att_type == 4 ? &run_flash<T, VB, false, true>
                                            : &run_flash<T, VB, false, false>);
    return run(ptr, idx, q, x, kt, ewp, gshift, plan, st, part, out,
               out_dtype, n, d, a, h, att_type, scal, kvec, wpb, seg, nlong,
               nseg, s);
  });
}

// The training forward. q [n, a] (pre-scaled) and x [n, d] in one dtype; kt
// [n, a] float32; sc [E, h] float32 out (the scores, a residual); shift and
// denom [n, h] float32 out; out [n, d] in x's dtype. vec_bytes as
// gx_flash_attention's; kvec as gx_attention_bwd_cols's; wpb warps per
// block, each with (BATCH h + a) floats of shared memory. Rows of more than
// 32 edges go in segments of `seg` edges: plan as gx_flash_attention's, st
// [nseg, 2h] and part [nseg, d] float32 scratch.
int gx_attention_fwd_res(const void* ptr, const void* idx, const void* q,
                         const void* x, const void* kt, const void* plan,
                         void* st, void* part, void* sc, void* shift,
                         void* denom, void* out, int n, int d, int a, int h,
                         int dtype, int vec_bytes, int kvec, int wpb, int seg,
                         int nlong, int nseg, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (wpb < 1 || wpb > WPB) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(dtype, vec_bytes, [&](auto t, auto vb) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int VB = decltype(vb)::value;
    return kvec ? run_fwd_res<T, VB, true>(ptr, idx, q, x, kt, plan, st, part,
                                           sc, shift, denom, out, n, d, a, h,
                                           wpb, seg, nlong, nseg, s)
                : run_fwd_res<T, VB, false>(ptr, idx, q, x, kt, plan, st,
                                            part, sc, shift, denom, out, n, d,
                                            a, h, wpb, seg, nlong, nseg, s);
  });
}

// The row-side backward over the CSR layout. sc, shift, denom from
// gx_attention_fwd_res; g and x [n, d] in one dtype; kt [n, a] float32; dq
// [n, a] and rho [n, h] float32 out (dq not yet scaled by 1/sqrt(dk)).
// vec_bytes: the bytes of one g and x load (as gx_flash_attention's, for
// both); wpb warps per block, each with BATCH * h floats of shared memory.
// Rows of more than BATCH edges go in segments of BATCH: plan as
// gx_attention_bwd_cols's, dab [nseg, BATCH], pr [nseg, h] and pq [nseg,
// a] float32 scratch.
int gx_attention_bwd_rows(const void* ptr, const void* idx, const void* sc,
                          const void* shift, const void* denom, const void* g,
                          const void* x, const void* kt, const void* plan,
                          void* dab, void* pr, void* pq, void* dq, void* rho,
                          int n, int d, int a, int h, int dtype,
                          int vec_bytes, int wpb, int nlong, int nseg,
                          void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (wpb < 1 || wpb > WPB) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(dtype, vec_bytes, [&](auto t, auto vb) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int VB = decltype(vb)::value;
    return run_bwd_rows<T, VB>(ptr, idx, sc, shift, denom, g, x, kt, plan,
                               dab, pr, pq, dq, rho, n, d, a, h, wpb, nlong,
                               nseg, s);
  });
}

// The column-side backward over the CSC layout (ptr per column, idx the
// rows). q, g and x in one dtype; kt [n, a] float32; shift, denom and rho
// [n, h] float32 (per row); dk [n, a] and dxv [n, d] float32 out. vec_bytes:
// the bytes of one g and x load (as gx_flash_attention's, for both); kvec:
// q's and K's head slices by 16-byte loads (dk % 4 == 0 and the slices on
// 16 bytes); wpb warps per block, each with BATCH * h floats of shared
// memory. Columns of more than BATCH slots go in segments of BATCH: plan
// (the long columns, their segment offsets, each segment's column; the
// host's row_split_plan), pk [nseg, a] and pv [nseg, d] float32 scratch.
int gx_attention_bwd_cols(const void* ptr, const void* idx, const void* q,
                          const void* g, const void* x, const void* kt,
                          const void* shift, const void* denom,
                          const void* rho, const void* plan, void* pk,
                          void* pv, void* dk, void* dxv, int n, int d, int a,
                          int h, int dtype, int vec_bytes, int kvec, int wpb,
                          int nlong, int nseg, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (wpb < 1 || wpb > WPB) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(dtype, vec_bytes, [&](auto t, auto vb) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int VB = decltype(vb)::value;
    return kvec ? run_bwd_cols<T, VB, true>(ptr, idx, q, g, x, kt, shift,
                                            denom, rho, plan, pk, pv, dk, dxv,
                                            n, d, a, h, wpb, nlong, nseg, s)
                : run_bwd_cols<T, VB, false>(ptr, idx, q, g, x, kt, shift,
                                             denom, rho, plan, pk, pv, dk,
                                             dxv, n, d, a, h, wpb, nlong,
                                             nseg, s);
  });
}

// K1 + K2 with one shift for every row. q [n, a] in the state dtype
// (pre-scaled for scaled_dot); kt [n, a] float32; ew [E] float32 or null;
// gshift [1] float32 (the shift, from gx_attention_gmax); eo [E, h] float32
// out (e unrounded); den [n, h] float32 out (the row sums of e); ov2p,
// inv2l2p: beltrami_exp's positional pair. kvec: scaled_dot's head slices
// by 16-byte loads, as gx_attention_bwd_cols's, or beltrami_exp's halves
// (att_type 4, which takes norm_kernel's BEL instance; the host's
// score_vec rule); read for those two types only. Rows of more than
// NM_CUT slots go in segments of NM_SEG: plan as gx_attention_bwd_cols's,
// part [nseg, h] float32 scratch.
int gx_attention_norm(const void* ptr, const void* idx, const void* q,
                      const void* kt, const void* ew, const void* gshift,
                      const void* plan, void* part, void* eo, void* den,
                      int n, int a, int h, int att_type, int reweight,
                      int square_plus, float ov2, float inv2l2, float ov2p,
                      float inv2l2p, int dtype, int kvec, int nlong, int nseg,
                      void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const gx_att::Scal scal{ov2, inv2l2, ov2p, inv2l2p};
  const void* ewp = reweight ? ew : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
#define GX_NORM(T, SQP, KV, BEL)                                            \
  run_norm<T, SQP, KV, BEL>(ptr, idx, q, kt, ewp, gshift, plan, part, eo,   \
                            den, n, a, h, att_type, scal, nlong, nseg, s)
#define GX_NORM_KV(T, SQP)                                                   \
  (att_type == 4 ? (kvec ? GX_NORM(T, SQP, true, true)                       \
                         : GX_NORM(T, SQP, false, true))                     \
   : kvec && att_type == 0 ? GX_NORM(T, SQP, true, false)                    \
                           : GX_NORM(T, SQP, false, false))
  if (dtype == 0)
    return (int)(square_plus ? GX_NORM_KV(float, true)
                             : GX_NORM_KV(float, false));
  if (dtype == 1)
    return (int)(square_plus ? GX_NORM_KV(__nv_bfloat16, true)
                             : GX_NORM_KV(__nv_bfloat16, false));
#undef GX_NORM_KV
#undef GX_NORM
  return (int)cudaErrorInvalidValue;
}

// K3 against outside denominators. eo [E, h] float32 (from gx_attention_norm);
// den [n, h] float32, read at the row (per_column 0) or at the edge's column
// (per_column 1); x [n, d] in the state dtype; add [n, d] float32 or null;
// out [n, d] = (add + sum) as float32 (out_dtype 0) or bfloat16 (1).
// vec_bytes as gx_flash_attention's; rows of more than `split` edges go
// through the segment kernels, in segments of `split` edges (plan and part
// as gx_flash_attention's).
int gx_attention_attspmm(const void* ptr, const void* idx, const void* eo,
                         const void* den, const void* x, const void* add,
                         const void* plan, void* part, void* out, int n,
                         int d, int h, int per_column, int dtype,
                         int out_dtype, int vec_bytes, int split, int nlong,
                         int nseg, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)by_width(dtype, vec_bytes, [&](auto t, auto vb) {
    using T = std::remove_pointer_t<decltype(t)>;
    constexpr int VB = decltype(vb)::value;
    return per_column
        ? run_attspmm<T, VB, true>(ptr, idx, eo, den, x, add, plan, part, out,
                                   out_dtype, n, d, h, split, nlong, nseg, s)
        : run_attspmm<T, VB, false>(ptr, idx, eo, den, x, add, plan, part,
                                    out, out_dtype, n, d, h, split, nlong,
                                    nseg, s);
  });
}

}  // extern "C"
