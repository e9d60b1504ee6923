// The windowed (block-dense) SpMM: densify once per forward, then a batched
// product of the dense per-tile blocks with the window slabs per solver
// evaluation, and its two backward products.
//
// Replaces graphax/kernels/pallas_windows.py:
//   `_densify_kernel` (:57)       -> densify_kernel
//   `_win_matmul_kernel` (:185)   -> win_matmul_tc_kernel (bf16),
//                                    win_matmul_f32_kernel (f32)
//   `_win_bwd_dense_kernel` (:214)-> win_bwd_dense_tc_kernel (bf16),
//                                    win_bwd_dense_f32_kernel (f32)
//   `_win_bwd_slab_kernel` (:243) -> win_bwd_slab_tc_kernel (bf16),
//                                    win_bwd_slab_f32_kernel (f32)
//
// Layout (graphax_torch/kernels/windows.py): node rows fall into T tiles of
// `tile` rows; tile t reads window w = tile_win[t], the `W` consecutive
// nodes w*W .. w*W+W-1 (the "slab"; slab rows past N read as zero). The
// in-window edges of tile t form the dense block dense[t] in [tile, W].
//
// What bounds them on an H100 depends on the dtype. At the ogbn-arxiv
// shapes (T = 1323, tile 128, W 512, D 162) each product is 2*T*tile*W*D =
// 28 GFLOP. In bf16 that is 0.03 ms at the tensor-core peak against 0.1 ms
// to read the 173 MB of blocks once: bytes. In f32 it is 0.419 ms at the
// 67 TFLOP/s of CUDA-core FMAs against 0.17-0.20 ms of bytes: operations.
// The three products are one tiled GEMM each, with A and B staged through
// shared memory; bf16 inputs go through the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulators: bf16 products are exact in f32, as
// on the MXU; the *_tc_kernels below), f32 inputs through CUDA-core FMAs
// (the TPU's f32 MXU passes keep f32 precision; TF32 would not), the f32
// core below.
//
// Design, against the TPU kernels:
// - No sequential grid: the TPU densify accumulates one-hot products into a
//   revisited output block, and win_bwd_slab accumulates a window's tiles
//   into a resident block in window-sorted order. Here densify zero-fills
//   and then stores one value per in-window edge (cells are disjoint: the
//   edges are coalesced), and win_bwd_slab gives each (window, W-chunk,
//   D-chunk) to one CTA that walks that window's tiles from a host-built
//   window -> tiles CSR, so no output is revisited and nothing is atomic.
// - Runtime shapes: tile, W and D are arguments. Every staged run is
//   guarded (rows past tile or N, columns past W or D read as zero) and
//   every store is guarded, so D = 162 (not a multiple of 16) and small test
//   shapes need no padding in device memory.
//
// The f32 bodies (win_matmul_f32_kernel, win_bwd_dense_f32_kernel,
// win_bwd_slab_f32_kernel) share one GEMM core (f_gemm below), bound by
// operations (0.419 ms each at the arxiv shapes). What it does about that:
// - Register tiles of 8 x 12 outputs a thread in win_matmul and
//   win_bwd_slab (a CTA covers 192 columns of D, so each block is read
//   from device memory once) and 8 x 8 in win_bwd_dense; each k's A and B
//   values come by 16-byte shared loads. An SM does 128 f32 FMAs a clock
//   but moves 128 bytes a clock from shared memory into registers: 8 x 8
//   needs just that rate (64 bytes for 64 FMAs), 8 x 12 80 for 96.
// - Two CTAs an SM (128 registers a thread): one CTA's barriers, copies
//   and stores overlap the other's FMAs. One CTA an SM with 8 x 16 tiles
//   measured slower (PERF.md).
// - k-major staging: both operands land as [k][rows] in shared memory, the
//   transposes absorbed by the copies. Operands whose rows run along k (the
//   blocks in win_matmul, g and x in win_bwd_dense) go by 4-byte cp.async
//   of one value, a warp 8 k x 4 rows; the others (the slab rows in
//   win_matmul, the blocks and g in win_bwd_slab) by 16-, 8- or 4-byte
//   cp.async along their rows (the wrapper's copy width). A row pitch of 4
//   words mod 32 keeps the transposing stores and every 16-byte load free
//   of bank conflicts. Each thread copies from one base address, so a full
//   step's copies need no address arithmetic and no guards.
// - A ring of 2 cp.async steps (32 k in win_matmul and win_bwd_slab, 16 in
//   win_bwd_dense), one barrier a step; a K loop bounded by the real depth
//   (no FMAs on k past D, W or a tile).
// - win_bwd_dense writes its [T, 128, W] output by 16-byte streaming
//   stores straight from registers.
// - Summation order: each output is one running f32 sum from +0, one fmaf
//   a k in K order, no split of K; win_matmul then adds its addend,
//   rounded once. A zero term (k past D, W or a tile, rows past N) never
//   changes a sum begun at +0 (such a sum is never -0), so skipping those
//   terms gives the bits of the same chain over zero-padded K.
//
// win_matmul in bf16 (win_matmul_tc_kernel below): bound by bytes, the
// [T, 128, W] blocks once (173 MB at the arxiv shapes) and x, the addend
// and the output (55 MB each), 0.101 ms at 3.35 TB/s, against 28 GFLOP
// (0.03 ms at the bf16 tensor-core peak). Design: one CTA per 128-row tile
// covers the whole D (up to 176 columns, 22 n8 fragments; wider D takes
// more CTAs), so each block is read from device memory once. A (the block,
// 1024-byte rows) streams in K chunks of 32 columns by 16-byte cp.async, B
// (the slab rows of the same chunk) by 4-byte cp.async of its column
// pairs, straight into rows of a 16-byte multiple pitch (D = 162: 324
// bytes a row in device memory, 368 in shared memory), through a ring of 3
// stages with one barrier a step; mma.sync m16n8k16 reads A by ldmatrix
// and B by ldmatrix.trans (the contraction runs along slab rows). The
// addend's rows are copied into shared memory with the first chunk; the
// epilogue adds them to the f32 sums, rounds once to bf16 in place and
// writes the tile's rows out whole. Two CTAs per SM overlap one tile's
// epilogue with the other's stream. The 4-byte copies of B cost the most
// of the staging (PERF.md: the designs that measured slower).
//
// win_bwd_dense in bf16 (win_bwd_dense_tc_kernel below): bound by bytes,
// 110 MB of g and x in and the [T, 128, W] output out, 347 MB in f32
// (0.136 ms at 3.35 TB/s) or 173 MB in the blocks' bf16 (0.085 ms),
// against 28 GFLOP (0.03 ms at the bf16 tensor-core peak). It takes the output dtype and rounds its f32 sums once in the
// epilogue, so the autograd Function's separate cast pass over an f32
// copy is gone. Design: whole 128 x 128 output blocks per CTA, both
// operands staged at once by 16-byte cp.async of contiguous row ranges,
// mma.sync from conflict-free 32-bit shared loads, 16-byte streaming
// stores, two CTAs per SM (see the kernel's note; measurements and the
// designs that measured slower in PERF.md).
//
// win_bwd_slab in bf16 (win_bwd_slab_tc_kernel below): bound by bytes,
// the [T, 128, W] blocks once (173 MB at the arxiv shapes), g (55 MB) and
// dx in x's dtype (55 MB of bf16), 0.0845 ms at 3.35 TB/s, against 28
// GFLOP (0.03 ms at the bf16 tensor-core peak). Design:
// win_matmul_tc_kernel's with the block transposed: one CTA per (window,
// 128 slab rows) covers the whole D (176 columns; wider D takes more
// CTAs), so each block is read once; it walks the window's tiles (4 of
// them at every window of the arxiv stand-in: the longest window does not
// set the launch's length) in chunks of 32 tile rows through a 3-stage
// cp.async ring, A = the block's rows by 16-byte copies and ldmatrix.trans,
// B = g's rows as win_matmul's slab rows; it takes the output dtype and
// writes only slab rows < N, rounded once (bf16 rows leave whole from
// shared memory, as win_matmul's), so the caller gets dx itself. The
// 4-byte copies of g cost the most of what is left (PERF.md).
//
// Not yet done (later work): wgmma/TMA, and skipping all-zero 32-column
// strips of the blocks (0.66 % of the cells are filled at the arxiv
// shapes, but 97.9 % of the 32-column strips hold one: PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// dense[cell[i]] = values[edge_id[i]] (after a zero fill of dense)
template <typename TI, typename TO>
__global__ void densify_kernel(const int* __restrict__ edge_id,
                               const int* __restrict__ cell,
                               const TI* __restrict__ values,
                               TO* __restrict__ dense, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dense[cell[i]] = from_f<TO>(to_f(values[edge_id[i]]));
}

// ---------------------------------------------------------------------------
// The f32 core (see the note at the top). A CTA owns F_BM output rows and
// 64 * NR output columns, 8 warps: 4 over rows (32 each) x 2 over columns
// (32 * NR each). Lane (tm = lane / 8, tn = lane % 8) of a warp owns rows
// ra + i and ra + 16 + i (i < 4) and columns cb + 32 r + j (r < NR, j < 4),
// ra = its warp's first row + 4 tm, cb = its warp's first column + 4 tn: an
// 8 x 4 NR register tile whose k-th A values are two 16-byte runs of the
// staged row k of A, and whose B values are NR 16-byte runs of row k of B.
// The 4 distinct A runs and 8 distinct B runs a warp reads per load lie in
// one 64- or 128-byte span of one staged row: no bank conflicts.
constexpr int F_BM = 128;       // output rows a CTA
constexpr int F_THREADS = 256;  // 8 warps
constexpr int F_PA = F_BM + 4;  // A's staged row pitch: 4 words mod 32
// win_matmul and win_bwd_slab: 192 columns of D a CTA (NR = 3), steps of
// 32 k, a ring of 2, 2 CTAs an SM (the register cap: 128 a thread)
constexpr int F_NR_MM = 3;
constexpr int F_BK_MM = 32;
constexpr int F_ST_MM = 2;
constexpr int F_CTAS_MM = 2;
// win_bwd_dense: 128 slab rows a CTA (NR = 2), steps of 16 k, a ring of 2,
// 2 CTAs an SM
constexpr int F_NR_BD = 2;
constexpr int F_BK_BD = 16;
constexpr int F_ST_BD = 2;
constexpr int F_CTAS_BD = 2;

// a body's CTA: 64 * NR_ columns, steps of BK_ k, a ring of ST_ steps
template <int NR_, int BK_, int ST_> struct FShape {
  static constexpr int NR = NR_, BK = BK_, ST = ST_;
  static constexpr int BN = 64 * NR;                   // columns a CTA
  static constexpr int PB = BN + 4;                    // B's row pitch
  static constexpr int STAGE = BK * (F_PA + PB);       // floats a step
  static constexpr int SMEM = ST * STAGE * (int)sizeof(float);
};

// this thread's first row ra and first column cb in the CTA's tile
template <int NR>
__device__ __forceinline__ void f_coords(int& ra, int& cb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ra = 32 * (warp & 3) + 4 * (lane >> 3);
  cb = 32 * NR * (warp >> 2) + 4 * (lane & 7);
}

// acc[i][j] = fmaf(a_i, b_j, acc[i][j]) for one k: a = A's staged row k
// from ra, b = B's staged row k from cb
template <int NR>
__device__ __forceinline__ void f_fma(float (&acc)[8][4 * NR],
                                      const float* a, const float* b) {
  const float4 a0 = *reinterpret_cast<const float4*>(a);
  const float4 a1 = *reinterpret_cast<const float4*>(a + 16);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  float bv[4 * NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float4 v = *reinterpret_cast<const float4*>(b + 32 * r);
    bv[4 * r] = v.x;
    bv[4 * r + 1] = v.y;
    bv[4 * r + 2] = v.z;
    bv[4 * r + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// S[k][r] (pitch P) = src[r * ld + k] for r < rows and k < kn, zeros for
// the other r < R, k < BK: 4-byte cp.async of one value each (src is
// not read where !ok: `safe` stands in). A warp copies 8 k of 4 rows (32
// bytes of each row; with P = 4 mod 32 its stores hit 32 banks), rows 32
// apart and the next 8 k from the same thread's base, so that a full
// step's copies need no address arithmetic of their own and no guards.
template <int R, int BK>
__device__ __forceinline__ void stage_t(float* S, int P, const float* src,
                                        long long ld, int rows, int kn,
                                        const float* safe) {
  constexpr int RP = R / 32, NP = R * BK / F_THREADS;
  const int tid = threadIdx.x;
  const int r0 = 4 * (tid >> 5) + ((tid >> 3) & 3), k0 = tid & 7;
  float* s = S + k0 * P + r0;
  const float* g = src + r0 * ld + k0;
  const long long ld32 = 32 * ld;
  const bool full = rows >= R && kn >= BK;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int dr = 32 * (p % RP), dk = 8 * (p / RP);
    const bool ok = full || (r0 + dr < rows && k0 + dk < kn);
    gx_tc::cp_async4_zfill(s + dk * P + dr,
                           ok ? g + (p % RP) * ld32 + dk : safe, ok);
  }
}

// S[k][c] (pitch P) = src[k * ld + c] for k < rows and c < cols, zeros for
// the other k < BK, c < C: cp.async of V values (16, 8 or 4 bytes; ld,
// cols and src's alignment divide by V), F_THREADS / BK threads a row
template <int C, int V, int BK>
__device__ __forceinline__ void stage_dv(float* S, int P, const float* src,
                                         long long ld, int rows, int cols,
                                         const float* safe) {
  constexpr int TR = F_THREADS / BK, NC = C / V / TR;
  static_assert(NC * V * TR == C, "a row must split evenly");
  const int k = threadIdx.x / TR, c0 = (threadIdx.x % TR) * V;
  float* s = S + k * P + c0;
  const float* g = src + k * ld + c0;
  const bool full = rows >= BK && cols >= C;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int dc = j * TR * V;
    const bool ok = full || (k < rows && c0 + dc < cols);
    const float* from = ok ? g + dc : safe;
    if (V == 4)
      gx_tc::cp_async16_zfill(s + dc, from, ok);
    else if (V == 2)
      gx_tc::cp_async8_zfill(s + dc, from, ok);
    else
      gx_tc::cp_async4_zfill(s + dc, from, ok);
  }
}

template <int C, int BK>
__device__ __forceinline__ void stage_d(float* S, int P, const float* src,
                                        long long ld, int rows, int cols,
                                        int vw, const float* safe) {
  if (vw == 4)
    stage_dv<C, 4, BK>(S, P, src, ld, rows, cols, safe);
  else if (vw == 2)
    stage_dv<C, 2, BK>(S, P, src, ld, rows, cols, safe);
  else
    stage_dv<C, 1, BK>(S, P, src, ld, rows, cols, safe);
}

// The K loop of one CTA of shape S: acc = A B over nsteps steps from +0
// in K order, stage(s, As, Bs) filling step s's ring slot (A [BK][F_PA],
// B [BK][PB]) and klen(s) giving its real depth (<= BK); ST - 1 steps in
// flight, one barrier a step. A full step's k loop is unrolled (its
// shared offsets immediates); a short one runs only its k.
template <typename S, typename Stage, typename KLen>
__device__ __forceinline__ void f_gemm(float (&acc)[8][4 * S::NR],
                                       float* ring, int nsteps, Stage stage,
                                       KLen klen) {
  int ra, cb;
  f_coords<S::NR>(ra, cb);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * S::NR; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < S::ST - 1; ++s) {
    float* slot = ring + s * S::STAGE;
    if (s < nsteps) stage(s, slot, slot + S::BK * F_PA);
    gx_tc::cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    gx_tc::cp_async_wait<S::ST - 2>();
    __syncthreads();  // step s is in; step s - 1's slot is free
    const int sn = s + S::ST - 1;
    if (sn < nsteps) {
      float* slot = ring + (sn % S::ST) * S::STAGE;
      stage(sn, slot, slot + S::BK * F_PA);
    }
    gx_tc::cp_async_commit();
    const float* a = ring + (s % S::ST) * S::STAGE + ra;
    const float* b = ring + (s % S::ST) * S::STAGE + S::BK * F_PA + cb;
    const int kn = klen(s);
    if (kn == S::BK) {
#pragma unroll
      for (int k = 0; k < S::BK; ++k)
        f_fma<S::NR>(acc, a + k * F_PA, b + k * S::PB);
    } else {
#pragma unroll 1
      for (int k = 0; k < kn; ++k)
        f_fma<S::NR>(acc, a + k * F_PA, b + k * S::PB);
    }
  }
  gx_tc::cp_async_wait<0>();
}

// n <= 4 consecutive outputs v (f32 sums) to p in TO, by vw-value stores
// (4: one 16-byte f32 or 8-byte bf16 streaming store; 2: pairs; 1: single
// values), each rounded once
template <typename TO>
__device__ __forceinline__ void f_put(TO* p, const float (&v)[4], int n,
                                      int vw) {
  if (vw == 4 && n == 4) {
    gx_tc::store4(p, v);
  } else if (vw >= 2) {
    gx_tc::store2(p, v[0], v[1]);
    if (n > 2) gx_tc::store2(p + 2, v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) gx_tc::store1(p + e, v[e]);
  }
}

// v += the n <= 4 addend values at a (vw-value loads, as f_put)
__device__ __forceinline__ void f_add(float (&v)[4], const float* a, int n,
                                      int vw) {
  if (vw == 4 && n == 4) {
    const float4 t = *reinterpret_cast<const float4*>(a);
    v[0] += t.x; v[1] += t.y; v[2] += t.z; v[3] += t.w;
  } else if (vw >= 2) {
    const float2 t = *reinterpret_cast<const float2*>(a);
    v[0] += t.x; v[1] += t.y;
    if (n > 2) {
      const float2 u = *reinterpret_cast<const float2*>(a + 2);
      v[2] += u.x; v[3] += u.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) v[e] += a[e];
  }
}

// The CTA's outputs: row m < m_out of its tile to rowp(m) (nullptr: not
// stored), columns c < n_out, through put(p, v, n) for each run of n <= 4
template <int NR, typename RowP, typename Put>
__device__ __forceinline__ void f_epilogue(const float (&acc)[8][4 * NR],
                                           int m_out, int n_out, RowP rowp,
                                           Put put) {
  int ra, cb;
  f_coords<NR>(ra, cb);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ra + (i & 3) + 16 * (i >> 2);
    if (m >= m_out) continue;
    auto p = rowp(m);
    if (p == nullptr) continue;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int c = cb + 32 * r;
      if (c >= n_out) continue;
      float v[4] = {acc[i][4 * r], acc[i][4 * r + 1], acc[i][4 * r + 2],
                    acc[i][4 * r + 3]};
      put(p + c, v, min(4, n_out - c));
    }
  }
}

// out[t*tile + m, c] = rnd(dense[t, m, :] . slab[tile_win[t]][:, c] +
// addend[t*tile + m, c]) in f32 (win_matmul_tc_kernel runs bf16): one CTA
// a (tile, 128 rows, 192 columns of D), so each block is read once.
// A = the block's rows [m][k], staged k-major by 4-byte copies; B = the
// slab rows [k][c], by vb-value copies along D (vb also sizes the
// epilogue's addend loads and stores: x and the addend start on vb values;
// read a value at a time, the addend measured slower: PERF.md). Slab
// rows past W or N are zeros; K is W (the last step W % BK deep).
__global__ void __launch_bounds__(F_THREADS, F_CTAS_MM)
win_matmul_f32_kernel(const float* __restrict__ dense,
                      const float* __restrict__ x,
                      const int* __restrict__ tile_win,
                      const float* __restrict__ addend,
                      float* __restrict__ out, int tile, int W, int N, int D,
                      int vb) {
  using S = FShape<F_NR_MM, F_BK_MM, F_ST_MM>;
  extern __shared__ __align__(16) unsigned char smem_f[];
  float* ring = reinterpret_cast<float*>(smem_f);
  const int nchunks = (D + S::BN - 1) / S::BN;
  const int mblocks = (tile + F_BM - 1) / F_BM;
  const int c0 = (blockIdx.x % nchunks) * S::BN;
  const int m0 = ((blockIdx.x / nchunks) % mblocks) * F_BM;
  const int t = blockIdx.x / nchunks / mblocks;
  const int mrows = min(F_BM, tile - m0), ncol = min(S::BN, D - c0);
  const long long node0 = (long long)t * tile + m0;  // first output row
  const long long base = (long long)tile_win[t] * W;  // first slab row
  const float* A = dense + (size_t)node0 * W;
  float acc[8][4 * F_NR_MM];
  f_gemm<S>(
      acc, ring, (W + S::BK - 1) / S::BK,
      [&](int s, float* As, float* Bs) {
        const int k0 = s * S::BK;
        stage_t<F_BM, S::BK>(As, F_PA, A + k0, W, mrows, W - k0, dense);
        const long long first = base + k0;
        const int rows = (int)max(0LL, min((long long)(W - k0), N - first));
        stage_d<S::BN, S::BK>(Bs, S::PB, rows > 0 ? x + first * D + c0 : x,
                              D, rows, ncol, vb, x);
      },
      [&](int s) { return min(S::BK, W - s * S::BK); });
  f_epilogue<F_NR_MM>(
      acc, mrows, ncol,
      [&](int m) -> float* {
        return node0 + m < N ? out + (node0 + m) * D + c0 : nullptr;
      },
      [&](float* p, float (&v)[4], int n) {
        f_add(v, addend + (p - out), n, vb);
        f_put(p, v, n, vb);
      });
}

// d_dense[t, m, n] = g[t*tile + m, :] . slab[tile_win[t]][n, :] in f32,
// rounded once to TO (win_bwd_dense_tc_kernel runs bf16 inputs): one CTA a
// (tile, 128 rows, 128 slab rows). A = g rows and B = slab rows,
// both [.][k] in device memory, staged k-major by 4-byte copies; K is D,
// BK a step (the last step D % BK deep). Rows past N (of the last
// tile, of the last window's slab) are zeros, so their outputs are the
// zeros the plain version's padding gives. 16-byte (f32) or 8-byte (bf16)
// streaming stores where W % 4 == 0.
template <typename TO>
__global__ void __launch_bounds__(F_THREADS, F_CTAS_BD)
win_bwd_dense_f32_kernel(const float* __restrict__ g,
                         const float* __restrict__ x,
                         const int* __restrict__ tile_win,
                         TO* __restrict__ out, int tile, int W, int N,
                         int D) {
  using S = FShape<F_NR_BD, F_BK_BD, F_ST_BD>;
  extern __shared__ __align__(16) unsigned char smem_f[];
  float* ring = reinterpret_cast<float*>(smem_f);
  const int nchunks = (W + S::BN - 1) / S::BN;
  const int mblocks = (tile + F_BM - 1) / F_BM;
  const int vw = (W & 3) == 0 ? 4 : 1;
  const int n0 = (blockIdx.x % nchunks) * S::BN;
  const int m0 = ((blockIdx.x / nchunks) % mblocks) * F_BM;
  const int t = blockIdx.x / nchunks / mblocks;
  const long long row0 = (long long)t * tile + m0;         // first g row
  const long long base = (long long)tile_win[t] * W + n0;  // first slab row
  const int m_out = min(F_BM, tile - m0), n_out = min(S::BN, W - n0);
  // g rows and slab rows below N (the others are staged as zeros)
  const int grows = (int)max(0LL, min((long long)m_out, N - row0));
  const int xrows = (int)max(0LL, min((long long)n_out, N - base));
  const float* ga = grows > 0 ? g + row0 * D : g;
  const float* xb = xrows > 0 ? x + base * D : x;
  float acc[8][4 * F_NR_BD];
  f_gemm<S>(
      acc, ring, (D + S::BK - 1) / S::BK,
      [&](int s, float* As, float* Bs) {
        const int k0 = s * S::BK;
        stage_t<F_BM, S::BK>(As, F_PA, ga + k0, D, grows, D - k0, g);
        stage_t<S::BN, S::BK>(Bs, S::PB, xb + k0, D, xrows, D - k0, x);
      },
      [&](int s) { return min(S::BK, D - s * S::BK); });
  f_epilogue<F_NR_BD>(
      acc, m_out, n_out,
      [&](int m) -> TO* {
        return out + ((size_t)t * tile + m0 + m) * W + n0;
      },
      [&](TO* p, float (&v)[4], int n) { f_put(p, v, n, vw); });
}

// dx[w*W + m, c] = sum over the tiles t of window w (the window -> tiles
// CSR's order) of sum_r dense[t, r, m] g[t*tile + r, c], in f32, rounded
// once to TO, for the slab rows w*W + m < N (win_bwd_slab_tc_kernel runs
// bf16): one CTA a (window, 128 slab rows, 192 columns of D), so each
// block is read once. A = the block's rows [r][m], B = g's rows [r][c]:
// both k-major already, staged by va- and vb-value copies along their rows
// (vb also sizes the stores). K walks the window's tiles, each in steps of
// BK rows (the last tile % BK deep); g rows past N are zeros. A window
// that no tile maps writes zeros.
template <typename TO>
__global__ void __launch_bounds__(F_THREADS, F_CTAS_MM)
win_bwd_slab_f32_kernel(const float* __restrict__ dense,
                        const float* __restrict__ g,
                        const int* __restrict__ win_ptr,
                        const int* __restrict__ win_tiles,
                        TO* __restrict__ out, int tile, int W, int N, int D,
                        int va, int vb) {
  using S = FShape<F_NR_MM, F_BK_MM, F_ST_MM>;
  extern __shared__ __align__(16) unsigned char smem_f[];
  float* ring = reinterpret_cast<float*>(smem_f);
  const int nchunks = (D + S::BN - 1) / S::BN;
  const int mblocks = (W + F_BM - 1) / F_BM;
  const int kpt = (tile + S::BK - 1) / S::BK;  // steps a tile
  const int c0 = (blockIdx.x % nchunks) * S::BN;
  const int m0 = ((blockIdx.x / nchunks) % mblocks) * F_BM;
  const int w = blockIdx.x / nchunks / mblocks;
  const int ncol = min(S::BN, D - c0), mcols = min(F_BM, W - m0);
  const int beg = win_ptr[w];
  float acc[8][4 * F_NR_MM];
  f_gemm<S>(
      acc, ring, (win_ptr[w + 1] - beg) * kpt,
      [&](int s, float* As, float* Bs) {
        const long long t = win_tiles[beg + s / kpt];
        const int r0 = (s % kpt) * S::BK, rows = min(S::BK, tile - r0);
        stage_d<F_BM, S::BK>(As, F_PA, dense + (t * tile + r0) * W + m0, W,
                             rows, mcols, va, dense);
        const long long first = t * tile + r0;
        const int grows = (int)max(0LL, min((long long)rows, N - first));
        stage_d<S::BN, S::BK>(Bs, S::PB, grows > 0 ? g + first * D + c0 : g,
                              D, grows, ncol, vb, g);
      },
      [&](int s) { return min(S::BK, tile - (s % kpt) * S::BK); });
  const long long row0 = (long long)w * W + m0;  // first slab row
  f_epilogue<F_NR_MM>(
      acc, mcols, ncol,
      [&](int m) -> TO* {
        return row0 + m < N ? out + (row0 + m) * D + c0 : nullptr;
      },
      [&](TO* p, float (&v)[4], int n) { f_put(p, v, n, vb); });
}

// The bf16 instantiation, on the tensor cores (see the note at the top).
// One CTA per work item (tile, 128-row block, 176-column chunk). 8 warps:
// 4 over rows (32 each, two m16 fragments) x 2 over columns (11 n8
// fragments each), 88 f32 accumulators a thread. Shared memory:
// - a ring of MM_STAGES K chunks, each A [128][40] (80-byte rows:
//   ldmatrix's 8 rows fall in 8 different 16-byte bank groups) and B
//   [32][184] (368-byte rows, the same for ldmatrix.trans), B's slab rows
//   staged by 4-byte copies of their column pairs (D = 162 rows are 324
//   bytes, so in device memory most start off 16 bytes, and 16-byte copies
//   cannot place them in 16-byte-aligned ldmatrix rows);
// - C [128][184], the item's addend rows, copied in at the start (in the
//   first chunk's cp.async group) and overwritten in place by the rounded
//   outputs, which leave row by row (each warp a row, each lane a column
//   pair: whole 128-byte lines).
// Rows past the tile or past N, slab rows past W or N and block columns
// past W are staged as zeros (cp.async's zero fill); B columns past D are
// never written and only reach outputs that are not stored.
constexpr int MM_BM = 128, MM_BK = 32, MM_STAGES = 3, MM_THREADS = 256;
constexpr int MM_NFW = 11;                 // n8 fragments per warp
constexpr int MM_BN = 2 * 8 * MM_NFW;      // 176 output columns per CTA
constexpr int MM_PA = MM_BK + 8, MM_PB = MM_BN + 8;
constexpr int MM_STAGE = MM_BM * MM_PA + MM_BK * MM_PB;  // elements
constexpr int MM_SMEM =
    (MM_STAGES * MM_STAGE + MM_BM * MM_PB) * (int)sizeof(bf16);

// Rows [0, rows) of a row-major [., D] bf16 matrix from row r0 on, columns
// c0 .. c0 + ncol, into S [.][MM_PB]: a warp per row, a pair per lane (4-byte
// cp.async where ASYNC, else one value per copy); rows past `valid` as zeros.
template <bool ASYNC>
__device__ __forceinline__ void stage_pairs(bf16* S, const bf16* M,
                                            long long r0, int rows, int valid,
                                            int c0, int ncol, int D, int warp,
                                            int lane) {
  for (int r = warp; r < rows; r += MM_THREADS / 32) {
    const bool ok = r < valid;
    const bf16* src = M + (ok ? (r0 + r) * D + c0 : 0);
    bf16* dst = S + r * MM_PB;
    for (int c = 2 * lane; c < ncol; c += 64) {
      if (ASYNC) {
        gx_tc::cp_async4_zfill(dst + c, src + c, ok);
      } else {
        dst[c] = ok ? src[c] : gx_tc::bzero();
        dst[c + 1] = ok && c + 1 < ncol ? src[c + 1] : gx_tc::bzero();
      }
    }
  }
}

// ASYNC: the "cp.async" route (W % 8 == 0, D even, the blocks on 16 bytes,
// x and the addend on 4); else the "elements" route, one value per copy
template <bool ASYNC>
__global__ void __launch_bounds__(MM_THREADS, 2)
win_matmul_tc_kernel(const bf16* __restrict__ dense, const bf16* __restrict__ x,
                     const int* __restrict__ tile_win,
                     const bf16* __restrict__ addend, bf16* __restrict__ out,
                     int tile, int W, int N, int D) {
  extern __shared__ __align__(16) unsigned char smem_mm[];
  bf16* ring = reinterpret_cast<bf16*>(smem_mm);
  bf16* Cs = ring + MM_STAGES * MM_STAGE;  // [MM_BM][MM_PB]
  const int nchunks = (D + MM_BN - 1) / MM_BN;
  const int mblocks = (tile + MM_BM - 1) / MM_BM;
  const int c0 = (blockIdx.x % nchunks) * MM_BN;
  const int m0 = ((blockIdx.x / nchunks) % mblocks) * MM_BM;
  const int t = blockIdx.x / nchunks / mblocks;
  const int ncol = min(MM_BN, D - c0);
  const int mrows = min(MM_BM, tile - m0);
  const long long node0 = (long long)t * tile + m0;  // first output row
  const int mout = (int)max(0LL, min((long long)mrows, N - node0));
  const bf16* A = dense + ((size_t)t * tile + m0) * W;
  const long long base = (long long)tile_win[t] * W;  // first slab row
  const int nk = (W + MM_BK - 1) / MM_BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 3) * 32, fw = (warp >> 2) * MM_NFW;

  // K chunk kc into its ring slot
  auto stage = [&](int kc) {
    if (kc >= nk) return;
    bf16* As = ring + (kc % MM_STAGES) * MM_STAGE;
    bf16* Bs = As + MM_BM * MM_PA;
    const int k0 = kc * MM_BK;
    for (int i = tid; i < MM_BM * (MM_BK / 8); i += MM_THREADS) {
      const int r = i / (MM_BK / 8), c = k0 + 8 * (i % (MM_BK / 8));
      bf16* dst = As + r * MM_PA + (c - k0);
      if (ASYNC) {
        const bool ok = r < mrows && c < W;
        gx_tc::cp_async16_zfill(dst, ok ? A + (size_t)r * W + c : A, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = r < mrows && c + e < W ? A[(size_t)r * W + c + e]
                                          : gx_tc::bzero();
      }
    }
    const long long first = base + k0;  // slab rows past W or N are zeros
    stage_pairs<ASYNC>(Bs, x, first, MM_BK,
                       (int)max(0LL, min((long long)(W - k0), N - first)),
                       c0, ncol, D, warp, lane);
  };

  float acc[2][MM_NFW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < MM_NFW; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;

  stage_pairs<ASYNC>(Cs, addend, node0, mout, mout, c0, ncol, D, warp,
                     lane);  // (with the first chunk)
#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    stage(s);
    gx_tc::cp_async_commit();
  }
  // ldmatrix addresses: A rows wm + 16 i + (lane & 7) + 8 ((lane >> 3) & 1),
  // columns 8 (lane >> 4); B (k rows) (lane & 7) + 8 ((lane >> 3) & 1),
  // columns 8 (lane >> 4) of each fragment pair
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  for (int kc = 0; kc < nk; ++kc) {
    gx_tc::cp_async_wait<MM_STAGES - 2>();
    __syncthreads();  // chunk kc is in; chunk kc - 1's slot is free
    stage(kc + MM_STAGES - 1);
    gx_tc::cp_async_commit();
    const bf16* As = ring + (kc % MM_STAGES) * MM_STAGE;
    const bf16* Bs = As + MM_BM * MM_PA;
#pragma unroll
    for (int kk = 0; kk < MM_BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        gx_tc::ldmatrix_x4(a[i], As + (wm + 16 * i + lr) * MM_PA + kk + lc);
#pragma unroll
      for (int p = 0; p < (MM_NFW + 1) / 2; ++p) {
        const int n0 = (fw + 2 * p) * 8;
        if (n0 >= ncol) break;  // fragments wholly past D
        uint32_t b[4];
        gx_tc::ldmatrix_x4_trans(b, Bs + (kk + lr) * MM_PB + n0 + lc);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          gx_tc::mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
          if (2 * p + 1 < MM_NFW)
            gx_tc::mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  gx_tc::cp_async_wait<0>();
  __syncthreads();  // the addend is in C

  // C = rnd(acc + C) in place: this lane's rows wm + 16 i + g (+8),
  // columns 2q, 2q+1 of each fragment (C's 92-word pitch puts a
  // fragment's 8 rows x 4 pairs in 32 different banks)
  const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      bf16* crow = Cs + (wm + 16 * i + g + 8 * hf) * MM_PB;
#pragma unroll
      for (int f = 0; f < MM_NFW; ++f) {
        const int c = (fw + f) * 8 + q2;
        if (c >= ncol) break;
        __nv_bfloat162* cp = reinterpret_cast<__nv_bfloat162*>(crow + c);
        const __nv_bfloat162 ad = *cp;
        *cp = __floats2bfloat162_rn(acc[i][f][2 * hf] + __low2float(ad),
                                    acc[i][f][2 * hf + 1] + __high2float(ad));
      }
    }
  __syncthreads();
  for (int r = warp; r < mout; r += MM_THREADS / 32) {
    const bf16* src = Cs + r * MM_PB;
    bf16* dst = out + (node0 + r) * D + c0;
    for (int c = 2 * lane; c < ncol; c += 64) {
      if (ASYNC) {
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            *reinterpret_cast<const __nv_bfloat162*>(src + c);
      } else {
        dst[c] = src[c];
        if (c + 1 < ncol) dst[c + 1] = src[c + 1];
      }
    }
  }
}

template <bool ASYNC>
cudaError_t win_matmul_tc_run(const void* dense, const void* x,
                              const void* tile_win, const void* addend,
                              void* out, int T, int tile, int W, int N, int D,
                              cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {  // the opt-in above 48 KB, once
    cudaError_t err = cudaFuncSetAttribute(
        win_matmul_tc_kernel<ASYNC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MM_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long long blocks = (long long)T * ((tile + MM_BM - 1) / MM_BM) *
                           ((D + MM_BN - 1) / MM_BN);
  if (blocks <= 0) return cudaSuccess;
  win_matmul_tc_kernel<ASYNC><<<(unsigned)blocks, MM_THREADS, MM_SMEM, s>>>(
      (const bf16*)dense, (const bf16*)x, (const int*)tile_win,
      (const bf16*)addend, (bf16*)out, tile, W, N, D);
  return cudaGetLastError();
}

// The bf16 instantiation, on the tensor cores. Each CTA owns one
// BM_TC x BN_TC block of d_dense[t]: the g rows of its tile part and the
// slab rows of its column part are staged whole (D in one piece up to
// KMAX_TC, in K chunks beyond), as the contiguous byte ranges they are in
// device memory (16-byte cp.async; element copies for odd D, K chunks or a
// misaligned view), so the shared rows keep D's pitch and mma.sync reads
// k pairs with 32-bit loads. 8 warps (4 over rows, 2 over columns) of
// 32 x 64, f32 accumulators. A fragment's 8 rows (and a B fragment's 8
// columns) are staged rows 4 apart: with an odd pitch in words (D = 162:
// 81) rows 4 apart start 4 banks apart, so every 32-bit shared load is
// free of bank conflicts; and each lane then holds 8 consecutive output
// columns of 4 rows, which leave as 16-byte streaming stores, rounded once
// from the f32 sums. Two CTAs per SM overlap one's staging and products
// with the other's stores; the column blocks of one tile are adjacent in
// the grid, and the tiles of one window too, so a tile's g rows and a
// window's slab rows are read from device memory about once and from L2
// after. Rows past N (the last window's slab, the last tile) are staged as
// zeros, so their outputs are the zero the plain version's padding gives.
constexpr int BM_TC = 128, BN_TC = 128, THREADS_TC = 256;
// the deepest K (a multiple of 16) whose two blocks fit the opt-in shared
// memory of a CTA
constexpr int KMAX_TC = ((232448 / 2 - 16) / (BM_TC + BN_TC)) & ~15;

// CHUNKED: D > kc, staged and consumed in K chunks; else one piece (the
// loop folds away, which keeps the accumulators within the register
// budget of two CTAs per SM)
template <typename TO, bool CHUNKED>
__global__ void __launch_bounds__(THREADS_TC, 2)
win_bwd_dense_tc_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                        const int* __restrict__ tile_win,
                        TO* __restrict__ out, int tile, int W, int N, int D,
                        int kc, int P, int vec) {
  constexpr int NJ = BN_TC / 16;  // B fragments per warp: 64 columns
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* As = reinterpret_cast<bf16*>(smem_tc);  // [BM_TC][P]
  bf16* Bs = As + BM_TC * P;                     // [BN_TC][P] (+16 slack)
  const int nchunks = (W + BN_TC - 1) / BN_TC;
  const int mblocks = (tile + BM_TC - 1) / BM_TC;
  const int n0 = (blockIdx.x % nchunks) * BN_TC;
  const int m0 = ((blockIdx.x / nchunks) % mblocks) * BM_TC;
  const int t = blockIdx.x / nchunks / mblocks;
  const long long row0 = (long long)t * tile + m0;         // first g row
  const long long base = (long long)tile_win[t] * W + n0;  // first slab row
  const int m_out = min(BM_TC, tile - m0), n_out = min(BN_TC, W - n0);
  const int ra = (int)max(0LL, min((long long)m_out, N - row0));
  const int rb = (int)max(0LL, min((long long)n_out, N - base));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = 4 * (lane >> 2), q = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * (BN_TC / 2);
  float acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = CHUNKED ? (D + kc - 1) / kc : 1;
  for (int ci = 0; ci < nk; ++ci) {
    const int k0 = ci * kc, kcur = CHUNKED ? min(kc, D - k0) : D;
    if (ci > 0) __syncthreads();  // the last K chunk's products are done
    gx_tc::stage_rows(As, g + row0 * D, ra, D, k0, kcur, P, vec, tid,
                      THREADS_TC);
    gx_tc::stage_rows(Bs, x + base * D, rb, D, k0, kcur, P, vec, tid,
                      THREADS_TC);
    gx_tc::zero_rows(As, ra, BM_TC, P, tid, THREADS_TC);
    gx_tc::zero_rows(Bs, rb, BN_TC, P, tid, THREADS_TC);
    gx_tc::cp_async_commit();
    gx_tc::cp_async_wait<0>();
    __syncthreads();
    // (warps whose rows or columns all lie past the block's edge multiply
    // zeros and store nothing)
#pragma unroll 2
    for (int kk = 0; kk < kcur; kk += 16) {
      // fragment i's rows g, g+8: staged rows wm + 4g + 2i (+1)
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        gx_tc::load_a(a[i], As, P, wm + g4 + 2 * i, wm + g4 + 2 * i + 1, kk,
                      kcur, lane);
      // fragment j's column g: staged row wn + 32 (j / 4) + 4g + j % 4
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b0, b1;
        gx_tc::load_b(b0, b1, Bs, P, wn + 32 * (j >> 2) + g4 + (j & 3), kk,
                      kcur, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) gx_tc::mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
  }
  // this lane's rows wm + 4g + 2i + h, columns wn + 32 jg + 8q .. + 7
  const bool vec_out = W % (16 / (int)sizeof(TO)) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + g4 + 2 * i + h;
      if (r >= m_out) continue;
#pragma unroll
      for (int jg = 0; jg < NJ / 4; ++jg) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = acc[i][4 * jg + e][2 * h];
          v[4 + e] = acc[i][4 * jg + e][2 * h + 1];
        }
        const int c = wn + 32 * jg + 8 * q;
        TO* p = out + ((size_t)t * tile + m0 + r) * W + n0 + c;
        if (vec_out && c + 7 < n_out) {
          gx_tc::store8(p, v);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c + e < n_out) gx_tc::store1(p + e, v[e]);
        }
      }
    }
}

template <typename TO, bool CHUNKED>
cudaError_t bwd_dense_tc_run(const void* g, const void* x,
                             const void* tile_win, void* out, int T, int tile,
                             int W, int N, int D, int vec, cudaStream_t s) {
  const int kc = D < KMAX_TC ? D : KMAX_TC;
  const int P = kc + (kc & 1);
  const int smem = ((BM_TC + BN_TC) * P + 16) * (int)sizeof(bf16);
  static int smem_set = 0;
  if (smem > smem_set) {  // the opt-in, once per size
    cudaError_t err = cudaFuncSetAttribute(
        win_bwd_dense_tc_kernel<TO, CHUNKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const long long blocks = (long long)T * ((tile + BM_TC - 1) / BM_TC) *
                           ((W + BN_TC - 1) / BN_TC);
  if (blocks <= 0) return cudaSuccess;
  win_bwd_dense_tc_kernel<TO, CHUNKED>
      <<<(unsigned)blocks, THREADS_TC, smem, s>>>(
          (const bf16*)g, (const bf16*)x, (const int*)tile_win, (TO*)out,
          tile, W, N, D, kc, P, vec);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t bwd_dense_tc_launch(const void* g, const void* x,
                                const void* tile_win, void* out, int T,
                                int tile, int W, int N, int D, int vec,
                                cudaStream_t s) {
  if (D > KMAX_TC)
    return bwd_dense_tc_run<TO, true>(g, x, tile_win, out, T, tile, W, N, D,
                                      vec, s);
  return bwd_dense_tc_run<TO, false>(g, x, tile_win, out, T, tile, W, N, D,
                                     vec, s);
}

// The bf16 instantiation, on the tensor cores (see the note at the top):
// win_matmul_tc_kernel's machinery with the block transposed. One CTA per
// (window, 128 slab rows, 176 columns of D) walks the window's tiles from
// the window -> tiles CSR, each in chunks of MM_BK = 32 tile rows, through
// a ring of MM_STAGES stages: A = dense[t]^T, staged as the block's rows
// [32][128 slab rows] (256 bytes a row, 16-byte cp.async; 272-byte rows in
// shared memory, so ldmatrix.trans's 8 rows fall in 8 bank groups), and B
// = the tile's g rows [32][176] by 4-byte copies of column pairs (as
// win_matmul's slab rows), both read by ldmatrix.trans. Each block is read
// from device memory once; a window's g rows by its 4 CTAs (W = 512) side
// by side in the grid, so from L2 after the first. The f32 sums leave
// rounded once to TO (bf16 through shared memory in whole rows), only for
// slab rows < N: dx itself, with no [Wn W, D] f32 slab and no cast pass.
// A window that no tile maps writes zeros.
// (A persistent grid whose ring runs on across a CTA's windows, with 4
// stages, measured slower: PERF.md.)
constexpr int SB_PA = MM_BM + 8;
constexpr int SB_STAGE = MM_BK * SB_PA + MM_BK * MM_PB;  // elements
constexpr int SB_SMEM = MM_STAGES * SB_STAGE * (int)sizeof(bf16);
static_assert(MM_BM * MM_PB <= MM_STAGES * SB_STAGE,
              "the bf16 output tile must fit the ring");

// ASYNC: the "cp.async" route (W % 8 == 0, D even, the blocks on 16 bytes,
// g on 4); else the "elements" route, one value per copy
template <typename TO, bool ASYNC>
__global__ void __launch_bounds__(MM_THREADS, 2)
win_bwd_slab_tc_kernel(const bf16* __restrict__ dense,
                       const bf16* __restrict__ g,
                       const int* __restrict__ win_ptr,
                       const int* __restrict__ win_tiles,
                       TO* __restrict__ out, int tile, int W, int N, int D) {
  extern __shared__ __align__(16) unsigned char smem_sb[];
  bf16* ring = reinterpret_cast<bf16*>(smem_sb);
  const int nchunks = (D + MM_BN - 1) / MM_BN;
  const int mblocks = (W + MM_BM - 1) / MM_BM;
  const int c0 = (blockIdx.x % nchunks) * MM_BN;
  const int m0 = ((blockIdx.x / nchunks) % mblocks) * MM_BM;
  const int w = blockIdx.x / nchunks / mblocks;
  const int ncol = min(MM_BN, D - c0);
  const int mcols = min(MM_BM, W - m0);  // slab rows of this CTA
  const int beg = win_ptr[w];
  const int kpt = (tile + MM_BK - 1) / MM_BK;  // chunks a tile
  const int nk = (win_ptr[w + 1] - beg) * kpt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 3) * 32, fw = (warp >> 2) * MM_NFW;

  // chunk kc (tile kc / kpt of the window, its rows from (kc % kpt) * 32)
  // into its ring slot; rows past the tile and g rows past N as zeros
  auto stage = [&](int kc) {
    if (kc >= nk) return;
    bf16* As = ring + (kc % MM_STAGES) * SB_STAGE;
    bf16* Bs = As + MM_BK * SB_PA;
    const long long t = win_tiles[beg + kc / kpt];
    const int r0 = (kc % kpt) * MM_BK, rows = min(MM_BK, tile - r0);
    const bf16* A = dense + (t * tile + r0) * W + m0;
    for (int i = tid; i < MM_BK * (MM_BM / 8); i += MM_THREADS) {
      const int r = i / (MM_BM / 8), c = 8 * (i % (MM_BM / 8));
      bf16* dst = As + r * SB_PA + c;
      if (ASYNC) {
        const bool ok = r < rows && c < mcols;
        gx_tc::cp_async16_zfill(dst, ok ? A + (size_t)r * W + c : dense, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = r < rows && c + e < mcols ? A[(size_t)r * W + c + e]
                                             : gx_tc::bzero();
      }
    }
    const long long first = t * tile + r0;
    stage_pairs<ASYNC>(Bs, g, first, MM_BK,
                       (int)max(0LL, min((long long)rows, N - first)), c0,
                       ncol, D, warp, lane);
  };

  float acc[2][MM_NFW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < MM_NFW; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;

#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    stage(s);
    gx_tc::cp_async_commit();
  }
  // ldmatrix.trans addresses: A (tile rows k, slab rows m) k = (lane & 7) +
  // 8 (lane >> 4), m = 8 ((lane >> 3) & 1) of each m16 fragment; B (tile
  // rows k, columns n) as win_matmul's
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  const int ak = (lane & 7) + lc, am = 8 * ((lane >> 3) & 1);
  for (int kc = 0; kc < nk; ++kc) {
    gx_tc::cp_async_wait<MM_STAGES - 2>();
    __syncthreads();  // chunk kc is in; chunk kc - 1's slot is free
    stage(kc + MM_STAGES - 1);
    gx_tc::cp_async_commit();
    const bf16* As = ring + (kc % MM_STAGES) * SB_STAGE;
    const bf16* Bs = As + MM_BK * SB_PA;
#pragma unroll
    for (int kk = 0; kk < MM_BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        gx_tc::ldmatrix_x4_trans(a[i],
                                 As + (kk + ak) * SB_PA + wm + 16 * i + am);
#pragma unroll
      for (int p = 0; p < (MM_NFW + 1) / 2; ++p) {
        const int n0 = (fw + 2 * p) * 8;
        if (n0 >= ncol) break;  // fragments wholly past D
        uint32_t b[4];
        gx_tc::ldmatrix_x4_trans(b, Bs + (kk + lr) * MM_PB + n0 + lc);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          gx_tc::mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
          if (2 * p + 1 < MM_NFW)
            gx_tc::mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  gx_tc::cp_async_wait<0>();

  // this lane's slab rows wm + 16 i + g (+8), columns 2q, 2q+1 of each
  // fragment. bf16: rounded into C [128][MM_PB] in the ring's memory (92
  // words a row: a fragment's 8 rows x 4 pairs in 32 banks), then out a
  // warp per row, a pair per lane, whole 128-byte lines (with the rest of
  // the kernel switched off, the fragments' 16-byte row pieces stored
  // straight took 0.097 ms on the H100 at the arxiv shapes, these 0.036:
  // PERF.md). f32 (off every path; C would not fit): straight.
  const int g8 = lane >> 2, q2 = 2 * (lane & 3);
  const long long row0 = (long long)w * W + m0;  // first slab row
  const int mout = (int)max(0LL, min((long long)mcols, N - row0));
  bf16* Cs = ring;
  if (sizeof(TO) == 2) __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm + 16 * i + g8 + 8 * hf;
      if (m >= mout) continue;
      TO* orow = out + (row0 + m) * D + c0;
#pragma unroll
      for (int f = 0; f < MM_NFW; ++f) {
        const int c = (fw + f) * 8 + q2;
        if (c >= ncol) break;
        const float v0 = acc[i][f][2 * hf], v1 = acc[i][f][2 * hf + 1];
        if (sizeof(TO) == 2) {
          *reinterpret_cast<__nv_bfloat162*>(Cs + m * MM_PB + c) =
              __floats2bfloat162_rn(v0, v1);
        } else if (ASYNC) {
          gx_tc::store2(orow + c, v0, v1);
        } else {
          gx_tc::store1(orow + c, v0);
          if (c + 1 < ncol) gx_tc::store1(orow + c + 1, v1);
        }
      }
    }
  if (sizeof(TO) != 2) return;
  __syncthreads();
  for (int r = warp; r < mout; r += MM_THREADS / 32) {
    const bf16* src = Cs + r * MM_PB;
    bf16* dst = reinterpret_cast<bf16*>(out) + (row0 + r) * D + c0;
    for (int c = 2 * lane; c < ncol; c += 64) {
      if (ASYNC) {
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            *reinterpret_cast<const __nv_bfloat162*>(src + c);
      } else {
        dst[c] = src[c];
        if (c + 1 < ncol) dst[c + 1] = src[c + 1];
      }
    }
  }
}

template <typename TO, bool ASYNC>
cudaError_t win_bwd_slab_tc_run(const void* dense, const void* g,
                                const void* win_ptr, const void* win_tiles,
                                void* out, int Wn, int tile, int W, int N,
                                int D, cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {  // the opt-in above 48 KB, once
    cudaError_t err = cudaFuncSetAttribute(
        win_bwd_slab_tc_kernel<TO, ASYNC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SB_SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long long blocks = (long long)Wn * ((W + MM_BM - 1) / MM_BM) *
                           ((D + MM_BN - 1) / MM_BN);
  if (blocks <= 0) return cudaSuccess;
  win_bwd_slab_tc_kernel<TO, ASYNC><<<(unsigned)blocks, MM_THREADS, SB_SMEM,
                                      s>>>(
      (const bf16*)dense, (const bf16*)g, (const int*)win_ptr,
      (const int*)win_tiles, (TO*)out, tile, W, N, D);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t densify_launch(const void* edge_id, const void* cell,
                           const void* values, void* dense, int n,
                           long long n_cells, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(dense, 0, (size_t)n_cells * sizeof(TO), s);
  if (err != cudaSuccess) return err;
  if (n > 0)
    densify_kernel<TI, TO><<<(n + 255) / 256, 256, 0, s>>>(
        (const int*)edge_id, (const int*)cell, (const TI*)values, (TO*)dense, n);
  return cudaGetLastError();
}

// One CTA a work item of an f32 body's `kernel`, its shared memory opted
// in above 48 KB at the first launch (`set`, one per kernel)
template <typename... P, typename... A>
cudaError_t f_launch(void (*kernel)(P...), bool& set, int smem,
                     long long items, cudaStream_t s, A... args) {
  if (!set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set = true;
  }
  if (items <= 0) return cudaSuccess;
  kernel<<<(unsigned)items, F_THREADS, smem, s>>>(args...);
  return cudaGetLastError();
}

bool f_width(int v) { return v == 1 || v == 2 || v == 4; }

cudaError_t win_matmul_f32_run(const void* dense, const void* x,
                               const void* tile_win, const void* addend,
                               void* out, int T, int tile, int W, int N,
                               int D, int vb, cudaStream_t s) {
  using S = FShape<F_NR_MM, F_BK_MM, F_ST_MM>;
  static bool set = false;
  if (!f_width(vb)) return cudaErrorInvalidValue;
  return f_launch(win_matmul_f32_kernel, set, S::SMEM,
                  (long long)T * ((tile + F_BM - 1) / F_BM) *
                      ((D + S::BN - 1) / S::BN),
                  s, (const float*)dense, (const float*)x,
                  (const int*)tile_win, (const float*)addend, (float*)out,
                  tile, W, N, D, vb);
}

template <typename TO>
cudaError_t bwd_dense_f32_run(const void* g, const void* x,
                              const void* tile_win, void* out, int T,
                              int tile, int W, int N, int D, cudaStream_t s) {
  using S = FShape<F_NR_BD, F_BK_BD, F_ST_BD>;
  static bool set = false;
  return f_launch(win_bwd_dense_f32_kernel<TO>, set, S::SMEM,
                  (long long)T * ((tile + F_BM - 1) / F_BM) *
                      ((W + S::BN - 1) / S::BN),
                  s, (const float*)g, (const float*)x, (const int*)tile_win,
                  (TO*)out, tile, W, N, D);
}

template <typename TO>
cudaError_t bwd_slab_f32_run(const void* dense, const void* g,
                             const void* win_ptr, const void* win_tiles,
                             void* out, int Wn, int tile, int W, int N, int D,
                             int va, int vb, cudaStream_t s) {
  using S = FShape<F_NR_MM, F_BK_MM, F_ST_MM>;
  static bool set = false;
  if (!f_width(va) || !f_width(vb)) return cudaErrorInvalidValue;
  return f_launch(win_bwd_slab_f32_kernel<TO>, set, S::SMEM,
                  (long long)Wn * ((W + F_BM - 1) / F_BM) *
                      ((D + S::BN - 1) / S::BN),
                  s, (const float*)dense, (const float*)g,
                  (const int*)win_ptr, (const int*)win_tiles, (TO*)out, tile,
                  W, N, D, va, vb);
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16. Each function returns the cudaError_t
// of its launch.

// dense [n_cells] (out_dtype) = 0, then dense[cell[i]] = values[edge_id[i]]
// for i < n_win; edge_id and cell are int32.
int gx_densify(const void* edge_id, const void* cell, const void* values,
               void* dense, int n_win, long long n_cells, int in_dtype,
               int out_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (in_dtype == 0 && out_dtype == 0)
    return densify_launch<float, float>(edge_id, cell, values, dense, n_win, n_cells, s);
  if (in_dtype == 0 && out_dtype == 1)
    return densify_launch<float, bf16>(edge_id, cell, values, dense, n_win, n_cells, s);
  if (in_dtype == 1 && out_dtype == 0)
    return densify_launch<bf16, float>(edge_id, cell, values, dense, n_win, n_cells, s);
  if (in_dtype == 1 && out_dtype == 1)
    return densify_launch<bf16, bf16>(edge_id, cell, values, dense, n_win, n_cells, s);
  return (int)cudaErrorInvalidValue;
}


// out [N, D] = dense @ slab + addend, rounded once to the shared dtype of
// dense [T, tile, W], x [N, D], addend [N, D] and out; tile_win [T] int32.
// float32: vb the values per copy of x's rows and per access of the
// addend's and out's (4, 2 or 1: D and both pointers divide by it; va is
// not read); bfloat16 (the tensor-core kernel): va != 0 takes the cp.async
// route (W % 8 == 0, D even, dense on 16 bytes, x and addend on 4), else
// the element route.
int gx_win_matmul(const void* dense, const void* x, const void* tile_win,
                  const void* addend, void* out, int T, int tile, int W,
                  int N, int D, int dtype, int va, int vb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (va)
      return (int)win_matmul_tc_run<true>(dense, x, tile_win, addend, out, T,
                                          tile, W, N, D, s);
    return (int)win_matmul_tc_run<false>(dense, x, tile_win, addend, out, T,
                                         tile, W, N, D, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)win_matmul_f32_run(dense, x, tile_win, addend, out, T, tile, W,
                                 N, D, vb, s);
}

// out [T, tile, W] in out_dtype, the f32 sums rounded once; g [N, D] and
// x [N, D] share dtype. float32 inputs: va, vb are not read (both operands
// go by 4-byte copies); bfloat16 inputs (the tensor-core kernel): va != 0
// lets 16-byte-aligned row ranges of even D be staged by 16-byte copies.
int gx_win_bwd_dense(const void* g, const void* x, const void* tile_win,
                     void* out, int T, int tile, int W, int N, int D,
                     int dtype, int out_dtype, int va, int vb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (out_dtype == 0)
      return (int)bwd_dense_tc_launch<float>(g, x, tile_win, out, T, tile, W,
                                             N, D, va, s);
    if (out_dtype == 1)
      return (int)bwd_dense_tc_launch<bf16>(g, x, tile_win, out, T, tile, W,
                                            N, D, va, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    return (int)bwd_dense_f32_run<float>(g, x, tile_win, out, T, tile, W, N,
                                         D, s);
  if (out_dtype == 1)
    return (int)bwd_dense_f32_run<bf16>(g, x, tile_win, out, T, tile, W, N,
                                        D, s);
  return (int)cudaErrorInvalidValue;
}

// out [N, D] in out_dtype: the slab's gradient at its first N rows, the
// f32 sums rounded once; dense [T, tile, W] and g [N, D] share dtype;
// win_ptr [Wn+1] and win_tiles [T] int32 (the window -> tiles CSR).
// float32 inputs: va, vb the values per copy of the blocks' rows and of
// g's (and per store of out's) rows (4, 2 or 1: W, resp. D, and the
// pointers divide by it); bfloat16 inputs (the tensor-core kernel): va != 0
// takes the cp.async route (W % 8 == 0, D even, dense on 16 bytes, g on
// 4), else the element route.
int gx_win_bwd_slab(const void* dense, const void* g, const void* win_ptr,
                    const void* win_tiles, void* out, int Wn, int tile, int W,
                    int N, int D, int dtype, int out_dtype, int va, int vb,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (out_dtype == 0)
      return (int)(va ? win_bwd_slab_tc_run<float, true>(
                            dense, g, win_ptr, win_tiles, out, Wn, tile, W, N,
                            D, s)
                      : win_bwd_slab_tc_run<float, false>(
                            dense, g, win_ptr, win_tiles, out, Wn, tile, W, N,
                            D, s));
    if (out_dtype == 1)
      return (int)(va ? win_bwd_slab_tc_run<bf16, true>(
                            dense, g, win_ptr, win_tiles, out, Wn, tile, W, N,
                            D, s)
                      : win_bwd_slab_tc_run<bf16, false>(
                            dense, g, win_ptr, win_tiles, out, Wn, tile, W, N,
                            D, s));
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    return (int)bwd_slab_f32_run<float>(dense, g, win_ptr, win_tiles, out, Wn,
                                        tile, W, N, D, va, vb, s);
  if (out_dtype == 1)
    return (int)bwd_slab_f32_run<bf16>(dense, g, win_ptr, win_tiles, out, Wn,
                                       tile, W, N, D, va, vb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
