// The windowed (block-dense) SpMM: densify once per forward, then a batched
// product of the dense per-tile blocks with the window slabs per solver
// evaluation, and its two backward products.
//
// Replaces graphax/kernels/pallas_windows.py:
//   `_densify_kernel` (:57)       -> densify_kernel
//   `_win_matmul_kernel` (:185)   -> win_matmul_tc_kernel (bf16),
//                                    win_matmul_kernel (f32)
//   `_win_bwd_dense_kernel` (:214)-> win_bwd_dense_tc_kernel (bf16),
//                                    win_bwd_dense_kernel (f32)
//   `_win_bwd_slab_kernel` (:243) -> win_bwd_slab_tc_kernel (bf16),
//                                    win_bwd_slab_kernel (f32)
//
// Layout (graphax_torch/kernels/windows.py): node rows fall into T tiles of
// `tile` rows; tile t reads window w = tile_win[t], the `W` consecutive
// nodes w*W .. w*W+W-1 (the "slab"; slab rows past N read as zero). The
// in-window edges of tile t form the dense block dense[t] in [tile, W].
//
// What bounds them on an H100: bytes. At the ogbn-arxiv shapes (T = 1323,
// tile 128, W 512, D 162, bf16) the blocks alone are 173 MB per pass, while
// 2*T*tile*W*D = 28 GFLOP is 0.03 ms at the bf16 tensor-core peak against
// 0.1 ms to read the blocks once. The three products are one tiled GEMM
// each, with A and B staged through shared memory; bf16 inputs go through
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators: bf16
// products are exact in f32, as on the MXU; the kernels below), f32 inputs
// through CUDA-core FMAs (the TPU's f32 MXU passes keep f32 precision;
// TF32 would not), the generic bodies below.
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
// - Staging (the f32 bodies): each operand is copied in runs along its
//   contiguous axis (16 bytes of the blocks, 2 values of a state row) into
//   shared memory laid out the same way, and the staged layout (row or
//   column major) absorbs the transposes of the two backward products. The next step's
//   loads are issued into registers before this step's products, and the
//   1-D grid puts the column chunks of one output block side by side, so
//   they share its A operand in L2 instead of reading it from HBM again.
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
// GFLOP (0.03 ms at the bf16 tensor-core peak). The generic body gave
// each CTA 64 columns of D, so D = 162 read every block 3 times (519 MB),
// wrote an f32 [Wn W, D] slab through a shared-memory epilogue, and the
// autograd Function sliced and cast it in a pass of its own. Design:
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
// shapes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // output rows per CTA
constexpr int BN = 64;         // output columns per CTA
constexpr int BK = 32;         // reduction depth per staged step
constexpr int THREADS = 256;   // 8 warps: 4 (rows) x 2 (columns) of 32x32
constexpr int PAD = 8;         // shared pitch padding (elements)
constexpr int LDC = BN + 4;    // shared row pitch of the f32 epilogue
// A is staged [BM][BK] or [BK][BM], B [BK][BN] or [BN][BK], whichever
// keeps each operand's contiguous axis contiguous in shared memory
constexpr int A_ELEMS = (BM * (BK + PAD)) > (BK * (BM + PAD))
                            ? BM * (BK + PAD) : BK * (BM + PAD);
constexpr int B_ELEMS = (BK * (BN + PAD)) > (BN * (BK + PAD))
                            ? BK * (BN + PAD) : BN * (BK + PAD);
constexpr int SMEM_AB_F32 = (A_ELEMS + B_ELEMS) * 4;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_C > SMEM_AB_F32 ? SMEM_C : SMEM_AB_F32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Copy VEC consecutive elements in one load or store where VEC elements
// make 4, 8 or 16 bytes (both pointers aligned to that size).
template <typename T, int VEC>
__device__ __forceinline__ void copy_vec(T* dst, const T* src) {
  constexpr int BYTES = VEC * sizeof(T);
  if constexpr (BYTES == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = src[j];
  }
}

// One SR x SC operand tile on its way from device memory to shared memory
// (S[r * (SC + PAD) + c]), held in registers in between so that the next
// step's loads are in flight while this step's products run. Each thread
// moves NV runs of VEC elements along c, contiguous in device memory and in
// shared memory. fetch(step, r, c, v) fills the run at (r, c) or zeros
// when it lies outside the operand (a run never straddles the operand's
// edge: the wrapper takes VEC > 1 only where the extent divides by it).
template <typename T, int VEC, int SR, int SC>
struct Staged {
  static constexpr int NV = SR * SC / VEC / THREADS;
  static_assert(NV * VEC * THREADS == SR * SC, "tile must split evenly");
  T buf[NV][VEC];

  __device__ __forceinline__ static void pos(int p, int& r, int& c) {
    const int i = threadIdx.x + p * THREADS;
    r = i / (SC / VEC);
    c = (i % (SC / VEC)) * VEC;
  }
  template <typename F>
  __device__ __forceinline__ void load(F fetch, int step) {
#pragma unroll
    for (int p = 0; p < NV; ++p) {
      int r, c;
      pos(p, r, c);
      fetch(step, r, c, buf[p]);
    }
  }
  __device__ __forceinline__ void store(T* S) const {
#pragma unroll
    for (int p = 0; p < NV; ++p) {
      int r, c;
      pos(p, r, c);
      copy_vec<T, VEC>(S + r * (SC + PAD) + c, buf[p]);
    }
  }
};

// fetch helper: VEC values at p, or zeros
template <typename T, int VEC>
__device__ __forceinline__ void fetch_or_zero(bool ok, const T* p, T* v) {
  if (ok) {
    copy_vec<T, VEC>(v, p);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = from_f<T>(0.f);
  }
}

// Per-thread share of the CTA's BM x BN f32 accumulator of the f32
// products (CUDA-core FMAs; the bf16 products run the tensor-core kernels).
// mma() adds A[BM x BK] @ B[BK x BN] from shared memory, A staged [m][k]
// (A_MK) or [k][m], B staged [k][n] (B_KN) or [n][k].
template <typename T> struct Accum;

template <> struct Accum<float> {
  float r[8][4];  // rows ty*8 + i, columns tx*4 + j

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) r[i][j] = 0.f;
  }
  template <bool A_MK, bool B_KN>
  __device__ __forceinline__ void mma(const float* As, const float* Bs) {
    constexpr int lda = A_MK ? BK + PAD : BM + PAD;
    constexpr int ldb = B_KN ? BN + PAD : BK + PAD;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty * 8 + i;
        a[i] = As[A_MK ? m * lda + k : k * lda + m];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx * 4 + j;
        b[j] = Bs[B_KN ? k * ldb + n : n * ldb + k];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) r[i][j] = fmaf(a[i], b[j], r[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * LDC + tx * 4 + j] = r[i][j];
  }
};

// The CTA's accumulator through shared memory to out[row(m), col(n)] for
// m < m_lim, n < n_lim (put(m, n, v) does the guarded store).
template <typename T, typename P>
__device__ __forceinline__ void epilogue(Accum<T>& acc, float* Cs, P put) {
  __syncthreads();  // the last staged tiles share Cs's memory
  acc.store(Cs);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int m = i / BN, n = i % BN;
    put(m, n, Cs[m * LDC + n]);
  }
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

// The staged GEMM of one CTA: acc += A @ B over `steps` steps of BK, the
// operands staged by fa / fb (SA, SB: their Staged tiles, laid out as
// A_MK / B_KN say), the next step's loads issued before this step's
// products.
template <typename T, bool A_MK, bool B_KN, int VA, int VB, typename FA,
          typename FB>
__device__ __forceinline__ void gemm_steps(Accum<T>& acc, T* As, T* Bs,
                                           int steps, FA fa, FB fb) {
  Staged<T, VA, A_MK ? BM : BK, A_MK ? BK : BM> sa;
  Staged<T, VB, B_KN ? BK : BN, B_KN ? BN : BK> sb;
  if (steps > 0) {
    sa.load(fa, 0);
    sb.load(fb, 0);
  }
  for (int s = 0; s < steps; ++s) {
    sa.store(As);
    sb.store(Bs);
    __syncthreads();
    if (s + 1 < steps) {
      sa.load(fa, s + 1);
      sb.load(fb, s + 1);
    }
    acc.template mma<A_MK, B_KN>(As, Bs);
    __syncthreads();
  }
}

// The CTA of a flat 1-D grid: column chunk fastest, so the chunks of one
// output row block run side by side and share its A operand in L2.
__device__ __forceinline__ void cta_coords(int nchunks, int mblocks, int& b,
                                           int& m0, int& n0) {
  const int i = blockIdx.x;
  n0 = (i % nchunks) * BN;
  m0 = ((i / nchunks) % mblocks) * BM;
  b = i / nchunks / mblocks;
}

// out[t*tile + r, :] = dense[t, r, :] @ slab[tile_win[t]] summed in f32,
// plus addend[t*tile + r, :], rounded once to T (the windowed SpMM's
// residual, added in the epilogue instead of three elementwise passes over
// [N, D]): the f32 instantiation (CUDA-core FMAs, no TF32; bf16 runs
// win_matmul_tc_kernel). A [m][k] = dense[t] rows (runs of VA along W),
// B [k][n] = slab rows (runs of VB along D).
template <typename T, int VA, int VB>
__global__ void __launch_bounds__(THREADS)
win_matmul_kernel(const T* __restrict__ dense, const T* __restrict__ x,
                  const int* __restrict__ tile_win,
                  const T* __restrict__ addend, T* __restrict__ out,
                  int tile, int W, int N, int D) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + A_ELEMS;
  int t, m0, n0;
  cta_coords((D + BN - 1) / BN, (tile + BM - 1) / BM, t, m0, n0);
  const long long base = (long long)tile_win[t] * W;  // first slab row
  const T* A = dense + (size_t)t * tile * W;
  Accum<T> acc;
  acc.zero();
  gemm_steps<T, true, true, VA, VB>(
      acc, As, Bs, (W + BK - 1) / BK,
      [&](int s, int m, int k, T* v) {
        const int r = m0 + m, c = s * BK + k;
        fetch_or_zero<T, VA>(r < tile && c < W, A + (size_t)r * W + c, v);
      },
      [&](int s, int k, int n, T* v) {
        const long long node = base + s * BK + k;
        const int c = n0 + n;
        fetch_or_zero<T, VB>(s * BK + k < W && node < N && c < D,
                             x + node * D + c, v);
      });
  epilogue(acc, reinterpret_cast<float*>(smem), [&](int m, int n, float v) {
    const long long row = (long long)t * tile + m0 + m;
    const int c = n0 + n;
    if (m0 + m < tile && row < N && c < D)
      out[row * D + c] = from_f<T>(v + to_f(addend[row * D + c]));
  });
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

// d_dense[t, r, k] = g[t*tile + r, :] . slab[tile_win[t]][k, :] summed in
// f32, rounded once to TO: the f32 instantiation (CUDA-core FMAs, no TF32).
// A [m][d] = g rows (runs of VA along D), B staged [n][d] = slab rows
// (runs of VB along D)
template <typename T, typename TO, int VA, int VB>
__global__ void __launch_bounds__(THREADS)
win_bwd_dense_kernel(const T* __restrict__ g, const T* __restrict__ x,
                     const int* __restrict__ tile_win, TO* __restrict__ out,
                     int tile, int W, int N, int D) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + A_ELEMS;
  int t, m0, n0;
  cta_coords((W + BN - 1) / BN, (tile + BM - 1) / BM, t, m0, n0);
  const long long row0 = (long long)t * tile;         // first node of tile t
  const long long base = (long long)tile_win[t] * W;  // first slab row
  Accum<T> acc;
  acc.zero();
  gemm_steps<T, true, false, VA, VB>(
      acc, As, Bs, (D + BK - 1) / BK,
      [&](int s, int m, int k, T* v) {
        const int r = m0 + m, c = s * BK + k;
        fetch_or_zero<T, VA>(r < tile && row0 + r < N && c < D,
                             g + (row0 + r) * D + c, v);
      },
      [&](int s, int n, int k, T* v) {
        const int j = n0 + n, c = s * BK + k;
        fetch_or_zero<T, VB>(j < W && base + j < N && c < D,
                             x + (base + j) * D + c, v);
      });
  epilogue(acc, reinterpret_cast<float*>(smem), [&](int m, int n, float v) {
    const int r = m0 + m, j = n0 + n;
    if (r < tile && j < W) out[((size_t)t * tile + r) * W + j] = from_f<TO>(v);
  });
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

// dx[w*W + k, :] = sum over tiles t with tile_win[t] == w of
//                  sum_r dense[t, r, k] * g[t*tile + r, :]   (f32 sums)
// for the slab rows w*W + k < N, rounded once to TO: the f32
// instantiation (CUDA-core FMAs, no TF32; bf16 runs win_bwd_slab_tc_kernel).
// A staged [r][k] = dense[t] rows (runs of VA along W), B [r][n] = g rows
// (runs of VB along D). The steps walk the window's tiles from the
// window -> tiles CSR, tile rows in BK chunks within each.
template <typename T, typename TO, int VA, int VB>
__global__ void __launch_bounds__(THREADS)
win_bwd_slab_kernel(const T* __restrict__ dense, const T* __restrict__ g,
                    const int* __restrict__ win_ptr,
                    const int* __restrict__ win_tiles,
                    TO* __restrict__ out, int tile, int W, int N, int D) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + A_ELEMS;
  int w, m0, n0;
  cta_coords((D + BN - 1) / BN, (W + BM - 1) / BM, w, m0, n0);
  const int beg = win_ptr[w];
  const int ksteps = (tile + BK - 1) / BK;
  Accum<T> acc;
  acc.zero();
  gemm_steps<T, false, true, VA, VB>(
      acc, As, Bs, (win_ptr[w + 1] - beg) * ksteps,
      [&](int s, int k, int m, T* v) {
        const int t = win_tiles[beg + s / ksteps];
        const int r = (s % ksteps) * BK + k, c = m0 + m;
        fetch_or_zero<T, VA>(r < tile && c < W,
                             dense + ((size_t)t * tile + r) * W + c, v);
      },
      [&](int s, int k, int n, T* v) {
        const long long t = win_tiles[beg + s / ksteps];
        const int r = (s % ksteps) * BK + k, c = n0 + n;
        fetch_or_zero<T, VB>(r < tile && t * tile + r < N && c < D,
                             g + (t * tile + r) * D + c, v);
      });
  epilogue(acc, reinterpret_cast<float*>(smem), [&](int m, int n, float v) {
    const int k = m0 + m, c = n0 + n;
    const long long row = (long long)w * W + k;
    if (k < W && row < N && c < D) out[row * D + c] = from_f<TO>(v);
  });
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

// The three products take va, vb: the run length of A's and B's staged
// loads. A runs along W (the blocks) take 16 bytes or 1 value; A runs
// along D (g in win_bwd_dense) and every B run (along D) take 2 values or
// 1. The wrapper picks the longer run where the extent divides by it and
// the pointer is aligned to it.

template <template <typename, int, int> class K, typename T, int VAW,
          typename... Args>
cudaError_t launch_gemm(int blocks, int va, int vb, cudaStream_t s,
                        Args... args) {
  if (va == VAW && vb == 2)
    K<T, VAW, 2>::run(blocks, s, args...);
  else if (va == VAW && vb == 1)
    K<T, VAW, 1>::run(blocks, s, args...);
  else if (va == 1 && vb == 2)
    K<T, 1, 2>::run(blocks, s, args...);
  else if (va == 1 && vb == 1)
    K<T, 1, 1>::run(blocks, s, args...);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T, int VA, int VB> struct MatmulK {
  static void run(int blocks, cudaStream_t s, const void* dense,
                  const void* x, const void* tile_win, const void* addend,
                  void* out, int tile, int W, int N, int D) {
    win_matmul_kernel<T, VA, VB><<<blocks, THREADS, 0, s>>>(
        (const T*)dense, (const T*)x, (const int*)tile_win, (const T*)addend,
        (T*)out, tile, W, N, D);
  }
};
template <typename TO> struct BwdDense {
  template <typename T, int VA, int VB> struct K {
    static void run(int blocks, cudaStream_t s, const void* g, const void* x,
                    const void* tile_win, void* out, int tile, int W, int N,
                    int D) {
      win_bwd_dense_kernel<T, TO, VA, VB><<<blocks, THREADS, 0, s>>>(
          (const T*)g, (const T*)x, (const int*)tile_win, (TO*)out, tile,
          W, N, D);
    }
  };
};
template <typename TO> struct BwdSlab {
  template <typename T, int VA, int VB> struct K {
    static void run(int blocks, cudaStream_t s, const void* dense,
                    const void* g, const void* win_ptr,
                    const void* win_tiles, void* out, int tile, int W, int N,
                    int D) {
      win_bwd_slab_kernel<T, TO, VA, VB><<<blocks, THREADS, 0, s>>>(
          (const T*)dense, (const T*)g, (const int*)win_ptr,
          (const int*)win_tiles, (TO*)out, tile, W, N, D);
    }
  };
};

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
// float32: va, vb the staged run lengths; bfloat16 (the tensor-core
// kernel): va != 0 takes the cp.async route (W % 8 == 0, D even, dense on
// 16 bytes, x and addend on 4), else the element route.
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
  const int blocks = T * ((tile + BM - 1) / BM) * ((D + BN - 1) / BN);
  if (blocks <= 0) return (int)cudaSuccess;
  return (int)launch_gemm<MatmulK, float, 4>(blocks, va, vb, s, dense, x,
                                             tile_win, addend, out, tile, W,
                                             N, D);
}

// out [T, tile, W] in out_dtype, the f32 sums rounded once; g [N, D] and
// x [N, D] share dtype. float32 inputs: va, vb the staged run lengths;
// bfloat16 inputs (the tensor-core kernel): va != 0 lets 16-byte-aligned
// row ranges of even D be staged by 16-byte copies.
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
  const int blocks = T * ((tile + BM - 1) / BM) * ((W + BN - 1) / BN);
  if (blocks <= 0) return (int)cudaSuccess;
  if (out_dtype == 0)
    return (int)launch_gemm<BwdDense<float>::K, float, 2>(
        blocks, va, vb, s, g, x, tile_win, out, tile, W, N, D);
  if (out_dtype == 1)
    return (int)launch_gemm<BwdDense<bf16>::K, float, 2>(
        blocks, va, vb, s, g, x, tile_win, out, tile, W, N, D);
  return (int)cudaErrorInvalidValue;
}

// out [N, D] in out_dtype: the slab's gradient at its first N rows, the
// f32 sums rounded once; dense [T, tile, W] and g [N, D] share dtype;
// win_ptr [Wn+1] and win_tiles [T] int32 (the window -> tiles CSR).
// float32 inputs: va, vb the staged run lengths; bfloat16 inputs (the
// tensor-core kernel): va != 0 takes the cp.async route (W % 8 == 0, D
// even, dense on 16 bytes, g on 4), else the element route.
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
  const int blocks = Wn * ((W + BM - 1) / BM) * ((D + BN - 1) / BN);
  if (blocks <= 0) return (int)cudaSuccess;
  if (out_dtype == 0)
    return (int)launch_gemm<BwdSlab<float>::K, float, 4>(
        blocks, va, vb, s, dense, g, win_ptr, win_tiles, out, tile, W, N, D);
  if (out_dtype == 1)
    return (int)launch_gemm<BwdSlab<bf16>::K, float, 4>(
        blocks, va, vb, s, dense, g, win_ptr, win_tiles, out, tile, W, N, D);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
