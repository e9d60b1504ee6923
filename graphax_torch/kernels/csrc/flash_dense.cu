// Masked flash attention on the dense strategy: per head,
// softmax_row(q k^T masked by the dense adjacency) v.
//
// Replaces graphax/kernels/pallas_ops.py `_flash_kernel` (:27), called by
// `flash_masked_attention` (:60) once per head from
// `flash_attention_multihead` (:111), which `dense_rhs_ax`
// (graphax/functions/transformer.py:217-232) runs on a dense graph for
// scaled_dot attention with row softmax. graphax's grid walks [256, 512]
// (row block, key block) tiles in order on one TPU core, carrying the
// running max m, denominator l and accumulator acc in VMEM scratch across
// the key blocks; it streams the int8 mask so that the [N, N] scores never
// reach HBM.
//
// Here one launch covers every (row tile, head) pair: blockIdx.x picks 64
// query rows, blockIdx.y the head. The key dimension, the TPU's sequential
// grid axis, is a loop inside the block: 64-key tiles of k (f32), v (as
// f32) and the int8 mask stream through shared memory, and each of the 8
// warps owns 8 rows, whose m, l and acc stay in registers for the whole
// walk (acc: lane owns columns lane + 32 c of D). Per tile and row:
//   s = q . k over dk in f32 (masked entries NEG = -1e30),
//   m' = max(m, max s), p = live ? exp(s - m') : 0, alpha = exp(m - m'),
//   l = l alpha + sum p, acc = acc alpha + sum rnd(p) v,
// with rnd() the rounding of p to v's dtype (graphax's p.astype(v.dtype),
// :50-51) and the products summed in f32; finally out = acc / max(l,
// 1e-16) (:56-57) in v's dtype. A row without an edge has l = 0 and acc =
// 0, so it writes exactly 0. Rows and keys past N (the last tile) are
// masked inside the kernel: nothing is padded.
//
// What bounds it: the dense work, H * 2 * N^2 * (dk + D) operations on f32
// CUDA cores (the mask's zeros are computed and discarded, as graphax's
// kernel does); its bytes (the N^2 mask, q, k, v once and the [H, N, D]
// output) are far below. Shared memory feeds every FMA: the scores loop
// over dk outermost with the k values of two keys in registers and the 8
// rows' q values broadcast, and the product reads 4 p values of a row in
// one broadcast float4. Tensor cores (wgmma on bf16 p and v) and TMA are
// left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;          // query rows per block
constexpr int WARPS = 8;          // warps per block
constexpr int RPW = ROWS / WARPS; // rows each warp owns
constexpr int KT = 64;            // keys per shared-memory tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// one rounding to v's dtype T
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

// q, k [n, h, dk] f32 (q pre-scaled); v [n, d] in T; mask [n, n] uint8
// (nonzero = edge); out [h, n, d] in T. d <= 32 * CPL.
template <typename T, int CPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_dense_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ mask,
                   T* __restrict__ out, int n, int h, int dk, int d) {
  extern __shared__ __align__(16) float smem[];
  const int dkp = dk + 1;                    // odd stride: no bank conflicts
  float* ps = smem;                          // [ROWS][KT] p of the tile
  float* vs = ps + ROWS * KT;                // [KT][d]
  float* qs = vs + KT * d;                   // [ROWS][dkp]
  float* ks = qs + ROWS * dkp;               // [KT][dkp]
  uint8_t* ms = (uint8_t*)(ks + KT * dkp);   // [ROWS][KT]

  const int head = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthreads = WARPS * 32;

  for (int i = tid; i < ROWS * dk; i += nthreads) {
    const int r = i / dk, c = i - r * dk, gr = row0 + r;
    qs[r * dkp + c] = gr < n ? q[((size_t)gr * h + head) * dk + c] : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][CPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[rr][c] = 0.f;
  }

  for (int kb = 0; kb < n; kb += KT) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < KT * dk; i += nthreads) {
      const int j = i / dk, c = i - j * dk, key = kb + j;
      ks[j * dkp + c] = key < n ? k[((size_t)key * h + head) * dk + c] : 0.f;
    }
    for (int i = tid; i < KT * d; i += nthreads) {
      const int j = i / d, key = kb + j;
      vs[i] = key < n ? to_f(v[(size_t)key * d + (i - j * d)]) : 0.f;
    }
    for (int i = tid; i < ROWS * KT; i += nthreads) {
      const int r = i / KT, key = kb + (i - r * KT), gr = row0 + r;
      ms[i] = (gr < n && key < n) ? mask[(size_t)gr * n + key] : 0;
    }
    __syncthreads();

    // scores of keys lane and lane + 32 for the warp's rows
    float s0[RPW], s1[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) s0[rr] = s1[rr] = 0.f;
    for (int c = 0; c < dk; ++c) {
      const float k0 = ks[lane * dkp + c], k1 = ks[(lane + 32) * dkp + c];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float qc = qs[(warp * RPW + rr) * dkp + c];
        s0[rr] = fmaf(qc, k0, s0[rr]);
        s1[rr] = fmaf(qc, k1, s1[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const bool live0 = ms[r * KT + lane] != 0;
      const bool live1 = ms[r * KT + lane + 32] != 0;
      const float a0 = live0 ? s0[rr] : NEG, a1 = live1 ? s1[rr] : NEG;
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(a0, a1)));
      const float p0 = live0 ? expf(a0 - m_new) : 0.f;
      const float p1 = live1 ? expf(a1 - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p0 + p1);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[rr][c] *= alpha;
      ps[r * KT + lane] = rnd<T>(p0);
      ps[r * KT + lane + 32] = rnd<T>(p1);
    }
    __syncwarp();

    // acc += p v over the tile's keys, four keys at a time
    for (int j = 0; j < KT; j += 4) {
      float vv[4][CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int col = lane + 32 * c;
          vv[u][c] = col < d ? vs[(j + u) * d + col] : 0.f;
        }
      }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + (warp * RPW + rr) * KT + j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float a = acc[rr][c];
          a = fmaf(p4.x, vv[0][c], a);
          a = fmaf(p4.y, vv[1][c], a);
          a = fmaf(p4.z, vv[2][c], a);
          a = fmaf(p4.w, vv[3][c], a);
          acc[rr][c] = a;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int gr = row0 + warp * RPW + rr;
    if (gr >= n) continue;
    const float den = fmaxf(l[rr], 1e-16f);
    T* o = out + ((size_t)head * n + gr) * d;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) o[col] = from_f<T>(acc[rr][c] / den);
    }
  }
}

template <typename T, int CPL>
cudaError_t run(const void* q, const void* k, const void* v, const void* mask,
                void* out, int n, int h, int dk, int d, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)ROWS * KT + (size_t)KT * d +
                                       (size_t)(ROWS + KT) * (dk + 1)) +
                      (size_t)ROWS * KT;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_dense_kernel<T, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + ROWS - 1) / ROWS, h);
  flash_dense_kernel<T, CPL><<<grid, WARPS * 32, smem, s>>>(
      (const float*)q, (const float*)k, (const T*)v, (const uint8_t*)mask,
      (T*)out, n, h, dk, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* mask, void* out, int n, int h, int dk, int d,
                     cudaStream_t s) {
  if (d <= 32) return run<T, 1>(q, k, v, mask, out, n, h, dk, d, s);
  if (d <= 64) return run<T, 2>(q, k, v, mask, out, n, h, dk, d, s);
  if (d <= 128) return run<T, 4>(q, k, v, mask, out, n, h, dk, d, s);
  if (d <= 256) return run<T, 8>(q, k, v, mask, out, n, h, dk, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k [n, h, dk] float32 (q pre-scaled by 1/sqrt(dk)); v [n, d] in the
// dtype (0 float32, 1 bfloat16); mask [n, n] uint8, nonzero = edge; out
// [h, n, d] in v's dtype. 1 <= dk <= 64, 1 <= d <= 256.
int gx_flash_dense(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int n, int h, int dk, int d,
                   int dtype, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaSuccess;
  if (dk < 1 || dk > 64 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)dispatch<float>(q, k, v, mask, out, n, h, dk, d, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, mask, out, n, h, dk, d, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
