// The CSR row walk shared by the gathering kernels: spmm.cu (spmm_walk;
// sddmm_kernel's batch dot products), fused_attention.cu (the flash and
// attspmm walks; bwd_rows_kernel's batch dot products) and, for its
// segments of long rows, attention_pin.cu.
//
// A warp owns a row (or a segment of a long row) and takes its edges in
// batches of BATCH, each lane loading one edge's column (and weight) in one
// coalesced load. It then gathers the batch's x rows U at a time, all their
// vectors of a column chunk, before it multiplies any, each column and
// weight handed to the warp by __shfl_sync. A lane holds VPL load vectors
// of VB bytes of each row (the widest load that every row and the view
// allow: the host's gather_width), so one chunk is 32 VPL vectors.
// Products rnd(x w) are rounded once to the state type T (bf16 two at a
// time by one bf16x2 multiply, round to nearest even, which rounds the
// exact product of two bf16 values; f32 by __fmul_rn, never fused into the
// sum), and each column's f32 sum runs over the edges in order, whichever
// lane and load width hold it.
//
// Long rows: the host's `row_split_plan`
// (graphax_torch/kernels/fused_attention.py), int32 [long rows (nlong) |
// each one's first segment, then nseg (nlong + 1) | each segment's long row
// (nseg)]. A long row's segments cover its edges in order, `seg` edges
// each, the last one the rest. A warp walks each segment into f32 partial
// sums, and seg_combine adds a row's partials in segment order (no float
// atomics: the result does not depend on the schedule).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace gx_rows {

constexpr int BATCH = 32;  // edges a warp holds at once, one per lane
constexpr unsigned FULL = 0xffffffffu;

// one rounding to the state type T
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// a load of VB bytes of T: E values in W 32-bit words
template <typename T, int VB>
struct Vec {
  static constexpr int E = VB / (int)sizeof(T);
  static constexpr int W = VB < 4 ? 1 : VB / 4;
};

template <int VB>
__device__ __forceinline__ void ldv(const void* p, uint32_t* w) {
  if constexpr (VB == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (VB == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
}

template <typename T, int VB>
__device__ __forceinline__ void unpack(const uint32_t* w, float* f) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < Vec<T, VB>::W; ++i) f[i] = __uint_as_float(w[i]);
  } else if constexpr (VB == 2) {
    f[0] = __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < Vec<T, VB>::W; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// rnd(x * wt) for the E values of one gathered vector, wt a value of T
template <typename T, int VB>
__device__ __forceinline__ void products(const uint32_t* raw, float wt,
                                         float* p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VB >= 4) {
    const __nv_bfloat162 w2 = __float2bfloat162_rn(wt);
#pragma unroll
    for (int i = 0; i < Vec<T, VB>::W; ++i) {
      const __nv_bfloat162 pr =
          __hmul2(*reinterpret_cast<const __nv_bfloat162*>(raw + i), w2);
      p[2 * i] = __low2float(pr);
      p[2 * i + 1] = __high2float(pr);
    }
  } else {
    unpack<T, VB>(raw, p);
#pragma unroll
    for (int k = 0; k < Vec<T, VB>::E; ++k) p[k] = rnd<T>(__fmul_rn(p[k], wt));
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// E output values at element offset `off`: (add[off..] + v) in f32, then
// stored as f32 (otype 0) or bf16 (otype 1)
template <int E>
__device__ __forceinline__ void store_vec(void* out, int otype,
                                          const float* __restrict__ add,
                                          size_t off, float* v) {
  if (add != nullptr) {
    float a[E];
    if constexpr (E == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(add + off));
      a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
    } else if constexpr (E == 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(add + off));
      a[0] = t.x; a[1] = t.y;
    } else {
      a[0] = __ldg(add + off);
    }
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = a[k] + v[k];
  }
  if (otype == 0) {
    float* p = reinterpret_cast<float*>(out) + off;
    if constexpr (E == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (E == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
      *p = v[0];
    }
  } else {
    __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(out) + off;
    if constexpr (E == 4) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    } else if constexpr (E == 2) {
      *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
    } else {
      *p = __float2bfloat16(v[0]);
    }
  }
}

// zeroed sums of one chunk
template <int VPL, int E>
__device__ __forceinline__ void clear(float (&acc)[VPL][E]) {
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int k = 0; k < E; ++k) acc[v][k] = 0.f;
}

// the chunk [v0, v0 + 32 VPL) of vectors of one output row (element offset
// `row`), of nvec vectors in all
template <typename T, int VB, int VPL>
__device__ __forceinline__ void store_chunk(
    float (&acc)[VPL][Vec<T, VB>::E], void* out, int otype,
    const float* __restrict__ add, size_t row, int v0, int nvec, int lane) {
  constexpr int E = Vec<T, VB>::E;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int vi = v0 + v * 32 + lane;
    if (vi < nvec) store_vec<E>(out, otype, add, row + (size_t)vi * E, acc[v]);
  }
}

// U gathered rows of the batch at a time: raw[u] holds edge e0 + u's
// vectors of the chunk at v0 (lane j holds edge j's column)
template <typename T, int VB, int VPL, int U>
__device__ __forceinline__ void load_rows(
    uint32_t (&raw)[U][VPL][Vec<T, VB>::W], const T* __restrict__ x, int col,
    int e0, int cnt, int d, int v0, int nvec, int lane) {
  using V = Vec<T, VB>;
  const T* xl = x + (size_t)(v0 + lane) * V::E;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = __shfl_sync(FULL, col, (e0 + u) & 31);
    if (e0 + u < cnt) {
      const T* xr = xl + (size_t)c * d;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        if (v0 + v * 32 + lane < nvec) ldv<VB>(xr + v * 32 * V::E, raw[u][v]);
    }
  }
}

// acc += rnd(x[col] w) over the cnt edges of a batch, lane j holding edge
// j's column and weight (a value of T)
template <typename T, int VB, int VPL, int U>
__device__ __forceinline__ void gather(float (&acc)[VPL][Vec<T, VB>::E],
                                       const T* __restrict__ x, int col,
                                       float wl, int cnt, int d, int v0,
                                       int nvec, int lane) {
  using V = Vec<T, VB>;
  for (int e0 = 0; e0 < cnt; e0 += U) {
    uint32_t raw[U][VPL][V::W];
    load_rows<T, VB, VPL, U>(raw, x, col, e0, cnt, d, v0, nvec, lane);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float wt = __shfl_sync(FULL, wl, (e0 + u) & 31);
      if (e0 + u < cnt) {
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          float p[V::E];
          products<T, VB>(raw[u][v], wt, p);
#pragma unroll
          for (int k = 0; k < V::E; ++k) acc[v][k] += p[k];
        }
      }
    }
  }
}

// the U dot products of the x rows e0 .. e0 + U - 1 of a batch, from each
// lane's partials p: a warp sum of each (xor butterfly), lane e0 + u
// keeping row u's; 0 on the other lanes (a transposed butterfly, U - 1
// fewer shuffles, measured no faster: PERF.md)
template <int U>
__device__ __forceinline__ float row_dots(const float (&p)[U], int e0,
                                          int lane) {
  float mine = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float t = p[u];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(FULL, t, o);
    if (lane == e0 + u) mine = t;
  }
  return mine;
}

// lane j's g_r . x[col_j] in f32 over the cnt (<= BATCH) edges of a batch
// (lane j holding edge j's column; 0 on lanes past cnt): g_r's chunk of
// VPL vectors a lane in registers, the batch's x rows gathered U at a time
// (load_rows), each lane's partials over its vectors, row_dots per U rows;
// D past one chunk adds up in the lane's register
template <typename T, int VB, int VPL, int U>
__device__ __forceinline__ float batch_dots(const T* __restrict__ gr,
                                            const T* __restrict__ x, int col,
                                            int cnt, int d, int lane) {
  using V = Vec<T, VB>;
  float dot = 0.f;
  const int nvec = d / V::E;
  for (int v0 = 0; cnt > 0 && v0 < nvec; v0 += 32 * VPL) {
    float gs[VPL][V::E];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int vi = v0 + v * 32 + lane;
      uint32_t raw[V::W];
      if (vi < nvec) {
        ldv<VB>(gr + (size_t)vi * V::E, raw);
        unpack<T, VB>(raw, gs[v]);
      } else {
#pragma unroll
        for (int k = 0; k < V::E; ++k) gs[v][k] = 0.f;
      }
    }
    for (int e0 = 0; e0 < cnt; e0 += U) {
      uint32_t raw[U][VPL][V::W];
      load_rows<T, VB, VPL, U>(raw, x, col, e0, cnt, d, v0, nvec, lane);
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = 0.f;
        if (e0 + u < cnt) {   // the same for the whole warp
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            if (v0 + v * 32 + lane < nvec) {
              float f[V::E];
              unpack<T, VB>(raw[u][v], f);
#pragma unroll
              for (int k = 0; k < V::E; ++k) p[u] += f[k] * gs[v][k];
            }
          }
        }
      }
      dot += row_dots<U>(p, e0, lane);
    }
  }
  return dot;
}

// the segment j of a long row: its row r, edges [sb, se), the long row's
// index i in the plan
__device__ __forceinline__ void segment(const int* __restrict__ ptr,
                                        const int* __restrict__ plan,
                                        int nlong, int seg, int j, int& r,
                                        int& sb, int& se, int& i) {
  i = plan[2 * nlong + 1 + j];
  r = plan[i];
  sb = ptr[r] + (j - plan[nlong + i]) * seg;
  se = ptr[r + 1] - sb > seg ? sb + seg : ptr[r + 1];
}

// each long row (a warp each): the sum of its segments' partials [nseg, d]
// in segment order, after the addend `add` (or none), into out as f32
// (otype 0) or bf16 (otype 1); lanes over columns
static __global__ void seg_combine(const int* __restrict__ plan,
                                   const float* __restrict__ part,
                                   const float* __restrict__ add,
                                   void* __restrict__ out, int otype,
                                   int nlong, int d) {
  const int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= nlong) return;
  const int r = plan[i], p0 = plan[nlong + i], p1 = plan[nlong + i + 1];
  for (int c = lane; c < d; c += 32) {
    float s = 0.f;
    for (int j = p0; j < p1; ++j) s += part[(size_t)j * d + c];
    store_vec<1>(out, otype, add, (size_t)r * d + c, &s);
  }
}

}  // namespace gx_rows
