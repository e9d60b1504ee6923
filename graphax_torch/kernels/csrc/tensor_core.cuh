// Building blocks of the bf16 tensor-core kernels (the bf16 instantiations
// of win_matmul, win_bwd_dense, win_bwd_slab and attention_kproj):
// asynchronous 16-, 8- and 4-byte copies into shared memory (the 8-byte one
// also stages the CUDA-core K projection), mma.sync m16n8k16 (bf16 in, f32
// accumulators) from 32-bit shared loads (or ldmatrix, where the staged
// rows are 16-byte aligned), and streaming vector stores of the
// accumulators.
//
// Why mma.sync and not wgmma: the staged rows keep their device-memory
// layout (D = 162 bf16 rows are 324 bytes, not a multiple of 16, so
// neither TMA's 2-D descriptors nor wgmma's and ldmatrix's 16-byte-aligned
// shared layouts take them without a repack), and at these shapes the
// products take a few percent of the time the bytes need. mma.sync reads
// its operands from 32-bit shared loads of k pairs, which any even row
// pitch allows.
//
// Fragment layout of m16n8k16 (g = lane / 4, q = lane % 4):
//   A (row-major, 16 x 16): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..),
//                           a2 = (g, 2q+8..),   a3 = (g+8, 2q+8..)
//   B (col-major, 16 x 8):  b0 = (2q..2q+1, g), b1 = (2q+8.., g)
//   C (16 x 8, f32):        c0, c1 = (g, 2q..2q+1), c2, c3 = (g+8, 2q..)
// so A's rows and B's columns are both read as rows of k: one staged
// [rows][pitch] layout, k contiguous, serves either side.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gx_tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ bf16 bzero() {
  return __ushort_as_bfloat16((unsigned short)0);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
// 16 (8, 4) bytes, or zeros where !ok (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async8_zfill(void* dst, const void* src,
                                                bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, rows) x columns [k0, k0 + kc) of a row-major bf16 matrix with
// row pitch ld (src at row 0, column 0) into S [rows][P], column k0 at 0.
// When the rows are one contiguous, 16-byte-aligned byte range that S
// keeps as it is (vec, k0 == 0, kc == ld == P), whole 16-byte cp.async
// copies move it and element copies its last < 16 bytes; else element
// copies (odd widths, K chunks, misaligned views). A pad column (P > kc) is
// zeroed. The cp.async part lands at the next cp_async_wait.
__device__ __forceinline__ void stage_rows(bf16* S, const bf16* src, int rows,
                                           int ld, int k0, int kc, int P,
                                           bool vec, int tid, int nthreads) {
  if (vec && k0 == 0 && kc == ld && P == ld &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n = rows * ld, n16 = n >> 3;
    for (int i = tid; i < n16; i += nthreads) cp_async16(S + 8 * i, src + 8 * i);
    for (int i = (n16 << 3) + tid; i < n; i += nthreads) S[i] = src[i];
    return;
  }
  const int n = rows * kc;
  for (int i = tid; i < n; i += nthreads) {
    const int r = i / kc, c = i - r * kc;
    S[r * P + c] = src[(size_t)r * ld + k0 + c];
  }
  if (P > kc)
    for (int r = tid; r < rows; r += nthreads) S[r * P + kc] = bzero();
}

// zero rows [from, to) of S [.][P] (P even)
__device__ __forceinline__ void zero_rows(bf16* S, int from, int to, int P,
                                          int tid, int nthreads) {
  uint32_t* w = reinterpret_cast<uint32_t*>(S + from * P);
  const int n = (to - from) * P / 2;
  for (int i = tid; i < n; i += nthreads) w[i] = 0u;
}

// The m16 x k16 fragment of S [.][P] whose rows g and g+8 are this
// lane's staged rows r_lo and r_hi, columns kk..kk+15; k pairs at or past
// kvalid read as zero (a pair that starts below an odd kvalid holds the
// zeroed pad column).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* S, int P,
                                       int r_lo, int r_hi, int kk, int kvalid,
                                       int lane) {
  const int q = lane & 3;
  const bf16* p0 = S + r_lo * P + kk + 2 * q;
  const bf16* p1 = S + r_hi * P + kk + 2 * q;
  a[0] = lds32(p0);
  a[1] = lds32(p1);
  a[2] = lds32(p0 + 8);
  a[3] = lds32(p1 + 8);
  if (kk + 16 > kvalid) {
    if (kk + 2 * q >= kvalid) a[0] = a[1] = 0u;
    if (kk + 8 + 2 * q >= kvalid) a[2] = a[3] = 0u;
  }
}

// The k16 x n8 fragment whose column g is this lane's staged row r of S
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* S, int P, int r, int kk,
                                       int kvalid, int lane) {
  const int q = lane & 3;
  const bf16* p = S + r * P + kk + 2 * q;
  b0 = lds32(p);
  b1 = lds32(p + 8);
  if (kk + 16 > kvalid) {
    if (kk + 2 * q >= kvalid) b0 = 0u;
    if (kk + 8 + 2 * q >= kvalid) b1 = 0u;
  }
}

// Four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l & 7 of matrix l >> 3 (16-byte-aligned rows of 8 values). Plain:
// lane (g, q) gets row g, columns 2q, 2q+1 of each; trans: rows 2q, 2q+1
// of column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Two B fragments at once from S [.][P] with 16-byte-aligned rows (P a
// multiple of 8): columns n0 .. n0+15 of k16 at kk, b[0], b[1] of columns
// n0.., b[2], b[3] of columns n0+8.. (lane l gives row
// n0 + (l & 7) + 8 (l >> 4), k kk + 8 ((l >> 3) & 1)).
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const bf16* S, int P,
                                        int n0, int kk, int lane) {
  ldmatrix_x4(b, S + (n0 + (lane & 7) + 8 * (lane >> 4)) * P + kk +
                     8 * ((lane >> 3) & 1));
}

// The accumulator c (rows g, g+8; columns 2q, 2q+1) regrouped between lane
// pairs: v[0..3] = row g + dr, columns dc .. dc+3 of the 16 x 8 block.
__device__ __forceinline__ void quad(const float (&c)[4], int lane,
                                     float (&v)[4], int& dr, int& dc) {
  const bool odd = lane & 1;
  const float s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
  const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (odd) {
    v[0] = r0; v[1] = r1; v[2] = c[2]; v[3] = c[3];
  } else {
    v[0] = c[0]; v[1] = c[1]; v[2] = r0; v[3] = r1;
  }
  dr = odd ? 8 : 0;
  dc = 4 * ((lane & 3) >> 1);
}

// four consecutive outputs, streamed (evict-first): 16 bytes of f32 or
// 8 of bf16 (rounded to nearest even, as a cast of the f32 values)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), u);
}
// eight consecutive outputs: 2 x 16 bytes of f32 or 16 of bf16
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(v[4], v[5], v[6], v[7]));
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(p), u);
}
// two consecutive outputs: 8 bytes of f32 or 4 of bf16
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace gx_tc
