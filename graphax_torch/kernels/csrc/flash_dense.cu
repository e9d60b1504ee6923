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
// the key blocks, and computes every (row, key) pair of every tile on the
// MXU; it streams the int8 mask so that the [N, N] scores never reach HBM.
//
// What bounds it on an H100: reading the [N, N] int8 mask once. That is
// the one thing the function must do (at Computers' N = 13,381: 179 MB,
// 0.053 ms at 3.35 TB/s); its arithmetic is that of the mask's set
// entries only, 2 H live (dk + D) operations (0.12 GFLOP there, with 6e-4
// of the entries set), and q, k, v and the [H, N, D] output are a few MB.
//
// Design: one warp per query row, all heads of a head group (up to 4, a
// launch's blockIdx.y; q of the row staged in shared memory, m, l and acc
// of every head in registers for the whole row). The warp streams the
// row's mask through a ring of NS = 8 spans in shared memory (a span is
// 512 columns, a 16-byte cp.async a lane, with an L2 evict-first policy
// so the mask does not push k and v out of L2), so 4 KB a warp are in
// flight whatever the warp is doing; a row need not start on 16 bytes:
// bytes outside the row are masked off. Each lane turns its 16 bytes into
// a bit mask of live keys, and the warp compacts the live columns in
// ascending order into a list in shared memory (ballot, popc, a warp
// prefix sum). Zero words, most of the mask, cost one OR and one ballot.
//
// Numerics, as graphax's kernel: the running max is updated once per
// group of KT = 64 keys (the 64-column tiles [64 g, 64 g + 64), the plain
// version's `block_k`); a group without a live key changes nothing (its
// update is exactly the identity), so only groups with live keys count.
// Per group g and head, with s = q . k over dk in f32,
//   m_g = max(m_{g-1}, max_g s), p = exp(s - m_g),
//   alpha_g = exp(m_{g-1} - m_g), l = l alpha_g + sum p,
//   acc = acc alpha_g + sum rnd(p) v,
// rnd() the rounding of p to v's dtype (graphax's p.astype(v.dtype),
// :50-51), products summed in f32. The keys are taken in batches of whole
// groups, at most 32 keys, one a lane (a sparse row's keys are one or two
// batches, not one dependent pass per group): all are scored at once, m_g
// is the prefix max of the batch's scores up to group g's last key (and
// the m carried in), and the alphas of the groups after g telescope to
// exp(m_g - m_last), so key j adds rnd(p_j) exp(m_g - m_last) v_j and l
// gains p_j exp(m_g - m_last): the same function, p rounded against the
// same m_g, f32 products rounded at another point. A group of more than 32
// keys goes alone, two keys a lane. Each live key's v row is read once for
// all heads (lane owns columns lane + 32 c). Finally out = acc / max(l,
// 1e-16) (:56-57) in v's dtype; a row without a live key has l = 0 and
// acc = 0, so it writes exactly 0. A group whose keys straddle two spans
// waits in the list until the next span completes it, and fewer than 32
// keys of whole groups wait for more, so the list holds at most one span
// and 94 keys: a hub row with every key live runs span by span. No tensor
// cores: after the compaction the work is a few hundred MFLOP, and f32
// stays full f32 on CUDA cores (graphax's f32 MXU passes keep f32
// precision; TF32 would not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int WARPS = 8;           // rows per block, one per warp
constexpr int KT = 64;             // keys per group of the running max
constexpr int SPAN = 32 * 16;      // mask columns of one warp-wide load
// a span's keys, a partial group and fewer than 32 keys of whole groups
constexpr int LIST = SPAN + KT + 32;
constexpr int NS = 8;              // spans in flight per warp
constexpr int HG = 4;              // heads per launch row (blockIdx.y)
constexpr int MAX_DK = 64;
// shared memory: each warp's span ring, q rows and key list
constexpr int RING_BYTES = WARPS * NS * SPAN;
constexpr int Q_BYTES = WARPS * HG * MAX_DK * 4;
constexpr int SMEM = RING_BYTES + Q_BYTES + WARPS * LIST * 4;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// bit b set iff byte b of x is nonzero (4 bits)
__device__ __forceinline__ unsigned nonzero4(unsigned x) {
  const unsigned hi = (x | ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu)) & 0x80808080u;
  return ((hi >> 7) * 0x01020408u) >> 24;
}

// bit b set iff byte b of the 16-byte word is nonzero
__device__ __forceinline__ unsigned live_bits(const uint4& w) {
  if ((w.x | w.y | w.z | w.w) == 0u) return 0u;
  return nonzero4(w.x) | (nonzero4(w.y) << 4) | (nonzero4(w.z) << 8) |
         (nonzero4(w.w) << 12);
}

// q, k [n, h, dk] f32 (q pre-scaled); v [n, d] in T; mask [n, n] uint8
// (nonzero = edge); out [h, n, d] in T. d <= 32 * CPL, dk <= MAX_DK; vec4:
// dk % 4 == 0 and q, k on 16 bytes (k rows read as float4).
template <typename T, int CPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_dense_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ mask,
                   T* __restrict__ out, int n, int h, int dk, int d,
                   int vec4) {
  extern __shared__ __align__(16) unsigned char smem_fd[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* ring = reinterpret_cast<uint4*>(smem_fd) + warp * NS * 32;
  float* qs = reinterpret_cast<float*>(smem_fd + RING_BYTES) +
              warp * HG * MAX_DK;
  int* list = reinterpret_cast<int*>(smem_fd + RING_BYTES + Q_BYTES) +
              warp * LIST;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= n) return;  // no block-wide barrier below
  const int h0 = blockIdx.y * HG, hn = min(HG, h - h0);

  // the row's mask as aligned 16-byte words; word wi covers columns
  // 16 wi - off .. 16 wi - off + 15. Span s (words 32 s .. 32 s + 31, a
  // word a lane) goes to ring slot s % NS by cp.async, NS spans ahead.
  const uint8_t* rp = mask + (size_t)row * n;
  const int off = (int)(reinterpret_cast<uintptr_t>(rp) & 15);
  const uint4* w16 = reinterpret_cast<const uint4*>(rp - off);
  const int nw = (off + n + 15) >> 4;
  const int nspan = (nw + 31) >> 5;
  // the mask is read once: evict it from L2 first, k and v stay
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(evict_first));
  auto fetch = [&](int s) {  // one cp.async group per span, empty past it
    const int wi = s * 32 + lane;
    if (s < nspan) {
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(ring + (s % NS) * 32 + lane);
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, "
          "%3;\n" ::"r"(dst),
          "l"(wi < nw ? w16 + wi : w16), "r"(wi < nw ? 16 : 0),
          "l"(evict_first));
    }
    gx_tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < NS; ++s) fetch(s);

  for (int i = lane; i < hn * dk; i += 32)
    qs[i] = q[((size_t)row * h + h0) * dk + i];
  __syncwarp();

  float m[HG], l[HG], acc[HG][CPL];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    m[hh] = NEG;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[hh][c] = 0.f;
  }

  // s[hh] = q[row, h0 + hh] . k[j, h0 + hh], or NEG where !live
  auto scores = [&](float (&sc)[HG], int j, bool live) {
    const float* kp = k + ((size_t)(live ? j : 0) * h + h0) * dk;
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      float a = 0.f;
      if (live && hh < hn) {
        const float* kr = kp + hh * dk;
        const float* qr = qs + hh * dk;
        if (vec4) {
          for (int c = 0; c < dk; c += 4) {
            const float4 kv = __ldg(reinterpret_cast<const float4*>(kr + c));
            const float4 qv = *reinterpret_cast<const float4*>(qr + c);
            a = fmaf(qv.x, kv.x, a);
            a = fmaf(qv.y, kv.y, a);
            a = fmaf(qv.z, kv.z, a);
            a = fmaf(qv.w, kv.w, a);
          }
        } else {
          for (int c = 0; c < dk; ++c) a = fmaf(qr[c], __ldg(kr + c), a);
        }
      }
      sc[hh] = live ? a : NEG;
    }
  };

  // A batch of whole groups, cnt <= 32 keys, key `key` with score sc on
  // each lane that takes part (`take`, the first cnt lanes); `floor` is a
  // lower bound of every group max (NEG, or the max of a group split in
  // two halves). Each group's running max m_g is the prefix max of the
  // scores up to the group's last key (and the carried m), and the alphas
  // of the groups after it telescope to exp(m_g - m_last).
  auto batch = [&](int cnt, int key, bool take, const float (&sc)[HG],
                   const float (&floor)[HG]) {
    const int g = key / KT;
    const int gn = __shfl_down_sync(FULL, g, 1);
    const unsigned ends =
        __ballot_sync(FULL, take && (lane == cnt - 1 || gn != g));
    const int e = take ? lane + __ffs(ends >> lane) - 1 : 0;  // group's end
    float w[HG];
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      float pm = sc[hh];  // prefix max over the batch's keys
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(FULL, pm, o);
        if (lane >= o) pm = fmaxf(pm, y);
      }
      const float base = fmaxf(m[hh], floor[hh]);
      const float mg = fmaxf(base, __shfl_sync(FULL, pm, e));
      const float ml = fmaxf(base, __shfl_sync(FULL, pm, cnt - 1));
      const float p = take ? expf(sc[hh] - mg) : 0.f;
      const float f = expf(mg - ml);
      const float alpha = expf(m[hh] - ml);
      l[hh] = l[hh] * alpha + warp_sum(p * f);
      m[hh] = ml;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[hh][c] *= alpha;
      w[hh] = rnd<T>(p) * f;
    }
    // acc += w v over the batch's keys, four v rows in flight
    for (int i = 0; i < cnt; i += 4) {
      float vv[4][CPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = i + u < cnt;
        const size_t j = (size_t)__shfl_sync(FULL, key, (i + u) & 31);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int col = lane + 32 * c;
          vv[u][c] = ok && col < d ? to_f(v[j * d + col]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i + u >= cnt) break;
#pragma unroll
        for (int hh = 0; hh < HG; ++hh) {
          const float wk = __shfl_sync(FULL, w[hh], i + u);
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[hh][c] = fmaf(wk, vv[u][c], acc[hh][c]);
        }
      }
    }
  };

  // the groups of list[0 .. len) that end below column `done`, in
  // batches of whole groups; the rest (one partial group, < KT keys)
  // moves to the front. Returns the new len.
  auto consume = [&](int len, int done) {
    float none[HG];
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) none[hh] = NEG;
    int pos = 0;
    while (pos < len && list[pos] < done) {
      const int key = pos + lane < len ? list[pos + lane] : INT_MAX;
      // a group that runs past these 32 keys waits for the next batch
      const int next = pos + 32 < len ? list[pos + 32] : INT_MAX;
      const int cut = next < done ? next / KT : INT_MAX;
      const bool take = key < done && key / KT < cut;
      const int cnt = __popc(__ballot_sync(FULL, take));
      float sc[HG];
      if (cnt > 0) {
        scores(sc, key, take);
        batch(cnt, key, take, sc, none);
        pos += cnt;
        continue;
      }
      // the first group holds 33 to 64 keys: its max over both halves,
      // then each half as a batch under that max
      const int end = (list[pos] / KT + 1) * KT;
      const int j1 = pos + 32 + lane < len ? list[pos + 32 + lane] : end;
      const bool in1 = j1 < end;
      const int c1 = __popc(__ballot_sync(FULL, in1));
      float s1[HG], gm[HG];
      scores(sc, key, true);
      scores(s1, j1, in1);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) gm[hh] = warp_max(fmaxf(sc[hh], s1[hh]));
      batch(32, key, true, sc, gm);
      batch(c1, j1, in1, s1, gm);
      pos += 32 + c1;
    }
    const int rest = len - pos;
    if (pos > 0 && rest > 0) {
      const int a = lane < rest ? list[pos + lane] : 0;
      const int b = lane + 32 < rest ? list[pos + 32 + lane] : 0;
      __syncwarp();
      if (lane < rest) list[lane] = a;
      if (lane + 32 < rest) list[lane + 32] = b;
    }
    __syncwarp();
    return rest;
  };

  int len = 0;
  for (int s = 0; s < nspan; ++s) {
    gx_tc::cp_async_wait<NS - 1>();  // this lane's word of span s is in
    const int c0 = (s * 32 + lane) * 16 - off;
    unsigned bits = live_bits(ring[(s % NS) * 32 + lane]);
    if (c0 < 0 || c0 + 16 > n) {  // bytes of the rows around this one
      const int lo = max(0, -c0), hi = max(0, min(16, n - c0));
      bits &= hi > lo ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u;
    }
    const bool any = __ballot_sync(FULL, bits != 0u) != 0u;
    fetch(s + NS);  // the slot is read: span s + NS into it
    // groups wholly scanned: below the span's end, rounded down to KT
    const bool last = s == nspan - 1;
    const int done = last ? n : ((s + 1) * SPAN - off) / KT * KT;
    int wait = 0;  // this span's keys at or past `done`
    if (any) {
      // compact the live columns, ascending, after the list's len keys
      const int cnt = __popc(bits);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int at = len + incl - cnt;
      while (bits) {
        const int col = c0 + __ffs(bits) - 1;
        list[at++] = col;
        wait += col >= done;
        bits &= bits - 1u;
      }
      len += __shfl_sync(FULL, incl, 31);
      wait = __reduce_add_sync(FULL, wait);
      __syncwarp();
    }
    // batches of 32 keys where there are that many, the rest at the end
    if (len > 0 && (last || len - wait >= 32)) len = consume(len, done);
  }
  gx_tc::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (hh >= hn) break;
    const float den = fmaxf(l[hh], 1e-16f);
    T* o = out + ((size_t)(h0 + hh) * n + row) * d;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) o[col] = from_f<T>(acc[hh][c] / den);
    }
  }
}

template <typename T, int CPL>
cudaError_t run(const void* q, const void* k, const void* v, const void* mask,
                void* out, int n, int h, int dk, int d, int vec4,
                cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {  // the opt-in above 48 KB, once
    cudaError_t err = cudaFuncSetAttribute(
        flash_dense_kernel<T, CPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((n + WARPS - 1) / WARPS, (h + HG - 1) / HG);
  flash_dense_kernel<T, CPL><<<grid, WARPS * 32, SMEM, s>>>(
      (const float*)q, (const float*)k, (const T*)v, (const uint8_t*)mask,
      (T*)out, n, h, dk, d, vec4);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* mask, void* out, int n, int h, int dk, int d,
                     int vec4, cudaStream_t s) {
  if (d <= 32) return run<T, 1>(q, k, v, mask, out, n, h, dk, d, vec4, s);
  if (d <= 64) return run<T, 2>(q, k, v, mask, out, n, h, dk, d, vec4, s);
  if (d <= 128) return run<T, 4>(q, k, v, mask, out, n, h, dk, d, vec4, s);
  if (d <= 256) return run<T, 8>(q, k, v, mask, out, n, h, dk, d, vec4, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k [n, h, dk] float32 (q pre-scaled by 1/sqrt(dk)); v [n, d] in the
// dtype (0 float32, 1 bfloat16); mask [n, n] uint8, nonzero = edge; out
// [h, n, d] in v's dtype. 1 <= dk <= 64, 1 <= d <= 256. vec4 != 0: dk is a
// multiple of 4 and q, k start on 16 bytes.
int gx_flash_dense(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int n, int h, int dk, int d,
                   int dtype, int vec4, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaSuccess;
  if (dk < 1 || dk > MAX_DK || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, mask, out, n, h, dk, d, vec4, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, mask, out, n, h, dk, d,
                                        vec4, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
