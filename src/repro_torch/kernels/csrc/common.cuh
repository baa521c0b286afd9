// Shared device helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// element-type codes passed from the Python wrappers
enum DTypeCode { DT_F32 = 0, DT_BF16 = 1 };

#define NEG_INF_F (-1e30f)

__device__ __forceinline__ float ld_elem(const void* p, int64_t i, int dt) {
  return dt == DT_BF16
             ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
             : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_elem(void* p, int64_t i, int dt, float v) {
  if (dt == DT_BF16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// Four consecutive elements starting at index i (i % 4 == 0 and the base
// 16-byte aligned when `vec` is set: one 8-byte or 16-byte load).
__device__ __forceinline__ float4 ld4_aligned(const void* p, int64_t i, int dt) {
  if (dt == DT_BF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(p) + i);
    __nv_bfloat162 lo, hi;
    *reinterpret_cast<uint32_t*>(&lo) = u.x;
    *reinterpret_cast<uint32_t*>(&hi) = u.y;
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
}

// Elements [c, c+4) of row `r` of a row-major [rows, cols] matrix; zeros
// outside it.
__device__ __forceinline__ float4 ld4_row(const void* p, int r, int c, int rows,
                                          int cols, int dt, bool vec) {
  if (r >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t base = (int64_t)r * cols;
  if (vec && c + 3 < cols) return ld4_aligned(p, base + c, dt);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (c + j < cols) ? ld_elem(p, base + c + j, dt) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Eight bf16 values of a 16-byte load, element 0 in the low half of u.x.
__device__ __forceinline__ void unpack8(const uint4 u, float w[8]) {
  w[0] = __uint_as_float(u.x << 16);
  w[1] = __uint_as_float(u.x & 0xffff0000u);
  w[2] = __uint_as_float(u.y << 16);
  w[3] = __uint_as_float(u.y & 0xffff0000u);
  w[4] = __uint_as_float(u.z << 16);
  w[5] = __uint_as_float(u.z & 0xffff0000u);
  w[6] = __uint_as_float(u.w << 16);
  w[7] = __uint_as_float(u.w & 0xffff0000u);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Round through bf16 (the P tile is cast to V's dtype before P.V).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Single-token decode attention, shared by paged_decode.cu and
// decode_attention.cu: one block of DEC_THREADS threads owns one (slot, kv
// head) pair and its G = H / KV query heads, and folds the KV positions it
// walks chunk by chunk into online-softmax state (the TPU kernels'
// `_online_merge`): per chunk, scores = (q . k) / sqrt(D) in fp32, the
// running max / sum rescale, P cast to V's dtype for P.V.  Each chunk is a
// run of `n` consecutive valid positions (rows `row0 + t * stride`, t < n);
// the caller never hands over a masked position, so masked positions cost no
// bytes and contribute exactly the zero they contribute on the TPU.
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_MAXG = 8;                  // query heads per kv head
constexpr int DEC_MAXV = 16;                 // (G * D) / DEC_THREADS upper bound

// Shared memory of one block: Qs [G][D] fp32 queries, Ss [G][chunk] scores
// (overwritten by P), and the per-head statistics Ms / Ls and this chunk's
// rescale factor Cs, [G] each.
struct DecSmem {
  float* Qs;
  float* Ss;
  float* Ms;
  float* Ls;
  float* Cs;
};

__host__ __device__ inline size_t dec_smem_bytes(int G, int D, int chunk) {
  return (size_t)(G * D + G * chunk + 3 * G) * sizeof(float);
}

__device__ __forceinline__ DecSmem dec_smem(float* smem, int G, int D, int chunk) {
  DecSmem s;
  s.Qs = smem;
  s.Ss = s.Qs + G * D;
  s.Ms = s.Ss + G * chunk;
  s.Ls = s.Ms + G;
  s.Cs = s.Ls + G;
  return s;
}

// Load the block's G query rows (q[head0 .. head0 + G) of a [., D] tensor)
// and reset the state: m = -1e30, l = 0, acc = 0.
__device__ __forceinline__ void dec_begin(const DecSmem& sh, float acc[DEC_MAXV],
                                          const void* q, int64_t head0, int G,
                                          int D, int dt) {
  for (int i = threadIdx.x; i < G * D; i += DEC_THREADS)
    sh.Qs[i] = ld_elem(q, head0 * D + i, dt);
  if (threadIdx.x < G) {
    sh.Ms[threadIdx.x] = NEG_INF_F;
    sh.Ls[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DEC_MAXV; ++i) acc[i] = 0.f;
}

// Fold one chunk of n >= 1 valid positions into the state.
__device__ __forceinline__ void dec_fold(const DecSmem& sh, float acc[DEC_MAXV],
                                         const void* k, const void* v,
                                         int64_t row0, int64_t stride, int n,
                                         int G, int D, int dt, int vec,
                                         float sm_scale) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __syncthreads();                 // Qs / state ready, previous P consumed

  // scores: one warp per position, each K row read once for all G heads
  for (int t = warp; t < n; t += DEC_WARPS) {
    const int64_t krow = row0 + (int64_t)t * stride;
    float dot[DEC_MAXG];
#pragma unroll
    for (int g = 0; g < DEC_MAXG; ++g) dot[g] = 0.f;
    for (int c = lane * 4; c < D; c += 128) {
      const float4 k4 = vec ? ld4_aligned(k, krow + c, dt)
                            : make_float4(ld_elem(k, krow + c, dt),
                                          ld_elem(k, krow + c + 1, dt),
                                          ld_elem(k, krow + c + 2, dt),
                                          ld_elem(k, krow + c + 3, dt));
#pragma unroll
      for (int g = 0; g < DEC_MAXG; ++g) {
        if (g >= G) break;
        const float* qg = sh.Qs + g * D + c;
        float d = fmaf(qg[0], k4.x, dot[g]);
        d = fmaf(qg[1], k4.y, d);
        d = fmaf(qg[2], k4.z, d);
        dot[g] = fmaf(qg[3], k4.w, d);
      }
    }
#pragma unroll
    for (int g = 0; g < DEC_MAXG; ++g) {
      if (g >= G) break;
      const float s = warp_sum(dot[g]);
      if (lane == 0) sh.Ss[g * n + t] = s * sm_scale;
    }
  }
  __syncthreads();

  // statistics: one warp per query head; P replaces the scores in place
  for (int g = warp; g < G; g += DEC_WARPS) {
    float* sg = sh.Ss + g * n;
    float mb = NEG_INF_F;
    for (int t = lane; t < n; t += 32) mb = fmaxf(mb, sg[t]);
    mb = warp_max(mb);
    const float m_old = sh.Ms[g];
    const float m_new = fmaxf(m_old, mb);
    float ps = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float pw = expf(sg[t] - m_new);
      ps += pw;
      sg[t] = dt == DT_BF16 ? round_bf16(pw) : pw;
    }
    ps = warp_sum(ps);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      sh.Cs[g] = corr;
      sh.Ls[g] = sh.Ls[g] * corr + ps;
      sh.Ms[g] = m_new;
    }
  }
  __syncthreads();

  // P.V: each thread its (head, dim) outputs, V rows read coalesced
#pragma unroll
  for (int i = 0; i < DEC_MAXV; ++i) {
    const int pi = tid + i * DEC_THREADS;
    if (pi >= G * D) break;
    const int g = pi / D, d = pi % D;
    const float* pg = sh.Ss + g * n;
    float a = acc[i] * sh.Cs[g];
    for (int t = 0; t < n; ++t)
      a = fmaf(pg[t], ld_elem(v, row0 + (int64_t)t * stride + d, dt), a);
    acc[i] = a;
  }
}

// Write the state: NORMALIZE -> acc / max(l, 1e-30) at dt into o [., D];
// else the fp32 partials o (unnormalized) and m, l [.].
template <bool NORMALIZE>
__device__ __forceinline__ void dec_finish(const DecSmem& sh,
                                           const float acc[DEC_MAXV], void* o,
                                           float* m, float* l, int64_t head0,
                                           int G, int D, int dt) {
  const int tid = threadIdx.x;
  __syncthreads();                 // statistics of the last chunk visible
#pragma unroll
  for (int i = 0; i < DEC_MAXV; ++i) {
    const int pi = tid + i * DEC_THREADS;
    if (pi >= G * D) break;
    const int g = pi / D;
    const int64_t idx = head0 * D + pi;
    if (NORMALIZE)
      st_elem(o, idx, dt, acc[i] / fmaxf(sh.Ls[g], 1e-30f));
    else
      reinterpret_cast<float*>(o)[idx] = acc[i];
  }
  if (!NORMALIZE && tid < G) {
    m[head0 + tid] = sh.Ms[tid];
    l[head0 + tid] = sh.Ls[tid];
  }
}
