// Paged single-token decode attention, two variants from one template.
//
// Replaces the TPU kernels src/repro/kernels/flash_decode.py:
//   paged_decode_partials  (_paged_partials_kernel, _online_merge) -> NORMALIZE = false:
//       unnormalized fp32 o [B, H, D] and m, l [B, H] for the online-softmax merge;
//   paged_decode_attention (_paged_decode_kernel, _online_merge)   -> NORMALIZE = true:
//       o / max(l, 1e-30) at q's dtype.
// q [B, H, D]; k/v pools [NB, BS, KV, D]; block tables [B, MB] int32 (entries
// < 0 absent); lengths [B].  Token t of table entry e holds position
// e*BS + t and is masked at or past the slot's length.  Per pool block:
// scores = (q . k) / sqrt(D) in fp32, -1e30 where masked, the online-softmax
// rescale, P cast to V's dtype for P.V.  Absent entries and entries wholly
// past the length are skipped, as the TPU kernel skips their fold.
//
// What bounds it on an H100: bytes — every live K and V row is read once
// (2 * len * KV * D * 2 bytes per slot) against a handful of FLOPs per byte.
// Design: one block of 128 threads per (kv head, slot), walking the slot's
// table entries in order (the TPU grid's sequential innermost dimension
// becomes a loop inside the block).  Warps score one (query head, token)
// pair each with 4-wide loads and a shuffle reduction; every thread then
// applies the online-softmax update to its share of the D output dims with
// coalesced V row loads.  With B = 4 and 16 heads this is 64 blocks on 132
// SMs: the callers split long contexts across blocks through the partials
// variant (split-KV) and merge, which is how both variants run on the
// serving path.
#include "common.cuh"

constexpr int PD_THREADS = 128;
constexpr int PD_MAXG = 8;                     // query heads per kv head
constexpr int PD_MAXV = 16;                    // (G * D) / PD_THREADS upper bound

struct PDParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* lengths;
  void* o;      // NORMALIZE: [B, H, D] at dt; else fp32 [B, H, D]
  float* m;     // partials only: [B, H]
  float* l;
  int B, H, KV, D, BS, MB;
  int dt, vec;
  float sm_scale;
};

template <bool NORMALIZE>
__global__ void __launch_bounds__(PD_THREADS) paged_decode_kernel(const PDParams p) {
  extern __shared__ float smem[];
  const int G = p.H / p.KV, D = p.D, BS = p.BS;
  float* Qs = smem;            // [G][D]
  float* Ss = Qs + G * D;      // [G][BS]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = p.lengths[b];
  const bool round_p = p.dt == DT_BF16;

  for (int i = tid; i < G * D; i += PD_THREADS) {
    const int g = i / D, d = i % D;
    Qs[i] = ld_elem(p.q, ((int64_t)b * p.H + kvh * G + g) * D + d, p.dt);
  }

  float m[PD_MAXG], l[PD_MAXG], acc[PD_MAXV];
#pragma unroll
  for (int g = 0; g < PD_MAXG; ++g) {
    m[g] = NEG_INF_F;
    l[g] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < PD_MAXV; ++i) acc[i] = 0.f;

  for (int e = 0; e < p.MB; ++e) {
    const int t = p.tables[(int64_t)b * p.MB + e];
    if (t < 0 || e * BS >= len) continue;   // dead entry: no fold
    __syncthreads();                         // Qs ready / previous Ss consumed
    const int64_t blk = (int64_t)t * BS;
    for (int pr = warp; pr < G * BS; pr += PD_THREADS / 32) {
      const int g = pr / BS, tok = pr % BS;
      const int64_t krow = ((blk + tok) * p.KV + kvh) * D;
      const float* qg = Qs + g * D;
      float dot = 0.f;
      for (int c = lane * 4; c < D; c += 128) {
        const float4 k4 = p.vec ? ld4_aligned(p.k_pool, krow + c, p.dt)
                                : make_float4(ld_elem(p.k_pool, krow + c, p.dt),
                                              ld_elem(p.k_pool, krow + c + 1, p.dt),
                                              ld_elem(p.k_pool, krow + c + 2, p.dt),
                                              ld_elem(p.k_pool, krow + c + 3, p.dt));
        dot = fmaf(qg[c], k4.x, dot);
        dot = fmaf(qg[c + 1], k4.y, dot);
        dot = fmaf(qg[c + 2], k4.z, dot);
        dot = fmaf(qg[c + 3], k4.w, dot);
      }
      dot = warp_sum(dot);
      if (lane == 0) {
        const float s = dot * p.sm_scale;
        Ss[g * BS + tok] = (e * BS + tok < len) ? s : NEG_INF_F;
      }
    }
    __syncthreads();

    float corr[PD_MAXG], mnew[PD_MAXG];
#pragma unroll
    for (int g = 0; g < PD_MAXG; ++g) {
      if (g >= G) break;
      float mb = NEG_INF_F;
      for (int tok = 0; tok < BS; ++tok) mb = fmaxf(mb, Ss[g * BS + tok]);
      mnew[g] = fmaxf(m[g], mb);
      corr[g] = expf(m[g] - mnew[g]);
      float ps = 0.f;
      for (int tok = 0; tok < BS; ++tok) ps += expf(Ss[g * BS + tok] - mnew[g]);
      l[g] = l[g] * corr[g] + ps;
      m[g] = mnew[g];
    }
#pragma unroll
    for (int i = 0; i < PD_MAXV; ++i) {
      const int pi = tid + i * PD_THREADS;
      if (pi >= G * D) break;
      const int g = pi / D, d = pi % D;
      float a = acc[i] * corr[g];
      for (int tok = 0; tok < BS; ++tok) {
        float pw = expf(Ss[g * BS + tok] - mnew[g]);
        if (round_p) pw = round_bf16(pw);
        a = fmaf(pw, ld_elem(p.v_pool, ((blk + tok) * p.KV + kvh) * D + d, p.dt), a);
      }
      acc[i] = a;
    }
  }

#pragma unroll
  for (int i = 0; i < PD_MAXV; ++i) {
    const int pi = tid + i * PD_THREADS;
    if (pi >= G * D) break;
    const int g = pi / D, d = pi % D;
    const int64_t o = ((int64_t)b * p.H + kvh * G + g) * D + d;
    if (NORMALIZE)
      st_elem(p.o, o, p.dt, acc[i] / fmaxf(l[g], 1e-30f));
    else
      reinterpret_cast<float*>(p.o)[o] = acc[i];
  }
  if (!NORMALIZE && tid < G) {
    p.m[(int64_t)b * p.H + kvh * G + tid] = m[tid];
    p.l[(int64_t)b * p.H + kvh * G + tid] = l[tid];
  }
}

static int launch_paged(bool normalize, const PDParams& p, void* stream) {
  const int G = p.H / p.KV;
  if (G > PD_MAXG || G * p.D > PD_MAXV * PD_THREADS || p.D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(G * p.D + G * p.BS) * sizeof(float);
  dim3 grid(p.KV, p.B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (normalize) {
    e = cudaFuncSetAttribute(paged_decode_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    paged_decode_kernel<true><<<grid, PD_THREADS, smem, s>>>(p);
  } else {
    e = cudaFuncSetAttribute(paged_decode_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    paged_decode_kernel<false><<<grid, PD_THREADS, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_paged_decode_partials(const void* q, const void* k_pool,
                                           const void* v_pool, const int* tables,
                                           const int* lengths, float* o, float* m,
                                           float* l, int B, int H, int KV, int D,
                                           int BS, int MB, int dt, int vec,
                                           float sm_scale, void* stream) {
  PDParams p{q, k_pool, v_pool, tables, lengths, o, m, l,
             B, H, KV, D, BS, MB, dt, vec, sm_scale};
  return launch_paged(false, p, stream);
}

extern "C" int repro_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const int* tables,
                                            const int* lengths, void* o, int B,
                                            int H, int KV, int D, int BS, int MB,
                                            int dt, int vec, float sm_scale,
                                            void* stream) {
  PDParams p{q, k_pool, v_pool, tables, lengths, o, nullptr, nullptr,
             B, H, KV, D, BS, MB, dt, vec, sm_scale};
  return launch_paged(true, p, stream);
}
