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
// becomes a loop inside the block); each live entry's valid tokens are one
// chunk of common.cuh's `dec_fold`, which decode_attention.cu shares: warps
// score one token each for all G query heads with 4-wide K loads and a
// shuffle reduction, one warp per head updates the statistics, and every
// thread applies the rescale to its share of the G x D outputs with
// coalesced V row loads.  With B = 4 and 16 heads this is 64 blocks on 132
// SMs: the callers split long contexts across blocks through the partials
// variant (split-KV) and merge, which is how both variants run on the
// serving path.
#include "common.cuh"

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
__global__ void __launch_bounds__(DEC_THREADS) paged_decode_kernel(const PDParams p) {
  extern __shared__ float smem[];
  const int G = p.H / p.KV, D = p.D, BS = p.BS;
  const DecSmem sh = dec_smem(smem, G, D, BS);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int len = p.lengths[b];
  const int64_t head0 = (int64_t)b * p.H + kvh * G;

  float acc[DEC_MAXV];
  dec_begin(sh, acc, p.q, head0, G, D, p.dt);
  for (int e = 0; e < p.MB; ++e) {
    const int t = p.tables[(int64_t)b * p.MB + e];
    if (t < 0 || e * BS >= len) continue;   // dead entry: no fold
    dec_fold(sh, acc, p.k_pool, p.v_pool, ((int64_t)t * BS * p.KV + kvh) * D,
             (int64_t)p.KV * D, min(BS, len - e * BS), G, D, p.dt, p.vec,
             p.sm_scale);
  }
  dec_finish<NORMALIZE>(sh, acc, p.o, p.m, p.l, head0, G, D, p.dt);
}

static int launch_paged(bool normalize, const PDParams& p, void* stream) {
  const int G = p.H / p.KV;
  if (G > DEC_MAXG || G * p.D > DEC_MAXV * DEC_THREADS || p.D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = dec_smem_bytes(G, p.D, p.BS);
  dim3 grid(p.KV, p.B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (normalize) {
    e = cudaFuncSetAttribute(paged_decode_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    paged_decode_kernel<true><<<grid, DEC_THREADS, smem, s>>>(p);
  } else {
    e = cudaFuncSetAttribute(paged_decode_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    paged_decode_kernel<false><<<grid, DEC_THREADS, smem, s>>>(p);
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
