// Paged single-token decode attention: one fold kernel and one merge kernel.
// Pools of bf16 or fp32 (q's dtype), or of int8 with fp32 scales (below).
//
// Replaces the TPU kernels src/repro/kernels/flash_decode.py:
//   paged_decode_partials  (_paged_partials_kernel, _online_merge) -> paged_decode_kernel:
//       unnormalized fp32 o [S, B, H, D] and m, l [S, B, H] for the online-softmax
//       merge, one set per split of the table (S = 1: the TPU kernel's shapes);
//   paged_decode_attention (_paged_decode_kernel, _online_merge)   -> paged_decode_kernel
//       then dec_merge_kernel, at every split count (one included):
//       o / max(l, 1e-30) at q's dtype.
// q [B, H, D]; k/v pools [NB, BS, KV, D]; block tables [B, MB] int32 (entries
// < 0 absent); lengths [B].  Token t of table entry e holds position
// e*BS + t and is masked at or past the slot's length.  Per pool block (the
// TPU kernel's fold, and the plain version's): scores = (q . k) / sqrt(D) in
// fp32, the online-softmax rescale, P cast to V's dtype for P.V (int8
// pools, the TPU kernel's `quantized` fold: k_scale[block, h] on the scores
// after sm_scale, P in fp32, v_scale[block, h] on the page's P.V).  Absent
// entries and entries wholly past the length are skipped, as the TPU kernel
// skips their fold.  Split z walks the contiguous entry range
// [z * per, (z + 1) * per), per = ceil(MB / S).
//
// What bounds it on an H100: bytes — every live K and V row is read once
// (2 * len * KV * D * 2 bytes per slot; int8 pools half that, plus a scale
// a block and kv head) against a handful of FLOPs per byte.
// Design: grid (kv head, slot, split), 256 threads, through the stage ring
// of decode_fold.cuh: the block first compacts its range's live entries
// (one warp ballot per 32 entries) into a list in shared memory, then keeps
// DF_STAGES stages of pages in flight with 16-byte cp.async, a stage holding
// whole K and V pages, max(BS, 32) tokens, only the valid rows of a page
// copied, and folds each stage with a rescale per page.  The engine's block
// size (PD_COMPILED_BS) is compiled into the fold, so that its divisions
// by the block size become shifts; every other block size runs the same
// fold with the size read at run time.  The split count
// (kernels/flash_decode.py:paged_splits: two blocks an SM over the (kv head,
// slot) grid, at least the serving path's one split per 256 positions of
// the longest slot) spreads the pages over the card; dec_merge_kernel then
// folds the splits' partials into the normalized output at q's dtype in one
// launch.  The normalized entry point launches both kernels itself, so one
// verified fold serves every shape.
#include "decode_fold.cuh"

constexpr int PD_COMPILED_BS = 16;  // the engine's default pool block size

struct PDParams {
  DecFold f;
  const int* tables;   // [B, MB]
  const int* lengths;  // [B]
  int BS, MB, per;
};

// shared memory: the fold's, then the live list: entry and pool block,
// [per] each
__host__ __device__ inline size_t pd_smem_bytes(int G, int D, int BS, int per, int esize) {
  return df_smem_bytes(G, D, BS, esize, (size_t)2 * per * sizeof(int));
}

template <typename T, int kBS, int kG>
__global__ void __launch_bounds__(DF_THREADS) paged_decode_kernel(const PDParams p) {
  extern __shared__ __align__(16) uint8_t pd_smem[];
  __shared__ int nlive_sh;
  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int e0 = z * p.per;
  int* ents = reinterpret_cast<int*>(
      pd_smem + df_smem_bytes(p.f.H / p.f.KV, p.f.D, p.BS, sizeof(T), 0));
  PagedRows<kBS> rows{p.tables + (int64_t)b * p.MB, p.BS, p.lengths[b], e0,
                      min(p.MB, e0 + p.per), ents, ents + p.per, &nlive_sh};
  dec_fold<T, kG>(p.f, rows, pd_smem, kvh, b, z);
}

template <typename T, int kBS, int kG>
static cudaError_t launch_paged_t(const PDParams& p, int splits, size_t smem, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T, kBS, kG>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               DF_SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  dim3 grid(p.f.KV, p.f.B, splits);
  paged_decode_kernel<T, kBS, kG><<<grid, DF_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// the serving engine's block size runs a fold with it compiled in; the
// head capacity is 8, or 16 above 8 query heads a kv head
template <typename T, int kG>
static cudaError_t launch_paged_g(const PDParams& p, int splits, size_t smem,
                                  cudaStream_t s) {
  return p.BS == PD_COMPILED_BS ? launch_paged_t<T, PD_COMPILED_BS, kG>(p, splits, smem, s)
                                : launch_paged_t<T, 0, kG>(p, splits, smem, s);
}
template <typename T>
static cudaError_t launch_paged_bs(const PDParams& p, int splits, size_t smem,
                                   cudaStream_t s) {
  return df_wide(p.f.H, p.f.KV) ? launch_paged_g<T, DF_MAXG>(p, splits, smem, s)
                                : launch_paged_g<T, DF_WARPS>(p, splits, smem, s);
}

// dt: the pools' dtype; q_dt: q's (and the normalized output's).  bf16 and
// fp32 pools are at q's dtype; int8 pools take their scales ks / vs.
static int launch_paged(const PDParams& p, int splits, int dt, int q_dt, void* stream) {
  const int esize = dt == DT_I8 ? 1 : dt == DT_BF16 ? 2 : 4;
  const bool pools_ok = dt == DT_I8 ? (p.f.ks && p.f.vs && q_dt != DT_I8)
                                    : (!p.f.ks && !p.f.vs && q_dt == dt);
  if (!pools_ok || !df_shape_ok(p.f.H, p.f.KV, p.f.D, esize, p.f.k, p.f.v, p.f.o) ||
      splits < 1 || p.per < 1 || (int64_t)p.per * splits < p.MB)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pd_smem_bytes(p.f.H / p.f.KV, p.f.D, p.BS, p.per, esize);
  if (smem > DF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dt == DT_I8) return (int)launch_paged_bs<int8_t>(p, splits, smem, s);
  return (int)(dt == DT_BF16 ? launch_paged_bs<__nv_bfloat16>(p, splits, smem, s)
                             : launch_paged_bs<float>(p, splits, smem, s));
}

extern "C" int repro_paged_decode_partials(const void* q, const void* k_pool,
                                           const void* v_pool, const float* ks,
                                           const float* vs, const int* tables,
                                           const int* lengths, float* o, float* m,
                                           float* l, int B, int H, int KV, int D,
                                           int BS, int MB, int splits, int dt, int q_dt,
                                           float sm_scale, void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const int per = (MB + splits - 1) / splits;
  PDParams p{{q, k_pool, v_pool, o, m, l, B, H, KV, D, sm_scale, ks, vs, q_dt}, tables,
             lengths, BS, MB, per};
  return launch_paged(p, splits, dt, q_dt, stream);
}

// The normalized entry point: the partials of `splits` ranges (one or more)
// go to the caller's scratch (o_part [S, B, H, D], m_part / l_part [S, B, H])
// and the merge kernel normalizes them into o at q's dtype.
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const float* ks,
                                            const float* vs, const int* tables,
                                            const int* lengths, void* o, float* o_part,
                                            float* m_part, float* l_part, int B, int H,
                                            int KV, int D, int BS, int MB, int splits,
                                            int dt, int q_dt, float sm_scale,
                                            void* stream) {
  if (!o_part || !m_part || !l_part || splits < 1 || splits > DF_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int e = repro_paged_decode_partials(q, k_pool, v_pool, ks, vs, tables, lengths,
                                            o_part, m_part, l_part, B, H, KV, D, BS, MB,
                                            splits, dt, q_dt, sm_scale, stream);
  if (e != 0) return e;
  dec_merge_kernel<<<B * H, DF_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      o_part, m_part, l_part, o, splits, B * H, D, q_dt);
  return (int)cudaGetLastError();
}
extern "C" int repro_paged_decode_merge(const float* o, const float* m, const float* l,
                                        void* out, int B, int H, int D, int splits, int dt,
                                        void* stream) {
  if (splits < 1 || splits > DF_MAX_SPLITS || D < 1) return (int)cudaErrorInvalidValue;
  dec_merge_kernel<<<B * H, DF_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      o, m, l, out, splits, B * H, D, dt);
  return (int)cudaGetLastError();
}
