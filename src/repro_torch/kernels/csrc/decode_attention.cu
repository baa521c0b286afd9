// Single-token decode attention over dense per-slot KV caches.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:decode_attention
// (`_decode_kernel`, `_online_merge`).  q [B, H, D]; k/v caches [B, S, KV, D];
// lengths [B] int32 (<= S); a static window.  Position p of a slot attends
// when p < length and, for window > 0, p >= length - window; the function is
// softmax((q . k) / sqrt(D)) . v over those positions with fp32 scores and
// statistics, P cast to V's dtype for P.V, and acc / max(l, 1e-30) at q's
// dtype.  The serving path runs it on ring caches (slot = position % W),
// whose valid rows are the prefix s < min(pos + 1, W), and on linear caches
// with a window.
//
// What bounds it on an H100: bytes.  Every valid K and V row is read once
// (gemma3's ring at B = 4, KV 16, D 128, S 1024 full: 16.8 MB, 5.0 us at
// 3.35 TB/s) against ~4 FLOPs per cache element.  The first design walked
// 32 positions a fold behind three barriers at 128 threads and read V row
// after row with 2-byte loads, each waiting on the last row's FMA chain:
// almost no bytes in flight, so latency and instructions bound it, at
// 10-46x the byte bound.
// Design: a dense cache is a pool whose table is implicit (row `pos` of slot
// b and kv head h at ((b * S + pos) * KV + h) * D), so the block folds
// through the paged decode's stage ring (decode_fold.cuh, DenseRows):
// grid (kv head, slot, split), 256 threads, DF_STAGES stages of 32
// positions in flight with 16-byte cp.async, only valid rows copied; 8
// lanes score a key row for all G heads, one warp a query head keeps its
// statistics, and each thread accumulates a pair of output dimensions with
// bf16x2 / float2 reads of V.  S is cut into `splits` ranges of `range`
// positions, a multiple of the stage (kernels/flash_decode.py:dense_splits:
// two blocks an SM over the (kv head, slot) grid, at most 64); each range
// walks stages aligned to 32 positions from the window's lower bound
// lo = max(0, length - window), and a block whose range lies outside
// [lo, length) writes empty partials and exits before any copy.
// dec_merge_kernel folds the splits' partials into the output, at every
// split count.
#include "decode_fold.cuh"

struct DAParams {
  DecFold f;
  const int* lengths;  // [B]
  int S, range, window;
};

template <typename T>
__global__ void __launch_bounds__(DF_THREADS) decode_attention_kernel(const DAParams p) {
  extern __shared__ __align__(16) uint8_t da_smem[];
  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int len = min(max(p.lengths[b], 0), p.S);
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;
  const int first = max(z * p.range, lo), end = min(z * p.range + p.range, len);
  if (first >= end) {
    df_store_empty(p.f, kvh, b, z);
    return;
  }
  DenseRows rows{(int64_t)b * p.S, first - first % DF_STAGE_TOKENS, first, end};
  dec_fold<T>(p.f, rows, da_smem, kvh, b, z);
}

template <typename T>
static cudaError_t launch_dense_t(const DAParams& p, int splits, size_t smem,
                                  cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               DF_SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  dim3 grid(p.f.KV, p.f.B, splits);
  decode_attention_kernel<T><<<grid, DF_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

// The partials of `splits` ranges of `range` positions go to the caller's
// scratch (o_part [splits, B, H, D], m_part / l_part [splits, B, H]) and the
// merge kernel normalizes them into out at q's dtype.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int* lengths, void* out, float* o_part,
                                      float* m_part, float* l_part, int B, int H,
                                      int KV, int D, int S, int range, int splits,
                                      int window, int dt, float sm_scale, void* stream) {
  const int esize = dt == DT_BF16 ? 2 : 4;
  if (!df_shape_ok(H, KV, D, esize, k, v, o_part) || !out || !o_part || !m_part ||
      !l_part || splits < 1 || splits > DF_MAX_SPLITS || range < 1 ||
      range % DF_STAGE_TOKENS || (int64_t)range * splits < S || window < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = df_smem_bytes(H / KV, D, DF_STAGE_TOKENS, esize, 0);
  if (smem > DF_SMEM_MAX) return (int)cudaErrorInvalidValue;
  DAParams p{{q, k, v, o_part, m_part, l_part, B, H, KV, D, sm_scale}, lengths, S, range,
             window};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = dt == DT_BF16 ? launch_dense_t<__nv_bfloat16>(p, splits, smem, s)
                                      : launch_dense_t<float>(p, splits, smem, s);
  if (e != cudaSuccess) return (int)e;
  dec_merge_kernel<<<B * H, DF_THREADS, 0, s>>>(o_part, m_part, l_part, out, splits, B * H,
                                                D, dt);
  return (int)cudaGetLastError();
}
