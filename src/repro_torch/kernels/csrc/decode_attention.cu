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
// 3.35 TB/s) against ~4 FLOPs per cache element.
// Design: the TPU walks the cache in 512-position chunks along a sequential
// grid axis; a (slot, kv head) grid alone is 64 blocks at gemma3's shapes,
// under half the 132 SMs.  So S is cut into `nsplit` ranges of `range`
// positions (the wrapper picks enough for two blocks per SM), grid (KV, B,
// nsplit).  Each block folds the valid positions of its range, 32 at a time,
// through common.cuh's `dec_fold` (shared with paged_decode.cu) and writes
// fp32 partials (o, m, l); ranges wholly outside [length - window, length)
// fold nothing, as the TPU's `live` skips dead chunks.  A second small kernel
// merges the partials with the online-softmax rule (the reference's
// merge_partials).  With one range the block normalizes itself and the
// merge is skipped.
#include "common.cuh"

constexpr int DA_CHUNK = 32;          // positions per fold
constexpr int DA_MAX_SPLITS = 64;

struct DAParams {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;        // [B, H, D] at dt
  float* o_part;    // [nsplit, B, H, D] fp32 (nsplit > 1)
  float* m_part;    // [nsplit, B, H]
  float* l_part;
  int B, H, KV, D, S, range, nsplit, window;
  int dt, vec;
  float sm_scale;
};

template <bool NORMALIZE>
__global__ void __launch_bounds__(DEC_THREADS) decode_attention_kernel(const DAParams p) {
  extern __shared__ float smem[];
  const int G = p.H / p.KV, D = p.D;
  const DecSmem sh = dec_smem(smem, G, D, DA_CHUNK);
  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int len = min(max(p.lengths[b], 0), p.S);
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;
  const int first = max(split * p.range, lo);
  const int end = min(split * p.range + p.range, len);
  const int64_t head0 = (int64_t)b * p.H + kvh * G;
  const int64_t stride = (int64_t)p.KV * D;

  float acc[DEC_MAXV];
  dec_begin(sh, acc, p.q, head0, G, D, p.dt);
  for (int c0 = first; c0 < end; c0 += DA_CHUNK)
    dec_fold(sh, acc, p.k, p.v, ((int64_t)b * p.S + c0) * stride + (int64_t)kvh * D,
             stride, min(DA_CHUNK, end - c0), G, D, p.dt, p.vec, p.sm_scale);
  if (NORMALIZE) {
    dec_finish<true>(sh, acc, p.out, nullptr, nullptr, head0, G, D, p.dt);
  } else {
    const int64_t bh = (int64_t)split * p.B * p.H;
    dec_finish<false>(sh, acc, p.o_part + bh * D, p.m_part + bh, p.l_part + bh,
                      head0, G, D, p.dt);
  }
}

// One block per (slot, query head): out = sum_s o_s e^(m_s - m) /
// max(sum_s l_s e^(m_s - m), 1e-30), m = max_s m_s.
__global__ void __launch_bounds__(DEC_THREADS) decode_merge_kernel(const DAParams p) {
  __shared__ float corr[DA_MAX_SPLITS];
  __shared__ float l_all;
  const int64_t BH = (int64_t)p.B * p.H, bh = blockIdx.x;
  if (threadIdx.x == 0) {
    float m_all = NEG_INF_F;
    for (int s = 0; s < p.nsplit; ++s) m_all = fmaxf(m_all, p.m_part[s * BH + bh]);
    float l = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      corr[s] = expf(p.m_part[s * BH + bh] - m_all);
      l += p.l_part[s * BH + bh] * corr[s];
    }
    l_all = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < p.D; d += DEC_THREADS) {
    float o = 0.f;
    for (int s = 0; s < p.nsplit; ++s)
      o = fmaf(p.o_part[(s * BH + bh) * p.D + d], corr[s], o);
    st_elem(p.out, bh * p.D + d, p.dt, o / l_all);
  }
}

extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int* lengths, void* out, float* o_part,
                                      float* m_part, float* l_part, int B, int H,
                                      int KV, int D, int S, int range, int nsplit,
                                      int window, int dt, int vec, float sm_scale,
                                      void* stream) {
  const int G = KV > 0 ? H / KV : 0;
  if (G < 1 || H % KV != 0 || G > DEC_MAXG || G * D > DEC_MAXV * DEC_THREADS ||
      D % 4 != 0 || nsplit < 1 || nsplit > DA_MAX_SPLITS || range < 1 ||
      (long long)range * nsplit < S || window < 0 ||
      (nsplit > 1 && (o_part == nullptr || m_part == nullptr || l_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  DAParams p{q, k, v, lengths, out, o_part, m_part, l_part,
             B, H, KV, D, S, range, nsplit, window, dt, vec, sm_scale};
  const size_t smem = dec_smem_bytes(G, D, DA_CHUNK);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(KV, B, nsplit);
  if (nsplit == 1) {
    decode_attention_kernel<true><<<grid, DEC_THREADS, smem, s>>>(p);
    return (int)cudaGetLastError();
  }
  decode_attention_kernel<false><<<grid, DEC_THREADS, smem, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_merge_kernel<<<B * H, DEC_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
