// FlashAttention-2 forward for prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_fa_kernel): q [B, Sq, H, D], k/v [B, Skv, KV, D] -> o [B, Sq, H, D], with
// causal, sliding-window, q_offset and kv_len masks and GQA (query head h
// reads kv head h / (H / KV)).  Statistics (m, l, acc) are fp32; scores are
// the fp32 dot of the operands times 1/sqrt(D); masked scores are -1e30; P is
// cast to V's dtype before P.V; the output is acc / max(l, 1e-30).
//
// What bounds it on an H100: at prefill lengths the operations (4*Sq*Skv*D
// per head, halved by the causal mask).  Design: one block per (16 query
// rows, head, batch row); the KV loop runs inside the block over 32-key
// tiles staged in shared memory (fp32, K padded by one column so the
// per-lane key rows hit distinct banks).  Each warp owns two query rows;
// lane j scores key j, the warp reduces max and sum with shuffles, and the
// P.V product broadcasts p_j by shuffle while each lane accumulates D/32
// output dims.  Tiles that every row of the block masks (above the causal
// diagonal, past kv_len, or older than the window) are skipped, which is
// exact: a fully masked tile is a no-op of the online-softmax update once a
// row has seen a valid key.  Head dim 256 needs 82 KB of shared memory, so
// the kernel opts in to dynamic shared memory above 48 KB.  Tensor cores and
// pipelined TMA loads are later work.
#include "common.cuh"

constexpr int FA_BQ = 16;    // query rows per block (2 per warp)
constexpr int FA_BKV = 32;   // keys per tile (one per lane)
constexpr int FA_MAXD = 256;
constexpr int FA_DPL = FA_MAXD / 32;  // output dims per lane, upper bound

struct FAParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, KV, D;
  int q_offset, causal, window, kv_len;
  int dt, vec;
  float sm_scale;
};

__device__ __forceinline__ void fa_load_rows(float* dst, int dst_stride,
                                             const void* src, int b, int row0,
                                             int nrows, int S, int heads, int h,
                                             int D, int dt, bool vec) {
  const int groups = nrows * (D / 4);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int r = g / (D / 4), d = (g % (D / 4)) * 4;
    const int s = row0 + r;
    float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      const int64_t idx = (((int64_t)b * S + s) * heads + h) * D + d;
      if (vec) {
        v4 = ld4_aligned(src, idx, dt);
      } else {
        v4.x = ld_elem(src, idx, dt);
        v4.y = ld_elem(src, idx + 1, dt);
        v4.z = ld_elem(src, idx + 2, dt);
        v4.w = ld_elem(src, idx + 3, dt);
      }
    }
    float* o = dst + r * dst_stride + d;
    o[0] = v4.x;
    o[1] = v4.y;
    o[2] = v4.z;
    o[3] = v4.w;
  }
}

__global__ void __launch_bounds__(256) flash_attention_kernel(const FAParams p) {
  extern __shared__ float smem[];
  const int D = p.D;
  float* Qs = smem;                          // [BQ][D]
  float* Ks = Qs + FA_BQ * D;                // [BKV][D + 1]
  float* Vs = Ks + FA_BKV * (D + 1);         // [BKV][D]

  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  fa_load_rows(Qs, D, p.q, b, q0, FA_BQ, p.Sq, p.H, h, D, p.dt, p.vec);

  const int r0 = warp * 2;
  const int qpos0 = q0 + r0 + p.q_offset, qpos1 = qpos0 + 1;
  const int qlast = min(q0 + FA_BQ, p.Sq) - 1 + p.q_offset;  // last real row
  const int qfirst = q0 + p.q_offset;
  const bool round_p = p.dt == DT_BF16;

  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};
  float acc[2][FA_DPL];
#pragma unroll
  for (int i = 0; i < FA_DPL; ++i) acc[0][i] = acc[1][i] = 0.f;

  for (int t0 = 0; t0 < p.kv_len; t0 += FA_BKV) {
    if (p.causal && t0 > qlast) break;                       // above diagonal
    if (p.window > 0 && t0 + FA_BKV - 1 <= qfirst - p.window) continue;
    __syncthreads();  // previous tile fully consumed
    fa_load_rows(Ks, D + 1, p.k, b, t0, FA_BKV, p.Skv, p.KV, kvh, D, p.dt, p.vec);
    fa_load_rows(Vs, D, p.v, b, t0, FA_BKV, p.Skv, p.KV, kvh, D, p.dt, p.vec);
    __syncthreads();

    // scores: lane = key
    const float* kr = Ks + lane * (D + 1);
    const float* qa = Qs + r0 * D;
    const float* qb = qa + D;
    float s0 = 0.f, s1 = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
      s0 = fmaf(qa[d], kv, s0);
      s1 = fmaf(qb[d], kv, s1);
    }
    const int kpos = t0 + lane;
    float s[2] = {s0 * p.sm_scale, s1 * p.sm_scale};
    const int qp[2] = {qpos0, qpos1};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bool ok = kpos < p.kv_len;
      if (p.causal) ok = ok && kpos <= qp[r];
      if (p.window > 0) ok = ok && kpos > qp[r] - p.window;
      if (!ok) s[r] = NEG_INF_F;
      const float m_new = fmaxf(m[r], warp_max(s[r]));
      const float pr = expf(s[r] - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(pr);
      m[r] = m_new;
      const float pv = round_p ? round_bf16(pr) : pr;
#pragma unroll
      for (int i = 0; i < FA_DPL; ++i) acc[r][i] *= corr;
      for (int j = 0; j < FA_BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
        const float* vr = Vs + j * D;
#pragma unroll
        for (int i = 0; i < FA_DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[r][i] = fmaf(pj, vr[d], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const int64_t base = (((int64_t)b * p.Sq + qi) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < FA_DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) st_elem(p.o, base + d, p.dt, acc[r][i] * inv);
    }
  }
}

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int Sq, int Skv, int H, int KV,
                                     int D, int q_offset, int causal, int window,
                                     int kv_len, int dt, int vec, float sm_scale,
                                     void* stream) {
  if (D > FA_MAXD || D % 4 != 0) return (int)cudaErrorInvalidValue;
  FAParams p{q, k, v, o, B, Sq, Skv, H, KV, D, q_offset, causal, window,
             kv_len, dt, vec, sm_scale};
  const size_t smem = (size_t)(FA_BQ * D + FA_BKV * (D + 1) + FA_BKV * D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
  flash_attention_kernel<<<grid, 256, smem, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
