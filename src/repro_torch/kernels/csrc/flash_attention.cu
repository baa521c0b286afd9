// FlashAttention-2 forward for prefill: two templates, picked per call by
// kernels/flash_attention.py:flash_plan.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_fa_kernel): q [B, Sq, H, D], k/v [B, Skv, KV, D] -> o [B, Sq, H, D], with
// causal, sliding-window, q_offset and kv_len masks and GQA (query head h
// reads kv head h / (H / KV)).  Statistics (m, l, acc) are fp32; scores are
// the fp32 dot of the operands times 1/sqrt(D); masked scores are -1e30; P is
// cast to V's dtype before P.V; the output is acc / max(l, 1e-30).  Tiles
// that every row of a block masks (above the causal diagonal, past kv_len,
// or older than the window) are skipped, which is exact: a fully masked tile
// is a no-op of the online-softmax update once a row has seen a valid key,
// and before that its contribution is wiped by the first valid key's
// rescale (exp(-1e30 - m) = 0).
//
// What bounds it on an H100: at prefill lengths the operations (4*Sq*Skv*D
// per head, halved by the causal mask), at the bf16 tensor-core rate.
//
//   wgmma  bf16, D a multiple of 16 up to 256.  One block per (64 query
//          rows, head, batch row): one lane of a producer warp keeps TMA
//          loads of K and V tiles (64 keys) in flight in a 2-stage
//          shared-memory ring with mbarriers, through 4-D tensor maps over
//          (D, heads, S, B) that read the [B, S, H, D] layout in place
//          (GQA: the kv head is a coordinate), in 64-column boxes with the
//          128-byte swizzle; the consumer warpgroup runs S = Q.K^T as
//          wgmma with both operands in shared memory (K is [keys][D],
//          wgmma's K-major B), the online softmax on the fp32 accumulator
//          registers, and O += P.V as wgmma with P converted to bf16 in
//          registers (the register-A form: the bits of round_bf16(p)) and
//          V the MN-major B operand.  64-row query tiles give
//          H x ceil(S / 64) blocks (128 at S = 512 with 16 heads), the
//          heaviest causal tiles launched first; TMA zero-fills rows and
//          columns past the tensor's edge, and the masks still make those
//          keys -1e30.
//   simt   fp32 (and bf16 at any other D): the first design, unchanged —
//          one block per (16 query rows, head, batch row), fp32 tiles of 32
//          keys staged by plain loads, FMA on CUDA cores.
#include "hopper.cuh"

// ---------------------------------------------------------------------------
// simt template
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// wgmma template
// ---------------------------------------------------------------------------

constexpr int FW_BQ = 64;              // query rows of a block: one consumer warpgroup
constexpr int FW_BKV = 64;             // keys of a tile
constexpr int FW_STAGES = 2;           // K / V tiles in flight
constexpr int FW_THREADS = 160;        // consumer warpgroup (warps 0-3) + producer warp 4
constexpr int FW_BOX = 64 * 128;       // one [64 rows][64 columns] bf16 box (8 KB)
static_assert(FW_BQ == 64 && FW_BKV == 64, "one box height for Q, K and V tiles");

// Shared memory of a block with NB 64-column boxes per row (D <= 64 NB):
// 1 KB of alignment slack, the Q tile, the ring of K and V tiles, barriers.
template <int NB>
constexpr int fw_smem_bytes() {
  return 1024 + NB * FW_BOX + FW_STAGES * 2 * NB * FW_BOX + 8 * (1 + 2 * FW_STAGES);
}

// o[64 x 64 NB] += P[64 x 16] . V[16 keys x 64 NB]
template <int NB>
__device__ __forceinline__ void fw_pv(float (&o)[32 * NB], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NB == 1) wgmma_rs_n64(o, a, db);
  else if constexpr (NB == 2) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

// Registers: the D = 256 accumulator alone is 128 a thread, so that
// variant takes up to 255 (one block an SM, as its shared memory does);
// D <= 128 fits two blocks an SM.
template <int NB>
__global__ void __launch_bounds__(FW_THREADS, NB == 4 ? 1 : 2)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v, const FAParams p) {
  extern __shared__ uint8_t fw_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fw_smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* qs = smem;                                 // [NB][64 rows][64 columns]
  uint8_t* ring = qs + NB * FW_BOX;                   // [stage][K boxes, V boxes]
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + FW_STAGES * 2 * NB * FW_BOX);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + FW_STAGES;

  const int nq = (p.Sq + FW_BQ - 1) / FW_BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * FW_BQ;  // the heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int qfirst = q0 + p.q_offset;
  const int qlast = min(q0 + FW_BQ, p.Sq) - 1 + p.q_offset;  // last real row
  // the KV tiles some row of the block attends: [j0, j1)
  int j1 = (p.kv_len + FW_BKV - 1) / FW_BKV;
  if (p.causal) j1 = min(j1, qlast / FW_BKV + 1);
  const int lo = qfirst - p.window + 1;               // the first row's oldest key
  const int j0 = (p.window > 0 && lo > 0) ? lo / FW_BKV : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0 && j1 > j0) {  // the producer
      mbar_expect_tx(qbar, NB * FW_BOX);
      for (int c = 0; c < NB; ++c) tma_load_4d(qs + c * FW_BOX, &tma_q, c * 64, h, q0, b, qbar);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = j0; j < j1; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = ring + stage * 2 * NB * FW_BOX;
        mbar_expect_tx(&full[stage], 2 * NB * FW_BOX);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(st + c * FW_BOX, &tma_k, c * 64, kvh, j * FW_BKV, b, &full[stage]);
          tma_load_4d(st + (NB + c) * FW_BOX, &tma_v, c * 64, kvh, j * FW_BKV, b, &full[stage]);
        }
        if (++stage == FW_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroup.  Accumulator layout (m64nN): its warp w, lane
  // (g, t) = (lane / 4, lane % 4) holds rows 16 w + g (registers 4 n,
  // 4 n + 1) and 16 w + g + 8 (4 n + 2, 4 n + 3) at columns 8 n + 2 t,
  // 8 n + 2 t + 1.
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int nk = p.D / 16;              // k16 steps of Q.K^T
  float o[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F}, l[2] = {0.f, 0.f};  // l: this thread's columns
  const uint32_t qa = smem_u32(qs);
  int stage = 0;
  uint32_t phase = 0;
  if (j1 > j0) mbar_wait(qbar, 0);
  for (int j = j0; j < j1; ++j) {
    mbar_wait(&full[stage], phase);
    const uint32_t kb = smem_u32(ring + stage * 2 * NB * FW_BOX);
    const uint32_t vb = kb + NB * FW_BOX;

    // S = Q . K^T: both operands K-major in shared memory
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      if (kk < nk) {
        const uint32_t off = (kk >> 2) * FW_BOX + (kk & 3) * 32;
        wgmma_ss_n64(s, desc_kmajor(qa + off), desc_kmajor(kb + off));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax on the registers; a row's 64 keys sit in the 4 lanes of
    // its quad
    const int k0 = j * FW_BKV;
    const bool edge = k0 + FW_BKV > p.kv_len || (p.causal && k0 + FW_BKV - 1 > qfirst) ||
                      (p.window > 0 && k0 <= qlast - p.window);
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qpos = row0 + 8 * hh + p.q_offset;
      float mx = NEG_INF_F;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + 2 * hh + e;
          float x = s[i] * p.sm_scale;
          if (edge) {
            const int kpos = k0 + 8 * n + 2 * t + e;
            bool ok = kpos < p.kv_len;
            if (p.causal) ok = ok && kpos <= qpos;
            if (p.window > 0) ok = ok && kpos > qpos - p.window;
            if (!ok) x = NEG_INF_F;
          }
          s[i] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + 2 * hh + e;
          const float pv = expf(s[i] - m_new);
          s[i] = pv;
          rs += pv;
        }
      }
      l[hh] = l[hh] * corr[hh] + rs;
    }
#pragma unroll
    for (int n = 0; n < 8 * NB; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
    // P in bf16 as the register-A fragments of the 4 k16 slices: slice kk
    // is accumulator columns 16 kk .. 16 kk + 15 (n8 blocks 2 kk, 2 kk + 1)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack2(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = pack2(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack2(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack2(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // O += P . V: V [keys][D] is the MN-major B operand, 16 keys a step
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fw_pv<NB>(o, a[kk], desc_mnmajor(vb + kk * 16 * 128, FW_BOX));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == FW_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int r = row0 + 8 * hh;
    if (r >= p.Sq) continue;
    __nv_bfloat16* orow =
        reinterpret_cast<__nv_bfloat16*>(p.o) + (((int64_t)b * p.Sq + r) * p.H + h) * p.D;
#pragma unroll
    for (int n = 0; n < 8 * NB; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < p.D)
        *reinterpret_cast<uint32_t*>(orow + c) =
            pack2(o[4 * n + 2 * hh] * inv, o[4 * n + 2 * hh + 1] * inv);
    }
  }
}

template <int NB>
static int launch_flash_wgmma(const FAParams& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  const int qdims[4] = {p.D, p.H, p.Sq, p.B};
  const int64_t qstr[3] = {p.D, (int64_t)p.H * p.D, (int64_t)p.Sq * p.H * p.D};
  const int kdims[4] = {p.D, p.KV, p.Skv, p.B};
  const int64_t kstr[3] = {p.D, (int64_t)p.KV * p.D, (int64_t)p.Skv * p.KV * p.D};
  if (!encode_bf16_4d(&mq, p.q, qdims, qstr, FW_BQ) ||
      !encode_bf16_4d(&mk, p.k, kdims, kstr, FW_BKV) ||
      !encode_bf16_4d(&mv, p.v, kdims, kstr, FW_BKV))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = fw_smem_bytes<NB>();
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)flash_wgmma_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((p.Sq + FW_BQ - 1) / FW_BQ, p.H, p.B);
  flash_wgmma_kernel<NB><<<grid, FW_THREADS, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
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

extern "C" int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                           void* o, int B, int Sq, int Skv, int H, int KV,
                                           int D, int q_offset, int causal, int window,
                                           int kv_len, float sm_scale, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (D < 16 || D > 256 || D % 16 || H % KV || align % 16) return (int)cudaErrorInvalidValue;
  FAParams p{q, k, v, o, B, Sq, Skv, H, KV, D, q_offset, causal, window,
             kv_len, DT_BF16, 1, sm_scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 64) return launch_flash_wgmma<1>(p, s);
  if (D <= 128) return launch_flash_wgmma<2>(p, s);
  return launch_flash_wgmma<4>(p, s);
}
