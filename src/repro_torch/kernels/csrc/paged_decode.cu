// Paged single-token decode attention: one fold kernel and one merge kernel.
//
// Replaces the TPU kernels src/repro/kernels/flash_decode.py:
//   paged_decode_partials  (_paged_partials_kernel, _online_merge) -> paged_decode_kernel:
//       unnormalized fp32 o [S, B, H, D] and m, l [S, B, H] for the online-softmax
//       merge, one set per split of the table (S = 1: the TPU kernel's shapes);
//   paged_decode_attention (_paged_decode_kernel, _online_merge)   -> paged_decode_kernel
//       then paged_merge_kernel, at every split count (one included):
//       o / max(l, 1e-30) at q's dtype.
// q [B, H, D]; k/v pools [NB, BS, KV, D]; block tables [B, MB] int32 (entries
// < 0 absent); lengths [B].  Token t of table entry e holds position
// e*BS + t and is masked at or past the slot's length.  Per pool block (the
// TPU kernel's fold, and the plain version's): scores = (q . k) / sqrt(D) in
// fp32, the online-softmax rescale, P cast to V's dtype for P.V.  Absent
// entries and entries wholly past the length are skipped, as the TPU kernel
// skips their fold.  Split z walks the contiguous entry range
// [z * per, (z + 1) * per), per = ceil(MB / S).
//
// What bounds it on an H100: bytes — every live K and V row is read once
// (2 * len * KV * D * 2 bytes per slot) against a handful of FLOPs per byte.
// Design: grid (kv head, slot, split), 256 threads.  The block first
// compacts its range's live entries (one warp ballot per 32 entries) into
// a list in shared memory, then keeps PD_STAGES stages of pages in flight
// with 16-byte cp.async: a stage holds whole K and V pages, max(BS, 32)
// tokens, only the valid rows of a page copied.  Each stage is folded with
// three barriers: 8 lanes per key row score it for all G query heads
// (16-byte shared loads, a 3-step shuffle reduction), one warp per head
// folds the stage's pages into (m, l) in page order (the per-page rescale
// kept), and each thread accumulates a pair of output dimensions of one
// head with bf16x2 / float2 reads of V, applying each page's rescale.  The
// split count (kernels/flash_decode.py:paged_splits: two blocks an SM over
// the (kv head, slot) grid, at least the serving path's one split per 256
// positions of the longest slot) spreads the pages over the card;
// paged_merge_kernel then folds the splits' partials into the normalized
// output at q's dtype in one launch (the online-softmax merge rule of the
// reference's core/attention.py:merge_partials).  The normalized entry point
// launches both kernels itself, so one verified fold serves every shape.
#include "common.cuh"

constexpr int PD_THREADS = 256;
constexpr int PD_WARPS = PD_THREADS / 32;   // a warp for each query head's statistics
constexpr int PD_STAGES = 3;            // stages of pages in flight
constexpr int PD_STAGE_TOKENS = 32;     // tokens a stage holds at least
constexpr int PD_LPT = 8;               // lanes scoring one key row
constexpr int PD_ROWS = 32 / PD_LPT;    // key rows a warp scores at once
constexpr int PD_MAXG = DEC_MAXG;       // query heads per kv head
static_assert(PD_WARPS >= PD_MAXG, "one warp a query head");
constexpr int PD_MAXPAIRS = 4;          // (G * D / 2) / PD_THREADS upper bound
constexpr int PD_SMEM_MAX = 226 * 1024; // dynamic shared memory (227 KB less static)
constexpr int PD_MAX_SPLITS = 64;       // splits the merge kernel takes

struct PDParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* lengths;
  float* o;     // [S, B, H, D]
  float* m;     // [S, B, H]
  float* l;
  int B, H, KV, D, BS, MB, per;
  float sm_scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// pages of one stage: enough for PD_STAGE_TOKENS tokens
__host__ __device__ inline int pd_pages(int BS) {
  return BS >= PD_STAGE_TOKENS ? 1 : PD_STAGE_TOKENS / BS;
}

__host__ __device__ inline size_t pd_ring_bytes(int BS, int D, int esize) {
  return (size_t)PD_STAGES * pd_pages(BS) * 2 * BS * D * esize;
}

// shared memory: the ring, then fp32 Qs [G][D], Ss [G][stage tokens] (scores,
// then P), Cs [G][pages] (each page's rescale); then the live list: entry and
// pool block, [per] each
__host__ __device__ inline size_t pd_smem_bytes(int G, int D, int BS, int per, int esize) {
  const int tok = pd_pages(BS) * BS;
  return pd_ring_bytes(BS, D, esize) +
         (size_t)(G * D + G * tok + G * pd_pages(BS)) * sizeof(float) +
         (size_t)2 * per * sizeof(int) + 16;
}

template <typename T>
__device__ __forceinline__ void pd_unpack(const uint4 u, float (&w)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 2) {
    unpack8(u, w);
  } else {
    w[0] = __uint_as_float(u.x);
    w[1] = __uint_as_float(u.y);
    w[2] = __uint_as_float(u.z);
    w[3] = __uint_as_float(u.w);
  }
}

template <typename T>
__device__ __forceinline__ float2 pd_pair(const T* p) {
  if constexpr (sizeof(T) == 2) return unpack2(*reinterpret_cast<const uint32_t*>(p));
  else return *reinterpret_cast<const float2*>(p);
}

template <typename T>
__global__ void __launch_bounds__(PD_THREADS) paged_decode_kernel(const PDParams p) {
  constexpr int EPC = 16 / sizeof(T);  // elements of a 16-byte chunk
  extern __shared__ __align__(16) uint8_t pd_smem[];
  const int G = p.H / p.KV, D = p.D, BS = p.BS;
  const int P = pd_pages(BS), TOK = P * BS;
  const int CR = D / EPC;                         // 16-byte chunks of a row
  T* ring = reinterpret_cast<T*>(pd_smem);         // [stage][page][K, V][BS][D]
  float* Qs = reinterpret_cast<float*>(pd_smem + pd_ring_bytes(BS, D, sizeof(T)));
  float* Ss = Qs + G * D;
  float* Cs = Ss + G * TOK;
  int* ents = reinterpret_cast<int*>(Cs + G * P);  // live entries of the range
  int* blks = ents + p.per;
  __shared__ int nlive_sh;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int len = p.lengths[b];
  const int e0 = z * p.per, e1 = min(p.MB, e0 + p.per);
  const int64_t head0 = (int64_t)b * p.H + kvh * G;

  if (warp == 0) {
    // compact the range's live entries, in order
    int count = 0;
    for (int c = e0; c < e1; c += 32) {
      const int e = c + lane;
      const int t = e < e1 ? p.tables[(int64_t)b * p.MB + e] : -1;
      const bool live = t >= 0 && e * BS < len;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int at = count + __popc(mask & ((1u << lane) - 1));
        ents[at] = e;
        blks[at] = t;
      }
      count += __popc(mask);
    }
    if (lane == 0) nlive_sh = count;
  } else {
    for (int i = tid - 32; i < G * D; i += PD_THREADS - 32)
      Qs[i] = ld_elem(p.q, head0 * D + i, sizeof(T) == 2 ? DT_BF16 : DT_F32);
  }
  __syncthreads();
  const int nlive = nlive_sh;
  const int nst = (nlive + P - 1) / P;

  // copy stage `st`'s pages (their valid rows) into ring slot `slot`: this
  // thread's 16-byte column of the K or V rows (2 CR columns divide the
  // block), every `rstep`-th row from `r0`
  const int col = tid % (2 * CR), r0 = tid / (2 * CR), rstep = PD_THREADS / (2 * CR);
  const int ckv = col / CR, cch = col % CR;
  const T* pool = reinterpret_cast<const T*>(ckv ? p.v_pool : p.k_pool) + kvh * D + cch * EPC;
  const int64_t gstride = (int64_t)p.KV * D;
  auto load_stage = [&](int st, int slot) {
    const int i0 = st * P, np = min(P, nlive - i0);
    T* base = ring + (size_t)slot * P * 2 * BS * D + (size_t)ckv * BS * D + cch * EPC;
    for (int pi = 0; pi < np; ++pi) {
      const int n = min(BS, len - ents[i0 + pi] * BS);
      const T* src = pool + (int64_t)blks[i0 + pi] * BS * gstride;
      T* dst = base + (size_t)pi * 2 * BS * D;
      for (int r = r0; r < n; r += rstep)
        cp_async16(dst + (size_t)r * D, src + r * gstride);
    }
  };

  // warp g folds query head g (its m, l in registers)
  float m_r = NEG_INF_F, l_r = 0.f;
  float acc[2 * PD_MAXPAIRS];
#pragma unroll
  for (int i = 0; i < 2 * PD_MAXPAIRS; ++i) acc[i] = 0.f;
  const int npairs = G * D / 2;

  for (int s = 0; s < PD_STAGES - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<PD_STAGES - 2>();
    __syncthreads();  // stage st landed for every thread; stage st - 1 consumed
    if (st + PD_STAGES - 1 < nst)
      load_stage(st + PD_STAGES - 1, (st + PD_STAGES - 1) % PD_STAGES);
    cp_async_commit();
    const T* kv = ring + (size_t)(st % PD_STAGES) * P * 2 * BS * D;
    const int i0 = st * P, np = min(P, nlive - i0);

    // scores: PD_LPT lanes per key row, all G heads at once
    for (int u0 = warp * PD_ROWS; u0 < TOK; u0 += PD_WARPS * PD_ROWS) {
      const int u = u0 + lane / PD_LPT, sub = lane % PD_LPT;
      const int pi = u / BS, r = u % BS;
      const bool valid = u < TOK && pi < np && r < min(BS, len - ents[i0 + min(pi, np - 1)] * BS);
      float dot[PD_MAXG];
#pragma unroll
      for (int g = 0; g < PD_MAXG; ++g) dot[g] = 0.f;
      if (valid) {
        const T* krow = kv + ((size_t)(pi * 2) * BS + r) * D;
        for (int ch = sub; ch < CR; ch += PD_LPT) {
          float w[EPC];
          pd_unpack<T>(*reinterpret_cast<const uint4*>(krow + ch * EPC), w);
#pragma unroll
          for (int g = 0; g < PD_MAXG; ++g) {
            if (g >= G) break;
            const float* qg = Qs + g * D + ch * EPC;
#pragma unroll
            for (int x = 0; x < EPC; ++x) dot[g] = fmaf(qg[x], w[x], dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < PD_MAXG; ++g) {
        if (g >= G) break;
        float d = dot[g];
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        if (sub == 0 && u < TOK) Ss[g * TOK + u] = valid ? d * p.sm_scale : NEG_INF_F;
      }
    }
    __syncthreads();

    // statistics, page by page, warp g for head g; P replaces the scores
    if (warp < G) {
      float* sg = Ss + warp * TOK;
      for (int pi = 0; pi < np; ++pi) {
        const int n = min(BS, len - ents[i0 + pi] * BS);
        float* sp = sg + pi * BS;
        float mb = NEG_INF_F;
        for (int t = lane; t < n; t += 32) mb = fmaxf(mb, sp[t]);
        mb = warp_max(mb);
        const float m_new = fmaxf(m_r, mb);
        float ps = 0.f;
        for (int t = lane; t < n; t += 32) {
          const float pw = expf(sp[t] - m_new);
          ps += pw;
          sp[t] = sizeof(T) == 2 ? round_bf16(pw) : pw;
        }
        ps = warp_sum(ps);
        const float corr = expf(m_r - m_new);
        if (lane == 0) Cs[warp * P + pi] = corr;
        l_r = l_r * corr + ps;
        m_r = m_new;
      }
    }
    __syncthreads();

    // P.V: each thread a pair of output dimensions of one head
#pragma unroll
    for (int i = 0; i < PD_MAXPAIRS; ++i) {
      const int pr = tid + i * PD_THREADS;
      if (pr >= npairs) break;
      const int g = (2 * pr) / D, d = (2 * pr) % D;
      float a0 = acc[2 * i], a1 = acc[2 * i + 1];
      for (int pi = 0; pi < np; ++pi) {
        const int n = min(BS, len - ents[i0 + pi] * BS);
        const float c = Cs[g * P + pi];
        a0 *= c;
        a1 *= c;
        const float* pg = Ss + g * TOK + pi * BS;
        const T* vrow = kv + ((size_t)(pi * 2 + 1) * BS) * D + d;
        // even and odd tokens in two chains: half the dependent FMAs
        float b0 = 0.f, b1 = 0.f;
        int t = 0;
#pragma unroll 4
        for (; t + 1 < n; t += 2) {
          const float2 va = pd_pair<T>(vrow + (size_t)t * D);
          const float2 vb = pd_pair<T>(vrow + (size_t)(t + 1) * D);
          a0 = fmaf(pg[t], va.x, a0);
          a1 = fmaf(pg[t], va.y, a1);
          b0 = fmaf(pg[t + 1], vb.x, b0);
          b1 = fmaf(pg[t + 1], vb.y, b1);
        }
        if (t < n) {
          const float2 va = pd_pair<T>(vrow + (size_t)t * D);
          a0 = fmaf(pg[t], va.x, a0);
          a1 = fmaf(pg[t], va.y, a1);
        }
        a0 += b0;
        a1 += b1;
      }
      acc[2 * i] = a0;
      acc[2 * i + 1] = a1;
    }
  }
  cp_async_wait<0>();

  const int64_t split0 = (int64_t)z * p.B * p.H;
  if (warp < G && lane == 0) {
    p.m[split0 + head0 + warp] = m_r;
    p.l[split0 + head0 + warp] = l_r;
  }
#pragma unroll
  for (int i = 0; i < PD_MAXPAIRS; ++i) {
    const int pr = tid + i * PD_THREADS;
    if (pr >= npairs) break;
    *reinterpret_cast<float2*>(p.o + (split0 + head0) * D + 2 * pr) =
        make_float2(acc[2 * i], acc[2 * i + 1]);
  }
}

// One block per (slot, query head): out = sum_s o_s e^(m_s - m) /
// max(sum_s l_s e^(m_s - m), 1e-30), m = max_s m_s, the splits in order.
__global__ void __launch_bounds__(PD_THREADS)
    paged_merge_kernel(const float* o, const float* m, const float* l, void* out, int S,
                       int BH, int D, int dt) {
  __shared__ float ms[PD_MAX_SPLITS], ls[PD_MAX_SPLITS], corr[PD_MAX_SPLITS];
  __shared__ float l_all;
  const int64_t bh = blockIdx.x;
  if (threadIdx.x < S) {
    ms[threadIdx.x] = m[threadIdx.x * (int64_t)BH + bh];
    ls[threadIdx.x] = l[threadIdx.x * (int64_t)BH + bh];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m_all = NEG_INF_F, la = 0.f;
    for (int s = 0; s < S; ++s) m_all = fmaxf(m_all, ms[s]);
    for (int s = 0; s < S; ++s) {
      corr[s] = expf(ms[s] - m_all);
      la += ls[s] * corr[s];
    }
    l_all = fmaxf(la, 1e-30f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += PD_THREADS) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) a = fmaf(o[(s * (int64_t)BH + bh) * D + d], corr[s], a);
    st_elem(out, bh * D + d, dt, a / l_all);
  }
}

template <typename T>
static cudaError_t launch_paged_t(const PDParams& p, int splits, size_t smem, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               PD_SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  dim3 grid(p.KV, p.B, splits);
  paged_decode_kernel<T><<<grid, PD_THREADS, smem, s>>>(p);
  return cudaGetLastError();
}

static int launch_paged(const PDParams& p, int splits, int dt, void* stream) {
  const int G = p.KV > 0 ? p.H / p.KV : 0;
  const int esize = dt == DT_BF16 ? 2 : 4;
  const uintptr_t align = reinterpret_cast<uintptr_t>(p.k_pool) |
                          reinterpret_cast<uintptr_t>(p.v_pool) | reinterpret_cast<uintptr_t>(p.o);
  const int cr = p.D * esize / 16;  // 16-byte columns of a row: 2 cr must divide the block
  if (G < 1 || p.H % p.KV || G > PD_MAXG || G * p.D > 2 * PD_MAXPAIRS * PD_THREADS ||
      (p.D * esize) % 16 || cr < 1 || PD_THREADS % (2 * cr) || align % 16 || splits < 1 ||
      p.per < 1 || (int64_t)p.per * splits < p.MB)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pd_smem_bytes(G, p.D, p.BS, p.per, esize);
  if (smem > PD_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dt == DT_BF16 ? launch_paged_t<__nv_bfloat16>(p, splits, smem, s)
                             : launch_paged_t<float>(p, splits, smem, s));
}

extern "C" int repro_paged_decode_partials(const void* q, const void* k_pool,
                                           const void* v_pool, const int* tables,
                                           const int* lengths, float* o, float* m,
                                           float* l, int B, int H, int KV, int D,
                                           int BS, int MB, int splits, int dt,
                                           float sm_scale, void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const int per = (MB + splits - 1) / splits;
  PDParams p{q, k_pool, v_pool, tables, lengths, o, m, l,
             B, H, KV, D, BS, MB, per, sm_scale};
  return launch_paged(p, splits, dt, stream);
}

// The normalized entry point: the partials of `splits` ranges (one or more)
// go to the caller's scratch (o_part [S, B, H, D], m_part / l_part [S, B, H])
// and the merge kernel normalizes them into o at q's dtype.
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const int* tables,
                                            const int* lengths, void* o, float* o_part,
                                            float* m_part, float* l_part, int B, int H,
                                            int KV, int D, int BS, int MB, int splits,
                                            int dt, float sm_scale, void* stream) {
  if (!o_part || !m_part || !l_part || splits < 1 || splits > PD_MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const int e = repro_paged_decode_partials(q, k_pool, v_pool, tables, lengths, o_part,
                                            m_part, l_part, B, H, KV, D, BS, MB, splits,
                                            dt, sm_scale, stream);
  if (e != 0) return e;
  paged_merge_kernel<<<B * H, PD_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      o_part, m_part, l_part, o, splits, B * H, D, dt);
  return (int)cudaGetLastError();
}
extern "C" int repro_paged_decode_merge(const float* o, const float* m, const float* l,
                                        void* out, int B, int H, int D, int splits, int dt,
                                        void* stream) {
  if (splits < 1 || splits > PD_MAX_SPLITS || D < 1) return (int)cudaErrorInvalidValue;
  paged_merge_kernel<<<B * H, PD_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      o, m, l, out, splits, B * H, D, dt);
  return (int)cudaGetLastError();
}
