// Single-token decode attention: the stage ring shared by the paged decode
// (paged_decode.cu) and the dense decode (decode_attention.cu).
//
// One block of DF_THREADS threads owns one (kv head, slot, split) triple and
// the G = H / KV query heads of its kv head.  The KV rows it folds come in
// pages: runs of at most BS consecutive rows of which rows [lo, hi) are
// valid.  A row source says where page i starts and which of its rows are
// valid:
//   PagedRows  page i is the i-th live entry of the block's range of the
//              block table (compacted into shared memory first), BS the
//              pool's block size (compiled in where the launcher knows
//              it), lo = 0;
//   DenseRows  page i is the i-th run of DF_STAGE_TOKENS positions of the
//              block's position range, aligned to DF_STAGE_TOKENS and
//              clipped to [max(range start, length - window),
//              min(range end, length)): the lower bound of positions that
//              a window gives.
// A stage holds P = max(1, DF_STAGE_TOKENS / BS) pages; DF_STAGES stages
// are in flight with 16-byte cp.async, only the valid rows copied.  Each
// stage is folded with three barriers: 8 lanes a key row score it for all G
// query heads (16-byte shared loads, a 3-step shuffle reduction), one warp a
// query head folds the stage's pages into (m, l) in page order (a rescale
// per page, P rounded to V's dtype after the running max), and each thread
// accumulates a pair of output dimensions of one head with bf16x2 / float2
// reads of V, applying each page's rescale.  The block writes fp32 partials
// (o unnormalized, m, l) of its split; dec_merge_kernel folds the splits'
// partials into the normalized output at q's dtype (the online-softmax
// merge of the reference's core/attention.py:merge_partials).
//
// Int8 pools (T = int8_t, paged only): the rows are staged at one byte an
// element, and each pool block carries one fp32 scale a kv head for K and
// one for V (`ks`, `vs` [NB, KV]), the TPU kernel's quantized fold
// (src/repro/kernels/flash_decode.py:_online_merge): a page's scores are
// (q . k_int8) * sm_scale * ks[block, h] in fp32, P stays fp32, and the
// page's P.V (on the widened int8 values, in fp32) is multiplied by
// vs[block, h] before it joins the rescaled accumulator.
#pragma once

#include "common.cuh"

constexpr int DF_THREADS = 256;
constexpr int DF_WARPS = DF_THREADS / 32;   // a warp for each query head's statistics
constexpr int DF_STAGES = 3;                // stages of pages in flight
constexpr int DF_STAGE_TOKENS = 32;         // tokens a stage holds at least
constexpr int DF_LPT = 8;                   // lanes scoring one key row
constexpr int DF_ROWS = 32 / DF_LPT;        // key rows a warp scores at once
constexpr int DF_MAXG = 8;                  // query heads per kv head
static_assert(DF_WARPS >= DF_MAXG, "one warp a query head");
constexpr int DF_MAXPAIRS = 4;              // (G * D / 2) / DF_THREADS upper bound
constexpr int DF_SMEM_MAX = 226 * 1024;     // dynamic shared memory (227 KB less static)
constexpr int DF_MAX_SPLITS = 64;           // splits the merge kernel takes

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

// pages of one stage: enough for DF_STAGE_TOKENS tokens
__host__ __device__ inline int df_pages(int BS) {
  return BS >= DF_STAGE_TOKENS ? 1 : DF_STAGE_TOKENS / BS;
}

__host__ __device__ inline size_t df_ring_bytes(int BS, int D, int esize) {
  return (size_t)DF_STAGES * df_pages(BS) * 2 * BS * D * esize;
}

// shared memory of the fold: the ring, then fp32 Qs [G][D], Ss [G][stage
// tokens] (scores, then P), Cs [G][pages] (each page's rescale); a row
// source's own `extra` bytes follow
__host__ __device__ inline size_t df_smem_bytes(int G, int D, int BS, int esize,
                                                size_t extra) {
  const int tok = df_pages(BS) * BS;
  return df_ring_bytes(BS, D, esize) +
         (size_t)(G * D + G * tok + G * df_pages(BS)) * sizeof(float) + extra;
}

// The operands every row source shares.  Row r of kv head h of the K / V
// rows lies at (r * KV + h) * D: a pool [NB, BS, KV, D] (r = block * BS +
// token) or a dense cache [B, S, KV, D] (r = slot * S + position).
struct DecFold {
  const void* q;   // [B, H, D]
  const void* k;
  const void* v;
  float* o;        // partials: o [splits, B, H, D], m / l [splits, B, H]
  float* m;
  float* l;
  int B, H, KV, D;
  float sm_scale;
  const float* ks;  // int8 pools: the scales [NB, KV] of K and V
  const float* vs;
  int q_dt;         // int8 pools: q's dtype (otherwise the pools')
};

// Block tables: the live entries of table entries [e0, e1) of one slot, in
// pool blocks of kBS tokens (kBS = 0: the block size BS is read at run
// time; a compiled size turns the fold's divisions by it into shifts).
template <int kBS>
struct PagedRows {
  static constexpr bool kKnown = false;  // warp 0 compacts the live list first
  const int* table;  // the slot's row of the block table
  int BS, len, e0, e1;
  int* ents;         // shared: live entries, then their pool blocks
  int* blks;
  int* nlive;
  __device__ __forceinline__ int bs() const { return kBS ? kBS : BS; }
  __device__ __forceinline__ int pages() const { return df_pages(bs()); }
  // warp 0 compacts the range's live entries, in order
  __device__ __forceinline__ void prepare(int lane) {
    int count = 0;
    for (int c = e0; c < e1; c += 32) {
      const int e = c + lane;
      const int t = e < e1 ? table[e] : -1;
      const bool live = t >= 0 && e * bs() < len;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int at = count + __popc(mask & ((1u << lane) - 1));
        ents[at] = e;
        blks[at] = t;
      }
      count += __popc(mask);
    }
    if (lane == 0) *nlive = count;
  }
  __device__ __forceinline__ int count() const { return *nlive; }
  __device__ __forceinline__ int64_t row0(int i) const { return (int64_t)blks[i] * bs(); }
  __device__ __forceinline__ int blk(int i) const { return blks[i]; }
  __device__ __forceinline__ void span(int i, int& lo, int& hi) const {
    lo = 0;
    hi = min(bs(), len - ents[i] * bs());
  }
};

// A dense cache: the valid positions [first, end) of one slot's range, in
// stages aligned to DF_STAGE_TOKENS from p0 = first rounded down.
struct DenseRows {
  static constexpr bool kKnown = true;
  int64_t slot_row;  // b * S
  int p0, first, end;
  __device__ __forceinline__ int bs() const { return DF_STAGE_TOKENS; }
  __device__ __forceinline__ int pages() const { return 1; }
  __device__ __forceinline__ void prepare(int) {}
  __device__ __forceinline__ int count() const {
    return (end - p0 + DF_STAGE_TOKENS - 1) / DF_STAGE_TOKENS;
  }
  __device__ __forceinline__ int64_t row0(int i) const {
    return slot_row + p0 + i * DF_STAGE_TOKENS;
  }
  __device__ __forceinline__ int blk(int) const { return 0; }  // no scales
  __device__ __forceinline__ void span(int i, int& lo, int& hi) const {
    const int s = p0 + i * DF_STAGE_TOKENS;
    lo = max(0, first - s);
    hi = min(DF_STAGE_TOKENS, end - s);
  }
};

template <typename T>
__device__ __forceinline__ void df_unpack(const uint4 u, float (&w)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 1) {
    const uint32_t x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = i8_to_f32(x[j >> 2], j & 3);
  } else if constexpr (sizeof(T) == 2) {
    unpack8(u, w);
  } else {
    w[0] = __uint_as_float(u.x);
    w[1] = __uint_as_float(u.y);
    w[2] = __uint_as_float(u.z);
    w[3] = __uint_as_float(u.w);
  }
}

template <typename T>
__device__ __forceinline__ float2 df_pair(const T* p) {
  if constexpr (sizeof(T) == 1) {
    const uint32_t u = *reinterpret_cast<const uint16_t*>(p);
    return make_float2(i8_to_f32(u, 0), i8_to_f32(u, 1));
  } else if constexpr (sizeof(T) == 2) {
    return unpack2(*reinterpret_cast<const uint32_t*>(p));
  } else {
    return *reinterpret_cast<const float2*>(p);
  }
}

// The block's partials of split z: m, l of its G heads and o of its G * D
// outputs (acc: this thread's pairs).
__device__ __forceinline__ void df_store(const DecFold& f, int kvh, int b, int z, float m_r,
                                         float l_r, const float (&acc)[2 * DF_MAXPAIRS]) {
  const int G = f.H / f.KV, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t head0 = (int64_t)b * f.H + kvh * G;
  const int64_t split0 = (int64_t)z * f.B * f.H;
  if (warp < G && lane == 0) {
    f.m[split0 + head0 + warp] = m_r;
    f.l[split0 + head0 + warp] = l_r;
  }
#pragma unroll
  for (int i = 0; i < DF_MAXPAIRS; ++i) {
    const int pr = threadIdx.x + i * DF_THREADS;
    if (pr >= G * f.D / 2) break;
    *reinterpret_cast<float2*>(f.o + (split0 + head0) * f.D + 2 * pr) =
        make_float2(acc[2 * i], acc[2 * i + 1]);
  }
}

// The partials of a split with no valid row: m = -1e30, l = 0, o = 0 (the
// merge weighs it by zero).
__device__ __forceinline__ void df_store_empty(const DecFold& f, int kvh, int b, int z) {
  float acc[2 * DF_MAXPAIRS];
#pragma unroll
  for (int i = 0; i < 2 * DF_MAXPAIRS; ++i) acc[i] = 0.f;
  df_store(f, kvh, b, z, NEG_INF_F, 0.f, acc);
}

// Fold the rows `rows` gives into the partials of (kv head kvh, slot b,
// split z).  `smem`: df_smem_bytes(G, D, rows.bs(), sizeof(T), extra).
template <typename T, class Rows>
__device__ __forceinline__ void dec_fold(const DecFold& f, Rows& rows, uint8_t* smem,
                                         int kvh, int b, int z) {
  constexpr int EPC = 16 / sizeof(T);  // elements of a 16-byte chunk
  constexpr bool kQuant = sizeof(T) == 1;   // int8 pools, with scales
  const int q_dt = kQuant ? f.q_dt : (sizeof(T) == 2 ? DT_BF16 : DT_F32);
  const int G = f.H / f.KV, D = f.D;
  const int BS = rows.bs(), P = rows.pages(), TOK = P * BS;
  const int CR = D / EPC;                          // 16-byte chunks of a row
  T* ring = reinterpret_cast<T*>(smem);            // [stage][page][K, V][BS][D]
  float* Qs = reinterpret_cast<float*>(smem + df_ring_bytes(BS, D, sizeof(T)));
  float* Ss = Qs + G * D;
  float* Cs = Ss + G * TOK;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t head0 = (int64_t)b * f.H + kvh * G;

  // a source whose rows are known before any shared state (kKnown) issues
  // its first stages before the query rows land; the others after warp 0
  // prepared them
  int npages = Rows::kKnown ? rows.count() : 0;
  int nst = (npages + P - 1) / P;

  // copy stage `st`'s pages (their valid rows) into ring slot `slot`: this
  // thread's 16-byte column of the K or V rows (2 CR columns divide the
  // block), every `rstep`-th row
  const int col = tid % (2 * CR), r0 = tid / (2 * CR), rstep = DF_THREADS / (2 * CR);
  const int ckv = col / CR, cch = col % CR;
  const T* src0 = reinterpret_cast<const T*>(ckv ? f.v : f.k) + kvh * D + cch * EPC;
  const int64_t gstride = (int64_t)f.KV * D;
  auto load_stage = [&](int st, int slot) {
    const int i0 = st * P, np = min(P, npages - i0);
    T* base = ring + (size_t)slot * P * 2 * BS * D + (size_t)ckv * BS * D + cch * EPC;
    for (int pi = 0; pi < np; ++pi) {
      int lo, hi;
      rows.span(i0 + pi, lo, hi);
      const T* src = src0 + rows.row0(i0 + pi) * gstride;
      T* dst = base + (size_t)pi * 2 * BS * D;
      for (int r = lo + r0; r < hi; r += rstep)
        cp_async16(dst + (size_t)r * D, src + r * gstride);
    }
  };
  auto first_stages = [&]() {
    for (int s = 0; s < DF_STAGES - 1; ++s) {
      if (s < nst) load_stage(s, s);
      cp_async_commit();
    }
  };

  if constexpr (Rows::kKnown) {
    first_stages();
    for (int i = tid; i < G * D; i += DF_THREADS) Qs[i] = ld_elem(f.q, head0 * D + i, q_dt);
    __syncthreads();
  } else {
    if (warp == 0) {
      rows.prepare(lane);
    } else {
      for (int i = tid - 32; i < G * D; i += DF_THREADS - 32)
        Qs[i] = ld_elem(f.q, head0 * D + i, q_dt);
    }
    __syncthreads();
    npages = rows.count();
    nst = (npages + P - 1) / P;
    first_stages();
  }

  // warp g folds query head g (its m, l in registers)
  float m_r = NEG_INF_F, l_r = 0.f;
  float acc[2 * DF_MAXPAIRS];
#pragma unroll
  for (int i = 0; i < 2 * DF_MAXPAIRS; ++i) acc[i] = 0.f;
  const int npairs = G * D / 2;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<DF_STAGES - 2>();
    __syncthreads();  // stage st landed for every thread; stage st - 1 consumed
    if (st + DF_STAGES - 1 < nst)
      load_stage(st + DF_STAGES - 1, (st + DF_STAGES - 1) % DF_STAGES);
    cp_async_commit();
    const T* kv = ring + (size_t)(st % DF_STAGES) * P * 2 * BS * D;
    const int i0 = st * P, np = min(P, npages - i0);

    // scores: DF_LPT lanes per key row, all G heads at once
    for (int u0 = warp * DF_ROWS; u0 < TOK; u0 += DF_WARPS * DF_ROWS) {
      const int u = u0 + lane / DF_LPT, sub = lane % DF_LPT;
      const int pi = u / BS, r = u % BS;
      int lo, hi;
      rows.span(i0 + min(pi, np - 1), lo, hi);
      const bool valid = u < TOK && pi < np && r >= lo && r < hi;
      float dot[DF_MAXG];
#pragma unroll
      for (int g = 0; g < DF_MAXG; ++g) dot[g] = 0.f;
      if (valid) {
        const T* krow = kv + ((size_t)(pi * 2) * BS + r) * D;
        for (int ch = sub; ch < CR; ch += DF_LPT) {
          float w[EPC];
          df_unpack<T>(*reinterpret_cast<const uint4*>(krow + ch * EPC), w);
#pragma unroll
          for (int g = 0; g < DF_MAXG; ++g) {
            if (g >= G) break;
            const float* qg = Qs + g * D + ch * EPC;
#pragma unroll
            for (int x = 0; x < EPC; ++x) dot[g] = fmaf(qg[x], w[x], dot[g]);
          }
        }
      }
      // int8: the page's K scale, after sm_scale (the TPU kernel's order)
      const float ksc = (kQuant && valid) ? f.ks[(int64_t)rows.blk(i0 + pi) * f.KV + kvh] : 1.f;
#pragma unroll
      for (int g = 0; g < DF_MAXG; ++g) {
        if (g >= G) break;
        float d = dot[g];
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        if (sub == 0 && u < TOK)
          Ss[g * TOK + u] = !valid ? NEG_INF_F : kQuant ? d * f.sm_scale * ksc : d * f.sm_scale;
      }
    }
    __syncthreads();

    // statistics, page by page, warp g for head g; P replaces the scores
    if (warp < G) {
      float* sg = Ss + warp * TOK;
      for (int pi = 0; pi < np; ++pi) {
        int lo, hi;
        rows.span(i0 + pi, lo, hi);
        float* sp = sg + pi * BS;
        float mb = NEG_INF_F;
        for (int t = lo + lane; t < hi; t += 32) mb = fmaxf(mb, sp[t]);
        mb = warp_max(mb);
        const float m_new = fmaxf(m_r, mb);
        float ps = 0.f;
        for (int t = lo + lane; t < hi; t += 32) {
          const float pw = expf(sp[t] - m_new);
          ps += pw;
          sp[t] = sizeof(T) == 2 ? round_bf16(pw) : pw;  // int8 and fp32: P in fp32
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
    for (int i = 0; i < DF_MAXPAIRS; ++i) {
      const int pr = tid + i * DF_THREADS;
      if (pr >= npairs) break;
      const int g = (2 * pr) / D, d = (2 * pr) % D;
      float a0 = acc[2 * i], a1 = acc[2 * i + 1];
      for (int pi = 0; pi < np; ++pi) {
        int lo, hi;
        rows.span(i0 + pi, lo, hi);
        const float c = Cs[g * P + pi];
        a0 *= c;
        a1 *= c;
        const float* pg = Ss + g * TOK + pi * BS;
        const T* vrow = kv + ((size_t)(pi * 2 + 1) * BS) * D + d;
        // even and odd tokens in two chains: half the dependent FMAs; int8
        // sums the page apart, then scales it by the page's V scale
        float e0 = 0.f, e1 = 0.f, b0 = 0.f, b1 = 0.f;
        float& s0 = kQuant ? e0 : a0;
        float& s1 = kQuant ? e1 : a1;
        int t = lo;
#pragma unroll 4
        for (; t + 1 < hi; t += 2) {
          const float2 va = df_pair<T>(vrow + (size_t)t * D);
          const float2 vb = df_pair<T>(vrow + (size_t)(t + 1) * D);
          s0 = fmaf(pg[t], va.x, s0);
          s1 = fmaf(pg[t], va.y, s1);
          b0 = fmaf(pg[t + 1], vb.x, b0);
          b1 = fmaf(pg[t + 1], vb.y, b1);
        }
        if (t < hi) {
          const float2 va = df_pair<T>(vrow + (size_t)t * D);
          s0 = fmaf(pg[t], va.x, s0);
          s1 = fmaf(pg[t], va.y, s1);
        }
        if constexpr (kQuant) {
          const float vsc = f.vs[(int64_t)rows.blk(i0 + pi) * f.KV + kvh];
          a0 = fmaf(e0 + b0, vsc, a0);
          a1 = fmaf(e1 + b1, vsc, a1);
        } else {
          a0 += b0;
          a1 += b1;
        }
      }
      acc[2 * i] = a0;
      acc[2 * i + 1] = a1;
    }
  }
  cp_async_wait<0>();
  df_store(f, kvh, b, z, m_r, l_r, acc);
}

// One block per (slot, query head): out = sum_s o_s e^(m_s - m) /
// max(sum_s l_s e^(m_s - m), 1e-30), m = max_s m_s.  The first warp takes
// the statistics, two splits a lane; every thread then sums its output
// dimensions over the splits in order.
__global__ void __launch_bounds__(DF_THREADS)
    dec_merge_kernel(const float* o, const float* m, const float* l, void* out, int S,
                     int BH, int D, int dt) {
  static_assert(DF_MAX_SPLITS <= 64, "two splits a lane");
  __shared__ float corr[DF_MAX_SPLITS];
  __shared__ float l_all;
  const int64_t bh = blockIdx.x;
  if (threadIdx.x < 32) {
    const int s0 = threadIdx.x, s1 = threadIdx.x + 32;
    const float m0 = s0 < S ? m[s0 * (int64_t)BH + bh] : NEG_INF_F;
    const float m1 = s1 < S ? m[s1 * (int64_t)BH + bh] : NEG_INF_F;
    const float l0 = s0 < S ? l[s0 * (int64_t)BH + bh] : 0.f;
    const float l1 = s1 < S ? l[s1 * (int64_t)BH + bh] : 0.f;
    const float m_all = warp_max(fmaxf(m0, m1));
    const float c0 = expf(m0 - m_all), c1 = expf(m1 - m_all);
    if (s0 < S) corr[s0] = c0;
    if (s1 < S) corr[s1] = c1;
    const float la = warp_sum(l0 * c0 + l1 * c1);
    if (threadIdx.x == 0) l_all = fmaxf(la, 1e-30f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += DF_THREADS) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) a = fmaf(o[(s * (int64_t)BH + bh) * D + d], corr[s], a);
    st_elem(out, bh * D + d, dt, a / l_all);
  }
}

// The checks both launchers share: G = H / KV query heads a kv head (at most
// DF_MAXG), pairs of output dimensions for the block's threads, 16-byte rows
// whose 2 CR columns divide the block, 16-byte aligned K / V / o.
__host__ inline bool df_shape_ok(int H, int KV, int D, int esize, const void* k,
                                 const void* v, const void* o) {
  const int G = KV > 0 ? H / KV : 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
  const int cr = D * esize / 16;
  return G >= 1 && H % KV == 0 && G <= DF_MAXG && G * D <= 2 * DF_MAXPAIRS * DF_THREADS &&
         (D * esize) % 16 == 0 && cr >= 1 && DF_THREADS % (2 * cr) == 0 && align % 16 == 0;
}
