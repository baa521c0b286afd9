// Mamba2 SSD (state-space duality) chunked scan, chunk-parallel on the
// tensor cores.
//
// Replaces the TPU kernels src/repro/kernels/ssd.py:ssd_multihead
// (_ssd_mh_kernel, all heads per (batch, chunk)) and :ssd (_ssd_kernel, one
// head per grid cell).  Both compute one function; the TPU picks between
// them by whether the [H, P, N] state fits its VMEM.  Here one C entry point
// serves both.  Per chunk c of L steps, with cum = inclusive cumsum(dt * A)
// over the chunk and h_c the state entering it:
//     y[t]    = sum_{s<=t} G[t,s] exp(cum_t - cum_s) dt_s x_s         intra
//             + exp(cum_t) (C_t . h_c)                                state in
//             + D x_t                                                 skip
//     h_{c+1} = exp(cum_L) h_c + sum_s exp(cum_L - cum_s) dt_s x_s B_s^T
// with G = C . B^T.  x [Bt, S, H, P] and B, C [Bt, S, N] in bf16 (or all
// three in fp32); dt [Bt, S, H], A and D [H] fp32; y [Bt, S, H, P] in x's
// dtype, h_final [Bt, H, P, N] fp32.
//
// What bounds it on an H100: at the serving shapes (S <= 512, N 16 or 128)
// latency and, in this chunk-parallel form, the bytes of the chunk states
// (an fp32 P x N state per chunk and head, four times the chunk's x), not
// the operations or the bytes of x / B / C.  The first design ran every product on the fp32 FMA units
// from shared memory, recomputed C.B^T in each of 320 blocks a chunk and
// walked the chunks in order inside a block.  This design, three kernels:
//   ssd_state_kernel  grid (H + 1, chunks, Bt): block h < H the chunk's own
//       state S_c = (x * w)^T . B (w_s = exp(cum_L - cum_s) dt_s) on the
//       tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums) and its decay
//       exp(cum_L); block H the chunk's G = C . B^T, once per (batch,
//       chunk).  Every chunk and head in parallel, 36 KB of shared memory
//       a block at N = 128 (bf16).
//   ssd_scan_kernel   one thread a 4-float slice of a (batch, head) state:
//       h_{c+1} = exp(cum_L) h_c + S_c over the chunks, writing h_c over S_c
//       in place and h_final; four chunks' loads in flight at a time.
//   ssd_out_kernel    grid (H, chunks, Bt): y = (G * decay * dt) . x
//       + exp(cum) (C . h_c^T) + D x, both products on the tensor cores; the
//       decay-weighted G is formed in registers as the intra product's A
//       fragments (the flash-attention trick for P), so only x, C and h_c
//       are staged: 61 KB at N = 128 (bf16), three blocks an SM.
// The scan is a second launch (not a chain of blocks waiting on flags):
// the chain would serialize one round trip to L2 per chunk on every
// (batch, head), where the launch costs one pass over the states.  The
// wrapper counts one launch a call.
// Every global load a thread makes for a tile is issued before it waits on
// any (RowVecs): a loop of load-then-store would wait once per vector.
// Precision: B, C and x are exact in bf16, so G and the products with x /
// B / C alone are exact; an fp32 operand (x * w, the decay-weighted G, the
// state h, and x / B / C themselves when they come in fp32) is split into
// bf16 hi + lo, and each product takes hi.hi + lo.hi (+ hi.lo where both
// are split): ~2^-16 of a term against the fp32 reference, not bf16's 2^-8.
// Copies of exact bf16 rows use 16-byte cp.async; rows that are scaled or
// split go through registers, 16 bytes a load.  Any S: the tail chunk is
// padded with dt = 0, x = B = C = 0, which is exact (the decay is exp(0) = 1
// and nothing is added to the state), and its pad rows are not stored.
#include "hopper.cuh"

constexpr int SSD_L = 64;         // chunk length
constexpr int SSD_P = 64;         // head dim the kernels are compiled for
constexpr int SSD_THREADS = 128;  // four warps: warp w owns rows [16w, 16w + 16) of a tile
constexpr int SSD_SCAN_THREADS = 256;
constexpr int SSD_SCAN_BATCH = 4;  // chunks whose states a scan thread loads at once

static_assert(SSD_L == 64 && SSD_P == 64, "four warps of 16 rows; the cumsum gives a lane two steps");

typedef __nv_bfloat16 bf16;

struct SSDParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  float* hout;
  float* states;  // [Bt, nc, H, P, N]: S_c, then (after the scan) h_c
  float* decay;   // [Bt, nc, H]: exp(cum_L)
  float* gmat;    // [Bt, nc, L, L]: C . B^T
  int Bt, S, H, N, nc;
};

// ---------------------------------------------------------------------------
// tensor-core helpers

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments from bf16 tiles in shared memory, rows `ld` elements apart
// (a multiple of 8 plus 8: the eight rows of an 8 x 8 matrix fall in
// distinct banks).  Lane l addresses row l % 8 of matrix l / 8.
//   a_rows: the A fragment (16 x 16 at m0, k0) of a tile stored [m][k]
//   a_cols: the same of a tile stored [k][m] (its transpose)
//   b_rows: B fragments of two n-tiles (n0, n0 + 8) at k0, stored [n][k]
//           (r[0], r[1] the first tile's, r[2], r[3] the second's)
//   b_cols: the same, stored [k][n]
__device__ __forceinline__ void a_rows(uint32_t (&r)[4], const bf16* t, int ld, int m0, int k0) {
  const int l = threadIdx.x % 32;
  ldmatrix_x4(r, smem_u32(t + (m0 + l % 16) * ld + k0 + (l / 16) * 8));
}
__device__ __forceinline__ void a_cols(uint32_t (&r)[4], const bf16* t, int ld, int m0, int k0) {
  const int l = threadIdx.x % 32, i = l / 8;
  ldsm_x4_trans(r, t + (k0 + (i / 2) * 8 + l % 8) * ld + m0 + (i % 2) * 8);
}
__device__ __forceinline__ void b_rows(uint32_t (&r)[4], const bf16* t, int ld, int n0, int k0) {
  const int l = threadIdx.x % 32, i = l / 8;
  ldmatrix_x4(r, smem_u32(t + (n0 + (i / 2) * 8 + l % 8) * ld + k0 + (i % 2) * 8));
}
__device__ __forceinline__ void b_cols(uint32_t (&r)[4], const bf16* t, int ld, int n0, int k0) {
  const int l = threadIdx.x % 32, i = l / 8;
  ldsm_x4_trans(r, t + (k0 + (i % 2) * 8 + l % 8) * ld + n0 + (i / 2) * 8);
}

// acc[two n-tiles] += A . B over one k16 step, with the A and B parts
// given (lo parts null where the operand is exact in bf16): hi.hi + lo.hi +
// hi.lo.
__device__ __forceinline__ void mma_split(float (&d0)[4], float (&d1)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], bool a_split,
                                          const uint32_t (&bh)[4], const uint32_t (&bl)[4],
                                          bool b_split) {
  mma_bf16(d0, ah, bh[0], bh[1]);
  mma_bf16(d1, ah, bh[2], bh[3]);
  if (a_split) {
    mma_bf16(d0, al, bh[0], bh[1]);
    mma_bf16(d1, al, bh[2], bh[3]);
  }
  if (b_split) {
    mma_bf16(d0, ah, bl[0], bl[1]);
    mma_bf16(d1, ah, bl[2], bl[3]);
  }
}

// ---------------------------------------------------------------------------
// staging rows into shared memory

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, SSD_L) of W bf16 columns, row t at src + off + t * ld (zero for
// t >= len), into the tile dst [SSD_L][W + 8]: 16-byte cp.async, waited
// for by cp_async_commit_wait_all.
template <int W>
__device__ __forceinline__ void copy_rows(bf16* dst, const void* src, int64_t off, int64_t ld,
                                          int len) {
  constexpr int VPR = W / 8;  // 16-byte vectors a row
  const bf16* s = reinterpret_cast<const bf16*>(src);
  for (int i = threadIdx.x; i < SSD_L * VPR; i += SSD_THREADS) {
    const int t = i / VPR, v = (i % VPR) * 8;
    const bool in = t < len;
    cp_async16_zfill(dst + t * (W + 8) + v, in ? s + off + t * ld + v : s, in);
  }
}

__device__ __forceinline__ uint32_t split2(float a, float b, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  lo = pack2(a - hf.x, b - hf.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// This thread's 16-byte vectors of a tile of SSD_L rows of W columns (bf16
// or, F32, fp32), row t at src + off + t * ld (zero for t >= len): every
// load is issued by load() before split_store() waits on any of them.
template <int W, bool F32>
struct RowVecs {
  static constexpr int EPV = F32 ? 4 : 8;  // elements of a 16-byte vector
  static constexpr int VPR = W / EPV;      // vectors a row
  static constexpr int IT = SSD_L * VPR / SSD_THREADS;
  static_assert(IT * SSD_THREADS == SSD_L * VPR, "whole vectors a thread");
  uint4 v[IT];

  __device__ __forceinline__ void load(const void* src, int64_t off, int64_t ld, int len) {
    const size_t es = F32 ? 4 : 2;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * SSD_THREADS, t = i / VPR, c = (i % VPR) * EPV;
      v[it] = t < len ? *reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(src) +
                                                        (off + t * ld + c) * es)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the vectors (each row scaled by rs[t] when rs is given) split into
  // bf16 hi + lo tiles [SSD_L][W + 8]
  __device__ __forceinline__ void split_store(bf16* hi, bf16* lo, const float* rs) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * SSD_THREADS, t = i / VPR, c = (i % VPR) * EPV;
      float f[EPV];
      if constexpr (F32) {
        f[0] = __uint_as_float(v[it].x), f[1] = __uint_as_float(v[it].y);
        f[2] = __uint_as_float(v[it].z), f[3] = __uint_as_float(v[it].w);
      } else {
        unpack8(v[it], f);
      }
      if (rs) {
        const float sc = rs[t];
#pragma unroll
        for (int e = 0; e < EPV; ++e) f[e] *= sc;
      }
      uint32_t h[EPV / 2], l[EPV / 2];
#pragma unroll
      for (int e = 0; e < EPV / 2; ++e) h[e] = split2(f[2 * e], f[2 * e + 1], l[e]);
      bf16* dh = hi + t * (W + 8) + c;
      bf16* dl = lo + t * (W + 8) + c;
      if constexpr (F32) {
        *reinterpret_cast<uint2*>(dh) = make_uint2(h[0], h[1]);
        *reinterpret_cast<uint2*>(dl) = make_uint2(l[0], l[1]);
      } else {
        *reinterpret_cast<uint4*>(dh) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(dl) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  }
};

// W columns of rows from x / B / C: exact bf16 rows by cp.async into hi
// (waited for by cp_async_commit_wait_all); fp32 rows split into hi + lo.
template <int W, bool F32>
__device__ __forceinline__ void stage_rows(bf16* hi, bf16* lo, const void* src, int64_t off,
                                           int64_t ld, int len) {
  if constexpr (F32) {
    RowVecs<W, true> v;
    v.load(src, off, ld, len);
    v.split_store(hi, lo, nullptr);
  } else {
    copy_rows<W>(hi, src, off, ld, len);
  }
}

// Warp 0: dt of the chunk's steps (0 past len), cum = inclusive cumsum of
// dt * A into cum[], and dt into dts[]; returns cum_L on every lane of
// warp 0.
__device__ __forceinline__ float chunk_cumsum(const SSDParams& p, int64_t row0, int len, int h,
                                              float* cum, float* dts) {
  const int lane = threadIdx.x;
  const float A = p.A[h];
  const float d0 = lane < len ? p.dt[(row0 + lane) * p.H + h] : 0.f;
  const float d1 = lane + 32 < len ? p.dt[(row0 + lane + 32) * p.H + h] : 0.f;
  float a0 = d0 * A, a1 = d1 * A;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, a0, o);
    const float u1 = __shfl_up_sync(0xffffffffu, a1, o);
    if (lane >= o) {
      a0 += u0;
      a1 += u1;
    }
  }
  a1 += __shfl_sync(0xffffffffu, a0, 31);
  cum[lane] = a0;
  cum[lane + 32] = a1;
  dts[lane] = d0;
  dts[lane + 32] = d1;
  return __shfl_sync(0xffffffffu, a1, 31);
}

// ---------------------------------------------------------------------------
// 1. the chunk's own state and decay; G = C . B^T in one more block a chunk

template <int N, bool F32>
struct StateSmem {
  static constexpr int LX = SSD_P + 8, LN = N + 8, PARTS = F32 ? 2 : 1;
  static constexpr int b_elems = PARTS * SSD_L * LN;  // B (hi, lo)
  static constexpr int x_elems = 2 * SSD_L * LX;      // x * w (hi, lo): state blocks
  static constexpr int c_elems = PARTS * SSD_L * LN;  // C (hi, lo): the G block
  static constexpr int o_elems = x_elems > c_elems ? x_elems : c_elems;
  static constexpr int bytes = (b_elems + o_elems) * 2 + 3 * SSD_L * 4;  // + cum, dt, w
};

// grid (H + 1, chunks, Bt): block x < H the chunk's state of head x, block
// x = H the chunk's G
template <int N, bool F32>
__global__ void __launch_bounds__(SSD_THREADS) ssd_state_kernel(const SSDParams p) {
  using SM = StateSmem<N, F32>;
  constexpr int LX = SM::LX, LN = SM::LN;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* bh = reinterpret_cast<bf16*>(smem);  // B, [s][n]
  bf16* bl = bh + SSD_L * LN;
  bf16* other = bh + SM::b_elems;            // x * w [s][p], or C [t][n]
  float* cum = reinterpret_cast<float*>(other + SM::o_elems);
  float* dts = cum + SSD_L;
  float* w = dts + SSD_L;

  const int c = blockIdx.y, b = blockIdx.z;
  const int H = p.H, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int len = min(SSD_L, p.S - c * SSD_L);
  const int64_t row0 = (int64_t)b * p.S + c * SSD_L;  // (batch, time) row of step 0

  stage_rows<N, F32>(bh, bl, p.B, row0 * N, N, len);
  if ((int)blockIdx.x == H) {  // G[t, s] = C_t . B_s: warp w owns t in [16w, 16w + 16)
    bf16* ch = other;
    bf16* cl = other + SSD_L * LN;
    stage_rows<N, F32>(ch, cl, p.C, row0 * N, N, len);
    cp_async_commit_wait_all();
    __syncthreads();
    float acc[SSD_L / 8][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t ah[4], al[4];
      a_rows(ah, ch, LN, 16 * warp, k0);
      if (F32) a_rows(al, cl, LN, 16 * warp, k0);
#pragma unroll
      for (int n0 = 0; n0 < SSD_L; n0 += 16) {
        uint32_t bhf[4], blf[4];
        b_rows(bhf, bh, LN, n0, k0);
        if (F32) b_rows(blf, bl, LN, n0, k0);
        mma_split(acc[n0 / 8], acc[n0 / 8 + 1], ah, al, F32, bhf, blf, F32);
      }
    }
    float* gm = p.gmat + ((int64_t)b * p.nc + c) * SSD_L * SSD_L;
#pragma unroll
    for (int j = 0; j < SSD_L / 8; ++j) {
      const int t = 16 * warp + g, s = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(gm + t * SSD_L + s) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(gm + (t + 8) * SSD_L + s) = make_float2(acc[j][2], acc[j][3]);
    }
    return;
  }

  const int h = blockIdx.x;
  bf16* xh = other;  // x * w, [s][p]
  bf16* xl = other + SSD_L * LX;
  RowVecs<SSD_P, F32> xv;
  xv.load(p.x, (row0 * H + h) * SSD_P, (int64_t)H * SSD_P, len);
  if (warp == 0) {
    const float last = chunk_cumsum(p, row0, len, h, cum, dts);
    w[lane] = expf(last - cum[lane]) * dts[lane];
    w[lane + 32] = expf(last - cum[lane + 32]) * dts[lane + 32];
    if (lane == 0) p.decay[((int64_t)b * p.nc + c) * H + h] = expf(last);
  }
  __syncthreads();  // w
  xv.split_store(xh, xl, w);
  cp_async_commit_wait_all();
  __syncthreads();

  // S_c[p, n] = sum_s (x w)[s, p] B[s, n]: warp w owns p in [16w, 16w + 16)
  float acc[N / 8][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < SSD_L; k0 += 16) {
    uint32_t ah[4], al[4];
    a_cols(ah, xh, LX, 16 * warp, k0);
    a_cols(al, xl, LX, 16 * warp, k0);
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      uint32_t bhf[4], blf[4];
      b_cols(bhf, bh, LN, n0, k0);
      if (F32) b_cols(blf, bl, LN, n0, k0);
      mma_split(acc[n0 / 8], acc[n0 / 8 + 1], ah, al, true, bhf, blf, F32);
    }
  }
  float* st = p.states + (((int64_t)b * p.nc + c) * H + h) * SSD_P * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int pr = 16 * warp + g, n = 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(st + pr * N + n) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(st + (pr + 8) * N + n) = make_float2(acc[j][2], acc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// 2. the scan over chunks: h_c (the state entering chunk c) over S_c

// The scan is a stream of loads, and what bounds it is how many are in
// flight: three blocks an SM, four chunks' loads a thread at a time.
__global__ void __launch_bounds__(SSD_SCAN_THREADS, 3) ssd_scan_kernel(const SSDParams p) {
  const int per = SSD_P * p.N / 4;  // float4 slices of one (batch, head) state
  const int64_t q = (int64_t)blockIdx.x * SSD_SCAN_THREADS + threadIdx.x;
  if (q >= (int64_t)p.Bt * p.H * per) return;
  const int bh = (int)(q / per), e = (int)(q % per);
  const int b = bh / p.H, h = bh % p.H;
  // chunk c of this slice at st[c * cstride], its decay at dc[c * p.H]
  const int64_t cstride = (int64_t)p.H * per;
  float4* st = reinterpret_cast<float4*>(p.states) + ((int64_t)b * p.nc * p.H + h) * per + e;
  const float* dc = p.decay + (int64_t)b * p.nc * p.H + h;
  float4 hc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += SSD_SCAN_BATCH) {
    float4* sb = st + c0 * cstride;
    const float* db = dc + (int64_t)c0 * p.H;
    float4 s[SSD_SCAN_BATCH];
    float d[SSD_SCAN_BATCH];
#pragma unroll
    for (int j = 0; j < SSD_SCAN_BATCH; ++j)
      if (c0 + j < p.nc) {
        s[j] = sb[j * cstride];
        d[j] = db[j * p.H];
      }
#pragma unroll
    for (int j = 0; j < SSD_SCAN_BATCH; ++j)
      if (c0 + j < p.nc) {
        sb[j * cstride] = hc;
        hc = make_float4(d[j] * hc.x + s[j].x, d[j] * hc.y + s[j].y, d[j] * hc.z + s[j].z,
                         d[j] * hc.w + s[j].w);
      }
  }
  reinterpret_cast<float4*>(p.hout)[(int64_t)bh * per + e] = hc;
}

// ---------------------------------------------------------------------------
// 3. the chunk's output

template <int N, bool F32>
struct OutSmem {
  static constexpr int LX = SSD_P + 8, LN = N + 8, PARTS = F32 ? 2 : 1;
  static constexpr int x_elems = PARTS * SSD_L * LX;  // x (hi, lo), [s][p]
  static constexpr int c_elems = PARTS * SSD_L * LN;  // C (hi, lo), [t][n]
  static constexpr int h_elems = 2 * SSD_P * LN;      // h_c (hi, lo), [p][n]
  static constexpr int bytes = (x_elems + c_elems + h_elems) * 2 + 3 * SSD_L * 4;
};

// grid (H, chunks, Bt).  The decay-weighted G is formed in registers as the
// A fragments of the intra product (warp w's rows, k-steps up to its
// diagonal), from G read straight from L2.
template <int N, bool F32>
__global__ void __launch_bounds__(SSD_THREADS) ssd_out_kernel(const SSDParams p) {
  using SM = OutSmem<N, F32>;
  constexpr int LX = SM::LX, LN = SM::LN;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* xh = reinterpret_cast<bf16*>(smem);
  bf16* xl = xh + SSD_L * LX;
  bf16* ch = xh + SM::x_elems;
  bf16* cl = ch + SSD_L * LN;
  bf16* hh = ch + SM::c_elems;
  bf16* hl = hh + SSD_P * LN;
  float* cum = reinterpret_cast<float*>(hh + SM::h_elems);
  float* dts = cum + SSD_L;
  float* ecum = dts + SSD_L;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int H = p.H, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, t0 = 16 * warp + g;
  const int len = min(SSD_L, p.S - c * SSD_L);
  const int64_t row0 = (int64_t)b * p.S + c * SSD_L;
  const int64_t xoff = (row0 * H + h) * SSD_P, xld = (int64_t)H * SSD_P;
  const bool state_in = c > 0;  // h_0 = 0

  stage_rows<SSD_P, F32>(xh, xl, p.x, xoff, xld, len);
  stage_rows<N, F32>(ch, cl, p.C, row0 * N, N, len);
  // G at this thread's A-fragment places: register r of k-step kk holds
  // row t0 + 8 (r % 2), columns 16 kk + 8 (r / 2) + 2 tq and the next
  float2 gv[SSD_L / 16][4];
  const float* gm = p.gmat + ((int64_t)b * p.nc + c) * SSD_L * SSD_L;
#pragma unroll
  for (int kk = 0; kk < SSD_L / 16; ++kk)
    if (kk <= warp)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        gv[kk][r] = *reinterpret_cast<const float2*>(
            gm + (t0 + 8 * (r % 2)) * SSD_L + 16 * kk + 8 * (r / 2) + 2 * tq);
  RowVecs<N, true> hv;
  if (state_in)
    hv.load(p.states, (((int64_t)b * p.nc + c) * H + h) * SSD_P * N, N, SSD_P);
  if (warp == 0) {
    chunk_cumsum(p, row0, len, h, cum, dts);
    ecum[lane] = expf(cum[lane]);
    ecum[lane + 32] = expf(cum[lane + 32]);
  }
  if (state_in) hv.split_store(hh, hl, nullptr);
  cp_async_commit_wait_all();
  __syncthreads();

  // M[t, s] = G[t, s] exp(cum_t - cum_s) dt_s for s <= t, else 0, split
  uint32_t mh[SSD_L / 16][4], ml[SSD_L / 16][4];
#pragma unroll
  for (int kk = 0; kk < SSD_L / 16; ++kk)
    if (kk <= warp)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + 8 * (r % 2), s = 16 * kk + 8 * (r / 2) + 2 * tq;
        const float ct = cum[t];
        const float m0 = s <= t ? gv[kk][r].x * expf(ct - cum[s]) * dts[s] : 0.f;
        const float m1 = s + 1 <= t ? gv[kk][r].y * expf(ct - cum[s + 1]) * dts[s + 1] : 0.f;
        mh[kk][r] = split2(m0, m1, ml[kk][r]);
      }

  // warp w owns output rows t in [16w, 16w + 16), all P columns
  float yi[SSD_P / 8][4] = {}, ys[SSD_P / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < SSD_L / 16; ++kk)  // intra: only s <= t
    if (kk <= warp)
#pragma unroll
      for (int n0 = 0; n0 < SSD_P; n0 += 16) {
        uint32_t bhf[4], blf[4];
        b_cols(bhf, xh, LX, n0, 16 * kk);
        if (F32) b_cols(blf, xl, LX, n0, 16 * kk);
        mma_split(yi[n0 / 8], yi[n0 / 8 + 1], mh[kk], ml[kk], true, bhf, blf, F32);
      }
  if (state_in) {  // C_t . h_c^T
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t ah[4], al[4];
      a_rows(ah, ch, LN, 16 * warp, k0);
      if (F32) a_rows(al, cl, LN, 16 * warp, k0);
#pragma unroll
      for (int n0 = 0; n0 < SSD_P; n0 += 16) {
        uint32_t bhf[4], blf[4];
        b_rows(bhf, hh, LN, n0, k0);
        b_rows(blf, hl, LN, n0, k0);
        mma_split(ys[n0 / 8], ys[n0 / 8 + 1], ah, al, F32, bhf, blf, true);
      }
    }
  }

  const float Dh = p.D[h];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + 8 * half;
    if (t >= len) continue;
    const float e = ecum[t];
#pragma unroll
    for (int j = 0; j < SSD_P / 8; ++j) {
      const int pc = 8 * j + 2 * tq;
      const int64_t o = xoff + t * xld + pc;
      float x0, x1;
      if constexpr (F32) {
        const float2 xv = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(p.x) + o);
        x0 = xv.x, x1 = xv.y;
      } else {
        const float2 xv = unpack2(*reinterpret_cast<const uint32_t*>(xh + t * LX + pc));
        x0 = xv.x, x1 = xv.y;
      }
      const float v0 = yi[j][2 * half] + e * ys[j][2 * half] + Dh * x0;
      const float v1 = yi[j][2 * half + 1] + e * ys[j][2 * half + 1] + Dh * x1;
      if constexpr (F32)
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.y) + o) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(p.y) + o) = pack2(v0, v1);
    }
  }
}

// ---------------------------------------------------------------------------

template <int N, bool F32>
static int launch_ssd(const SSDParams& p, cudaStream_t s) {
  static bool configured = false;  // the shared-memory opt-in, once per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ssd_state_kernel<N, F32>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         StateSmem<N, F32>::bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_out_kernel<N, F32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               OutSmem<N, F32>::bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  ssd_state_kernel<N, F32>
      <<<dim3(p.H + 1, p.nc, p.Bt), SSD_THREADS, StateSmem<N, F32>::bytes, s>>>(p);
  const int64_t slices = (int64_t)p.Bt * p.H * SSD_P * p.N / 4;
  ssd_scan_kernel<<<(unsigned)((slices + SSD_SCAN_THREADS - 1) / SSD_SCAN_THREADS),
                    SSD_SCAN_THREADS, 0, s>>>(p);
  ssd_out_kernel<N, F32>
      <<<dim3(p.H, p.nc, p.Bt), SSD_THREADS, OutSmem<N, F32>::bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool F32>
static int launch_for_width(const SSDParams& p, cudaStream_t s) {
  switch (p.N) {
    case 16: return launch_ssd<16, F32>(p, s);
    case 32: return launch_ssd<32, F32>(p, s);
    case 64: return launch_ssd<64, F32>(p, s);
    case 128: return launch_ssd<128, F32>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// states [Bt, nc, H, P, N], decay [Bt, nc, H] and gmat [Bt, nc, L, L] are
// fp32 scratch the caller allocates (nc = ceil(S / L)); every pointer is
// 16-byte aligned.  P must be SSD_P, N one of 16 / 32 / 64 / 128, and x,
// B, C of one dtype.
extern "C" int repro_ssd(const void* x, const float* dt, const float* A, const void* B,
                         const void* C, const float* D, void* y, float* hout, float* states,
                         float* decay, float* gmat, int Bt, int S, int H, int P, int N, int x_dt,
                         int bc_dt, void* stream) {
  if (Bt == 0 || S == 0 || H == 0) return 0;
  if (P != SSD_P || x_dt != bc_dt || (x_dt != DT_F32 && x_dt != DT_BF16))
    return (int)cudaErrorInvalidValue;
  const int nc = (S + SSD_L - 1) / SSD_L;
  const SSDParams prm{x, dt, A, B, C, D, y, hout, states, decay, gmat, Bt, S, H, N, nc};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return x_dt == DT_F32 ? launch_for_width<true>(prm, s) : launch_for_width<false>(prm, s);
}
