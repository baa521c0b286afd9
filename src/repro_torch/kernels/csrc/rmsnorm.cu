// Row normalization: RMSNorm and LayerNorm with fp32 statistics, alone or
// behind a residual add.
//
// Replaces the TPU kernels src/repro/kernels/rmsnorm.py:rmsnorm (_rms_kernel)
// and :layernorm (_ln_kernel):
//     rmsnorm    y = x * rsqrt(mean(x^2) + eps) * gamma
//     layernorm  y = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * gamma + beta
// over the last dimension of x [R, D], output in x's dtype.  LayerNorm takes
// the mean first, then the variance about that mean, as _ln_kernel does.
// And :residual_rmsnorm / :residual_layernorm (_res_rms_kernel,
// _res_ln_kernel): r = x + y is stored rounded to x's dtype, and h = norm(r)
// takes its statistics over r AS STORED ("norm what was stored"), so h is
// the norm the unfused chain would take of the same residual.  -> (h, r).
//
// What bounds it on an H100: bytes (read x once, write y once; the
// statistics are a few flops per element); with a handful of rows (decode)
// the launch and one round trip to memory.
// norm_kernel: a row is held in registers, so x is read from HBM once and
// both LayerNorm statistics come from the registers.  `tpr` threads a row
// (a power of two from 32 to NORM_MAX_TPR: one warp a row up to
// 32 x NORM_NV 16-byte vectors, 2048 bf16 elements), each holding up to
// NORM_NV 16-byte vectors of the row (vector j at thread j % tpr) with x,
// gamma and beta loaded 16 bytes at a time before the first reduction;
// max(NORM_MIN_BLOCK, tpr) threads a block, so that rows of up to 2048 bf16
// elements share a block and a 512-row prefill is 256 blocks.  Each sum is
// a warp shuffle plus, above a warp, one shared-memory step; y is stored 16
// bytes at a time.  A row that fits no tile (D not a multiple of the
// vector, an operand not 16-byte aligned, more than NORM_MAX_TPR x NORM_NV
// vectors) takes the looped path of the same kernel: one NT-thread block a
// row walking it element by element, its later passes from L1 / L2.
// res_norm_kernel: the same register tile (norm_tile<..., true>).  x and y
// are loaded 16 bytes at a time before anything waits on them, r = x + y
// is rounded to x's dtype in the registers and stored 16 bytes at a time,
// and the statistics and h come from those rounded registers: nothing is
// read back.  gamma and beta are loaded after r is formed, in flight during
// the reductions.  A single decode row is latency (a few round trips to
// memory), so the tile keeps one round trip for x and y where the first
// design chained a load, a store and a read-back per element.  x and y of
// different dtypes take the looped path: r stored first, then the plain
// norm's passes over it.
#include "common.cuh"

enum NormKind { KIND_RMS = 1, KIND_LN = 2 };

constexpr int NT = 128;              // threads a row on the looped paths
constexpr int NORM_NV = 8;           // 16-byte vectors of a row a thread holds
constexpr int NORM_MAX_TPR = 256;    // threads a row on the register path
constexpr int NORM_MIN_BLOCK = 64;   // threads a block on the register path

struct NormParams {
  const void* x;
  const void* y;      // residual forms: the added operand
  const void* gamma;
  const void* beta;
  void* out;          // the norm (h)
  void* r;            // residual forms: x + y as stored
  int R, D;
  int kind;
  float eps;
  int tpr;   // threads a row of the register tile; 0: the looped path
  int y_dt;  // residual looped path: y's dtype code
};

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // `red` may still be read from the previous sum
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) t += red[w];
  return t;
}

// The sum over one row of the threads' values: `tpr` threads a row, rows
// `grp` of the block side by side; `red` holds a value per warp.
__device__ __forceinline__ float row_sum(float v, float* red, int tpr, int grp) {
  v = warp_sum(v);
  if (tpr == 32) return v;
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const int wpr = tpr / 32;
  float t = 0.f;
  for (int w = 0; w < wpr; ++w) t += red[grp * wpr + w];
  return t;
}

// W 32-bit words of a vector, loaded 16 (or 8) bytes at a time
template <int W>
struct Raw {
  uint32_t w[W];
};

template <int W>
__device__ __forceinline__ Raw<W> ld_raw(const void* p) {
  Raw<W> r;
  if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    r.w[0] = u.x;
    r.w[1] = u.y;
  } else {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[k];
      r.w[4 * k] = u.x;
      r.w[4 * k + 1] = u.y;
      r.w[4 * k + 2] = u.z;
      r.w[4 * k + 3] = u.w;
    }
  }
  return r;
}

// element e of a vector of T held in raw words
template <typename T, int W>
__device__ __forceinline__ float raw_elem(const Raw<W>& r, int e) {
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(e % 2 ? r.w[e / 2] & 0xffff0000u : r.w[e / 2] << 16);
  else
    return __uint_as_float(r.w[e]);
}

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(v);
  else return v;
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16(v);
  else return v;
}

// The looped path: one block of NT threads a row, element by element, over
// rows of `src` (x, or the stored r of the residual forms).
template <typename TX, typename TG>
__device__ __forceinline__ void norm_looped(const NormParams& p, const void* src, float* red) {
  const int64_t base = (int64_t)blockIdx.x * p.D;
  const TX* x = reinterpret_cast<const TX*>(src) + base;
  const TG* gamma = reinterpret_cast<const TG*>(p.gamma);
  const TG* beta = reinterpret_cast<const TG*>(p.beta);
  TX* out = reinterpret_cast<TX*>(p.out) + base;
  const bool ln = p.kind == KIND_LN;
  const float df = (float)p.D;
  float mu = 0.f;
  if (ln) {
    float s = 0.f;
    for (int c = threadIdx.x; c < p.D; c += NT) s += to_f(x[c]);
    mu = block_sum(s, red) / df;
  }
  float ss = 0.f;
  for (int c = threadIdx.x; c < p.D; c += NT) {
    const float d = to_f(x[c]) - mu;
    ss += d * d;
  }
  const float rstd = rsqrtf(block_sum(ss, red) / df + p.eps);
  for (int c = threadIdx.x; c < p.D; c += NT) {
    const float y = (to_f(x[c]) - mu) * rstd * to_f(gamma[c]);
    out[c] = from_f<TX>(ln ? y + to_f(beta[c]) : y);
  }
}

// The residual forms' looped pass: r = x + y rounded to x's dtype, stored
// element by element on the same thread-to-element map as norm_looped, so
// that each thread reads back only what it stored itself.
template <typename TX>
__device__ __forceinline__ void residual_looped(const NormParams& p) {
  const int64_t base = (int64_t)blockIdx.x * p.D;
  const TX* x = reinterpret_cast<const TX*>(p.x) + base;
  TX* r = reinterpret_cast<TX*>(p.r) + base;
  for (int c = threadIdx.x; c < p.D; c += NT)
    r[c] = from_f<TX>(to_f(x[c]) + ld_elem(p.y, base + c, p.y_dt));
}

// 16 bytes of TX from EPV floats, rounded as the store rounds them
template <typename TX>
__device__ __forceinline__ uint4 pack16(const float* v) {
  if constexpr (sizeof(TX) == 2)
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                      pack2(v[6], v[7]));
  else
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
}

// The register tile of one row (see the note).  RES: the residual forms,
// whose row is r = x + y rounded to TX in the registers and stored to p.r.
template <typename TX, typename TG, bool RES>
__device__ __forceinline__ void norm_tile(const NormParams& p, float (*red)[NORM_MAX_TPR / 32]) {
  constexpr int EPV = 16 / sizeof(TX);          // elements of a 16-byte x vector
  constexpr int GW = EPV * sizeof(TG) / 4;      // 32-bit words of gamma for them
  const int tpr = p.tpr, t = threadIdx.x % tpr, grp = threadIdx.x / tpr;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / tpr) + grp;
  const int nvec = p.D / EPV;
  const int nmine = row < p.R ? (nvec - t + tpr - 1) / tpr : 0;  // vectors of this thread
  const bool ln = p.kind == KIND_LN;
  const TX* x = reinterpret_cast<const TX*>(p.x) + row * p.D;
  const TG* gamma = reinterpret_cast<const TG*>(p.gamma);
  const TG* beta = reinterpret_cast<const TG*>(p.beta);

  Raw<4> xv[NORM_NV];
  Raw<GW> gv[NORM_NV], bv[NORM_NV];
  if constexpr (RES) {
    const TX* y = reinterpret_cast<const TX*>(p.y) + row * p.D;
    TX* r = reinterpret_cast<TX*>(p.r) + row * p.D;
    Raw<4> yv[NORM_NV];
#pragma unroll
    for (int i = 0; i < NORM_NV; ++i)
      if (i < nmine) {
        xv[i] = ld_raw<4>(x + (t + i * tpr) * EPV);
        yv[i] = ld_raw<4>(y + (t + i * tpr) * EPV);
      }
#pragma unroll
    for (int i = 0; i < NORM_NV; ++i)
      if (i < nmine) {
        float v[EPV];
#pragma unroll
        for (int e = 0; e < EPV; ++e) v[e] = raw_elem<TX>(xv[i], e) + raw_elem<TX>(yv[i], e);
        const uint4 u = pack16<TX>(v);
        xv[i].w[0] = u.x;
        xv[i].w[1] = u.y;
        xv[i].w[2] = u.z;
        xv[i].w[3] = u.w;
        *reinterpret_cast<uint4*>(r + (t + i * tpr) * EPV) = u;
      }
  } else {
#pragma unroll
    for (int i = 0; i < NORM_NV; ++i)
      if (i < nmine) xv[i] = ld_raw<4>(x + (t + i * tpr) * EPV);
  }
#pragma unroll
  for (int i = 0; i < NORM_NV; ++i) {
    if (i < nmine) {
      const int j = t + i * tpr;
      gv[i] = ld_raw<GW>(gamma + j * EPV);
      if (ln) bv[i] = ld_raw<GW>(beta + j * EPV);
    }
  }
  const float df = (float)p.D;
  float mu = 0.f;
  if (ln) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NORM_NV; ++i)
      if (i < nmine) {
#pragma unroll
        for (int e = 0; e < EPV; ++e) s += raw_elem<TX>(xv[i], e);
      }
    mu = row_sum(s, red[0], tpr, grp) / df;
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_NV; ++i)
    if (i < nmine) {
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const float d = raw_elem<TX>(xv[i], e) - mu;
        ss += d * d;
      }
    }
  const float rstd = rsqrtf(row_sum(ss, red[1], tpr, grp) / df + p.eps);
  TX* out = reinterpret_cast<TX*>(p.out) + row * p.D;
#pragma unroll
  for (int i = 0; i < NORM_NV; ++i) {
    if (i < nmine) {
      float y[EPV];
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        y[e] = (raw_elem<TX>(xv[i], e) - mu) * rstd * raw_elem<TG>(gv[i], e);
        if (ln) y[e] += raw_elem<TG>(bv[i], e);
      }
      *reinterpret_cast<uint4*>(out + (t + i * tpr) * EPV) = pack16<TX>(y);
    }
  }
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(NORM_MAX_TPR) norm_kernel(const NormParams p) {
  __shared__ float red[2][NORM_MAX_TPR / 32];
  if (p.tpr == 0) {
    norm_looped<TX, TG>(p, p.x, red[0]);
    return;
  }
  norm_tile<TX, TG, false>(p, red);
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(NORM_MAX_TPR) res_norm_kernel(const NormParams p) {
  __shared__ float red[2][NORM_MAX_TPR / 32];
  if (p.tpr == 0) {
    residual_looped<TX>(p);
    norm_looped<TX, TG>(p, p.r, red[0]);
    return;
  }
  norm_tile<TX, TG, true>(p, red);
}

// The register tile for a row of D elements: the fewest threads a row (a
// power of two from 32) whose NORM_NV vectors each hold the row; 0 (the
// looped path) where no tile fits or an operand is not 16-byte aligned.
static int tile_tpr(int D, int x_dt, uintptr_t align) {
  const int epv = x_dt == DT_BF16 ? 8 : 4;
  if (D % epv != 0 || align % 16 != 0) return 0;
  for (int t = 32; t <= NORM_MAX_TPR; t *= 2)
    if (t * NORM_NV * epv >= D) return t;
  return 0;
}

static bool norm_args_ok(int R, int D, int x_dt, int g_dt, int kind, const void* beta) {
  const bool dts_ok = (x_dt == DT_F32 || x_dt == DT_BF16) && (g_dt == DT_F32 || g_dt == DT_BF16);
  return R >= 0 && D >= 1 && dts_ok && (kind == KIND_RMS || kind == KIND_LN) &&
         (kind != KIND_LN || beta);
}

// Launch `kern<TX, TG>` (norm_kernel or res_norm_kernel) for the dtype pair:
// the tile's block holds max(NORM_MIN_BLOCK, tpr) threads, the looped path
// one NT-thread block a row.
template <bool RES>
static int launch_norm(const NormParams& p, int x_dt, int g_dt, void* stream) {
  int block = NT, grid = p.R;
  if (p.tpr) {
    block = p.tpr > NORM_MIN_BLOCK ? p.tpr : NORM_MIN_BLOCK;
    const int rows = block / p.tpr;
    grid = (p.R + rows - 1) / rows;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define NORM_LAUNCH(TX, TG)                                     \
  if constexpr (RES) res_norm_kernel<TX, TG><<<grid, block, 0, s>>>(p); \
  else norm_kernel<TX, TG><<<grid, block, 0, s>>>(p)
  if (x_dt == DT_BF16 && g_dt == DT_BF16) {
    NORM_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  } else if (x_dt == DT_BF16) {
    NORM_LAUNCH(__nv_bfloat16, float);
  } else if (g_dt == DT_BF16) {
    NORM_LAUNCH(float, __nv_bfloat16);
  } else {
    NORM_LAUNCH(float, float);
  }
#undef NORM_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int repro_residual_norm(const void* x, const void* y, const void* gamma,
                                   const void* beta, void* h, void* r, int R, int D,
                                   int x_dt, int y_dt, int vec_dt, int kind, float eps,
                                   void* stream) {
  if (R == 0) return 0;
  if (!norm_args_ok(R, D, x_dt, vec_dt, kind, beta) || (y_dt != DT_F32 && y_dt != DT_BF16))
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(gamma) | reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(r) |
                          (kind == KIND_LN ? reinterpret_cast<uintptr_t>(beta) : 0);
  const int tpr = y_dt == x_dt ? tile_tpr(D, x_dt, align) : 0;
  const NormParams p{x, y, gamma, beta, h, r, R, D, kind, eps, tpr, y_dt};
  return launch_norm<true>(p, x_dt, vec_dt, stream);
}

extern "C" int repro_norm(const void* x, const void* gamma, const void* beta,
                          void* out, int R, int D, int x_dt, int g_dt, int kind,
                          float eps, void* stream) {
  if (R == 0) return 0;
  if (!norm_args_ok(R, D, x_dt, g_dt, kind, beta)) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
                          reinterpret_cast<uintptr_t>(out) |
                          (kind == KIND_LN ? reinterpret_cast<uintptr_t>(beta) : 0);
  const NormParams p{x, nullptr, gamma, beta, out, nullptr, R, D, kind, eps,
                     tile_tpr(D, x_dt, align), x_dt};
  return launch_norm<false>(p, x_dt, g_dt, stream);
}
