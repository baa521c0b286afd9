// The two Hopper templates of the fused GEMMs (fused_matmul.cu and
// fused_swiglu.cu), chosen by M in the wrappers' planner
// (kernels/matmul.py:gemm_plan):
//
//   stream  M <= STREAM_MAX_M (decode): a weight stream on CUDA cores, exact
//           fp32 arithmetic, K split across blocks;
//   wgmma   larger M (prefill): TMA fills a 3-stage shared-memory ring, two
//           consumer warpgroups run wgmma from shared memory; K is split
//           only when the tiles cannot fill the card.
// A split GEMM leaves fp32 partials that splitk_finish adds in split order
// before it applies the norm: the norm is not linear in a split.
//
// Both compute the TPU kernel's function in its deferred-norm form
// (src/repro/kernels/matmul.py:_finalize_norm): the product runs on x*gamma,
// the row sums (sum x, sum x^2) and, for LayerNorm, gamma@W and beta@W run
// beside it, and the norm is applied once to the fp32 accumulator before
// bias, activation, residual and the one store.  GATED = the SwiGLU kernel:
// two weights (gate, up) share A, the row statistics and the K loop, and the
// finish is silu(g) * u.
//
// I8 = int8 weights (weight-only quantization), each with one fp32 scale an
// output column: |q| <= 127 is exact in fp32 and in bf16, so the products
// run on q itself, and the scale multiplies the finalized accumulator, before
// the bias, the activation (or silu(g) * u) and the residual, where the TPU
// kernel applies b_scale (every accumulated term is linear in W).  The stream
// template reads 8 bytes (8 columns) of a weight row a lane, twice the rows
// in flight; the wgmma template's TMA brings int8 tiles, and the producer
// warpgroup's three spare warps widen them to bf16 in place, in the layout
// the B descriptors read.
#pragma once

#include "hopper.cuh"

enum NormCode { NORM_NONE = 0, NORM_RMS = 1, NORM_LN = 2 };
enum ActCode { ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_EXACT = 2, ACT_I_GELU = 3,
               ACT_SILU = 4 };
// template codes of the C entry points (kernels/matmul.py:_TEMPLATES)
enum TemplateCode { TPL_FMA32 = 0, TPL_STREAM = 1, TPL_WGMMA = 2 };

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_GELU_TANH: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_GELU_EXACT:
      return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case ACT_I_GELU: {  // I-BERT polynomial (core/activations.py:i_gelu)
      const float arg = x * 0.70710678118654752f;
      const float sgn = (float)((arg > 0.f) - (arg < 0.f));
      const float a = fminf(fabsf(arg), 1.769f);
      const float t = a - 1.769f;
      const float erf_approx = sgn * (-0.2888f * t * t + 1.f);
      return 0.5f * x * (1.f + erf_approx);
    }
    case ACT_SILU:
      return x / (1.f + expf(-x));
    default:
      return x;
  }
}

struct GemmParams {
  const void* a;         // [M, K]
  const void* b0;        // [K, N]: W, or the gate weight when GATED
  const void* b1;        // [K, N]: the up weight when GATED
  const void* gamma;     // [K] norm scale
  const void* beta;      // [K] LayerNorm shift
  const void* bias;      // [N]
  const void* residual;  // [M, N]
  void* out;             // [M, N]
  float* part;           // split-K partials (stream template, splits > 1)
  int M, N, K;
  int a_dt, b_dt, vec_dt, res_dt, out_dt;
  int norm, act;
  float eps;
  int kchunk, splits;    // split z covers K rows [z * kchunk, min(K, (z+1) * kchunk))
};

// Row scale of _finalize_norm from the full-K row sums.
__device__ __forceinline__ void row_scale(int norm, float s1, float s2, float kf,
                                          float eps, float& rstd, float& mu) {
  rstd = 1.f;
  mu = 0.f;
  if (norm == NORM_RMS) {
    rstd = rsqrtf(s2 / kf + eps);
  } else if (norm == NORM_LN) {
    mu = s1 / kf;
    const float var = s2 / kf - mu * mu;
    rstd = rsqrtf(var + eps);
  }
}

__device__ __forceinline__ float finalize(float acc, int norm, float rstd, float mu,
                                          float gw, float bw) {
  if (norm == NORM_RMS) return acc * rstd;
  if (norm == NORM_LN) return (acc - mu * gw) * rstd + bw;
  return acc;
}

// The int8 weights' column scales, [N] each (null for bf16 / fp32 weights):
// a kernel parameter of their own.  With them as two more pointers in
// GemmParams (144 bytes, not 128), the bf16 stream kernel compiled to 130
// registers instead of 168 and ran 10-20% slower on an H100.
struct GemmScales {
  const float* s0;  // W, or the gate weight when GATED
  const float* s1;  // the up weight when GATED
};

// An int8 weight's column scale on a finalized output (weight b: 0 = W or
// the gate, 1 = the up weight); other weights pass y through.
__device__ __forceinline__ float dequant(const GemmScales& sc, int b, int c, float y) {
  const float* s = b ? sc.s1 : sc.s0;
  return s ? y * s[c] : y;
}

// The epilogue of one finalized output (y0; GATED: gate y0, up y1) at
// column c, flat index o: bias + activation (plain) or silu(g) * u (gated),
// then the residual.
template <bool GATED>
__device__ __forceinline__ float epilogue(const GemmParams& p, int c, int64_t o,
                                          float y0, float y1) {
  float y;
  if (GATED) {
    y = y0 / (1.f + expf(-y0)) * y1;
  } else {
    y = y0;
    if (p.bias) y += ld_elem(p.bias, c, p.vec_dt);
    y = activate(y, p.act);
  }
  if (p.residual) y += ld_elem(p.residual, o, p.res_dt);
  return y;
}

// ---------------------------------------------------------------------------
// stream template (decode, M <= STREAM_MAX_M)
//
// Grid (strips, splits).  A block of 4 warps owns one strip of 256 output
// columns (each lane 8 of them, one 16-byte load of a bf16 weight row or an
// 8-byte load of an int8 one) and one range of K rows.  It stages its rows
// of x * gamma in fp32 in shared memory, M values per row, read back as
// broadcasts, and sums x and x^2 of each row over its range.  Each warp
// walks groups of R consecutive weight rows (warp w: groups w, w + 4, ...),
// the next group's loads in flight while this group's FMAs run; a warp's
// load instruction reads 512 (int8: 256) contiguous bytes of one row.  The 4 warps' sums are added in warp order
// in shared memory by all threads, one output column each.  One split
// finalizes in place; several write fp32 partials (acc, gamma@W, beta@W per
// column, sum x and sum x^2 per row) and splitk_finish adds them in split
// order before it applies the norm.
// ---------------------------------------------------------------------------

constexpr int STREAM_MAX_M = 8;
constexpr int ST_THREADS = 128;
constexpr int ST_WARPS = ST_THREADS / 32;
constexpr int ST_COLS = 256;
constexpr int ST_SMEM_MAX = 96 * 1024;  // dynamic shared memory a stream block may take

// Weight rows a warp has in flight per group: an int8 row's load is half a
// bf16 row's, so int8 keeps twice the rows (the same registers and bytes).
__host__ __device__ constexpr int stream_rows_per_group(int MT, bool gated, bool i8) {
  return (gated ? (MT >= 8 ? 2 : 4) : 8) * (i8 ? 2 : 1);
}

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Staged rows of a split of `len` K rows: whole groups of rows (8 or 16).
__host__ __device__ inline int stream_rows(int len, bool i8) {
  return i8 ? round16(len) : round8(len);
}

// Dynamic shared memory of one stream block: the staged rows (x * gamma,
// then gamma and beta for LayerNorm), later reused for the cross-warp sums.
__host__ __device__ inline size_t stream_smem_bytes(int MT, bool gated, bool i8, int kchunk) {
  const size_t rows = stream_rows(kchunk, i8);
  const size_t stage = rows * MT * 4 + 2 * rows * 4;
  const size_t red = (size_t)ST_WARPS * (gated ? 2 : 1) * (MT + 2) * ST_COLS * 4;
  return stage > red ? stage : red;
}

template <int MT>
__device__ __forceinline__ void load_arow(const float* p, float (&v)[MT]) {
  if constexpr (MT >= 4) {
#pragma unroll
    for (int q = 0; q < MT / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q + 0] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m) v[m] = p[m];
  }
}

template <int MT, bool GATED, bool I8>
__global__ void __launch_bounds__(ST_THREADS) stream_kernel(const GemmParams p,
                                                             const GemmScales sc) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int R = stream_rows_per_group(MT, GATED, I8);
  using WT = std::conditional_t<I8, int8_t, __nv_bfloat16>;  // a weight element
  using WV = std::conditional_t<I8, uint2, uint4>;           // a lane's 8 of them
  extern __shared__ float4 st_smem4[];
  float* sm = reinterpret_cast<float*>(st_smem4);
  __shared__ float st_part[ST_WARPS][MT][2];
  __shared__ float st_sum[MT][2];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int z = blockIdx.y;
  const int kb = z * p.kchunk;
  const int ke = min(p.K, kb + p.kchunk);
  const int len = ke - kb;
  const int rows = stream_rows(len, I8);
  const bool has_norm = p.norm != NORM_NONE;
  const bool ln = p.norm == NORM_LN;
  float* As = sm;                  // [rows][MT]
  float* Gs = As + rows * MT;      // [rows] gamma (LayerNorm)
  float* Bts = Gs + rows;          // [rows] beta (LayerNorm)

  // the weight stream's first loads go out before the staging below
  const int n = blockIdx.x * ST_COLS + lane * 8;
  const bool col_ok = n < p.N;  // N % 8 == 0: a lane's 8 columns are all in or out
  const WT* wp[NB];
  wp[0] = reinterpret_cast<const WT*>(p.b0) + n;
  if (GATED) wp[NB - 1] = reinterpret_cast<const WT*>(p.b1) + n;
  float acc[NB][MT][8], gacc[NB][8], bacc[NB][8];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      gacc[b][j] = bacc[b][j] = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[b][m][j] = 0.f;
    }
  const int ngroups = rows / R;
  WV bufa[NB][R], bufb[NB][R];

  auto load = [&](WV (&buf)[NB][R], int grp) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = kb + grp * R + i;
      const bool ok = col_ok && grp < ngroups && k < ke;
#pragma unroll
      for (int b = 0; b < NB; ++b)
        buf[b][i] = ok ? __ldg(reinterpret_cast<const WV*>(wp[b] + (int64_t)k * p.N)) : WV{};
    }
  };
  int grp = warp;
  load(bufa, grp);

  // 1. stage x * gamma of this range (zero past it) and the row sums
  float s1[MT], s2[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) s1[m] = s2[m] = 0.f;
  for (int kk = tid; kk < rows; kk += ST_THREADS) {
    const int k = kb + kk;
    const bool in = kk < len;
    const float g = (has_norm && in) ? ld_elem(p.gamma, k, p.vec_dt) : 1.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float x = (in && m < p.M) ? ld_elem(p.a, (int64_t)m * p.K + k, p.a_dt) : 0.f;
      s1[m] += x;
      s2[m] = fmaf(x, x, s2[m]);
      As[kk * MT + m] = x * g;
    }
    if (ln) {
      Gs[kk] = in ? g : 0.f;
      Bts[kk] = in ? ld_elem(p.beta, k, p.vec_dt) : 0.f;
    }
  }
  if (has_norm) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float a1 = warp_sum(s1[m]), a2 = warp_sum(s2[m]);
      if (lane == 0) {
        st_part[warp][m][0] = a1;
        st_part[warp][m][1] = a2;
      }
    }
  }
  __syncthreads();
  if (has_norm && tid < MT) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int w = 0; w < ST_WARPS; ++w) {
      a1 += st_part[w][tid][0];
      a2 += st_part[w][tid][1];
    }
    st_sum[tid][0] = a1;
    st_sum[tid][1] = a2;
  }

  // 2. the weight stream
  auto compute = [&](const WV (&buf)[NB][R], int grp) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kk = grp * R + i;
      float av[MT];
      load_arow<MT>(As + kk * MT, av);
      const float gk = ln ? Gs[kk] : 0.f, bk = ln ? Bts[kk] : 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float w[8];
        if constexpr (I8)
          unpack8_i8(buf[b][i], w);
        else
          unpack8(buf[b][i], w);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[b][m][j] = fmaf(av[m], w[j], acc[b][m][j]);
          if (ln) {
            gacc[b][j] = fmaf(gk, w[j], gacc[b][j]);
            bacc[b][j] = fmaf(bk, w[j], bacc[b][j]);
          }
        }
      }
    }
  };

  while (grp < ngroups) {
    load(bufb, grp + ST_WARPS);
    compute(bufa, grp);
    grp += ST_WARPS;
    if (grp >= ngroups) break;
    load(bufa, grp + ST_WARPS);
    compute(bufb, grp);
    grp += ST_WARPS;
  }

  // 3. every warp's sums to shared memory, then all threads add them in
  // warp order, one output column each
  __syncthreads();  // the staged rows are no longer read
  constexpr int NV = MT + 2;  // per weight: M accumulator rows, gamma@W, beta@W
  float* red = sm;            // [ST_WARPS][NB][NV][ST_COLS]
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float* rb = red + (warp * NB + b) * NV * ST_COLS + lane * 8;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = m < MT ? acc[b][m < MT ? m : 0][j] : (m == MT ? gacc[b][j] : bacc[b][j]);
      reinterpret_cast<float4*>(rb + m * ST_COLS)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(rb + m * ST_COLS)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  __syncthreads();

  // 4. finish here (one split) or leave the partials to splitk_finish
  float* pacc = p.part;                                     // [S][NB][M][N]
  float* pcol = pacc + (size_t)p.splits * NB * p.M * p.N;   // [S][NB][2][N]
  float* pst = pcol + (size_t)p.splits * NB * 2 * p.N;      // [S][M][2]
  if (p.splits > 1 && has_norm && blockIdx.x == 0 && tid < p.M) {
    pst[(z * p.M + tid) * 2 + 0] = st_sum[tid][0];
    pst[(z * p.M + tid) * 2 + 1] = st_sum[tid][1];
  }
  const float kf = (float)p.K;
  for (int idx = tid; idx < p.M * ST_COLS; idx += ST_THREADS) {
    const int m = idx / ST_COLS, cl = idx % ST_COLS;
    const int c = blockIdx.x * ST_COLS + cl;
    if (c >= p.N) continue;
    float rstd = 1.f, mu = 0.f;
    if (p.splits == 1) row_scale(p.norm, st_sum[m][0], st_sum[m][1], kf, p.eps, rstd, mu);
    float y[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float v[3] = {0.f, 0.f, 0.f};  // acc, gamma@W, beta@W
#pragma unroll
      for (int w = 0; w < ST_WARPS; ++w) {
        const float* rb = red + (w * NB + b) * NV * ST_COLS + cl;
        v[0] += rb[m * ST_COLS];
        if (ln) {
          v[1] += rb[MT * ST_COLS];
          v[2] += rb[(MT + 1) * ST_COLS];
        }
      }
      if (p.splits == 1) {
        y[b] = dequant(sc, b, c, finalize(v[0], p.norm, rstd, mu, v[1], v[2]));
      } else {
        pacc[((size_t)(z * NB + b) * p.M + m) * p.N + c] = v[0];
        if (ln && m == 0) {
          pcol[((size_t)(z * NB + b) * 2) * p.N + c] = v[1];
          pcol[((size_t)(z * NB + b) * 2 + 1) * p.N + c] = v[2];
        }
      }
    }
    if (p.splits == 1) {
      const int64_t o = (int64_t)m * p.N + c;
      st_elem(p.out, o, p.out_dt, epilogue<GATED>(p, c, o, y[0], y[NB - 1]));
    }
  }
}

// Second pass of a split-K GEMM (either template): one thread per output
// element adds the splits' partials in split order, then finalizes once (and
// applies an int8 weight's column scale).
template <bool GATED>
__global__ void __launch_bounds__(256) splitk_finish(const GemmParams p, const GemmScales sc) {
  constexpr int NB = GATED ? 2 : 1;
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (int64_t)p.M * p.N) return;
  const int m = (int)(i / p.N), n = (int)(i % p.N);
  const int S = p.splits;
  const float* pacc = p.part;
  const float* pcol = pacc + (size_t)S * NB * p.M * p.N;
  const float* pst = pcol + (size_t)S * NB * 2 * p.N;
  float s1 = 0.f, s2 = 0.f;
  if (p.norm != NORM_NONE) {
#pragma unroll 8
    for (int z = 0; z < S; ++z) {
      s1 += pst[(z * p.M + m) * 2 + 0];
      s2 += pst[(z * p.M + m) * 2 + 1];
    }
  }
  float rstd, mu;
  row_scale(p.norm, s1, s2, (float)p.K, p.eps, rstd, mu);
  float y[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float acc = 0.f, gw = 0.f, bw = 0.f;
#pragma unroll 8
    for (int z = 0; z < S; ++z) {
      acc += pacc[((size_t)(z * NB + b) * p.M + m) * p.N + n];
      if (p.norm == NORM_LN) {
        gw += pcol[((size_t)(z * NB + b) * 2) * p.N + n];
        bw += pcol[((size_t)(z * NB + b) * 2 + 1) * p.N + n];
      }
    }
    y[b] = dequant(sc, b, n, finalize(acc, p.norm, rstd, mu, gw, bw));
  }
  st_elem(p.out, i, p.out_dt, epilogue<GATED>(p, n, i, y[0], y[NB - 1]));
}

// Opt the stream kernel into its dynamic shared memory past 48 KB, once.
template <int MT, bool GATED, bool I8>
inline cudaError_t stream_prepare() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute((const void*)stream_kernel<MT, GATED, I8>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             ST_SMEM_MAX);
  done = e == cudaSuccess;
  return e;
}

template <int MT, bool GATED, bool I8>
inline cudaError_t launch_stream_mt(const GemmParams& p, const GemmScales& sc, cudaStream_t s) {
  const cudaError_t e = stream_prepare<MT, GATED, I8>();
  if (e != cudaSuccess) return e;
  const size_t smem = stream_smem_bytes(MT, GATED, I8, p.kchunk);
  if (smem > ST_SMEM_MAX) return cudaErrorInvalidValue;
  dim3 grid((p.N + ST_COLS - 1) / ST_COLS, p.splits);
  stream_kernel<MT, GATED, I8><<<grid, ST_THREADS, smem, s>>>(p, sc);
  return cudaGetLastError();
}

template <bool GATED, bool I8>
inline cudaError_t launch_stream_w(const GemmParams& p, const GemmScales& sc, cudaStream_t s) {
  if (p.M <= 1) return launch_stream_mt<1, GATED, I8>(p, sc, s);
  if (p.M <= 2) return launch_stream_mt<2, GATED, I8>(p, sc, s);
  if (p.M <= 4) return launch_stream_mt<4, GATED, I8>(p, sc, s);
  return launch_stream_mt<8, GATED, I8>(p, sc, s);
}

// Resident stream blocks per SM at M rows, with the shared memory of the
// largest split the planner makes (32 KB of staged rows): the planner sizes
// the grid to whole waves of these.  -1 on a CUDA error.
template <int MT, bool GATED, bool I8>
inline int stream_occupancy_mt() {
  if (stream_prepare<MT, GATED, I8>() != cudaSuccess) return -1;
  int blocks = 0;
  const size_t smem = stream_smem_bytes(MT, GATED, I8, 32 * 1024 / (4 * (MT + 2)));
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, stream_kernel<MT, GATED, I8>,
                                                    ST_THREADS, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <bool GATED, bool I8>
inline int stream_occupancy_w(int M) {
  if (M <= 1) return stream_occupancy_mt<1, GATED, I8>();
  if (M <= 2) return stream_occupancy_mt<2, GATED, I8>();
  if (M <= 4) return stream_occupancy_mt<4, GATED, I8>();
  return stream_occupancy_mt<8, GATED, I8>();
}

template <bool GATED>
inline int stream_occupancy(int M, int i8) {
  return i8 ? stream_occupancy_w<GATED, true>(M) : stream_occupancy_w<GATED, false>(M);
}

// int8 weights come with their scales (both weights when GATED), other
// weights without
inline bool scales_ok(const GemmParams& p, const GemmScales& sc, bool gated) {
  const bool i8 = p.b_dt == DT_I8;
  return i8 == (sc.s0 != nullptr) && (!gated || i8 == (sc.s1 != nullptr));
}

template <bool GATED>
inline cudaError_t launch_stream(const GemmParams& p, const GemmScales& sc, cudaStream_t s) {
  if (p.M < 1 || p.M > STREAM_MAX_M || (p.b_dt != DT_BF16 && p.b_dt != DT_I8) ||
      !scales_ok(p, sc, GATED) || p.N % 8 || p.kchunk < 1 ||
      p.splits != (p.K + p.kchunk - 1) / p.kchunk || (p.splits > 1 && !p.part))
    return cudaErrorInvalidValue;
  const cudaError_t e = p.b_dt == DT_I8 ? launch_stream_w<GATED, true>(p, sc, s)
                                        : launch_stream_w<GATED, false>(p, sc, s);
  if (e != cudaSuccess || p.splits == 1) return e;
  const int64_t total = (int64_t)p.M * p.N;
  splitk_finish<GATED><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(p, sc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma template (prefill, M > STREAM_MAX_M)
//
// Block tile 128 rows x 256 B columns (plain: 256 output columns; GATED: 128
// output columns of the gate and the same 128 of the up weight), K in steps
// of 64 through a 3-stage ring: per stage one TMA box of A [128 x 64] and
// four of B [64 x 64], each with the 128-byte swizzle and zero-filled past M,
// N, K, and the stage's 64 entries of gamma (and beta) in a small ring
// beside it.  Warpgroup 0 (registers cut to 56 with setmaxnreg): warp 0 lane
// 0 issues the loads; for LayerNorm warps 1-3 accumulate gamma@W and beta@W
// of the block's 256 B columns on CUDA cores from the B tiles already in
// shared memory (no second pass over W).  Warpgroups 1-2 (224 registers):
// each owns 64 rows.  Per stage each warp reads its 16 rows of A with
// ldmatrix, sums x and x^2, and writes bf16(x * gamma) back in place (one
// bf16x2 multiply for a bf16 gamma; an fp32 output also writes the bf16
// remainder v - bf16(v) to a lo tile, a second MMA); a proxy fence and a
// warpgroup barrier later one wgmma.m64n256k16 per 16 K rows reads A
// K-major and B MN-major from shared memory.  The previous stage's MMAs run
// while this stage's prologue does (wait_group 1).  The epilogue stages the
// accumulators in the drained ring, then all consumer threads finalize and
// store the tile row by row (coalesced), or write a split's partials.
//
// I8: per stage TMA brings two int8 boxes B [64 x 128] (128-byte rows, the
// same swizzle) into the upper half of the stage's B region, and warps 1-3
// widen them in place to the four bf16 boxes the consumers' descriptors
// read: a group of 8 lanes owns a row, reads its 16 int8 chunks (both
// boxes), syncs its warp and writes the row's 32 bf16 chunks; bf16 boxes 2
// and 3 of row r overwrite exactly the int8 row r it read, so no other row
// is in the way.  They fence the writes to the async proxy and arrive on the
// stage's `ready` barrier, which the consumers wait on after `full`; for
// LayerNorm they then sum gamma@W and beta@W from the widened tile.
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;
constexpr int WG_BK = 64;
constexpr int WG_BOX = 64;      // columns of one B box: 128 bytes of bf16
constexpr int WG_BOXES = 4;
constexpr int WG_COLS = WG_BOXES * WG_BOX;  // B columns of one block
constexpr int WG_STAGES = 3;
constexpr int WG_LO = 2;        // A lo tiles: the stage in the prologue and the one in MMAs
constexpr int WG_THREADS = 384;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;
constexpr int WG_B_BYTES = WG_BK * WG_BOX * 2;
constexpr int WG_STAGE_BYTES = WG_A_BYTES + WG_BOXES * WG_B_BYTES;  // what TMA fills
constexpr int WG_B8_BOX = 128;  // columns of one int8 B box: 128 bytes
constexpr int WG_B8_BYTES = WG_BK * WG_B8_BOX;
constexpr int WG_B8_BOXES = WG_COLS / WG_B8_BOX;
constexpr int WG_B8_OFF = WG_BOXES * WG_B_BYTES - WG_B8_BOXES * WG_B8_BYTES;  // in B region
constexpr int WG_STAGE_BYTES_I8 = WG_A_BYTES + WG_B8_BOXES * WG_B8_BYTES;    // what TMA fills
constexpr int WG_VEC_BYTES = 256;      // one stage's gamma or beta: 64 entries <= 4 bytes
constexpr int WG_CPAD = WG_COLS + 4;   // row stride (floats) of the staged tile
constexpr int WG_HELPERS = 96;         // LayerNorm helper threads (warps 1-3)
constexpr int WG_CHUNKS = WG_COLS / 8;  // 16-byte column chunks of a B row
constexpr int WG_HELPER_GROUPS = WG_HELPERS / WG_CHUNKS;  // row groups (one per warp)
constexpr int WG_SMEM = 1024 + WG_STAGES * WG_STAGE_BYTES + WG_LO * WG_A_BYTES +
                        WG_STAGES * 2 * WG_VEC_BYTES + 3 * WG_STAGES * 8 +
                        (2 * WG_HELPER_GROUPS + 2) * WG_COLS * 4 + WG_BM * 2 * 4;
static_assert(WG_BM * WG_CPAD * 4 <= WG_STAGES * WG_STAGE_BYTES, "staged tile fits the ring");
static_assert(WG_HELPER_GROUPS * WG_CHUNKS == WG_HELPERS, "helpers cover the chunks");
static_assert(WG_SMEM <= 227 * 1024, "shared memory of one block");

// bf16x2 a * b, rounded once (as bf16(float(a) * float(b)): the product of
// two bf16 values is exact in fp32)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float2 ld_pair(const uint8_t* v, int k, int dt) {
  if (dt == DT_BF16) return unpack2(*reinterpret_cast<const uint32_t*>(v + 2 * k));
  return *reinterpret_cast<const float2*>(v + 4 * k);
}

// Widen one stage's int8 B tile (WG_B8_BOXES boxes at b + WG_B8_OFF) in place
// into the bf16 boxes at b, as warps 1-3 of the producer warpgroup (thread
// ht of 96): a group of 8 lanes a row, lane c the 16-byte chunk c of the
// row in each int8 box.  Int8 box j's chunk c (columns 16c .. 16c + 15 of
// the box) becomes bf16 chunks 2(c % 4), 2(c % 4) + 1 of bf16 box 2j + c / 4.
__device__ __forceinline__ void widen_b_tile(uint8_t* b, int ht) {
  const int lane = ht & 31, c = lane & 7;
  const int grp = (ht >> 5) * 4 + (lane >> 3);  // 12 row groups
  for (int r = grp; r < WG_BK; r += WG_HELPERS / 8) {
    uint4 src[WG_B8_BOXES];
#pragma unroll
    for (int j = 0; j < WG_B8_BOXES; ++j)
      src[j] = *reinterpret_cast<const uint4*>(b + WG_B8_OFF + j * WG_B8_BYTES + r * 128 +
                                               ((c ^ (r & 7)) << 4));
    __syncwarp();  // the row is read by its 8 lanes before any lane writes it
#pragma unroll
    for (int j = 0; j < WG_B8_BOXES; ++j) {
      const uint32_t w[4] = {src[j].x, src[j].y, src[j].z, src[j].w};
      uint32_t h[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        h[q] = pack2(i8_to_f32(w[q >> 1], 2 * (q & 1)), i8_to_f32(w[q >> 1], 2 * (q & 1) + 1));
      uint8_t* dst = b + (2 * j + (c >> 2)) * WG_B_BYTES + r * 128;
      const int j0 = 2 * (c & 3);
      *reinterpret_cast<uint4*>(dst + ((j0 ^ (r & 7)) << 4)) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(dst + (((j0 + 1) ^ (r & 7)) << 4)) =
          make_uint4(h[4], h[5], h[6], h[7]);
    }
    __syncwarp();
  }
}

template <bool GATED, bool I8>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b0,
                 const __grid_constant__ CUtensorMap tma_b1,
                 const __grid_constant__ CUtensorMap tma_gamma,
                 const __grid_constant__ CUtensorMap tma_beta, const GemmParams p,
                 const GemmScales sc) {
  extern __shared__ uint8_t wg_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* lo_ring = smem + WG_STAGES * WG_STAGE_BYTES;   // [WG_LO][A tile]
  uint8_t* vring = lo_ring + WG_LO * WG_A_BYTES;           // [stage][gamma, beta][256 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(vring + WG_STAGES * 2 * WG_VEC_BYTES);
  uint64_t* empty = full + WG_STAGES;
  uint64_t* ready = empty + WG_STAGES;  // I8: the stage's B tile is widened
  float* colpart = reinterpret_cast<float*>(ready + WG_STAGES);  // [2][groups][WG_COLS]
  float* colsum = colpart + 2 * WG_HELPER_GROUPS * WG_COLS;        // [2][WG_COLS]
  float* rowscale = colsum + 2 * WG_COLS;                          // [WG_BM][rstd, mu]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * WG_BM;
  const int ncol0 = blockIdx.y * (GATED ? WG_COLS / 2 : WG_COLS);  // first output column
  const int z = blockIdx.z;  // split: K rows [kbase, kbase + kchunk), kchunk % WG_BK == 0
  const int kbase = z * p.kchunk;
  const int ktiles = (min(p.K, kbase + p.kchunk) - kbase + WG_BK - 1) / WG_BK;
  const bool has_norm = p.norm != NORM_NONE;
  const bool ln = p.norm == NORM_LN;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 + (ln ? WG_HELPERS / 32 : 0));  // consumer (+ LN helper) warps
      mbar_init(&ready[s], WG_HELPERS / 32);                 // the widening warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == 0) {
      if (lane == 0) {  // the producer
        const uint32_t vbytes = (p.vec_dt == DT_BF16 ? 2 : 4) * WG_BK;
        const uint32_t tx = (I8 ? WG_STAGE_BYTES_I8 : WG_STAGE_BYTES) + (has_norm ? vbytes : 0) +
                            (ln ? vbytes : 0);
        int stage = 0;
        uint32_t phase = 0;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * WG_STAGE_BYTES;
          uint8_t* vt = vring + stage * 2 * WG_VEC_BYTES;
          const int k0 = kbase + kt * WG_BK;
          mbar_expect_tx(&full[stage], tx);
          tma_load_2d(st, &tma_a, k0, m0, &full[stage]);
          if constexpr (I8) {
#pragma unroll
            for (int b = 0; b < WG_B8_BOXES; ++b) {
              // plain: W at columns ncol0 + 128 b; gated: Wg, then Wu
              const CUtensorMap* map = (GATED && b == 1) ? &tma_b1 : &tma_b0;
              const int col = ncol0 + (GATED ? 0 : b) * WG_B8_BOX;
              tma_load_2d(st + WG_A_BYTES + WG_B8_OFF + b * WG_B8_BYTES, map, col, k0,
                          &full[stage]);
            }
          } else {
#pragma unroll
            for (int b = 0; b < WG_BOXES; ++b) {
              // plain: W at columns ncol0 + 64 b; gated: Wg, then Wu, 128 columns each
              const CUtensorMap* map = (GATED && b >= WG_BOXES / 2) ? &tma_b1 : &tma_b0;
              const int col = ncol0 + (GATED ? (b % (WG_BOXES / 2)) : b) * WG_BOX;
              tma_load_2d(st + WG_A_BYTES + b * WG_B_BYTES, map, col, k0, &full[stage]);
            }
          }
          if (has_norm) tma_load_1d(vt, &tma_gamma, k0, &full[stage]);
          if (ln) tma_load_1d(vt + WG_VEC_BYTES, &tma_beta, k0, &full[stage]);
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (ln || I8) {
      // warps 1-3.  I8: widen each stage's B tile.  LayerNorm: thread ht
      // owns one 16-byte column chunk (8 B columns) and rows kg, kg + 3, ...
      // of every stage, for gamma@W and beta@W
      const int ht = tid - 32;
      const int chunk = ht % WG_CHUNKS, kg = ht / WG_CHUNKS;
      float ga[8], ba[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) ga[j] = ba[j] = 0.f;
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[stage], phase);
        if constexpr (I8) {
          widen_b_tile(smem + stage * WG_STAGE_BYTES + WG_A_BYTES, ht);
          fence_proxy_async();  // the bf16 tile is read by wgmma (async proxy)
          __syncwarp();
          if (lane == 0) mbar_arrive(&ready[stage]);
          if (!ln) {
            if (++stage == WG_STAGES) {
              stage = 0;
              phase ^= 1;
            }
            continue;
          }
          named_sync(6, WG_HELPERS);  // every row widened before gamma@W reads it
        }
        const uint8_t* bt =
            smem + stage * WG_STAGE_BYTES + WG_A_BYTES + (chunk >> 3) * WG_B_BYTES;
        const uint8_t* vt = vring + stage * 2 * WG_VEC_BYTES;
#pragma unroll 2
        for (int r = kg; r < WG_BK; r += WG_HELPER_GROUPS) {
          const float gk = ld_elem(vt, r, p.vec_dt);
          const float bk = ld_elem(vt + WG_VEC_BYTES, r, p.vec_dt);
          const uint4 u =
              *reinterpret_cast<const uint4*>(bt + r * 128 + (((chunk & 7) ^ (r & 7)) << 4));
          float w[8];
          unpack8(u, w);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            ga[j] = fmaf(gk, w[j], ga[j]);
            ba[j] = fmaf(bk, w[j], ba[j]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (!ln) return;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        colpart[(0 * WG_HELPER_GROUPS + kg) * WG_COLS + chunk * 8 + j] = ga[j];
        colpart[(1 * WG_HELPER_GROUPS + kg) * WG_COLS + chunk * 8 + j] = ba[j];
      }
      named_sync(1, WG_HELPERS);
      for (int c = ht; c < WG_COLS; c += WG_HELPERS) {
        float sg = 0.f, sb = 0.f;
#pragma unroll
        for (int q = 0; q < WG_HELPER_GROUPS; ++q) {
          sg += colpart[(0 * WG_HELPER_GROUPS + q) * WG_COLS + c];
          sb += colpart[(1 * WG_HELPER_GROUPS + q) * WG_COLS + c];
        }
        colsum[c] = sg;
        colsum[WG_COLS + c] = sb;
      }
      named_arrive(2, WG_HELPERS + 256);
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int cw = warp - 4;
  const int wg = cw >> 2, wr = cw & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool split = has_norm && p.out_dt == DT_F32;
  const bool packed = !split && p.vec_dt == DT_BF16;  // bf16 gamma: one bf16x2 multiply
  const int arow = wg * 64 + wr * 16 + (lane & 15);  // the row this lane addresses
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&full[stage], phase);
    if constexpr (I8) mbar_wait(&ready[stage], phase);
    const uint32_t a_base = smem_u32(smem + stage * WG_STAGE_BYTES);
    const uint32_t b_base = a_base + WG_A_BYTES;
    const uint32_t lo_base = smem_u32(lo_ring + (kt % WG_LO) * WG_A_BYTES);
    if (has_norm) {
      // the prologue, in place: this warp's 16 rows of the A tile become
      // bf16(x * gamma) (and the rounding's remainder in a lo tile)
      const uint8_t* gvec = vring + stage * 2 * WG_VEC_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, a_base + arow * 128 + (((kk * 2 + (lane >> 4)) ^ (arow & 7)) << 4));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // register q: row g (+8 if q odd), columns 2t, 2t+1 (+8 if q >= 2)
          const int h = q & 1;
          const int row = wg * 64 + wr * 16 + g + 8 * h;
          const int chunk = kk * 2 + (q >> 1);
          const uint32_t off = row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t;
          const int kc = kk * 16 + (q >> 1) * 8 + 2 * t;
          const float2 x = unpack2(r[q]);
          if (ln) s1[h] += x.x + x.y;
          s2[h] = fmaf(x.x, x.x, fmaf(x.y, x.y, s2[h]));
          if (packed) {
            st_shared_u32(a_base + off,
                          mul_bf16x2(r[q], *reinterpret_cast<const uint32_t*>(gvec + 2 * kc)));
          } else {
            const float2 gm = ld_pair(gvec, kc, p.vec_dt);
            const float v0 = x.x * gm.x, v1 = x.y * gm.y;
            const uint32_t hi = pack2(v0, v1);
            st_shared_u32(a_base + off, hi);
            if (split) {
              const float2 hf = unpack2(hi);
              st_shared_u32(lo_base + off, pack2(v0 - hf.x, v1 - hf.y));
            }
          }
        }
      }
      fence_proxy_async();
      named_sync(4 + wg, 128);  // the warpgroup's 64 rows are ready
    }
    fence_regs(acc);
    wgmma_fence();
    const uint32_t a_slab = a_base + wg * 64 * 128, lo_slab = lo_base + wg * 64 * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mnmajor(b_base + kk * 16 * 128, WG_B_BYTES);
      wgmma_n256(acc, desc_kmajor(a_slab + kk * 32), db);
      if (split) wgmma_n256(acc, desc_kmajor(lo_slab + kk * 32), db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    fence_regs(acc);
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == WG_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue.  Row sums: the quad of lanes 4g .. 4g+3 holds all K columns of
  // rows g and g+8.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 1);
    s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 2);
    s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 1);
    s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 2);
  }
  // every consumer is past its last MMA and the LN helpers have left
  // gamma@W / beta@W in colsum: the ring is free for the staged tile
  named_sync(2, 256 + (ln ? WG_HELPERS : 0));
  float* ct = reinterpret_cast<float*>(smem);  // [WG_BM][WG_CPAD]
  const int lrow = wg * 64 + wr * 16 + g;
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_scale(p.norm, s1[h], s2[h], (float)p.K, p.eps, rowscale[(lrow + 8 * h) * 2],
                rowscale[(lrow + 8 * h) * 2 + 1]);
  }
#pragma unroll
  for (int j = 0; j < WG_COLS / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(ct + (lrow + 8 * h) * WG_CPAD + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  named_sync(3, 256);
  // The tile leaves in chunks of 8 consecutive columns a thread (two
  // float4 reads of the staged row, one 16-byte or two 32-byte stores):
  // eight independent outputs in flight per thread.  GATED: output column
  // lc is gate column lc and up column OCOLS + lc.
  constexpr int OCOLS = GATED ? WG_COLS / 2 : WG_COLS;
  constexpr int NB = GATED ? 2 : 1;
  constexpr int CHUNKS = OCOLS / 8;
  const bool partial = p.splits > 1;
  float* pacc = p.part;                                     // [S][NB][M][N]
  float* pcol = pacc + (size_t)p.splits * NB * p.M * p.N;   // [S][NB][2][N]
  float* pst = pcol + (size_t)p.splits * NB * 2 * p.N;      // [S][M][2]
  if (partial && blockIdx.y == 0 && t == 0) {
    // this split's partials go to splitk_finish (stream_kernel's layout)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + lrow + 8 * h;
      if (r < p.M) {
        pst[((size_t)z * p.M + r) * 2] = s1[h];
        pst[((size_t)z * p.M + r) * 2 + 1] = s2[h];
      }
    }
  }
  for (int ch = tid - 128; ch < WG_BM * CHUNKS; ch += 256) {
    const int lr = ch / CHUNKS, lc = (ch % CHUNKS) * 8;
    const int r = m0 + lr, c = ncol0 + lc;
    if (r >= p.M || c >= p.N) continue;  // N % 8 == 0: a chunk is all in or out
    const float* row = ct + lr * WG_CPAD;
    float v[NB][8];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float4 lo = *reinterpret_cast<const float4*>(row + b * OCOLS + lc);
      const float4 hi = *reinterpret_cast<const float4*>(row + b * OCOLS + lc + 4);
      v[b][0] = lo.x, v[b][1] = lo.y, v[b][2] = lo.z, v[b][3] = lo.w;
      v[b][4] = hi.x, v[b][5] = hi.y, v[b][6] = hi.z, v[b][7] = hi.w;
    }
    if (partial) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float4* dst = reinterpret_cast<float4*>(
            pacc + ((size_t)(z * NB + b) * p.M + r) * p.N + c);
        dst[0] = make_float4(v[b][0], v[b][1], v[b][2], v[b][3]);
        dst[1] = make_float4(v[b][4], v[b][5], v[b][6], v[b][7]);
        if (ln && blockIdx.x == 0 && lr == 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            pcol[((size_t)(z * NB + b) * 2) * p.N + c + e] = colsum[b * OCOLS + lc + e];
            pcol[((size_t)(z * NB + b) * 2 + 1) * p.N + c + e] =
                colsum[WG_COLS + b * OCOLS + lc + e];
          }
        }
      }
      continue;
    }
    const float rstd = rowscale[lr * 2], mu = rowscale[lr * 2 + 1];
    const int64_t o = (int64_t)r * p.N + c;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float f[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        f[b] = dequant(sc, b, c + e,
                       finalize(v[b][e], p.norm, rstd, mu, ln ? colsum[b * OCOLS + lc + e] : 0.f,
                                ln ? colsum[WG_COLS + b * OCOLS + lc + e] : 0.f));
      y[e] = epilogue<GATED>(p, c + e, o + e, f[0], f[NB - 1]);
    }
    if (p.out_dt == DT_BF16) {
      *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(p.out) + o) =
          make_uint4(pack2(y[0], y[1]), pack2(y[2], y[3]), pack2(y[4], y[5]),
                     pack2(y[6], y[7]));
    } else {
      float4* dst = reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) + o);
      dst[0] = make_float4(y[0], y[1], y[2], y[3]);
      dst[1] = make_float4(y[4], y[5], y[6], y[7]);
    }
  }
}

// A row-major bf16 [rows, cols] matrix read in [box_rows, 64] boxes (int8:
// [box_rows, 128]), 128-byte rows with the 128-byte swizzle; boxes past the
// edge are zero-filled.
inline bool encode_tile_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
                           int box_rows, bool i8) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return false;
  const int esize = i8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1u, 1u};
  return fn(map, i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [n] vector (gamma, beta) read in boxes of WG_BK entries, zero past n.
inline bool encode_vec(CUtensorMap* map, const void* ptr, int n, int dt) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // a rank-1 map has no strides
  const cuuint32_t box[1] = {(cuuint32_t)WG_BK};
  const cuuint32_t estr[1] = {1u};
  return fn(map, dt == DT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            1, const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool GATED, bool I8>
inline cudaError_t launch_wgmma_w(const CUtensorMap& ma, const CUtensorMap& mb0,
                                  const CUtensorMap& mb1, const CUtensorMap& mg,
                                  const CUtensorMap& mbt, const GemmParams& p,
                                  const GemmScales& sc, cudaStream_t s) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute((const void*)wgmma_kernel<GATED, I8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int bn = GATED ? WG_COLS / 2 : WG_COLS;
  dim3 grid((p.M + WG_BM - 1) / WG_BM, (p.N + bn - 1) / bn, p.splits);
  wgmma_kernel<GATED, I8><<<grid, WG_THREADS, WG_SMEM, s>>>(ma, mb0, mb1, mg, mbt, p, sc);
  return cudaGetLastError();
}

template <bool GATED>
inline cudaError_t launch_wgmma(const GemmParams& p, const GemmScales& sc, cudaStream_t s) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(p.a) | reinterpret_cast<uintptr_t>(p.b0) |
                          reinterpret_cast<uintptr_t>(p.b1) |
                          reinterpret_cast<uintptr_t>(p.gamma) |
                          reinterpret_cast<uintptr_t>(p.beta);
  const bool i8 = p.b_dt == DT_I8;
  if (p.M < 1 || p.a_dt != DT_BF16 || (p.b_dt != DT_BF16 && !i8) || !scales_ok(p, sc, GATED) ||
      p.N % (i8 ? 16 : 8) || p.K % 8 || align % 16 ||
      (p.norm != NORM_NONE && !p.gamma) || (p.norm == NORM_LN && !p.beta) ||
      p.kchunk < 1 || (p.kchunk % WG_BK && p.kchunk < p.K) ||
      p.splits != (p.K + p.kchunk - 1) / p.kchunk || (p.splits > 1 && !p.part))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb0, mb1, mg, mbt;
  if (!encode_tile_2d(&ma, p.a, p.M, p.K, WG_BM, false) ||
      !encode_tile_2d(&mb0, p.b0, p.K, p.N, WG_BK, i8) ||
      !encode_tile_2d(&mb1, GATED ? p.b1 : p.b0, p.K, p.N, WG_BK, i8))
    return cudaErrorInvalidValue;
  mg = mbt = ma;  // unread without a norm
  if (p.norm != NORM_NONE && !encode_vec(&mg, p.gamma, p.K, p.vec_dt))
    return cudaErrorInvalidValue;
  if (p.norm == NORM_LN && !encode_vec(&mbt, p.beta, p.K, p.vec_dt))
    return cudaErrorInvalidValue;
  cudaError_t e = i8 ? launch_wgmma_w<GATED, true>(ma, mb0, mb1, mg, mbt, p, sc, s)
                     : launch_wgmma_w<GATED, false>(ma, mb0, mb1, mg, mbt, p, sc, s);
  if (e != cudaSuccess || p.splits == 1) return e;
  const int64_t total = (int64_t)p.M * p.N;
  splitk_finish<GATED><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(p, sc);
  return cudaGetLastError();
}
