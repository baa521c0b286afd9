// Row normalization: RMSNorm and LayerNorm with fp32 statistics, alone or
// behind a residual add.
//
// Replaces the TPU kernels src/repro/kernels/rmsnorm.py:rmsnorm (_rms_kernel)
// and :layernorm (_ln_kernel):
//     rmsnorm    y = x * rsqrt(mean(x^2) + eps) * gamma
//     layernorm  y = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * gamma + beta
// over the last dimension of x [R, D], output in x's dtype.  LayerNorm takes
// the mean and the variance in two passes, as _ln_kernel does.
// And :residual_rmsnorm / :residual_layernorm (_res_rms_kernel,
// _res_ln_kernel): r = x + y is stored rounded to x's dtype, and h = norm(r)
// takes its statistics over r AS STORED ("norm what was stored"), so h is
// the norm the unfused chain would take of the same residual.  -> (h, r).
//
// What bounds it on an H100: bytes (read x once, write y once; the
// statistics are a few flops per element).  Design: one block of 128
// threads per row; each pass walks the row with 4-wide loads (8 bytes of
// bf16, 16 of fp32) where the row is aligned, a warp-shuffle plus
// shared-memory block reduction gives the sums, and the row's later passes
// hit L1 / L2.  With a handful of rows (decode) the kernel is launch-bound,
// not byte-bound.
#include "common.cuh"

enum NormKind { KIND_RMS = 1, KIND_LN = 2 };

constexpr int NT = 128;

struct NormParams {
  const void* x;
  const void* gamma;
  const void* beta;
  void* out;
  int R, D;
  int x_dt, vec_dt;
  int kind;
  float eps;
  int vec;
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

// sum over the row of f(x) for the elements this thread owns
template <typename F>
__device__ __forceinline__ float row_pass(const NormParams& p, int64_t base, F f) {
  float s = 0.f;
  if (p.vec) {
    for (int c = threadIdx.x * 4; c < p.D; c += NT * 4) {
      const float4 v = ld4_aligned(p.x, base + c, p.x_dt);
      s += f(v.x) + f(v.y) + f(v.z) + f(v.w);
    }
  } else {
    for (int c = threadIdx.x; c < p.D; c += NT) s += f(ld_elem(p.x, base + c, p.x_dt));
  }
  return s;
}

__global__ void __launch_bounds__(NT) norm_kernel(const NormParams p) {
  __shared__ float red[NT / 32];
  const int64_t base = (int64_t)blockIdx.x * p.D;
  const float df = (float)p.D;
  float mu = 0.f;
  if (p.kind == KIND_LN)
    mu = block_sum(row_pass(p, base, [](float v) { return v; }), red) / df;
  const float ss = block_sum(row_pass(p, base, [mu](float v) {
                               const float d = v - mu;
                               return d * d;
                             }), red);
  const float rstd = rsqrtf(ss / df + p.eps);
  for (int c = threadIdx.x; c < p.D; c += NT) {
    const float v = ld_elem(p.x, base + c, p.x_dt);
    const float g = ld_elem(p.gamma, c, p.vec_dt);
    float y;
    if (p.kind == KIND_LN)
      y = (v - mu) * rstd * g + ld_elem(p.beta, c, p.vec_dt);
    else
      y = v * rstd * g;
    st_elem(p.out, base + c, p.x_dt, y);
  }
}

struct ResNormParams {
  const void* x;
  const void* y;
  const void* gamma;
  const void* beta;
  void* h;
  void* r;
  int D;
  int x_dt, y_dt, vec_dt;
  int kind;
  float eps;
};

// One block per row.  Every pass walks the same elements per thread, so a
// thread reads back only the r it stored itself (no barrier needed).
__global__ void __launch_bounds__(NT) res_norm_kernel(const ResNormParams p) {
  __shared__ float red[NT / 32];
  const int64_t base = (int64_t)blockIdx.x * p.D;
  const float df = (float)p.D;
  float s = 0.f;
  for (int c = threadIdx.x; c < p.D; c += NT) {
    st_elem(p.r, base + c, p.x_dt,
            ld_elem(p.x, base + c, p.x_dt) + ld_elem(p.y, base + c, p.y_dt));
    const float rq = ld_elem(p.r, base + c, p.x_dt);
    s += p.kind == KIND_LN ? rq : rq * rq;
  }
  s = block_sum(s, red);
  float mu = 0.f, ss = s;
  if (p.kind == KIND_LN) {
    mu = s / df;
    float d2 = 0.f;
    for (int c = threadIdx.x; c < p.D; c += NT) {
      const float d = ld_elem(p.r, base + c, p.x_dt) - mu;
      d2 += d * d;
    }
    ss = block_sum(d2, red);
  }
  const float rstd = rsqrtf(ss / df + p.eps);
  for (int c = threadIdx.x; c < p.D; c += NT) {
    const float rq = ld_elem(p.r, base + c, p.x_dt);
    const float g = ld_elem(p.gamma, c, p.vec_dt);
    const float v = p.kind == KIND_LN ? (rq - mu) * rstd * g + ld_elem(p.beta, c, p.vec_dt)
                                      : rq * rstd * g;
    st_elem(p.h, base + c, p.x_dt, v);
  }
}

extern "C" int repro_residual_norm(const void* x, const void* y, const void* gamma,
                                   const void* beta, void* h, void* r, int R, int D,
                                   int x_dt, int y_dt, int vec_dt, int kind, float eps,
                                   void* stream) {
  ResNormParams p{x, y, gamma, beta, h, r, D, x_dt, y_dt, vec_dt, kind, eps};
  if (R == 0) return 0;
  res_norm_kernel<<<R, NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int repro_norm(const void* x, const void* gamma, const void* beta,
                          void* out, int R, int D, int x_dt, int vec_dt, int kind,
                          float eps, int vec, void* stream) {
  NormParams p{x, gamma, beta, out, R, D, x_dt, vec_dt, kind, eps, vec};
  if (R == 0) return 0;
  norm_kernel<<<R, NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
