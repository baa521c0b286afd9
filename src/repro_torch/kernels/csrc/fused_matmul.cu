// Fused GEMM with norm prologue and bias/activation/residual epilogue.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:matmul
// (_fused_mm_kernel, _finalize_norm):
//     C = act(norm(A) @ B + bias) + residual,   A [M, K], B [K, N].
//
// Arithmetic follows the TPU kernel exactly: the prologue multiplies the A
// tile by gamma in fp32 and the product runs on fp32 operands (the weight
// tile upcast), accumulating in fp32; RMSNorm applies rsqrt(sum x^2 / K +
// eps) to the accumulator at the end, LayerNorm applies
// rstd * (acc - mu * (gamma @ W)) + beta @ W with the row sums and the two
// column vectors accumulated alongside the product.  Bias, activation and
// residual run on the fp32 accumulator before the single store.
//
// What bounds it on an H100: at decode batch (M <= 16) the weight stream
// (K*N*2 bytes) over 3.35 TB/s; at prefill M the operations.  Design: the
// whole K loop lives in one block (Hopper blocks run in no order, so nothing
// carries over between them), and that block accumulates the row statistics
// of its rows and gamma@W / beta@W of its columns itself.  Tiles are staged
// through shared memory with a one-tile register prefetch that overlaps the
// next tile's loads with this tile's FMAs.  Plain fp32 FMA keeps the
// prologue's fp32 operands exact; tensor cores (wgmma) are later work.
// Two tile shapes: 16 x 32 x 128 for decode (more blocks in flight on the
// weight stream), 64 x 64 x 16 for prefill.
#include "common.cuh"

enum NormCode { NORM_NONE = 0, NORM_RMS = 1, NORM_LN = 2 };
enum ActCode { ACT_NONE = 0, ACT_GELU_TANH = 1, ACT_GELU_EXACT = 2, ACT_I_GELU = 3,
               ACT_SILU = 4 };

struct MMParams {
  const void* a;
  const void* b;
  const void* gamma;
  const void* beta;
  const void* bias;
  const void* residual;
  void* out;
  int M, N, K;
  int a_dt, b_dt, vec_dt, res_dt, out_dt;
  int norm, act;
  float eps;
  int a_vec, b_vec;
};

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

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(256) fused_mm_kernel(const MMParams p) {
  constexpr int NT = 256;
  constexpr int BNT = BN / TN;          // threads along N
  constexpr int BMT = BM / TM;          // threads along M
  static_assert(BNT * BMT == NT, "tile shape must use 256 threads");
  constexpr int KQ = BK / 4;            // 4-wide groups per A row tile
  constexpr int NQ = BN / 4;            // 4-wide groups per B row tile
  constexpr int NA = BM * KQ;           // A groups per tile
  constexpr int NB = BK * NQ;           // B groups per tile
  constexpr int LA = (NA + NT - 1) / NT;
  constexpr int LB = (NB + NT - 1) / NT;

  __shared__ float As[BK][BM];          // prologue-scaled A, k-major
  __shared__ float Bs[BK][BN];
  __shared__ float Gs[BK], Bts[BK];     // gamma / beta of this K tile
  __shared__ float sp1[LA * NT], sp2[LA * NT];
  __shared__ float rs1[BM], rs2[BM], gsum[BN], bsum[BN];

  const int tid = threadIdx.x;
  const int tx = tid % BNT, ty = tid / BNT;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const bool has_norm = p.norm != NORM_NONE;
  const bool ln = p.norm == NORM_LN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float ps1[LA], ps2[LA];
#pragma unroll
  for (int i = 0; i < LA; ++i) ps1[i] = ps2[i] = 0.f;
  float gacc = 0.f, bacc = 0.f;

  float4 ra[LA], rg[LA], rb[LB];
  float rgam = 0.f, rbet = 0.f;

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int g = tid + i * NT;
      if (g < NA) {
        const int row = g / KQ, kq = (g % KQ) * 4;
        ra[i] = ld4_row(p.a, m0 + row, k0 + kq, p.M, p.K, p.a_dt, p.a_vec);
        if (has_norm)
          rg[i] = ld4_row(p.gamma, 0, k0 + kq, 1, p.K, p.vec_dt, false);
      }
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int g = tid + i * NT;
      if (g < NB) {
        const int kr = g / NQ, nq = (g % NQ) * 4;
        rb[i] = ld4_row(p.b, k0 + kr, n0 + nq, p.K, p.N, p.b_dt, p.b_vec);
      }
    }
    if (ln && tid < BK) {
      const int k = k0 + tid;
      rgam = k < p.K ? ld_elem(p.gamma, k, p.vec_dt) : 0.f;
      rbet = k < p.K ? ld_elem(p.beta, k, p.vec_dt) : 0.f;
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // commit the prefetched tile to shared memory
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      const int g = tid + i * NT;
      if (g < NA) {
        const int row = g / KQ, kq = (g % KQ) * 4;
        const float x[4] = {ra[i].x, ra[i].y, ra[i].z, ra[i].w};
        const float gm[4] = {rg[i].x, rg[i].y, rg[i].z, rg[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (has_norm) {
            ps1[i] += x[j];
            ps2[i] += x[j] * x[j];
            As[kq + j][row] = x[j] * gm[j];
          } else {
            As[kq + j][row] = x[j];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int g = tid + i * NT;
      if (g < NB) {
        const int kr = g / NQ, nq = (g % NQ) * 4;
        Bs[kr][nq + 0] = rb[i].x;
        Bs[kr][nq + 1] = rb[i].y;
        Bs[kr][nq + 2] = rb[i].z;
        Bs[kr][nq + 3] = rb[i].w;
      }
    }
    if (ln && tid < BK) {
      Gs[tid] = rgam;
      Bts[tid] = rbet;
    }
    __syncthreads();
    if (k0 + BK < p.K) fetch(k0 + BK);  // in flight while this tile computes

    if (ln && tid < BN) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        gacc += Gs[kk] * Bs[kk][tid];
        bacc += Bts[kk] * Bs[kk][tid];
      }
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * BMT];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * BNT];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // deterministic reduction of the row statistics and column vectors
  if (has_norm) {
#pragma unroll
    for (int i = 0; i < LA; ++i) {
      sp1[tid + i * NT] = ps1[i];
      sp2[tid + i * NT] = ps2[i];
    }
  }
  if (ln && tid < BN) {
    gsum[tid] = gacc;
    bsum[tid] = bacc;
  }
  __syncthreads();
  if (has_norm && tid < BM) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < KQ; ++j) {
      s1 += sp1[tid * KQ + j];
      s2 += sp2[tid * KQ + j];
    }
    rs1[tid] = s1;
    rs2[tid] = s2;
  }
  __syncthreads();

  const float kf = (float)p.K;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = ty + i * BMT;
    const int r = m0 + rl;
    if (r >= p.M) continue;
    float rstd = 1.f, mu = 0.f;
    if (p.norm == NORM_RMS) {
      rstd = rsqrtf(rs2[rl] / kf + p.eps);
    } else if (ln) {
      mu = rs1[rl] / kf;
      const float var = rs2[rl] / kf - mu * mu;
      rstd = rsqrtf(var + p.eps);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cl = tx + j * BNT;
      const int c = n0 + cl;
      if (c >= p.N) continue;
      float y = acc[i][j];
      if (p.norm == NORM_RMS) y = y * rstd;
      if (ln) y = (y - mu * gsum[cl]) * rstd + bsum[cl];
      if (p.bias) y += ld_elem(p.bias, c, p.vec_dt);
      y = activate(y, p.act);
      const int64_t o = (int64_t)r * p.N + c;
      if (p.residual) y += ld_elem(p.residual, o, p.res_dt);
      st_elem(p.out, o, p.out_dt, y);
    }
  }
}

extern "C" int repro_fused_matmul(const void* a, const void* b, const void* gamma,
                                  const void* beta, const void* bias,
                                  const void* residual, void* out, int M, int N,
                                  int K, int a_dt, int b_dt, int vec_dt, int res_dt,
                                  int out_dt, int norm, int act, float eps,
                                  int a_vec, int b_vec, void* stream) {
  MMParams p{a, b, gamma, beta, bias, residual, out, M, N, K, a_dt, b_dt,
             vec_dt, res_dt, out_dt, norm, act, eps, a_vec, b_vec};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 16) {
    dim3 grid((N + 31) / 32, (M + 15) / 16);
    fused_mm_kernel<16, 32, 128, 1, 2><<<grid, 256, 0, s>>>(p);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    fused_mm_kernel<64, 64, 16, 4, 4><<<grid, 256, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
