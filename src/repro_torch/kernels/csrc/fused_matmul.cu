// Fused GEMM with norm prologue and bias/activation/residual epilogue.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:matmul
// (_fused_mm_kernel, _finalize_norm):
//     C = act(norm(A) @ B + bias) + residual,   A [M, K], B [K, N].
// The deferred norm: the product runs on x * gamma (fp32), the row sums
// sum x^2 (RMSNorm) and sum x, gamma @ W, beta @ W (LayerNorm) run beside it,
// and rsqrt / mu / beta@W are applied once to the fp32 accumulator; bias,
// activation and residual follow before the single store.
//
// Three templates (gemm.cuh), picked per call by kernels/matmul.py:gemm_plan:
//
// stream (bf16 W, M <= 8: decode).  Bound: the weight stream, K*N*2 bytes
//   over 3.35 TB/s; 2*M FLOPs per 2 weight bytes is <= 27 TFLOP/s at the
//   full HBM rate, under the 67 TFLOP/s fp32 FMA peak, so CUDA-core fp32
//   arithmetic (exact: x * gamma in fp32, fp32 FMA) keeps up.  Design: no
//   shared-memory staging of W; each lane reads 16 bytes (8 columns) of a
//   weight row, neighbouring lanes neighbouring bytes, 8 rows in flight per
//   lane and the next 8 prefetched; the M rows of x * gamma sit in shared
//   memory as broadcasts.  K is split across blocks so that the grid fills
//   whole waves of resident blocks (at least two per SM); each split writes
//   acc, sum x, sum x^2, gamma@W and beta@W partials, and a second kernel
//   adds them in split order before it applies the norm (never per split).
// wgmma (bf16 A and W, M > 8: prefill).  Bound: the operations, 2*M*N*K
//   over 989 TFLOP/s.  Design: tensor cores; TMA (descriptors encoded on the
//   host through the runtime's driver entry point, passed as
//   __grid_constant__) fills a 3-stage ring of A [128 x 64] and B [64 x 256]
//   tiles, 128-byte swizzled and zero-filled past the edges; two consumer
//   warpgroups, 64 rows each, turn their A rows into bf16(x * gamma) in
//   place, sum x and x^2, and run wgmma.m64n256k16 from shared memory.
//   Rounding: x * gamma is rounded once to bf16 for a bf16 output (as the
//   unfused chain rounds norm(x) before its GEMM); for an fp32 output (the
//   logits head) it is split into bf16 hi + lo, two MMAs, ~1e-5 from fp32;
//   an un-normalized bf16 A is exact.  LayerNorm's gamma@W and beta@W: the
//   producer warpgroup's three spare warps run CUDA-core fp32 FMA over the
//   B tiles already in shared memory.  When the tiles cannot fill the card
//   (small M or N), K is split as in the stream template.
// int8 W (weight-only quantization, `scale` [N] fp32 a column): both
//   templates take it (gemm.cuh, I8).  stream: the bound halves to K*N bytes;
//   a lane reads 8 bytes (8 columns) of a row, twice the rows in flight,
//   and turns them into fp32 without a conversion instruction.  wgmma: TMA
//   brings int8 tiles, widened to bf16 in shared memory (exact) by the
//   producer warpgroup's spare warps.  The scale multiplies the finalized
//   fp32 accumulator before bias, activation and residual (the TPU kernel's
//   order), once, in splitk_finish when K is split.
// fma32 (fp32 W: an fp32 policy in `auto` mode; no served path).  The
//   port's first design, kept as is: the K loop in one block, tiles staged
//   through shared memory with a one-tile register prefetch, fp32 FMA;
//   16 x 32 x 128 tiles at M <= 16, 64 x 64 x 16 above.
#include "gemm.cuh"

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

extern "C" int repro_fused_matmul(const void* a, const void* b, const float* scale,
                                  const void* gamma, const void* beta, const void* bias,
                                  const void* residual, void* out, void* part, int M,
                                  int N, int K, int a_dt, int b_dt, int vec_dt,
                                  int res_dt, int out_dt, int norm, int act, float eps,
                                  int a_vec, int b_vec, int tpl, int kchunk, int splits,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (tpl != TPL_FMA32) {
    GemmParams g{a, b, nullptr, gamma, beta, bias, residual, out,
                 reinterpret_cast<float*>(part), M, N, K, a_dt, b_dt, vec_dt, res_dt,
                 out_dt, norm, act, eps, kchunk, splits};
    const GemmScales sc{scale, nullptr};
    if (tpl == TPL_STREAM) return (int)launch_stream<false>(g, sc, s);
    if (tpl == TPL_WGMMA) return (int)launch_wgmma<false>(g, sc, s);
    return (int)cudaErrorInvalidValue;
  }
  if (b_dt == DT_I8 || scale) return (int)cudaErrorInvalidValue;  // fp32 / bf16 W only
  MMParams p{a, b, gamma, beta, bias, residual, out, M, N, K, a_dt, b_dt,
             vec_dt, res_dt, out_dt, norm, act, eps, a_vec, b_vec};
  if (M <= 16) {
    dim3 grid((N + 31) / 32, (M + 15) / 16);
    fused_mm_kernel<16, 32, 128, 1, 2><<<grid, 256, 0, s>>>(p);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    fused_mm_kernel<64, 64, 16, 4, 4><<<grid, 256, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_fused_matmul_stream_occupancy(int M, int i8) {
  return stream_occupancy<false>(M, i8);
}
