// Fused gated GEMM (SwiGLU) with norm prologue and residual epilogue.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:matmul_swiglu
// (_fused_gated_kernel):
//     C = silu(norm(A) @ Bg) * (norm(A) @ Bu) + residual,
//     A [M, K], Bg / Bu [K, N].
// Both products run on x * gamma (fp32) into their own fp32 accumulators
// over one K loop; one set of row sums serves both (sum x^2; LayerNorm adds
// sum x and gamma@Wg, beta@Wg, gamma@Wu, beta@Wu per column).  The finish is
// _finalize_norm twice, silu(g) * u in fp32, the residual, one store.
//
// The templates are fused_matmul.cu's (gemm.cuh, GATED = true), picked by
// kernels/matmul.py:gemm_plan:
// stream (bf16 W, M <= 8).  Bound: the two weight streams, 2*K*N*2 bytes
//   over 3.35 TB/s.  Each lane reads the same 16 bytes (8 columns) of a row
//   of Bg and of Bu; twice the accumulators, so 4 rows in flight per weight
//   (2 at M > 4) instead of 8.  Split K and the ordered second pass as in
//   fused_matmul.cu, carrying both products' partials.
// wgmma (bf16, M > 8).  Bound: the operations, 2*2*M*N*K over 989
//   TFLOP/s.  The block's four B boxes per stage are Bg and Bu at the same
//   128 output columns (the plain GEMM's 256 B columns, half the output
//   width), so one warpgroup's m64n256k16 accumulator holds g and u of the
//   same outputs and the epilogue pairs them.  Rounding, the LayerNorm
//   column sums and the split of K as in fused_matmul.cu.
// int8 Bg / Bu (phi4-mini's int8 serving; `sg` / `su` [N] fp32 column
//   scales): both templates as in fused_matmul.cu, the gate's scale on g
//   and the up's on u after the norm's finalize, before silu(g) * u.
// The expert form (repro_expert_swiglu, kernels/matmul.py:expert_swiglu;
//   replaces the reference's ops.expert_swiglu, which vmaps the TPU kernel
//   over the experts of an MoE layer): xe [NE, C, K] @ wg / wu [NE, K, N]
//   -> silu(g) * u [NE, C, N], bf16 operands, no norm, no residual, in one
//   launch of the stream template (C <= 8: a decode step's expert buffers)
//   or the wgmma template (prefill), the expert an outer grid index
//   (gemm.cuh, EX = true).  Bound: the stream template reads both weights of
//   every expert, 2*NE*K*N*2 bytes over 3.35 TB/s (mixtral-8x7b: 1.88 GB,
//   0.56 ms); the wgmma template's operations, 2*2*NE*C*N*K over 989
//   TFLOP/s.  An expert's rows are C whatever the tokens routed to it: an
//   expert left empty still streams its weights (a later change may skip
//   it: its output rows are unread).
// fma32 (fp32 W; no served path): the first design, kept as is — the K loop
//   in one block, a one-tile register prefetch, fp32 FMA; 16 x 16 x 128
//   tiles at M <= 16 and 64 x 32 x 16 above.
#include "gemm.cuh"

struct SGParams {
  const void* a;
  const void* bg;
  const void* bu;
  const void* gamma;
  const void* beta;
  const void* residual;
  void* out;
  int M, N, K;
  int a_dt, b_dt, vec_dt, res_dt, out_dt;
  int norm;
  float eps;
  int a_vec, b_vec;
};

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(256) fused_swiglu_kernel(const SGParams p) {
  constexpr int NT = 256;
  constexpr int BNT = BN / TN;          // threads along N
  constexpr int BMT = BM / TM;          // threads along M
  static_assert(BNT * BMT == NT, "tile shape must use 256 threads");
  static_assert(BN <= NT && BK <= NT, "per-column / per-k work needs a thread each");
  constexpr int KQ = BK / 4;            // 4-wide groups per A row tile
  constexpr int NQ = BN / 4;            // 4-wide groups per B row tile
  constexpr int NA = BM * KQ;           // A groups per tile
  constexpr int NB = BK * NQ;           // B groups per tile (each weight)
  constexpr int LA = (NA + NT - 1) / NT;
  constexpr int LB = (NB + NT - 1) / NT;

  __shared__ float As[BK][BM];          // prologue-scaled A, k-major
  __shared__ float Bgs[BK][BN], Bus[BK][BN];
  __shared__ float Gs[BK], Bts[BK];     // gamma / beta of this K tile
  __shared__ float sp1[LA * NT], sp2[LA * NT];
  __shared__ float rs1[BM], rs2[BM];
  __shared__ float gsg[BN], bsg[BN], gsu[BN], bsu[BN];

  const int tid = threadIdx.x;
  const int tx = tid % BNT, ty = tid / BNT;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const bool has_norm = p.norm != NORM_NONE;
  const bool ln = p.norm == NORM_LN;

  float accg[TM][TN], accu[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accg[i][j] = accu[i][j] = 0.f;
  float ps1[LA], ps2[LA];
#pragma unroll
  for (int i = 0; i < LA; ++i) ps1[i] = ps2[i] = 0.f;
  float gaccg = 0.f, baccg = 0.f, gaccu = 0.f, baccu = 0.f;

  float4 ra[LA], rg[LA], rbg[LB], rbu[LB];
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
        rbg[i] = ld4_row(p.bg, k0 + kr, n0 + nq, p.K, p.N, p.b_dt, p.b_vec);
        rbu[i] = ld4_row(p.bu, k0 + kr, n0 + nq, p.K, p.N, p.b_dt, p.b_vec);
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
        Bgs[kr][nq + 0] = rbg[i].x;
        Bgs[kr][nq + 1] = rbg[i].y;
        Bgs[kr][nq + 2] = rbg[i].z;
        Bgs[kr][nq + 3] = rbg[i].w;
        Bus[kr][nq + 0] = rbu[i].x;
        Bus[kr][nq + 1] = rbu[i].y;
        Bus[kr][nq + 2] = rbu[i].z;
        Bus[kr][nq + 3] = rbu[i].w;
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
        gaccg += Gs[kk] * Bgs[kk][tid];
        baccg += Bts[kk] * Bgs[kk][tid];
        gaccu += Gs[kk] * Bus[kk][tid];
        baccu += Bts[kk] * Bus[kk][tid];
      }
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bgv[TN], buv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * BMT];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bgv[j] = Bgs[kk][tx + j * BNT];
        buv[j] = Bus[kk][tx + j * BNT];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accg[i][j] = fmaf(av[i], bgv[j], accg[i][j]);
          accu[i][j] = fmaf(av[i], buv[j], accu[i][j]);
        }
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
    gsg[tid] = gaccg;
    bsg[tid] = baccg;
    gsu[tid] = gaccu;
    bsu[tid] = baccu;
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
      float g = accg[i][j], u = accu[i][j];
      if (p.norm == NORM_RMS) {
        g *= rstd;
        u *= rstd;
      }
      if (ln) {
        g = (g - mu * gsg[cl]) * rstd + bsg[cl];
        u = (u - mu * gsu[cl]) * rstd + bsu[cl];
      }
      float y = g / (1.f + expf(-g)) * u;
      const int64_t o = (int64_t)r * p.N + c;
      if (p.residual) y += ld_elem(p.residual, o, p.res_dt);
      st_elem(p.out, o, p.out_dt, y);
    }
  }
}

extern "C" int repro_fused_swiglu(const void* a, const void* bg, const void* bu,
                                  const float* sg, const float* su, const void* gamma,
                                  const void* beta, const void* residual, void* out,
                                  void* part, int M, int N, int K, int a_dt, int b_dt,
                                  int vec_dt, int res_dt, int out_dt, int norm, float eps,
                                  int a_vec, int b_vec, int tpl, int kchunk, int splits,
                                  void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (tpl != TPL_FMA32) {
    GemmParams g{a, bg, bu, gamma, beta, nullptr, residual, out,
                 reinterpret_cast<float*>(part), M, N, K, a_dt, b_dt, vec_dt, res_dt,
                 out_dt, norm, ACT_NONE, eps, kchunk, splits};
    const GemmScales sc{sg, su};
    if (tpl == TPL_STREAM) return (int)launch_stream<true>(g, sc, s);
    if (tpl == TPL_WGMMA) return (int)launch_wgmma<true>(g, sc, s);
    return (int)cudaErrorInvalidValue;
  }
  if (b_dt == DT_I8 || sg || su) return (int)cudaErrorInvalidValue;  // fp32 / bf16 W only
  SGParams p{a, bg, bu, gamma, beta, residual, out, M, N, K, a_dt, b_dt,
             vec_dt, res_dt, out_dt, norm, eps, a_vec, b_vec};
  if (M <= 16) {
    dim3 grid((N + 15) / 16, (M + 15) / 16);
    fused_swiglu_kernel<16, 16, 128, 1, 1><<<grid, 256, 0, s>>>(p);
  } else {
    dim3 grid((N + 31) / 32, (M + 63) / 64);
    fused_swiglu_kernel<64, 32, 16, 4, 2><<<grid, 256, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_fused_swiglu_stream_occupancy(int M, int i8) {
  return stream_occupancy<true>(M, i8);
}

// The expert form: `experts` gated GEMMs of [M, K] @ [K, N] over
// expert-major bf16 operands (a [experts, M, K], bg / bu [experts, K, N]),
// out [experts, M, N] (bf16 or fp32), `part` the split partials of every
// expert (kernels/matmul.py:_part_numel each).
extern "C" int repro_expert_swiglu(const void* a, const void* bg, const void* bu, void* out,
                                   void* part, int experts, int M, int N, int K, int out_dt,
                                   int tpl, int kchunk, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  GemmParams g{a, bg, bu, nullptr, nullptr, nullptr, nullptr, out,
               reinterpret_cast<float*>(part), M, N, K, DT_BF16, DT_BF16, DT_BF16, DT_BF16,
               out_dt, NORM_NONE, ACT_NONE, 0.f, kchunk, splits};
  const GemmScales sc{nullptr, nullptr};
  if (tpl == TPL_STREAM) return (int)launch_stream<true, true>(g, sc, s, experts);
  if (tpl == TPL_WGMMA) return (int)launch_wgmma<true, true>(g, sc, s, experts);
  return (int)cudaErrorInvalidValue;
}
