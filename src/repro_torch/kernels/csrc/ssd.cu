// Mamba2 SSD (state-space duality) chunked scan.
//
// Replaces the TPU kernels src/repro/kernels/ssd.py:ssd_multihead
// (_ssd_mh_kernel, all heads per (batch, chunk)) and :ssd (_ssd_kernel, one
// head per grid cell).  Both compute one function; the TPU picks between
// them by whether the [H, P, N] state fits its VMEM.  Here one kernel serves
// both.  Per chunk of L steps, with cum = inclusive cumsum(dt * A):
//     y[t]  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s      intra
//           + exp(cum_t) (C_t . h)                                    state in
//           + D x_t                                                   skip
//     h    <- exp(cum_L) h + sum_s exp(cum_L - cum_s) dt_s x_s B_s^T  state out
// x [Bt, S, H, P] and B, C [Bt, S, N] in bf16 or fp32; dt [Bt, S, H], A and
// D [H] fp32; y [Bt, S, H, P] in x's dtype, h_final [Bt, H, P, N] fp32.
//
// What bounds it on an H100: at the serving shapes (S <= 512, N 16 or 128)
// the operations, not the bytes: each chunk does L*L*N multiply-adds for
// C.B^T against L*P*(L + 2N) for the rest.  This first version runs them on
// the fp32 FMA units, not the tensor cores.  Design: the TPU carries h across
// a sequential grid dimension; here a loop over chunks runs inside the block
// and h stays in shared memory, fp32.  The recurrence is independent per
// (batch, head, row p of the state), so the grid is (P / 16, H, Bt): a single
// prompt of mamba2 (80 heads) still fills the 132 SMs.  Each block recomputes
// the chunk's masked C.B^T, 4 x 4 outputs per thread from shared memory.
// Any S: the tail chunk is padded with dt = 0, x = B = C = 0, which is exact
// (the decay is exp(0) = 1 and nothing is added to the state), and its pad
// rows are not stored.
#include "common.cuh"

constexpr int SSD_L = 64;    // chunk length
constexpr int SSD_PT = 16;   // state rows (of P) per block
constexpr int SSD_NT = 256;  // threads per block

static_assert(SSD_L == 64, "the chunk cumsum gives each lane of one warp two steps");
static_assert(SSD_NT == 256 && SSD_L * SSD_L == 16 * SSD_NT, "4 x 4 C.B^T tile a thread");

struct SSDParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  float* hout;
  int Bt, S, H, P, N;
  int x_dt, bc_dt;
};

// floats of dynamic shared memory for state width N (a width past the card's
// limit fails cudaFuncSetAttribute in repro_ssd, and the wrapper raises)
__host__ __device__ inline int ssd_smem_floats(int N) {
  return 2 * SSD_L * (N + 1)        // B, C chunk
         + SSD_L * (SSD_L + 1)      // masked C.B^T * decay * dt
         + SSD_L * SSD_PT           // x tile
         + SSD_PT * (N + 1)         // state tile
         + 4 * SSD_L;               // dt, cum, exp(cum), exp(cum_L - cum) dt
}

__global__ void __launch_bounds__(SSD_NT) ssd_kernel(const SSDParams p) {
  extern __shared__ float sm[];
  const int N = p.N, ldn = N + 1, ldl = SSD_L + 1;
  float* Bs = sm;
  float* Cs = Bs + SSD_L * ldn;
  float* W = Cs + SSD_L * ldn;
  float* xs = W + SSD_L * ldl;
  float* hs = xs + SSD_L * SSD_PT;
  float* dts = hs + SSD_PT * ldn;
  float* cum = dts + SSD_L;
  float* ein = cum + SSD_L;
  float* bw = ein + SSD_L;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * SSD_PT, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S, H = p.H, P = p.P;
  const float A = p.A[h], Dh = p.D[h];

  for (int i = tid; i < SSD_PT * ldn; i += SSD_NT) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += SSD_L) {
    const int len = min(SSD_L, S - c0);
    const int64_t row0 = (int64_t)b * S + c0;  // (batch, time) row of step 0
    for (int t = tid; t < SSD_L; t += SSD_NT)
      dts[t] = t < len ? p.dt[(row0 + t) * H + h] : 0.f;
    for (int i = tid; i < SSD_L * N; i += SSD_NT) {
      const int t = i / N, n = i % N;
      const bool in = t < len;
      Bs[t * ldn + n] = in ? ld_elem(p.B, (row0 + t) * N + n, p.bc_dt) : 0.f;
      Cs[t * ldn + n] = in ? ld_elem(p.C, (row0 + t) * N + n, p.bc_dt) : 0.f;
    }
    for (int i = tid; i < SSD_L * SSD_PT; i += SSD_NT) {
      const int t = i / SSD_PT, pp = p0 + i % SSD_PT;
      xs[i] = (t < len && pp < P) ? ld_elem(p.x, ((row0 + t) * H + h) * P + pp, p.x_dt)
                                  : 0.f;
    }
    __syncthreads();

    if (tid < 32) {  // inclusive cumsum of dt * A over the chunk, one warp
      float a0 = dts[tid] * A, a1 = dts[tid + 32] * A;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, a0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, a1, o);
        if (tid >= o) { a0 += u0; a1 += u1; }
      }
      a1 += __shfl_sync(0xffffffffu, a0, 31);
      cum[tid] = a0;
      cum[tid + 32] = a1;
    }
    __syncthreads();
    const float last = cum[SSD_L - 1];
    for (int t = tid; t < SSD_L; t += SSD_NT) {
      ein[t] = expf(cum[t]);
      bw[t] = expf(last - cum[t]) * dts[t];
    }

    {  // W[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, else 0
      const int ty = tid / 16, tx = tid % 16;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cv[i] = Cs[(ty + 16 * i) * ldn + n];
          bv[i] = Bs[(tx + 16 * i) * ldn + n];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          W[t * ldl + s] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
    }
    __syncthreads();

    {  // y for this chunk, from W, the incoming state and the skip
      const int pl = tid % SSD_PT, tg = tid / SSD_PT;
      const int pp = p0 + pl;
      for (int t = tg; t < SSD_L; t += SSD_NT / SSD_PT) {
        float intra = 0.f;
        for (int s = 0; s <= t; ++s) intra += W[t * ldl + s] * xs[s * SSD_PT + pl];
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter += Cs[t * ldn + n] * hs[pl * ldn + n];
        const float v = intra + ein[t] * inter + Dh * xs[t * SSD_PT + pl];
        if (t < len && pp < P) st_elem(p.y, ((row0 + t) * H + h) * P + pp, p.x_dt, v);
      }
    }
    __syncthreads();  // every read of the old state is done

    const float dec = expf(last);
    for (int e = tid; e < SSD_PT * N; e += SSD_NT) {
      const int pl = e / N, n = e % N;
      float acc = 0.f;
      for (int s = 0; s < SSD_L; ++s) acc += bw[s] * xs[s * SSD_PT + pl] * Bs[s * ldn + n];
      hs[pl * ldn + n] = hs[pl * ldn + n] * dec + acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < SSD_PT * N; e += SSD_NT) {
    const int pl = e / N, n = e % N;
    if (p0 + pl < P) p.hout[(((int64_t)b * H + h) * P + p0 + pl) * N + n] = hs[pl * ldn + n];
  }
}

extern "C" int repro_ssd(const void* x, const float* dt, const float* A, const void* B,
                         const void* C, const float* D, void* y, float* hout, int Bt,
                         int S, int H, int P, int N, int x_dt, int bc_dt, void* stream) {
  if (Bt == 0 || S == 0 || H == 0 || P == 0) return 0;
  SSDParams prm{x, dt, A, B, C, D, y, hout, Bt, S, H, P, N, x_dt, bc_dt};
  const int smem = ssd_smem_floats(N) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((P + SSD_PT - 1) / SSD_PT, H, Bt);
  ssd_kernel<<<grid, SSD_NT, smem, reinterpret_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}
