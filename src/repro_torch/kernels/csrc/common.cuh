// Shared device helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// element-type codes passed from the Python wrappers (int8: quantized
// weights and KV pools, which come with fp32 scales)
enum DTypeCode { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

#define NEG_INF_F (-1e30f)

__device__ __forceinline__ float ld_elem(const void* p, int64_t i, int dt) {
  return dt == DT_BF16
             ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
             : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_elem(void* p, int64_t i, int dt, float v) {
  if (dt == DT_BF16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// Four consecutive elements starting at index i (i % 4 == 0 and the base
// 16-byte aligned when `vec` is set: one 8-byte or 16-byte load).
__device__ __forceinline__ float4 ld4_aligned(const void* p, int64_t i, int dt) {
  if (dt == DT_BF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(p) + i);
    __nv_bfloat162 lo, hi;
    *reinterpret_cast<uint32_t*>(&lo) = u.x;
    *reinterpret_cast<uint32_t*>(&hi) = u.y;
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
}

// Elements [c, c+4) of row `r` of a row-major [rows, cols] matrix; zeros
// outside it.
__device__ __forceinline__ float4 ld4_row(const void* p, int r, int c, int rows,
                                          int cols, int dt, bool vec) {
  if (r >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t base = (int64_t)r * cols;
  if (vec && c + 3 < cols) return ld4_aligned(p, base + c, dt);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (c + j < cols) ? ld_elem(p, base + c + j, dt) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Eight bf16 values of a 16-byte load, element 0 in the low half of u.x.
__device__ __forceinline__ void unpack8(const uint4 u, float w[8]) {
  w[0] = __uint_as_float(u.x << 16);
  w[1] = __uint_as_float(u.x & 0xffff0000u);
  w[2] = __uint_as_float(u.y << 16);
  w[3] = __uint_as_float(u.y & 0xffff0000u);
  w[4] = __uint_as_float(u.z << 16);
  w[5] = __uint_as_float(u.z & 0xffff0000u);
  w[6] = __uint_as_float(u.w << 16);
  w[7] = __uint_as_float(u.w & 0xffff0000u);
}

// Byte j of x (an int8) as a float, exactly and without a conversion
// instruction: the byte, its sign bit flipped (s + 128), is placed in the
// mantissa of 2^23 (0x4B000000), and 2^23 + 128 is subtracted.
__device__ __forceinline__ float i8_to_f32(uint32_t x, int j) {
  const uint32_t u = __byte_perm(x ^ 0x80808080u, 0x4B000000u, 0x7540 + j);
  return __uint_as_float(u) - 8388736.f;
}

// Eight int8 values of an 8-byte load, element 0 in the low byte of u.x.
__device__ __forceinline__ void unpack8_i8(const uint2 u, float w[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = i8_to_f32(u.x, j);
    w[4 + j] = i8_to_f32(u.y, j);
  }
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Round through bf16 (the P tile is cast to V's dtype before P.V).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
