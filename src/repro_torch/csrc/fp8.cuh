#pragma once
// fp8 (e4m3) KV tiers, shared by the attention kernels: the tier type
// __nv_fp8_e4m3 (one byte; only its storage is used), its exact upcast to
// f32, and the downcast that the prefill kernels' emit applies.
//
// The downcast is the reference's (jax's astype(float8_e4m3fn)): round to
// nearest even, and NaN (byte 0x7f, with the sign kept) where |x| > 464 or
// x is not finite. It is written by hand: __nv_cvt_float_to_fp8 with
// __NV_SATFINITE and the cvt.rn.satfinite.e4m3x2 instruction saturate to
// 448 where the reference gives NaN. The same integer steps make the plain
// version, kv_cache.to_tier, so the two agree bit for bit.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

// The upcast: e4m3 (sign, 4 exponent bits of bias 7, 3 mantissa bits;
// subnormals m * 2^-9; byte 0x7f / 0xff NaN, no infinities) -> f16 by the
// hardware conversion (cvt.rn.f16x2.e4m3x2), then f32: both steps exact,
// since every e4m3 value is an f16 value. A first, hand-written upcast
// (bit fields and selects) made the fp8 decode forms 1.3-5.5x slower than
// this one on the H100 (PERF.md §6).
__device__ __forceinline__ float e4m3_to_f32(uint32_t byte) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)byte, __NV_E4M3)));
}

__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return e4m3_to_f32(v.__x); }

// f32 -> e4m3 byte (see the note above).
__device__ __forceinline__ uint32_t to_e4m3(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t sign = (u >> 24) & 0x80u;
  const float a = fabsf(x);
  if (!(a <= 464.f)) return sign | 0x7fu;  // past 464, infinite or NaN
  // subnormals: whole multiples of 2^-9 (an exact product), half to even;
  // 8 of them is 2^-6, whose byte 0x08 follows on
  if (a < 0.015625f) return sign | (uint32_t)__float2int_rn(__fmul_rn(a, 512.f));
  // normal: rebias the exponent (127 -> 7), round the 23-bit mantissa to
  // 3 bits, half to even; a carry moves into the exponent
  const uint32_t r = (u & 0x7fffffffu) - (120u << 23);
  return sign | ((r + 0x7ffffu + ((r >> 20) & 1u)) >> 20);
}

}  // namespace
