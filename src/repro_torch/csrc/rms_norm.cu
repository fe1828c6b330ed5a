// RMSNorm y = x / sqrt(mean(x^2) + eps) * w for Hopper (sm_90a), in a sum
// order fixed per row.
//
// Not a TPU kernel: the reference computes rms_norm in XLA
// (src/repro/models/layers.py::rms_norm). PyTorch's CUDA reduction picks its
// thread layout, and so the order of a row's sum, from the number of rows:
// on the H100 rows of mean(x * x) at width 2048 changed between M = 1, M = 6
// and M >= 8 (chip_smoke.py, m_dependence). The serving paths normalise a
// token's hidden state at several M (a decode step's slots, a chunk wave's
// slots x C, a grouped prefill's group x prompt), so the same token could
// be normalised in two orders and greedy tokens could part. Here each row's
// arithmetic depends on that row alone.
//
// What bounds it on this card: bytes (x read twice, the second time from
// L1 or L2; w once; y once). falcon3-1b's 37 norms of a decode step (6 rows
// of 2048) move 3.9 MB, 1.2 us at 3.35 TB/s; each launch is a few blocks, so
// the launch latency sets the time.
//
// Design: a warp per row, 8 rows per block. Lane L adds x[k] * x[k] for
// k = L, L + 32, L + 64, ... in that order to a sum starting at +0.0; an
// xor butterfly over the 32 lanes (the halving tree over the lanes, element
// i + 16 added to element i, then i + 8, ...) gives the row's sum s; then
// inv = 1 / sqrt(s / D + eps), each operation correctly rounded (__fdiv_rn,
// __fsqrt_rn, __fadd_rn), and y[k] = (x[k] * inv) * w[k]. No FMA
// contraction. The plain PyTorch version (kernels/rms_norm.py) repeats the
// order with tensor ops, every step correctly rounded as here, so the two
// agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) rms_norm_kernel(const T* __restrict__ x,
                                                            const W* __restrict__ w,
                                                            T* __restrict__ out, int M, int D,
                                                            float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (int64_t)row * D;
  float s = 0.f;
#pragma unroll 8
  for (int k = lane; k < D; k += 32) {
    const float v = to_f32(xr[k]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(s, (float)D), eps)));
  T* orow = out + (int64_t)row * D;
#pragma unroll 8
  for (int k = lane; k < D; k += 32)
    store(orow + k, __fmul_rn(__fmul_rn(to_f32(xr[k]), inv), to_f32(w[k])));
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, int M, int D, float eps,
                   cudaStream_t st) {
  rms_norm_kernel<T, W><<<(M + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const T*)x, (const W*)w, (T*)out, M, D, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, D) and out (M, D) f32 or bf16, w (D,) f32 or bf16, contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int rms_norm(int x_is_bf16, int w_is_bf16, const void* x, const void* w, void* out,
                        int M, int D, float eps, void* stream) {
  if (M < 1 || D < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (x_is_bf16) {
    return w_is_bf16 ? launch<B, B>(x, w, out, M, D, eps, st)
                     : launch<B, float>(x, w, out, M, D, eps, st);
  }
  return w_is_bf16 ? launch<float, B>(x, w, out, M, D, eps, st)
                   : launch<float, float>(x, w, out, M, D, eps, st);
}
