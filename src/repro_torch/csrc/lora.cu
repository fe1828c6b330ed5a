// The quantized LoRA delta ((xq @ aq) @ bq) * scale for Hopper (sm_90a),
// in a sum order fixed per output row.
//
// Not a TPU kernel: the reference computes this product in XLA
// (src/repro/core/lora.py::apply), and the port's first version used two
// cuBLAS GEMMs. cuBLAS picks its algorithm, and so the order of each
// row's sums, by the number of rows M: on the H100 a row of (M, 2048) x
// (2048, 16) changed with M at every M >= 2 against the same row alone.
// Grouped admission (M = group x prompt), chunk waves (M = slots x C) and
// decode (M = slots) then add different deltas for the same token, and
// at falcon3-1b's width that flips greedy tokens. Here each output row's
// arithmetic depends only on that row.
//
// What bounds it on this card: bytes at prefill widths (x once, the
// factors once, the output once; falcon3-1b's lora_down at M = 192 moves
// 6.8 MB, 2.0 us at 3.35 TB/s), the length of one row's dependent add
// chain at decode (M = 6: six blocks, K / 32 adds each).
//
// Design: one block per row, 32 R threads (R <= 32).
//  * t[r] = sum_k xq[k] aq[k, r]: for each "lane" L < 32 of the order, the
//    products of k = L, L + 32, L + 64, ... are added in that order to a
//    sum starting at +0.0 (keys past K contribute +0.0); then the halving
//    tree over the 32 lane sums (element i + 16 added to element i, then
//    i + 8, ...), as an xor butterfly. Thread t runs lane L = t / R of rank
//    r = t % R, so a warp reads 32 consecutive words of aq (rows L and
//    L + 1 at R = 16): coalesced. The lane sums meet in shared memory and
//    the warp of rank r runs its butterfly. (A first version gave lane L of
//    warp r the same sum; its loads of aq strode 4R bytes apart, and one
//    falcon3-1b decode step's 54 launches took 1.14 ms against the cuBLAS
//    pair's 0.52: PERF.md.)
//  * After a barrier, thread n computes out[n] = (sum_{r < R} t[r] bq[r, n]
//    in order of r, from +0.0) * scale, for n = tid, tid + blockDim, ...;
//    bq rows are read coalesced.
//  * Every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
//    FMA contraction), in f32 whatever the input type; the plain PyTorch
//    version (kernels/lora.py::lora_delta_plain) repeats the order with
//    tensor ops, so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(32 * kMaxRank) lora_kernel(const T* __restrict__ xq,
                                                             const T* __restrict__ aq,
                                                             const T* __restrict__ bq,
                                                             T* __restrict__ out, int K, int N,
                                                             int R, float scale) {
  __shared__ float lane_s[kMaxRank][32];
  __shared__ float t_s[kMaxRank];
  const int m = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* x = xq + (int64_t)m * K;
  {
    const int r = threadIdx.x % R, L = threadIdx.x / R;
    float s = 0.f;
#pragma unroll 8
    for (int k = L; k < K; k += 32)
      s = __fadd_rn(s, __fmul_rn(to_f32(x[k]), to_f32(aq[(int64_t)k * R + r])));
    lane_s[r][L] = s;
  }
  __syncthreads();
  if (warp < R) {
    float s = lane_s[warp][lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
    if (lane == 0) t_s[warp] = s;
  }
  __syncthreads();
  T* orow = out + (int64_t)m * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float o = 0.f;
    for (int r = 0; r < R; ++r) o = __fadd_rn(o, __fmul_rn(t_s[r], to_f32(bq[(int64_t)r * N + n])));
    store(orow + n, __fmul_rn(o, scale));
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xq (M, K), aq (K, R), bq (R, N), out (M, N), all f32 or all bf16,
// contiguous. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lora_delta(int is_bf16, const void* xq, const void* aq, const void* bq, void* out,
                          int M, int K, int N, int R, float scale, void* stream) {
  if (R < 1 || R > kMaxRank || M < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    lora_kernel<T><<<M, 32 * R, 0, st>>>((const T*)xq, (const T*)aq, (const T*)bq, (T*)out, K, N,
                                         R, scale);
  } else {
    lora_kernel<float><<<M, 32 * R, 0, st>>>((const float*)xq, (const float*)aq,
                                             (const float*)bq, (float*)out, K, N, R, scale);
  }
  return cudaGetLastError();
}
