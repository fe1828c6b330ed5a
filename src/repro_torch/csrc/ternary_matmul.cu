// Packed-ternary matmuls for Hopper (sm_90a): one integer core, three
// prologue / epilogue pairs, five entry points.
//
// Replaces four TPU kernels of src/repro/kernels/ternary_matmul.py:
//  * ternary_matmul_actq_pallas (body _actq_kernel), entry points
//    ternary_matmul_actq and ternary_matmul_actq_expert: raw f32/bf16 x
//    (M, K) -> per-row absmax -> scale = qmax / max(absmax, 1e-5) -> int8
//    codes rint(x * scale) clipped -> int8 x trit int32 accumulate ->
//    out = float(acc) * (col_scale[n] / scale[m]), f32.
//  * ternary_matmul_fused_pallas (body _fused_kernel), entry point
//    ternary_matmul_known: int8 codes (M, K) and their per-row scale
//    x_scale (M,) from the caller (the carried-scale path,
//    fuse_act_quant=False) -> the same accumulate and epilogue.
//  * ternary_matmul_fused_batched_pallas (body _fused_batched_kernel),
//    entry point ternary_matmul_known_expert: the known-scale form over a
//    leading expert dimension, codes (E, C, K), x_scale (E, C).
//  * ternary_matmul_pallas (body _kernel), entry point ternary_matmul_int32:
//    int8 codes (M, K) -> the exact int32 accumulator (M, N), no scales.
//
// The expert forms run E independent products x (E, C, K) x packed
// (E, K/g, N) with per-expert per-column scales (E, N) in ONE launch: the
// expert index is the grid's z axis and only offsets the pointers.
//
// What bounds it on this card: at decode (M = 6) the packed weights are
// the only large operand (K*N/4 bytes under pack2), so it is bound by the
// bytes it moves; at prefill (M = 192) the int8 operations dominate. The
// expert forms read every expert's packed weights once per launch (C = 1
// at decode, 8 at prefill for DeepSeek-V3), so they are bound by bytes.
//
// Design:
//  * The prologue is a compile-time switch. kActQuant: the TPU kernel
//    sweeps the absmax once per row tile and carries the scale in scratch
//    across the output-column axis; blocks here run in no order, so every
//    block recomputes the absmax of its own 8 rows over the full K (one
//    warp per row; x is small and stays in L2) and quantizes those rows
//    into shared memory once. kCodes: the caller's int8 codes are copied
//    into the same shared-memory layout and the caller's row scale is
//    read as given. Either way no int8 copy of x is written to device
//    memory by this kernel.
//  * Trits decode in registers from a 256-entry table in shared memory:
//    one byte of pack2 -> four int8 trits in one 32-bit word; one byte of
//    pack243 -> four trits in a word plus the fifth. Each product of four
//    codes by four trits is one __dp4a into an int32 accumulator.
//  * A block covers 8 rows x 64 columns; its 256 threads are 16 column
//    quads x 16 slices of the K groups, and the 16 partial sums are added
//    in shared memory at the end (integers: the order does not matter).
//  * The epilogue is the second switch. kScaled divides the column scale
//    by the row scale and then multiplies, the reference's order, so
//    results are bit-identical to the plain versions; kInt32 stores the
//    accumulator itself. Codes round with rintf (half to even, like
//    jnp.round and torch.round). Activation columns at or past the true K
//    read as zero, which is how a pack243 weight's padding trits drop out;
//    rows past M and columns past N are masked, nothing is padded. A row
//    of zero codes (an expert slot with no token) gives exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 8;             // rows per block: one warp per row in the prologue
constexpr int kColQuads = 16;      // 4-column groups per block
constexpr int kBN = kColQuads * 4;  // 64 columns per block
constexpr int kSlices = kThreads / kColQuads;  // 16 slices of the K groups
constexpr float kEps = 1e-5f;

enum Prologue { kActQuant, kCodes };
enum Epilogue { kScaled, kInt32 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int group_stride(int g) { return g == 4 ? 4 : 8; }

__host__ __device__ inline size_t codes_bytes(int kg, int g) {
  return ((size_t)kBM * kg * group_stride(g) + 15) / 16 * 16;
}

struct Args {
  const void* x;         // (E, M, K): raw f32/bf16 (kActQuant) or int8 codes (kCodes)
  const float* x_scale;  // (E, M): the codes' row scale (kCodes + kScaled only)
  const uint8_t* packed;  // (E, KG, N)
  const float* col_scale;  // (E, N) (kScaled only)
  void* out;             // (E, M, N): f32 (kScaled) or int32 (kInt32)
  int M, K, KG, N;
  float qmax, qmin;
};

// T: the element type of x (float, __nv_bfloat16, or int8_t for kCodes).
template <typename T, int G, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads) ternary_kernel(Args a) {
  constexpr int GS = group_stride(G);
  const int M = a.M, K = a.K, KG = a.KG, N = a.N;
  // expert e of a batched launch (gridDim.z = E; 1 for a plain product)
  const int64_t e = blockIdx.z;
  const T* x = static_cast<const T*>(a.x) + e * M * K;
  const uint8_t* packed = a.packed + e * KG * N;
  __shared__ int lut_lo[256];  // trits 0..3 of a byte as four int8 lanes
  __shared__ int lut_hi[256];  // pack243: trit 4
  __shared__ float row_scale[kBM];
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = KG * GS;
  int8_t* codes = reinterpret_cast<int8_t*>(smem);  // [kBM][KG][GS]
  int* red = reinterpret_cast<int*>(smem + codes_bytes(KG, G));  // [kSlices][kBM][kBN]

  for (int v = threadIdx.x; v < 256; v += kThreads) {
    int lo = 0, hi = 0, r = v;
    for (int i = 0; i < G; ++i) {
      int t;
      if (G == 4) {
        const int c = (v >> (2 * i)) & 3;
        t = (c & 1) - ((c >> 1) & 1);
      } else {
        t = r % 3 - 1;
        r /= 3;
      }
      if (i < 4) lo |= (t & 0xff) << (8 * i);
      else hi = t;
    }
    lut_lo[v] = lo;
    lut_hi[v] = hi;
  }

  // ---- prologue: int8 codes (and the scale) of this block's rows ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kBM;
  {
    const int m = m0 + warp;
    const T* xr = x + (int64_t)m * K;
    int8_t* dst = codes + warp * row_bytes;
    if constexpr (PRO == kActQuant) {
      float amax = 0.f;
      if (m < M)
        for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
      for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float scale = a.qmax / fmaxf(amax, kEps);
      if (lane == 0) row_scale[warp] = scale;
      for (int k = lane; k < KG * G; k += 32) {
        const float v = (m < M && k < K) ? to_f32(xr[k]) : 0.f;
        const float q = fminf(fmaxf(rintf(v * scale), a.qmin), a.qmax);
        dst[(k / G) * GS + (k % G)] = (int8_t)(int)q;
      }
    } else {
      if (EPI == kScaled && lane == 0)
        row_scale[warp] = m < M ? a.x_scale[e * M + m] : 1.f;  // masked rows divide by 1
      for (int k = lane; k < KG * G; k += 32)
        dst[(k / G) * GS + (k % G)] = (m < M && k < K) ? (int8_t)xr[k] : (int8_t)0;
    }
  }
  __syncthreads();

  // ---- int8 x trit accumulate over this thread's K slice ----
  const int cq = threadIdx.x % kColQuads;
  const int slice = threadIdx.x / kColQuads;
  const int n0 = blockIdx.x * kBN + cq * 4;
  int acc[kBM][4];
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  for (int kg = slice; kg < KG; kg += kSlices) {
    const uint8_t* prow = packed + (int64_t)kg * N;
    int w_lo[4], w_hi[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // past N: the all-zero-trit byte (0 under pack2, 121 under pack243)
      const int byte = (n0 + c < N) ? prow[n0 + c] : (G == 4 ? 0 : 121);
      w_lo[c] = lut_lo[byte];
      w_hi[c] = lut_hi[byte];
    }
#pragma unroll
    for (int r = 0; r < kBM; ++r) {
      const int8_t* xg = codes + r * row_bytes + kg * GS;
      const int xw = *reinterpret_cast<const int*>(xg);
      const int x4 = (G == 5) ? (int)xg[4] : 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = __dp4a(xw, w_lo[c], acc[r][c]);
        if (G == 5) acc[r][c] += x4 * w_hi[c];
      }
    }
  }

  // ---- add the slices, then rescale (kScaled) or store as is (kInt32) ----
  int* mine = red + slice * kBM * kBN;
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mine[r * kBN + cq * 4 + c] = acc[r][c];
  __syncthreads();
  for (int o = threadIdx.x; o < kBM * kBN; o += kThreads) {
    const int r = o / kBN, col = o % kBN;
    const int m = m0 + r, n = blockIdx.x * kBN + col;
    if (m >= M || n >= N) continue;
    int s = 0;
    for (int t = 0; t < kSlices; ++t) s += red[(t * kBM + r) * kBN + col];
    const int64_t at = (e * M + m) * N + n;
    if constexpr (EPI == kScaled)
      static_cast<float*>(a.out)[at] = (float)s * (a.col_scale[e * N + n] / row_scale[r]);
    else
      static_cast<int32_t*>(a.out)[at] = s;
  }
}

template <typename T, int G, int PRO, int EPI>
cudaError_t launch_one(const Args& a, int E, cudaStream_t stream) {
  const size_t smem = codes_bytes(a.KG, G) + (size_t)kSlices * kBM * kBN * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(ternary_kernel<T, G, PRO, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM, E);
  ternary_kernel<T, G, PRO, EPI><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int PRO, int EPI>
int by_group(const Args& a, int E, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return group == 4 ? launch_one<T, 4, PRO, EPI>(a, E, s) : launch_one<T, 5, PRO, EPI>(a, E, s);
}

Args make_args(const void* x, const void* x_scale, const void* packed, const void* col_scale,
               void* out, int M, int K, int KG, int N, int act_bits) {
  return Args{x, static_cast<const float*>(x_scale), static_cast<const uint8_t*>(packed),
              static_cast<const float*>(col_scale), out, M, K, KG, N,
              act_bits == 4 ? 7.f : 127.f, act_bits == 4 ? -8.f : -128.f};
}

int actq(const void* x, int x_is_bf16, const void* packed, const void* col_scale, void* out,
         int E, int M, int K, int KG, int N, int group, int act_bits, void* stream) {
  const Args a = make_args(x, nullptr, packed, col_scale, out, M, K, KG, N, act_bits);
  return x_is_bf16 ? by_group<__nv_bfloat16, kActQuant, kScaled>(a, E, group, stream)
                   : by_group<float, kActQuant, kScaled>(a, E, group, stream);
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Every entry point returns cudaGetLastError() after the launch (0 on success).

// Raw x (M, K) f32/bf16 -> f32 (M, N), act-quant prologue.
extern "C" int ternary_matmul_actq(const void* x, int x_is_bf16, const void* packed,
                                   const void* col_scale, void* out, int M, int K, int KG,
                                   int N, int group, int act_bits, void* stream) {
  return actq(x, x_is_bf16, packed, col_scale, out, 1, M, K, KG, N, group, act_bits, stream);
}

// x (E, C, K), packed (E, KG, N), col_scale (E, N), out (E, C, N).
extern "C" int ternary_matmul_actq_expert(const void* x, int x_is_bf16, const void* packed,
                                          const void* col_scale, void* out, int E, int C, int K,
                                          int KG, int N, int group, int act_bits, void* stream) {
  return actq(x, x_is_bf16, packed, col_scale, out, E, C, K, KG, N, group, act_bits, stream);
}

// Known scale: int8 codes (M, K) with x_scale (M,) -> f32 (M, N).
extern "C" int ternary_matmul_known(const void* xq, const void* x_scale, const void* packed,
                                    const void* col_scale, void* out, int M, int K, int KG,
                                    int N, int group, void* stream) {
  const Args a = make_args(xq, x_scale, packed, col_scale, out, M, K, KG, N, 8);
  return by_group<int8_t, kCodes, kScaled>(a, 1, group, stream);
}

// Known scale over experts: codes (E, C, K), x_scale (E, C), packed
// (E, KG, N), col_scale (E, N) -> f32 (E, C, N).
extern "C" int ternary_matmul_known_expert(const void* xq, const void* x_scale,
                                           const void* packed, const void* col_scale, void* out,
                                           int E, int C, int K, int KG, int N, int group,
                                           void* stream) {
  const Args a = make_args(xq, x_scale, packed, col_scale, out, C, K, KG, N, 8);
  return by_group<int8_t, kCodes, kScaled>(a, E, group, stream);
}

// int8 codes (M, K) -> the exact int32 accumulator (M, N).
extern "C" int ternary_matmul_int32(const void* xq, const void* packed, void* out, int M, int K,
                                    int KG, int N, int group, void* stream) {
  const Args a = make_args(xq, nullptr, packed, nullptr, out, M, K, KG, N, 8);
  return by_group<int8_t, kCodes, kInt32>(a, 1, group, stream);
}
