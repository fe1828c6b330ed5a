// Act-quant-prologue packed-ternary matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ternary_matmul.py::
// ternary_matmul_actq_pallas (body _actq_kernel): raw f32/bf16 x (M, K)
// and packed trits (ceil(K/g), N) -> per-row absmax -> scale = qmax /
// max(absmax, 1e-5) -> int8 codes rint(x * scale) clipped -> int8 x trit
// int32 accumulate -> out = float(acc) * (col_scale[n] / scale[m]), f32.
//
// The expert form (entry point ternary_matmul_actq_expert; reference
// kernels/ops.py::ternary_matmul_expert, the same Pallas kernel with a
// leading expert grid axis) runs E independent products x (E, C, K) x
// packed (E, K/g, N) with per-expert per-column scales (E, N) in ONE
// launch: the expert index is the grid's z axis and only offsets the four
// pointers.
//
// What bounds it on this card: at decode (M = 6) the packed weights are
// the only large operand (K*N/4 bytes under pack2), so it is bound by the
// bytes it moves; at prefill (M = 192) the int8 operations dominate. The
// expert form reads every expert's packed weights once per launch (C = 1
// at decode, 8 at prefill for DeepSeek-V3), so it is bound by bytes.
//
// Design:
//  * The TPU kernel sweeps the absmax once per row tile and carries the
//    scale in scratch across the output-column axis. Blocks here run in
//    no order, so every block recomputes the absmax of its own 8 rows over
//    the full K (one warp per row; x is small and stays in L2) and then
//    quantizes those rows into shared memory once. No second launch and
//    no int8 copy of x in device memory.
//  * Trits decode in registers from a 256-entry table in shared memory:
//    one byte of pack2 -> four int8 trits in one 32-bit word; one byte of
//    pack243 -> four trits in a word plus the fifth. Each product of four
//    codes by four trits is one __dp4a into an int32 accumulator.
//  * A block covers 8 rows x 64 columns; its 256 threads are 16 column
//    quads x 16 slices of the K groups, and the 16 partial sums are added
//    in shared memory at the end (integers: the order does not matter).
//  * Codes round with rintf (half to even, like jnp.round and
//    torch.round); the epilogue divides the column scale by the row scale
//    and then multiplies, the reference's order, so results are
//    bit-identical to the plain version. Activation columns at or past the
//    true K read as zero, which is how a pack243 weight's padding trits
//    drop out.

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int group_stride(int g) { return g == 4 ? 4 : 8; }

__host__ __device__ inline size_t codes_bytes(int kg, int g) {
  return ((size_t)kBM * kg * group_stride(g) + 15) / 16 * 16;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) actq_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ col_scale, float* __restrict__ out,
    int M, int K, int KG, int N, float qmax, float qmin) {
  constexpr int GS = group_stride(G);
  // expert e of a batched launch (gridDim.z = E; 1 for a plain product)
  const int64_t e = blockIdx.z;
  x += e * M * K;
  packed += e * KG * N;
  col_scale += e * N;
  out += e * M * N;
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

  // ---- prologue: absmax, scale and int8 codes of this block's rows ----
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kBM;
  {
    const int m = m0 + warp;
    const T* xr = x + (int64_t)m * K;
    float amax = 0.f;
    if (m < M)
      for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
    for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = qmax / fmaxf(amax, kEps);
    if (lane == 0) row_scale[warp] = scale;
    int8_t* dst = codes + warp * row_bytes;
    for (int k = lane; k < KG * G; k += 32) {
      const float v = (m < M && k < K) ? to_f32(xr[k]) : 0.f;
      const float q = fminf(fmaxf(rintf(v * scale), qmin), qmax);
      dst[(k / G) * GS + (k % G)] = (int8_t)(int)q;
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

  // ---- add the slices, rescale, store ----
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
    out[(int64_t)m * N + n] = (float)s * (col_scale[n] / row_scale[r]);
  }
}

template <typename T, int G>
cudaError_t launch(const void* x, const void* packed, const void* col_scale, void* out, int E,
                   int M, int K, int KG, int N, float qmax, float qmin, cudaStream_t stream) {
  const size_t smem = codes_bytes(KG, G) + (size_t)kSlices * kBM * kBN * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(actq_kernel<T, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  actq_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(col_scale), static_cast<float*>(out), M, K, KG, N, qmax, qmin);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

int dispatch(const void* x, int x_is_bf16, const void* packed, const void* col_scale, void* out,
             int E, int M, int K, int KG, int N, int group, int act_bits, void* stream) {
  const float qmax = act_bits == 8 ? 127.f : 7.f;
  const float qmin = act_bits == 8 ? -128.f : -8.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 4)
    return x_is_bf16
               ? launch<__nv_bfloat16, 4>(x, packed, col_scale, out, E, M, K, KG, N, qmax, qmin, s)
               : launch<float, 4>(x, packed, col_scale, out, E, M, K, KG, N, qmax, qmin, s);
  return x_is_bf16
             ? launch<__nv_bfloat16, 5>(x, packed, col_scale, out, E, M, K, KG, N, qmax, qmin, s)
             : launch<float, 5>(x, packed, col_scale, out, E, M, K, KG, N, qmax, qmin, s);
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success).
extern "C" int ternary_matmul_actq(const void* x, int x_is_bf16, const void* packed,
                                   const void* col_scale, void* out, int M, int K, int KG,
                                   int N, int group, int act_bits, void* stream) {
  return dispatch(x, x_is_bf16, packed, col_scale, out, 1, M, K, KG, N, group, act_bits, stream);
}

// x (E, C, K), packed (E, KG, N), col_scale (E, N), out (E, C, N).
extern "C" int ternary_matmul_actq_expert(const void* x, int x_is_bf16, const void* packed,
                                          const void* col_scale, void* out, int E, int C, int K,
                                          int KG, int N, int group, int act_bits, void* stream) {
  return dispatch(x, x_is_bf16, packed, col_scale, out, E, C, K, KG, N, group, act_bits, stream);
}
