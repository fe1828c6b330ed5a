// MLA absorbed-form flash decode over the tiered latent cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::_flash_latent
// (body _kernel_latent), reached through flash_decode_attention_latent from
// models/attention.py::mla_decode: every head of a slot queries the slot's
// one shared latent stream. q (B, H, D) holds (q_nope @ W_uk ‖ q_rope) per
// head; each cached row (B, S, D) is (c_kv ‖ k_rope), and its first DV dims
// (the latent c_kv) are also the value. The call comes after the decode
// append, so the hot tier and then the cold tier hold the slot's valid rows;
// the output is the per-head latent context (B, H, DV) in f32.
//
// What bounds it on this card: at DeepSeek-V3's width (H = 128, D = 576,
// DV = 512) one decode step of 6 slots at length 80 reads about 2.9 MB (q,
// valid rows; the output adds 1.6 MB) and does about 134 MFLOP. Both
// bounds are microseconds; at these sizes the launch and the block's
// serial tile loop bound it.
//
// Design:
//  * The TPU grid (b, s_blocks) carries the softmax state of all heads of
//    a slot across its sequential S axis. Here one block owns R = 8 heads
//    of one slot, grid (H / R, B), and loops over 32-key tiles of the
//    slot's valid rows only (hot tier, then cold tier): no row at or past
//    a slot's length is read, so a masked row may hold anything, and a
//    length-0 slot writes zeros.
//  * Each tile is staged once in shared memory as f32 (32 x 576 x 4 B =
//    72 KiB) and serves all R heads twice: the logits read all D dims, the
//    value product the first DV. A warp takes one key at a time; its
//    lanes split D.
//  * Reproducible arithmetic, as in flash_decode.cu: the dot product over D
//    (zero-padded to a power of two) and the sums over a tile's 32 keys
//    are halving trees, and every product and sum is rounded on its own
//    (__fmul_rn, __fadd_rn), so the plain PyTorch version
//    (kernels/flash_decode.py::flash_decode_latent_plain) repeats the
//    kernel bit for bit. At 128 heads x 512 dims a one-ulp drift would
//    otherwise flip greedy tokens downstream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // keys per tile
constexpr int kHeads = 8;  // heads per block (R)
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// Halving-tree sum of the values x[i], i = lane + 32 * t, held TL per lane
// (TL a power of two, padding zero): first over t inside the lane, then
// across lanes with a butterfly (see flash_decode.cu).
template <int TL>
__device__ __forceinline__ float warp_tree(float (&x)[TL]) {
#pragma unroll
  for (int h = TL / 2; h > 0; h /= 2)
#pragma unroll
    for (int t = 0; t < h; ++t) x[t] = __fadd_rn(x[t], x[t + h]);
  float s = x[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// Halving-tree sum of 32 values.
__device__ __forceinline__ float tree32(float (&x)[kTile]) {
#pragma unroll
  for (int h = kTile / 2; h > 0; h /= 2)
#pragma unroll
    for (int j = 0; j < h; ++j) x[j] = __fadd_rn(x[j], x[j + h]);
  return x[0];
}

template <typename T>
struct LatentArgs {
  const float* q;   // (B, H, D) f32
  const T* hot;     // (B, HC, D)
  const T* cold;    // (B, CC, D)
  const int* lengths;  // (B,)
  float* out;       // (B, H, DV) f32
  int H, HC, CC;
  float scale;
};

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) latent_kernel(LatentArgs<T> a) {
  constexpr int TL = pow2_at_least((D + 31) / 32);  // key elements per lane, padded
  constexpr int DPT = (DV + kThreads - 1) / kThreads;  // value dims per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                // [kHeads][D]
  float* k_s = q_s + kHeads * D;    // [kTile][D]
  float* logit_s = k_s + kTile * D;  // [kHeads][kTile]
  float* p_s = logit_s + kHeads * kTile;  // [kHeads][kTile]

  const int h0 = blockIdx.x * kHeads, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int length = a.lengths[b];

  for (int e = threadIdx.x; e < kHeads * D; e += kThreads) {
    const int r = e / D, i = e % D;
    q_s[e] = h0 + r < a.H ? a.q[((int64_t)b * a.H + h0 + r) * D + i] : 0.f;
  }

  // online-softmax state, replicated in every thread; acc holds value
  // dims threadIdx.x + kThreads * c of every head
  float m[kHeads], l[kHeads], acc[kHeads][DPT];
#pragma unroll
  for (int r = 0; r < kHeads; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
  }
  __syncthreads();

  const int n_hot = min(length, a.HC);
  const int n_cold = min(max(length - a.HC, 0), a.CC);
  for (int tier = 0; tier < 2; ++tier) {
    const T* buf = tier == 0 ? a.hot : a.cold;
    const int cap = tier == 0 ? a.HC : a.CC;
    const int n_valid = tier == 0 ? n_hot : n_cold;
    for (int start = 0; start < n_valid; start += kTile) {
      const int n = min(kTile, n_valid - start);
      const T* rows = buf + ((int64_t)b * cap + start) * D;
      for (int e = threadIdx.x; e < kTile * D; e += kThreads)
        k_s[e] = e < n * D ? to_f32(rows[e]) : 0.f;
      __syncthreads();
      // logits: a warp takes one key and all heads of the block
      for (int j = warp; j < n; j += kWarps) {
        float kx[TL];
#pragma unroll
        for (int t = 0; t < TL; ++t) {
          const int i = lane + 32 * t;
          kx[t] = i < D ? k_s[j * D + i] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kHeads; ++r) {
          float x[TL];
#pragma unroll
          for (int t = 0; t < TL; ++t) {
            const int i = lane + 32 * t;
            x[t] = i < D ? __fmul_rn(q_s[r * D + i], kx[t]) : 0.f;
          }
          const float s = warp_tree<TL>(x);
          if (lane == 0) logit_s[r * kTile + j] = __fmul_rn(s, a.scale);
        }
      }
      __syncthreads();
      float m_new[kHeads], alpha[kHeads];
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        float mt = kNegInf;
        for (int j = 0; j < n; ++j) mt = fmaxf(mt, logit_s[r * kTile + j]);
        m_new[r] = fmaxf(m[r], mt);
        alpha[r] = expf(m[r] - m_new[r]);
      }
      for (int e = threadIdx.x; e < kHeads * kTile; e += kThreads) {
        const int r = e / kTile, j = e % kTile;
        p_s[e] = j < n ? expf(logit_s[e] - m_new[r]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        float ps[kTile];
#pragma unroll
        for (int j = 0; j < kTile; ++j) ps[j] = p_s[r * kTile + j];
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), tree32(ps));
        m[r] = m_new[r];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const int dv = threadIdx.x + kThreads * c;
          float pv[kTile];
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            pv[j] = dv < DV ? __fmul_rn(p_s[r * kTile + j], k_s[j * D + dv]) : 0.f;
          acc[r][c] = __fadd_rn(__fmul_rn(acc[r][c], alpha[r]), tree32(pv));
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kHeads; ++r) {
    if (h0 + r >= a.H) break;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int dv = threadIdx.x + kThreads * c;
      if (dv < DV) a.out[((int64_t)b * a.H + h0 + r) * DV + dv] = acc[r][c] / fmaxf(l[r], 1e-30f);
    }
  }
}

template <typename T, int D, int DV>
cudaError_t launch_d(const LatentArgs<T>& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(kHeads + kTile) * D + 2 * kHeads * kTile);
  cudaError_t err = cudaFuncSetAttribute(latent_kernel<T, D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.H + kHeads - 1) / kHeads, B);
  latent_kernel<T, D, DV><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// (D, DV): DeepSeek-V3 (512 + 64, 512) and its smoke config (16 + 8, 16).
template <typename T>
int run(const void* q, const void* hot, const void* cold, const void* lengths, void* out, int B,
        int H, int HC, int CC, int D, int DV, float scale, void* stream) {
  LatentArgs<T> a{(const float*)q, (const T*)hot, (const T*)cold, (const int*)lengths,
                  (float*)out, H, HC, CC, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 576 && DV == 512) return launch_d<T, 576, 512>(a, B, s);
  if (D == 24 && DV == 16) return launch_d<T, 24, 16>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_decode_latent(int is_bf16, const void* q, const void* hot, const void* cold,
                                   const void* lengths, void* out, int B, int H, int HC, int CC,
                                   int D, int DV, float scale, void* stream) {
  return is_bf16 ? run<__nv_bfloat16>(q, hot, cold, lengths, out, B, H, HC, CC, D, DV, scale, stream)
                 : run<float>(q, hot, cold, lengths, out, B, H, HC, CC, D, DV, scale, stream);
}
