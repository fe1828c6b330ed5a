// Fused-RoPE GQA flash decode over the tiered KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::_flash_gqa_fused
// (body _kernel_gqa_fused), reached through flash_decode_attention(k_new=...,
// rope_theta=...): one new token per slot attends over the hot tier, then
// the cold tier, then (for active slots) its own pending (k, v), with an
// online softmax in f32. q and the pending k arrive unrotated and rotate at
// position lengths[b]; the rotated k is returned for the caller's append.
//
// What bounds it on this card: the bytes of the valid KV rows (one read of
// each), far below the operation peak at one query token per slot.
//
// Design:
//  * The TPU grid (batch, kv_group, s_blocks) carries the softmax state
//    across its sequential S axis. Here one block owns one (slot, kv group)
//    and loops over 32-key tiles of the valid prefix only: the loop bound
//    is the slot's length, so no row at or past the valid length is read
//    (the 0 * NaN hazard of a masked row cannot arise) and a length-0
//    inactive slot writes zeros.
//  * GQA: the rep query heads of the group share every key tile. A warp
//    takes one key at a time; its lanes split the head dimension.
//  * Reproducible arithmetic. At full width a one-ulp difference in the
//    attention output flips int8 activation codes downstream and, within a
//    few tokens, greedy choices. So every sum here has one fixed order that
//    the plain PyTorch version (kernels/flash_decode.py) repeats: the dot
//    product over the head dimension and the sums over a tile's 32 keys are
//    halving trees (element i + n/2 added to element i, level by level),
//    and every product and sum is rounded on its own (__fmul_rn,
//    __fadd_rn: no FMA contraction). Kernel and plain version then agree
//    bit for bit. RoPE uses cos and sin tables from the wrapper, computed
//    with the plain version's own expression.
//  * Ring, paged and fp8 layouts are not handled here (the wrapper raises).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // keys per tile
constexpr int kMaxRep = 8;  // query heads per kv group
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Rotate element i of a head row: x1 = x[i], x2 = x[i + half] for i < half.
__device__ __forceinline__ float rope_at(const float* row, int i, int half,
                                         const float* cos_row, const float* sin_row) {
  if (i < half) {
    const float x1 = row[i], x2 = row[i + half];
    return __fsub_rn(__fmul_rn(x1, cos_row[i]), __fmul_rn(x2, sin_row[i]));
  }
  const int j = i - half;
  const float x1 = row[j], x2 = row[i];
  return __fadd_rn(__fmul_rn(x2, cos_row[j]), __fmul_rn(x1, sin_row[j]));
}

// Halving-tree sum of the values x[i], i = lane + 32 * t, held TL per lane:
// first over t inside the lane, then across lanes with a butterfly. Lane 0's
// result is the halving tree over i (element i + n/2 added to element i).
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
struct DecodeArgs {
  const T* q;       // (B, H, D)
  const T* hot_k;   // (B, HC, G, D)
  const T* hot_v;
  const T* cold_k;  // (B, CC, G, D)
  const T* cold_v;
  const T* k_new;   // (B, G, D)
  const T* v_new;
  const int* lengths;  // (B,)
  const int* active;   // (B,)
  const float* cos;    // (B, D/2)
  const float* sin;
  T* out;    // (B, H, D)
  T* k_rot;  // (B, G, D)
  int G, rep, HC, CC;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs<T> a) {
  constexpr int TL = D >= 32 ? D / 32 : 1;  // head elements per lane
  constexpr int half = D / 2;
  __shared__ float q_s[kMaxRep][D];
  __shared__ float kr_s[D];
  __shared__ float raw_s[D];
  __shared__ float logit_s[kMaxRep][kTile];
  __shared__ float p_s[kMaxRep][kTile];

  const int g = blockIdx.x, b = blockIdx.y;
  const int G = a.G, rep = a.rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = threadIdx.x;
  const int length = a.lengths[b];
  const bool active = a.active[b] != 0;
  const float* cos_row = a.cos + (int64_t)b * half;
  const float* sin_row = a.sin + (int64_t)b * half;

  // ---- prologue: rotate the rep query heads and the pending k ----
  for (int r = 0; r < rep; ++r) {
    const T* qrow = a.q + ((int64_t)b * G * rep + g * rep + r) * D;
    if (d < D) raw_s[d] = to_f32(qrow[d]);
    __syncthreads();
    if (d < D) q_s[r][d] = rope_at(raw_s, d, half, cos_row, sin_row);
    __syncthreads();
  }
  {
    const T* krow = a.k_new + ((int64_t)b * G + g) * D;
    if (d < D) raw_s[d] = to_f32(krow[d]);
    __syncthreads();
    if (d < D) {
      const float v = rope_at(raw_s, d, half, cos_row, sin_row);
      kr_s[d] = v;
      store(a.k_rot + ((int64_t)b * G + g) * D + d, v);
    }
    __syncthreads();
  }

  // online-softmax state, replicated in every thread; acc is dimension d
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r] = 0.f;
  }

  // ---- stream the hot tier, then the cold tier, over valid rows only ----
  const int n_hot = min(length, a.HC);
  const int n_cold = min(max(length - a.HC, 0), a.CC);
  for (int tier = 0; tier < 2; ++tier) {
    const T* kt = tier == 0 ? a.hot_k : a.cold_k;
    const T* vt = tier == 0 ? a.hot_v : a.cold_v;
    const int cap = tier == 0 ? a.HC : a.CC;
    const int n_valid = tier == 0 ? n_hot : n_cold;
    for (int start = 0; start < n_valid; start += kTile) {
      const int n = min(kTile, n_valid - start);
      auto row = [&](const T* base, int j) {
        return base + (((int64_t)b * cap + start + j) * G + g) * D;
      };
      for (int j = warp; j < n; j += kWarps) {
        const T* krow = row(kt, j);
        float kx[TL];
#pragma unroll
        for (int t = 0; t < TL; ++t) {
          const int i = lane + 32 * t;
          kx[t] = i < D ? to_f32(krow[i]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r >= rep) break;
          float x[TL];
#pragma unroll
          for (int t = 0; t < TL; ++t) {
            const int i = lane + 32 * t;
            x[t] = i < D ? __fmul_rn(q_s[r][i], kx[t]) : 0.f;
          }
          const float s = warp_tree<TL>(x);
          if (lane == 0) logit_s[r][j] = __fmul_rn(s, a.scale);
        }
      }
      __syncthreads();
      float m_new[kMaxRep], alpha[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) break;
        float mt = kNegInf;
        for (int j = 0; j < n; ++j) mt = fmaxf(mt, logit_s[r][j]);
        m_new[r] = fmaxf(m[r], mt);
        alpha[r] = expf(m[r] - m_new[r]);
      }
      for (int e = threadIdx.x; e < rep * kTile; e += kThreads) {
        const int r = e / kTile, j = e % kTile;
        p_s[r][j] = j < n ? expf(logit_s[r][j] - m_new[r]) : 0.f;
      }
      __syncthreads();
      float vv[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) vv[j] = (d < D && j < n) ? to_f32(row(vt, j)[d]) : 0.f;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) break;
        float ps[kTile], pv[kTile];
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          ps[j] = p_s[r][j];
          pv[j] = __fmul_rn(ps[j], vv[j]);
        }
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), tree32(ps));
        acc[r] = __fadd_rn(__fmul_rn(acc[r], alpha[r]), tree32(pv));
        m[r] = m_new[r];
      }
      __syncthreads();
    }
  }

  // ---- the pending token joins as the last element for active slots ----
  if (active) {
    if (warp == 0) {
      for (int r = 0; r < rep; ++r) {
        float x[TL];
#pragma unroll
        for (int t = 0; t < TL; ++t) {
          const int i = lane + 32 * t;
          x[t] = i < D ? __fmul_rn(q_s[r][i], kr_s[i]) : 0.f;
        }
        const float s = warp_tree<TL>(x);
        if (lane == 0) logit_s[r][0] = __fmul_rn(s, a.scale);
      }
    }
    __syncthreads();
    const float vn = d < D ? to_f32(a.v_new[((int64_t)b * G + g) * D + d]) : 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      const float lg = logit_s[r][0];
      const float mn = fmaxf(m[r], lg);
      const float alpha = expf(m[r] - mn);
      const float p = expf(lg - mn);
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), p);
      acc[r] = __fadd_rn(__fmul_rn(acc[r], alpha), __fmul_rn(p, vn));
      m[r] = mn;
    }
  }

  if (d < D)
    for (int r = 0; r < rep; ++r)
      store(a.out + ((int64_t)b * G * rep + g * rep + r) * D + d, acc[r] / fmaxf(l[r], 1e-30f));
}

template <typename T>
cudaError_t launch(const DecodeArgs<T>& a, int B, int D, cudaStream_t stream) {
  const dim3 grid(a.G, B);
  switch (D) {
    case 16: decode_kernel<T, 16><<<grid, kThreads, 0, stream>>>(a); break;
    case 32: decode_kernel<T, 32><<<grid, kThreads, 0, stream>>>(a); break;
    case 64: decode_kernel<T, 64><<<grid, kThreads, 0, stream>>>(a); break;
    case 128: decode_kernel<T, 128><<<grid, kThreads, 0, stream>>>(a); break;
    case 256: decode_kernel<T, 256><<<grid, kThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_decode_gqa_fused(
    int is_bf16, const void* q, const void* hot_k, const void* hot_v, const void* cold_k,
    const void* cold_v, const void* k_new, const void* v_new, const void* lengths,
    const void* active, const void* cos, const void* sin, void* out, void* k_rot,
    int B, int G, int rep, int D, int HC, int CC, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    DecodeArgs<T> a{(const T*)q, (const T*)hot_k, (const T*)hot_v, (const T*)cold_k,
                    (const T*)cold_v, (const T*)k_new, (const T*)v_new, (const int*)lengths,
                    (const int*)active, (const float*)cos, (const float*)sin, (T*)out,
                    (T*)k_rot, G, rep, HC, CC, scale};
    return launch(a, B, D, s);
  }
  using T = float;
  DecodeArgs<T> a{(const T*)q, (const T*)hot_k, (const T*)hot_v, (const T*)cold_k,
                  (const T*)cold_v, (const T*)k_new, (const T*)v_new, (const int*)lengths,
                  (const int*)active, (const float*)cos, (const float*)sin, (T*)out,
                  (T*)k_rot, G, rep, HC, CC, scale};
  return launch(a, B, D, s);
}
