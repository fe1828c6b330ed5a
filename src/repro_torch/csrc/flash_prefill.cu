// Causal GQA flash prefill of a fresh prompt, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::_flash_prefill
// (body _kernel_prefill) in its fresh form flash_prefill_attention(cache=None,
// emit_kv=True): causal attention over the prompt with RoPE applied in the
// prologue at positions 0..s-1, key blocks above the diagonal skipped, and
// the rotated k and the v emitted in the tier dtype with rows at or past
// the slot's valid count zeroed.
//
// The MLA form (entry point flash_prefill_mla; reference call
// flash_prefill_attention(rope_dims=qk_rope_head_dim, emit_kv=False) in
// models/attention.py::mla_prefill) is the same kernel with g = h (rep 1),
// keys of DK = nope + rope dims of which only the trailing rope_dims
// rotate, values of another width DV, and nothing emitted: the cached row
// is the latent, built outside.
//
// What bounds it on this card: at serving prompt lengths (32..128 tokens)
// the q/k/v/o bytes and the launch itself; the operation count grows as
// s^2 and would bound it for long prompts.
//
// Design:
//  * The TPU grid carries the softmax state across its innermost kv axis.
//    Here one block owns one (q block, kv group, slot) and loops over the
//    32-key tiles of the prompt up to the diagonal of its last row (and
//    the valid count), so the state lives in the block itself.
//  * A q block is 32 rows: 32 / rep tokens x rep query heads of the group
//    (token-major rows, the reference's layout), so each key tile read
//    serves every grouped head. Rows, key tile and value tile live in
//    shared memory as f32 (about 100 KiB at head dim 256); thread t owns output
//    dimension t of all 32 rows, which keeps the accumulator in registers.
//    Key widths that are not a power of two (MLA's 192) are zero-padded to
//    one inside the dot product's halving tree, as the plain version pads.
//  * Reproducible arithmetic, as in flash_decode.cu: the dot products over
//    the head dimension and the sums over a tile's 32 keys are halving
//    trees, and every product and sum is rounded on its own (__fmul_rn,
//    __fadd_rn), so the plain PyTorch version (kernels/flash_prefill.py)
//    repeats the kernel bit for bit; a one-ulp drift in the prompt's
//    attention would otherwise change greedy tokens downstream. RoPE uses
//    cos and sin tables from the wrapper, computed with the plain
//    version's own expression.
//  * Each block emits the rotated k and the v of its own q-block tokens.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // q rows per block (tokens x grouped heads)
constexpr int kTile = 32;  // keys per tile
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Element i of a raw head row x (global memory, type T) of width D after
// rotating its trailing rd dims (rd = D: the whole head); cos_row and
// sin_row hold rd / 2 values.
template <typename T>
__device__ __forceinline__ float rope_at(const T* x, int i, int D, int rd, const float* cos_row,
                                         const float* sin_row) {
  const int off = D - rd, half = rd / 2;
  if (i < off) return to_f32(x[i]);
  const int j = i - off;
  if (j < half) {
    const float x1 = to_f32(x[off + j]), x2 = to_f32(x[off + j + half]);
    return __fsub_rn(__fmul_rn(x1, cos_row[j]), __fmul_rn(x2, sin_row[j]));
  }
  const int jj = j - half;
  const float x1 = to_f32(x[off + jj]), x2 = to_f32(x[i]);
  return __fadd_rn(__fmul_rn(x2, cos_row[jj]), __fmul_rn(x1, sin_row[jj]));
}

// Smallest power of two >= n (n >= 1).
__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// Halving-tree sum of the values x[i], i = lane + 32 * t, held TL per lane
// (see flash_decode.cu).
template <int TL>
__device__ __forceinline__ float warp_tree(float (&x)[TL]) {
#pragma unroll
  for (int h = TL / 2; h > 0; h /= 2)
#pragma unroll
    for (int t = 0; t < h; ++t) x[t] = __fadd_rn(x[t], x[t + h]);
  float s = x[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
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
struct PrefillArgs {
  const T* q;  // (B, S, H, D)
  const T* k;  // (B, S, G, D)
  const T* v;  // (B, S, G, DV)
  const int* valid;  // (B,)
  const float* cos;  // (S, rope_dims/2)
  const float* sin;
  T* out;     // (B, S, H, DV)
  T* k_cast;  // (B, S, G, D), or null: nothing emitted
  T* v_cast;  // (B, S, G, DV)
  int S, G, rep, rope_dims;
  float scale;
};

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads) prefill_kernel(PrefillArgs<T> a) {
  constexpr int TL = pow2_at_least((D + 31) / 32);  // head elements per lane, padded
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [kRows][D]
  float* k_s = q_s + kRows * D;      // [kTile][D]
  float* v_s = k_s + kTile * D;      // [kTile][DV]
  float* p_s = v_s + kTile * DV;     // [kRows][kTile]
  float* m_s = p_s + kRows * kTile;  // [kRows]
  float* l_s = m_s + kRows;          // [kRows]
  float* alpha_s = l_s + kRows;      // [kRows]

  const int S = a.S, G = a.G, rep = a.rep, rd = a.rope_dims, half = rd / 2;
  const int bq = kRows / rep;  // tokens per q block
  const int qb = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d = threadIdx.x;
  const int tok0 = qb * bq;
  const int nv = min(a.valid[b], S);
  const int H = G * rep;
  auto q_off = [&](int tok, int rr) { return (((int64_t)b * S + tok) * H + g * rep + rr) * D; };
  auto o_off = [&](int tok, int rr) { return (((int64_t)b * S + tok) * H + g * rep + rr) * DV; };
  auto kv_off = [&](int tok) { return (((int64_t)b * S + tok) * G + g) * D; };
  auto v_off = [&](int tok) { return (((int64_t)b * S + tok) * G + g) * DV; };
  auto kv_row = [&](const T* base, int tok) { return base + kv_off(tok); };
  auto cos_of = [&](int tok) { return a.cos + (int64_t)tok * half; };
  auto sin_of = [&](int tok) { return a.sin + (int64_t)tok * half; };

  // ---- prologue: rotate this block's q rows; emit its tokens' k and v ----
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D, i = e % D;
    const int tok = tok0 + r / rep;
    q_s[e] = tok < S ? rope_at(a.q + q_off(tok, r % rep), i, D, rd, cos_of(tok), sin_of(tok)) : 0.f;
  }
  if (a.k_cast != nullptr) {
    for (int e = threadIdx.x; e < bq * D; e += kThreads) {
      const int tok = tok0 + e / D, i = e % D;
      if (tok >= S) continue;
      const bool keep = tok < nv;
      const float kr = rope_at(kv_row(a.k, tok), i, D, rd, cos_of(tok), sin_of(tok));
      store(a.k_cast + kv_off(tok) + i, keep ? kr : 0.f);
    }
    for (int e = threadIdx.x; e < bq * DV; e += kThreads) {
      const int tok = tok0 + e / DV, i = e % DV;
      if (tok >= S) continue;
      store(a.v_cast + v_off(tok) + i, tok < nv ? to_f32(a.v[v_off(tok) + i]) : 0.f);
    }
  }
  if (threadIdx.x < kRows) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  __syncthreads();

  // ---- stream key tiles up to the block's diagonal and the valid count ----
  const int q_hi = min(tok0 + bq, S) - 1;  // last token of this q block
  const int kv_end = min(q_hi + 1, nv);
  for (int start = 0; start < kv_end; start += kTile) {
    const int n_load = min(kTile, nv - start);  // keys of the tile that exist
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int j = e / D, i = e % D;
      const int tok = start + j;
      k_s[e] = j < n_load ? rope_at(kv_row(a.k, tok), i, D, rd, cos_of(tok), sin_of(tok)) : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * DV; e += kThreads) {
      const int j = e / DV, i = e % DV;
      v_s[e] = j < n_load ? to_f32(a.v[v_off(start + j) + i]) : 0.f;
    }
    __syncthreads();
    // logits: a warp takes one key and all 32 rows
    for (int j = warp; j < kTile; j += kWarps) {
      float kx[TL];
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        const int i = lane + 32 * t;
        kx[t] = i < D ? k_s[j * D + i] : 0.f;
      }
      for (int r = 0; r < kRows; ++r) {
        float x[TL];
#pragma unroll
        for (int t = 0; t < TL; ++t) {
          const int i = lane + 32 * t;
          x[t] = i < D ? __fmul_rn(q_s[r * D + i], kx[t]) : 0.f;
        }
        const float s = warp_tree<TL>(x);
        if (lane == 0) p_s[r * kTile + j] = __fmul_rn(s, a.scale);
      }
    }
    __syncthreads();
    if (threadIdx.x < kRows) {  // one thread per row: max, weights, sum
      const int r = threadIdx.x;
      const int q_tok = tok0 + r / rep;
      float mt = kNegInf;
      for (int j = 0; j < kTile; ++j) {
        const int k_tok = start + j;
        if (k_tok < nv && k_tok <= q_tok && q_tok < S) mt = fmaxf(mt, p_s[r * kTile + j]);
      }
      const float m_new = fmaxf(m_s[r], mt);
      const float alpha = expf(m_s[r] - m_new);
      float ps[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int k_tok = start + j;
        const bool ok = k_tok < nv && k_tok <= q_tok && q_tok < S;
        ps[j] = ok ? expf(p_s[r * kTile + j] - m_new) : 0.f;
        p_s[r * kTile + j] = ps[j];
      }
      l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), tree32(ps));
      m_s[r] = m_new;
      alpha_s[r] = alpha;
    }
    __syncthreads();
    if (d < DV) {
      float vv[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) vv[j] = v_s[j * DV + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float pv[kTile];
#pragma unroll
        for (int j = 0; j < kTile; ++j) pv[j] = __fmul_rn(p_s[r * kTile + j], vv[j]);
        acc[r] = __fadd_rn(__fmul_rn(acc[r], alpha_s[r]), tree32(pv));
      }
    }
    __syncthreads();
  }

  // ---- epilogue ----
  if (d < DV) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int tok = tok0 + r / rep;
      if (r < bq * rep && tok < S)
        store(a.out + o_off(tok, r % rep) + d, acc[r] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, int D, int DV>
cudaError_t launch_d(const PrefillArgs<T>& a, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kRows + kTile) * D + (size_t)kTile * DV + kRows * kTile + 3 * kRows);
  cudaError_t err = cudaFuncSetAttribute(prefill_kernel<T, D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int bq = kRows / a.rep;
  const dim3 grid((a.S + bq - 1) / bq, a.G, B);
  prefill_kernel<T, D, DV><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// (D, DV) pairs: GQA heads (DV = D), DeepSeek-V3's MLA (192, 128) and its
// smoke config's (24, 16).
template <typename T>
cudaError_t launch(const PrefillArgs<T>& a, int B, int D, int DV, cudaStream_t stream) {
  if (D == DV) {
    switch (D) {
      case 16: return launch_d<T, 16, 16>(a, B, stream);
      case 32: return launch_d<T, 32, 32>(a, B, stream);
      case 64: return launch_d<T, 64, 64>(a, B, stream);
      case 128: return launch_d<T, 128, 128>(a, B, stream);
      case 256: return launch_d<T, 256, 256>(a, B, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (D == 192 && DV == 128) return launch_d<T, 192, 128>(a, B, stream);
  if (D == 24 && DV == 16) return launch_d<T, 24, 16>(a, B, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* valid, const void* cos,
        const void* sin, void* out, void* k_cast, void* v_cast, int B, int S, int G, int rep,
        int D, int DV, int rope_dims, float scale, void* stream) {
  PrefillArgs<T> a{(const T*)q, (const T*)k, (const T*)v, (const int*)valid,
                   (const float*)cos, (const float*)sin, (T*)out, (T*)k_cast, (T*)v_cast,
                   S, G, rep, rope_dims, scale};
  return launch(a, B, D, DV, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Both return cudaGetLastError() after the launch (0 on success).
extern "C" int flash_prefill_fresh(int is_bf16, const void* q, const void* k, const void* v,
                                   const void* valid, const void* cos, const void* sin,
                                   void* out, void* k_cast, void* v_cast, int B, int S, int G,
                                   int rep, int D, float scale, void* stream) {
  return is_bf16 ? run<__nv_bfloat16>(q, k, v, valid, cos, sin, out, k_cast, v_cast, B, S, G, rep,
                                      D, D, D, scale, stream)
                 : run<float>(q, k, v, valid, cos, sin, out, k_cast, v_cast, B, S, G, rep, D, D,
                              D, scale, stream);
}

// MLA form: q, k (B, S, H, D), v (B, S, H, DV), g = h; the trailing
// rope_dims of every q and k row rotate; nothing is emitted.
extern "C" int flash_prefill_mla(int is_bf16, const void* q, const void* k, const void* v,
                                 const void* valid, const void* cos, const void* sin, void* out,
                                 int B, int S, int H, int D, int DV, int rope_dims, float scale,
                                 void* stream) {
  return is_bf16 ? run<__nv_bfloat16>(q, k, v, valid, cos, sin, out, nullptr, nullptr, B, S, H,
                                      1, D, DV, rope_dims, scale, stream)
                 : run<float>(q, k, v, valid, cos, sin, out, nullptr, nullptr, B, S, H, 1, D, DV,
                              rope_dims, scale, stream);
}
