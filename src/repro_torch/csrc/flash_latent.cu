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
// DV = 512) one decode step of 6 slots at length 80 moves 4.4 MB (q, the
// valid rows, the output: 1.3 us at 3.35 TB/s) and does 134 MFLOP (2.0 us
// at 67 TFLOP/s). The fixed sum order below keeps every product and sum a
// separate CUDA-core instruction (no FMA, no tensor cores), which halves
// that rate. Beyond those, each block's chain of row loads and phases per
// tile, and the rows' reads from L2 (every head group of a slot reads the
// slot's rows: 64 x 184 KB per slot at length 80) set the time.
//
// Design:
//  * The TPU grid (b, s_blocks) carries the softmax state of all heads of
//    a slot across its sequential S axis. Here one block owns kHeads heads
//    of one slot, grid (H / kHeads, B): small head groups put several
//    blocks on every SM in one wave. The slot's valid rows form 32-key
//    tiles (the hot tier's, then the cold tier's); no row at or past a
//    slot's length is read, so a masked row may hold anything, and a
//    length-0 slot writes zeros.
//  * Per tile, logits first, then the fold: (1) every logit of the tile
//    for the block's heads, a warp per key, the row read straight into
//    registers (lane L holds dims L + 32 t, q of every head held the same
//    way); (2) one warp per head: the tile's max by an fmaxf butterfly,
//    m_new, alpha = exp(m - m_new), p_j = exp(logit_j - m_new) and l, each
//    once; p and alpha go to shared memory; (3) P.V: each thread owns
//    value dims, loads v_j[dv] for the tile's 32 keys once for all heads,
//    and folds acc = acc * alpha + tile_dot(p, v) in registers. Shared
//    memory is under 300 bytes (static, so no attribute to set), and
//    registers set the blocks per SM.
//  * Reproducible arithmetic: every product and sum is rounded on its own
//    (__fmul_rn, __fadd_rn) in the plain PyTorch version's order
//    (kernels/flash_decode.py::flash_decode_latent_plain), which repeats
//    the kernel bit for bit: at 128 heads x 512 dims a one-ulp drift would
//    otherwise flip greedy tokens downstream. The plain version sums a dot
//    product as a halving tree over the width zero-padded to a power of
//    two (576 -> 1024): its first level adds element t + 16 of lane L's
//    run to element t, then halves within the lane, then across lanes (the
//    xor butterfly). With D = 576 each lane holds 18 real elements, so the
//    first level has 2 real steps and 14 that add +0.0; the kernel leaves
//    those out. x + (+0.0) equals x except that -0.0 becomes +0.0, and a
//    sum that differs only in a zero's sign stays so up the tree, so a
//    logit can differ from the plain one only as -0.0 against +0.0. A
//    logit enters the output only through fmaxf and exp(logit - m_new),
//    neither of which a zero's sign changes, so the outputs are the same.
//    At D = 24 each lane holds one element and lanes 24-31 add +0.0 in the
//    butterfly, as in the plain version. The sums over a tile's 32 keys
//    are halving trees unrolled level by level (halve, tile_dot), so no
//    array goes to local memory.
//  * fp8 (e4m3) latent tiers (the reference's kv_fp8 cache, whose latent
//    rows the caller fake-quantizes and rounds back to fp8): the tier type T
//    is then __nv_fp8_e4m3 (fp8.cuh, entry point flash_decode_latent_fp8),
//    each element upcast to f32 as it is loaded (exact), so the tiles and
//    sums are the f32 form's; q and the output stay f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp8.cuh"

namespace {

// Measured at DeepSeek-V3's width on the H100 (heads per block 1 / 2 / 4 /
// 8, 128 / 256 / 512 threads, logits of 1 / 2 / 4 tiles before each
// fold): 2 heads, 128 threads, 3 blocks per SM (168 registers, no spill)
// and one tile at a time were fastest. The grid of 64 x 6 blocks then
// runs in one wave.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // keys per tile
constexpr int kHeads = 2;      // heads per block
constexpr int kMinBlocks = 3;  // blocks per SM that the register budget allows
static_assert(kHeads <= kWarps, "the fold takes one warp per head");
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// x[j] += x[j + H] for j < H, then H / 2, ..., 1: a halving tree with each
// level a loop of constant bound, so every index is a compile-time
// constant and x stays in registers.
template <int H, int N>
__device__ __forceinline__ void halve(float (&x)[N]) {
  if constexpr (H > 0) {
#pragma unroll
    for (int j = 0; j < H; ++j) x[j] = __fadd_rn(x[j], x[j + H]);
    halve<H / 2>(x);
  }
}

// The halving tree over a tile's 32 products p[j] * v[j] (p in shared
// memory, 16-byte aligned), its first level x[j] + x[j + 16] taken as the
// products are formed.
__device__ __forceinline__ float tile_dot(const float* p, const float (&v)[kTile]) {
  constexpr int H = kTile / 2;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  float x[H];
#pragma unroll
  for (int j4 = 0; j4 < H / 4; ++j4) {
    const float4 lo = p4[j4], hi = p4[j4 + H / 4];
    const int j = 4 * j4;
    x[j] = __fadd_rn(__fmul_rn(lo.x, v[j]), __fmul_rn(hi.x, v[j + H]));
    x[j + 1] = __fadd_rn(__fmul_rn(lo.y, v[j + 1]), __fmul_rn(hi.y, v[j + 1 + H]));
    x[j + 2] = __fadd_rn(__fmul_rn(lo.z, v[j + 2]), __fmul_rn(hi.z, v[j + 2 + H]));
    x[j + 3] = __fadd_rn(__fmul_rn(lo.w, v[j + 3]), __fmul_rn(hi.w, v[j + 3 + H]));
  }
  halve<H / 2>(x);
  return x[0];
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

__device__ __forceinline__ float warp_max(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = fmaxf(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// The dot product whose products x[t] (dim lane + 32 t) the lanes hold, in
// the order of the halving tree over the width zero-padded to
// 32 * pow2_at_least(TL), without its +0.0 steps: the first in-lane level
// adds only the real x[t + H], then the lane halves x[0..H), then the
// butterfly sums across lanes. Every lane returns the sum.
template <int TL>
__device__ __forceinline__ float dot_sum(float (&x)[TL]) {
  if constexpr (TL > 1) {
    constexpr int H = pow2_at_least(TL) / 2;
#pragma unroll
    for (int t = 0; t + H < TL; ++t) x[t] = __fadd_rn(x[t], x[t + H]);
    halve<H / 2>(x);
  }
  return warp_sum(x[0]);
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
__global__ void __launch_bounds__(kThreads, kMinBlocks) latent_kernel(LatentArgs<T> a) {
  constexpr int TL = (D + 31) / 32;  // key dims per lane
  constexpr int DPT = (DV + kThreads - 1) / kThreads;  // value dims per thread
  __shared__ __align__(16) float p_s[kHeads][kTile];  // the tile's logits, then its p
  __shared__ float alpha_s[kHeads];
  __shared__ float l_s[kHeads];

  const int h0 = blockIdx.x * kHeads, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int length = a.lengths[b];
  const int n_hot = min(length, a.HC);
  const int n_cold = min(max(length - a.HC, 0), a.CC);
  const int t_hot = (n_hot + kTile - 1) / kTile;
  const int n_tiles = t_hot + (n_cold + kTile - 1) / kTile;

  float m = kNegInf, l = 0.f;  // softmax state of head `warp` (warps < kHeads)
  float acc[kHeads][DPT];
#pragma unroll
  for (int r = 0; r < kHeads; ++r)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;

  for (int k = 0; k < n_tiles; ++k) {
    const bool hot = k < t_hot;
    const int start = (hot ? k : k - t_hot) * kTile;
    const int n = min(kTile, (hot ? n_hot : n_cold) - start);  // valid keys of the tile
    const T* rows = hot ? a.hot + ((int64_t)b * a.HC + start) * D
                        : a.cold + ((int64_t)b * a.CC + start) * D;
    // (1) logits: a warp per key, for every head of the block; q is loaded
    // here so that its registers are free during P.V
    float q[kHeads][TL];
#pragma unroll
    for (int r = 0; r < kHeads; ++r)
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        const int i = lane + 32 * t;
        q[r][t] = h0 + r < a.H && i < D ? a.q[((int64_t)b * a.H + h0 + r) * D + i] : 0.f;
      }
#pragma unroll 2
    for (int j = warp; j < n; j += kWarps) {
      const T* row = rows + (int64_t)j * D;
      float kx[TL];
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        const int i = lane + 32 * t;
        kx[t] = i < D ? to_f32(row[i]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        float x[TL];
#pragma unroll
        for (int t = 0; t < TL; ++t) x[t] = __fmul_rn(q[r][t], kx[t]);
        const float s = dot_sum<TL>(x);
        if (lane == 0) p_s[r][j] = __fmul_rn(s, a.scale);
      }
    }
    __syncthreads();
    // (2) the fold's softmax terms: a warp per head, lane j on key j
    if (warp < kHeads) {
      const float x = lane < n ? p_s[warp][lane] : kNegInf;
      const float m_new = fmaxf(m, warp_max(x));
      const float alpha = expf(m - m_new);
      const float p = lane < n ? expf(x - m_new) : 0.f;
      p_s[warp][lane] = p;
      if (lane == 0) alpha_s[warp] = alpha;
      l = __fadd_rn(__fmul_rn(l, alpha), warp_sum(p));
      m = m_new;
    }
    __syncthreads();
    // (3) P.V: each thread's value dims, all heads, the tile's 32 keys
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int dv = threadIdx.x + kThreads * c;
      if (DV % kThreads != 0 && dv >= DV) break;
      float v[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) v[j] = j < n ? to_f32(rows[(int64_t)j * D + dv]) : 0.f;
#pragma unroll
      for (int r = 0; r < kHeads; ++r)
        acc[r][c] = __fadd_rn(__fmul_rn(acc[r][c], alpha_s[r]), tile_dot(p_s[r], v));
    }
    if (k + 1 < n_tiles) __syncthreads();  // the next tile rewrites p_s and alpha_s
  }
  if (warp < kHeads && lane == 0) l_s[warp] = l;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kHeads; ++r) {
    if (h0 + r >= a.H) break;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int dv = threadIdx.x + kThreads * c;
      if (dv < DV) a.out[((int64_t)b * a.H + h0 + r) * DV + dv] = acc[r][c] / den;
    }
  }
}

template <typename T, int D, int DV>
cudaError_t launch(const LatentArgs<T>& a, int B, cudaStream_t stream) {
  const dim3 grid((a.H + kHeads - 1) / kHeads, B);
  latent_kernel<T, D, DV><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// (D, DV): DeepSeek-V3 (512 + 64, 512) and its smoke config (16 + 8, 16).
template <typename T>
int run(const void* q, const void* hot, const void* cold, const void* lengths, void* out, int B,
        int H, int HC, int CC, int D, int DV, float scale, void* stream) {
  LatentArgs<T> a{(const float*)q, (const T*)hot, (const T*)cold, (const int*)lengths,
                  (float*)out, H, HC, CC, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 576 && DV == 512) return launch<T, 576, 512>(a, B, s);
  if (D == 24 && DV == 16) return launch<T, 24, 16>(a, B, s);
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

// The same over fp8 (e4m3) latent tiers.
extern "C" int flash_decode_latent_fp8(const void* q, const void* hot, const void* cold,
                                       const void* lengths, void* out, int B, int H, int HC,
                                       int CC, int D, int DV, float scale, void* stream) {
  return run<__nv_fp8_e4m3>(q, hot, cold, lengths, out, B, H, HC, CC, D, DV, scale, stream);
}
