// Causal GQA flash prefill of a fresh prompt, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::_flash_prefill
// (body _kernel_prefill) in its fresh form flash_prefill_attention(cache=None,
// emit_kv=True): causal attention over the prompt with RoPE applied in the
// prologue at positions 0..s-1, key blocks above the diagonal skipped, and
// the rotated k and the v emitted in the tier dtype with rows at or past
// the slot's valid count zeroed.
//
// What bounds it on this card: at serving prompt lengths (32..128 tokens)
// the latency of short blocks, not bytes (falcon3-1b's s = 32 moves 6.3 MB:
// 1.9 us at 3.35 TB/s); the operation count grows as s^2 and bounds long
// prompts. No tensor cores: mma / wgmma neither round each product on its
// own nor sum in the fixed order below.
//
// Reproducible arithmetic, shared with flash_decode.cu: the dot products
// over the head dimension and the sums over a tile's 32 keys are halving
// trees (element i + n/2 added to element i, level by level), and every
// product and sum is rounded on its own (__fmul_rn, __fadd_rn; never a
// plain a * b + c, which nvcc contracts into an FMA), so the plain PyTorch
// version (kernels/flash_prefill.py) repeats the kernel bit for bit; a
// one-ulp drift in the prompt's attention would otherwise change greedy
// tokens downstream. RoPE uses cos and sin tables from the wrapper,
// computed with the plain version's own expression.
//
// GQA form (entry point flash_prefill_fresh, gqa_prefill_kernel):
//  * Rows are the group's (token, grouped head) pairs, token-major; a block
//    of 8 warps owns kGqaRows = 16 consecutive rows of one (kv group, slot):
//    16 / rep tokens, or part of one token's heads when rep > 16 (any rep up
//    to 32, powers of two or not). The grid is one-dimensional with the q
//    block slowest and reversed, so the blocks with the most key tiles
//    start first. Shared memory (82.6 KiB at d 256, f32) allows 2 blocks per SM.
//  * One block loops over the 32-key tiles up to the diagonal of its last
//    row (and the valid count), so the online-softmax state lives in the
//    block. A tile's raw k and v rows arrive by cp.async, every copy in
//    flight at once (tile 0's while the q rows rotate); the keys are then
//    rotated once into f32 rows padded to D + 4 words, so that a warp's
//    16-byte loads of 32 different keys hit distinct banks. Each staged
//    tile serves every grouped head of the block's 16 rows.
//  * Logits: lane j of a warp owns key j, the warp owns 2 rows. A lane
//    computes each whole dot product itself, with no shuffles: the halving
//    tree over d equals ((T0 + T2) + (T1 + T3)), Tp the tree over the dims
//    i = p (mod 4), and each Tp equals the pairwise sum of its elements in
//    bit-reversed order, kept on binary-counter stacks in registers.
//  * Softmax: the same warp holds its rows' 32 logits, one per lane: the
//    max is an fmaxf butterfly (order-free), the tile sum an xor butterfly,
//    which pairs lane j with j ^ 16, then j ^ 8, ...: the halving tree over
//    the tile (tree32), since each add is commutative. m and l stay in
//    registers across tiles; p and alpha go to shared memory, one row per
//    32 consecutive words.
//  * P.V: thread t owns output dim t (+ 256) of the rows, holds that column
//    of the value tile in registers and sums the tile with the halving tree
//    unrolled level by level (tile_sum), so no array leaves the registers;
//    the accumulator stays in registers across tiles.
//  * Each block emits the rotated k and the v of the tokens whose first
//    grouped head is among its rows, copied from the staged tile; rows past
//    the valid count are zeroed.
//  * Measured on an H100 (PERF.md): 8-row blocks of 4 warps spilled at
//    d 256 (two output dims a thread), and tree32's nested loop kept the
//    32-value P.V arrays in local memory; P.V then dominated each block.
//
// MLA form (entry point flash_prefill_mla, prefill_kernel): the first
// kernel of this file, unchanged. g = h (rep 1), keys of DK = nope + rope
// dims of which only the trailing rope_dims rotate, values of another
// width DV, and nothing emitted: the cached row is the latent, built
// outside (reference call flash_prefill_attention(rope_dims=
// qk_rope_head_dim, emit_kv=False) in models/attention.py::mla_prefill).
//  * One block owns one (32-row q block, head, slot) and loops over the
//    32-key tiles; rows, key tile and value tile live in shared memory as
//    f32; thread t owns output dimension t of all 32 rows. Key widths that
//    are not a power of two (192) are zero-padded to one inside the dot
//    product's halving tree, as the plain version pads.

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

// ---------------------------------------------------------------------------
// GQA form
// ---------------------------------------------------------------------------

constexpr int kGqaRows = 16;     // q rows per block (tokens x grouped heads, token-major)
constexpr int kRowsPerWarp = 2;  // rows whose logits and softmax one warp computes
constexpr int kGqaThreads = 32 * kGqaRows / kRowsPerWarp;
constexpr int kKeyPad = 4;  // words of padding per staged key row: no bank conflicts
constexpr int kMinBlocks = 2;  // resident blocks per SM the register budget allows

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }
__host__ __device__ constexpr int bit_reverse(int x, int bits) {
  return bits == 0 ? 0 : ((x & 1) << (bits - 1)) | bit_reverse(x >> 1, bits - 1);
}
__host__ __device__ constexpr int trailing_ones(int x) { return (x & 1) ? 1 + trailing_ones(x >> 1) : 0; }

struct F4 {
  float v[4];
};
__device__ __forceinline__ F4 load4(const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  return {{x.x, x.y, x.z, x.w}};
}
__device__ __forceinline__ F4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return {{__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi)}};
}
__device__ __forceinline__ void store4(float* p, const F4& x) {
  *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const F4& x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.v[0], x.v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.v[2], x.v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// tree32's halving tree with each level a loop of constant bound, so every
// index is a compile-time constant and x stays in registers (tree32's
// nested loop leaves x in local memory).
template <int H>
__device__ __forceinline__ void halve(float (&x)[kTile]) {
  if constexpr (H > 0) {
#pragma unroll
    for (int j = 0; j < H; ++j) x[j] = __fadd_rn(x[j], x[j + H]);
    halve<H / 2>(x);
  }
}
__device__ __forceinline__ float tile_sum(float (&x)[kTile]) {
  halve<kTile / 2>(x);
  return x[0];
}

// 16-byte asynchronous copy global -> shared (bypassing L1), and the wait
// for all of this thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Dims [i, i + 4) of a head row x of width D (i < D / 2) and their RoPE
// partners [i + D / 2, ...), rotated with the position's tables cs / sn
// (D / 2 values each), in rope_at's expression.
template <typename T, int D>
__device__ __forceinline__ void rope_quad(const T* x, int i, const float* cs, const float* sn,
                                          F4& lo, F4& hi) {
  const F4 x1 = load4(x + i), x2 = load4(x + i + D / 2), c = load4(cs + i), s = load4(sn + i);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lo.v[e] = __fsub_rn(__fmul_rn(x1.v[e], c.v[e]), __fmul_rn(x2.v[e], s.v[e]));
    hi.v[e] = __fadd_rn(__fmul_rn(x2.v[e], c.v[e]), __fmul_rn(x1.v[e], s.v[e]));
  }
}

// Dot products of R query rows q (stride D) with one key k, in the
// halving-tree order over d. That tree equals ((T0 + T2) + (T1 + T3)), Tp
// the halving tree over the dims i = p (mod 4), and each Tp equals the
// pairwise sum of its N = D / 4 elements taken in bit-reversed order. Step
// c of that order reads the dims 4m .. 4m + 3, m = bit_reverse(c), one per
// residue. The steps run in groups of NI: a group is a complete subtree,
// unrolled at compile time on register stacks (level l holds a pairwise
// sum of 2^l products); the groups run in a loop, their sums pushed on a
// second stack, which keeps the code and the live registers small.
template <int D>
struct DotShape {
  static constexpr int N = D / 4;               // steps
  static constexpr int NI = N < 16 ? N : 16;    // steps per group
  static constexpr int NG = N / NI;             // groups
  static constexpr int LBI = ilog2(NI), LBO = ilog2(NG);
};

// Step C of a group whose first dims q and k already point at (offset
// 4 * bit_reverse(group)): step c = group * NI + C reads the dims at
// 4 * (NG * bit_reverse(C) + bit_reverse(group)).
template <int D, int R, int C>
__device__ __forceinline__ void dot_group(const float* q, const float* k,
                                          float (&st)[R][4][DotShape<D>::LBI + 1]) {
  using Sh = DotShape<D>;
  if constexpr (C < Sh::NI) {
    constexpr int off = 4 * Sh::NG * bit_reverse(C, Sh::LBI), t = trailing_ones(C);
    const float4 kk = *reinterpret_cast<const float4*>(k + off);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 qq = *reinterpret_cast<const float4*>(q + r * D + off);
      float x[4] = {__fmul_rn(qq.x, kk.x), __fmul_rn(qq.y, kk.y), __fmul_rn(qq.z, kk.z),
                    __fmul_rn(qq.w, kk.w)};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int l = 0; l < t; ++l) x[p] = __fadd_rn(st[r][p][l], x[p]);
        st[r][p][t] = x[p];
      }
    }
    dot_group<D, R, C + 1>(q, k, st);
  }
}

template <int D, int R>
__device__ __forceinline__ void dot_rows(const float* q, const float* k, float (&out)[R]) {
  using Sh = DotShape<D>;
  float ost[R][4][Sh::LBO + 1];
#pragma unroll 1
  for (int grp = 0; grp < Sh::NG; ++grp) {
    const int base = Sh::LBO ? 4 * (int)(__brev((unsigned)grp) >> (32 - Sh::LBO)) : 0;
    float st[R][4][Sh::LBI + 1];
    dot_group<D, R, 0>(q + base, k + base, st);
    const int t = __ffs(~grp) - 1;  // trailing ones of grp: the push's adds
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float x = st[r][p][Sh::LBI];
#pragma unroll
        for (int l = 0; l < Sh::LBO; ++l)
          if (l < t) x = __fadd_rn(ost[r][p][l], x);
#pragma unroll
        for (int l = 0; l <= Sh::LBO; ++l)
          if (l == t) ost[r][p][l] = x;
      }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    out[r] = __fadd_rn(__fadd_rn(ost[r][0][Sh::LBO], ost[r][2][Sh::LBO]),
                       __fadd_rn(ost[r][1][Sh::LBO], ost[r][3][Sh::LBO]));
}

template <typename T, int D>
__global__ void __launch_bounds__(kGqaThreads, kMinBlocks)
    gqa_prefill_kernel(PrefillArgs<T> a, int n_qb) {
  constexpr int KS = D + kKeyPad;  // staged key row stride (words)
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  constexpr int KRS = kF32 ? KS : D;  // raw key row stride (elements of T)
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int RC = D / CH;          // copies per head row
  constexpr int QD = D / 8;  // 4-dim quads in half a head row
  constexpr int VD = D / 4;  // 4-dim quads in a head row
  // P.V: thread t owns output dims t % DVT (+ DVT, ...) of RPT rows
  constexpr int DVT = D < kGqaThreads ? D : kGqaThreads;
  constexpr int U = D / DVT;
  constexpr int RG = kGqaThreads / DVT;  // row groups; those past kGqaRows idle
  constexpr int RPT = kGqaRows >= RG ? kGqaRows / RG : 1;
  static_assert((kGqaRows < RG || RPT * RG == kGqaRows) && U * DVT == D, "head width unsupported");
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                        // [kGqaRows][D], rotated
  float* k_s = q_s + kGqaRows * D;          // [kTile][KS], rotated
  T* v_s = reinterpret_cast<T*>(k_s + kTile * KS);  // [kTile][D], as loaded
  T* kr_s = v_s + kTile * D;  // [kTile][KRS] raw keys: k_s itself for f32
  if constexpr (kF32) kr_s = reinterpret_cast<T*>(k_s);
  float* p_s = reinterpret_cast<float*>(v_s + kTile * D + (kF32 ? 0 : kTile * D));  // [kGqaRows][kTile]
  float* alpha_s = p_s + kGqaRows * kTile;  // [kGqaRows]
  float* l_s = alpha_s + kGqaRows;          // [kGqaRows]

  const int S = a.S, G = a.G, rep = a.rep, H = G * rep;
  const int n_gb = gridDim.x / n_qb;  // (group, slot) pairs
  const int qb = n_qb - 1 - (int)(blockIdx.x / n_gb);  // longest q blocks first
  const int g = blockIdx.x % n_gb % G, b = blockIdx.x % n_gb / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = qb * kGqaRows;  // first row: token row0 / rep, head row0 % rep
  const int nv = min(a.valid[b], S);
  auto q_off = [&](int tok, int rr) { return (((int64_t)b * S + tok) * H + g * rep + rr) * D; };
  auto kv_off = [&](int tok) { return (((int64_t)b * S + tok) * G + g) * D; };
  auto cos_of = [&](int tok) { return a.cos + (int64_t)tok * (D / 2); };
  auto sin_of = [&](int tok) { return a.sin + (int64_t)tok * (D / 2); };

  const int q_hi = (min(row0 + kGqaRows, S * rep) - 1) / rep;  // last token of the block
  const int kv_end = min(q_hi + 1, nv);
  // the raw keys and values of the tile starting at `start`, every copy in flight at once
  auto copy_tile = [&](int start) {
    const int n_load = min(kTile, nv - start);
    for (int e = tid; e < n_load * RC; e += kGqaThreads) {
      const int j = e / RC, c = CH * (e % RC);
      cp_async16(kr_s + j * KRS + c, a.k + kv_off(start + j) + c);
      cp_async16(v_s + j * D + c, a.v + kv_off(start + j) + c);
    }
  };
  if (kv_end > 0) copy_tile(0);  // lands while the prologue runs

  // ---- prologue: rotate this block's q rows; zero its tokens' k / v rows past valid ----
#pragma unroll 2
  for (int e = tid; e < kGqaRows * QD; e += kGqaThreads) {
    const int r = e / QD, i = 4 * (e % QD), tok = (row0 + r) / rep;
    F4 lo = {}, hi = {};
    if (tok < S) rope_quad<T, D>(a.q + q_off(tok, (row0 + r) % rep), i, cos_of(tok), sin_of(tok), lo, hi);
    store4(q_s + r * D + i, lo);
    store4(q_s + r * D + i + D / 2, hi);
  }
  // the tokens this block emits: those whose head-0 row lies in it; the
  // valid ones are copied from the staged tiles, the rest zeroed here
  const int t0 = (row0 + rep - 1) / rep;
  const int t1 = min((row0 + kGqaRows - 1) / rep + 1, S);  // one past the last
  for (int e = tid; e < (t1 - max(t0, nv)) * VD; e += kGqaThreads) {
    const int tok = max(t0, nv) + e / VD, i = 4 * (e % VD);
    const F4 zero = {};
    store4(a.k_cast + kv_off(tok) + i, zero);
    store4(a.v_cast + kv_off(tok) + i, zero);
  }
  if (tid < kGqaRows) l_s[tid] = 0.f;
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) m[rr] = kNegInf, l[rr] = 0.f;
  float acc[RPT][U];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
#pragma unroll
    for (int u = 0; u < U; ++u) acc[k][u] = 0.f;
  __syncthreads();

  // ---- stream key tiles up to the block's diagonal and the valid count ----
  for (int start = 0; start < kv_end; start += kTile) {
    const int n_load = min(kTile, nv - start);  // keys of the tile that exist
    if (start > 0) copy_tile(start);
    cp_async_wait_all();
    __syncthreads();
    // rotate the keys into k_s (in place for f32); zero the missing rows
#pragma unroll 4
    for (int e = tid; e < kTile * QD; e += kGqaThreads) {
      const int j = e / QD, i = 4 * (e % QD), tok = start + j;
      F4 lo = {}, hi = {};
      if (j < n_load) {
        rope_quad<T, D>(kr_s + j * KRS, i, cos_of(tok), sin_of(tok), lo, hi);
      } else {
        store4(v_s + j * D + i, lo);
        store4(v_s + j * D + i + D / 2, lo);
      }
      store4(k_s + j * KS + i, lo);
      store4(k_s + j * KS + i + D / 2, hi);
    }
    __syncthreads();
    {  // the block's valid tokens in this tile: rotated k, v as loaded
      const int e0 = max(t0, start), e1 = min(t1, start + n_load);
      for (int e = tid; e < (e1 - e0) * VD; e += kGqaThreads) {
        const int tok = e0 + e / VD, j = tok - start, i = 4 * (e % VD);
        store4(a.k_cast + kv_off(tok) + i, load4(k_s + j * KS + i));
        store4(a.v_cast + kv_off(tok) + i, load4(v_s + j * D + i));
      }
    }
    {  // logits and the online softmax: lane = key, the warp's rows
      float dots[kRowsPerWarp];
      dot_rows<D, kRowsPerWarp>(q_s + warp * kRowsPerWarp * D, k_s + lane * KS, dots);
      const int key = start + lane;
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr, tok = (row0 + r) / rep;
        const float logit = __fmul_rn(dots[rr], a.scale);
        const bool ok = key < nv && key <= tok && tok < S;
        float mt = ok ? logit : kNegInf;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[rr], mt);
        const float alpha = expf(__fsub_rn(m[rr], m_new));
        const float p = ok ? expf(__fsub_rn(logit, m_new)) : 0.f;
        float sum = p;  // xor butterfly = tree32 over the lanes
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
        l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha), sum);
        m[rr] = m_new;
        p_s[r * kTile + lane] = p;
        if (lane == 0) alpha_s[r] = alpha, l_s[r] = l[rr];
      }
    }
    __syncthreads();
    if (tid / DVT * RPT < kGqaRows) {  // acc = acc * alpha + tree32(p * v)
      const int dcol = tid % DVT, rg = tid / DVT;
#pragma unroll 1
      for (int u = 0; u < U; ++u) {
        float vv[kTile];
#pragma unroll
        for (int j = 0; j < kTile; ++j) vv[j] = to_f32(v_s[j * D + dcol + u * DVT]);
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const int r = rg * RPT + k;
          float pv[kTile];
#pragma unroll
          for (int j = 0; j < kTile; j += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * kTile + j);
            pv[j] = __fmul_rn(p4.x, vv[j]);
            pv[j + 1] = __fmul_rn(p4.y, vv[j + 1]);
            pv[j + 2] = __fmul_rn(p4.z, vv[j + 2]);
            pv[j + 3] = __fmul_rn(p4.w, vv[j + 3]);
          }
          const float sum = tile_sum(pv), alpha = alpha_s[r];
#pragma unroll
          for (int w = 0; w < U; ++w)  // u is a loop variable: select, keep acc in registers
            if (w == u) acc[k][w] = __fadd_rn(__fmul_rn(acc[k][w], alpha), sum);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue ----
  const int dcol = tid % DVT, rg = tid / DVT;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = rg * RPT + k, tok = (row0 + r) / rep;
    if (r >= kGqaRows || tok >= S) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* o = a.out + q_off(tok, (row0 + r) % rep) + dcol;
#pragma unroll
    for (int u = 0; u < U; ++u) store(o + u * DVT, acc[k][u] / den);
  }
}

template <typename T, int D>
cudaError_t launch_gqa(const PrefillArgs<T>& a, int B, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * ((size_t)kGqaRows * D + (size_t)kTile * (D + kKeyPad) + kGqaRows * kTile +
                       2 * kGqaRows) +
      sizeof(T) * kTile * D * (sizeof(T) == sizeof(float) ? 1 : 2);
  static unsigned long long attribute_set = 0;  // bit per device: the attribute is set once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((attribute_set >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(gqa_prefill_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) attribute_set |= 1ull << dev;
  }
  const int n_qb = (a.S * a.rep + kGqaRows - 1) / kGqaRows;
  const long long blocks = (long long)n_qb * a.G * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gqa_prefill_kernel<T, D><<<(unsigned)blocks, kGqaThreads, smem, stream>>>(a, n_qb);
  return cudaGetLastError();
}

// (D, DV) pairs: GQA heads (DV = D) on gqa_prefill_kernel; DeepSeek-V3's MLA
// (192, 128) and its smoke config's (24, 16) on prefill_kernel.
template <typename T>
cudaError_t launch(const PrefillArgs<T>& a, int B, int D, int DV, cudaStream_t stream) {
  if (D == DV) {
    switch (D) {
      case 16: return launch_gqa<T, 16>(a, B, stream);
      case 32: return launch_gqa<T, 32>(a, B, stream);
      case 64: return launch_gqa<T, 64>(a, B, stream);
      case 128: return launch_gqa<T, 128>(a, B, stream);
      case 256: return launch_gqa<T, 256>(a, B, stream);
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
