#pragma once
// GQA flash decode over the tiered KV cache, for Hopper (sm_90a): the
// fused-RoPE form and the post-append form, one kernel template.
//
// Replaces two TPU kernels of src/repro/kernels/flash_decode.py:
//  * _flash_gqa_fused (body _kernel_gqa_fused), entry point
//    flash_decode_gqa_fused, reached through flash_decode_attention(k_new=...,
//    rope_theta=...): one new token per slot attends over the hot tier, then
//    the cold tier, then (for active slots) its own pending (k, v), with an
//    online softmax in f32. q and the pending k arrive unrotated and rotate
//    at position lengths[b]; the rotated k is returned for the caller's
//    append. The cache is the pre-append state.
//  * _flash_gqa (body _kernel_gqa), entry point flash_decode_gqa, reached
//    through flash_decode_attention(q, cache) with no k_new: q is already
//    rotated and the cache already holds the new token (the post-append
//    state), so there is no RoPE prologue and no pending token. A length-0
//    slot gives zeros (acc / max(l, 1e-30) with acc = l = 0).
// Both fold the slot's keys in ABSOLUTE 32-key tiles, as the chunked
// prefill forms do (flash_prefill.cuh): tile i holds positions 32 i ..
// 32 i + 31, position p < HC from hot row p and the rest from cold row p -
// HC, so a tile may hold rows of both tiers, and the fused form's pending
// token is the key at lane p % 32 of tile p // 32 (p = lengths[b]), inside
// that tile's max, sums and P.V. A decoded row then equals the prefill's
// row at its position bit for bit, so a request preempted and recomputed
// from its prefix decodes the tokens it would have decoded unpreempted.
//
// What bounds it on this card: the bytes of the valid KV rows, one read of
// each. At falcon3-1b's shape (b 6, h 8, g 4, d 256, f32) the fused form
// moves 4.1 MB at length 80 (1.2 us at 3.35 TB/s) and 6.3 MB at length 127
// (1.9 us); its 4 b h (n + 1) d operations take under a third of that at
// the f32 rate. At one query token per slot each block's chain of
// dependent phases (load, dot products, softmax, fold, each ended by a
// barrier) sets the time, so the design shortens that chain, keeps every
// row load of a chunk in flight at once, and reads each key row once.
//
// Design:
//  * The TPU grid (batch, kv_group, s_blocks) carries the softmax state
//    across its sequential S axis. Here one block owns one (value-dim
//    slice of DVS = 64, kv group, slot), grid (D / DVS, G, B), and the D /
//    DVS slice blocks of a (slot, group) form one thread-block cluster: at
//    falcon3-1b's shape 24 clusters of 4 blocks, 96 blocks in one wave.
//  * The block walks the 32-key tiles of the slot's keys in chunks of
//    kChunk = 4 tiles; each key's row is resolved from its position
//    (row_at); no row at or past the slot's length is read, so a masked row
//    may hold anything, and a length-0 inactive slot writes zeros. A chunk's key rows and
//    values are loaded into registers before they are needed: the first
//    chunk's as soon as the length is known (the queries, the pending k and
//    v and the RoPE table load before it), the next one's after a fold.
//    Per chunk:
//    (1) logits: the cluster's warps split the chunk's keys (key j of each
//    tile to warp j mod CW of the cluster), so each key row is read once
//    per (slot, group); lane L holds dims L + 32 t of the row and of q.
//    The dot product is the halving tree over t inside the lane, then the
//    xor butterfly across lanes, whose levels run together for all of a
//    warp's keys. Each logit is written into every block of the cluster
//    (distributed shared memory), and a cluster barrier follows;
//    (2) softmax: one warp per head, lane j on key j of every tile of the
//    chunk at once: the tile maxima (fmaxf butterflies) and the sums of p
//    run in parallel, and only m and l chain from tile to tile: m_new,
//    alpha = exp(m - m_new), p_j = exp(logit_j - m_new) and l, each once;
//    p (stored in the P.V threads' order) and alpha go to shared memory.
//    Every block of a cluster computes them from the same logits, so the
//    slices agree bit for bit;
//    (3) P.V: a thread owns one value dim of the slice and the keys j = c
//    (mod SPLIT) of each tile, SPLIT = 256 / DVS; it folds acc = acc *
//    alpha + tile_dot(p, v) for every head: the halving tree over its 32 /
//    SPLIT keys unrolled level by level, then an xor butterfly over the
//    SPLIT threads of the dim, which together are the halving tree over
//    the tile's 32 keys.
//  * Fused form: q and k_new rotate in registers in the prologue. For d >=
//    64 the RoPE partner of dim L + 32 t is L + 32 (t + TL / 2), in the
//    same lane; for d 16 and 32 it is lane L ^ (d / 2), one shuffle. The
//    pending token's logits are computed there too (the warp of each head
//    holds them in registers, in the lane dot order of every other logit),
//    and its softmax step puts them at the pending lane of their tile;
//    its value is the P.V thread's value of that key. Slice 0 writes k_rot.
//  * Head dim 112 (zamba2-7b's shared attention block; the fused contiguous
//    form in f32 and bf16 only, its own instantiation): the lanes carry 128
//    dims (padded_dims), dims 112 .. 127 zero in registers and shared memory
//    and never read or written in memory, whose rows stay 112 wide. The dot
//    products are then the halving tree over 128, the plain version's
//    tree_sum, and the two 64-dim value slices cover 128, the threads of
//    dims 112 .. 127 folding zeros and writing nothing. The RoPE partner of
//    dim i is i +- 56, in another lane and register, so the row passes
//    through the warp's row of shared memory (rope_padded).
//  * The two forms are one template (FUSED): the post-append form drops the
//    RoPE prologue and the pending token at compile time, so the tile
//    loop, the one the plain versions share too, exists once.
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
//  * No array leaves the registers: every tree is unrolled level by level
//    with compile-time indices (halve, tile_dot), and __launch_bounds__
//    asks for one block per SM, so ptxas may use up to 255 registers
//    (without that minimum it held some forms to 128 and spilled).
//  * Measured on the H100 at falcon3-1b's shape (PERF.md): blocks that
//    each computed every logit of their (slot, group) were held by those
//    logits; sharing them across the cluster gained most. 256 threads with
//    64-dim slices and 128 threads with 32-dim slices (clusters of 8) were
//    fastest, the first slightly; chunks of 2 tiles were slower at length
//    80 and up; issuing every load of a chunk before its first use and
//    running the butterflies of a warp's dot products together gained the
//    rest.
//  * Paged cold tier (the reference's paged forms of both kernels,
//    _flash_gqa_fused and _flash_gqa with a PagedKVCache; entry points
//    flash_decode_gqa_fused_paged and flash_decode_gqa_paged, kernel
//    gqa_decode_paged_kernel): the cold tier is a pool of pages shared by
//    the slots, and cold row r of slot b is pool row page_table[b, r / ps]
//    * ps + r % ps. The address is resolved per row (row_at), so a 32-key
//    tile may span pages when ps is not a multiple of 32; the tiles and
//    every sum are the contiguous form's, so over the same content the two
//    forms agree bit for bit. The same
//    body (PAGED flag) compiles into a kernel of its own name.
//  * Ring cold tier (the reference's _flash_gqa_fused with ring=True, entry
//    point flash_decode_gqa_fused_ring, kernel gqa_decode_ring_kernel; the
//    fused form over the sliding-window ring of mixtral-8x22b): cold
//    position p >= HC sits at ring row (p - HC) % CC while the ring still
//    holds it (p >= length - CC). The form folds ABSOLUTE tiles too, over
//    the positions the ring holds: the hot rows, the cold positions from
//    max(HC, length - CC) to length - 1, and the pending token at lane
//    length % 32 of tile length / 32. For an active slot the oldest of
//    those cold positions, once the window has wrapped, is the evictee (the
//    append that follows overwrites its row, and it has left the window of
//    the token being decoded), so the cold keys start one later; an inactive
//    slot appends nothing and keeps every row, as in the reference. Tiles
//    wholly before the window are skipped, as the chunked ring form skips
//    them (flash_prefill.cuh), so at hot_cap 0 (every SWA cache the
//    engine builds) an active slot's decoded row is the one-row ring chunk's
//    row at window = CC bit for bit, and an inactive one's the row of that
//    chunk at valid 0 and no window: a speculative verify chunk over the
//    ring gives the decode's rows. Once the window start is not 32-aligned,
//    one tile's keys come from both ends of the ring (the window's oldest
//    tile and the pending token's share a block of 32 ring rows); each
//    lane resolves its row from the ring row of the first cold key by one
//    select (row_at), so every load of a chunk stays in flight together.
//    The same body (RING flag) compiles into a kernel of its own name. At
//    mixtral-8x22b's shape (b 4, h 48, g 8, d 128, a 4096-row ring, f32)
//    the form moves 134 MB, 0.040 ms at 3.35 TB/s, over a grid of only 2 x
//    8 x 4 = 64 blocks.
//  * fp8 (e4m3) tiers (the reference's kv_fp8 caches, which its kernels
//    upcast tile by tile to f32): the tiers have a type of their own, TT,
//    either T or __nv_fp8_e4m3 (fp8.cuh), while q, k_new, v_new, out and
//    k_rot keep the activation type T. A row element is upcast as it is
//    loaded (to_f32, exact), so the tiles, their order and every sum are
//    the f32 forms'; an fp8 form reads a quarter of an f32 form's tier
//    bytes. Every form has an fp8 instance (entry points in
//    flash_decode_fp8.cu and flash_decode_paged_fp8.cu).
//
// This header holds the kernels; their C entry points are in five sources,
// one library each, so that they build in parallel: flash_decode.cu (the
// contiguous forms), flash_decode_paged.cu (the paged forms),
// flash_decode_ring.cu (the ring form), flash_decode_fp8.cu (the contiguous
// and ring forms over fp8 tiers) and flash_decode_paged_fp8.cu (the paged
// forms over fp8 tiers).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fp8.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // keys per tile
constexpr int kChunk = 4;   // tiles whose logits are computed before their fold
constexpr int kMaxRep = 8;  // query heads per kv group
constexpr int kHeadsPerWarp = (kMaxRep + kWarps - 1) / kWarps;  // in the softmax step
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr unsigned kFull = 0xffffffffu;

// Value dims per block: the grid is (D / slice_dims(D), G, B), and the
// D / slice_dims(D) slice blocks of a (slot, group) form one cluster.
__host__ __device__ constexpr int slice_dims(int d) { return d < 64 ? d : 64; }

// The lane layout's width: D itself for the powers of two, the next one
// up for d 112 (zamba2-7b's heads). Dims D .. padded_dims(D) - 1 are zero in
// registers and shared memory and neither read nor written in memory, so
// the dot products are the halving tree over the padded width, which is
// the plain version's tree_sum (it zero-pads to a power of two), and the
// value slices (64 wide) cover it in whole blocks.
__host__ __device__ constexpr int padded_dims(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// The maximum over the warp of each s[i], the butterflies level by level.
template <int N>
__device__ __forceinline__ void warp_maxes(float (&s)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = fmaxf(s[i], __shfl_xor_sync(kFull, s[i], o));
}

// warp_sum of each s[i], the butterflies of all N sums level by level.
template <int N>
__device__ __forceinline__ void warp_sums(float (&s)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = __fadd_rn(s[i], __shfl_xor_sync(kFull, s[i], o));
}

// The dot product whose products x[t] (dim lane + 32 t) the lanes hold: the
// halving tree over t inside the lane, then the xor butterfly across lanes,
// which together are the halving tree over the dims. Every lane returns
// the sum.
template <int TL>
__device__ __forceinline__ float dot_sum(float (&x)[TL]) {
  halve<TL / 2>(x);
  return warp_sum(x[0]);
}

// The halving tree over a tile's 32 products p_j * v_j, of which this
// thread holds the keys j = c + SPLIT u (c = lane % SPLIT): p holds this
// thread's KPT = 32 / SPLIT probabilities in order of u (16-byte aligned),
// v the values. The tree's levels that pair j with j + 16, ..., j + SPLIT
// stay inside the thread (u with u + KPT / 2, ...; the first is taken as
// the products are formed); the rest pair the SPLIT threads of the dim by
// an xor butterfly. Every thread of the dim returns the sum.
template <int SPLIT>
__device__ __forceinline__ float tile_dot(const float* p, const float (&v)[kTile / SPLIT]) {
  constexpr int KPT = kTile / SPLIT, H = KPT / 2;
  float x[H];
  if constexpr (H % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int j4 = 0; j4 < H / 4; ++j4) {
      const float4 lo = p4[j4], hi = p4[j4 + H / 4];
      const int j = 4 * j4;
      x[j] = __fadd_rn(__fmul_rn(lo.x, v[j]), __fmul_rn(hi.x, v[j + H]));
      x[j + 1] = __fadd_rn(__fmul_rn(lo.y, v[j + 1]), __fmul_rn(hi.y, v[j + 1 + H]));
      x[j + 2] = __fadd_rn(__fmul_rn(lo.z, v[j + 2]), __fmul_rn(hi.z, v[j + 2 + H]));
      x[j + 3] = __fadd_rn(__fmul_rn(lo.w, v[j + 3]), __fmul_rn(hi.w, v[j + 3 + H]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < H; ++j) x[j] = __fadd_rn(__fmul_rn(p[j], v[j]), __fmul_rn(p[j + H], v[j + H]));
  }
  halve<H / 2>(x);
  float s = x[0];
#pragma unroll
  for (int o = SPLIT / 2; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

// This lane's entries of a RoPE table row (D / 2 values, the low dim of
// each pair): dims lane + 32 t for t < TL / 2 when D >= 64, else dim
// lane mod D / 2 (lanes below D).
template <int D, int TL>
__device__ __forceinline__ void load_table(const float* row, int lane, float (&out)[(TL + 1) / 2]) {
  if constexpr (TL >= 2) {
#pragma unroll
    for (int t = 0; t < TL / 2; ++t) out[t] = row[lane + 32 * t];
  } else {
    out[0] = lane < D ? row[lane & (D / 2 - 1)] : 0.f;
  }
}

// RoPE of the head row whose dims lane + 32 t this lane holds in x, in
// apply_rope's expression: for i < D / 2, x1 = x[i], x2 = x[i + D / 2];
// out[i] = x1 cos - x2 sin, out[i + D / 2] = x2 cos + x1 sin. c and s are
// this lane's table entries (load_table).
template <int D, int TL>
__device__ __forceinline__ void rope(float (&x)[TL], const float (&c)[(TL + 1) / 2],
                                     const float (&s)[(TL + 1) / 2], int lane) {
  if constexpr (TL >= 2) {  // the partner of t is t + TL / 2, in this lane
#pragma unroll
    for (int t = 0; t < TL / 2; ++t) {
      const float x1 = x[t], x2 = x[t + TL / 2];
      x[t] = __fsub_rn(__fmul_rn(x1, c[t]), __fmul_rn(x2, s[t]));
      x[t + TL / 2] = __fadd_rn(__fmul_rn(x2, c[t]), __fmul_rn(x1, s[t]));
    }
  } else {  // d 16 or 32: the partner of lane L is lane L ^ (D / 2)
    const float other = __shfl_xor_sync(kFull, x[0], D / 2);
    if (lane < D)
      x[0] = lane < D / 2 ? __fsub_rn(__fmul_rn(x[0], c[0]), __fmul_rn(other, s[0]))
                          : __fadd_rn(__fmul_rn(x[0], c[0]), __fmul_rn(other, s[0]));
  }
}

// The RoPE of a padded width (D not a power of two): the partner of dim i is
// i + D / 2 or i - D / 2, in another lane and register, so the row passes
// through the warp's own row of shared memory. c and s hold the table
// entry of each dim this lane holds (load_table_padded). The expression is
// rope's.
template <int D, int TL>
__device__ __forceinline__ void load_table_padded(const float* row, int lane, float (&out)[TL]) {
#pragma unroll
  for (int t = 0; t < TL; ++t) {
    const int i = lane + 32 * t;
    out[t] = i < D ? row[i < D / 2 ? i : i - D / 2] : 0.f;
  }
}

template <int D, int TL>
__device__ __forceinline__ void rope_padded(float (&x)[TL], const float (&c)[TL],
                                            const float (&s)[TL], int lane) {
  __shared__ float row_s[kWarps][D];
  float* row = row_s[threadIdx.x >> 5];
  __syncwarp();  // the warp's last rotation has read its row
#pragma unroll
  for (int t = 0; t < TL; ++t)
    if (lane + 32 * t < D) row[lane + 32 * t] = x[t];
  __syncwarp();
#pragma unroll
  for (int t = 0; t < TL; ++t) {
    const int i = lane + 32 * t;
    if (i < D) {
      const float other = row[i < D / 2 ? i + D / 2 : i - D / 2];
      x[t] = i < D / 2 ? __fsub_rn(__fmul_rn(x[t], c[t]), __fmul_rn(other, s[t]))
                       : __fadd_rn(__fmul_rn(x[t], c[t]), __fmul_rn(other, s[t]));
    }
  }
}

// T: the activations' type (q, k_new, v_new, out, k_rot); TT: the tiers'
// (T, or __nv_fp8_e4m3).
template <typename T, typename TT = T>
struct DecodeArgs {
  const T* q;       // (B, H, D)
  const TT* hot_k;  // (B, HC, G, D)
  const TT* hot_v;
  const TT* cold_k;  // (B, CC, G, D); paged: the pool (n_pages, ps, G, D)
  const TT* cold_v;
  const T* k_new;   // (B, G, D); fused form only, like active, cos, sin, k_rot
  const T* v_new;
  const int* lengths;  // (B,)
  const int* active;   // (B,)
  const float* cos;    // (B, D/2)
  const float* sin;
  T* out;    // (B, H, D)
  T* k_rot;  // (B, G, D)
  int G, rep, HC, CC;  // paged: CC = pps * ps
  float scale;
  const int* page_table = nullptr;  // (B, pps), paged form only
  int ps = 0, pps = 0;
};

template <typename T, typename TT, int D, bool FUSED, bool PAGED, bool RING = false>
__device__ __forceinline__ void decode_body(const DecodeArgs<T, TT>& a) {
  constexpr int DP = padded_dims(D);         // the lane layout's width
  constexpr bool kPad = DP != D;             // d 112: dims D .. DP - 1 are zero
  constexpr int TL = DP >= 32 ? DP / 32 : 1;  // head dims per lane
  constexpr int NT = kPad ? TL : (TL + 1) / 2;  // RoPE table entries per lane
  constexpr int DVS = slice_dims(DP);         // value dims per block
  constexpr int S = DP / DVS;                 // slice blocks of a cluster
  constexpr int SPLIT = kThreads / DVS;  // P.V threads per value dim
  constexpr int KPT = kTile / SPLIT;     // a tile's keys per P.V thread
  constexpr int CW = S * kWarps;      // warps of a cluster, which share a chunk's logits
  constexpr int KPW = kChunk * kTile / CW;  // a chunk's key slots per warp
  constexpr int kSpan = kTile / CW;         // a warp's key slots in one tile
  static_assert(kThreads % DVS == 0 && SPLIT <= 16, "a dim's P.V threads share a warp, 2+ keys each");
  static_assert(kTile % CW == 0, "a warp's key slots s, s + CW, ... stay in one tile");
  __shared__ float q_s[kMaxRep][D];  // the rotated queries
  // a chunk's logits, then p; two buffers, since the cluster's warps write
  // the next chunk's logits while this block may still fold the last one
  __shared__ __align__(16) float p_s[2][kMaxRep][kChunk * kTile];
  __shared__ float alpha_s[kMaxRep][kChunk];
  __shared__ float l_s[kMaxRep];

  cg::cluster_group cluster = cg::this_cluster();
  const int slice = blockIdx.x, g = blockIdx.y, b = blockIdx.z;  // slice = cluster rank
  const int G = a.G, rep = a.rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = slice * kWarps + warp;               // this warp in its cluster
  const int part = threadIdx.x % SPLIT;               // P.V keys j = part (mod SPLIT)
  const int dv = slice * DVS + threadIdx.x / SPLIT;   // P.V value dim
  const int gd = G * D;  // a tier's row stride, in elements

  // ---- the loads that need nothing but the block's place go first: the
  // query heads r = warp + kWarps h (the heads whose softmax this warp
  // runs) and, fused, the pending k and v and the RoPE table ----
  float qx[kHeadsPerWarp][TL];
#pragma unroll
  for (int h = 0; h < kHeadsPerWarp; ++h) {
    const int r = warp + kWarps * h;
    const T* qrow = a.q + ((int64_t)b * G * rep + g * rep + r) * D;
#pragma unroll
    for (int t = 0; t < TL; ++t) {
      const int i = lane + 32 * t;
      qx[h][t] = r < rep && i < D ? to_f32(qrow[i]) : 0.f;
    }
  }
  const bool active = FUSED && a.active[b] != 0;
  float kr[TL], vn = 0.f, cos_l[NT], sin_l[NT];
  if constexpr (FUSED && kPad) {
    load_table_padded<D, TL>(a.cos + (int64_t)b * (D / 2), lane, cos_l);
    load_table_padded<D, TL>(a.sin + (int64_t)b * (D / 2), lane, sin_l);
  } else if constexpr (FUSED) {
    load_table<D, TL>(a.cos + (int64_t)b * (D / 2), lane, cos_l);
    load_table<D, TL>(a.sin + (int64_t)b * (D / 2), lane, sin_l);
  }
  if constexpr (FUSED) {
    const T* krow = a.k_new + ((int64_t)b * G + g) * D;
#pragma unroll
    for (int t = 0; t < TL; ++t) {
      const int i = lane + 32 * t;
      kr[t] = i < D ? to_f32(krow[i]) : 0.f;
    }
    if constexpr (kPad)
      vn = dv < D ? to_f32(a.v_new[((int64_t)b * G + g) * D + dv]) : 0.f;
    else
      vn = to_f32(a.v_new[((int64_t)b * G + g) * D + dv]);
  }

  const int length = a.lengths[b];
  // Absolute tiles: tile i holds positions 32 i .. 32 i + 31. Linear forms:
  // the slot's keys are the positions 0 .. n_keys - 1, tier rows below
  // n_tier and, for an active slot of the fused form, the pending token at
  // position pend = n_tier (-1: none).
  const int n_tier = min(length, a.HC + a.CC);
  const int pend = !active ? -1 : RING ? length : n_tier;
  // RING: n_hot = min(length, HC) hot rows; the cold positions from lo =
  // max(HC, length - CC + active), clipped to length, which the ring still
  // holds (an active slot's oldest one is the evictee: the coming append
  // overwrites it, and its position has left the window of the token being
  // decoded); then the pending token at position length, so the keys end
  // at n_end. Tiles [0, t_hot) and [t_up, t_up + n_tiles - t_hot) hold
  // every key; the tiles between hold none and are skipped.
  const int n_hot = min(length, a.HC);
  const int lo = min(max(a.HC, length - a.CC + (active ? 1 : 0)), length);
  const int n_end = length + (active ? 1 : 0);
  const int t_hot = (n_hot + kTile - 1) / kTile;
  const int t_up = max(lo / kTile, t_hot);
  const int n_tiles = RING ? t_hot + max((n_end + kTile - 1) / kTile - t_up, 0)
                           : (n_tier + (pend >= 0) + kTile - 1) / kTile;
  // RING: a cold key p (lo <= p < length, so p - lo < CC) sits at ring row
  // rbase + p, less CC past the ring's end (rbase + lo is the ring row of
  // position lo): one select, no branch, so a tile whose keys wrap the ring
  // (its rows come from both ends of it) loads like any other. Keys and
  // rows follow from the position and these scalars alone, so the ring
  // form keeps no per-tile bases in registers. hslot / cslot: the slot's
  // row 0 of this group in the hot tier / the ring.
  const int rbase = (a.CC > 0 ? max(lo - a.HC, 0) % a.CC : 0) - lo;
  const int64_t hslot = (int64_t)b * a.HC * gd + (int64_t)g * D;
  const int64_t cslot = (int64_t)b * a.CC * gd + (int64_t)g * D;

  // A chunk in registers: its tiles' key counts from key 0 (0 past the
  // last tile), the pending token's key index in each tile (-1: none), the
  // position of each tile's key 0, this warp's key rows for the logits
  // (slot gw + CW i of the chunk: tile i / kSpan) and this thread's values
  // for the fold.
  int n[kChunk], pl[kChunk], start[kChunk];
  int64_t hbase[kChunk], cbase[kChunk];  // contiguous: tile k's row 0 in either tier
  float kx[KPW][TL];
  float v[kChunk][KPT];
  // key j of tile k is one of the slot's keys (the pending token included)
  auto is_key = [&](int k, int j) -> bool {
    if constexpr (RING) {
      const int pos = start[k] + j;
      // bitwise, not short-circuit: a branch here keeps a chunk's loads
      // from issuing together
      return (j < n[k]) & ((pos < n_hot) | (pos >= lo));
    } else {
      return j < n[k];
    }
  };
  // ... and held in a tier: a key, not the pending token. One predicate,
  // written per form as it compiled to its fastest code (SASS and times
  // from time_decode_forms.py): bitwise for the ring and paged forms, whose
  // row addresses depend on it, short-circuit for the contiguous ones.
  auto held_at = [&](int k, int j) -> bool {
    if constexpr (RING) {
      return is_key(k, j) & (j != pl[k]);
    } else if constexpr (PAGED) {
      return (j < n[k]) & (j != pl[k]);
    } else {
      return j < n[k] && j != pl[k];
    }
  };
  // The row of this slot's group at position start[k] + j, as an offset
  // from the hot tier (position < HC) or the cold tier: contiguous, from
  // the tile's bases; paged, a cold row through the page table; RING, a
  // cold row of the ring from rbase (each read only for a key a tier
  // holds). No branch, so the loads it feeds stay predicated and are in
  // flight together.
  auto row_at = [&](int k, int j, bool held) -> int64_t {
    const int pos = start[k] + j;
    if constexpr (PAGED) {
      const int r = held ? max(pos - a.HC, 0) : 0;
      const int64_t cold = (int64_t)a.page_table[(int64_t)b * a.pps + r / a.ps] * a.ps + r % a.ps;
      return (pos < a.HC ? (int64_t)b * a.HC + pos : cold) * gd + (int64_t)g * D;
    } else if constexpr (RING) {
      int r = rbase + pos;
      r = r >= a.CC ? r - a.CC : r;
      return pos < a.HC ? hslot + (int64_t)pos * gd : cslot + (int64_t)(held ? r : 0) * gd;
    } else {
      return (pos < a.HC ? hbase[k] : cbase[k]) + j * gd;
    }
  };
  auto fetch = [&](int c0) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int tk = c0 + k;
      if constexpr (RING) {
        start[k] = (tk < t_hot ? tk : tk - t_hot + t_up) * kTile;
        n[k] = tk < n_tiles ? min(kTile, n_end - start[k]) : 0;
      } else {
        start[k] = tk * kTile;
        n[k] = tk < n_tiles ? min(kTile, n_tier + (pend >= 0) - start[k]) : 0;
      }
      pl[k] = pend >= start[k] && pend < start[k] + kTile ? pend - start[k] : -1;
      hbase[k] = ((int64_t)b * a.HC + start[k]) * gd + (int64_t)g * D;
      cbase[k] = ((int64_t)b * a.CC + start[k] - a.HC) * gd + (int64_t)g * D;
    }
#pragma unroll
    for (int i = 0; i < KPW; ++i) {
      const int k = i / kSpan, j = gw + CW * (i % kSpan), pos = start[k] + j;
      const bool held = held_at(k, j);
      const TT* row = (pos < a.HC ? a.hot_k : a.cold_k) + row_at(k, j, held);
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        const int idx = lane + 32 * t;
        kx[i][t] = held && idx < D ? to_f32(row[idx]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
#pragma unroll
      for (int u = 0; u < KPT; ++u) {
        const int j = part + SPLIT * u, pos = start[k] + j;
        const bool held = held_at(k, j);
        const TT* row = (pos < a.HC ? a.hot_v : a.cold_v) + row_at(k, j, held) + dv;
        bool vheld = held;
        if constexpr (kPad) vheld = held && dv < D;  // a padded dim reads nothing
        const float x = vheld ? to_f32(*row) : 0.f;
        v[k][u] = j == pl[k] ? vn : x;
      }
  };
  fetch(0);  // the first chunk's rows load while the queries rotate

  // ---- prologue: rotate the heads (fused), store them; fused: every warp
  // also rotates the pending k, so the pending logits of its heads come
  // here, and slice 0's warp 0 writes k_rot ----
  float lg_pend[kHeadsPerWarp] = {};
  if constexpr (FUSED && kPad) rope_padded<D>(kr, cos_l, sin_l, lane);
  else if constexpr (FUSED) rope<D>(kr, cos_l, sin_l, lane);
  if constexpr (FUSED) {
    if (slice == 0 && warp == 0)
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        const int i = lane + 32 * t;
        if (i < D) store(a.k_rot + ((int64_t)b * G + g) * D + i, kr[t]);
      }
  }
#pragma unroll
  for (int h = 0; h < kHeadsPerWarp; ++h) {
    const int r = warp + kWarps * h;
    if (r >= rep) break;
    if constexpr (FUSED && kPad) rope_padded<D>(qx[h], cos_l, sin_l, lane);
    else if constexpr (FUSED) rope<D>(qx[h], cos_l, sin_l, lane);
#pragma unroll
    for (int t = 0; t < TL; ++t) {
      const int i = lane + 32 * t;
      if (i < D) q_s[r][i] = qx[h][t];
    }
    if constexpr (FUSED) {
      float pr[TL];
#pragma unroll
      for (int t = 0; t < TL; ++t) pr[t] = __fmul_rn(qx[h][t], kr[t]);
      lg_pend[h] = __fmul_rn(dot_sum<TL>(pr), a.scale);
    }
  }

  // online-softmax state: m and l of head warp + kWarps h in the lanes of
  // warp `warp`; acc of every head for this thread's value dims
  float m[kHeadsPerWarp], l[kHeadsPerWarp];
#pragma unroll
  for (int h = 0; h < kHeadsPerWarp; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int c0 = 0, buf = 0; c0 < n_tiles; c0 += kChunk, buf ^= 1) {
    float* lg_s = &p_s[buf][0][0];
    // (1) logits: the cluster's warps share the chunk's key slots (slot s,
    // tile s / 32, key s % 32, to warp s % CW of the cluster); each logit
    // goes into every block of the cluster
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      float q[TL];
#pragma unroll
      for (int t = 0; t < TL; ++t) {
        const int idx = lane + 32 * t;
        q[t] = idx < D ? q_s[r][idx] : 0.f;
      }
      float dot[KPW];
#pragma unroll
      for (int i = 0; i < KPW; ++i) {
        float x[TL];
#pragma unroll
        for (int t = 0; t < TL; ++t) x[t] = __fmul_rn(q[t], kx[i][t]);
        halve<TL / 2>(x);
        dot[i] = x[0];
      }
      warp_sums(dot);
#pragma unroll
      for (int i = 0; i < KPW; ++i) {
        const int k = i / kSpan, j = gw + CW * (i % kSpan);
        if (!held_at(k, j)) continue;
        const float logit = __fmul_rn(dot[i], a.scale);
        float* dst = lg_s + r * (kChunk * kTile) + k * kTile + j;
        if constexpr (S == 1) {
          if (lane == 0) *dst = logit;
        } else if (lane < S) {
          *cluster.map_shared_rank(dst, lane) = logit;
        }
      }
    }
    if constexpr (S == 1) __syncthreads(); else cluster.sync();
    // (2) softmax: a warp per head, lane j on key j of every tile at once;
    // the tile maxima and sums are independent, only m and l chain. p is
    // stored where the P.V threads read it: key j = c + SPLIT u at
    // c * KPT + u
#pragma unroll
    for (int h = 0; h < kHeadsPerWarp; ++h) {
      const int r = warp + kWarps * h;
      if (r >= rep) break;
      float* lg = lg_s + r * (kChunk * kTile);
      float x[kChunk], p[kChunk], alpha[kChunk], tmax[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        tmax[k] = x[k] = !is_key(k, lane) ? kNegInf
                         : lane == pl[k]  ? lg_pend[h]
                                          : lg[k * kTile + lane];
      warp_maxes(tmax);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        p[k] = 0.f;
        if (n[k] == 0) continue;
        const float m_new = fmaxf(m[h], tmax[k]);
        alpha[k] = expf(m[h] - m_new);
        if (is_key(k, lane)) p[k] = expf(x[k] - m_new);
        m[h] = m_new;
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (n[k] == 0) break;
        lg[k * kTile + (lane % SPLIT) * KPT + lane / SPLIT] = p[k];
        if (lane == 0) alpha_s[r][k] = alpha[k];
      }
      warp_sums(p);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (n[k] == 0) break;
        l[h] = __fadd_rn(__fmul_rn(l[h], alpha[k]), p[k]);
      }
    }
    __syncthreads();
    // (3) P.V: this thread's value dims and keys, every head
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (n[k] == 0) break;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) break;
        acc[r] = __fadd_rn(__fmul_rn(acc[r], alpha_s[r][k]),
                           tile_dot<SPLIT>(lg_s + r * (kChunk * kTile) + k * kTile + part * KPT,
                                           v[k]));
      }
    }
    // the next chunk's logits go to the other buffer, and its barrier
    // after them keeps this fold's reads of alpha_s before any rewrite
    if (c0 + kChunk < n_tiles) fetch(c0 + kChunk);
  }

#pragma unroll
  for (int h = 0; h < kHeadsPerWarp; ++h) {
    const int r = warp + kWarps * h;
    if (r >= rep) break;
    if (lane == 0) l_s[r] = l[h];
  }
  __syncthreads();
  bool writes = part == 0;
  if constexpr (kPad) writes = writes && dv < D;  // a padded dim has no output
  if (writes) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      T* orow = a.out + ((int64_t)b * G * rep + g * rep + r) * D;
      store(orow + dv, acc[r] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, typename TT, int D, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1) gqa_decode_kernel(DecodeArgs<T, TT> a) {
  decode_body<T, TT, D, FUSED, false>(a);
}

template <typename T, typename TT, int D, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1) gqa_decode_paged_kernel(DecodeArgs<T, TT> a) {
  decode_body<T, TT, D, FUSED, true>(a);
}

template <typename T, typename TT, int D>
__global__ void __launch_bounds__(kThreads, 1) gqa_decode_ring_kernel(DecodeArgs<T, TT> a) {
  decode_body<T, TT, D, true, false, true>(a);
}

template <typename T, typename TT, int D, bool FUSED, bool PAGED, bool RING>
cudaError_t launch_d(const DecodeArgs<T, TT>& a, int B, cudaStream_t stream) {
  constexpr int S = padded_dims(D) / slice_dims(padded_dims(D));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, a.G, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if constexpr (RING) {
    static_assert(FUSED && !PAGED, "the ring form is the fused form over a contiguous ring");
    err = cudaLaunchKernelEx(&cfg, gqa_decode_ring_kernel<T, TT, D>, a);
  } else if constexpr (PAGED) {
    err = cudaLaunchKernelEx(&cfg, gqa_decode_paged_kernel<T, TT, D, FUSED>, a);
  } else {
    err = cudaLaunchKernelEx(&cfg, gqa_decode_kernel<T, TT, D, FUSED>, a);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool FUSED, bool PAGED = false, bool RING = false, typename TT>
cudaError_t launch(const DecodeArgs<T, TT>& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, TT, 16, FUSED, PAGED, RING>(a, B, stream);
    case 32: return launch_d<T, TT, 32, FUSED, PAGED, RING>(a, B, stream);
    case 64: return launch_d<T, TT, 64, FUSED, PAGED, RING>(a, B, stream);
    case 128: return launch_d<T, TT, 128, FUSED, PAGED, RING>(a, B, stream);
    case 256: return launch_d<T, TT, 256, FUSED, PAGED, RING>(a, B, stream);
    case 112:
      // zamba2-7b's heads: the fused contiguous form only, f32 and bf16 tiers
      if constexpr (FUSED && !PAGED && !RING && std::is_same<T, TT>::value)
        return launch_d<T, TT, 112, FUSED, PAGED, RING>(a, B, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
