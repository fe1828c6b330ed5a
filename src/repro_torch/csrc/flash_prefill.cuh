#pragma once
// Causal flash prefill for Hopper (sm_90a): the GQA form, fresh or over a
// live tiered, paged or ring cache, with or without a sliding window, and
// the MLA form; six kernels over one block body.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::_flash_prefill
// (body _kernel_prefill): causal attention over a prompt or a prompt chunk
// with RoPE applied in the prologue and key blocks above the diagonal
// skipped.
//  * GQA fresh form (entry point flash_prefill_fresh, gqa_prefill_kernel;
//    reference call flash_prefill_attention(cache=None, emit_kv=True)):
//    positions 0..s-1; the whole head rotates, and the rotated k and the v
//    are emitted in the tier dtype with rows at or past the slot's valid
//    count zeroed.
//  * GQA chunked form (entry point flash_prefill_chunk, gqa_chunk_kernel;
//    reference call flash_prefill_attention(cache, valid, emit_kv=True),
//    the chunked-prefill admission of serving/engine.py): chunk row t of
//    slot b sits at position lengths[b] + t (lengths read on the device),
//    and every row folds the 32-key tiles of the slot's key sequence
//    [cached prefix ‖ chunk] at ABSOLUTE positions: tile i holds positions
//    32 i .. 32 i + 31, each a tier row (hot below hot_cap, else cold;
//    already rotated, never rotated again) below the offset, else a chunk
//    row (rotated in the prologue's way), so a tile may hold both. Tiles
//    holding no key of the slot are skipped, as the reference's pl.when
//    does. The tiles are then the fresh form's whatever the offsets, so a
//    prompt streamed in f32 chunks of any size, or resumed mid-tile from a
//    shared prefix, gives the fresh form's output bit for bit (the
//    reference folds the tiers' tiles and the chunk's separately, which is
//    the same fold only when the offset is a multiple of the block).
//  * GQA chunked form over a paged cold tier (entry point
//    flash_prefill_chunk_paged, gqa_chunk_paged_kernel; the reference's
//    chunked call with a PagedKVCache): the cold tier is a pool of pages
//    shared by the slots, and cold row r of slot b is pool row
//    page_table[b, r / ps] * ps + r % ps, resolved per row as a tier tile
//    is staged, so a tile may span pages when ps is not a multiple of 32.
//    The tiles, their order and every sum are the chunked form's, so over
//    the same content the two agree bit for bit.
//  * Sliding-window forms (the reference's window and ring arguments, the
//    serving path of mixtral-8x22b): the fresh GQA form with a window
//    (entry point flash_prefill_window, gqa_window_kernel) and the chunked
//    GQA form over a ring cold tier (entry point flash_prefill_chunk_ring,
//    gqa_chunk_ring_kernel). A row at position P sees the keys P - window <
//    p <= P. In the ring, cold position p >= hot_cap sits at row (p -
//    hot_cap) % cold_cap and is held while p >= offset - cold_cap (the
//    reference's ring_slot_positions at hot_cap = 0); an evicted position
//    is no key (value zeroed, logit masked). A block starts at the tile of
//    its first row's window: the tiles before it hold no key any of its
//    rows sees, and a skipped tile leaves the online-softmax state as a
//    folded fully masked one does (m kept, alpha = exp(0) = 1, p = 0). The
//    chunked form keeps the absolute tiles, so a prompt admitted in chunks
//    over the ring gives the fresh window form's rows bit for bit. The
//    same body (SWA flag) compiles into the two kernels of their own names.
//  * MLA form (entry point flash_prefill_mla, mla_prefill_kernel; reference
//    call flash_prefill_attention(rope_dims=qk_rope_head_dim, emit_kv=False)
//    in models/attention.py::mla_prefill): g = h (rep 1), keys of
//    D = nope + rope dims of which only the trailing RD rotate, values of
//    another width DV, and nothing emitted: the cached row is the latent,
//    built outside.
//
// What bounds it on this card: at serving prompt lengths (32..128 tokens)
// the latency of short blocks, not bytes (falcon3-1b's s = 32 moves 6.3 MB:
// 1.9 us at 3.35 TB/s; DeepSeek-V3's MLA form 62.9 MB: 18.8 us); the
// operation count grows as s^2 and bounds long prompts. No tensor cores:
// mma / wgmma neither round each product on its own nor sum in the fixed
// order below.
//
// Reproducible arithmetic, shared with flash_decode.cu: the dot products
// over the head dimension (zero-padded to a power of two) and the sums over
// a tile's 32 keys are halving trees (element i + n/2 added to element i,
// level by level), and every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn; never a plain a * b + c, which nvcc contracts into
// an FMA), so the plain PyTorch version (kernels/flash_prefill.py) repeats
// the kernel bit for bit; a one-ulp drift in the prompt's attention would
// otherwise change greedy tokens downstream. RoPE uses cos and sin tables
// from the wrapper, computed with the plain version's own expression.
//
// Design (one body, prefill_body, for every form):
//  * Rows are the group's (token, grouped head) pairs, token-major; a block
//    of 8 warps owns kRows = 16 consecutive rows of one (kv group, slot):
//    16 / rep tokens, or part of one token's heads when rep > 16 (any rep up
//    to 32, powers of two or not; the MLA form has rep 1, 16 tokens of one
//    head). The grid is one-dimensional and runs in chunks of kChunk
//    (group, slot) pairs, each with its longest q blocks first: the blocks
//    with the most key tiles start first, and the q blocks of a pair run
//    close enough in time that the key tiles they share come from L2 (the
//    MLA form's 768 pairs hold 123 MB of keys and values at s = 128).
//  * One block loops over the 32-key tiles up to the diagonal of its last
//    row (and the valid count), so the online-softmax state lives in the
//    block. A tile's raw k and v rows arrive by cp.async, every copy in
//    flight at once (tile 0's while the q rows rotate): the values of every
//    key that exists, the keys only up to the block's diagonal (past it
//    every logit is masked, while a masked key's p * v = +-0 still enters
//    the tile sum as the plain version's does); the keys are then
//    rotated once into f32 rows padded to D + 4 words, so that a warp's
//    16-byte loads of 32 different keys hit distinct banks. Only the
//    trailing RD dims rotate (dim OFF + j with OFF + j + RD / 2, OFF =
//    D - RD); the others pass through (in place for f32 keys). Each staged
//    tile serves every grouped head of the block's 16 rows.
//  * Logits: lane j of a warp owns key j, the warp owns 2 rows. A lane
//    computes each whole dot product itself, with no shuffles: the halving
//    tree over the padded width equals ((T0 + T2) + (T1 + T3)), Tp the tree
//    over the dims i = p (mod 4), and each Tp equals the pairwise sum of its
//    elements in bit-reversed order, kept on binary-counter stacks in
//    registers. The padded dims (D = 192 of 256, 24 of 32) fall on steps
//    known at compile time: there the product is the constant +0.0 (no
//    load, no multiply) and only the add remains, since -0 + +0 = +0.
//  * Softmax: the same warp holds its rows' 32 logits, one per lane: the
//    max is an fmaxf butterfly (order-free), the tile sum an xor butterfly,
//    which pairs lane j with j ^ 16, then j ^ 8, ...: the halving tree over
//    the tile, since each add is commutative. m and l stay in registers
//    across tiles; p and alpha go to shared memory, one row per 32
//    consecutive words.
//  * P.V: thread t owns output dims t % DVT (+ DVT, ...), DVT = min(DV,
//    256), of 16 / (256 / DVT) rows, holds that column of the value tile in registers and sums the tile with
//    the halving tree unrolled level by level (tile_sum), so no array leaves
//    the registers; the accumulator stays in registers across tiles.
//  * GQA only: each block emits the rotated k and the v of the tokens whose
//    first grouped head is among its rows, copied from the staged tile;
//    rows past the valid count are zeroed.
//  * Chunked form only: a tile is staged by cp.async, one at a time (the
//    first while q rotates), each row from its tier or from the chunk: f32
//    tier rows land in the staged-key rows as they are, bf16 ones are
//    widened, chunk rows are rotated; values of keys that do not exist are
//    zeroed. Offsets are per slot, so the RoPE
//    tables are per slot too, (B, S, D / 2), built by the wrapper with the
//    plain version's expression at lengths[b] + t. A block of a slot with
//    valid = 0 (an idle or decoding slot riding along a chunk wave) folds
//    its tiers and emits zeros, like the plain version.
//  * Measured on an H100 (PERF.md): 8-row blocks of 4 warps spilled at
//    d 256 (two output dims a thread), and a halving tree written as a
//    nested loop kept the 32-value P.V arrays in local memory; P.V then
//    dominated each block. The MLA form runs fastest at 3 blocks per SM
//    (80 registers, a few spilled) and with the chunked grid order; at
//    s = 32 its blocks then spend a third of their time loading q and the
//    first tile, in waves that load and compute in step.
//
//  * fp8 (e4m3) tiers (the reference's kv_fp8 caches): every GQA form has an
//    instance whose emit and tiers have the type TT = __nv_fp8_e4m3
//    (fp8.cuh) while q, k, v and the output keep T. The emit writes each
//    value's e4m3 byte (to_e4m3: the reference's cast, NaN past 464) of its
//    value in T (a k row's rotated f32 values round to T first, as the
//    reference's .astype(k_in_dtype).astype(fp8) does), 4 bytes a store. A
//    chunked form stages an fp8 tier row by loads of CH bytes, upcast into
//    the raw staging rows in T (exact), where its f32 / bf16 form copies the
//    row by cp.async; everything after is the same, so the tiles, their
//    order and every sum are unchanged.
//
// This header holds the kernels; their C entry points are in three sources,
// one library each, so that they build in parallel: flash_prefill.cu (the
// fresh, chunked, paged chunked and MLA forms), flash_prefill_swa.cu (the
// sliding-window forms) and flash_prefill_fp8.cu (the GQA forms over fp8
// tiers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp8.cuh"

namespace {

constexpr int kRows = 16;        // q rows per block (tokens x grouped heads, token-major)
constexpr int kTile = 32;        // keys per tile
constexpr int kRowsPerWarp = 2;  // rows whose logits and softmax one warp computes
constexpr int kThreads = 32 * kRows / kRowsPerWarp;
constexpr int kKeyPad = 4;     // words of padding per staged key row: no bank conflicts
constexpr int kChunk = 32;     // (group, slot) pairs whose q blocks run together
// resident blocks per SM the register budget allows: 2 for the GQA form
// (its d 256 rows need 128 registers); 3 for the MLA form, whose few
// spilled registers cost less than a third block per SM gains (PERF.md)
constexpr int kMinBlocks = 2, kMlaMinBlocks = 3;
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Smallest power of two >= n (n >= 1).
__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }
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

// CH = 16 / sizeof(T) elements of an fp8 tier row, loaded (4 or 8 bytes)
// and upcast into a raw staging row of T: exact, as every e4m3 value is an
// f32 and a bf16 value.
__device__ __forceinline__ void stage_fp8(float* dst, const __nv_fp8_e4m3* src) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
  *reinterpret_cast<float4*>(dst) =
      make_float4(e4m3_to_f32(w & 0xffu), e4m3_to_f32((w >> 8) & 0xffu),
                  e4m3_to_f32((w >> 16) & 0xffu), e4m3_to_f32(w >> 24));
}
__device__ __forceinline__ void stage_fp8(__nv_bfloat16* dst, const __nv_fp8_e4m3* src) {
  const uint2 w = *reinterpret_cast<const uint2*>(src);
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t half = (i < 2 ? w.x : w.y) >> (16 * (i % 2));
    const __nv_bfloat162 two =
        __floats2bfloat162_rn(e4m3_to_f32(half & 0xffu), e4m3_to_f32((half >> 8) & 0xffu));
    out[i] = *reinterpret_cast<const uint32_t*>(&two);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(out[0], out[1], out[2], out[3]);
}

// Four values (dims i .. i + 3 of an emitted k or v row) into the emit
// buffer: as T, or as the e4m3 bytes of their values in T. K: the values
// are a k row's rotated f32 values, which round to T first; a v row's
// values are T's already.
template <typename T, bool K>
__device__ __forceinline__ void emit4(T* p, const F4& x) {
  store4(p, x);
}
template <typename T, bool K>
__device__ __forceinline__ void emit4(__nv_fp8_e4m3* p, const F4& x) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = x.v[e];
    if constexpr (K && sizeof(T) == 2) v = __bfloat162float(__float2bfloat16(v));
    w |= to_e4m3(v) << (8 * e);
  }
  *reinterpret_cast<uint32_t*>(p) = w;
}

// The halving tree over a tile's 32 values with each level a loop of
// constant bound, so every index is a compile-time constant and x stays in
// registers (a nested loop over the levels leaves x in local memory).
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

// Dims OFF + [i, i + 4) of a head row x (i < HALF) and their RoPE partners
// OFF + HALF + [i, i + 4), rotated with the position's tables cs / sn (HALF
// values each): x1 c - x2 s and x2 c + x1 s, each product rounded alone.
template <int OFF, int HALF, typename T>
__device__ __forceinline__ void rope_quad(const T* x, int i, const float* cs, const float* sn,
                                          F4& lo, F4& hi) {
  const F4 x1 = load4(x + OFF + i), x2 = load4(x + OFF + HALF + i), c = load4(cs + i),
           s = load4(sn + i);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    lo.v[e] = __fsub_rn(__fmul_rn(x1.v[e], c.v[e]), __fmul_rn(x2.v[e], s.v[e]));
    hi.v[e] = __fadd_rn(__fmul_rn(x2.v[e], c.v[e]), __fmul_rn(x1.v[e], s.v[e]));
  }
}

// Dot products of R query rows q (stride D) with one key k, in the
// halving-tree order over D zero-padded to DP = pow2_at_least(D). That tree
// equals ((T0 + T2) + (T1 + T3)), Tp the halving tree over the dims
// i = p (mod 4), and each Tp equals the pairwise sum of its N = DP / 4
// elements taken in bit-reversed order. Step c of that order reads the dims
// 4m .. 4m + 3, m = bit_reverse(c), one per residue. The steps run in groups
// of NI: a group is a complete subtree, unrolled at compile time on register
// stacks (level l holds a pairwise sum of 2^l products); the groups run in a
// loop, their sums pushed on a second stack, which keeps the code and the
// live registers small.
template <int D>
struct DotShape {
  static constexpr int DP = pow2_at_least(D);
  static constexpr int N = DP / 4;              // steps
  static constexpr int NI = N < 16 ? N : 16;    // steps per group
  static constexpr int NG = N / NI;             // groups
  static constexpr int LBI = ilog2(NI), LBO = ilog2(NG);
  // a group's steps read the same dims in every group but the low 2 + LBO
  // bits, so a step lies wholly in the padding in every group or in none
  static_assert(D % (4 * NG) == 0, "head width unsupported");
};

// Step C of a group whose first dims q and k already point at (offset
// 4 * bit_reverse(group)): step c = group * NI + C reads the dims at
// 4 * (NG * bit_reverse(C) + bit_reverse(group)). A step past D is padding:
// its four products are the constant +0.0.
template <int D, int R, int C>
__device__ __forceinline__ void dot_group(const float* q, const float* k,
                                          float (&st)[R][4][DotShape<D>::LBI + 1]) {
  using Sh = DotShape<D>;
  if constexpr (C < Sh::NI) {
    constexpr int off = 4 * Sh::NG * bit_reverse(C, Sh::LBI), t = trailing_ones(C);
    constexpr bool pad = off >= D;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (!pad) {
        const float4 kk = *reinterpret_cast<const float4*>(k + off);
        const float4 qq = *reinterpret_cast<const float4*>(q + r * D + off);
        x[0] = __fmul_rn(qq.x, kk.x), x[1] = __fmul_rn(qq.y, kk.y);
        x[2] = __fmul_rn(qq.z, kk.z), x[3] = __fmul_rn(qq.w, kk.w);
      }
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

// T: the type of q, k, v and the output; TT: that of the emit (and of the
// tiers), T or __nv_fp8_e4m3.
template <typename T, typename TT = T>
struct PrefillArgs {
  const T* q;  // (B, S, H, D)
  const T* k;  // (B, S, G, D)
  const T* v;  // (B, S, G, DV)
  const int* valid;  // (B,)
  const float* cos;  // (S, rope_dims/2)
  const float* sin;
  T* out;      // (B, S, H, DV)
  TT* k_cast;  // (B, S, G, D), or null: nothing emitted
  TT* v_cast;  // (B, S, G, DV)
  int S, G, rep;
  float scale;
  int window = 0;  // SWA forms: a row sees the keys less than window behind it (0: all)
};

// The live cache of the chunked GQA form: tiers (B, cap, G, D) holding
// rotated keys and values in TT, and each slot's cached token count.
template <typename TT>
struct TierArgs {
  const TT* hot_k = nullptr;
  const TT* hot_v = nullptr;
  const TT* cold_k = nullptr;
  const TT* cold_v = nullptr;
  const int* lengths = nullptr;  // (B,): the slot's offset
  int hot_cap = 0, cold_cap = 0;    // paged: cold_cap = pps * ps
  const int* page_table = nullptr;  // (B, pps): paged form only; cold_k / v are the pool
  int ps = 0, pps = 0;
  int ring = 0;  // SWA chunked form: the cold tier is a ring
};

// Dynamic shared memory of one block: q rows, staged keys (f32, padded),
// value tile (as loaded), raw bf16 keys, p, alpha and l.
template <typename T, int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kRows * D + (size_t)kTile * (D + kKeyPad) + kRows * kTile +
                          2 * kRows) +
         sizeof(T) * kTile * (DV + (sizeof(T) == sizeof(float) ? 0 : D));
}

// One block of any form: keys and queries of width D whose trailing RD
// dims rotate, values of width DV; EMIT writes the rotated k and the v.
// CHUNK (the chunked GQA form): the q rows and the chunk's keys sit at the
// slot's offset tr.lengths[b] + t (cos / sin are per-slot tables (B, S,
// RD / 2)), and the slot's hot tier's, then its cold tier's 32-key tiles
// are folded before the chunk's own, for every row and without rotation.
// PAGED (chunked form only): the cold tier's rows come through the page
// table. SWA: the window mask a.window and, chunked, the ring tr.ring.
template <typename T, typename TT, int D, int DV, int RD, bool EMIT, bool CHUNK,
          bool PAGED = false, bool SWA = false>
__device__ __forceinline__ void prefill_body(const PrefillArgs<T, TT>& a, const TierArgs<TT>& tr,
                                             int n_qb, float* smem) {
  constexpr int KS = D + kKeyPad;  // staged key row stride (words)
  constexpr bool kF32 = sizeof(T) == sizeof(float);
  constexpr int KRS = kF32 ? KS : D;  // raw key row stride (elements of T)
  constexpr int CH = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int KC = D / CH, VC = DV / CH;  // copies per key / value row
  constexpr int OFF = D - RD, HALF = RD / 2;  // the rotated span
  constexpr int PQ = OFF / 4;   // 4-dim quads of a row that pass through
  constexpr int NQ = PQ + RD / 8;  // + quads of the span's first half
  constexpr int VQ = DV / 4;    // 4-dim quads in a value row
  // P.V: thread t owns output dims t % DVT (+ DVT, ...) of RPT rows
  constexpr int DVT = DV < kThreads ? DV : kThreads;
  constexpr int U = DV / DVT;
  constexpr int RG = kThreads / DVT;  // row groups; those past kRows idle
  constexpr int RPT = kRows >= RG ? kRows / RG : 1;
  static_assert(D % CH == 0 && DV % CH == 0 && OFF % 4 == 0 && RD % 8 == 0 && HALF % 4 == 0,
                "head width unsupported");
  static_assert((kRows < RG || RPT * RG == kRows) && U * DVT == DV, "value width unsupported");
  static_assert(!EMIT || D == DV, "the emitting form has DV = D");
  static_assert(!CHUNK || (EMIT && RD == D), "the chunked form is the GQA form");
  static_assert(CHUNK || !PAGED, "only the chunked form reads a paged tier");
  static_assert(!SWA || (EMIT && RD == D && !PAGED), "the window forms are the GQA forms");
  float* q_s = smem;                           // [kRows][D], rotated
  float* k_s = q_s + kRows * D;                // [kTile][KS], rotated
  T* v_s = reinterpret_cast<T*>(k_s + kTile * KS);  // [kTile][DV], as loaded
  T* kr_s = v_s + kTile * DV;  // [kTile][KRS] raw keys: k_s itself for f32
  if constexpr (kF32) kr_s = reinterpret_cast<T*>(k_s);
  float* p_s = reinterpret_cast<float*>(v_s + kTile * DV + (kF32 ? 0 : kTile * D));  // [kRows][kTile]
  float* alpha_s = p_s + kRows * kTile;  // [kRows]
  float* l_s = alpha_s + kRows;          // [kRows]

  const int S = a.S, G = a.G, rep = a.rep, H = G * rep;
  // the grid runs in chunks of kChunk (group, slot) pairs, each with its
  // longest q blocks first, so that a pair's key tiles, which each of its q
  // blocks reads, are still in L2 when the next one does
  const int n_gb = gridDim.x / n_qb;  // (group, slot) pairs
  const int chunk0 = (int)(blockIdx.x / (kChunk * n_qb)) * kChunk;  // the chunk's first pair
  const int cn = min(kChunk, n_gb - chunk0), i = (int)blockIdx.x - chunk0 * n_qb;
  const int qb = n_qb - 1 - i / cn, g = (chunk0 + i % cn) % G, b = (chunk0 + i % cn) / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = qb * kRows;  // first row: token row0 / rep, head row0 % rep
  const int nv = min(a.valid[b], S);
  auto head_row = [&](int tok, int rr) { return ((int64_t)b * S + tok) * H + g * rep + rr; };
  auto kv_row = [&](int tok) { return ((int64_t)b * S + tok) * G + g; };
  // RoPE tables: by chunk row in the slot's own table, or by token
  const int64_t tab0 = CHUNK ? (int64_t)b * S : 0;
  auto cos_of = [&](int tok) { return a.cos + (tab0 + tok) * HALF; };
  auto sin_of = [&](int tok) { return a.sin + (tab0 + tok) * HALF; };
  // CHUNK: the slot's cached tokens, which sit before the chunk's rows
  const int offset = CHUNK ? tr.lengths[b] : 0;

  const int q_hi = (min(row0 + kRows, S * rep) - 1) / rep;  // last token of the block
  const int kv_end = min(q_hi + 1, nv);
  // CHUNK: the block folds the absolute tiles of [tiers ‖ chunk] that hold
  // a key up to its last row's diagonal (the tiers' keys precede every row)
  const int n_abs = CHUNK ? (offset + kv_end + kTile - 1) / kTile : 0;
  // SWA: the first tile holding a key in the window of the block's first
  // row (absolute position offset + row0 / rep); earlier ones are skipped
  const int win = SWA ? a.window : 0;
  const int t_lo = win > 0 ? max(offset + row0 / rep - win + 1, 0) / kTile : 0;
  const int kv_lo = CHUNK ? 0 : t_lo * kTile;  // fresh form: the first key tile
  // SWA, chunked over a ring: a cold position below offset - cold_cap has
  // been evicted from the ring
  const bool ring = SWA && CHUNK && tr.ring;
  auto held = [&](int pos) {
    return pos >= offset || pos < tr.hot_cap || !ring || pos >= offset - tr.cold_cap;
  };
  // the raw keys (up to the diagonal) and values (of the keys that exist)
  // of the tile starting at `start`, every copy in flight at once
  auto copy_tile = [&](int start) {
    const int n_load = min(kTile, nv - start), n_k = min(kTile, kv_end - start);
    for (int e = tid; e < (VC == KC ? n_load : n_k) * KC; e += kThreads) {
      const int j = e / KC, c = CH * (e % KC);
      if (j < n_k) cp_async16(kr_s + j * KRS + c, a.k + kv_row(start + j) * D + c);
      if constexpr (VC == KC) cp_async16(v_s + j * DV + c, a.v + kv_row(start + j) * DV + c);
    }
    if constexpr (VC != KC) {
      for (int e = tid; e < n_load * VC; e += kThreads) {
        const int j = e / VC, c = CH * (e % VC);
        cp_async16(v_s + j * DV + c, a.v + kv_row(start + j) * DV + c);
      }
    }
  };
  // CHUNK: absolute tile ti, positions 32 ti + j of the slot's [tiers ‖
  // chunk]: a position below the offset is a tier row (hot below hot_cap,
  // else cold, through the page table when PAGED), already rotated; one
  // at or past it is chunk row pos - offset, raw (its key only up to the
  // block's diagonal, its value if it exists)
  auto copy_abs = [&](int ti) {
    const int start = ti * kTile;
    for (int e = tid; e < kTile * KC; e += kThreads) {
      const int j = e / KC, c = CH * (e % KC), pos = start + j;
      if (pos < offset) {
        if (!held(pos)) continue;  // evicted: no key, its value zeroed below
        const bool hot = pos < tr.hot_cap;
        const int tp = hot ? pos : (ring ? (pos - tr.hot_cap) % tr.cold_cap : pos - tr.hot_cap);
        int64_t slot_row = (int64_t)b * (hot ? tr.hot_cap : tr.cold_cap) + tp;
        if constexpr (PAGED) {
          if (!hot) slot_row = (int64_t)tr.page_table[(int64_t)b * tr.pps + tp / tr.ps] * tr.ps + tp % tr.ps;
        }
        const int64_t row = slot_row * G + g;
        const TT* ks = (hot ? tr.hot_k : tr.cold_k) + row * D + c;
        const TT* vs = (hot ? tr.hot_v : tr.cold_v) + row * DV + c;
        if constexpr (sizeof(TT) == sizeof(T)) {
          cp_async16(kr_s + j * KRS + c, ks);
          cp_async16(v_s + j * DV + c, vs);
        } else {  // fp8 tiers: loaded and upcast here, in place of the copy
          stage_fp8(kr_s + j * KRS + c, ks);
          stage_fp8(v_s + j * DV + c, vs);
        }
      } else {
        const int ci = pos - offset;
        if (ci < kv_end) cp_async16(kr_s + j * KRS + c, a.k + kv_row(ci) * D + c);
        if (ci < nv) cp_async16(v_s + j * DV + c, a.v + kv_row(ci) * DV + c);
      }
    }
  };
  if constexpr (CHUNK) {
    if (n_abs > t_lo) copy_abs(t_lo);  // lands while the prologue runs
  } else if (kv_end > kv_lo) {
    copy_tile(kv_lo);
  }

  // ---- prologue: rotate this block's q rows ----
#pragma unroll 2
  for (int e = tid; e < kRows * NQ; e += kThreads) {
    const int r = e / NQ, c = e % NQ, tok = (row0 + r) / rep;
    const T* x = a.q + head_row(tok, (row0 + r) % rep) * D;
    float* qr = q_s + r * D;
    if (PQ > 0 && c < PQ) {
      F4 y = {};
      if (tok < S) y = load4(x + 4 * c);
      store4(qr + 4 * c, y);
    } else {
      const int i = 4 * (c - PQ);
      F4 lo = {}, hi = {};
      if (tok < S) rope_quad<OFF, HALF>(x, i, cos_of(tok), sin_of(tok), lo, hi);
      store4(qr + OFF + i, lo);
      store4(qr + OFF + HALF + i, hi);
    }
  }
  // GQA: the tokens this block emits are those whose head-0 row lies in it;
  // the valid ones are copied from the staged tiles, the rest zeroed here
  const int t0 = (row0 + rep - 1) / rep;
  const int t1 = min((row0 + kRows - 1) / rep + 1, S);  // one past the last
  if constexpr (EMIT) {
    for (int e = tid; e < (t1 - max(t0, nv)) * VQ; e += kThreads) {
      const int tok = max(t0, nv) + e / VQ, i = 4 * (e % VQ);
      const F4 zero = {};
      emit4<T, true>(a.k_cast + kv_row(tok) * D + i, zero);
      emit4<T, false>(a.v_cast + kv_row(tok) * DV + i, zero);
    }
  }
  if (tid < kRows) l_s[tid] = 0.f;
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) m[rr] = kNegInf, l[rr] = 0.f;
  float acc[RPT][U];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
#pragma unroll
    for (int u = 0; u < U; ++u) acc[k][u] = 0.f;
  __syncthreads();

  // Fold the staged tile into every row: logits and the online softmax
  // (lane = key, the warp's rows), then acc = acc * alpha + tile_sum(p * v).
  // live(lane, tok): row tok sees key `lane` of the tile.
  auto fold_staged = [&](auto live) {
    {  // logits and the online softmax: lane = key, the warp's rows
      float dots[kRowsPerWarp];
      dot_rows<D, kRowsPerWarp>(q_s + warp * kRowsPerWarp * D, k_s + lane * KS, dots);
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr, tok = (row0 + r) / rep;
        const float logit = __fmul_rn(dots[rr], a.scale);
        const bool ok = live(lane, tok) && tok < S;
        float mt = ok ? logit : kNegInf;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[rr], mt);
        const float alpha = expf(__fsub_rn(m[rr], m_new));
        const float p = ok ? expf(__fsub_rn(logit, m_new)) : 0.f;
        float sum = p;  // xor butterfly = the halving tree over the lanes
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
        l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha), sum);
        m[rr] = m_new;
        p_s[r * kTile + lane] = p;
        if (lane == 0) alpha_s[r] = alpha, l_s[r] = l[rr];
      }
    }
    __syncthreads();
    if (tid / DVT * RPT < kRows) {  // acc = acc * alpha + tile_sum(p * v)
      const int dcol = tid % DVT, rg = tid / DVT;
#pragma unroll 1
      for (int u = 0; u < U; ++u) {
        float vv[kTile];
#pragma unroll
        for (int j = 0; j < kTile; ++j) vv[j] = to_f32(v_s[j * DV + dcol + u * DVT]);
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
  };

  // ---- CHUNK: the absolute tiles of [tiers ‖ chunk] ----
  for (int ti = t_lo; CHUNK && ti < n_abs; ++ti) {
    const int start = ti * kTile, c0 = start - offset;  // c0: the tile's first chunk row
    if (ti > t_lo) copy_abs(ti);
    cp_async_wait_all();
    __syncthreads();
    // stage the keys in k_s: a chunk row rotated at its own table, a tier
    // row as stored (a bf16 one widened; f32 rows landed in k_s), the rest
    // zeroed; zero the values of the keys that do not exist
#pragma unroll 4
    for (int e = tid; e < kTile * (HALF / 4); e += kThreads) {
      const int j = e / (HALF / 4), i = 4 * (e % (HALF / 4)), ci = c0 + j;
      F4 lo = {}, hi = {};
      if (ci < 0) {
        if constexpr (kF32) continue;
        lo = load4(kr_s + j * KRS + i);
        hi = load4(kr_s + j * KRS + HALF + i);
      } else if (ci < kv_end) {
        rope_quad<0, HALF>(kr_s + j * KRS, i, cos_of(ci), sin_of(ci), lo, hi);
      }
      store4(k_s + j * KS + i, lo);
      store4(k_s + j * KS + HALF + i, hi);
    }
    for (int e = tid; e < kTile * VQ; e += kThreads) {
      const int j = e / VQ;
      if (c0 + j >= nv || !held(start + j)) {
        const F4 zero = {};
        store4(v_s + j * DV + 4 * (e % VQ), zero);
      }
    }
    __syncthreads();
    {  // the block's valid tokens in this tile: rotated k, v as loaded
      const int e0 = max(t0, c0), e1 = min(min(t1, nv), c0 + kTile);
      for (int e = tid; e < (e1 - e0) * VQ; e += kThreads) {
        const int tok = e0 + e / VQ, j = tok - c0, i = 4 * (e % VQ);
        emit4<T, true>(a.k_cast + kv_row(tok) * D + i, load4(k_s + j * KS + i));
        emit4<T, false>(a.v_cast + kv_row(tok) * DV + i, load4(v_s + j * DV + i));
      }
    }
    fold_staged([&](int key, int tok) {
      return c0 + key < nv && c0 + key <= tok && held(start + key) &&
             (win <= 0 || tok - (c0 + key) < win);
    });
  }

  // ---- stream key tiles up to the block's diagonal and the valid count ----
  for (int start = kv_lo; !CHUNK && start < kv_end; start += kTile) {
    const int n_load = min(kTile, nv - start);  // keys of the tile that exist
    const int n_k = min(kTile, kv_end - start);  // keys staged
    if (start > kv_lo) copy_tile(start);
    cp_async_wait_all();
    __syncthreads();
    // stage the keys in k_s: rotate the span (in place for f32), widen the
    // rest of a bf16 row; zero the span of the rows not staged and the
    // values of the keys that do not exist
    constexpr int SQ = kF32 ? NQ - PQ : NQ;  // quads staged per key row
#pragma unroll 4
    for (int e = tid; e < kTile * SQ; e += kThreads) {
      const int j = e / SQ, c = e % SQ + (NQ - SQ), tok = start + j;
      if (PQ > 0 && c < PQ) {
        F4 y = {};
        if (j < n_k) y = load4(kr_s + j * KRS + 4 * c);
        store4(k_s + j * KS + 4 * c, y);
      } else {
        const int i = 4 * (c - PQ);
        F4 lo = {}, hi = {};
        if (j < n_k) rope_quad<OFF, HALF>(kr_s + j * KRS, i, cos_of(tok), sin_of(tok), lo, hi);
        store4(k_s + j * KS + OFF + i, lo);
        store4(k_s + j * KS + OFF + HALF + i, hi);
      }
    }
    for (int e = tid; e < (kTile - n_load) * VQ; e += kThreads) {
      const F4 zero = {};
      store4(v_s + (n_load + e / VQ) * DV + 4 * (e % VQ), zero);
    }
    __syncthreads();
    if constexpr (EMIT) {  // the block's valid tokens in this tile: rotated k, v as loaded
      const int e0 = max(t0, start), e1 = min(t1, start + n_load);
      for (int e = tid; e < (e1 - e0) * VQ; e += kThreads) {
        const int tok = e0 + e / VQ, j = tok - start, i = 4 * (e % VQ);
        emit4<T, true>(a.k_cast + kv_row(tok) * D + i, load4(k_s + j * KS + i));
        emit4<T, false>(a.v_cast + kv_row(tok) * DV + i, load4(v_s + j * DV + i));
      }
    }
    fold_staged([&](int key, int tok) {
      return start + key < nv && start + key <= tok && (win <= 0 || tok - (start + key) < win);
    });
  }

  // ---- epilogue ----
  const int dcol = tid % DVT, rg = tid / DVT;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = rg * RPT + k, tok = (row0 + r) / rep;
    if (r >= kRows || tok >= S) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* o = a.out + head_row(tok, (row0 + r) % rep) * DV + dcol;
#pragma unroll
    for (int u = 0; u < U; ++u) store(o + u * DVT, acc[k][u] / den);
  }
}

template <typename T, typename TT, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gqa_prefill_kernel(PrefillArgs<T, TT> a, int n_qb) {
  extern __shared__ __align__(16) float smem[];
  prefill_body<T, TT, D, D, D, true, false>(a, TierArgs<TT>{}, n_qb, smem);
}

template <typename T, typename TT, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gqa_chunk_kernel(PrefillArgs<T, TT> a, TierArgs<TT> tr, int n_qb) {
  extern __shared__ __align__(16) float smem[];
  prefill_body<T, TT, D, D, D, true, true>(a, tr, n_qb, smem);
}

template <typename T, typename TT, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gqa_chunk_paged_kernel(PrefillArgs<T, TT> a, TierArgs<TT> tr, int n_qb) {
  extern __shared__ __align__(16) float smem[];
  prefill_body<T, TT, D, D, D, true, true, true>(a, tr, n_qb, smem);
}

template <typename T, typename TT, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gqa_window_kernel(PrefillArgs<T, TT> a, int n_qb) {
  extern __shared__ __align__(16) float smem[];
  prefill_body<T, TT, D, D, D, true, false, false, true>(a, TierArgs<TT>{}, n_qb, smem);
}

template <typename T, typename TT, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gqa_chunk_ring_kernel(PrefillArgs<T, TT> a, TierArgs<TT> tr, int n_qb) {
  extern __shared__ __align__(16) float smem[];
  prefill_body<T, TT, D, D, D, true, true, false, true>(a, tr, n_qb, smem);
}

template <typename T, int D, int DV, int RD>
__global__ void __launch_bounds__(kThreads, kMlaMinBlocks) mla_prefill_kernel(PrefillArgs<T> a, int n_qb) {
  extern __shared__ __align__(16) float smem[];
  prefill_body<T, T, D, DV, RD, false, false>(a, TierArgs<T>{}, n_qb, smem);
}

// One kernel instance K over (q block, group, slot), called with a, the
// extra arguments and n_qb; its shared-memory attribute is set once per
// device.
template <typename T, int D, int DV, auto K, typename TT = T, typename... Extra>
cudaError_t launch_blocks(const PrefillArgs<T, TT>& a, int B, cudaStream_t stream,
                          const Extra&... extra) {
  constexpr size_t smem = smem_bytes<T, D, DV>();
  static unsigned long long attribute_set = 0;  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !((attribute_set >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) attribute_set |= 1ull << dev;
  }
  const int n_qb = (a.S * a.rep + kRows - 1) / kRows;
  const long long blocks = (long long)n_qb * a.G * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  K<<<(unsigned)blocks, kThreads, smem, stream>>>(a, extra..., n_qb);
  return cudaGetLastError();
}

// GQA heads (DV = D = RD) on gqa_prefill_kernel, or on gqa_window_kernel
// with a window.
template <typename T, typename TT, int D, bool SWA>
cudaError_t launch_gqa_d(const PrefillArgs<T, TT>& a, int B, cudaStream_t stream) {
  if constexpr (SWA) {
    return launch_blocks<T, D, D, gqa_window_kernel<T, TT, D>>(a, B, stream);
  } else {
    return launch_blocks<T, D, D, gqa_prefill_kernel<T, TT, D>>(a, B, stream);
  }
}

template <typename T, bool SWA = false, typename TT>
cudaError_t launch_gqa(const PrefillArgs<T, TT>& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_gqa_d<T, TT, 16, SWA>(a, B, stream);
    case 32: return launch_gqa_d<T, TT, 32, SWA>(a, B, stream);
    case 64: return launch_gqa_d<T, TT, 64, SWA>(a, B, stream);
    case 128: return launch_gqa_d<T, TT, 128, SWA>(a, B, stream);
    case 256: return launch_gqa_d<T, TT, 256, SWA>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The chunked GQA form on gqa_chunk_kernel, on gqa_chunk_paged_kernel over
// a paged cold tier, or on gqa_chunk_ring_kernel with a window or ring.
template <typename T, typename TT, int D, bool PAGED, bool SWA>
cudaError_t launch_chunk_d(const PrefillArgs<T, TT>& a, const TierArgs<TT>& tr, int B,
                           cudaStream_t stream) {
  if constexpr (SWA) {
    return launch_blocks<T, D, D, gqa_chunk_ring_kernel<T, TT, D>>(a, B, stream, tr);
  } else if constexpr (PAGED) {
    return launch_blocks<T, D, D, gqa_chunk_paged_kernel<T, TT, D>>(a, B, stream, tr);
  } else {
    return launch_blocks<T, D, D, gqa_chunk_kernel<T, TT, D>>(a, B, stream, tr);
  }
}

template <typename T, bool PAGED = false, bool SWA = false, typename TT>
cudaError_t launch_chunk(const PrefillArgs<T, TT>& a, const TierArgs<TT>& tr, int B, int D,
                         cudaStream_t stream) {
  switch (D) {
    case 16: return launch_chunk_d<T, TT, 16, PAGED, SWA>(a, tr, B, stream);
    case 32: return launch_chunk_d<T, TT, 32, PAGED, SWA>(a, tr, B, stream);
    case 64: return launch_chunk_d<T, TT, 64, PAGED, SWA>(a, tr, B, stream);
    case 128: return launch_chunk_d<T, TT, 128, PAGED, SWA>(a, tr, B, stream);
    case 256: return launch_chunk_d<T, TT, 256, PAGED, SWA>(a, tr, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// (D, DV, RD) of the MLA form: DeepSeek-V3 (192, 128, 64) and its smoke
// config (24, 16, 8), on mla_prefill_kernel.
template <typename T>
cudaError_t launch_mla(const PrefillArgs<T>& a, int B, int D, int DV, int RD, cudaStream_t stream) {
  if (D == 192 && DV == 128 && RD == 64)
    return launch_blocks<T, 192, 128, mla_prefill_kernel<T, 192, 128, 64>>(a, B, stream);
  if (D == 24 && DV == 16 && RD == 8)
    return launch_blocks<T, 24, 16, mla_prefill_kernel<T, 24, 16, 8>>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
