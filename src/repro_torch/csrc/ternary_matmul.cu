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
// What bounds each shape on this card:
//  * Decode (M = 6 for falcon3-1b, C = 1 per expert for DeepSeek-V3): the
//    packed weights are the only large operand (K*N/4 bytes in pack2,
//    K*N/5 in pack243) and each byte serves M rows only, so the bound is
//    the bytes. In the way: the integer work per byte (trit decode plus,
//    on CUDA cores, one __dp4a per row: measured on the H100, each extra
//    row costs as much as the whole byte stream at M = 1), filling the
//    card when N is small (falcon3-1b's wo and down are 16 tiles of 128),
//    and a fixed latency per block (scales, staging, barriers, about
//    7-10 us a launch) that only enough bytes per block amortize.
//  * Prefill (M = 192, or C = 8 per expert): the int8 multiply-adds
//    (2 * M * K * N) and, for raw activations, quantizing x once per
//    column tile.
//
// Three cores share the prologue, the staging and the epilogue; the
// launcher picks one from M (or C) and the codec:
//  * ternary_kernel, CUDA cores, one row (expert and 2-D decode at M = 1):
//    a thread owns 16 neighbouring columns (one 16-byte load per K group),
//    trits decode in registers and each group of four codes x four trits
//    is one __dp4a.
//  * ternary_mv_kernel, tensor cores, pack2 up to 8 rows (falcon3-1b's
//    decode, M = 6; the expert prefill, C = 8): the weights are the A
//    operand of mma.sync m16n8k32 s8, decoded in registers straight into
//    its fragments, and the rows' codes are the n8 operand, so neither the
//    per-row __dp4a work nor a shared-memory copy of the weights exists.
//  * ternary_tc_kernel, tensor cores, 64 x 128 tiles (prefill; pack243
//    from 2 rows): the chunk's codes and decoded trits go through shared
//    memory into mma.sync fragments.
//
// Design, each point against what held the first version back:
//  1. K is staged in chunks (256 K groups, 32 in the 64-row core). Only one
//     chunk's codes sit in shared memory (at most 8 KiB of codes, plus
//     the trits in the 64-row core), so shared memory no longer grows with
//     K and any K is taken. Loads go out ahead of use: the 64-row core
//     loads the next chunk's weights and x while the current chunk is
//     multiplied; the other two load a chunk's weights (the register-fed
//     core also its x) before its codes are staged, the first chunk's
//     before the scales are found.
//  2. The row tile fits the rows present: one row (the __dp4a core) at
//     expert decode; eight, the mma's n8, at falcon3-1b's decode, where the
//     two masked rows cost no instruction of their own; 64 at prefill,
//     where m16 tiles past the live rows are skipped. Rows past M read zero
//     codes and are not stored.
//  3. The card is filled at decode by split-K across a thread-block cluster
//     of cs blocks, with no workspace and no extra launch: (a) every block
//     of a cluster takes the absmax of its rows over its 1/cl share of K
//     and the cluster combines the partial maxima through distributed
//     shared memory (max is exact in any order); in the 64-row core a
//     cluster also spans up to 8 column tiles, which then share one sweep;
//     (b) each block sums its int32 partials in shared memory, and after a
//     cluster barrier each of a tile's cs blocks reduces and stores 1/cs
//     of the tile. The launcher splits K only while the grid still fits in
//     one wave of resident blocks and every block keeps 256 K groups (128
//     in the 64-row core): measured on the H100, a second wave or a thinner
//     block costs more than it spreads.
//     Cost of the absmax sweep: each cluster reads its rows' x from L2
//     once (falcon3-1b's down at decode: 16 clusters x 6 rows x 32 KiB =
//     3 MiB beside 4 MiB of weights), with 16-byte loads, eight in flight,
//     where the row is 16-byte aligned.
//  4. Weight loads are coalesced 16-byte loads: neighbouring threads read
//     neighbouring bytes of a packed row. Trits decode with bit arithmetic,
//     no table: two PRMTs turn a pack2 byte into its four trits as int8
//     lanes (Pack2Word; in the order t0 t2 t1 t3, and the codes are staged
//     in that order); pack243 bytes split into
//     base-3 digits two columns at a time in 16-bit lanes ((r * 171) >> 9 is
//     r / 3 for r < 256), and the digits (0..2) either go into __dp4a with
//     the sum of the codes subtracted once, or become trits in the byte
//     lanes before the mma.
//  5. Tensor cores: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. The
//     int32 accumulation is exact (|acc| <= 128 K), so it stays
//     bit-identical. wgmma and a persistent producer / consumer layout are
//     later work.
//
// Exactness: the accumulator is an int32, so every order of summation
// (k lanes, warps, mma, cluster ranks) gives the same value. The epilogue
// kScaled divides the column scale by the row scale and then multiplies,
// the reference's order; kInt32 stores the accumulator itself. Codes round
// with rintf (half to even, like jnp.round and torch.round). Activation
// columns at or past the true K read as zero, which is how a pack243
// weight's padding trits drop out; rows past M and columns past N are
// masked, nothing is padded. A row of zero codes (an expert slot with no
// token) gives exact zeros.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;                  // columns per block
constexpr int kChunk = 256;              // K groups staged at a time
constexpr int kMaxCluster = 8;           // split-K ways (portable cluster size)
constexpr float kEps = 1e-5f;

enum Prologue { kActQuant, kCodes };
enum Epilogue { kScaled, kInt32 };

// The __dp4a core's thread layout: a thread owns 16 neighbouring columns
// (one 16-byte load per K group) of 4 column lanes, and every 64th group.
constexpr int kCols = 16;                      // columns per thread
constexpr int kWords = kCols / 4;              // 32-bit words per load
constexpr int kColLanes = kBN / kCols;         // threads across the columns
constexpr int kKLanes = kThreads / kColLanes;  // threads across the K groups
constexpr int kPerLane = kChunk / kKLanes;     // groups per thread per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// pack2: four bytes (columns 0-3 of a word) -> each column's trits as
// int8 lanes in the order (t0, t2, t1, t3), two PRMTs a column. Code c of
// trit i sits in bits 2i..2i+1 of its byte (0 -> 0, 1 -> +1, 2 -> -1,
// 3 -> 0); lo / hi hold codes 0 and 2 / 1 and 3 of every byte, one per
// nibble, the first PRMT gathers column j's four nibbles into a selector
// and the second picks byte c of 0x00FF0100 for each. The codes are staged
// in the same order.
struct Pack2Word {
  uint32_t lo, hi;
  __device__ __forceinline__ explicit Pack2Word(uint32_t w)
      : lo(w & 0x33333333u), hi((w >> 2) & 0x33333333u) {}
  __device__ __forceinline__ int trits(int j) const {
    return (int)__byte_perm(0x00FF0100u, 0u, __byte_perm(lo, hi, j | (j + 4) << 4));
  }
};

// pack243: four bytes (columns 0-3 of w) -> per column the base-3 digits
// 0-3 as uint8 lanes (lo) and digit 4 (hi). Digit i of byte v is
// (v / 3^i) % 3, the plain version's divmod (so trit = digit - 1); two
// columns ride in the 16-bit lanes of one word, where (r * 171) >> 9 is
// r / 3 for r < 256 and no lane carries into the next.
__device__ __forceinline__ void decode243(uint32_t w, int (&lo)[4], int (&hi)[4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // p = 0: columns 0 and 2; p = 1: columns 1 and 3
    uint32_t r = (w >> (8 * p)) & 0x00FF00FFu;
    uint32_t d[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uint32_t q = ((r * 171u) >> 9) & 0x007F007Fu;
      d[i] = r - 3u * q;
      r = q;
    }
    const uint32_t a = __byte_perm(d[0], d[1], 0x6240);  // (d0, d1) of both columns
    const uint32_t b = __byte_perm(d[2], d[3], 0x6240);  // (d2, d3) of both columns
    lo[p] = (int)__byte_perm(a, b, 0x5410);
    lo[p + 2] = (int)__byte_perm(a, b, 0x7632);
    hi[p] = (int)(d[4] & 0xFFu);
    hi[p + 2] = (int)(d[4] >> 16);
  }
}

struct Args {
  const void* x;         // (E, M, K): raw f32/bf16 (kActQuant) or int8 codes (kCodes)
  const float* x_scale;  // (E, M): the codes' row scale (kCodes + kScaled only)
  const uint8_t* packed;  // (E, KG, N)
  const float* col_scale;  // (E, N) (kScaled only)
  void* out;             // (E, M, N): f32 (kScaled) or int32 (kInt32)
  int M, K, KG, N;
  float qmax, qmin;
  int splits;  // K split over this many blocks of a cluster (set by the launcher)
};

// This block's place. A cluster of cl blocks holds cl / cs column tiles,
// each split over K across cs = Args::splits neighbouring ranks; all of its
// blocks share the rows (blockIdx.y, z), so they share the absmax sweep.
struct Place {
  cg::cluster_group cluster;
  int cl, rank, cs, split, tile;
  __device__ explicit Place(int splits) : cluster(cg::this_cluster()) {
    cl = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
    cs = splits;
    split = rank % cs;
    tile = (int)(blockIdx.x / cl) * (cl / cs) + rank / cs;
  }
  // this block's K groups [lo, hi)
  __device__ void groups(int KG, int& lo, int& hi) const {
    const int per = (KG + cs - 1) / cs;
    lo = min(KG, split * per);
    hi = min(KG, lo + per);
  }
  __device__ void sync() {
    if (cl > 1) cluster.sync(); else __syncthreads();
  }
  // the sum over this tile's cs blocks of the int at p in each one's smem
  __device__ int tile_sum(int* p) {
    int s = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < cs) s += *cluster.map_shared_rank(p, rank - split + q);
    return s;
  }
};

// Largest |x| over elements [k0, k1) of one row, lanes t, t + stride, ...;
// 16-byte loads, eight in flight, over the aligned middle when ``vec``.
// The larger of two magnitudes (non-negative floats, or a NaN with its sign
// cleared by fabsf) as an integer max of their bits: for non-negative
// floats integer order is float order, so every finite and infinite result
// is fmaxf's bit for bit, and a NaN's bits order above +inf, so a NaN row
// keeps its NaN absmax (fmaxf would drop it). The plain version's
// torch.amax propagates NaN the same way, so a NaN row's scale, and with it
// the row's output, is NaN in both. Branch-free: one integer max.
__device__ __forceinline__ float abs_max(float a, float b) {
  return __int_as_float(max(__float_as_int(a), __float_as_int(b)));
}

template <typename T>
__device__ float absmax_range(const T* row, int k0, int k1, int t, int stride, bool vec) {
  constexpr int V = 16 / sizeof(T);
  float m = 0.f;
  int a0 = k0, a1 = k0;
  if (vec) {
    a0 = min(k1, (k0 + V - 1) / V * V);
    a1 = max(a0, k1 / V * V);
    const uint4* v = reinterpret_cast<const uint4*>(row);
    const int end = a1 / V;
    for (int i = a0 / V + t; i < end; i += 8 * stride) {
      uint4 u[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        u[j] = i + j * stride < end ? v[i + j * stride] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* el = reinterpret_cast<const T*>(&u[j]);
#pragma unroll
        for (int q = 0; q < V; ++q) m = abs_max(m, fabsf(to_f32(el[q])));
      }
    }
  }
  for (int k = k0 + t; k < a0; k += stride) m = abs_max(m, fabsf(to_f32(row[k])));
  for (int k = a1 + t; k < k1; k += stride) m = abs_max(m, fabsf(to_f32(row[k])));
  return m;
}

// The row scales of rows [m0, m0 + R) into row_scale: kActQuant takes the
// absmax of each row over this block's 1/cl share of K, combines the
// cluster's partial maxima through distributed shared memory (max is
// exact in any order) and divides qmax by it; kCodes reads the caller's
// scale (masked rows divide by 1). Ends with the block synchronised.
template <typename T, int PRO, int EPI, int R>
__device__ void row_scales(const Args& a, const T* x, int64_t e, int m0, int live, Place& pl,
                           int* amax_bits, float* row_scale) {
  if constexpr (PRO == kActQuant) {
    const int per = (a.K + pl.cl - 1) / pl.cl;
    const int k0 = min(a.K, pl.rank * per), k1 = min(a.K, k0 + per);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    constexpr int P = R >= kWarps ? 1 : kWarps / R;  // warps per row
    const bool vec = a.K % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
    for (int r = warp / P; r < R; r += kWarps / P) {
      float amax = 0.f;
      if (r < live)
        amax = absmax_range(x + (int64_t)(m0 + r) * a.K, k0, k1, (warp % P) * 32 + lane, 32 * P,
                            vec);
#pragma unroll
      for (int o = 16; o; o >>= 1) amax = abs_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) atomicMax(&amax_bits[r], __float_as_int(amax));  // abs_max's int order
    }
    pl.sync();
    for (int r = threadIdx.x; r < R; r += kThreads) {
      float m = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < pl.cl)
          m = abs_max(m, __int_as_float(*pl.cluster.map_shared_rank(&amax_bits[r], q)));
      row_scale[r] = a.qmax / abs_max(m, kEps);  // a NaN absmax: a NaN scale
    }
  } else if constexpr (EPI == kScaled) {
    for (int r = threadIdx.x; r < R; r += kThreads)
      row_scale[r] = r < live ? a.x_scale[e * a.M + m0 + r] : 1.f;
  }
  __syncthreads();
}

// A group's raw values: floats for the act-quant prologue, the given codes
// as ints otherwise.
template <int PRO>
using Raw = std::conditional_t<PRO == kActQuant, float, int>;

template <int PRO, typename T>
__device__ __forceinline__ Raw<PRO> raw(T v) {
  if constexpr (PRO == kActQuant) return to_f32(v); else return (int)v;
}

// The raw values of one K group, elements k0 .. k0 + G - 1 of a row (zero
// at or past K); one vector load of the group when ``vec`` (pack2, rows
// 16-byte aligned).
template <typename T, int G, int PRO>
__device__ __forceinline__ void load_group(const T* row, int k0, int K, bool vec,
                                           Raw<PRO> (&v)[G]) {
  if (G == 4 && vec && k0 + 4 <= K) {
    T t[4];
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(t) = *reinterpret_cast<const float4*>(row + k0);
    } else if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint2*>(t) = *reinterpret_cast<const uint2*>(row + k0);
    } else {
      *reinterpret_cast<int*>(t) = *reinterpret_cast<const int*>(row + k0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = raw<PRO>(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) v[i] = k0 + i < K ? raw<PRO>(row[k0 + i]) : Raw<PRO>(0);
  }
}

// A group's int8 codes (the act-quant rule, or the given codes): codes 0-3
// as the bytes of the returned word (pack2 in the order 0 2 1 3, Pack2Word's),
// code 4 in ``fifth``.
template <int G, int PRO>
__device__ __forceinline__ int group_word(const Raw<PRO> (&v)[G], float scale, const Args& a,
                                          int& fifth) {
  int q[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if constexpr (PRO == kActQuant)
      q[i] = (int)fminf(fmaxf(rintf(v[i] * scale), a.qmin), a.qmax);
    else
      q[i] = v[i];
  }
  fifth = G == 5 ? q[G - 1] : 0;
  const int b1 = G == 4 ? q[2] : q[1], b2 = G == 4 ? q[1] : q[2];
  return (q[0] & 0xff) | (b1 & 0xff) << 8 | (b2 & 0xff) << 16 | (q[3] & 0xff) << 24;
}

template <typename T, int G, int PRO>
__device__ __forceinline__ int group_codes(const T* row, int k0, int K, bool vec, float scale,
                                           const Args& a, int& fifth) {
  Raw<PRO> v[G];
  load_group<T, G, PRO>(row, k0, K, vec, v);
  return group_word<G, PRO>(v, scale, a, fifth);
}

// The four words of one thread's 16 columns [n0, n0 + 16) of one packed
// row, one streaming 16-byte load when ``vec``; columns past N read 0
// (their sums are never stored).
__device__ __forceinline__ void load_cols(const uint8_t* prow, int n0, int N, bool vec,
                                          uint32_t (&w)[4]) {
  if (vec && n0 + 16 <= N) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(prow + n0));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int n = n0 + 4 * i + b;
        if (n < N) v |= (uint32_t)prow[n] << (8 * b);
      }
      w[i] = v;
    }
  }
}

// The epilogue of one output: the column scale divided by the row scale,
// then times the accumulator (the reference's order), or the int32 itself.
template <int EPI>
__device__ __forceinline__ void store_out(const Args& a, int64_t e, int m, int n, int s,
                                          float row_scale) {
  const int64_t at = (e * a.M + m) * a.N + n;
  if constexpr (EPI == kScaled)
    static_cast<float*>(a.out)[at] = (float)s * (a.col_scale[e * a.N + n] / row_scale);
  else
    static_cast<int32_t*>(a.out)[at] = s;
}

// The one-row __dp4a core (expert and 2-D decode at M = 1); BM is its tile
// height. T: the element type of x (float, __nv_bfloat16, or int8_t for
// kCodes).
template <typename T, int G, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads) ternary_kernel(Args a) {
  constexpr int BM = 1;
  constexpr int CW = kWords, CPT = kCols, CL = kColLanes, KL = kKLanes, PL = kPerLane;
  static_assert(kChunk == kThreads, "one staged group per thread and row");
  const int M = a.M, K = a.K, KG = a.KG, N = a.N;
  Place pl(a.splits);

  const int64_t e = blockIdx.z;  // expert of a batched launch (1 for a plain product)
  const T* x = static_cast<const T*>(a.x) + e * M * K;
  const uint8_t* packed = a.packed + e * KG * N;
  const int n_base = pl.tile * kBN;
  const int m0 = blockIdx.y * BM;
  const int live = min(BM, M - m0);
  int g_lo, g_hi;  // this block's K groups
  pl.groups(KG, g_lo, g_hi);

  __shared__ int amax_bits[BM];
  __shared__ float row_scale[BM];
  __shared__ int xw[BM][kChunk];  // codes of k 0-3 of each group (pack2 order 0 2 1 3)
  __shared__ int8_t x4[G == 5 ? BM : 1][G == 5 ? kChunk : 1];  // pack243: code of k 4
  __shared__ int red[BM][kBN];    // the block's column sums

  for (int i = threadIdx.x; i < BM * kBN; i += kThreads) (&red[0][0])[i] = 0;
  if (threadIdx.x < BM) amax_bits[threadIdx.x] = 0;
  __syncthreads();
  row_scales<T, PRO, EPI, BM>(a, x, e, m0, live, pl, amax_bits, row_scale);

  const int clane = threadIdx.x % CL, klane = threadIdx.x / CL;
  const int n0 = n_base + clane * CPT;
  const bool vec_n = N % (4 * CW) == 0 && reinterpret_cast<uintptr_t>(a.packed) % 16 == 0;
  const bool vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  int acc[BM][CPT];
  int corr[BM];  // pack243: the sum of this thread's codes, per row
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    corr[r] = 0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0;
  }

  for (int c0 = g_lo; c0 < g_hi; c0 += kChunk) {
    const int c1 = min(g_hi, c0 + kChunk);
    // this thread's weights of the chunk, in flight while the codes stage
    uint32_t wv[PL][CW];
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const int g = c0 + klane + j * KL;
      if (g < c1) {
        load_cols(packed + (int64_t)g * N, n0, N, vec_n, wv[j]);
      } else {
#pragma unroll
        for (int i = 0; i < CW; ++i) wv[j][i] = 0;
      }
    }
    // ---- stage the chunk's int8 codes: group threadIdx.x of every row ----
    {
      const int g = c0 + threadIdx.x;
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        int word = 0, fifth = 0;
        if (r < live && g < c1)
          word = group_codes<T, G, PRO>(x + (int64_t)(m0 + r) * K, g * G, K, vec_x,
                                        row_scale[r], a, fifth);
        xw[r][threadIdx.x] = word;
        if constexpr (G == 5) x4[r][threadIdx.x] = (int8_t)fifth;
      }
    }
    __syncthreads();
    // ---- int8 x trit accumulate ----
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const int g = c0 + klane + j * KL;
      if (g < c1) {
        const int kk = g - c0;
        int xr[BM], x5[BM];
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          xr[r] = xw[r][kk];
          x5[r] = G == 5 ? (int)x4[G == 5 ? r : 0][G == 5 ? kk : 0] : 0;
        }
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          if constexpr (G == 4) {
            const Pack2Word p(wv[j][i]);
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int t = p.trits(b);
#pragma unroll
              for (int r = 0; r < BM; ++r)
                if (r < live) acc[r][4 * i + b] = __dp4a(xr[r], t, acc[r][4 * i + b]);
            }
          } else {
            int lo[4], hi[4];
            decode243(wv[j][i], lo, hi);
#pragma unroll
            for (int b = 0; b < 4; ++b)
#pragma unroll
              for (int r = 0; r < BM; ++r)
                if (r < live)
                  acc[r][4 * i + b] = __dp4a(xr[r], lo[b], acc[r][4 * i + b]) + x5[r] * hi[b];
          }
        }
        if constexpr (G == 5) {
#pragma unroll
          for (int r = 0; r < BM; ++r) corr[r] = __dp4a(xr[r], 0x01010101, corr[r] + x5[r]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the codes
  }

  // ---- sum the k lanes: warp shuffles, then shared-memory atomics ----
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      int v = acc[r][c] - corr[r];  // pack243: digits are trits + 1
#pragma unroll
      for (int o = CL; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[r][c] = v;
    }
  if (lane < CL) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
      if (r < live)
#pragma unroll
        for (int c = 0; c < CPT; ++c) atomicAdd(&red[r][clane * CPT + c], acc[r][c]);
  }
  pl.sync();

  // ---- each of the tile's cs blocks reduces and stores a 1/cs share ----
  for (int o = threadIdx.x; o < BM * kBN; o += kThreads) {
    if (o % pl.cs != pl.split) continue;
    const int r = o / kBN, n = n_base + o % kBN;
    if (r >= live || n >= N) continue;
    store_out<EPI>(a, e, m0 + r, n, pl.tile_sum(&red[0][0] + o), row_scale[r]);
  }
  pl.sync();  // keep this block's sums alive until the cluster has read them
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Tensor-core core for pack2 at up to 8 rows (decode): the weights are the
// mma's A operand, decoded in registers straight into its fragments, and
// the rows' codes are its n8 operand.
// ---------------------------------------------------------------------------

constexpr int kMvRows = 8;     // rows: the mma's n8
constexpr int kMvCols = 128;   // columns per block: 8 fragment rows x 16 columns a thread

// Thread (gid, tig) of a warp owns 16 neighbouring columns n_base + 16 gid
// and, in every mma k-step of 8 groups, groups tig and tig + 4: one
// 16-byte load of each. Fragment row gid is its column 2t of tile t, row
// gid + 8 its column 2t + 1, so the 16 loaded bytes feed 8 mma tiles; the
// codes' k order is the trits', so b0 / b1 are the staged code words of
// row gid for the same two groups. Warps split the chunk's k-steps.
template <typename T, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads, 2) ternary_mv_kernel(Args a) {
  constexpr int R = kMvRows;
  const int M = a.M, K = a.K, KG = a.KG, N = a.N;
  Place pl(a.splits);

  const int64_t e = blockIdx.z;
  const T* x = static_cast<const T*>(a.x) + e * M * K;
  const uint8_t* packed = a.packed + e * KG * N;
  const int n_base = pl.tile * kMvCols;
  const int live = min(R, M);
  int g_lo, g_hi;
  pl.groups(KG, g_lo, g_hi);

  constexpr int RS = kMvCols + 4;  // red's row stride: the fragment stores hit 32 banks
  __shared__ int amax_bits[R];
  __shared__ float row_scale[R];
  __shared__ int xw[R][kChunk];  // code words, Pack2Word's order
  __shared__ int red[R * RS];    // column sums; column c of row r at r RS + (c % 16) 8 + c / 16

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ncol = n_base + gid * 16;
  const bool vec_n = N % 16 == 0 && reinterpret_cast<uintptr_t>(a.packed) % 16 == 0;
  const bool vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  // A chunk of kChunk groups is 32 k-steps of 8; warp w takes steps w,
  // w + 8, w + 16, w + 24 and loads all four before the chunk's codes stage
  // (the first chunk's before the scales are found).
  constexpr int SPW = kChunk / 8 / kWarps;  // k-steps per warp per chunk
  uint32_t wv[SPW][2][4];
  auto load_chunk = [&](int c0, int c1) {
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int g0 = c0 + 8 * (warp + j * kWarps) + tig;
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[j][0][i] = wv[j][1][i] = 0u;
      if (g0 < c1) load_cols(packed + (int64_t)g0 * N, ncol, N, vec_n, wv[j][0]);
      if (g0 + 4 < c1) load_cols(packed + (int64_t)(g0 + 4) * N, ncol, N, vec_n, wv[j][1]);
    }
  };
  Raw<PRO> xv[R][4];  // group threadIdx.x of the chunk, every row
  auto load_x = [&](int c0, int c1) {
    const int g = c0 + threadIdx.x;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < live && g < c1) {
        load_group<T, 4, PRO>(x + (int64_t)r * K, g * 4, K, vec_x, xv[r]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[r][i] = 0;
      }
    }
  };
  load_chunk(g_lo, min(g_hi, g_lo + kChunk));
  load_x(g_lo, min(g_hi, g_lo + kChunk));

  for (int i = threadIdx.x; i < R * RS; i += kThreads) red[i] = 0;
  if (threadIdx.x < R) amax_bits[threadIdx.x] = 0;
  __syncthreads();
  row_scales<T, PRO, EPI, R>(a, x, e, 0, live, pl, amax_bits, row_scale);

  int acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0;

  for (int c0 = g_lo; c0 < g_hi; c0 += kChunk) {
    const int c1 = min(g_hi, c0 + kChunk);
    if (c0 != g_lo) {
      load_chunk(c0, c1);
      load_x(c0, c1);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int fifth = 0;
      xw[r][threadIdx.x] = group_word<4, PRO>(xv[r], row_scale[r], a, fifth);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int kk = 8 * (warp + j * kWarps);
      if (c0 + kk >= c1) break;
      const int b0 = xw[gid][kk + tig], b1 = xw[gid][kk + 4 + tig];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // word q: columns 4q .. 4q + 3 = tiles 2q and 2q + 1
        const Pack2Word p0(wv[j][0][q]), p1(wv[j][1][q]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int af[4] = {p0.trits(2 * h), p0.trits(2 * h + 1), p1.trits(2 * h),
                             p1.trits(2 * h + 1)};
          mma_s8(acc[2 * q + h], af, b0, b1);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the codes
  }

  // ---- sum the warps' K slices, then the cluster's ----
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = tig * 2 + (q & 1);  // column gid * 16 + 2 t + (q >> 1)
      if (r < live) atomicAdd(&red[r * RS + (2 * t + (q >> 1)) * 8 + gid], acc[t][q]);
    }
  pl.sync();
  for (int o = threadIdx.x; o < R * kMvCols; o += kThreads) {
    if (o % pl.cs != pl.split) continue;
    const int r = o / kMvCols, c = o % kMvCols, n = n_base + c;
    if (r >= live || n >= N) continue;
    store_out<EPI>(a, e, r, n, pl.tile_sum(red + r * RS + (c % 16) * 8 + c / 16), row_scale[r]);
  }
  pl.sync();
}

// ---------------------------------------------------------------------------
// Tensor-core core for tiles of 16+ rows (prefill): 64 x 128 output tile,
// eight warps of 32 x 32, mma.sync m16n8k32 s8 x s8 -> s32.
// ---------------------------------------------------------------------------

constexpr int kTcBM = 64, kTcBN = 128;
constexpr int kTcGroups = 32;  // K groups per chunk: 128 (pack2) or 160 (pack243) k
constexpr int kTcMinGroups = 4 * kTcGroups;  // K groups a block keeps under split-K

template <int G>
struct TcTile {
  static constexpr int kKe = kTcGroups * G;       // k per chunk, a multiple of 32
  static constexpr int kStride = kKe / 4 + 4;     // words per shared row; +4 spreads the banks
  static constexpr int kABytes = kTcBM * kStride * 4;
  static constexpr int kBBytes = kTcBN * kStride * 4;
  static constexpr int kRedBytes = kTcBM * kTcBN * 4;
  static constexpr int kBytes = kABytes + kBBytes > kRedBytes ? kABytes + kBBytes : kRedBytes;
};

// K order inside a chunk, the same for the codes (A) and the trits (B), so
// every product pairs the right code with the right trit: group g's k 0-3
// in bytes 4g..4g+3 (pack2 in the order 0 2 1 3), pack243's k 4 in byte
// 128 + g.
template <typename T, int G, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads) ternary_tc_kernel(Args a) {
  using TT = TcTile<G>;
  constexpr int SW = TT::kStride;
  static_assert(kTcGroups == 32 && kThreads == 256, "a warp per column slice, a lane per group");
  const int M = a.M, K = a.K, KG = a.KG, N = a.N;
  Place pl(a.splits);

  const int64_t e = blockIdx.z;
  const T* x = static_cast<const T*>(a.x) + e * M * K;
  const uint8_t* packed = a.packed + e * KG * N;
  const int n_base = pl.tile * kTcBN;
  const int m0 = blockIdx.y * kTcBM;
  const int live = min(kTcBM, M - m0);
  int g_lo, g_hi;
  pl.groups(KG, g_lo, g_hi);

  __shared__ __align__(16) unsigned char smem[TT::kBytes];
  __shared__ int amax_bits[kTcBM];
  __shared__ float row_scale[kTcBM];
  int* As = reinterpret_cast<int*>(smem);                // [kTcBM][SW] codes
  int* Bs = reinterpret_cast<int*>(smem + TT::kABytes);  // [kTcBN][SW] trits, k contiguous
  int* red = reinterpret_cast<int*>(smem);               // [kTcBM][kTcBN] after the K loop

  if (threadIdx.x < kTcBM) amax_bits[threadIdx.x] = 0;
  __syncthreads();
  row_scales<T, PRO, EPI, kTcBM>(a, x, e, m0, live, pl, amax_bits, row_scale);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;   // this warp's 32 x 32 output block
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const bool vec_n = N % 16 == 0 && reinterpret_cast<uintptr_t>(a.packed) % 16 == 0;
  const bool vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  // this lane's group of each chunk, columns n_base + 16 warp .. + 15; the
  // next chunk's weights load while this one is staged and multiplied
  uint32_t wv[4] = {0u, 0u, 0u, 0u};
  if (g_lo + lane < g_hi)
    load_cols(packed + (int64_t)(g_lo + lane) * N, n_base + warp * 16, N, vec_n, wv);
  constexpr int RPT = kTcBM / kWarps;  // rows warp, warp + 8, ... of this lane's group
  Raw<PRO> xv[RPT][G];
  auto load_x = [&](int g) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = warp + j * kWarps;
      if (r < live && g < g_hi) {
        load_group<T, G, PRO>(x + (int64_t)(m0 + r) * K, g * G, K, vec_x, xv[j]);
      } else {
#pragma unroll
        for (int i = 0; i < G; ++i) xv[j][i] = 0;
      }
    }
  };
  load_x(g_lo + lane);
  for (int c0 = g_lo; c0 < g_hi; c0 += kTcGroups) {
    const int g = c0 + lane;  // this lane's group, for the weights and the codes
    // ---- codes of group g for rows warp, warp + 8, ... (zero values past the rows) ----
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = warp + j * kWarps;
      int fifth = 0;
      As[r * SW + lane] = group_word<G, PRO>(xv[j], row_scale[r], a, fifth);
      if constexpr (G == 5) reinterpret_cast<int8_t*>(As + r * SW)[128 + lane] = (int8_t)fifth;
    }
    // ---- trits of group g for this warp's 16 columns, k contiguous per column ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (G == 4) {
        const Pack2Word p(wv[i]);
#pragma unroll
        for (int b = 0; b < 4; ++b) Bs[(warp * 16 + 4 * i + b) * SW + lane] = p.trits(b);
      } else {
        int lo[4], hi[4];
        decode243(wv[i], lo, hi);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = warp * 16 + 4 * i + b;
          // digits 0..2 -> trits -1..1 in each byte lane, no borrow between lanes
          Bs[col * SW + lane] = (int)(((uint32_t)lo[b] | 0x80808080u) - 0x01010101u) ^ 0x80808080;
          reinterpret_cast<int8_t*>(Bs + col * SW)[128 + lane] = (int8_t)(hi[b] - 1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = 0u;
    if (g + kTcGroups < g_hi)
      load_cols(packed + (int64_t)(g + kTcGroups) * N, n_base + warp * 16, N, vec_n, wv);
    load_x(g + kTcGroups);  // the next chunk's x, in flight during this chunk's mma
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TT::kKe / 32; ++ks) {
      const int kw = ks * 8;
      int af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + gid;
        af[mt][0] = As[row * SW + kw + tig];
        af[mt][1] = As[(row + 8) * SW + kw + tig];
        af[mt][2] = As[row * SW + kw + 4 + tig];
        af[mt][3] = As[(row + 8) * SW + kw + 4 + tig];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + gid;
        const int b0 = Bs[col * SW + kw + tig], b1 = Bs[col * SW + kw + 4 + tig];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)  // m16 tiles past the live rows hold zero codes
          if (wm * 32 + mt * 16 < live) mma_s8(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();  // the next chunk overwrites A and B
  }

  if (pl.cs == 1) {  // straight from the fragments
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = wm * 32 + mt * 16 + gid + (q >= 2 ? 8 : 0);
          const int n = n_base + wn * 32 + nt * 8 + tig * 2 + (q & 1);
          if (r < live && n < N) store_out<EPI>(a, e, m0 + r, n, acc[mt][nt][q], row_scale[r]);
        }
    if (pl.cl > 1) pl.cluster.sync();  // the cluster may still read this block's absmax
    return;
  }
  // split K: park the partial tile in shared memory, reduce across the cluster
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm * 32 + mt * 16 + gid + (q >= 2 ? 8 : 0);
        const int col = wn * 32 + nt * 8 + tig * 2 + (q & 1);
        red[r * kTcBN + col] = acc[mt][nt][q];
      }
  pl.sync();
  for (int o = threadIdx.x; o < kTcBM * kTcBN; o += kThreads) {
    if (o % pl.cs != pl.split) continue;
    const int r = o / kTcBN, n = n_base + o % kTcBN;
    if (r >= live || n >= N) continue;
    store_out<EPI>(a, e, m0 + r, n, pl.tile_sum(red + o), row_scale[r]);
  }
  pl.sync();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Launch kernel F over (column tiles x cluster, row tiles, E). K is split
// over a cluster of cs blocks only while (a) the grid still fits in one
// wave of resident blocks and (b) every block keeps ``min_groups`` K groups:
// measured on the H100, a block's fixed latency (scales, staging, cluster
// barriers) outweighs its share of the bytes below one 256-group chunk, and
// a second wave costs a whole block latency.
template <void (*F)(Args)>
cudaError_t launch(const Args& a, int E, int bm, int bn, int min_groups, bool share_sweep,
                   cudaStream_t stream) {
  static const int resident = [] {
    int per_sm = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, F, kThreads, 0);
    return std::max(1, per_sm) * sm_count();
  }();
  const int tiles_n = (a.N + bn - 1) / bn, tiles_m = (a.M + bm - 1) / bm;
  const long blocks = (long)tiles_n * tiles_m * E;
  const long cs = std::max<long>(1, std::min<long>({(long)kMaxCluster, resident / blocks,
                                                    (long)a.KG / min_groups}));
  long ct = 1;  // column tiles per cluster: they share one absmax sweep
  while (share_sweep && cs * ct * 2 <= kMaxCluster && tiles_n % (ct * 2) == 0) ct *= 2;
  Args b = a;
  b.splits = (int)cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_n * cs, tiles_m, E);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)(cs * ct);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, F, b);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The row tile fitted to the rows present: one row on the __dp4a core
// (expert decode), pack2 up to 8 rows on the register-fed mma core, the
// 64-row shared-memory mma core beyond (and pack243 from 2 rows).
template <typename T, int G, int PRO, int EPI>
cudaError_t by_rows(const Args& a, int E, cudaStream_t s) {
  if (a.M <= 1) return launch<ternary_kernel<T, G, PRO, EPI>>(a, E, 1, kBN, kChunk, false, s);
  if constexpr (G == 4)
    if (a.M <= kMvRows)
      return launch<ternary_mv_kernel<T, PRO, EPI>>(a, E, kMvRows, kMvCols, kChunk, false, s);
  return launch<ternary_tc_kernel<T, G, PRO, EPI>>(a, E, kTcBM, kTcBN, kTcMinGroups,
                                                   PRO == kActQuant, s);
}

template <typename T, int PRO, int EPI>
int by_group(const Args& a, int E, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return group == 4 ? by_rows<T, 4, PRO, EPI>(a, E, s) : by_rows<T, 5, PRO, EPI>(a, E, s);
}

Args make_args(const void* x, const void* x_scale, const void* packed, const void* col_scale,
               void* out, int M, int K, int KG, int N, int act_bits) {
  return Args{x, static_cast<const float*>(x_scale), static_cast<const uint8_t*>(packed),
              static_cast<const float*>(col_scale), out, M, K, KG, N,
              act_bits == 4 ? 7.f : 127.f, act_bits == 4 ? -8.f : -128.f, 1};
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
