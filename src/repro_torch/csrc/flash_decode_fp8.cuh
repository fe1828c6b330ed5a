#pragma once
// The launcher of the GQA flash decode's fp8-tier forms (flash_decode.cuh's
// kernels with TT = __nv_fp8_e4m3), shared by their two sources,
// flash_decode_fp8.cu (contiguous and ring tiers) and flash_decode_paged_fp8.cu
// (paged tiers).

#include "flash_decode.cuh"

namespace {

using F8 = __nv_fp8_e4m3;

// One form over fp8 tiers, with bf16 or f32 activations. CC is the cold
// tier's rows, or pps * ps over a paged pool (table non-null).
template <bool FUSED, bool PAGED, bool RING>
int run(int is_bf16, const void* q, const void* hot_k, const void* hot_v, const void* cold_k,
        const void* cold_v, const void* k_new, const void* v_new, const void* lengths,
        const void* active, const void* cos, const void* sin, void* out, void* k_rot,
        const void* table, int B, int G, int rep, int D, int HC, int CC, int ps, int pps,
        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto zero) {
    using T = decltype(zero);
    DecodeArgs<T, F8> a{(const T*)q, (const F8*)hot_k, (const F8*)hot_v, (const F8*)cold_k,
                        (const F8*)cold_v, (const T*)k_new, (const T*)v_new,
                        (const int*)lengths, (const int*)active, (const float*)cos,
                        (const float*)sin, (T*)out, (T*)k_rot, G, rep, HC, CC, scale,
                        (const int*)table, ps, pps};
    return launch<T, FUSED, PAGED, RING>(a, B, D, s);
  };
  return is_bf16 ? go(__nv_bfloat16{}) : go(0.f);
}

}  // namespace

