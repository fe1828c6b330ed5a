// C entry points of the GQA flash decode over contiguous and ring fp8 (e4m3)
// tiers: the fused-RoPE form over contiguous and ring tiers and the
// post-append form over contiguous tiers (the reference's _flash_gqa_fused and
// _flash_gqa of src/repro/kernels/flash_decode.py with kv_fp8 caches; the
// paged forms are in flash_decode_paged_fp8.cu, so the two build in
// parallel). Each takes the arguments of its f32 / bf16 counterpart; is_bf16
// names the activations' type, the tiers are fp8. The kernels and their notes
// are in flash_decode.cuh, the fp8 forms' shared launcher in
// flash_decode_fp8.cuh.

#include "flash_decode_fp8.cuh"

extern "C" int flash_decode_gqa_fused_fp8(
    int is_bf16, const void* q, const void* hot_k, const void* hot_v, const void* cold_k,
    const void* cold_v, const void* k_new, const void* v_new, const void* lengths,
    const void* active, const void* cos, const void* sin, void* out, void* k_rot,
    int B, int G, int rep, int D, int HC, int CC, float scale, void* stream) {
  return run<true, false, false>(is_bf16, q, hot_k, hot_v, cold_k, cold_v, k_new, v_new,
                                 lengths, active, cos, sin, out, k_rot, nullptr, B, G, rep, D,
                                 HC, CC, 0, 0, scale, stream);
}

extern "C" int flash_decode_gqa_fp8(int is_bf16, const void* q, const void* hot_k,
                                    const void* hot_v, const void* cold_k, const void* cold_v,
                                    const void* lengths, void* out, int B, int G, int rep,
                                    int D, int HC, int CC, float scale, void* stream) {
  return run<false, false, false>(is_bf16, q, hot_k, hot_v, cold_k, cold_v, nullptr, nullptr,
                                  lengths, nullptr, nullptr, nullptr, out, nullptr, nullptr, B,
                                  G, rep, D, HC, CC, 0, 0, scale, stream);
}

extern "C" int flash_decode_gqa_fused_ring_fp8(
    int is_bf16, const void* q, const void* hot_k, const void* hot_v, const void* cold_k,
    const void* cold_v, const void* k_new, const void* v_new, const void* lengths,
    const void* active, const void* cos, const void* sin, void* out, void* k_rot,
    int B, int G, int rep, int D, int HC, int CC, float scale, void* stream) {
  return run<true, false, true>(is_bf16, q, hot_k, hot_v, cold_k, cold_v, k_new, v_new,
                                lengths, active, cos, sin, out, k_rot, nullptr, B, G, rep, D,
                                HC, CC, 0, 0, scale, stream);
}
