// C entry points of the GQA flash decode over a paged fp8 (e4m3) cold tier: the
// fused-RoPE and post-append forms (the reference's _flash_gqa_fused and
// _flash_gqa of src/repro/kernels/flash_decode.py with a kv_fp8
// PagedKVCache). Each takes the arguments of its f32 / bf16 counterpart;
// is_bf16 names the activations' type, the tiers are fp8. The kernels and
// their notes are in flash_decode.cuh, the shared launcher in
// flash_decode_fp8.cuh.

#include "flash_decode_fp8.cuh"

extern "C" int flash_decode_gqa_fused_paged_fp8(
    int is_bf16, const void* q, const void* hot_k, const void* hot_v, const void* pool_k,
    const void* pool_v, const void* k_new, const void* v_new, const void* lengths,
    const void* active, const void* cos, const void* sin, void* out, void* k_rot,
    const void* page_table, int B, int G, int rep, int D, int HC, int ps, int pps, float scale,
    void* stream) {
  return run<true, true, false>(is_bf16, q, hot_k, hot_v, pool_k, pool_v, k_new, v_new,
                                lengths, active, cos, sin, out, k_rot, page_table, B, G, rep,
                                D, HC, ps * pps, ps, pps, scale, stream);
}

extern "C" int flash_decode_gqa_paged_fp8(int is_bf16, const void* q, const void* hot_k,
                                          const void* hot_v, const void* pool_k,
                                          const void* pool_v, const void* lengths, void* out,
                                          const void* page_table, int B, int G, int rep, int D,
                                          int HC, int ps, int pps, float scale, void* stream) {
  return run<false, true, false>(is_bf16, q, hot_k, hot_v, pool_k, pool_v, nullptr, nullptr,
                                 lengths, nullptr, nullptr, nullptr, out, nullptr, page_table,
                                 B, G, rep, D, HC, ps * pps, ps, pps, scale, stream);
}
