// C entry points of the GQA flash decode's paged forms, fused-RoPE and
// post-append over a paged cold tier (the reference's _flash_gqa_fused and
// _flash_gqa with a PagedKVCache); the kernels and their notes are in
// flash_decode.cuh.

#include "flash_decode.cuh"

extern "C" int flash_decode_gqa_fused_paged(
    int is_bf16, const void* q, const void* hot_k, const void* hot_v, const void* pool_k,
    const void* pool_v, const void* k_new, const void* v_new, const void* lengths,
    const void* active, const void* cos, const void* sin, void* out, void* k_rot,
    const void* page_table, int B, int G, int rep, int D, int HC, int ps, int pps, float scale,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    DecodeArgs<T> a{(const T*)q, (const T*)hot_k, (const T*)hot_v, (const T*)pool_k,
                    (const T*)pool_v, (const T*)k_new, (const T*)v_new, (const int*)lengths,
                    (const int*)active, (const float*)cos, (const float*)sin, (T*)out,
                    (T*)k_rot, G, rep, HC, ps * pps, scale, (const int*)page_table, ps, pps};
    return launch<T, true, true>(a, B, D, s);
  }
  using T = float;
  DecodeArgs<T> a{(const T*)q, (const T*)hot_k, (const T*)hot_v, (const T*)pool_k,
                  (const T*)pool_v, (const T*)k_new, (const T*)v_new, (const int*)lengths,
                  (const int*)active, (const float*)cos, (const float*)sin, (T*)out,
                  (T*)k_rot, G, rep, HC, ps * pps, scale, (const int*)page_table, ps, pps};
  return launch<T, true, true>(a, B, D, s);
}

extern "C" int flash_decode_gqa_paged(int is_bf16, const void* q, const void* hot_k,
                                      const void* hot_v, const void* pool_k, const void* pool_v,
                                      const void* lengths, void* out, const void* page_table,
                                      int B, int G, int rep, int D, int HC, int ps, int pps,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    DecodeArgs<T> a{(const T*)q, (const T*)hot_k, (const T*)hot_v, (const T*)pool_k,
                    (const T*)pool_v, nullptr, nullptr, (const int*)lengths, nullptr, nullptr,
                    nullptr, (T*)out, nullptr, G, rep, HC, ps * pps, scale,
                    (const int*)page_table, ps, pps};
    return launch<T, false, true>(a, B, D, s);
  }
  using T = float;
  DecodeArgs<T> a{(const T*)q, (const T*)hot_k, (const T*)hot_v, (const T*)pool_k,
                  (const T*)pool_v, nullptr, nullptr, (const int*)lengths, nullptr, nullptr,
                  nullptr, (T*)out, nullptr, G, rep, HC, ps * pps, scale, (const int*)page_table,
                  ps, pps};
  return launch<T, false, true>(a, B, D, s);
}
