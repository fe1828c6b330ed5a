// C entry points of the causal flash prefill's fresh, chunked, paged chunked
// and MLA forms (replacing _flash_prefill of src/repro/kernels/flash_prefill.py);
// the kernels and their notes are in flash_prefill.cuh.

#include "flash_prefill.cuh"

extern "C" int flash_prefill_fresh(int is_bf16, const void* q, const void* k, const void* v,
                                   const void* valid, const void* cos, const void* sin,
                                   void* out, void* k_cast, void* v_cast, int B, int S, int G,
                                   int rep, int D, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const PrefillArgs<T> a{(const T*)q, (const T*)k, (const T*)v, (const int*)valid,
                           (const float*)cos, (const float*)sin, (T*)out, (T*)k_cast,
                           (T*)v_cast, S, G, rep, scale};
    return launch_gqa(a, B, D, st);
  }
  const PrefillArgs<float> a{(const float*)q, (const float*)k, (const float*)v, (const int*)valid,
                             (const float*)cos, (const float*)sin, (float*)out, (float*)k_cast,
                             (float*)v_cast, S, G, rep, scale};
  return launch_gqa(a, B, D, st);
}

extern "C" int flash_prefill_chunk(int is_bf16, const void* q, const void* k, const void* v,
                                   const void* valid, const void* cos, const void* sin,
                                   void* out, void* k_cast, void* v_cast, const void* hot_k,
                                   const void* hot_v, const void* cold_k, const void* cold_v,
                                   const void* lengths, int B, int S, int G, int rep, int D,
                                   int hot_cap, int cold_cap, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const PrefillArgs<T> a{(const T*)q, (const T*)k, (const T*)v, (const int*)valid,
                           (const float*)cos, (const float*)sin, (T*)out, (T*)k_cast,
                           (T*)v_cast, S, G, rep, scale};
    const TierArgs<T> tr{(const T*)hot_k, (const T*)hot_v, (const T*)cold_k, (const T*)cold_v,
                         (const int*)lengths, hot_cap, cold_cap};
    return launch_chunk(a, tr, B, D, st);
  }
  const PrefillArgs<float> a{(const float*)q, (const float*)k, (const float*)v, (const int*)valid,
                             (const float*)cos, (const float*)sin, (float*)out, (float*)k_cast,
                             (float*)v_cast, S, G, rep, scale};
  const TierArgs<float> tr{(const float*)hot_k, (const float*)hot_v, (const float*)cold_k,
                           (const float*)cold_v, (const int*)lengths, hot_cap, cold_cap};
  return launch_chunk(a, tr, B, D, st);
}

extern "C" int flash_prefill_chunk_paged(int is_bf16, const void* q, const void* k,
                                         const void* v, const void* valid, const void* cos,
                                         const void* sin, void* out, void* k_cast, void* v_cast,
                                         const void* hot_k, const void* hot_v, const void* pool_k,
                                         const void* pool_v, const void* lengths,
                                         const void* page_table, int B, int S, int G, int rep,
                                         int D, int hot_cap, int ps, int pps, float scale,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const PrefillArgs<T> a{(const T*)q, (const T*)k, (const T*)v, (const int*)valid,
                           (const float*)cos, (const float*)sin, (T*)out, (T*)k_cast,
                           (T*)v_cast, S, G, rep, scale};
    const TierArgs<T> tr{(const T*)hot_k, (const T*)hot_v, (const T*)pool_k, (const T*)pool_v,
                         (const int*)lengths, hot_cap, ps * pps, (const int*)page_table, ps, pps};
    return launch_chunk<T, true>(a, tr, B, D, st);
  }
  const PrefillArgs<float> a{(const float*)q, (const float*)k, (const float*)v, (const int*)valid,
                             (const float*)cos, (const float*)sin, (float*)out, (float*)k_cast,
                             (float*)v_cast, S, G, rep, scale};
  const TierArgs<float> tr{(const float*)hot_k, (const float*)hot_v, (const float*)pool_k,
                           (const float*)pool_v, (const int*)lengths, hot_cap, ps * pps,
                           (const int*)page_table, ps, pps};
  return launch_chunk<float, true>(a, tr, B, D, st);
}

extern "C" int flash_prefill_mla(int is_bf16, const void* q, const void* k, const void* v,
                                 const void* valid, const void* cos, const void* sin, void* out,
                                 int B, int S, int H, int D, int DV, int rope_dims, float scale,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const PrefillArgs<T> a{(const T*)q, (const T*)k, (const T*)v, (const int*)valid,
                           (const float*)cos, (const float*)sin, (T*)out, nullptr, nullptr,
                           S, H, 1, scale};
    return launch_mla(a, B, D, DV, rope_dims, st);
  }
  const PrefillArgs<float> a{(const float*)q, (const float*)k, (const float*)v, (const int*)valid,
                             (const float*)cos, (const float*)sin, (float*)out, nullptr, nullptr,
                             S, H, 1, scale};
  return launch_mla(a, B, D, DV, rope_dims, st);
}
