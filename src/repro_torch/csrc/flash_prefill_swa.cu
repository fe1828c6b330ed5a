// C entry points of the causal flash prefill's sliding-window forms: the
// fresh GQA form with a window and the chunked GQA form over a ring cold tier
// (the reference's _flash_prefill with window / ring); the kernels and their
// notes are in flash_prefill.cuh.

#include "flash_prefill.cuh"

extern "C" int flash_prefill_window(int is_bf16, const void* q, const void* k, const void* v,
                                    const void* valid, const void* cos, const void* sin,
                                    void* out, void* k_cast, void* v_cast, int B, int S, int G,
                                    int rep, int D, int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const PrefillArgs<T> a{(const T*)q, (const T*)k, (const T*)v, (const int*)valid,
                           (const float*)cos, (const float*)sin, (T*)out, (T*)k_cast,
                           (T*)v_cast, S, G, rep, scale, window};
    return launch_gqa<T, true>(a, B, D, st);
  }
  const PrefillArgs<float> a{(const float*)q, (const float*)k, (const float*)v, (const int*)valid,
                             (const float*)cos, (const float*)sin, (float*)out, (float*)k_cast,
                             (float*)v_cast, S, G, rep, scale, window};
  return launch_gqa<float, true>(a, B, D, st);
}

extern "C" int flash_prefill_chunk_ring(int is_bf16, const void* q, const void* k,
                                        const void* v, const void* valid, const void* cos,
                                        const void* sin, void* out, void* k_cast, void* v_cast,
                                        const void* hot_k, const void* hot_v, const void* cold_k,
                                        const void* cold_v, const void* lengths, int B, int S,
                                        int G, int rep, int D, int hot_cap, int cold_cap,
                                        int window, int ring, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const PrefillArgs<T> a{(const T*)q, (const T*)k, (const T*)v, (const int*)valid,
                           (const float*)cos, (const float*)sin, (T*)out, (T*)k_cast,
                           (T*)v_cast, S, G, rep, scale, window};
    TierArgs<T> tr{(const T*)hot_k, (const T*)hot_v, (const T*)cold_k, (const T*)cold_v,
                   (const int*)lengths, hot_cap, cold_cap};
    tr.ring = ring;
    return launch_chunk<T, false, true>(a, tr, B, D, st);
  }
  const PrefillArgs<float> a{(const float*)q, (const float*)k, (const float*)v, (const int*)valid,
                             (const float*)cos, (const float*)sin, (float*)out, (float*)k_cast,
                             (float*)v_cast, S, G, rep, scale, window};
  TierArgs<float> tr{(const float*)hot_k, (const float*)hot_v, (const float*)cold_k,
                     (const float*)cold_v, (const int*)lengths, hot_cap, cold_cap};
  tr.ring = ring;
  return launch_chunk<float, false, true>(a, tr, B, D, st);
}
