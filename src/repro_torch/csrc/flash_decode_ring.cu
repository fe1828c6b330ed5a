// C entry point of the GQA flash decode's ring form: the fused-RoPE form over
// the sliding-window ring cold tier (the reference's _flash_gqa_fused with
// ring=True, through flash_decode_attention_ring); the kernel and its notes
// are in flash_decode.cuh.

#include "flash_decode.cuh"

extern "C" int flash_decode_gqa_fused_ring(
    int is_bf16, const void* q, const void* hot_k, const void* hot_v, const void* cold_k,
    const void* cold_v, const void* k_new, const void* v_new, const void* lengths,
    const void* active, const void* cos, const void* sin, void* out, void* k_rot,
    int B, int G, int rep, int D, int HC, int CC, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    DecodeArgs<T> a{(const T*)q, (const T*)hot_k, (const T*)hot_v, (const T*)cold_k,
                    (const T*)cold_v, (const T*)k_new, (const T*)v_new, (const int*)lengths,
                    (const int*)active, (const float*)cos, (const float*)sin, (T*)out,
                    (T*)k_rot, G, rep, HC, CC, scale};
    return launch<T, true, false, true>(a, B, D, s);
  }
  using T = float;
  DecodeArgs<T> a{(const T*)q, (const T*)hot_k, (const T*)hot_v, (const T*)cold_k,
                  (const T*)cold_v, (const T*)k_new, (const T*)v_new, (const int*)lengths,
                  (const int*)active, (const float*)cos, (const float*)sin, (T*)out,
                  (T*)k_rot, G, rep, HC, CC, scale};
  return launch<T, true, false, true>(a, B, D, s);
}
