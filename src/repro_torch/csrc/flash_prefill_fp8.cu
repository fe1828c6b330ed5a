// C entry points of the causal flash prefill's GQA forms over fp8 (e4m3) tiers:
// the fresh and window forms emit k / v as fp8, the chunked, paged chunked and
// ring chunked forms read fp8 tiers and emit fp8 (the reference's
// _flash_prefill of src/repro/kernels/flash_prefill.py with kv_fp8 caches).
// Each takes the arguments of its f32 / bf16 counterpart; is_bf16 names the
// type of q, k, v and the output. The kernels and their notes are in
// flash_prefill.cuh.

#include "flash_prefill.cuh"

namespace {

using F8 = __nv_fp8_e4m3;

template <typename T>
PrefillArgs<T, F8> fp8_args(const void* q, const void* k, const void* v, const void* valid,
                            const void* cos, const void* sin, void* out, void* k_cast,
                            void* v_cast, int S, int G, int rep, float scale, int window) {
  return {(const T*)q, (const T*)k,   (const T*)v,    (const int*)valid, (const float*)cos,
          (const float*)sin, (T*)out, (F8*)k_cast, (F8*)v_cast, S, G, rep, scale, window};
}

TierArgs<F8> fp8_tiers(const void* hot_k, const void* hot_v, const void* cold_k,
                       const void* cold_v, const void* lengths, int hot_cap, int cold_cap,
                       const void* page_table = nullptr, int ps = 0, int pps = 0, int ring = 0) {
  TierArgs<F8> tr{(const F8*)hot_k, (const F8*)hot_v, (const F8*)cold_k, (const F8*)cold_v,
                  (const int*)lengths, hot_cap, cold_cap, (const int*)page_table, ps, pps};
  tr.ring = ring;
  return tr;
}

}  // namespace

extern "C" int flash_prefill_fresh_fp8(int is_bf16, const void* q, const void* k, const void* v,
                                       const void* valid, const void* cos, const void* sin,
                                       void* out, void* k_cast, void* v_cast, int B, int S,
                                       int G, int rep, int D, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_gqa(fp8_args<__nv_bfloat16>(q, k, v, valid, cos, sin, out, k_cast, v_cast, S,
                                              G, rep, scale, 0),
                      B, D, st);
  return launch_gqa(fp8_args<float>(q, k, v, valid, cos, sin, out, k_cast, v_cast, S, G, rep,
                                    scale, 0),
                    B, D, st);
}

extern "C" int flash_prefill_window_fp8(int is_bf16, const void* q, const void* k, const void* v,
                                        const void* valid, const void* cos, const void* sin,
                                        void* out, void* k_cast, void* v_cast, int B, int S,
                                        int G, int rep, int D, int window, float scale,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_gqa<__nv_bfloat16, true>(
        fp8_args<__nv_bfloat16>(q, k, v, valid, cos, sin, out, k_cast, v_cast, S, G, rep,
                                scale, window),
        B, D, st);
  return launch_gqa<float, true>(
      fp8_args<float>(q, k, v, valid, cos, sin, out, k_cast, v_cast, S, G, rep, scale, window),
      B, D, st);
}

extern "C" int flash_prefill_chunk_fp8(int is_bf16, const void* q, const void* k, const void* v,
                                       const void* valid, const void* cos, const void* sin,
                                       void* out, void* k_cast, void* v_cast, const void* hot_k,
                                       const void* hot_v, const void* cold_k, const void* cold_v,
                                       const void* lengths, int B, int S, int G, int rep, int D,
                                       int hot_cap, int cold_cap, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TierArgs<F8> tr = fp8_tiers(hot_k, hot_v, cold_k, cold_v, lengths, hot_cap, cold_cap);
  if (is_bf16)
    return launch_chunk(fp8_args<__nv_bfloat16>(q, k, v, valid, cos, sin, out, k_cast, v_cast,
                                                S, G, rep, scale, 0),
                        tr, B, D, st);
  return launch_chunk(fp8_args<float>(q, k, v, valid, cos, sin, out, k_cast, v_cast, S, G, rep,
                                      scale, 0),
                      tr, B, D, st);
}

extern "C" int flash_prefill_chunk_paged_fp8(
    int is_bf16, const void* q, const void* k, const void* v, const void* valid, const void* cos,
    const void* sin, void* out, void* k_cast, void* v_cast, const void* hot_k, const void* hot_v,
    const void* pool_k, const void* pool_v, const void* lengths, const void* page_table, int B,
    int S, int G, int rep, int D, int hot_cap, int ps, int pps, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TierArgs<F8> tr =
      fp8_tiers(hot_k, hot_v, pool_k, pool_v, lengths, hot_cap, ps * pps, page_table, ps, pps);
  if (is_bf16)
    return launch_chunk<__nv_bfloat16, true>(
        fp8_args<__nv_bfloat16>(q, k, v, valid, cos, sin, out, k_cast, v_cast, S, G, rep,
                                scale, 0),
        tr, B, D, st);
  return launch_chunk<float, true>(
      fp8_args<float>(q, k, v, valid, cos, sin, out, k_cast, v_cast, S, G, rep, scale, 0), tr,
      B, D, st);
}

extern "C" int flash_prefill_chunk_ring_fp8(
    int is_bf16, const void* q, const void* k, const void* v, const void* valid, const void* cos,
    const void* sin, void* out, void* k_cast, void* v_cast, const void* hot_k, const void* hot_v,
    const void* cold_k, const void* cold_v, const void* lengths, int B, int S, int G, int rep,
    int D, int hot_cap, int cold_cap, int window, int ring, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TierArgs<F8> tr =
      fp8_tiers(hot_k, hot_v, cold_k, cold_v, lengths, hot_cap, cold_cap, nullptr, 0, 0, ring);
  if (is_bf16)
    return launch_chunk<__nv_bfloat16, false, true>(
        fp8_args<__nv_bfloat16>(q, k, v, valid, cos, sin, out, k_cast, v_cast, S, G, rep,
                                scale, window),
        tr, B, D, st);
  return launch_chunk<float, false, true>(
      fp8_args<float>(q, k, v, valid, cos, sin, out, k_cast, v_cast, S, G, rep, scale, window),
      tr, B, D, st);
}
