// The FP8-KV forms of kernel 8 (paged_prefill.cu's note: 8e, 8ew and their
// capped, sink and head_dim-256 forms), instantiated in a translation unit
// of their own, as paged_decode_e4m3.cu does for kernel 4: the build runs
// one nvcc a source, all at once.
#include "paged_prefill.cuh"

namespace sli_pp {

int dispatch_e4m3_fma(int head_dim, const void* q, long long q_bs,
                      long long q_ss, const void* pool_k, const void* pool_v,
                      const int* tables, const int* kv_lens, const int* offs,
                      void* out, int batch, int seq, int heads, int layer,
                      int num_pages1, int kvn, int ps, int mp, int group,
                      int window, float scale, float cap, const float* sinks,
                      cudaStream_t st) {
  return dispatch_d<float, __nv_fp8_e4m3>(
      head_dim, q, q_bs, q_ss, pool_k, pool_v, nullptr, nullptr, tables,
      kv_lens, offs, out, batch, seq, heads, layer, num_pages1, kvn, ps, mp,
      group, window, scale, cap, sinks, st);
}

int dispatch_e4m3_mma(int head_dim, const void* q, long long q_bs,
                      long long q_ss, const void* pool_k, const void* pool_v,
                      const int* tables, const int* kv_lens, const int* offs,
                      void* out, float* work, int batch, int seq, int heads,
                      int layer, int num_pages1, int kvn, int ps, int mp,
                      int group, int window, float scale, float cap,
                      int splits, const float* sinks, cudaStream_t st) {
  return dispatch_mma<sli::pfa::KV_E4M3>(
      head_dim, q, q_bs, q_ss, pool_k, pool_v, nullptr, nullptr, tables,
      kv_lens, offs, out, work, batch, seq, heads, layer, num_pages1, kvn, ps,
      mp, group, window, scale, cap, splits, sinks, st);
}

}  // namespace sli_pp
