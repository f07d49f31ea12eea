// The FP8-KV forms of kernel 4 (paged_decode.cu's note: 4e, 4ew, 4ve, 4vew
// and their capped, sink and head_dim-256 forms), instantiated in a
// translation unit of their own, as paged_decode_i8.cu does for the
// INT8-KV forms: the build runs one nvcc a source, all at once.
#include "paged_decode.cuh"

namespace sli_pd {

int dispatch_e4m3(bool f32, int head_dim, const Args& a, cudaStream_t st) {
  return f32 ? dispatch_d<float, __nv_fp8_e4m3>(head_dim, a, st)
             : dispatch_d<__nv_bfloat16, __nv_fp8_e4m3>(head_dim, a, st);
}

}  // namespace sli_pd
