// The FP8-KV forms of kernel 13 (the dense arena over float8_e4m3fn codes:
// 13e, 13ew, and their capped, sink and head_dim-256 forms, 13ec, 13ewc,
// 13es, 13ews; paged_decode.cu's note), instantiated in a translation unit
// of their own, as paged_decode_e4m3.cu does for the paged FP8-KV forms:
// the build runs one nvcc a source, all at once. The body is kernel 4's
// with one page of Smax slots a sequence (DENSE), over the e4m3 staging
// of the paged forms: each 8-code group converts exactly to f32 in
// registers (unpack8), as the TPU kernel casts each e4m3 element straight
// to f32 (flash_decode.py:74-75, :95).
#include "paged_decode.cuh"

namespace sli_pd {

int dispatch_e4m3_dense(bool f32, int head_dim, const Args& a,
                        cudaStream_t st) {
  return f32 ? dispatch_d<float, __nv_fp8_e4m3, true>(head_dim, a, st)
             : dispatch_d<__nv_bfloat16, __nv_fp8_e4m3, true>(head_dim, a,
                                                              st);
}

}  // namespace sli_pd
