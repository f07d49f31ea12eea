// The INT8-KV forms of kernels 4 (paged_decode.cu's note: 4q, 4qw, 4vq,
// 4vqw and their capped, sink and head_dim-256 forms), instantiated in a
// translation unit of their own: the kernel's instantiations over int8
// pools at every head dim and option would otherwise make paged_decode.cu
// the slowest source of the build, which runs one nvcc a source, all at
// once.
#include "paged_decode.cuh"

namespace sli_pd {

int dispatch_i8(bool f32, int head_dim, const Args& a, cudaStream_t st) {
  return f32 ? dispatch_d<float, int8_t>(head_dim, a, st)
             : dispatch_d<__nv_bfloat16, int8_t>(head_dim, a, st);
}

}  // namespace sli_pd
