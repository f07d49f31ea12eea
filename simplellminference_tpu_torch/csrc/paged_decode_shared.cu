// Form 4l: paged flash decode over a shared-KV pool (absorbed MLA), one
// pool whose latent row is both the key and the value, instantiated here,
// apart from paged_decode.cu, so that nvcc builds it in parallel with the
// other forms. The kernel is paged_decode.cuh's with SHARED: each 64-key
// tile is staged once and serves both the scores (q . row) and the PV
// product (p . row), as the TPU kernel's v = k reads one VMEM block.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/attention/
// paged_decode.py: _paged_kernel with shared_kv (:24, :36-40, :110-111),
// reached through paged_flash_decode with v_pool None (:165, :192).
//
// Bound on the H100, at DeepSeek-V2-Lite's absorbed geometry (16 q heads
// over one latent row of 640 lanes, 8 sequences at ~1,152 keys): bytes
// 11.8 MB a layer (3.5 us at 3.35 TB/s) and operations 4 x 16 x 640 = 41k
// a key (377 MFLOP a call, 5.6 us on the FP32 CUDA cores at 67 TFLOP/s),
// so the FMA body is compute-bound here: the GQA group of 16 makes the
// kernel do 16 rows' dot products for every row it reads. Moving the
// group's QK^T and PV onto mma.sync is later work.
//
// Design at D 640: a block holds the group's 16 rows (row_block<640>), q
// in shared memory as f32 (40 KB); bf16 tiles through a ring of 2 stages
// of K alone (2 x 82,944 bytes, 211,712 in all), f32 tiles one stage at a
// time (164,864 bytes, 210,432 in all); one block an SM. Only B x kvN = 8
// (sequence, kv head) pairs give blocks, so the wrapper's decode_splits
// cuts the key walk into up to 32 splits, merged by split_merge.cuh's
// row-wide merge (640 columns are more than a merge block's threads). PV
// units: 80 column groups a row, 3 a thread's rows apart (paged_decode.
// cuh's note). D 128 (the tiny MLA configurations' latent lane) takes the
// same template with the D-128 ring (3 bf16 stages of K alone).
#include "paged_decode.cuh"

namespace sli_pd {

int dispatch_shared(bool f32, int head_dim, const Args& a, cudaStream_t st) {
  if (a.ksp != nullptr || a.sinks != nullptr || a.window != 0 ||
      a.cap != 0.f)
    return SLI_ERR_SHAPE;  // the options MLA has not: refused
  switch (head_dim) {
    case 128:
      return f32 ? launch<float, float, 128, false, false, true>(a, st)
                 : launch<__nv_bfloat16, __nv_bfloat16, 128, false, false,
                          true>(a, st);
    case 640:
      return f32 ? launch<float, float, 640, false, false, true>(a, st)
                 : launch<__nv_bfloat16, __nv_bfloat16, 640, false, false,
                          true>(a, st);
    default:
      return SLI_ERR_HEAD_DIM;
  }
}

}  // namespace sli_pd
