// Where kernel 6's k/v rows go: the slot of a token in the paged pools or
// the dense arena, and a store in the pool's dtype (f32, bf16, or e4m3 with
// the JAX package's rounding: form 6e, the k/v rows rounded from f32 to
// the pool dtype once, as the TPU kernel's slabs are, qkv_fused.py:155-158,
// :370-371). Shared by the FMA
// kernel (qkv_fused.cu) and the tensor-core one (qkv_fused_mma.cu).
#pragma once

#include "common.cuh"

namespace qkv {

// Row index into [L, num_pages1, kvn, ps] of token `row`'s slot for kv
// head kh: an unmapped page or a position past the table -> the trash page.
// Without tables (the dense arena [L, B', kvn, Smax, D]: num_pages1 = B',
// ps = Smax) x row `row` owns arena row `row`, and a slot outside
// [0, Smax) gives -1: the row is dropped.
__device__ __forceinline__ long long slot_row(const int* __restrict__ tables,
                                              const int* __restrict__ positions,
                                              int row, int kh, int layer,
                                              int num_pages1, int kvn, int ps,
                                              int mp) {
  const int pos = positions[row];
  int page;
  int slot;
  if (tables == nullptr) {
    if (pos < 0 || pos >= ps) return -1;
    page = row;
    slot = pos;
  } else {
    const int pc = pos >= 0 ? pos / ps : -1;
    page = (pc >= 0 && pc < mp) ? tables[(long long)row * mp + pc] : -1;
    if (page < 0) page = num_pages1 - 1;
    slot = pos >= 0 ? pos % ps : 0;
  }
  return (((long long)layer * num_pages1 + page) * kvn + kh) * ps + slot;
}

// The qkv column of local column t (0 .. 127) of column block x, for both
// kernels: 128 contiguous columns at D <= 128 (whole heads, so every RoPE
// pair (c, c + D/2) stays in the block); at D 256 (Gemma) a pair would
// span two such blocks, so block x takes two 64-column runs of head x / 2,
// [64 (x % 2), + 64) and the 64 columns D/2 = 128 past them: local
// column t < 64 pairs with t + 64, and every pair stays in the block.
__host__ __device__ __forceinline__ int block_col(int x, int t, int d) {
  if (d < 256) return x * 128 + t;
  return (x >> 1) * 256 + (x & 1) * 64 + (t & 63) + (t >> 6) * 128;
}

// The local columns (t1, t2 = the partner D/2 past t1's qkv column) of a
// block's pair p (0 .. 63).
__device__ __forceinline__ int pair_col(int p, int d) {
  const int half = d >> 1;
  return d < 256 ? (p / half) * d + p % half : p;
}
__device__ __forceinline__ int pair_partner(int t1, int d) {
  return t1 + (d < 256 ? d >> 1 : 64);
}

// pool_dt: SLI_POOL_F32, SLI_POOL_BF16 or SLI_POOL_E4M3 (INT8 pools are
// quantized by the kernels' own pass, not through here).
__device__ __forceinline__ void store_pool(void* pool, int pool_dt,
                                           long long i, float v) {
  if (pool_dt == SLI_POOL_BF16) {
    reinterpret_cast<__nv_bfloat16*>(pool)[i] = __float2bfloat16(v);
  } else if (pool_dt == SLI_POOL_E4M3) {
    reinterpret_cast<unsigned char*>(pool)[i] = sli::f_to_e4m3(v);
  } else {
    reinterpret_cast<float*>(pool)[i] = v;
  }
}

// A pool dtype code the kernels take: f32, bf16 or e4m3 without scale
// pools, int8 with them.
__host__ inline bool pool_ok(int pool_dt, bool scales) {
  return scales ? pool_dt == SLI_POOL_I8
                : (pool_dt == SLI_POOL_F32 || pool_dt == SLI_POOL_BF16 ||
                   pool_dt == SLI_POOL_E4M3);
}

}  // namespace qkv
