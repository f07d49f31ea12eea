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

// INT8 KV: one (row, k/v head)'s d values src (rounded to the activation
// dtype) into its slot's codes dst and scale, by one warp, with
// quantize_kv's math: scale = max(absmax / 127, 1e-8) by IEEE division,
// code = rint(x / scale) clipped to +-127.
__device__ __forceinline__ void quant_head(const float* src, int d, int lane,
                                           int8_t* dst, float* scale_dst) {
  float amax = 0.f;
  for (int i = lane; i < d; i += 32) amax = fmaxf(amax, fabsf(src[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = fmaxf(amax / 127.f, 1e-8f);
  for (int i = lane; i < d; i += 32)
    dst[i] = (int8_t)fminf(fmaxf(rintf(src[i] / sc), -127.f), 127.f);
  if (lane == 0) *scale_dst = sc;
}

// INT8 KV at D 256 (Gemma): a head's 256 columns lie in two column blocks
// (block_col), so neither block sees the head's absmax. The blocks leave
// their rounded k/v values in kv_rows [b][2 kvn][d] f32 (k heads, then v
// heads) and this kernel, launched after them on the same stream, one warp
// a (row, k/v head), 8 warps a block, quantizes each into its slot: no
// counter and no host read, the grid from shapes alone.
static __global__ void __launch_bounds__(256) quant_heads_kernel(
    const float* __restrict__ kv_rows, int8_t* __restrict__ pool_k,
    int8_t* __restrict__ pool_v, float* __restrict__ pool_ks,
    float* __restrict__ pool_vs, const int* __restrict__ tables,
    const int* __restrict__ positions, int layer, int num_pages1, int kvn,
    int ps, int mp, int b, int d) {
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= b * 2 * kvn) return;
  const int row = w / (2 * kvn);
  const int hh = w - row * 2 * kvn;
  const bool is_k = hh < kvn;
  const long long srow = slot_row(tables, positions, row, is_k ? hh : hh - kvn,
                                  layer, num_pages1, kvn, ps, mp);
  if (srow < 0) return;  // (paged pools only: never)
  quant_head(kv_rows + (long long)w * d, d, threadIdx.x & 31,
             (is_k ? pool_k : pool_v) + srow * (long long)d,
             (is_k ? pool_ks : pool_vs) + srow);
}

// The launch of quant_heads_kernel for b rows of 2 kvn heads.
__host__ inline cudaError_t quant_heads(const float* kv_rows, void* pool_k,
                                        void* pool_v, float* pool_ks,
                                        float* pool_vs, const int* tables,
                                        const int* positions, int layer,
                                        int num_pages1, int kvn, int ps,
                                        int mp, int b, int d,
                                        cudaStream_t st) {
  const int warps = b * 2 * kvn;
  quant_heads_kernel<<<(warps + 7) / 8, 256, 0, st>>>(
      kv_rows, (int8_t*)pool_k, (int8_t*)pool_v, pool_ks, pool_vs, tables,
      positions, layer, num_pages1, kvn, ps, mp, b, d);
  return cudaGetLastError();
}

// pool_dt: SLI_POOL_F32, SLI_POOL_BF16 or SLI_POOL_E4M3 (INT8 pools are
// quantized by quant_head, not through here).
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
