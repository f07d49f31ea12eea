// Decode attention input in one launch: rmsnorm -> int8 qkv product x
// per-channel scale -> RoPE on q and k -> k/v rows written in place into
// the paged pools; q is returned.
//
// Since the tensor-core regime (qkv_fused_mma.cu, kernel 6m: bf16 rows,
// H a multiple of 64 and the qkv columns of 128; ops/qkv_fused.py
// qkv_regime) serves bf16 rows at every model width the port runs, this
// FMA kernel serves f32 activations and the shapes 6m does not take.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/qkv_fused.py:
//   fused_qkv_append (_kernel, qkv_fused.py:37-184; wrapper :229) in its
//   paged form (tables given), into bf16/f32 pools or, its quantizing
//   (INT8-KV) form, into int8 pools with f32 scale pools; and in its
//   dense-arena form (tables=None, qkv_fused.py:302-304: x row b writes
//   arena row b at slot offsets[b]), into a bf16/f32 arena [L, B', kvN,
//   Smax, D] with B' >= B, where only slot_row changes (no table; a slot
//   past Smax is dropped). Its kv_layer form (qkv_fused.py:294-299: the
//   cache indexed by the grouped engine's group-local layer, the weights
//   by the global one) needs nothing of the kernel: the launcher gets the
//   layer's weight, scale and norm pointers and indexes the pools only by
//   kv_layer. Its FP8-KV form (6e, paged; 6de, the dense arena): the
//   rotated k and the v rows go from f32 straight to e4m3 (qkv_slots.cuh
//   store_pool, the JAX package's rounding), as the TPU kernel rounds them
//   into slabs of the pool dtype (qkv_fused.py:155-158, :370-371).
//
// Bound on the H100: bytes. The qkv weight ([H, (N + 2 kvN) D] int8, 50.3
// MB at Llama-2-7B: 15.0 us at 3.35 TB/s) dominates; x, the tables and
// the new rows are a few KB.
//
// Design: the TPU grid walks in order and carries the normalized rows and
// the qkv columns in scratch from step to step; CUDA blocks run in
// parallel and share nothing, so each block recomputes the rmsnorm of its
// rows (one warp per row, from L2) and owns 128 whole columns: one head of
// D = 128 (or 2 of 64, 4 of 32), so every RoPE pair (c, c + D/2) stays in
// the block; at D 256 (Gemma) the block's 128 columns are two 64-column
// runs of one head, 128 apart (qkv_slots.cuh block_col), so the pairs
// still do (e4m3 pools too, each element rounded on its own; INT8 KV
// below), with the registers and shared
// memory of every other D. It
// streams the int8 product over all of K (int8_rows.cuh:
// 16-byte loads, f32 FMAs against the normalized rows in shared memory),
// applies the per-channel scale, rotates q and k in f32, writes q out and
// stores each k/v row straight into its pool slot. An unmapped (-1) page,
// or a position past the table, writes to the trash page (the pool's last
// page row), the rule of the port's paged_append_decode, so pools compare
// page for page. The TPU kernel's 8-row read-modify-write windows and its
// kv-first walk (qkv_fused.py:41-48, 152-175) served Pallas out-blocks and
// the TPU's DMA queue; a CUDA thread stores only the row it owns, so both
// are gone.
//
// Rounding: the normalized rows are rounded to the activation dtype (the
// TPU kernel rounds them to bf16, qkv_fused.py:76-77) and everything after
// stays f32 until q is stored in the activation dtype and k/v in the pool
// dtype.
//
// INT8 KV (pool_ks/pool_vs given): the rotated k and the v rows, rounded
// to the activation dtype (the TPU kernel rounds them to bf16,
// qkv_fused.py:139-143), go back into the block's tile; then one warp per
// (row, k/v head) reduces the head's absmax over D with shuffles (the
// block owns whole heads, so the reduction stays in the block) and stores
// the codes and the scale with quantize_kv's math: scale = max(absmax /
// 127, 1e-8) by IEEE division, code = rint(x / scale) clipped to +-127
// (qkv_slots.cuh quant_head). At D 256 (Gemma over INT8 KV) a head's
// columns lie in two blocks, so each block leaves its rounded half in
// kv_rows and a second launch, qkv_slots.cuh's quant_heads_kernel,
// quantizes the whole heads, one warp a (row, k/v head), as kernel 6m's
// third launch does. Dead rows write to the trash page, so they never race
// with live rows.
#include "int8_rows.cuh"
#include "qkv_slots.cuh"

namespace {

constexpr int QKV_CT = 8;                   // 16-column groups per block
constexpr int QKV_CW = 16 * QKV_CT;         // 128 columns per block
constexpr int QKV_KL = RT_THREADS / QKV_CT;

// grid (ceil(B / 8), ceil(Nq / 128)).
template <typename T>
__global__ void __launch_bounds__(RT_THREADS, 1) qkv_fused_kernel(
    const T* __restrict__ x, long long ldx, const void* __restrict__ nw,
    int nw_bf16, const int8_t* __restrict__ wq, const float* __restrict__ ws,
    const float* __restrict__ sin_t, const float* __restrict__ cos_t,
    void* pool_k, void* pool_v, float* __restrict__ pool_ks,
    float* __restrict__ pool_vs, int pool_dt, T* __restrict__ q_out,
    const int* __restrict__ tables, const int* __restrict__ positions,
    int layer, int num_pages1, int kvn, int ps, int mp, int b, int h,
    int n_heads, int d, float eps, int vec, float* __restrict__ kv_rows) {
  __shared__ __align__(16) float xs[RT_KC * RT_MT];
  __shared__ __align__(16) float red[QKV_KL * QKV_CW];
  __shared__ __align__(16) float tile[RT_MT * QKV_CW];
  __shared__ float inv[RT_MT];
  const int heads = n_heads + 2 * kvn;
  const int nq = heads * d;
  const int m0 = blockIdx.x * RT_MT;
  const int col0 = blockIdx.y * QKV_CW;  // the INT8-KV pass's (D <= 128)
  const int tid = threadIdx.x;
  const int ct = tid % QKV_CT;
  const int klane = tid / QKV_CT;
  const int c = qkv::block_col(blockIdx.y, ct * 16, d);

  row_rms<T>(x, ldx, m0, b, h, eps, inv);
  float acc[RT_MT][16];
#pragma unroll
  for (int r = 0; r < RT_MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  float sc[16];
  int g_cur = 0;
  for (int k0 = 0; k0 < h; k0 += RT_KC) {
    const int kcnt = min(RT_KC, h - k0);
    stage_rows<T, true>(x, ldx, m0, b, k0, kcnt, inv, nw, nw_bf16, xs);
    stream_rows<QKV_KL, false>(acc, wq + (long long)k0 * nq, nq, c, nq,
                               vec != 0, kcnt, klane, xs, nullptr, k0, h, sc,
                               g_cur);
  }
  reduce_lanes<QKV_CT>(acc, red, tile);
  for (int i = tid; i < RT_MT * QKV_CW; i += RT_THREADS) {
    const int col = qkv::block_col(blockIdx.y, i % QKV_CW, d);
    if (col < nq) tile[i] *= __ldg(ws + col);
  }
  __syncthreads();

  const int half = d / 2;
  for (int i = tid; i < RT_MT * QKV_CW / 2; i += RT_THREADS) {
    const int r = i / (QKV_CW / 2);
    const int p = i - r * (QKV_CW / 2);
    const int t1 = qkv::pair_col(p, d);    // first column of the pair
    const int t2 = qkv::pair_partner(t1, d);
    const int g1 = qkv::block_col(blockIdx.y, t1, d);
    const int j = g1 % d;
    const int head = g1 / d;
    const int row = m0 + r;
    if (row >= b || head >= heads) continue;
    const float x1 = tile[r * QKV_CW + t1];
    const float x2 = tile[r * QKV_CW + t2];
    float r1 = x1, r2 = x2;
    if (head < n_heads + kvn) {
      const float s = sin_t[(long long)row * half + j];
      const float co = cos_t[(long long)row * half + j];
      r1 = x1 * co - x2 * s;
      r2 = x2 * co + x1 * s;
    }
    if (head < n_heads) {
      T* qo = q_out + ((long long)row * n_heads + head) * d;
      qo[j] = sli::from_f<T>(r1);
      qo[j + half] = sli::from_f<T>(r2);
      continue;
    }
    if (pool_ks != nullptr) {  // INT8 KV: the pass below, at D 256 the
                               // second launch
      float* c1 = d == 256 ? kv_rows + ((long long)row * 2 * kvn + head -
                                        n_heads) * d + j
                           : tile + r * QKV_CW + t1;
      float* c2 = d == 256 ? c1 + half : tile + r * QKV_CW + t2;
      *c1 = sli::to_f(sli::from_f<T>(r1));
      *c2 = sli::to_f(sli::from_f<T>(r2));
      continue;
    }
    const bool is_k = head < n_heads + kvn;
    const int kh = is_k ? head - n_heads : head - n_heads - kvn;
    const long long srow = qkv::slot_row(tables, positions, row, kh,
                                         layer, num_pages1, kvn, ps, mp);
    if (srow < 0) continue;  // dense arena: a slot past Smax is dropped
    const long long off = srow * (long long)d;
    void* pool = is_k ? pool_k : pool_v;
    qkv::store_pool(pool, pool_dt, off + j, r1);
    qkv::store_pool(pool, pool_dt, off + j + half, r2);
  }
  if (pool_ks == nullptr || d == 256) return;

  // INT8 KV: one warp per (row, k/v head) of the block's whole heads
  __syncthreads();
  const int warp = tid / 32;
  const int hpb = QKV_CW / d;  // whole heads per block
  for (int t = warp; t < RT_MT * hpb; t += RT_THREADS / 32) {
    const int r = t / hpb;
    const int hb = t - r * hpb;
    const int head = col0 / d + hb;
    const int row = m0 + r;
    if (row >= b || head < n_heads || head >= heads) continue;
    const bool is_k = head < n_heads + kvn;
    const int kh = is_k ? head - n_heads : head - n_heads - kvn;
    const long long srow = qkv::slot_row(tables, positions, row, kh,
                                         layer, num_pages1, kvn, ps, mp);
    if (srow < 0) continue;
    qkv::quant_head(tile + r * QKV_CW + hb * d, d, tid % 32,
                    reinterpret_cast<int8_t*>(is_k ? pool_k : pool_v) +
                        srow * (long long)d,
                    (is_k ? pool_ks : pool_vs) + srow);
  }
}

}  // namespace

extern "C" {

// x: [b, h] at row stride ldx (x_dtype); nw: the layer's norm weight [h]
// (f32, or bf16 when nw_bf16); wq: the layer's [h, (n_heads + 2 kvn) d]
// int8; ws: its [(n_heads + 2 kvn) d] f32 scales; sin/cos: [b, d/2] f32;
// pools: [L, num_pages1, kvn, ps, d] of pool_dt (SLI_POOL_F32, _BF16, or
// _E4M3: form 6e),
// written in place at pool layer `kv_layer` (the weight layer's pointers
// come in already); q_out: [b, n_heads, d] (x_dtype); tables:
// [b, mp] int32; positions: [b] int32. vec: wq and its row length allow
// 16-byte loads. pool_ks/pool_vs: null, or (INT8 KV) the f32 scale pools
// [L, num_pages1, kvn, ps] of int8 pools (pool_dt SLI_POOL_I8); kv_rows:
// INT8 KV at d 256, b * 2 kvn * d floats of scratch (null otherwise). d
// 32, 64, 128 or 256 (every pool dtype).
int sli_qkv_fused(const void* x, long long ldx, const void* nw, int nw_bf16,
                  const void* wq, const float* ws, const float* sin_t,
                  const float* cos_t, void* pool_k, void* pool_v,
                  void* pool_ks, void* pool_vs, int pool_dt, void* q_out,
                  const int* tables,
                  const int* positions, int kv_layer, int num_pages1,
                  int kvn, int ps, int mp, int b, int h, int n_heads, int d,
                  float eps, int x_dtype, int vec, float* kv_rows,
                  void* stream) {
  if (b <= 0 || h <= 0 || n_heads <= 0 || kvn <= 0 || ps <= 0 || mp <= 0)
    return SLI_ERR_SHAPE;
  if (d != 32 && d != 64 && d != 128 && d != 256) return SLI_ERR_HEAD_DIM;
  if ((pool_ks == nullptr) != (pool_vs == nullptr)) return SLI_ERR_SHAPE;
  if (d == 256 && pool_ks != nullptr && (kv_rows == nullptr ||
                                         tables == nullptr))
    return SLI_ERR_SHAPE;
  if (!qkv::pool_ok(pool_dt, pool_ks != nullptr)) return SLI_ERR_DTYPE;
  float* ks = (float*)pool_ks;
  float* vs = (float*)pool_vs;
  const int nq = (n_heads + 2 * kvn) * d;
  const dim3 grid((b + RT_MT - 1) / RT_MT, (nq + QKV_CW - 1) / QKV_CW);
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* w = (const int8_t*)wq;
  if (x_dtype == SLI_F32) {
    qkv_fused_kernel<float><<<grid, RT_THREADS, 0, st>>>(
        (const float*)x, ldx, nw, nw_bf16, w, ws, sin_t, cos_t, pool_k,
        pool_v, ks, vs, pool_dt, (float*)q_out, tables, positions,
        kv_layer, num_pages1, kvn, ps, mp, b, h, n_heads, d, eps, vec,
        kv_rows);
  } else if (x_dtype == SLI_BF16) {
    qkv_fused_kernel<__nv_bfloat16><<<grid, RT_THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, ldx, nw, nw_bf16, w, ws, sin_t, cos_t,
        pool_k, pool_v, ks, vs, pool_dt, (__nv_bfloat16*)q_out, tables,
        positions, kv_layer, num_pages1, kvn, ps, mp, b, h, n_heads, d, eps,
        vec, kv_rows);
  } else {
    return SLI_ERR_DTYPE;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || ks == nullptr || d != 256) return (int)e;
  return (int)qkv::quant_heads(kv_rows, pool_k, pool_v, ks, vs, tables,
                               positions, kv_layer, num_pages1, kvn, ps, mp,
                               b, d, st);
}

// The dense-arena form (fused_qkv_append with tables=None): cache_k/v are
// [L, arena_rows, kvn, smax, d] (cache_dt SLI_POOL_F32, _BF16 or _E4M3:
// form 6de, k/v rounded from f32 to e4m3 once); x row b < b_rows <=
// arena_rows writes arena row b at slot positions[b] (dropped outside
// [0, smax)). Other arguments as sli_qkv_fused; no INT8-KV form (the JAX
// dense arena has no scale pools).
int sli_qkv_fused_dense(const void* x, long long ldx, const void* nw,
                        int nw_bf16, const void* wq, const float* ws,
                        const float* sin_t, const float* cos_t,
                        void* cache_k, void* cache_v, int cache_dt,
                        void* q_out, const int* positions, int layer,
                        int arena_rows, int kvn, int smax, int b, int h,
                        int n_heads, int d, float eps, int x_dtype, int vec,
                        void* stream) {
  if (b > arena_rows) return SLI_ERR_SHAPE;
  if (cache_dt != SLI_POOL_F32 && cache_dt != SLI_POOL_BF16 &&
      cache_dt != SLI_POOL_E4M3)
    return SLI_ERR_DTYPE;
  return sli_qkv_fused(x, ldx, nw, nw_bf16, wq, ws, sin_t, cos_t, cache_k,
                       cache_v, nullptr, nullptr, cache_dt, q_out, nullptr,
                       positions, layer, arena_rows, kvn, smax, 1, b, h,
                       n_heads, d, eps, x_dtype, vec, nullptr, stream);
}

}  // extern "C"
