// INT8-KV paged writes: quantize new K/V rows per (token, kv head) and store
// the int8 codes and the f32 scale in place, one decode row per sequence or
// whole prompt pages at prefill.
//
// Replaces the TPU kernels of simplellminference_tpu/ops/paged_append.py:
//   paged_append_decode_quant  (_decode_quant_kernel,  paged_append.py:192-281)
//   paged_append_prefill_quant (_prefill_quant_kernel, paged_append.py:284-365)
// Both TPU kernels receive rows that XLA quantized beforehand
// (memory/paged_kv.py quantize_kv) and only copy them; here the
// quantization runs in the kernel, so the f32 rows never go to device
// memory.
//
// Bound on the H100: bytes. Each new row is read once (D elements of
// bf16/f32) and written once (D int8 codes + one f32 scale); a prefill
// also writes the zero tail of its last page.
//
// Design: one warp owns one (row, kv head): it holds the row's D <= 256
// values in registers (lane i takes elements i, i + 32, ...), reduces the
// absolute maximum across its lanes with shuffles, and stores every code
// and, from lane 0, the scale. The math is quantize_kv's exactly:
// scale = max(absmax / 127, 1e-8) with IEEE division (no fast math), code
// = rint(x / scale) (round half to even, as jnp.round and torch.round)
// clipped to +-127, so the pools are byte-equal to the plain version's.
// A CUDA thread stores only what it owns: the TPU kernels' whole-page
// read-modify-write (a Pallas out block always writes back) is gone.
// Unmapped (-1) table entries and columns past the table go to the trash
// page (the pool's last page row); prefill rows past the prompt get code 0
// and scale 0, as the JAX package's zero pad after quantizing.
#include "common.cuh"

namespace {

constexpr int QMAX = 8;  // values per lane: D <= 256

template <typename T>
__device__ __forceinline__ void quant_row(const T* __restrict__ src,
                                          int8_t* __restrict__ dst,
                                          float* __restrict__ scale_dst,
                                          int d, int lane) {
  float v[QMAX];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < QMAX; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < d ? sli::to_f(src[i]) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = fmaxf(amax / 127.f, 1e-8f);
#pragma unroll
  for (int j = 0; j < QMAX; ++j) {
    const int i = lane + 32 * j;
    if (i < d)
      dst[i] = (int8_t)fminf(fmaxf(rintf(v[j] / scale), -127.f), 127.f);
  }
  if (lane == 0) *scale_dst = scale;
}

__device__ __forceinline__ void zero_row(int8_t* __restrict__ dst,
                                         float* __restrict__ scale_dst,
                                         int d, int lane) {
  for (int i = lane; i < d; i += 32) dst[i] = 0;
  if (lane == 0) *scale_dst = 0.f;
}

// grid (B, kvN), 64 threads: warp 0 quantizes row (b, h) of new K, warp 1
// of new V, into slot pos % ps of page tables[b, pos / ps]. Strides are in
// elements.
template <typename T>
__global__ void __launch_bounds__(64) paged_append_decode_quant_kernel(
    int8_t* __restrict__ pool_k, int8_t* __restrict__ pool_v,
    float* __restrict__ pool_ks, float* __restrict__ pool_vs,
    const T* __restrict__ new_k, const T* __restrict__ new_v, long long k_bs,
    long long v_bs, const int* __restrict__ tables,
    const int* __restrict__ positions, int layer, int num_pages1, int kvn,
    int ps, int d, int mp) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos = positions[b];
  const int col = pos >= 0 ? pos / ps : -1;
  int page = (col >= 0 && col < mp) ? tables[(long long)b * mp + col] : -1;
  if (page < 0) page = num_pages1 - 1;
  const int slot = pos >= 0 ? pos % ps : 0;
  const long long row =
      (((long long)layer * num_pages1 + page) * kvn + h) * ps + slot;
  if (warp == 0) {
    quant_row(new_k + (long long)b * k_bs + (long long)h * d,
              pool_k + row * d, pool_ks + row, d, lane);
  } else {
    quant_row(new_v + (long long)b * v_bs + (long long)h * d,
              pool_v + row * d, pool_vs + row, d, lane);
  }
}

constexpr int PQ_THREADS = 256;

// grid (B, ceil(S/ps), kvN): the block fills page tables[b, pg] of head h:
// its ps K rows and ps V rows, one (row, K or V) per warp at a time.
template <typename T>
__global__ void __launch_bounds__(PQ_THREADS) paged_append_prefill_quant_kernel(
    int8_t* __restrict__ pool_k, int8_t* __restrict__ pool_v,
    float* __restrict__ pool_ks, float* __restrict__ pool_vs,
    const T* __restrict__ new_k, const T* __restrict__ new_v, long long k_bs,
    long long k_ss, long long v_bs, long long v_ss,
    const int* __restrict__ tables, int layer, int num_pages1, int kvn,
    int ps, int d, int mp, int seq) {
  const int b = blockIdx.x;
  const int pg = blockIdx.y;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int page = pg < mp ? tables[(long long)b * mp + pg] : -1;
  if (page < 0) page = num_pages1 - 1;
  const long long row0 =
      (((long long)layer * num_pages1 + page) * kvn + h) * (long long)ps;
  for (int t = warp; t < 2 * ps; t += PQ_THREADS / 32) {
    const bool is_v = t >= ps;
    const int r = is_v ? t - ps : t;
    const int s = pg * ps + r;
    int8_t* dst = (is_v ? pool_v : pool_k) + (row0 + r) * d;
    float* sdst = (is_v ? pool_vs : pool_ks) + row0 + r;
    if (s < seq) {
      const T* src = is_v ? new_v + (long long)b * v_bs + (long long)s * v_ss
                          : new_k + (long long)b * k_bs + (long long)s * k_ss;
      quant_row(src + (long long)h * d, dst, sdst, d, lane);
    } else {
      zero_row(dst, sdst, d, lane);
    }
  }
}

}  // namespace

extern "C" {

// pools [L, num_pages1, kvn, ps, d] int8 and scale pools [L, num_pages1,
// kvn, ps] f32, written in place at `layer`; new_k/v [batch, kvn, d]
// (dtype) with batch strides k_bs/v_bs in elements; tables [batch, mp];
// positions [batch].
int sli_paged_append_decode_quant(void* pool_k, void* pool_v, void* pool_ks,
                                  void* pool_vs, const void* new_k,
                                  const void* new_v, long long k_bs,
                                  long long v_bs, const int* tables,
                                  const int* positions, int layer,
                                  int num_pages1, int kvn, int ps, int d,
                                  int mp, int batch, int dtype,
                                  void* stream) {
  if (batch <= 0 || kvn <= 0 || ps <= 0 || mp <= 0) return SLI_ERR_SHAPE;
  if (d <= 0 || d > 32 * QMAX) return SLI_ERR_HEAD_DIM;
  const dim3 grid(batch, kvn);
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* pk = (int8_t*)pool_k;
  int8_t* pv = (int8_t*)pool_v;
  float* ks = (float*)pool_ks;
  float* vs = (float*)pool_vs;
  if (dtype == SLI_F32) {
    paged_append_decode_quant_kernel<float><<<grid, 64, 0, st>>>(
        pk, pv, ks, vs, (const float*)new_k, (const float*)new_v, k_bs, v_bs,
        tables, positions, layer, num_pages1, kvn, ps, d, mp);
  } else if (dtype == SLI_BF16) {
    paged_append_decode_quant_kernel<__nv_bfloat16><<<grid, 64, 0, st>>>(
        pk, pv, ks, vs, (const __nv_bfloat16*)new_k,
        (const __nv_bfloat16*)new_v, k_bs, v_bs, tables, positions, layer,
        num_pages1, kvn, ps, d, mp);
  } else {
    return SLI_ERR_DTYPE;
  }
  return (int)cudaGetLastError();
}

// new_k/v [batch, seq, kvn, d] (dtype) with batch and row strides in
// elements; tables[:, :ceil(seq / ps)] name the pages.
int sli_paged_append_prefill_quant(void* pool_k, void* pool_v, void* pool_ks,
                                   void* pool_vs, const void* new_k,
                                   const void* new_v, long long k_bs,
                                   long long k_ss, long long v_bs,
                                   long long v_ss, const int* tables,
                                   int layer, int num_pages1, int kvn, int ps,
                                   int d, int mp, int batch, int seq,
                                   int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || kvn <= 0 || ps <= 0 || mp <= 0)
    return SLI_ERR_SHAPE;
  if (d <= 0 || d > 32 * QMAX) return SLI_ERR_HEAD_DIM;
  const dim3 grid(batch, (seq + ps - 1) / ps, kvn);
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* pk = (int8_t*)pool_k;
  int8_t* pv = (int8_t*)pool_v;
  float* ks = (float*)pool_ks;
  float* vs = (float*)pool_vs;
  if (dtype == SLI_F32) {
    paged_append_prefill_quant_kernel<float><<<grid, PQ_THREADS, 0, st>>>(
        pk, pv, ks, vs, (const float*)new_k, (const float*)new_v, k_bs, k_ss,
        v_bs, v_ss, tables, layer, num_pages1, kvn, ps, d, mp, seq);
  } else if (dtype == SLI_BF16) {
    paged_append_prefill_quant_kernel<__nv_bfloat16>
        <<<grid, PQ_THREADS, 0, st>>>(
            pk, pv, ks, vs, (const __nv_bfloat16*)new_k,
            (const __nv_bfloat16*)new_v, k_bs, k_ss, v_bs, v_ss, tables,
            layer, num_pages1, kvn, ps, d, mp, seq);
  } else {
    return SLI_ERR_DTYPE;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
