// Form 8l: chunked-prefill attention through the page tables of a
// shared-KV pool (absorbed MLA: one latent row per token that is both the
// key and the value), causal from each sequence's chunk offset.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/attention/
// paged_prefill.py: _paged_prefill_kernel with shared_kv (:44, :55-58,
// :114-118), reached through paged_flash_prefill with v_pool None (:156,
// :188). The kernels and their bound are prefill_shared.cuh's: each key
// tile, its rows found page by page in the table (key p at row p % ps of
// page tables[b, p / ps]; an unmapped page reads as zeros), staged once
// for both products, the output in passes of 128 columns; bf16 on the
// tensor cores (wgmma), f32 on FMAs.
#include "prefill_shared.cuh"

namespace {

namespace pfa = sli::pfa;
namespace pfs = sli::pfs;

template <int D>
__device__ __forceinline__ pfs::PagedRows rows_of(const int* tables, int b,
                                                  int mp, int layer,
                                                  int num_pages1, int kvn,
                                                  int kh, int ps) {
  return pfs::PagedRows{tables + (long long)b * mp,
                        (long long)layer * num_pages1, kvn, kh, ps,
                        num_pages1, D};
}

// bf16 q [B, Sq, N, D] (element strides q_bs, q_ss; 16-byte aligned rows)
// against a bf16 pool [L, P+1, kvN, ps, D]; out [B, Sq, N, D] contiguous,
// or the split partials in work.
template <int D>
__global__ void __launch_bounds__(pfa::NT) paged_prefill_shared_mma_kernel(
    const __nv_bfloat16* __restrict__ q, long long q_bs, long long q_ss,
    const __nv_bfloat16* __restrict__ pool, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, const int* __restrict__ offs,
    __nv_bfloat16* __restrict__ out, float* __restrict__ work, int batch,
    int seq, int heads, int layer, int num_pages1, int kvn, int ps, int mp,
    int group, float mul, int splits) {
  const int b = blockIdx.z / splits;
  pfs::attend_shared_mma<D>(
      q + (long long)b * q_bs, q_ss, pool,
      rows_of<D>(tables, b, mp, layer, num_pages1, kvn, (int)blockIdx.y, ps),
      out + (long long)b * seq * heads * D, work, batch, b, seq, heads,
      group, offs[b], min(kv_lens[b], mp * ps), mul, splits);
}

// f32: grid (ceil(Sq / 32), N, B).
template <int D>
__global__ void __launch_bounds__(pfs::FNT) paged_prefill_shared_fma_kernel(
    const float* __restrict__ q, long long q_bs, long long q_ss,
    const float* __restrict__ pool, const int* __restrict__ tables,
    const int* __restrict__ kv_lens, const int* __restrict__ offs,
    float* __restrict__ out, int seq, int heads, int layer, int num_pages1,
    int kvn, int ps, int mp, int group, float scale) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  pfs::attend_shared_fma<D>(
      q + (long long)b * q_bs + (long long)h * D, q_ss, pool,
      rows_of<D>(tables, b, mp, layer, num_pages1, kvn, h / group, ps),
      out + ((long long)b * seq * heads + h) * D, (long long)heads * D, seq,
      offs[b], min(kv_lens[b], mp * ps), scale);
}

template <int D>
int launch(const void* q, long long q_bs, long long q_ss, const void* pool,
           const int* tables, const int* kv_lens, const int* offs, void* out,
           int batch, int seq, int heads, int layer, int num_pages1, int kvn,
           int ps, int mp, float scale, int dtype, float* work, int splits,
           cudaStream_t st) {
  const int group = heads / kvn;
  if (dtype == SLI_F32) {
    if (splits != 1) return SLI_ERR_SHAPE;
    constexpr size_t bytes = pfs::fma_smem_bytes<D>();
    auto kern = paged_prefill_shared_fma_kernel<D>;
    cudaError_t e = sli::allow_smem(kern, bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((seq + pfs::FQ - 1) / pfs::FQ, heads, batch);
    kern<<<grid, pfs::FNT, bytes, st>>>(
        (const float*)q, q_bs, q_ss, (const float*)pool, tables, kv_lens,
        offs, (float*)out, seq, heads, layer, num_pages1, kvn, ps, mp, group,
        scale);
    return (int)cudaGetLastError();
  }
  if (dtype != SLI_BF16) return SLI_ERR_DTYPE;
  if (((unsigned long long)q | (unsigned long long)pool |
       (unsigned long long)out) % 16 || q_bs % 8 || q_ss % 8)
    return SLI_ERR_SHAPE;
  constexpr int bytes = pfs::MmaSmem<D>::BYTES;
  auto kern = paged_prefill_shared_mma_kernel<D>;
  cudaError_t e = sli::allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  const int h = min(group, pfa::TILE);
  const int tiles = (seq + pfa::TILE / h - 1) / (pfa::TILE / h) *
                    ((group + h - 1) / h);
  const dim3 grid(tiles, kvn, batch * splits);
  kern<<<grid, pfa::NT, bytes, st>>>(
      (const __nv_bfloat16*)q, q_bs, q_ss, (const __nv_bfloat16*)pool,
      tables, kv_lens, offs, (__nv_bfloat16*)out, work, batch, seq, heads,
      layer, num_pages1, kvn, ps, mp, group, scale * pfa::LOG2E, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)sli::launch_merge<__nv_bfloat16>(
      work, out, (long long)batch * seq * heads, D, splits, st);
}

}  // namespace

// q [B, Sq, N, D] of dtype (SLI_F32 or SLI_BF16) at element strides q_bs,
// q_ss, heads contiguous, its rows at positions offs[b] + 0..Sq-1; pool:
// the shared pool [L, num_pages1, kvN, ps, D] of q's dtype; tables [B, mp]
// (-1 unmapped), kv_lens [B]; out [B, Sq, N, D] contiguous. D 128 or 640.
// bf16 with splits > 1: work holds splits * B * Sq * N * (D + 2) floats;
// f32: splits 1.
extern "C" int sli_paged_flash_prefill_shared(
    const void* q, long long q_bs, long long q_ss, const void* pool,
    const int* tables, const int* kv_lens, const int* offs, void* out,
    int batch, int seq, int heads, int layer, int num_pages1, int kvn, int ps,
    int mp, int head_dim, float scale, int dtype, void* work, int splits,
    void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || kvn <= 0 || heads % kvn ||
      ps <= 0 || mp <= 0 || layer < 0 || splits < 1 ||
      (splits > 1 && work == nullptr))
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 128:
      return launch<128>(q, q_bs, q_ss, pool, tables, kv_lens, offs, out,
                         batch, seq, heads, layer, num_pages1, kvn, ps, mp,
                         scale, dtype, (float*)work, splits, st);
    case 640:
      return launch<640>(q, q_bs, q_ss, pool, tables, kv_lens, offs, out,
                         batch, seq, heads, layer, num_pages1, kvn, ps, mp,
                         scale, dtype, (float*)work, splits, st);
    default:
      return SLI_ERR_HEAD_DIM;
  }
}
