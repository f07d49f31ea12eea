// Form 3l: causal attention of a whole prompt over its fresh shared-KV
// rows (absorbed MLA: the JAX package's whole-prompt prefill calls
// dispatch.attention(q, k, v=k), llama.py:713-717, and its dispatcher
// sends D 640 to the Pallas kernel, dispatch.py:36-40).
//
// Replaces the TPU kernel of simplellminference_tpu/ops/attention/
// flash_prefill.py: flash_prefill (_flash_kernel, wrapper :102) called
// with v = k. The kernels and their bound are prefill_shared.cuh's:
// each row tile staged once for both products, the output in passes of
// 128 columns; bf16 on the tensor cores (wgmma), f32 on FMAs.
#include "prefill_shared.cuh"

namespace {

namespace pfa = sli::pfa;
namespace pfs = sli::pfs;

// bf16 q [B, S, N, D], k [B, S, kvN, D] (element strides, heads
// contiguous, 16-byte aligned rows); out [B, S, N, D] contiguous, or the
// split partials in work.
template <int D>
__global__ void __launch_bounds__(pfa::NT) flash_prefill_shared_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    __nv_bfloat16* __restrict__ out, float* __restrict__ work,
    long long q_bs, long long q_ss, long long k_bs, long long k_ss, int batch,
    int seq, int heads, int group, float mul, int splits) {
  const int b = blockIdx.z / splits;
  const long long kh = blockIdx.y;
  pfs::attend_shared_mma<D>(q + b * q_bs, q_ss, k + b * k_bs + kh * D,
                            pfs::DenseRows{k_ss},
                            out + (long long)b * seq * heads * D, work, batch,
                            b, seq, heads, group, 0, seq, mul, splits);
}

// f32: grid (ceil(S / 32), N, B).
template <int D>
__global__ void __launch_bounds__(pfs::FNT) flash_prefill_shared_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    float* __restrict__ out, long long q_bs, long long q_ss, long long k_bs,
    long long k_ss, int seq, int heads, int group, float scale) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  pfs::attend_shared_fma<D>(q + b * q_bs + (long long)h * D, q_ss,
                            k + b * k_bs + (long long)(h / group) * D,
                            pfs::DenseRows{k_ss},
                            out + ((long long)b * seq * heads + h) * D,
                            (long long)heads * D, seq, 0, seq, scale);
}

template <int D>
int launch(const void* q, const void* k, void* out, long long q_bs,
           long long q_ss, long long k_bs, long long k_ss, int batch,
           int seq, int heads, int group, float scale, int dtype,
           float* work, int splits, cudaStream_t st) {
  if (dtype == SLI_F32) {
    if (splits != 1) return SLI_ERR_SHAPE;
    constexpr size_t bytes = pfs::fma_smem_bytes<D>();
    auto kern = flash_prefill_shared_fma_kernel<D>;
    cudaError_t e = sli::allow_smem(kern, bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((seq + pfs::FQ - 1) / pfs::FQ, heads, batch);
    kern<<<grid, pfs::FNT, bytes, st>>>((const float*)q, (const float*)k,
                                        (float*)out, q_bs, q_ss, k_bs, k_ss,
                                        seq, heads, group, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != SLI_BF16) return SLI_ERR_DTYPE;
  if (((unsigned long long)q | (unsigned long long)k |
       (unsigned long long)out) % 16 || (q_bs | q_ss | k_bs | k_ss) % 8)
    return SLI_ERR_SHAPE;
  constexpr int bytes = pfs::MmaSmem<D>::BYTES;
  auto kern = flash_prefill_shared_mma_kernel<D>;
  cudaError_t e = sli::allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  const int h = min(group, pfa::TILE);
  const int tiles = (seq + pfa::TILE / h - 1) / (pfa::TILE / h) *
                    ((group + h - 1) / h);
  const dim3 grid(tiles, heads / group, batch * splits);
  kern<<<grid, pfa::NT, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (__nv_bfloat16*)out,
      work, q_bs, q_ss, k_bs, k_ss, batch, seq, heads, group,
      scale * pfa::LOG2E, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)sli::launch_merge<__nv_bfloat16>(
      work, out, (long long)batch * seq * heads, D, splits, st);
}

}  // namespace

// q [B, S, N, D] and k (= v) [B, S, kvN, D] of dtype (SLI_F32 or SLI_BF16)
// with element strides q_bs, q_ss, k_bs, k_ss, heads contiguous; out [B,
// S, N, D] contiguous. group = N / kvN. D 128 or 640. bf16 with splits >
// 1: work holds splits * B * S * N * (D + 2) floats; f32: splits 1.
extern "C" int sli_flash_prefill_shared(const void* q, const void* k,
                                        void* out, long long q_bs,
                                        long long q_ss, long long k_bs,
                                        long long k_ss, int batch, int seq,
                                        int heads, int group, int head_dim,
                                        float scale, int dtype, void* work,
                                        int splits, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || group <= 0 || heads % group ||
      splits < 1 || (splits > 1 && work == nullptr))
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 128:
      return launch<128>(q, k, out, q_bs, q_ss, k_bs, k_ss, batch, seq,
                         heads, group, scale, dtype, (float*)work, splits, st);
    case 640:
      return launch<640>(q, k, out, q_bs, q_ss, k_bs, k_ss, batch, seq,
                         heads, group, scale, dtype, (float*)work, splits, st);
    default:
      return SLI_ERR_HEAD_DIM;
  }
}
