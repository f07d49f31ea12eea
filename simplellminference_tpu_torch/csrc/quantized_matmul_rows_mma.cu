// Weight-only INT8 product for a few bf16 rows on the bf16 tensor cores:
// y[m, n] = (sum_k x[m, k] q[k, n]) * s[n], m <= 8, per-channel scales.
//
// Replaces, with the f32 FMA kernel of quantized_matmul.cu (which keeps f32
// activations, grouped scales and the shapes this one does not take), the
// TPU kernel of simplellminference_tpu/ops/matmul.py: quantized_matmul
// (_qmm_kernel, matmul.py:69-109; wrapper :522) at M <= 8, the decode
// products that do not go through a fused kernel: wo and the LM head
// (models/llama.py:165, :188). Regime "rmma" of ops/matmul.py
// tiled_regime (row 5r).
//
// Bound on the H100: bytes. The K x N weight bytes read once: the 7B wo
// (16.8 MB) in 5.0 us, the int8 LM head (131 MB) in 39.1 us at 3.35
// TB/s. The FMA kernel (int8_rows.cuh) takes 4.9x and 3.5x that: 8 f32
// FMAs and a conversion a weight byte on the f32 pipes.
//
// Design: int8_mma_rows.cuh, as kernels 7m and 6m. A block of 4 warps owns
// 128 output columns (two 64-column groups; the second reads zeros past N
// when N is an odd multiple of 64) and a K range, streamed through a
// 4-stage cp.async ring against the rows of x (one n8 tile) on
// mma.sync.m16n8k16 with the weight as A, converted exactly to bf16 in
// registers. 128 columns keep the weight rows' runs at 128 bytes, and the
// card is filled by splitting K from shapes alone (ops/matmul.py
// rows_mma_split: 32 column tiles x 8 K ranges of 512 rows for the 7B
// wo, 250 x 2 for the head). Each block writes its f32 partial sums; the
// last block to arrive at a column tile (an arrival counter of its own,
// reset by that block, so CUDA-graph replay holds) adds them in K order,
// applies the per-channel scale once and rounds once to the output dtype,
// as _qmm_kernel applies its per-channel scale once at write-out.
//
// Rounding: x is used in bf16 as given (the TPU kernel rounds x to bf16,
// matmul.py:565); the products are exact, their sums f32 in another order
// than the plain version's; one rounding to out_dtype (f32 for the head).
#include "int8_mma_rows.cuh"

namespace {

constexpr int QMR_MAX_TILES = 4096;  // column tiles a launch may arrive at

// arrival counters of the K-split grid, one a column tile (apart from the
// other kernels'); zero at load, and each launch leaves them zero
__device__ int qmr_arrivals[QMR_MAX_TILES];

// blocks an SM holds: ops/matmul.py ROWS_MMA_RES sizes the K split by it
constexpr int QMR_RES = 4;

// grid (ceil(N / 128), chunks): block (x, z) takes output columns [128x,
// 128x + 128) and K rows [z * kch, min(K, (z + 1) * kch)).
template <typename TO>
__global__ void __launch_bounds__(i8m::THREADS, QMR_RES)
    qmm_rows_mma_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ s, TO* __restrict__ out,
                        float* __restrict__ work, int m, int k, int n,
                        int kch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * 128;
  const int z = blockIdx.y;
  const int chunks = gridDim.y;
  const int kb = z * kch;
  const int ke = min(k, kb + kch);
  float acc[4][1][4];
#pragma unroll
  for (int tj = 0; tj < 4; ++tj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[tj][0][e] = 0.f;
  i8m::stream<1>(smem, q, n, n0, n0 + 64, n0 + 64 < n, x, ldx, m, kb, ke,
                 acc);
  float* red = reinterpret_cast<float*>(smem);
  i8m::spill<1>(acc, red);
  const int tid = threadIdx.x;
  const int width = min(128, n - n0);  // n % 64 == 0: 64 or 128
  if (chunks > 1) {
    float* pz = work + (long long)z * m * n;
    for (int i = tid; i < m * width; i += i8m::THREADS) {
      const int row = i / width;
      const int c = i - row * width;
      pz[(long long)row * n + n0 + c] =
          i8m::block_sum<1>(red, c >> 6, c & 63, row);
    }
    if (!i8m::last_to_arrive(qmr_arrivals + blockIdx.x, chunks)) return;
  }
  // four neighbouring columns a thread
  const int w4 = width / 4;
  for (int i = tid; i < m * w4; i += i8m::THREADS) {
    const int row = i / w4;
    const int c4 = (i - row * w4) * 4;
    const long long o = (long long)row * n + n0 + c4;
    float v[4];
    if (chunks == 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = i8m::block_sum<1>(red, (c4 + e) >> 6, (c4 + e) & 63, row);
    } else {
      const float4 s4 =
          i8m::sum_partials4(work + o, (long long)m * n, chunks);
      v[0] = s4.x; v[1] = s4.y; v[2] = s4.z; v[3] = s4.w;
    }
    const float4 sc = __ldg(reinterpret_cast<const float4*>(s + n0 + c4));
    const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) out[o + e] = sli::from_f<TO>(v[e] * scv[e]);
  }
}

template <typename TO>
int run(const __nv_bfloat16* x, long long ldx, const int8_t* q,
        const float* s, void* out, float* work, int m, int k, int n, int kch,
        cudaStream_t st) {
  constexpr int SMEM = i8m::Geo<1>::SMEM;
  auto kern = qmm_rows_mma_kernel<TO>;
  cudaError_t e = sli::allow_smem(kern, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + 127) / 128, (k + kch - 1) / kch);
  kern<<<grid, i8m::THREADS, SMEM, st>>>(x, ldx, q, s, (TO*)out, work, m, k,
                                         n, kch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [m, k] bf16 rows at element stride ldx (m <= 8); q: [k, n] int8 of one
// layer; s: [n] f32 per-channel scales; out: [m, n] (out_dtype); work:
// ceil(k / kch) * m * n floats when K is split (null otherwise). k a
// multiple of 64, n of 64; kch: K rows a block, a multiple of 64. x, its
// row stride (ldx a multiple of 8), q, s and work 16-byte aligned.
int sli_quantized_matmul_rows_mma(const void* x, long long ldx,
                                  const void* q, const float* s, void* out,
                                  float* work, int m, int k, int n, int kch,
                                  int out_dtype, void* stream) {
  if (m <= 0 || m > 8 || k <= 0 || k % 64 || n <= 0 || n % 64 ||
      kch <= 0 || kch % 64 || (n + 127) / 128 > QMR_MAX_TILES || ldx % 8 ||
      ((unsigned long long)x | (unsigned long long)q |
       (unsigned long long)s | (unsigned long long)work) % 16)
    return SLI_ERR_SHAPE;
  if (kch < k && work == nullptr) return SLI_ERR_SHAPE;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* qq = (const int8_t*)q;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == SLI_F32)
    return run<float>(xb, ldx, qq, s, out, work, m, k, n, kch, st);
  if (out_dtype == SLI_BF16)
    return run<__nv_bfloat16>(xb, ldx, qq, s, out, work, m, k, n, kch, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
