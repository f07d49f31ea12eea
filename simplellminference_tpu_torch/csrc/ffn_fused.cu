// The FFN of a decoder layer for a few rows (m <= 64): rmsnorm -> int8
// gate_up x per-channel scale -> SwiGLU -> int8 down x per-channel scale
// -> + residual.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/ffn_fused.py:
//   fused_ffn (_kernel, ffn_fused.py:42-98; wrapper :138). Since the
//   tensor-core kernels (ffn_fused_mma.cu) these take only f32 rows and
//   H or I off a multiple of 64 (ops/ffn_fused.py ffn_regime).
//
// Bound on the H100: bytes. The two weights ([H, 2I] and [I, H] int8,
// 135.3 MB at Llama-2-7B: 40.4 us at 3.35 TB/s) dominate.
//
// Design: the TPU kernel runs gate_up and down back to back in one
// sequential grid, carrying the SwiGLU output in VMEM. The down product
// needs every column of that output, and CUDA blocks cannot wait for each
// other inside one ordinary launch, so the wrapper's one call launches in
// order on one stream:
//   (a) ffn_gate_up_kernel: each block recomputes the rmsnorm of its rows
//       (one warp per row), streams gate columns [j0, j0 + 64) and the
//       matching up columns [I + j0, I + j0 + 64) of the int8 weight
//       (int8_rows.cuh), applies the per-channel scales and SwiGLU in f32
//       and writes h [m, I] in the activation dtype (176 KB at 7B, m = 8);
//   (b) qmm_rows_kernel (int8_rows.cuh) over h and the down weight, K
//       split across blocks, f32 partial sums;
//   (c) qmm_finish_kernel: the partials summed, times the down scales,
//       plus the residual x, rounded once to the activation dtype.
// h makes one round trip through L2/device memory (2 x 176 KB against the
// 135 MB of weights).
//
// Rounding: the normalized rows and h are rounded to the activation dtype
// (the TPU kernel rounds both to bf16, ffn_fused.py:54-55 and :85); the
// products, scales, SwiGLU and the residual add stay f32.
#include "int8_rows.cuh"

namespace {

constexpr int FFN_CT = 8;                    // 4 gate + 4 up column groups
constexpr int FFN_CW = 16 * FFN_CT;          // 128 columns per block
constexpr int FFN_GW = FFN_CW / 2;           // 64 gate (and up) columns
constexpr int FFN_KL = RT_THREADS / FFN_CT;

// grid (ceil(m / 8), ceil(I / 64)).
template <typename T>
__global__ void __launch_bounds__(RT_THREADS, 1) ffn_gate_up_kernel(
    const T* __restrict__ x, const void* __restrict__ nw, int nw_bf16,
    const int8_t* __restrict__ q1, const float* __restrict__ s1,
    T* __restrict__ hbuf, int m, int h, int inter, float eps, int vec) {
  __shared__ __align__(16) float xs[RT_KC * RT_MT];
  __shared__ __align__(16) float red[FFN_KL * FFN_CW];
  __shared__ __align__(16) float tile[RT_MT * FFN_CW];
  __shared__ float inv[RT_MT];
  const int m0 = blockIdx.x * RT_MT;
  const int j0 = blockIdx.y * FFN_GW;
  const int tid = threadIdx.x;
  const int ct = tid % FFN_CT;
  const int klane = tid / FFN_CT;
  const bool up = ct >= FFN_CT / 2;
  const int c = j0 + (ct % (FFN_CT / 2)) * 16;  // column within [0, I)
  const long long ldw = 2LL * inter;

  row_rms<T>(x, h, m0, m, h, eps, inv);
  float acc[RT_MT][16];
#pragma unroll
  for (int r = 0; r < RT_MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  float sc[16];
  int g_cur = 0;
  for (int k0 = 0; k0 < h; k0 += RT_KC) {
    const int kcnt = min(RT_KC, h - k0);
    stage_rows<T, true>(x, h, m0, m, k0, kcnt, inv, nw, nw_bf16, xs);
    stream_rows<FFN_KL, false>(acc, q1 + k0 * ldw + (up ? inter : 0), ldw, c,
                               inter, vec != 0, kcnt, klane, xs, nullptr, k0,
                               h, sc, g_cur);
  }
  reduce_lanes<FFN_CT>(acc, red, tile);

  for (int i = tid; i < RT_MT * FFN_GW; i += RT_THREADS) {
    const int r = i / FFN_GW;
    const int j = i - r * FFN_GW;
    const int row = m0 + r;
    const int col = j0 + j;
    if (row >= m || col >= inter) continue;
    const float g = tile[r * FFN_CW + j] * __ldg(s1 + col);
    const float u = tile[r * FFN_CW + FFN_GW + j] * __ldg(s1 + inter + col);
    const float sg = 1.f / (1.f + expf(-g));
    hbuf[(long long)row * inter + col] = sli::from_f<T>(g * sg * u);
  }
}

template <typename T>
int run(const void* x, const void* nw, int nw_bf16, const int8_t* q1,
        const float* s1, const int8_t* q2, const float* s2, void* hbuf,
        float* work, void* out, int m, int h, int inter, int kch, float eps,
        int vec1, int vec2, cudaStream_t st) {
  const dim3 grid((m + RT_MT - 1) / RT_MT, (inter + FFN_GW - 1) / FFN_GW);
  ffn_gate_up_kernel<T><<<grid, RT_THREADS, 0, st>>>(
      (const T*)x, nw, nw_bf16, q1, s1, (T*)hbuf, m, h, inter, eps, vec1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch_qmm_rows<T>(hbuf, inter, q2, s2, work, m, inter, h, kch, inter,
                         vec2, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_qmm_finish<T>(work, (inter + kch - 1) / kch, s2, x, out,
                                   m, h, st);
}

}  // namespace

extern "C" {

// x: [m, h] contiguous (x_dtype), also the residual; nw: the layer's norm
// weight [h] (f32, or bf16 when nw_bf16); q1: the layer's [h, 2 inter]
// int8 with s1 [2 inter] f32; q2: [inter, h] int8 with s2 [h] f32; hbuf:
// [m, inter] (x_dtype) scratch; work: ceil(inter / kch) * m * h floats;
// out: [m, h] (x_dtype). vec1/vec2: q1/q2 allow 16-byte loads.
int sli_ffn_fused(const void* x, const void* nw, int nw_bf16, const void* q1,
                  const float* s1, const void* q2, const float* s2,
                  void* hbuf, float* work, void* out, int m, int h, int inter,
                  int kch, float eps, int x_dtype, int vec1, int vec2,
                  void* stream) {
  if (m <= 0 || h <= 0 || inter <= 0 || kch <= 0) return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* a = (const int8_t*)q1;
  const int8_t* bq = (const int8_t*)q2;
  if (x_dtype == SLI_F32)
    return run<float>(x, nw, nw_bf16, a, s1, bq, s2, hbuf, work, out, m, h,
                      inter, kch, eps, vec1, vec2, st);
  if (x_dtype == SLI_BF16)
    return run<__nv_bfloat16>(x, nw, nw_bf16, a, s1, bq, s2, hbuf, work, out,
                              m, h, inter, kch, eps, vec1, vec2, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
