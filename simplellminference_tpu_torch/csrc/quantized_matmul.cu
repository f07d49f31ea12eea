// Weight-only INT8 product y = x @ dequant(q, scales), f32 accumulation.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/matmul.py:
//   quantized_matmul (_qmm_kernel, matmul.py:69-109; wrapper :522), 8-bit
//   weights with per-output-channel scales ([1, N]) or per-group scales
//   ([K/G, N], group G along K).
//
// Two of kernel 5's four regimes, chosen by the wrapper (ops/matmul.py
// tiled_regime; the other two run bf16 activations on the tensor cores:
// M > 8 in quantized_matmul_mma.cu (5m), and M <= 8 with per-channel
// scales, K and N multiples of 64 in quantized_matmul_rows_mma.cu (5r),
// which takes the decode wo and LM head at every model width the port
// runs):
//
// * A few rows that 5r does not take (M <= 8 with f32 activations,
//   grouped scales, or K or N off a multiple of 64): bound by bytes, the
//   K*N weight bytes read once (the 7B wo, 16.8 MB, in 5.0 us; the int8
//   LM head, 131 MB, in 39.1 us at 3.35 TB/s). qmm_rows_kernel
//   (int8_rows.cuh): one block per 256 output columns and K range, 16-byte
//   weight loads along N (contiguous), int8 -> f32 in registers, f32 FMAs
//   against the activation rows held in shared memory. K is split across
//   blocks until about two blocks per SM are in flight; each block writes
//   f32 partial sums and qmm_finish_kernel adds them, applies the
//   per-channel scale once, and rounds once to the output dtype, as
//   _qmm_kernel applies its per-channel scale once at write-out.
// * Many rows the tensor-core kernel does not take (f32 activations,
//   scale groups off a multiple of its 64-row slab, K off a multiple of 8
//   or N of 16): qmm_tiled_kernel, a shared-memory tiled FMA kernel (64 x
//   128 output tile, 32-deep K slabs, 4 x 8 outputs a thread): the int8
//   tile is converted to f32 once in shared memory and reused by all 64
//   rows. It runs on the f32 pipes, far above an operation bound.
//
// Grouped scales are folded into the converted weights (w * s[g], f32)
// before the FMA instead of scaling each group's partial sum; both are
// f32 and differ from the plain version only in rounding order. Every K
// is exact: there is no K tile that must divide K (the TPU wrapper drops a
// K % 128 remainder, matmul.py:583-584), rows past K read as zero.
// Activations are read in their own dtype and never rounded: with bf16
// activations this is the TPU kernel's math (it rounds x to bf16,
// matmul.py:565); with f32 ones it is the JAX package's CPU math.
#include "int8_rows.cuh"

namespace {

constexpr int TM = 64;   // output rows per block
constexpr int TN = 128;  // output columns per block
constexpr int TK = 32;   // K rows per slab
constexpr int TT = 256;  // threads

template <typename T, typename TO, bool SCALED>
__global__ void __launch_bounds__(TT)
    qmm_tiled_kernel(const T* __restrict__ x, long long ldx,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ scales, TO* __restrict__ out,
                     int m, int k, int n, int group, int vec) {
  __shared__ __align__(16) float as[TK][TM];
  __shared__ __align__(16) float bs[TK][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +4 and 64 + tx*4 .. +4
  const int ty = tid / 16;  // rows ty*4 .. +4
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int ar = tid >> 2;         // A loader: row, 8 consecutive k
  const int ak = (tid & 3) * 8;
  const int br = tid >> 3;         // B loader: k row, 16 columns
  const int bc = (tid & 7) * 16;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += TK) {
    const T* xr = x + (long long)(m0 + ar) * ldx;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = k0 + ak + j;
      as[ak + j][ar] = (m0 + ar < m && kk < k) ? sli::to_f(xr[kk]) : 0.f;
    }
    {
      const int kk = k0 + br;
      float w[16];
      if (kk < k) {
        const int4 wv = load_w16(q + (long long)kk * n, n0 + bc, n, vec != 0);
        const unsigned int words[4] = {(unsigned int)wv.x, (unsigned int)wv.y,
                                       (unsigned int)wv.z, (unsigned int)wv.w};
#pragma unroll
        for (int p = 0; p < 4; ++p) i8x4_to_f32(words[p], w + 4 * p);
        if (SCALED) {
          const float* srow = scales + (long long)(kk / group) * n;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            w[j] *= n0 + bc + j < n ? __ldg(srow + n0 + bc + j) : 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(&bs[br][bc]);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        dst[p] = make_float4(w[4 * p], w[4 * p + 1], w[4 * p + 2],
                             w[4 * p + 3]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col >= n) continue;
      float v = acc[i][j];
      if (!SCALED) v *= __ldg(scales + col);
      out[(long long)row * n + col] = sli::from_f<TO>(v);
    }
  }
}

template <typename T, typename TO>
int run(const void* x, long long ldx, const int8_t* q, const float* scales,
        void* out, float* work, int m, int k, int n, int group, int kch,
        int vec, cudaStream_t st) {
  const bool per_channel = group >= k;
  if (kch > 0) {
    cudaError_t e = launch_qmm_rows<T>(x, ldx, q, scales, work, m, k, n, kch,
                                       group, vec, st);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_qmm_finish<TO>(work, (k + kch - 1) / kch,
                                      per_channel ? scales : nullptr, nullptr,
                                      out, m, n, st);
  }
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  if (per_channel) {
    qmm_tiled_kernel<T, TO, false><<<grid, TT, 0, st>>>(
        (const T*)x, ldx, q, scales, (TO*)out, m, k, n, group, vec);
  } else {
    qmm_tiled_kernel<T, TO, true><<<grid, TT, 0, st>>>(
        (const T*)x, ldx, q, scales, (TO*)out, m, k, n, group, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [m, k] rows at element stride ldx (x_dtype); q: [k, n] int8 of one
// layer; scales: [k / group, n] f32 (group == k: per-channel); out: [m, n]
// (out_dtype). kch > 0: the few-rows kernel with K ranges of kch rows and
// work holding ceil(k / kch) * m * n floats; kch == 0: the tiled kernel.
// vec: q and n allow 16-byte weight loads.
int sli_quantized_matmul(const void* x, long long ldx, const void* q,
                         const float* scales, void* out, float* work, int m,
                         int k, int n, int group, int kch, int x_dtype,
                         int out_dtype, int vec, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || group <= 0 || kch < 0)
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* qq = (const int8_t*)q;
  if (x_dtype == SLI_F32 && out_dtype == SLI_F32)
    return run<float, float>(x, ldx, qq, scales, out, work, m, k, n, group,
                             kch, vec, st);
  if (x_dtype == SLI_F32 && out_dtype == SLI_BF16)
    return run<float, __nv_bfloat16>(x, ldx, qq, scales, out, work, m, k, n,
                                     group, kch, vec, st);
  if (x_dtype == SLI_BF16 && out_dtype == SLI_F32)
    return run<__nv_bfloat16, float>(x, ldx, qq, scales, out, work, m, k, n,
                                      group, kch, vec, st);
  if (x_dtype == SLI_BF16 && out_dtype == SLI_BF16)
    return run<__nv_bfloat16, __nv_bfloat16>(x, ldx, qq, scales, out, work,
                                              m, k, n, group, kch, vec, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
