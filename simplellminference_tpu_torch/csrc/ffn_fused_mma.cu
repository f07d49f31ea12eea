// The FFN of a decoder layer for a few bf16 rows (m <= 64) on the bf16
// tensor cores: rmsnorm -> int8 gate_up x per-channel scale -> SwiGLU ->
// int8 down x per-channel scale -> + residual.
//
// Replaces, with the f32 FMA kernels of ffn_fused.cu (which keep f32
// activations and the shapes this one does not take), the TPU kernel of
// simplellminference_tpu/ops/ffn_fused.py: fused_ffn (_kernel,
// ffn_fused.py:42-98; wrapper :138).
//
// Bound on the H100: bytes. The two weights ([H, 2I] and [I, H] int8,
// 135.3 MB at Llama-2-7B: 40.4 us at 3.35 TB/s) dominate. The FMA kernels
// take 5.8x that: 172 blocks of one per SM (1.3 waves), 16 KB in flight
// an SM, 8 f32 FMAs and a conversion a weight byte, and the weights
// streamed again for every 8 rows.
//
// Design: one wrapper call launches, in order on one stream,
//   (a) i8m::norm_rows_kernel: the rmsnorm of each row once, in f32,
//       rounded to bf16 into xn [m, H] (the block of the old kernel
//       recomputed every row's norm);
//   (b) ffn_gate_up_mma_kernel: a block streams gate columns [j0, j0 + 64)
//       and the matching up columns [I + j0, I + j0 + 64) of a K range
//       against all m rows of xn in one pass (int8_mma_rows.cuh:
//       mma.sync with the weight as A, converted exactly to bf16 in
//       registers; a 4-stage cp.async ring, three stages in flight),
//       so SwiGLU stays in the block. Gate and up are 64-byte runs of a
//       22,016-byte row at 7B (two 32-byte sectors each), as in the FMA
//       kernel: 16- or 32-wide tiles would halve the runs to one sector
//       and double the rows opened for the same bytes, so the card is
//       filled by splitting K instead, from shapes alone
//       (ops/ffn_fused.py ffn_split: 172 column tiles x 3 K ranges at
//       7B, m = 8). Each block writes its f32 partial sums; the last block
//       to arrive at a column tile (an arrival counter in device memory,
//       reset by that block, so CUDA-graph replay holds) adds the
//       partials in K order, applies the scales and SwiGLU in f32 and
//       writes h [m, I] in bf16;
//   (c) ffn_down_mma_kernel: the same over h and the down weight, 128
//       columns a block, K (= I) split the same way; the last block at a
//       column tile adds the partials, applies the down scales, adds the
//       residual x in f32 and rounds once to bf16.
// Three launches and no host sync; the grids come from shapes alone.
//
// Rounding, as the plain version (ops/ffn_fused.py _ffn_plain): the
// normalized rows and h rounded to bf16 (the TPU kernel rounds both to
// bf16, ffn_fused.py:54-55 and :85); products, scales, SwiGLU and the
// residual add in f32 (products of bf16 codes and rows on the tensor
// cores are exact, their sums f32 in another order).
#include "int8_mma_rows.cuh"

namespace {

constexpr int FFN_MAX_TILES = 4096;  // column tiles a launch may arrive at

// arrival counters of the K-split grids: [0, MAX) gate_up's column tiles,
// [MAX, 2 MAX) down's; zero at load, and each launch leaves them zero
__device__ int ffn_arrivals[2 * FFN_MAX_TILES];

// Blocks an SM holds for NT n8 row tiles (launch bounds): ops/ffn_fused.py
// ffn_split sizes the K split by the same numbers.
template <int NT>
struct FfnRes {
  static constexpr int value = NT == 1 ? 4 : (NT <= 5 ? 3 : 2);
};

__device__ __forceinline__ float swiglu(float g, float u) {
  const float sg = 1.f / (1.f + expf(-g));
  return g * sg * u;
}

// grid (I / 64, chunks): block (x, z) takes gate columns [64x, 64x + 64),
// the matching up columns, and H rows [z * kch, min(H, (z + 1) * kch)).
template <int NT>
__global__ void __launch_bounds__(i8m::THREADS, FfnRes<NT>::value)
    ffn_gate_up_mma_kernel(const __nv_bfloat16* __restrict__ xn,
                           const int8_t* __restrict__ q1,
                           const float* __restrict__ s1,
                           __nv_bfloat16* __restrict__ hbuf,
                           float* __restrict__ work, int m, int h, int inter,
                           int kch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j0 = blockIdx.x * 64;
  const int z = blockIdx.y;
  const int chunks = gridDim.y;
  const int kb = z * kch;
  const int ke = min(h, kb + kch);
  const long long ld = 2LL * inter;
  float acc[4][NT][4];
#pragma unroll
  for (int tj = 0; tj < 4; ++tj)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tj][nt][e] = 0.f;
  i8m::stream<NT>(smem, q1, ld, j0, inter + j0, true, xn, h, m, kb, ke, acc);
  float* red = reinterpret_cast<float*>(smem);
  i8m::spill<NT>(acc, red);
  const int tid = threadIdx.x;
  if (chunks > 1) {
    float* pz = work + (long long)z * m * ld;
    for (int i = tid; i < m * 64; i += i8m::THREADS) {
      const int row = i >> 6;
      const int col = i & 63;
      pz[row * ld + j0 + col] = i8m::block_sum<NT>(red, 0, col, row);
      pz[row * ld + inter + j0 + col] = i8m::block_sum<NT>(red, 1, col, row);
    }
    if (!i8m::last_to_arrive(ffn_arrivals + blockIdx.x, chunks)) return;
  }
  // four neighbouring columns a thread
  for (int i = tid; i < m * 16; i += i8m::THREADS) {
    const int row = i >> 4;
    const int c4 = (i & 15) * 4;
    float gs[4], us[4];
    if (chunks == 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gs[e] = i8m::block_sum<NT>(red, 0, c4 + e, row);
        us[e] = i8m::block_sum<NT>(red, 1, c4 + e, row);
      }
    } else {
      const float* p = work + row * ld + j0 + c4;
      const float4 g4 = i8m::sum_partials4(p, (long long)m * ld, chunks);
      const float4 u4 =
          i8m::sum_partials4(p + inter, (long long)m * ld, chunks);
      gs[0] = g4.x; gs[1] = g4.y; gs[2] = g4.z; gs[3] = g4.w;
      us[0] = u4.x; us[1] = u4.y; us[2] = u4.z; us[3] = u4.w;
    }
    const float4 sg = __ldg(reinterpret_cast<const float4*>(s1 + j0 + c4));
    const float4 su =
        __ldg(reinterpret_cast<const float4*>(s1 + inter + j0 + c4));
    const float sgv[4] = {sg.x, sg.y, sg.z, sg.w};
    const float suv[4] = {su.x, su.y, su.z, su.w};
    float hv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) hv[e] = swiglu(gs[e] * sgv[e], us[e] * suv[e]);
    __nv_bfloat162 o[2] = {__floats2bfloat162_rn(hv[0], hv[1]),
                           __floats2bfloat162_rn(hv[2], hv[3])};
    *reinterpret_cast<uint2*>(hbuf + (long long)row * inter + j0 + c4) =
        *reinterpret_cast<const uint2*>(o);
  }
}

// grid (ceil(H / 128), chunks): block (x, z) takes output columns [128x,
// 128x + 128) and I rows [z * kch, min(I, (z + 1) * kch)).
template <int NT>
__global__ void __launch_bounds__(i8m::THREADS, FfnRes<NT>::value)
    ffn_down_mma_kernel(const __nv_bfloat16* __restrict__ hbuf,
                        const int8_t* __restrict__ q2,
                        const float* __restrict__ s2,
                        const __nv_bfloat16* __restrict__ x,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ work, int m, int h, int inter,
                        int kch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * 128;
  const int z = blockIdx.y;
  const int chunks = gridDim.y;
  const int kb = z * kch;
  const int ke = min(inter, kb + kch);
  float acc[4][NT][4];
#pragma unroll
  for (int tj = 0; tj < 4; ++tj)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tj][nt][e] = 0.f;
  i8m::stream<NT>(smem, q2, h, n0, n0 + 64, n0 + 64 < h, hbuf, inter, m, kb,
                  ke, acc);
  float* red = reinterpret_cast<float*>(smem);
  i8m::spill<NT>(acc, red);
  const int tid = threadIdx.x;
  const int width = min(128, h - n0);  // h % 64 == 0: 64 or 128
  if (chunks > 1) {
    float* pz = work + (long long)z * m * h;
    for (int i = tid; i < m * width; i += i8m::THREADS) {
      const int row = i / width;
      const int c = i - row * width;
      pz[(long long)row * h + n0 + c] =
          i8m::block_sum<NT>(red, c >> 6, c & 63, row);
    }
    if (!i8m::last_to_arrive(ffn_arrivals + FFN_MAX_TILES + blockIdx.x,
                             chunks))
      return;
  }
  // four neighbouring columns a thread
  const int w4 = width / 4;
  for (int i = tid; i < m * w4; i += i8m::THREADS) {
    const int row = i / w4;
    const int c4 = (i - row * w4) * 4;
    const long long o = (long long)row * h + n0 + c4;
    float v[4];
    if (chunks == 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = i8m::block_sum<NT>(red, (c4 + e) >> 6, (c4 + e) & 63, row);
    } else {
      const float4 s4 =
          i8m::sum_partials4(work + o, (long long)m * h, chunks);
      v[0] = s4.x; v[1] = s4.y; v[2] = s4.z; v[3] = s4.w;
    }
    const float4 sc = __ldg(reinterpret_cast<const float4*>(s2 + n0 + c4));
    const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
    const uint2 xr = *reinterpret_cast<const uint2*>(x + o);
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&xr);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] *= scv[e];
      v[e] += __bfloat162float(xv[e]);
    }
    __nv_bfloat162 ob[2] = {__floats2bfloat162_rn(v[0], v[1]),
                            __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(out + o) = *reinterpret_cast<const uint2*>(ob);
  }
}

template <int NT>
int run_nt(const __nv_bfloat16* x, const void* nw, int nw_bf16,
           const int8_t* q1, const float* s1, const int8_t* q2,
           const float* s2, __nv_bfloat16* xn, __nv_bfloat16* hbuf,
           float* work, __nv_bfloat16* out, int m, int h, int inter,
           int kch1, int kch2, float eps, cudaStream_t st) {
  constexpr int SMEM = i8m::Geo<NT>::SMEM;
  auto gu = ffn_gate_up_mma_kernel<NT>;
  auto dn = ffn_down_mma_kernel<NT>;
  cudaError_t e = sli::allow_smem(gu, SMEM);
  if (e == cudaSuccess) e = sli::allow_smem(dn, SMEM);
  if (e != cudaSuccess) return (int)e;
  i8m::norm_rows_kernel<<<m, 256, 0, st>>>(x, h, nw, nw_bf16, xn, h, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 g1(inter / 64, (h + kch1 - 1) / kch1);
  gu<<<g1, i8m::THREADS, SMEM, st>>>(xn, q1, s1, hbuf, work, m, h, inter,
                                     kch1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 g2((h + 127) / 128, (inter + kch2 - 1) / kch2);
  dn<<<g2, i8m::THREADS, SMEM, st>>>(hbuf, q2, s2, x, out, work, m, h, inter,
                                     kch2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [m, h] bf16, contiguous, also the residual (m <= 64); nw: the layer's
// norm weight [h] (f32, or bf16 when nw_bf16); q1: the layer's [h, 2
// inter] int8 with s1 [2 inter] f32; q2: [inter, h] int8 with s2 [h] f32
// (every pointer 16-byte aligned); xn: [m, h] and hbuf: [m, inter] bf16
// scratch; work: max(chunks1 * m * 2 inter, chunks2 * m * h)
// floats when a product's K is split (chunks = ceil(K / kch) > 1); out:
// [m, h] bf16. h and inter multiples of 64; kch1 / kch2: H / I rows a
// block of gate_up / down, multiples of 64.
int sli_ffn_fused_mma(const void* x, const void* nw, int nw_bf16,
                      const void* q1, const float* s1, const void* q2,
                      const float* s2, void* xn, void* hbuf, float* work,
                      void* out, int m, int h, int inter, int kch1, int kch2,
                      float eps, void* stream) {
  if (m <= 0 || m > 64 || h <= 0 || inter <= 0 || h % 64 || inter % 64 ||
      kch1 <= 0 || kch1 % 64 || kch2 <= 0 || kch2 % 64 ||
      inter / 64 > FFN_MAX_TILES || (h + 127) / 128 > FFN_MAX_TILES ||
      ((unsigned long long)q1 | (unsigned long long)q2 |
       (unsigned long long)xn | (unsigned long long)hbuf |
       (unsigned long long)x | (unsigned long long)out |
       (unsigned long long)s1 | (unsigned long long)s2 |
       (unsigned long long)work) % 16)
    return SLI_ERR_SHAPE;
  if ((kch1 < h || kch2 < inter) && work == nullptr) return SLI_ERR_SHAPE;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* a = (const int8_t*)q1;
  const auto* b = (const int8_t*)q2;
  auto* xnb = (__nv_bfloat16*)xn;
  auto* hb = (__nv_bfloat16*)hbuf;
  auto* ob = (__nv_bfloat16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((m + 7) / 8) {
#define SLI_FFN_NT(NT)                                                       \
  case NT:                                                                   \
    return run_nt<NT>(xb, nw, nw_bf16, a, s1, b, s2, xnb, hb, work, ob, m, h, \
                      inter, kch1, kch2, eps, st);
    SLI_FFN_NT(1)
    SLI_FFN_NT(2)
    SLI_FFN_NT(3)
    SLI_FFN_NT(4)
    SLI_FFN_NT(5)
    SLI_FFN_NT(6)
    SLI_FFN_NT(7)
    SLI_FFN_NT(8)
#undef SLI_FFN_NT
  }
  return SLI_ERR_SHAPE;
}

}  // extern "C"
