// Weight-only INT4 product y = x @ dequant(q, scales[, zs]), f32
// accumulation.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/matmul.py:
//   _quantized_matmul_int4 (_qmm4_kernel, matmul.py:112-176; wrapper :354,
//   reached through quantized_matmul(bits=4) :522): x [M, K] against
//   split-half packed 4-bit weights q [K/2, N] int8 -- packed row i holds
//   logical row i in its low nibble and row i + K/2 in its high nibble --
//   with per-output-channel ([1, N]) or per-group ([K/G, N], G dividing
//   K/2) f32 scales and, for AWQ/GPTQ imports, per-group zero points zs
//   ([K/G, N] f32, w = q * s - zs).
//
// Each packed byte is read once and gives two weights of the same column:
// the low nibble multiplies x[:, i], the high one x[:, i + K/2]. Both are
// sign-extended in int32 ((b << 28) >> 28 and (b << 24) >> 28): the code
// -8 occurs (bench.py's weights are arbitrary bytes, AWQ's q - 8 reaches
// it). The low half of the packed rows uses scale rows [0, G/2), the high
// half [G/2, G) (row i + K/2 is in group (i + K/2) / gs).
//
// These are the FMA kernels of the product: the wrapper (ops/matmul.py
// int4_regime) sends them f32 activations and the shapes the tensor-core
// kernels do not take (N off a multiple of 16, K/2 off a multiple of 64,
// scale groups off a multiple of 64 rows); bf16 activations of other
// shapes go to quantized_matmul_int4_mma.cu (M <= 8) and
// quantized_matmul_int4_wgmma.cu. Two regimes, as for the INT8 kernel
// (quantized_matmul.cu):
//
// * A few rows (decode, M <= 8: wqkv, wo, gate_up, down and the LM head
//   of every step, since the fused decode kernels take only INT8): the
//   K/2 * N weight bytes read once bound it (the 7B gate_up, 45.1 MB, in
//   13.5 us at 3.35 TB/s). qmm4_rows_kernel: one block per 256 output
//   columns and packed-K range, each thread 8 columns (one 8-byte load per
//   packed row, a warp covering 256 contiguous bytes), the activation
//   rows of both halves staged as f32 in shared memory, f32 FMAs. Each
//   byte feeds 16 FMAs at 8 rows, so at M = 8 the FMA rate, not the bytes,
//   sets its time (about twice the bound). K is split across blocks until
//   about two blocks per SM are in flight; qmm_finish_kernel
//   (int8_rows.cuh) adds the partial sums, applies a per-channel scale
//   once, and rounds once to the output dtype.
// * Many rows (prefill, M = 1024): bound by operations (the 7B wqkv is
//   103 GFLOP, 0.104 ms at the bf16 tensor-core peak). qmm4_tiled_kernel
//   is the INT8 kernel's shared-memory tiled FMA kernel (64 x 128 output
//   tile, 4 x 8 outputs a thread) over slabs of 16 packed rows, i.e. 32
//   logical rows: 16 from each half. It runs on the f32 pipes, not the
//   tensor cores, so it stays well above that bound.
//
// Scales: per-channel without zero points, the raw f32 sum is scaled once
// at write-out (as _qmm4_kernel). Grouped scales and zero points are
// folded into each converted weight, w = fmaf(q, s, -zs) in f32, before
// the FMAs, where the TPU kernel scales each group's partial sum and
// subtracts rowsum(x) * zs per group (a rank-1 correction); both are f32
// and differ only in rounding order. Every K with an even K/2 split and
// every N is exact: rows past K/2 and columns past N read as zero (the TPU
// wrapper sends K/2 or N off a multiple of 128 to the jnp reference,
// matmul.py:382-398). Activations are read in their own dtype and never
// rounded: with bf16 activations this is the TPU kernel's math.
#include "int8_rows.cuh"

namespace {

constexpr int Q4_KC = 256;                   // packed rows staged per slab
constexpr int Q4_CT = 32;                    // column threads, 8 columns each
constexpr int Q4_CW = 8 * Q4_CT;             // output columns per block
constexpr int Q4_KL = RT_THREADS / Q4_CT;    // packed-row lanes
constexpr int Q4_UNROLL = 8;                 // 8-byte loads in flight

// 8 packed bytes of one row at columns [c, c + 8), zero at and past n.
// vec: the row start and c are 8-byte aligned.
__device__ __forceinline__ uint2 load_w8(const int8_t* __restrict__ row,
                                         int c, int n, bool vec) {
  if (vec && c + 8 <= n)
    return __ldg(reinterpret_cast<const uint2*>(row + c));
  unsigned int u[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (c + j < n)
      u[j >> 2] |= (unsigned int)(unsigned char)row[c + j] << (8 * (j & 3));
  }
  return make_uint2(u[0], u[1]);
}

// The low and high nibble of byte j of w, sign-extended, as exact floats.
__device__ __forceinline__ float nib_lo(unsigned int w, int j) {
  return (float)(((int)(w << (28 - 8 * j))) >> 28);
}
__device__ __forceinline__ float nib_hi(unsigned int w, int j) {
  return (float)(((int)(w << (24 - 8 * j))) >> 28);
}

// The folded weight: q * s - zs (SCALED with ZEROS), q * s (SCALED), q.
template <bool SCALED, bool ZEROS>
__device__ __forceinline__ float fold(float qv, float s, float z) {
  if (ZEROS) return fmaf(qv, s, -z);
  if (SCALED) return qv * s;
  return qv;
}

// acc[r][j] += xl[r] * w_lo[j] + xh[r] * w_hi[j] for the 8 bytes of one
// packed row; xl/xh are the staged activations of its two logical rows.
template <bool SCALED, bool ZEROS>
__device__ __forceinline__ void fma_row4(float (&acc)[RT_MT][8], uint2 wv,
                                         const float* __restrict__ xl,
                                         const float* __restrict__ xh,
                                         const float (&slo)[8],
                                         const float (&shi)[8],
                                         const float (&zlo)[8],
                                         const float (&zhi)[8]) {
  float a[RT_MT], b[RT_MT];
  {
    const float4 a0 = *reinterpret_cast<const float4*>(xl);
    const float4 a1 = *reinterpret_cast<const float4*>(xl + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(xh);
    const float4 b1 = *reinterpret_cast<const float4*>(xh + 4);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
  }
  const unsigned int words[2] = {wv.x, wv.y};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * p + j;
      const float wl = fold<SCALED, ZEROS>(nib_lo(words[p], j), slo[col],
                                           zlo[col]);
      const float wh = fold<SCALED, ZEROS>(nib_hi(words[p], j), shi[col],
                                           zhi[col]);
#pragma unroll
      for (int r = 0; r < RT_MT; ++r) {
        acc[r][col] = fmaf(a[r], wl, acc[r][col]);
        acc[r][col] = fmaf(b[r], wh, acc[r][col]);
      }
    }
  }
}

// 8 f32 of row g of a [G, n] array at columns [c, c + 8) (0 past n).
__device__ __forceinline__ void load_row8(const float* __restrict__ a, int g,
                                          int c, int n, float (&out)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    out[j] = c + j < n ? __ldg(a + (long long)g * n + c + j) : 0.f;
}

// Partial products of a packed-K range for a few rows: grid (ceil(M/MT),
// ceil(N/256), chunks); block z covers packed rows [z*kch, min(kp,
// (z+1)*kch)) and writes f32 sums to part[z][M][N].
template <typename T, bool SCALED, bool ZEROS>
__global__ void __launch_bounds__(RT_THREADS, 1)
    qmm4_rows_kernel(const T* __restrict__ x, long long ldx,
                     const int8_t* __restrict__ q,
                     const float* __restrict__ scales,
                     const float* __restrict__ zs, float* __restrict__ part,
                     int m, int kp, int n, int kch, int group, int vec) {
  __shared__ __align__(16) float xlo[Q4_KC * RT_MT];
  __shared__ __align__(16) float xhi[Q4_KC * RT_MT];
  __shared__ __align__(16) float red[Q4_KL * Q4_CW];
  const int m0 = blockIdx.x * RT_MT;
  const int col0 = blockIdx.y * Q4_CW;
  const int kb = blockIdx.z * kch;
  const int ke = min(kp, kb + kch);
  const int tid = threadIdx.x;
  const int ct = tid % Q4_CT;
  const int klane = tid / Q4_CT;
  const int c = col0 + ct * 8;

  float acc[RT_MT][8];
#pragma unroll
  for (int r = 0; r < RT_MT; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  float slo[8], shi[8], zlo[8], zhi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    slo[j] = shi[j] = 1.f;
    zlo[j] = zhi[j] = 0.f;
  }
  int g_lo = -1, g_hi = -1;

  for (int k0 = kb; k0 < ke; k0 += Q4_KC) {
    const int kcnt = min(Q4_KC, ke - k0);
    __syncthreads();  // the previous slab is no longer read
    for (int i = tid; i < RT_MT * Q4_KC; i += RT_THREADS) {
      const int r = i / Q4_KC;
      const int kk = i - r * Q4_KC;
      float a = 0.f, b = 0.f;
      if (m0 + r < m && kk < kcnt) {
        const T* xr = x + (long long)(m0 + r) * ldx + k0 + kk;
        a = sli::to_f(xr[0]);
        b = sli::to_f(xr[kp]);
      }
      xlo[kk * RT_MT + r] = a;
      xhi[kk * RT_MT + r] = b;
    }
    __syncthreads();
    for (int kk = klane; kk < kcnt; kk += Q4_UNROLL * Q4_KL) {
      uint2 wv[Q4_UNROLL];
#pragma unroll
      for (int u = 0; u < Q4_UNROLL; ++u) {
        const int k = kk + u * Q4_KL;
        wv[u] = k < kcnt ? load_w8(q + (long long)(k0 + k) * n, c, n,
                                   vec != 0)
                         : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < Q4_UNROLL; ++u) {
        const int k = kk + u * Q4_KL;
        if (k < kcnt) {
          if (SCALED) {
            const int gl = (k0 + k) / group;
            const int gh = (kp + k0 + k) / group;
            if (gl != g_lo) {
              g_lo = gl;
              load_row8(scales, gl, c, n, slo);
              if (ZEROS) load_row8(zs, gl, c, n, zlo);
            }
            if (gh != g_hi) {
              g_hi = gh;
              load_row8(scales, gh, c, n, shi);
              if (ZEROS) load_row8(zs, gh, c, n, zhi);
            }
          }
          fma_row4<SCALED, ZEROS>(acc, wv[u], xlo + k * RT_MT,
                                  xhi + k * RT_MT, slo, shi, zlo, zhi);
        }
      }
    }
  }
  // the lanes' sums meet in shared memory, one output row at a time
#pragma unroll
  for (int r = 0; r < RT_MT; ++r) {
    float4* dst = reinterpret_cast<float4*>(red + klane * Q4_CW + ct * 8);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    __syncthreads();
    if (tid < Q4_CW) {
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < Q4_KL; ++l) s += red[l * Q4_CW + tid];
      const int col = col0 + tid;
      if (m0 + r < m && col < n)
        part[((long long)blockIdx.z * m + m0 + r) * n + col] = s;
    }
    __syncthreads();
  }
}

constexpr int TM = 64;   // output rows per block
constexpr int TN = 128;  // output columns per block
constexpr int TKP = 16;  // packed rows per slab (32 logical rows)
constexpr int TT = 256;  // threads

template <typename T, typename TO, bool SCALED, bool ZEROS>
__global__ void __launch_bounds__(TT)
    qmm4_tiled_kernel(const T* __restrict__ x, long long ldx,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ scales,
                      const float* __restrict__ zs, TO* __restrict__ out,
                      int m, int kp, int n, int group, int vec) {
  // logical slab rows [0, 16): the low half (x columns k0p + j), rows
  // [16, 32): the high half (x columns kp + k0p + j)
  __shared__ __align__(16) float as[2 * TKP][TM];
  __shared__ __align__(16) float bs[2 * TKP][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +4 and 64 + tx*4 .. +4
  const int ty = tid / 16;  // rows ty*4 .. +4
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int ar = tid >> 2;         // A loader: row, 8 consecutive slab rows
  const int ak = (tid & 3) * 8;
  const int br = tid >> 4;         // B loader: packed row, 8 columns
  const int bc = (tid & 15) * 8;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kp; k0 += TKP) {
    {
      const T* xr = x + (long long)(m0 + ar) * ldx;
      const int half = ak >= TKP ? kp : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = k0 + (ak & (TKP - 1)) + j;  // packed row
        as[ak + j][ar] =
            (m0 + ar < m && kk < kp) ? sli::to_f(xr[half + kk]) : 0.f;
      }
    }
    {
      const int kk = k0 + br;
      float wl[8], wh[8];
      if (kk < kp) {
        const uint2 wv = load_w8(q + (long long)kk * n, n0 + bc, n, vec != 0);
        const unsigned int words[2] = {wv.x, wv.y};
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wl[4 * p + j] = nib_lo(words[p], j);
            wh[4 * p + j] = nib_hi(words[p], j);
          }
        if (SCALED) {
          const int gl = kk / group;
          const int gh = (kp + kk) / group;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = n0 + bc + j;
            if (col < n) {
              const float zl = ZEROS ? __ldg(zs + (long long)gl * n + col) : 0.f;
              const float zh = ZEROS ? __ldg(zs + (long long)gh * n + col) : 0.f;
              wl[j] = fold<SCALED, ZEROS>(
                  wl[j], __ldg(scales + (long long)gl * n + col), zl);
              wh[j] = fold<SCALED, ZEROS>(
                  wh[j], __ldg(scales + (long long)gh * n + col), zh);
            } else {
              wl[j] = wh[j] = 0.f;
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) wl[j] = wh[j] = 0.f;
      }
      float4* dl = reinterpret_cast<float4*>(&bs[br][bc]);
      float4* dh = reinterpret_cast<float4*>(&bs[TKP + br][bc]);
      dl[0] = make_float4(wl[0], wl[1], wl[2], wl[3]);
      dl[1] = make_float4(wl[4], wl[5], wl[6], wl[7]);
      dh[0] = make_float4(wh[0], wh[1], wh[2], wh[3]);
      dh[1] = make_float4(wh[4], wh[5], wh[6], wh[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 2 * TKP; ++kk) {
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

template <typename T, bool SCALED, bool ZEROS>
cudaError_t launch_rows4(const void* x, long long ldx, const int8_t* q,
                         const float* scales, const float* zs, float* part,
                         int m, int kp, int n, int kch, int group, int vec,
                         cudaStream_t st) {
  const int chunks = (kp + kch - 1) / kch;
  const dim3 grid((m + RT_MT - 1) / RT_MT, (n + Q4_CW - 1) / Q4_CW, chunks);
  qmm4_rows_kernel<T, SCALED, ZEROS><<<grid, RT_THREADS, 0, st>>>(
      (const T*)x, ldx, q, scales, zs, part, m, kp, n, kch, group, vec);
  return cudaGetLastError();
}

template <typename T, typename TO, bool SCALED, bool ZEROS>
cudaError_t launch_tiled4(const void* x, long long ldx, const int8_t* q,
                          const float* scales, const float* zs, void* out,
                          int m, int kp, int n, int group, int vec,
                          cudaStream_t st) {
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  qmm4_tiled_kernel<T, TO, SCALED, ZEROS><<<grid, TT, 0, st>>>(
      (const T*)x, ldx, q, scales, zs, (TO*)out, m, kp, n, group, vec);
  return cudaGetLastError();
}

template <typename T, typename TO>
int run(const void* x, long long ldx, const int8_t* q, const float* scales,
        const float* zs, void* out, float* work, int m, int kp, int n,
        int group, int kch, int vec, cudaStream_t st) {
  const bool per_channel = group >= 2 * kp;
  cudaError_t e;
  if (kch > 0) {
    if (zs != nullptr)
      e = launch_rows4<T, true, true>(x, ldx, q, scales, zs, work, m, kp, n,
                                      kch, group, vec, st);
    else if (!per_channel)
      e = launch_rows4<T, true, false>(x, ldx, q, scales, zs, work, m, kp,
                                       n, kch, group, vec, st);
    else
      e = launch_rows4<T, false, false>(x, ldx, q, scales, zs, work, m, kp,
                                        n, kch, group, vec, st);
    if (e != cudaSuccess) return (int)e;
    const bool scale_at_end = per_channel && zs == nullptr;
    return (int)launch_qmm_finish<TO>(work, (kp + kch - 1) / kch,
                                      scale_at_end ? scales : nullptr,
                                      nullptr, out, m, n, st);
  }
  if (zs != nullptr)
    e = launch_tiled4<T, TO, true, true>(x, ldx, q, scales, zs, out, m, kp,
                                         n, group, vec, st);
  else if (!per_channel)
    e = launch_tiled4<T, TO, true, false>(x, ldx, q, scales, zs, out, m, kp,
                                          n, group, vec, st);
  else
    e = launch_tiled4<T, TO, false, false>(x, ldx, q, scales, zs, out, m,
                                           kp, n, group, vec, st);
  return (int)e;
}

}  // namespace

extern "C" {

// x: [m, 2 * kp] rows at element stride ldx (x_dtype); q: [kp, n] int8
// split-half packed, of one layer; scales: [2 * kp / group, n] f32 (group
// == 2 * kp: per-channel; otherwise group divides kp); zs: null or the
// same shape as scales; out: [m, n] (out_dtype). kch > 0: the few-rows
// kernel with packed-K ranges of kch rows and work holding ceil(kp / kch)
// * m * n floats; kch == 0: the tiled kernel. vec: q and n allow 8-byte
// weight loads.
int sli_quantized_matmul_int4(const void* x, long long ldx, const void* q,
                              const float* scales, const float* zs,
                              void* out, float* work, int m, int kp, int n,
                              int group, int kch, int x_dtype, int out_dtype,
                              int vec, void* stream) {
  if (m <= 0 || kp <= 0 || n <= 0 || group <= 0 || kch < 0 ||
      (group < 2 * kp && kp % group != 0))
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* qq = (const int8_t*)q;
  if (x_dtype == SLI_F32 && out_dtype == SLI_F32)
    return run<float, float>(x, ldx, qq, scales, zs, out, work, m, kp, n,
                             group, kch, vec, st);
  if (x_dtype == SLI_F32 && out_dtype == SLI_BF16)
    return run<float, __nv_bfloat16>(x, ldx, qq, scales, zs, out, work, m,
                                     kp, n, group, kch, vec, st);
  if (x_dtype == SLI_BF16 && out_dtype == SLI_F32)
    return run<__nv_bfloat16, float>(x, ldx, qq, scales, zs, out, work, m,
                                     kp, n, group, kch, vec, st);
  if (x_dtype == SLI_BF16 && out_dtype == SLI_BF16)
    return run<__nv_bfloat16, __nv_bfloat16>(x, ldx, qq, scales, zs, out,
                                             work, m, kp, n, group, kch, vec,
                                             st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
