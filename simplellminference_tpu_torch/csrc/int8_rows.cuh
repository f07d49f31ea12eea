// Building blocks of the port's int8-weight products for a few activation
// rows (decode): y[m, n] = sum_k x[m, k] * q[k, n], with q an int8 [K, N]
// row-major matrix. Used by quantized_matmul.cu (the "skinny" kernel),
// qkv_fused.cu and ffn_fused.cu.
//
// Bound: bytes. At M <= 8 rows each weight byte feeds at most 8 FMAs, so
// the least time is the K*N weight bytes at the card's memory rate.
//
// Tile: a block of 256 threads owns CW = 16*CT output columns for MT = 8
// rows. Thread (klane, ct) = (tid / CT, tid % CT) streams 16 int8 columns
// [16*ct, 16*ct + 16) of rows k = klane, klane + KL, ... (KL = 256 / CT)
// with one 16-byte load per row, converts them in registers (byte
// permute into the mantissa of 2^23, then one subtract: exact, no
// int-to-float instruction) and keeps MT x 16 f32 sums. The activation
// rows of the current K slab (KC rows) sit in shared memory as f32
// [KC][MT], so every weight byte is read from device memory once per
// block. The KL lanes' partial sums meet in shared memory at the end.
#pragma once

#include "common.cuh"

namespace {

constexpr int RT_THREADS = 256;
constexpr int RT_MT = 8;      // activation rows per block
constexpr int RT_KC = 512;    // K rows of activations staged per slab
constexpr int RT_UNROLL = 4;  // 16-byte weight loads in flight per thread

// 16 int8 weights of one row at columns [c, c + 16), zero at and past n.
// vec: the row start and c are 16-byte aligned.
__device__ __forceinline__ int4 load_w16(const int8_t* __restrict__ row,
                                         int c, int n, bool vec) {
  if (vec && c + 16 <= n) return __ldg(reinterpret_cast<const int4*>(row + c));
  unsigned int u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (c + j < n)
      u[j >> 2] |= (unsigned int)(unsigned char)row[c + j] << (8 * (j & 3));
  }
  return make_int4((int)u[0], (int)u[1], (int)u[2], (int)u[3]);
}

using sli::i8x4_to_f32;

// acc[r][j] += xk[r] * (w[j] * sc[j]) for the 16 weights of one row.
template <bool SCALED>
__device__ __forceinline__ void fma_row(float (&acc)[RT_MT][16], int4 wv,
                                        const float* __restrict__ xk,
                                        const float (&sc)[16]) {
  float xr[RT_MT];
  const float4 x0 = *reinterpret_cast<const float4*>(xk);
  const float4 x1 = *reinterpret_cast<const float4*>(xk + 4);
  xr[0] = x0.x; xr[1] = x0.y; xr[2] = x0.z; xr[3] = x0.w;
  xr[4] = x1.x; xr[5] = x1.y; xr[6] = x1.z; xr[7] = x1.w;
  const unsigned int words[4] = {(unsigned int)wv.x, (unsigned int)wv.y,
                                 (unsigned int)wv.z, (unsigned int)wv.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float w[4];
    i8x4_to_f32(words[q], w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float wj = SCALED ? w[j] * sc[4 * q + j] : w[j];
#pragma unroll
      for (int r = 0; r < RT_MT; ++r)
        acc[r][4 * q + j] = fmaf(xr[r], wj, acc[r][4 * q + j]);
    }
  }
}

// Streams rows [k0, k0 + kcnt) of the weight columns this thread owns
// against the staged slab xs ([RT_KC][RT_MT] f32, row kk at xs + kk*MT).
// row0 points at weight row k0 and column 0 of this thread's column
// range; ldw is the row stride in bytes; c/n are the thread's first column
// and the column bound. SCALED: grouped scales ([K / group, n]), sc holds
// the 16 scales of group g_cur and is reloaded when the group changes
// (weight row kglob0 + kk is in group (kglob0 + kk) / group).
template <int KL, bool SCALED>
__device__ __forceinline__ void stream_rows(
    float (&acc)[RT_MT][16], const int8_t* __restrict__ row0, long long ldw,
    int c, int n, bool vec, int kcnt, int klane, const float* __restrict__ xs,
    const float* __restrict__ scales, int kglob0, int group, float (&sc)[16],
    int& g_cur) {
  for (int kk = klane; kk < kcnt; kk += RT_UNROLL * KL) {
    int4 wv[RT_UNROLL];
#pragma unroll
    for (int u = 0; u < RT_UNROLL; ++u) {
      const int k = kk + u * KL;
      wv[u] = k < kcnt ? load_w16(row0 + (long long)k * ldw, c, n, vec)
                       : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < RT_UNROLL; ++u) {
      const int k = kk + u * KL;
      if (k < kcnt) {
        if (SCALED) {
          const int g = (kglob0 + k) / group;
          if (g != g_cur) {
            g_cur = g;
#pragma unroll
            for (int j = 0; j < 16; ++j)
              sc[j] = c + j < n ? __ldg(scales + (long long)g * n + c + j)
                                : 0.f;
          }
        }
        fma_row<SCALED>(acc, wv[u], xs + k * RT_MT, sc);
      }
    }
  }
}

// Sums the KL lanes' acc into tile[r * CW + col] (f32, CW = 16 * CT
// columns); red is [KL][CW] f32 of shared memory. Ends synchronized.
template <int CT>
__device__ __forceinline__ void reduce_lanes(const float (&acc)[RT_MT][16],
                                             float* red, float* tile) {
  constexpr int CW = 16 * CT;
  constexpr int KL = RT_THREADS / CT;
  const int tid = threadIdx.x;
  const int ct = tid % CT;
  const int klane = tid / CT;
#pragma unroll
  for (int r = 0; r < RT_MT; ++r) {
    float4* dst = reinterpret_cast<float4*>(red + klane * CW + ct * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dst[q] = make_float4(acc[r][4 * q], acc[r][4 * q + 1],
                           acc[r][4 * q + 2], acc[r][4 * q + 3]);
    __syncthreads();
    if (tid < CW) {
      float s = 0.f;
#pragma unroll 8
      for (int l = 0; l < KL; ++l) s += red[l * CW + tid];
      tile[r * CW + tid] = s;
    }
    __syncthreads();
  }
}

// inv[r] = rsqrt(mean(x[m0 + r, :]^2) + eps) for the block's rows (0 for
// rows past m). One warp per row. Ends synchronized.
template <typename T>
__device__ __forceinline__ void row_rms(const T* __restrict__ x, long long ldx,
                                        int m0, int m, int h, float eps,
                                        float* inv) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < RT_MT; r += RT_THREADS / 32) {
    float s = 0.f;
    if (m0 + r < m) {
      const T* xr = x + (long long)(m0 + r) * ldx;
      for (int k = lane; k < h; k += 32) {
        const float v = sli::to_f(xr[k]);
        s = fmaf(v, v, s);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) inv[r] = m0 + r < m ? rsqrtf(s / (float)h + eps) : 0.f;
  }
  __syncthreads();
}

// Stages rows [k0, k0 + kcnt) of the block's activation rows into xs
// ([RT_KC][RT_MT] f32), zero past m and kcnt. NORM: the rows are
// rmsnorm'ed first, (x * inv[r]) * nw[k] in f32, then rounded to T (the
// activation dtype), as the plain version rounds. nw is f32 or bf16
// (nw_bf16). Ends synchronized.
template <typename T, bool NORM>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x,
                                           long long ldx, int m0, int m,
                                           int k0, int kcnt,
                                           const float* __restrict__ inv,
                                           const void* __restrict__ nw,
                                           int nw_bf16, float* xs) {
  __syncthreads();  // the previous slab is no longer read
  for (int i = threadIdx.x; i < RT_MT * RT_KC; i += RT_THREADS) {
    const int r = i / RT_KC;
    const int kk = i - r * RT_KC;
    float v = 0.f;
    if (m0 + r < m && kk < kcnt) {
      v = sli::to_f(x[(long long)(m0 + r) * ldx + k0 + kk]);
      if (NORM) {
        const float w =
            nw_bf16 ? __bfloat162float(
                          reinterpret_cast<const __nv_bfloat16*>(nw)[k0 + kk])
                    : reinterpret_cast<const float*>(nw)[k0 + kk];
        v = sli::to_f(sli::from_f<T>(v * inv[r] * w));
      }
    }
    xs[kk * RT_MT + r] = v;
  }
  __syncthreads();
}

// Partial products of a K range for quantized_matmul and the FFN's down
// projection: grid (ceil(M/MT), ceil(N/256), chunks); block z covers rows
// [z*kch, min(K, (z+1)*kch)) and writes its f32 sums to
// part[z][M][N]. Grouped scales (group < K) fold into the weights in
// registers; per-channel scales are left to qmm_finish.
template <typename T, bool SCALED>
__global__ void __launch_bounds__(RT_THREADS, 1)
    qmm_rows_kernel(const T* __restrict__ x, long long ldx,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scales, float* __restrict__ part,
                    int m, int k, int n, int kch, int group, int vec) {
  constexpr int CT = 16;
  constexpr int CW = 16 * CT;
  constexpr int KL = RT_THREADS / CT;
  __shared__ __align__(16) float xs[RT_KC * RT_MT];
  __shared__ __align__(16) float red[KL * CW];
  __shared__ __align__(16) float tile[RT_MT * CW];
  const int m0 = blockIdx.x * RT_MT;
  const int col0 = blockIdx.y * CW;
  const int kb = blockIdx.z * kch;
  const int ke = min(k, kb + kch);
  const int tid = threadIdx.x;
  const int ct = tid % CT;
  const int klane = tid / CT;
  const int c = col0 + ct * 16;

  float acc[RT_MT][16];
#pragma unroll
  for (int r = 0; r < RT_MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  float sc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) sc[j] = 1.f;
  int g_cur = -1;

  for (int k0 = kb; k0 < ke; k0 += RT_KC) {
    const int kcnt = min(RT_KC, ke - k0);
    stage_rows<T, false>(x, ldx, m0, m, k0, kcnt, nullptr, nullptr, 0, xs);
    stream_rows<KL, SCALED>(acc, q + (long long)k0 * n, n, c, n, vec != 0,
                            kcnt, klane, xs, scales, k0, group, sc, g_cur);
  }
  reduce_lanes<CT>(acc, red, tile);
  for (int i = tid; i < RT_MT * CW; i += RT_THREADS) {
    const int r = i / CW;
    const int col = col0 + (i - r * CW);
    if (m0 + r < m && col < n)
      part[((long long)blockIdx.z * m + m0 + r) * n + col] = tile[i];
  }
}

// out[i, j] = (sum_z part[z, i, j]) * s[j] (+ res[i, j]) in f32, rounded
// once to TO. scales: per-channel row [N], or null (already applied).
template <typename TO>
__global__ void qmm_finish_kernel(const float* __restrict__ part, int chunks,
                                  const float* __restrict__ scales,
                                  const TO* __restrict__ res,
                                  TO* __restrict__ out, int m, int n) {
  const long long total = (long long)m * n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < chunks; ++z) s += part[z * total + i];
    const int col = (int)(i % n);
    if (scales != nullptr) s *= scales[col];
    if (res != nullptr) s += sli::to_f(res[i]);
    out[i] = sli::from_f<TO>(s);
  }
}

template <typename T>
cudaError_t launch_qmm_rows(const void* x, long long ldx, const int8_t* q,
                            const float* scales, float* part, int m, int k,
                            int n, int kch, int group, int vec,
                            cudaStream_t st) {
  const int chunks = (k + kch - 1) / kch;
  const dim3 grid((m + RT_MT - 1) / RT_MT, (n + 255) / 256, chunks);
  if (group < k) {
    qmm_rows_kernel<T, true><<<grid, RT_THREADS, 0, st>>>(
        (const T*)x, ldx, q, scales, part, m, k, n, kch, group, vec);
  } else {
    qmm_rows_kernel<T, false><<<grid, RT_THREADS, 0, st>>>(
        (const T*)x, ldx, q, scales, part, m, k, n, kch, group, vec);
  }
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_qmm_finish(const float* part, int chunks,
                              const float* scales, const void* res, void* out,
                              int m, int n, cudaStream_t st) {
  const long long total = (long long)m * n;
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  qmm_finish_kernel<TO><<<(int)blocks, 256, 0, st>>>(
      part, chunks, scales, (const TO*)res, (TO*)out, m, n);
  return cudaGetLastError();
}

}  // namespace
