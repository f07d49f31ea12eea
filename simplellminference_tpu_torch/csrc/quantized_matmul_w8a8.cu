// W8A8 product y = (xi @ q) * scales * xs: per-token int8 activations
// against int8 weights, int32 dots.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/matmul.py:
//   quantized_matmul_w8a8 (_qmm_w8a8_kernel, matmul.py:177-216; wrapper
//   :232): xi [M, K] int8 with row scales xs [M, 1] f32 (made by
//   quantize_activations_int8, outside the kernel as in the reference),
//   q [K, N] int8 of one layer, scales per output channel ([1, N]) or per
//   group ([K/G, N]). The prefill form of the INT8 product: the linear
//   layer takes it for 128 rows or more (ops/linear.py). Since the int8
//   tensor-core kernel (quantized_matmul_w8a8_wgmma.cu) this one takes
//   only what that one does not: K or N off a multiple of 16, and groups
//   off a multiple of its 128-row slab (ops/matmul.py w8a8_regime).
//
// Bound: operations. At M = 1024 the 7B wqkv is 103 G integer
// multiply-adds, 0.052 ms at the int8 tensor-core peak (1,979 TOP/s).
// This kernel is the simple route: a shared-memory tiled kernel (64 x 128
// output tile, 64-deep K slabs, 4 x 8 outputs a thread) on __dp4a, four
// int8 products summed into an int32 per instruction, on the integer
// pipes rather than the tensor cores, so it stays well above that bound.
// The weight slab is transposed into K-major 32-bit words while staged
// (byte permutes of four rows), so that a word holds four K values of one
// column, as the activation words hold four K values of one row.
//
// Per-channel scales: one int32 sum over K (|sum| <= K * 127^2 < 2^31 for
// K <= 133k), then (float)sum * s[n] * xs[m] at write-out. Grouped
// scales: each group's int32 partial becomes f32, is multiplied by its
// scale and added to an f32 accumulator, then times xs[m] (groups must be
// a multiple of 4 rows: a 32-bit word never straddles two). The integer
// part is exact, so the kernel and its plain version differ only in the
// order of the f32 sums. Every K and N is exact: rows past K and columns
// past N read as zero.
#include "common.cuh"

namespace {

constexpr int TM = 64;   // output rows per block
constexpr int TN = 128;  // output columns per block
constexpr int TK = 64;   // K rows per slab (16 words)
constexpr int TW = TK / 4;
constexpr int TT = 256;  // threads

// Bytes [c, c + 4) of row `row` (zero past n or past k rows), packed.
__device__ __forceinline__ unsigned int load4(const int8_t* __restrict__ q,
                                              int row, int k, int c, int n,
                                              bool vec) {
  if (row >= k) return 0u;
  const int8_t* p = q + (long long)row * n + c;
  if (vec && c + 4 <= n)
    return (unsigned int)__ldg(reinterpret_cast<const int*>(p));
  unsigned int u = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < n) u |= (unsigned int)(unsigned char)p[j] << (8 * j);
  return u;
}

template <typename TO, bool GROUPED>
__global__ void __launch_bounds__(TT)
    qmm_w8a8_kernel(const int8_t* __restrict__ xi,
                    const float* __restrict__ xs,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scales, TO* __restrict__ out,
                    int m, int k, int n, int group, int vec_q, int vec_x) {
  __shared__ __align__(16) int as[TW][TM];   // word w: K rows 4w .. 4w+3
  __shared__ __align__(16) int bs[TW][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4 .. +4 and 64 + tx*4 .. +4
  const int ty = tid / 16;  // rows ty*4 .. +4
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  const int ar = tid >> 2;         // A loader: row, 16 consecutive K
  const int ak = (tid & 3) * 16;
  const int bq = tid >> 5;         // B loader: K rows 8bq .. +8, 4 columns
  const int bc = (tid & 31) * 4;

  int acc[4][8];
  float facc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0;
      facc[i][j] = 0.f;
    }
  int cols[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    cols[j] = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
  int g = 0;           // the group being summed
  int gend = group;    // its end (a K row)
  const int ngroups = k / group;

  for (int k0 = 0; k0 < k; k0 += TK) {
    {
      const int row = m0 + ar;
      unsigned int u[4] = {0u, 0u, 0u, 0u};
      if (row < m) {
        const int8_t* p = xi + (long long)row * k + k0 + ak;
        if (vec_x && k0 + ak + 16 <= k) {
          const int4 v = *reinterpret_cast<const int4*>(p);
          u[0] = (unsigned int)v.x;
          u[1] = (unsigned int)v.y;
          u[2] = (unsigned int)v.z;
          u[3] = (unsigned int)v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (k0 + ak + j < k)
              u[j >> 2] |= (unsigned int)(unsigned char)p[j] << (8 * (j & 3));
        }
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) as[ak / 4 + w][ar] = (int)u[w];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = k0 + 8 * bq + 4 * h;
      const unsigned int w0 = load4(q, r0, k, n0 + bc, n, vec_q != 0);
      const unsigned int w1 = load4(q, r0 + 1, k, n0 + bc, n, vec_q != 0);
      const unsigned int w2 = load4(q, r0 + 2, k, n0 + bc, n, vec_q != 0);
      const unsigned int w3 = load4(q, r0 + 3, k, n0 + bc, n, vec_q != 0);
      // 4 x 4 byte transpose: column j's word holds rows r0 .. r0+3
      const unsigned int lo01 = __byte_perm(w0, w1, 0x5140);
      const unsigned int lo23 = __byte_perm(w2, w3, 0x5140);
      const unsigned int hi01 = __byte_perm(w0, w1, 0x7362);
      const unsigned int hi23 = __byte_perm(w2, w3, 0x7362);
      int* dst = &bs[2 * bq + h][bc];
      dst[0] = (int)__byte_perm(lo01, lo23, 0x5410);
      dst[1] = (int)__byte_perm(lo01, lo23, 0x7632);
      dst[2] = (int)__byte_perm(hi01, hi23, 0x5410);
      dst[3] = (int)__byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < TW; ++w) {
      if (GROUPED && k0 + 4 * w == gend) {
        // the group ends before this word: scale its partials into facc
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float s =
              cols[j] < n ? __ldg(scales + (long long)g * n + cols[j]) : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            facc[i][j] = fmaf((float)acc[i][j], s, facc[i][j]);
            acc[i][j] = 0;
          }
        }
        ++g;
        gend += group;
      }
      const int4 a = *reinterpret_cast<const int4*>(&as[w][ty * 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&bs[w][tx * 4]);
      const int4 b1 = *reinterpret_cast<const int4*>(&bs[w][64 + tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
    const float xsr = __ldg(xs + row);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cols[j];
      if (col >= n) continue;
      float v;
      if (GROUPED) {
        v = facc[i][j];
        if (g < ngroups)
          v = fmaf((float)acc[i][j], __ldg(scales + (long long)g * n + col),
                   v);
      } else {
        v = (float)acc[i][j] * __ldg(scales + col);
      }
      out[(long long)row * n + col] = sli::from_f<TO>(v * xsr);
    }
  }
}

template <typename TO>
int run(const int8_t* xi, const float* xs, const int8_t* q,
        const float* scales, void* out, int m, int k, int n, int group,
        int vec_q, int vec_x, cudaStream_t st) {
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  if (group >= k)
    qmm_w8a8_kernel<TO, false><<<grid, TT, 0, st>>>(
        xi, xs, q, scales, (TO*)out, m, k, n, k, vec_q, vec_x);
  else
    qmm_w8a8_kernel<TO, true><<<grid, TT, 0, st>>>(
        xi, xs, q, scales, (TO*)out, m, k, n, group, vec_q, vec_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xi: [m, k] int8, contiguous; xs: [m] f32 row scales; q: [k, n] int8 of
// one layer; scales: [k / group, n] f32 (group == k: per-channel; else a
// multiple of 4 dividing k); out: [m, n] (out_dtype). vec_q: q and n allow
// 4-byte loads; vec_x: xi and k allow 16-byte loads.
int sli_quantized_matmul_w8a8(const void* xi, const float* xs, const void* q,
                              const float* scales, void* out, int m, int k,
                              int n, int group, int out_dtype, int vec_q,
                              int vec_x, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || group <= 0 || k % group != 0 ||
      (group < k && group % 4 != 0))
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* x8 = (const int8_t*)xi;
  const int8_t* q8 = (const int8_t*)q;
  if (out_dtype == SLI_F32)
    return run<float>(x8, xs, q8, scales, out, m, k, n, group, vec_q, vec_x,
                      st);
  if (out_dtype == SLI_BF16)
    return run<__nv_bfloat16>(x8, xs, q8, scales, out, m, k, n, group, vec_q,
                              vec_x, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
