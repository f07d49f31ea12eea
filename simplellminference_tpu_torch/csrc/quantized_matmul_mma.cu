// Weight-only INT8 product y = x @ dequant(q, scales) for many activation
// rows (M > 8) with bf16 activations, on the bf16 tensor cores (wgmma).
//
// Replaces, with the few-rows and FMA kernels of quantized_matmul.cu, the
// TPU kernel of simplellminference_tpu/ops/matmul.py: quantized_matmul
// (_qmm_kernel, matmul.py:69-109; wrapper :522). Its math is the TPU
// kernel's own: the int8 tile is cast to bf16 (exact: every code fits
// bf16's 8 significant bits, matmul.py:85-87) and multiplied on the matrix
// unit with an f32 accumulator; per-channel scales ([1, N]) multiply once
// at write-out, grouped scales ([K/G, N]) multiply each group's partial
// sum before it is added (matmul.py:89-96).
//
// Bound on the H100: operations at prefill (M = 1024 rows of the 7B wqkv:
// 103 GFLOP, 0.104 ms at the bf16 tensor-core peak, against 50 MB of
// weights, 0.015 ms), bytes at a verify step (M = 40: the K*N weight
// bytes read once).
//
// Design: the output is cut into BM x 128 tiles, one warpgroup (128
// threads) per 64 rows (BM = 128 from M = 128, else 64: rows past M are
// zero-filled and cost no memory); the row tiles of one column tile are
// neighbours in the grid, so its weights come from device memory about
// once. K runs in slabs of 64 rows through a cp.async ring (6 stages for
// 128-row tiles, 4 for 64; 16-byte copies; rows past M or K and columns
// past N zero-filled by the copy, nothing read): the bf16 activation rows
// land K-major in the 128-byte swizzle wgmma reads (16-byte chunk c of row
// r at chunk c ^ (r % 8)); the int8 weight rows [k][n] land with chunk c of row
// k at chunk c ^ (k / 8 % 8), so that the conversion's reads hit distinct
// banks. Each slab's weights are converted once, exact int8 -> bf16, and
// transposed 4 x 4 bytes at a time in registers into a K-major swizzled
// bf16 tile [n][k]: the next slab's while the tensor cores run this one
// (with 128-row tiles, three such tiles let the one before stay in
// flight too). wgmma.m64n128k16 takes both operands from shared
// memory by descriptor (both K-major, so neither needs the
// transposed-operand mode) and accumulates 64 x 128 f32 per warpgroup in
// registers. One barrier a slab orders the copies, the conversion and the
// products. When the tiles alone would leave SMs idle (the verify step's
// 40 rows, Mistral's 256-row chunk of the down projection), K is split
// across blocks on slab (and scale-group) boundaries: each writes f32
// partial sums and qmm_finish_kernel (int8_rows.cuh) adds them, applies a
// per-channel scale once and rounds once to the output dtype. Grouped
// scales need groups of a multiple of the 64-row slab: at a group's last
// slab the block waits for its products and folds the group's partial,
// times its scale, into a second accumulator. Every K and N is exact (K a
// multiple of 8, N of 16, for the 16-byte copies; the wrapper sends other
// shapes and f32 activations to the FMA kernel).
#include "int8_rows.cuh"

namespace {

constexpr int MM_BN = 128;   // output columns per block
constexpr int MM_BK = 64;    // K rows per slab (128 bytes of bf16)
constexpr int MM_ROW = 128;  // bytes of a swizzled smem row

template <int WM>  // warpgroups along M: BM = 64 * WM rows, 128 * WM threads
struct MmGeo {
  static constexpr int BM = 64 * WM;
  static constexpr int NT = 128 * WM;
  static constexpr int STAGES = WM == 2 ? 6 : 4;
  // converted tiles: with three (128-row tiles, operation-bound), the
  // products of slab i - 1 may still run while slab i + 1 is converted
  // (LAG = 1 wgmma group left in flight); the bytes-bound 64-row tiles
  // keep two and drain the products every slab (LAG = 0) to hold two
  // blocks an SM
  static constexpr int CBUFS = WM == 2 ? 3 : 2;
  static constexpr int LAG = CBUFS - 2;
  static constexpr int A_STAGE = BM * MM_ROW;     // bf16 [BM][64]
  static constexpr int B_STAGE = MM_BK * MM_BN;   // int8 [64][128]
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int CBUF = MM_BN * MM_ROW;     // bf16 [128][64]
  // + 1024: the base is rounded up to the 1024-byte swizzle atom
  static constexpr int SMEM = STAGES * STAGE + CBUFS * CBUF + 1024;
};

__device__ __forceinline__ void mm_cp16(void* dst, const void* src,
                                        bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ unsigned long long mm_desc(const void* p) {
  const unsigned long long a = (unsigned)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Keeps the compiler from moving accumulator definitions into a wgmma
// batch (which would serialize the batch).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, f32 accumulators in
// this thread's 64 registers; A and B K-major in 128-byte-swizzled shared
// memory (descriptors), never transposed.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], unsigned long long da,
                                                 unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// x: [m, k] bf16 rows at stride ldx; q: [k, n] int8; out: [m, n] of TO, or
// (PART) f32 partial sums part[blockIdx.z][m][n] of K rows
// [z * kch, min(k, (z + 1) * kch)). SCALED: grouped scales [k / group, n]
// applied per group; else per-channel scales [n], applied here unless
// PART (then by qmm_finish).
template <int WM, bool SCALED, bool PART, typename TO>
__global__ void __launch_bounds__(MmGeo<WM>::NT)
    qmm_mma_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                   const int8_t* __restrict__ q,
                   const float* __restrict__ scales, TO* __restrict__ out,
                   float* __restrict__ part, int m, int k, int n, int group,
                   int kch) {
  using G = MmGeo<WM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(
                                                 smem_raw) & 1023)) & 1023);
  unsigned char* cbufs = smem + G::STAGES * G::STAGE;  // 3 x bf16 [128][64]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;          // warpgroup: rows wg * 64 .. + 64
  const int wr = (tid >> 5) & 3;    // warp in it: rows wr * 16 .. + 16
  const int m0 = blockIdx.x * G::BM;
  const int n0 = blockIdx.y * MM_BN;
  const int kb = blockIdx.z * kch;
  const int ke = min(k, kb + kch);
  const int nslab = (ke - kb + MM_BK - 1) / MM_BK;

  auto load = [&](int slab, int st) {
    unsigned char* as = smem + st * G::STAGE;
    unsigned char* bs = as + G::A_STAGE;
    const int k0 = kb + slab * MM_BK;
    for (int i = tid; i < G::BM * 8; i += G::NT) {  // 8 bf16 a copy
      const int r = i >> 3;
      const int c = i & 7;
      const bool ok = m0 + r < m && k0 + c * 8 < ke;
      const __nv_bfloat16* src =
          ok ? x + (long long)(m0 + r) * ldx + k0 + c * 8 : x;
      mm_cp16(as + r * MM_ROW + ((c ^ (r & 7)) << 4), src, ok);
    }
    for (int i = tid; i < MM_BK * 8; i += G::NT) {  // 16 int8 a copy
      const int r = i >> 3;
      const int c = i & 7;
      const bool ok = k0 + r < ke && n0 + c * 16 < n;
      const int8_t* src = ok ? q + (long long)(k0 + r) * n + n0 + c * 16 : q;
      mm_cp16(bs + r * MM_BN + ((c ^ ((r >> 3) & 7)) << 4), src, ok);
    }
  };

  // slab j's int8 [k][n] -> bf16 [n][k] in converted tile j % 3: a thread
  // takes 8 k (chunk kc) x 4 n, reads 8 words, transposes 4 x 4 bytes at a
  // time and writes 4 swizzled 16-byte chunks
  auto convert = [&](int j) {
    const unsigned char* bs = smem + (j % G::STAGES) * G::STAGE + G::A_STAGE;
    unsigned char* cb = cbufs + (j % G::CBUFS) * G::CBUF;
    for (int blk = tid; blk < 8 * 32; blk += G::NT) {
      const int kc = blk & 7;
      const int bn = blk >> 3;  // n = 4 * bn .. + 4
      const int boff = (((bn >> 2) ^ kc) << 4) + ((bn & 3) << 2);
      unsigned w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = *reinterpret_cast<const unsigned*>(bs + (kc * 8 + i) * MM_BN +
                                                  boff);
      unsigned col[2][4];  // [k half][n]: 4 k codes of one n
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned t01 = __byte_perm(w[4 * h], w[4 * h + 1], 0x5140);
        const unsigned t23 = __byte_perm(w[4 * h + 2], w[4 * h + 3], 0x5140);
        const unsigned u01 = __byte_perm(w[4 * h], w[4 * h + 1], 0x7362);
        const unsigned u23 = __byte_perm(w[4 * h + 2], w[4 * h + 3], 0x7362);
        col[h][0] = __byte_perm(t01, t23, 0x5410);
        col[h][1] = __byte_perm(t01, t23, 0x7632);
        col[h][2] = __byte_perm(u01, u23, 0x5410);
        col[h][3] = __byte_perm(u01, u23, 0x7632);
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int nn = 4 * bn + jn;
        unsigned o[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float f[4];
          i8x4_to_f32(col[h][jn], f);  // exact
          o[2 * h] = bf16x2(f[0], f[1]);
          o[2 * h + 1] = bf16x2(f[2], f[3]);
        }
        *reinterpret_cast<uint4*>(cb + nn * MM_ROW + ((kc ^ (nn & 7)) << 4)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  };

  float acc[64];  // the running (group's) sums: wgmma's D fragment
  float tot[64];  // SCALED: the scaled groups' total
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  // fragment i: n8 chunk i / 4, row lane / 4 (+ 8 for i % 4 >= 2),
  // column 2 * (lane % 4) (+ 1 for odd i)
  const int col0 = n0 + 2 * (lane & 3);

  // copies run STAGES - 1 - LAG slabs ahead, the conversion one slab
  // ahead, and LAG wgmma groups stay in flight across the barrier: at
  // slab i the barrier needs slab i + 1's copies, slab i's converted tile
  // and the products of slab i - 1 - LAG (whose stage and converted tile
  // are reused)
  constexpr int AHEAD = G::STAGES - 1 - G::LAG;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nslab) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1));
  __syncthreads();
  convert(0);
  for (int i = 0; i < nslab; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 2));
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(G::LAG)
                 : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    {
      const int nx = i + AHEAD;  // into slab i - 1 - LAG's stage
      if (nx < nslab) load(nx, nx % G::STAGES);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const unsigned char* as =
        smem + (i % G::STAGES) * G::STAGE + wg * 64 * MM_ROW;
    const unsigned char* cbuf = cbufs + (i % G::CBUFS) * G::CBUF;
    if (m0 + wg * 64 < m) {  // a warpgroup-uniform skip of rows past M
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < MM_BK / 16; ++kk)
        wgmma_m64n128k16(acc, mm_desc(as + kk * 32), mm_desc(cbuf + kk * 32));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_acc(acc);
    }
    if (i + 1 < nslab) convert(i + 1);  // while the tensor cores run slab i
    if (SCALED) {
      const int k1 = kb + (i + 1) * MM_BK;  // this slab's end
      if (k1 % group == 0 || k1 >= ke) {
        // a group ends: its partial times its scale joins the total
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        const float* srow = scales + (long long)((k1 - 1) / group) * n;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = col0 + j * 8;
          const float s0 = c < n ? __ldg(srow + c) : 0.f;
          const float s1 = c + 1 < n ? __ldg(srow + c + 1) : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[4 * j + e] =
                fmaf(acc[4 * j + e], (e & 1) ? s1 : s0, tot[4 * j + e]);
            acc[4 * j + e] = 0.f;
          }
        }
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  asm volatile("cp.async.wait_group 0;\n" ::);

  // write-out: fragment i at row wr * 16 + lane / 4 (+ 8), column
  // col0 + (i / 4) * 8 (+ 1)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + j * 8;
    if (c >= n) continue;  // n is even: c + 1 < n too
    float s0 = 1.f;
    float s1 = 1.f;
    if (!SCALED && !PART) {
      s0 = __ldg(scales + c);
      s1 = __ldg(scales + c + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + wr * 16 + (lane >> 2) + 8 * h;
      if (row >= m) continue;
      const float v0 = SCALED ? tot[4 * j + 2 * h] : acc[4 * j + 2 * h];
      const float v1 = SCALED ? tot[4 * j + 2 * h + 1] : acc[4 * j + 2 * h + 1];
      if (PART) {
        float* p = part + ((long long)blockIdx.z * m + row) * n + c;
        p[0] = v0;
        p[1] = v1;
      } else {
        TO* o = out + (long long)row * n + c;
        o[0] = sli::from_f<TO>(v0 * s0);
        o[1] = sli::from_f<TO>(v1 * s1);
      }
    }
  }
}

template <int WM, bool SCALED, bool PART, typename TO>
cudaError_t launch_mma(const void* x, long long ldx, const int8_t* q,
                       const float* scales, void* out, float* part, int m,
                       int k, int n, int group, int kch, cudaStream_t st) {
  using G = MmGeo<WM>;
  auto kern = qmm_mma_kernel<WM, SCALED, PART, TO>;
  cudaError_t e = sli::allow_smem(kern, G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + G::BM - 1) / G::BM, (n + MM_BN - 1) / MM_BN,
                  (k + kch - 1) / kch);
  kern<<<grid, G::NT, G::SMEM, st>>>((const __nv_bfloat16*)x, ldx, q, scales,
                                     (TO*)out, part, m, k, n, group, kch);
  return cudaGetLastError();
}

template <int WM, typename TO>
int run_mma(const void* x, long long ldx, const int8_t* q,
            const float* scales, void* out, float* work, int m, int k, int n,
            int group, int kch, cudaStream_t st) {
  const bool grouped = group < k;
  const int chunks = (k + kch - 1) / kch;
  cudaError_t e;
  if (chunks == 1) {
    e = grouped ? launch_mma<WM, true, false, TO>(x, ldx, q, scales, out,
                                                  nullptr, m, k, n, group,
                                                  kch, st)
                : launch_mma<WM, false, false, TO>(x, ldx, q, scales, out,
                                                   nullptr, m, k, n, group,
                                                   kch, st);
    return (int)e;
  }
  e = grouped ? launch_mma<WM, true, true, TO>(x, ldx, q, scales, nullptr,
                                               work, m, k, n, group, kch, st)
              : launch_mma<WM, false, true, TO>(x, ldx, q, scales, nullptr,
                                                work, m, k, n, group, kch,
                                                st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_qmm_finish<TO>(work, chunks, grouped ? nullptr : scales,
                                    nullptr, out, m, n, st);
}

}  // namespace

extern "C" {

// x: [m, k] bf16 rows at element stride ldx (16-byte aligned rows); q:
// [k, n] int8 of one layer (16-byte aligned); scales: [k / group, n] f32
// (group == k: per-channel); out: [m, n] (out_dtype). kch: K rows per
// block (a multiple of 64, and of group when grouped); with
// ceil(k / kch) > 1, work holds ceil(k / kch) * m * n floats. wm: 2 for
// 128-row tiles, 1 for 64-row tiles.
int sli_quantized_matmul_mma(const void* x, long long ldx, const void* q,
                             const float* scales, void* out, float* work,
                             int m, int k, int n, int group, int kch, int wm,
                             int out_dtype, void* stream) {
  const bool grouped = group < k;
  if (m <= 0 || k <= 0 || n <= 0 || k % 8 || n % 16 || ldx % 8 ||
      group <= 0 || k % group || (grouped && group % MM_BK) || kch <= 0 ||
      kch % MM_BK || (grouped && kch % group) || (wm != 1 && wm != 2) ||
      ((unsigned long long)x | (unsigned long long)q) % 16)
    return SLI_ERR_SHAPE;
  if ((k + kch - 1) / kch > 1 && work == nullptr) return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* qq = (const int8_t*)q;
  if (out_dtype == SLI_F32)
    return wm == 2 ? run_mma<2, float>(x, ldx, qq, scales, out, work, m, k,
                                       n, group, kch, st)
                   : run_mma<1, float>(x, ldx, qq, scales, out, work, m, k,
                                       n, group, kch, st);
  if (out_dtype == SLI_BF16)
    return wm == 2 ? run_mma<2, __nv_bfloat16>(x, ldx, qq, scales, out, work,
                                               m, k, n, group, kch, st)
                   : run_mma<1, __nv_bfloat16>(x, ldx, qq, scales, out, work,
                                               m, k, n, group, kch, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
