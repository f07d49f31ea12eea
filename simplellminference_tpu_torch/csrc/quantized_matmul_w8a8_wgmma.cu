// W8A8 product y = (xi @ q) * scales * xs on the int8 tensor cores (wgmma
// s8 x s8 -> s32): per-token int8 activation codes against int8 weights.
//
// Replaces, with the dp4a kernel of quantized_matmul_w8a8.cu (which keeps
// the shapes this one does not take), the TPU kernel of
// simplellminference_tpu/ops/matmul.py: quantized_matmul_w8a8
// (_qmm_w8a8_kernel, matmul.py:177-216; wrapper :232). xi [M, K] int8 and
// the row scales xs [M] f32 come from quantize_activations_int8 (torch
// ops, outside the kernel as in the reference); q [K, N] int8 of one
// layer; scales per output channel ([1, N]) or per group ([K/G, N]).
//
// Bound on the H100: operations at prefill (M = 1024 rows of the 7B wqkv:
// 51.5 G multiply-adds, 0.052 ms at 1,979 TOP/s), bytes at M = 128 (the
// 50 MB weight read once, 0.015 ms). The dp4a kernel sits on the integer
// pipes (about 64 four-way dots an SM a clock), 20x the bound; the int8
// tensor cores run about 15x faster.
//
// Design: 8-bit wgmma reads both operands K-major from shared memory and
// has no transpose mode. The activation codes [M, K] are K-major already;
// the weights [K, N] are N-major. Of the two ways round that (transpose a
// staged slab in shared memory, or swap the operands and feed the weights
// from registers as 14w does), this kernel transposes: a thread's 4 x 4
// byte permutes give it four weight columns at once, which register-
// sourced A could only use by spreading them over four m64 tiles (a 64-
// column warpgroup has one), and the staged route is 5m's
// (quantized_matmul_mma.cu) with the bytes kept int8 and no conversion.
// The output is cut into BM x 128 tiles, one warpgroup per 64 rows (BM =
// 256 per channel from M = 256, 128 from M = 128, else 64; rows past M
// are zero-filled and cost no memory): a slab's weight copies and
// transpose serve BM rows, so the 256-row tile moves a quarter less from
// L2 per output, which bounds this kernel, and transposes half as often.
// K runs in slabs of 128
// rows (128 bytes: one 128-byte swizzle row) through a cp.async ring of
// 16-byte copies, 6 stages (4 for 256-row tiles; rows past M or K and
// columns past N zero-filled by the copy): the activation rows land in the
// swizzle wgmma reads (16-byte chunk c of row r at c ^ (r % 8)); the
// weight rows [k][n] with chunk c of row k at c ^ (k / 16 % 8), so that
// the transpose's reads hit 32 distinct banks. Each slab's weights are
// transposed once, 4 x 4 bytes at a time in registers, into a K-major
// swizzled int8 tile [n][k], the next slab's while the tensor cores run
// this one. wgmma.m64n128k32.s32.s8.s8 takes both tiles by descriptor and
// accumulates 64 x 128 s32 per warpgroup in registers: the integer sums
// are exact.
//
// Scales, in the plain version's order (ops/ref_ops.py
// quantized_matmul_w8a8_ref): per channel, one s32 sum over K, then
// (float)sum * s[n] * xs[m] at write-out; grouped (groups a multiple of
// the 128-row slab), at each group's last slab the block waits for its
// products and adds (float)partial * s[g][n] to an f32 total, in group
// order, then total * xs[m]. No multiply-add is contracted, so an output
// of one block equals the plain version's bit for bit wherever that one's
// f32 sums are exact. When the tiles alone would leave SMs idle, K is
// split across blocks on slab (and group) edges, from shapes alone
// (ops/matmul.py w8a8_split): each block writes its partial, s32 per
// channel and f32 grouped, and w8a8_finish_kernel adds them in block
// order (the integers exactly) and applies the scales. qmm_finish_kernel
// (int8_rows.cuh) cannot serve here: it sums in f32 and has no row scale.
#include "common.cuh"

namespace {

constexpr int WQ_BN = 128;   // output columns per block
constexpr int WQ_BK = 128;   // K rows per slab (128 bytes of int8)
constexpr int WQ_ROW = 128;  // bytes of a swizzled smem row

template <int WM>  // warpgroups along M: BM = 64 * WM rows, 128 * WM threads
struct WqGeo {
  static constexpr int BM = 64 * WM;
  static constexpr int NT = 128 * WM;
  // 6 stages (4 for 256-row tiles) fill the 227 KB a block may take
  static constexpr int STAGES = WM == 4 ? 4 : 6;
  // two transposed tiles: slab i + 1's is written while the tensor cores
  // read slab i's; the products are drained every slab
  static constexpr int CBUFS = 2;
  static constexpr int A_STAGE = BM * WQ_ROW;    // int8 [BM][128]
  static constexpr int B_STAGE = WQ_BK * WQ_BN;  // int8 [128 k][128 n]
  static constexpr int STAGE = A_STAGE + B_STAGE;
  static constexpr int CBUF = WQ_BN * WQ_ROW;    // int8 [128 n][128 k]
  // + 1024: the base is rounded up to the 1024-byte swizzle atom
  static constexpr int SMEM = STAGES * STAGE + CBUFS * CBUF + 1024;
};

__device__ __forceinline__ void wq_cp16(void* dst, const void* src,
                                        bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the same bytes for 8-bit k32 as for bf16 k16)
__device__ __forceinline__ unsigned long long wq_desc(const void* p) {
  const unsigned long long a = (unsigned)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Keeps the compiler from moving accumulator definitions into a wgmma
// batch (which would serialize the batch).
__device__ __forceinline__ void wq_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 32] B[32 x 128], s8 in, s32 accumulators in this
// thread's 64 registers; A and B K-major in 128-byte-swizzled shared
// memory (descriptors).
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64],
                                                    unsigned long long da,
                                                    unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// xi: [m, k] int8 codes (16-byte aligned rows); xs: [m] f32; q: [k, n]
// int8; out: [m, n] of TO, or (PART) partial sums of K rows [z * kch,
// min(k, (z + 1) * kch)) at part[z][m][n]: s32 per channel, f32 grouped.
// GROUPED: scales [k / group, n] folded at group ends; else per-channel
// scales [n] at write-out (by w8a8_finish when PART).
template <int WM, bool GROUPED, bool PART, typename TO>
__global__ void __launch_bounds__(WqGeo<WM>::NT)
    qmm_w8a8_wgmma_kernel(const int8_t* __restrict__ xi,
                          const float* __restrict__ xs,
                          const int8_t* __restrict__ q,
                          const float* __restrict__ scales,
                          TO* __restrict__ out, void* __restrict__ part,
                          int m, int k, int n, int group, int kch) {
  using G = WqGeo<WM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(
                                                 smem_raw) & 1023)) & 1023);
  unsigned char* cbufs = smem + G::STAGES * G::STAGE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;          // warpgroup: rows wg * 64 .. + 64
  const int wr = (tid >> 5) & 3;    // warp in it: rows wr * 16 .. + 16
  const int m0 = blockIdx.x * G::BM;
  const int n0 = blockIdx.y * WQ_BN;
  const int kb = blockIdx.z * kch;
  const int ke = min(k, kb + kch);
  const int nslab = (ke - kb + WQ_BK - 1) / WQ_BK;

  auto load = [&](int slab, int st) {
    unsigned char* as = smem + st * G::STAGE;
    unsigned char* bs = as + G::A_STAGE;
    const int k0 = kb + slab * WQ_BK;
    for (int i = tid; i < G::BM * 8; i += G::NT) {  // 16 codes a copy
      const int r = i >> 3;
      const int c = i & 7;
      const bool ok = m0 + r < m && k0 + c * 16 < ke;
      const int8_t* src = ok ? xi + (long long)(m0 + r) * k + k0 + c * 16 : xi;
      wq_cp16(as + r * WQ_ROW + ((c ^ (r & 7)) << 4), src, ok);
    }
    for (int i = tid; i < WQ_BK * 8; i += G::NT) {  // 16 weights a copy
      const int r = i >> 3;
      const int c = i & 7;
      const bool ok = k0 + r < ke && n0 + c * 16 < n;
      const int8_t* src = ok ? q + (long long)(k0 + r) * n + n0 + c * 16 : q;
      wq_cp16(bs + r * WQ_BN + ((c ^ ((r >> 4) & 7)) << 4), src, ok);
    }
  };

  // slab j's int8 [k][n] -> int8 [n][k] in transposed tile j % CBUFS: a
  // thread takes 16 k (chunk kc) x 4 n, reads 16 words, transposes 4 x 4
  // bytes at a time and writes 4 swizzled 16-byte chunks
  auto transpose = [&](int j) {
    const unsigned char* bs = smem + (j % G::STAGES) * G::STAGE + G::A_STAGE;
    unsigned char* cb = cbufs + (j % G::CBUFS) * G::CBUF;
    for (int blk = tid; blk < 8 * 32; blk += G::NT) {
      const int kc = blk & 7;
      const int bn = blk >> 3;  // n = 4 * bn .. + 4
      const int boff = (((bn >> 2) ^ kc) << 4) + ((bn & 3) << 2);
      unsigned col[4][4];  // [k quarter][n]: 4 k codes of one n
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        unsigned w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = *reinterpret_cast<const unsigned*>(
              bs + (kc * 16 + 4 * h + i) * WQ_BN + boff);
        const unsigned t01 = __byte_perm(w[0], w[1], 0x5140);
        const unsigned t23 = __byte_perm(w[2], w[3], 0x5140);
        const unsigned u01 = __byte_perm(w[0], w[1], 0x7362);
        const unsigned u23 = __byte_perm(w[2], w[3], 0x7362);
        col[h][0] = __byte_perm(t01, t23, 0x5410);
        col[h][1] = __byte_perm(t01, t23, 0x7632);
        col[h][2] = __byte_perm(u01, u23, 0x5410);
        col[h][3] = __byte_perm(u01, u23, 0x7632);
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int nn = 4 * bn + jn;
        *reinterpret_cast<uint4*>(cb + nn * WQ_ROW + ((kc ^ (nn & 7)) << 4)) =
            make_uint4(col[0][jn], col[1][jn], col[2][jn], col[3][jn]);
      }
    }
  };

  int acc[64];    // the running (group's) s32 sums: wgmma's D fragment
  float tot[64];  // GROUPED: the scaled groups' total
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0;
    tot[i] = 0.f;
  }
  // fragment i: n8 chunk i / 4, row lane / 4 (+ 8 for i % 4 >= 2),
  // column 2 * (lane % 4) (+ 1 for odd i)
  const int col0 = n0 + 2 * (lane & 3);

  // copies run STAGES - 1 slabs ahead and the transpose one slab ahead:
  // at slab i the barrier needs slab i + 1's copies, slab i's transposed
  // tile and the products of slab i - 1 (whose stage and tile are reused)
  constexpr int AHEAD = G::STAGES - 1;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nslab) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1));
  __syncthreads();
  transpose(0);
  for (int i = 0; i < nslab; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 2));
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    {
      const int nx = i + AHEAD;  // into slab i - 1's stage
      if (nx < nslab) load(nx, nx % G::STAGES);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const unsigned char* as =
        smem + (i % G::STAGES) * G::STAGE + wg * 64 * WQ_ROW;
    const unsigned char* cbuf = cbufs + (i % G::CBUFS) * G::CBUF;
    if (m0 + wg * 64 < m) {  // a warpgroup-uniform skip of rows past M
      wq_fence(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WQ_BK / 32; ++kk)
        wgmma_s8_m64n128k32(acc, wq_desc(as + kk * 32),
                            wq_desc(cbuf + kk * 32));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      wq_fence(acc);
    }
    if (i + 1 < nslab) transpose(i + 1);  // while the tensor cores run slab i
    if (GROUPED) {
      const int k1 = kb + (i + 1) * WQ_BK;  // this slab's end
      if (k1 % group == 0 || k1 >= ke) {
        // a group ends: its partial as f32 times its scale joins the total
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        wq_fence(acc);
        const float* srow = scales + (long long)((k1 - 1) / group) * n;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = col0 + j * 8;
          const float s0 = c < n ? __ldg(srow + c) : 0.f;
          const float s1 = c + 1 < n ? __ldg(srow + c + 1) : 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[4 * j + e] = __fadd_rn(
                tot[4 * j + e], __fmul_rn((float)acc[4 * j + e],
                                          (e & 1) ? s1 : s0));
            acc[4 * j + e] = 0;
          }
        }
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wq_fence(acc);
  asm volatile("cp.async.wait_group 0;\n" ::);

  // write-out: fragment i at row wr * 16 + lane / 4 (+ 8), column
  // col0 + (i / 4) * 8 (+ 1)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + j * 8;
    if (c >= n) continue;  // n is even: c + 1 < n too
    float s0 = 1.f;
    float s1 = 1.f;
    if (!GROUPED && !PART) {
      s0 = __ldg(scales + c);
      s1 = __ldg(scales + c + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + wr * 16 + (lane >> 2) + 8 * h;
      if (row >= m) continue;
      const int e = 4 * j + 2 * h;
      const long long o = (long long)row * n + c;
      if (PART) {
        const long long po = (long long)blockIdx.z * m * n + o;
        if (GROUPED) {
          float* p = reinterpret_cast<float*>(part) + po;
          p[0] = tot[e];
          p[1] = tot[e + 1];
        } else {
          int* p = reinterpret_cast<int*>(part) + po;
          p[0] = acc[e];
          p[1] = acc[e + 1];
        }
        continue;
      }
      const float xr = __ldg(xs + row);
      const float v0 = GROUPED ? tot[e] : __fmul_rn((float)acc[e], s0);
      const float v1 = GROUPED ? tot[e + 1] : __fmul_rn((float)acc[e + 1], s1);
      out[o] = sli::from_f<TO>(__fmul_rn(v0, xr));
      out[o + 1] = sli::from_f<TO>(__fmul_rn(v1, xr));
    }
  }
}

// out[i, j] from the K blocks' partials, added in block order: per
// channel the s32 sums exactly, then (float)sum * s[j] * xs[i]; grouped
// the f32 totals, then total * xs[i].
template <bool GROUPED, typename TO>
__global__ void w8a8_finish_kernel(const void* __restrict__ part, int chunks,
                                   const float* __restrict__ scales,
                                   const float* __restrict__ xs,
                                   TO* __restrict__ out, int m, int n) {
  const long long total = (long long)m * n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(i / n);
    float v;
    if (GROUPED) {
      const float* p = reinterpret_cast<const float*>(part);
      v = 0.f;
      for (int z = 0; z < chunks; ++z) v = __fadd_rn(v, p[z * total + i]);
    } else {
      const int* p = reinterpret_cast<const int*>(part);
      int s = 0;
      for (int z = 0; z < chunks; ++z) s += p[z * total + i];
      v = __fmul_rn((float)s, scales[i % n]);
    }
    out[i] = sli::from_f<TO>(__fmul_rn(v, xs[row]));
  }
}

template <int WM, bool GROUPED, bool PART, typename TO>
cudaError_t launch_wq(const int8_t* xi, const float* xs, const int8_t* q,
                      const float* scales, void* out, void* part, int m,
                      int k, int n, int group, int kch, cudaStream_t st) {
  using G = WqGeo<WM>;
  auto kern = qmm_w8a8_wgmma_kernel<WM, GROUPED, PART, TO>;
  cudaError_t e = sli::allow_smem(kern, G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + G::BM - 1) / G::BM, (n + WQ_BN - 1) / WQ_BN,
                  (k + kch - 1) / kch);
  kern<<<grid, G::NT, G::SMEM, st>>>(xi, xs, q, scales, (TO*)out, part, m, k,
                                     n, group, kch);
  return cudaGetLastError();
}

template <int WM, bool GROUPED, typename TO>
int run_wq(const int8_t* xi, const float* xs, const int8_t* q,
           const float* scales, void* out, void* work, int m, int k, int n,
           int group, int kch, cudaStream_t st) {
  const int chunks = (k + kch - 1) / kch;
  if (chunks == 1)
    return (int)launch_wq<WM, GROUPED, false, TO>(xi, xs, q, scales, out,
                                                  nullptr, m, k, n, group,
                                                  kch, st);
  cudaError_t e = launch_wq<WM, GROUPED, true, TO>(xi, xs, q, scales, nullptr,
                                                   work, m, k, n, group, kch,
                                                   st);
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)m * n;
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  w8a8_finish_kernel<GROUPED, TO><<<(int)blocks, 256, 0, st>>>(
      work, chunks, scales, xs, (TO*)out, m, n);
  return (int)cudaGetLastError();
}

template <typename TO>
int run_wq_any(const int8_t* xi, const float* xs, const int8_t* q,
               const float* scales, void* out, void* work, int m, int k,
               int n, int group, int kch, int wm, cudaStream_t st) {
  const bool grouped = group < k;
  if (wm == 4)  // per channel only: an f32 total too would not fit
    return run_wq<4, false, TO>(xi, xs, q, scales, out, work, m, k, n, group,
                                kch, st);
  if (wm == 2)
    return grouped ? run_wq<2, true, TO>(xi, xs, q, scales, out, work, m, k,
                                         n, group, kch, st)
                   : run_wq<2, false, TO>(xi, xs, q, scales, out, work, m, k,
                                          n, group, kch, st);
  return grouped ? run_wq<1, true, TO>(xi, xs, q, scales, out, work, m, k, n,
                                       group, kch, st)
                 : run_wq<1, false, TO>(xi, xs, q, scales, out, work, m, k, n,
                                        group, kch, st);
}

}  // namespace

extern "C" {

// xi: [m, k] int8 codes, contiguous, 16-byte aligned; xs: [m] f32 row
// scales; q: [k, n] int8 of one layer (16-byte aligned); scales: [k /
// group, n] f32 (group == k: per-channel; else a multiple of 128 dividing
// k); out: [m, n] (out_dtype). kch: K rows per block (a multiple of 128,
// and of group when grouped); with ceil(k / kch) > 1, work holds
// ceil(k / kch) * m * n 4-byte partials. wm: warpgroups a block, 4 (256-row
// tiles, per channel only), 2 (128) or 1 (64). k and n multiples of 16.
int sli_quantized_matmul_w8a8_wgmma(const void* xi, const float* xs,
                                    const void* q, const float* scales,
                                    void* out, void* work, int m, int k,
                                    int n, int group, int kch, int wm,
                                    int out_dtype, void* stream) {
  const bool grouped = group < k;
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 || n % 16 || group <= 0 ||
      k % group || (grouped && group % WQ_BK) || kch <= 0 || kch % WQ_BK ||
      (grouped && kch % group) || (wm != 1 && wm != 2 && wm != 4) ||
      (grouped && wm == 4) ||
      ((unsigned long long)xi | (unsigned long long)q) % 16)
    return SLI_ERR_SHAPE;
  if ((k + kch - 1) / kch > 1 && work == nullptr) return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* x8 = (const int8_t*)xi;
  const int8_t* q8 = (const int8_t*)q;
  if (out_dtype == SLI_F32)
    return run_wq_any<float>(x8, xs, q8, scales, out, work, m, k, n, group,
                             kch, wm, st);
  if (out_dtype == SLI_BF16)
    return run_wq_any<__nv_bfloat16>(x8, xs, q8, scales, out, work, m, k, n,
                                     group, kch, wm, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
