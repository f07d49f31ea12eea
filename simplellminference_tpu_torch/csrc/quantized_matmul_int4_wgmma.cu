// Weight-only INT4 product y = x @ dequant(q, scales[, zs]) for many
// activation rows (prefill, M > 8) with bf16 activations, on the bf16
// tensor cores (wgmma, f32 accumulators).
//
// Replaces, with the few-rows kernel of quantized_matmul_int4_mma.cu and
// the FMA kernels of quantized_matmul_int4.cu, the TPU kernel of
// simplellminference_tpu/ops/matmul.py: _quantized_matmul_int4
// (_qmm4_kernel, matmul.py:112-176; wrapper :354). Its math is the TPU
// kernel's own: codes in [-8, 7], exact in bf16, on the matrix unit with
// an f32 accumulator; per-channel scales multiply the f32 sum once at
// write-out; grouped scales multiply each group's partial sum before it
// joins the total, and zero points subtract rowsum_g(x) * zs per group.
//
// Bound on the H100: operations (M = 1024 rows of the 7B wqkv: 103 GFLOP,
// 0.104 ms at the bf16 tensor-core peak, against 25 MB of packed weights).
// The FMA kernel it replaces ran on the f32 pipes (~30 TFLOP/s).
//
// Design: the operands are swapped (int4_tiles.cuh): A is the weight,
// converted in registers from the packed bytes (the same fragment mapping
// and conversion as the few-rows kernel) and fed to register-sourced
// wgmma.m64nNk16; B is x^T, K-major in 128-byte-swizzled shared memory as
// x's rows already are, N = the block's activation rows. The conversion
// is off the products' path: the A registers are buffered, and a k-step's
// weights are converted while the tensor cores run the ones before (one
// wgmma group left in flight per channel, two with groups, whose k-steps
// are a quarter of the work). One 16-byte-copy cp.async ring
// stage holds 64 packed rows x the block's 256 columns (rows padded by 16
// bytes so the fragment reads hit distinct banks) and both halves' x
// tiles: one copy of the packed bytes feeds two 64-row k-blocks, the low
// nibbles against x[:, p0 .. p0 + 64] and the high nibbles against
// x[:, K/2 + p0 ..]. Two warpgroups a block split its 256 columns, each
// four warps of two m64 tiles (tile j's row r of warp w at column 32w +
// 4(r % 8) + 2j + r / 8, so a thread's 32-bit word holds both tiles' two
// rows):
// * per-channel scales: each k-step runs both k-blocks into one
//   accumulator set (m64n128, 128 activation rows a block, or m64n64 when
//   M <= 64), scaled once at write-out; copies run two stages ahead (the
//   group in flight across a barrier reads the stage before the one
//   refilled);
// * grouped scales or zero points: each k-block lies in one group
//   (groups are a multiple of 64 rows), and the two halves' groups differ,
//   so a warpgroup runs the low k-block, waits for its products and folds
//   its accumulator times the group's scale (fetched at the stage's start;
//   minus the k-block's x row sums, summed from the staged tiles, times
//   the zero points) into an f32 total, then the high k-block likewise
//   (m64n64: an accumulator and a total fill the registers, 64 rows a
//   block; each k-block converts only its half's nibbles); every stage
//   ends drained, so copies run all the ring's other stages ahead.
// Wider tiles than the INT8 kernel's 128 columns fetch the activations
// fewer times from L2. When the tiles alone leave SMs idle, K is split
// across blocks on 64-row boundaries (ops/matmul.py int4_wgmma_split, from
// shapes alone): each block writes f32 partial sums and qmm_finish_kernel
// (int8_rows.cuh) adds them, applies a per-channel scale once and rounds
// once. The wrapper sends f32 activations, N off a multiple of 16, K/2 off
// a multiple of 64 and groups off a multiple of 64 rows to the FMA kernel.
#include "int4_tiles.cuh"
#include "int8_rows.cuh"

namespace {

template <int BM, bool GROUPED>  // BM: activation rows a block (64, 128)
struct W4Geo {
  static constexpr int BNC = 256;                  // output columns a block
  static constexpr int NT = 256;                   // two warpgroups
  static constexpr int WROW = BNC + 16;            // staged weight row, bytes
  static constexpr int XT = BM * 128;              // x tile: bf16 [BM][64]
  static constexpr int W = 64 * WROW;
  static constexpr int STAGE = (2 * XT + W + 1023) / 1024 * 1024;
  static constexpr int FIT = 200 * 1024 / STAGE;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  // copies in flight: per channel, a stage's last wgmma group is still in
  // flight across the next barrier (it reads the stage before the one
  // refilled); grouped, every stage ends drained
  static constexpr int AHEAD = GROUPED ? STAGES - 1 : STAGES - 2;
  static constexpr int RS = GROUPED ? 2 * BM * 4 : 0;  // a stage's row sums
  // + 1024: the base is rounded up to the 1024-byte swizzle atom
  static constexpr int SMEM = STAGES * STAGE + RS + 1024;
  static constexpr int NACC = BM / 2;  // f32 accumulators a tile
};

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ unsigned long long w4_desc(const void* p) {
  const unsigned long long a = (unsigned)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A from registers (the m64k16
// fragment), B K-major in shared memory (not transposed); scale_d 0
// ignores D's old values.
__device__ __forceinline__ void wgmma_rs_k_n64(float (&d)[32],
                                               const unsigned (&a)[4],
                                               unsigned long long db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], as wgmma_rs_k_n64.
__device__ __forceinline__ void wgmma_rs_k_n128(float (&d)[64],
                                                const unsigned (&a)[4],
                                                unsigned long long db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2],
                                           const unsigned (&a)[4],
                                           unsigned long long db,
                                           int scale_d) {
  if constexpr (N == 64) wgmma_rs_k_n64(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_rs_k_n128(d, a, db, scale_d);
}


// x: [m, 2 * kp] bf16 rows at stride ldx; q: [kp, n] split-half packed;
// scales [2 kp / group, n] f32; zs null or the same shape. Block (x, y,
// z): activation rows x * BM .. + BM, columns y * 256 .. + 256, packed
// rows [z * kch, min(kp, (z + 1) * kch)). Writes out (TO), or with PART
// f32 partial sums part[z][m][n] (per-channel scales then left to
// qmm_finish).
template <int BM, bool GROUPED, bool ZEROS, bool PART, typename TO>
__global__ void __launch_bounds__(256, 1)
    qmm4_wgmma_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ scales,
                      const float* __restrict__ zs, TO* __restrict__ out,
                      float* __restrict__ part, int m, int kp, int n,
                      int group, int kch) {
  using G = W4Geo<BM, GROUPED>;
  constexpr int NA = G::NACC;
  constexpr int NH = GROUPED ? 1 : 2;    // halves a k-step's A holds
  constexpr int LAG = 2;                 // wgmma groups left in flight
  constexpr int NBUF = 2 * LAG;          // A buffers (4 % NBUF == 0)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(
                                                 smem_raw) & 1023)) & 1023);
  float* rs = reinterpret_cast<float*>(smem + G::STAGES * G::STAGE);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;        // warpgroup: columns wg * 128 .. + 128
  const int w = (tid >> 5) & 3;   // warp in it: A rows 16w .. + 16
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * G::BNC;
  const int kb = blockIdx.z * kch;
  const int ke = min(kp, kb + kch);
  const int nst = (ke - kb) / 64;
  // this thread's word: block columns cw .. cw + 3 = tile 0 rows g, g + 8,
  // tile 1 rows g, g + 8
  const int cw = wg * 128 + 32 * w + 4 * g;

  auto load = [&](int s, int st) {
    unsigned char* xs = smem + st * G::STAGE;
    unsigned char* ws = xs + 2 * G::XT;
    const int p0 = kb + s * 64;
    for (int i = tid; i < 2 * BM * 8; i += G::NT) {  // 8 bf16 a copy
      const int h = i / (BM * 8);
      const int r = (i >> 3) % BM;
      const int c = i & 7;
      const bool ok = m0 + r < m;
      const __nv_bfloat16* src =
          ok ? x + (long long)(m0 + r) * ldx + h * kp + p0 + c * 8 : x;
      q4::cp16(xs + h * G::XT + r * 128 + ((c ^ (r & 7)) << 4), src, ok);
    }
    constexpr int CH = G::BNC / 16;  // 16 packed bytes a copy
    for (int i = tid; i < 64 * CH; i += G::NT) {
      const int r = i / CH;
      const int c = i % CH;
      const bool ok = n0 + c * 16 < n;
      const int8_t* src = ok ? q + (long long)(p0 + r) * n + n0 + c * 16 : q;
      q4::cp16(ws + r * G::WROW + c * 16, src, ok);
    }
  };

  // A registers of one k-step (k-block rows 16 ks .. + 16): [half][tile]
  // [a0..a3]; GROUPED converts only half h's nibbles, into [0]
  auto convert = [&](const unsigned char* ws, int ks, int h,
                     unsigned (&a)[NH][2][4]) {
    const unsigned char* wp = ws + (16 * ks + 2 * t) * G::WROW + cw;
    unsigned r[4];  // rows p, p + 1, p + 8, p + 9
#pragma unroll
    for (int u = 0; u < 4; ++u)
      r[u] = q4::ld_u32(wp + ((u >> 1) * 8 + (u & 1)) * G::WROW) ^ q4::FLIP;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {    // rows p (a0, a1) / p + 8 (a2, a3)
#pragma unroll
      for (int tj = 0; tj < 2; ++tj) {  // bytes 0-1: tile 0, 2-3: tile 1
        const unsigned pr =
            tj ? q4::pair_rows<true>(r[2 * kk], r[2 * kk + 1])
               : q4::pair_rows<false>(r[2 * kk], r[2 * kk + 1]);
#pragma unroll
        for (int c = 0; c < 2; ++c)    // tile rows g (c 0) / g + 8 (c 1)
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            a[hh][tj][2 * kk + c] =
                q4::to_bf16x2(pr, 2 * c + (GROUPED ? h : hh));
      }
    }
  };
  // keeps an A buffer's registers intact until the wait that frees it
  auto fence_a = [&](unsigned (&a)[NH][2][4]) {
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int tj = 0; tj < 2; ++tj)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          asm volatile("" : "+r"(a[hh][tj][u])::"memory");
  };
  // the products of k-step ks of half h (GROUPED) or both halves; LAG
  // groups stay in flight, the one before them is done and its buffer
  // takes k-step ks + LAG
  auto products = [&](const unsigned char* xs, const unsigned char* ws,
                      int ks, int h, float (&acc)[2][NA],
                      unsigned (&a)[NBUF][NH][2][4]) {
    const int b = ks % NBUF;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const unsigned char* xh = xs + (GROUPED ? h : hh) * G::XT + 32 * ks;
      // grouped, a k-block's first products start its accumulator over
      const int sd = GROUPED && ks == 0 ? 0 : 1;
      wgmma_rs_k<BM>(acc[0], a[b][hh][0], w4_desc(xh), sd);
      wgmma_rs_k<BM>(acc[1], a[b][hh][1], w4_desc(xh), sd);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(LAG)
                 : "memory");
    fence_a(a[(ks + LAG) % NBUF]);
    if (ks + LAG < 4) convert(ws, ks + LAG, h, a[(ks + LAG) % NBUF]);
  };

  float acc[2][NA];  // per tile: wgmma's D fragment (per channel: the sum)
  float tot[2][GROUPED ? NA : 1];  // GROUPED: the folded k-blocks
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < (GROUPED ? NA : 1); ++i) tot[j][i] = 0.f;
  }
  // A buffers: wgmma reads them after its issue, so they live across
  // stages
  unsigned a[NBUF][NH][2][4];

#pragma unroll
  for (int s = 0; s < G::AHEAD; ++s) {
    if (s < nst) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = 0; i < nst; ++i) {
    // stage i landed, and every stage the groups in flight read stays
    // clear of the refill below
    asm volatile("cp.async.wait_group %0;\n" ::"n"(G::AHEAD - 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    {
      const int nx = i + G::AHEAD;
      if (nx < nst) load(nx, nx % G::STAGES);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const unsigned char* xs = smem + (i % G::STAGES) * G::STAGE;
    const unsigned char* ws = xs + 2 * G::XT;
    if (!GROUPED) {
#pragma unroll
      for (int ks = 0; ks < LAG; ++ks) convert(ws, ks, 0, a[ks]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) products(xs, ws, ks, 0, acc, a);
      continue;
    }
    // GROUPED: each k-block lies in one group; its scales (and zero
    // points) for this thread's 4 columns, fetched before the products
    const int pst = kb + i * 64;
    float sc[2][4], zc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long grow = (long long)((h * kp + pst) / group) * n;
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[h][c] = zc[h][c] = 0.f;
      if (n0 + cw < n) {
        q4::load4(scales + grow + n0 + cw, true, sc[h]);
        if (ZEROS) q4::load4(zs + grow + n0 + cw, true, zc[h]);
      }
    }
    if (ZEROS) {
      // both k-blocks' x row sums: two threads a (half, row)
      const int h = tid >> 7;
      const int r = (tid & 127) >> 1;
      const int hh = tid & 1;
      const unsigned char* xr = xs + h * G::XT + r * 128;
      float v = 0.f;
#pragma unroll
      for (int c = 4 * hh; c < 4 * hh + 4; ++c) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(xr + ((c ^ (r & 7)) << 4));
        v += q4::bf16x2_sum(u.x) + q4::bf16x2_sum(u.y) +
             q4::bf16x2_sum(u.z) + q4::bf16x2_sum(u.w);
      }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (hh == 0) rs[h * BM + r] = v;
      __syncthreads();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int ks = 0; ks < LAG; ++ks) convert(ws, ks, h, a[ks]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) products(xs, ws, ks, h, acc, a);
      // the k-block's partial times its group's scale (minus its x row
      // sums times the zero points) joins the total
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc[0]);
      fence_acc(acc[1]);
#pragma unroll
      for (int b = 0; b < NBUF; ++b) fence_a(a[b]);
#pragma unroll
      for (int jj = 0; jj < BM / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float rsum = ZEROS ? rs[h * BM + 8 * jj + 2 * t + (e & 1)]
                                   : 0.f;
#pragma unroll
          for (int tj = 0; tj < 2; ++tj) {
            const int ci = 2 * tj + (e >> 1);  // tile tj's row g / g + 8
            float v = fmaf(acc[tj][4 * jj + e], sc[h][ci],
                           tot[tj][4 * jj + e]);
            if (ZEROS) v = fmaf(-rsum, zc[h][ci], v);
            tot[tj][4 * jj + e] = v;
          }
        }
      fence_acc(acc[0]);
      fence_acc(acc[1]);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc[0]);
  fence_acc(acc[1]);
#pragma unroll
  for (int b = 0; b < NBUF; ++b) fence_a(a[b]);
  asm volatile("cp.async.wait_group 0;\n" ::);

  // write-out: activation row m0 + 8 jj + 2t + e2, columns col .. col + 3
  // = tile 0 rows g, g + 8, tile 1 rows g, g + 8
  const int col = n0 + cw;
  if (col >= n) return;  // n % 16 == 0: col + 3 < n too
  float so[4] = {1.f, 1.f, 1.f, 1.f};
  if (!GROUPED && !PART) q4::load4(scales + col, true, so);
#pragma unroll
  for (int jj = 0; jj < BM / 8; ++jj)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = m0 + 8 * jj + 2 * t + e2;
      if (row >= m) continue;
      float o[4];
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) {
        const int i2 = 4 * jj + 2 * (ci & 1) + e2;
        const float v = GROUPED ? tot[ci >> 1][i2] : acc[ci >> 1][i2];
        o[ci] = v * so[ci];
      }
      if (PART)
        q4::store4<float>(part + ((long long)blockIdx.z * m + row) * n + col,
                          o);
      else
        q4::store4<TO>(out + (long long)row * n + col, o);
    }
}

template <int BM, bool GROUPED, bool ZEROS, bool PART, typename TO>
cudaError_t launch_w4(const void* x, long long ldx, const int8_t* q,
                      const float* scales, const float* zs, void* out,
                      float* part, int m, int kp, int n, int group, int kch,
                      cudaStream_t st) {
  using G = W4Geo<BM, GROUPED>;
  auto kern = qmm4_wgmma_kernel<BM, GROUPED, ZEROS, PART, TO>;
  cudaError_t e = sli::allow_smem(kern, G::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + BM - 1) / BM, (n + G::BNC - 1) / G::BNC,
                  (kp + kch - 1) / kch);
  kern<<<grid, G::NT, G::SMEM, st>>>((const __nv_bfloat16*)x, ldx, q, scales,
                                     zs, (TO*)out, part, m, kp, n, group,
                                     kch);
  return cudaGetLastError();
}

template <int BM, bool GROUPED, bool ZEROS, typename TO>
int run_w4(const void* x, long long ldx, const int8_t* q, const float* scales,
           const float* zs, void* out, float* work, int m, int kp, int n,
           int group, int kch, cudaStream_t st) {
  const int chunks = (kp + kch - 1) / kch;
  if (chunks == 1)
    return (int)launch_w4<BM, GROUPED, ZEROS, false, TO>(
        x, ldx, q, scales, zs, out, nullptr, m, kp, n, group, kch, st);
  cudaError_t e = launch_w4<BM, GROUPED, ZEROS, true, float>(
      x, ldx, q, scales, zs, nullptr, work, m, kp, n, group, kch, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_qmm_finish<TO>(work, chunks, GROUPED ? nullptr : scales,
                                    nullptr, out, m, n, st);
}

template <typename TO>
int run_w4_scales(const void* x, long long ldx, const int8_t* q,
                  const float* scales, const float* zs, void* out,
                  float* work, int m, int kp, int n, int group, int kch,
                  int bm, cudaStream_t st) {
  if (zs != nullptr)
    return run_w4<64, true, true, TO>(x, ldx, q, scales, zs, out, work, m,
                                      kp, n, group, kch, st);
  if (group < 2 * kp)
    return run_w4<64, true, false, TO>(x, ldx, q, scales, zs, out, work, m,
                                       kp, n, group, kch, st);
  if (bm == 128)
    return run_w4<128, false, false, TO>(x, ldx, q, scales, zs, out, work, m,
                                         kp, n, group, kch, st);
  return run_w4<64, false, false, TO>(x, ldx, q, scales, zs, out, work, m,
                                      kp, n, group, kch, st);
}

}  // namespace

extern "C" {

// x: [m, 2 * kp] bf16 rows at element stride ldx (16-byte aligned rows);
// q: [kp, n] int8 split-half packed, of one layer (16-byte aligned);
// scales: [2 * kp / group, n] f32 (group == 2 * kp: per channel;
// otherwise a multiple of 64 dividing kp); zs: null or the same shape as
// scales; out: [m, n] (out_dtype). bm: activation rows a block (128 or
// 64; 64 with grouped scales or zero points). kch: packed rows a block (a
// multiple of 64); with ceil(kp / kch) > 1, work holds ceil(kp / kch) * m
// * n floats.
int sli_quantized_matmul_int4_wgmma(const void* x, long long ldx,
                                    const void* q, const float* scales,
                                    const float* zs, void* out, float* work,
                                    int m, int kp, int n, int group, int kch,
                                    int bm, int out_dtype, void* stream) {
  const bool grouped = zs != nullptr || group < 2 * kp;
  if (m <= 0 || kp <= 0 || kp % 64 || n <= 0 || n % 16 || ldx % 8 ||
      group <= 0 || (group < 2 * kp && (group % 64 || kp % group)) ||
      group > 2 * kp || kch <= 0 || kch % 64 || (bm != 64 && bm != 128) ||
      (grouped && bm != 64) ||
      ((unsigned long long)x | (unsigned long long)q |
       (unsigned long long)scales | (unsigned long long)zs) % 16)
    return SLI_ERR_SHAPE;
  if ((kp + kch - 1) / kch > 1 && work == nullptr) return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* qq = (const int8_t*)q;
  if (out_dtype == SLI_F32)
    return run_w4_scales<float>(x, ldx, qq, scales, zs, out, work, m, kp, n,
                                group, kch, bm, st);
  if (out_dtype == SLI_BF16)
    return run_w4_scales<__nv_bfloat16>(x, ldx, qq, scales, zs, out, work, m,
                                        kp, n, group, kch, bm, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
