// Weight-only INT4 product y = x @ dequant(q, scales[, zs]) for a few
// activation rows (decode, M <= 8) with bf16 activations, on the bf16
// tensor cores (mma.sync.m16n8k16, f32 accumulators).
//
// Replaces, with the FMA kernels of quantized_matmul_int4.cu and the
// many-row kernel of quantized_matmul_int4_wgmma.cu, the TPU kernel of
// simplellminference_tpu/ops/matmul.py: _quantized_matmul_int4
// (_qmm4_kernel, matmul.py:112-176; wrapper :354, reached through
// quantized_matmul(bits=4) :522). Its math is the TPU kernel's own: the
// nibbles are sign-extended codes in [-8, 7], exact in bf16, multiplied
// on the matrix unit with an f32 accumulator; per-channel scales multiply
// the f32 sum once at write-out; grouped scales multiply each group's
// partial sum before it is added, and zero points subtract rowsum_g(x) *
// zs per group (a rank-1 correction).
//
// Bound on the H100: bytes. At M <= 8 each packed byte (two weights)
// feeds at most 16 multiply-adds, so the least time is the K/2 * N weight
// bytes at 3.35 TB/s (the 7B wqkv, 25.2 MB, 7.5 us). The FMA kernel it
// replaces spent that time on the f32 pipes (two conversions and 16 FMAs
// a byte against activations in shared memory).
//
// Design: the operands are swapped (int4_tiles.cuh): A is the weight, 16
// output columns x 16 k a tile, converted in registers, two values a
// 32-bit operation and no I2F; B is x^T, 16 k x 8 activation rows (rows
// past M zero). A block of 4 warps owns 128 output columns and a range of
// packed rows; the packed bytes and both halves' x slabs stream through a
// 4-stage cp.async ring of 16-byte copies (64 packed rows x 128 columns a
// stage; rows padded by 16 bytes so the fragment reads hit distinct
// banks), three stages in flight. Warp (cn, kw) takes columns cn * 64 ..
// + 64 as four tiles (tile j's row r at column 4r + j, r < 8, and 32 +
// 4(r - 8) + j) and packed rows kw * 32 .. + 32 of each stage: two
// k-step pairs of 16 packed rows, each a low-half and a high-half k-step
// (the byte's two nibbles). Per-channel scales: one accumulator; grouped
// scales or zero points: one a half, folded times their groups' scales
// (minus the x row sums, taken from the B fragments, times the zero
// points) into an f32 total at each group's end (groups are a multiple of
// 64 rows, so a stage lies in one). The two K warps' sums meet in shared
// memory. K is split across blocks (ops/matmul.py int4_mma_split, from
// shapes alone) until the grid holds about three blocks per SM; then each
// block writes f32 partial sums and qmm_finish_kernel (int8_rows.cuh)
// adds them, applies a per-channel scale once and rounds once. The
// wrapper sends f32 activations, N off a multiple of 16, K/2 off a
// multiple of 64 and groups off a multiple of 64 rows to the FMA kernel.
#include "int4_tiles.cuh"
#include "int8_rows.cuh"

namespace {

constexpr int D4_KT = 64;                         // packed rows a stage
constexpr int D4_BN = 128;                        // output columns a block
constexpr int D4_WROW = D4_BN + 16;               // staged weight row, bytes
constexpr int D4_XROW = 2 * D4_KT + 16;           // staged x row, bytes
constexpr int D4_STAGES = 4;
constexpr int D4_AHEAD = D4_STAGES - 1;           // stages in flight
constexpr int D4_W = D4_KT * D4_WROW;
constexpr int D4_STAGE = D4_W + 2 * 8 * D4_XROW;  // + the lo and hi x slabs
constexpr int D4_THREADS = 128;
constexpr int D4_SMEM = D4_STAGES * D4_STAGE;

// d[4] += A[16 x 16] B[16 x 8]: bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x: [m <= 8, 2 * kp] bf16 rows at stride ldx; q: [kp, n] split-half
// packed; scales [2 kp / group, n] f32; zs null or the same shape. Block
// (x, y) covers columns x * 128 .. + 128 and packed rows [y * kch, min(kp,
// (y + 1) * kch)). SCALED: grouped scales or zero points, folded at group
// ends; else the raw sum, scaled at write-out (or by qmm_finish when
// PART: f32 partial sums part[y][m][n]).
template <bool SCALED, bool ZEROS, bool PART, typename TO>
__global__ void __launch_bounds__(D4_THREADS)
    qmm4_mma_rows_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                         const int8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         const float* __restrict__ zs, TO* __restrict__ out,
                         float* __restrict__ part, int m, int kp, int n,
                         int group, int kch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cn = warp & 1;   // columns cn * 64 .. + 64 of the block
  const int kw = warp >> 1;  // packed rows kw * 32 .. + 32 of each stage
  const int n0 = blockIdx.x * D4_BN;
  const int kb = blockIdx.y * kch;
  const int ke = min(kp, kb + kch);
  const int nst = (ke - kb) / D4_KT;

  auto load = [&](int s, int st) {
    unsigned char* ws = smem + st * D4_STAGE;
    unsigned char* xs = ws + D4_W;
    const int p0 = kb + s * D4_KT;
#pragma unroll
    for (int i = tid; i < D4_KT * 8; i += D4_THREADS) {  // 16 bytes a copy
      const int r = i >> 3;
      const int c = i & 7;
      const bool ok = n0 + c * 16 < n;
      const int8_t* src = ok ? q + (long long)(p0 + r) * n + n0 + c * 16 : q;
      q4::cp16(ws + r * D4_WROW + c * 16, src, ok);
    }
    {  // x: half h, row r, 8 bf16 at chunk c; rows past m zero
      const int h = tid >> 6;
      const int r = (tid >> 3) & 7;
      const int c = tid & 7;
      const bool ok = r < m;
      const __nv_bfloat16* src =
          ok ? x + (long long)r * ldx + h * kp + p0 + c * 8 : x;
      q4::cp16(xs + (h * 8 + r) * D4_XROW + c * 16, src, ok);
    }
  };

  float acc[4][4];  // per tile: (row g, act 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
  float ach[4][4];  // SCALED: the high half's group
  float tot[4][4];  // SCALED: the folded groups
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = ach[j][e] = tot[j][e] = 0.f;
  float rs_lo = 0.f, rs_hi = 0.f;  // ZEROS: x row g over this thread's k

  const int ca = n0 + cn * 64 + 4 * g;  // tile rows g: columns ca + j
  const int cb = ca + 32;               // tile rows g + 8: cb + j

#pragma unroll
  for (int s = 0; s < D4_AHEAD; ++s) {
    if (s < nst) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = 0; i < nst; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(D4_AHEAD - 1));
    __syncthreads();  // stage i landed; stage i - 1 is no longer read
    {
      const int nx = i + D4_AHEAD;
      if (nx < nst) load(nx, nx % D4_STAGES);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const unsigned char* ws = smem + (i % D4_STAGES) * D4_STAGE;
    const unsigned char* xs = ws + D4_W;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = kw * 32 + j * 16 + 2 * t;  // rows p, p + 1, p + 8, p + 9
      const unsigned char* wa = ws + p * D4_WROW + cn * 64 + 4 * g;
      const unsigned char* wb = wa + 32;
      unsigned r[2][4];  // [tile rows g / g + 8][rows p, p+1, p+8, p+9]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int off = ((u >> 1) * 8 + (u & 1)) * D4_WROW;
        r[0][u] = q4::ld_u32(wa + off) ^ q4::FLIP;
        r[1][u] = q4::ld_u32(wb + off) ^ q4::FLIP;
      }
      const unsigned char* xr = xs + g * D4_XROW + p * 2;
      const unsigned bl0 = q4::ld_u32(xr);
      const unsigned bl1 = q4::ld_u32(xr + 16);
      const unsigned bh0 = q4::ld_u32(xr + 8 * D4_XROW);
      const unsigned bh1 = q4::ld_u32(xr + 8 * D4_XROW + 16);
      unsigned alo[4][4], ahi[4][4];  // [tile][a0..a3]
#pragma unroll
      for (int ab = 0; ab < 2; ++ab) {    // tile rows g (a0, a2) / g + 8
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // rows p, p+1 (a0, a1) / p+8, p+9
#pragma unroll
          for (int hb = 0; hb < 2; ++hb) {  // bytes 0-1: tiles 0, 1; 2-3: 2, 3
            unsigned lo[2], hi[2];
            q4::convert2(hb ? q4::pair_rows<true>(r[ab][2 * kk], r[ab][2 * kk + 1])
                            : q4::pair_rows<false>(r[ab][2 * kk], r[ab][2 * kk + 1]),
                         lo, hi);
            const int reg = 2 * kk + ab;  // a0: (g, p), a1: (g+8, p), a2, a3
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              alo[2 * hb + c][reg] = lo[c];
              ahi[2 * hb + c][reg] = hi[c];
            }
          }
        }
      }
#pragma unroll
      for (int tj = 0; tj < 4; ++tj) {
        mma16816(acc[tj], alo[tj], bl0, bl1);
        mma16816(SCALED ? ach[tj] : acc[tj], ahi[tj], bh0, bh1);
      }
      if (ZEROS) {
        rs_lo += q4::bf16x2_sum(bl0) + q4::bf16x2_sum(bl1);
        rs_hi += q4::bf16x2_sum(bh0) + q4::bf16x2_sum(bh1);
      }
    }
    if (SCALED) {
      const int pst = kb + i * D4_KT;
      if ((pst + D4_KT) % group == 0 || i + 1 == nst) {
        // the stage's groups end: each half's partial times its scale
        // (minus its x row sums times its zero points) joins the total
        const long long glo = (long long)(pst / group) * n;
        const long long ghi = (long long)((kp + pst) / group) * n;
        float sla[4], slb[4], sha[4], shb[4];
        q4::load4(scales + glo + ca, ca < n, sla);
        q4::load4(scales + glo + cb, cb < n, slb);
        q4::load4(scales + ghi + ca, ca < n, sha);
        q4::load4(scales + ghi + cb, cb < n, shb);
        float zla[4] = {0.f, 0.f, 0.f, 0.f}, zlb[4] = {0.f, 0.f, 0.f, 0.f};
        float zha[4] = {0.f, 0.f, 0.f, 0.f}, zhb[4] = {0.f, 0.f, 0.f, 0.f};
        float rl[2] = {0.f, 0.f}, rh[2] = {0.f, 0.f};
        if (ZEROS) {
          q4::load4(zs + glo + ca, ca < n, zla);
          q4::load4(zs + glo + cb, cb < n, zlb);
          q4::load4(zs + ghi + ca, ca < n, zha);
          q4::load4(zs + ghi + cb, cb < n, zhb);
          // x row g's sums over the warp's rows (lanes 4g .. 4g + 3), then
          // this lane's activation rows 2t and 2t + 1 (held by lanes 8t, 8t + 4)
          float fl = rs_lo + __shfl_xor_sync(0xffffffffu, rs_lo, 1);
          fl += __shfl_xor_sync(0xffffffffu, fl, 2);
          float fh = rs_hi + __shfl_xor_sync(0xffffffffu, rs_hi, 1);
          fh += __shfl_xor_sync(0xffffffffu, fh, 2);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            rl[e] = __shfl_sync(0xffffffffu, fl, 4 * (2 * t + e));
            rh[e] = __shfl_sync(0xffffffffu, fh, 4 * (2 * t + e));
          }
          rs_lo = rs_hi = 0.f;
        }
#pragma unroll
        for (int tj = 0; tj < 4; ++tj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool rb = e >= 2;  // tile row g + 8
            float v = fmaf(acc[tj][e], rb ? slb[tj] : sla[tj], tot[tj][e]);
            v = fmaf(ach[tj][e], rb ? shb[tj] : sha[tj], v);
            if (ZEROS) {
              v = fmaf(-rl[e & 1], rb ? zlb[tj] : zla[tj], v);
              v = fmaf(-rh[e & 1], rb ? zhb[tj] : zha[tj], v);
            }
            tot[tj][e] = v;
            acc[tj][e] = ach[tj][e] = 0.f;
          }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // the ring is free: the K warps' sums meet there

  float* red = reinterpret_cast<float*>(smem);  // [cn][16][32]
  if (kw == 1) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
      red[(cn * 16 + u) * 32 + lane] = SCALED ? tot[u >> 2][u & 3]
                                              : acc[u >> 2][u & 3];
  }
  __syncthreads();
  if (kw == 1) return;
  float v[4][4];
#pragma unroll
  for (int u = 0; u < 16; ++u)
    v[u >> 2][u & 3] = (SCALED ? tot[u >> 2][u & 3] : acc[u >> 2][u & 3]) +
                       red[(cn * 16 + u) * 32 + lane];
  // outputs: activation row 2t + (e & 1), columns (e < 2 ? ca : cb) + tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = half ? cb : ca;
    if (col >= n) continue;  // n % 16 == 0: col + 3 < n too
    float sc[4] = {1.f, 1.f, 1.f, 1.f};
    if (!SCALED && !PART) q4::load4(scales + col, true, sc);
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int row = 2 * t + e2;
      if (row >= m) continue;
      float o[4];
#pragma unroll
      for (int tj = 0; tj < 4; ++tj) o[tj] = v[tj][2 * half + e2] * sc[tj];
      if (PART)
        q4::store4<float>(part + ((long long)blockIdx.y * m + row) * n + col,
                          o);
      else
        q4::store4<TO>(out + (long long)row * n + col, o);
    }
  }
}

template <bool SCALED, bool ZEROS, bool PART, typename TO>
cudaError_t launch_d4(const void* x, long long ldx, const int8_t* q,
                      const float* scales, const float* zs, void* out,
                      float* part, int m, int kp, int n, int group, int kch,
                      cudaStream_t st) {
  auto kern = qmm4_mma_rows_kernel<SCALED, ZEROS, PART, TO>;
  cudaError_t e = sli::allow_smem(kern, D4_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + D4_BN - 1) / D4_BN, (kp + kch - 1) / kch);
  kern<<<grid, D4_THREADS, D4_SMEM, st>>>((const __nv_bfloat16*)x, ldx, q,
                                          scales, zs, (TO*)out, part, m, kp,
                                          n, group, kch);
  return cudaGetLastError();
}

template <bool SCALED, bool ZEROS, typename TO>
int run_d4(const void* x, long long ldx, const int8_t* q, const float* scales,
           const float* zs, void* out, float* work, int m, int kp, int n,
           int group, int kch, cudaStream_t st) {
  const int chunks = (kp + kch - 1) / kch;
  if (chunks == 1)
    return (int)launch_d4<SCALED, ZEROS, false, TO>(
        x, ldx, q, scales, zs, out, nullptr, m, kp, n, group, kch, st);
  cudaError_t e = launch_d4<SCALED, ZEROS, true, float>(
      x, ldx, q, scales, zs, nullptr, work, m, kp, n, group, kch, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_qmm_finish<TO>(work, chunks, SCALED ? nullptr : scales,
                                    nullptr, out, m, n, st);
}

template <typename TO>
int run_d4_scales(const void* x, long long ldx, const int8_t* q,
                  const float* scales, const float* zs, void* out,
                  float* work, int m, int kp, int n, int group, int kch,
                  cudaStream_t st) {
  if (zs != nullptr)
    return run_d4<true, true, TO>(x, ldx, q, scales, zs, out, work, m, kp, n,
                                  group, kch, st);
  if (group < 2 * kp)
    return run_d4<true, false, TO>(x, ldx, q, scales, zs, out, work, m, kp,
                                   n, group, kch, st);
  return run_d4<false, false, TO>(x, ldx, q, scales, zs, out, work, m, kp, n,
                                  group, kch, st);
}

}  // namespace

extern "C" {

// x: [m, 2 * kp] bf16 rows at element stride ldx (16-byte aligned rows,
// m <= 8); q: [kp, n] int8 split-half packed, of one layer (16-byte
// aligned); scales: [2 * kp / group, n] f32 (group == 2 * kp: per
// channel; otherwise a multiple of 64 dividing kp); zs: null or the same
// shape as scales; out: [m, n] (out_dtype). kch: packed rows a block (a
// multiple of 64); with ceil(kp / kch) > 1, work holds ceil(kp / kch) * m
// * n floats.
int sli_quantized_matmul_int4_mma(const void* x, long long ldx, const void* q,
                                  const float* scales, const float* zs,
                                  void* out, float* work, int m, int kp,
                                  int n, int group, int kch, int out_dtype,
                                  void* stream) {
  if (m <= 0 || m > 8 || kp <= 0 || kp % D4_KT || n <= 0 || n % 16 ||
      ldx % 8 || group <= 0 ||
      (group < 2 * kp && (group % D4_KT || kp % group)) ||
      (group > 2 * kp) || kch <= 0 || kch % D4_KT ||
      ((unsigned long long)x | (unsigned long long)q |
       (unsigned long long)scales | (unsigned long long)zs) % 16)
    return SLI_ERR_SHAPE;
  if ((kp + kch - 1) / kch > 1 && work == nullptr) return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* qq = (const int8_t*)q;
  if (out_dtype == SLI_F32)
    return run_d4_scales<float>(x, ldx, qq, scales, zs, out, work, m, kp, n,
                                group, kch, st);
  if (out_dtype == SLI_BF16)
    return run_d4_scales<__nv_bfloat16>(x, ldx, qq, scales, zs, out, work, m,
                                        kp, n, group, kch, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
