// Building blocks of an int8-weight product for a few activation rows
// (m <= 64, bf16) on the bf16 tensor cores (mma.sync.m16n8k16, f32
// accumulators): y[m, n] = sum_k x[m, k] * q[k, n], q int8 [K, N]
// row-major. Used by ffn_fused_mma.cu (kernel 7m), qkv_fused_mma.cu
// (kernel 6m) and quantized_matmul_rows_mma.cu (kernel 5r); 7m and 6m
// also share its rmsnorm pass (norm_rows_kernel).
//
// Bound: bytes. Each weight byte feeds m multiply-adds, so the least time
// is the K x N weight bytes at the card's memory rate. The f32 FMA loop
// of int8_rows.cuh pays 8 FMAs and a conversion a byte for 8 rows, about
// the whole bytes bound at the f32 peak, and streams the weight again for
// every 8 rows; here all m <= 64 rows come in one pass over the weight.
//
// Operands swapped, as 14m (quantized_matmul_int4_mma.cu): A is the
// weight, 16 weight columns x 16 k, converted in registers; B is x^T, 16
// k x 8 activation rows (NT n8 tiles cover the rows, those past m zero);
// D is y^T. A block of 4 warps owns two groups of 64 weight columns (for
// the FFN's gate_up: 64 gate columns and the matching 64 up columns) and
// a K range, streamed through a 4-stage cp.async ring of 16-byte copies
// (64 K rows a stage: the two groups' 128 bytes a row, and the x slab;
// rows padded by 16 bytes so the fragment reads hit distinct banks),
// three stages in flight. Warp (cg, kw) = (warp % 2, warp / 2) takes
// column group cg as four 16-column tiles (tile j's row r at column 4r +
// j for r < 8, 32 + 4(r - 8) + j above: one 32-bit word of 4 neighbouring
// columns feeds all four tiles) and K rows kw * 32 .. + 32 of each stage:
// two k-steps. A thread reads the words of its 4 columns at rows p = P +
// 2t, p + 1, p + 8, p + 9 (t = lane % 4), turns each byte into an exact
// f32 (i8x4_to_f32: a byte permute into the mantissa of 2^23 and one
// subtract) and packs rows p, p + 1 of one column into a bf16x2 (exact:
// every int8 code fits bf16's 8 significant bits). B's registers are
// plain bf16x2 words of x's rows.
#pragma once

#include "common.cuh"

namespace i8m {

constexpr int KT = 64;              // K rows a stage
constexpr int BN = 128;             // weight columns a block (2 groups)
constexpr int WROW = BN + 16;       // staged weight row, bytes
constexpr int XROW = 2 * KT + 16;   // staged x row (64 bf16), bytes
constexpr int STAGES = 4;
constexpr int AHEAD = STAGES - 1;   // stages in flight
constexpr int THREADS = 128;
constexpr int W_BYTES = KT * WROW;

template <int NT>  // n8 tiles of activation rows: rows 0 .. 8 * NT - 1
struct Geo {
  static constexpr int ROWS = 8 * NT;
  static constexpr int STAGE = W_BYTES + ROWS * XROW;
  static constexpr int RING = STAGES * STAGE;
  // the K warps' sums [kw][cg][64 columns][RS] f32, over the ring (a
  // column's rows padded by one against bank conflicts)
  static constexpr int RS = ROWS + 1;
  static constexpr int RED = 2 * 2 * 64 * RS * 4;
  static constexpr int SMEM = RING > RED ? RING : RED;
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ unsigned ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// bf16x2 of two exact floats: lo in the low 16 bits
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// d[4] += A[16 x 16] B[16 x 8]: bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block column (0 .. 63 of its group) of tile j's row r.
__device__ __forceinline__ int tile_col(int j, int r) {
  return r < 8 ? 4 * r + j : 32 + 4 * (r - 8) + j;
}

// acc[j][nt] += A(tile j) B(n8 tile nt) over rows [kb, ke) of q (ke - kb
// a multiple of KT), for this warp's column group and K half. q: int8
// rows at byte stride ldq; group 0's 64 columns start at col0, group 1's
// at col1 (valid1 false: group 1 reads zeros); x: bf16 rows at element
// stride ldx, m of them (rows past m read zeros), K at the same rows as
// q. smem: Geo<NT>::RING bytes. Ends with every copy landed and the
// block synchronized (the ring is free).
template <int NT>
__device__ __forceinline__ void stream(
    unsigned char* smem, const int8_t* __restrict__ q, long long ldq,
    long long col0, long long col1, bool valid1,
    const __nv_bfloat16* __restrict__ x, long long ldx, int m, int kb,
    int ke, float (&acc)[4][NT][4]) {
  using G = Geo<NT>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cg = warp & 1;
  const int kw = warp >> 1;
  const int nst = (ke - kb) / KT;

  auto load = [&](int s, int st) {
    unsigned char* ws = smem + st * G::STAGE;
    unsigned char* xs = ws + W_BYTES;
    const int k0 = kb + s * KT;
#pragma unroll
    for (int i = tid; i < KT * 8; i += THREADS) {  // 16 weights a copy
      const int r = i >> 3;
      const int c = i & 7;
      const bool grp1 = c >= 4;
      const bool ok = !grp1 || valid1;
      const int8_t* src =
          ok ? q + (long long)(k0 + r) * ldq + (grp1 ? col1 : col0) +
                   (c & 3) * 16
             : q;
      cp16(ws + r * WROW + c * 16, src, ok);
    }
#pragma unroll
    for (int i = tid; i < G::ROWS * 8; i += THREADS) {  // 8 bf16 a copy
      const int r = i >> 3;
      const int c = i & 7;
      const bool ok = r < m;
      const __nv_bfloat16* src = ok ? x + (long long)r * ldx + k0 + c * 8 : x;
      cp16(xs + r * XROW + c * 16, src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < nst) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = 0; i < nst; ++i) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1));
    __syncthreads();  // stage i landed; stage i - 1 is no longer read
    {
      const int nx = i + AHEAD;
      if (nx < nst) load(nx, nx % STAGES);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const unsigned char* ws = smem + (i % STAGES) * G::STAGE;
    const unsigned char* xs = ws + W_BYTES;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = kw * 32 + j * 16 + 2 * t;  // rows p, p + 1, p + 8, p + 9
      const unsigned char* wa = ws + p * WROW + cg * 64 + 4 * g;
      float fa[4][4], fb[4][4];  // [row p, p+1, p+8, p+9][column j of 4]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int off = ((u >> 1) * 8 + (u & 1)) * WROW;
        sli::i8x4_to_f32(ld_u32(wa + off), fa[u]);       // tile rows g
        sli::i8x4_to_f32(ld_u32(wa + off + 32), fb[u]);  // tile rows g + 8
      }
      unsigned a[4][4];  // [tile][a0 .. a3]
#pragma unroll
      for (int tj = 0; tj < 4; ++tj) {
        a[tj][0] = pack_bf16x2(fa[0][tj], fa[1][tj]);  // row g, k 2t, 2t + 1
        a[tj][1] = pack_bf16x2(fb[0][tj], fb[1][tj]);  // row g + 8
        a[tj][2] = pack_bf16x2(fa[2][tj], fa[3][tj]);  // row g, k 2t + 8, + 9
        a[tj][3] = pack_bf16x2(fb[2][tj], fb[3][tj]);
      }
      const unsigned char* xr = xs + g * XROW + (kw * 32 + j * 16 + 2 * t) * 2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned b0 = ld_u32(xr + nt * 8 * XROW);
        const unsigned b1 = ld_u32(xr + nt * 8 * XROW + 16);
#pragma unroll
        for (int tj = 0; tj < 4; ++tj) mma16816(acc[tj][nt], a[tj], b0, b1);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// Writes this warp's acc into red[kw][cg][column][row] (f32, RS floats a
// column) and synchronizes; red may alias the ring.
template <int NT>
__device__ __forceinline__ void spill(const float (&acc)[4][NT][4],
                                      float* red) {
  constexpr int RS = Geo<NT>::RS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  float* base = red + (warp >> 1) * (2 * 64 * RS) + (warp & 1) * 64 * RS;
#pragma unroll
  for (int tj = 0; tj < 4; ++tj)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tile_col(tj, g + 8 * (e >> 1));
        const int row = nt * 8 + 2 * t + (e & 1);
        base[col * RS + row] = acc[tj][nt][e];
      }
  __syncthreads();
}

// The block's sum for (group cg, column col, row): the two K warps' sums.
template <int NT>
__device__ __forceinline__ float block_sum(const float* red, int cg, int col,
                                           int row) {
  constexpr int RS = Geo<NT>::RS;
  const int i = (cg * 64 + col) * RS + row;
  return red[i] + red[2 * 64 * RS + i];
}

// Sums 4 consecutive floats of the partials part + z * stride, z = 0 ..
// chunks - 1, in z order (0 + p0 + p1 ..), with 8 loads in flight: the
// partials were written by other blocks of this launch, so they are read
// from L2 (16-byte aligned).
__device__ __forceinline__ float4 sum_partials4(const float* part,
                                                long long stride,
                                                int chunks) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z0 = 0; z0 < chunks; z0 += 8) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = z0 + u < chunks
                 ? __ldcg(reinterpret_cast<const float4*>(
                       part + (z0 + u) * stride))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (z0 + u < chunks) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
    }
  }
  return s;
}

// Arrival at a column tile of a K-split grid: every block has written its
// partials; returns true (to every thread) in the last block to arrive,
// which then reads all of them and resets the counter for the next launch
// (so CUDA-graph replay holds).
__device__ __forceinline__ bool last_to_arrive(int* counter, int chunks) {
  __shared__ int last;
  __threadfence();  // this block's partials are visible card-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    const int old = atomicAdd(counter, 1);
    last = old == chunks - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last != 0;
}

// xn[r, :] = bf16((x[r, :] * inv_r) * nw) with inv_r = rsqrt(mean(x_r^2)
// + eps) in f32; one block of 256 threads a row (x rows at element stride
// ldx, xn rows at h). The rmsnorm of kernels 7m and 6m, once per row.
static __global__ void __launch_bounds__(256)
    norm_rows_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                     const void* __restrict__ nw, int nw_bf16,
                     __nv_bfloat16* __restrict__ xn, int h, float eps) {
  __shared__ float part[8];
  __shared__ float inv_s;
  const int row = blockIdx.x;
  const __nv_bfloat16* xr = x + (long long)row * ldx;
  float s = 0.f;
  for (int k = threadIdx.x; k < h; k += 256) {
    const float v = __bfloat162float(xr[k]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += part[w];
    inv_s = rsqrtf(t / (float)h + eps);
  }
  __syncthreads();
  const float inv = inv_s;
  for (int k = threadIdx.x; k < h; k += 256) {
    const float w =
        nw_bf16 ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(nw)[k])
                : reinterpret_cast<const float*>(nw)[k];
    xn[(long long)row * h + k] =
        __float2bfloat16(__bfloat162float(xr[k]) * inv * w);
  }
}

}  // namespace i8m
