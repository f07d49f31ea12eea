// The post-attention half of a decoder layer for a few rows, one launch:
// x + down(SwiGLU(gate_up(rmsnorm(x + attn @ wo)))) over per-channel int8
// weights.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/ffn_fused.py:
//   fused_wo_ffn (_wo_kernel, ffn_fused.py:222-299; wrapper :302).
// Like the TPU kernel it is an operation of its own: no model path of the
// JAX package dispatches it (ffn_fused.py:313-316), so none of the port's
// does either.
//
// Bound on the H100: bytes. The three weights ([N*D, H], [H, 2I] and
// [I, H] int8: 192.9 MB at Mistral-7B, 151.0 MB at Llama-2-7B, 57.6 /
// 45.1 us at 3.35 TB/s) dominate; attn, x and the scratch are a few
// hundred KB at m = 8.
//
// Design: the TPU kernel is one weight stream, a sequential grid whose
// phases hand their results to the next through VMEM. On the card the
// three products each need every column of the one before, and blocks of
// one ordinary launch cannot wait for each other, so this is a persistent
// cooperative grid (cudaLaunchCooperativeKernel; every block resident at
// once) whose blocks meet at cooperative_groups::this_grid().sync()
// between the phases, each phase a grid-stride loop over work items built
// from the blocks of int8_rows.cuh (16-byte weight loads, f32 FMAs
// against activation slabs staged in shared memory):
//   1a. wo: items (8 rows, 256 columns of H, a K range of attn) write f32
//       partial sums;
//   1b. every thread sums its elements' partials: wo_out = round(sum x
//       wo scale), xres = round(x + wo_out), kept in an f32 scratch;
//   2.  gate_up: items (8 rows, 64 gate and the matching 64 up columns)
//       take the rmsnorm of their xres rows, stream all of K, apply the
//       scales and SwiGLU, and write h [m, I] in the activation dtype;
//   3a. down: items as in 1a over h;
//   3b. out = round(sum x down scale + xres).
// Rounding points are ffn_fused.py:249-258's, in the activation dtype as
// the port's fused_ffn rounds (with bf16 activations the TPU kernel's
// math): wo_out, x + wo_out, the normalized rows and h are rounded; sums,
// scales, SwiGLU and the last residual add stay f32. The grid must not
// exceed the blocks the card holds at once (occupancy x SM count), or the
// first grid sync waits for blocks that never start: the launcher checks
// and returns SLI_ERR_GRID, and the wrapper raises. The scratch (partials,
// xres, h) makes one round trip through L2 per phase, a few hundred KB
// against the weights' 150-190 MB.
#include <cooperative_groups.h>

#include "int8_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WF_CT = 16;                  // row-product items: 256 columns
constexpr int WF_CW = 16 * WF_CT;
constexpr int WF_KL = RT_THREADS / WF_CT;
constexpr int GU_CT = 8;                   // gate_up items: 4 gate + 4 up
constexpr int GU_CW = 16 * GU_CT;          // 128 columns
constexpr int GU_GW = GU_CW / 2;           // 64 gate (and up) columns
constexpr int GU_KL = RT_THREADS / GU_CT;
constexpr int RED_FLOATS = WF_KL * WF_CW > GU_KL * GU_CW ? WF_KL * WF_CW
                                                         : GU_KL * GU_CW;

struct Args {
  const void* attn;   // [m, nd]
  const void* x;      // [m, h], the residual
  const int8_t* wo;   // [nd, h]
  const float* wos;   // [h]
  const void* nw;     // [h], f32 or bf16 (nw_bf16)
  const int8_t* q1;   // [h, 2 inter]
  const float* s1;    // [2 inter]
  const int8_t* q2;   // [inter, h]
  const float* s2;    // [h]
  float* part;        // max(chunks0, chunks2) * m * h
  float* xres;        // [m, h]
  void* hbuf;         // [m, inter]
  void* out;          // [m, h]
  int m, nd, h, inter, kch0, kch2, nw_bf16, vec0, vec1, vec2;
  float eps;
};

// One item of a K-split row product: rows [m0, m0 + 8), columns
// [col0, col0 + 256), K rows [kb, ke) of x [m, k] against q [k, n]; f32
// sums to part[z][m][n] (qmm_rows_kernel of int8_rows.cuh as a device
// function).
template <typename T>
__device__ void rows_item(const T* __restrict__ x, const int8_t* __restrict__ q,
                          float* __restrict__ part, int m, int k, int n,
                          int kch, bool vec, int item, float* xs, float* red,
                          float* tile) {
  const int mt_n = (m + RT_MT - 1) / RT_MT;
  const int ct_n = (n + WF_CW - 1) / WF_CW;
  const int m0 = (item % mt_n) * RT_MT;
  const int col0 = (item / mt_n % ct_n) * WF_CW;
  const int z = item / (mt_n * ct_n);
  const int kb = z * kch;
  const int ke = min(k, kb + kch);
  const int tid = threadIdx.x;
  const int c = col0 + (tid % WF_CT) * 16;
  float acc[RT_MT][16];
#pragma unroll
  for (int r = 0; r < RT_MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  float sc[16];
  int g_cur = 0;
  for (int k0 = kb; k0 < ke; k0 += RT_KC) {
    const int kcnt = min(RT_KC, ke - k0);
    stage_rows<T, false>(x, k, m0, m, k0, kcnt, nullptr, nullptr, 0, xs);
    stream_rows<WF_KL, false>(acc, q + (long long)k0 * n, n, c, n, vec, kcnt,
                              tid / WF_CT, xs, nullptr, k0, k, sc, g_cur);
  }
  reduce_lanes<WF_CT>(acc, red, tile);
  for (int i = tid; i < RT_MT * WF_CW; i += RT_THREADS) {
    const int r = i / WF_CW;
    const int col = col0 + (i - r * WF_CW);
    if (m0 + r < m && col < n)
      part[((long long)z * m + m0 + r) * n + col] = tile[i];
  }
}

// The normalized xres rows [k0, k0 + kcnt) of the item's rows into xs:
// (xres * inv[r]) * nw[k] in f32, rounded to T (stage_rows' NORM form over
// an f32 source). Ends synchronized.
template <typename T>
__device__ void stage_norm(const float* __restrict__ xres, int h, int m0,
                           int m, int k0, int kcnt,
                           const float* __restrict__ inv,
                           const void* __restrict__ nw, int nw_bf16,
                           float* xs) {
  __syncthreads();  // the previous slab is no longer read
  for (int i = threadIdx.x; i < RT_MT * RT_KC; i += RT_THREADS) {
    const int r = i / RT_KC;
    const int kk = i - r * RT_KC;
    float v = 0.f;
    if (m0 + r < m && kk < kcnt) {
      const float w =
          nw_bf16 ? __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(nw)[k0 + kk])
                  : reinterpret_cast<const float*>(nw)[k0 + kk];
      v = sli::to_f(sli::from_f<T>(
          xres[(long long)(m0 + r) * h + k0 + kk] * inv[r] * w));
    }
    xs[kk * RT_MT + r] = v;
  }
  __syncthreads();
}

// One gate_up item: rows [m0, m0 + 8), gate columns [j0, j0 + 64) and the
// matching up columns; h = SwiGLU(gate, up) in T.
template <typename T>
__device__ void gate_up_item(const Args& a, int item, float* xs, float* red,
                             float* tile, float* inv) {
  const int mt_n = (a.m + RT_MT - 1) / RT_MT;
  const int m0 = (item % mt_n) * RT_MT;
  const int j0 = (item / mt_n) * GU_GW;
  const int tid = threadIdx.x;
  const int ct = tid % GU_CT;
  const bool up = ct >= GU_CT / 2;
  const int c = j0 + (ct % (GU_CT / 2)) * 16;  // column within [0, I)
  const long long ldw = 2LL * a.inter;
  row_rms<float>(a.xres, a.h, m0, a.m, a.h, a.eps, inv);
  float acc[RT_MT][16];
#pragma unroll
  for (int r = 0; r < RT_MT; ++r)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
  float sc[16];
  int g_cur = 0;
  for (int k0 = 0; k0 < a.h; k0 += RT_KC) {
    const int kcnt = min(RT_KC, a.h - k0);
    stage_norm<T>(a.xres, a.h, m0, a.m, k0, kcnt, inv, a.nw, a.nw_bf16, xs);
    stream_rows<GU_KL, false>(acc, a.q1 + k0 * ldw + (up ? a.inter : 0), ldw,
                              c, a.inter, a.vec1 != 0, kcnt, tid / GU_CT, xs,
                              nullptr, k0, a.h, sc, g_cur);
  }
  reduce_lanes<GU_CT>(acc, red, tile);
  T* hb = (T*)a.hbuf;
  for (int i = tid; i < RT_MT * GU_GW; i += RT_THREADS) {
    const int r = i / GU_GW;
    const int j = i - r * GU_GW;
    const int row = m0 + r;
    const int col = j0 + j;
    if (row >= a.m || col >= a.inter) continue;
    const float g = tile[r * GU_CW + j] * __ldg(a.s1 + col);
    const float u = tile[r * GU_CW + GU_GW + j] * __ldg(a.s1 + a.inter + col);
    const float sg = 1.f / (1.f + expf(-g));
    hb[(long long)row * a.inter + col] = sli::from_f<T>(g * sg * u);
  }
}

template <typename T>
__global__ void __launch_bounds__(RT_THREADS, 1) wo_ffn_kernel(Args a) {
  __shared__ __align__(16) float xs[RT_KC * RT_MT];
  __shared__ __align__(16) float red[RED_FLOATS];
  __shared__ __align__(16) float tile[RT_MT * WF_CW];
  __shared__ float inv[RT_MT];
  cg::grid_group grid = cg::this_grid();
  const int mt_n = (a.m + RT_MT - 1) / RT_MT;
  const int ch0 = (a.nd + a.kch0 - 1) / a.kch0;
  const int ch2 = (a.inter + a.kch2 - 1) / a.kch2;
  const int ct_n = (a.h + WF_CW - 1) / WF_CW;
  const long long total = (long long)a.m * a.h;
  const long long tid_g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;

  // 1a. attn @ wo, K split
  for (int it = blockIdx.x; it < mt_n * ct_n * ch0; it += gridDim.x)
    rows_item<T>((const T*)a.attn, a.wo, a.part, a.m, a.nd, a.h, a.kch0,
                 a.vec0 != 0, it, xs, red, tile);
  grid.sync();
  // 1b. xres = round(x + round(wo_out)), carried in f32
  for (long long i = tid_g; i < total; i += stride) {
    float s = 0.f;
    for (int z = 0; z < ch0; ++z) s += a.part[z * total + i];
    const float wo_out = sli::to_f(sli::from_f<T>(s * a.wos[i % a.h]));
    a.xres[i] = sli::to_f(
        sli::from_f<T>(sli::to_f(((const T*)a.x)[i]) + wo_out));
  }
  grid.sync();
  // 2. rmsnorm -> gate_up -> SwiGLU into h
  const int gu_n = (a.inter + GU_GW - 1) / GU_GW;
  for (int it = blockIdx.x; it < mt_n * gu_n; it += gridDim.x)
    gate_up_item<T>(a, it, xs, red, tile, inv);
  grid.sync();
  // 3a. h @ down, K split
  for (int it = blockIdx.x; it < mt_n * ct_n * ch2; it += gridDim.x)
    rows_item<T>((const T*)a.hbuf, a.q2, a.part, a.m, a.inter, a.h, a.kch2,
                 a.vec2 != 0, it, xs, red, tile);
  grid.sync();
  // 3b. out = round(down x scale + xres)
  for (long long i = tid_g; i < total; i += stride) {
    float s = 0.f;
    for (int z = 0; z < ch2; ++z) s += a.part[z * total + i];
    ((T*)a.out)[i] = sli::from_f<T>(s * a.s2[i % a.h] + a.xres[i]);
  }
}

template <typename T>
int max_grid(int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  int coop = 0;
  int per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, wo_ffn_kernel<T>, RT_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = coop ? per_sm * sms : 0;
  return 0;
}

template <typename T>
int run(const Args& a, int grid, cudaStream_t st) {
  int most = 0;
  const int rc = max_grid<T>(&most);
  if (rc != 0) return rc;
  if (grid <= 0 || grid > most) return SLI_ERR_GRID;
  Args arg = a;
  void* params[] = {&arg};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)wo_ffn_kernel<T>, dim3(grid), dim3(RT_THREADS), params, 0,
      st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most blocks of the cooperative grid the card holds at once for
// activations of x_dtype (0 when the card has no cooperative launch).
int sli_wo_ffn_max_grid(int x_dtype, int* blocks) {
  if (x_dtype == SLI_F32) return max_grid<float>(blocks);
  if (x_dtype == SLI_BF16) return max_grid<__nv_bfloat16>(blocks);
  return SLI_ERR_DTYPE;
}

// attn: [m, nd]; x: [m, h] (x_dtype, both contiguous); wo: the layer's
// [nd, h] int8 with wos [h] f32; nw: the layer's norm weight [h] (f32, or
// bf16 when nw_bf16); q1: [h, 2 inter] int8 with s1 [2 inter]; q2: [inter,
// h] int8 with s2 [h]; part: max(ceil(nd / kch0), ceil(inter / kch2)) * m
// * h floats; xres: m * h floats; hbuf: [m, inter] (x_dtype); out: [m, h]
// (x_dtype). vec0/1/2: wo/q1/q2 allow 16-byte loads. grid: the blocks of
// the cooperative launch, at most sli_wo_ffn_max_grid's (else
// SLI_ERR_GRID, nothing launched).
int sli_wo_ffn(const void* attn, const void* x, const void* wo,
               const float* wos, const void* nw, int nw_bf16, const void* q1,
               const float* s1, const void* q2, const float* s2, float* part,
               float* xres, void* hbuf, void* out, int m, int nd, int h,
               int inter, int kch0, int kch2, float eps, int vec0, int vec1,
               int vec2, int grid, int x_dtype, void* stream) {
  if (m <= 0 || nd <= 0 || h <= 0 || inter <= 0 || kch0 <= 0 || kch2 <= 0)
    return SLI_ERR_SHAPE;
  const Args a{attn, x, (const int8_t*)wo, wos, nw, (const int8_t*)q1, s1,
               (const int8_t*)q2, s2, part, xres, hbuf, out, m, nd, h, inter,
               kch0, kch2, nw_bf16, vec0, vec1, vec2, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == SLI_F32) return run<float>(a, grid, st);
  if (x_dtype == SLI_BF16) return run<__nv_bfloat16>(a, grid, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
