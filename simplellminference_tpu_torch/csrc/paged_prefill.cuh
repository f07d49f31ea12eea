// The body of kernel 8 (paged flash prefill): the FMA kernel (f32 q), the
// tensor-core kernel over prefill_mma.cuh (bf16 q), their launches and
// their dispatch over head dims and the cap, included by paged_prefill.cu
// (the entry point; its note says what the kernels replace, what bounds
// them and how they are built) and by paged_prefill_e4m3.cu, which
// instantiates the FP8-KV forms in a translation unit of its own so that
// nvcc builds the two in parallel.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "prefill_mma.cuh"

namespace sli_pp {

// The FP8-KV forms (e4m3 pools), defined in paged_prefill_e4m3.cu: f32 q
// on the FMA kernel, bf16 q on the tensor-core one (arguments as
// dispatch_d's and dispatch_mma's).
int dispatch_e4m3_fma(int head_dim, const void* q, long long q_bs,
                      long long q_ss, const void* pool_k, const void* pool_v,
                      const int* tables, const int* kv_lens, const int* offs,
                      void* out, int batch, int seq, int heads, int layer,
                      int num_pages1, int kvn, int ps, int mp, int group,
                      int window, float scale, float cap, const float* sinks,
                      cudaStream_t st);
int dispatch_e4m3_mma(int head_dim, const void* q, long long q_bs,
                      long long q_ss, const void* pool_k, const void* pool_v,
                      const int* tables, const int* kv_lens, const int* offs,
                      void* out, float* work, int batch, int seq, int heads,
                      int layer, int num_pages1, int kvn, int ps, int mp,
                      int group, int window, float scale, float cap,
                      int splits, const float* sinks, cudaStream_t st);

}  // namespace sli_pp

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * (BK + 1)) *
             sizeof(float) +
         (size_t)BK * sizeof(long long);
}

// q: [B, Sq, N, D] with element strides q_bs (batch) and q_ss (row), heads
// contiguous; pools [L, P+1, kvN, ps, D] of P (T, __nv_fp8_e4m3, or int8_t
// with the scale pools ksp/vsp [L, P+1, kvN, ps]) contiguous; out [B, Sq,
// N, D] contiguous.
template <typename T, typename P, int D, bool CAP>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const T* __restrict__ q, long long q_bs, long long q_ss,
    const P* __restrict__ pool_k, const P* __restrict__ pool_v,
    const float* __restrict__ ksp, const float* __restrict__ vsp,
    const int* __restrict__ tables, const int* __restrict__ kv_lens,
    const int* __restrict__ offs, T* __restrict__ out, int seq, int heads,
    int layer, int num_pages1, int kvn, int ps, int mp, int group,
    int window, float scale, float cap, const float* __restrict__ sinks) {
  constexpr bool QUANT = std::is_same_v<P, int8_t>;  // scales beside codes
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D+1]
  float* ks = qs + BQ * (D + 1);     // [BK][D+1]
  float* vs = ks + BK * (D + 1);     // [BK][D]
  float* pr = vs + BK * D;           // [BQ][BK+1]
  long long* rowoff = (long long*)(pr + BQ * (BK + 1));  // [BK], -1 = zeros
  constexpr int CPT = D / 16;        // output columns per thread

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // cols tx + 16*j
  const int q0 = qt * BQ;
  const int off = offs[b];
  const int n_keys = min(kv_lens[b], mp * ps);
  const int* row = tables + (long long)b * mp;

  const T* qb = q + (long long)b * q_bs + (long long)h * D;
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = q0 + r;
    qs[r * (D + 1) + d] = s < seq ? sli::to_f(qb[(long long)s * q_ss + d])
                                  : 0.f;
  }

  float acc[4][CPT];
  float m[4];
  float l[4];
  // a sink seeds the row's state (its head's logit, one unit of weight)
  const float m_seed = sinks != nullptr ? sinks[h] : NEG_INF;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = m_seed;
    l[i] = sinks != nullptr ? 1.f : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // keys k_lo .. min(newest query position of the tile, n_keys - 1); k_lo
  // is 0, or with a window the oldest row's first key
  const int last_key = min(off + min(q0 + BQ, seq) - 1, n_keys - 1);
  const int k_lo = window > 0 ? max(0, off + q0 - window + 1) : 0;
  const int nkt = last_key < k_lo ? 0 : (last_key - k_lo) / BK + 1;
  const long long layer_base = (long long)layer * num_pages1;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = k_lo + kt * BK;
    __syncthreads();  // the previous tile's readers are done
    if (tid < BK) {
      const int kp = k0 + tid;
      long long o = -1;
      if (kp <= last_key) {
        const int page = row[kp / ps];
        if (page >= 0 && page < num_pages1)
          o = (((layer_base + page) * kvn + kh) * ps + kp % ps) * (long long)D;
      }
      rowoff[tid] = o;
    }
    __syncthreads();
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D;
      const int d = i - r * D;
      const long long o = rowoff[r];
      float kv = 0.f;
      float vv = 0.f;
      if (o >= 0) {
        kv = sli::to_f(pool_k[o + d]);
        vv = sli::to_f(pool_v[o + d]);
        if (QUANT) {  // dequantize in f32, round to q's dtype
          kv = sli::to_f(sli::from_f<T>(kv * ksp[o / D]));
          vv = sli::to_f(sli::from_f<T>(vv * vsp[o / D]));
        }
      }
      ks[r * (D + 1) + d] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4];
      float kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = off + q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if constexpr (CAP) s = cap * tanhf(s * (1.f / cap));
        if (kp > qp || kp >= n_keys || (window > 0 && kp <= qp - window))
          s = NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      // the 16 threads sharing ty hold the tile's 64 columns of row i
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a masked key, or a row that has seen no key yet, keeps p = 0
        const float p = sc[i][j] <= NEG_INF ? 0.f : expf(sc[i][j] - m_new);
        sc[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pr[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha[i];
    const int kmax = min(BK, last_key + 1 - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = pr[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

  T* ob = out + ((long long)b * seq * heads + h) * D;
  const long long o_ss = (long long)heads * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s < seq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        ob[(long long)s * o_ss + tx + 16 * c] = sli::from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T, typename P, int D, bool CAP>
int launch(const void* q, long long q_bs, long long q_ss, const void* pool_k,
           const void* pool_v, const float* ksp, const float* vsp,
           const int* tables, const int* kv_lens, const int* offs, void* out,
           int batch, int seq, int heads, int layer, int num_pages1, int kvn,
           int ps, int mp, int group, int window, float scale, float cap,
           const float* sinks, cudaStream_t st) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t e = sli::allow_smem(paged_prefill_kernel<T, P, D, CAP>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  paged_prefill_kernel<T, P, D, CAP><<<grid, NT, bytes, st>>>(
      (const T*)q, q_bs, q_ss, (const P*)pool_k, (const P*)pool_v, ksp, vsp,
      tables, kv_lens, offs, (T*)out, seq, heads, layer, num_pages1, kvn, ps,
      mp, group, window, scale, cap, sinks);
  return (int)cudaGetLastError();
}

// Every pool (q's dtype, int8 with its scales, e4m3) takes every option:
// the cap a template flag, windows and sinks runtime arguments, D 256 an
// instantiation like the others.
template <typename T, typename P>
int dispatch_d(int head_dim, const void* q, long long q_bs, long long q_ss,
               const void* pool_k, const void* pool_v, const float* ksp,
               const float* vsp, const int* tables, const int* kv_lens,
               const int* offs, void* out, int batch, int seq, int heads,
               int layer, int num_pages1, int kvn, int ps, int mp, int group,
               int window, float scale, float cap, const float* sinks,
               cudaStream_t st) {
#define SLI_PP_LAUNCH(DD, C)                                                 \
  launch<T, P, DD, C>(q, q_bs, q_ss, pool_k, pool_v, ksp, vsp, tables,       \
                      kv_lens, offs, out, batch, seq, heads, layer,          \
                      num_pages1, kvn, ps, mp, group, window, scale, cap,    \
                      sinks, st)
#define SLI_PP_CASE(DD)                                                      \
  case DD:                                                                   \
    if (cap > 0.f) return SLI_PP_LAUNCH(DD, true);                           \
    return SLI_PP_LAUNCH(DD, false);
  switch (head_dim) {
    SLI_PP_CASE(32)
    SLI_PP_CASE(64)
    SLI_PP_CASE(128)
    SLI_PP_CASE(256)
    default:
      return SLI_ERR_HEAD_DIM;
  }
#undef SLI_PP_CASE
#undef SLI_PP_LAUNCH
}

// The K/V rows of one sequence and kv head in the stacked pools, for
// pfa::attend: a cursor on key kp holds its table column kp / ps and its
// row in the page kp % ps, advanced 64 keys a tile without a division;
// the page is the table entry (fetched one tile ahead), the row
// ((layer * P1 + page) * kvN + kh) * ps + kp % ps, -1 (zeros) for an
// unmapped or out-of-range page.
template <int D, int KV>
struct PagedRows {
  const unsigned char* pk;
  const unsigned char* pv;
  const float* ks;
  const float* vs;
  const int* table;
  long long base;  // layer * P1
  int kvn, kh, ps, p1;
  int step_col, step_row;  // 64 keys: 64 / ps columns and 64 % ps rows
  static constexpr int ROW = KV != sli::pfa::KV_BF16 ? D : 2 * D;  // bytes
  struct Cursor {
    int col, in;
  };
  __device__ Cursor cursor(int kp) const { return {kp / ps, kp % ps}; }
  __device__ void advance(Cursor& c) const {
    c.col += step_col;
    c.in += step_row;
    if (c.in >= ps) {
      c.in -= ps;
      ++c.col;
    }
  }
  __device__ int page(const Cursor& c) const { return __ldg(table + c.col); }
  __device__ long long row(const Cursor& c, int pg) const {
    if (pg < 0 || pg >= p1) return -1;
    return ((base + pg) * kvn + kh) * ps + c.in;
  }
  __device__ const void* k(long long r) const { return pk + r * ROW; }
  __device__ const void* v(long long r) const { return pv + r * ROW; }
  __device__ const float* ksc(long long r) const { return ks + r; }
  __device__ const float* vsc(long long r) const { return vs + r; }
};

// bf16 q [B, Sq, N, D] (element strides q_bs, q_ss; 16-byte aligned
// rows) against bf16 pools, e4m3 pools (KV_E4M3), or int8 pools (KV_I8)
// with their scale pools; out [B, Sq, N, D] contiguous, or the split
// partials in work.
template <int D, int KV, bool CAP>
__global__ void __launch_bounds__(sli::pfa::NT) paged_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q, long long q_bs, long long q_ss,
    const void* __restrict__ pool_k, const void* __restrict__ pool_v,
    const float* __restrict__ ksp, const float* __restrict__ vsp,
    const int* __restrict__ tables, const int* __restrict__ kv_lens,
    const int* __restrict__ offs, __nv_bfloat16* __restrict__ out,
    float* __restrict__ work, int batch, int seq, int heads, int layer,
    int num_pages1, int kvn, int ps, int mp, int group, int window,
    sli::pfa::Score sc, int splits, const float* __restrict__ sinks) {
  const int b = blockIdx.z / splits;
  const PagedRows<D, KV> src{
      (const unsigned char*)pool_k, (const unsigned char*)pool_v, ksp, vsp,
      tables + (long long)b * mp, (long long)layer * num_pages1, kvn,
      (int)blockIdx.y, ps, num_pages1, sli::pfa::TILE / ps,
      sli::pfa::TILE % ps};
  sli::pfa::attend<D, KV, CAP>(q + (long long)b * q_bs, q_ss, src,
                               out + (long long)b * seq * heads * D, work,
                               batch, b, seq, heads, group, offs[b],
                               min(kv_lens[b], mp * ps), window, sc, splits,
                               sinks);
}

template <int D, int KV, bool CAP>
int launch_mma(const void* q, long long q_bs, long long q_ss,
               const void* pool_k, const void* pool_v, const float* ksp,
               const float* vsp, const int* tables, const int* kv_lens,
               const int* offs, void* out, float* work, int batch, int seq,
               int heads, int layer, int num_pages1, int kvn, int ps, int mp,
               int group, int window, float scale, float cap, int splits,
               const float* sinks, cudaStream_t st) {
  namespace pfa = sli::pfa;
  constexpr int bytes = pfa::Smem<D, KV>::BYTES;
  auto kern = paged_prefill_mma_kernel<D, KV, CAP>;
  cudaError_t e = sli::allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  const int h = min(group, pfa::TILE);
  const int tiles = (seq + pfa::TILE / h - 1) / (pfa::TILE / h) *
                    ((group + h - 1) / h);
  const dim3 grid(tiles, kvn, batch * splits);
  kern<<<grid, pfa::NT, bytes, st>>>(
      (const __nv_bfloat16*)q, q_bs, q_ss, pool_k, pool_v, ksp, vsp, tables,
      kv_lens, offs, (__nv_bfloat16*)out, work, batch, seq, heads, layer,
      num_pages1, kvn, ps, mp, group, window, pfa::make_score(scale, cap),
      splits, sinks);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)sli::launch_merge<__nv_bfloat16>(
      work, out, (long long)batch * seq * heads, D, splits, st);
}

// Every pool kind (bf16, int8, e4m3) takes every option, as dispatch_d.
template <int KV>
int dispatch_mma(int head_dim, const void* q, long long q_bs, long long q_ss,
                 const void* pool_k, const void* pool_v, const float* ksp,
                 const float* vsp, const int* tables, const int* kv_lens,
                 const int* offs, void* out, float* work, int batch, int seq,
                 int heads, int layer, int num_pages1, int kvn, int ps,
                 int mp, int group, int window, float scale, float cap,
                 int splits, const float* sinks, cudaStream_t st) {
#define SLI_PP_LAUNCH(DD, C)                                                  \
  launch_mma<DD, KV, C>(q, q_bs, q_ss, pool_k, pool_v, ksp, vsp, tables,      \
                        kv_lens, offs, out, work, batch, seq, heads, layer,   \
                        num_pages1, kvn, ps, mp, group, window, scale, cap,   \
                        splits, sinks, st)
#define SLI_PP_CASE(DD)                                                       \
  case DD:                                                                    \
    if (cap > 0.f) return SLI_PP_LAUNCH(DD, true);                            \
    return SLI_PP_LAUNCH(DD, false);
  switch (head_dim) {
    SLI_PP_CASE(32)
    SLI_PP_CASE(64)
    SLI_PP_CASE(128)
    SLI_PP_CASE(256)
    default:
      return SLI_ERR_HEAD_DIM;
  }
#undef SLI_PP_CASE
#undef SLI_PP_LAUNCH
}

}  // namespace
