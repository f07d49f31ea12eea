// Paged flash prefill attention: a chunk of queries per sequence, at its own
// absolute offset, against the KV already in its pages (found through the
// block table), causal, online softmax.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/attention/
// paged_prefill.py: paged_flash_prefill (_paged_prefill_kernel,
// paged_prefill.py:44-150), for bf16/f32 pools and, its INT8-KV form,
// int8 pools with per-token-per-head f32 scale pools [L, P+1, kvN, ps],
// and the sliding-window form of both (window > 0, paged_prefill.py:90-92,
// :131-132; the soft cap, sinks and shared-KV forms raise in the wrapper).
//
// Bound on the H100: for the serving shapes (a prefix-cached suffix of
// Sq = 64 rows or a 256-row chunk behind a few hundred cached tokens) the
// least time is set by bytes: q and the output (2*N*Sq*D elements per row)
// plus each sequence's live K and V (2*kvN*kv_len*D elements), at
// 3.35 TB/s, against 4*B*N*Sq*kv_len*D operations, which stay below the
// card's ops-per-byte balance point at these lengths. INT8 KV halves the
// K/V bytes and adds one f32 scale per key row and head.
//
// Design: one block per (q tile of 64 rows, q head, sequence). Query row r
// sits at absolute position off[b] + q0 + r. The block walks K/V tiles of
// 64 keys from key 0 up to min(its last query position, kv_len - 1) only:
// tiles past the causal frontier or past kv_len are never loaded. The page
// of each key row of a tile is looked up once per tile (key p reads row
// p % ps of page tables[b, p / ps], so pages smaller than the tile work)
// into shared memory; an unmapped (-1) entry reads zeros, as the plain
// version's gather does, and never touches memory outside the pool. K/V
// rows are staged through shared memory in f32; scores, the running
// max/sum and the accumulator stay in f32 (a 4 x 4 micro-tile per thread
// for QK^T, 4 rows x D/16 columns for PV, plain FMAs). The mask is per
// element: k_pos <= q_pos && k_pos < kv_len. Every row of a sequence with
// kv_len >= 1 sees key 0, so its sum is never 0; rows past kv_len (the
// chunk's padding) and the batch's padding rows (-1 tables, kv_len 1)
// stay finite, and the sum is guarded anyway. Every Sq is taken. GQA head
// of q head h is h / group. INT8 KV dequantizes each staged K/V element
// as the TPU kernel dequantizes each page slab (paged_prefill.py:105-110):
// code x its row's scale in f32, rounded to q's dtype, then used as the
// bf16/f32 pools' values are. Sliding window: query q_pos attends keys
// q_pos - window < k_pos <= q_pos; the walk starts at the oldest row of
// the tile's first key, off + q0 - window + 1, and reads no key below it
// (its tiles start there, not at a multiple of 64), so over the grouped
// engine's ring pools a table column below the band, which aliases the
// live page of a newer position, is never read. A row's keys below its own
// band are masked per element (p = 0). Sharing a K/V tile across the GQA group,
// TMA page copies and wgmma are later work.
#include "common.cuh"

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
// contiguous; pools [L, P+1, kvN, ps, D] of P (T, or int8_t with the scale
// pools ksp/vsp [L, P+1, kvN, ps]) contiguous; out [B, Sq, N, D]
// contiguous.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(
    const T* __restrict__ q, long long q_bs, long long q_ss,
    const P* __restrict__ pool_k, const P* __restrict__ pool_v,
    const float* __restrict__ ksp, const float* __restrict__ vsp,
    const int* __restrict__ tables, const int* __restrict__ kv_lens,
    const int* __restrict__ offs, T* __restrict__ out, int seq, int heads,
    int layer, int num_pages1, int kvn, int ps, int mp, int group,
    int window, float scale) {
  constexpr bool QUANT = sizeof(P) == 1;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
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

template <typename T, typename P, int D>
int launch(const void* q, long long q_bs, long long q_ss, const void* pool_k,
           const void* pool_v, const float* ksp, const float* vsp,
           const int* tables, const int* kv_lens, const int* offs, void* out,
           int batch, int seq, int heads, int layer, int num_pages1, int kvn,
           int ps, int mp, int group, int window, float scale,
           cudaStream_t st) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t e = sli::allow_smem(paged_prefill_kernel<T, P, D>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  paged_prefill_kernel<T, P, D><<<grid, NT, bytes, st>>>(
      (const T*)q, q_bs, q_ss, (const P*)pool_k, (const P*)pool_v, ksp, vsp,
      tables, kv_lens, offs, (T*)out, seq, heads, layer, num_pages1, kvn, ps,
      mp, group, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int dispatch_d(int head_dim, const void* q, long long q_bs, long long q_ss,
               const void* pool_k, const void* pool_v, const float* ksp,
               const float* vsp, const int* tables, const int* kv_lens,
               const int* offs, void* out, int batch, int seq, int heads,
               int layer, int num_pages1, int kvn, int ps, int mp, int group,
               int window, float scale, cudaStream_t st) {
  switch (head_dim) {
    case 32:
      return launch<T, P, 32>(q, q_bs, q_ss, pool_k, pool_v, ksp, vsp,
                              tables, kv_lens, offs, out, batch, seq, heads,
                              layer, num_pages1, kvn, ps, mp, group, window,
                              scale, st);
    case 64:
      return launch<T, P, 64>(q, q_bs, q_ss, pool_k, pool_v, ksp, vsp,
                              tables, kv_lens, offs, out, batch, seq, heads,
                              layer, num_pages1, kvn, ps, mp, group, window,
                              scale, st);
    case 128:
      return launch<T, P, 128>(q, q_bs, q_ss, pool_k, pool_v, ksp, vsp,
                               tables, kv_lens, offs, out, batch, seq, heads,
                               layer, num_pages1, kvn, ps, mp, group, window,
                               scale, st);
    default:
      return SLI_ERR_HEAD_DIM;
  }
}

template <typename T>
int dispatch_p(bool quant, int head_dim, const void* q, long long q_bs,
               long long q_ss, const void* pool_k, const void* pool_v,
               const float* ksp, const float* vsp, const int* tables,
               const int* kv_lens, const int* offs, void* out, int batch,
               int seq, int heads, int layer, int num_pages1, int kvn, int ps,
               int mp, int group, int window, float scale, cudaStream_t st) {
  if (quant)
    return dispatch_d<T, int8_t>(head_dim, q, q_bs, q_ss, pool_k, pool_v, ksp,
                                 vsp, tables, kv_lens, offs, out, batch, seq,
                                 heads, layer, num_pages1, kvn, ps, mp, group,
                                 window, scale, st);
  return dispatch_d<T, T>(head_dim, q, q_bs, q_ss, pool_k, pool_v, ksp, vsp,
                          tables, kv_lens, offs, out, batch, seq, heads,
                          layer, num_pages1, kvn, ps, mp, group, window, scale,
                          st);
}

}  // namespace

// k_scale/v_scale: null for bf16/f32 pools (of q's dtype); given, the pools
// are int8 and these are their f32 scale pools [L, num_pages1, kvn, ps].
// window: 0 for none, else the sliding window (>= 1).
extern "C" int sli_paged_flash_prefill(
    const void* q, long long q_bs, long long q_ss, const void* pool_k,
    const void* pool_v, const void* k_scale, const void* v_scale,
    const int* tables, const int* kv_lens, const int* offs, void* out,
    int batch, int seq, int heads, int layer, int num_pages1, int kvn, int ps,
    int mp, int group, int head_dim, int window, float scale, int dtype,
    void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || kvn <= 0 || group <= 0 ||
      ps <= 0 || mp <= 0 || heads != kvn * group || window < 0)
    return SLI_ERR_SHAPE;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ksp = (const float*)k_scale;
  const float* vsp = (const float*)v_scale;
  const bool quant = ksp != nullptr;
  if (dtype == SLI_F32)
    return dispatch_p<float>(quant, head_dim, q, q_bs, q_ss, pool_k, pool_v,
                             ksp, vsp, tables, kv_lens, offs, out, batch, seq,
                             heads, layer, num_pages1, kvn, ps, mp, group,
                             window, scale, st);
  if (dtype == SLI_BF16)
    return dispatch_p<__nv_bfloat16>(quant, head_dim, q, q_bs, q_ss, pool_k,
                                     pool_v, ksp, vsp, tables, kv_lens, offs,
                                     out, batch, seq, heads, layer,
                                     num_pages1, kvn, ps, mp, group, window,
                                     scale, st);
  return SLI_ERR_DTYPE;
}
