// Paged flash-decode attention: one query token per sequence (decode), or a
// verify window of S <= 8 consecutive query tokens per sequence (speculative
// decoding), against its KV pages, found through the block table, online
// softmax.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/attention/
// paged_decode.py: _paged_kernel (paged_decode.py:24-131), reached through
// paged_flash_decode (:165, wins=1, one query row per sequence) and
// paged_flash_verify (:136, wins=S, rows s at positions kv_len - S + s),
// over bf16/f32 pools and, its INT8-KV form, over int8 pools with
// per-token-per-head f32 scale pools [L, P+1, kvN, ps]; and the TPU kernel
// of simplellminference_tpu/ops/attention/flash_decode.py: _decode_kernel
// (flash_decode.py:40-107), reached through flash_decode (:114), one query
// row per sequence over the dense KV arena [L, B', kvN, Smax, D]. A dense
// arena is a pool with one page of Smax slots per sequence, so the same
// body serves it (template DENSE: sequence b reads arena row b, no table)
// and walks only the keys below min(kv_len, Smax), where the TPU kernel
// clamps past-the-end grid steps (flash_decode.py:172-181); its bk,
// rows_target and max_kv tiling hints have no counterpart. The paged forms
// take the sliding window of the TPU kernel (paged_decode.py:73-75,
// :98-101; window > 0): each row attends only keys within `window` of its
// own position.
//
// Bound on the H100: bytes. Each sequence's live K and V rows
// (2*kv_len*kvN*D elements, plus 2*kv_len*kvN f32 scales for INT8 KV)
// are read once for ~4*kv_len*N*S*D operations: about S operations per
// byte (2S for int8), far below the card's balance point for S <= 8.
//
// Design: one block per (sequence, kv head), holding that head's
// `group` x S query rows (row r = window row r / group, head r % group),
// so every K/V row of the sequence is read from device memory once and
// serves all the query heads of its GQA group and every row of the verify
// window: a verify step moves the KV bytes of one decode step, which is
// the point of the TPU design (paged_decode.py:146-150). The block reads
// its page ids from the table itself and walks the live keys
// 0 .. min(kv_len, MP*ps)-1 in chunks of 32 keys staged through shared
// memory in f32; pages past kv_len are never read. Window row s attends
// keys k_pos < kv_len - S + 1 + s (in-window causal; S = 1 is k_pos <
// kv_len). Scores and the running max/sum/accumulator stay in f32; a
// masked key contributes p = 0, so a row with no key at all (kv_len <= 0,
// or kv_len < S - s) gives a zero output. An unmapped (-1) page inside
// kv_len (the dead rows of a decode burst, whose tables are all -1) reads
// as zeros, as the plain version's gather does, and never touches memory
// outside the pool. INT8 KV dequantizes late, as the TPU kernel does
// (paged_decode.py:84-89, :116-120): the codes are staged as exact floats,
// each key's scale (staged beside its chunk) multiplies its score after
// q.k, and each key's V scale folds into its probability before the PV
// product, so the row sum l stays the sum of the unscaled probabilities.
// Sliding window: the key walk starts at the oldest verify row's first key,
// k_lo = kv_len - S - window + 1, and reads no key below it, not even
// inside k_lo's page. This is what keeps the grouped engine's ring pools
// right: there table column j maps to ring page s*R + j % R, so a column
// below the window band aliases the live page of a newer position, and
// masking after the read would still fetch it. Rows newer than the oldest
// mask the keys below their own band per element (p = 0).
// Shared memory grows with group x S: 64 rows at D = 128 (GQA group 8,
// S = 8) take 107.6 KB of the 227 KB a block may use; the wrapper refuses
// more than 128 rows. Split-K over the sequence (flash-decoding) and TMA
// page copies are later work.
#include "common.cuh"

namespace {

constexpr int KC = 32;   // keys per chunk (one per lane)
constexpr int NT = 128;  // threads per block
constexpr float NEG_INF = -1e30f;

template <int D>
size_t smem_floats(int rows) {
  return (size_t)rows * D           // q rows
         + (size_t)KC * (D + 1)     // K chunk (padded: lane = key)
         + (size_t)KC * D           // V chunk
         + (size_t)rows * KC        // probabilities
         + (size_t)rows * D         // accumulator
         + 3 * (size_t)rows         // max, sum, rescale
         + 2 * (size_t)KC;          // INT8 KV: K and V scales of the chunk
}

// q: [B, S, N, D] with batch stride q_bs and window stride q_ss (elements;
// S = wins); pools [L, P+1, kvN, ps, D] of P (T, or int8_t with the scale
// pools ksp/vsp [L, P+1, kvN, ps]); out: [B, S, N, D] contiguous. DENSE:
// the pools are a dense arena [L, B', kvN, Smax, D] (num_pages1 = B',
// ps = Smax, mp = 1, no table): sequence b reads arena row b.
template <typename T, typename P, int D, bool DENSE>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, long long q_bs, long long q_ss,
    const P* __restrict__ pool_k, const P* __restrict__ pool_v,
    const float* __restrict__ ksp, const float* __restrict__ vsp,
    const int* __restrict__ tables, const int* __restrict__ kv_lens,
    T* __restrict__ out, int layer, int num_pages1, int kvn, int ps, int mp,
    int group, int wins, int window, float scale) {
  constexpr bool QUANT = sizeof(P) == 1;
  const int rows = group * wins;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + rows * D;
  float* vs = ks + KC * (D + 1);
  float* pr = vs + KC * D;
  float* acc = pr + rows * KC;
  float* ms = acc + rows * D;
  float* ls = ms + rows;
  float* al = ls + rows;
  float* ksc = al + rows;  // [KC] (INT8 KV)
  float* vsc = ksc + KC;   // [KC]

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h0 = g * group;

  const T* qb = q + (long long)b * q_bs + (long long)h0 * D;
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D;
    const int w = r / group;
    qs[i] = sli::to_f(qb[w * q_ss + (long long)(r - w * group) * D + i % D]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < rows; i += NT) {
    ms[i] = NEG_INF;
    ls[i] = 0.f;
  }
  const int kv_len = kv_lens[b];
  const int n_keys = min(kv_len, mp * ps);
  // window: no key below the oldest row's band is ever read
  const int k_lo = window > 0 ? max(0, kv_len - wins - window + 1) : 0;
  const int* row = DENSE ? nullptr : tables + (long long)b * mp;
  const long long layer_base = (long long)layer * num_pages1;
  __syncthreads();

  for (int k0 = k_lo; k0 < n_keys; k0 += KC) {
    for (int i = tid; i < KC * D; i += NT) {
      const int r = i / D;
      const int d = i - r * D;
      const int kp = k0 + r;
      float kv = 0.f;
      float vv = 0.f;
      if (kp < n_keys) {
        const int page = DENSE ? b : row[kp / ps];
        if (page >= 0) {
          const long long off =
              (((layer_base + page) * kvn + g) * ps + kp % ps) * (long long)D +
              d;
          kv = sli::to_f(pool_k[off]);
          vv = sli::to_f(pool_v[off]);
        }
      }
      ks[r * (D + 1) + d] = kv;
      vs[r * D + d] = vv;
    }
    if (QUANT && tid < KC) {
      const int kp = k0 + tid;
      float a = 0.f;
      float c = 0.f;
      if (kp < n_keys) {
        const int page = DENSE ? b : row[kp / ps];
        if (page >= 0) {
          const long long so = ((layer_base + page) * kvn + g) * ps + kp % ps;
          a = ksp[so];
          c = vsp[so];
        }
      }
      ksc[tid] = a;
      vsc[tid] = c;
    }
    __syncthreads();

    // scores: warp w takes query rows w, w+4, ...; lane = key of the chunk;
    // window row w = r / group sees keys below kv_len - wins + 1 + w and,
    // with a sliding window, above kv_len - wins + w - window
    for (int r = warp; r < rows; r += NT / 32) {
      const float m_old = ms[r];
      const int w = r / group;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s += qs[r * D + d] * ks[lane * (D + 1) + d];
      s *= scale;
      if (QUANT) s *= ksc[lane];  // late dequant of K
      const int kp = k0 + lane;
      const bool live = kp < n_keys && kp < kv_len - wins + 1 + w &&
                        (window <= 0 || kp > kv_len - wins + w - window);
      if (!live) s = NEG_INF;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float p = live ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      pr[r * KC + lane] = QUANT ? p * vsc[lane] : p;  // V scale folded in
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        al[r] = a;
        ls[r] = ls[r] * a + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // PV: thread d owns output column d of every query row
    for (int d = tid; d < D; d += NT) {
      for (int r = 0; r < rows; ++r) {
        float a = acc[r * D + d] * al[r];
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) a += pr[r * KC + kk] * vs[kk * D + d];
        acc[r * D + d] = a;
      }
    }
    __syncthreads();
  }

  const int n = kvn * group;
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D;
    const int w = r / group;
    const long long o =
        (((long long)b * wins + w) * n + h0 + (r - w * group)) * D + i % D;
    out[o] = sli::from_f<T>(acc[i] / fmaxf(ls[r], 1e-30f));
  }
}

// The kernel's arguments past the head dim, dtype and stream.
struct Args {
  const void* q;
  long long q_bs, q_ss;
  const void* pool_k;
  const void* pool_v;
  const float* ksp;
  const float* vsp;
  const int* tables;
  const int* kv_lens;
  void* out;
  int batch, layer, num_pages1, kvn, ps, mp, group, wins, window;
  float scale;
};

template <typename T, typename P, int D, bool DENSE>
int launch(const Args& a, cudaStream_t st) {
  const size_t bytes = smem_floats<D>(a.group * a.wins) * sizeof(float);
  cudaError_t e =
      sli::allow_smem(paged_decode_kernel<T, P, D, DENSE>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.batch, a.kvn);
  paged_decode_kernel<T, P, D, DENSE><<<grid, NT, bytes, st>>>(
      (const T*)a.q, a.q_bs, a.q_ss, (const P*)a.pool_k, (const P*)a.pool_v,
      a.ksp, a.vsp, a.tables, a.kv_lens, (T*)a.out, a.layer, a.num_pages1,
      a.kvn, a.ps, a.mp, a.group, a.wins, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename P, bool DENSE = false>
int dispatch_d(int head_dim, const Args& a, cudaStream_t st) {
  switch (head_dim) {
    case 32:
      return launch<T, P, 32, DENSE>(a, st);
    case 64:
      return launch<T, P, 64, DENSE>(a, st);
    case 128:
      return launch<T, P, 128, DENSE>(a, st);
    default:
      return SLI_ERR_HEAD_DIM;
  }
}

}  // namespace

// Dense-arena decode (the flash_decode entry): q [B, N, D] at batch stride
// q_bs (elements); cache_k/v the dense arena [L, arena_rows, kvn, smax, D]
// of q's dtype, sequence b < batch <= arena_rows reading arena row b's
// slots [0, min(kv_len, smax)); out [B, N, D] contiguous.
extern "C" int sli_flash_decode(const void* q, long long q_bs,
                                const void* cache_k, const void* cache_v,
                                const int* kv_lens, void* out, int batch,
                                int layer, int arena_rows, int kvn, int smax,
                                int group, int head_dim, float scale,
                                int dtype, void* stream) {
  if (batch <= 0 || kvn <= 0 || group <= 0 || smax <= 0 ||
      batch > arena_rows)
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  // one "page" of smax slots per sequence, one window row, no scales
  const Args a{q, q_bs, 0LL, cache_k, cache_v, nullptr, nullptr, nullptr,
               kv_lens, out, batch, layer, arena_rows, kvn, smax, 1, group,
               1, 0, scale};
  if (dtype == SLI_F32) return dispatch_d<float, float, true>(head_dim, a, st);
  if (dtype == SLI_BF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16, true>(head_dim, a, st);
  return SLI_ERR_DTYPE;
}

// k_scale/v_scale: null for bf16/f32 pools (of q's dtype); given, the pools
// are int8 and these are their f32 scale pools [L, num_pages1, kvn, ps].
// q: [B, wins, N, D] with strides q_bs, q_ss (elements); wins = 1 is decode.
// window: 0 for none, else the sliding window (>= 1).
extern "C" int sli_paged_flash_decode(const void* q, long long q_bs,
                                      long long q_ss, const void* pool_k,
                                      const void* pool_v, const void* k_scale,
                                      const void* v_scale, const int* tables,
                                      const int* kv_lens, void* out,
                                      int batch, int layer, int num_pages1,
                                      int kvn, int ps, int mp, int group,
                                      int wins, int head_dim, int window,
                                      float scale, int dtype, void* stream) {
  if (batch <= 0 || kvn <= 0 || group <= 0 || ps <= 0 || mp <= 0 ||
      wins <= 0 || window < 0)
    return SLI_ERR_SHAPE;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{q, q_bs, q_ss, pool_k, pool_v, (const float*)k_scale,
               (const float*)v_scale, tables, kv_lens, out, batch, layer,
               num_pages1, kvn, ps, mp, group, wins, window, scale};
  const bool quant = k_scale != nullptr;
  if (dtype == SLI_F32)
    return quant ? dispatch_d<float, int8_t>(head_dim, a, st)
                 : dispatch_d<float, float>(head_dim, a, st);
  if (dtype == SLI_BF16)
    return quant ? dispatch_d<__nv_bfloat16, int8_t>(head_dim, a, st)
                 : dispatch_d<__nv_bfloat16, __nv_bfloat16>(head_dim, a, st);
  return SLI_ERR_DTYPE;
}
