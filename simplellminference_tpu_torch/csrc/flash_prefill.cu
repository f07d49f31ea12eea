// Causal GQA flash attention over a prompt (prefill), online softmax.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/attention/
// flash_prefill.py: flash_prefill (_flash_kernel, flash_prefill.py:26-100,
// wrapper :102), with its sliding-window form (window > 0: query i attends
// keys with q_pos - k_pos < window, flash_prefill.py:76-77): forms 3, 3w;
// and Gemma-2's soft cap of both (cap > 0: each live score becomes
// cap * tanh(s * scale * (1 / cap)) before the mask, flash_prefill.py:
// 67-68): forms 3c, 3wc, a template flag of each kernel (the uncapped
// forms are compiled as before); and GPT-OSS's attention sinks of both
// (sinks != nullptr: each q head's f32 logit joins every row's softmax
// denominator and adds no value, flash_prefill.py:29-43): forms 3s, 3ws,
// a pointer and not a template flag (one uniform branch where a row's
// softmax state is seeded, no further instantiation).
//
// Bound on the H100: for the serving shapes (S = 128..2048) bytes: q and
// k, v read once and the output written once, (2*N + 2*kvN)*B*S*D
// elements, against 2*B*N*D*S*(S+1) causal multiply-add operations, which
// stay below the card's ops-per-byte balance point until S is a few
// thousand.
//
// Design, bf16: prefill_mma.cuh, on the tensor cores. One warpgroup a
// block and a 64-row query tile that packs 64 / group positions x the
// group's q heads of one kv head, so each K/V tile is read once for the
// whole GQA group; K/V rows (strided views taken as they are, 16-byte
// aligned) through a two-stage cp.async ring; S = QK^T and O += PV on
// wgmma with P split hi + lo in bf16, the f32 online softmax on the
// fragments. The walk runs from key 0, or with a window from the tile's
// oldest row's first key q0 - (window - 1) (flash_prefill.py:50-53,
// :154-157; cost O(S * window)), up to the tile's newest position; rows
// past S are zero-filled by the copy and masked. Every S is taken (the
// TPU dispatcher sends S % 128 != 0 to the jnp reference instead). When
// the tiles alone leave fewer than two blocks an SM, the key walk is split
// over blocks (from shapes alone) and merged by log-sum-exp.
//
// Head dims 32, 64, 128 and 256 (Gemma) for every form: D 256's register
// and shared-memory budget is prefill_mma.cuh's note; the f32 FMA kernel's
// tiles at D 256 take 213,760 bytes of shared memory.
//
// Design, f32: the first, FMA kernel below (TF32 tensor cores would not
// hold f32's tolerance): one block per (q tile of 64 rows, q head,
// batch); K/V tiles of 64 rows staged through shared memory in f32, a
// 4 x 4 micro-tile per thread for QK^T and 4 rows x D/16 columns for PV,
// the same walk, a key outside its row's band masked per element; with
// CAP the live scores capped by tanhf (prefill_mma.cuh's note). Sinks
// seed each row's state with (m, l) = (its head's sink, 1), as the TPU
// kernel does (flash_prefill.py:37-43): the sink is a raw logit, neither
// scaled nor capped, so a masked key (p = 0) and a row that meets no key
// (acc 0 / l 1 = 0) keep their outputs.
#include "common.cuh"
#include "prefill_mma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1);
}

// Element strides: *_bs between batch rows, *_ss between sequence rows;
// the [heads, D] part of each row is contiguous.
template <typename T, int D, bool CAP>
__global__ void __launch_bounds__(NT) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, long long q_bs,
    long long q_ss, long long k_bs, long long k_ss, long long v_bs,
    long long v_ss, long long o_bs, long long o_ss, int seq, int group,
    int window, float scale, float cap, const float* __restrict__ sinks) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D+1]
  float* ks = qs + BQ * (D + 1);     // [BK][D+1]
  float* vs = ks + BK * (D + 1);     // [BK][D]
  float* ps = vs + BK * D;           // [BQ][BK+1]
  constexpr int CPT = D / 16;        // output columns per thread

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // cols tx + 16*j
  const int q0 = qt * BQ;

  const T* qb = q + (long long)b * q_bs + (long long)h * D;
  const T* kb = k + (long long)b * k_bs + (long long)kh * D;
  const T* vb = v + (long long)b * v_bs + (long long)kh * D;

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

  const int last_q = min(q0 + BQ, seq) - 1;
  const int nkt = last_q / BK + 1;  // tiles .. causal frontier
  // window: from the tile of the oldest row's first key
  const int kt0 = window > 0 ? max(0, q0 - (window - 1)) / BK : 0;
  for (int kt = kt0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D;
      const int d = i - r * D;
      const int s = k0 + r;
      float kv = 0.f;
      float vv = 0.f;
      if (s < seq) {
        kv = sli::to_f(kb[(long long)s * k_ss + d]);
        vv = sli::to_f(vb[(long long)s * v_ss + d]);
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
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if constexpr (CAP) s = cap * tanhf(s * (1.f / cap));
        if (kp > qp || kp >= seq || (window > 0 && kp <= qp - window))
          s = NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      // the 16 threads sharing ty hold the tile's 64 columns of row i
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
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
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha[i];
    const int kmax = min(BK, seq - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

  T* ob = out + (long long)b * o_bs + (long long)h * D;
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

template <typename T, int D, bool CAP>
int launch(const void* q, const void* k, const void* v, void* out,
           long long q_bs, long long q_ss, long long k_bs, long long k_ss,
           long long v_bs, long long v_ss, long long o_bs, long long o_ss,
           int batch, int seq, int heads, int group, int window, float scale,
           float cap, const float* sinks, cudaStream_t st) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t e = sli::allow_smem(flash_prefill_kernel<T, D, CAP>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  flash_prefill_kernel<T, D, CAP><<<grid, NT, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, q_bs, q_ss, k_bs, k_ss,
      v_bs, v_ss, o_bs, o_ss, seq, group, window, scale, cap, sinks);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_c(const void* q, const void* k, const void* v, void* out,
             long long q_bs, long long q_ss, long long k_bs, long long k_ss,
             long long v_bs, long long v_ss, long long o_bs, long long o_ss,
             int batch, int seq, int heads, int group, int window,
             float scale, float cap, const float* sinks, cudaStream_t st) {
  if (cap > 0.f)
    return launch<T, D, true>(q, k, v, out, q_bs, q_ss, k_bs, k_ss, v_bs,
                              v_ss, o_bs, o_ss, batch, seq, heads, group,
                              window, scale, cap, sinks, st);
  return launch<T, D, false>(q, k, v, out, q_bs, q_ss, k_bs, k_ss, v_bs,
                             v_ss, o_bs, o_ss, batch, seq, heads, group,
                             window, scale, cap, sinks, st);
}

template <typename T>
int dispatch_d(int head_dim, const void* q, const void* k, const void* v,
               void* out, long long q_bs, long long q_ss, long long k_bs,
               long long k_ss, long long v_bs, long long v_ss, long long o_bs,
               long long o_ss, int batch, int seq, int heads, int group,
               int window, float scale, float cap, const float* sinks,
               cudaStream_t st) {
#define SLI_FP_CASE(DD)                                                      \
  case DD:                                                                   \
    return launch_c<T, DD>(q, k, v, out, q_bs, q_ss, k_bs, k_ss, v_bs, v_ss, \
                           o_bs, o_ss, batch, seq, heads, group, window,     \
                           scale, cap, sinks, st);
  switch (head_dim) {
    SLI_FP_CASE(32)
    SLI_FP_CASE(64)
    SLI_FP_CASE(128)
    SLI_FP_CASE(256)
    default:
      return SLI_ERR_HEAD_DIM;
  }
#undef SLI_FP_CASE
}

// The K/V rows of one sequence and kv head of dense [B, S, kvN, D]
// arrays for pfa::attend: key kp is row kp (no pages, no lookups).
struct DenseRows {
  const __nv_bfloat16* kb;  // k + b * k_bs + kh * D
  const __nv_bfloat16* vb;
  long long k_ss, v_ss;
  struct Cursor {
    int kp;
  };
  __device__ Cursor cursor(int kp) const { return {kp}; }
  __device__ void advance(Cursor& c) const { c.kp += sli::pfa::TILE; }
  __device__ int page(const Cursor&) const { return 0; }
  __device__ long long row(const Cursor& c, int) const { return c.kp; }
  __device__ const void* k(long long r) const { return kb + r * k_ss; }
  __device__ const void* v(long long r) const { return vb + r * v_ss; }
};

// bf16 q [B, S, N, D], k/v [B, S, kvN, D] (element strides, heads
// contiguous, 16-byte aligned rows); out [B, S, N, D] contiguous, or the
// split partials in work.
template <int D, bool CAP>
__global__ void __launch_bounds__(sli::pfa::NT) flash_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ work, long long q_bs, long long q_ss, long long k_bs,
    long long k_ss, long long v_bs, long long v_ss, int batch, int seq,
    int heads, int group, int window, sli::pfa::Score sc, int splits,
    const float* __restrict__ sinks) {
  const int b = blockIdx.z / splits;
  const long long kh = blockIdx.y;
  const DenseRows src{k + b * k_bs + kh * D, v + b * v_bs + kh * D, k_ss,
                      v_ss};
  sli::pfa::attend<D, sli::pfa::KV_BF16, CAP>(
      q + b * q_bs, q_ss, src, out + (long long)b * seq * heads * D, work,
      batch, b, seq, heads, group, 0, seq, window, sc, splits, sinks);
}

template <int D, bool CAP>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* work, long long q_bs, long long q_ss, long long k_bs,
               long long k_ss, long long v_bs, long long v_ss, int batch,
               int seq, int heads, int group, int window, float scale,
               float cap, int splits, const float* sinks, cudaStream_t st) {
  namespace pfa = sli::pfa;
  constexpr int bytes = pfa::Smem<D, pfa::KV_BF16>::BYTES;
  auto kern = flash_prefill_mma_kernel<D, CAP>;
  cudaError_t e = sli::allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  const int h = min(group, pfa::TILE);
  const int tiles = (seq + pfa::TILE / h - 1) / (pfa::TILE / h) *
                    ((group + h - 1) / h);
  const dim3 grid(tiles, heads / group, batch * splits);
  kern<<<grid, pfa::NT, bytes, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, work, q_bs, q_ss, k_bs,
      k_ss, v_bs, v_ss, batch, seq, heads, group, window,
      pfa::make_score(scale, cap), splits, sinks);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)sli::launch_merge<__nv_bfloat16>(
      work, out, (long long)batch * seq * heads, D, splits, st);
}

int dispatch_mma(int head_dim, const void* q, const void* k, const void* v,
                 void* out, float* work, long long q_bs, long long q_ss,
                 long long k_bs, long long k_ss, long long v_bs,
                 long long v_ss, int batch, int seq, int heads, int group,
                 int window, float scale, float cap, int splits,
                 const float* sinks, cudaStream_t st) {
#define SLI_FP_CASE(DD)                                                       \
  case DD:                                                                    \
    return cap > 0.f                                                          \
               ? launch_mma<DD, true>(q, k, v, out, work, q_bs, q_ss, k_bs,   \
                                      k_ss, v_bs, v_ss, batch, seq, heads,    \
                                      group, window, scale, cap, splits,      \
                                      sinks, st)                              \
               : launch_mma<DD, false>(q, k, v, out, work, q_bs, q_ss, k_bs,  \
                                       k_ss, v_bs, v_ss, batch, seq, heads,   \
                                       group, window, scale, cap, splits,     \
                                       sinks, st);
  switch (head_dim) {
    SLI_FP_CASE(32)
    SLI_FP_CASE(64)
    SLI_FP_CASE(128)
    SLI_FP_CASE(256)
    default:
      return SLI_ERR_HEAD_DIM;
  }
#undef SLI_FP_CASE
}

}  // namespace

// window: 0 for plain causal attention, else the sliding window (>= 1);
// cap: 0 for none, else the soft cap (> 0); sinks: null for none, else
// the layer's f32 sink logits [heads]. bf16 takes the tensor-core
// kernel: q, k, v rows 16-byte aligned (base pointers and strides), out
// contiguous, and with splits > 1, work holds splits * batch * seq *
// heads * (head_dim + 2) floats. f32 takes the FMA kernel (splits 1).
extern "C" int sli_flash_prefill(const void* q, const void* k, const void* v,
                                 void* out, long long q_bs, long long q_ss,
                                 long long k_bs, long long k_ss,
                                 long long v_bs, long long v_ss,
                                 long long o_bs, long long o_ss, int batch,
                                 int seq, int heads, int group, int head_dim,
                                 int window, float scale, float cap,
                                 int dtype, void* work, int splits,
                                 const float* sinks, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || group <= 0 || window < 0 ||
      cap < 0.f || heads % group || splits < 1 ||
      (splits > 1 && work == nullptr))
    return SLI_ERR_SHAPE;
  if (sinks != nullptr && head_dim > 128) return SLI_ERR_HEAD_DIM;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == SLI_F32) {
    if (splits != 1) return SLI_ERR_SHAPE;
    return dispatch_d<float>(head_dim, q, k, v, out, q_bs, q_ss, k_bs, k_ss,
                             v_bs, v_ss, o_bs, o_ss, batch, seq, heads, group,
                             window, scale, cap, sinks, st);
  }
  if (dtype == SLI_BF16) {
    const long long hd = (long long)heads * head_dim;
    if (((unsigned long long)q | (unsigned long long)k |
         (unsigned long long)v | (unsigned long long)out) % 16 ||
        (q_bs | q_ss | k_bs | k_ss | v_bs | v_ss) % 8 || o_ss != hd ||
        o_bs != seq * hd)
      return SLI_ERR_SHAPE;
    return dispatch_mma(head_dim, q, k, v, out, (float*)work, q_bs, q_ss,
                        k_bs, k_ss, v_bs, v_ss, batch, seq, heads, group,
                        window, scale, cap, splits, sinks, st);
  }
  return SLI_ERR_DTYPE;
}
