// Dense decode attention with the key loop inside the kernel: one query row
// per sequence against slots [0, kv_len) of the dense KV arena, online
// softmax, key/value tiles streamed through a two-stage cp.async pipeline.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/attention/
// flash_decode_dyn.py: flash_decode_dyn (_dyn_kernel, flash_decode_dyn.py:
// 40-102; wrapper :105). Like the TPU kernel it is an operation of its
// own: the JAX package dispatches flash_decode (kernel 13) instead
// (flash_decode_dyn.py:16-21), and so does the port.
//
// Bound on the H100: bytes. Each sequence's live K and V rows
// (2 * kv_len * kvN * D elements) are read once for 4 * kv_len * N * D
// operations: about group / 2 operations per byte in bf16, far below the
// card's balance point.
//
// Design: the TPU kernel's grid is (batch, head block of hb kv heads); its
// body loops ceil(kv_len / bk) times over the live keys only, with
// two-slot manual DMA of hb x bk x D K and V tiles. At Llama-2-7B's hb = 8
// and bk = 256 that buffer (2 slots x K and V x 8 x 256 x 128 bf16) is 2
// MB, far past the 227 KB of shared memory a block may use. Here a block
// takes one (sequence, kv head) and its GQA group's query rows, so the
// grid is (B, kvN) with more blocks in flight, and walks the live keys in
// tiles of BK = 32: while the block computes on tile i, cp.async copies
// tile i + 1 into the other stage (K and V, 16 bytes a thread and copy,
// rows padded by 16 bytes so that the score loop's 16-byte reads of eight
// neighbouring keys hit distinct banks); keys past kv_len are zero-filled
// by the copy itself and masked. Scores, the running max and sum and the
// accumulator stay in f32: warp w scores query rows w, w + 4, ... with
// lane = key; thread d accumulates output column d. bk, the TPU's tile
// length, is taken and does not change the result. kv_len <= 0 gives a
// zero row (no tile, sum 0), as on the TPU.
#include "common.cuh"

namespace {

constexpr int BK = 32;   // keys per tile (one per lane)
constexpr int NT = 128;  // threads per block
constexpr float NEG_INF = -1e30f;

template <typename T, int D>
struct Geo {
  static constexpr int ROWB = D * (int)sizeof(T) + 16;  // padded row bytes
  static constexpr int TILE = BK * ROWB;                // one K or V tile
  static constexpr int CHUNKS = D * (int)sizeof(T) / 16;
  static size_t bytes(int rows) {
    return 4 * (size_t)TILE +
           sizeof(float) * ((size_t)2 * rows * D + (size_t)rows * BK +
                            3 * (size_t)rows);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// 16 bytes of a row -> 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void unpack16(const unsigned char* p, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(const unsigned char* p,
                                                float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(
    const unsigned char* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// q: [B, N, D] at batch stride q_bs; caches [L, arena_rows, kvn, smax, D]
// (contiguous, 16-byte aligned); out [B, N, D] contiguous. Sequence b
// reads arena row b.
template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_dyn_kernel(
    const T* __restrict__ q, long long q_bs, const T* __restrict__ ck,
    const T* __restrict__ cv, const int* __restrict__ kv_lens,
    T* __restrict__ out, int layer, int arena_rows, int kvn, int smax,
    int group, float scale) {
  using G = Geo<T, D>;
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;  // [2][K, V][BK][ROWB]
  float* qs = reinterpret_cast<float*>(smem + 4 * G::TILE);
  const int rows = group;
  float* acc = qs + rows * D;
  float* pr = acc + rows * D;
  float* ms = pr + rows * BK;
  float* ls = ms + rows;
  float* al = ls + rows;

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h0 = g * group;
  const T* qb = q + (long long)b * q_bs + (long long)h0 * D;
  for (int i = tid; i < rows * D; i += NT) {
    qs[i] = sli::to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < rows; i += NT) {
    ms[i] = NEG_INF;
    ls[i] = 0.f;
  }
  const int n_keys = max(0, min(kv_lens[b], smax));
  const int nblk = (n_keys + BK - 1) / BK;
  const long long head = ((long long)layer * arena_rows + b) * kvn + g;
  const T* kh = ck + head * smax * D;
  const T* vh = cv + head * smax * D;

  // tile `blk` into stage `st`: BK rows x CHUNKS 16-byte copies, K and V
  auto load = [&](int blk, int st) {
    unsigned char* kd = stage + (2 * st) * G::TILE;
    unsigned char* vd = kd + G::TILE;
    for (int i = tid; i < BK * G::CHUNKS; i += NT) {
      const int r = i / G::CHUNKS;
      const int c = i - r * G::CHUNKS;
      const int kp = blk * BK + r;
      const bool ok = kp < n_keys;
      const long long off = (long long)(ok ? kp : 0) * D + c * EPC;
      cp_async16(kd + r * G::ROWB + c * 16, kh + off, ok);
      cp_async16(vd + r * G::ROWB + c * 16, vh + off, ok);
    }
  };

  if (nblk > 0) load(0, 0);
  cp_async_commit();
  for (int i = 0; i < nblk; ++i) {
    if (i + 1 < nblk) load(i + 1, (i + 1) & 1);
    cp_async_commit();  // possibly empty: keeps one group in flight
    cp_async_wait_one();  // tile i has landed
    __syncthreads();
    const unsigned char* ks = stage + (2 * (i & 1)) * G::TILE;
    const unsigned char* vs = ks + G::TILE;
    const int k0 = i * BK;

    // scores: warp w takes query rows w, w+4, ...; lane = key of the tile
    for (int r = warp; r < rows; r += NT / 32) {
      const float m_old = ms[r];
      const unsigned char* krow = ks + lane * G::ROWB;
      float s = 0.f;
#pragma unroll 4
      for (int c = 0; c < G::CHUNKS; ++c) {
        float f[EPC];
        unpack16<T>(krow + c * 16, f);
#pragma unroll
        for (int e = 0; e < EPC; ++e) s += qs[r * D + c * EPC + e] * f[e];
      }
      const bool live = k0 + lane < n_keys;
      s = live ? s * scale : NEG_INF;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_old, mx);
      const float p = live ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      pr[r * BK + lane] = p;
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
        for (int kk = 0; kk < BK; ++kk)
          a += pr[r * BK + kk] *
               sli::to_f(reinterpret_cast<const T*>(vs + kk * G::ROWB)[d]);
        acc[r * D + d] = a;
      }
    }
    __syncthreads();  // stage i & 1 is refilled by the next iteration
  }

  T* ob = out + ((long long)b * kvn * group + h0) * D;
  for (int i = tid; i < rows * D; i += NT)
    ob[i] = sli::from_f<T>(acc[i] / fmaxf(ls[i / D], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, long long q_bs, const void* ck, const void* cv,
           const int* kv_lens, void* out, int batch, int layer,
           int arena_rows, int kvn, int smax, int group, float scale,
           cudaStream_t st) {
  const size_t bytes = Geo<T, D>::bytes(group);
  if (bytes > 227 * 1024) return SLI_ERR_SHAPE;
  cudaError_t e = sli::allow_smem(decode_dyn_kernel<T, D>, bytes);
  if (e != cudaSuccess) return (int)e;
  decode_dyn_kernel<T, D><<<dim3(batch, kvn), NT, bytes, st>>>(
      (const T*)q, q_bs, (const T*)ck, (const T*)cv, kv_lens, (T*)out, layer,
      arena_rows, kvn, smax, group, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int head_dim, const void* q, long long q_bs, const void* ck,
               const void* cv, const int* kv_lens, void* out, int batch,
               int layer, int arena_rows, int kvn, int smax, int group,
               float scale, cudaStream_t st) {
  switch (head_dim) {
    case 128:
      return launch<T, 128>(q, q_bs, ck, cv, kv_lens, out, batch, layer,
                            arena_rows, kvn, smax, group, scale, st);
    case 256:
      return launch<T, 256>(q, q_bs, ck, cv, kv_lens, out, batch, layer,
                            arena_rows, kvn, smax, group, scale, st);
    default:
      return SLI_ERR_HEAD_DIM;
  }
}

}  // namespace

// q: [B, N, D] at batch stride q_bs (elements; heads contiguous); cache_k/v:
// the dense arena [L, arena_rows, kvn, smax, D] of q's dtype, contiguous and
// 16-byte aligned, sequence b < batch <= arena_rows reading arena row b's
// slots [0, min(kv_len, smax)); out [B, N, D] contiguous. D: 128 or 256.
extern "C" int sli_flash_decode_dyn(const void* q, long long q_bs,
                                    const void* cache_k, const void* cache_v,
                                    const int* kv_lens, void* out, int batch,
                                    int layer, int arena_rows, int kvn,
                                    int smax, int group, int head_dim,
                                    float scale, int dtype, void* stream) {
  if (batch <= 0 || kvn <= 0 || group <= 0 || smax <= 0 ||
      batch > arena_rows)
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == SLI_F32)
    return dispatch_d<float>(head_dim, q, q_bs, cache_k, cache_v, kv_lens,
                             out, batch, layer, arena_rows, kvn, smax, group,
                             scale, st);
  if (dtype == SLI_BF16)
    return dispatch_d<__nv_bfloat16>(head_dim, q, q_bs, cache_k, cache_v,
                                     kv_lens, out, batch, layer, arena_rows,
                                     kvn, smax, group, scale, st);
  return SLI_ERR_DTYPE;
}
