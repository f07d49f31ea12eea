// In-place paged KV writes: one decode row per sequence, T <= 8 consecutive
// rows per sequence (a speculative verify span), and whole prompt pages at
// prefill; and the same row copy into the dense KV arena.
//
// Replaces the TPU kernels of simplellminference_tpu/ops/paged_append.py:
//   paged_append_decode  (_decode_kernel,  paged_append.py:34-113)
//   paged_append_prefill (_prefill_kernel, paged_append.py:116-189)
//   paged_append_span    (_span_kernel,    paged_append.py:368-479)
// and of simplellminference_tpu/ops/kv_append.py:
//   kv_append            (_append_kernel,  kv_append.py:37-116)
//
// kv_append writes S rows per sequence into the dense arena [L, B', kvN,
// Smax, D] at a per-sequence offset (the Generator's prefill, S = bucket,
// and decode, S = 1). The TPU kernel read-modify-writes 8-row windows
// (kv_append.py:10-18), hence its rule that offsets be multiples of 8 when
// S > 1; here a block stores only the row it owns, so any offset works,
// and a row whose slot falls outside the arena is dropped (the JAX jnp
// fallback clamps the start instead; no caller reaches that case).
//
// Bound on the H100: bytes. The kernels only copy (decode: 2*B*kvN*D
// elements; span and kv_append: 2*B*T*kvN*D; prefill:
// 2*B*ceil(S/ps)*kvN*ps*D), so the
// least time is those bytes read once and written once at the card's
// memory rate.
//
// Design against that bound: every thread moves 16-byte vectors (a row of
// D=128 bf16 is 16 of them), neighbouring threads take neighbouring
// addresses, and the pools are written in place: nothing else is read or
// written. The TPU kernels' 8-row read-modify-write windows (a Pallas out
// block always writes back, paged_append.py:18-19; the span kernel's two
// windows, :404-407, :426-432) are gone: a CUDA block stores exactly the
// row it owns, so a span that crosses a page boundary needs nothing
// special (row t finds its own page, tables[b, (pos + t) / ps]). Decode is
// the span kernel with T = 1. Unmapped (-1) table entries, and columns
// past the table, still go to the trash page (the pool's last page row),
// as on the TPU, so the plain version and the kernel agree on every page
// but that one. Prefill rows past the prompt (the tail of the last page)
// are written as zeros, like the JAX pad.
//
// FP8 (e4m3) KV pools, forms 1e, 2e and 11e (the same TPU kernels over
// float8_e4m3fn pools: the rows are cast to the pool dtype at
// paged_append.py:45, :49, :74, :148-151): each thread reads 8 elements of
// a bf16 or f32 row (16 or 32 bytes), converts them in registers with the
// JAX package's rounding (common.cuh f_to_e4m3: nearest even, NaN past
// 464), and stores 8 code bytes; the cast is the row's own dtype -> e4m3,
// never a torch cast in the wrapper, so bf16 rows round once from bf16 as
// the JAX cast does. Page, slot and trash-page rules are the copies'.
// Every head dim a multiple of 8 takes the 8-element path (Gemma's 256
// too: a row is 32 such groups, a block's threads stride over them).
// Bound: bytes (the rows read in their dtype, 1 byte an element written).
//
// FP8 (e4m3) on the dense arena, form 12e (kv_append into a float8_e4m3fn
// arena: the TPU kernel casts the new rows to the arena dtype,
// kv_append.py:49-58, :78-79): the rows kernel of 1e and 11e with the
// dense addressing of kv_append's copy (one page of Smax slots a sequence,
// row b into arena row b, a slot outside [0, Smax) dropped), the same
// conversion in registers; S rows a sequence (the prefill's bucket, or 1
// at decode) are S blocks a (sequence, kv head).
#include "common.cuh"

namespace {

template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ uint4 vzero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ unsigned short vzero<unsigned short>() {
  return 0;
}

// grid (B, T, kvN); the block copies row (b, t, h) of new K and new V into
// pool[layer, page, h, slot, :] at position positions[b] + t (a negative
// position goes to slot 0 of the trash page). Strides and row_bytes are in
// bytes. DENSE: the pool is a dense arena [L, B', kvN, Smax, D] (one page
// of ps = Smax slots per sequence, num_pages1 = B' >= B rows, no table):
// row b writes arena row b at slot positions[b] + t, and a slot outside
// [0, Smax) is dropped, never written outside the arena.
template <typename V, bool DENSE>
__global__ void paged_append_rows_kernel(
    char* __restrict__ pool_k, char* __restrict__ pool_v,
    const char* __restrict__ new_k, const char* __restrict__ new_v,
    long long k_bstride, long long k_tstride, long long v_bstride,
    long long v_tstride, const int* __restrict__ tables,
    const int* __restrict__ positions, int layer, int num_pages1, int kvn,
    int ps, int row_bytes, int mp) {
  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int h = blockIdx.z;
  const int pos = positions[b] + t;
  int page;
  int slot;
  if (DENSE) {
    if (pos < 0 || pos >= ps) return;
    page = b;
    slot = pos;
  } else {
    const int col = pos >= 0 ? pos / ps : -1;
    page = (col >= 0 && col < mp) ? tables[(long long)b * mp + col] : -1;
    if (page < 0) page = num_pages1 - 1;
    slot = pos >= 0 ? pos % ps : 0;
  }
  const long long dst =
      ((((long long)layer * num_pages1 + page) * kvn + h) * ps + slot) *
      (long long)row_bytes;
  const V* sk = reinterpret_cast<const V*>(
      new_k + (long long)b * k_bstride + (long long)t * k_tstride +
      (long long)h * row_bytes);
  const V* sv = reinterpret_cast<const V*>(
      new_v + (long long)b * v_bstride + (long long)t * v_tstride +
      (long long)h * row_bytes);
  V* dk = reinterpret_cast<V*>(pool_k + dst);
  V* dv = reinterpret_cast<V*>(pool_v + dst);
  const int nvec = row_bytes / (int)sizeof(V);
  for (int i = threadIdx.x; i < 2 * nvec; i += blockDim.x) {
    if (i < nvec) {
      dk[i] = sk[i];
    } else {
      dv[i - nvec] = sv[i - nvec];
    }
  }
}

// grid (B, ceil(S/ps), kvN); the block copies the ps x D tile of rows
// [pg*ps, pg*ps+ps) of head h into pool[layer, tables[b, pg], h], zeros
// past row S.
template <typename V>
__global__ void paged_append_prefill_kernel(
    char* __restrict__ pool_k, char* __restrict__ pool_v,
    const char* __restrict__ new_k, const char* __restrict__ new_v,
    long long k_bstride, long long k_sstride, long long v_bstride,
    long long v_sstride, const int* __restrict__ tables, int layer,
    int num_pages1, int kvn, int ps, int row_bytes, int mp, int seq) {
  const int b = blockIdx.x;
  const int pg = blockIdx.y;
  const int h = blockIdx.z;
  int page = pg < mp ? tables[(long long)b * mp + pg] : -1;
  if (page < 0) page = num_pages1 - 1;
  const long long base =
      (((long long)layer * num_pages1 + page) * kvn + h) * (long long)ps *
      row_bytes;
  char* dk = pool_k + base;
  char* dv = pool_v + base;
  const int nvec = row_bytes / (int)sizeof(V);
  const int total = ps * nvec;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / nvec;
    const int c = i - r * nvec;
    const int s = pg * ps + r;
    V kv = vzero<V>();
    V vv = vzero<V>();
    if (s < seq) {
      kv = reinterpret_cast<const V*>(new_k + (long long)b * k_bstride +
                                      (long long)s * k_sstride +
                                      (long long)h * row_bytes)[c];
      vv = reinterpret_cast<const V*>(new_v + (long long)b * v_bstride +
                                      (long long)s * v_sstride +
                                      (long long)h * row_bytes)[c];
    }
    reinterpret_cast<V*>(dk + (long long)r * row_bytes)[c] = kv;
    reinterpret_cast<V*>(dv + (long long)r * row_bytes)[c] = vv;
  }
}

// 8 row elements of T from 16-byte aligned memory -> 8 floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* s, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(s);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* s, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// E elements of a row (T) -> E e4m3 codes at o; E 8 (16-byte aligned
// source, 8-byte aligned o) or 1. s null: zeros (a prefill pad row).
template <typename T, int E>
__device__ __forceinline__ void store_e4m3(unsigned char* o, const T* s) {
  if constexpr (E == 8) {
    unsigned w[2] = {0u, 0u};
    if (s != nullptr) {
      float f[8];
      load8(s, f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j >> 2] |= (unsigned)sli::f_to_e4m3(f[j]) << (8 * (j & 3));
    }
    *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
  } else {
    o[0] = s != nullptr ? sli::f_to_e4m3(sli::to_f(s[0])) : 0;
  }
}

// grid (B, T, kvN): forms 1e and 11e, and (DENSE) 12e. Row (b, t, h) of new
// K and new V (T: f32 or bf16; strides in elements) converted into the
// e4m3 pools at pool[layer, page, h, slot, :], the slot rules of
// paged_append_rows_kernel (DENSE: the arena [L, B', kvN, Smax, D], row b
// at slot positions[b] + t, a slot outside [0, Smax) dropped). E:
// elements a thread handles at once.
template <typename T, int E, bool DENSE>
__global__ void paged_append_rows_e4m3_kernel(
    unsigned char* __restrict__ pool_k, unsigned char* __restrict__ pool_v,
    const T* __restrict__ new_k, const T* __restrict__ new_v,
    long long k_bstride, long long k_tstride, long long v_bstride,
    long long v_tstride, const int* __restrict__ tables,
    const int* __restrict__ positions, int layer, int num_pages1, int kvn,
    int ps, int d, int mp) {
  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int h = blockIdx.z;
  const int pos = positions[b] + t;
  int page;
  int slot;
  if (DENSE) {
    if (pos < 0 || pos >= ps) return;
    page = b;
    slot = pos;
  } else {
    const int col = pos >= 0 ? pos / ps : -1;
    page = (col >= 0 && col < mp) ? tables[(long long)b * mp + col] : -1;
    if (page < 0) page = num_pages1 - 1;
    slot = pos >= 0 ? pos % ps : 0;
  }
  const long long dst =
      ((((long long)layer * num_pages1 + page) * kvn + h) * ps + slot) *
      (long long)d;
  const T* sk = new_k + (long long)b * k_bstride + (long long)t * k_tstride +
                (long long)h * d;
  const T* sv = new_v + (long long)b * v_bstride + (long long)t * v_tstride +
                (long long)h * d;
  const int n = d / E;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const bool v = i >= n;
    const int c = (v ? i - n : i) * E;
    store_e4m3<T, E>((v ? pool_v : pool_k) + dst + c, (v ? sv : sk) + c);
  }
}

// grid (B, ceil(S/ps), kvN): form 2e. The ps x D tile of rows
// [pg*ps, pg*ps+ps) of head h converted into page tables[b, pg] (the
// trash page for -1 or a column past the table), code 0 past row S.
template <typename T, int E>
__global__ void paged_append_prefill_e4m3_kernel(
    unsigned char* __restrict__ pool_k, unsigned char* __restrict__ pool_v,
    const T* __restrict__ new_k, const T* __restrict__ new_v,
    long long k_bstride, long long k_sstride, long long v_bstride,
    long long v_sstride, const int* __restrict__ tables, int layer,
    int num_pages1, int kvn, int ps, int d, int mp, int seq) {
  const int b = blockIdx.x;
  const int pg = blockIdx.y;
  const int h = blockIdx.z;
  int page = pg < mp ? tables[(long long)b * mp + pg] : -1;
  if (page < 0) page = num_pages1 - 1;
  const long long base =
      (((long long)layer * num_pages1 + page) * kvn + h) * (long long)ps * d;
  const int n = d / E;
  for (int i = threadIdx.x; i < 2 * ps * n; i += blockDim.x) {
    const bool v = i >= ps * n;
    const int j = v ? i - ps * n : i;
    const int r = j / n;
    const int c = (j - r * n) * E;
    const int s = pg * ps + r;
    const T* src = nullptr;
    if (s < seq)
      src = (v ? new_v + (long long)b * v_bstride + (long long)s * v_sstride
               : new_k + (long long)b * k_bstride + (long long)s * k_sstride) +
            (long long)h * d + c;
    store_e4m3<T, E>((v ? pool_v : pool_k) + base + (long long)r * d + c, src);
  }
}

template <typename T, bool DENSE>
int launch_rows_e4m3(void* pool_k, void* pool_v, const void* new_k,
                     const void* new_v, long long k_bstride,
                     long long k_tstride, long long v_bstride,
                     long long v_tstride, const int* tables,
                     const int* positions, int layer, int num_pages1, int kvn,
                     int ps, int d, int mp, int batch, int span, int vec8,
                     cudaStream_t st) {
  const dim3 grid(batch, span, kvn);
  if (vec8)
    paged_append_rows_e4m3_kernel<T, 8, DENSE><<<grid, 64, 0, st>>>(
        (unsigned char*)pool_k, (unsigned char*)pool_v, (const T*)new_k,
        (const T*)new_v, k_bstride, k_tstride, v_bstride, v_tstride, tables,
        positions, layer, num_pages1, kvn, ps, d, mp);
  else
    paged_append_rows_e4m3_kernel<T, 1, DENSE><<<grid, 64, 0, st>>>(
        (unsigned char*)pool_k, (unsigned char*)pool_v, (const T*)new_k,
        (const T*)new_v, k_bstride, k_tstride, v_bstride, v_tstride, tables,
        positions, layer, num_pages1, kvn, ps, d, mp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prefill_e4m3(void* pool_k, void* pool_v, const void* new_k,
                        const void* new_v, long long k_bstride,
                        long long k_sstride, long long v_bstride,
                        long long v_sstride, const int* tables, int layer,
                        int num_pages1, int kvn, int ps, int d, int mp,
                        int batch, int seq, int vec8, cudaStream_t st) {
  const dim3 grid(batch, (seq + ps - 1) / ps, kvn);
  if (vec8)
    paged_append_prefill_e4m3_kernel<T, 8><<<grid, 128, 0, st>>>(
        (unsigned char*)pool_k, (unsigned char*)pool_v, (const T*)new_k,
        (const T*)new_v, k_bstride, k_sstride, v_bstride, v_sstride, tables,
        layer, num_pages1, kvn, ps, d, mp, seq);
  else
    paged_append_prefill_e4m3_kernel<T, 1><<<grid, 128, 0, st>>>(
        (unsigned char*)pool_k, (unsigned char*)pool_v, (const T*)new_k,
        (const T*)new_v, k_bstride, k_sstride, v_bstride, v_sstride, tables,
        layer, num_pages1, kvn, ps, d, mp, seq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sli_error_string(int code) {
  switch (code) {
    case SLI_ERR_DTYPE:
      return "unsupported dtype";
    case SLI_ERR_HEAD_DIM:
      return "unsupported head dim";
    case SLI_ERR_SHAPE:
      return "unsupported shape";
    case SLI_ERR_GRID:
      return "cooperative grid larger than the blocks the card holds at once";
    default:
      return cudaGetErrorString((cudaError_t)code);
  }
}

// vec16: 1 when every row start is 16-byte aligned (row_bytes and the byte
// strides are multiples of 16), else rows move as 2-byte units. span: the T
// rows written per sequence (1 for decode, whose t stride is unused).
int sli_paged_append_span(void* pool_k, void* pool_v, const void* new_k,
                          const void* new_v, long long k_bstride,
                          long long k_tstride, long long v_bstride,
                          long long v_tstride, const int* tables,
                          const int* positions, int layer, int num_pages1,
                          int kvn, int ps, int row_bytes, int mp, int batch,
                          int span, int vec16, void* stream) {
  if (batch <= 0 || span <= 0 || kvn <= 0 || row_bytes <= 0)
    return SLI_ERR_SHAPE;
  const dim3 grid(batch, span, kvn);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec16) {
    paged_append_rows_kernel<uint4, false><<<grid, 64, 0, st>>>(
        (char*)pool_k, (char*)pool_v, (const char*)new_k, (const char*)new_v,
        k_bstride, k_tstride, v_bstride, v_tstride, tables, positions, layer,
        num_pages1, kvn, ps, row_bytes, mp);
  } else {
    paged_append_rows_kernel<unsigned short, false><<<grid, 64, 0, st>>>(
        (char*)pool_k, (char*)pool_v, (const char*)new_k, (const char*)new_v,
        k_bstride, k_tstride, v_bstride, v_tstride, tables, positions, layer,
        num_pages1, kvn, ps, row_bytes, mp);
  }
  return (int)cudaGetLastError();
}

// The dense arena [L, arena_rows, kvn, smax, D]: S rows of each of the
// `batch` <= arena_rows sequences at slots offsets[b] + 0..S-1 of arena row
// b; slots outside [0, smax) are dropped. Strides as sli_paged_append_span.
int sli_kv_append(void* cache_k, void* cache_v, const void* new_k,
                  const void* new_v, long long k_bstride, long long k_sstride,
                  long long v_bstride, long long v_sstride,
                  const int* offsets, int layer, int arena_rows, int kvn,
                  int smax, int row_bytes, int batch, int seq, int vec16,
                  void* stream) {
  if (batch <= 0 || seq <= 0 || kvn <= 0 || row_bytes <= 0 || smax <= 0 ||
      batch > arena_rows)
    return SLI_ERR_SHAPE;
  const dim3 grid(batch, seq, kvn);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec16) {
    paged_append_rows_kernel<uint4, true><<<grid, 64, 0, st>>>(
        (char*)cache_k, (char*)cache_v, (const char*)new_k,
        (const char*)new_v, k_bstride, k_sstride, v_bstride, v_sstride,
        nullptr, offsets, layer, arena_rows, kvn, smax, row_bytes, 1);
  } else {
    paged_append_rows_kernel<unsigned short, true><<<grid, 64, 0, st>>>(
        (char*)cache_k, (char*)cache_v, (const char*)new_k,
        (const char*)new_v, k_bstride, k_sstride, v_bstride, v_sstride,
        nullptr, offsets, layer, arena_rows, kvn, smax, row_bytes, 1);
  }
  return (int)cudaGetLastError();
}

int sli_paged_append_prefill(void* pool_k, void* pool_v, const void* new_k,
                             const void* new_v, long long k_bstride,
                             long long k_sstride, long long v_bstride,
                             long long v_sstride, const int* tables,
                             int layer, int num_pages1, int kvn, int ps,
                             int row_bytes, int mp, int batch, int seq,
                             int vec16, void* stream) {
  if (batch <= 0 || seq <= 0 || kvn <= 0 || row_bytes <= 0)
    return SLI_ERR_SHAPE;
  const int npg = (seq + ps - 1) / ps;
  const dim3 grid(batch, npg, kvn);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec16) {
    paged_append_prefill_kernel<uint4><<<grid, 128, 0, st>>>(
        (char*)pool_k, (char*)pool_v, (const char*)new_k, (const char*)new_v,
        k_bstride, k_sstride, v_bstride, v_sstride, tables, layer,
        num_pages1, kvn, ps, row_bytes, mp, seq);
  } else {
    paged_append_prefill_kernel<unsigned short><<<grid, 128, 0, st>>>(
        (char*)pool_k, (char*)pool_v, (const char*)new_k, (const char*)new_v,
        k_bstride, k_sstride, v_bstride, v_sstride, tables, layer,
        num_pages1, kvn, ps, row_bytes, mp, seq);
  }
  return (int)cudaGetLastError();
}

// Forms 1e and 11e: the rows of sli_paged_append_span converted into e4m3
// pools [L, num_pages1, kvn, ps, d]. new_k/new_v: rows of `dtype` (SLI_F32
// or SLI_BF16), strides in elements; vec8: d % 8 == 0 with every row start
// 16-byte aligned (8 elements a thread), else one element a thread.
int sli_paged_append_span_e4m3(void* pool_k, void* pool_v, const void* new_k,
                               const void* new_v, long long k_bstride,
                               long long k_tstride, long long v_bstride,
                               long long v_tstride, const int* tables,
                               const int* positions, int layer,
                               int num_pages1, int kvn, int ps, int d, int mp,
                               int batch, int span, int dtype, int vec8,
                               void* stream) {
  if (batch <= 0 || span <= 0 || kvn <= 0 || d <= 0 || (vec8 && d % 8))
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == SLI_F32)
    return launch_rows_e4m3<float, false>(
        pool_k, pool_v, new_k, new_v, k_bstride, k_tstride, v_bstride,
        v_tstride, tables, positions, layer, num_pages1, kvn, ps, d, mp,
        batch, span, vec8, st);
  if (dtype == SLI_BF16)
    return launch_rows_e4m3<__nv_bfloat16, false>(
        pool_k, pool_v, new_k, new_v, k_bstride, k_tstride, v_bstride,
        v_tstride, tables, positions, layer, num_pages1, kvn, ps, d, mp,
        batch, span, vec8, st);
  return SLI_ERR_DTYPE;
}

// Form 12e: sli_kv_append into an e4m3 arena [L, arena_rows, kvn, smax,
// d]: S rows of `dtype` (SLI_F32 or SLI_BF16; strides in elements) of each
// of the `batch` <= arena_rows sequences converted at slots offsets[b] +
// 0..S-1 of arena row b, slots outside [0, smax) dropped; vec8 as above.
int sli_kv_append_e4m3(void* cache_k, void* cache_v, const void* new_k,
                       const void* new_v, long long k_bstride,
                       long long k_sstride, long long v_bstride,
                       long long v_sstride, const int* offsets, int layer,
                       int arena_rows, int kvn, int smax, int d, int batch,
                       int seq, int dtype, int vec8, void* stream) {
  if (batch <= 0 || seq <= 0 || kvn <= 0 || d <= 0 || smax <= 0 ||
      batch > arena_rows || (vec8 && d % 8))
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == SLI_F32)
    return launch_rows_e4m3<float, true>(
        cache_k, cache_v, new_k, new_v, k_bstride, k_sstride, v_bstride,
        v_sstride, nullptr, offsets, layer, arena_rows, kvn, smax, d, 1,
        batch, seq, vec8, st);
  if (dtype == SLI_BF16)
    return launch_rows_e4m3<__nv_bfloat16, true>(
        cache_k, cache_v, new_k, new_v, k_bstride, k_sstride, v_bstride,
        v_sstride, nullptr, offsets, layer, arena_rows, kvn, smax, d, 1,
        batch, seq, vec8, st);
  return SLI_ERR_DTYPE;
}

// Form 2e: a right-padded prompt of `dtype` rows converted into e4m3
// pages (code 0 past row seq); strides in elements, vec8 as above.
int sli_paged_append_prefill_e4m3(void* pool_k, void* pool_v,
                                  const void* new_k, const void* new_v,
                                  long long k_bstride, long long k_sstride,
                                  long long v_bstride, long long v_sstride,
                                  const int* tables, int layer,
                                  int num_pages1, int kvn, int ps, int d,
                                  int mp, int batch, int seq, int dtype,
                                  int vec8, void* stream) {
  if (batch <= 0 || seq <= 0 || kvn <= 0 || ps <= 0 || d <= 0 ||
      (vec8 && d % 8))
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == SLI_F32)
    return launch_prefill_e4m3<float>(pool_k, pool_v, new_k, new_v,
                                      k_bstride, k_sstride, v_bstride,
                                      v_sstride, tables, layer, num_pages1,
                                      kvn, ps, d, mp, batch, seq, vec8, st);
  if (dtype == SLI_BF16)
    return launch_prefill_e4m3<__nv_bfloat16>(
        pool_k, pool_v, new_k, new_v, k_bstride, k_sstride, v_bstride,
        v_sstride, tables, layer, num_pages1, kvn, ps, d, mp, batch, seq,
        vec8, st);
  return SLI_ERR_DTYPE;
}

}  // extern "C"
