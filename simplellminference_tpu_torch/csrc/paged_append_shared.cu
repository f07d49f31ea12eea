// In-place paged writes into a shared-KV pool (absorbed MLA): one latent
// row per sequence at decode (form 1l) and a chunk's latent rows, page by
// page, at prefill (form 2l). The pool holds one row per token that serves
// as key and value, so there is no V pool to write.
//
// Replaces the TPU kernels of simplellminference_tpu/ops/paged_append.py
// in their shared-KV forms (dual=False):
//   paged_append_decode  (_decode_kernel,  paged_append.py:34-47, :108)
//   paged_append_prefill (_prefill_kernel, paged_append.py:116-126, :184)
//
// Bound on the H100: bytes. A copy: decode B * kvN * D elements read and
// written, prefill B * ceil(S / ps) * kvN * ps * D (the last page's rows
// past S written as zeros, like the JAX pad); DeepSeek-V2-Lite's latent
// row is 640 bf16 lanes, 1280 bytes.
//
// Design: the row copies of paged_append.cu (16-byte vectors where every
// row start and stride is 16-byte aligned, 2-byte elements otherwise;
// neighbouring threads on neighbouring addresses; an unmapped (-1) page or
// a column past the table writes to the trash page, the pool's last page
// row) with the V write left out. A prefill page's rows are cut over
// `parts` blocks (the wrapper's choice from shapes: two blocks an SM), so
// a 512-row chunk of one sequence, four pages of one kv head, still fills
// the card: the two-pool kernel's one block a page leaves most SMs idle at
// such shapes (its e4m3 form at D 256 ran slower than PyTorch's own cast
// and copy at Gemma-2-2B's prefill, 32 blocks on 132 SMs).
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

// grid (B, kvN): row (b, h) of new into pool[layer, page, h, slot, :] at
// position positions[b] (a negative position: slot 0 of the trash page).
template <typename V>
__global__ void append_decode_shared_kernel(
    char* __restrict__ pool, const char* __restrict__ nk, long long bstride,
    const int* __restrict__ tables, const int* __restrict__ positions,
    int layer, int num_pages1, int kvn, int ps, int row_bytes, int mp) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int pos = positions[b];
  const int col = pos >= 0 ? pos / ps : -1;
  int page = (col >= 0 && col < mp) ? tables[(long long)b * mp + col] : -1;
  if (page < 0) page = num_pages1 - 1;
  const int slot = pos >= 0 ? pos % ps : 0;
  V* dst = reinterpret_cast<V*>(
      pool + ((((long long)layer * num_pages1 + page) * kvn + h) * ps + slot) *
                 (long long)row_bytes);
  const V* src = reinterpret_cast<const V*>(nk + (long long)b * bstride +
                                            (long long)h * row_bytes);
  const int nvec = row_bytes / (int)sizeof(V);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) dst[i] = src[i];
}

// grid (B, npg * parts, kvN): block (b, pg * parts + part, h) copies rows
// [part * rpp, min(ps, (part + 1) * rpp)) of page pg (rpp = ceil(ps /
// parts)) of head h into pool[layer, tables[b, pg], h], zeros past row S.
template <typename V>
__global__ void append_prefill_shared_kernel(
    char* __restrict__ pool, const char* __restrict__ nk, long long bstride,
    long long sstride, const int* __restrict__ tables, int layer,
    int num_pages1, int kvn, int ps, int row_bytes, int mp, int seq,
    int parts) {
  const int b = blockIdx.x;
  const int pg = blockIdx.y / parts;
  const int part = blockIdx.y - pg * parts;
  const int h = blockIdx.z;
  const int rpp = (ps + parts - 1) / parts;
  const int r0 = part * rpp;
  const int r1 = min(ps, r0 + rpp);
  if (r0 >= r1) return;
  int page = pg < mp ? tables[(long long)b * mp + pg] : -1;
  if (page < 0) page = num_pages1 - 1;
  char* dst = pool + (((long long)layer * num_pages1 + page) * kvn + h) *
                         (long long)ps * row_bytes;
  const int nvec = row_bytes / (int)sizeof(V);
  const int total = (r1 - r0) * nvec;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = r0 + i / nvec;
    const int c = i % nvec;
    const int s = pg * ps + r;
    V v = vzero<V>();
    if (s < seq)
      v = reinterpret_cast<const V*>(nk + (long long)b * bstride +
                                     (long long)s * sstride +
                                     (long long)h * row_bytes)[c];
    reinterpret_cast<V*>(dst + (long long)r * row_bytes)[c] = v;
  }
}

}  // namespace

extern "C" {

// Form 1l. pool: [L, num_pages1, kvn, ps, row_bytes / element] (bf16 or
// f32, the rows' own dtype: a byte copy); new_k: [B, kvn, D] rows with
// batch stride bstride (bytes), heads contiguous; vec16: every row start
// and bstride 16-byte aligned and row_bytes a multiple of 16.
int sli_paged_append_decode_shared(void* pool, const void* new_k,
                                   long long bstride, const int* tables,
                                   const int* positions, int layer,
                                   int num_pages1, int kvn, int ps,
                                   int row_bytes, int mp, int batch,
                                   int vec16, void* stream) {
  if (batch <= 0 || kvn <= 0 || ps <= 0 || row_bytes <= 0 || row_bytes % 2)
    return SLI_ERR_SHAPE;
  const dim3 grid(batch, kvn);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec16)
    append_decode_shared_kernel<uint4><<<grid, 128, 0, st>>>(
        (char*)pool, (const char*)new_k, bstride, tables, positions, layer,
        num_pages1, kvn, ps, row_bytes, mp);
  else
    append_decode_shared_kernel<unsigned short><<<grid, 128, 0, st>>>(
        (char*)pool, (const char*)new_k, bstride, tables, positions, layer,
        num_pages1, kvn, ps, row_bytes, mp);
  return (int)cudaGetLastError();
}

// Form 2l. new_k: [B, S, kvn, D] rows with strides bstride, sstride
// (bytes), heads contiguous; parts: blocks a page (>= 1); vec16 as above.
int sli_paged_append_prefill_shared(void* pool, const void* new_k,
                                    long long bstride, long long sstride,
                                    const int* tables, int layer,
                                    int num_pages1, int kvn, int ps,
                                    int row_bytes, int mp, int batch,
                                    int seq, int parts, int vec16,
                                    void* stream) {
  if (batch <= 0 || seq <= 0 || kvn <= 0 || ps <= 0 || row_bytes <= 0 ||
      row_bytes % 2 || parts < 1 || parts > ps)
    return SLI_ERR_SHAPE;
  const int npg = (seq + ps - 1) / ps;
  const dim3 grid(batch, npg * parts, kvn);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec16)
    append_prefill_shared_kernel<uint4><<<grid, 128, 0, st>>>(
        (char*)pool, (const char*)new_k, bstride, sstride, tables, layer,
        num_pages1, kvn, ps, row_bytes, mp, seq, parts);
  else
    append_prefill_shared_kernel<unsigned short><<<grid, 128, 0, st>>>(
        (char*)pool, (const char*)new_k, bstride, sstride, tables, layer,
        num_pages1, kvn, ps, row_bytes, mp, seq, parts);
  return (int)cudaGetLastError();
}

}  // extern "C"
