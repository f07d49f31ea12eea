// Decode attention input for a few bf16 rows (b <= 64) on the bf16 tensor
// cores: rmsnorm -> int8 qkv product x per-channel scale -> RoPE on q and
// k -> k/v rows written in place into the paged pools (or the dense
// arena, or quantized into int8 pools); q is returned.
//
// Replaces, with the f32 FMA kernel of qkv_fused.cu (which keeps f32
// activations and the shapes this one does not take), the TPU kernel of
// simplellminference_tpu/ops/qkv_fused.py: fused_qkv_append (_kernel,
// qkv_fused.py:37-184; wrapper :229) in all four of its forms: paged (6),
// dense arena (6d), quantizing INT8 KV (6q) and kv_layer (6k, pools
// indexed by kv_layer: nothing of the kernel changes), and over e4m3
// pools (6e, paged) and an e4m3 dense arena (6de): each k/v element
// rounded from f32 to e4m3 once in the tail's store (qkv_slots.cuh
// store_pool), into the slot qkv_slots.cuh slot_row gives (the dense
// arena drops a slot past Smax); at D 256 each block rounds its own
// 64-column runs of a head, as 6e/256 does.
//
// Bound on the H100: bytes. The qkv weight ([H, (N + 2 kvN) D] int8, 50.3
// MB at Llama-2-7B: 15.0 us at 3.35 TB/s; 25.2 MB, 7.5 us at Mistral-7B)
// dominates; x, the tables and the new rows are a few KB. The FMA kernel
// takes 5.5x that (8.2x at Mistral width): 96 blocks of one per SM (48 at
// Mistral) each streaming all of K, every block recomputing the rmsnorm
// of its rows, 8 f32 FMAs and a conversion a weight byte, and the weight
// streamed again for every 8 rows.
//
// Design, as kernel 7m (ffn_fused_mma.cu): one wrapper call launches, in
// order on one stream,
//   (a) i8m::norm_rows_kernel: the rmsnorm of each row once, in f32,
//       rounded to bf16 into xn [b, H];
//   (b) qkv_fused_mma_kernel: a block owns 128 qkv columns, the
//       header's two 64-column groups: at D 32, 64 and 128 contiguous
//       (col1 = col0 + 64), whole heads (four, two or one), so every RoPE
//       pair (c, c + D/2) and every INT8-KV head's absmax stays in the
//       block; at D 256 (Gemma) the groups are a head's columns
//       [64 k, + 64) and [128 + 64 k, + 64), k = 0, 1 (qkv_slots.cuh
//       block_col), so the pairs still stay in the block, and the grid
//       keeps Nq / 128 blocks a K range (20 at Gemma-2B's 2560 columns;
//       INT8 KV takes (c); over e4m3 pools, 6e/256, each block rounds its
//       own 64-column runs of a head to e4m3 element by element, so no
//       further launch is needed); registers, shared
//       memory and the bytes bound (5.2 MB of weight at Gemma-2B) do not
//       depend on D, only the tail's column map does. It
//       streams a K range of the weight against all b rows of xn in one
//       pass (int8_mma_rows.cuh: mma.sync with the weight as A, converted
//       exactly to bf16 in registers; a 4-stage cp.async ring). K is split
//       from shapes alone (ops/qkv_fused.py qkv_split: 96 column tiles x 5
//       K ranges at 7B, 48 x 8 at Mistral, b = 8) so that the grid fills
//       the card; each block writes its f32 partial sums, and the last
//       block to arrive at a column tile (an arrival counter of its own,
//       reset by that block, so CUDA-graph replay holds) adds them in K
//       order and does the tail: the per-channel scale, RoPE on q and k in
//       f32, q stored in bf16, each k/v row stored into its slot
//       (qkv_slots.cuh: an unmapped page or a position past the table
//       writes the trash page; the dense arena drops a slot past Smax) or,
//       INT8 KV, rounded to bf16 into a shared tile and quantized per
//       (row, kv head) by one warp with quantize_kv's math
//       (qkv_slots.cuh quant_head);
//   (c) INT8 KV at D 256 only (Gemma over INT8 KV, 6q/256): a head's
//       columns lie in two blocks, so neither block has its absmax; each
//       leaves its rounded half in kv_rows and qkv_slots.cuh's
//       quant_heads_kernel quantizes the whole heads, one warp a (row, k/v
//       head). A third small launch and not a second arrival counter: it
//       keeps (b) as it is, and stream order is the only hand-off.
// Two launches (three for 6q/256) and no host sync; the grid comes from
// shapes alone.
//
// Rounding, as the plain version (ops/qkv_fused.py fused_qkv_append_ref):
// the normalized rows rounded to bf16 (the TPU kernel rounds them to bf16,
// qkv_fused.py:76-77); products (exact on the tensor cores), their f32
// sums in another order, the scale and RoPE in f32; q rounded once to
// bf16, k/v once to the pool dtype, or (INT8 KV) k/v rounded to bf16, then
// scale = max(absmax / 127, 1e-8) by IEEE division and code = rint(x /
// scale) clipped to +-127.
#include "int8_mma_rows.cuh"
#include "qkv_slots.cuh"

namespace {

constexpr int QKV_MAX_TILES = 4096;  // column tiles a launch may arrive at

// arrival counters of the K-split grid, one a column tile (apart from the
// FFN's); zero at load, and each launch leaves them zero
__device__ int qkv_arrivals[QKV_MAX_TILES];

// Blocks an SM holds for NT n8 row tiles (launch bounds): 7m's, whose
// split rule ops/qkv_fused.py qkv_split takes.
template <int NT>
struct QkvRes {
  static constexpr int value = NT == 1 ? 4 : (NT <= 5 ? 3 : 2);
};

// The ring, or the K warps' sums followed by the tail's tile [rows][128]
// f32 of rounded k/v values (INT8 KV).
template <int NT>
struct QkvSmem {
  using G = i8m::Geo<NT>;
  static constexpr int TILE = G::ROWS * 128 * 4;
  static constexpr int value =
      G::RING > G::RED + TILE ? G::RING : G::RED + TILE;
};

// grid (Nq / 128, chunks): block (x, z) takes qkv columns [128x, 128x +
// 128) and H rows [z * kch, min(H, (z + 1) * kch)).
template <int NT>
__global__ void __launch_bounds__(i8m::THREADS, QkvRes<NT>::value)
    qkv_fused_mma_kernel(const __nv_bfloat16* __restrict__ xn,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ ws,
                         const float* __restrict__ sin_t,
                         const float* __restrict__ cos_t, void* pool_k,
                         void* pool_v, float* __restrict__ pool_ks,
                         float* __restrict__ pool_vs, int pool_dt,
                         __nv_bfloat16* __restrict__ q_out,
                         const int* __restrict__ tables,
                         const int* __restrict__ positions, int layer,
                         int num_pages1, int kvn, int ps, int mp, int b,
                         int h, int n_heads, int d, int kch,
                         float* __restrict__ work,
                         float* __restrict__ kv_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  using G = i8m::Geo<NT>;
  const int nq = (n_heads + 2 * kvn) * d;
  const int col0 = qkv::block_col(blockIdx.x, 0, d);
  const int col1 = qkv::block_col(blockIdx.x, 64, d);
  const int z = blockIdx.y;
  const int chunks = gridDim.y;
  const int kb = z * kch;
  const int ke = min(h, kb + kch);
  float acc[4][NT][4];
#pragma unroll
  for (int tj = 0; tj < 4; ++tj)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tj][nt][e] = 0.f;
  i8m::stream<NT>(smem, wq, nq, col0, col1, true, xn, h, b, kb, ke, acc);
  float* red = reinterpret_cast<float*>(smem);
  i8m::spill<NT>(acc, red);
  const int tid = threadIdx.x;
  if (chunks > 1) {
    float* pz = work + (long long)z * b * nq;
    for (int i = tid; i < b * 128; i += i8m::THREADS) {
      const int row = i >> 7;
      const int c = i & 127;
      pz[(long long)row * nq + (c < 64 ? col0 + c : col1 + c - 64)] =
          i8m::block_sum<NT>(red, c >> 6, c & 63, row);
    }
    if (!i8m::last_to_arrive(qkv_arrivals + blockIdx.x, chunks)) return;
  }

  // The tail: a thread takes 4 neighbouring pairs (c, c + D/2) of a head
  // (the block's 64 pairs, in 16 groups a row; qkv_slots.cuh pair_col).
  float* tile = red + G::RED / 4;
  const bool quant = pool_ks != nullptr;
  const int half = d >> 1;
  for (int i = tid; i < b * 16; i += i8m::THREADS) {
    const int row = i >> 4;
    const int t1 = qkv::pair_col((i & 15) * 4, d);  // block column of c
    const int t2 = qkv::pair_partner(t1, d);        // and of c + D/2
    const int g1 = qkv::block_col(blockIdx.x, t1, d);  // qkv column of c
    const int head = g1 / d;
    const int j = g1 % d;
    float v1[4], v2[4];
    if (chunks == 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c1 = t1 + e;
        const int c2 = t2 + e;
        v1[e] = i8m::block_sum<NT>(red, c1 >> 6, c1 & 63, row);
        v2[e] = i8m::block_sum<NT>(red, c2 >> 6, c2 & 63, row);
      }
    } else {
      const float* p = work + (long long)row * nq + g1;
      const long long stride = (long long)b * nq;
      const float4 a = i8m::sum_partials4(p, stride, chunks);
      const float4 c = i8m::sum_partials4(p + half, stride, chunks);
      v1[0] = a.x; v1[1] = a.y; v1[2] = a.z; v1[3] = a.w;
      v2[0] = c.x; v2[1] = c.y; v2[2] = c.z; v2[3] = c.w;
    }
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(ws + g1));
    const float4 s2 = __ldg(reinterpret_cast<const float4*>(ws + g1 + half));
    v1[0] *= s1.x; v1[1] *= s1.y; v1[2] *= s1.z; v1[3] *= s1.w;
    v2[0] *= s2.x; v2[1] *= s2.y; v2[2] *= s2.z; v2[3] *= s2.w;
    float r1[4], r2[4];
    if (head < n_heads + kvn) {  // q and k: rotated
      const long long o = (long long)row * half + j;
      const float4 sn = __ldg(reinterpret_cast<const float4*>(sin_t + o));
      const float4 cs = __ldg(reinterpret_cast<const float4*>(cos_t + o));
      const float snv[4] = {sn.x, sn.y, sn.z, sn.w};
      const float csv[4] = {cs.x, cs.y, cs.z, cs.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r1[e] = v1[e] * csv[e] - v2[e] * snv[e];
        r2[e] = v2[e] * csv[e] + v1[e] * snv[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r1[e] = v1[e];
        r2[e] = v2[e];
      }
    }
    if (head < n_heads) {
      __nv_bfloat16* qo = q_out + ((long long)row * n_heads + head) * d + j;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qo[e] = __float2bfloat16(r1[e]);
        qo[half + e] = __float2bfloat16(r2[e]);
      }
      continue;
    }
    if (quant) {  // quantized by the pass below, or at D 256 by (c)
      // columns j and j + D/2 of the head: the tile's t1 and t2, or its
      // row of kv_rows
      float* c1 = d == 256 ? kv_rows + ((long long)row * 2 * kvn + head -
                                        n_heads) * d + j
                           : tile + row * 128 + t1;
      float* c2 = d == 256 ? c1 + half : tile + row * 128 + t2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c1[e] = __bfloat162float(__float2bfloat16(r1[e]));
        c2[e] = __bfloat162float(__float2bfloat16(r2[e]));
      }
      continue;
    }
    const bool is_k = head < n_heads + kvn;
    const int kh = is_k ? head - n_heads : head - n_heads - kvn;
    const long long srow = qkv::slot_row(tables, positions, row, kh, layer,
                                         num_pages1, kvn, ps, mp);
    if (srow < 0) continue;  // dense arena: a slot past Smax is dropped
    const long long off = srow * (long long)d + j;
    void* pool = is_k ? pool_k : pool_v;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qkv::store_pool(pool, pool_dt, off + e, r1[e]);
      qkv::store_pool(pool, pool_dt, off + half + e, r2[e]);
    }
  }
  if (!quant || d == 256) return;

  // INT8 KV: one warp a (row, k/v head) of the block's whole heads
  __syncthreads();
  const int warp = tid >> 5;
  const int hpb = 128 / d;  // whole heads a block
  for (int t = warp; t < b * hpb; t += i8m::THREADS / 32) {
    const int row = t / hpb;
    const int hb = t - row * hpb;
    const int head = col0 / d + hb;
    if (head < n_heads) continue;
    const bool is_k = head < n_heads + kvn;
    const int kh = is_k ? head - n_heads : head - n_heads - kvn;
    const long long srow = qkv::slot_row(tables, positions, row, kh, layer,
                                         num_pages1, kvn, ps, mp);
    if (srow < 0) continue;
    qkv::quant_head(tile + row * 128 + hb * d, d, tid & 31,
                    reinterpret_cast<int8_t*>(is_k ? pool_k : pool_v) +
                        srow * (long long)d,
                    (is_k ? pool_ks : pool_vs) + srow);
  }
}

template <int NT>
int run_nt(const __nv_bfloat16* x, long long ldx, const void* nw,
           int nw_bf16, const int8_t* wq, const float* ws,
           const float* sin_t, const float* cos_t, void* pool_k,
           void* pool_v, float* pool_ks, float* pool_vs, int pool_dt,
           __nv_bfloat16* q_out, const int* tables, const int* positions,
           int layer, int num_pages1, int kvn, int ps, int mp, int b, int h,
           int n_heads, int d, float eps, __nv_bfloat16* xn, float* work,
           int kch, float* kv_rows, cudaStream_t st) {
  constexpr int SMEM = QkvSmem<NT>::value;
  auto kern = qkv_fused_mma_kernel<NT>;
  cudaError_t e = sli::allow_smem(kern, SMEM);
  if (e != cudaSuccess) return (int)e;
  i8m::norm_rows_kernel<<<b, 256, 0, st>>>(x, ldx, nw, nw_bf16, xn, h, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nq = (n_heads + 2 * kvn) * d;
  const dim3 grid(nq / 128, (h + kch - 1) / kch);
  kern<<<grid, i8m::THREADS, SMEM, st>>>(
      xn, wq, ws, sin_t, cos_t, pool_k, pool_v, pool_ks, pool_vs, pool_dt,
      q_out, tables, positions, layer, num_pages1, kvn, ps, mp, b, h,
      n_heads, d, kch, work, kv_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess || pool_ks == nullptr || d != 256) return (int)e;
  return (int)qkv::quant_heads(kv_rows, pool_k, pool_v, pool_ks, pool_vs,
                               tables, positions, layer, num_pages1, kvn, ps,
                               mp, b, d, st);
}

}  // namespace

extern "C" {

// x: [b, h] bf16 at row stride ldx (b <= 64); nw: the layer's norm weight
// [h] (f32, or bf16 when nw_bf16); wq: the layer's [h, (n_heads + 2 kvn) d]
// int8 with ws its f32 scales; sin/cos: [b, d/2] f32; pools: [L,
// num_pages1, kvn, ps, d] of pool_dt (SLI_POOL_F32, _BF16, or _E4M3: forms
// 6e and, dense, 6de), written at pool layer kv_layer, with tables [b, mp]
// int32; tables null: the dense arena [L, num_pages1 >= b, kvn, ps = Smax,
// d], x row r into arena row r; pool_ks/pool_vs: null, or (INT8 KV, paged)
// the f32 scale pools [L, num_pages1, kvn, ps] of int8 pools; positions:
// [b] int32; q_out: [b, n_heads, d] bf16; xn: [b, h] bf16 scratch; work:
// ceil(h / kch) * b * nq floats when K is split (null otherwise); kv_rows:
// INT8 KV at d 256, b * 2 kvn * d floats of scratch (null otherwise). h a
// multiple of 64, nq = (n_heads + 2 kvn) d of 128, d 32, 64, 128 or 256
// (every pool dtype); kch: H rows a block, a multiple of 64. wq, ws,
// sin, cos and work 16-byte aligned.
int sli_qkv_fused_mma(const void* x, long long ldx, const void* nw,
                      int nw_bf16, const void* wq, const float* ws,
                      const float* sin_t, const float* cos_t, void* pool_k,
                      void* pool_v, void* pool_ks, void* pool_vs,
                      int pool_dt, void* q_out, const int* tables,
                      const int* positions, int kv_layer, int num_pages1,
                      int kvn, int ps, int mp, int b, int h, int n_heads,
                      int d, float eps, void* xn, float* work, int kch,
                      float* kv_rows, void* stream) {
  if (b <= 0 || b > 64 || h <= 0 || h % 64 || n_heads <= 0 || kvn <= 0 ||
      ps <= 0 || mp <= 0 || kch <= 0 || kch % 64)
    return SLI_ERR_SHAPE;
  if (d != 32 && d != 64 && d != 128 && d != 256) return SLI_ERR_HEAD_DIM;
  if (d == 256 && pool_ks != nullptr && kv_rows == nullptr)
    return SLI_ERR_SHAPE;
  const int nq = (n_heads + 2 * kvn) * d;
  if (nq % 128 || nq / 128 > QKV_MAX_TILES) return SLI_ERR_SHAPE;
  if ((pool_ks == nullptr) != (pool_vs == nullptr)) return SLI_ERR_SHAPE;
  if (!qkv::pool_ok(pool_dt, pool_ks != nullptr)) return SLI_ERR_DTYPE;
  if (pool_ks != nullptr && tables == nullptr) return SLI_ERR_SHAPE;
  if (tables == nullptr && b > num_pages1) return SLI_ERR_SHAPE;
  if (kch < h && work == nullptr) return SLI_ERR_SHAPE;
  if (((unsigned long long)wq | (unsigned long long)ws |
       (unsigned long long)sin_t | (unsigned long long)cos_t |
       (unsigned long long)xn | (unsigned long long)work) % 16)
    return SLI_ERR_SHAPE;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* w = (const int8_t*)wq;
  auto* qo = (__nv_bfloat16*)q_out;
  auto* xnb = (__nv_bfloat16*)xn;
  float* ks = (float*)pool_ks;
  float* vs = (float*)pool_vs;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((b + 7) / 8) {
#define SLI_QKV_NT(NT)                                                        \
  case NT:                                                                    \
    return run_nt<NT>(xb, ldx, nw, nw_bf16, w, ws, sin_t, cos_t, pool_k,      \
                      pool_v, ks, vs, pool_dt, qo, tables, positions,       \
                      kv_layer, num_pages1, kvn, ps, mp, b, h, n_heads, d,    \
                      eps, xnb, work, kch, kv_rows, st);
    SLI_QKV_NT(1)
    SLI_QKV_NT(2)
    SLI_QKV_NT(3)
    SLI_QKV_NT(4)
    SLI_QKV_NT(5)
    SLI_QKV_NT(6)
    SLI_QKV_NT(7)
    SLI_QKV_NT(8)
#undef SLI_QKV_NT
  }
  return SLI_ERR_SHAPE;
}

}  // extern "C"
