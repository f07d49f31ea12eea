// Paged flash prefill attention: a chunk of queries per sequence, at its own
// absolute offset, against the KV already in its pages (found through the
// block table), causal, online softmax.
//
// Replaces the TPU kernel of simplellminference_tpu/ops/attention/
// paged_prefill.py: paged_flash_prefill (_paged_prefill_kernel,
// paged_prefill.py:44-150, wrapper :156), for bf16/f32 pools and, its
// INT8-KV form, int8 pools with per-token-per-head f32 scale pools
// [L, P+1, kvN, ps], and the sliding-window form of both (window > 0,
// paged_prefill.py:90-92, :131-132; shared-KV raises in the wrapper):
// forms 8, 8q, 8w, 8qw, 8ew; GPT-OSS's attention sinks over every pool
// dtype (sinks != nullptr, the layer's f32 logit of each q head, seeding
// each row's softmax state at (sink, 1), paged_prefill.py:259;
// prefill_mma.cuh's note; the FMA kernel seeds its rows the same way):
// forms 8s, 8ws, 8qs, 8qws, 8es, 8ews, a pointer and not a template flag;
// Gemma-2's soft cap over every pool dtype (cap > 0: each live score
// becomes cap * tanh(s * scale * (1 / cap)) before the mask,
// paged_prefill.py:123-124; prefill_mma.cuh's note): forms 8c, 8wc, 8qc,
// 8qwc, 8ec, 8ewc, a template flag of each kernel, the uncapped forms
// compiled as before. Over int8 and e4m3 pools both options see the K and
// V rows as the TPU kernel's page slabs are, dequantized (or converted)
// and rounded to q's dtype (paged_prefill.py:105-110) before the scores,
// so the cap takes the score of those rows and a sink, a raw logit, stays
// outside every scale; and, its FP8-KV form
// 8e, float8_e4m3fn pools (no scales; the TPU kernel casts the page slabs
// to q's dtype, paged_prefill.py:108-110): bf16 q on the tensor cores, each
// staged code converted exactly to bf16 in the block where INT8 KV
// dequantizes, f32 q on the FMA kernel, each code read exactly as f32;
// with a window (8ew) and sinks (8es, 8ews) as over the other pools: the
// walk starts at the oldest row's band (no e4m3 page below it is read:
// codes 0x7f and 0xff are NaN in e4m3fn, so a stray read would show), and
// the sink, a raw logit, stays outside the conversion.
//
// Bound on the H100: at the prefix path's shapes bytes (a suffix batch of
// 8 x 64 rows behind 512 cached tokens, a 256-row chunk: q and the output,
// 2*N*Sq*D elements per sequence, plus each sequence's live K and V,
// 2*kvN*kv_len*D elements, at 3.35 TB/s, against 4*N*D operations per
// (row, key) pair); at the Mistral window chunk (256 rows against 4096
// keys, window 4096) operations: 4*N*D per pair, 17 GFLOP, 0.017 ms at
// the bf16 tensor-core peak, 26 GFLOP with the split P below. INT8 KV
// halves the K/V bytes and adds one f32 scale per key row and head.
//
// Design, bf16 (the forms the Engine runs): prefill_mma.cuh, on the
// tensor cores. One warpgroup a block and a 64-row query tile that packs
// 64 / group positions x the group's q heads of one kv head, so each K/V
// tile is read once for the whole GQA group (the first design read it
// once per q head); K/V rows through a two-stage cp.async ring, each key
// row's page looked up in the table (key p reads row p % ps of page
// tables[b, p / ps], so pages smaller than the tile work) one tile ahead;
// S = QK^T and O += PV on wgmma with P split hi + lo in bf16; the f32
// online softmax on the fragments. The walk runs from the tile's oldest
// row's band start (0 without a window) to min(its newest position,
// kv_len - 1) only; a row outside it, an unmapped (-1) page and the
// chunk's padding rows are zero-filled by the copy, never read, so over
// the grouped engine's ring pools a table column below the band, which
// aliases the live page of a newer position, is never read, and an
// unmapped page inside kv_len reads zeros as the plain version's gather
// does. When the tiles alone leave fewer than two blocks an SM (the
// Mistral chunk: 128 tiles), the key walk is split over blocks from shapes
// alone and the partials merged by log-sum-exp. INT8 KV converts each
// staged row in registers, code x its row's scale in f32 rounded to bf16
// (paged_prefill.py:105-110), into the swizzled tiles. Every Sq is taken;
// a batch's padding row (-1 table, kv_len 1) stays finite. Head dims 32,
// 64 and 128 for every form; 256 (Gemma) over pools of q's dtype (8, 8w,
// 8c, 8wc and their f32 FMA forms), int8 pools (8q, 8qw, 8qc, 8qwc: Gemma
// over INT8 KV) and e4m3 pools (8e, 8ew, 8ec, 8ewc: Gemma over FP8 KV),
// budget in prefill_mma.cuh's note (the FMA kernel's tiles, f32 whatever
// the pool: 214,272 bytes of shared memory). The kernels live in
// paged_prefill.cuh; the e4m3 forms are instantiated in
// paged_prefill_e4m3.cu, a translation unit of their own.
//
// Design, f32: the first, FMA kernel below (TF32 tensor cores would not
// hold f32's tolerance): one block per (q tile of 64 rows, q head,
// sequence); K/V tiles of 64 keys staged through shared memory in f32
// (each tile's rows looked up once into shared memory), a 4 x 4 micro-tile
// per thread for QK^T and 4 rows x D/16 columns for PV; the same walk and
// per-element mask (k_pos <= q_pos, k_pos < kv_len, k_pos > q_pos - window),
// a row's sum guarded.
#include "paged_prefill.cuh"

namespace {

template <typename T>
int dispatch_p(int pool, int head_dim, const void* q, long long q_bs,
               long long q_ss, const void* pool_k, const void* pool_v,
               const float* ksp, const float* vsp, const int* tables,
               const int* kv_lens, const int* offs, void* out, int batch,
               int seq, int heads, int layer, int num_pages1, int kvn, int ps,
               int mp, int group, int window, float scale, float cap,
               const float* sinks, cudaStream_t st) {
  if (pool == SLI_POOL_I8)
    return dispatch_d<T, int8_t>(head_dim, q, q_bs, q_ss, pool_k, pool_v, ksp,
                                 vsp, tables, kv_lens, offs, out, batch, seq,
                                 heads, layer, num_pages1, kvn, ps, mp, group,
                                 window, scale, cap, sinks, st);
  if (pool == SLI_POOL_E4M3)  // paged_prefill_e4m3.cu
    return sli_pp::dispatch_e4m3_fma(
        head_dim, q, q_bs, q_ss, pool_k, pool_v, tables, kv_lens, offs, out,
        batch, seq, heads, layer, num_pages1, kvn, ps, mp, group, window,
        scale, cap, sinks, st);
  if (pool != (std::is_same_v<T, float> ? SLI_POOL_F32 : SLI_POOL_BF16))
    return SLI_ERR_DTYPE;
  return dispatch_d<T, T>(head_dim, q, q_bs, q_ss, pool_k, pool_v, ksp, vsp,
                          tables, kv_lens, offs, out, batch, seq, heads,
                          layer, num_pages1, kvn, ps, mp, group, window, scale,
                          cap, sinks, st);
}

}  // namespace

// pool: the pools' dtype (SLI_POOL_*): q's dtype, e4m3 (forms 8e, 8ew,
// 8es, 8ews, 8ec, 8ewc), or int8
// with k_scale/v_scale, their f32 scale pools [L, num_pages1, kvn, ps]
// (null for every other pool dtype). window: 0 for none, else the sliding
// window (>= 1); cap: 0 for none, else the soft cap (> 0; every pool
// dtype); sinks: null for none, else the layer's f32 sink logits [heads]
// (every pool dtype, D <= 128). D 256: every pool dtype. bf16 q takes the
// tensor-core kernel:
// q rows 16-byte aligned (q, q_bs, q_ss), and with splits > 1, work holds
// splits * batch * seq * heads * (head_dim + 2) floats. f32 q takes the
// FMA kernel (splits 1).
extern "C" int sli_paged_flash_prefill(
    const void* q, long long q_bs, long long q_ss, const void* pool_k,
    const void* pool_v, const void* k_scale, const void* v_scale,
    const int* tables, const int* kv_lens, const int* offs, void* out,
    int batch, int seq, int heads, int layer, int num_pages1, int kvn, int ps,
    int mp, int group, int head_dim, int window, float scale, float cap,
    int dtype, int pool, void* work, int splits, const float* sinks,
    void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || kvn <= 0 || group <= 0 ||
      ps <= 0 || mp <= 0 || heads != kvn * group || window < 0 ||
      cap < 0.f || splits < 1 || (splits > 1 && work == nullptr))
    return SLI_ERR_SHAPE;
  if (sinks != nullptr && head_dim > 128) return SLI_ERR_HEAD_DIM;
  if ((k_scale == nullptr) != (v_scale == nullptr) ||
      (k_scale != nullptr) != (pool == SLI_POOL_I8))
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ksp = (const float*)k_scale;
  const float* vsp = (const float*)v_scale;
  if (dtype == SLI_F32) {
    if (splits != 1) return SLI_ERR_SHAPE;
    return dispatch_p<float>(pool, head_dim, q, q_bs, q_ss, pool_k, pool_v,
                             ksp, vsp, tables, kv_lens, offs, out, batch, seq,
                             heads, layer, num_pages1, kvn, ps, mp, group,
                             window, scale, cap, sinks, st);
  }
  if (dtype == SLI_BF16) {
    if (((unsigned long long)q | (unsigned long long)pool_k |
         (unsigned long long)pool_v) % 16 || q_bs % 8 || q_ss % 8)
      return SLI_ERR_SHAPE;
    float* w = (float*)work;
    namespace pfa = sli::pfa;
    switch (pool) {
      case SLI_POOL_BF16:
        return dispatch_mma<pfa::KV_BF16>(
            head_dim, q, q_bs, q_ss, pool_k, pool_v, ksp, vsp, tables,
            kv_lens, offs, out, w, batch, seq, heads, layer, num_pages1, kvn,
            ps, mp, group, window, scale, cap, splits, sinks, st);
      case SLI_POOL_I8:
        return dispatch_mma<pfa::KV_I8>(
            head_dim, q, q_bs, q_ss, pool_k, pool_v, ksp, vsp, tables,
            kv_lens, offs, out, w, batch, seq, heads, layer, num_pages1, kvn,
            ps, mp, group, window, scale, cap, splits, sinks, st);
      case SLI_POOL_E4M3:  // paged_prefill_e4m3.cu
        return sli_pp::dispatch_e4m3_mma(
            head_dim, q, q_bs, q_ss, pool_k, pool_v, tables, kv_lens, offs,
            out, w, batch, seq, heads, layer, num_pages1, kvn, ps, mp, group,
            window, scale, cap, splits, sinks, st);
      default:
        return SLI_ERR_DTYPE;
    }
  }
  return SLI_ERR_DTYPE;
}
