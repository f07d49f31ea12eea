// Paged flash-decode attention: one query token per sequence (decode), or a
// verify window of S <= 8 consecutive query tokens per sequence (speculative
// decoding), against its KV pages, found through the block table, online
// softmax, the keys split over blocks (flash-decoding).
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
// rows_target and max_kv tiling hints have no counterpart. The forms take
// the sliding window of the TPU kernels (paged_decode.py:73-75, :98-101;
// flash_decode.py:67-70, :83-86; window > 0; over e4m3 pools too, forms
// 4ew and 4vew): each row attends only keys within `window` of its own
// position, and the dense walk starts at the band, kv_len - window, as
// the TPU kernel's index map skips the blocks below it
// (flash_decode.py:172-181: a step costs O(window), not O(kv_len)).
// Every form over every pool dtype takes Gemma-2's soft cap (cap > 0:
// each live score becomes cap * tanh(s * scale * (1 / cap)) before the
// mask, paged_decode.py:90-91, flash_decode.py:80-81; forms 4c, 4wc, 4vc,
// 4vwc, 13c, 13wc, over int8 pools 4qc, 4qwc, 4vqc, 4vqwc, over e4m3
// pools 4ec, 4ewc, 4vec, 4vewc), a template flag (CAP), so the uncapped
// forms are compiled as before; tanh is tanhf, CUDA's full-precision one
// (prefill_mma.cuh's note says why not tanh.approx.f32). Over int8 pools
// the cap takes the dequantized score, q.k x the key's scale x scale, the
// order of the TPU kernel (paged_decode.py:84-91): capping before the K
// scale would be another function, equal only at scale 1. Over e4m3 pools
// the codes convert exactly to f32 before q.k and nothing scales them, so
// the capped score is the one of the TPU kernel, which casts each e4m3
// element to f32 and caps after (paged_decode.py:79-80, :90-91). GPT-OSS's
// attention sinks on every
// form over every pool dtype at D 32-128: decode and verify rows, with or
// without a window, and the dense arena (sinks != nullptr: the layer's
// f32 logit of each q head; forms 4s, 4ws, 4vs, 4vws, 13s, 13ws, over
// int8 pools 4qs, 4qws, 4vqs, 4vqws, over e4m3 pools 4es, 4ews, 4ves,
// 4vews;
// paged_decode.py:29-35, :57-67, flash_decode.py: 43-62, :191-194): a
// sink joins the row's softmax denominator and adds
// no value, so split 0's block seeds each row's state with (m, l) = (its
// head's sink, 1) where the others start at (-1e30, 0). The merge then
// counts it once: the partials keep m in natural-log units, the units
// this kernel's softmax runs in, and the sink is a raw logit (neither
// scaled nor capped). A split 0 that meets no key carries (sink, 1) into
// the merge, and a row with no key at all gives acc 0 / l >= 1 = 0. A
// row's head is g * group + its place in the group (row = window row x
// group + head), the head its output goes to; a verify window whose rows
// take two row blocks (gpt-oss-20b's group of 8 x 5 rows = 40) seeds
// each block's rows in that block's split 0, so every (row, head) is
// seeded once. A pointer and not a template flag: one uniform branch
// where the state is seeded, no further instantiation. Over int8 pools
// the seed stays outside both scales: the K scale multiplies a key's
// score and the V scale its probability after l has taken it, so l sums
// unscaled weights and (sink, 1) enters it as over bf16 pools; over e4m3
// pools the codes convert exactly and nothing scales, so the seed is the
// bf16 pools' own. Sinks at D 256 raise in the wrappers and are refused
// here.
//
// Bound on the H100: bytes. Each sequence's live K and V rows
// (2*kv_len*kvN*D elements, plus 2*kv_len*kvN f32 scales for INT8 KV)
// are read once for ~4*kv_len*N*S*D operations: about S operations per
// byte (2S for int8), far below the card's balance point for S <= 8.
//
// Design. The grid is (sequence, kv head x row block, split). A block
// holds up to RB = 32 query rows of one kv head (row r = window row r /
// group, head r % group; a GQA group x S past 32 rows takes more row
// blocks), so every K/V row read serves all the query heads of its group
// and every row of the verify window: a verify step moves the KV bytes of
// one decode step, the point of the TPU design (paged_decode.py:146-150).
// The wrapper picks the number of splits from shapes alone (the key span a
// block can meet, never kv_len: no host sync, so the call can be captured
// in a CUDA graph) to fill one wave of two blocks on each of the 132 SMs
// (a second, partial wave would double the time); inside, each block cuts
// the live keys [k_lo, min(kv_len, MP*ps)) of its own sequence into
// `splits` ranges of whole 64-key tiles and walks its range only. Tiles
// stream through a ring of shared-memory stages (3 for bf16 pools, 4 for
// int8 and e4m3, 2 for f32) with cp.async, 16 bytes a thread and copy, so
// two tiles are in flight while the block computes on a third, kept in the
// pool's storage dtype (bf16, f32, int8 or e4m3 codes; rows padded by 16 bytes
// so the score loop's 16-byte reads of neighbouring keys hit distinct
// banks); a tile reads its page id from the table once when the page size
// is a multiple of the tile. Keys outside the live span are zero-filled by
// the copy itself (nothing read) and masked; an unmapped (-1) page inside
// kv_len reads as zeros, as the plain version's gather does, and never
// touches memory outside the pool. 256 threads a block (8 warps, so two
// blocks an SM hide the copies' and shared memory's latency). Scores:
// four threads a key of the tile, a quarter of D each, f32 dot products
// against q held
// in shared memory as f32; softmax: one warp per row, 2 keys a lane; PV:
// each thread owns 8 output columns and, when the block holds few rows
// (<= 8: decode, Llama's verify window), all of them over a slice of the
// tile's keys (each V chunk loaded once for every row), the slices summed
// at the end, or else a few rows over all the keys. Window
// row s attends keys k_pos < kv_len - S + 1 + s (in-window causal; S = 1 is
// k_pos < kv_len). Scores, the running max/sum and the accumulator stay in
// f32. A block writes f32 partials (m, l, acc[rows, D]) and a second small
// kernel merges the splits by log-sum-exp, divides by l and rounds once to
// the output dtype; with one split the block writes the output itself. A
// split with no key writes m = -1e30 (for -inf: exp(m - M) stays finite
// when every split is empty) and l = 0, so a row with no key at all
// (kv_len <= 0, or kv_len < S - s) gives a zero output. INT8 KV
// dequantizes late, as the TPU kernel does (paged_decode.py:84-89,
// :116-120): each key's scale (copied beside its tile) multiplies its
// score after q.k, and each key's V scale folds into its probability
// before the PV product, so the row sum l stays the sum of the unscaled
// probabilities. FP8 KV (forms 4e, 4ve: float8_e4m3fn pools, no scales;
// the TPU kernel casts each e4m3 element straight to f32,
// paged_decode.py:79-80, :113): the tiles of 1-byte codes go through the
// ring as the int8 ones do (4 stages), and each 8-element group converts
// in registers (cvt.f16x2.e4m3x2, then to f32: both exact), so q.k and
// p.v see the exact stored values with no scale. Sliding window: the key
// walk starts at the oldest verify
// row's first key, k_lo = kv_len - S - window + 1, and no split reads a key
// below it, not even inside k_lo's page. This is what keeps the grouped
// engine's ring pools right: there table column j maps to ring page
// s*R + j % R, so a column below the window band aliases the live page of
// a newer position, and masking after the read would still fetch it (over
// e4m3 pools a stale page may hold codes 0x7f/0xff, NaN in e4m3fn). Rows
// newer than the oldest mask the keys below their own band per element
// (p = 0).
//
// FP8 KV on the dense arena (forms 13e, 13ew, 13ec, 13ewc, 13es, 13ews: the
// TPU kernel casts each e4m3 arena element straight to f32,
// flash_decode.py:74-75, :95): kernel 4's e4m3 body with DENSE, instantiated
// in flash_decode_e4m3.cu; sli_flash_decode takes the arena's dtype code as
// sli_paged_flash_decode takes the pool's. A dense arena's slots past
// kv_len may hold anything (a stale e4m3 code 0x7f is NaN), and the walk
// never reads them: the live span stops at min(kv_len, Smax) and starts,
// with a window, at the band, so only written slots reach a sum.
//
// Head dims 32, 64 and 128 for every form; 256 (Gemma) for every form over
// pools of q's own dtype: paged decode and verify (4, 4w, 4c, 4wc, 4v,
// 4vw, 4vc, 4vwc) and dense (13, 13w, 13c, 13wc), over int8 pools (4q,
// 4qw, 4qc, 4qwc, 4vq, 4vqw, 4vqc, 4vqwc: Gemma over INT8 KV) and over
// e4m3 pools and arenas (4e, 4ew, 4ec, 4ewc, 4ve, 4vew, 4vec, 4vewc, 13e,
// 13ew, 13ec, 13ewc: Gemma over FP8 KV); a window at D 256 starts its walk
// at the band as at every head dim. An int8 stage at D 256 is 2 x 64 keys x 272 bytes = 34 KB with its
// scales, so the int8 ring keeps its 4 stages there: 138 KB and the 32
// rows' q, probability and state arrays, 179 KB (Geo<int8_t, 256>), one
// block an SM, three tiles in flight; an e4m3 stage is the same 34 KB
// (its scale slots unused), so Geo<__nv_fp8_e4m3, 256> is the same 179
// KB. Each 8-element group of codes converts in the score loop and again
// in the PV loop, as at D 128. Gemma-2's GQA group of 2
// makes 2 rows a block at decode and 10 at a 5-row verify window (the
// "more rows" PV branch); Gemma-1's group of 8 makes 40 verify rows, two
// row blocks of 32 and 8, each reading the keys once (K/V twice over). At
// D 256 the work a key is 4x D 64's, the bytes bound the same: a bf16 K+V
// stage is 2 x 64 keys x 528 bytes = 66 KB, so the ring keeps 2 stages,
// one tile in flight while the block computes on the other (f32: one 130
// KB stage, loaded, then computed), 178 KB of shared memory at 32 rows (8
// at Gemma's group: 147 KB), one block an SM. A row
// has 32 PV units of 8 columns: few rows take 8 key slices of the tile,
// more rows up to 4 units a thread; each thread's accumulators stay 64
// floats at every D, and the merge takes a 256-thread block a row.
#include "paged_decode.cuh"

// Dense-arena decode (the flash_decode entry): q [B, N, D] at batch stride
// q_bs (elements); cache_k/v the dense arena [L, arena_rows, kvn, smax, D]
// of q's dtype or, pool SLI_POOL_E4M3, of float8_e4m3fn codes (forms 13e,
// 13ew and their capped and sink forms: flash_decode_e4m3.cu), sequence
// b < batch <= arena_rows reading arena row b's slots [0, min(kv_len,
// smax)), or with window > 0 only the slots [kv_len - window, kv_len) of
// them (forms 13w, 13wc); cap: 0 for none, else the soft cap (> 0; forms
// 13c, 13wc); sinks: null for none, else the layer's f32 sink logits [N]
// (forms 13s, 13ws; D <= 128); out [B, N, D] contiguous. splits > 1: part
// holds splits * B * N * (D + 2) floats of workspace. Slots past kv_len,
// or below the window band, are never read (the copy zero-fills them), so
// a stale e4m3 slot holding a NaN code (0x7f) reaches no sum.
extern "C" int sli_flash_decode(const void* q, long long q_bs,
                                const void* cache_k, const void* cache_v,
                                const int* kv_lens, void* out, float* part,
                                int batch, int layer, int arena_rows, int kvn,
                                int smax, int group, int head_dim, int window,
                                int splits, float scale, float cap, int dtype,
                                int pool, const float* sinks, void* stream) {
  if (batch <= 0 || kvn <= 0 || group <= 0 || smax <= 0 ||
      batch > arena_rows || window < 0 || cap < 0.f)
    return SLI_ERR_SHAPE;
  if (sinks != nullptr && head_dim > 128) return SLI_ERR_HEAD_DIM;
  if (dtype != SLI_F32 && dtype != SLI_BF16) return SLI_ERR_DTYPE;
  cudaStream_t st = (cudaStream_t)stream;
  // one "page" of smax slots per sequence, one window row, no scales
  const Args a{q, q_bs, 0LL, cache_k, cache_v, nullptr, nullptr, nullptr,
               kv_lens, out, part, batch, layer, arena_rows, kvn, smax, 1,
               group, 1, window, splits, scale, cap, sinks};
  if (pool == SLI_POOL_E4M3)  // flash_decode_e4m3.cu
    return sli_pd::dispatch_e4m3_dense(dtype == SLI_F32, head_dim, a, st);
  if (dtype == SLI_F32 && pool == SLI_POOL_F32)
    return dispatch_d<float, float, true>(head_dim, a, st);
  if (dtype == SLI_BF16 && pool == SLI_POOL_BF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16, true>(head_dim, a, st);
  return SLI_ERR_DTYPE;
}

template <typename T>
int dispatch_pool(int pool, int head_dim, const Args& a, cudaStream_t st) {
  switch (pool) {
    case SLI_POOL_I8:  // paged_decode_i8.cu
      return sli_pd::dispatch_i8(std::is_same_v<T, float>, head_dim, a, st);
    case SLI_POOL_E4M3:  // paged_decode_e4m3.cu
      return sli_pd::dispatch_e4m3(std::is_same_v<T, float>, head_dim, a,
                                   st);
    default:  // bf16 or f32 pools: q's own dtype
      return pool == (std::is_same_v<T, float> ? SLI_POOL_F32 : SLI_POOL_BF16)
                 ? dispatch_d<T, T>(head_dim, a, st)
                 : SLI_ERR_DTYPE;
  }
}

// pool: the pools' dtype (SLI_POOL_*): q's dtype, e4m3 (forms 4e, 4ve and
// their window and sink forms), or
// int8 with k_scale/v_scale, their f32 scale pools [L, num_pages1, kvn,
// ps] (null for every other pool dtype). q: [B, wins, N, D] with strides
// q_bs, q_ss (elements); wins = 1 is decode. window: 0 for none, else the
// sliding window (>= 1); cap: 0 for none, else the soft cap (> 0; every
// pool dtype); sinks: null for none, else the layer's f32 sink
// logits [N] (decode and verify rows over every pool dtype, D <= 128; a
// row's sink is its head's, whatever its window row). D 256: every pool
// dtype. pool_v null: a shared-KV pool of q's dtype (form 4l, decode rows
// only, D 128 or 640, no window, cap, sinks or scales). splits > 1:
// part holds splits * B * wins * N * (D + 2) floats of workspace.
extern "C" int sli_paged_flash_decode(
    const void* q, long long q_bs, long long q_ss, const void* pool_k,
    const void* pool_v, const void* k_scale, const void* v_scale,
    const int* tables, const int* kv_lens, void* out, float* part, int batch,
    int layer, int num_pages1, int kvn, int ps, int mp, int group, int wins,
    int head_dim, int window, int splits, float scale, float cap, int dtype,
    int pool, const float* sinks, void* stream) {
  if (batch <= 0 || kvn <= 0 || group <= 0 || ps <= 0 || mp <= 0 ||
      wins <= 0 || window < 0 || cap < 0.f)
    return SLI_ERR_SHAPE;
  if (sinks != nullptr && head_dim > 128) return SLI_ERR_HEAD_DIM;
  if ((k_scale == nullptr) != (v_scale == nullptr) ||
      (k_scale != nullptr) != (pool == SLI_POOL_I8))
    return SLI_ERR_SHAPE;
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{q, q_bs, q_ss, pool_k, pool_v, (const float*)k_scale,
               (const float*)v_scale, tables, kv_lens, out, part, batch,
               layer, num_pages1, kvn, ps, mp, group, wins, window, splits,
               scale, cap, sinks};
  if (pool_v == nullptr) {  // form 4l: paged_decode_shared.cu
    if (wins != 1 || pool != (dtype == SLI_F32 ? SLI_POOL_F32 : SLI_POOL_BF16))
      return SLI_ERR_SHAPE;
    return sli_pd::dispatch_shared(dtype == SLI_F32, head_dim, a, st);
  }
  if (dtype == SLI_F32) return dispatch_pool<float>(pool, head_dim, a, st);
  if (dtype == SLI_BF16)
    return dispatch_pool<__nv_bfloat16>(pool, head_dim, a, st);
  return SLI_ERR_DTYPE;
}
