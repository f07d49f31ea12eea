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
// flash_decode.py:67-70, :83-86; window > 0; the wrappers refuse it over
// e4m3 pools): each row attends only keys within `window` of its own
// position, and the dense walk starts at the band, kv_len - window, as
// the TPU kernel's index map skips the blocks below it
// (flash_decode.py:172-181: a step costs O(window), not O(kv_len)).
// Every form over pools of q's dtype takes Gemma-2's soft cap (cap > 0:
// each live score becomes cap * tanh(s * scale * (1 / cap)) before the
// mask, paged_decode.py:90-91, flash_decode.py:80-81; forms 4c, 4wc, 4vc,
// 4vwc, 13c, 13wc), a template flag (CAP), so the uncapped forms are
// compiled as before; tanh is tanhf, CUDA's full-precision one
// (prefill_mma.cuh's note says why not tanh.approx.f32). The cap over
// int8 or e4m3 pools raises in the wrappers and is refused here. GPT-OSS's
// attention sinks on every form over pools of q's dtype at D 32-128:
// decode and verify rows, with or without a window, and the dense arena
// (sinks != nullptr: the layer's f32 logit of each q head; forms 4s, 4ws,
// 4vs, 4vws, 13s, 13ws; paged_decode.py:29-35, :57-67, flash_decode.py:
// 43-62, :191-194): a sink joins the row's softmax denominator and adds
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
// where the state is seeded, no further instantiation. Sinks over int8 or
// e4m3 pools and at D 256 raise in the wrappers and are refused here.
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
// a newer position, and masking after the read would still fetch it. Rows
// newer than the oldest mask the keys below their own band per element
// (p = 0).
//
// Head dims 32, 64 and 128 for every form; 256 (Gemma) for every form over
// pools of q's own dtype: paged decode and verify (4, 4w, 4c, 4wc, 4v,
// 4vw, 4vc, 4vwc) and dense (13, 13w, 13c, 13wc); a window at D 256 starts
// its walk at the band as at every head dim. Gemma-2's GQA group of 2
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
#include <type_traits>

#include "common.cuh"
#include "split_merge.cuh"

namespace {

constexpr int BK = 64;         // keys per tile
constexpr int NT = 256;        // threads per block
constexpr int PARTS = NT / BK; // threads a key in the score phase
constexpr int RB = 32;         // query rows a block holds at most
constexpr int FEW = 8;         // rows every thread holds in PV (and the
                               // most units a thread holds past them)
constexpr int PSTR = BK + 1;   // probability row stride (floats)
constexpr float NEG_INF = -1e30f;
static_assert(PARTS == 4, "the score phase adds four parts a key");
static_assert(RB * 256 / 8 <= FEW * NT, "PV units must fit the threads");

// Stages of the ring: 4 for 1-byte codes, 3 for bf16, 2 for f32; at D 256
// one fewer for bf16 and f32 (a bf16 stage of K and V is 66 KB there, an
// f32 one 130 KB: 2 bf16 stages and the q, probability and state arrays of
// 32 rows make 173 KB, one f32 stage 171 KB, within the 227 KB a block
// may take; the card holds one such block an SM, and one 64-key tile in
// flight then still covers the SM's share of the memory rate).
template <int ES, int D>
constexpr int stages() {
  return ES == 1 ? 4 : (ES == 2 ? 3 : 2) - (D >= 256 ? 1 : 0);
}

template <typename P, int D>
struct Geo {
  static constexpr int ES = (int)sizeof(P);
  static constexpr int ROWB = D * ES + 16;  // padded key row bytes
  static constexpr int TILE = BK * ROWB;    // one K or V tile
  static constexpr int CH = D * ES / 16;    // 16-byte chunks of a key row
  static constexpr int STAGES = stages<ES, D>();
  static_assert(STAGES * 2 * TILE >= NT * 8 * (int)sizeof(float),
                "the key slices' reduction fits the ring");
  // ring (K, V tiles and their scales; after the walk, the key slices'
  // reduction), q, the probabilities, max, sum and rescale
  static size_t bytes(int rows) {
    return (size_t)STAGES * 2 * (TILE + BK * sizeof(float)) +
           sizeof(float) * ((size_t)rows * D + (size_t)rows * PSTR +
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 consecutive elements of a key row (16 bytes of bf16, 32 of f32, 8 of
// int8 or e4m3 codes) -> 8 exact floats.
template <typename P>
__device__ __forceinline__ void unpack8(const unsigned char* p, float* f);
template <>
__device__ __forceinline__ void unpack8<float>(const unsigned char* p,
                                               float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
template <>
__device__ __forceinline__ void unpack8<__nv_bfloat16>(const unsigned char* p,
                                                       float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack8<int8_t>(const unsigned char* p,
                                                float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const unsigned w[2] = {v.x, v.y};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    f[j] = (float)(signed char)((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
}
template <>
__device__ __forceinline__ void unpack8<__nv_fp8_e4m3>(const unsigned char* p,
                                                       float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const unsigned w[2] = {v.x, v.y};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = sli::e4m3x2_to_f2(
        (unsigned short)(w[j >> 1] >> (16 * (j & 1))));
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

// q: [B, S, N, D] with batch stride q_bs and window stride q_ss (elements;
// S = wins); pools [L, P+1, kvN, ps, D] of P (T, __nv_fp8_e4m3, or int8_t
// with the scale pools ksp/vsp [L, P+1, kvN, ps]); out: [B, S, N, D]
// contiguous. DENSE:
// the pools are a dense arena [L, B', kvN, Smax, D] (num_pages1 = B',
// ps = Smax, mp = 1, no table): sequence b reads arena row b. rcap: the
// rows of the shared-memory layout (min(RB, group * wins)). splits > 1:
// the block writes part (acc [splits][B*S*N][D], then m, l
// [splits][B*S*N][2], f32) for merge_kernel; splits == 1: out.
template <typename T, typename P, int D, bool DENSE, bool CAP>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, long long q_bs, long long q_ss,
    const P* __restrict__ pool_k, const P* __restrict__ pool_v,
    const float* __restrict__ ksp, const float* __restrict__ vsp,
    const int* __restrict__ tables, const int* __restrict__ kv_lens,
    T* __restrict__ out, float* __restrict__ part, int layer,
    int num_pages1, int kvn, int ps, int mp, int group, int wins, int window,
    int rcap, float scale, float cap, const float* __restrict__ sinks) {
  using G = Geo<P, D>;
  constexpr bool QUANT = std::is_same_v<P, int8_t>;  // scales beside codes
  constexpr int EPC = 16 / G::ES;  // elements per 16-byte copy
  constexpr int C8 = D / 8;        // PV units of a row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;  // [STAGES][K, V][BK][ROWB]
  float* scl = reinterpret_cast<float*>(smem + G::STAGES * 2 * G::TILE);
  float* qs = scl + G::STAGES * 2 * BK;  // [rcap][D]
  float* red = reinterpret_cast<float*>(ring);  // [NT][8], after the walk
  float* pr = qs + rcap * D;             // [rcap][PSTR]
  float* ms = pr + rcap * PSTR;
  float* ls = ms + rcap;
  float* al = ls + rcap;

  const int b = blockIdx.x;
  const int nrb = (group * wins + RB - 1) / RB;
  const int g = blockIdx.y / nrb;
  const int row0 = (blockIdx.y - g * nrb) * RB;
  const int rows = min(RB, group * wins - row0);
  const int splits = gridDim.z;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_heads = kvn * group;

  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D;
    const int rr = row0 + r;
    const int w = rr / group;
    qs[i] = sli::to_f(q[(long long)b * q_bs + w * q_ss +
                        (long long)(g * group + rr - w * group) * D + i % D]);
  }
  // split 0 seeds each row with its head's sink (once over the splits)
  const bool seed = sinks != nullptr && z == 0;
  for (int i = tid; i < rows; i += NT) {
    const int rr = row0 + i;
    ms[i] = seed ? sinks[g * group + rr - rr / group * group] : NEG_INF;
    ls[i] = seed ? 1.f : 0.f;
  }
  const int kv_len = kv_lens[b];
  const int n_keys = max(0, min(kv_len, mp * ps));
  // window: no key below the oldest row's band is ever read
  const int k_lo = window > 0 ? max(0, kv_len - wins - window + 1) : 0;
  // this split's tiles [ta, tb) of the live tiles [t_lo, t_hi)
  const int t_lo = k_lo / BK;
  const int nt = max(0, (n_keys + BK - 1) / BK - t_lo);
  const int per = (nt + splits - 1) / splits;
  const int ta = t_lo + min(nt, z * per);
  const int ntile = t_lo + min(nt, (z + 1) * per) - ta;
  const int* trow = DENSE ? nullptr : tables + (long long)b * mp;
  const long long layer_base = (long long)layer * num_pages1;
  const bool one_page = DENSE || ps % BK == 0;

  // tile t into stage st: BK rows x CH 16-byte copies, K and V (+ scales);
  // the pool row of key kp, or -1 for none (outside the live span, or an
  // unmapped page); a tile inside one page has contiguous rows
  auto load = [&](int t, int st) {
    unsigned char* kd = ring + (2 * st) * G::TILE;
    unsigned char* vd = kd + G::TILE;
    const int k0 = t * BK;
    long long base = -1;
    if (one_page) {
      const int page = DENSE ? b : trow[k0 / ps];
      if (page >= 0)
        base = ((layer_base + page) * kvn + g) * (long long)ps + k0 % ps;
    }
    auto row_of = [&](int kp) -> long long {
      if (kp < k_lo || kp >= n_keys) return -1;
      if (one_page) return base < 0 ? -1 : base + (kp - k0);
      const int page = trow[kp / ps];
      return page < 0 ? -1
                      : ((layer_base + page) * kvn + g) * (long long)ps +
                            kp % ps;
    };
    for (int i = tid; i < BK * G::CH; i += NT) {
      const int r = i / G::CH;
      const int c = i % G::CH;
      const long long row = row_of(k0 + r);
      const long long off = row < 0 ? 0 : row * D + c * EPC;
      cp_async16(kd + r * G::ROWB + c * 16, pool_k + off, row >= 0);
      cp_async16(vd + r * G::ROWB + c * 16, pool_v + off, row >= 0);
    }
    if (QUANT && tid < BK) {
      const long long row = row_of(k0 + tid);
      float* sd = scl + (2 * st) * BK;
      // zero-filled: the score and the V weight are 0
      cp_async4(sd + tid, ksp + (row < 0 ? 0 : row), row >= 0);
      cp_async4(sd + BK + tid, vsp + (row < 0 ? 0 : row), row >= 0);
    }
  };

  // PV ownership. Few rows (<= FEW): thread (c8, slice) = (tid % C8,
  // tid / C8) holds every row of the block for columns 8 * c8 .. + 8 over
  // the keys slice, slice + RSTEP, ...: each V chunk it loads serves all
  // its rows. More rows: unit u = (row u / C8, columns 8 * (u % C8)), a
  // thread's units u0 + j * NT share its columns (rows r_first + j *
  // RSTEP); with fewer units than threads, key slices share a unit.
  constexpr int RSTEP = NT / C8;
  const bool few = rows <= FEW;
  const int units = rows * C8;
  const int ks_n = few ? RSTEP : units >= NT ? 1 : NT / units;
  const int slice = few ? tid / C8 : units >= NT ? 0 : tid / units;
  const bool pv_on = slice < ks_n;
  const int u0 = few ? tid % C8 : units >= NT ? tid : tid - slice * units;
  const int c8 = u0 % C8;
  const int r_first = few ? 0 : u0 / C8;
  const int r_step = few ? 1 : RSTEP;
  const int n_acc = few ? rows : units >= NT ? (units - u0 + NT - 1) / NT : 1;
  float acc[FEW][8];
#pragma unroll
  for (int j = 0; j < FEW; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;

  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < ntile) load(ta + s, s);
    cp_async_commit();
  }
  __syncthreads();  // q, max and sum are in place

  for (int i = 0; i < ntile; ++i) {
    if constexpr (G::STAGES == 1) {  // f32 at D 256: load, then compute
      __syncthreads();               // tile i - 1 is read by all
      load(ta + i, 0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      cp_async_wait<G::STAGES - 2>();  // tile i has landed
      __syncthreads();                 // and tile i - 1 is read by all
      const int nx = i + G::STAGES - 1;
      if (nx < ntile) load(ta + nx, nx % G::STAGES);
      cp_async_commit();  // possibly empty: keeps the group count
    }
    const int st = i % G::STAGES;
    const unsigned char* kt = ring + (2 * st) * G::TILE;
    const unsigned char* vt = kt + G::TILE;
    const float* kscl = scl + (2 * st) * BK;
    const int k0 = (ta + i) * BK;

    // scores: PARTS threads a key of the tile (kk = tid / PARTS), each with
    // a quarter of its 8-element groups (in an order rotated by the part,
    // so a key's four threads read other banks), rows in groups of 4
    // against q in shared memory, the parts added by shuffles; window row
    // w = r / group sees keys below kv_len - wins + 1 + w and, with a
    // sliding window, above kv_len - wins + w - window
    {
      constexpr int GPP = D / 8 / PARTS;  // 8-element groups a part
      const int kk = tid / PARTS;
      const int part = tid % PARTS;
      const unsigned char* krow = kt + kk * G::ROWB;
      const int kp = k0 + kk;
      const float ks = QUANT ? kscl[kk] : 1.f;  // late dequant of K
      const float inv_cap = CAP ? 1.f / cap : 0.f;
      for (int r0 = 0; r0 < rows; r0 += 4) {
        float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int gi = 0; gi < GPP; ++gi) {
          const int e0 = (part * GPP + (gi + part) % GPP) * 8;
          float f[8];
          unpack8<P>(krow + e0 * G::ES, f);
          const float* qc = qs + r0 * D + e0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (r0 + j < rows) {
              const float4 qa = *reinterpret_cast<const float4*>(qc + j * D);
              const float4 qb =
                  *reinterpret_cast<const float4*>(qc + j * D + 4);
              float a = sacc[j];
              a = fmaf(qa.x, f[0], a);
              a = fmaf(qa.y, f[1], a);
              a = fmaf(qa.z, f[2], a);
              a = fmaf(qa.w, f[3], a);
              a = fmaf(qb.x, f[4], a);
              a = fmaf(qb.y, f[5], a);
              a = fmaf(qb.z, f[6], a);
              a = fmaf(qb.w, f[7], a);
              sacc[j] = a;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sc = sacc[j] + __shfl_xor_sync(0xffffffffu, sacc[j], 1);
          sc += __shfl_xor_sync(0xffffffffu, sc, 2);
          const int r = r0 + j;
          if (part == 0 && r < rows) {
            const int w = (row0 + r) / group;
            const bool live =
                kp >= k_lo && kp < n_keys && kp < kv_len - wins + 1 + w &&
                (window <= 0 || kp > kv_len - wins + w - window);
            float v = sc * scale * ks;
            if constexpr (CAP) v = cap * tanhf(v * inv_cap);
            pr[r * PSTR + kk] = live ? v : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 8, ...; lane keys lane and
    // lane + 32; masked keys (-inf) give p = 0
    for (int r = warp; r < rows; r += NT / 32) {
      const float s0 = pr[r * PSTR + lane];
      const float s1 = pr[r * PSTR + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float* vscl = kscl + BK;  // V scale folded into p
      pr[r * PSTR + lane] = QUANT ? p0 * vscl[lane] : p0;
      pr[r * PSTR + lane + 32] = QUANT ? p1 * vscl[lane + 32] : p1;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        al[r] = a;
        ls[r] = ls[r] * a + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // PV: rows r_first + j * r_step (j < n_acc), columns c8, keys slice,
    // slice + ks_n, ...: one V chunk load a key for all of them
    if (pv_on) {
#pragma unroll
      for (int j = 0; j < FEW; ++j) {
        if (j >= n_acc) break;
        const float a = al[r_first + j * r_step];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] *= a;
      }
      const unsigned char* vcol = vt + c8 * 8 * G::ES;
      const float* prow = pr + r_first * PSTR;
#pragma unroll 2
      for (int kk = slice; kk < BK; kk += ks_n) {
        float v[8];
        unpack8<P>(vcol + kk * G::ROWB, v);
#pragma unroll
        for (int j = 0; j < FEW; ++j) {
          if (j >= n_acc) break;
          const float p = prow[j * r_step * PSTR + kk];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(p, v[e], acc[j][e]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can remain

  // the rows' sums meet in fin [rows][D] (q's place, no longer read);
  // key slices add up through red (the ring, no longer read either)
  float* fin = qs;
  __syncthreads();
  if (ks_n == 1) {
#pragma unroll
    for (int j = 0; j < FEW; ++j) {
      if (!pv_on || j >= n_acc) break;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        fin[(r_first + j * r_step) * D + c8 * 8 + e] = acc[j][e];
    }
  } else {
    // slice s of unit (row r, columns c8) at red[(s * units + r * C8 + c8)
    // * 8]; rows one at a time when each thread holds all (few)
    const int passes = few ? rows : 1;
    for (int j = 0; j < passes; ++j) {
      const int r = r_first + j;
      if (pv_on) {
#pragma unroll
        for (int jj = 0; jj < FEW; ++jj) {
          if (jj == j) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              red[((slice * (few ? C8 : units)) + (few ? c8 : u0)) * 8 + e] =
                  acc[jj][e];
          }
        }
      }
      __syncthreads();
      const int width = few ? C8 : units;  // units a slice holds
      for (int i = tid; i < width * 8; i += NT) {
        float sum = 0.f;
        for (int sl = 0; sl < ks_n; ++sl) sum += red[sl * width * 8 + i];
        // i = unit * 8 + e: unit (row, columns) of this pass
        const int uu = i / 8;
        const int rr = few ? r : uu / C8;
        fin[rr * D + (uu % C8) * 8 + i % 8] = sum;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // write-out: each row's D columns, divided by l (one split) or as f32
  // partials with m and l (several)
  const long long n_rows = (long long)gridDim.x * wins * n_heads;
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D;
    const int d = i - r * D;
    const int rr = row0 + r;
    const int w = rr / group;
    const long long orow =
        ((long long)b * wins + w) * n_heads + g * group + rr - w * group;
    if (splits == 1) {
      out[orow * D + d] = sli::from_f<T>(fin[i] / fmaxf(ls[r], 1e-30f));
    } else {
      part[((long long)z * n_rows + orow) * D + d] = fin[i];
      if (d == 0) {
        float* pm = part + (long long)splits * n_rows * D +
                    ((long long)z * n_rows + orow) * 2;
        pm[0] = ms[r];
        pm[1] = ls[r];
      }
    }
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
  float* part;
  int batch, layer, num_pages1, kvn, ps, mp, group, wins, window, splits;
  float scale, cap;
  const float* sinks;  // null, or the layer's f32 sink logits [kvn * group]
};

template <typename T, typename P, int D, bool DENSE, bool CAP>
int launch(const Args& a, cudaStream_t st) {
  const int rows = a.group * a.wins;
  const int rcap = rows < RB ? rows : RB;
  const size_t bytes = Geo<P, D>::bytes(rcap);
  if (bytes > 227 * 1024) return SLI_ERR_SHAPE;
  if (a.splits < 1 || (a.splits > 1 && a.part == nullptr))
    return SLI_ERR_SHAPE;
  cudaError_t e =
      sli::allow_smem(paged_decode_kernel<T, P, D, DENSE, CAP>, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.batch, a.kvn * ((rows + RB - 1) / RB), a.splits);
  paged_decode_kernel<T, P, D, DENSE, CAP><<<grid, NT, bytes, st>>>(
      (const T*)a.q, a.q_bs, a.q_ss, (const P*)a.pool_k, (const P*)a.pool_v,
      a.ksp, a.vsp, a.tables, a.kv_lens, (T*)a.out, a.part, a.layer,
      a.num_pages1, a.kvn, a.ps, a.mp, a.group, a.wins, a.window, rcap,
      a.scale, a.cap, a.sinks);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const long long n_rows = (long long)a.batch * a.wins * a.kvn * a.group;
  return (int)sli::launch_merge<T>(a.part, a.out, n_rows, D, a.splits, st);
}

// The cap (CAP) only over pools of q's own dtype; D 256 (Gemma) only over
// pools of q's own dtype: the INT8-KV and e4m3 forms take D <= 128 (the
// wrappers raise for them).
template <typename T, typename P, int D, bool DENSE>
int launch_c(const Args& a, cudaStream_t st) {
  if (a.sinks != nullptr && !std::is_same_v<T, P>) return SLI_ERR_DTYPE;
  if (a.cap <= 0.f) return launch<T, P, D, DENSE, false>(a, st);
  if constexpr (std::is_same_v<T, P>)
    return launch<T, P, D, DENSE, true>(a, st);
  else
    return SLI_ERR_DTYPE;
}

template <typename T, typename P, bool DENSE = false>
int dispatch_d(int head_dim, const Args& a, cudaStream_t st) {
  switch (head_dim) {
    case 32:
      return launch_c<T, P, 32, DENSE>(a, st);
    case 64:
      return launch_c<T, P, 64, DENSE>(a, st);
    case 128:
      return launch_c<T, P, 128, DENSE>(a, st);
    case 256:
      if constexpr (std::is_same_v<T, P>)
        return launch_c<T, P, 256, DENSE>(a, st);
      else
        return SLI_ERR_HEAD_DIM;
    default:
      return SLI_ERR_HEAD_DIM;
  }
}

}  // namespace

// Dense-arena decode (the flash_decode entry): q [B, N, D] at batch stride
// q_bs (elements); cache_k/v the dense arena [L, arena_rows, kvn, smax, D]
// of q's dtype, sequence b < batch <= arena_rows reading arena row b's
// slots [0, min(kv_len, smax)), or with window > 0 only the slots
// [kv_len - window, kv_len) of them (forms 13w, 13wc); cap: 0 for none,
// else the soft cap (> 0; forms 13c, 13wc); sinks: null for none, else
// the layer's f32 sink logits [N] (forms 13s, 13ws; D <= 128); out
// [B, N, D] contiguous. splits > 1: part holds splits * B * N * (D + 2)
// floats of workspace.
extern "C" int sli_flash_decode(const void* q, long long q_bs,
                                const void* cache_k, const void* cache_v,
                                const int* kv_lens, void* out, float* part,
                                int batch, int layer, int arena_rows, int kvn,
                                int smax, int group, int head_dim, int window,
                                int splits, float scale, float cap, int dtype,
                                const float* sinks, void* stream) {
  if (batch <= 0 || kvn <= 0 || group <= 0 || smax <= 0 ||
      batch > arena_rows || window < 0 || cap < 0.f)
    return SLI_ERR_SHAPE;
  if (sinks != nullptr && head_dim > 128) return SLI_ERR_HEAD_DIM;
  cudaStream_t st = (cudaStream_t)stream;
  // one "page" of smax slots per sequence, one window row, no scales
  const Args a{q, q_bs, 0LL, cache_k, cache_v, nullptr, nullptr, nullptr,
               kv_lens, out, part, batch, layer, arena_rows, kvn, smax, 1,
               group, 1, window, splits, scale, cap, sinks};
  if (dtype == SLI_F32) return dispatch_d<float, float, true>(head_dim, a, st);
  if (dtype == SLI_BF16)
    return dispatch_d<__nv_bfloat16, __nv_bfloat16, true>(head_dim, a, st);
  return SLI_ERR_DTYPE;
}

template <typename T>
int dispatch_pool(int pool, int head_dim, const Args& a, cudaStream_t st) {
  switch (pool) {
    case SLI_POOL_I8:
      return dispatch_d<T, int8_t>(head_dim, a, st);
    case SLI_POOL_E4M3:
      return dispatch_d<T, __nv_fp8_e4m3>(head_dim, a, st);
    default:  // bf16 or f32 pools: q's own dtype
      return pool == (std::is_same_v<T, float> ? SLI_POOL_F32 : SLI_POOL_BF16)
                 ? dispatch_d<T, T>(head_dim, a, st)
                 : SLI_ERR_DTYPE;
  }
}

// pool: the pools' dtype (SLI_POOL_*): q's dtype, e4m3 (forms 4e, 4ve), or
// int8 with k_scale/v_scale, their f32 scale pools [L, num_pages1, kvn,
// ps] (null for every other pool dtype). q: [B, wins, N, D] with strides
// q_bs, q_ss (elements); wins = 1 is decode. window: 0 for none, else the
// sliding window (>= 1); cap: 0 for none, else the soft cap (> 0; pools
// of q's dtype only); sinks: null for none, else the layer's f32 sink
// logits [N] (decode and verify rows over pools of q's dtype, D <= 128;
// a row's sink is its head's, whatever its window row). splits > 1:
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
  if (dtype == SLI_F32) return dispatch_pool<float>(pool, head_dim, a, st);
  if (dtype == SLI_BF16)
    return dispatch_pool<__nv_bfloat16>(pool, head_dim, a, st);
  return SLI_ERR_DTYPE;
}
