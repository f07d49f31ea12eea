// Prefill attention on the H100's bf16 tensor cores (wgmma), shared by the
// bf16 forms of kernel 3 (flash_prefill.cu: 3, 3w) and kernel 8
// (paged_prefill.cu: 8, 8q, 8e, 8w, 8qw, 8ew and their capped and sink
// forms; the kernels themselves in paged_prefill.cuh).
// Each .cu file gives the rows of
// its keys (a Src: a dense [B, S, kvN, D] array, or pages through a block
// table) and launches attend<D, KV, Src> for its pools' kind (KV_BF16,
// KV_I8, KV_E4M3); the f32 forms keep their FMA kernels (TF32 would not
// hold f32's tolerance).
//
// Tiles. A block is one warpgroup (128 threads) and one 64-row tile of
// queries that packs 64 / H positions x H q heads of one kv head (H =
// min(group, 64); a group of more than 64 heads takes several head
// chunks): Llama-2 (group 1) 64 x 1, Mistral (4) 16 x 4, TinyLlama (8)
// 8 x 8. Row r is position p0 + r / H, head kh * group + hc * H + r % H.
// Every K/V byte a tile reads serves the whole group, and a window tile's
// key walk covers window + 64 / H - 1 keys. The walk runs from the oldest
// row's band start k_lo (0 without a window) to the newest row's last key
// (its position, or min(kv_len, MP * ps) - 1) in 64-key tiles; with
// `splits` > 1 each block walks one run of whole tiles
// (ceil(tiles / splits) each) and writes f32 partials (acc, m, l) that
// split_merge.cuh's merge_kernel adds by log-sum-exp. Tiles, walk and
// splits are ops/attention/prefill_tiles.py's arithmetic, which the CPU
// tests hold.
//
// Copies. K/V rows come in through a two-stage cp.async ring, 16 bytes a
// copy, a warp on whole rows (consecutive threads on consecutive chunks);
// each row's address is the Src's, from its page in the table: a page is
// fetched one tile ahead into a register, and the tile's row addresses go
// to a table in shared memory before the barrier that precedes the
// copies. A row outside [k_lo, last_key], past the keys or in an unmapped
// (-1) page, and a Q row past Sq or the group, is zero-filled by the copy
// (src-size 0) and never read: with tensor cores a masked key still enters
// the product (p = 0), and 0 x NaN would be NaN. bf16 tiles land in the
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8); rows of D > 64
// in 128-byte slabs) or, at D = 32, the 64-byte one (c ^ (r / 2 % 4)).
// INT8 KV (KV_I8): the codes and each row's f32 scales land unswizzled;
// after a barrier the block converts them, code x scale in f32 rounded to
// bf16 (the TPU kernel's page dequant, paged_prefill.py:105-110), into
// swizzled K and V tiles, then fence.proxy.async and a second barrier
// before the wgmma. FP8 KV (KV_E4M3, form 8e): the e4m3 codes land
// the same way, with no scales, and convert exactly to bf16 (e4m3 -> f16 ->
// f32 -> bf16, each step exact: e4m3's 4 significant bits and exponents
// 2^-9 .. 2^8 fit bf16), which is the TPU kernel's cast of its page slabs
// to q's dtype (paged_prefill.py:108-110).
//
// Products. S = Q K^T: wgmma.m64n64k16, Q and K both K-major from shared
// memory (D / 16 steps), f32. Online softmax in f32 on the fragments, in
// log2 units (scale x log2 e), a masked key at p = 0 (no mask where both
// of a thread's rows see the whole tile).
//
// Soft cap (Gemma-2's attn_logit_softcapping; template flag CAP, the
// uncapped forms keep the one multiply by scale x log2 e): each live
// score becomes cap * tanh(s * scale * (1 / cap)), the TPU kernels'
// order (flash_prefill.py:65-68, paged_prefill.py:121-124), then x log2
// e; a masked key stays -1e30 (p = 0), never -cap. tanh is tanhf (CUDA's
// full-precision tanh, 2 ulp), not tanh.approx.f32: the approximation's
// relative error of about 2^-11 is an absolute error of up to cap x
// 2^-11 = 0.024 in a capped score at cap 50, which moves p by 2.4%, six
// bf16 ulps, where the one-ulp rule below leaves about one; tanhf's
// error is about 6e-6 there. O += P V:
// wgmma.m64n{D}k16, P from registers as A, V as B from the same [key][d]
// tile in the MN-major (transposed) mode. The TPU kernel rounds P to the
// value dtype before this product (p.astype(v.dtype),
// flash_prefill.py:89; paged_prefill.py:142); here P is split into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi) and both go through the tensor
// cores into the one f32 accumulator, so P keeps about 16 bits and the
// outputs stay within one bf16 ulp of the plain f32-P version (rounding P
// alone misses that rule many times over at the serving shapes:
// tests/test_torch_prefill_tiles.py).
//
// Sinks (GPT-OSS; sinks != nullptr: the layer's f32 logit of each q head,
// forms 3s, 3ws, 8s, 8ws): a sink joins a row's softmax denominator and adds
// no value, so each row's state starts at (m, l) = (sink x log2 e, 1)
// instead of (-1e30, 0), the TPU kernels' seed (flash_prefill.py:37-43,
// paged_prefill.py:259). The sink is a raw logit: neither scaled nor
// capped, only moved into the log2 units the softmax runs in (cap x
// log2 e caps a capped score in the same units). Of a split walk only
// split 0 seeds its rows, so the merge counts the sink once; its partial
// m leaves in natural-log units (x ln 2) as every split's does, and a
// split 0 that meets no key still carries (sink, 1) into the merge. A
// fragment row's head is the tile's (kh, hc, r % H), the head its output
// goes to; with l = 1 held by one thread of the quad (the quad adds its
// four shares at the end). A masked key keeps p = ex2(-1e30 - m) = 0,
// and a row that meets no key gives acc 0 / l 1 = 0, as the TPU kernel's
// (acc 0 / l 1). Over INT8 KV (forms 8qs, 8qws) and e4m3 pools (8es,
// 8ews) nothing changes: the scales and the exact e4m3 -> bf16 conversion
// act in convert() on the K and V rows, before any score, so the sink
// stays outside them. Head dims 32, 64 (gpt-oss-20b's) and 128: no
// model with sinks has D 256, whose instantiations sit at 255 registers a
// thread and spill (ptxas: 128 bytes in flash_prefill_mma_kernel<256>,
// with or without the seeding), so the seeding is compiled out there,
// their code stays as it was, and the entry points refuse sinks at D 256.
//
// D 256 (Gemma-2B: 8 q heads over one kv head, so a tile packs 8
// positions x 8 heads, as TinyLlama's at D 64; Gemma-2-2B: 2 over each of
// 4, 32 positions x 2 heads), bf16, int8 and e4m3 pools, with or without a
// window and the cap: S = QK^T takes 16 k-steps of m64n64k16;
// O += PV is one
// wgmma.m64n256k16 a 16-key step (P from registers, V as B in four
// 64-column slabs at the slab stride, the same descriptor as n128's two),
// for p_hi and again for p_lo. Its accumulator is float[128] a thread,
// on top of S (32), the P fragments (32: hi and lo kept, the one-ulp
// rule needs both) and the softmax state; a one-warpgroup block may use
// 255 registers a thread, and chip_smoke's build prints ptxas's count and
// spills for each instantiation. Shared memory: Q 32 KB, two stages of K
// and V at 64 KB each, the row tables and the 1 KB alignment pad: 165,888
// bytes (Smem<256, KV_BF16>::BYTES), so one block an SM; every 16-byte
// chunk lands in the 128-byte swizzle of its 64-column slab (four slabs a
// row). Bound at Gemma's prefill (a 128-row prompt, 8 heads): bytes, as
// for D 128; at the 512-key prefix chunks the tensor cores (4 x 8 x 256
// operations a (row, key) pair, 6 with P's two parts). D 256 over INT8 KV
// (KV_I8; Gemma over INT8 KV, forms 8q, 8qw, 8qc, 8qwc at D 256): the
// stages hold the codes and scales (2 x 33,280 bytes) and the converted K
// and V tiles take 64 KB more, 166,912 bytes in all (Smem<256,
// KV_I8>::BYTES), still one block an SM; the registers are the bf16
// form's and convert()'s, and chip_smoke's build prints ptxas's count and
// spills for them as for every instantiation. D 256 over e4m3 pools
// (KV_E4M3; Gemma over FP8 KV, forms 8e, 8ew, 8ec, 8ewc at D 256): the
// stages hold the codes alone (2 x 32,768 bytes) beside the converted
// tiles, 165,888 bytes (Smem<256, KV_E4M3>::BYTES); convert() turns each
// 4-byte word of codes into four exact bf16 values, as at D 128, so the
// registers are those of the int8 form less its scale.
#pragma once

#include "common.cuh"
#include "split_merge.cuh"

namespace sli {
namespace pfa {

constexpr int TILE = 64;  // rows of a packed query tile, keys of a key tile
constexpr int NT = 128;   // one warpgroup a block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// the pools' kind: bf16 rows, or 1-byte codes converted in the block
constexpr int KV_BF16 = 0;
constexpr int KV_I8 = 1;    // int8 codes x their rows' f32 scales
constexpr int KV_E4M3 = 2;  // e4m3 codes, exact

// A bf16 [64][D] tile in shared memory.
template <int D>
struct Geo {
  static constexpr int RB = D >= 64 ? 128 : 64;  // bytes of a swizzled row
  static constexpr int SLAB = TILE * RB;          // bytes of a 64-row slab
  static constexpr int BYTES = TILE * 2 * D;
  static constexpr int CH = 2 * D / 16;           // 16-byte chunks, bf16 row
  static constexpr int CH8 = D / 16;              // 16-byte chunks, int8 row
  static constexpr unsigned long long SW = RB == 128 ? 1ull : 2ull;
  // int8 stage: K and V codes [64][D], then their rows' scales [2][64]
  static constexpr int Q8_STAGE = 2 * TILE * D + 2 * TILE * 4;
};

template <int D, int KV>
struct Smem {
  using G = Geo<D>;
  static constexpr bool CODES = KV != KV_BF16;
  static constexpr int STAGE = KV == KV_I8     ? G::Q8_STAGE
                               : KV == KV_E4M3 ? 2 * TILE * D
                                               : 2 * G::BYTES;
  // 1024: the base is rounded up to the swizzle atom; Q, two stages, for
  // 1-byte codes the converted K and V tiles, then the two stages' row
  // tables
  static constexpr int ROWS =
      G::BYTES + 2 * STAGE + (CODES ? 2 * G::BYTES : 0);
  static constexpr int BYTES = 1024 + ROWS + 2 * TILE * 8;
};

// byte offset of 16-byte chunk c of row r in a swizzled [64][D] tile
template <int D>
__device__ __forceinline__ int chunk_at(int r, int c) {
  using G = Geo<D>;
  constexpr int PER = G::RB / 16;
  const int swz = G::RB == 128 ? (r & 7) : ((r >> 1) & 3);
  return (c / PER) * G::SLAB + r * G::RB + (((c % PER) ^ swz) << 4);
}

__device__ __forceinline__ unsigned long long desc(const void* p,
                                                   unsigned lbo,
                                                   unsigned sbo,
                                                   unsigned long long sw) {
  const unsigned long long a = (unsigned)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFFull) >> 4) | ((unsigned long long)(lbo >> 4) << 16) |
         ((unsigned long long)(sbo >> 4) << 32) | (sw << 62);
}

// K-major operand (Q as A, K as B: rows of D contiguous) at k-step kk
template <int D>
__device__ __forceinline__ unsigned long long kmajor(const unsigned char* t,
                                                     int kk) {
  using G = Geo<D>;
  return desc(t + (kk * 32 / G::RB) * G::SLAB + (kk * 32) % G::RB, 16,
              8 * G::RB, G::SW);
}

// MN-major operand (V [key][d] as B of O += P V) at k-step kk (16 keys):
// 8-key groups 8 rows apart (SBO), 64-column slabs a slab apart (LBO)
template <int D>
__device__ __forceinline__ unsigned long long mnmajor(const unsigned char* t,
                                                      int kk) {
  using G = Geo<D>;
  return desc(t + kk * 16 * G::RB, G::SLAB, 8 * G::RB, G::SW);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));  // 0: zero-fill, nothing read
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register definitions into (or reads out
// of) a wgmma batch.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(unsigned (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A score's units: log2 (the softmax runs on ex2). Uncapped: mul =
// scale x log2 e, one multiply. Capped: mul = scale, inv_cap = 1 / cap,
// cap_l2 = cap x log2 e.
struct Score {
  float mul, inv_cap, cap_l2;
};

__host__ inline Score make_score(float scale, float cap) {
  if (cap > 0.f)
    return {scale, (float)(1.0 / (double)cap), cap * LOG2E};
  return {scale * LOG2E, 0.f, 0.f};
}

template <bool CAP>
__device__ __forceinline__ float score(float s, const Score& c) {
  if constexpr (CAP) return tanhf(s * c.mul * c.inv_cap) * c.cap_l2;
  return s * c.mul;
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// S[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory
// (descriptors); scale_d 0 zeroes the accumulators first.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
                                            unsigned long long da,
                                            unsigned long long db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x 32] += A[64 x 16] B[16 x 32]: A from registers (the m64k16
// fragment), B MN-major in shared memory (the transposed mode).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const unsigned (&a)[4],
                                            unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (the m64k16
// fragment), B MN-major in shared memory (the transposed mode).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4],
                                            unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (the m64k16
// fragment), B MN-major in shared memory (the transposed mode).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const unsigned (&a)[4],
                                            unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x 256] += A[64 x 16] B[16 x 256]: A from registers (the m64k16
// fragment), B MN-major in shared memory (the transposed mode); D 256's
// 128 accumulators a thread.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const unsigned (&a)[4],
                                             unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const unsigned (&a)[4],
                                         unsigned long long db) {
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  if constexpr (D == 256) wgmma_rs_n256(d, a, db);
}

// The block's tile of queries and the run of key tiles it walks.
struct Walk {
  int H, P, hc, kh, p0;     // packing: H heads x P positions from p0
  int k_lo, last_key;       // keys k_lo .. last_key (none if last < lo)
  int ta, tb;               // this split's key tiles [ta, tb)
};

// blockIdx: x = position tile * head chunks + head chunk, y = kv head,
// z = sequence * splits + split
__device__ __forceinline__ Walk walk(int seq, int group, int off, int n_keys,
                                     int window, int splits) {
  Walk w;
  w.H = min(group, TILE);
  w.P = TILE / w.H;
  const int chunks = (group + w.H - 1) / w.H;
  w.hc = blockIdx.x % chunks;
  w.p0 = blockIdx.x / chunks * w.P;
  w.kh = blockIdx.y;
  const int newest = min(w.p0 + w.P, seq) - 1;
  w.last_key = min(off + newest, n_keys - 1);
  w.k_lo = window > 0 ? max(0, off + w.p0 - window + 1) : 0;
  const int nkt =
      w.last_key < w.k_lo ? 0 : (w.last_key - w.k_lo) / TILE + 1;
  const int per = (nkt + splits - 1) / splits;
  const int z = blockIdx.z % splits;
  w.ta = min(nkt, z * per);
  w.tb = min(nkt, (z + 1) * per);
  return w;
}

// Attention of one packed query tile over its run of key tiles.
//   q: this sequence's [Sq, N, D] rows (element stride q_ss, heads
//   contiguous, 16-byte aligned); src: its K/V rows (see the .cu files);
//   out: this sequence's [Sq, N, D] (contiguous), written when splits == 1;
//   work: else split_merge.cuh's f32 partials over the B * Sq * N rows.
// Query row at position s sits at off + s and sees keys k <= off + s,
// k < n_keys and, with a window, k > off + s - window. sc: the scores'
// scale (and cap, with CAP), make_score's. sinks: null, or the layer's
// f32 sink logit of each of the heads q heads (see the note).
template <int D, int KV, bool CAP, typename Src>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ q,
                                       long long q_ss, const Src& src,
                                       __nv_bfloat16* __restrict__ out,
                                       float* __restrict__ work, int batch,
                                       int b, int seq, int heads, int group,
                                       int off, int n_keys, int window,
                                       Score sc, int splits,
                                       const float* __restrict__ sinks) {
  using G = Geo<D>;
  using S = Smem<D, KV>;
  constexpr bool CODES = S::CODES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(smem_raw) &
                           1023)) & 1023);
  unsigned char* qs = sm;
  unsigned char* stages = qs + G::BYTES;
  unsigned char* kc = stages + 2 * S::STAGE;  // CODES: converted K, then V
  unsigned char* vc = kc + G::BYTES;

  long long* rowtab = (long long*)(sm + S::ROWS);  // [2][64]: -1 zeros
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Walk w = walk(seq, group, off, n_keys, window, splits);
  const int z = blockIdx.z % splits;

  // the query tile: consecutive threads on consecutive chunks of a row
  for (int i = tid; i < TILE * G::CH; i += NT) {
    const int r = i / G::CH;
    const int c = i % G::CH;
    const int pl = r / w.H;
    const int hg = w.hc * w.H + r % w.H;
    const int s = w.p0 + pl;
    const bool ok = pl < w.P && s < seq && hg < group;
    const __nv_bfloat16* row =
        ok ? q + (long long)s * q_ss + (long long)(w.kh * group + hg) * D : q;
    cp16(qs + chunk_at<D>(r, c), row + c * 8, ok);
  }

  // key tile t's row tid (threads below 64): the Src's cursor on it (its
  // page's column and row, advanced 64 keys a tile), its page fetched one
  // tile ahead, then its row, or -1 outside the walk or in an unmapped page
  auto live = [&](int t) {
    return t < w.tb && w.k_lo + t * TILE + tid <= w.last_key;
  };

  // the copies of the tile whose rows stand in rowtab[st], into stage st:
  // a warp covers whole rows, 16 bytes a thread
  auto load = [&](int st) {
    unsigned char* sb = stages + st * S::STAGE;
    const long long* rt = rowtab + st * TILE;
    if constexpr (CODES) {
#pragma unroll
      for (int it = 0; it < TILE * G::CH8 / NT; ++it) {
        const int i = it * NT + tid;
        const int r = i / G::CH8;
        const int c = i % G::CH8;
        const long long row = rt[r];
        const bool ok = row >= 0;
        const long long at = ok ? row : 0;
        cp16(sb + r * D + c * 16, (const int8_t*)src.k(at) + c * 16, ok);
        cp16(sb + (TILE + r) * D + c * 16, (const int8_t*)src.v(at) + c * 16,
             ok);
      }
      if constexpr (KV == KV_I8) {
        const long long row = rt[tid & (TILE - 1)];
        const long long at = row >= 0 ? row : 0;
        cp4((float*)(sb + 2 * TILE * D) + tid,
            tid < TILE ? src.ksc(at) : src.vsc(at), row >= 0);
      }
    } else {
#pragma unroll
      for (int it = 0; it < TILE * G::CH / NT; ++it) {
        const int i = it * NT + tid;
        const int r = i / G::CH;
        const int c = i % G::CH;
        const long long row = rt[r];
        const bool ok = row >= 0;
        const long long at = ok ? row : 0;
        cp16(sb + chunk_at<D>(r, c),
             (const __nv_bfloat16*)src.k(at) + c * 8, ok);
        cp16(sb + G::BYTES + chunk_at<D>(r, c),
             (const __nv_bfloat16*)src.v(at) + c * 8, ok);
      }
    }
  };

  // CODES: stage st's codes (INT8: x their rows' scales, rounded to bf16;
  // e4m3: exact) into the swizzled K and V tiles (after the barrier: any
  // thread's copies)
  auto convert = [&](int st) {
    const unsigned char* sb = stages + st * S::STAGE;
    const float* sc = (const float*)(sb + 2 * TILE * D);
#pragma unroll
    for (int it = 0; it < 2 * TILE * G::CH8 / NT; ++it) {
      const int i = it * NT + tid;
      const int kv = i / (TILE * G::CH8);
      const int r = i / G::CH8 % TILE;
      const int c = i % G::CH8;
      const uint4 raw = *(const uint4*)(sb + (kv * TILE + r) * D + c * 16);
      const unsigned wd[4] = {raw.x, raw.y, raw.z, raw.w};
      unsigned o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        if constexpr (KV == KV_I8) {
          const float scale = sc[kv * TILE + r];
          i8x4_to_f32(wd[j], f);  // exact codes
#pragma unroll
          for (int e = 0; e < 4; ++e) f[e] *= scale;
        } else {
          const float2 a = e4m3x2_to_f2((unsigned short)(wd[j] & 0xffffu));
          const float2 b = e4m3x2_to_f2((unsigned short)(wd[j] >> 16));
          f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
        }
        o[2 * j] = bf16x2(f[0], f[1]);
        o[2 * j + 1] = bf16x2(f[2], f[3]);
      }
      unsigned char* dst = kv ? vc : kc;
      *(uint4*)(dst + chunk_at<D>(r, 2 * c)) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *(uint4*)(dst + chunk_at<D>(r, 2 * c + 1)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  // this thread's fragment rows r0 = 16 * warp + lane / 4 and r0 + 8
  const int t4 = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);
  // split 0 seeds each row with its sink (not at D 256: see the note)
  if constexpr (D < 256) {
    if (sinks != nullptr && z == 0) {
      const int hg0 = w.hc * w.H + r0 % w.H;
      const int hg1 = w.hc * w.H + (r0 + 8) % w.H;
      if (hg0 < group) {
        m0 = sinks[w.kh * group + hg0] * LOG2E;
        l0 = t4 == 0 ? 1.f : 0.f;
      }
      if (hg1 < group) {
        m1 = sinks[w.kh * group + hg1] * LOG2E;
        l1 = t4 == 0 ? 1.f : 0.f;
      }
    }
  }
  const int qp0 = off + w.p0 + r0 / w.H;
  const int qp1 = off + w.p0 + (r0 + 8) / w.H;
  const int hi0 = min(qp0, n_keys - 1);
  const int hi1 = min(qp1, n_keys - 1);
  const int lo0 = window > 0 ? qp0 - window + 1 : 0;
  const int lo1 = window > 0 ? qp1 - window + 1 : 0;
  const int lo_max = max(lo0, lo1);
  const int hi_min = min(hi0, hi1);

  // cur: tile t + 1's row tid (its page in pg); nxt: tile t + 2's
  auto cur = src.cursor(w.k_lo + w.ta * TILE + tid);
  int pg = -1;
  if (tid < TILE) {
    rowtab[tid] = live(w.ta) ? src.row(cur, src.page(cur)) : -1;
    src.advance(cur);
    if (live(w.ta + 1)) pg = src.page(cur);
  }
  auto nxt = cur;
  src.advance(nxt);
  __syncthreads();
  if (w.ta < w.tb) load(0);
  cp_commit();
  for (int t = w.ta; t < w.tb; ++t) {
    const int st = (t - w.ta) & 1;
    if (tid < TILE) {  // tile t + 1's rows; tile t + 2's page on its way
      rowtab[(st ^ 1) * TILE + tid] = live(t + 1) ? src.row(cur, pg) : -1;
      cur = nxt;
      pg = live(t + 2) ? src.page(cur) : -1;
      src.advance(nxt);
    }
    cp_wait_all();
    if constexpr (CODES) {
      __syncthreads();
      convert(st);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the other stage's readers (tile t - 1's products) are done
    if (t + 1 < w.tb) load(st ^ 1);
    cp_commit();

    const unsigned char* kt = CODES ? kc : stages + st * S::STAGE;
    const unsigned char* vt = CODES ? vc : kt + G::BYTES;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor<D>(qs, kk), kmajor<D>(kt, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // mask (not where both rows see the whole tile), row max over the
    // quad's 64 keys, p in log2 units
    const int kb = w.k_lo + t * TILE;
    const int k0 = kb + 2 * t4;
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (kb >= lo_max && kb + TILE - 1 <= hi_min) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = score<CAP>(s[4 * j + e], sc);
          s[4 * j + e] = v;
          if (e < 2) mx0 = fmaxf(mx0, v);
          else mx1 = fmaxf(mx1, v);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + (e & 1);
          const bool ok = e < 2 ? (kp >= lo0 && kp <= hi0)
                                : (kp >= lo1 && kp <= hi1);
          const float v = ok ? score<CAP>(s[4 * j + e], sc) : NEG_INF;
          s[4 * j + e] = v;
          if (e < 2) mx0 = fmaxf(mx0, v);
          else mx1 = fmaxf(mx1, v);
        }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // a row that has seen no key yet subtracts 0: its masked keys (-1e30)
    // still give p = 0, and so does its old sum's factor
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float ms0 = mn0 <= NEG_INF ? 0.f : mn0;
    const float ms1 = mn1 <= NEG_INF ? 0.f : mn1;
    const float al0 = ex2(m0 - ms0);
    const float al1 = ex2(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * j + e] - (e < 2 ? ms0 : ms1));
        s[4 * j + e] = p;
        if (e < 2) rs0 += p;
        else rs1 += p;
      }
    l0 = l0 * al0 + rs0;  // this thread's share; the quad adds at the end
    l1 = l1 * al1 + rs1;

    // P as the A fragments of 4 k-steps, split hi + lo (see the note)
    unsigned ph[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float a = s[8 * kk + 2 * x];
        const float c = s[8 * kk + 2 * x + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
        const float2 hf = __bfloat1622float2(h);
        ph[kk][x] = *reinterpret_cast<const unsigned*>(&h);
        plo[kk][x] = bf16x2(a - hf.x, c - hf.y);
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(plo[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<D>(o, ph[kk], mnmajor<D>(vt, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, plo[kk], mnmajor<D>(vt, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(o);
  }
  cp_wait_all();

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    const int pl = r / w.H;
    const int hg = w.hc * w.H + r % w.H;
    const int s = w.p0 + pl;
    if (pl >= w.P || s >= seq || hg >= group) continue;
    const long long row = (long long)s * heads + w.kh * group + hg;
    const float l = hr ? l1 : l0;
    if (splits == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      __nv_bfloat16* orow = out + row * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *(unsigned*)(orow + 8 * j) =
            bf16x2(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
    } else {  // split_merge.cuh's partials, m in natural-log units
      const long long n_rows = (long long)batch * seq * heads;
      const long long at = (long long)z * n_rows + (long long)b * seq * heads +
                           row;
      float* acc = work + at * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *(float2*)(acc + 8 * j) =
            make_float2(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]);
      if (t4 == 0) {
        float* ml = work + (long long)splits * n_rows * D + at * 2;
        ml[0] = (hr ? m1 : m0) * LN2;
        ml[1] = l;
      }
    }
  }
}

}  // namespace pfa
}  // namespace sli
