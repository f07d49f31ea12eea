// The body of kernels 4 and 13 (paged flash decode, the verify window and
// the dense arena): the kernel, its launch and its dispatch over head dims
// and options, included by paged_decode.cu (the entry points; its note
// says what the kernel replaces, what bounds it and how it is built), by
// paged_decode_i8.cu, by paged_decode_e4m3.cu and by flash_decode_e4m3.cu,
// which instantiate the INT8-KV forms, the paged FP8-KV forms and the
// dense arena's FP8-KV forms in translation units of their own so that
// nvcc builds the four in parallel.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "split_merge.cuh"

namespace sli_pd {

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

// The INT8-KV forms (int8 pools with their scale pools) for bf16 or f32 q
// (``f32``), defined in paged_decode_i8.cu.
int dispatch_i8(bool f32, int head_dim, const Args& a, cudaStream_t st);
// The FP8-KV forms (e4m3 pools), defined in paged_decode_e4m3.cu.
int dispatch_e4m3(bool f32, int head_dim, const Args& a, cudaStream_t st);
// The FP8-KV forms of the dense arena (kernel 13 over an e4m3 arena),
// defined in flash_decode_e4m3.cu.
int dispatch_e4m3_dense(bool f32, int head_dim, const Args& a,
                        cudaStream_t st);
// The shared-KV form 4l (one pool of q's dtype, key row == value row,
// pool_v unused), defined in paged_decode_shared.cu.
int dispatch_shared(bool f32, int head_dim, const Args& a, cudaStream_t st);

}  // namespace sli_pd

namespace {

using sli_pd::Args;


constexpr int BK = 64;         // keys per tile
constexpr int NT = 256;        // threads per block
constexpr int PARTS = NT / BK; // threads a key in the score phase
constexpr int RB = 32;         // query rows a block holds at most
constexpr int FEW = 8;         // rows every thread holds in PV (and the
                               // most units a thread holds past them)
constexpr int PSTR = BK + 1;   // probability row stride (floats)
constexpr float NEG_INF = -1e30f;
static_assert(PARTS == 4, "the score phase adds four parts a key");

// Query rows a block holds at head dim D: RB, or 16 past D 256 (the
// absorbed-MLA latent rows, D 640: 16 rows of q in f32 are 40 KB beside
// the key stages, and a thread's PV units, rows r_first + j * (NT / (D /
// 8)) at one column group, stay within FEW).
template <int D>
__host__ __device__ constexpr int row_block() {
  return D > 256 ? 16 : RB;
}

// Stages of the ring: 4 for 1-byte codes, 3 for bf16, 2 for f32; at D 256
// one fewer for bf16 and f32 (a bf16 stage of K and V is 66 KB there, an
// f32 one 130 KB: 2 bf16 stages and the q, probability and state arrays of
// 32 rows make 173 KB, one f32 stage 171 KB, within the 227 KB a block
// may take; the card holds one such block an SM, and one 64-key tile in
// flight then still covers the SM's share of the memory rate).
// A shared-KV pool (SHARED, form 4l) stages K tiles alone, the PV phase
// reading the same tile: at D 640 a bf16 stage of 64 keys is 82,944
// bytes, so two stages and 16 rows' q, probability and state arrays make
// 211,712 bytes; an f32 stage is 164,864 bytes, one stage (loaded, then
// computed).
template <int ES, int D, bool SHARED = false>
constexpr int stages() {
  if (SHARED && D > 256) return ES == 2 ? 2 : 1;
  return ES == 1 ? 4 : (ES == 2 ? 3 : 2) - (D >= 256 ? 1 : 0);
}

template <typename P, int D, bool SHARED = false>
struct Geo {
  static constexpr int ES = (int)sizeof(P);
  static constexpr int ROWB = D * ES + 16;  // padded key row bytes
  static constexpr int TILE = BK * ROWB;    // one K or V tile
  static constexpr int CH = D * ES / 16;    // 16-byte chunks of a key row
  static constexpr int NKV = SHARED ? 1 : 2;  // tiles a stage (K, V)
  static constexpr int STAGES = stages<ES, D, SHARED>();
  static_assert(STAGES * NKV * TILE >= NT * 8 * (int)sizeof(float),
                "the key slices' reduction fits the ring");
  // ring (K, V tiles and their scales; after the walk, the key slices'
  // reduction), q, the probabilities, max, sum and rescale
  static size_t bytes(int rows) {
    return (size_t)STAGES * NKV * TILE + (size_t)STAGES * 2 * BK *
           sizeof(float) + sizeof(float) * ((size_t)rows * D +
                                            (size_t)rows * PSTR +
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
// rows of the shared-memory layout (min(row_block<D>(), group * wins)).
// splits > 1: the block writes part (acc [splits][B*S*N][D], then m, l
// [splits][B*S*N][2], f32) for merge_kernel; splits == 1: out. SHARED:
// one pool (pool_k) whose row is the key and the value; pool_v unused.
template <typename T, typename P, int D, bool DENSE, bool CAP,
          bool SHARED = false>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, long long q_bs, long long q_ss,
    const P* __restrict__ pool_k, const P* __restrict__ pool_v,
    const float* __restrict__ ksp, const float* __restrict__ vsp,
    const int* __restrict__ tables, const int* __restrict__ kv_lens,
    T* __restrict__ out, float* __restrict__ part, int layer,
    int num_pages1, int kvn, int ps, int mp, int group, int wins, int window,
    int rcap, float scale, float cap, const float* __restrict__ sinks) {
  using G = Geo<P, D, SHARED>;
  constexpr bool QUANT = std::is_same_v<P, int8_t>;  // scales beside codes
  constexpr int EPC = 16 / G::ES;  // elements per 16-byte copy
  constexpr int C8 = D / 8;        // PV units of a row
  constexpr int RBD = row_block<D>();
  static_assert(RBD * C8 <= FEW * NT, "PV units must fit the threads");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;  // [STAGES][K, V (not SHARED)][BK][ROWB]
  float* scl =
      reinterpret_cast<float*>(smem + G::STAGES * G::NKV * G::TILE);
  float* qs = scl + G::STAGES * 2 * BK;  // [rcap][D]
  float* red = reinterpret_cast<float*>(ring);  // [NT][8], after the walk
  float* pr = qs + rcap * D;             // [rcap][PSTR]
  float* ms = pr + rcap * PSTR;
  float* ls = ms + rcap;
  float* al = ls + rcap;

  const int b = blockIdx.x;
  const int nrb = (group * wins + RBD - 1) / RBD;
  const int g = blockIdx.y / nrb;
  const int row0 = (blockIdx.y - g * nrb) * RBD;
  const int rows = min(RBD, group * wins - row0);
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
    unsigned char* kd = ring + (G::NKV * st) * G::TILE;
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
      if constexpr (!SHARED)
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
  // RSTEP); with fewer units than threads, key slices share a unit. When
  // C8 does not divide NT (D 640: 80 column groups), threads tid <
  // RSTEP * C8 take column group tid % C8 and rows tid / C8 + j * RSTEP,
  // the same count as ceil((units - u0) / NT) where C8 divides NT, and the
  // rest hold none.
  constexpr int RSTEP = NT / C8;
  constexpr bool RAGGED = NT % C8 != 0;
  const bool few = rows <= FEW;
  const int units = rows * C8;
  const int ks_n = few ? RSTEP : units >= NT ? 1 : NT / units;
  const int slice = few ? tid / C8 : units >= NT ? 0 : tid / units;
  const bool pv_on =
      slice < ks_n && (!RAGGED || few || units < NT || tid < RSTEP * C8);
  const int u0 = few ? tid % C8 : units >= NT ? tid : tid - slice * units;
  const int c8 = u0 % C8;
  const int r_first = few ? 0 : u0 / C8;
  const int r_step = few ? 1 : RSTEP;
  const int n_acc =
      few ? rows
          : units >= NT ? (RAGGED ? (rows - r_first + RSTEP - 1) / RSTEP
                                  : (units - u0 + NT - 1) / NT)
                        : 1;
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
    const unsigned char* kt = ring + (G::NKV * st) * G::TILE;
    const unsigned char* vt = SHARED ? kt : kt + G::TILE;
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


template <typename T, typename P, int D, bool DENSE, bool CAP,
          bool SHARED = false>
int launch(const Args& a, cudaStream_t st) {
  constexpr int RBD = row_block<D>();
  const int rows = a.group * a.wins;
  const int rcap = rows < RBD ? rows : RBD;
  const size_t bytes = Geo<P, D, SHARED>::bytes(rcap);
  if (bytes > 227 * 1024) return SLI_ERR_SHAPE;
  if (a.splits < 1 || (a.splits > 1 && a.part == nullptr))
    return SLI_ERR_SHAPE;
  auto kern = paged_decode_kernel<T, P, D, DENSE, CAP, SHARED>;
  cudaError_t e = sli::allow_smem(kern, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.batch, a.kvn * ((rows + RBD - 1) / RBD), a.splits);
  kern<<<grid, NT, bytes, st>>>(
      (const T*)a.q, a.q_bs, a.q_ss, (const P*)a.pool_k, (const P*)a.pool_v,
      a.ksp, a.vsp, a.tables, a.kv_lens, (T*)a.out, a.part, a.layer,
      a.num_pages1, a.kvn, a.ps, a.mp, a.group, a.wins, a.window, rcap,
      a.scale, a.cap, a.sinks);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  const long long n_rows = (long long)a.batch * a.wins * a.kvn * a.group;
  return (int)sli::launch_merge<T>(a.part, a.out, n_rows, D, a.splits, st);
}

// Every pool (q's own dtype, int8 codes with their scales, e4m3 codes)
// takes every option: the cap a template flag, windows and sinks runtime
// arguments, D 256 an instantiation like the others.
template <typename T, typename P, int D, bool DENSE>
int launch_c(const Args& a, cudaStream_t st) {
  if (a.cap <= 0.f) return launch<T, P, D, DENSE, false>(a, st);
  return launch<T, P, D, DENSE, true>(a, st);
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
      return launch_c<T, P, 256, DENSE>(a, st);
    default:
      return SLI_ERR_HEAD_DIM;
  }
}

}  // namespace
