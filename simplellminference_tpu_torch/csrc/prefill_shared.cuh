// Prefill attention over shared-KV rows (absorbed MLA: one latent row per
// token and kv head that is both the key and the value), shared by form
// 3l (flash_prefill_shared.cu: the fresh rows of a whole prompt, called
// with v = k) and form 8l (paged_prefill_shared.cu: a chunk through the
// page tables of a shared pool). Each .cu file gives the rows of its keys
// (a Src: row(kp) is the element offset of key kp's row from the block's
// base pointer, or -1 for an unmapped page) and launches the kernels
// below. Neither has a window, a soft cap, sinks or quantized rows: no
// model with MLA uses them.
//
// What bounds them on the H100 at DeepSeek-V2-Lite's absorbed geometry
// (16 q heads over one 640-lane row, a 512-row chunk at offset 512):
// operations, 4 x 16 x 640 a (row, key) pair, about 16 GFLOP a chunk,
// 16 us at the bf16 tensor-core peak; the rows themselves are 1.3 MB a
// sequence.
//
// bf16 (attend_shared_mma): prefill_mma.cuh's tiles and products. A block
// is one warpgroup and one 64-row query tile packing 64 / H positions x H
// q heads of one kv head (DeepSeek-V2-Lite: 4 positions x 16 heads), so a
// staged row serves the whole group. A bf16 row tile of 64 keys at D 640
// is 80 KB and the Q tile another 80 KB, so the block stages one key tile
// at a time (165,376 bytes with the row table and the alignment pad: one
// block an SM), loaded, then computed. The tile is staged once for both
// products: S = Q K^T reads it K-major, O += P V reads the same bytes
// MN-major through wgmma's transpose mode for 16-bit B, as the TPU
// kernel's v = k reads one VMEM block. O at D 640 would be 320 f32
// registers a thread over one warpgroup, past the 255 a thread may have,
// so the output's columns go in passes of 128 (O 64 registers a thread,
// the D-128 form's budget): each pass walks the key tiles again,
// recomputes S and the online softmax (the same numbers each pass) and
// adds P V into its 128 columns. S is computed D / 128 times over: 5 at D
// 640, the price of staying within the registers without a second
// warpgroup (a later redesign: consumer warpgroups owning column slabs,
// P in shared memory). P goes through the tensor cores split into
// p_hi + p_lo in bf16, the one-ulp rule of prefill_mma.cuh. The key walk
// splits over blocks when the tiles alone leave the card idle
// (prefill_tiles.py's arithmetic, the tiles' walk() here), f32 partials
// merged by split_merge.cuh.
//
// f32 (attend_shared_fma): the FMA kernel of the two-pool forms cannot
// hold D 640 (its tiles would take 508 KB of shared memory and its
// accumulators 160 registers a thread), so this one stages 32 query rows
// of one q head and 32-key tiles, each staged once for both products, in
// f32 (Q and K 82 KB each at D 640), and makes its output in passes of
// 128 columns, recomputing S each pass, as the bf16 kernel does.
#pragma once

#include "common.cuh"
#include "prefill_mma.cuh"

namespace sli {
namespace pfs {

// The rows of a shared pool's pages: key kp of sequence b, kv head kh at
// row ((layer * P1 + tables[b, kp / ps]) * kvN + kh) * ps + kp % ps,
// row_len elements apart; -1 for an unmapped or out-of-range page.
struct PagedRows {
  const int* table;  // this sequence's row of the block table
  long long base;    // layer * P1
  int kvn, kh, ps, p1;
  long long row_len;
  __device__ long long row(int kp) const {
    const int pg = __ldg(table + kp / ps);
    if (pg < 0 || pg >= p1) return -1;
    return (((base + pg) * kvn + kh) * ps + kp % ps) * row_len;
  }
};

// Dense rows [S, kvN, D] of one sequence and kv head (the block's base
// pointer at k + b * k_bs + kh * D): key kp at kp * k_ss elements.
struct DenseRows {
  long long k_ss;
  __device__ long long row(int kp) const { return kp * k_ss; }
};

constexpr int PW = 128;  // output columns a pass

template <int D>
struct MmaSmem {
  // 1024: the base rounded up to the swizzle atom; Q, one key tile, the
  // key tile's row table
  static constexpr int BYTES = 1024 + 2 * pfa::Geo<D>::BYTES +
                               pfa::TILE * 8;
};

// Attention of one packed query tile (blockIdx as pfa::walk reads it)
// over its run of key tiles. q: this sequence's [Sq, N, D] rows (element
// stride q_ss, heads contiguous, 16-byte aligned); kbase + src.row(kp):
// key kp's row; out: this sequence's [Sq, N, D] (contiguous), written when
// splits == 1; work: else split_merge.cuh's f32 partials over the B * Sq *
// N rows. Query row at position s sits at off + s and sees keys k <= off +
// s, k < n_keys. mul: the scores' scale x log2 e.
template <int D, typename Src>
__device__ __forceinline__ void attend_shared_mma(
    const __nv_bfloat16* __restrict__ q, long long q_ss,
    const __nv_bfloat16* __restrict__ kbase, const Src& src,
    __nv_bfloat16* __restrict__ out, float* __restrict__ work, int batch,
    int b, int seq, int heads, int group, int off, int n_keys, float mul,
    int splits) {
  using G = pfa::Geo<D>;
  using pfa::TILE;
  static_assert(D % PW == 0, "whole passes of 128 columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - ((unsigned)__cvta_generic_to_shared(smem_raw) &
                           1023)) & 1023);
  unsigned char* qs = sm;
  unsigned char* kt = qs + G::BYTES;
  long long* rowtab = (long long*)(kt + G::BYTES);  // [64]: -1 zeros
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const pfa::Walk w = pfa::walk(seq, group, off, n_keys, 0, splits);
  const int z = blockIdx.z % splits;

  // the query tile, once for every pass
  for (int i = tid; i < TILE * G::CH; i += pfa::NT) {
    const int r = i / G::CH;
    const int c = i % G::CH;
    const int pl = r / w.H;
    const int hg = w.hc * w.H + r % w.H;
    const int s = w.p0 + pl;
    const bool ok = pl < w.P && s < seq && hg < group;
    const __nv_bfloat16* row =
        ok ? q + (long long)s * q_ss + (long long)(w.kh * group + hg) * D : q;
    pfa::cp16(qs + pfa::chunk_at<D>(r, c), row + c * 8, ok);
  }
  pfa::cp_commit();
  pfa::cp_wait_all();  // landed before any exit; read after a barrier

  // this thread's fragment rows r0 = 16 * warp + lane / 4 and r0 + 8
  const int t4 = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);
  const int qp0 = off + w.p0 + r0 / w.H;
  const int qp1 = off + w.p0 + (r0 + 8) / w.H;
  const int hi0 = min(qp0, n_keys - 1);
  const int hi1 = min(qp1, n_keys - 1);
  const int hi_min = min(hi0, hi1);

  for (int pass = 0; pass < D / PW; ++pass) {
    float o[PW / 2];
#pragma unroll
    for (int i = 0; i < PW / 2; ++i) o[i] = 0.f;
    float m0 = pfa::NEG_INF, m1 = pfa::NEG_INF, l0 = 0.f, l1 = 0.f;
    for (int t = w.ta; t < w.tb; ++t) {
      const int kb = w.k_lo + t * TILE;
      __syncthreads();  // the previous tile's readers are done
      if (tid < TILE)
        rowtab[tid] = kb + tid <= w.last_key ? src.row(kb + tid) : -1;
      __syncthreads();
#pragma unroll 8
      for (int it = 0; it < TILE * G::CH / pfa::NT; ++it) {
        const int i = it * pfa::NT + tid;
        const int r = i / G::CH;
        const int c = i % G::CH;
        const long long row = rowtab[r];
        const bool ok = row >= 0;
        pfa::cp16(kt + pfa::chunk_at<D>(r, c), kbase + (ok ? row : 0) + c * 8,
                  ok);
      }
      pfa::cp_commit();
      pfa::cp_wait_all();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();

      // S = Q K^T over the whole row
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      pfa::fence_regs(s);
      pfa::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        pfa::wgmma_ss_n64(s, pfa::kmajor<D>(qs, kk), pfa::kmajor<D>(kt, kk),
                          kk > 0);
      pfa::wg_commit();
      pfa::wg_wait_all();
      pfa::fence_regs(s);

      // causal mask (not where both rows see the whole tile), row max over
      // the quad's 64 keys, p in log2 units
      const int k0 = kb + 2 * t4;
      float mx0 = pfa::NEG_INF, mx1 = pfa::NEG_INF;
      const bool whole = kb + TILE - 1 <= hi_min;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + (e & 1);
          const bool ok = whole || kp <= (e < 2 ? hi0 : hi1);
          const float v = ok ? s[4 * j + e] * mul : pfa::NEG_INF;
          s[4 * j + e] = v;
          if (e < 2) mx0 = fmaxf(mx0, v);
          else mx1 = fmaxf(mx1, v);
        }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      // a row that has seen no key yet subtracts 0: its masked keys
      // (-1e30) still give p = 0, and so does its old sum's factor
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float ms0 = mn0 <= pfa::NEG_INF ? 0.f : mn0;
      const float ms1 = mn1 <= pfa::NEG_INF ? 0.f : mn1;
      const float al0 = pfa::ex2(m0 - ms0);
      const float al1 = pfa::ex2(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = pfa::ex2(s[4 * j + e] - (e < 2 ? ms0 : ms1));
          s[4 * j + e] = p;
          if (e < 2) rs0 += p;
          else rs1 += p;
        }
      l0 = l0 * al0 + rs0;  // this thread's share; the quad adds at the end
      l1 = l1 * al1 + rs1;

      // P as the A fragments of 4 k-steps, split hi + lo
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
          plo[kk][x] = pfa::bf16x2(a - hf.x, c - hf.y);
        }
#pragma unroll
      for (int j = 0; j < PW / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      pfa::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pfa::fence_regs(ph[kk]);
        pfa::fence_regs(plo[kk]);
      }
      // O[:, pass columns] += P V: the same tile, its pass's two 64-column
      // slabs, MN-major
      const unsigned char* vt = kt + pass * (PW / 64) * G::SLAB;
      pfa::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        pfa::wgmma_rs_n128(o, ph[kk], pfa::mnmajor<D>(vt, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        pfa::wgmma_rs_n128(o, plo[kk], pfa::mnmajor<D>(vt, kk));
      pfa::wg_commit();
      pfa::wg_wait_all();
      pfa::fence_regs(o);
    }

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
        __nv_bfloat16* orow = out + row * D + pass * PW + 2 * t4;
#pragma unroll
        for (int j = 0; j < PW / 8; ++j)
          *(unsigned*)(orow + 8 * j) = pfa::bf16x2(
              o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
      } else {  // split_merge.cuh's partials, m in natural-log units
        const long long n_rows = (long long)batch * seq * heads;
        const long long at =
            (long long)z * n_rows + (long long)b * seq * heads + row;
        float* acc = work + at * D + pass * PW + 2 * t4;
#pragma unroll
        for (int j = 0; j < PW / 8; ++j)
          *(float2*)(acc + 8 * j) =
              make_float2(o[4 * j + 2 * hr], o[4 * j + 2 * hr + 1]);
        if (pass == 0 && t4 == 0) {
          float* ml = work + (long long)splits * n_rows * D + at * 2;
          ml[0] = (hr ? m1 : m0) * pfa::LN2;
          ml[1] = l;
        }
      }
    }
  }
}

// f32: 32 query rows of one q head, 32-key tiles, 256 threads: the scores
// a 2 x 2 micro-tile a thread (rows ty * 2 + i, keys tx + 16 * j; ty =
// tid / 16, tx = tid % 16), PV 2 rows x 8 columns tx + 16 * c of the pass.
constexpr int FQ = 32;
constexpr int FK = 32;
constexpr int FNT = 256;

template <int D>
constexpr size_t fma_smem_bytes() {
  return ((size_t)FQ * (D + 1) + (size_t)FK * (D + 1) +
          (size_t)FQ * (FK + 1)) * sizeof(float) + FK * sizeof(long long);
}

// grid (ceil(Sq / FQ), heads, batch) as the caller sets it: q at this
// sequence and head (rows q_ss apart), kbase + src.row(kp) key kp's row,
// out at this sequence and head (rows o_ss apart).
template <int D, typename Src>
__device__ __forceinline__ void attend_shared_fma(
    const float* __restrict__ q, long long q_ss,
    const float* __restrict__ kbase, const Src& src, float* __restrict__ out,
    long long o_ss, int seq, int off, int n_keys, float scale) {
  static_assert(D % PW == 0, "whole passes of 128 columns");
  extern __shared__ float fsm[];
  float* qs = fsm;                  // [FQ][D + 1]
  float* ks = qs + FQ * (D + 1);    // [FK][D + 1]: key and value rows
  float* pr = ks + FK * (D + 1);    // [FQ][FK + 1]
  long long* rowoff = (long long*)(pr + FQ * (FK + 1));  // [FK]
  constexpr float NEG = -1e30f;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.x * FQ;
  for (int i = tid; i < FQ * D; i += FNT) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = q0 + r;
    qs[r * (D + 1) + d] = s < seq ? q[(long long)s * q_ss + d] : 0.f;
  }
  const int last_key = min(off + min(q0 + FQ, seq) - 1, n_keys - 1);
  const int nkt = last_key < 0 ? 0 : last_key / FK + 1;

  for (int pass = 0; pass < D / PW; ++pass) {
    float acc[2][PW / 16];
    float m[2] = {NEG, NEG};
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < PW / 16; ++c) acc[i][c] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * FK;
      __syncthreads();  // the previous tile's readers are done
      if (tid < FK) {
        const int kp = k0 + tid;
        rowoff[tid] = kp <= last_key ? src.row(kp) : -1;
      }
      __syncthreads();
      for (int i = tid; i < FK * D; i += FNT) {
        const int r = i / D;
        const int d = i - r * D;
        const long long o = rowoff[r];
        ks[r * (D + 1) + d] = o >= 0 ? kbase[o + d] : 0.f;
      }
      __syncthreads();

      float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qa = qs[(ty * 2) * (D + 1) + d];
        const float qb = qs[(ty * 2 + 1) * (D + 1) + d];
        const float ka = ks[tx * (D + 1) + d];
        const float kb = ks[(tx + 16) * (D + 1) + d];
        sc[0][0] += qa * ka;
        sc[0][1] += qa * kb;
        sc[1][0] += qb * ka;
        sc[1][1] += qb * kb;
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qp = off + q0 + ty * 2 + i;
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = k0 + tx + 16 * j;
          float v = sc[i][j] * scale;
          if (kp > qp || kp >= n_keys) v = NEG;
          sc[i][j] = v;
          mx = fmaxf(mx, v);
        }
        // the 16 threads sharing ty hold the tile's 32 keys of row i
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // a masked key, or a row that has seen no key yet, keeps p = 0
          const float p = sc[i][j] <= NEG ? 0.f : expf(sc[i][j] - m_new);
          sc[i][j] = p;
          rs += p;
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, o);
        alpha[i] = expf(m[i] - m_new);
        l[i] = l[i] * alpha[i] + rs;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          pr[(ty * 2 + i) * (FK + 1) + tx + 16 * j] = sc[i][j];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < PW / 16; ++c) acc[i][c] *= alpha[i];
      const int kmax = min(FK, last_key + 1 - k0);
      const float* vcol = ks + pass * PW + tx;
      for (int kk = 0; kk < kmax; ++kk) {
        float vv[PW / 16];
#pragma unroll
        for (int c = 0; c < PW / 16; ++c) vv[c] = vcol[kk * (D + 1) + 16 * c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p = pr[(ty * 2 + i) * (FK + 1) + kk];
#pragma unroll
          for (int c = 0; c < PW / 16; ++c) acc[i][c] += p * vv[c];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = q0 + ty * 2 + i;
      if (s < seq) {
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < PW / 16; ++c)
          out[(long long)s * o_ss + pass * PW + tx + 16 * c] = acc[i][c] / den;
      }
    }
  }
}

}  // namespace pfs
}  // namespace sli
