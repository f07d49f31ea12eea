// Building blocks of the INT4 weight product on the bf16 tensor cores
// (quantized_matmul_int4_mma.cu: mma.sync for a few activation rows;
// quantized_matmul_int4_wgmma.cu: wgmma for many), mirrored in Python by
// simplellminference_tpu_torch/ops/int4_tiles.py, which the CPU tests
// hold against the reference.
//
// Both kernels swap the operands: A is the weight (16 output columns x 16
// k per warp), B is x^T (k x activation rows), D is out^T. An mma k-step
// of 16 k slots takes logical rows P .. P + 15 of one half in order
// (slot s is row P + s): the low nibbles of packed rows P .. P + 15, or
// their high nibbles (rows K/2 + P ..). So a k-step lies in one scale
// group whenever groups are a multiple of 16 rows, and B's fragments are
// plain bf16x2 pairs of x's rows.
//
// A's fragment (mma.m16n8k16's, and per warp wgmma's m64k16): register
// a0 holds tile row g = lane / 4 at k slots 2t, 2t + 1 (t = lane % 4), a1
// row g + 8 there, a2 and a3 the same rows at slots 2t + 8, 2t + 9. A
// thread reads 32-bit words of 4 neighbouring columns at packed rows
// p = P + 2t (+ 8) and p + 1; one byte permute puts two columns' bytes of
// both rows into one word (row p's bytes in bytes 0-1, row p + 1's in
// bytes 2-3), and nibble i pairs with nibble i + 4: the same column, rows
// p and p + 1, one half. The conversion is exact and takes no I2F:
// flipping bit 3 of each nibble gives v + 8 in [0, 15], which under the
// bf16 pattern 0x4300 (128.0) reads as 136 + v; one bf16x2 fma subtracts
// 136 (every value 128 .. 143 and its difference is exact in bf16).
#pragma once

#include "common.cuh"

namespace q4 {

// nibble i -> v + 8: flip bit 3 of every nibble
constexpr unsigned FLIP = 0x88888888u;

// Bytes 0-1 of words r0 (row p) and r1 (row p + 1), or bytes 2-3 (HI).
template <bool HI>
__device__ __forceinline__ unsigned pair_rows(unsigned r0, unsigned r1) {
  return __byte_perm(r0, r1, HI ? 0x7632 : 0x5410);
}

// bf16x2 of the nibbles s and s + 4 of a pair_rows word whose nibbles were
// flipped (FLIP): s = 0 the first column's low nibbles (rows p, p + 1 of
// the low half), 1 its high nibbles (the high half), 2 and 3 the second
// column's. Low 16 bits: row p (k slot 2t), high: row p + 1.
__device__ __forceinline__ unsigned to_bf16x2(unsigned w, int s) {
  const unsigned r = ((w >> (4 * s)) & 0x000F000Fu) | 0x43004300u;
  unsigned d;
  // r * 1 - 136 in each half: exact
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// The A registers of two columns (c0, c1 of a pair_rows word) for both
// halves at one pair of rows: lo[0] / hi[0] column c0's low / high half,
// lo[1] / hi[1] column c1's.
__device__ __forceinline__ void convert2(unsigned w, unsigned (&lo)[2],
                                         unsigned (&hi)[2]) {
  lo[0] = to_bf16x2(w, 0);
  hi[0] = to_bf16x2(w, 1);
  lo[1] = to_bf16x2(w, 2);
  hi[1] = to_bf16x2(w, 3);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ unsigned ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// 4 consecutive outputs of one row (16-byte f32, 8-byte bf16 stores)
template <typename TO>
__device__ __forceinline__ void store4(TO* p, const float (&v)[4]);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&a),
                 *reinterpret_cast<const unsigned*>(&b));
}

// 4 consecutive f32 (scales or zero points of 4 columns), 0 unless ok
__device__ __forceinline__ void load4(const float* __restrict__ p, bool ok,
                                      float (&v)[4]) {
  const float4 f = ok ? __ldg(reinterpret_cast<const float4*>(p))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

// f32 sum of the two bf16 halves of w
__device__ __forceinline__ float bf16x2_sum(unsigned w) {
  return __uint_as_float(w << 16) + __uint_as_float(w & 0xFFFF0000u);
}

}  // namespace q4
