// Shared helpers for the port's CUDA kernels (plain C interface, loaded with
// ctypes by simplellminference_tpu_torch/ops/cuda_build.py).
//
// Element types: SLI_F32 (float) and SLI_BF16 (__nv_bfloat16); int8_t
// for INT8-KV pools (read with to_f, dequantized by the caller) and
// __nv_fp8_e4m3 for FP8-KV pools (read with to_f, exactly; written with
// f_to_e4m3). A pool's dtype has a code of its own (SLI_POOL_*,
// cuda_build.POOL_CODES), apart from the activation code. Every
// launcher returns 0 on success, a cudaError_t code (> 0) from
// cudaGetLastError() after the launch, or a negative code for arguments
// the kernel does not take, SLI_ERR_GRID for a cooperative grid larger
// than the card holds at once (sli_error_string names them all).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SLI_F32 0
#define SLI_BF16 1

// KV pool dtypes (ops/cuda_build.py POOL_CODES)
#define SLI_POOL_F32 0
#define SLI_POOL_BF16 1
#define SLI_POOL_I8 2
#define SLI_POOL_E4M3 3

#define SLI_ERR_DTYPE (-1)
#define SLI_ERR_HEAD_DIM (-2)
#define SLI_ERR_SHAPE (-3)
#define SLI_ERR_GRID (-4)

namespace sli {

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return (float)x;  // an INT8-KV code, exact
}

template <>
__device__ __forceinline__ float to_f<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  // e4m3 -> f16 (cvt.f16x2.e4m3x2) -> f32: both steps exact
  return __half2float(
      __half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

// Two e4m3 codes (the low byte first) -> two exact floats.
__device__ __forceinline__ float2 e4m3x2_to_f2(unsigned short v) {
  return __half22float2(
      __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)v, __NV_E4M3)));
}

// f32 -> e4m3 code with the JAX package's cast (ml_dtypes, XLA; the plain
// version is ops/ref_ops.py to_e4m3): round to nearest even, and |x| > 464
// (past the tie between 448 and 480, which goes to 448) or NaN -> NaN with
// x's sign. The hardware conversion (cvt.rn.satfinite.e4m3x2.f32)
// saturates to +-448 instead, so the overflow is selected after it.
__device__ __forceinline__ unsigned char f_to_e4m3(float x) {
  const unsigned char c =
      (unsigned char)__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return fabsf(x) <= 464.f
             ? c
             : (unsigned char)(((__float_as_uint(x) >> 24) & 0x80u) | 0x7Fu);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four signed bytes of w -> four exact floats (a byte permute into the
// mantissa of 2^23, then one subtract: no int-to-float instruction).
__device__ __forceinline__ void i8x4_to_f32(unsigned int w, float* f) {
  const unsigned int u = w ^ 0x80808080u;  // b -> b + 128, as unsigned
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __int_as_float((int)__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
           8388736.f;  // 2^23 + 128
}

// Sets the dynamic shared memory limit of `kernel` when it needs more than
// the 48 KB a launch gets without opting in.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace sli
