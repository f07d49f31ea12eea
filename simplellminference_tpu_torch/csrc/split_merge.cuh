// The merge of a key walk split over blocks (flash-decoding), shared by the
// decode attention kernel (paged_decode.cu) and the tensor-core prefill
// kernels (prefill_mma.cuh). Each split of an output row leaves f32
// partials in part: its unnormalized acc [splits][n_rows][d], then its
// running max m (natural-log units) and sum l [splits][n_rows][2].
#pragma once

#include "common.cuh"

namespace sli {

// out[row, c] = sum_z acc_z[row, c] e^(m_z - M) / sum_z l_z e^(m_z - M),
// M = max_z m_z, rounded once to T; a row whose splits are all empty
// (m = -1e30, l = 0) gives zero. A thread an element, a block MERGE_NT / d
// whole rows (d divides MERGE_NT): no 64-bit division.
constexpr int MERGE_NT = 256;

template <typename T>
__global__ void __launch_bounds__(MERGE_NT)
    merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                 long long n_rows, int d, int splits) {
  const long long row =
      (long long)blockIdx.x * (MERGE_NT / d) + threadIdx.x / d;
  if (row >= n_rows) return;
  const long long i = row * d + threadIdx.x % d;
  const long long total = n_rows * d;
  const float* ml = part + (long long)splits * total;
  float mx = -1e30f;
  for (int z = 0; z < splits; ++z)
    mx = fmaxf(mx, ml[(z * n_rows + row) * 2]);
  float l = 0.f;
  float a = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float* mz = ml + (z * n_rows + row) * 2;
    const float w = expf(mz[0] - mx);
    l = fmaf(mz[1], w, l);
    a = fmaf(part[z * total + i], w, a);
  }
  out[i] = from_f<T>(a / fmaxf(l, 1e-30f));
}

// The same merge for a row width d that does not divide MERGE_NT (the
// absorbed-MLA latent rows, d 640): a block a row, its threads striding
// over the row's columns; each column's sum takes the splits in the same
// order and the same operations as merge_kernel.
template <typename T>
__global__ void __launch_bounds__(MERGE_NT)
    merge_rows_kernel(const float* __restrict__ part, T* __restrict__ out,
                      long long n_rows, int d, int splits) {
  const long long row = blockIdx.x;
  const long long total = n_rows * d;
  const float* ml = part + (long long)splits * total;
  float mx = -1e30f;
  for (int z = 0; z < splits; ++z)
    mx = fmaxf(mx, ml[(z * n_rows + row) * 2]);
  float l = 0.f;
  for (int z = 0; z < splits; ++z) {
    const float* mz = ml + (z * n_rows + row) * 2;
    l = fmaf(mz[1], expf(mz[0] - mx), l);
  }
  for (int c = threadIdx.x; c < d; c += MERGE_NT) {
    const long long i = row * d + c;
    float a = 0.f;
    for (int z = 0; z < splits; ++z)
      a = fmaf(part[z * total + i], expf(ml[(z * n_rows + row) * 2] - mx),
               a);
    out[i] = from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T>
cudaError_t launch_merge(const float* part, void* out, long long n_rows,
                         int d, int splits, cudaStream_t st) {
  if (d <= 0) return cudaErrorInvalidValue;
  if (MERGE_NT % d) {
    merge_rows_kernel<T><<<(unsigned)n_rows, MERGE_NT, 0, st>>>(
        part, (T*)out, n_rows, d, splits);
    return cudaGetLastError();
  }
  const long long per = MERGE_NT / d;
  merge_kernel<T><<<(unsigned)((n_rows + per - 1) / per), MERGE_NT, 0, st>>>(
      part, (T*)out, n_rows, d, splits);
  return cudaGetLastError();
}

}  // namespace sli
