// The bucket search that kernel K2 (onehot_bucketize.cu, the forward) and
// kernel K3b (onehot_grad.cu, its backward) share, so the bucket a raw
// value's gradient goes to is the bucket its forward read.
//
//   bucket(x) = #{j < counts[c] : bounds_c[j] <= x}   (upper bound)
//             = counts[c]                              for NaN and +inf
//
// Column c's boundaries are hi[c, 0:counts[c]], sorted, and hi[c, v] = +inf
// for every v >= counts[c] (ops/lookup_onehot.py::bucket_bounds).  For a
// finite x, counting hi[j] <= x over the whole +inf-padded row counts
// exactly the boundaries <= x, so the search needs no per-column length: a
// branchless upper bound of a fixed number of steps, log2 of the smallest
// power of two >= V, where entries past V (a V that is not a power of two)
// count as +inf.  NaN fails every comparison and +inf passes the +inf
// padding, so bucket_of settles both with a test after the search.
// Comparisons are on floats: -0.0 equals a boundary at 0 and lands above
// it; -inf lands in bucket 0 unless a boundary is -inf.
//
// upper_bounds runs N searches interleaved step by step, so their loads
// are in flight together rather than N chains of dependent loads one after
// another.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace bucket {

// pos[k] = #{j < v : hi[row[k] + j] <= x[k]} for finite x[k].
// half: half of the smallest power of two >= v (0 for v == 1).  kGlobal:
// hi is in device memory (read through the read-only cache), else in
// shared memory.
template <int N, typename I, bool kGlobal = true>
__device__ __forceinline__ void upper_bounds(const float* __restrict__ hi,
                                             const I (&row)[N],
                                             const float (&x)[N],
                                             int (&pos)[N], int v, int half) {
#pragma unroll
  for (int k = 0; k < N; ++k) pos[k] = 0;
  for (int s = half; s > 0; s >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = pos[k] + s - 1;
      const float b = j >= v           ? CUDART_INF_F
                      : kGlobal        ? __ldg(hi + row[k] + j)
                                       : hi[row[k] + j];
      pos[k] += b <= x[k] ? s : 0;
    }
  }
}

// The bucket of x in column c, given its search result pos.
template <typename I>
__device__ __forceinline__ int32_t bucket_of(float x, int pos,
                                             const int32_t* __restrict__ counts,
                                             I c) {
  return x < CUDART_INF_F ? pos : __ldg(counts + c);
}

// half of the smallest power of two >= v, the search's first step
inline int first_step(int64_t v) {
  int64_t p2 = 1;
  while (p2 < v) p2 *= 2;
  return static_cast<int>(p2 / 2);
}

}  // namespace bucket
