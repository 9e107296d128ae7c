// The write phase that kernels K1 (onehot_lookup.cu) and K2
// (onehot_bucketize.cu) share: copy the table rows a block tile selected
// into the batch-major [Bp, C, d] output.
//
// A block owns a tile of kCols columns x kRows batch rows.  Its first
// phase leaves, for each entry (bl, cl) of the tile, the table3 offset of
// the selected row in rows[bl][cl] (in units of T), or -1 for a missing id
// (the row is then zeros).  write_tile_rows then has each warp write one
// batch row's slice of the tile: nc x dq contiguous elements of the output,
// lane e moving elements e, e + 32, ... (512 contiguous bytes a warp store
// with float4).  Consecutive lanes read one table row's consecutive
// elements.  A lane's (column, offset in row) is carried from element to
// element, so no element divides by a runtime size.  Stores carry the
// evict-first hint (__stcs): the streamed output is larger than L2 at
// serving batch sizes and would otherwise push the tables out of it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace onehot {

constexpr int kCols = 32;      // columns per block tile
constexpr int kRows = 32;      // batch rows per block tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> __device__ __forceinline__ T Zero();
template <> __device__ __forceinline__ float Zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 Zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// T: float, or float4 with d counted in float4s (dq = d or d / 4).
// Call after a __syncthreads() that publishes rows.
template <typename I, typename T>
__device__ __forceinline__ void write_tile_rows(
    const T* __restrict__ table3,       // [C_pad, V, dq]
    I (*rows)[kCols + 1],               // [kRows][kCols + 1] offsets, -1 = 0
    T* __restrict__ out,                // [Bp, C, dq]
    I C, I c0, I b0, int nc, int nb, int dq) {
  const int lane = threadIdx.x & 31;
  const int span = nc * dq;            // elements of one batch row's slice
  const int cl_first = lane / dq, q_first = lane - cl_first * dq;
  const int cl_step = 32 / dq, q_step = 32 - cl_step * dq;
  for (int bl = threadIdx.x >> 5; bl < nb; bl += kWarps) {
    T* o = out + ((b0 + bl) * C + c0) * dq;
    const I* r = rows[bl];
    int cl = cl_first, q = q_first;
#pragma unroll 2
    for (int e = lane; e < span; e += 32) {
      const I row = r[cl];
      __stcs(o + e, row >= 0 ? __ldg(table3 + row + q) : Zero<T>());
      q += q_step;
      cl += cl_step;
      if (q >= dq) {
        q -= dq;
        ++cl;
      }
    }
  }
}

}  // namespace onehot
