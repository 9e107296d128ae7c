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
//
// Stored dtypes: table3 holds f32 rows, or bf16 rows (the bf16 variants
// K1-bf16 and K2-bf16).  A bf16 element is the top half of an f32, so it
// is upcast exactly, as it is read, by a shift into the high 16 bits:
// -0.0, NaN payloads, infinities and subnormals keep their bits, and the
// f32 output holds the same value the stored row does.  The load type S
// and the store type T then differ: a float4 of output is four bf16, one
// 8-byte load (uint2); a float, one 2-byte load.  Offsets count units of
// T in the output and units of S in table3, one S per T, so the
// bookkeeping (dq = d or d / 4, the rows[][] offsets) is the same for
// both dtypes.
//
// What a selected unit becomes in the output is the caller's ``value``
// functor, called with the loaded unit and the entry's (bl, cl): K1 and K2
// take CopyUnit, the upcast above; X1's one-id tile (pooled_gather.cu)
// passes its own, which adds the unit to +0.0 and reads an int8 entry's
// row scale, kept beside rows[][] in shared memory.

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

// A stored unit as f32: f32 as it is; bf16 (16-bit patterns) shifted
// into the top half of an f32, which is exact.
__device__ __forceinline__ float Upcast(float v) { return v; }
__device__ __forceinline__ float4 Upcast(float4 v) { return v; }
__device__ __forceinline__ float Upcast(unsigned short v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float4 Upcast(uint2 v) {   // four bf16, in order
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}

// K1's and K2's value of a stored unit: its upcast, bit for bit.
struct CopyUnit {
  template <typename S>
  __device__ __forceinline__ auto operator()(S v, int, int) const {
    return Upcast(v);
  }
};

// S: the stored unit (float or float4 for f32 tables, unsigned short or
// uint2 for bf16); T: the output unit, float or float4 with d counted in
// float4s (dq = d or d / 4); value(unit, bl, cl) -> T.  Call after a
// __syncthreads() that publishes rows.
template <typename I, typename S, typename T, typename Value = CopyUnit>
__device__ __forceinline__ void write_tile_rows(
    const S* __restrict__ table3,       // [C_pad, V, dq]
    I (*rows)[kCols + 1],               // [kRows][kCols + 1] offsets, -1 = 0
    T* __restrict__ out,                // [Bp, C, dq]
    I C, I c0, I b0, int nc, int nb, int dq, Value value = Value()) {
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
      __stcs(o + e, row >= 0 ? value(__ldg(table3 + row + q), bl, cl)
                             : Zero<T>());
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
