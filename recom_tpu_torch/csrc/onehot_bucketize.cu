// K2: fused bucketize + one-id lookup of a pure-bucketize column group, by
// hand for Hopper.
//
// Replaces: recom_tpu/ops/lookup_pallas.py::_bz_kernel (the Pallas kernel
// that one-hots raw floats against per-vocab interval pairs on the MXU,
// launched by _onehot_bucketize_impl and wrapped by onehot_bucketize_lookup),
// together with the column pad, the rows[:num_columns] slice and the
// transpose that Engine._embedding_forward wraps around it
// (recom_tpu/runtime/executor.py:452-476): all are fused here.
//
//   out[b, c, :] = table3[c, bucket(raw[c, b]), :]
//   bucket(x)    = #{j < counts[c] : bounds_c[j] <= x}   (upper bound)
//                = counts[c]                              for NaN and +inf
//
// The TPU kernel's interval test (lo[c,v] <= x < hi[c,v]) selects exactly
// this bucket for the arrays bucket_bounds builds: column c's boundaries are
// hi[c, 0:counts[c]], sorted, with lo[c, v] = hi[c, v-1], and hi[c, v] =
// +inf for every v >= counts[c].  Repeated f32 boundaries (two f64
// boundaries that ceil32 rounds to one value) leave an empty interval
// between them, and only a true upper bound puts x equal to that value in
// the bucket after both; a lower bound with an equality fix-up does not.
// Comparisons are on floats, so -0.0 equals a boundary at 0 and lands above
// it; -inf lands in bucket 0 unless a boundary is -inf.  NaN fails every
// comparison and +inf passes the +inf padding, so both are settled by a
// test ahead of the search.
//
// One id per entry: the row is copied, no arithmetic touches it, and the
// output is bit-exact by construction.  K2-bf16 reads a bf16 table3 and
// upcasts each element as it is read, exactly (onehot_write.cuh).
//
// What bounds it on the H100: bytes.  At the microbenchmark model's 1000
// columns and batch 2048 it reads 8.2 MB of raw floats and writes 65.5 MB
// of output; the tables (about 5 MB) and the boundaries (at most 1 MB) stay
// in the 50 MB L2.
//
// Design: one block per tile of 32 columns x 32 batch rows.  Phase 1: the
// block reads the tile's raw values along the batch (coalesced in the
// host's column-major [C, Bp] layout) and finds each one's bucket with a
// branchless upper bound of a fixed number of steps over the column's whole
// hi row: for a finite x, counting hi[j] <= x over the +inf-padded row
// counts exactly the boundaries <= x, so the search needs no per-column
// length, and entries past V (a V that is not a power of two) count as
// +inf.  Each thread searches four entries, interleaved step by step, so
// their loads are in flight together rather than four chains of dependent
// loads one after another (the search lives in bucket_search.cuh, which the
// backward K3b shares).  The block keeps each entry's table offset in
// shared memory.  Phase 2 is K1's write phase (onehot_write.cuh): a warp
// writes one batch row's contiguous slice, float4 rows with __stcs, no
// per-element division.  32-bit index math when every index fits, 64-bit
// otherwise.  The first port ran one binary search per thread entry after
// entry, up to 8 dependent loads each (up to 32 in series a thread), and
// wrote with a division per element and without the evict-first hint.
//
// Tried on the H100 and dropped (an experiment build, not kept): staging
// the tile's 32 hi rows in shared memory (16 or 32 KB a block) to feed the
// search; no faster than reading through L1, since the staging reads whole
// rows where a tile's searches touch part of each.  What still holds it
// back: the V_pad-256 launch of micro-1000 has 512 blocks, under four an
// SM, so its searches' latency is not hidden behind other blocks' writes;
// and each group is a launch of its own.

#include <cstdint>
#include <cuda_runtime.h>
#include "bucket_search.cuh"
#include "onehot_write.cuh"

namespace {

using onehot::kCols;
using onehot::kRows;
using onehot::kThreads;

constexpr int kPerThread = kCols * kRows / kThreads;   // searches a thread runs

// S: the stored unit of table3 (float / float4 for f32, unsigned short /
// uint2 for bf16); T: the output unit, float or float4 with d counted in
// float4s (dq = d or d / 4).  half: half of the smallest power of two >= V
// (0 for V == 1).
template <typename I, typename S, typename T>
__global__ void __launch_bounds__(kThreads) onehot_bucketize_kernel(
    const S* __restrict__ table3,        // [C_pad, V, d]
    const float* __restrict__ raw,       // [C, Bp] raw feature values
    const float* __restrict__ hi,        // [C_pad, V] upper interval bounds
    const int32_t* __restrict__ counts,  // [C_pad] boundary counts
    T* __restrict__ out,                 // [Bp, C, d]
    I C, I Bp, I V, int dq, int half) {
  __shared__ I rows[kRows][kCols + 1];   // table3 offset of (b, c)
  const I c0 = static_cast<I>(blockIdx.x) * kCols;
  const I b0 = static_cast<I>(blockIdx.y) * kRows;
  const int nc = C - c0 < kCols ? static_cast<int>(C - c0) : kCols;
  const int nb = Bp - b0 < kRows ? static_cast<int>(Bp - b0) : kRows;
  const int v = static_cast<int>(V);

  // entry k of this thread: column (tid / 32) + 8 k, batch row tid % 32
  const int bl = threadIdx.x & 31;
  float x[kPerThread];
  I h[kPerThread];                       // offset of the column's hi row
  int pos[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int cl = (threadIdx.x >> 5) + k * onehot::kWarps;
    const bool live = cl < nc && bl < nb;
    const I c = c0 + (live ? cl : 0);
    x[k] = live ? __ldg(raw + c * Bp + b0 + bl) : 0.0f;
    h[k] = c * V;
  }
  bucket::upper_bounds<kPerThread, I>(hi, h, x, pos, v, half);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int cl = (threadIdx.x >> 5) + k * onehot::kWarps;
    if (cl < nc && bl < nb) {
      const I c = c0 + cl;
      const int32_t id = bucket::bucket_of(x[k], pos[k], counts, c);
      rows[bl][cl] = (c * V + id) * dq;
    }
  }
  __syncthreads();
  onehot::write_tile_rows<I, S, T>(table3, rows, out, C, c0, b0, nc, nb,
                                   dq);
}

// S1 / S4: the stored unit of one element / of four
template <typename I, typename S1, typename S4>
void launch(const void* table3, const void* raw, const void* hi,
            const void* counts, void* out, I C, I Bp, I V, int d, bool vec,
            int half, dim3 grid, cudaStream_t s) {
  const float* r = static_cast<const float*>(raw);
  const float* h = static_cast<const float*>(hi);
  const int32_t* n = static_cast<const int32_t*>(counts);
  if (vec) {
    onehot_bucketize_kernel<I, S4, float4><<<grid, kThreads, 0, s>>>(
        static_cast<const S4*>(table3), r, h, n,
        static_cast<float4*>(out), C, Bp, V, d / 4, half);
  } else {
    onehot_bucketize_kernel<I, S1, float><<<grid, kThreads, 0, s>>>(
        static_cast<const S1*>(table3), r, h, n,
        static_cast<float*>(out), C, Bp, V, d, half);
  }
}

template <typename S1, typename S4>
int run(const void* table3, const void* raw, const void* hi,
        const void* counts, void* out, int64_t C, int64_t Bp, int64_t V,
        int64_t d, void* stream) {
  if (C == 0 || Bp == 0 || d == 0) return 0;
  const int64_t col_tiles = (C + kCols - 1) / kCols;
  const int64_t row_tiles = (Bp + kRows - 1) / kRows;
  if (col_tiles > 2147483647 || row_tiles > 65535 || d > 2147483647 ||
      V < 1 || V > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int half = bucket::first_step(V);
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(row_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the largest index: the output's, or the table's (planes c < C only)
  const int64_t out_n = C * Bp * d;
  const int64_t tab_n = C * V * d;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table3) % sizeof(S4) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (out_n < (int64_t{1} << 31) && tab_n < (int64_t{1} << 31)) {
    launch<int32_t, S1, S4>(table3, raw, hi, counts, out,
                            static_cast<int32_t>(C), static_cast<int32_t>(Bp),
                            static_cast<int32_t>(V), static_cast<int>(d), vec,
                            half, grid, s);
  } else {
    launch<int64_t, S1, S4>(table3, raw, hi, counts, out, C, Bp, V,
                            static_cast<int>(d), vec, half, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_onehot_bucketize_f32(
    const void* table3, const void* raw, const void* hi, const void* counts,
    void* out, int64_t C, int64_t Bp, int64_t V, int64_t d, void* stream) {
  return run<float, float4>(table3, raw, hi, counts, out, C, Bp, V, d,
                            stream);
}

// K2-bf16: table3 holds bf16 rows (16-bit patterns), upcast as they are
// read by K1's write phase (onehot_write.cuh); the output is f32 as K2's
extern "C" int rt_onehot_bucketize_bf16(
    const void* table3, const void* raw, const void* hi, const void* counts,
    void* out, int64_t C, int64_t Bp, int64_t V, int64_t d, void* stream) {
  return run<unsigned short, uint2>(table3, raw, hi, counts, out, C, Bp, V,
                                    d, stream);
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
