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
// hi[c, 0:counts[c]], sorted, with lo[c, v] = hi[c, v-1].  Repeated f32
// boundaries (two f64 boundaries that ceil32 rounds to one value) leave an
// empty interval between them, and only a true upper bound puts x equal to
// that value in the bucket after both; a lower bound with an equality
// fix-up does not.  Comparisons are on floats, so -0.0 equals a boundary at
// 0 and lands above it; -inf lands in bucket 0 unless a boundary is -inf.
// NaN fails every comparison, so it is caught before the search.
//
// One id per entry: the row is copied, no arithmetic touches it, and the
// output is bit-exact by construction.
//
// What bounds it on the H100: bytes.  At the microbenchmark model's 1000
// columns and batch 2048 it reads 8.2 MB of raw floats and writes 65.5 MB
// of output; the tables (about 5 MB) and the boundaries (at most 1 MB) stay
// in the 50 MB L2.
//
// Design: one block per tile of 32 columns x 32 batch rows.  Phase 1: the
// block's threads read the tile's raw values along the batch (coalesced in
// the host's column-major [C, Bp] layout), binary-search each column's
// boundaries (at most 8 steps over <= 255 values, from L1/L2), and keep the
// ids in shared memory.  Phase 2: they write the tile's output in output
// order; one batch row's slice of it is 32 x d contiguous floats, so a
// warp's stores are one contiguous run, and consecutive lanes read one
// table row's consecutive floats.  Rows move as float4 when d is a multiple
// of 4 and the pointers allow it (16-byte loads and stores, a quarter of
// the index math), else float by float.  32-bit index math when every
// index fits, 64-bit otherwise.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCols = 32;      // columns per block tile
constexpr int kRows = 32;      // batch rows per block tile
constexpr int kThreads = 256;

// Count of bounds[0:n] <= x, for sorted bounds; n for NaN and +inf.
__device__ __forceinline__ int32_t bucket_of(float x,
                                             const float* __restrict__ bounds,
                                             int32_t n) {
  if (!(x < CUDART_INF_F)) return n;
  int32_t first = 0;
  int32_t len = n;
  while (len > 0) {
    const int32_t half = len >> 1;
    if (__ldg(bounds + first + half) <= x) {
      first += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return first;
}

// T: float, or float4 with d counted in float4s.
template <typename I, typename T>
__global__ void __launch_bounds__(kThreads) onehot_bucketize_f32_kernel(
    const T* __restrict__ table3,        // [C_pad, V, d]
    const float* __restrict__ raw,       // [C, Bp] raw feature values
    const float* __restrict__ hi,        // [C_pad, V] upper interval bounds
    const int32_t* __restrict__ counts,  // [C_pad] boundary counts
    T* __restrict__ out,                 // [Bp, C, d]
    I C, I Bp, I V, I d) {
  __shared__ int32_t ids[kRows][kCols + 1];
  const I c0 = static_cast<I>(blockIdx.x) * kCols;
  const I b0 = static_cast<I>(blockIdx.y) * kRows;
  const I nc = C - c0 < kCols ? C - c0 : static_cast<I>(kCols);
  const I nb = Bp - b0 < kRows ? Bp - b0 : static_cast<I>(kRows);

  for (int i = threadIdx.x; i < kCols * kRows; i += kThreads) {
    const int cl = i / kRows;
    const int bl = i % kRows;
    if (cl < nc && bl < nb) {
      const I c = c0 + cl;
      const float x = raw[c * Bp + b0 + bl];
      ids[bl][cl] = bucket_of(x, hi + c * V, counts[c]);
    }
  }
  __syncthreads();

  const I span = nc * d;   // contiguous output elements of one batch row
  const I total = nb * span;
  for (I j = threadIdx.x; j < total; j += kThreads) {
    const I bl = j / span;
    const I r = j - bl * span;
    const I cl = r / d;
    const I k = r - cl * d;
    const I c = c0 + cl;
    out[((b0 + bl) * C + c) * d + k] =
        table3[(c * V + ids[bl][cl]) * d + k];
  }
}

template <typename I>
void launch(const void* table3, const void* raw, const void* hi,
            const void* counts, void* out, I C, I Bp, I V, I d, bool vec,
            dim3 grid, cudaStream_t s) {
  const float* r = static_cast<const float*>(raw);
  const float* h = static_cast<const float*>(hi);
  const int32_t* n = static_cast<const int32_t*>(counts);
  if (vec) {
    onehot_bucketize_f32_kernel<I, float4><<<grid, kThreads, 0, s>>>(
        static_cast<const float4*>(table3), r, h, n,
        static_cast<float4*>(out), C, Bp, V, d / 4);
  } else {
    onehot_bucketize_f32_kernel<I, float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(table3), r, h, n,
        static_cast<float*>(out), C, Bp, V, d);
  }
}

}  // namespace

extern "C" int rt_onehot_bucketize_f32(
    const void* table3, const void* raw, const void* hi, const void* counts,
    void* out, int64_t C, int64_t Bp, int64_t V, int64_t d, void* stream) {
  if (C == 0 || Bp == 0 || d == 0) return 0;
  const int64_t col_tiles = (C + kCols - 1) / kCols;
  const int64_t row_tiles = (Bp + kRows - 1) / kRows;
  if (col_tiles > 2147483647 || row_tiles > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(col_tiles),
                  static_cast<unsigned>(row_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the largest index: the output's, or the table's (planes c < C only)
  const int64_t out_n = C * Bp * d;
  const int64_t tab_n = C * V * d;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table3) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (out_n < (int64_t{1} << 31) && tab_n < (int64_t{1} << 31)) {
    launch<int32_t>(table3, raw, hi, counts, out, static_cast<int32_t>(C),
                    static_cast<int32_t>(Bp), static_cast<int32_t>(V),
                    static_cast<int32_t>(d), vec, grid, s);
  } else {
    launch<int64_t>(table3, raw, hi, counts, out, C, Bp, V, d, vec, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
