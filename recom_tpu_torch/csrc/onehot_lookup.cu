// K1: one-id lookup of a uniform-vocab column group, by hand for Hopper.
//
// Replaces: recom_tpu/ops/lookup_pallas.py::_kernel (the Pallas one-hot MXU
// kernel, launched by _onehot_lookup_impl and wrapped by onehot_lookup and
// group_pooled_onehot), together with the pad, the two transposes and the
// one-id combiner that group_pooled_onehot wraps around it, and the
// vocab_caps clamp that Engine._embedding_forward applies before it
// (recom_tpu/runtime/executor.py:503-505): all four are fused here.
//
//   out[b, c, :] = table3[c, min(ids[c, b], caps[c]), :]   if that id >= 0
//                = 0                                        otherwise
//
// With one id per entry every combiner divides by 1 or yields 0 for a
// missing id, so the result is the row itself: no arithmetic touches it and
// the output is bit-exact by construction.
//
// K1-bf16 (rt_onehot_lookup_bf16) is the same kernel over a bf16 table3:
// the reference upcasts each vocab tile to f32 before its one-hot product
// (lookup_pallas.py:49-53); here each element is upcast, exactly, as it is
// read (onehot_write.cuh), so the f32 output holds the stored values.  Its
// reads halve; the f32 output it writes, most of its bytes, does not.
//
// What bounds it on the H100: bytes.  The TPU streams vocab tiles through
// VMEM into the MXU; here that one-hot GEMM would be pure waste.  The whole
// table3 of model E (936 x 128 x 8 x 4 B = 3.8 MB) sits in the 50 MB L2, so
// the row reads hit L2 and the work is bound by writing the [Bp, C, d]
// output (2048 x 930 x 8 x 4 B = 61 MB at batch 2048) plus reading the
// [C, Bp] ids once (7.6 MB): 0.021 ms at 3.35 TB/s.  A thread per output
// float (the first port) spent about 100 instructions on every 4 bytes it
// wrote (two divisions and two remainders by runtime sizes, a strided
// reload of the id and its cap), so instruction throughput, not memory,
// bounded it.
//
// Design: one block per tile of 32 columns x 32 batch rows.  Phase 1: the
// block reads the tile's ids along the batch (coalesced in the host's
// column-major [C, Bp] layout), applies the cap and the missing test once
// per id, and keeps each entry's table offset in shared memory.  Phase 2:
// a warp writes one batch row's slice of the tile, 32 x d contiguous floats
// of the output, lane e moving elements e, e + 32, ... (512 contiguous
// bytes a warp store); consecutive lanes read one table row's consecutive
// floats (the write phase K1 shares with K2, in onehot_write.cuh).  Rows
// move as float4 when d is a multiple of 4 and the pointers allow it, else
// float by float.  A lane's (column, offset in row) is carried from element
// to element, so no element divides.  Stores carry the evict-first hint
// (__stcs), so the streamed output does not push table3 out of L2.  32-bit
// index math when every index fits, 64-bit otherwise.  Staging the output
// tile in shared memory and writing it with TMA bulk stores
// (cp.async.bulk) was slower than these direct stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "onehot_write.cuh"

namespace {

using onehot::kCols;
using onehot::kRows;
using onehot::kThreads;

// S: the stored unit of table3 (float / float4 for f32, unsigned short /
// uint2 for bf16); T: the output unit, float or float4 with d counted in
// float4s (dq = d or d / 4).
template <typename I, typename S, typename T>
__global__ void __launch_bounds__(kThreads) onehot_lookup_kernel(
    const S* __restrict__ table3,       // [C_pad, V, d]
    const int32_t* __restrict__ ids,    // [C, Bp] local ids, < 0 = missing
    const int32_t* __restrict__ caps,   // [C] last valid row per column
    T* __restrict__ out,                // [Bp, C, d]
    I C, I Bp, I V, int dq) {
  __shared__ I rows[kRows][kCols + 1];  // table3 offset of (b, c), -1 missing
  const I c0 = static_cast<I>(blockIdx.x) * kCols;
  const I b0 = static_cast<I>(blockIdx.y) * kRows;
  const int nc = C - c0 < kCols ? static_cast<int>(C - c0) : kCols;
  const int nb = Bp - b0 < kRows ? static_cast<int>(Bp - b0) : kRows;

  for (int i = threadIdx.x; i < kCols * kRows; i += kThreads) {
    const int cl = i / kRows;
    const int bl = i % kRows;
    if (cl < nc && bl < nb) {
      const I c = c0 + cl;
      const int32_t cap = __ldg(caps + c);
      int32_t id = __ldg(ids + c * Bp + b0 + bl);
      id = id < cap ? id : cap;
      rows[bl][cl] = id >= 0 ? (c * V + id) * dq : static_cast<I>(-1);
    }
  }
  __syncthreads();
  onehot::write_tile_rows<I, S, T>(table3, rows, out, C, c0, b0, nc, nb,
                                   dq);
}

// S1 / S4: the stored unit of one element / of four
template <typename I, typename S1, typename S4>
void launch(const void* table3, const void* ids, const void* caps, void* out,
            I C, I Bp, I V, int d, bool vec, dim3 grid, cudaStream_t s) {
  const int32_t* i = static_cast<const int32_t*>(ids);
  const int32_t* k = static_cast<const int32_t*>(caps);
  if (vec) {
    onehot_lookup_kernel<I, S4, float4><<<grid, kThreads, 0, s>>>(
        static_cast<const S4*>(table3), i, k, static_cast<float4*>(out),
        C, Bp, V, d / 4);
  } else {
    onehot_lookup_kernel<I, S1, float><<<grid, kThreads, 0, s>>>(
        static_cast<const S1*>(table3), i, k, static_cast<float*>(out),
        C, Bp, V, d);
  }
}

template <typename S1, typename S4>
int run(const void* table3, const void* ids, const void* caps, void* out,
        int64_t C, int64_t Bp, int64_t V, int64_t d, void* stream) {
  if (C == 0 || Bp == 0 || d == 0) return 0;
  const int64_t col_tiles = (C + kCols - 1) / kCols;
  const int64_t row_tiles = (Bp + kRows - 1) / kRows;
  if (col_tiles > 2147483647 || row_tiles > 65535 || d > 2147483647) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
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
    launch<int32_t, S1, S4>(table3, ids, caps, out, static_cast<int32_t>(C),
                            static_cast<int32_t>(Bp), static_cast<int32_t>(V),
                            static_cast<int>(d), vec, grid, s);
  } else {
    launch<int64_t, S1, S4>(table3, ids, caps, out, C, Bp, V,
                            static_cast<int>(d), vec, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_onehot_lookup_f32(
    const void* table3, const void* ids, const void* caps, void* out,
    int64_t C, int64_t Bp, int64_t V, int64_t d, void* stream) {
  return run<float, float4>(table3, ids, caps, out, C, Bp, V, d, stream);
}

// K1-bf16: table3 holds bf16 rows (16-bit patterns), upcast as they are
// read; the output is f32 as K1's
extern "C" int rt_onehot_lookup_bf16(
    const void* table3, const void* ids, const void* caps, void* out,
    int64_t C, int64_t Bp, int64_t V, int64_t d, void* stream) {
  return run<unsigned short, uint2>(table3, ids, caps, out, C, Bp, V, d,
                                    stream);
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
