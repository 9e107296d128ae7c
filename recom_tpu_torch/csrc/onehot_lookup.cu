// K1: one-id lookup of uniform-vocab column groups, by hand for Hopper.
//
// Replaces: recom_tpu/ops/lookup_pallas.py::_kernel (the Pallas one-hot MXU
// kernel, launched by _onehot_lookup_impl and wrapped by onehot_lookup and
// group_pooled_onehot), together with the pad, the two transposes and the
// one-id combiner that group_pooled_onehot wraps around it, the vocab_caps
// clamp that Engine._embedding_forward applies before it
// (recom_tpu/runtime/executor.py:503-505), and, for a one-hot group whose
// bucketize members reach the device as raw values, the XLA bucketize and
// id LUT in front of it (lookup_xla.device_bucketize and executor.py:
// 482-501): all are fused here.
//
//   id(c, b)     = bucket(raw[c, b]), through lut[c] where the group has
//                  one (-1: dropped)              for c < nbz (searched)
//                = ids[c - nbz, b]                 otherwise (host ids)
//   out[b, c, :] = table3[c, min(id, caps[c]), :]  if that id >= 0
//                = 0                               otherwise
//   bucket(x)    = #{j : hi[c, j] <= x}  (upper bound), counts[c] for NaN
//                  and +inf: what device_bucketize computes, as integers
//
// With one id per entry every combiner divides by 1 or yields 0 for a
// missing id, so the result is the row itself: no arithmetic touches it and
// the output is bit-exact by construction.
//
// K1-bf16 (rt_onehot_lookup_bf16) is the same kernel over bf16 tables:
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
// [C, Bp] ids or raw values once (7.6 MB): 0.021 ms at 3.35 TB/s.  The
// searched columns add their boundary rows, read from L2 (model E: 880
// rows of at most 101 floats, 0.36 MB).  A thread per output float (the
// first port) spent about 100 instructions on every 4 bytes it wrote (two
// divisions and two remainders by runtime sizes, a strided reload of the
// id and its cap), so instruction throughput, not memory, bounded it.
//
// Design: one launch for every one-hot group of a forward, up to
// kMaxGroups, each described by a K1Group record; the blocks of group k
// are numbered from its block_begin.  A block takes a tile of `cols`
// columns x 2^rows_log2 batch rows of its group, at most kEntries entries,
// chosen per group by the host (ops/lookup_onehot.py::k1_tile): a wide
// group takes 32 columns, a narrow one all of its columns and more batch
// rows (Criteo's one-column groups at d = 64: 1 x 128), so that the ids a
// block reads are real and every warp store is full.
//   Phase 1: the block reads the tile's ids along the batch (coalesced in
// the host's column-major [C, Bp] layout), or, for the searched columns,
// the raw values, and finds each value's bucket with bucket_search.cuh's
// branchless upper bound (the search K2 and K3b run), four entries a
// thread interleaved step by step; then the LUT, the cap and the missing
// test, once per entry, leaving each entry's table offset in shared
// memory.  Under autograd the group also names an ids_out, and the block
// writes each entry's id there (what K3a then reads); serving writes none.
//   Phase 2: the block writes its tile's output as one run of elements
// (nb rows of nc x dq units; contiguous where the tile spans the group's
// columns), consecutive threads on consecutive units, a thread's offsets
// in the shared offsets and in the output carried from unit to unit, so
// no unit divides or multiplies.  The shared offsets' rows have an odd
// stride, so phase 1's stores along the batch hit distinct banks.  Rows
// move as float4 when d is a multiple of 4 and the pointers allow it
// (decided per group), else float by float.  Stores carry the
// evict-first hint (__stcs), so the streamed output does not push table3
// out of L2.  32-bit index math when every index of the launch fits,
// 64-bit otherwise.
//
// Tried on the H100 and dropped: staging the output tile in shared memory
// and writing it with TMA bulk stores (cp.async.bulk), slower than these
// direct stores; and (the kernel's first Hopper design) a fixed 32 x 32
// tile and a warp a batch row's slice, which at Criteo's one-column
// groups left 31 of every 32 columns of a block empty and a warp store at
// half its lanes, one launch a group.

#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_search.cuh"
#include "onehot_write.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEntries = 1024;                  // entries of a block tile
constexpr int kPer = kEntries / kThreads;       // entries a thread reads
constexpr int kMaxGroups = 16;                  // groups a launch

// One group of a launch; the layout of ops/lookup_onehot.py::K1_DESC.
struct K1Group {
  const void* table3;      // [C_pad, V, d] f32 or bf16
  const int32_t* ids;      // [C - nbz, Bp] host ids of columns [nbz, C)
  const int32_t* caps;     // [C] last valid row per column
  const float* raw;        // [nbz, Bp] raw values of columns [0, nbz)
  const float* hi;         // [nbz, VB] upper interval bounds (bucket_bounds)
  const int32_t* counts;   // [nbz] boundary counts
  const int32_t* lut;      // [nbz, VL] each bucket's id, -1 dropped; or null
  void* out;               // [Bp, C, d] f32
  int32_t* ids_out;        // [C, Bp] the ids read, or null
  int64_t C, nbz, Bp, V, d, VB, half, VL;
  int64_t cols, rows_log2, col_tiles, vec, block_begin;
};

struct K1Launch {
  K1Group g[kMaxGroups];
  int32_t n;
};

// Phase 2: the tile's nb x (nc x dq) units of output, one run of
// consecutive units a step of the block.  rows[bl * stride + cl]: each
// entry's table3 offset (stride = cols | 1, odd: phase 1's writes, a warp
// along the batch at one column, fall in distinct banks).  A thread's
// unit is carried as its offsets in rows and out and its offset in the
// row, so no unit divides or multiplies.
template <typename I, typename S, typename T>
__device__ __forceinline__ void write_tile(const S* __restrict__ table3,
                                           const I* rows, int stride,
                                           T* __restrict__ out, I C, I c0,
                                           I b0, int nc, int nb, int dq) {
  const int span = nc * dq;             // units of one batch row's slice
  const int total = nb * span;
  int e = threadIdx.x;
  if (e >= total) return;
  // this thread's first unit: (batch row bl, unit r of its slice, column
  // cl and offset q of its row); the step of kThreads units the same way
  const int bl = e / span;
  int r = e - bl * span;
  const int cl = r / dq;
  int q = r - cl * dq;
  const int sb = kThreads / span, sr = kThreads - sb * span;
  const int scl = sr / dq, sq = sr - scl * dq;
  int ri = bl * stride + cl;
  const int ri_step = sb * stride + scl, ri_wrap = stride - nc;
  I oi = ((b0 + bl) * C + c0) * dq + r;
  const I oi_step = static_cast<I>(sb) * C * dq + sr;
  const I oi_wrap = (C - nc) * dq;
  for (; e < total; e += kThreads) {
    const I row = rows[ri];
    __stcs(out + oi, row >= 0 ? onehot::Upcast(__ldg(table3 + row + q))
                              : onehot::Zero<T>());
    q += sq;
    ri += ri_step;
    r += sr;
    oi += oi_step;
    if (q >= dq) {                      // past the row: the next column
      q -= dq;
      ++ri;
    }
    if (r >= span) {                    // past the slice: the next batch row
      r -= span;
      ri += ri_wrap;
      oi += oi_wrap;
    }
  }
}

// S1 / S4: the stored unit of one element / of four (float / float4 for
// f32 tables, unsigned short / uint2 for bf16).
template <typename I, typename S1, typename S4>
__global__ void __launch_bounds__(kThreads)
    onehot_lookup_kernel(const __grid_constant__ K1Launch P) {
  // table3 offset of (b, c), -1 none; rows of an odd stride (write_tile)
  __shared__ I rows[2 * kEntries];
  int gk = 0;
  while (gk + 1 < P.n && blockIdx.x >= P.g[gk + 1].block_begin) ++gk;
  const K1Group& a = P.g[gk];
  const int64_t blk = blockIdx.x - a.block_begin;
  const int cols = static_cast<int>(a.cols);
  const int stride = cols | 1;
  const int rl2 = static_cast<int>(a.rows_log2);
  const int64_t rt = blk / a.col_tiles;
  const I C = static_cast<I>(a.C), Bp = static_cast<I>(a.Bp);
  const I V = static_cast<I>(a.V);
  const I c0 = static_cast<I>(blk - rt * a.col_tiles) * cols;
  const I b0 = static_cast<I>(rt) << rl2;
  const int nc = C - c0 < cols ? static_cast<int>(C - c0) : cols;
  const int nb = Bp - b0 < (I{1} << rl2) ? static_cast<int>(Bp - b0)
                                          : (1 << rl2);
  const int dq = a.vec ? static_cast<int>(a.d / 4) : static_cast<int>(a.d);
  const I nbz = static_cast<I>(a.nbz);

  // phase 1: entry i of the tile is (column i >> rl2, batch row i & mask)
  float x[kPer];
  I h[kPer];
  int pos[kPer];
  int32_t id[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int cl = i >> rl2, bl = i & ((1 << rl2) - 1);
    const bool live = cl < nc && bl < nb;
    const I c = c0 + (live ? cl : 0);
    const I b = b0 + (live ? bl : 0);
    const bool searched = live && c < nbz;
    x[k] = searched ? __ldg(a.raw + c * Bp + b) : 0.0f;
    h[k] = searched ? c * static_cast<I>(a.VB) : I{0};
    id[k] = live && !searched ? __ldg(a.ids + (c - nbz) * Bp + b) : -1;
  }
  if (c0 < nbz) {                       // the block holds searched columns
    bucket::upper_bounds<kPer, I>(a.hi, h, x, pos, static_cast<int>(a.VB),
                                  static_cast<int>(a.half));
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int cl = i >> rl2, bl = i & ((1 << rl2) - 1);
      const I c = c0 + cl;
      if (cl < nc && bl < nb && c < nbz) {
        const int32_t bk = bucket::bucket_of(x[k], pos[k], a.counts, c);
        id[k] = a.lut != nullptr
                    ? __ldg(a.lut + c * static_cast<I>(a.VL) + bk)
                    : bk;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int cl = i >> rl2, bl = i & ((1 << rl2) - 1);
    if (cl < nc && bl < nb) {
      const I c = c0 + cl;
      if (a.ids_out != nullptr) a.ids_out[c * Bp + b0 + bl] = id[k];
      const int32_t cap = __ldg(a.caps + c);
      const int32_t v = id[k] < cap ? id[k] : cap;
      rows[bl * stride + cl] = v >= 0 ? (c * V + v) * dq
                                      : static_cast<I>(-1);
    }
  }
  __syncthreads();
  if (a.vec) {
    write_tile<I, S4, float4>(static_cast<const S4*>(a.table3), rows, stride,
                              static_cast<float4*>(a.out), C, c0, b0, nc, nb,
                              dq);
  } else {
    write_tile<I, S1, float>(static_cast<const S1*>(a.table3), rows, stride,
                             static_cast<float*>(a.out), C, c0, b0, nc, nb,
                             dq);
  }
}

template <typename S1, typename S4>
int run(const void* groups, int64_t n, int64_t blocks, void* stream) {
  if (n < 1 || n > kMaxGroups || blocks < 0 || blocks > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  K1Launch P = {};
  const K1Group* src = static_cast<const K1Group*>(groups);
  bool wide = false;    // some index needs 64 bits
  int64_t want = 0;
  for (int64_t i = 0; i < n; ++i) {
    const K1Group& g = src[i];
    const int64_t rows = int64_t{1} << g.rows_log2;
    if (g.C < 0 || g.Bp < 0 || g.d < 1 || g.d > 2147483647 || g.V < 1 ||
        g.nbz < 0 || g.nbz > g.C || g.cols < 1 || g.rows_log2 < 0 ||
        g.cols * rows > kEntries ||
        g.col_tiles != (g.C + g.cols - 1) / g.cols ||
        g.block_begin != want ||
        (g.nbz > 0 && (g.VB < 1 || g.VB > (int64_t{1} << 30) ||
                       (g.lut != nullptr && g.VL < 1))) ||
        (g.vec && g.d % 4 != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    want += g.col_tiles * ((g.Bp + rows - 1) / rows);
    const int64_t top = int64_t{1} << 31;
    wide = wide || g.C * g.Bp * g.d >= top || g.C * g.V * g.d >= top ||
           g.nbz * g.VB >= top || g.nbz * g.VL >= top;
    P.g[i] = g;
  }
  if (want != blocks) return static_cast<int>(cudaErrorInvalidValue);
  P.n = static_cast<int32_t>(n);
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    onehot_lookup_kernel<int64_t, S1, S4>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(P);
  } else {
    onehot_lookup_kernel<int32_t, S1, S4>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 over n <= kMaxGroups groups described by the host array `groups`
// (K1Group records, each group's blocks numbered from its block_begin),
// `blocks` blocks in all.  Returns the launch's cudaError_t.
extern "C" int rt_onehot_lookup_f32(const void* groups, int64_t n,
                                    int64_t blocks, void* stream) {
  return run<float, float4>(groups, n, blocks, stream);
}

// K1-bf16: every table3 holds bf16 rows (16-bit patterns), upcast as they
// are read; the output is f32 as K1's
extern "C" int rt_onehot_lookup_bf16(const void* groups, int64_t n,
                                     int64_t blocks, void* stream) {
  return run<unsigned short, uint2>(groups, n, blocks, stream);
}

// The constants the host plans with, in the order of
// ops/lookup_onehot.py::K1_LIMITS: kMaxGroups, kEntries, sizeof(K1Group).
extern "C" void rt_onehot_lookup_limits(int64_t* out) {
  out[0] = kMaxGroups;
  out[1] = kEntries;
  out[2] = sizeof(K1Group);
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
