// X1: masked, in-order gather + pooling of stacked column groups, by hand
// for Hopper.
//
// Replaces: recom_tpu/ops/lookup_xla.py::group_pooled (both its L == 1 and
// its ragged branch) with pool_rows_inorder and apply_combiner_divisors,
// plus the vocab_caps clamp of Engine._embedding_forward
// (recom_tpu/runtime/executor.py:503-505).  No Pallas kernel exists for
// this in the JAX package: it runs there as XLA gather + scan.
//
//   id_l  = min(ids[c, b, l], caps[c]);  valid_l = id_l >= 0
//   w_l   = weights ? weights[c, b, l] : 1
//   acc   = +0.0;  acc += table[id_l + row_offsets[c], :] * w_l
//           for each valid l, l = 0, 1, ... in order
//   out[b, c, :] = combiner(acc, sum w_l, sum w_l^2)   (valid l only)
//
// Exactness (the bit-exact contract with the NumPy oracle): each product
// and each sum is rounded separately, strictly left to right in f32 --
// __fmul_rn/__fadd_rn can never be contracted into an FMA, and the file is
// also built with -fmad=false.  Combiner divisors: MEAN divides by the
// weight sum, SQRTN by __fsqrt_rn(sum w^2); a column with an explicit
// weight field divides (__fdiv_rn(acc, denom)), an unweighted one
// multiplies by the rounded reciprocal (acc * __fdiv_rn(1, denom)), the two
// TF rounding conventions of lookup_xla.apply_combiner_divisors.  A bag
// whose denominator is not > 0 gives 0.
//
// Missing slots are skipped and the sum starts at +0.0, as in the oracle
// (oracle/reference.py::pool_lookup).  The JAX reference, and the plain
// version in ops/lookup_gather.py, instead add row 0 of the member times a
// zero weight for a missing slot, and start a ragged sum at the first
// slot's row times 0.  The two agree on every value except in three
// places: the sign of a sum that is zero; a bag with a missing slot whose
// member's row 0 holds NaN or inf; and a bag whose first slot's row holds
// inf.  There row * 0 turns the reference's sum into NaN while this kernel
// and the oracle keep their value.  Reading row 0 for missing slots here
// would trade the oracle's answer for the reference's quirk, so the kernel
// does not; its tests compare with == and equal NaN positions, and keep
// NaN and inf out of a member's row 0 and inf out of a bag's first slot.
//
// What bounds it on the H100: bytes, in principle.  Per entry the kernel
// reads one id, one weight and a d-float row, and does 2 flops per float;
// the rows of the 2^23 x 32 tables are random 128-byte reads from HBM.  In
// practice model E's three groups move 21 MB together, 6 us at the HBM
// rate, so latency bounds it: the launch, and the chain of dependent steps
// a bag takes (its ids, then its rows, then the sum), times the waves of
// blocks the register file lets the SMs hold at once (registers, not
// shared memory, limit the blocks an SM holds).  The first port ran a thread per output
// float, each walking its L slots as a serial chain of id load, row load
// and add, with two divisions and two remainders by runtime sizes per
// float, one launch per group.
//
// Design:
// - A bag is one (column, batch row) pair.  A group of G lanes owns a bag,
//   G the smallest power of two >= d/4 (float4 rows, when d % 4 == 0 and
//   the pointers allow it) or >= d (scalar), at most 32; a lane moves
//   elements q, q + G, ... of the row.  Model E's groups: d = 8 is 2 lanes
//   a bag (16 bags a warp), d = 32 is 8 lanes (4 bags a warp).
// - A block of 256 lanes takes a tile of TC columns x TB batch rows (TB =
//   min(32, 256 / G), TC = 256 / G / TB), bags running along the batch
//   inside a column, so a warp's id reads are contiguous in the host's
//   column-major [C, Bp, L] layout.  The tile comes from one division per
//   block; G, TB and TC are compile-time, so no element divides.
// - A bag's per-column constants are read once.  Its ids are read a chunk
//   of kChunk = 4 at a time, each clamped and turned into a 64-bit row
//   index once (the 41.9 M-row group holds 1.34 G floats), and every valid
//   slot's row load of the chunk is issued before the first add; only the
//   adds are ordered.  L = 1 has its own path (one id, one row).
// - Outputs leave with the evict-first hint (__stcs), so the tables that
//   the next launch reads from L2 survive.  A warp's stores are whole
//   32-byte sectors (d = 8) or lines (d = 32), one run per bag.
// - One launch serves up to kMaxGroups groups: the host packs a descriptor
//   per group (ops/lookup_gather.py::x1_descriptors), passed by value as
//   the kernel's argument; each block finds its group by its index.
//
// Stored dtypes (the variants X1-bf16 and X1-int8, one kernel each, so
// that the f32 kernel keeps its own registers): the reference gathers rows
// in the stored dtype and converts them after the gather
// (lookup_xla.py:61-76, quant.py:47-49); here each lane converts the unit
// it loaded, in registers, before the pooling sees it.
// - bf16: a unit of four elements is one 8-byte load (uint2), upcast
//   exactly by a shift into the top half of an f32 (-0.0, NaN, infinities
//   and subnormals keep their values).
// - int8: a unit of four is one 4-byte load (char4), and each element is
//   dequantized as __fmul_rn(__int2float_rn(q), scale[row]): the
//   conversion is exact and the product is rounded once, before it meets
//   the weight's __fmul_rn or the pool's __fadd_rn.  Written as
//   acc + f32(q) * s, an unweighted column would be the pattern nvcc
//   contracts into an FMA, one rounding fewer than the reference takes.
//   Each slot reads its row's scale once, beside the row.  An all-zero row
//   has scale 0.0 and q = 0, so it reads +0.0 * 0.0 = +0.0, as numpy's
//   dequantize_table gives.
// Units stay four elements (or one) for every dtype, so the lane, tile and
// descriptor bookkeeping (dq, G, TB, TC) is the f32 kernel's; only the
// load width differs (16, 8 or 4 bytes a unit), and the host's vector test
// asks for the stored unit's alignment (ops/lookup_gather.py::_x1_group).
// What bounds the variants: the same latency as the f32 kernel at model
// E's sizes; the stored rows' bytes shrink by 2x or 4x, the ids, weights
// and the f32 output do not.
//
// Tried on the H100 and dropped (experiment builds, not kept): one launch
// per group (the three launches' tails and gaps cost more than the shared
// kernel's extra registers); staging each tile's output in shared memory to
// write whole batch-row runs (slower: a barrier and a second pass, for
// stores that were already whole sectors); chunks of 6, 8, 12 and 16 row
// loads (more registers, fewer blocks an SM, slower), and of 2 and 3 (more
// round trips); reading the next chunk's ids while a chunk's rows load
// (more registers, no faster); capping registers with __launch_bounds__ to
// hold 4 or 6 blocks an SM (spills, slower).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;       // row loads in flight per lane
constexpr int kMaxGroups = 8;   // groups per launch

// One group of a launch; the layout of ops/lookup_gather.py::X1_DESC.
struct X1Group {
  const void* table;            // [R, d] stacked rows: f32, bf16 or int8
  const float* scales;          // [R] an int8 table's row scales, else null
  const int32_t* ids;           // [C, Bp, L] member-local ids
  const float* weights;         // [C, Bp, L] or nullptr
  const int32_t* row_offsets;   // [C]
  const int32_t* caps;          // [C]
  const int32_t* codes;         // [C] 0 sum / 1 mean / 2 sqrtn
  const uint8_t* weighted;      // [C] 1 = divide, 0 = reciprocal
  void* out;                    // [Bp, C, d]
  int64_t C, Bp, L;
  int64_t dq;                   // row length in T units (d or d / 4)
  int64_t block_begin;          // first block of this group
  int32_t tiles_b;              // batch tiles per column tile
  int32_t kind;                 // 8 * vec + log2(G)
};

struct X1Launch {
  X1Group g[kMaxGroups];
  int32_t n;
};

__device__ __forceinline__ float fmul(float a, float w) {
  return __fmul_rn(a, w);
}
__device__ __forceinline__ float4 fmul(float4 a, float w) {
  return make_float4(__fmul_rn(a.x, w), __fmul_rn(a.y, w),
                     __fmul_rn(a.z, w), __fmul_rn(a.w, w));
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 fadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The stored dtypes, and the unit a lane loads for one output unit T.
enum Stored { kF32, kBF16, kInt8 };
template <int S, typename T> struct Unit;
template <> struct Unit<kF32, float> { using type = float; };
template <> struct Unit<kF32, float4> { using type = float4; };
template <> struct Unit<kBF16, float> { using type = unsigned short; };
template <> struct Unit<kBF16, float4> { using type = uint2; };
template <> struct Unit<kInt8, float> { using type = signed char; };
template <> struct Unit<kInt8, float4> { using type = char4; };

// A loaded unit as f32: f32 as it is; bf16 shifted into the top half of an
// f32 (exact); int8 converted (exact) and times the row's scale, one
// rounded product.
__device__ __forceinline__ float to_f32(float v, float) { return v; }
__device__ __forceinline__ float4 to_f32(float4 v, float) { return v; }
__device__ __forceinline__ float to_f32(unsigned short v, float) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float4 to_f32(uint2 v, float) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}
__device__ __forceinline__ float to_f32(signed char v, float s) {
  return __fmul_rn(__int2float_rn(v), s);
}
__device__ __forceinline__ float4 to_f32(char4 v, float s) {
  return make_float4(__fmul_rn(__int2float_rn(v.x), s),
                     __fmul_rn(__int2float_rn(v.y), s),
                     __fmul_rn(__int2float_rn(v.z), s),
                     __fmul_rn(__int2float_rn(v.w), s));
}

// The combiner on a finished sum: divide (weighted column) or multiply by
// the rounded reciprocal; 0 where the denominator is not > 0.
template <typename T>
__device__ __forceinline__ T finish(T acc, int32_t code, bool divide,
                                    float wsum, float w2sum) {
  if (code == 0) return acc;
  const float denom = code == 1 ? wsum : __fsqrt_rn(w2sum);
  if (!(denom > 0.0f)) return zero<T>();
  if (divide) {
    if constexpr (sizeof(T) == sizeof(float)) {
      return __fdiv_rn(acc, denom);
    } else {
      return make_float4(__fdiv_rn(acc.x, denom), __fdiv_rn(acc.y, denom),
                         __fdiv_rn(acc.z, denom), __fdiv_rn(acc.w, denom));
    }
  }
  return fmul(acc, __fdiv_rn(1.0f, denom));
}

// Slots 0 .. L-1 of one bag, K at a time: a chunk's ids, then all its
// row loads (each converted to f32 units as it arrives), then the adds in
// slot order.
template <int S, typename T, int K>
__device__ __forceinline__ void pool_slots(
    const typename Unit<S, T>::type* __restrict__ table,
    const float* __restrict__ scales, const int32_t* __restrict__ id_row,
    const float* __restrict__ w_row, int L, int32_t cap, int64_t off,
    int64_t dq, int64_t q, T& acc, float& wsum, float& w2sum) {
  for (int l0 = 0; l0 < L; l0 += K) {
    int32_t id[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      id[k] = l0 + k < L ? __ldg(id_row + l0 + k) : -1;
    }
    T r[K];
    float w[K];
    bool ok[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int32_t i = id[k] < cap ? id[k] : cap;
      ok[k] = i >= 0;
      const int64_t row = static_cast<int64_t>(i) + off;
      if (ok[k]) {
        const float sc = S == kInt8 ? __ldg(scales + row) : 1.0f;
        r[k] = to_f32(__ldg(table + row * dq + q), sc);
      } else {
        r[k] = zero<T>();
      }
      w[k] = ok[k] && w_row ? __ldg(w_row + l0 + k) : 1.0f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ok[k]) {
        acc = fadd(acc, fmul(r[k], w[k]));
        wsum = __fadd_rn(wsum, w[k]);
        w2sum = __fadd_rn(w2sum, __fmul_rn(w[k], w[k]));
      }
    }
  }
}

// One block of group g: its tile's bags, G lanes a bag.
template <int S, typename T, int G>
__device__ __forceinline__ void pool_tile(const X1Group& g, int64_t local) {
  constexpr int kBags = kThreads / G;
  constexpr int TB = kBags < 32 ? kBags : 32;    // batch rows a tile
  constexpr int TC = kBags / TB;                 // columns a tile
  const int64_t tc = local / g.tiles_b;
  const int64_t c0 = tc * TC;
  const int64_t b0 = (local - tc * g.tiles_b) * TB;
  const int bag = threadIdx.x / G;
  const int cl = bag / TB, bl = bag % TB;
  const int sub = threadIdx.x % G;
  const int64_t c = c0 + cl, b = b0 + bl;
  if (c >= g.C || b >= g.Bp) return;
  const int64_t dq = g.dq;
  const int L = static_cast<int>(g.L);
  const int64_t slot = (c * g.Bp + b) * g.L;
  const int32_t* id_row = g.ids + slot;
  const float* w_row = g.weights ? g.weights + slot : nullptr;
  const int32_t cap = __ldg(g.caps + c);
  const int64_t off = __ldg(g.row_offsets + c);
  const int32_t code = __ldg(g.codes + c);
  const bool divide = __ldg(g.weighted + c) != 0;
  const auto* table = static_cast<const typename Unit<S, T>::type*>(g.table);
  T* out = static_cast<T*>(g.out) + (b * g.C + c) * dq;
  for (int64_t q = sub; q < dq; q += G) {
    T acc = zero<T>();
    float wsum = 0.0f, w2sum = 0.0f;
    if (L == 1) {
      pool_slots<S, T, 1>(table, g.scales, id_row, w_row, 1, cap, off, dq, q,
                          acc, wsum, w2sum);
    } else {
      pool_slots<S, T, kChunk>(table, g.scales, id_row, w_row, L, cap, off,
                               dq, q, acc, wsum, w2sum);
    }
    __stcs(out + q, finish(acc, code, divide, wsum, w2sum));
  }
}

template <int S, typename T>
__device__ __forceinline__ void pool_tile_g(const X1Group& g, int lg,
                                            int64_t local) {
  switch (lg) {
    case 0: pool_tile<S, T, 1>(g, local); break;
    case 1: pool_tile<S, T, 2>(g, local); break;
    case 2: pool_tile<S, T, 4>(g, local); break;
    case 3: pool_tile<S, T, 8>(g, local); break;
    case 4: pool_tile<S, T, 16>(g, local); break;
    default: pool_tile<S, T, 32>(g, local); break;
  }
}

// S: the stored dtype of every group of the launch
template <int S>
__global__ void __launch_bounds__(kThreads) pooled_gather_kernel(
    const __grid_constant__ X1Launch batch) {
  const int64_t blk = blockIdx.x;
  int i = 0;
  while (i + 1 < batch.n && blk >= batch.g[i + 1].block_begin) ++i;
  const X1Group& g = batch.g[i];
  const int64_t local = blk - g.block_begin;
  if (g.kind >= 8) {
    pool_tile_g<S, float4>(g, g.kind - 8, local);
  } else {
    pool_tile_g<S, float>(g, g.kind, local);
  }
}

// Launch X1 (of stored dtype S) over n <= kMaxGroups groups described by
// the host array `groups` (block_begin ascending from 0), `blocks` blocks
// in all.
template <int S>
int launch_groups(const void* groups, int64_t n, int64_t blocks,
                  void* stream) {
  if (n < 1 || n > kMaxGroups || blocks < 0 || blocks > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks == 0) return 0;
  X1Launch batch = {};
  const X1Group* src = static_cast<const X1Group*>(groups);
  for (int64_t i = 0; i < n; ++i) {
    batch.g[i] = src[i];
    if (S == kInt8 && src[i].scales == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  batch.n = static_cast<int32_t>(n);
  pooled_gather_kernel<S><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X1: f32 tables
extern "C" int rt_pooled_gather_f32(const void* groups, int64_t n,
                                    int64_t blocks, void* stream) {
  return launch_groups<kF32>(groups, n, blocks, stream);
}

// X1-bf16: bf16 tables (16-bit patterns), upcast as they are read
extern "C" int rt_pooled_gather_bf16(const void* groups, int64_t n,
                                     int64_t blocks, void* stream) {
  return launch_groups<kBF16>(groups, n, blocks, stream);
}

// X1-int8: int8 tables with per-row f32 scales, dequantized as read
extern "C" int rt_pooled_gather_int8(const void* groups, int64_t n,
                                     int64_t blocks, void* stream) {
  return launch_groups<kInt8>(groups, n, blocks, stream);
}

extern "C" int rt_pooled_gather_desc_size() {
  return static_cast<int>(sizeof(X1Group));
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
