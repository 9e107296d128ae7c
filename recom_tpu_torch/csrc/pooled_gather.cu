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
// Stored dtypes: one kernel each (X1 f32, X1-bf16, X1-int8), so that each
// keeps its own registers.  The reference gathers rows in the stored dtype
// and converts them after the gather (lookup_xla.py:61-76, quant.py:47-49);
// here each element is converted in registers before the pooling sees it:
// bf16 by a shift into the top half of an f32 (exact: -0.0, NaN,
// infinities and subnormals keep their values), int8 as
// __fmul_rn(__int2float_rn(q), scale[row]) -- the conversion exact, the
// product rounded once, before the weight's __fmul_rn and the pool's
// __fadd_rn (written as acc + f32(q) * s, an unweighted column would be the
// pattern nvcc contracts into an FMA, one rounding fewer than the
// reference takes).  An all-zero int8 row has scale 0.0 and q = 0, so it
// reads +0.0 * 0.0 = +0.0, as numpy's dequantize_table gives.
//
// Two tiles, chosen per group by the host (ops/lookup_gather.py::_x1_group)
// and named in the descriptor's kind (64 * one-id + 8 * log2(unit) +
// log2(G)); one launch serves every group of a forward of one stored dtype
// (up to kMaxGroups), so both tiles share it, the bag groups' blocks first
// (their slot chains are latency-bound; the one-id tiles' streaming writes
// fill the SMs around them):
//
// 1. The bag tile, for lists and weighted columns.  A bag is one (column,
//    batch row) pair; G lanes own a bag, G the smallest power of two >=
//    d / U, at most 32, where a lane's unit is U stored elements, one load
//    of up to 16 bytes: f32 four (float4), bf16 eight, int8 sixteen (eight
//    at d = 8: the whole 8-byte row), each only where d and the table's
//    alignment allow it, else the next smaller unit down to four, else one
//    element (the scalar path).  So a bf16 d = 8 bag is one lane, an int8
//    d = 32 bag two.  A block of 256 lanes takes a tile of TC columns x TB
//    batch rows (TB = min(32, 256 / G), TC = 256 / G / TB), bags running
//    along the batch inside a column, so a warp's id reads are contiguous
//    in the host's column-major [C, Bp, L] layout.  A bag's ids are read a
//    chunk at a time, each clamped and turned into a 64-bit row index once
//    (the 41.9 M-row group holds 1.34 G elements), and every valid slot's
//    row load of the chunk is issued before the first add; the loaded
//    units stay raw in registers (a uint4 at most, as f32's float4) and
//    each element is converted as its add takes it, so only the adds are
//    ordered.  A chunk is kChunk = 4 slots, or 2 for units of 8 and 16
//    elements, whose sums take 8 or 16 registers.  Outputs leave with the
//    evict-first hint (__stcs), as float4 runs of U floats.
// 2. The one-id tile, for a group with L == 1 and no weights plane (model
//    E's 980 one-id columns under int8, its 50 string-hash columns under
//    every dtype, model F's 100): K1's tile of 32 columns x 32 batch rows
//    (onehot_write.cuh), column tiles first, as K1's grid runs.  Phase 1
//    reads the tile's ids along the batch (coalesced in [C, Bp, 1]),
//    clamps each to caps[c], treats one below 0 as missing, and keeps the
//    row's 64-bit offset (and an int8 row's scale) in shared memory; phase
//    2 has each warp write one batch row's slice of the tile, 32 x d
//    contiguous floats (1 KB at d = 8), with __stcs.  The value written is
//    __fadd_rn(+0.0f, v), v the stored element as f32 (int8:
//    __fmul_rn(__int2float_rn(q), scale)); a missing entry writes +0.0.
//    That is the bag tile's L = 1 result under every combiner: SUM keeps
//    acc = +0 + v * 1; MEAN and SQRTN divide by 1 or multiply by
//    __fdiv_rn(1, 1) = 1, which changes no value; a missing entry has a
//    weight sum of 0, so +0 (SUM) or 0 (MEAN, SQRTN); and +0 + -0.0 =
//    +0.0.  The shared memory (8.4 KB, 12.7 KB for int8) is dynamic, asked
//    for only by a launch that holds a one-id group.  f32 groups take it
//    below d = 32, whose rows the bag tile writes in pieces of less than a
//    128-byte line (X1_ONEID_F32_BELOW_D in ops/lookup_gather.py, with the
//    A/B readings).
//
// __launch_bounds__(256, 4): 64 registers a lane, four blocks an SM, as the
// f32 kernel takes unasked; the bf16 and int8 kernels would otherwise take
// 71 and 80 and hold three.
//
// What bounds it on the H100: bytes, in principle; per entry one id, one
// weight and a d-element row in, d floats out at the end, 2 flops an
// element (3 for int8).  At model E's sizes, f32: three groups, 21 MB
// together, 6 us at the HBM rate, so latency bounds it -- the launch, and
// the chain a bag takes (its ids, then its rows, then the sum) times the
// waves of blocks the SMs hold.  bf16: the same chain over half the row
// bytes, 15 MB.  int8: all 980 one-id columns come here, and their 2048 x
// 980 x 8 floats (64.2 MB of the 82 MB bound) are output.  The one-id tile
// writes them as whole batch-row runs, where the bag tile (16 bags of one
// column a warp) wrote 16 separate 32-byte pieces C x 32 bytes apart; on
// one-hot-sized tables (K1's own data) it runs at K1's rate.  What holds
// it back at model E is the 50 string-hash members of 10 000 rows each:
// their rows miss L1, where a 100-row vocab's repeat within a tile, and
// the tiles that hold them set the launch's tail (chip_smoke.py times the
// two classes of members alone; PERF.md has the readings).
//
// Tried on the H100 and dropped (experiment builds, not kept): one launch
// per group (the three launches' tails and gaps cost more than the shared
// kernel's extra registers); staging each bag tile's output in shared
// memory to write whole batch-row runs (slower: a barrier and a second
// pass, for stores that were already whole sectors); chunks of 6, 8, 12
// and 16 row loads (more registers, fewer blocks an SM, slower), and of 2
// and 3 for four-element units (more round trips); reading the next
// chunk's ids while a chunk's rows load (more registers, no faster);
// capping registers below 64 to hold 5, 6 or 8 blocks an SM (spills in the
// bag tile; the one-id tile, even alone in a kernel of its own at 32
// registers, was no faster); in the one-id tile, writing two or four batch
// rows a warp at once (more registers, no faster), 32-bit row offsets (no
// faster), prefetching each entry's row into L1 or L2 in phase 1
// (slower), and the tiles in batch-first order (slower).  Before the one-id
// tile and the 16-byte units, the bf16 and int8 kernels moved four elements
// a unit, as f32 does: an 8- or 4-byte load a lane at the same latency,
// and one-id columns through the bag tile.

#include <cstdint>
#include <cuda_runtime.h>

#include "onehot_write.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;   // blocks an SM holds (64 registers a lane)
constexpr int kChunk = 4;       // row loads in flight per lane
constexpr int kMaxGroups = 8;   // groups per launch
constexpr int kOneId = 64;      // the kind bit of the one-id tile

// A lane's row loads in flight: kChunk, or 2 for units of 8 and 16
// elements, whose sums take 8 or 16 registers.
__host__ __device__ constexpr int chunk_of(int u) {
  return u >= 8 ? 2 : kChunk;
}

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
  int64_t dq;                   // row length in units (d / U)
  int64_t block_begin;          // first block of this group
  int32_t tiles_b;              // batch tiles per column tile
  int32_t kind;                 // 64 * one-id + 8 * log2(U) + log2(G)
};

struct X1Launch {
  X1Group g[kMaxGroups];
  int32_t n;
};

// The stored dtypes, and the raw load of U stored elements (U x itemsize
// bytes, at most 16).
enum Stored { kF32, kBF16, kInt8 };
__host__ __device__ constexpr int item_bytes(int s) {
  return s == kF32 ? 4 : s == kBF16 ? 2 : 1;
}
template <int B> struct RawOf;
template <> struct RawOf<1> { using type = unsigned char; };
template <> struct RawOf<2> { using type = unsigned short; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };
template <int S, int U>
using Raw = typename RawOf<U * item_bytes(S)>::type;

// 32-bit word k of a raw unit (a narrower unit zero-extended)
__device__ __forceinline__ uint32_t word(unsigned char v, int) { return v; }
__device__ __forceinline__ uint32_t word(unsigned short v, int) { return v; }
__device__ __forceinline__ uint32_t word(unsigned int v, int) { return v; }
__device__ __forceinline__ uint32_t word(uint2 v, int k) {
  return k == 0 ? v.x : v.y;
}
__device__ __forceinline__ uint32_t word(uint4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Element j of a raw unit as f32: f32 as it is; bf16 shifted into the top
// half of an f32 (exact); int8 sign-extended, converted (exact) and times
// the row's scale, one rounded product.
template <int S, typename R>
__device__ __forceinline__ float element(R raw, int j, float scale) {
  if constexpr (S == kF32) {
    return __uint_as_float(word(raw, j));
  } else if constexpr (S == kBF16) {
    const uint32_t w = word(raw, j >> 1);
    return __uint_as_float(j & 1 ? w & 0xFFFF0000u : w << 16);
  } else {
    const int q = static_cast<int>(word(raw, j >> 2) << (24 - 8 * (j & 3)))
                  >> 24;
    return __fmul_rn(__int2float_rn(q), scale);
  }
}

// The combiner on a finished sum: divide (weighted column) or multiply by
// the rounded reciprocal; 0 where the denominator is not > 0.
template <int U>
__device__ __forceinline__ void finish(float (&acc)[U], int32_t code,
                                       bool divide, float wsum, float w2sum) {
  if (code == 0) return;
  const float denom = code == 1 ? wsum : __fsqrt_rn(w2sum);
#pragma unroll
  for (int j = 0; j < U; ++j) {
    if (!(denom > 0.0f)) {
      acc[j] = 0.0f;
    } else if (divide) {
      acc[j] = __fdiv_rn(acc[j], denom);
    } else {
      acc[j] = __fmul_rn(acc[j], __fdiv_rn(1.0f, denom));
    }
  }
}

// U output floats with the evict-first hint: one float, or float4 runs
template <int U>
__device__ __forceinline__ void store(float* o, const float (&acc)[U]) {
  if constexpr (U == 1) {
    __stcs(o, acc[0]);
  } else {
#pragma unroll
    for (int v = 0; v < U / 4; ++v) {
      __stcs(reinterpret_cast<float4*>(o) + v,
             make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                         acc[4 * v + 3]));
    }
  }
}

// Slots 0 .. L-1 of one bag, K at a time: a chunk's ids, then all its row
// loads (kept raw), then the adds in slot order, each element converted
// as its add takes it.
template <int S, int U, int K>
__device__ __forceinline__ void pool_slots(
    const Raw<S, U>* __restrict__ table, const float* __restrict__ scales,
    const int32_t* __restrict__ id_row, const float* __restrict__ w_row,
    int L, int32_t cap, int64_t off, int64_t dq, int64_t q, float (&acc)[U],
    float& wsum, float& w2sum) {
  for (int l0 = 0; l0 < L; l0 += K) {
    int32_t id[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      id[k] = l0 + k < L ? __ldg(id_row + l0 + k) : -1;
    }
    Raw<S, U> r[K];
    float sc[K], w[K];
    bool ok[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int32_t i = id[k] < cap ? id[k] : cap;
      ok[k] = i >= 0;
      const int64_t row = static_cast<int64_t>(i) + off;
      r[k] = ok[k] ? __ldg(table + row * dq + q) : Raw<S, U>{};
      sc[k] = S == kInt8 && ok[k] ? __ldg(scales + row) : 1.0f;
      w[k] = ok[k] && w_row ? __ldg(w_row + l0 + k) : 1.0f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ok[k]) {
#pragma unroll
        for (int j = 0; j < U; ++j) {
          acc[j] = __fadd_rn(acc[j],
                             __fmul_rn(element<S>(r[k], j, sc[k]), w[k]));
        }
        wsum = __fadd_rn(wsum, w[k]);
        w2sum = __fadd_rn(w2sum, __fmul_rn(w[k], w[k]));
      }
    }
  }
}

// One bag-tile block of group g: its tile's bags, G lanes a bag, U stored
// elements a lane load.
template <int S, int U, int G>
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
  const auto* table = static_cast<const Raw<S, U>*>(g.table);
  float* out = static_cast<float*>(g.out) + (b * g.C + c) * dq * U;
  for (int64_t q = sub; q < dq; q += G) {
    float acc[U];
#pragma unroll
    for (int j = 0; j < U; ++j) acc[j] = 0.0f;
    float wsum = 0.0f, w2sum = 0.0f;
    if (L == 1) {
      pool_slots<S, U, 1>(table, g.scales, id_row, w_row, 1, cap, off, dq,
                          q, acc, wsum, w2sum);
    } else {
      pool_slots<S, U, chunk_of(U)>(table, g.scales, id_row, w_row, L, cap,
                                    off, dq, q, acc, wsum, w2sum);
    }
    finish(acc, code, divide, wsum, w2sum);
    store(out + q * U, acc);
  }
}

template <int S, int U>
__device__ __forceinline__ void pool_tile_g(const X1Group& g, int lg,
                                            int64_t local) {
  switch (lg) {
    case 0: pool_tile<S, U, 1>(g, local); break;
    case 1: pool_tile<S, U, 2>(g, local); break;
    case 2: pool_tile<S, U, 4>(g, local); break;
    case 3: pool_tile<S, U, 8>(g, local); break;
    case 4: pool_tile<S, U, 16>(g, local); break;
    default: pool_tile<S, U, 32>(g, local); break;
  }
}

// The one-id tile's value of a stored unit of T's width (one element, or
// four): +0.0 + each element as f32, an int8 entry times its row's scale.
template <int S, typename T>
struct OneIdValue {
  const float (*scales)[onehot::kCols + 1];   // int8 only

  template <typename R>
  __device__ __forceinline__ T operator()(R raw, int bl, int cl) const {
    float s = 1.0f;
    if constexpr (S == kInt8) s = scales[bl][cl];
    if constexpr (sizeof(T) == sizeof(float)) {
      return __fadd_rn(0.0f, element<S>(raw, 0, s));
    } else {
      return make_float4(__fadd_rn(0.0f, element<S>(raw, 0, s)),
                         __fadd_rn(0.0f, element<S>(raw, 1, s)),
                         __fadd_rn(0.0f, element<S>(raw, 2, s)),
                         __fadd_rn(0.0f, element<S>(raw, 3, s)));
    }
  }
};

// Shared memory of a one-id block: the tile's row offsets, then (int8) its
// row scales.
constexpr int kRowsBytes =
    sizeof(int64_t) * onehot::kRows * (onehot::kCols + 1);
constexpr int kScalesBytes =
    sizeof(float) * onehot::kRows * (onehot::kCols + 1);

// One one-id block of group g (L == 1, no weights): 32 columns x 32 batch
// rows, T the output unit (float, or float4 of four stored elements).
template <int S, typename T>
__device__ __forceinline__ void oneid_tile(const X1Group& g, int64_t local,
                                           unsigned char* smem) {
  using onehot::kCols;
  using onehot::kRows;
  auto rows = reinterpret_cast<int64_t (*)[kCols + 1]>(smem);
  auto scl = reinterpret_cast<float (*)[kCols + 1]>(smem + kRowsBytes);
  // column tiles first, as K1's grid runs: the blocks in flight write
  // neighbouring pieces of the same batch rows
  const int64_t tiles_c = (g.C + kCols - 1) / kCols;
  const int64_t tb = local / tiles_c;
  const int64_t c0 = (local - tb * tiles_c) * kCols;
  const int64_t b0 = tb * kRows;
  const int nc = static_cast<int>(g.C - c0 < kCols ? g.C - c0 : kCols);
  const int nb = static_cast<int>(g.Bp - b0 < kRows ? g.Bp - b0 : kRows);
  const int64_t dq = g.dq;
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int cl = e / kRows, bl = e % kRows;
    if (cl < nc && bl < nb) {
      const int64_t c = c0 + cl;
      const int32_t id = __ldg(g.ids + c * g.Bp + b0 + bl);
      const int32_t cap = __ldg(g.caps + c);
      const int32_t i = id < cap ? id : cap;
      const int64_t row = static_cast<int64_t>(i) + __ldg(g.row_offsets + c);
      rows[bl][cl] = i >= 0 ? row * dq : -1;
      if constexpr (S == kInt8) {
        scl[bl][cl] = i >= 0 ? __ldg(g.scales + row) : 0.0f;
      }
    }
  }
  __syncthreads();
  constexpr int U = sizeof(T) / sizeof(float);
  onehot::write_tile_rows(static_cast<const Raw<S, U>*>(g.table), rows,
                          static_cast<T*>(g.out), g.C, c0, b0, nc, nb,
                          static_cast<int>(dq), OneIdValue<S, T>{scl});
}

// S: the stored dtype of every group of the launch
template <int S>
__global__ void __launch_bounds__(kThreads, kMinBlocks) pooled_gather_kernel(
    const __grid_constant__ X1Launch batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t blk = blockIdx.x;
  int i = 0;
  while (i + 1 < batch.n && blk >= batch.g[i + 1].block_begin) ++i;
  const X1Group& g = batch.g[i];
  const int64_t local = blk - g.block_begin;
  const int lu = (g.kind >> 3) & 7, lg = g.kind & 7;
  if (g.kind & kOneId) {
    if (lu == 2) {
      oneid_tile<S, float4>(g, local, smem);
    } else {
      oneid_tile<S, float>(g, local, smem);
    }
    return;
  }
  switch (lu) {
    case 0: pool_tile_g<S, 1>(g, lg, local); break;
    case 2: pool_tile_g<S, 4>(g, lg, local); break;
    case 3:
      if constexpr (S != kF32) pool_tile_g<S, 8>(g, lg, local);
      break;
    default:
      if constexpr (S == kInt8) pool_tile_g<S, 16>(g, lg, local);
      break;
  }
}

// The units a lane may load for stored dtype S: 1, 4, and up to 16 bytes
constexpr bool unit_ok(int s, int lu) {
  return lu == 0 || lu == 2 || (lu == 3 && s != kF32) ||
         (lu == 4 && s == kInt8);
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
  bool oneid = false;
  for (int64_t i = 0; i < n; ++i) {
    batch.g[i] = src[i];
    const int32_t kind = src[i].kind;
    const int lu = (kind >> 3) & 7;
    const bool one = (kind & kOneId) != 0;
    if ((S == kInt8 && src[i].scales == nullptr) || !unit_ok(S, lu) ||
        kind < 0 || kind >= 2 * kOneId ||
        (one && (lu > 2 || src[i].L != 1 || src[i].weights != nullptr))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    oneid = oneid || one;
  }
  batch.n = static_cast<int32_t>(n);
  const int smem = oneid ? kRowsBytes + (S == kInt8 ? kScalesBytes : 0) : 0;
  pooled_gather_kernel<S><<<static_cast<unsigned>(blocks), kThreads, smem,
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
