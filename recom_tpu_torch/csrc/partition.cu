// Part: the partition pass of the backward kernels X1b
// (pooled_gather_grad.cu) and K3a/K3b (onehot_grad.cu).  It orders each
// member's (X1b) or column's (K3a, K3b) entries by the work item that will
// sum them, keeping entry order inside each item, so that each item then
// reads only its own entries (the layout of item_lists.cuh).
//
// Replaces no TPU kernel of its own: it is a phase of the ports of
// recom_tpu/ops/lookup_pallas.py::onehot_lookup._bwd (K3a),
// onehot_bucketize_lookup._bwd (K3b) and XLA's autodiff of
// recom_tpu/ops/lookup_xla.py::group_pooled (X1b), whose scatter-adds XLA
// leaves to the TPU's own sort.  On Hopper the backward kernels run one
// block a work item, in parallel, and before this pass every item re-read
// all of its member's entries to find its own: items x entries loads (the
// all-to-all exchange's pool: 961 tiles x 61 440 slots, 236 MB from L2),
// where this pass and the items together read each entry about twice.
//
// The item of an entry is a pure function of its value: the id clamped to
// its member's cap (X1b, K3a) or the bucket bucket_search.cuh finds for a
// raw value (K3b, the search K2 runs, so a gradient lands on the row its
// forward read); its item is value / unit (the member's dense tile rows,
// sparse range rows or vocab tile rows), and a value < 0 or >= lim (past
// the member's rows), or whose item is past the member's items, has none
// and is dropped.
//
// One block a segment of kSeg consecutive entries of a member, one launch
// for every group of a training step (the forward's, ops/item_lists.py::
// StepLists: K3a's, K3b's and X1b's groups together): the block loads the
// segment's values, then orders them with the stable counting sort of
// ordered_runs.cuh (each warp counts, then places, a contiguous range in
// order), by the item's 12-bit digits, least significant first, where a
// member has more than 4096 items (one pass otherwise); it writes the
// placed entries, -1 for the rest of its places, and its row of each
// item's first place (the counting sort's starts, or a binary search over
// the sorted items after several passes).  Integers only, no atomics on
// device memory: the output is the same every run, equal to its plain
// version (ops/item_lists.py::partition_plain).
//
// A segment holds kSeg = 2048 entries (half of the first version's: a
// block's phases, not its launch, set the pass's time, and smaller
// segments cut it; A/B on the H100 at model E's and Criteo's shapes, where
// 1024 slowed K3a's reading of the lists).  The block writes its offsets,
// one per item (items + 1 ints), as one contiguous row (item_lists.cuh's
// layout), a store of consecutive words by consecutive threads.  Tried
// and taken out: digits as wide as the block's entries need (2^5 to 2^11
// bins), so that zeroing and scanning the bins cost O(entries) a pass.
// Where a member has more items than that, the extra pass and the
// offsets' binary search cost more than one pass of 4096 bins (part_ab.py
// on the H100: 0.0316 against 0.0263 ms for 4096-item members), and the
// paths' shapes did not move.
//
// Why a launch of its own: every item of the backward kernels needs every
// segment's placement done first, and blocks of one launch cannot wait on
// one another without a cooperative launch; the items take the scan over
// their own segments' starts themselves (item_lists.cuh), so no third
// launch is needed.  Every size is fixed by the host plan (S, the items
// of each member), so the pass captures into a CUDA graph unchanged.
//
// What bounds it on the H100: the bytes of the values read once and the
// slots, values and offsets written once, and at the paths' small sizes
// the latency of one block's phases (a few microseconds).

#include <cstdint>
#include <cuda_runtime.h>

#include "bucket_search.cuh"
#include "item_lists.cuh"
#include "ordered_runs.cuh"

namespace {

using lists::kSeg;
using runs::kThreads;
using runs::kWarps;
constexpr int kMaxGroups = 16;      // groups a launch
constexpr int kDigitBits = 12;
constexpr int kMaxBins = 1 << kDigitBits;
constexpr int kSearches = 4;        // K3b: searches a thread interleaves

// One group of a launch; the layout of ops/item_lists.py::PART_DESC.
struct PartGroup {
  const int32_t* ids;      // [C, S] ids (kind 0)
  const float* raw;        // [C, S] raw values (kind 1)
  const int32_t* caps;     // [C] last valid id (kind 0)
  const float* hi;         // [C, V] upper interval bounds (kind 1)
  const int32_t* counts;   // [C] boundary counts (kind 1)
  const int32_t* minfo;    // [C, 4]: unit, items, lim, ibase
  int32_t* slot;           // [C, S]
  int32_t* val;            // [C, S]
  int32_t* off;            // [sum nseg (items + 1)], item_lists.cuh
  int64_t S, C, nseg, V, half, kind, block_begin;
};

struct PartLaunch {
  PartGroup g[kMaxGroups];
  int32_t n;
  int32_t bins;            // the largest pass's bins (shared memory)
};

__host__ __device__ inline size_t smem_bytes(int bins) {
  return sizeof(int) * (2 * kSeg + 2 * static_cast<size_t>(bins)) +
         sizeof(uint16_t) * (2 * kSeg + kWarps * static_cast<size_t>(bins));
}

__global__ void __launch_bounds__(kThreads)
    partition_kernel(const __grid_constant__ PartLaunch P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* key = reinterpret_cast<int*>(smem);      // [kSeg] item, -1 none
  int* val = key + kSeg;                        // [kSeg]
  int* total = val + kSeg;                      // [bins]
  int* start = total + P.bins;                  // [bins]
  uint16_t* ord = reinterpret_cast<uint16_t*>(start + P.bins);  // [2][kSeg]
  uint16_t* wcnt = ord + 2 * kSeg;              // [kWarps][bins]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int gk = 0;
  while (gk + 1 < P.n && blockIdx.x >= P.g[gk + 1].block_begin) ++gk;
  const PartGroup& a = P.g[gk];
  const int64_t blk = blockIdx.x - a.block_begin;
  const int c = static_cast<int>(blk / a.nseg);
  const int s = static_cast<int>(blk - static_cast<int64_t>(c) * a.nseg);
  const int64_t e0 = static_cast<int64_t>(s) * kSeg;
  const int64_t left = a.S - e0;
  const int n = static_cast<int>(left < kSeg ? (left > 0 ? left : 0) : kSeg);
  const int unit = __ldg(a.minfo + 4 * c);
  const int items = __ldg(a.minfo + 4 * c + 1);
  const int lim = __ldg(a.minfo + 4 * c + 2);
  const int64_t ibase = __ldg(a.minfo + 4 * c + 3);
  const int64_t mbase = static_cast<int64_t>(c) * a.S + e0;

  // 1. each entry's value and item
  auto note = [&](int i, int32_t v) {
    const int k = v >= 0 && v < lim ? v / unit : -1;
    key[i] = k < items ? k : -1;
    val[i] = v;
    ord[i] = static_cast<uint16_t>(i);
  };
  if (a.kind == 0) {
    const int32_t cap = __ldg(a.caps + c);
    for (int i = tid; i < n; i += kThreads) {
      const int32_t id = __ldg(a.ids + mbase + i);
      note(i, id < cap ? id : cap);
    }
  } else {
    const int64_t row = static_cast<int64_t>(c) * a.V;
    const int v = static_cast<int>(a.V);
    for (int i0 = tid; i0 < n; i0 += kSearches * kThreads) {
      float x[kSearches];
      int64_t hrow[kSearches];
      int pos[kSearches];
#pragma unroll
      for (int k = 0; k < kSearches; ++k) {
        const int i = i0 + k * kThreads;
        x[k] = i < n ? __ldg(a.raw + mbase + i) : 0.0f;
        hrow[k] = row;
      }
      bucket::upper_bounds<kSearches, int64_t>(a.hi, hrow, x, pos, v,
                                               static_cast<int>(a.half));
#pragma unroll
      for (int k = 0; k < kSearches; ++k) {
        const int i = i0 + k * kThreads;
        if (i < n) note(i, bucket::bucket_of(x[k], pos[k], a.counts, c));
      }
    }
  }
  __syncthreads();

  // 2. the stable counting sort by item, a 12-bit digit a pass (least
  // significant first); entries with no item drop out in the first pass
  int m = 0;      // entries in the current order
  int cur = 0;
  bool one_pass = true;
  if (items > 0) {
    m = n;
    for (int sh = 0;; sh += kDigitBits) {
      const int top = (items - 1) >> sh;
      const int nb = top >= kMaxBins ? kMaxBins : top + 1;
      const uint16_t* from = ord + cur * kSeg;
      uint16_t* to = ord + (cur ^ 1) * kSeg;
      uint16_t* mine = wcnt + warp * nb;
      for (int j = tid; j < kWarps * nb; j += kThreads) wcnt[j] = 0;
      const int span = runs::warp_span(m);
      const int lo = min(warp * span, m);
      const int hi = min(lo + span, m);
      __syncthreads();
      auto digit = [&](int p) {
        const int k = key[from[p]];
        return k < 0 ? -1 : (k >> sh) & (kMaxBins - 1);
      };
      for (int p = lo + lane; p < hi; p += 32) runs::count_key(mine, digit(p));
      __syncthreads();
      runs::starts(total, start, wcnt, nb);
      for (int i0 = lo; i0 < hi; i0 += 32) {
        const int p = i0 + lane;
        const int dg = p < hi ? digit(p) : -1;
        const int at = runs::place_of(mine, dg, lane);
        if (at >= 0) to[at] = from[p];
      }
      __syncthreads();
      m = start[nb - 1] + total[nb - 1];
      cur ^= 1;
      if (top < kMaxBins) break;
      one_pass = false;
    }
  }

  // 3. the placed entries, -1 past them; each item's first place
  const uint16_t* sorted = ord + cur * kSeg;
  int32_t* so = a.slot + mbase;
  int32_t* vo = a.val + mbase;
  for (int p = tid; p < n; p += kThreads) {
    const int e = p < m ? sorted[p] : -1;
    so[p] = e < 0 ? -1 : static_cast<int32_t>(e0 + e);
    vo[p] = e < 0 ? -1 : val[e];
  }
  int32_t* oo = a.off + lists::row_of(ibase, items, a.nseg, s);
  if (one_pass) {
    for (int i = tid; i < items; i += kThreads) oo[i] = start[i];
  } else {
    for (int i = tid; i < items; i += kThreads) {
      int lo = 0, hi = m;     // the first place whose item is >= i
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key[sorted[mid]] < i) lo = mid + 1; else hi = mid;
      }
      oo[i] = lo;
    }
  }
  if (tid == 0) oo[items > 0 ? items : 0] = m;
}

}  // namespace

// Launch Part over n <= kMaxGroups groups described by the host array
// `groups` (PartGroup records, each group's C x nseg blocks numbered from
// its block_begin), `blocks` blocks in all, and `bins` the bins of the
// largest pass (the most items of any member, at most 4096; the shared
// memory; ops/item_lists.py::digit_bins).  Returns the launch's
// cudaError_t.
extern "C" int rt_partition(const void* groups, int64_t n, int64_t blocks,
                            int64_t bins, void* stream) {
  if (n < 1 || n > kMaxGroups || blocks < 0 || blocks > 2147483647 ||
      bins < 1 || bins > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PartLaunch P = {};
  const PartGroup* src = static_cast<const PartGroup*>(groups);
  for (int64_t i = 0; i < n; ++i) {
    const PartGroup& g = src[i];
    if (g.S < 0 || g.S > 2147483647 || g.nseg < 1 ||
        g.nseg * kSeg < g.S || g.kind < 0 || g.kind > 1 ||
        (g.kind == 1 && (g.V < 1 || g.V > (1 << 30)))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    P.g[i] = g;
  }
  P.n = static_cast<int32_t>(n);
  P.bins = static_cast<int32_t>(bins);
  if (blocks == 0) return 0;
  const size_t bytes = smem_bytes(static_cast<int>(bins));
  cudaError_t err = cudaFuncSetAttribute(
      partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// The constants the host plans with, in the order of
// ops/item_lists.py::PART_LIMITS: kMaxGroups, kSeg, kMaxBins, kWin,
// sizeof(PartGroup).
extern "C" void rt_partition_limits(int64_t* out) {
  out[0] = kMaxGroups;
  out[1] = kSeg;
  out[2] = kMaxBins;
  out[3] = lists::kWin;
  out[4] = sizeof(PartGroup);
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
