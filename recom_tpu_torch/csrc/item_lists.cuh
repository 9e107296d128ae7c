// The entry lists that the partition pass (partition.cu) writes and the
// backward kernels K3a/K3b (onehot_grad.cu) and X1b (pooled_gather_grad.cu)
// read: each work item of those kernels (a vocab tile of a column, a dense
// tile or a sparse range of a member) walks only its own entries, in their
// order, instead of scanning every entry of its member.
//
// Layout (one group).  Member c's S entries e are cut into nseg segments
// of kSeg, s = e / kSeg.  The region [c S + s kSeg, c S + s kSeg + n_s) of
// slot and val holds segment s's entries that fall in an item, ordered by
// item and, within an item, by e (a stable sort); the rest of the segment's
// places hold -1.  slot is the entry's index e, val its value (the clamped
// id, or the bucket).  Member c's offsets are nseg rows of items_c + 1,
// from ibase_c nseg on (ibase_c: the items + 1 of the members before it):
//   off[ibase_c nseg + s (items_c + 1) + i] = the first place of item i in
// segment s's region, i in [0, items_c] (so item i's entries there are
// [off(i, s), off(i + 1, s)), and off(items_c, s) counts the segment's
// placed entries).  A partition block (c, s) writes its row whole, with
// consecutive threads on consecutive words.

// A consumer takes an item's segments a window of kWin at a time: one
// thread a segment reads its two offsets, and a block scan numbers the
// item's entries across them (the exclusive scan over the item's segments,
// item-major and segment-minor, taken where it is needed); entry j of the
// window is then found by a binary search over the window's starts.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lists {

constexpr int kSeg = 2048;   // entries of a segment (a partition block's)
constexpr int kWin = 256;    // segments a consumer maps at once
constexpr int kWinInts = 2 * kWin + 1 + 8;   // a Window's shared ints

// One group's lists, as partition.cu writes them.
struct Lists {
  const int32_t* slot;   // [C, S] entry index, or -1
  const int32_t* val;    // [C, S] its clamped id or bucket, or -1
  const int32_t* off;    // [nseg sum_c (items_c + 1)]
  int64_t S;             // entries of a member
  int64_t nseg;          // segments of a member (>= 1)
};

// A window of an item's segments, in shared memory (kWinInts ints).
struct Window {
  int* pre;       // [kWin + 1] the window's entries before each segment
  int* lo;        // [kWin] the item's first place in each segment
  int* wtot;      // [8] a warp's sum, scratch
  int s0 = 0;     // the window's first segment
  int nsw = 0;    // its segments
  int64_t base = 0;   // the member's first place, c S

  __device__ void bind(int* smem) {
    pre = smem;
    lo = smem + kWin + 1;
    wtot = lo + kWin;
  }
};

// The first word of member c's offsets row of segment s (c's ibase and
// items; nseg: the group's segments a member).
__host__ __device__ __forceinline__ int64_t row_of(int64_t ibase, int items,
                                                   int64_t nseg, int64_t s) {
  return ibase * nseg + s * (static_cast<int64_t>(items) + 1);
}

// Item i of a member whose offsets start at ibase and which has `items`
// items: where its offset lies in each segment's row.
struct Item {
  int64_t base;     // ibase nseg + i
  int64_t stride;   // items + 1
};

__device__ __forceinline__ Item item_of(const Lists& L, int64_t ibase,
                                        int items, int64_t i) {
  return Item{row_of(ibase, items, L.nseg, 0) + i,
              static_cast<int64_t>(items) + 1};
}

// Map window w of item `it` of member c: returns the item's entries in
// segments [w kWin, w kWin + kWin).  All threads of a block of kWin
// threads call it; it begins and ends with a barrier.
__device__ __forceinline__ int load_window(const Lists& L, const Item& it,
                                           int c, int w, Window& win) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t s = static_cast<int64_t>(w) * kWin + t;
  int lo = 0, cnt = 0;
  if (s < L.nseg) {
    const int32_t* at = L.off + it.base + s * it.stride;
    lo = __ldg(at);
    cnt = __ldg(at + 1) - lo;
  }
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  __syncthreads();   // the previous window's readers are done
  if (lane == 31) win.wtot[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int k = 0; k < warp; ++k) before += win.wtot[k];
  const int excl = before + incl - cnt;
  win.pre[t] = excl;
  win.lo[t] = lo;
  if (t == kWin - 1) win.pre[kWin] = excl + cnt;
  win.s0 = w * kWin;
  const int64_t left = L.nseg - static_cast<int64_t>(w) * kWin;
  win.nsw = static_cast<int>(left < kWin ? left : kWin);
  win.base = static_cast<int64_t>(c) * L.S;
  __syncthreads();
  return win.pre[kWin];
}

// The place in slot / val of entry j of the mapped window.
__device__ __forceinline__ int64_t place(const Window& win, int j) {
  int a = 0, b = win.nsw - 1;
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (win.pre[m] <= j) a = m; else b = m - 1;
  }
  return win.base + static_cast<int64_t>(win.s0 + a) * kSeg + win.lo[a] +
         (j - win.pre[a]);
}

// The windows of a member's nseg segments.
__host__ __device__ __forceinline__ int windows(int64_t nseg) {
  return static_cast<int>((nseg + kWin - 1) / kWin);
}

}  // namespace lists
