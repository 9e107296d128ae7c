// X1b: the backward pass of the gather + pooling X1 (pooled_gather.cu), by
// hand for Hopper: the dense gradient of each stacked column group's table.
//
// Replaces: XLA's autodiff of recom_tpu/ops/lookup_xla.py::group_pooled
// (the transpose of gather_rows_f32's jnp.take, of pool_rows_inorder's
// products and scan, and of apply_combiner_divisors), which the JAX
// package's training takes through jax.value_and_grad.
//
// For every valid slot (c, b, l), id_l = min(ids[c, b, l], caps[c]) >= 0:
//   dacc  = g[b, c, :]                                    SUM
//         = g * __fdiv_rn(1, den)   unweighted  MEAN / SQRTN, den > 0
//         = __fdiv_rn(g, den)       weighted    MEAN / SQRTN, den > 0
//         = 0                                             den not > 0
//   dtable[row_offsets[c] + id_l, :] += dacc * w[c, b, l]
// with den the bag's weight sum (MEAN) or __fsqrt_rn of its squared weight
// sum (SQRTN), summed in slot order as the forward does, and w the slot's
// weight (1 for an unweighted column).  Each step is rounded on its own, as
// XLA computes JAX's cotangents: the divide's f64 quotient narrowed to f32
// (exact_div) is the correctly rounded f32 quotient.  A missing slot adds
// nothing (the masked-slot convention of X1); rows no slot touches are
// +0.0.
//
// Deterministic, with no float atomics: each row's sum is taken strictly in
// [C, Bp, L] slot order from +0.0 (__fmul_rn/__fadd_rn, -fmad=false), so
// two runs give the same bits, equal to the plain version's index_add_ in
// slot order (ops/lookup_gather.py).
//
// What bounds it on the H100: bytes, and of those the dense output.  JAX's
// cotangent of a table is dense [R, d], and so is this one: model E's
// large group (41.9 M rows x 32) is 5.37 GB to write, 1.6 ms at 3.35 TB/s,
// against under 10 MB of cotangent, ids and weights.  This kernel writes
// every element of each output exactly once, zeros included, so the
// output needs no fill.
//
// Design.  One launch serves up to kMaxGroups groups.  Each member (column)
// c of a group owns the rows [row_offsets[c], row_offsets[c] + caps[c] + 1)
// of its table, disjoint from every other member's (the wrapper checks), so
// a row's sum runs over its own member's Bp x L slots alone.  The host cuts
// every group's rows into work items (ops/lookup_gather.py::x1b_plan), a
// block each:
// - dense: a tile of at most kMaxKeys rows of a member with a small vocab
//   (model E: 10 000 rows x d 8, tiles of 512 rows), or of a member whose
//   rows are few beside its slots (the all-to-all exchange's receive
//   buffer), its sums in shared memory;
// - sparse: a range of at most kRangeRows rows of a member with a large
//   vocab (model E: 2^23 rows x d 32), whose touched rows a bitmap marks
//   and a scan of the words' popcounts numbers; the host sizes a member's
//   ranges so that its slots, spread evenly, fill about one window of
//   touched rows each (x1b_range_rows: the Criteo DLRM's 39 060-row member
//   takes ranges of 1024 rows, model E's 2^23-row lists 32 768);
// - zero: rows that no member owns.
// The partition pass (partition.cu, a launch before this one) has ordered
// each member's slots by item, in slot order within each, so a block walks
// only its item's list (item_lists.cuh): a sparse item marks its touched
// rows from it, and the stable counting sort of ordered_runs.cuh (K3's)
// orders it by key (the row in the tile, or the touched row's number), a
// run per key in slot order, kSeg slots at a time; a thread per (run,
// element) adds its run's terms in order.  A MEAN or SQRTN slot's
// denominator is summed once a slot.  A sparse range crowded past
// kMaxKeys touched rows takes the same sort window by window, each window
// walking the item's list again (its own slots only).  Then the block
// streams its rows out once, in order, a bitmap word's 32 rows a warp, 16
// bytes a lane with the evict-first hint (__stcs) where d % 4 == 0: each
// row its sum if touched, else +0.0.  Sparse blocks of the large group
// spend most of their time in that stream; two blocks an SM let one's
// ordering overlap the other's writes, and the work list puts sparse
// items first so that the short dense and zero items fill the SMs that
// the last sparse ones leave.  The cost of finding the slots falls from
// items x slots to slots + items.
//
// The design before (PERF.md): every block read its
// member's whole [Bp, L] id plane to collect its hits, ranked them by an
// O(n^2) count, and a crowded range rescanned every slot of the member a
// window at a time; the exchange's receive buffer was cut into 4 members
// of 32 768 rows, each given every slot (the cotangent copied 4x).  On an
// NVIDIA H100 80GB HBM3 at 700 W it read 0.3926 ms as the exchange pool's
// backward (library 0.0135), 1.3542 as the psum partial's backward
// (library 0.8283), 1.0088 as the owner's scatter (library 0.8282),
// 0.9988 at the Criteo DLRM (library 0.5954) and 1.7877 at model E
// (library 1.6892).
//
// The first port (PERF.md) sorted each group's slots with a stable
// torch.sort, zero-filled the output with torch.zeros, then wrote the
// touched rows a second time, one launch per group: 1.9809 ms for model
// E's three groups on an H100.

#include <cstdint>
#include <cuda_runtime.h>

#include "item_lists.cuh"
#include "ordered_runs.cuh"

namespace {

using runs::kThreads;
using runs::kWarps;
constexpr int kMinBlocks = 2;        // blocks an SM holds (shared memory)
constexpr int kMaxGroups = 8;        // groups a launch
constexpr int kMaxKeys = 512;        // rows a tile or window sums
constexpr int kAccFloats = 4096;     // a tile's or window's sums (16 KB)
constexpr int kSeg = 4096;           // slots a block orders at a time
constexpr int kRangeRows = 32768;    // rows of a sparse item
constexpr int kWords = kRangeRows / 32;
constexpr int kLoads = 16;           // list loads a thread keeps in flight
constexpr int kUnroll = 4;           // terms read ahead of the ordered adds

constexpr size_t kSmemBytes =
    sizeof(float) * kAccFloats +
    sizeof(int) * (kWarps * kMaxKeys + 2 * kMaxKeys) +
    (2 * sizeof(int16_t) + sizeof(float) + sizeof(int32_t)) * kSeg +
    sizeof(uint32_t) * kWords + sizeof(int) * (kWords + 1) +
    sizeof(int) * lists::kWinInts;

// One group of a launch; the layout of ops/lookup_gather.py::X1B_DESC.
struct X1bGroup {
  const float* g;          // [Bp, C, d], batch stride gs, inner contiguous
  const int32_t* ids;      // [C, Bp, L] member-local ids, < 0 = missing
  const float* weights;    // [C, Bp, L] or null (unweighted: w = 1)
  const int32_t* caps;     // [C] last valid row per member
  const int32_t* codes;    // [C] 0 sum / 1 mean / 2 sqrtn
  const uint8_t* weighted; // [C] 1: divide, 0: multiply by the reciprocal
  float* out;              // [R, d], every element written once
  int64_t gs;
  int64_t C, Bp, L, d;
};

// A group's item lists (partition.cu); the layout of
// ops/lookup_gather.py::X1B_LISTS.
struct X1bLists {
  lists::Lists l;          // slot, val, off, S = Bp L, nseg
  const int32_t* minfo;    // [C, 4]: unit, items, lim, ibase
};

struct X1bLaunch {
  X1bGroup g[kMaxGroups];
  X1bLists l[kMaxGroups];
  int32_t n;
};

// A block's work: rows [row_lo, row_lo + nrows) of its group's output,
// which are its member's local rows [local_lo, local_lo + nrows).  kind:
// ((member + 1) << 4) | (group << 1) | dense, member -1 for a zero item.
struct Work {
  int64_t row_lo, local_lo, nrows, kind;
};

// The combiner denominator of the bag whose slots start at ids[bag], as the
// forward sums it.
__device__ __forceinline__ float bag_den(const X1bGroup& a, int64_t bag,
                                         int32_t cap, int code) {
  float ws = 0.0f, w2 = 0.0f;
  for (int64_t k = 0; k < a.L; ++k) {
    int32_t id = __ldg(a.ids + bag + k);
    id = id < cap ? id : cap;
    const float m = id >= 0 ? 1.0f : 0.0f;
    const float wl = a.weights ? __fmul_rn(__ldg(a.weights + bag + k), m) : m;
    ws = __fadd_rn(ws, wl);
    w2 = __fadd_rn(w2, __fmul_rn(wl, wl));
  }
  return code == 1 ? ws : __fsqrt_rn(w2);
}

struct Shared {
  float* acc;       // [kAccFloats] sums of the tile or window's rows
  int* wcnt;        // [kWarps][kMaxKeys] counts, then places
  int* total;       // [kMaxKeys]
  int* start;       // [kMaxKeys]
  float* den;       // [kSeg] a slot's combiner denominator
  int16_t* place;   // [kSeg] a segment slot's key
  uint16_t* list;   // [kSeg] segment slots by key
  int32_t* cslot;   // [kSeg] a segment entry's slot
  uint32_t* bitmap; // [kWords] touched rows of a sparse item
  int* wpre;        // [kWords + 1] touched rows before each word
  lists::Window win;
};

// The touched row's number among the item's touched rows.
__device__ __forceinline__ int touched_rank(const Shared& sh, int r) {
  const uint32_t bits = sh.bitmap[r >> 5];
  return sh.wpre[r >> 5] + __popc(bits & ((1u << (r & 31)) - 1u));
}

// Sum the item's entries into acc[key * d + e], in slot order, for the
// keys of rows [r_lo, r_hi) of the item: the row itself (dense) or its
// number among the touched rows less k0 (sparse).  nk keys.  The entries:
// the item's lists (item gi of off), window after window, kSeg at a time.
template <bool kDense>
__device__ void accumulate(const X1bGroup& a, const lists::Lists& L,
                           Shared& sh, int c, lists::Item gi, int64_t local_lo,
                           int r_lo, int r_hi, int k0, int nk) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = static_cast<int>(a.d);
  const int64_t mbase = static_cast<int64_t>(c) * L.S;
  const int32_t cap = __ldg(a.caps + c);
  const int code = __ldg(a.codes + c);
  const bool divide = __ldg(a.weighted + c) != 0;
  int* mine = sh.wcnt + warp * nk;
  // a slot's bag, s / L, by the reciprocal where S < 2^20
  const bool small_s = L.S < (1 << 20);
  const float inv_l = runs::recip(static_cast<int>(small_s ? a.L : 1));
  auto bag_of = [&](int64_t s) -> int64_t {
    return small_s ? runs::quot(static_cast<int>(s), inv_l) : s / a.L;
  };
  __syncthreads();
  for (int p = tid; p < nk * d; p += kThreads) sh.acc[p] = 0.0f;
  const int nwin = lists::windows(L.nseg);
  for (int w = 0; w < nwin; ++w) {
    const int entries = lists::load_window(L, gi, c, w, sh.win);
    for (int base = 0; base < entries; base += kSeg) {
      const int n = min(entries - base, kSeg);
      for (int j = tid; j < kWarps * nk; j += kThreads) sh.wcnt[j] = 0;
      const int span = runs::warp_span(n);
      const int lo = min(warp * span, n);
      const int hi = min(lo + span, n);
      __syncthreads();
      // 1. each entry's slot and key, counted; a MEAN / SQRTN slot's
      // denominator
      for (int i0 = lo; i0 < hi; i0 += 32 * kLoads) {
        int64_t at[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int i = i0 + k * 32 + lane;
          at[k] = i < hi ? lists::place(sh.win, base + i) : -1;
        }
        int32_t sl[kLoads], v[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          sl[k] = at[k] >= 0 ? __ldg(L.slot + at[k]) : -1;
          v[k] = at[k] >= 0 ? __ldg(L.val + at[k]) : -1;
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const int i = i0 + k * 32 + lane;
          int key = -1;
          if (i < hi) {
            const int64_t r64 = static_cast<int64_t>(v[k]) - local_lo;
            const int r = static_cast<int>(r64);
            if (r64 >= r_lo && r64 < r_hi) {
              key = kDense ? r : touched_rank(sh, r) - k0;
            }
            sh.place[i] = static_cast<int16_t>(key);
            sh.cslot[i] = sl[k];
            if (key >= 0 && code != 0) {
              sh.den[i] = bag_den(a, mbase + bag_of(sl[k]) * a.L, cap, code);
            }
          }
          runs::count_key(mine, key);
        }
      }
      __syncthreads();
      // 2. totals, starts, each warp's first places
      runs::starts(sh.total, sh.start, sh.wcnt, nk);
      // 3. each warp places its entries, in slot order
      for (int i0 = lo; i0 < hi; i0 += 32) {
        const int i = i0 + lane;
        const int key = i < hi ? sh.place[i] : -1;
        const int at = runs::place_of(mine, key, lane);
        if (at >= 0) sh.list[at] = static_cast<uint16_t>(i);
      }
      __syncthreads();
      // 4. a thread per (run, element) adds the run's terms in slot order:
      // the thread of the run's first place walks it
      const int nhit = sh.start[nk - 1] + sh.total[nk - 1];
      const bool small_p = nhit * d < (1 << 20);
      const float inv_d = runs::recip(small_p ? d : 1);
      for (int p = tid; p < nhit * d; p += kThreads) {
        const int j = small_p ? runs::quot(p, inv_d) : p / d;
        const int e = p - j * d;
        const int key = sh.place[sh.list[j]];
        if (j != sh.start[key]) continue;
        const uint16_t* run = sh.list + j;
        const int m = sh.total[key];
        const int q = key * d + e;
        float acc = sh.acc[q];
        for (int j0 = 0; j0 < m; j0 += kUnroll) {
          float t[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            t[u] = 0.0f;
            if (j0 + u < m) {
              const int i = run[j0 + u];
              const int64_t s = sh.cslot[i];
              const int64_t b = bag_of(s);
              const float gv = __ldg(a.g + b * a.gs +
                                     static_cast<int64_t>(c) * d + e);
              float dacc = gv;
              if (code != 0) {
                const float den = sh.den[i];
                dacc = !(den > 0.0f) ? 0.0f
                       : divide      ? __fdiv_rn(gv, den)
                                     : __fmul_rn(gv, __fdiv_rn(1.0f, den));
              }
              const float w = a.weights ? __ldg(a.weights + mbase + s) : 1.0f;
              t[u] = __fmul_rn(dacc, w);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (j0 + u < m) acc = __fadd_rn(acc, t[u]);
          }
        }
        sh.acc[q] = acc;
      }
      __syncthreads();
    }
  }
}

// Mark a sparse item's touched rows in the bitmap, from its lists.
__device__ void mark_rows(const lists::Lists& L, Shared& sh, int c,
                          lists::Item gi, int64_t local_lo, int nrows) {
  const int nwin = lists::windows(L.nseg);
  for (int w = 0; w < nwin; ++w) {
    const int entries = lists::load_window(L, gi, c, w, sh.win);
    for (int j0 = threadIdx.x; j0 < entries; j0 += kThreads * kLoads) {
      int32_t v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int j = j0 + k * kThreads;
        v[k] = j < entries ? __ldg(L.val + lists::place(sh.win, j)) : -1;
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int64_t r = static_cast<int64_t>(v[k]) - local_lo;
        if (v[k] >= 0 && r >= 0 && r < nrows) {
          atomicOr(sh.bitmap + (r >> 5), 1u << (r & 31));
        }
      }
    }
  }
  __syncthreads();
}

// Stream rows [r_lo, r_hi) of the item out, in order, a bitmap word's 32
// rows a warp: a touched row's sum from acc (dense: every row, at its
// index; sparse: at its number less k0), else +0.0.  kind: 0 zero rows,
// 1 dense, 2 sparse.  r_lo is a multiple of 32.
template <typename T>
__device__ __forceinline__ void write_rows(const X1bGroup& a,
                                           const Shared& sh, int64_t row_lo,
                                           int r_lo, int r_hi, int kind,
                                           int k0) {
  constexpr int kw = sizeof(T) / sizeof(float);
  const int dq = static_cast<int>(a.d) / kw;
  const bool pow2 = (dq & (dq - 1)) == 0;
  const int sh2 = __ffs(dq) - 1;
  const float inv_dq = runs::recip(dq);
  const int lane = threadIdx.x & 31;
  T zero;
  float* zf = reinterpret_cast<float*>(&zero);
#pragma unroll
  for (int k = 0; k < kw; ++k) zf[k] = 0.0f;
  const T* acc = reinterpret_cast<const T*>(sh.acc);
  for (int w = (r_lo >> 5) + (threadIdx.x >> 5); w * 32 < r_hi; w += kWarps) {
    const uint32_t bits =
        kind == 2 ? sh.bitmap[w] : (kind == 1 ? 0xffffffffu : 0u);
    const int rank0 = kind == 2 ? sh.wpre[w] - k0 : w * 32;
    const int rows = min(32, r_hi - w * 32);
    T* o = reinterpret_cast<T*>(a.out) + (row_lo + w * 32) * dq;
    if (bits == 0u && rows == 32) {
      for (int t = lane; t < 32 * dq; t += 32) __stcs(o + t, zero);
      continue;
    }
    for (int t = lane; t < rows * dq; t += 32) {
      const int rr = pow2 ? t >> sh2 : runs::quot(t, inv_dq);
      T v = zero;
      if ((bits >> rr) & 1u) {
        const int rank =
            rank0 + (kind == 2 ? __popc(bits & ((1u << rr) - 1u)) : rr);
        v = acc[rank * dq + (t - rr * dq)];
      }
      __stcs(o + t, v);
    }
  }
}

__device__ __forceinline__ void write_out(const X1bGroup& a, const Shared& sh,
                                          int64_t row_lo, int r_lo, int r_hi,
                                          int kind, int k0) {
  if (a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0) {
    write_rows<float4>(a, sh, row_lo, r_lo, r_hi, kind, k0);
  } else {
    write_rows<float>(a, sh, row_lo, r_lo, r_hi, kind, k0);
  }
}

// wpre[w] = the touched rows in words [0, w), for w in [0, nw].
__device__ __forceinline__ void number_words(const Shared& sh, int nw) {
  __shared__ int warp_tot[kWarps];
  constexpr int kPer = kWords / kThreads;   // words a thread counts
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int cnt[kPer];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int w = tid * kPer + k;
    cnt[k] = w < nw ? __popc(sh.bitmap[w]) : 0;
    mine += cnt[k];
  }
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int r = incl - mine;
  for (int w = 0; w < warp; ++w) r += warp_tot[w];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int w = tid * kPer + k;
    if (w < nw) sh.wpre[w] = r;
    r += cnt[k];
  }
  if (tid == kThreads - 1) sh.wpre[nw] = r;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pooled_gather_grad_kernel(const __grid_constant__ X1bLaunch batch,
                              const Work* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared sh;
  sh.acc = reinterpret_cast<float*>(smem);
  sh.wcnt = reinterpret_cast<int*>(sh.acc + kAccFloats);
  sh.total = sh.wcnt + kWarps * kMaxKeys;
  sh.start = sh.total + kMaxKeys;
  sh.den = reinterpret_cast<float*>(sh.start + kMaxKeys);
  sh.cslot = reinterpret_cast<int32_t*>(sh.den + kSeg);
  sh.place = reinterpret_cast<int16_t*>(sh.cslot + kSeg);
  sh.list = reinterpret_cast<uint16_t*>(sh.place + kSeg);
  sh.bitmap = reinterpret_cast<uint32_t*>(sh.list + kSeg);
  sh.wpre = reinterpret_cast<int*>(sh.bitmap + kWords);
  sh.win.bind(sh.wpre + kWords + 1);

  const Work wk = work[blockIdx.x];
  const int64_t member = (wk.kind >> 4) - 1;
  const int gk = static_cast<int>((wk.kind >> 1) & 7);
  const X1bGroup& a = batch.g[gk];
  const int nrows = static_cast<int>(wk.nrows);
  if (member < 0) {
    write_out(a, sh, wk.row_lo, 0, nrows, 0, 0);
    return;
  }
  const int c = static_cast<int>(member);
  const int d = static_cast<int>(a.d);
  const bool dense = wk.kind & 1;
  const lists::Lists& L = batch.l[gk].l;
  // the item's offsets: the member's first row and the item's number
  const int32_t* mi = batch.l[gk].minfo + 4 * c;
  const lists::Item gi = lists::item_of(L, __ldg(mi + 3), __ldg(mi + 1),
                                        wk.local_lo / __ldg(mi));
  if (dense) {
    accumulate<true>(a, L, sh, c, gi, wk.local_lo, 0, nrows, 0, nrows);
    write_out(a, sh, wk.row_lo, 0, nrows, 1, 0);
    return;
  }
  // a sparse item: its touched rows, numbered
  const int nw = (nrows + 31) / 32;
  for (int w = threadIdx.x; w < nw; w += kThreads) sh.bitmap[w] = 0u;
  mark_rows(L, sh, c, gi, wk.local_lo, nrows);
  number_words(sh, nw);
  const int runs_max = min(kMaxKeys, kAccFloats / d);
  const int touched = sh.wpre[nw];
  if (touched <= runs_max) {
    if (touched > 0) {
      accumulate<false>(a, L, sh, c, gi, wk.local_lo, 0, nrows, 0, touched);
    }
    write_out(a, sh, wk.row_lo, 0, nrows, touched > 0 ? 2 : 0, 0);
    return;
  }
  // crowded: window by window, each a walk of the item's own list
  for (int w0 = 0; w0 < nw;) {
    // the last word w1 whose touched rows since w0 fit the window
    int lo = w0 + 1, hi = nw;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (sh.wpre[mid] - sh.wpre[w0] <= runs_max) lo = mid; else hi = mid - 1;
    }
    const int w1 = lo;
    const int k0 = sh.wpre[w0];
    const int nk = sh.wpre[w1] - k0;
    const int r_lo = w0 * 32, r_hi = min(w1 * 32, nrows);
    if (nk > 0) {
      accumulate<false>(a, L, sh, c, gi, wk.local_lo, r_lo, r_hi, k0, nk);
    }
    write_out(a, sh, wk.row_lo, r_lo, r_hi, nk > 0 ? 2 : 0, k0);
    __syncthreads();
    w0 = w1;
  }
}

}  // namespace

// Launch X1b over n <= kMaxGroups groups described by the host arrays
// `groups` (X1bGroup records) and `item_lists` (X1bLists records: each
// group's lists, written by the partition launch before this one) and
// the device array `work` of n_work Work records, a block each
// (ops/lookup_gather.py::x1b_plan).  Returns the launch's cudaError_t.
extern "C" int rt_pooled_gather_grad_f32(const void* groups, int64_t n,
                                         const void* item_lists,
                                         const void* work, int64_t n_work,
                                         void* stream) {
  if (n < 1 || n > kMaxGroups || n_work < 0 || n_work > 2147483647) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  X1bLaunch batch = {};
  const X1bGroup* src = static_cast<const X1bGroup*>(groups);
  const X1bLists* ls = static_cast<const X1bLists*>(item_lists);
  for (int64_t i = 0; i < n; ++i) {
    batch.g[i] = src[i];
    batch.l[i] = ls[i];
    const int64_t d = src[i].d;
    if (d < 1 || d > kAccFloats || src[i].L < 1 || src[i].gs < 0 ||
        ls[i].l.S != src[i].Bp * src[i].L || ls[i].l.S > 2147483647 ||
        ls[i].l.nseg < 1 || ls[i].l.nseg * lists::kSeg < ls[i].l.S) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  batch.n = static_cast<int32_t>(n);
  if (n_work == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kSmemBytes > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaFuncSetAttribute(pooled_gather_grad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  pooled_gather_grad_kernel<<<static_cast<unsigned>(n_work), kThreads,
                              kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      batch, static_cast<const Work*>(work));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's constants the host plans with, in the order of
// ops/lookup_gather.py::X1B_LIMITS: kMaxGroups, kMaxKeys, kAccFloats,
// kRangeRows, sizeof(X1bGroup), sizeof(Work), sizeof(X1bLists).
extern "C" void rt_pooled_gather_grad_limits(int64_t* out) {
  out[0] = kMaxGroups;
  out[1] = kMaxKeys;
  out[2] = kAccFloats;
  out[3] = kRangeRows;
  out[4] = sizeof(X1bGroup);
  out[5] = sizeof(Work);
  out[6] = sizeof(X1bLists);
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
