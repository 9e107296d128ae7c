// K3a and K3b: the backward passes of the one-hot lookups K1 and K2, by
// hand for Hopper.
//
// Replaces: recom_tpu/ops/lookup_pallas.py::onehot_lookup._bwd (K3a, the
// only gradient the Pallas kernel _kernel has) and
// onehot_bucketize_lookup._bwd (K3b, _bz_kernel's), both per-column
// scatter-adds that the JAX package leaves to XLA.
//
//   K3a: dtable3[c, v, :] = sum over b in batch order of g[b, c, :]
//                           where min(ids[c, b], caps[c]) == v  (ids < 0 drop)
//   K3b: the same with the id bucket(raw[c, b]) (bucket_search.cuh, the
//        search K2 runs, so each gradient lands on the row its forward read)
//
// K1 fuses the serving clamp to caps (the JAX package clamps before the
// kernel, recom_tpu/runtime/executor.py:503-505), so K3a clamps too: an id
// past its cap adds to row caps[c].  Planes c >= C and rows that no entry
// selects are written as +0.0; every element of dtable3 is written once,
// so the output needs no fill.
//
// Deterministic, with no float atomics: each row's sum is taken strictly in
// batch order, from +0.0, every add rounded on its own (__fadd_rn and
// -fmad=false), so two runs give the same bits and the result equals the
// plain version's index_add_ in batch order (ops/lookup_onehot.py).
//
// What bounds it on the H100: bytes.  At model E's one-hot group and batch
// 2048 it reads the [Bp, 930, 8] f32 cotangent (61 MB) and the ids (7.6
// MB) once and writes the [936, 128, 8] gradient (3.8 MB): about 72 MB,
// 0.022 ms at 3.35 TB/s.  At the Criteo DLRM's five one-hot groups (d =
// 64) the whole gradient is 5.4 MB and the bound 0.005 ms, so there the
// latency of a few dependent phases and the number of launches count.
//
// Design.  One launch serves up to kMaxGroups groups of one kind (K3a: the
// backward of every one-hot group of a step, ops/lookup_onehot.py::
// onehot_lookups_grad).  An item is a few adjacent columns of a group (cb:
// as many as make a batch row's slice of g at most 32 floats, 128 bytes,
// and whose keys and sums fit; 4 at d = 8) and a tile of nv vocab rows;
// its keys are (column, row) pairs, at most kMaxKeys.  A group whose vocab
// is one tile takes all its columns' batch rows.  A group cut into several
// tiles (cb = 1: the Criteo DLRM's vocabularies of 128 to 2304 at d = 64,
// tiles of 64 rows) takes, item by item, only the batch rows that select
// its tile: the partition pass (partition.cu, a launch before this one)
// has listed each column's entries by tile, in batch order, with their
// clamped ids or buckets (item_lists.cuh).  Blocks are persistent, two an
// SM, each walking its items.  An item's cotangent rows go through a ring
// of two shared-memory stages of seg entries each: the slices g[b, c0 :
// c0 + cb, :] of its entries' batch rows, gathered by cp.async 16 bytes a
// lane where g allows (4 otherwise; 256 bytes a row at d = 64), the rows
// padded to 36 floats where a multiple of 32 so that lanes reading one
// offset of different rows hit different banks.  While a block sums one
// stage the next is in flight.  A pass is kWarps stages; for each pass:
//   1. warp w takes stage w's entries: it loads all their ids (K3a, then
//      clamped), listed values, or raw values (K3b, then kSearches
//      interleaved searches a lane over the item's boundary rows, staged
//      in shared memory where they fit) at once, and counts their keys
//      with shared-memory atomics; the item's first stages go out only
//      after these loads, so the ids are not queued behind the cotangent;
//   2-3. the stable counting sort of ordered_runs.cuh orders the pass's
//      entries by key, each key's run in batch order; as warp w placed
//      stage w's entries, its places end where stage w's part of each run
//      ends, so each stage's part of a run is known exactly;
//   4. stage after stage, each thread adds the terms its units (float4
//      where d % 4 == 0) have in the stage, in order.  Units map to
//      threads turned per column, so that one hot row of each column lands
//      on another thread.
// The item's sums stay in registers and are written once at its end.
// Integer quotients by runtime sizes use an exact reciprocal
// (runs::quot).  A row selected by many entries is one long chain of
// dependent adds, the price of a sum in batch order: model E's random
// batches put about 1950 of a bucketize column's 2048 entries in one
// bucket, and that chain bounds the item.
//
// The design before (PERF.md): one launch a group, and every item
// streamed its column's whole cotangent and ids through the ring whatever
// its tile, so a column of 36 tiles read its [2048, 64] cotangent 36
// times; on an NVIDIA H100 80GB HBM3 at 700 W the Criteo DLRM's five
// launches read 0.2220 ms (library 0.0379), model E's one 0.0990 and
// bucketize-880's K3b 0.1323.
//
// The first port (a block per column, one-float copies of the cotangent
// rows, the phases one after another) read 0.0975 ms (K3a) and 0.0999 ms
// (K3b) on an H100 (PERF.md).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bucket_search.cuh"
#include "item_lists.cuh"
#include "ordered_runs.cuh"

namespace {

using runs::kThreads;
using runs::kWarps;
constexpr int kMinBlocks = 2;      // blocks an SM holds (shared memory)
constexpr int kMaxGroups = 16;     // groups a launch
constexpr int kSearches = 4;       // K3b: searches a thread interleaves
constexpr int kRowFloats = 32;     // an item's slice of a batch row, at most
constexpr int kMaxKeys = 512;      // (column, row) keys of an item
constexpr int kAccFloats = 4096;   // an item's sums
constexpr int kStages = 2;         // the ring's stages
constexpr int kStageFloats = 8192; // a stage's cotangent rows (32 KB)
constexpr int kStageEntries = 1024;  // a stage's (column, batch row) entries
constexpr int kPassEntries = kWarps * kStageEntries;  // a pass: a stage a warp
constexpr int kLaneEntries = kStageEntries / 32;   // a lane's, in a pass
constexpr int kHiFloats = 1024;    // K3b: an item's boundary rows, staged
constexpr int kRotate = 72;        // a thread's units, turned per slot
// K3b's staged boundary rows (identity items) and a listed item's window
// of segments (item_lists.cuh) share their shared memory
constexpr int kUnionInts =
    kHiFloats > lists::kWinInts ? kHiFloats : lists::kWinInts;

constexpr size_t kSmemBytes =
    sizeof(float) * kStages * kStageFloats +
    sizeof(int) * 2 * kMaxKeys +
    sizeof(uint16_t) * (kWarps * kMaxKeys + 2 * kPassEntries) +
    sizeof(int) * kUnionInts;

// One group of a launch, as the host describes it; the layout of
// ops/lookup_onehot.py::K3_DESC.  K3a reads ids and caps, K3b raw, hi and
// counts; slot, val and off are the partition's lists (null: every item
// takes all its columns' batch rows).
struct HostGroup {
  const float* g;          // [Bp, C, d], batch stride gs, inner contiguous
  const int32_t* ids;      // [C, Bp] local ids, < 0 = missing
  const int32_t* caps;     // [C] last valid row per column
  const float* raw;        // [C, Bp] raw feature values
  const float* hi;         // [C_pad, V] upper interval bounds
  const int32_t* counts;   // [C_pad] boundary counts
  float* dtable;           // [C_pad, V, d], written whole
  const int32_t* slot;     // [C, Bp] listed batch rows, or null
  const int32_t* val;      // [C, Bp] their clamped ids / buckets
  const int32_t* off;      // [nseg C (v_tiles + 1)], item_lists.cuh
  int64_t gs, C, C_pad, Bp, V, d, cb, nv, v_tiles, nseg, item_begin;
};

// The same, with what the launch derives: the stage rows, the copy width,
// the search's first step.
struct Group {
  const float* g;
  const int32_t* ids;
  const int32_t* caps;
  const float* raw;
  const float* hi;
  const int32_t* counts;
  float* dtable;
  lists::Lists L;          // slot null: not listed
  int64_t gs;
  int C, C_pad, Bp, V, d, cb, nv, v_tiles, item_begin;
  int seg;                 // entries of a stage
  int vec;                 // g allows 16-byte copies (aligned, gs % 4 == 0)
  int half;                // K3b: the search's first step
};

struct Launch {
  Group g[kMaxGroups];
  int32_t n;
  int32_t items;
};

struct Item {
  int c0, nc_out, nc_in, v0, nvv, tile;
};

__device__ __forceinline__ Item item_of(const Group& G, int li) {
  Item m;
  const int cg = li / G.v_tiles;
  m.c0 = cg * G.cb;
  m.nc_out = min(G.cb, G.C_pad - m.c0);
  m.nc_in = max(0, min(m.nc_out, G.C - m.c0));
  m.tile = li - cg * G.v_tiles;
  m.v0 = m.tile * G.nv;
  m.nvv = min(G.nv, G.V - m.v0);
  return m;
}

// The floats between two staged batch rows of w floats: a row whose width
// is a multiple of 32 floats is padded by 4, so that the rows that a warp's
// lanes read at one offset fall in 8 different groups of banks.
__host__ __device__ __forceinline__ int stage_stride(int w) {
  return w % 32 == 0 ? w + 4 : w;
}

// A 16-byte asynchronous copy that skips L1 (the rows are read once).
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Start the copies of the item's stage t (its entries [t seg, t seg +
// seg) of n) into the ring slot `slot`, and commit them as one group (an
// empty group past its last stage): the cotangent rows g[b, c0 : c0 +
// nc_in, :] of the entries' batch rows b (listed: from the window's
// lists; else the entries themselves).
__device__ __forceinline__ void issue(const Group& G, const Item& m,
                                      const lists::Window& win, bool listed,
                                      float* stage, int slot, int t, int n) {
  const int b0 = t * G.seg;
  if (b0 < n) {
    const int rows = min(G.seg, n - b0);
    const int w = m.nc_in * G.d;
    const int ws = stage_stride(w);
    float* st = stage + slot * kStageFloats;
    const float* src = G.g + static_cast<int64_t>(m.c0) * G.d;
    auto row_of = [&](int i) -> int64_t {
      return listed ? __ldg(G.L.slot + lists::place(win, b0 + i))
                    : static_cast<int64_t>(b0 + i);
    };
    if (G.vec && ws % 4 == 0 && (m.c0 * G.d) % 4 == 0) {
      const int wq = w / 4;
      const float inv = runs::recip(wq);
      for (int t2 = threadIdx.x; t2 < rows * wq; t2 += kThreads) {
        const int i = runs::quot(t2, inv);
        const int x = 4 * (t2 - i * wq);
        copy16(st + i * ws + x, src + row_of(i) * G.gs + x);
      }
    } else {
      const float inv = runs::recip(w);
      for (int t2 = threadIdx.x; t2 < rows * w; t2 += kThreads) {
        const int i = runs::quot(t2, inv);
        const int x = t2 - i * w;
        __pipeline_memcpy_async(st + i * ws + x, src + row_of(i) * G.gs + x,
                                sizeof(float));
      }
    }
  }
  __pipeline_commit();
}

// The entry's row in the tile [v0, v0 + nv), or -1.
__device__ __forceinline__ int tile_row(int32_t id, int v0, int nv) {
  const int lv = id - v0;
  return id >= 0 && lv >= 0 && lv < nv ? lv : -1;
}

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 fadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The terms of a run from place js to je (all in the staged rows from
// pass row r0 on) added to acc in order.  T: a unit of a row, float4 or
// float; ws and off count units.  (A plain loop: reading rows ahead of the
// adds measured slower on an H100, 22 against 15 cycles a float4 term.)
template <typename T>
__device__ __forceinline__ T add_run(const uint16_t* list, const T* st,
                                     int js, int je, int r0, int ws, int off,
                                     T acc) {
  for (int j = js; j < je; ++j) {
    acc = fadd(acc, st[(static_cast<int>(list[j]) - r0) * ws + off]);
  }
  return acc;
}

// T: the unit of a row a thread sums, float4 where d % 4 == 0, else float.
// kLists: some group of the launch is listed (a launch of none leaves the
// lists' code out, and with it their registers).
template <bool kBucketize, bool kLists, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    onehot_grad_kernel(const __grid_constant__ Launch P) {
  constexpr int kw = sizeof(T) / sizeof(float);
  constexpr int kPer = kAccFloats / kThreads / kw;   // units a thread sums
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [kStages][kStageFloats]
  int* total = reinterpret_cast<int*>(stage + kStages * kStageFloats);
  int* start = total + kMaxKeys;          // [kMaxKeys] each run's first place
  uint16_t* wcnt = reinterpret_cast<uint16_t*>(start + kMaxKeys);
  uint16_t* place = wcnt + kWarps * kMaxKeys;  // [kPassEntries] key + 1
  uint16_t* list = place + kPassEntries;  // a pass's entries, by key
  int* shared_union = reinterpret_cast<int*>(list + kPassEntries);
  float* hi_s = reinterpret_cast<float*>(shared_union);  // K3b, not listed
  lists::Window win;                      // listed items
  win.bind(shared_union);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int q0 = 0;                             // the ring's stages so far
  for (int it = blockIdx.x; it < P.items; it += gridDim.x) {
    int gk = 0;
    while (gk + 1 < P.n && it >= P.g[gk + 1].item_begin) ++gk;
    const Group& G = P.g[gk];
    const Item m = item_of(G, it - G.item_begin);
    const bool listed = kLists && G.L.slot != nullptr;
    const int d = G.d;
    const int dq = d / kw;                // units of a row
    const int pass_rows = kWarps * G.seg;
    const int nk = m.nc_in * m.nvv;
    const int ws = stage_stride(m.nc_in * d) / kw;  // a staged row's units
    uint16_t* mine = wcnt + warp * nk;
    const float inv_nv = runs::recip(m.nvv);
    const float inv_dq = runs::recip(dq);
    // each slot's key and its unit's place in a staged row, once an item
    int key_of[kPer], off_of[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = k * kThreads + (tid + k * kRotate) % kThreads;
      const int key = runs::quot(p, inv_dq);
      key_of[k] = p < nk * dq ? key : -1;
      off_of[k] = runs::quot(key, inv_nv) * dq + (p - key * dq);
    }
    // slot k of this thread sums unit p = k * kThreads + (tid + k *
    // kRotate) % kThreads of the item, (key, unit) = (p / dq, p % dq): a
    // key's units on neighbouring lanes, and each column's turned, so that
    // a hot row of every column lands on other threads
    T a[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) a[k] = T{};
    // K3b: the item's columns' boundary rows in shared memory, where they
    // fit, so that each search step is a shared load
    const bool hi_shared =
        kBucketize && !listed && m.nc_in * G.V <= kHiFloats;
    __syncthreads();   // the previous item's readers of shared memory
    if (hi_shared) {
      for (int t = tid; t < m.nc_in * G.V; t += kThreads) {
        hi_s[t] = __ldg(G.hi + static_cast<int64_t>(m.c0) * G.V + t);
      }
    }
    // the item's entries: a listed item's, window by window; else its
    // columns' Bp batch rows
    const lists::Item gi = lists::item_of(
        G.L, static_cast<int64_t>(m.c0) * (G.v_tiles + 1),
        static_cast<int>(G.v_tiles), m.tile);
    const int nwin = listed ? (m.nc_in > 0 ? lists::windows(G.L.nseg) : 0)
                            : 1;
    for (int w = 0; w < nwin; ++w) {
      const int n = listed ? lists::load_window(G.L, gi, m.c0, w, win)
                           : G.Bp;
      const int nst_all = (n + G.seg - 1) / G.seg;
      for (int pbase = 0; pbase < n; pbase += pass_rows) {
        const int np = min(pass_rows, n - pbase);
        const int nst = (np + G.seg - 1) / G.seg;
        const int s0 = pbase / G.seg;     // the pass's first stage
        for (int j = tid; j < kWarps * nk; j += kThreads) wcnt[j] = 0;
        __syncthreads();
        // 1. warp w finds and counts the keys of stage w's entries: its
        // entries [w seg, w seg + rows) of the pass, column after column
        const int rows = warp < nst ? min(G.seg, np - warp * G.seg) : 0;
        const int e0 = warp * kStageEntries;
        const int ne = m.nc_in * rows;
        const int j0 = pbase + warp * G.seg;
        const float inv_rows = runs::recip(max(rows, 1));
        // its entries' ids (K3a), listed values, or raw values (K3b),
        // lane-strided, all in flight at once
        uint32_t v[kLaneEntries];
#pragma unroll
        for (int k = 0; k < kLaneEntries; ++k) {
          const int e = k * 32 + lane;
          v[k] = 0u;
          if (e < ne) {
            if (listed) {
              v[k] = static_cast<uint32_t>(
                  __ldg(G.L.val + lists::place(win, j0 + e)));
            } else {
              const int cl = runs::quot(e, inv_rows);
              const int64_t at = static_cast<int64_t>(m.c0 + cl) * G.Bp +
                                 j0 + e - cl * rows;
              v[k] = kBucketize ? __float_as_uint(__ldg(G.raw + at))
                                : static_cast<uint32_t>(__ldg(G.ids + at));
            }
          }
        }
        if (kBucketize && !listed) {
#pragma unroll
          for (int k0 = 0; k0 < kLaneEntries; k0 += kSearches) {
            if (k0 * 32 >= ne) break;
            float x[kSearches];
            int64_t hrow[kSearches];
            int pos[kSearches];
            int cl[kSearches];
#pragma unroll
            for (int k = 0; k < kSearches; ++k) {
              const int e = (k0 + k) * 32 + lane;
              cl[k] = e < ne ? runs::quot(e, inv_rows) : 0;
              x[k] = __uint_as_float(v[k0 + k]);
              hrow[k] = static_cast<int64_t>(hi_shared ? cl[k]
                                                       : m.c0 + cl[k]) * G.V;
            }
            if (hi_shared) {
              bucket::upper_bounds<kSearches, int64_t, false>(
                  hi_s, hrow, x, pos, G.V, G.half);
            } else {
              bucket::upper_bounds<kSearches, int64_t>(G.hi, hrow, x, pos,
                                                       G.V, G.half);
            }
#pragma unroll
            for (int k = 0; k < kSearches; ++k) {
              const int e = (k0 + k) * 32 + lane;
              const int lv =
                  e < ne ? tile_row(bucket::bucket_of(x[k], pos[k], G.counts,
                                                      m.c0 + cl[k]),
                                    m.v0, m.nvv)
                         : -1;
              const int key = lv >= 0 ? cl[k] * m.nvv + lv : -1;
              if (e < ne) place[e0 + e] = static_cast<uint16_t>(key + 1);
              runs::count_key(mine, key);
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < kLaneEntries; ++k) {
            if (k * 32 >= ne) break;
            const int e = k * 32 + lane;
            int key = -1;
            if (e < ne) {
              const int cl = runs::quot(e, inv_rows);
              const int32_t id = static_cast<int32_t>(v[k]);
              const int lv =
                  tile_row(listed ? id
                                  : min(id, __ldg(G.caps + m.c0 + cl)),
                           m.v0, m.nvv);
              key = lv >= 0 ? cl * m.nvv + lv : -1;
              place[e0 + e] = static_cast<uint16_t>(key + 1);
            }
            runs::count_key(mine, key);
          }
        }
        // the item's first stages go out once its first ids are in, so
        // that those are not queued behind the cotangent
        if (pbase == 0) {
          issue(G, m, win, listed, stage, q0 % kStages, 0, n);
          issue(G, m, win, listed, stage, (q0 + 1) % kStages, 1, n);
        }
        __syncthreads();
        // 2. totals, starts, each warp's first places
        runs::starts(total, start, wcnt, nk);
        // 3. each warp places its entries' pass rows, in batch order; its
        // places then end where its stage's part of each run ends
        for (int i0 = 0; i0 < ne; i0 += 32) {
          const int e = i0 + lane;
          const int key = e < ne ? static_cast<int>(place[e0 + e]) - 1 : -1;
          const int at = runs::place_of(mine, key, lane);
          if (at >= 0) {
            list[at] = static_cast<uint16_t>(
                warp * G.seg + e - runs::quot(key, inv_nv) * rows);
          }
        }
        __syncthreads();
        // 4. stage after stage, each unit's terms in the stage, in order
        for (int s = 0; s < nst; ++s) {
          const int t = s0 + s;           // the item's stage number
          __pipeline_wait_prior(kStages - 1);
          __syncthreads();
          const T* st = reinterpret_cast<const T*>(
              stage + ((q0 + t) % kStages) * kStageFloats);
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int key = key_of[k];
            if (key < 0) continue;
            const int js = s == 0 ? start[key] : wcnt[(s - 1) * nk + key];
            const int je = wcnt[s * nk + key];
            if (js < je) {
              a[k] = add_run(list, st, js, je, s * G.seg, ws, off_of[k],
                             a[k]);
            }
          }
          __syncthreads();
          issue(G, m, win, listed, stage, (q0 + t) % kStages, t + kStages,
                n);
        }
      }
      if (n > 0) q0 += nst_all + kStages;
    }
    // the item's sums, each element once (planes >= C and untouched rows
    // as +0.0)
    const int nout = m.nc_out * m.nvv * dq;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = k * kThreads + (tid + k * kRotate) % kThreads;
      if (p < nout) {
        const int cl = runs::quot(p, runs::recip(m.nvv * dq));
        reinterpret_cast<T*>(G.dtable)[(static_cast<int64_t>(m.c0 + cl) *
                                            G.V + m.v0) * dq +
                                       (p - cl * m.nvv * dq)] = a[k];
      }
    }
  }
}

template <bool kBucketize>
int launch(const void* groups, int64_t n, void* stream) {
  if (n < 1 || n > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HostGroup* src = static_cast<const HostGroup*>(groups);
  Launch P = {};
  P.n = static_cast<int32_t>(n);
  bool unit4 = true, any_listed = false;
  int64_t items = 0;
  for (int64_t i = 0; i < n; ++i) {
    const HostGroup& h = src[i];
    // an item's keys: at most kMaxKeys, their sums at most kAccFloats
    const int64_t keys = h.d < 1 ? 0
                         : (kMaxKeys < kAccFloats / h.d ? kMaxKeys
                                                        : kAccFloats / h.d);
    const bool listed = h.slot != nullptr;
    any_listed = any_listed || listed;
    if (h.C < 0 || h.C > h.C_pad || h.C_pad > (1 << 30) || h.Bp < 0 ||
        h.Bp > 2147483647 || h.V < 1 || h.V > (1 << 30) || h.d < 1 ||
        h.d > kAccFloats || h.gs < 0 || h.cb < 1 || h.nv < 1 ||
        h.cb * h.nv > keys || (h.cb > 1 && h.cb * h.d > kRowFloats) ||
        h.v_tiles < 1 || h.v_tiles * h.nv < h.V ||
        (h.v_tiles - 1) * h.nv >= h.V || h.item_begin != items ||
        (listed && (h.cb != 1 || h.nseg < 1 ||
                    h.nseg * lists::kSeg < h.Bp))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Group& G = P.g[i];
    G.g = h.g;
    G.ids = h.ids;
    G.caps = h.caps;
    G.raw = h.raw;
    G.hi = h.hi;
    G.counts = h.counts;
    G.dtable = h.dtable;
    G.L = lists::Lists{h.slot, h.val, h.off, h.Bp, h.nseg};
    G.gs = h.gs;
    G.C = static_cast<int>(h.C);
    G.C_pad = static_cast<int>(h.C_pad);
    G.Bp = static_cast<int>(h.Bp);
    G.V = static_cast<int>(h.V);
    G.d = static_cast<int>(h.d);
    G.cb = static_cast<int>(h.cb);
    G.nv = static_cast<int>(h.nv);
    G.v_tiles = static_cast<int>(h.v_tiles);
    G.item_begin = static_cast<int>(h.item_begin);
    int64_t seg = kStageFloats / stage_stride(static_cast<int>(h.cb * h.d));
    seg = seg < kStageEntries / h.cb ? seg : kStageEntries / h.cb;
    seg = seg < h.Bp ? seg : h.Bp;
    G.seg = static_cast<int>(seg > 1 ? seg : 1);
    G.vec = reinterpret_cast<uintptr_t>(h.g) % 16 == 0 && h.gs % 4 == 0;
    G.half = kBucketize ? bucket::first_step(h.V) : 0;
    unit4 = unit4 && h.d % 4 == 0 &&
            reinterpret_cast<uintptr_t>(h.dtable) % 16 == 0;
    items += (h.C_pad + h.cb - 1) / h.cb * h.v_tiles;
    if (items > 2147483647) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
  }
  P.items = static_cast<int32_t>(items);
  if (items == 0) return 0;

  // float4 units where every group's rows and output allow, else floats
  auto kernel =
      any_listed ? (unit4 ? onehot_grad_kernel<kBucketize, true, float4>
                          : onehot_grad_kernel<kBucketize, true, float>)
                 : (unit4 ? onehot_grad_kernel<kBucketize, false, float4>
                          : onehot_grad_kernel<kBucketize, false, float>);
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kSmemBytes > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const unsigned grid =
      static_cast<unsigned>(items < resident ? items : resident);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3a over n <= kMaxGroups groups described by the host array `groups`
// (HostGroup records; K3a reads g, ids, caps, dtable and the lists).
// Returns the launch's cudaError_t.
extern "C" int rt_onehot_lookup_grad_f32(const void* groups, int64_t n,
                                         void* stream) {
  return launch<false>(groups, n, stream);
}

// K3b: the same, reading raw [C, Bp] f32, hi [C_pad, V] f32 and counts
// [C_pad] int32 (the arrays K2 takes) instead of ids and caps.
extern "C" int rt_onehot_bucketize_grad_f32(const void* groups, int64_t n,
                                            void* stream) {
  return launch<true>(groups, n, stream);
}

// The kernels' constants the host plans with, in the order of
// ops/lookup_onehot.py::K3_LIMITS: kMaxGroups, kMaxKeys, kAccFloats,
// kRowFloats, sizeof(HostGroup).
extern "C" void rt_onehot_grad_limits(int64_t* out) {
  out[0] = kMaxGroups;
  out[1] = kMaxKeys;
  out[2] = kAccFloats;
  out[3] = kRowFloats;
  out[4] = sizeof(HostGroup);
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
