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
// 0.022 ms at 3.35 TB/s.
//
// Design.  An item is a few adjacent columns (cb: as many as make a batch
// row's slice of g at most 32 floats, 128 bytes, and whose keys and sums
// fit; 4 at d = 8) and a tile of nv vocab rows; its keys are (column, row)
// pairs, at most kMaxKeys.  Blocks are persistent, two an SM, each walking
// its items.  The cotangent streams through a ring of two shared-memory
// stages of seg batch rows each: the slices g[b, c0 : c0 + cb, :] of
// consecutive rows, copied by cp.async 16 bytes a lane where g allows (4
// otherwise), the rows padded to 36 floats so that lanes reading one
// offset of different rows hit different banks.  The ring runs across
// items, so while a block sums one stage the next is in flight.  A pass is
// kWarps stages; for each pass:
//   1. warp w takes stage w's entries: it loads all their ids (K3a, then
//      clamped) or raw values (K3b, then kSearches interleaved searches a
//      lane over the item's boundary rows, staged in shared memory where
//      they fit) at once, and counts their keys with shared-memory atomics; the
//      block's first stages go out only after these loads, so the ids are
//      not queued behind the cotangent;
//   2-3. the stable counting sort of ordered_runs.cuh orders the pass's
//      batch rows by key, each key's run in batch order; as warp w placed
//      stage w's entries, its places end where stage w's part of each run
//      ends, so each stage's part of a run is known exactly;
//   4. stage after stage, each thread adds the terms its units (float4
//      where d % 4 == 0) have in the stage, in order, kUnroll read ahead.
//      Units map to threads turned per column, so that one hot row of
//      each column lands on another thread.
// The item's sums stay in registers and are written once at its end.
// Integer quotients by runtime sizes use an exact reciprocal
// (runs::quot).  A row selected by many entries is one long chain of
// dependent adds, the price of a sum in batch order: model E's random
// batches put about 1950 of a bucketize column's 2048 entries in one
// bucket, and that chain bounds the item.
//
// The first port (a block per column, one-float copies of the cotangent
// rows, the phases one after another) read 0.0975 ms (K3a) and 0.0999 ms
// (K3b) on an H100 (PERF.md).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bucket_search.cuh"
#include "ordered_runs.cuh"

namespace {

using runs::kThreads;
using runs::kWarps;
constexpr int kMinBlocks = 2;      // blocks an SM holds (shared memory)
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

constexpr size_t kSmemBytes =
    sizeof(float) * kStages * kStageFloats +
    sizeof(int) * 2 * kMaxKeys +
    sizeof(uint16_t) * (kWarps * kMaxKeys + 2 * kPassEntries) +
    sizeof(float) * kHiFloats;

// Where a column's ids come from: K3a reads them (ids, caps), K3b finds
// them (raw, hi, counts, half).
struct IdSource {
  const int32_t* ids;      // [C, Bp] local ids, < 0 = missing
  const int32_t* caps;     // [C] last valid row per column
  const float* raw;        // [C, Bp] raw feature values
  const float* hi;         // [C_pad, V] upper interval bounds
  const int32_t* counts;   // [C_pad] boundary counts
  int half;                // the search's first step
};

// The shapes, the items and the stage ring, set once by the host.
struct Geometry {
  int C, C_pad, Bp, V, d;
  int64_t gs;              // g's batch stride in floats
  int cb;                  // columns of an item
  int nv;                  // vocab rows of an item
  int v_tiles;             // vocab tiles of a column group
  int items;
  int seg;                 // batch rows of a stage
  int seg_per_item;        // stages of an item (kWarps make a pass)
  int vec;                 // g allows 16-byte copies (aligned, gs % 4 == 0)
};

struct Item {
  int c0, nc_out, nc_in, v0, nvv;
};

__device__ __forceinline__ Item item_of(const Geometry& G, int it) {
  Item m;
  const int cg = it / G.v_tiles;
  m.c0 = cg * G.cb;
  m.nc_out = min(G.cb, G.C_pad - m.c0);
  m.nc_in = max(0, min(m.nc_out, G.C - m.c0));
  m.v0 = (it - cg * G.v_tiles) * G.nv;
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

// Start the copies of stage number q of this block's sequence (its items'
// stages, in order) into ring slot q % kStages, and commit them as one
// group (an empty group past the block's last item): the cotangent rows
// g[b, c0 : c0 + nc_in, :] of the stage's batch rows.
__device__ __forceinline__ void issue(const float* __restrict__ g,
                                      const Geometry& G, float* stage,
                                      int q) {
  if (G.seg_per_item > 0) {
    const int iter = q / G.seg_per_item;
    const int it = blockIdx.x + iter * gridDim.x;
    if (it < G.items) {
      const Item m = item_of(G, it);
      const int b0 = (q - iter * G.seg_per_item) * G.seg;
      const int rows = min(G.seg, G.Bp - b0);
      const int w = m.nc_in * G.d;
      const int ws = stage_stride(w);
      float* st = stage + (q % kStages) * kStageFloats;
      const float* src = g + static_cast<int64_t>(b0) * G.gs +
                         static_cast<int64_t>(m.c0) * G.d;
      if (G.vec && ws % 4 == 0 && (m.c0 * G.d) % 4 == 0) {
        const int wq = w / 4;
        const float inv = runs::recip(wq);
        for (int t = threadIdx.x; t < rows * wq; t += kThreads) {
          const int i = runs::quot(t, inv);
          const int x = 4 * (t - i * wq);
          copy16(st + i * ws + x, src + i * G.gs + x);
        }
      } else {
        const float inv = runs::recip(w);
        for (int t = threadIdx.x; t < rows * w; t += kThreads) {
          const int i = runs::quot(t, inv);
          const int x = t - i * w;
          __pipeline_memcpy_async(st + i * ws + x, src + i * G.gs + x,
                                  sizeof(float));
        }
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
// batch row r0 on) added to acc in order.  T: a unit of a row, float4 or
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
template <bool kBucketize, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) onehot_grad_kernel(
    const float* __restrict__ g,        // [Bp, C, d], batch stride gs
    const IdSource src,
    float* __restrict__ dtable,         // [C_pad, V, d]
    const Geometry G) {
  constexpr int kw = sizeof(T) / sizeof(float);
  constexpr int kPer = kAccFloats / kThreads / kw;   // units a thread sums
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [kStages][kStageFloats]
  int* total = reinterpret_cast<int*>(stage + kStages * kStageFloats);
  int* start = total + kMaxKeys;          // [kMaxKeys] each run's first place
  uint16_t* wcnt = reinterpret_cast<uint16_t*>(start + kMaxKeys);
  uint16_t* place = wcnt + kWarps * kMaxKeys;  // [kPassEntries] key + 1
  uint16_t* list = place + kPassEntries;  // a pass's batch rows, by key
  float* hi_s = reinterpret_cast<float*>(list + kPassEntries);  // K3b
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = G.d;
  const int dq = d / kw;                  // units of a row
  const int pass_rows = kWarps * G.seg;

  int q = 0;                              // the block's stage number
  for (int it = blockIdx.x; it < G.items; it += gridDim.x) {
    const Item m = item_of(G, it);
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
    const bool hi_shared = kBucketize && m.nc_in * G.V <= kHiFloats;
    if (hi_shared) {
      for (int t = tid; t < m.nc_in * G.V; t += kThreads) {
        hi_s[t] = __ldg(src.hi + static_cast<int64_t>(m.c0) * G.V + t);
      }
    }
    for (int pbase = 0; pbase < G.Bp; pbase += pass_rows) {
      const int np = min(pass_rows, G.Bp - pbase);
      const int nst = (np + G.seg - 1) / G.seg;
      for (int j = tid; j < kWarps * nk; j += kThreads) wcnt[j] = 0;
      __syncthreads();
      // 1. warp w finds and counts the keys of stage w's entries: its
      // batch rows [w seg, w seg + rows) of the pass, column after column
      const int rows = warp < nst ? min(G.seg, np - warp * G.seg) : 0;
      const int e0 = warp * kStageEntries;
      const int n = m.nc_in * rows;
      const int64_t b0 = pbase + warp * G.seg;
      const float inv_rows = runs::recip(max(rows, 1));
      // its entries' ids (K3a) or raw values (K3b), lane-strided, all in
      // flight at once
      uint32_t v[kLaneEntries];
#pragma unroll
      for (int k = 0; k < kLaneEntries; ++k) {
        const int e = k * 32 + lane;
        v[k] = 0u;
        if (e < n) {
          const int cl = runs::quot(e, inv_rows);
          const int64_t at =
              static_cast<int64_t>(m.c0 + cl) * G.Bp + b0 + e - cl * rows;
          v[k] = kBucketize ? __float_as_uint(__ldg(src.raw + at))
                            : static_cast<uint32_t>(__ldg(src.ids + at));
        }
      }
      if constexpr (kBucketize) {
#pragma unroll
        for (int k0 = 0; k0 < kLaneEntries; k0 += kSearches) {
          if (k0 * 32 >= n) break;
          float x[kSearches];
          int64_t hrow[kSearches];
          int pos[kSearches];
          int cl[kSearches];
#pragma unroll
          for (int k = 0; k < kSearches; ++k) {
            const int e = (k0 + k) * 32 + lane;
            cl[k] = e < n ? runs::quot(e, inv_rows) : 0;
            x[k] = __uint_as_float(v[k0 + k]);
            hrow[k] = static_cast<int64_t>(hi_shared ? cl[k] : m.c0 + cl[k]) *
                      G.V;
          }
          if (hi_shared) {
            bucket::upper_bounds<kSearches, int64_t, false>(hi_s, hrow, x,
                                                            pos, G.V,
                                                            src.half);
          } else {
            bucket::upper_bounds<kSearches, int64_t>(src.hi, hrow, x, pos,
                                                     G.V, src.half);
          }
#pragma unroll
          for (int k = 0; k < kSearches; ++k) {
            const int e = (k0 + k) * 32 + lane;
            const int lv =
                e < n ? tile_row(bucket::bucket_of(x[k], pos[k], src.counts,
                                                   m.c0 + cl[k]),
                                 m.v0, m.nvv)
                      : -1;
            const int key = lv >= 0 ? cl[k] * m.nvv + lv : -1;
            if (e < n) place[e0 + e] = static_cast<uint16_t>(key + 1);
            runs::count_key(mine, key);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kLaneEntries; ++k) {
          if (k * 32 >= n) break;
          const int e = k * 32 + lane;
          int key = -1;
          if (e < n) {
            const int cl = runs::quot(e, inv_rows);
            const int32_t id = static_cast<int32_t>(v[k]);
            const int lv = tile_row(min(id, __ldg(src.caps + m.c0 + cl)),
                                    m.v0, m.nvv);
            key = lv >= 0 ? cl * m.nvv + lv : -1;
            place[e0 + e] = static_cast<uint16_t>(key + 1);
          }
          runs::count_key(mine, key);
        }
      }
      // the ring's first stages go out once the first ids are in, so that
      // those are not queued behind the cotangent
      if (q == 0 && pbase == 0 && it == static_cast<int>(blockIdx.x)) {
        issue(g, G, stage, 0);
        issue(g, G, stage, 1);
      }
      __syncthreads();
      // 2. totals, starts, each warp's first places
      runs::starts(total, start, wcnt, nk);
      // 3. each warp places its entries' pass rows, in batch order; its
      // places then end where its stage's part of each run ends
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int e = i0 + lane;
        const int key = e < n ? static_cast<int>(place[e0 + e]) - 1 : -1;
        const int at = runs::place_of(mine, key, lane);
        if (at >= 0) {
          list[at] = static_cast<uint16_t>(
              warp * G.seg + e - runs::quot(key, inv_nv) * rows);
        }
      }
      __syncthreads();
      // 4. stage after stage, each unit's terms in the stage, in order
      for (int s = 0; s < nst; ++s, ++q) {
        __pipeline_wait_prior(kStages - 1);
        __syncthreads();
        const T* st =
            reinterpret_cast<const T*>(stage + (q % kStages) * kStageFloats);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int key = key_of[k];
          if (key < 0) continue;
          const int js = s == 0 ? start[key] : wcnt[(s - 1) * nk + key];
          const int je = wcnt[s * nk + key];
          if (js < je) {
            a[k] = add_run(list, st, js, je, s * G.seg, ws, off_of[k], a[k]);
          }
        }
        __syncthreads();
        issue(g, G, stage, q + kStages);
      }
    }
    // the item's sums, each element once (planes >= C and untouched rows
    // as +0.0)
    const int nout = m.nc_out * m.nvv * dq;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = k * kThreads + (tid + k * kRotate) % kThreads;
      if (p < nout) {
        const int cl = runs::quot(p, runs::recip(m.nvv * dq));
        reinterpret_cast<T*>(dtable)[(static_cast<int64_t>(m.c0 + cl) * G.V +
                                      m.v0) * dq + (p - cl * m.nvv * dq)] =
            a[k];
      }
    }
  }
}

template <bool kBucketize>
int launch(const void* g, const IdSource& src, void* dtable, int64_t C,
           int64_t C_pad, int64_t Bp, int64_t V, int64_t d, int64_t gs,
           void* stream) {
  if (C_pad == 0 || V == 0 || d == 0) return 0;
  if (C < 0 || C > C_pad || C_pad > (1 << 30) || Bp < 0 ||
      Bp > 2147483647 || V > (1 << 30) || d > kAccFloats || gs < 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  Geometry G{};
  G.C = static_cast<int>(C);
  G.C_pad = static_cast<int>(C_pad);
  G.Bp = static_cast<int>(Bp);
  G.V = static_cast<int>(V);
  G.d = static_cast<int>(d);
  G.gs = gs;
  // an item's keys: at most kMaxKeys, their sums at most kAccFloats
  const int64_t keys = kMaxKeys < kAccFloats / d ? kMaxKeys : kAccFloats / d;
  int64_t cb = kRowFloats / d;
  cb = cb < keys / V ? cb : keys / V;
  G.cb = static_cast<int>(cb > 1 ? cb : 1);
  const int64_t nv = V < keys / G.cb ? V : keys / G.cb;
  G.nv = static_cast<int>(nv);
  G.v_tiles = static_cast<int>((V + nv - 1) / nv);
  const int64_t items =
      (C_pad + G.cb - 1) / G.cb * static_cast<int64_t>(G.v_tiles);
  if (items > 2147483647) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  G.items = static_cast<int>(items);
  int64_t seg = kStageFloats / stage_stride(static_cast<int>(G.cb * d));
  seg = seg < kStageEntries / G.cb ? seg : kStageEntries / G.cb;
  seg = seg < Bp ? seg : Bp;
  G.seg = static_cast<int>(seg > 1 ? seg : 1);
  const int64_t spi = (Bp + G.seg - 1) / G.seg;
  if (spi * (items + 1) > 2147483647) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  G.seg_per_item = static_cast<int>(spi);
  G.vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 && gs % 4 == 0;

  // float4 units where rows and the output allow, else floats
  const bool unit4 =
      d % 4 == 0 && reinterpret_cast<uintptr_t>(dtable) % 16 == 0;
  auto kernel = unit4 ? onehot_grad_kernel<kBucketize, float4>
                      : onehot_grad_kernel<kBucketize, float>;
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
      static_cast<const float*>(g), src, static_cast<float*>(dtable), G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3a.  g: [Bp, C, d] f32 (batch stride gs, inner dims contiguous); ids:
// [C, Bp] int32; caps: [C] int32; dtable3: [C_pad, V, d] f32, written whole.
extern "C" int rt_onehot_lookup_grad_f32(
    const void* g, const void* ids, const void* caps, void* dtable3,
    int64_t C, int64_t C_pad, int64_t Bp, int64_t V, int64_t d, int64_t gs,
    void* stream) {
  IdSource src{static_cast<const int32_t*>(ids),
               static_cast<const int32_t*>(caps), nullptr, nullptr, nullptr,
               0};
  return launch<false>(g, src, dtable3, C, C_pad, Bp, V, d, gs, stream);
}

// K3b.  raw: [C, Bp] f32; hi: [C_pad, V] f32; counts: [C_pad] int32 (the
// arrays K2 takes); the rest as K3a.
extern "C" int rt_onehot_bucketize_grad_f32(
    const void* g, const void* raw, const void* hi, const void* counts,
    void* dtable3, int64_t C, int64_t C_pad, int64_t Bp, int64_t V, int64_t d,
    int64_t gs, void* stream) {
  IdSource src{nullptr, nullptr, static_cast<const float*>(raw),
               static_cast<const float*>(hi),
               static_cast<const int32_t*>(counts), bucket::first_step(V)};
  return launch<true>(g, src, dtable3, C, C_pad, Bp, V, d, gs, stream);
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
