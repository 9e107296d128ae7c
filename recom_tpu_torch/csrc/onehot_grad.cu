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
// Design: a block per column c (and per tile of vt vocab rows, where V x d
// would not fit in shared memory), accumulators for the tile's rows in
// shared memory.  The batch is taken a segment at a time (up to kSegment
// entries, and kStageFloats of cotangent), its entries split into kWarps
// contiguous ranges, one a warp:
//   0. the block starts asynchronous copies (cp.async) of the segment's
//      cotangent rows g[b, c, :] into shared memory, in batch order; they
//      land while the next three steps run;
//   1. each warp finds its entries' ids (K3a: read and clamped; K3b:
//      kSearches interleaved searches a lane), their rows in the tile (or
//      -1), and its own count per row;
//   2. the rows' totals, their starts (a scan by warp 0), and each warp's
//      first place in each row's run (the earlier warps' counts added);
//   3. each warp places its entries, 32 at a time in batch order, into the
//      rows' runs (a stable counting sort: an entry's rank among the
//      chunk's lanes on its row comes from one ballot per bit of the row
//      index);
//   4. a thread per (row, element) adds its run's staged floats in order,
//      kUnroll of them read ahead of the adds.
// The tile is written once at the end, coalesced.  A row selected by many
// entries is one long chain of dependent adds, the price of a sum in batch
// order: model E's random batches put about 1950 of a bucketize column's
// 2048 entries in one bucket.  Earlier versions on an H100 (model E's
// group, batch 2048): each chain reading the cotangent from device memory
// four floats at a time, 0.19 ms; the cotangent staged with plain loads and
// the entries placed by warp 0 alone, 0.08-0.11 ms, of which the placement
// and the staging's load latency took most (per-phase clock64 counts).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bucket_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;      // blocks an SM holds: <= 64 registers
constexpr int kSearches = 4;       // K3b: searches a thread interleaves
constexpr int kSegment = 4096;     // batch entries a block sorts at a time
constexpr int kStageFloats = 8192; // a segment's staged cotangent (32 KB)
constexpr int kUnroll = 8;         // staged loads ahead of the ordered adds
constexpr int kLoads = 8;          // device loads a thread keeps in flight
constexpr int kAccFloats = 8192;   // accumulators of a block (32 KB)
constexpr int kMaxTile = 512;      // vocab rows of a block

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

// The entry's row in the tile [v0, v0 + nv), or -1.
__device__ __forceinline__ int tile_row(int32_t id, int v0, int nv) {
  const int lv = id - v0;
  return id >= 0 && lv >= 0 && lv < nv ? lv : -1;
}

// The lanes of the (converged) warp whose key equals this lane's: one
// ballot per bit of keys in [0, 2^bits).
__device__ __forceinline__ unsigned peers_of(int key, int bits) {
  unsigned m = 0xffffffffu;
  for (int bit = 0; bit < bits; ++bit) {
    const bool on = (key >> bit) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, on);
    m &= on ? set : ~set;
  }
  return m;
}

// Count the chunk's entries in the warp's row counts: the lowest lane of
// each group on one row adds the group's size.  All 32 lanes call it;
// lv = -1 counts nowhere.
__device__ __forceinline__ void count_rows(int* wcnt, int lv, int lane,
                                           int bits) {
  const unsigned peers = peers_of(lv + 1, bits);
  if (lv >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {
    wcnt[lv] += __popc(peers);
  }
}

template <bool kBucketize>
__global__ void __launch_bounds__(kThreads, kMinBlocks) onehot_grad_kernel(
    const float* __restrict__ g,        // [Bp, C, d], batch stride gs
    IdSource src,
    float* __restrict__ dtable,         // [C_pad, V, d]
    int C, int Bp, int V, int d, int64_t gs, int vt, int seg) {
  extern __shared__ int smem[];
  const int c = blockIdx.x;
  const int v0 = blockIdx.y * vt;
  const int nv = min(vt, V - v0);
  const int np = nv * d;
  const int bits = 32 - __clz(nv);               // keys lv + 1 in [0, nv]
  float* acc = reinterpret_cast<float*>(smem);   // [nv * d]
  int* total = smem + np;                         // [nv] entries per row
  int* start = total + nv;                        // [nv] row's first place
  int* wcnt = start + nv;                         // [kWarps][nv] counts,
                                                  // then places
  int* place = wcnt + kWarps * nv;                // [seg] entry's row
  int* list = place + seg;                        // [seg] entries by row
  float* stage = reinterpret_cast<float*>(list + seg);  // [seg * d]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* mine = wcnt + warp * nv;
  for (int p = tid; p < np; p += kThreads) acc[p] = 0.0f;

  if (c < C) {
    const int64_t col = static_cast<int64_t>(c) * Bp;
    const float* gc = g + static_cast<int64_t>(c) * d;
    for (int base = 0; base < Bp; base += seg) {
      const int n = min(seg, Bp - base);
      // 0. the segment's cotangent rows, copied asynchronously
      for (int t = tid; t < n * d; t += kThreads) {
        const int i = t / d;
        __pipeline_memcpy_async(stage + t, gc + (base + i) * gs + (t - i * d),
                                sizeof(float));
      }
      __pipeline_commit();
      for (int j = tid; j < kWarps * nv; j += kThreads) wcnt[j] = 0;
      // the warp's entries [lo, hi), whole chunks of 32
      const int span = (n + kWarps * 32 - 1) / (kWarps * 32) * 32;
      const int lo = min(warp * span, n);
      const int hi = min(lo + span, n);
      __syncthreads();
      // 1. each entry's row in the tile (or -1), and the warp's row counts
      if constexpr (kBucketize) {
        for (int i0 = lo; i0 < hi; i0 += 32 * kSearches) {
          float x[kSearches];
          int64_t hrow[kSearches];
          int pos[kSearches];
#pragma unroll
          for (int k = 0; k < kSearches; ++k) {
            const int i = i0 + k * 32 + lane;
            x[k] = i < hi ? __ldg(src.raw + col + base + i) : 0.0f;
            hrow[k] = static_cast<int64_t>(c) * V;
          }
          bucket::upper_bounds<kSearches, int64_t>(src.hi, hrow, x, pos, V,
                                                   src.half);
#pragma unroll
          for (int k = 0; k < kSearches; ++k) {
            const int i = i0 + k * 32 + lane;
            const int lv = i < hi ? tile_row(bucket::bucket_of(
                                        x[k], pos[k], src.counts, c), v0, nv)
                                  : -1;
            if (i < hi) place[i] = lv;
            count_rows(mine, lv, lane, bits);
            __syncwarp();
          }
        }
      } else {
        const int32_t cap = __ldg(src.caps + c);
        for (int i0 = lo; i0 < hi; i0 += 32 * kLoads) {
          int32_t id[kLoads];
#pragma unroll
          for (int k = 0; k < kLoads; ++k) {
            const int i = i0 + k * 32 + lane;
            id[k] = i < hi ? __ldg(src.ids + col + base + i) : -1;
          }
#pragma unroll
          for (int k = 0; k < kLoads; ++k) {
            const int i = i0 + k * 32 + lane;
            const int lv = tile_row(id[k] < cap ? id[k] : cap, v0, nv);
            if (i < hi) place[i] = lv;
            count_rows(mine, lv, lane, bits);
            __syncwarp();
          }
        }
      }
      __syncthreads();
      // 2. totals; starts (warp 0); each warp's first place in each row
      for (int v = tid; v < nv; v += kThreads) {
        int t = 0;
        for (int w = 0; w < kWarps; ++w) t += wcnt[w * nv + v];
        total[v] = t;
      }
      __syncthreads();
      if (warp == 0) {
        const int per = (nv + 31) / 32;
        const int jlo = min(lane * per, nv);
        const int jhi = min(jlo + per, nv);
        int s = 0;
        for (int j = jlo; j < jhi; ++j) s += total[j];
        int incl = s;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += t;
        }
        int r = incl - s;
        for (int j = jlo; j < jhi; ++j) {
          start[j] = r;
          r += total[j];
        }
      }
      __syncthreads();
      for (int v = tid; v < nv; v += kThreads) {
        int r = start[v];
        for (int w = 0; w < kWarps; ++w) {
          const int t = wcnt[w * nv + v];
          wcnt[w * nv + v] = r;
          r += t;
        }
      }
      __syncthreads();
      // 3. each warp places its entries, in batch order
      for (int i0 = lo; i0 < hi; i0 += 32) {
        const int i = i0 + lane;
        const int lv = i < hi ? place[i] : -1;
        const unsigned peers = peers_of(lv + 1, bits);
        if (lv >= 0) list[mine[lv] + __popc(peers & ((1u << lane) - 1u))] = i;
        __syncwarp();
        // the highest lane of each group on one row moves the row on
        if (lv >= 0 && (peers >> lane) == 1u) mine[lv] += __popc(peers);
        __syncwarp();
      }
      __pipeline_wait_prior(0);
      __syncthreads();
      // 4. each (row, element) sum over its run, in batch order
      for (int p = tid; p < np; p += kThreads) {
        const int v = p / d;
        const int e = p - v * d;
        const int* run = list + start[v];
        const int m = total[v];
        float a = acc[p];
        int j = 0;
        for (; j + kUnroll <= m; j += kUnroll) {
          float x[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) x[k] = stage[run[j + k] * d + e];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) a = __fadd_rn(a, x[k]);
        }
        for (; j < m; ++j) a = __fadd_rn(a, stage[run[j] * d + e]);
        acc[p] = a;
      }
      __syncthreads();
    }
  }
  // each thread writes the accumulators it zeroed and summed
  float* o = dtable + (static_cast<int64_t>(c) * V + v0) * d;
  for (int p = tid; p < np; p += kThreads) o[p] = acc[p];
}

template <bool kBucketize>
int launch(const void* g, const IdSource& src, void* dtable, int64_t C,
           int64_t C_pad, int64_t Bp, int64_t V, int64_t d, int64_t gs,
           void* stream) {
  if (C_pad == 0 || V == 0 || d == 0) return 0;
  if (C > C_pad || C_pad > 2147483647 || Bp > 2147483647 || V > (1 << 30) ||
      d > kAccFloats || gs < 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  int64_t vt = kAccFloats / d;
  vt = vt < kMaxTile ? vt : kMaxTile;
  vt = vt < V ? vt : V;
  const int64_t v_tiles = (V + vt - 1) / vt;
  if (v_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t seg = kStageFloats / d;
  seg = seg < kSegment ? seg : kSegment;
  seg = seg < Bp ? seg : Bp;
  seg = seg > 1 ? seg : 1;
  const size_t smem =
      sizeof(int) * static_cast<size_t>(vt * d + (2 + kWarps) * vt +
                                        2 * seg + seg * d);
  auto kernel = onehot_grad_kernel<kBucketize>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(C_pad), static_cast<unsigned>(v_tiles));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), src, static_cast<float*>(dtable),
      static_cast<int>(C), static_cast<int>(Bp), static_cast<int>(V),
      static_cast<int>(d), gs, static_cast<int>(vt), static_cast<int>(seg));
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
