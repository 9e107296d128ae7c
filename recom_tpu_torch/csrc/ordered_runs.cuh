// The stable counting sort that the backward kernels K3a/K3b
// (onehot_grad.cu) and X1b (pooled_gather_grad.cu) share: it orders a
// block's entries by key, each key's run keeping the entries' order, so a
// thread can then add a run's terms strictly in that order.
//
// A block of kWarps warps splits its n entries into kWarps contiguous
// ranges, one a warp, each a whole number of 32-entry chunks:
//   1. each warp counts its entries per key in its own row of wcnt
//      (count_key, an atomic add);
//   2. starts(): the keys' totals, their starts (a scan by warp 0) and, in
//      wcnt, each warp's first place in each key's run;
//   3. each warp places its entries 32 at a time, in order (place_of: an
//      entry's rank among the chunk's lanes with its key comes from the
//      lanes that __match_any_sync finds holding the same key).
// Keys are in [0, nk); -1 is no key.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace runs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The lanes of the (converged) warp whose key equals this lane's.
__device__ __forceinline__ unsigned peers_of(int key) {
  return __match_any_sync(0xffffffffu, key);
}

// n / m for 0 <= n, m < 2^20, given inv = 1 / m rounded: (n + 1/2) / m
// lies at least 1/(2m) from an integer, and the float product errs by
// less than 2^-23 of it (< 1/(8m)), so truncating it is exact.  A runtime
// integer division takes some 25 instructions; this takes 3.
__device__ __forceinline__ float recip(int m) {
  return __frcp_rn(static_cast<float>(m));
}
__device__ __forceinline__ int quot(int n, float inv) {
  return __float2int_rz(__fmul_rn(static_cast<float>(n) + 0.5f, inv));
}

// The span of each warp's range of n entries: whole chunks of 32.
__device__ __forceinline__ int warp_span(int n) {
  return (n + kWarps * 32 - 1) / (kWarps * 32) * 32;
}

// Count an entry in its warp's key counts (key = -1 counts nowhere): a
// shared-memory atomic add, so the entries of a warp count in any order
// and at once.  A 16-bit count is added in its 32-bit word (counts stay
// below 2^16).
template <typename C>
__device__ __forceinline__ void count_key(C* mine, int key) {
  if (key < 0) return;
  if constexpr (sizeof(C) == 4) {
    atomicAdd(reinterpret_cast<unsigned*>(mine + key), 1u);
  } else {
    const uintptr_t at = reinterpret_cast<uintptr_t>(mine + key);
    atomicAdd(reinterpret_cast<unsigned*>(at & ~uintptr_t(3)),
              1u << ((at & 2u) * 8));
  }
}

// total[k]: entries with key k; start[k]: the first place of k's run; and
// wcnt[w * nk + k] turned from warp w's count into warp w's first place.
// All threads call it, after the counts; it ends with a barrier.  C: the
// counts' type (a place must fit it).
template <typename C>
__device__ __forceinline__ void starts(int* total, int* start, C* wcnt,
                                       int nk) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int v = tid; v < nk; v += kThreads) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += wcnt[w * nk + v];
    total[v] = t;
  }
  __syncthreads();
  if (tid < 32) {
    const int per = (nk + 31) / 32;
    const int jlo = min(lane * per, nk);
    const int jhi = min(jlo + per, nk);
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
  for (int v = tid; v < nk; v += kThreads) {
    int r = start[v];
    for (int w = 0; w < kWarps; ++w) {
      const int t = wcnt[w * nk + v];
      wcnt[w * nk + v] = static_cast<C>(r);
      r += t;
    }
  }
  __syncthreads();
}

// The place of this lane's entry in its key's run (-1 for no key), and the
// warp's places moved on past the chunk.  All 32 lanes call it, chunk after
// chunk in order.
template <typename C>
__device__ __forceinline__ int place_of(C* mine, int key, int lane) {
  if (__ballot_sync(0xffffffffu, key >= 0) == 0u) return -1;
  const unsigned peers = peers_of(key);
  const int at =
      key >= 0 ? mine[key] + __popc(peers & ((1u << lane) - 1u)) : -1;
  __syncwarp();
  // the highest lane of each group on one key moves the key on
  if (key >= 0 && (peers >> lane) == 1u) mine[key] += __popc(peers);
  __syncwarp();
  return at;
}

}  // namespace runs
