// O1: row-wise AdaGrad on every leaf of a param group, by hand for Hopper,
// writing only the rows a step touched.
//
// Replaces: XLA's fusion of optax's update and apply_updates for
// recom_tpu/train.py::rowwise_adagrad (:28-57, new_acc and upd), which the
// JAX Trainer's jitted train_step runs over every row of every table.  Its
// plain version is the dense torch formula
// (ops/rowwise_adagrad.py::rowwise_adagrad_plain), which the CPU runs.
//
// For a 2-D leaf p [R, d] with its accumulator acc [R], each row:
//   sq_e = g_e * g_e
//   mean = (the sum of the row's sq_e, in ATen's order) * factor
//   acc' = acc + mean
//   s    = rsqrtf(acc' + eps)
//   p_e' = p_e + ((-lr) * g_e) * s
// (factor as ATen's mean takes it: float(R) / float(R d), 1/d for d a power
// of two).  Any other rank is elementwise, acc_e' = acc_e + sq_e and s_e =
// rsqrtf(acc_e' + eps), the leaf viewed as rows of its last dimension.
// Each operation is rounded on its own, in the dense step's order
// (__fmul_rn/__fadd_rn, -fmad=false); rsqrtf is what torch.rsqrt calls on
// CUDA.
//
// Which rows it writes.  A row whose gradient is +0.0 in every element
// keeps its bits under the dense formula: acc + (+0.0) = acc, and p +
// ((-lr) * +0.0) * s = p + -0.0 = p.  X1b, K3a and K3b write +0.0 in every
// row no slot touches, and a leaf with no gradient steps with zeros, so on
// the training paths most rows are such rows: the kernel neither reads nor
// writes their p and acc.  A row holding -0.0 or NaN goes through the
// formula: with p = -0.0 and g = -0.0, -0.0 + +0.0 = +0.0, the dense
// step's bits.  (An accumulator of -0.0, which no step writes and only a
// loaded state can hold, stays -0.0 in a skipped row where the dense step
// would make it +0.0.)
//
// The row sum's order is ATen's reduce_kernel for (g * g).mean(dim=1), as
// torch 2.11's reduction takes it on an H100 (probed on the card): below
// d = 128 a row of W = min(2^floor(log2 d), 32) lanes, lane t summing the
// elements t, t + W, ... into four accumulators in turn from 0 and
// combining them in order; from d = 128 32 lanes, each summing its
// vectors of four elements componentwise, then the four in order; the
// lanes then meet in halving steps, lane t + W/2 into lane t, then W/4,
// ... 1.  O1 takes that order for every d <= 128 (d = 128 16-byte
// aligned), where R >= 16 for d > 32; wider rows take the order below
// 128, so their means may differ from the dense step's in the last bit.
// Float sums commute, so a butterfly over the lanes gives every lane the
// tree's bits.
//
// What bounds it on the H100: bytes.  It reads the whole dense gradient
// once (model E's tables: 5.37 GB, 1.60 ms at 3.35 TB/s) and reads and
// writes p and acc in the touched rows alone (under 0.3% of the large
// tables' rows a step); the dense formula's passes read and write each
// table about ten times.  Design: persistent blocks, kMinBlocks an SM; each
// warp walks chunks of rows of one leaf, the chunks of all leaves in one
// index space (each leaf's first chunk in its descriptor).  A row of d = 4
// G floats (d = 4 ... 128, 16-byte aligned) is G lanes of 16-byte
// streaming loads (evict-first), kUnroll rows a lane group in flight; a
// row pass whose rows are all +0.0 (one ballot) costs the warp nothing
// more.  Other widths take W lanes a row, a lane per element.  Every leaf
// of a launch is a descriptor, up to kMaxLeaves, passed by value.  Each
// block adds its rows updated and rows seen to the optimizer's int64 [2]
// counter, one atomic each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 32;     // leaves a launch
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;      // blocks an SM: 64 registers a lane
constexpr int kUnroll = 4;         // rows a lane group keeps in flight
constexpr unsigned kFull = 0xffffffffu;

enum : int32_t { kElementwise = 1, kVector = 2 };

// One leaf of a launch; the layout of ops/rowwise_adagrad.py::O1_DESC.
struct O1Leaf {
  float* p;              // [R, d], contiguous
  const float* g;        // [R, d], contiguous
  float* acc;            // [R] (row-wise) or [R, d] (elementwise)
  int64_t rows;          // R
  int64_t d;
  int64_t chunk0;        // the leaf's first chunk of the launch
  int64_t chunk_rows;    // rows a chunk
  float factor;          // the mean's factor, as ATen's mean takes it
  int32_t kind;          // kElementwise | kVector
  int32_t lanes;         // lanes a row: d / 4 (kVector), else ATen's W
  int32_t pad;
};

struct O1Launch {
  O1Leaf leaf[kMaxLeaves];
  int64_t chunks;                 // the leaves' chunks
  unsigned long long* counts;     // [2] rows updated, rows seen; or null
  int32_t n;
  float neg_lr;                   // -lr, rounded to f32
  float eps;
};

__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

__device__ __forceinline__ bool nonzero(float4 x) {
  return (__float_as_uint(x.x) | __float_as_uint(x.y) |
          __float_as_uint(x.z) | __float_as_uint(x.w)) != 0u;
}

// p + ((-lr) * g) * s
__device__ __forceinline__ float stepped(float p, float g, float s,
                                         float neg_lr) {
  return __fadd_rn(p, __fmul_rn(__fmul_rn(neg_lr, g), s));
}

// The sum of a row's squares in ATen's order, for a row of G = d / 4 lanes,
// each holding four consecutive squares q.  Below d = 128 ATen gives the
// row W = min(d, 32) lanes of one element each (at d = 64 lane t adds
// element t + 32 first), which meet in halving steps, lane t + W/2 into
// lane t, then W/4, ... 1: here the same pairs meet across lanes xor G/2
// ... 1 (elements d/2 ... 4 apart, the first of them the +32 at d = 64),
// then within the lane (2 and 1 apart).  At d = 128 ATen reads a lane's
// four elements as one vector and sums them in order, then the halving
// steps over the 32 lanes.  Every lane of the warp takes part.
__device__ __forceinline__ float row_sum(float4 q, int G) {
  if (G == 32) {
    float s = __fadd_rn(__fadd_rn(__fadd_rn(q.x, q.y), q.z), q.w);
    for (int off = 16; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    }
    return s;
  }
  for (int off = G >> 1; off > 0; off >>= 1) {
    q.x = __fadd_rn(q.x, __shfl_xor_sync(kFull, q.x, off));
    q.y = __fadd_rn(q.y, __shfl_xor_sync(kFull, q.y, off));
    q.z = __fadd_rn(q.z, __shfl_xor_sync(kFull, q.z, off));
    q.w = __fadd_rn(q.w, __shfl_xor_sync(kFull, q.w, off));
  }
  return __fadd_rn(__fadd_rn(q.x, q.z), __fadd_rn(q.y, q.w));
}

// A chunk of kUnroll passes of a leaf of 16-byte lanes, from row0; adds
// the rows it updates to ``updated`` in each row's first lane.
__device__ void vector_chunk(const O1Leaf& a, int64_t row0, float neg_lr,
                             float eps, int lane, unsigned& updated) {
  const int G = a.lanes;
  const int per = 32 / G;
  const int sub = lane / G;
  const int t = lane - sub * G;
  const unsigned gmask = (G == 32 ? kFull : ((1u << G) - 1u)) << (sub * G);
  const float4* g4 = reinterpret_cast<const float4*>(a.g);
  float4 gv[kUnroll];
  int64_t r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    r[u] = row0 + u * per + sub;
    gv[u] = r[u] < a.rows ? __ldcs(g4 + r[u] * G + t)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float4 x = gv[u];
    const unsigned any = __ballot_sync(kFull, nonzero(x));
    if (any == 0u) continue;            // no row of the pass was touched
    const bool touched = (any & gmask) != 0u;
    updated += touched && t == 0;
    if (a.kind & kElementwise) {
      if (!touched) continue;
      float4* acc4 = reinterpret_cast<float4*>(a.acc) + r[u] * G + t;
      float4* p4 = reinterpret_cast<float4*>(a.p) + r[u] * G + t;
      float4 ac = *acc4;
      float4 pv = *p4;
      ac.x = __fadd_rn(ac.x, sq(x.x));
      ac.y = __fadd_rn(ac.y, sq(x.y));
      ac.z = __fadd_rn(ac.z, sq(x.z));
      ac.w = __fadd_rn(ac.w, sq(x.w));
      pv.x = stepped(pv.x, x.x, rsqrtf(__fadd_rn(ac.x, eps)), neg_lr);
      pv.y = stepped(pv.y, x.y, rsqrtf(__fadd_rn(ac.y, eps)), neg_lr);
      pv.z = stepped(pv.z, x.z, rsqrtf(__fadd_rn(ac.z, eps)), neg_lr);
      pv.w = stepped(pv.w, x.w, rsqrtf(__fadd_rn(ac.w, eps)), neg_lr);
      *acc4 = ac;
      *p4 = pv;
      continue;
    }
    const float sum = row_sum(
        make_float4(sq(x.x), sq(x.y), sq(x.z), sq(x.w)), G);
    if (!touched) continue;
    float s = 0.f;
    if (t == 0) {
      const float acc = __fadd_rn(a.acc[r[u]], __fmul_rn(sum, a.factor));
      a.acc[r[u]] = acc;
      s = rsqrtf(__fadd_rn(acc, eps));
    }
    s = __shfl_sync(gmask, s, sub * G);
    float4* p4 = reinterpret_cast<float4*>(a.p) + r[u] * G + t;
    float4 pv = *p4;
    pv.x = stepped(pv.x, x.x, s, neg_lr);
    pv.y = stepped(pv.y, x.y, s, neg_lr);
    pv.z = stepped(pv.z, x.z, s, neg_lr);
    pv.w = stepped(pv.w, x.w, s, neg_lr);
    *p4 = pv;
  }
}

// A chunk of one pass of a leaf of W lanes a row (any width), from row0:
// lane t holds the elements t, t + W, ..., summed as ATen's thread_reduce
// sums them (four accumulators in turn).
__device__ void scalar_chunk(const O1Leaf& a, int64_t row0, float neg_lr,
                             float eps, int lane, unsigned& updated) {
  const int W = a.lanes;
  const int sub = lane / W;
  const int t = lane - sub * W;
  const unsigned gmask = (W == 32 ? kFull : ((1u << W) - 1u)) << (sub * W);
  const int64_t r = row0 + sub;
  const int64_t d = a.d;
  const float* gr = a.g + r * d;
  bool nz = false;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (r < a.rows) {
    int64_t e = t;
    for (; e + 3 * W < d; e += 4 * W) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = gr[e + i * W];
        nz |= __float_as_uint(x) != 0u;
        v[i] = __fadd_rn(v[i], sq(x));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (e >= d) break;
      const float x = gr[e];
      nz |= __float_as_uint(x) != 0u;
      v[i] = __fadd_rn(v[i], sq(x));
      e += W;
    }
  }
  const unsigned any = __ballot_sync(kFull, nz);
  if (any == 0u) return;
  const bool touched = (any & gmask) != 0u;
  updated += touched && t == 0;
  if (a.kind & kElementwise) {
    if (!touched) return;
    for (int64_t e = t; e < d; e += W) {
      const float x = gr[e];
      const float acc = __fadd_rn(a.acc[r * d + e], sq(x));
      a.acc[r * d + e] = acc;
      a.p[r * d + e] = stepped(a.p[r * d + e], x,
                               rsqrtf(__fadd_rn(acc, eps)), neg_lr);
    }
    return;
  }
  float sum = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), v[2]), v[3]);
  for (int off = W >> 1; off > 0; off >>= 1) {
    sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
  }
  if (!touched) return;
  float s = 0.f;
  if (t == 0) {
    const float acc = __fadd_rn(a.acc[r], __fmul_rn(sum, a.factor));
    a.acc[r] = acc;
    s = rsqrtf(__fadd_rn(acc, eps));
  }
  s = __shfl_sync(gmask, s, sub * W);
  for (int64_t e = t; e < d; e += W) {
    a.p[r * d + e] = stepped(a.p[r * d + e], gr[e], s, neg_lr);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rowwise_adagrad_kernel(const __grid_constant__ O1Launch P) {
  __shared__ unsigned long long s_updated, s_seen;
  if (threadIdx.x == 0) {
    s_updated = 0;
    s_seen = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kWarps;
  unsigned updated = 0;
  unsigned long long seen = 0;
  int li = 0;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       c < P.chunks; c += nwarps) {
    while (li + 1 < P.n && c >= P.leaf[li + 1].chunk0) ++li;
    const O1Leaf& a = P.leaf[li];
    const int64_t row0 = (c - a.chunk0) * a.chunk_rows;
    if (lane == 0) {
      const int64_t left = a.rows - row0;
      seen += left < a.chunk_rows ? left : a.chunk_rows;
    }
    if (a.kind & kVector) {
      vector_chunk(a, row0, P.neg_lr, P.eps, lane, updated);
    } else {
      scalar_chunk(a, row0, P.neg_lr, P.eps, lane, updated);
    }
  }
  const unsigned warp_updated = __reduce_add_sync(kFull, updated);
  if (lane == 0) {
    atomicAdd(&s_updated, static_cast<unsigned long long>(warp_updated));
    atomicAdd(&s_seen, seen);
  }
  __syncthreads();
  if (threadIdx.x == 0 && P.counts != nullptr) {
    atomicAdd(P.counts, s_updated);
    atomicAdd(P.counts + 1, s_seen);
  }
}

}  // namespace

// Row-wise AdaGrad on the n leaves described at ``leaves`` (O1Leaf
// records, their chunks numbered from 0 in order, ``chunks`` in all), with
// -lr and eps as f32; ``counts``: the int64 [2] the blocks add their rows
// updated and seen to, or null.
extern "C" int rt_rowwise_adagrad_f32(const void* leaves, int64_t n,
                                      int64_t chunks, float neg_lr, float eps,
                                      void* counts, void* stream) {
  if (n < 1 || n > kMaxLeaves || chunks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  O1Launch P = {};
  const O1Leaf* src = static_cast<const O1Leaf*>(leaves);
  int64_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    const O1Leaf& a = src[i];
    const int G = a.lanes;
    const bool vec = (a.kind & kVector) != 0;
    const uintptr_t aligned =
        reinterpret_cast<uintptr_t>(a.p) | reinterpret_cast<uintptr_t>(a.g) |
        ((a.kind & kElementwise) ? reinterpret_cast<uintptr_t>(a.acc) : 0);
    if (a.p == nullptr || a.g == nullptr || a.acc == nullptr ||
        a.rows < 1 || a.d < 1 || G < 1 || G > 32 || (G & (G - 1)) != 0 ||
        a.chunk0 != next ||
        a.chunk_rows != (vec ? kUnroll : 1) * (32 / G) ||
        (vec && (a.d != 4 * G || aligned % 16 != 0)) ||
        (!vec && G > a.d)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    next += (a.rows + a.chunk_rows - 1) / a.chunk_rows;
    P.leaf[i] = a;
  }
  if (next != chunks) return static_cast<int>(cudaErrorInvalidValue);
  P.chunks = chunks;
  P.counts = static_cast<unsigned long long*>(counts);
  P.n = static_cast<int32_t>(n);
  P.neg_lr = neg_lr;
  P.eps = eps;
  if (chunks == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (chunks + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sms) * kMinBlocks;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  rowwise_adagrad_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// What ops/rowwise_adagrad.py plans with: leaves a launch, the descriptor's
// bytes, rows a lane group keeps in flight.
extern "C" void rt_rowwise_adagrad_limits(int64_t* out) {
  out[0] = kMaxLeaves;
  out[1] = sizeof(O1Leaf);
  out[2] = kUnroll;
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
