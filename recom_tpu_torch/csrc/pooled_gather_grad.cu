// X1b: the backward pass of the gather + pooling X1 (pooled_gather.cu), by
// hand for Hopper: the dense gradient of a stacked column group's table.
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
// nothing (the masked-slot convention of X1); rows no slot touches stay
// +0.0.
//
// Deterministic, with no float atomics.  The wrapper
// (ops/lookup_gather.py) sorts the slots' destination rows with a stable
// sort in [C, Bp, L] slot order, missing slots keyed past the table; here a
// group of G lanes takes each run of equal rows, sums its slots' products
// in slot order from +0.0 (__fmul_rn/__fadd_rn, -fmad=false) and writes the
// row once.  So two runs give the same bits, equal to the plain version's
// index_add_ in slot order.
//
// What bounds it on the H100: bytes, and of those the dense fill.  JAX's
// cotangent of a table is dense [R, d], and so is this one: model E's
// large group (41.9 M rows x 32) is 5.37 GB to zero and write, 1.6 ms at
// 3.35 TB/s, against under 10 MB of cotangent, ids and weights.  The fill
// is the wrapper's torch.zeros; this kernel writes only the touched rows.
// A row-sparse gradient would drop the fill (a later change: Adam's state
// is dense).
//
// Design: a thread group of G lanes (the smallest power of two >= d, at
// most 32) per sorted slot position; a group whose key continues the run
// before it returns at once, so one group walks each run.  Lane q moves
// elements q, q + G, ... of the row, so a group's cotangent reads and its
// row store are contiguous.  A MEAN or SQRTN slot re-sums its bag's L
// weights (or masks) for the denominator, as the forward did; SUM slots
// skip that.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Group {
  const float* g;          // [Bp, C, d], batch stride gs, inner contiguous
  const int32_t* ids;      // [C, Bp, L] member-local ids, < 0 = missing
  const float* weights;    // [C, Bp, L] or null (unweighted: w = 1)
  const int32_t* caps;     // [C] last valid row per member
  const int32_t* codes;    // [C] 0 sum / 1 mean / 2 sqrtn
  const uint8_t* weighted; // [C] 1: divide, 0: multiply by the reciprocal
  const void* keys;        // [N] destination rows, sorted; R = none
  const int64_t* order;    // [N] slot (c * Bp + b) * L + l of each key
  float* out;              // [R, d], zero-filled
  int64_t N, R, gs;
  int C, Bp, L, d;
};

// The cotangent of the bag's pooled sum, scaled as its combiner divides.
__device__ __forceinline__ float bag_cotangent(const Group& a, float gv,
                                               int64_t bag, int c) {
  const int code = __ldg(a.codes + c);
  if (code == 0) return gv;
  const int32_t cap = __ldg(a.caps + c);
  float ws = 0.0f, w2 = 0.0f;
  for (int k = 0; k < a.L; ++k) {
    int32_t id = __ldg(a.ids + bag + k);
    id = id < cap ? id : cap;
    const float m = id >= 0 ? 1.0f : 0.0f;
    const float wl = a.weights ? __fmul_rn(__ldg(a.weights + bag + k), m) : m;
    ws = __fadd_rn(ws, wl);
    w2 = __fadd_rn(w2, __fmul_rn(wl, wl));
  }
  const float den = code == 1 ? ws : __fsqrt_rn(w2);
  if (!(den > 0.0f)) return 0.0f;
  return __ldg(a.weighted + c) ? __fdiv_rn(gv, den)
                               : __fmul_rn(gv, __fdiv_rn(1.0f, den));
}

// K: the keys' type, int32 where every row index fits, else int64.
template <int G, typename K>
__global__ void __launch_bounds__(kThreads) pooled_gather_grad_kernel(
    const Group a) {
  const K* keys = static_cast<const K*>(a.keys);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t i = t / G;
  const int q = static_cast<int>(t % G);
  if (i >= a.N) return;
  const int64_t row = __ldg(keys + i);
  if (row >= a.R || (i > 0 && __ldg(keys + i - 1) == row)) return;
  for (int e = q; e < a.d; e += G) {
    float acc = 0.0f;
    for (int64_t j = i; j < a.N && __ldg(keys + j) == row; ++j) {
      const int64_t s = __ldg(a.order + j);
      const int64_t bag = s / a.L;              // c * Bp + b
      const int c = static_cast<int>(bag / a.Bp);
      const int b = static_cast<int>(bag - static_cast<int64_t>(c) * a.Bp);
      const float gv = __ldg(a.g + b * a.gs + static_cast<int64_t>(c) * a.d + e);
      const float dacc = bag_cotangent(a, gv, bag * a.L, c);
      const float w = a.weights ? __ldg(a.weights + s) : 1.0f;
      acc = __fadd_rn(acc, __fmul_rn(dacc, w));
    }
    a.out[row * a.d + e] = acc;
  }
}

template <int G>
void launch(const Group& a, bool wide_keys, int64_t blocks, cudaStream_t s) {
  const unsigned nb = static_cast<unsigned>(blocks);
  if (wide_keys) {
    pooled_gather_grad_kernel<G, int64_t><<<nb, kThreads, 0, s>>>(a);
  } else {
    pooled_gather_grad_kernel<G, int32_t><<<nb, kThreads, 0, s>>>(a);
  }
}

}  // namespace

// One group.  keys/order: the stable sort of the slots' destination rows
// (key_bytes 4: int32, 8: int64; order int64), missing slots keyed R; out:
// [R, d] f32, zero-filled by the caller.  Returns the launch's cudaError_t.
extern "C" int rt_pooled_gather_grad_f32(
    const void* g, const void* ids, const void* weights, const void* caps,
    const void* codes, const void* weighted, const void* keys,
    const void* order, void* out, int64_t N, int64_t R, int64_t C,
    int64_t Bp, int64_t L, int64_t d, int64_t gs, int64_t key_bytes,
    void* stream) {
  if (N == 0 || R == 0 || d == 0) return 0;
  if (C > 2147483647 || Bp > 2147483647 || L > 2147483647 ||
      d > 2147483647 || L < 1 || gs < 0 ||
      (key_bytes != 4 && key_bytes != 8) ||
      (key_bytes == 4 && R > 2147483647)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  Group a{static_cast<const float*>(g), static_cast<const int32_t*>(ids),
          static_cast<const float*>(weights),
          static_cast<const int32_t*>(caps),
          static_cast<const int32_t*>(codes),
          static_cast<const uint8_t*>(weighted),
          keys,
          static_cast<const int64_t*>(order), static_cast<float*>(out), N, R,
          gs, static_cast<int>(C), static_cast<int>(Bp), static_cast<int>(L),
          static_cast<int>(d)};
  int lanes = 1;
  while (lanes < d && lanes < 32) lanes *= 2;
  const int64_t blocks = (N * lanes + kThreads - 1) / kThreads;
  if (blocks > 2147483647) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = key_bytes == 8;
  switch (lanes) {
    case 1: launch<1>(a, wide, blocks, s); break;
    case 2: launch<2>(a, wide, blocks, s); break;
    case 4: launch<4>(a, wide, blocks, s); break;
    case 8: launch<8>(a, wide, blocks, s); break;
    case 16: launch<16>(a, wide, blocks, s); break;
    default: launch<32>(a, wide, blocks, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
