// X2: string split + FarmHash Fingerprint64 + bucket mod on the device.
//
// Replaces: recom_tpu/ops/hash_device.py::fixed_hash_ids and split_hash_ids
// (with row_lengths, split_pieces, farmhash64_pieces and mod_buckets) and
// the re-padding gather recom_tpu/runtime/wire.py::unpack_blob._verbatim_rows
// that feeds them.  No Pallas kernel exists for this in the JAX package: it
// runs there as XLA code over emulated u64.  Torch has no usable uint64, so
// the port needs a kernel; here uint64_t is native.
//
// Input is the wire's verbatim staging: column c's numpy 'S<w_c>' buffer,
// row r at bytes [r * w_c, (r + 1) * w_c) of raw[c, :] (raw is [n, Bp * W],
// W the width bucket >= w_c).  Per (column, row):
//   1. the row length is the last non-NUL byte + 1 (numpy 'S' convention);
//   2. fixed columns (delims == nullptr) hash the whole row as one piece;
//      delimited columns split on the one-byte delimiter: an empty row has
//      0 pieces, empty pieces between delimiters count, pieces past L drop;
//   3. each piece hashes with Fingerprint64 (the straight-line 0..64-byte
//      branches of farmhashna::Hash64, recom_tpu/native/host_ops.cc:53-112;
//      longer pieces are routed to host hashing by the wire plan, and for
//      them this computes the same 33..64 branch the JAX code does);
//   4. out[c, r, k] = hash % buckets[c] as int32, -1 past the last piece.
// Bytes are unsigned; every byte a hash reads lies inside its piece.
//
// What bounds it on the H100: latency.  At batch 2048 model E's three
// launches move 1.2, 4.2 and 1.4 MB (0.4, 1.3 and 0.4 us at 3.35 TB/s) and
// do 6, 12 and 4 M integer operations (0.4, 0.7 and 0.2 us at the INT32
// rate); each launch is one short chain of dependent steps (a load round
// trip, a scan, a hash), so what counts is how few steps each block takes
// and how many blocks hide each other's.  The first port ran a thread per
// (column, row): too few threads (30 720), each scanning its row byte by
// byte from L2, hashing up to L pieces in series and dividing 64 bits by m
// in software.
//
// Design: a block owns a run of R consecutive rows of one column, which in
// the verbatim buffer is one contiguous span of R * w_c bytes.
//   - Stage: the block copies the span into shared memory in one coalesced
//     pass of 16-byte loads (bytes only at the unaligned ends), so no byte
//     is read from device memory twice.  Every later read is an aligned
//     shared word, funnel-shifted into place.
//   - Split (delimited columns): 8 lanes per row, each over a run of 4-byte
//     words.  Byte masks give each lane its last non-NUL byte and its
//     delimiters (a non-NUL delimiter never lies past the row's length, so
//     one pass finds both; a NUL delimiter takes a second pass below the
//     length); shuffles over the 8 lanes give the row length, the count of
//     delimiters before each lane's and the last of them.  Each delimiter
//     then closes its piece (rows of any width, any number of pieces;
//     pieces past L drop).
//   - Hash densely: a warp lists the pieces of its 4 rows in shared memory
//     and hashes that list a lane per piece (a thread per row would hash
//     up to L pieces in series; a lane per delimiter would leave most lanes
//     idle in each hash), writing each id, and -1 after a row's last piece,
//     straight to the output.  Fixed columns hash one piece a row, a
//     thread per row.
//   - Reduce: h % m without a 64-bit division, from a per-column constant
//     M = floor((2^64 - 1) / m) (ops/hash_device.py::bucket_reciprocals):
//     q = umulhi(h, M) is floor(h / m) or one less, so r = h - q * m lies in
//     [0, 2m) and one subtraction finishes it; r < 2^32 for m <= 2^31, so
//     the product and the difference are taken in 32 bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 8;              // lanes per row, delimited columns
constexpr int kRowsPerWarp = 32 / kGroup;
constexpr int kFixedRows = kThreads;   // rows per block at most
constexpr int kSplitRows = kThreads / kGroup;
constexpr int kSmemTarget = 48 * 1024; // shared bytes a block aims to stay in
constexpr unsigned kFull = 0xffffffffu;

constexpr uint64_t k0 = 0xc3a5c85c97cb3127ULL;
constexpr uint64_t k1 = 0xb492b66fbe98f273ULL;
constexpr uint64_t k2 = 0x9ae16a3b2f90404fULL;

// Little-endian reads at byte offset `o` of the staged words `s` (shared
// memory).  They read the aligned words that cover the bytes, up to 3 bytes
// past them; funnel shifts drop the extra bits.
__device__ __forceinline__ uint32_t Byte(const uint32_t* s, uint32_t o) {
  return (s[o >> 2] >> ((o & 3) * 8)) & 0xffu;
}

__device__ __forceinline__ uint32_t Fetch32(const uint32_t* s, uint32_t o) {
  const uint32_t i = o >> 2, sh = (o & 3) * 8;
  return __funnelshift_r(s[i], s[i + 1], sh);
}

__device__ __forceinline__ uint64_t Fetch64(const uint32_t* s, uint32_t o) {
  const uint32_t i = o >> 2, sh = (o & 3) * 8;
  const uint32_t a = s[i], b = s[i + 1], c = s[i + 2];
  return (static_cast<uint64_t>(__funnelshift_r(b, c, sh)) << 32) |
         __funnelshift_r(a, b, sh);
}

// 0xff in each of the first n bytes of a word (n may lie outside 0..4).
__device__ __forceinline__ uint32_t ValidBytes(int n) {
  return n >= 4 ? 0xffffffffu : (n <= 0 ? 0u : (1u << (8 * n)) - 1u);
}

// 0x80 in each byte of x that is zero, 0 elsewhere (exact: no borrows).
__device__ __forceinline__ uint32_t ZeroBytes(uint32_t x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
}

// Index + 1 of the last non-NUL byte of the w bytes at offset o, or 0.
__device__ __forceinline__ int RowLength(const uint32_t* s, uint32_t o,
                                         int w) {
  for (int j = (w - 1) & ~3; j >= 0; j -= 4) {
    const uint32_t x = Fetch32(s, o + j) & ValidBytes(w - j);
    if (x != 0) return j + 4 - __clz(x) / 8;
  }
  return 0;
}

__device__ __forceinline__ uint64_t Rotate(uint64_t v, int n) {
  return (v >> n) | (v << (64 - n));
}

__device__ __forceinline__ uint64_t ShiftMix(uint64_t v) {
  return v ^ (v >> 47);
}

__device__ __forceinline__ uint64_t HashLen16(uint64_t u, uint64_t v,
                                              uint64_t mul) {
  uint64_t a = (u ^ v) * mul;
  a ^= (a >> 47);
  uint64_t b = (v ^ a) * mul;
  b ^= (b >> 47);
  b *= mul;
  return b;
}

__device__ __forceinline__ uint64_t HashLen0to16(const uint32_t* s,
                                                 uint32_t o, uint32_t len) {
  if (len >= 8) {
    const uint64_t mul = k2 + len * 2ULL;
    const uint64_t a = Fetch64(s, o) + k2;
    const uint64_t b = Fetch64(s, o + len - 8);
    const uint64_t c = Rotate(b, 37) * mul + a;
    const uint64_t d = (Rotate(a, 25) + b) * mul;
    return HashLen16(c, d, mul);
  }
  if (len >= 4) {
    const uint64_t mul = k2 + len * 2ULL;
    const uint64_t a = Fetch32(s, o);
    return HashLen16(len + (a << 3), Fetch32(s, o + len - 4), mul);
  }
  if (len > 0) {
    const uint32_t a = Byte(s, o);
    const uint32_t b = Byte(s, o + (len >> 1));
    const uint32_t c = Byte(s, o + len - 1);
    const uint32_t y = a + (b << 8);
    const uint32_t z = len + (c << 2);
    return ShiftMix(y * k2 ^ z * k0) * k2;
  }
  return k2;
}

__device__ __forceinline__ uint64_t HashLen17to32(const uint32_t* s,
                                                  uint32_t o, uint32_t len) {
  const uint64_t mul = k2 + len * 2ULL;
  const uint64_t a = Fetch64(s, o) * k1;
  const uint64_t b = Fetch64(s, o + 8);
  const uint64_t c = Fetch64(s, o + len - 8) * mul;
  const uint64_t d = Fetch64(s, o + len - 16) * k2;
  return HashLen16(Rotate(a + b, 43) + Rotate(c, 30) + d,
                   a + Rotate(b + k2, 18) + c, mul);
}

__device__ __forceinline__ uint64_t HashLen33to64(const uint32_t* s,
                                                  uint32_t o, uint32_t len) {
  const uint64_t mul = k2 + len * 2ULL;
  const uint64_t a = Fetch64(s, o) * k2;
  const uint64_t b = Fetch64(s, o + 8);
  const uint64_t c = Fetch64(s, o + len - 8) * mul;
  const uint64_t d = Fetch64(s, o + len - 16) * k2;
  const uint64_t y = Rotate(a + b, 43) + Rotate(c, 30) + d;
  const uint64_t z = HashLen16(y, a + Rotate(b + k2, 18) + c, mul);
  const uint64_t e = Fetch64(s, o + 16) * mul;
  const uint64_t f = Fetch64(s, o + 24);
  const uint64_t g = (y + Fetch64(s, o + len - 32)) * mul;
  const uint64_t h = (z + Fetch64(s, o + len - 24)) * mul;
  return HashLen16(Rotate(e + f, 43) + Rotate(g, 30) + h,
                   e + Rotate(f + a, 18) + g, mul);
}

__device__ __forceinline__ uint64_t Fingerprint64(const uint32_t* s,
                                                  uint32_t o, uint32_t len) {
  if (len <= 16) return HashLen0to16(s, o, len);
  if (len <= 32) return HashLen17to32(s, o, len);
  return HashLen33to64(s, o, len);
}

// h % m for m in [1, 2^31], with M = floor((2^64 - 1) / m).
__device__ __forceinline__ int32_t ModBuckets(uint64_t h, uint32_t m,
                                              uint64_t M) {
  const uint64_t q = __umul64hi(h, M);
  uint32_t r = static_cast<uint32_t>(h) - static_cast<uint32_t>(q) * m;
  if (r >= m) r -= m;
  return static_cast<int32_t>(r);
}

// Shared memory of one block: the staged span from its 16-byte-aligned
// start, with slack for the word reads past its end; then, for delimited
// columns, each warp's piece list ({smem offset, length | slot << 16}).
int64_t StageBytes(int64_t R, int64_t W) { return (R * W + 48 + 15) / 16 * 16; }
constexpr int64_t kListEntries = kThreads / 32 * kRowsPerWarp;   // x L

template <bool kSplit>
__global__ void __launch_bounds__(kThreads) hash_rows_kernel(
    const uint8_t* __restrict__ raw,      // [n, Bp * W] verbatim bytes
    const int32_t* __restrict__ widths,   // [n] itemsize w_c <= W
    const int64_t* __restrict__ buckets,  // [n] in [1, 2^31]
    const uint64_t* __restrict__ recips,  // [n] floor((2^64 - 1) / m)
    const uint8_t* __restrict__ delims,   // [n] (delimited columns)
    int32_t* __restrict__ out,            // [n, Bp, L]
    int64_t Bp, int64_t W, int L, int R, int tiles, int stage_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int64_t c = blockIdx.x / tiles;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x - c * tiles) * R;
  const int nr = static_cast<int>(Bp - r0 < R ? Bp - r0 : R);
  int w = widths[c];
  w = w < 0 ? 0 : (w > W ? static_cast<int>(W) : w);   // stay in the buffer

  // ---- stage the span [r0 * w, (r0 + nr) * w) of column c --------------
  const uint8_t* g = raw + c * Bp * W + r0 * w;
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  const uint8_t* ga = g - head;
  const int end = head + nr * w;
  for (int k = tid; k * 16 < end; k += kThreads) {
    const int lo = k * 16;
    if (lo >= head && lo + 16 <= end) {
      reinterpret_cast<uint4*>(smem)[k] =
          __ldcs(reinterpret_cast<const uint4*>(ga) + k);
    } else {
      const int a = lo > head ? lo : head;
      const int b = lo + 16 < end ? lo + 16 : end;
      for (int j = a; j < b; ++j) smem[j] = ga[j];
    }
  }
  __syncthreads();
  const uint32_t* s = reinterpret_cast<const uint32_t*>(smem);
  const uint32_t m = static_cast<uint32_t>(buckets[c]);
  const uint64_t M = recips[c];
  int32_t* o_col = out + (c * Bp + r0) * L;

  if (!kSplit) {                         // a thread per row, one piece
    for (int r = tid; r < nr; r += kThreads) {
      const uint32_t o = head + r * w;
      __stcs(o_col + r,
             ModBuckets(Fingerprint64(s, o, RowLength(s, o, w)), m, M));
    }
    return;
  }

  // ---- delimited columns: kGroup lanes per row, a run of words each ----
  // A warp splits kRowsPerWarp rows at a time into a list of its own, then
  // hashes that list densely: a lane per piece.
  uint2* list = reinterpret_cast<uint2*>(smem + stage_bytes) +
                (tid >> 5) * kRowsPerWarp * L;
  const uint32_t dl4 = static_cast<uint32_t>(delims[c]) * 0x01010101u;
  const int lane = tid & 31;
  const int gl = lane & (kGroup - 1);    // lane within the row's group
  const int gw = lane / kGroup;          // the row's group within the warp
  const int nwords = (w + 3) >> 2;
  const int per = (nwords + kGroup - 1) / kGroup;
  const int q0 = gl * per < nwords ? gl * per : nwords;
  const int q1 = q0 + per < nwords ? q0 + per : nwords;
  for (int rw = (tid >> 5) * kRowsPerWarp; rw < R;
       rw += kThreads / kGroup) {       // the warp's first row this pass
    const int r = rw + gw;
    const bool live = r < nr;            // every lane takes the shuffles
    const uint32_t o = head + r * w;
    // the row length (the group's last non-NUL byte + 1) and this lane's
    // delimiters below it: their count and the last one.  A delimiter
    // other than NUL is never past the length, so one pass finds both.
    int len = 0, cnt = 0, lastd = -1;
    for (int q = live ? q0 : q1; q < q1; ++q) {
      const uint32_t valid = ValidBytes(w - 4 * q);
      const uint32_t x = Fetch32(s, o + 4 * q) & valid;
      if (x != 0) len = 4 * q + 4 - __clz(x) / 8;
      const uint32_t eq = ZeroBytes(x ^ dl4) & valid;   // 0x80 per delimiter
      cnt += __popc(eq);
      if (eq != 0) lastd = 4 * q + 3 - __clz(eq) / 8;
    }
#pragma unroll
    for (int d = 1; d < kGroup; d <<= 1) {
      len = max(len, __shfl_xor_sync(kFull, len, d));
    }
    const int limit = dl4 == 0 ? len : w;   // where delimiters may lie
    if (dl4 == 0) {
      cnt = 0;
      lastd = -1;
      for (int q = live ? q0 : q1; q < q1; ++q) {
        const uint32_t eq =
            ZeroBytes(Fetch32(s, o + 4 * q)) & ValidBytes(len - 4 * q);
        cnt += __popc(eq);
        if (eq != 0) lastd = 4 * q + 3 - __clz(eq) / 8;
      }
    }
    // over the group: delimiters before this lane's, and the last of them
    int incl = cnt, upto = lastd;
#pragma unroll
    for (int d = 1; d < kGroup; d <<= 1) {
      const int a = __shfl_up_sync(kFull, incl, d, kGroup);
      const int b = __shfl_up_sync(kFull, upto, d, kGroup);
      if (gl >= d) {
        incl += a;
        upto = max(upto, b);
      }
    }
    const int total = __shfl_sync(kFull, incl, kGroup - 1, kGroup);
    const int final_d = __shfl_sync(kFull, upto, kGroup - 1, kGroup);
    int p = __shfl_up_sync(kFull, upto, 1, kGroup);
    if (gl == 0) p = -1;                 // the delimiter before this lane's
    // the row's pieces (an empty row has none; past L they drop), and
    // where they start in the warp's list
    const int pieces = len == 0 ? 0 : (total + 1 < L ? total + 1 : L);
    int at = 0, listed = 0;
#pragma unroll
    for (int g = 0; g < kRowsPerWarp; ++g) {
      const int n_g = __shfl_sync(kFull, pieces, g * kGroup);
      at += g < gw ? n_g : 0;
      listed += n_g;
    }
    // each delimiter closes its piece; the group's last lane adds the one
    // that ends at len
    const uint32_t slot0 = static_cast<uint32_t>(gw * L) << 16;
    int k = incl - cnt;
    for (int q = live ? q0 : q1; q < q1 && k < L; ++q) {
      uint32_t eq = ZeroBytes(Fetch32(s, o + 4 * q) ^ dl4) &
                    ValidBytes(limit - 4 * q);
      while (eq != 0 && k < L) {
        const int pos = 4 * q + ((__ffs(eq) - 1) >> 3);
        list[at + k] = make_uint2(
            o + p + 1, static_cast<uint32_t>(pos - p - 1) |
                           (slot0 + (static_cast<uint32_t>(k) << 16)));
        ++k;
        p = pos;
        eq &= eq - 1;
      }
    }
    if (gl == kGroup - 1 && len > 0 && total < L) {
      list[at + total] = make_uint2(
          o + final_d + 1, static_cast<uint32_t>(len - final_d - 1) |
                               (slot0 + (static_cast<uint32_t>(total) << 16)));
    }
    if (live) {
      int32_t* o_row = o_col + r * L;
      for (int q = pieces + gl; q < L; q += kGroup) o_row[q] = -1;
    }
    __syncwarp();
    int32_t* o_pass = o_col + rw * L;
    for (int i = lane; i < listed; i += 32) {
      const uint2 e = list[i];
      o_pass[e.y >> 16] =
          ModBuckets(Fingerprint64(s, e.x, e.y & 0xffffu), m, M);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int rt_hash_rows(
    const void* raw, const void* widths, const void* buckets,
    const void* recips, const void* delims, void* out,
    int64_t n, int64_t Bp, int64_t W, int64_t L, void* stream) {
  if (n == 0 || Bp == 0) return 0;
  const bool split = delims != nullptr;
  // piece lengths and list slots are kept in 16 bits
  if (W < 1 || W > 65535 || L < 1 || L > 65535 / kRowsPerWarp ||
      (!split && L != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t most = split ? kSplitRows : kFixedRows;
  int64_t R = (kSmemTarget - 64) / W;
  R = R < 1 ? 1 : (R > most ? most : R);
  if (R > Bp) R = Bp;
  const int64_t stage = StageBytes(R, W);
  const int64_t smem = stage + (split ? kListEntries * L * 8 : 0);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (Bp + R - 1) / R;
  if (n * tiles > 2147483647) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto kernel = split ? hash_rows_kernel<true> : hash_rows_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(n * tiles), kThreads,
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const int32_t*>(widths),
      static_cast<const int64_t*>(buckets),
      static_cast<const uint64_t*>(recips),
      static_cast<const uint8_t*>(delims), static_cast<int32_t*>(out), Bp, W,
      static_cast<int>(L), static_cast<int>(R), static_cast<int>(tiles),
      static_cast<int>(stage));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
