// range_count: the WCOJ sorted-key range count, written for Hopper.
//
// Replaces the TPU kernel _range_count_kernel / _range_count_pallas in
// tpu_cypher/backend/tpu/pallas/intersect.py. For every query lane i < nq
// it computes, over the ascending int64 keys (nk > 0),
//     lo[i]     = searchsorted(keys, q[i], side='left')
//     counts[i] = qvalid[i] ? searchsorted(keys, q[i], side='right') - lo[i]
//                           : 0
// The TPU kernel splits each int64 into (lo32, hi32) planes for Mosaic's
// lane width and pads the key list to a power of two, which then needs a
// completion half-step to reach the insertion point n. Here the compare is
// a native int64 compare over the unpadded keys.
//
// Bound on the H100: the bytes that must move are the keys once, the 25
// per query (q, qvalid, lo, counts) and the index below: 1.48 ms at the
// closing probe's 197M queries over SF10's 4.5M KNOWS keys (Q22), 0.78 ms
// at Q6 arm 0's 103M. A lower-bound search over all nk keys would be
// bound by the L2 instead: it is ceil(log2 nk) = 23 dependent loads a
// query, and where neighbouring lanes probe unrelated keys (the closing
// probe's c*N + a, the lanes in a's order) each of the ~11 deepest lands
// on a 32-byte sector of its own.
//
// Design: a clear of the table, then three kernels, all on one stream and
// with no host sync between them.
// 1. The bucket starts. A bucket-start table over the key range: with
//    kmin = keys[0], span = kmax - kmin (unsigned 64-bit, so any int64
//    span is exact) and B = 2^log2b buckets (the wrapper takes B near
//    nk/2), shift = max(0, bit_length(span) - log2b) and
//        start[b] = lower_bound(keys, kmin + (b << shift)),  b < B
//        start[B] = nk
//    (a bucket whose first value lies past kmax starts at nk). The table
//    is cleared to -1; then one thread per key i writes i into the
//    buckets from its predecessor's bucket (exclusive) to its own
//    (inclusive), whose first values lie in (keys[i - 1], keys[i]]: one
//    coalesced read of the keys and each entry written once. A thread
//    whose run is longer than 32 buckets (a far key after a gap) writes
//    none of it, so no thread loops long; the next pass finds each such
//    entry still -1 and searches the keys for it, and takes every entry
//    past kmax as nk without a search.
// 2. The bucket records. One thread per bucket resolves its start s and
//    the next bucket's e and writes its 16-byte record: s and, when the
//    bucket holds at most 6 keys and shift <= 14, the offsets of its keys
//    within the bucket, (key - kmin) mod 2^shift, as 6 sorted 16-bit
//    lanes; a lane holds 0x8000 | offset, an unused lane 0xFFFF. Bit 31
//    of s marks a bucket whose keys are not inline; its record holds e in
//    its second word instead. With B near nk/2 (SF10: 2^21 buckets,
//    shift 13) nearly every closing-probe query lands in a bucket whose
//    keys are inline. The records take 32 MB at SF10, of which the
//    buckets in use, about 20 MB, stay in L2.
// 3. The search. A thread takes 2 query lanes a block apart and loads
//    both queries, then both records, before it answers either, so two
//    chains of dependent loads are in flight. A query below kmin has
//    lo = 0, one above kmax lo = nk, both count 0. Otherwise its bucket
//    b = (q - kmin) >> shift holds its insertion point: s <= lower_bound(q)
//    <= e, since the bucket's first value is <= q and the next bucket's
//    first value is > q. With the offsets inline,
//    lo = s + #(offsets < q's offset) and the count is
//    #(offsets == q's offset): per 32-bit word one subtract of q's
//    offset from both lanes (bit 15 of a lane survives it exactly when
//    the lane's offset is >= q's, and no borrow crosses lanes, since
//    every lane is >= 0x8000 > q's offset), and again with q's offset + 1
//    for a valid lane. Otherwise (a hub's bucket, or a span too wide for
//    14-bit offsets) the branchless lower-bound search runs over
//    keys[s, e) only; a run of keys equal to q lies inside one bucket, so
//    a hit's gallop (steps 1, 2, 4, ..., then halving back) stops at e.
//    The queries and the outputs stream through with evict-first loads
//    and stores, so they do not push the records out of L2.
// What a query costs in L2 is thereby one sector and one load
// instruction, where a search over all keys would take about 11 sectors
// and 24 dependent loads; a warp's lanes in unrelated buckets still need
// a line each.
// Search positions are int32: the CSR caps a key list below 2^31 entries.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInline = 6;        // key offsets kept in a bucket's record
constexpr int kInlineShift = 14;  // offsets inline only below 2^14: a lane
                                  // (0x8000 | offset) and an unused lane
                                  // (0xFFFF) both stay >= 0x8000 after the
                                  // subtract of any query offset + 1
constexpr uint32_t kSearch = 0x80000000u;  // a record's flag: search the keys
constexpr int kLanes = 2;  // query lanes a search thread takes, a block apart
constexpr int kGap = 32;   // buckets a pass-1 thread fills at most

// the bucket shift: bit_length(kmax - kmin) - log2b, at least 0; with
// log2b >= 1 it is at most 63
__device__ __forceinline__ int bucket_shift(long long kmin, long long kmax, int log2b) {
  const unsigned long long span = (unsigned long long)kmax - (unsigned long long)kmin;
  const int bits = 64 - __clzll((long long)span);
  return bits > log2b ? bits - log2b : 0;
}

// the lower bound of x in keys[b, b + n): a position in [b, b + n];
// every probed index is < b + n
__device__ __forceinline__ int32_t lower_bound(const long long* __restrict__ keys,
                                               int32_t b, int32_t n, long long x) {
  if (n == 0) return b;
  while (n > 1) {
    const int32_t half = n >> 1;
    b = __ldg(keys + b + half) < x ? b + half : b;
    n -= half;
  }
  return b + (__ldg(keys + b) < x ? 1 : 0);
}

// keys[b] == x: the length of the run of keys equal to x from b on, all
// of them before end
__device__ int64_t run_length(const long long* __restrict__ keys, int64_t end,
                              int64_t b, long long x) {
  int64_t last = b, step = 1;  // invariant: keys[last] == x
  while (last + step < end && __ldg(keys + last + step) == x) {
    last += step;
    step <<= 1;
  }
  // the run ends in (last, hi]: keys[hi] > x, or hi == end
  int64_t hi = last + step < end ? last + step : end;
  while (hi - last > 1) {
    const int64_t mid = last + ((hi - last) >> 1);
    if (__ldg(keys + mid) == x) last = mid; else hi = mid;
  }
  return hi - b;
}

// the first value of bucket b < 2^log2b, and whether it is <= kmax
__device__ __forceinline__ bool bucket_first(long long kmin, unsigned long long span, int shift,
                                             int64_t b, long long& first) {
  // b << shift < 2^64: b < 2^log2b, shift <= 64 - log2b
  const unsigned long long off = (unsigned long long)b << shift;
  first = (long long)((unsigned long long)kmin + off);
  return off <= span;
}

// pass 1, one thread per key i: start[b] = i for the buckets b in
// (bucket(keys[i - 1]), bucket(keys[i])], whose first value lies in
// (keys[i - 1], keys[i]]; a longer run than kGap buckets is left to pass 2
__global__ void bucket_start_from_keys_kernel(const long long* __restrict__ keys, int32_t nk,
                                              int log2b, int32_t* __restrict__ start) {
  const long long kmin = __ldg(keys), kmax = __ldg(keys + nk - 1);
  const int shift = bucket_shift(kmin, kmax, log2b);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nk; i += stride) {
    const int64_t b = (int64_t)(((unsigned long long)__ldg(keys + i) -
                                 (unsigned long long)kmin) >> shift);
    const int64_t prev = i == 0 ? -1 : (int64_t)(((unsigned long long)__ldg(keys + i - 1) -
                                                  (unsigned long long)kmin) >> shift);
    if (b - prev <= kGap)
      for (int64_t e = prev + 1; e <= b; ++e) start[e] = (int32_t)i;
    if (i == nk - 1) start[int64_t{1} << log2b] = nk;
  }
}

// start[b] after pass 1, or, where pass 1 left it unset (-1), its
// definition: the lower bound of the bucket's first value, nk past kmax
__device__ __forceinline__ int32_t resolve_start(const long long* __restrict__ keys, int32_t nk,
                                                 long long kmin, unsigned long long span,
                                                 int shift, const int32_t* __restrict__ start,
                                                 int64_t b) {
  const int32_t s = __ldg(start + b);
  if (s >= 0) return s;
  long long first;
  return bucket_first(kmin, span, shift, b, first) ? lower_bound(keys, 0, nk, first) : nk;
}

// the offset of x within its bucket, (x - kmin) mod 2^shift, shift <= 14
__device__ __forceinline__ uint32_t bucket_offset(long long x, long long kmin, int shift) {
  return (uint32_t)((unsigned long long)x - (unsigned long long)kmin) & ((1u << shift) - 1);
}

// pass 2, one thread per bucket b < 2^log2b: the bucket's record
__global__ void bucket_record_kernel(const long long* __restrict__ keys, int32_t nk,
                                     int log2b, const int32_t* __restrict__ start,
                                     uint4* __restrict__ records) {
  const long long kmin = __ldg(keys), kmax = __ldg(keys + nk - 1);
  const int shift = bucket_shift(kmin, kmax, log2b);
  const unsigned long long span = (unsigned long long)kmax - (unsigned long long)kmin;
  const int64_t nb = int64_t{1} << log2b;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < nb; b += stride) {
    const int32_t s = resolve_start(keys, nk, kmin, span, shift, start, b);
    const int32_t e = resolve_start(keys, nk, kmin, span, shift, start, b + 1);
    const bool inline_keys = shift <= kInlineShift && e - s <= kInline;
    uint32_t w[kInline / 2];
#pragma unroll
    for (int j = 0; j < kInline / 2; ++j) w[j] = 0xFFFFFFFFu;
    if (inline_keys) {
#pragma unroll
      for (int j = 0; j < kInline; ++j) {
        if (j < e - s) {
          const uint32_t lane = 0x8000u | bucket_offset(__ldg(keys + s + j), kmin, shift);
          const int h = 16 * (j & 1);
          w[j >> 1] = (w[j >> 1] & ~(0xFFFFu << h)) | (lane << h);
        }
      }
    } else {
      w[0] = (uint32_t)e;
    }
    records[b] = make_uint4((uint32_t)s | (inline_keys ? 0u : kSearch), w[0], w[1], w[2]);
  }
}

// per 16-bit lane of w (each lane >= 0x8000 > x): 1 where the lane's
// offset is >= x, else 0
__device__ __forceinline__ uint32_t lanes_at_least(uint32_t w, uint32_t x2) {
  return ((w - x2) >> 15) & 0x00010001u;
}

// one query lane's answer from its bucket's record r (x in [kmin, kmax])
__device__ __forceinline__ void answer(const long long* __restrict__ keys, uint4 r,
                                       long long x, long long kmin, int shift, bool valid,
                                       int32_t& lo, long long& c) {
  const int32_t s = (int32_t)(r.x & ~kSearch);
  if (!(r.x & kSearch)) {
    const uint32_t xo = bucket_offset(x, kmin, shift);
    const uint32_t x2 = xo * 0x10001u, x2next = (xo + 1) * 0x10001u;
    const uint32_t ge = lanes_at_least(r.y, x2) + lanes_at_least(r.z, x2) +
                        lanes_at_least(r.w, x2);
    const int32_t n_ge = (int32_t)((ge & 0xFFFFu) + (ge >> 16));
    lo = s + kInline - n_ge;
    if (valid) {
      const uint32_t gt = lanes_at_least(r.y, x2next) + lanes_at_least(r.z, x2next) +
                          lanes_at_least(r.w, x2next);
      c = n_ge - (long long)((gt & 0xFFFFu) + (gt >> 16));
    }
  } else {
    const int32_t e = (int32_t)r.y;
    lo = lower_bound(keys, s, e - s, x);
    if (valid && lo < e && __ldg(keys + lo) == x) c = run_length(keys, e, lo, x);
  }
}

__global__ void range_count_kernel(const long long* __restrict__ keys, int32_t nk,
                                   const uint4* __restrict__ records, int log2b,
                                   const long long* __restrict__ q,
                                   const uint8_t* __restrict__ qvalid,
                                   long long* __restrict__ lo_out,
                                   long long* __restrict__ cnt_out, int64_t nq) {
  const long long kmin = __ldg(keys), kmax = __ldg(keys + nk - 1);
  const int shift = bucket_shift(kmin, kmax, log2b);
  const int64_t tile = (int64_t)blockDim.x * kLanes;
  for (int64_t base = (int64_t)blockIdx.x * tile + threadIdx.x; base < nq;
       base += (int64_t)gridDim.x * tile) {
    // each phase for all of the thread's lanes first, so that their
    // query loads, then their record loads, are in flight together
    long long x[kLanes];
    bool in[kLanes];
    uint4 r[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int64_t i = base + k * (int64_t)blockDim.x;
      x[k] = i < nq ? __ldcs(q + i) : kmin;  // past nq: bucket 0, nothing stored
    }
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      in[k] = x[k] >= kmin && x[k] <= kmax;
      const unsigned long long b = ((unsigned long long)x[k] - (unsigned long long)kmin) >> shift;
      if (in[k]) r[k] = __ldg(records + b);
    }
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int64_t i = base + k * (int64_t)blockDim.x;
      if (i >= nq) break;
      int32_t lo = x[k] < kmin ? 0 : nk;
      long long c = 0;
      if (in[k]) answer(keys, r[k], x[k], kmin, shift, __ldcs(qvalid + i), lo, c);
      __stcs(lo_out + i, (long long)lo);
      __stcs(cnt_out + i, c);
    }
  }
}

int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  return (int)(blocks > 1048576 ? 1048576 : blocks);  // grid-stride covers the rest
}

// the index, then the search, on one stream; ``start`` is the caller's
// buffer of 2^log2b + 1 int32, ``records`` of 2^log2b records of 16 bytes
int launch(const void* keys, int64_t nk, int log2b, void* start, void* records,
           const void* q, const void* qvalid, void* lo_out, void* cnt_out, int64_t nq,
           cudaStream_t stream) {
  if (nk <= 0 || nk > INT32_MAX || log2b < 1 || log2b > 30)
    return (int)cudaErrorInvalidValue;
  if (nq <= 0) return 0;
  const int64_t nb = int64_t{1} << log2b;
  int rc = (int)cudaMemsetAsync(start, 0xFF, (size_t)(nb + 1) * sizeof(int32_t), stream);
  if (rc != 0) return rc;
  const int threads = 256;
  bucket_start_from_keys_kernel<<<grid_for(nk, threads), threads, 0, stream>>>(
      (const long long*)keys, (int32_t)nk, log2b, (int32_t*)start);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  bucket_record_kernel<<<grid_for(nb, threads), threads, 0, stream>>>(
      (const long long*)keys, (int32_t)nk, log2b, (const int32_t*)start, (uint4*)records);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  range_count_kernel<<<grid_for((nq + kLanes - 1) / kLanes, threads), threads, 0, stream>>>(
      (const long long*)keys, (int32_t)nk, (const uint4*)records, log2b,
      (const long long*)q, (const uint8_t*)qvalid, (long long*)lo_out, (long long*)cnt_out, nq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int range_count_launch(const void* keys, int64_t nk, int log2b,
                                  void* start, void* records, const void* q,
                                  const void* qvalid, void* lo_out, void* cnt_out,
                                  int64_t nq, void* stream) {
  return launch(keys, nk, log2b, start, records, q, qvalid, lo_out, cnt_out, nq,
                (cudaStream_t)stream);
}
