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
// a native int64 compare, and the search below runs over any length: its
// last step lands on [0, nk], so neither the pad nor the half-step exists.
//
// Bound on the H100: at the main path's shape (Q6, SF10 arm 0: 103M
// queries over 4.5M keys) the keys are 36 MB and stay in the 50 MB L2, so
// the bytes that must move are the 25 per query (q, qvalid, lo, counts):
// 0.77 ms. The function needs one lower-bound search per query,
// ceil(log2(nk)) = 23 rounds of int32 index arithmetic and an int64
// compare, then an equality test; only a hit needs more, a search of its
// own run. That bounds it by operations instead (chip_smoke.py counts them
// from this source).
// Design: one thread per query lane, grid-stride. The lower-bound search
// is branchless. The queries the WCOJ path sends are nearly sorted (row
// order, then the CSR's sorted neighbours), so a warp's lanes walk the
// same first rounds of the search: those loads are broadcasts of one L2
// line. A valid lane whose key is present finds the end of its run by
// galloping from lo (steps 1, 2, 4, ... then halving back), O(log run)
// loads instead of a second search over all of the keys; almost every
// probe misses, so the lanes of a warp rarely wait on it. Keys are read
// through __ldg; nothing is staged in shared memory, because the searched
// range (all of the keys) is far larger than it. Search positions are
// int32: the CSR caps a key list below 2^31 entries.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// keys[b] == x: the length of the run of keys equal to x from b on
__device__ int64_t run_length(const long long* __restrict__ keys, int64_t nk,
                              int64_t b, long long x) {
  int64_t last = b, step = 1;  // invariant: keys[last] == x
  while (last + step < nk && __ldg(keys + last + step) == x) {
    last += step;
    step <<= 1;
  }
  // the run ends in (last, end]: keys[end] > x, or end == nk
  int64_t end = last + step < nk ? last + step : nk;
  while (end - last > 1) {
    const int64_t mid = last + ((end - last) >> 1);
    if (__ldg(keys + mid) == x) last = mid; else end = mid;
  }
  return end - b;
}

__global__ void range_count_kernel(const long long* __restrict__ keys,
                                   int32_t nk,
                                   const long long* __restrict__ q,
                                   const uint8_t* __restrict__ qvalid,
                                   long long* __restrict__ lo_out,
                                   long long* __restrict__ cnt_out,
                                   int64_t nq) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nq;
       i += stride) {
    const long long x = q[i];
    // invariant: the left insertion point lies in [b, b + n]; every
    // probed index is < b + n <= nk
    int32_t b = 0, n = nk;
    while (n > 1) {
      const int32_t half = n >> 1;
      b = __ldg(keys + b + half) < x ? b + half : b;
      n -= half;
    }
    b += __ldg(keys + b) < x ? 1 : 0;
    long long c = 0;
    if (qvalid[i] && b < nk && __ldg(keys + b) == x) c = run_length(keys, nk, b, x);
    lo_out[i] = b;
    cnt_out[i] = c;
  }
}

}  // namespace

extern "C" int range_count_launch(const void* keys, int64_t nk, const void* q,
                                  const void* qvalid, void* lo_out,
                                  void* cnt_out, int64_t nq, void* stream) {
  if (nq <= 0) return 0;
  if (nk <= 0 || nk > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int64_t blocks = (nq + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride covers the rest
  range_count_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (int32_t)nk, (const long long*)q,
      (const uint8_t*)qvalid, (long long*)lo_out, (long long*)cnt_out, nq);
  return (int)cudaGetLastError();
}
