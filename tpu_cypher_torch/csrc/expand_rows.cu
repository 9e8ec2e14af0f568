// expand_rows: the CSR expand-materialize row search, written for Hopper.
//
// Replaces the TPU kernel _expand_rows_kernel / _expand_rows_pallas in
// tpu_cypher/backend/tpu/pallas/expand.py. For every output lane
// l < size it computes
//     row  = searchsorted(cum, l, side='right') - 1, clamped to [0, F-1]
//     edge = starts[row] + (l - cum[row])
// where cum is the frontier's degree cumsum with a leading 0 (int32[F+1])
// and starts = row_ptr[pos] (int32[F]). Pad lanes (l >= cum[F]) fall past
// the last stop and clamp exactly as the TPU kernel clamps them; the shared
// torch tail (jit_ops.finish_expand_counted) sanitizes them afterwards.
//
// Bound on the H100: memory. Each lane writes 8 bytes (row and edge, both
// int32) and the search reads cum, which is small (1.8 MB at a 449,972-row
// frontier) and stays in the 50 MB L2 for the whole launch.
// Design: one thread per output lane with an upper-bound binary search over
// cum in global memory. Neighbouring lanes fall in the same or adjacent
// rows, so a warp's searches walk the same cache lines and its stores are
// coalesced; nothing is staged in shared memory, because the searched range
// (all of cum) is far larger than a block's shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void expand_rows_kernel(const int32_t* __restrict__ cum,
                                   int32_t nstops,
                                   const int32_t* __restrict__ starts,
                                   int32_t* __restrict__ row_out,
                                   int32_t* __restrict__ edge_out,
                                   int64_t size) {
  const int32_t rmax = nstops - 2 > 0 ? nstops - 2 : 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; l < size;
       l += stride) {
    const int32_t lane = (int32_t)l;
    // first index in [0, nstops) whose stop exceeds the lane
    int32_t lo = 0, hi = nstops;
    while (lo < hi) {
      const int32_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(cum + mid) <= lane) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int32_t row = lo - 1;
    row = row < 0 ? 0 : (row > rmax ? rmax : row);
    row_out[l] = row;
    // int32 wraparound arithmetic, as the TPU kernel's int32 lanes
    edge_out[l] = (int32_t)((uint32_t)__ldg(starts + row) + (uint32_t)lane -
                            (uint32_t)__ldg(cum + row));
  }
}

}  // namespace

extern "C" int expand_rows_launch(const void* cum, int64_t nstops,
                                  const void* starts, void* row_out,
                                  void* edge_out, int64_t size,
                                  void* stream) {
  if (size <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (size + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride covers the rest
  expand_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cum, (int32_t)nstops, (const int32_t*)starts,
      (int32_t*)row_out, (int32_t*)edge_out, size);
  return (int)cudaGetLastError();
}
