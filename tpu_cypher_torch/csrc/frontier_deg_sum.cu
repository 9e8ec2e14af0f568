// frontier_deg_sum: the single-hop count(*) reduction, written for Hopper.
//
// Replaces the TPU kernel _deg_sum_kernel / _csr_deg_sum_pallas in
// tpu_cypher/backend/tpu/pallas/frontier.py. It computes
//     sum over present frontier rows i of (row_ptr[pos[i]+1] - row_ptr[pos[i]])
// as an int64. The TPU kernel first materializes the O(V) degree vector to
// keep it VMEM-resident; this kernel reads the two row_ptr entries of each
// frontier row directly, which is the same function with less traffic.
//
// Bound on the H100: memory, about 17 bytes per frontier row (8 B pos,
// 1 B present, two 4 B row_ptr reads). At the slice's F = 100,000 that is
// 1.7 MB, about half a microsecond of HBM time, so the kernel is bound by
// its two launches rather than by bytes.
// Design: pass 1 is a grid-stride loop accumulating in int64 per thread,
// reduced with warp shuffles and one shared-memory step to one partial per
// block; pass 2 is one block that reduces the partials the same way. An
// integer sum is exact in any order, so the result is bit-identical to the
// plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long block_sum(long long v) {
  __shared__ long long warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // valid in thread 0
}

__global__ void deg_sum_partials(const int32_t* __restrict__ rp, int64_t nrp,
                                 const int64_t* __restrict__ pos,
                                 const uint8_t* __restrict__ present,
                                 int64_t frontier,
                                 long long* __restrict__ partials) {
  long long acc = 0;
  const int64_t last = nrp - 2;  // largest row with a row_ptr successor
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < frontier;
       i += stride) {
    if (present[i] && last >= 0) {
      int64_t p = pos[i];
      p = p < 0 ? 0 : (p > last ? last : p);
      acc += (long long)(__ldg(rp + p + 1) - __ldg(rp + p));
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void deg_sum_final(const long long* __restrict__ partials, int n,
                              long long* __restrict__ out) {
  long long acc = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

}  // namespace

extern "C" int frontier_deg_sum_threads() { return kThreads; }

extern "C" int frontier_deg_sum_launch(const void* rp, int64_t nrp,
                                       const void* pos, const void* present,
                                       int64_t frontier, void* partials,
                                       int nblocks, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  deg_sum_partials<<<nblocks, kThreads, 0, s>>>(
      (const int32_t*)rp, nrp, (const int64_t*)pos, (const uint8_t*)present,
      frontier, (long long*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  deg_sum_final<<<1, kThreads, 0, s>>>((const long long*)partials, nblocks,
                                       (long long*)out);
  return (int)cudaGetLastError();
}
