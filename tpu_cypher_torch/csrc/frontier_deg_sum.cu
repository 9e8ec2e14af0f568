// frontier_deg_sum: the single-hop count(*) reduction, one launch, written
// for Hopper.
//
// Replaces the TPU kernel _deg_sum_kernel / _csr_deg_sum_pallas in
// tpu_cypher/backend/tpu/pallas/frontier.py. It computes
//     sum over present frontier rows i of (row_ptr[p+1] - row_ptr[p]),
//     p = pos[i] clamped into [0, len(row_ptr) - 2],
// as an int64. The TPU kernel first materializes the O(V) degree vector to
// keep it VMEM-resident; this kernel reads the two row_ptr entries of each
// frontier row directly, which is the same function with less traffic.
//
// Bound on the H100: memory, about 17 bytes per frontier row (8 B pos,
// 1 B present, two 4 B row_ptr reads). At the slice's F = 100,000 that is
// 1.7 MB, about half a microsecond of HBM time, so one launch and the host
// work around it are the cost, not the bytes.
// Design: one launch. Each thread reads 4-row chunks, pos as two 16-byte
// loads and present as one 4-byte load, two chunks in flight, and the two
// random row_ptr reads through the read-only path (__ldg); int64 sums per
// thread, warp shuffles and one shared-memory step give a block partial.
// The last block to finish (a __threadfence and an atomic ticket, which it
// resets) sums the partials with the whole block and writes the total, so
// no second kernel and no partials tensor from the allocator are needed.
// The grid is sized from F and capped at the blocks the SMs hold at once.
// An integer sum is exact in any order, so the result is bit-identical to
// the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;
constexpr int kRowsPerStep = kThreads * 4 * kUnroll;
constexpr int kMaxBlocksPerSM = 2048 / kThreads;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ long long degree(const int32_t* __restrict__ rp, int64_t last,
                                            int64_t p) {
  p = p < 0 ? 0 : (p > last ? last : p);
  return (long long)(__ldg(rp + p + 1) - __ldg(rp + p));
}

__global__ void __launch_bounds__(kThreads)
deg_sum(const int32_t* __restrict__ rp, int64_t nrp, const int64_t* __restrict__ pos,
        const uint8_t* __restrict__ present, int64_t frontier, bool aligned,
        long long* __restrict__ part, unsigned* __restrict__ ticket,
        long long* __restrict__ out) {
  const int64_t last = nrp - 2;  // largest row with a row_ptr successor
  long long acc = 0;
  if (last >= 0) {
    const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    const int64_t nchunks = aligned ? frontier / 4 : 0;
    for (int64_t base = tid; base < nchunks; base += stride * kUnroll) {
      longlong2 pa[kUnroll], pb[kUnroll];
      uchar4 m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int64_t c = base + u * stride;
        if (c >= nchunks) c = nchunks - 1;  // a repeated load, not summed
        pa[u] = __ldg((const longlong2*)pos + 2 * c);
        pb[u] = __ldg((const longlong2*)pos + 2 * c + 1);
        m[u] = __ldg((const uchar4*)present + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * stride >= nchunks) break;
        if (m[u].x) acc += degree(rp, last, pa[u].x);
        if (m[u].y) acc += degree(rp, last, pa[u].y);
        if (m[u].z) acc += degree(rp, last, pb[u].x);
        if (m[u].w) acc += degree(rp, last, pb[u].y);
      }
    }
    for (int64_t i = nchunks * 4 + tid; i < frontier; i += stride)
      if (present[i]) acc += degree(rp, last, pos[i]);
  }
  acc = block_sum(acc);
  __shared__ bool last_block;
  if (threadIdx.x == 0) {
    part[blockIdx.x] = acc;
    __threadfence();
    last_block = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  long long total = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads) total += __ldcg(part + b);
  total = block_sum(total);
  if (threadIdx.x == 0) {
    *out = total;
    *ticket = 0;  // ready for the next launch
  }
}

int sm_count(int dev) {
  static int cached[kMaxDevices];
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

}  // namespace

// Bytes of the scratch buffer a launch on `device` needs: the ticket, then
// one partial per block of the largest grid. The caller zeroes it once; the
// kernel leaves the ticket at zero.
extern "C" long long frontier_deg_sum_scratch_bytes(int device) {
  if (device < 0 || device >= kMaxDevices) return -1;
  return 16 + 8LL * sm_count(device) * kMaxBlocksPerSM;
}

extern "C" int frontier_deg_sum_launch(const void* rp, int64_t nrp, const void* pos,
                                       const void* present, int64_t frontier,
                                       void* scratch, void* out, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || frontier < 0) return (int)cudaErrorInvalidValue;
  static int occ[kMaxDevices];  // blocks per SM, per device
  if (!occ[dev]) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[dev], deg_sum, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t cap = (int64_t)sm_count(dev) * (occ[dev] > 0 ? occ[dev] : 1);
  const int64_t want = (frontier + kRowsPerStep - 1) / kRowsPerStep;
  const int grid = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  const bool aligned = (uintptr_t)pos % 16 == 0 && (uintptr_t)present % 4 == 0;
  deg_sum<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rp, nrp, (const int64_t*)pos, (const uint8_t*)present, frontier,
      aligned, (long long*)((char*)scratch + 16), (unsigned*)scratch, (long long*)out);
  return (int)cudaGetLastError();
}
