// hash_probe: the equi-join's hash table, built and probed on Hopper.
//
// Replaces the TPU kernel _probe_kernel / _hash_probe_pallas in
// tpu_cypher/backend/tpu/pallas/join.py, and the jnp build that feeds it
// (_hash_build). Two kernels:
//
// hash_build_kernel places every unique key of the valid build side, given
// as its int64 keys in sorted order (equal keys contiguous), in a table of
// `size` = 2^log2_size slots, each
//     {int64 key, int32 first sorted position, int32 run length}
// (16 bytes, run length 0 = empty), by the reference's claim rule: in round
// r every unplaced first-occurrence lane i tries slot (hash + r) & (size-1);
// of the lanes that find their slot empty at the round's start, the
// smallest i wins it. Unlike the reference it claims until every key is
// placed (the reference stops after 16 rounds and answers from
// searchsorted) and writes the last round's index, the largest offset any
// key needed, to *max_off. The rounds run in one cooperative launch, with
// a grid-wide barrier between a round's claims and its commits and after
// its commits; nothing goes back to the host. A claimed slot is always
// won, so the claim array needs no reset between rounds. The torch-op
// hash_build in hopper/join.py is its plain version, slot for slot.
//
// hash_probe_kernel, for every probe lane i < nq:
//     counts[i] = qvalid[i] ? the run length of q[i] in the build, else 0
//     lo[i]     = counts[i] > 0 ? the first sorted build position of q[i] : 0
// which is jit_ops.join_probe's contract (two searchsorted calls over the
// sorted build keys, lo zeroed where the count is 0). It walks at most
// *max_off + 1 slots from the key's hash slot and stops at the key or at an
// empty slot.
//
// The TPU kernel splits each int64 key into (lo32, hi32) int32 planes for
// Mosaic's lane width, keeps the four table vectors VMEM-resident (so the
// build is capped at 2^17 keys) and unrolls a fixed 16-step probe. Here a
// key compares as one int64, a slot is one 16-byte load, and the table
// stays in device memory (2^18 slots, 4 MiB, for Q11's 100,000-row build:
// inside the 50 MB L2), so no build size is declined.
//
// Bound on the H100: memory. A probe lane reads its 8 B key and 1 B
// validity and writes 8 B lo and 8 B count (25 B); the table is read once.
// The hash is two multiplies, an xor and a shift, and a probe step about
// ten int32 operations, so at the load factor <= 1/2 the build keeps, the
// operations take a small fraction of the bytes' time (chip_smoke.py counts
// both). Design: one thread per probe lane, grid-stride, coalesced key,
// validity and output accesses; the table loads are random but
// L2-resident, one 16-byte __ldg per probe step. Nothing is staged in
// shared memory: the table is larger than it, and each lane touches only
// one or two of its slots. The build reads its table, claim and state
// arrays through L2 only (__ldcg), since other blocks write them in the
// same launch.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// the reference's multiplicative mix of the key's two 32-bit halves
__device__ __forceinline__ uint32_t slot_hash(long long key, int log2_size) {
  const uint32_t lo = (uint32_t)((unsigned long long)key & 0xffffffffull);
  const uint32_t hi = (uint32_t)((unsigned long long)key >> 32);
  const uint32_t u = lo * 2654435761u ^ hi * 2246822519u;
  return u >> (32 - log2_size);
}

// one past the last lane of i's run of equal keys: a gallop, then a
// binary search, on equality (the runs are contiguous whatever the order)
__device__ __forceinline__ int run_end(const long long* __restrict__ keys,
                                       int i, int n) {
  const long long k = __ldg(keys + i);
  long long lo = i, hi = (long long)i + 1, step = 1;
  while (hi < n && __ldg(keys + hi) == k) {
    lo = hi;
    step <<= 1;
    hi = (long long)i + step;
  }
  if (hi > n) hi = n;
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid) == k) lo = mid; else hi = mid;
  }
  return (int)hi;
}

// meta: [0] the largest offset (written at the end), [1], [2] the unplaced
// lanes of even and odd rounds
__global__ void hash_build_kernel(const long long* __restrict__ keys, int n,
                                  int log2_size, int4* table, int* claim,
                                  int* off, int* meta) {
  cg::grid_group grid = cg::this_grid();
  const uint32_t size = 1u << log2_size, mask = size - 1u;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = tid; s < size; s += stride) {
    table[s] = make_int4(0, 0, 0, 0);
    claim[s] = INT_MAX;
  }
  // off[i]: lane i's next offset, or -1 once placed or not a run's first
  for (long long i = tid; i < n; i += stride)
    off[i] = (i == 0 || __ldg(keys + i) != __ldg(keys + i - 1)) ? 0 : -1;
  if (tid == 0) meta[0] = meta[1] = meta[2] = 0;
  grid.sync();
  for (int round = 0;; ++round) {
    for (long long i = tid; i < n; i += stride) {
      const int o = __ldcg(off + i);
      if (o < 0) continue;
      const uint32_t s = (slot_hash(__ldg(keys + i), log2_size) + (uint32_t)o) & mask;
      if (__ldcg(&table[s].w) == 0) atomicMin(claim + s, (int)i);
    }
    grid.sync();
    int unplaced = 0;
    // the next round's counter was the last round's, which every thread
    // read before this round's first barrier
    if (tid == 0) meta[1 + ((round + 1) & 1)] = 0;
    for (long long i = tid; i < n; i += stride) {
      const int o = __ldcg(off + i);
      if (o < 0) continue;
      const long long x = __ldg(keys + i);
      const uint32_t s = (slot_hash(x, log2_size) + (uint32_t)o) & mask;
      if (__ldcg(claim + s) == (int)i) {
        const unsigned long long u = (unsigned long long)x;
        table[s] = make_int4((int)(uint32_t)(u & 0xffffffffull), (int)(uint32_t)(u >> 32),
                             (int)i, run_end(keys, (int)i, n) - (int)i);
        off[i] = -1;
      } else {
        off[i] = o + 1;
        ++unplaced;
      }
    }
    if (unplaced) atomicAdd(meta + 1 + (round & 1), unplaced);
    grid.sync();
    if (__ldcg(meta + 1 + (round & 1)) == 0) {
      if (tid == 0) meta[0] = round;
      return;
    }
  }
}

__global__ void hash_probe_kernel(const int4* __restrict__ table,
                                  int log2_size, const int* __restrict__ max_off_p,
                                  const long long* __restrict__ q,
                                  const uint8_t* __restrict__ qvalid,
                                  long long* __restrict__ lo_out,
                                  long long* __restrict__ cnt_out,
                                  int64_t nq) {
  const uint32_t mask = (1u << log2_size) - 1u;
  const int max_off = __ldg(max_off_p);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nq;
       i += stride) {
    long long lo = 0, c = 0;
    if (qvalid == nullptr || qvalid[i]) {
      const long long x = q[i];
      const uint32_t h = slot_hash(x, log2_size);
      for (int t = 0; t <= max_off; ++t) {
        // slot = {key lo32, key hi32, first position, run length}
        const int4 s = __ldg(table + ((h + (uint32_t)t) & mask));
        if (s.w == 0) break;  // empty: the key is absent
        const long long key =
            (long long)(((unsigned long long)(uint32_t)s.y << 32) | (uint32_t)s.x);
        if (key == x) {
          lo = s.z;
          c = s.w;
          break;
        }
      }
    }
    lo_out[i] = lo;
    cnt_out[i] = c;
  }
}

}  // namespace

extern "C" int hash_build_launch(const void* keys, int n, int log2_size,
                                 void* table, void* claim, void* off,
                                 void* meta, void* stream) {
  if (n < 0 || log2_size < 1 || log2_size > 31)
    return (int)cudaErrorInvalidValue;
  static int max_blocks = 0;  // co-resident blocks, as a cooperative launch needs
  const int threads = 256;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_build_kernel,
                                                        threads, 0);
    if (e != cudaSuccess) return (int)e;
    max_blocks = sms * per_sm;
  }
  const long long work = n > (1ll << log2_size) ? n : (1ll << log2_size);
  long long blocks = (work + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  const long long* k = (const long long*)keys;
  int4* t = (int4*)table;
  int* c = (int*)claim;
  int* o = (int*)off;
  int* m = (int*)meta;
  void* args[] = {(void*)&k, (void*)&n, (void*)&log2_size, (void*)&t,
                  (void*)&c, (void*)&o, (void*)&m};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)hash_build_kernel,
                                              dim3((unsigned)blocks), dim3(threads),
                                              args, 0, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int hash_probe_launch(const void* table, int log2_size,
                                 const void* max_off, const void* q,
                                 const void* qvalid, void* lo_out,
                                 void* cnt_out, int64_t nq, void* stream) {
  if (nq <= 0) return 0;
  if (log2_size < 1 || log2_size > 31) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int64_t blocks = (nq + threads - 1) / threads;
  if (blocks > 1048576) blocks = 1048576;  // grid-stride covers the rest
  hash_probe_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int4*)table, log2_size, (const int*)max_off, (const long long*)q,
      (const uint8_t*)qvalid, (long long*)lo_out, (long long*)cnt_out, nq);
  return (int)cudaGetLastError();
}
