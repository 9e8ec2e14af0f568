// hash_probe: the equi-join's hash table, built and probed on Hopper.
//
// Replaces the TPU kernel _probe_kernel / _hash_probe_pallas in
// tpu_cypher/backend/tpu/pallas/join.py, and the jnp build that feeds it
// (_hash_build). Two kernels, each reading the join's keys at their own
// width (bool/uint8, int8, int32, int64 or float64):
//
// hash_build_kernel places every unique key of the valid build side in a
// table of `size` = 2^log2_size slots, each
//     {int32 key lo32, int32 key hi32, int32 first sorted position,
//      int32 run length}
// (16 bytes, run length 0 = empty), followed by one more 16-byte row whose
// first int32 is the probe bound: the largest offset from its hash slot at
// which any key sits. Lane i < n reads its key as rd[order[i]] (the valid
// build rows in join_build's sorted order, so equal keys are contiguous),
// sign-extends an int8 or int32 key to int64 (a bool or uint8 key
// zero-extends) and takes a float64 key as the bits of x + 0.0, so -0.0
// and 0.0 are one key. A lane whose key differs from its predecessor's
// starts a run; it finds the run's end (a gallop, then a binary search),
// walks linearly from its hash slot and claims the first slot whose run
// length it turns from 0 to its own with atomicCAS, then writes the slot's
// key and first position and folds its offset into the bound with
// atomicMax. Run starts are unique keys, so no key is compared during the
// build and a claimed slot is never read back in the same launch. The
// launcher zeroes the table and the bound with one cudaMemsetAsync on the
// call's stream first: one memset and one ordinary launch, no grid
// barrier. Which of two colliding keys wins the nearer slot depends on
// which CAS lands first, so the table is not hash_build's slot for slot;
// what the probe reads is the same (hopper/join.py table_invariants).
//
// hash_probe_kernel, for every probe lane i < nq:
//     counts[i] = valid(i) ? the run length of q[i] in the build, else 0
//     lo[i]     = counts[i] > 0 ? the first sorted build position of q[i] : 0
// and *total = sum of counts, which is jit_ops.join_probe's contract (two
// searchsorted calls over the sorted build keys, lo zeroed where the count
// is 0, and their sum). valid(i) is the AND of up to two validity masks,
// and for a float64 key also "not NaN". A lane walks at most bound + 1
// slots from its hash slot and stops at its key or at an empty slot.
//
// The TPU kernel splits each int64 key into (lo32, hi32) int32 planes for
// Mosaic's lane width, keeps the four table vectors VMEM-resident (so the
// build is capped at 2^17 keys) and unrolls a fixed 16-step probe. Here a
// key compares as one int64, a slot is one 16-byte load, and the table
// stays in device memory (2^18 slots, 4 MiB, for Q11's 100,000-row build:
// inside the 50 MB L2), so no build size is declined.
//
// Bound on the H100: memory. A probe lane reads its key at its own width
// (1, 4 or 8 B) and a byte per mask, and writes 8 B lo and 8 B count; the
// table is read once. The build reads 8 B of order and the key per valid
// row and writes the table once. The hash is two multiplies, an xor and a
// shift, and a probe step about ten int32 operations, so at the load
// factor <= 1/2 the table keeps, the operations take a small fraction of
// the bytes' time (chip_smoke.py counts both).
// Design of the probe: one launch, grid-stride over lane pairs. A thread
// takes pair j (lanes 2j, 2j+1) and reads its two keys as one load of
// twice the key's width (16 B for int64 and float64 keys, 8 B for int32, 2
// B for 1-byte keys) and each mask as one 2-byte load, so each load of a
// warp, and each of its two 16-byte stores of lo and counts, covers one
// contiguous span. The key and mask loads carry the streaming hint
// (__ldcs) and the stores are streaming (__stcs): the probe stream is
// evict-first in L2 and does not push the table out. The next pair's loads
// go out before the current pair's two table reads (16-byte __ldg,
// L2-resident). Each thread sums its counts; a warp shuffle and one
// shared-memory step give a block partial, and the last block to finish (a
// __threadfence and an atomic ticket, which it resets) folds the partials
// and writes the int64 total, so no second launch reads the counts again.
// The grid is one wave of the blocks the SMs hold at once: a block's
// ticket is a round trip to L2 that holds its SM slot, which many short
// blocks would pay many times. A misaligned input (a view at an odd
// offset) takes the one-lane path for every lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerSM = 2048 / kThreads;
constexpr int kMaxDevices = 64;

// key type codes, as hopper/join.py passes them
enum { kU8 = 1, kI8 = 2, kI32 = 3, kI64 = 4, kF64 = 5 };

template <int KT> struct KeyOf;
template <> struct KeyOf<kU8> { using T = unsigned char; };
template <> struct KeyOf<kI8> { using T = signed char; };
template <> struct KeyOf<kI32> { using T = int; };
template <> struct KeyOf<kI64> { using T = long long; };
template <> struct KeyOf<kF64> { using T = double; };

// a key as the table holds it: integers widened as .to(torch.int64) does,
// a float64 as the bits of x + 0.0
template <int KT>
__device__ __forceinline__ long long as_key(typename KeyOf<KT>::T x) {
  if constexpr (KT == kF64) {
    return __double_as_longlong(__dadd_rn(x, 0.0));
  } else {
    return (long long)x;
  }
}

template <int KT>
__device__ __forceinline__ bool key_ok(typename KeyOf<KT>::T x) {
  if constexpr (KT == kF64) {
    return !isnan(x);
  } else {
    return true;
  }
}

// the reference's multiplicative mix of the key's two 32-bit halves
__device__ __forceinline__ uint32_t slot_hash(long long key, int log2_size) {
  const uint32_t lo = (uint32_t)((unsigned long long)key & 0xffffffffull);
  const uint32_t hi = (uint32_t)((unsigned long long)key >> 32);
  const uint32_t u = lo * 2654435761u ^ hi * 2246822519u;
  return u >> (32 - log2_size);
}

template <int KT>
__device__ __forceinline__ long long build_key(const typename KeyOf<KT>::T* __restrict__ rd,
                                               const long long* __restrict__ order,
                                               long long i) {
  return as_key<KT>(__ldg(rd + __ldg(order + i)));
}

// one past the last lane of the run of key k that starts at lane i: a
// gallop, then a binary search, on equality (runs are contiguous)
template <int KT>
__device__ int run_end(const typename KeyOf<KT>::T* __restrict__ rd,
                       const long long* __restrict__ order, long long k, int i, int n) {
  long long lo = i, hi = (long long)i + 1, step = 1;
  while (hi < n && build_key<KT>(rd, order, hi) == k) {
    lo = hi;
    step <<= 1;
    hi = (long long)i + step;
  }
  if (hi > n) hi = n;
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (build_key<KT>(rd, order, mid) == k) lo = mid; else hi = mid;
  }
  return (int)hi;
}

template <int KT>
__global__ void __launch_bounds__(kThreads)
hash_build_kernel(const typename KeyOf<KT>::T* __restrict__ rd,
                  const long long* __restrict__ order, int n, int log2_size,
                  int4* table, int* bound) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long k = build_key<KT>(rd, order, i);
  if (i > 0 && build_key<KT>(rd, order, i - 1) == k) return;  // inside a run
  const int first = (int)i;
  const int run = run_end<KT>(rd, order, k, first, n) - first;
  const uint32_t mask = (1u << log2_size) - 1u;
  const uint32_t h = slot_hash(k, log2_size);
  // the table has a slot for every unique key, so the walk ends
  for (uint32_t off = 0;; ++off) {
    int4* slot = table + ((h + off) & mask);
    if (atomicCAS(&slot->w, 0, run) == 0) {
      const unsigned long long u = (unsigned long long)k;
      slot->x = (int)(uint32_t)(u & 0xffffffffull);
      slot->y = (int)(uint32_t)(u >> 32);
      slot->z = first;
      if (off) atomicMax(bound, (int)off);
      return;
    }
  }
}

__device__ __forceinline__ long long slot_key(int4 s) {
  return (long long)(((unsigned long long)(uint32_t)s.y << 32) | (uint32_t)s.x);
}

// one lane's walk, its first slot already loaded: (lo, count) of key x
__device__ __forceinline__ void walk(const int4* __restrict__ table, uint32_t mask,
                                     int max_off, uint32_t h, int4 s, long long x,
                                     long long& lo, long long& c) {
  for (int off = 0;;) {
    if (s.w == 0) return;  // empty: the key is absent
    if (slot_key(s) == x) {
      lo = s.z;
      c = s.w;
      return;
    }
    if (++off > max_off) return;
    s = __ldg(table + ((h + (uint32_t)off) & mask));
  }
}

__device__ __forceinline__ void and_mask(const uint8_t* __restrict__ m, int64_t j,
                                         bool (&v)[2]) {
  if (m == nullptr) return;
  const uchar2 a = __ldcs((const uchar2*)m + j);
  v[0] = v[0] && a.x != 0;
  v[1] = v[1] && a.y != 0;
}

// the two keys of pair j (lanes 2j, 2j+1), as one load of twice the key's
// width, and their validity: the key type's own rule and up to two masks
template <int KT>
__device__ __forceinline__ void load_pair(const typename KeyOf<KT>::T* __restrict__ q,
                                          const uint8_t* __restrict__ m1,
                                          const uint8_t* __restrict__ m2, int64_t j,
                                          long long (&x)[2], bool (&v)[2]) {
  v[0] = v[1] = true;
  if constexpr (KT == kI64) {
    const longlong2 a = __ldcs((const longlong2*)q + j);
    x[0] = a.x; x[1] = a.y;
  } else if constexpr (KT == kF64) {
    const double2 a = __ldcs((const double2*)q + j);
    x[0] = as_key<kF64>(a.x); x[1] = as_key<kF64>(a.y);
    v[0] = key_ok<kF64>(a.x); v[1] = key_ok<kF64>(a.y);
  } else if constexpr (KT == kI32) {
    const int2 a = __ldcs((const int2*)q + j);
    x[0] = a.x; x[1] = a.y;
  } else if constexpr (KT == kI8) {
    const char2 a = __ldcs((const char2*)q + j);
    x[0] = (signed char)a.x; x[1] = (signed char)a.y;
  } else {
    const uchar2 a = __ldcs((const uchar2*)q + j);
    x[0] = a.x; x[1] = a.y;
  }
  and_mask(m1, j, v);
  and_mask(m2, j, v);
}

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

template <int KT>
__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(const int4* __restrict__ table, int log2_size,
                  const typename KeyOf<KT>::T* __restrict__ q,
                  const uint8_t* __restrict__ m1, const uint8_t* __restrict__ m2,
                  int64_t nq, bool aligned, long long* __restrict__ lo_out,
                  long long* __restrict__ cnt_out, long long* __restrict__ part,
                  unsigned* __restrict__ ticket, long long* __restrict__ total) {
  const uint32_t size = 1u << log2_size, mask = size - 1u;
  const int max_off = __ldg((const int*)(table + size));  // the bound row
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t npairs = aligned ? nq / 2 : 0;
  long long acc = 0;
  long long x[2] = {0, 0};
  bool v[2] = {false, false};
  if (tid < npairs) load_pair<KT>(q, m1, m2, tid, x, v);
  for (int64_t j = tid; j < npairs; j += stride) {
    // the next pair's loads go out before this pair's table reads
    long long xn[2] = {0, 0}, lo[2] = {0, 0}, c[2] = {0, 0};
    bool vn[2] = {false, false};
    if (j + stride < npairs) load_pair<KT>(q, m1, m2, j + stride, xn, vn);
    uint32_t h[2];
    int4 s[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      h[u] = slot_hash(x[u], log2_size);
      s[u] = v[u] ? __ldg(table + h[u]) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      walk(table, mask, max_off, h[u], s[u], x[u], lo[u], c[u]);
      acc += c[u];
    }
    __stcs((longlong2*)lo_out + j, make_longlong2(lo[0], lo[1]));
    __stcs((longlong2*)cnt_out + j, make_longlong2(c[0], c[1]));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      x[u] = xn[u];
      v[u] = vn[u];
    }
  }
  for (int64_t i = npairs * 2 + tid; i < nq; i += stride) {
    const typename KeyOf<KT>::T raw = q[i];
    const bool ok = key_ok<KT>(raw) && (m1 == nullptr || m1[i]) && (m2 == nullptr || m2[i]);
    const long long key = as_key<KT>(raw);
    long long lo = 0, c = 0;
    if (ok) {
      const uint32_t h = slot_hash(key, log2_size);
      walk(table, mask, max_off, h, __ldg(table + h), key, lo, c);
    }
    lo_out[i] = lo;
    cnt_out[i] = c;
    acc += c;
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
  long long sum = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) sum += __ldcg(part + b);
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    *total = sum;
    *ticket = 0;  // ready for the next launch
  }
}

int sm_count(int dev) {
  static int cached[kMaxDevices];
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

bool aligned_to(const void* p, uintptr_t a) { return p == nullptr || (uintptr_t)p % a == 0; }

template <int KT>
void build(const void* rd, const void* order, int n, int log2_size, int4* table,
           cudaStream_t s) {
  const unsigned blocks = (unsigned)(((long long)n + kThreads - 1) / kThreads);
  hash_build_kernel<KT><<<blocks, kThreads, 0, s>>>(
      (const typename KeyOf<KT>::T*)rd, (const long long*)order, n, log2_size, table,
      (int*)(table + (1u << log2_size)));
}

template <int KT>
int probe(int dev, const void* table, int log2_size, const void* q, const void* m1,
          const void* m2, int64_t nq, void* lo_out, void* cnt_out, void* total, void* scratch,
          cudaStream_t s) {
  static int occ[kMaxDevices];  // resident blocks per SM, per device
  if (!occ[dev]) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ[dev], hash_probe_kernel<KT>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
  }
  // one wave of blocks that stay: each block's ticket and fold run once
  // (a block's ticket is a round trip to L2 that holds its SM slot)
  const int64_t cap = (int64_t)sm_count(dev) * (occ[dev] > 0 ? occ[dev] : 1);
  const int64_t want = (nq + 2 * kThreads - 1) / (2 * kThreads);
  const int grid = (int)(want < cap ? want : cap);
  // a pair's keys and masks as one load each, its outputs as 16-byte stores
  const bool aligned = aligned_to(q, 2 * sizeof(typename KeyOf<KT>::T)) &&
                       aligned_to(m1, 2) && aligned_to(m2, 2) &&
                       aligned_to(lo_out, 16) && aligned_to(cnt_out, 16);
  hash_probe_kernel<KT><<<grid, kThreads, 0, s>>>(
      (const int4*)table, log2_size, (const typename KeyOf<KT>::T*)q, (const uint8_t*)m1,
      (const uint8_t*)m2, nq, aligned, (long long*)lo_out, (long long*)cnt_out,
      (long long*)((char*)scratch + 16), (unsigned*)scratch, (long long*)total);
  return (int)cudaGetLastError();
}

}  // namespace

// rd: the build keys (ktype), order: int64 sorted positions, the first n
// of them valid; table: (2^log2_size + 1) 16-byte rows, zeroed here, the
// last row's first int32 receiving the probe bound.
extern "C" int hash_build_launch(const void* rd, int ktype, const void* order, int n,
                                 int log2_size, void* table, void* stream) {
  if (n < 0 || log2_size < 1 || log2_size > 31 || (n > 0 && (1ll << log2_size) < n))
    return (int)cudaErrorInvalidValue;
  if (ktype < kU8 || ktype > kF64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int4* t = (int4*)table;
  cudaError_t e = cudaMemsetAsync(t, 0, ((size_t)1 << log2_size) * 16 + 16, s);
  if (e != cudaSuccess || n == 0) return (int)e;
  switch (ktype) {
    case kU8: build<kU8>(rd, order, n, log2_size, t, s); break;
    case kI8: build<kI8>(rd, order, n, log2_size, t, s); break;
    case kI32: build<kI32>(rd, order, n, log2_size, t, s); break;
    case kI64: build<kI64>(rd, order, n, log2_size, t, s); break;
    case kF64: build<kF64>(rd, order, n, log2_size, t, s); break;
  }
  return (int)cudaGetLastError();
}

// Bytes of the scratch buffer a probe on `device` needs: the ticket, then
// one partial per block of the largest grid. The caller zeroes it once;
// the kernel leaves the ticket at zero.
extern "C" long long hash_probe_scratch_bytes(int device) {
  if (device < 0 || device >= kMaxDevices) return -1;
  return 16 + 8LL * sm_count(device) * kMaxBlocksPerSM;
}

// table: hash_build_launch's; q: nq probe keys (qtype); m1, m2: validity
// bytes or null; lo_out, cnt_out: nq int64; total: one int64.
extern "C" int hash_probe_launch(const void* table, int log2_size, const void* q, int qtype,
                                 const void* m1, const void* m2, int64_t nq, void* lo_out,
                                 void* cnt_out, void* total, void* scratch, void* stream) {
  if (nq <= 0 || log2_size < 1 || log2_size > 31) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = (cudaStream_t)stream;
  switch (qtype) {
    case kU8: return probe<kU8>(dev, table, log2_size, q, m1, m2, nq, lo_out, cnt_out, total, scratch, s);
    case kI8: return probe<kI8>(dev, table, log2_size, q, m1, m2, nq, lo_out, cnt_out, total, scratch, s);
    case kI32: return probe<kI32>(dev, table, log2_size, q, m1, m2, nq, lo_out, cnt_out, total, scratch, s);
    case kI64: return probe<kI64>(dev, table, log2_size, q, m1, m2, nq, lo_out, cnt_out, total, scratch, s);
    case kF64: return probe<kF64>(dev, table, log2_size, q, m1, m2, nq, lo_out, cnt_out, total, scratch, s);
  }
  return (int)cudaErrorInvalidValue;
}
