// segment_reduce: the masked grouped segment reduce, written for Hopper.
//
// Replaces the TPU kernel _seg_reduce_kernel_for / _seg_reduce_pallas in
// tpu_cypher/backend/tpu/pallas/aggregate.py. It computes, for k <= 256
// groups, the sum, min or max of vals[i] over the rows i with seg[i] == g;
// rows whose segment is outside [0, k) (the -1 of a dead lane) take no
// part, and an empty group yields the identity the caller passes.
// Value types: int32 (counts, BOOL as 0/1, string codes), int64, float64.
//
// Ties between -0.0 and 0.0: float64 min/max run on each value's
// order-preserving int64 key (the bit pattern with all but the sign bit
// flipped for negative values), under which -0.0 < 0.0. So min returns
// -0.0 and max returns 0.0 when both occur, whatever the order of the
// rows, the same rule as the JAX reference and jit_ops.f64_order_keys.
// The map also lets float min/max use the native 64-bit atomics instead
// of a compare-and-swap loop. NaN never reaches the kernel: the driver
// counts NaN apart and replaces it by +-inf first.
//
// Bound on the H100: memory, 12 bytes read per row for int64 values (8 B
// value + 4 B segment id), 8 bytes for int32 values.
// Design: pass 1 gives each block k partials in shared memory (at most
// 2 KB). Each thread folds its grid-stride rows into a register and
// flushes it to the shared partial with a shared-memory atomic only when
// its segment changes, so a global aggregate (k = 1) costs one shared
// atomic per thread rather than one per row. The block writes its
// partials to [nblocks, k]; pass 2 (one block, one thread per group)
// folds them. Integer sums wrap mod 2^32 / 2^64 exactly as the TPU
// kernel's int32/int64 lanes do; all three ops are associative on these
// types, so the result does not depend on the order of the rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 256;

enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum DType { kI32 = 0, kI64 = 1, kF64 = 2 };

__device__ __forceinline__ long long f64_key(double x) {
  long long b = __double_as_longlong(x);
  return b < 0 ? (b ^ 0x7FFFFFFFFFFFFFFFLL) : b;
}

__device__ __forceinline__ double f64_from_key(long long k) {
  long long b = k < 0 ? (k ^ 0x7FFFFFFFFFFFFFFFLL) : k;
  return __longlong_as_double(b);
}

template <typename A, int OP>
__device__ __forceinline__ A combine(A a, A b) {
  if (OP == kSum) return a + b;
  if (OP == kMin) return b < a ? b : a;
  return b > a ? b : a;
}

template <int OP>
__device__ __forceinline__ void atomic_combine(int* p, int v) {
  if (OP == kSum) atomicAdd(p, v);
  else if (OP == kMin) atomicMin(p, v);
  else atomicMax(p, v);
}

template <int OP>
__device__ __forceinline__ void atomic_combine(long long* p, long long v) {
  if (OP == kSum)
    atomicAdd((unsigned long long*)p, (unsigned long long)v);
  else if (OP == kMin)
    atomicMin(p, v);
  else
    atomicMax(p, v);
}

// A: the accumulator type (int for int32 values, long long for int64
// values and for float64 keys); F64: values are doubles mapped to keys.
template <typename A, int OP, bool F64>
__global__ void seg_pass1(const void* __restrict__ vals,
                          const int32_t* __restrict__ seg, int64_t n, int k,
                          A ident, A* __restrict__ partials) {
  __shared__ A sh[kMaxGroups];
  for (int j = threadIdx.x; j < k; j += blockDim.x) sh[j] = ident;
  __syncthreads();
  A acc = ident;
  int cur = -1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = __ldg(seg + i);
    if (s < 0 || s >= k) continue;  // dead lane
    A v;
    if (F64) {
      v = (A)f64_key(__ldg((const double*)vals + i));
    } else {
      v = __ldg((const A*)vals + i);
    }
    if (s != cur) {
      if (cur >= 0) atomic_combine<OP>(&sh[cur], acc);
      cur = s;
      acc = ident;
    }
    acc = combine<A, OP>(acc, v);
  }
  if (cur >= 0) atomic_combine<OP>(&sh[cur], acc);
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    partials[(int64_t)blockIdx.x * k + j] = sh[j];
}

template <typename A, int OP, bool F64>
__global__ void seg_pass2(const A* __restrict__ partials, int nblocks, int k,
                          A ident, void* __restrict__ out) {
  const int j = threadIdx.x;
  if (j >= k) return;
  A acc = ident;
  for (int b = 0; b < nblocks; ++b)
    acc = combine<A, OP>(acc, partials[(int64_t)b * k + j]);
  if (F64) {
    ((double*)out)[j] = f64_from_key((long long)acc);
  } else {
    ((A*)out)[j] = acc;
  }
}

template <typename A, int OP, bool F64>
int run(const void* vals, const int32_t* seg, int64_t n, int k, A ident,
        void* partials, int nblocks, void* out, cudaStream_t s) {
  seg_pass1<A, OP, F64><<<nblocks, kThreads, 0, s>>>(vals, seg, n, k, ident,
                                                     (A*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_pass2<A, OP, F64><<<1, kMaxGroups, 0, s>>>((const A*)partials, nblocks,
                                                 k, ident, out);
  return (int)cudaGetLastError();
}

template <typename A, bool F64>
int run_op(int op, const void* vals, const int32_t* seg, int64_t n, int k,
           A ident, void* partials, int nblocks, void* out, cudaStream_t s) {
  switch (op) {
    case kSum: return run<A, kSum, F64>(vals, seg, n, k, ident, partials, nblocks, out, s);
    case kMin: return run<A, kMin, F64>(vals, seg, n, k, ident, partials, nblocks, out, s);
    case kMax: return run<A, kMax, F64>(vals, seg, n, k, ident, partials, nblocks, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int segment_reduce_max_groups() { return kMaxGroups; }

// ident_bits: the identity as an int64 — the value itself for the integer
// types, the order-preserving key for float64.
extern "C" int segment_reduce_launch(const void* vals, int dtype,
                                     const void* seg, int64_t n, int k,
                                     int op, long long ident_bits,
                                     void* partials, int nblocks, void* out,
                                     void* stream) {
  if (k <= 0 || k > kMaxGroups || nblocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* sg = (const int32_t*)seg;
  switch (dtype) {
    case kI32:
      return run_op<int, false>(op, vals, sg, n, k, (int)ident_bits, partials, nblocks, out, s);
    case kI64:
      return run_op<long long, false>(op, vals, sg, n, k, ident_bits, partials, nblocks, out, s);
    case kF64:
      if (op == kSum) return (int)cudaErrorInvalidValue;  // float sums reorder
      return run_op<long long, true>(op, vals, sg, n, k, ident_bits, partials, nblocks, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
