// segment_reduce: the masked grouped segment aggregate, one fused launch,
// written for Hopper.
//
// Replaces the TPU kernel _seg_reduce_kernel_for / _seg_reduce_pallas in
// tpu_cypher/backend/tpu/pallas/aggregate.py, and the torch passes that
// _segment_aggregate_pallas runs around it. One launch computes, for k <= 256
// groups, what jit_ops.segment_aggregate computes for its kernel-eligible
// aggregates (count, int64 sum, min/max over int64, int32 string codes,
// bool and float64):
//   cnt[g]   the valid rows of group g (the count, and out_valid = cnt > 0);
//   nan[g]   the valid NaN rows of group g (float64 only);
//   acc[g]   the sum, min or max over the rows of group g, where a null or
//            NaN row takes the value `fill` (the torch.where(valid, d, big)
//            of the plain version) and a group no row reaches keeps `ident`.
// A row whose segment lies outside [0, k) takes no part. Without segment
// ids (a global aggregate, k = 1) every row is in group 0.
//
// Each row is read once, in its own type: int64, int32 or float64 values,
// bool bytes, the validity bytes (or none), int32 or int64 segment ids (or
// none). Float64 min/max run on each value's order-preserving int64 key
// (the bit pattern with all but the sign bit flipped for negative values),
// under which -0.0 < 0.0, so min gives -0.0 and max 0.0 when both occur, in
// any row order, as the JAX reference does. Integer sums wrap as int64
// does; min, max and the counts do not depend on the order of the rows, so
// the result is bit-identical to the plain version.
//
// Bound on the H100: memory. Per row, the value (8 B for int64 and float64,
// 4 B for string codes, 1 B for bool, none for a count), 1 B of validity
// where there is a mask, 4 or 8 B of segment id where there are ids. A
// global int64 min without mask or ids is 8 B a row: 0.047 ms for the
// 19,853,591 rows of the 2-hop aggregate at 3.35 TB/s.
// Design:
// - 4-row chunks, each stream read with one 16-byte load (4 bytes for the
//   bool and validity bytes) where the pointers allow; kUnroll chunks a
//   thread loaded before it folds any; a grid of as many blocks as the SMs
//   hold at once (the occupancy query, cached per device);
// - at k = 1 a register accumulator per thread, warp shuffles, one shared
//   step; at k > 1 a run accumulator per thread, flushed when the segment
//   changes into per-warp shared partials with shared atomics;
// - each block writes its partials [blocks][k] to a scratch buffer; the
//   last block to finish (a __threadfence and an atomic ticket, which it
//   resets) folds them with the whole block (blockDim / k threads a group,
//   kFoldLoads loads in flight each; one block per SM at k > 1 keeps the
//   partials few), applies the NaN rules (an all-NaN group's min is NaN;
//   any NaN makes the max NaN) and writes the outputs in their own type.
//   No second launch, no memset.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 256;
constexpr int kUnroll = 2;
constexpr int kRowsPerStep = kThreads * 4 * kUnroll;
// at k > 1 the last block folds k x blocks partials: one block per SM
constexpr int kGroupedBlocksPerSM = 1;
constexpr int kFoldLoads = 8;  // partial loads in flight per thread in the fold
constexpr int kMaxBlocksPerSM = 2048 / kThreads;
constexpr int kMaxDevices = 64;
constexpr long long kNaNBits = 0x7FF8000000000000LL;  // the canonical NaN

enum Op { kCount = 0, kSum = 1, kMin = 2, kMax = 3 };
enum VType { kNone = 0, kI32 = 1, kI64 = 2, kF64 = 3, kU8 = 4 };
enum SType { kSegNone = 0, kSeg32 = 1, kSeg64 = 2 };

struct Acc {
  long long acc;  // the sum, or the min/max over int64 values or f64 keys
  int cnt;        // valid rows
  int nan;        // valid NaN rows
};

__device__ __forceinline__ long long f64_key(double x) {
  long long b = __double_as_longlong(x);
  return b < 0 ? (b ^ 0x7FFFFFFFFFFFFFFFLL) : b;
}

__device__ __forceinline__ long long f64_from_key(long long k) {
  return k < 0 ? (k ^ 0x7FFFFFFFFFFFFFFFLL) : k;  // the bits of the double
}

template <int OP>
__device__ __forceinline__ long long fold(long long a, long long b) {
  if (OP == kSum) return (long long)((unsigned long long)a + (unsigned long long)b);
  if (OP == kMin) return b < a ? b : a;
  if (OP == kMax) return b > a ? b : a;
  return a;
}

template <int OP>
__device__ __forceinline__ void merge(Acc& a, const Acc& b) {
  a.acc = fold<OP>(a.acc, b.acc);
  a.cnt += b.cnt;
  a.nan += b.nan;
}

// One row of the group: `live` its validity, `x` its value (or key), `xnan`
// whether the value is NaN.
template <int OP, int VT>
__device__ __forceinline__ void fold_row(Acc& a, bool live, long long x, bool xnan,
                                         long long fill) {
  const bool nan = VT == kF64 && live && xnan;
  a.cnt += live;
  if (VT == kF64) a.nan += nan;
  if (OP != kCount) a.acc = fold<OP>(a.acc, live && !nan ? x : fill);
}

template <int VT>
__device__ __forceinline__ long long load_val(const void* v, int64_t i, bool& nan) {
  nan = false;
  if (VT == kI64) return __ldg((const long long*)v + i);
  if (VT == kI32) return __ldg((const int*)v + i);
  if (VT == kU8) return __ldg((const unsigned char*)v + i) != 0;
  if (VT == kF64) {
    const double d = __ldg((const double*)v + i);
    nan = d != d;
    return f64_key(d);
  }
  return 0;
}

// The four rows of chunk c, one or two 16-byte loads (4 bytes for bool).
template <int VT>
__device__ __forceinline__ void load_vals4(const void* v, int64_t c, long long (&x)[4],
                                           bool (&nan)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) nan[r] = false;
  if (VT == kI64) {
    const longlong2 a = __ldg((const longlong2*)v + 2 * c);
    const longlong2 b = __ldg((const longlong2*)v + 2 * c + 1);
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else if (VT == kF64) {
    const double2 a = __ldg((const double2*)v + 2 * c);
    const double2 b = __ldg((const double2*)v + 2 * c + 1);
    const double d[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      nan[r] = d[r] != d[r];
      x[r] = f64_key(d[r]);
    }
  } else if (VT == kI32) {
    const int4 a = __ldg((const int4*)v + c);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if (VT == kU8) {
    const uchar4 a = __ldg((const uchar4*)v + c);
    x[0] = a.x != 0; x[1] = a.y != 0; x[2] = a.z != 0; x[3] = a.w != 0;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = 0;
  }
}

__device__ __forceinline__ void load_seg4(const void* s, int st, int64_t c, long long (&g)[4]) {
  if (st == kSeg32) {
    const int4 a = __ldg((const int4*)s + c);
    g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
  } else if (st == kSeg64) {
    const longlong2 a = __ldg((const longlong2*)s + 2 * c);
    const longlong2 b = __ldg((const longlong2*)s + 2 * c + 1);
    g[0] = a.x; g[1] = a.y; g[2] = b.x; g[3] = b.y;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) g[r] = 0;
  }
}

__device__ __forceinline__ long long load_seg(const void* s, int st, int64_t i) {
  if (st == kSeg32) return __ldg((const int*)s + i);
  if (st == kSeg64) return __ldg((const long long*)s + i);
  return 0;
}

template <bool GROUPED>
struct Shared {
  Acc warp[kWarps];
  Acc fin[kThreads];
  bool last;
};

template <>
struct Shared<true> {
  long long wacc[kWarps][kMaxGroups];  // per-warp partials, so a hot group
  int wcnt[kWarps][kMaxGroups];        // contends within one warp only
  int wnan[kWarps][kMaxGroups];
  Acc fin[kThreads];
  bool last;
};

template <int OP, int VT>
__device__ __forceinline__ void flush(Shared<true>& sh, int w, int g, const Acc& a) {
  if (a.cnt) atomicAdd(&sh.wcnt[w][g], a.cnt);
  if (VT == kF64 && a.nan) atomicAdd(&sh.wnan[w][g], a.nan);
  if (OP == kSum) {
    atomicAdd((unsigned long long*)&sh.wacc[w][g], (unsigned long long)a.acc);
  } else if (OP == kMin) {
    atomicMin(&sh.wacc[w][g], a.acc);
  } else if (OP == kMax) {
    atomicMax(&sh.wacc[w][g], a.acc);
  }
}

// The thread's state over its rows: at k = 1 one accumulator; at k > 1 the
// accumulator of the current run of one segment.
template <int OP, int VT, bool GROUPED>
struct Folder {
  Acc a;
  int cur;
  long long ident;

  __device__ __forceinline__ void row(Shared<GROUPED>& sh, int k, long long g, bool live,
                                      long long x, bool xnan, long long fill) {
    if ((unsigned long long)g >= (unsigned long long)k) return;  // dead lane
    if constexpr (GROUPED) {
      if ((int)g != cur) {
        if (cur >= 0) flush<OP, VT>(sh, threadIdx.x >> 5, cur, a);
        cur = (int)g;
        a = Acc{ident, 0, 0};
      }
    }
    fold_row<OP, VT>(a, live, x, xnan, fill);
  }
};

template <int OP>
__device__ __forceinline__ Acc warp_merge(Acc a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc b;
    b.acc = __shfl_down_sync(0xffffffffu, a.acc, off);
    b.cnt = __shfl_down_sync(0xffffffffu, a.cnt, off);
    b.nan = __shfl_down_sync(0xffffffffu, a.nan, off);
    merge<OP>(a, b);
  }
  return a;
}

__device__ __forceinline__ Acc load_partial(const Acc* p) {
  // written by other blocks: read through L2, past this SM's L1
  return Acc{__ldcg(&p->acc), __ldcg(&p->cnt), __ldcg(&p->nan)};
}

template <int OP, int VT>
__device__ __forceinline__ void write_out(int j, const Acc& a, void* out, bool* out_valid) {
  if (OP == kCount) {
    ((long long*)out)[j] = a.cnt;
    return;
  }
  if (OP == kSum) {
    ((long long*)out)[j] = a.acc;
    return;
  }
  out_valid[j] = a.cnt > 0;
  if (VT == kI64) {
    ((long long*)out)[j] = a.acc;
  } else if (VT == kI32) {
    ((int*)out)[j] = (int)a.acc;
  } else if (VT == kU8) {
    ((bool*)out)[j] = a.acc != 0;
  } else if (VT == kF64) {
    const bool nan_out = OP == kMin ? (a.nan > 0 && a.cnt == a.nan) : a.nan > 0;
    ((long long*)out)[j] = nan_out ? kNaNBits : f64_from_key(a.acc);
  }
}

template <int OP, int VT, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
seg_agg(const void* __restrict__ vals, const uint8_t* __restrict__ valid,
        const void* __restrict__ seg, int st, int64_t n, int k, long long ident,
        long long fill, bool aligned, void* __restrict__ out,
        bool* __restrict__ out_valid, Acc* __restrict__ part,
        unsigned* __restrict__ ticket) {
  __shared__ Shared<GROUPED> sh;
  if constexpr (GROUPED) {
    for (int i = threadIdx.x; i < kWarps * k; i += kThreads) {
      sh.wacc[i / k][i % k] = ident;
      sh.wcnt[i / k][i % k] = 0;
      sh.wnan[i / k][i % k] = 0;
    }
    __syncthreads();
  }
  Folder<OP, VT, GROUPED> f{Acc{ident, 0, 0}, -1, ident};
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t nchunks = aligned ? n / 4 : 0;
  for (int64_t base = tid; base < nchunks; base += stride * kUnroll) {
    long long x[kUnroll][4], g[kUnroll][4];
    bool xnan[kUnroll][4];
    uchar4 m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int64_t c = base + u * stride;
      if (c >= nchunks) c = nchunks - 1;  // a repeated load, not folded
      load_vals4<VT>(vals, c, x[u], xnan[u]);
      load_seg4(seg, st, c, g[u]);
      m[u] = valid ? __ldg((const uchar4*)valid + c) : make_uchar4(1, 1, 1, 1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * stride >= nchunks) break;
      f.row(sh, k, g[u][0], m[u].x != 0, x[u][0], xnan[u][0], fill);
      f.row(sh, k, g[u][1], m[u].y != 0, x[u][1], xnan[u][1], fill);
      f.row(sh, k, g[u][2], m[u].z != 0, x[u][2], xnan[u][2], fill);
      f.row(sh, k, g[u][3], m[u].w != 0, x[u][3], xnan[u][3], fill);
    }
  }
  for (int64_t i = nchunks * 4 + tid; i < n; i += stride) {
    bool xnan;
    const long long x = load_val<VT>(vals, i, xnan);
    f.row(sh, k, load_seg(seg, st, i), valid ? valid[i] != 0 : true, x, xnan, fill);
  }

  // this block's partials, block-major: part[block * k + j]
  if constexpr (GROUPED) {
    if (f.cur >= 0) flush<OP, VT>(sh, threadIdx.x >> 5, f.cur, f.a);
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += kThreads) {
      Acc a{sh.wacc[0][j], sh.wcnt[0][j], sh.wnan[0][j]};
      for (int w = 1; w < kWarps; ++w) merge<OP>(a, Acc{sh.wacc[w][j], sh.wcnt[w][j], sh.wnan[w][j]});
      part[(int64_t)blockIdx.x * k + j] = a;
    }
  } else {
    const Acc a = warp_merge<OP>(f.a);
    if ((threadIdx.x & 31) == 0) sh.warp[threadIdx.x >> 5] = a;
    __syncthreads();
    if (threadIdx.x == 0) {
      Acc b = sh.warp[0];
      for (int w = 1; w < kWarps; ++w) merge<OP>(b, sh.warp[w]);
      part[blockIdx.x] = b;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sh.last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();

  // the last block: G threads fold each group's partials, then a tree
  const int nb = gridDim.x;
  int G = kThreads;
  while (G * k > kThreads) G >>= 1;
  const int j = threadIdx.x / G, sub = threadIdx.x % G;
  Acc a{ident, 0, 0};
  if (j < k) {
    int b = sub;
    for (; b + (kFoldLoads - 1) * G < nb; b += kFoldLoads * G) {
      Acc x[kFoldLoads];
#pragma unroll
      for (int u = 0; u < kFoldLoads; ++u) x[u] = load_partial(part + (int64_t)(b + u * G) * k + j);
#pragma unroll
      for (int u = 0; u < kFoldLoads; ++u) merge<OP>(a, x[u]);
    }
    for (; b < nb; b += G) merge<OP>(a, load_partial(part + (int64_t)b * k + j));
  }
  sh.fin[threadIdx.x] = a;
  for (int s = G / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (sub < s && j < k) merge<OP>(sh.fin[threadIdx.x], sh.fin[threadIdx.x + s]);
  }
  __syncthreads();
  if (sub == 0 && j < k) write_out<OP, VT>(j, sh.fin[threadIdx.x], out, out_valid);
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next launch
}

int sm_count(int dev) {
  static int cached[kMaxDevices];
  if (!cached[dev]) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

bool aligned_to(const void* p, uintptr_t a) { return ((uintptr_t)p % a) == 0; }

template <int OP, int VT, bool GROUPED>
int launch(const void* vals, const void* valid, const void* seg, int st, int64_t n, int k,
           long long ident, long long fill, void* out, void* out_valid, void* scratch,
           cudaStream_t s) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int occ[kMaxDevices];  // blocks per SM, per device and instantiation
  if (!occ[dev]) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[dev], seg_agg<OP, VT, GROUPED>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_sm = GROUPED ? (occ[dev] < kGroupedBlocksPerSM ? occ[dev] : kGroupedBlocksPerSM)
                             : occ[dev];
  const int64_t cap = (int64_t)sm_count(dev) * (per_sm > 0 ? per_sm : 1);
  const int64_t want = (n + kRowsPerStep - 1) / kRowsPerStep;
  const int grid = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  const uintptr_t va = VT == kU8 ? 4 : 16;
  const bool aligned = (VT == kNone || aligned_to(vals, va)) && (st == kSegNone || aligned_to(seg, 16)) &&
                       (valid == nullptr || aligned_to(valid, 4));
  unsigned* ticket = (unsigned*)scratch;
  Acc* part = (Acc*)((char*)scratch + 16);
  seg_agg<OP, VT, GROUPED><<<grid, kThreads, 0, s>>>(
      vals, (const uint8_t*)valid, seg, st, n, k, ident, fill, aligned, out,
      (bool*)out_valid, part, ticket);
  return (int)cudaGetLastError();
}

template <int OP, int VT>
int launch_k(const void* vals, const void* valid, const void* seg, int st, int64_t n, int k,
             long long ident, long long fill, void* out, void* out_valid, void* scratch,
             cudaStream_t s) {
  if (k > 1)
    return launch<OP, VT, true>(vals, valid, seg, st, n, k, ident, fill, out, out_valid, scratch, s);
  return launch<OP, VT, false>(vals, valid, seg, st, n, k, ident, fill, out, out_valid, scratch, s);
}

template <int OP>
int launch_minmax(int vtype, const void* vals, const void* valid, const void* seg, int st,
                  int64_t n, int k, long long ident, long long fill, void* out,
                  void* out_valid, void* scratch, cudaStream_t s) {
  switch (vtype) {
    case kI32: return launch_k<OP, kI32>(vals, valid, seg, st, n, k, ident, fill, out, out_valid, scratch, s);
    case kI64: return launch_k<OP, kI64>(vals, valid, seg, st, n, k, ident, fill, out, out_valid, scratch, s);
    case kF64: return launch_k<OP, kF64>(vals, valid, seg, st, n, k, ident, fill, out, out_valid, scratch, s);
    case kU8: return launch_k<OP, kU8>(vals, valid, seg, st, n, k, ident, fill, out, out_valid, scratch, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of the scratch buffer a launch on `device` needs: the ticket, then
// the largest grid's partials. The caller zeroes it once; the kernel leaves
// the ticket at zero.
extern "C" long long segment_reduce_scratch_bytes(int device) {
  if (device < 0 || device >= kMaxDevices) return -1;
  const int per_sm = kMaxGroups * kGroupedBlocksPerSM > kMaxBlocksPerSM
                         ? kMaxGroups * kGroupedBlocksPerSM : kMaxBlocksPerSM;
  return 16 + (long long)sizeof(Acc) * sm_count(device) * per_sm;
}

// vals: the value column (vtype kI32/kI64/kF64/kU8; unread for a count);
// valid: validity bytes or null; seg: segment ids (stype kSeg32/kSeg64) or
// null; ident/fill: int64 values, or float64 order keys; out: k values of
// the output type (int64 for count and sum, else the value type; bool for
// kU8); out_valid: k bools (min/max) or null.
extern "C" int segment_reduce_launch(const void* vals, int vtype, const void* valid,
                                     const void* seg, int stype, int64_t n, int k, int op,
                                     long long ident, long long fill, void* out,
                                     void* out_valid, void* scratch, void* stream) {
  if (k <= 0 || k > kMaxGroups || n < 0 || n >= (1LL << 31) || stype < kSegNone ||
      stype > kSeg64 || (stype != kSegNone) != (seg != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kCount:
      return launch_k<kCount, kNone>(nullptr, valid, seg, stype, n, k, 0, 0, out, nullptr, scratch, s);
    case kSum:
      if (vtype != kI64) return (int)cudaErrorInvalidValue;  // float sums reorder
      return launch_k<kSum, kI64>(vals, valid, seg, stype, n, k, ident, fill, out, nullptr, scratch, s);
    case kMin:
      if (out_valid == nullptr) return (int)cudaErrorInvalidValue;
      return launch_minmax<kMin>(vtype, vals, valid, seg, stype, n, k, ident, fill, out, out_valid, scratch, s);
    case kMax:
      if (out_valid == nullptr) return (int)cudaErrorInvalidValue;
      return launch_minmax<kMax>(vtype, vals, valid, seg, stype, n, k, ident, fill, out, out_valid, scratch, s);
  }
  return (int)cudaErrorInvalidValue;
}
