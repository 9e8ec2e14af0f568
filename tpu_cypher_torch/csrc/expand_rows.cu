// expand_rows: the CSR expand materialize, the row search and its tail in
// one launch, written for Hopper.
//
// Replaces the TPU kernel _expand_rows_kernel / _expand_rows_pallas in
// tpu_cypher/backend/tpu/pallas/expand.py, and the torch passes around it
// (the frontier state before it, the casts, pad sanitizing and gathers of
// jit_ops.finish_expand_counted after it). For a frontier of F rows with
// int64 degrees deg (absent rows 0), L = min(nvalid, size) live lanes and
// `size` lanes in all, it writes, for every lane l:
//     l <  L:  row  = searchsorted(cum, l, side='right') - 1, clamped to
//                     [0, F-1], where cum is deg's int32 cumsum with a
//                     leading 0
//              edge = starts[row] + l - cum[row]   (int32 arithmetic),
//                     starts = row_ptr[pos]
//              nbr  = int64(ci[edge]), orig = eo[edge], live = true
//     l >= L:  row = nbr = orig = 0, live = false (ci and eo not read)
// which is what jit_ops.expand_materialize_counted, the plain version,
// gives bit for bit. Without eo (the count tiers throw orig away) no orig
// is read or written.
//
// Bound on the H100: memory. Per lane it writes int64 row, nbr and orig and
// the live byte (25 B, 17 B without orig) and reads int32 ci and int64 eo
// for a live lane (12 B, 4 B without orig); per frontier row it reads pos,
// deg and row_ptr[pos] (20 B). At Q5's second hop (F = 449,972,
// 19,853,591 lanes) that is 0.74 GB, 0.22 ms at 3.35 TB/s. Tensor cores
// have no role in an integer search and gather.
//
// Design, two launches:
// 1. expand_state_kernel (F-sized): starts = row_ptr[pos], the int32
//    inclusive scan of deg into cum, and the merge-path partition points.
//    One pass: a fixed number of blocks, each taking a block id from an
//    atomic ticket and one chunk of rows, with a decoupled look-back over
//    the earlier chunks' flags in a scratch buffer kept per (device,
//    stream); the last block to finish zeroes the flags and tickets for
//    the next launch. Each row r then writes the partition of every tile
//    boundary that falls between its row start and the next one.
// 2. expand_rows_kernel: the lanes merged with the row starts (moderngpu's
//    load-balancing search). Tile t takes kTileItems merge items (lanes
//    plus row starts), so a run of absent, zero-degree rows consumes items
//    and never overflows the tile's window, and a hub row spans tiles. The
//    block stages its window of cum and starts in shared memory (coalesced
//    loads); each thread takes two lanes at an even lane index, finds the
//    first one's row by a binary search in shared memory and the second's
//    by a walk, gathers ci and eo (neighbouring lanes walk one row's edges,
//    so the gathers are nearly sequential) and stores the int64 outputs as
//    16-byte pairs. So a lane's row search runs in shared memory over at
//    most kTileItems + 1 entries, and the block's only searches in device
//    memory are its two partition points. The blocks past the last tile
//    zero the pad lanes the same way.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileItems = 2048;  // merge items a block of the row kernel takes
constexpr int kPadLanes = 4096;   // pad lanes a block zeroes
constexpr int kMaxStateBlocks = 1024;

// look-back flag word: the status in bits 32-33 over the uint32 value
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

struct StateScratch {
  unsigned int ticket;  // the next block id
  unsigned int done;    // blocks finished
  unsigned long long pad;
  unsigned long long flag[kMaxStateBlocks];
};

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Inclusive scan over the block (wrapping uint32); `total` gets its sum.
__device__ uint32_t block_inclusive(uint32_t x, uint32_t* s_warp, uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_inclusive(x);
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? s_warp[lane] : 0u;
    w = warp_inclusive(w);
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += s_warp[warp - 1];
  total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is reused by the next call
  return x;
}

__global__ void __launch_bounds__(kThreads)
expand_state_kernel(const int32_t* __restrict__ rp, const int64_t* __restrict__ pos,
                    const int64_t* __restrict__ deg, int64_t nrows, int64_t chunk,
                    int64_t live, int64_t ntiles, int32_t* __restrict__ starts,
                    int32_t* __restrict__ cum, int32_t* __restrict__ parts,
                    StateScratch* sc) {
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_block, s_excl;
  __shared__ bool s_last;
  if (threadIdx.x == 0) s_block = atomicAdd(&sc->ticket, 1u);
  __syncthreads();
  const uint32_t b = s_block;
  const int64_t r0 = (int64_t)b * chunk;
  const int64_t r1 = r0 + chunk < nrows ? r0 + chunk : nrows;

  // the chunk's degree sum
  uint32_t acc = 0;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += kThreads) acc += (uint32_t)deg[r];
  uint32_t agg;
  block_inclusive(acc, s_warp, agg);

  // decoupled look-back: every earlier block has taken its ticket already,
  // so it runs or has run, and publishes its aggregate without waiting
  if (threadIdx.x == 0) {
    uint32_t excl = 0;
    if (b == 0) {
      atomicExch(&sc->flag[0], kPrefix | agg);
    } else {
      atomicExch(&sc->flag[b], kAggregate | agg);
      for (int64_t j = (int64_t)b - 1; j >= 0; --j) {
        unsigned long long f;
        do {
          f = *(volatile unsigned long long*)&sc->flag[j];
        } while ((f >> 32) == 0);
        excl += (uint32_t)f;
        if ((f >> 32) == (kPrefix >> 32)) break;
      }
      atomicExch(&sc->flag[b], kPrefix | (uint32_t)(excl + agg));
    }
    s_excl = excl;
  }
  __syncthreads();

  // the chunk's scan, starts, and the partition points: tile boundary
  // k * kTileItems lies between the merge positions m(r) < d <= m(r + 1) of
  // row starts r and r + 1, where m(r) = min(cum[r], live) + r, so
  // parts[k] = r + 1 row starts precede it; past the last row start every
  // boundary up to the end of the merge (live + nrows) has parts = nrows
  if (b == 0 && threadIdx.x == 0) {
    cum[0] = 0;
    parts[0] = 0;
  }
  uint32_t carry = s_excl;
  for (int64_t base = r0; base < r1; base += kThreads) {
    const int64_t r = base + threadIdx.x;
    const uint32_t d = r < r1 ? (uint32_t)deg[r] : 0u;
    uint32_t tile_sum;
    const uint32_t incl = block_inclusive(d, s_warp, tile_sum);
    if (r < r1) {
      const uint32_t hi = carry + incl;  // cum[r + 1]
      const uint32_t lo = hi - d;        // cum[r]
      cum[r + 1] = (int32_t)hi;
      starts[r] = __ldg(rp + pos[r]);
      const int64_t m_lo = ((int64_t)lo < live ? (int64_t)lo : live) + r;
      int64_t k_end;
      if (r + 1 < nrows) {
        const int64_t m_hi = ((int64_t)hi < live ? (int64_t)hi : live) + r + 1;
        k_end = m_hi / kTileItems;
      } else {
        k_end = ntiles;
      }
      for (int64_t k = m_lo / kTileItems + 1; k <= k_end; ++k) parts[k] = (int32_t)(r + 1);
    }
    carry += tile_sum;
  }

  // the last block to finish leaves the scratch zeroed for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(&sc->done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    for (unsigned j = threadIdx.x; j < gridDim.x; j += kThreads) sc->flag[j] = 0;
    if (threadIdx.x == 0) {
      sc->ticket = 0;
      sc->done = 0;
    }
  }
}

struct Outputs {
  int64_t* row;
  int64_t* nbr;
  int64_t* orig;  // null without orig
  bool* live;
};

// Store lanes 2p and 2p + 1 where each lies in [lo, hi): one 16-byte store
// per int64 output when both do, scalar stores at a range's ragged ends.
__device__ __forceinline__ void store_pair(const Outputs& o, int64_t p, int64_t lo,
                                           int64_t hi, const int64_t (&row)[2],
                                           const int64_t (&nbr)[2],
                                           const int64_t (&orig)[2], bool alive) {
  const int64_t i0 = 2 * p;
  if (i0 >= lo && i0 + 1 < hi) {
    reinterpret_cast<longlong2*>(o.row)[p] = make_longlong2(row[0], row[1]);
    reinterpret_cast<longlong2*>(o.nbr)[p] = make_longlong2(nbr[0], nbr[1]);
    if (o.orig) reinterpret_cast<longlong2*>(o.orig)[p] = make_longlong2(orig[0], orig[1]);
    reinterpret_cast<uint16_t*>(o.live)[p] = alive ? 0x0101 : 0;
    return;
  }
  for (int h = 0; h < 2; ++h) {
    const int64_t i = i0 + h;
    if (i < lo || i >= hi) continue;
    o.row[i] = row[h];
    o.nbr[i] = nbr[h];
    if (o.orig) o.orig[i] = orig[h];
    o.live[i] = alive;
  }
}

__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const int32_t* __restrict__ cum, const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ parts, int64_t nrows, int64_t live,
                   int64_t ntiles, int64_t size, const int32_t* __restrict__ ci,
                   const int64_t* __restrict__ eo, Outputs o) {
  __shared__ int32_t s_cum[kTileItems + 1];
  __shared__ int32_t s_starts[kTileItems + 1];
  const int64_t tile = blockIdx.x;
  if (tile >= ntiles) {  // pad lanes
    const int64_t lo = live + (tile - ntiles) * kPadLanes;
    const int64_t hi = lo + kPadLanes < size ? lo + kPadLanes : size;
    const int64_t zero[2] = {0, 0};
    for (int64_t p = (lo >> 1) + threadIdx.x; 2 * p < hi; p += kThreads)
      store_pair(o, p, lo, hi, zero, zero, zero, false);
    return;
  }
  const int64_t items = live + nrows;
  const int64_t d0 = tile * kTileItems;
  const int64_t d1 = d0 + kTileItems < items ? d0 + kTileItems : items;
  const int64_t b0 = parts[tile], b1 = parts[tile + 1];
  const int64_t a0 = d0 - b0, a1 = d1 - b1;  // the tile's lanes
  const int nb = (int)(b1 - b0);             // the tile's row starts
  // the window: rows b0 - 1 .. b1 - 1 (row -1 is never read: lane 0
  // follows row start 0 in the merge)
  for (int t = threadIdx.x; t <= nb; t += kThreads) {
    const int64_t r = b0 - 1 + t;
    if (r >= 0) {
      s_cum[t] = __ldg(cum + r);
      s_starts[t] = __ldg(starts + r);
    }
  }
  __syncthreads();
  for (int64_t p = (a0 >> 1) + threadIdx.x; 2 * p < a1; p += kThreads) {
    int64_t row[2] = {0, 0}, nbr[2] = {0, 0}, orig[2] = {0, 0};
    int t = -1;
    for (int h = 0; h < 2; ++h) {
      const int64_t i = 2 * p + h;
      if (i < a0 || i >= a1) continue;
      const int32_t lane = (int32_t)i;
      if (t < 0) {  // window rows whose start is <= lane: s_cum[1..nb]
        int lo = 1, hi = nb + 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_cum[mid] <= lane) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        t = lo - 1;
      } else {
        while (t < nb && s_cum[t + 1] <= lane) ++t;
      }
      row[h] = b0 - 1 + t;
      const int32_t e = (int32_t)((uint32_t)s_starts[t] + (uint32_t)lane - (uint32_t)s_cum[t]);
      nbr[h] = (int64_t)__ldg(ci + e);
      if (eo) orig[h] = __ldg(eo + e);
    }
    store_pair(o, p, a0, a1, row, nbr, orig, true);
  }
}

}  // namespace

// Bytes of the scratch buffer a launch needs on `device`: the tickets and
// one look-back flag per state block. The caller zeroes it once, per
// (device, stream); the state kernel leaves it zeroed.
extern "C" long long expand_rows_scratch_bytes(int device) {
  (void)device;
  return (long long)sizeof(StateScratch);
}

// The state launch: starts, cum and the ntiles + 1 partition points of a
// merge of `live` lanes with `nrows` row starts in tiles of `tile_items`
// (which must equal the kernel's).
extern "C" int expand_state_launch(const void* rp, const void* pos, const void* deg,
                                   int64_t nrows, int64_t live, int64_t ntiles,
                                   int64_t tile_items, void* starts, void* cum,
                                   void* parts, void* scratch, void* stream) {
  if (tile_items != kTileItems || nrows <= 0 || live <= 0) return (int)cudaErrorInvalidValue;
  if (ntiles != (live + nrows + kTileItems - 1) / kTileItems) return (int)cudaErrorInvalidValue;
  int64_t chunk = (nrows + kMaxStateBlocks - 1) / kMaxStateBlocks;
  chunk = (chunk + kThreads - 1) / kThreads * kThreads;
  const int64_t blocks = (nrows + chunk - 1) / chunk;
  expand_state_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rp, (const int64_t*)pos, (const int64_t*)deg, nrows, chunk, live,
      ntiles, (int32_t*)starts, (int32_t*)cum, (int32_t*)parts, (StateScratch*)scratch);
  return (int)cudaGetLastError();
}

// The row launch: all `size` lanes, the first `live` of them live (ntiles
// tiles of the merge, then the pad lanes). eo and orig may be null together.
extern "C" int expand_rows_launch(const void* cum, const void* starts, const void* parts,
                                  int64_t nrows, int64_t live, int64_t ntiles,
                                  int64_t tile_items, int64_t size, const void* ci,
                                  const void* eo, void* row, void* nbr, void* orig,
                                  void* live_out, void* stream) {
  if (tile_items != kTileItems || live < 0 || live > size || (eo == nullptr) != (orig == nullptr))
    return (int)cudaErrorInvalidValue;
  if (size <= 0) return 0;
  const int64_t blocks = ntiles + (size - live + kPadLanes - 1) / kPadLanes;
  const Outputs o{(int64_t*)row, (int64_t*)nbr, (int64_t*)orig, (bool*)live_out};
  expand_rows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cum, (const int32_t*)starts, (const int32_t*)parts, nrows, live,
      ntiles, size, (const int32_t*)ci, (const int64_t*)eo, o);
  return (int)cudaGetLastError();
}
