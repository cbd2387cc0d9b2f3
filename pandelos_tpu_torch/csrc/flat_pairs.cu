// Flat pair list fill for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package fills its flat pair list with
// XLA ops (a scatter-max of each row's id at its base, then a running
// maximum; pandelos_tpu/ops/candidate.py, _flatten_join_program).  The
// port did the same with torch.cummax, whose CUDA scan of a 1-D tensor
// runs in one block on one SM.  This kernel writes what that formulation
// writes, bit for bit:
//
//     slot p < total:   pi[p] = gf[r],  pj[p] = cf[r * K + (p - base[r])]
//     total <= p < pair_cap:  pi[p] = pj[p] = G
//
// where cs is the inclusive int64 prefix sum of the capped row counts,
// total = cs[R - 1], r the first row with cs[r] > p (its owner: rows of
// count 0 never own a slot) and base[r] = cs[r - 1] (0 for r = 0).
//
// What bounds it on this card: bytes.  It writes 8 bytes a slot and reads
// one int32 candidate a filled slot; each row's ids and bounds are read
// once a block and stay in L1.  So it is a load-balanced fill over
// slots, not over rows, and costs the same per slot whatever the row
// widths (a 128-slot row of the main list or a row of tens of thousands
// of candidates in a heavy chunk):
//
// - A block takes a fixed tile of kTile consecutive slots.  Its first
//   warp finds the rows that own the tile's first and last filled slot
//   by a 32-way search of cs (each round probes 32 positions and narrows
//   the range 32-fold).
// - The block stages those rows' bounds, relative to the tile's first
//   slot, as int32 in shared memory; each thread finds the owner of each
//   of its slots by a binary search there.  A tile whose owners number
//   more than kStage (runs of rows of count 0 between them) searches cs
//   in device memory instead: the same answer, more slowly.
// - A thread takes the slots tile + j * kThreads + threadIdx.x, so every
//   store of pi and pj is coalesced, and the candidates a warp reads lie
//   side by side within a row.  All of a thread's candidate loads are
//   issued before any store, so their latencies overlap.
// - No int64 array of pair_cap slots is written: only pi and pj.
//
// The caller allocates pi and pj; this file allocates nothing.  The one
// kernel runs on the caller's stream; the entry point returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // slots a thread
constexpr int kTile = kThreads * kItems;   // slots a block
constexpr int kStage = 2 * kTile;          // owner bounds a block stages
constexpr unsigned kFull = 0xffffffffu;

// The first i in [lo, hi) with cs[i] > x, or hi where there is none; cs
// ascending.  Called by a whole warp: each round probes 32 positions.
__device__ long long warp_upper_bound(const long long* __restrict__ cs,
                                      long long lo, long long hi,
                                      long long x) {
  const int lane = threadIdx.x & 31;
  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long at = lo + lane * step;
    const bool live = at < hi;
    const unsigned gt = __ballot_sync(kFull, live && cs[at] > x);
    if (gt == 0) {
      // every probe is <= x: past the last one
      const unsigned probed = __ballot_sync(kFull, live);
      lo += (long long)(31 - __clz((int)probed)) * step + 1;
    } else {
      const int f = __ffs((int)gt) - 1;
      if (f == 0) return lo;
      hi = lo + f * step;
      lo += (long long)(f - 1) * step + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
flat_pairs_kernel(const int* __restrict__ gf, const int* __restrict__ cf,
                  long long K, const long long* __restrict__ cs, long long R,
                  long long pair_cap, int G, int* __restrict__ pi,
                  int* __restrict__ pj) {
  __shared__ int rel[kStage];  // min(cs[r0 + i] - p0, kTile)
  __shared__ long long head[4];
  const long long p0 = (long long)blockIdx.x * kTile;
  if (threadIdx.x < 32) {
    const long long total = R > 0 ? cs[R - 1] : 0;
    long long r0 = 0, n = 0, base0 = 0;
    if (p0 < total) {
      long long last = p0 + kTile - 1;
      if (last > pair_cap - 1) last = pair_cap - 1;
      if (last > total - 1) last = total - 1;
      r0 = warp_upper_bound(cs, 0, R, p0);
      n = warp_upper_bound(cs, r0, R, last) - r0 + 1;
      base0 = r0 > 0 ? cs[r0 - 1] : 0;
    }
    if (threadIdx.x == 0) {
      head[0] = r0;
      head[1] = n;
      head[2] = base0;
      head[3] = total;
    }
  }
  __syncthreads();
  const long long r0 = head[0], n = head[1], base0 = head[2];
  const long long total = head[3];
  const bool staged = n <= kStage;  // the same in every thread
  if (staged) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const long long d = cs[r0 + i] - p0;
      rel[i] = (int)(d < kTile ? d : kTile);
    }
    __syncthreads();
  }

  long long off[kItems];  // the slot's candidate, -1 for a padding slot
  int a[kItems];
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    const int q = j * kThreads + threadIdx.x;
    const long long p = p0 + q;
    off[j] = -1;
    a[j] = G;
    if (p < total && p < pair_cap) {
      // the owner r0 + lo: the first row of the tile's with cs > p
      long long lo = 0, hi = n - 1;
      long long base;
      if (staged) {
        while (lo < hi) {
          const long long mid = (lo + hi) >> 1;
          if (rel[mid] > q) hi = mid; else lo = mid + 1;
        }
        base = lo > 0 ? p0 + rel[lo - 1] : base0;
      } else {
        while (lo < hi) {
          const long long mid = (lo + hi) >> 1;
          if (cs[r0 + mid] > p) hi = mid; else lo = mid + 1;
        }
        base = lo > 0 ? cs[r0 + lo - 1] : base0;
      }
      const long long r = r0 + lo;
      a[j] = gf[r];
      off[j] = r * K + (p - base);
    }
  }
  int b[kItems];
#pragma unroll
  for (int j = 0; j < kItems; j++) b[j] = off[j] >= 0 ? cf[off[j]] : G;
#pragma unroll
  for (int j = 0; j < kItems; j++) {
    const long long p = p0 + j * kThreads + threadIdx.x;
    if (p < pair_cap) {
      pi[p] = a[j];
      pj[p] = b[j];
    }
  }
}

}  // namespace

// gf [R] int32 row gene ids, cf [R, K] int32 candidates, cs [R] int64 the
// inclusive prefix sum of the capped counts; writes pi, pj [pair_cap].
extern "C" int pt_flat_pairs(const int* gf, const int* cf, long long K,
                             const long long* cs, long long R,
                             long long pair_cap, int G, int* pi, int* pj,
                             void* stream) {
  if (pair_cap <= 0) return 0;
  const long long blocks = (pair_cap + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flat_pairs_kernel<<<(unsigned int)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(gf, cf, K, cs, R, pair_cap, G,
                                              pi, pj);
  return (int)cudaGetLastError();
}
