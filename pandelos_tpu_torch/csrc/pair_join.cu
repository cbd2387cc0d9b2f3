// Sorted exact profile join for NVIDIA Hopper (sm_90a): join kernel
// "roll".
//
// Replaces the TPU kernel pandelos_tpu/ops/pallas_join.py:56
// (_make_kernel, driven by join_pairs_core), in both its banded and
// plain modes, which give the same counters.  For each candidate pair
// p = (a, b) it computes the reference's integer counters
// (library.cpp:475-477) over the k-mer ids the two genes share:
//
//     inter[p] = sum min(ca, cb)    perc[p] = sum ca    tr[p] = sum cb
//
// Table layout (ops/pair_join.py::pack_profiles): one row of 2W int32 per
// gene, the pad_profiles ids then their counts.  A row's ids are
// distinct and ascend; its entries are left-packed, so its width is the
// position of its first count-0 slot (padding ids are vocab_size, which
// no real id equals, but the join never reads past a row's width).
//
// Design.  The TPU kernel compared each a tile with the b tile rotated
// through all 128 lane alignments (pltpu.roll), banded by tile id
// ranges: a way to join two sorted lists with vector compares only.
// Here the natural form is a sorted search.  One warp per pair: every
// lane finds the two widths by a binary search on the count halves,
// then takes a-entries i = lane, lane + 32, ... and binary-searches each
// id in b's ids [lo, w_b).  A lane's a-ids ascend, so its lower bound
// only moves right and each search starts from the last one.  Counters
// are int32 (exact: a profile's total count is below 2^24), reduced
// across the warp with shuffles and stored as f32.
//
// What bounds it on this card.  Its floor is the larger of its bytes
// (each named row read once up to its width, w * 8 bytes, plus the pair
// indices and the three outputs) at 3.35 TB/s and its w_a + w_b merge
// steps per pair at the CUDA cores' rate; the bytes set it.  This
// version reads both rows of every pair: the per-pair row traffic,
// (w_a + w_b) * 8 bytes per pair, is what it moves from memory when no
// row is reused from cache, plus log2(w_b) dependent cached reads per
// a-entry.  PERF.md holds the numbers from chip_smoke.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

// number of leading entries with count > 0 (counts are left-packed)
__device__ __forceinline__ int row_width(const int* __restrict__ cnt, int W) {
  int lo = 0, hi = W;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cnt + mid) > 0) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pair_join_kernel(const int* __restrict__ table, long long W,
                 const int* __restrict__ a_idx, const int* __restrict__ b_idx,
                 long long n_pairs, float* __restrict__ inter_out,
                 float* __restrict__ perc_out, float* __restrict__ tr_out) {
  const long long p =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n_pairs) return;  // whole warps exit together
  const int t = threadIdx.x & 31;
  const int* ia = table + (long long)__ldg(a_idx + p) * 2 * W;
  const int* ib = table + (long long)__ldg(b_idx + p) * 2 * W;
  const int* ca = ia + W;
  const int* cb = ib + W;
  const int wa = row_width(ca, (int)W);
  const int wb = row_width(cb, (int)W);

  int inter = 0, perc = 0, tr = 0;
  int lo = 0;
  for (int i = t; i < wa; i += 32) {
    const int v = __ldg(ia + i);
    int hi = wb;
    while (lo < hi) {  // lower bound of v in ib[lo, wb)
      const int mid = (lo + hi) >> 1;
      if (__ldg(ib + mid) < v) lo = mid + 1; else hi = mid;
    }
    if (lo < wb && __ldg(ib + lo) == v) {
      const int x = __ldg(ca + i);
      const int y = __ldg(cb + lo);
      inter += min(x, y);
      perc += x;
      tr += y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    inter += __shfl_xor_sync(0xffffffffu, inter, off);
    perc += __shfl_xor_sync(0xffffffffu, perc, off);
    tr += __shfl_xor_sync(0xffffffffu, tr, off);
  }
  if (t == 0) {
    inter_out[p] = (float)inter;
    perc_out[p] = (float)perc;
    tr_out[p] = (float)tr;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers; `W` is the padded profile width (the table's row is 2W
// int32).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int pt_pair_join(const int* table, long long W, const int* a_idx,
                            const int* b_idx, long long n_pairs, float* inter,
                            float* perc, float* tr, void* stream) {
  if (n_pairs <= 0) return 0;
  const long long blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pair_join_kernel<<<(unsigned int)blocks, kWarpsPerBlock * 32, 0,
                     (cudaStream_t)stream>>>(table, W, a_idx, b_idx, n_pairs,
                                             inter, perc, tr);
  return (int)cudaGetLastError();
}
