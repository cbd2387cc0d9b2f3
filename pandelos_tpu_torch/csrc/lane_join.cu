// lane exact profile join for NVIDIA Hopper (sm_90a): lane2's exact
// fallback for inputs that cannot pack (a k-mer count >= 256 or an id
// >= 2^23).
//
// Replaces the TPU kernel pandelos_tpu/ops/lane_join.py:235
// (_make_lane_kernel, driven by lane_join_core).  For each candidate
// pair p = (a, b) it computes the reference's integer counters
// (library.cpp:475-477) over the k-mer ids the two genes share:
//
//     inter[p] = sum min(ca, cb)    perc[p] = sum ca    tr[p] = sum cb
//
// Table layout (built by ops/lane_join.py::pack_lane_device_core with
// packed=False): one row of 2*D*128 int32 per gene, the ids of its
// [D, 128] lane grid then their counts; id v lives in lane v & 127 at the
// depth of its rank within that lane.  An empty slot has id -1 and count
// 0: it equals only another empty slot and adds 0 to every counter, so
// slots past a gene's own depth change nothing.  Equality is a plain
// id_a == id_b, so any id and any count work.
//
// Design.  lane2_join.cu's: one warp per pair, each thread owns 4
// adjacent lanes and reads them with one 16-byte load of ids and one of
// counts per depth row; the loop bounds are the pair's own per-gene
// depths dg[a] and dg[b], and rows are read by gene index.  The TPU
// kernel's banded window over b slots (per-slot id ranges, cross-lane
// min/max reductions per octet) and its gather-then-kernel split were
// TPU scheduling: they change no counter and are gone.  Counters are
// int32 (exact: a profile's total count is at most its length - k + 1,
// below 2^24), reduced across the warp with shuffles and stored as f32.
//
// What bounds it on this card.  Its floor is the larger of its bytes
// (each named row read once up to its depth, dg * 128 * 8 bytes, plus
// the pair indices and the three outputs) at 3.35 TB/s and its
// dg[a] * dg[b] * 128 compare-and-add steps at the CUDA cores' rate.  Like
// lane2 it reads both rows of every pair from memory, twice lane2's
// bytes per row (ids and counts apart), so its time follows the
// per-pair row traffic, (dg[a] + dg[b]) * 1024 bytes per pair; PERF.md
// holds the numbers from chip_smoke.py.  Reusing the a row across its
// run of pairs is the route to the floor, as for lane2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void join4(const int4 xi, const int4 xc,
                                      const int4 yi, const int4 yc,
                                      int& inter, int& perc, int& tr) {
  const int xis[4] = {xi.x, xi.y, xi.z, xi.w};
  const int xcs[4] = {xc.x, xc.y, xc.z, xc.w};
  const int yis[4] = {yi.x, yi.y, yi.z, yi.w};
  const int ycs[4] = {yc.x, yc.y, yc.z, yc.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (xis[q] == yis[q]) {
      inter += min(xcs[q], ycs[q]);
      perc += xcs[q];
      tr += ycs[q];
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lane_join_kernel(const int* __restrict__ table, long long stride,
                 const int* __restrict__ dg, const int* __restrict__ a_idx,
                 const int* __restrict__ b_idx, long long n_pairs,
                 float* __restrict__ inter_out, float* __restrict__ perc_out,
                 float* __restrict__ tr_out) {
  const long long p =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n_pairs) return;  // whole warps exit together
  const int t = threadIdx.x & 31;
  const int a = __ldg(a_idx + p);
  const int b = __ldg(b_idx + p);
  const int Da = __ldg(dg + a);
  const int Db = __ldg(dg + b);
  const long long half = stride / 2;  // D * 128: ids, then counts
  const int4* ra = reinterpret_cast<const int4*>(table + (long long)a * stride) + t;
  const int4* rb = reinterpret_cast<const int4*>(table + (long long)b * stride) + t;
  const long long ch = half / 4;  // the count half, in int4

  int inter = 0, perc = 0, tr = 0;
  for (int da = 0; da < Da; ++da) {
    const int4 xi = __ldg(ra + da * (kLane / 4));
    const int4 xc = __ldg(ra + ch + da * (kLane / 4));
    for (int db = 0; db < Db; ++db) {
      const int4 yi = __ldg(rb + db * (kLane / 4));
      const int4 yc = __ldg(rb + ch + db * (kLane / 4));
      join4(xi, xc, yi, yc, inter, perc, tr);
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
// pointers; `stride` is the table's row length in int32 (2 * D * 128).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int pt_lane_join(const int* table, long long stride,
                            const int* dg, const int* a_idx,
                            const int* b_idx, long long n_pairs,
                            float* inter, float* perc, float* tr,
                            void* stream) {
  if (n_pairs <= 0) return 0;
  const long long blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lane_join_kernel<<<(unsigned int)blocks, kWarpsPerBlock * 32, 0,
                     (cudaStream_t)stream>>>(table, stride, dg, a_idx, b_idx,
                                             n_pairs, inter, perc, tr);
  return (int)cudaGetLastError();
}
