// lane2 exact profile join for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pandelos_tpu/ops/lane_join.py:416
// (_make_lane2_kernel, driven by lane2_join_core).  For each candidate
// pair p = (a, b) it computes the reference's integer counters
// (library.cpp:475-477) over the k-mer ids the two genes share:
//
//     inter[p] = sum min(ca, cb)    perc[p] = sum ca    tr[p] = sum cb
//
// Table layout (built by ops/lane_join.py::pack_lane_device_core): one row of
// D*128 int32 per gene; id v (< 2^23) lives in lane v & 127 at the depth
// of its rank within that lane, packed as v << 8 | count (count < 256);
// an empty slot is -256.  Equal ids are therefore lane-aligned.
//
// What bounds it on this card.  Its floor is the larger of its bytes
// (each table row that a pair names, read once up to its depth, plus the
// pair indices and the three outputs) at 3.35 TB/s and its
// dg[a] * dg[b] * 128 compare-and-add steps at the CUDA cores' rate; at
// the main path's shapes the compare work sets that floor.  What holds
// the kernel is instruction throughput: its rate in lane steps per second is
// the same whether the rows come from L1, L2 or HBM, and its phase
// timers (-DPT_PROFILE) put four fifths of a warp's time in the compare
// loops (PERF.md holds the numbers of probe_joins.py and chip_smoke.py).
// So the design spends as few instructions per lane step as it can and
// keeps memory out of their way:
//
// - One warp joins a chunk of 32 consecutive pair slots; each thread
//   owns 4 adjacent lanes (16 bytes of every depth row), so no thread
//   reads another's table data.
// - The a row (its first kBufA depths) stays in the warp's shared memory
//   while consecutive pairs name the same a: the engine's pair list names
//   one a for a run of pairs.  Any list stays right; one whose a changes
//   at every pair is just no faster.
// - The first kStageB depths of each b row are brought into a ring in
//   shared memory one pair ahead of the compute.  A row is contiguous,
//   so each copy is one bulk asynchronous copy (cp.async.bulk) started by
//   one lane and reported to an mbarrier that the warp waits on: no lane
//   spends address arithmetic or load instructions on it.  Depths past
//   kBufA / kStageB are read straight from the table.
// - The loops are interchanged: a tile of up to 4 a depths sits in
//   registers and each b slot row is read once per tile, two rows a
//   step.  Depth counts that are no multiple of the tile take a smaller
//   tile (1..3 depths), an odd b depth a single-row step: no padding work.
// - The step is a multiply-add and a three-way unsigned minimum for two
//   lane steps.  Ids are distinct within a gene, so an a slot x matches
//   at most one b slot y of its lane.  With nx = -(x & ~255), y + nx is
//   y's count (< 256) when the ids are equal and at least 256 as an
//   unsigned number otherwise (a larger id leaves a multiple of 256, a
//   smaller one or an empty -256 wraps high; an empty x has nx = 256;
//   two empty slots give 0, a match with both counts 0).  So
//   m = min over the b rows of (y + nx), and one accounting per a slot
//   after the b loop: if m < 256, cb = m and ca = x & 255.  The add is
//   written y * one + nx with one = 1 passed at launch, so that it
//   compiles to IMAD and runs on the FMA pipe beside the integer pipe
//   that takes the minimum.
// - Counters are int32 (exact), reduced across the warp with redux and
//   stored, one coalesced store per chunk, as f32 (every counter is
//   < 2^24, so the conversion is exact).

// phase timers of a -DPT_PROFILE build (hopper_async.cuh):
// cycles per phase, summed over warps: 0 pair set-up, 1 a row, 2 prefetch
// request, 3 wait for the b row, 4 compare and account, 5 reduce
#include "hopper_async.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 32;    // pair slots per warp
constexpr int kBufA = 8;      // a depths kept in shared memory
constexpr int kStageB = 8;    // b depths staged per pair
constexpr int kStages = 2;    // ring stages per warp
constexpr int kRowInt4 = 32;  // one depth row: 128 int32 = 32 int4
constexpr int kRowBytes = kRowInt4 * (int)sizeof(int4);
// per warp: the a rows, the ring, and one 16-byte cell per mbarrier
constexpr int kWarpInt4 = (kBufA + kStages * kStageB) * kRowInt4 + kStages + 1;
constexpr int kSmemBytes = kWarpsPerBlock * kWarpInt4 * (int)sizeof(int4);
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned diff(int y, int nx, int one) {
  return (unsigned)y * (unsigned)one + (unsigned)nx;
}

// m = min(m, y0 + nx, y1 + nx) over TA a depths x 4 lanes
template <int TA>
__device__ __forceinline__ void step2(const int4 (&nx)[TA], uint4 (&m)[TA],
                                      const int4 y0, const int4 y1, int one) {
#pragma unroll
  for (int d = 0; d < TA; ++d) {
    m[d].x = __vimin3_u32(m[d].x, diff(y0.x, nx[d].x, one), diff(y1.x, nx[d].x, one));
    m[d].y = __vimin3_u32(m[d].y, diff(y0.y, nx[d].y, one), diff(y1.y, nx[d].y, one));
    m[d].z = __vimin3_u32(m[d].z, diff(y0.z, nx[d].z, one), diff(y1.z, nx[d].z, one));
    m[d].w = __vimin3_u32(m[d].w, diff(y0.w, nx[d].w, one), diff(y1.w, nx[d].w, one));
  }
}
template <int TA>
__device__ __forceinline__ void step1(const int4 (&nx)[TA], uint4 (&m)[TA],
                                      const int4 y, int one) {
#pragma unroll
  for (int d = 0; d < TA; ++d) {
    m[d].x = min(m[d].x, diff(y.x, nx[d].x, one));
    m[d].y = min(m[d].y, diff(y.y, nx[d].y, one));
    m[d].z = min(m[d].z, diff(y.z, nx[d].z, one));
    m[d].w = min(m[d].w, diff(y.w, nx[d].w, one));
  }
}

__device__ __forceinline__ void account(const int x, const unsigned m, int one,
                                        int& inter, int& perc, int& tr) {
  if (m < 256u) {
    const int ca = x & 255;
    const int cb = (int)m;
    inter += min(ca, cb) * one;
    perc += ca * one;
    tr += cb * one;
  }
}

// The a depths [a0, a0 + TA) against one b row: b depths [0, n_staged)
// from this thread's column of the ring stage `sb`, [n_staged, Db) from
// the table (`gb`).  a depths below kBufA come from shared memory (`sa`),
// deeper ones from the table (`ga`).
template <int TA>
__device__ __forceinline__ void join_tile(const int4* sa, const int4* ga, int a0,
                                          const int4* sb, int n_staged,
                                          const int4* gb, int Db, int one,
                                          int& inter, int& perc, int& tr) {
  int4 x[TA], nx[TA];
  uint4 m[TA];
#pragma unroll
  for (int d = 0; d < TA; ++d) {
    x[d] = a0 + d < kBufA ? sa[(a0 + d) * kRowInt4]
                          : __ldg(ga + (a0 + d) * kRowInt4);
    nx[d] = make_int4(-(x[d].x & ~255), -(x[d].y & ~255), -(x[d].z & ~255),
                      -(x[d].w & ~255));
    m[d] = make_uint4(~0u, ~0u, ~0u, ~0u);
  }
  int db = 0;
#pragma unroll 2
  for (; db + 1 < n_staged; db += 2)
    step2<TA>(nx, m, sb[db * kRowInt4], sb[(db + 1) * kRowInt4], one);
  if (db < n_staged) step1<TA>(nx, m, sb[db * kRowInt4], one);
  for (db = n_staged; db + 1 < Db; db += 2)
    step2<TA>(nx, m, __ldg(gb + db * kRowInt4), __ldg(gb + (db + 1) * kRowInt4),
              one);
  if (db < Db) step1<TA>(nx, m, __ldg(gb + db * kRowInt4), one);
#pragma unroll
  for (int d = 0; d < TA; ++d) {
    account(x[d].x, m[d].x, one, inter, perc, tr);
    account(x[d].y, m[d].y, one, inter, perc, tr);
    account(x[d].z, m[d].z, one, inter, perc, tr);
    account(x[d].w, m[d].w, one, inter, perc, tr);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32, 2)
lane2_join_kernel(const int* __restrict__ table, long long stride,
                  const int* __restrict__ dg, const int* __restrict__ a_idx,
                  const int* __restrict__ b_idx, long long n_pairs, int one,
                  float* __restrict__ inter_out, float* __restrict__ perc_out,
                  float* __restrict__ tr_out) {
  extern __shared__ int4 smem[];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p0 =
      ((long long)blockIdx.x * kWarpsPerBlock + warp) * kChunk;
  if (p0 >= n_pairs) return;  // whole warps exit together
  const int n = (int)min((long long)kChunk, n_pairs - p0);
  int4* buf_a = smem + warp * kWarpInt4;         // a depths [0, kBufA)
  int4* ring = buf_a + kBufA * kRowInt4;         // kStages x kStageB b depths
  int4* bars = ring + kStages * kStageB * kRowInt4;  // ring stages, then a
  if (t == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // lane l holds pair p0 + l: its genes, their depths and, at the end,
  // its counters
  int a_l = 0, b_l = 0, da_l = 0, db_l = 0;
  if (t < n) {
    a_l = __ldg(a_idx + p0 + t);
    b_l = __ldg(b_idx + p0 + t);
    da_l = __ldg(dg + a_l);
    db_l = __ldg(dg + b_l);
  }
  int inter_l = 0, perc_l = 0, tr_l = 0;
#ifdef PT_PROFILE
  long long prof_[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long last_ = clock64();
#endif

  // the staged part of pair i's b row, into stage i % kStages
  auto prefetch = [&](int i) {
    if (i < n) {
      const int b = __shfl_sync(kFull, b_l, i);
      const int nb = min(__shfl_sync(kFull, db_l, i), kStageB);
      if (t == 0) {
        const int st = i % kStages;
        mbar_expect_tx(bars + st, nb * kRowBytes);
        if (nb > 0)
          bulk_copy(ring + st * (kStageB * kRowInt4),
                    table + (long long)b * stride, nb * kRowBytes, bars + st);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) prefetch(i);

  int cur_a = -1, a_parity = 0;
  for (int i = 0; i < n; ++i) {
    const int a = __shfl_sync(kFull, a_l, i);
    const int b = __shfl_sync(kFull, b_l, i);
    const int Da = __shfl_sync(kFull, da_l, i);
    const int Db = __shfl_sync(kFull, db_l, i);
    const int4* ga =
        reinterpret_cast<const int4*>(table + (long long)a * stride) + t;
    const int4* gb =
        reinterpret_cast<const int4*>(table + (long long)b * stride) + t;
    PT_TICK(0)
    __syncwarp();  // every lane is done with the last pair's buffers
    if (a != cur_a) {
      const int na = min(Da, kBufA);
      if (t == 0) {
        mbar_expect_tx(bars + kStages, na * kRowBytes);
        if (na > 0)
          bulk_copy(buf_a, table + (long long)a * stride, na * kRowBytes,
                    bars + kStages);
      }
      mbar_wait(bars + kStages, a_parity);
      a_parity ^= 1;
      cur_a = a;
    }
    PT_TICK(1)
    prefetch(i + kStages - 1);
    PT_TICK(2)
    mbar_wait(bars + i % kStages, (i / kStages) & 1);
    PT_TICK(3)
    const int4* sa = buf_a + t;
    const int4* sb = ring + (i % kStages) * (kStageB * kRowInt4) + t;
    const int n_staged = min(Db, kStageB);
    int inter = 0, perc = 0, tr = 0;
    if (Db > 0) {
      int a0 = 0;
      for (; a0 + 4 <= Da; a0 += 4)
        join_tile<4>(sa, ga, a0, sb, n_staged, gb, Db, one, inter, perc, tr);
      switch (Da - a0) {
        case 1: join_tile<1>(sa, ga, a0, sb, n_staged, gb, Db, one, inter, perc, tr); break;
        case 2: join_tile<2>(sa, ga, a0, sb, n_staged, gb, Db, one, inter, perc, tr); break;
        case 3: join_tile<3>(sa, ga, a0, sb, n_staged, gb, Db, one, inter, perc, tr); break;
        default: break;
      }
    }
    PT_TICK(4)
    inter = __reduce_add_sync(kFull, inter);
    perc = __reduce_add_sync(kFull, perc);
    tr = __reduce_add_sync(kFull, tr);
    if (t == i) {
      inter_l = inter;
      perc_l = perc;
      tr_l = tr;
    }
    PT_TICK(5)
  }
#ifdef PT_PROFILE
  if (t == 0)
    for (int k = 0; k < 8; ++k)
      atomicAdd(&g_profile[k], (unsigned long long)prof_[k]);
#endif
  if (t < n) {
    inter_out[p0 + t] = (float)inter_l;
    perc_out[p0 + t] = (float)perc_l;
    tr_out[p0 + t] = (float)tr_l;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers, `table` 16-byte aligned; `stride` is the table's row length
// in int32 (D * 128).  Launches on `stream` and returns the first CUDA
// error of the attribute call or the launch (0 on success).
extern "C" int pt_lane2_join(const int* table, long long stride,
                             const int* dg, const int* a_idx,
                             const int* b_idx, long long n_pairs,
                             float* inter, float* perc, float* tr,
                             void* stream) {
  if (n_pairs <= 0) return 0;
  const long long per_block = (long long)kWarpsPerBlock * kChunk;
  const long long blocks = (n_pairs + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      lane2_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  lane2_join_kernel<<<(unsigned int)blocks, kWarpsPerBlock * 32, kSmemBytes,
                      (cudaStream_t)stream>>>(table, stride, dg, a_idx, b_idx,
                                              n_pairs, /*one=*/1, inter, perc,
                                              tr);
  return (int)cudaGetLastError();
}
