// lane exact profile join for NVIDIA Hopper (sm_90a): lane2's exact
// fallback for inputs that cannot pack (a k-mer count >= 256 or an id
// >= 2^23), and the cells path's join.
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
// 0.  Any id in [0, 2^31) and any count work; the kernel relies on the
// lane rule (the plain version does not).
//
// What bounds it on this card.  Its floor is the larger of its bytes
// (each named row read once up to its depth, dg * 128 * 8 bytes, plus
// the pair indices and the three outputs) at 3.35 TB/s and its
// dg[a] * dg[b] * 128 compare steps at the CUDA cores' rate.  The first
// version of this kernel (one warp a pair, every row from global memory,
// the b row dg[a] times over) was held by the traffic of those re-reads
// from L2 and, with its rows in L1, by instruction throughput at 7.5
// instructions a lane step.  This design reads a b row once per pair,
// moves only the half of it that the compare loop needs and spends 1.5
// instructions a lane step; what holds it now is no pipe and no memory
// rate but the work around the loops (a pair's set-up, its tiles'
// set-up and accounting, the counts fetched from the table) at the 16
// warps an SM that its shared memory allows, with a first-level cache
// small enough that more warps run slower (PERF.md holds the numbers of
// probe_joins.py and chip_smoke.py):
//
// - One warp joins a chunk of 32 consecutive pair slots; each thread
//   owns 4 adjacent lanes (16 bytes of every depth row).
// - The ids of the a row (its first kBufA depths) stay in the warp's
//   shared memory while consecutive pairs name the same a: the engine's
//   pair list names one a for a run of pairs.  They are negated there
//   once per run (see the step).  Any list stays right.
// - The ids of the first kStageB depths of each b row are brought into a
//   ring in shared memory one pair ahead of the compute, by one bulk
//   asynchronous copy (cp.async.bulk) that reports to an mbarrier.
//   Depths past kBufA / kStageB are read straight from the table.
// - A tile of up to 4 a depths sits in registers and each b id row is
//   read once per tile, two rows a step.
// - The step finds the matching depth and touches no count.  Every valid
//   id of lane l has id & 127 == l, so a thread never compares ids of
//   two lanes and the low seven bits of an id carry nothing.  Ids are
//   distinct within a gene, so an a slot x matches at most one b depth.
//   With j the b depth within a block of 128 depths, ky = (y & ~127) | j
//   and nx = -(x & ~127), the key ky + nx (unsigned) is j on a match and
//   at least 128 otherwise: an unequal valid id leaves a multiple of 128
//   above or wraps high, an empty b slot (-1) gives ky >= 0xffffff80,
//   which no valid nx brings below 2^31, and an empty a slot has nx =
//   128, which no valid ky wraps.  Two empty slots give j too, a match
//   whose two counts are 0.  So m = min over the b depths of the key, an
//   add and a minimum in one instruction (VIADDMNMX) a lane step, and
//   after the b loop, per a slot: if m < 128 the match is at depth m,
//   and only then is its count read, one word from the table's count
//   half.  A row deeper than 128 takes the b loop in blocks of 128
//   depths with the accounting after each.
// - Counters are int32 (exact), reduced across the warp with redux and
//   stored, one coalesced store per chunk, as f32 (every counter is
//   < 2^24, so the conversion is exact).

// phase timers of a -DPT_PROFILE build (hopper_async.cuh):
// cycles per phase, summed over warps: 0 pair set-up, 1 a row, 2 prefetch
// request, 3 wait for the b row, 4 compare and account, 5 reduce
#include "hopper_async.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kLaneMask = ~(kLane - 1);
constexpr int kWarpsPerBlock = 8;  // two blocks an SM; more run slower
constexpr int kChunk = 32;         // pair slots per warp
constexpr int kBufA = 8;           // a depths kept in shared memory
constexpr int kStageB = 8;         // b depths staged per pair
constexpr int kStages = 2;         // ring stages per warp
constexpr int kBlockDepths = 128;  // b depths a key's low seven bits can name
constexpr int kRowBytes = kLane * (int)sizeof(int);
// per warp: the a row, the ring, and one 16-byte cell per mbarrier
constexpr int kStageInts = kStageB * kLane;
constexpr int kWarpInts = kBufA * kLane + kStages * kStageInts + 4 * (kStages + 1);
constexpr int kSmemBytes = kWarpsPerBlock * kWarpInts * (int)sizeof(int);
constexpr unsigned kFull = 0xffffffffu;

// A thread's four slots of a depth row: lanes 4t .. 4t + 3 (`p` points
// at lane 4t), one 16-byte access.
__device__ __forceinline__ int4 shared4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}
__device__ __forceinline__ int4 global4(const int* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// What an a slot adds to a b key: minus its id without the low seven bits
// (its lane, the same for every slot a thread compares it with).
__device__ __forceinline__ int4 a_neg4(const int4 id) {
  return make_int4(-(id.x & kLaneMask), -(id.y & kLaneMask),
                   -(id.z & kLaneMask), -(id.w & kLaneMask));
}
// The keys of a b depth row: its ids with the depth's place jj in its
// block of 128 depths in the low seven bits.
__device__ __forceinline__ int4 b_key4(const int4 id, int jj) {
  return make_int4((id.x & kLaneMask) | jj, (id.y & kLaneMask) | jj,
                   (id.z & kLaneMask) | jj, (id.w & kLaneMask) | jj);
}

// One b row of one pair as a tile sees it, at this thread's lane 4t: the
// ids of depths [0, n_staged) in the ring stage (`s_ids`), the ids and
// the counts of every depth in the table (`g_ids`, `g_cnt`).
struct BRow {
  const int* s_ids;
  const int* g_ids;
  const int* g_cnt;
  int n_staged;
  int depth;
};

__device__ __forceinline__ int4 b_keys(const BRow& b, int j) {
  return b_key4(j < b.n_staged ? shared4(b.s_ids + j * kLane)
                               : global4(b.g_ids + j * kLane),
                j & (kBlockDepths - 1));
}

// m = min(m, y0 + nx, y1 + nx) over TA a depths x 4 lanes: an add and a
// minimum in one instruction (VIADDMNMX) per lane step
template <int TA>
__device__ __forceinline__ void step2(const int4 (&nx)[TA], uint4 (&m)[TA],
                                      const int4 y0, const int4 y1) {
#pragma unroll
  for (int d = 0; d < TA; ++d) {
    m[d].x = min(min(m[d].x, (unsigned)(y0.x + nx[d].x)), (unsigned)(y1.x + nx[d].x));
    m[d].y = min(min(m[d].y, (unsigned)(y0.y + nx[d].y)), (unsigned)(y1.y + nx[d].y));
    m[d].z = min(min(m[d].z, (unsigned)(y0.z + nx[d].z)), (unsigned)(y1.z + nx[d].z));
    m[d].w = min(min(m[d].w, (unsigned)(y0.w + nx[d].w)), (unsigned)(y1.w + nx[d].w));
  }
}
template <int TA>
__device__ __forceinline__ void step1(const int4 (&nx)[TA], uint4 (&m)[TA],
                                      const int4 y) {
#pragma unroll
  for (int d = 0; d < TA; ++d) {
    m[d].x = min(m[d].x, (unsigned)(y.x + nx[d].x));
    m[d].y = min(m[d].y, (unsigned)(y.y + nx[d].y));
    m[d].z = min(m[d].z, (unsigned)(y.z + nx[d].z));
    m[d].w = min(m[d].w, (unsigned)(y.w + nx[d].w));
  }
}

// One a slot after a block of b depths: m below 128 is the matching
// depth within the block, whose count is the word at `cnt_b` (the block's
// first count row at this slot's lane) + 128 * m.
__device__ __forceinline__ void account(const int ca, const unsigned m,
                                        const int* cnt_b, int& inter, int& perc,
                                        int& tr) {
  if (m < (unsigned)kBlockDepths) {
    const int cb = __ldg(cnt_b + m * kLane);
    inter += min(ca, cb);
    perc += ca;
    tr += cb;
  }
}

// The a depths [a0, a0 + TA) against one b row.  The ids of a depths
// below kBufA come negated from shared memory (`sa`), deeper ones from
// the table (`ga`); the a counts from the table (`ga_cnt`); all at lane
// 4t.
template <int TA>
__device__ __forceinline__ void join_tile(const int* sa, const int* ga, int a0,
                                          const int* ga_cnt, const BRow& b,
                                          int& inter, int& perc, int& tr) {
  int4 nx[TA];
  uint4 m[TA];
#pragma unroll
  for (int d = 0; d < TA; ++d)
    nx[d] = a0 + d < kBufA ? shared4(sa + (a0 + d) * kLane)
                           : a_neg4(global4(ga + (a0 + d) * kLane));
  for (int j0 = 0; j0 < b.depth; j0 += kBlockDepths) {
    const int end = min(b.depth, j0 + kBlockDepths);
#pragma unroll
    for (int d = 0; d < TA; ++d) m[d] = make_uint4(~0u, ~0u, ~0u, ~0u);
    int j = j0;
    if (j0 == 0) {  // the staged depths lie in the first block
#pragma unroll 2
      for (; j + 1 < b.n_staged; j += 2)
        step2<TA>(nx, m, b_key4(shared4(b.s_ids + j * kLane), j),
                  b_key4(shared4(b.s_ids + (j + 1) * kLane), j + 1));
    }
    for (; j + 1 < end; j += 2) step2<TA>(nx, m, b_keys(b, j), b_keys(b, j + 1));
    if (j < end) step1<TA>(nx, m, b_keys(b, j));
    const int* cnt_b = b.g_cnt + j0 * kLane;
#pragma unroll
    for (int d = 0; d < TA; ++d) {
      const int4 ca = global4(ga_cnt + (a0 + d) * kLane);
      account(ca.x, m[d].x, cnt_b, inter, perc, tr);
      account(ca.y, m[d].y, cnt_b + 1, inter, perc, tr);
      account(ca.z, m[d].z, cnt_b + 2, inter, perc, tr);
      account(ca.w, m[d].w, cnt_b + 3, inter, perc, tr);
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32, 2)
lane_join_kernel(const int* __restrict__ table, long long stride,
                 const int* __restrict__ dg, const int* __restrict__ a_idx,
                 const int* __restrict__ b_idx, long long n_pairs,
                 float* __restrict__ inter_out, float* __restrict__ perc_out,
                 float* __restrict__ tr_out) {
  extern __shared__ __align__(16) int smem[];
  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long p0 =
      ((long long)blockIdx.x * kWarpsPerBlock + warp) * kChunk;
  if (p0 >= n_pairs) return;  // whole warps exit together
  const int n = (int)min((long long)kChunk, n_pairs - p0);
  const long long half = stride / 2;  // D * 128: the ids, then the counts
  int* buf_a = smem + warp * kWarpInts;       // a depths [0, kBufA), negated
  int* ring = buf_a + kBufA * kLane;          // kStages stages of b ids
  int* bars = ring + kStages * kStageInts;    // ring stages, then a
  if (t == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(bars + 4 * s, 1);
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

  // the ids of the staged part of pair i's b row, into stage i % kStages
  auto prefetch = [&](int i) {
    if (i < n) {
      const int b = __shfl_sync(kFull, b_l, i);
      const int nb = min(__shfl_sync(kFull, db_l, i), kStageB);
      if (t == 0) {
        const int st = i % kStages;
        mbar_expect_tx(bars + 4 * st, nb * kRowBytes);
        if (nb > 0)
          bulk_copy(ring + st * kStageInts, table + (long long)b * stride,
                    nb * kRowBytes, bars + 4 * st);
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
    const int* ga = table + (long long)a * stride + 4 * t;
    const int* gb = table + (long long)b * stride + 4 * t;
    PT_TICK(0)
    // Every lane is done with the last pair's buffers, and what it wrote
    // into the a row (below) is ordered before a copy that overwrites it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (a != cur_a) {
      const int na = min(Da, kBufA);
      if (t == 0) {
        mbar_expect_tx(bars + 4 * kStages, na * kRowBytes);
        if (na > 0)
          bulk_copy(buf_a, table + (long long)a * stride, na * kRowBytes,
                    bars + 4 * kStages);
      }
      mbar_wait(bars + 4 * kStages, a_parity);
      a_parity ^= 1;
      cur_a = a;
      // the a row stays for its run of pairs: negate it in place, once (a
      // thread reads and writes only its own 16 bytes of a row)
      for (int d = 0; d < na; ++d) {
        int4* x = reinterpret_cast<int4*>(buf_a + d * kLane + 4 * t);
        *x = a_neg4(*x);
      }
    }
    PT_TICK(1)
    prefetch(i + kStages - 1);
    PT_TICK(2)
    mbar_wait(bars + 4 * (i % kStages), (i / kStages) & 1);
    PT_TICK(3)
    BRow row;
    row.s_ids = ring + (i % kStages) * kStageInts + 4 * t;
    row.g_ids = gb;
    row.g_cnt = gb + half;
    row.n_staged = min(Db, kStageB);
    row.depth = Db;
    const int* sa = buf_a + 4 * t;
    const int* ga_cnt = ga + half;
    int inter = 0, perc = 0, tr = 0;
    if (Db > 0) {
      int a0 = 0;
      for (; a0 + 4 <= Da; a0 += 4)
        join_tile<4>(sa, ga, a0, ga_cnt, row, inter, perc, tr);
      switch (Da - a0) {
        case 1: join_tile<1>(sa, ga, a0, ga_cnt, row, inter, perc, tr); break;
        case 2: join_tile<2>(sa, ga, a0, ga_cnt, row, inter, perc, tr); break;
        case 3: join_tile<3>(sa, ga, a0, ga_cnt, row, inter, perc, tr); break;
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
// in int32 (2 * D * 128).  Launches on `stream` and returns the first
// CUDA error of the attribute call or the launch (0 on success).
extern "C" int pt_lane_join(const int* table, long long stride,
                            const int* dg, const int* a_idx,
                            const int* b_idx, long long n_pairs,
                            float* inter, float* perc, float* tr,
                            void* stream) {
  if (n_pairs <= 0) return 0;
  const long long per_block = (long long)kWarpsPerBlock * kChunk;
  const long long blocks = (n_pairs + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      lane_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  lane_join_kernel<<<(unsigned int)blocks, kWarpsPerBlock * 32, kSmemBytes,
                     (cudaStream_t)stream>>>(table, stride, dg, a_idx, b_idx,
                                             n_pairs, inter, perc, tr);
  return (int)cudaGetLastError();
}
