// Exact profile join over id-sorted rows for NVIDIA Hopper (sm_90a): join
// kernel "roll".
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
// distinct; its entries are left-packed, so its width is the position of
// its first count-0 slot, and the join never reads past a row's width.
//
// What bounds it on this card.  Its floor is the larger of its bytes
// (each named row read once up to its width, w * 8 bytes, plus the pair
// indices and the three outputs) at 3.35 TB/s and its w_a + w_b merge
// steps per pair at the CUDA cores' rate; the bytes set it.  What holds a
// join of two sorted rows back is neither: it is the chain of dependent
// reads of a search or a merge, run by few warps (a design that keeps
// whole rows in shared memory per warp leaves room for about a dozen
// warps on an SM).  Its rate in steps per second is the same whether the
// rows come from L1, L2 or HBM (PERF.md holds the numbers of
// probe_joins.py and chip_smoke.py; a merge-path version of this kernel,
// each lane merging its diagonal of the w_a + w_b merge in shared memory,
// measured no faster than the binary search it replaced).  So the design
// has no dependent chain at all and shares what it can across a block:
//
// - The engine's pair list names one a for a run of pairs.  A block of 8
//   warps takes 256 consecutive pair slots and works through their runs
//   in order: for each run it builds, together, a hash table of the a
//   row in shared memory (open addressing, linear probing, slots of
//   {id, count} with count 0 = free, claimed with atomicCAS; sized to at
//   least 8 times the row's width where the table allows, at least twice
//   always), and then its warps take the run's pairs in turn (pair i goes
//   to warp i mod 8).  Any list stays right; one whose a changes at every
//   pair pays a table per pair.
// - A pair's b entries are looked up independently: each lane takes the
//   entries t, t + 32, ... of a tile, four side by side, so there is no
//   chain of dependent reads and no search.  Every lookup that does not
//   settle at its first slot (free: no match; same id: a match) goes on
//   in one shared loop.
// - The b rows come in tiles of kTile entries through a ring of kStages
//   stages per warp, each tile two bulk asynchronous copies (ids, counts;
//   cp.async.bulk) started by one lane one tile ahead and reported to an
//   mbarrier; a row of any width streams through, so shared memory does
//   not grow with the b side.
// - Row widths come from a small kernel of their own (one binary search
//   over the left-packed counts per row, written to `widths`) launched in
//   front of the join: a pair costs two reads, not two searches.
// - Counters are int32 (exact: a profile's total count is below 2^24),
//   reduced across the warp with redux, collected in shared memory and
//   stored, coalesced, as f32.
//
// Shared memory per block: the table (8 bytes a slot), 8 rings, and 6 KB
// of pair data.  The table takes the next power of two above 4W slots
// when three such blocks fit an SM, else above 2W; the wrapper refuses a
// W whose smaller table does not fit one block (W > 8192).

// phase timers of a -DPT_PROFILE build (hopper_async.cuh):
// cycles per phase, summed over warps: 0 table build (with its barriers),
// 1 tile request, 2 wait for the tile, 3 lookups, 4 reduce, 5 barrier at
// the end of a run
#include "hopper_async.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockPairs = kThreads;  // pair slots per block
constexpr int kTile = 128;             // b entries per ring stage
constexpr int kBatch = kTile / 32;     // lookups a lane runs side by side
constexpr int kStages = 2;
constexpr int kSmemPerBlock = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kHashMul = 0x9E3779B1u;  // 2^32 / golden ratio

// widths[r] = number of leading entries of row r with count > 0 (counts
// are left-packed)
__global__ void row_width_kernel(const int* __restrict__ table, int W,
                                 int n_rows, int* __restrict__ widths) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int* cnt = table + (long long)r * 2 * W + W;
  int lo = 0, hi = W;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cnt + mid) > 0) lo = mid + 1; else hi = mid;
  }
  widths[r] = lo;
}

// shared memory of one block, offsets in int32
struct Layout {
  int table;   // slots x {id, count}
  int ring;    // kWarps x kStages x (kTile ids, kTile counts)
  int bars;    // kWarps x kStages mbarriers, 16 bytes each
  int pairs;   // a, b, width of b, inter, perc, tr: kBlockPairs each
  int starts;  // kWarps words: bit i of word w = pair 32w + i starts a run
  int total;
};
__host__ __device__ inline Layout layout(int slots) {
  Layout L;
  L.table = 0;
  L.ring = 2 * slots;
  L.bars = L.ring + kWarps * kStages * 2 * kTile;
  L.pairs = L.bars + kWarps * kStages * 4;
  L.starts = L.pairs + 6 * kBlockPairs;
  L.total = L.starts + kWarps;
  return L;
}

// the smallest power of two (at least 64) that is >= n
__host__ __device__ inline int pow2_at_least(long long n) {
  int p = 64;
  while (p < n) p <<= 1;
  return p;
}

__global__ void __launch_bounds__(kThreads)
pair_join_kernel(const int* __restrict__ table, int W,
                 const int* __restrict__ widths, const int* __restrict__ a_idx,
                 const int* __restrict__ b_idx, long long n_pairs, int slots,
                 float* __restrict__ inter_out, float* __restrict__ perc_out,
                 float* __restrict__ tr_out) {
  extern __shared__ int4 smem4[];
  int* base = reinterpret_cast<int*>(smem4);
  const Layout L = layout(slots);
  int2* hash = reinterpret_cast<int2*>(base + L.table);
  const int tid = threadIdx.x;
  const int t = tid & 31;
  const int warp = tid >> 5;
  int* ring = base + L.ring + warp * (kStages * 2 * kTile);
  int* bars = base + L.bars + warp * (kStages * 4);
  int* a_s = base + L.pairs;
  int* b_s = a_s + kBlockPairs;
  int* wb_s = b_s + kBlockPairs;
  int* inter_s = wb_s + kBlockPairs;
  int* perc_s = inter_s + kBlockPairs;
  int* tr_s = perc_s + kBlockPairs;
  unsigned* starts = reinterpret_cast<unsigned*>(base + L.starts);
  const long long row = 2LL * W;
  const long long p0 = (long long)blockIdx.x * kBlockPairs;
  const int n = (int)min((long long)kBlockPairs, n_pairs - p0);

  {
    int a = -1;
    if (tid < n) {
      a = __ldg(a_idx + p0 + tid);
      const int b = __ldg(b_idx + p0 + tid);
      a_s[tid] = a;
      b_s[tid] = b;
      wb_s[tid] = __ldg(widths + b);
    }
    // a pair starts a run when its a differs from that of the pair
    // before it (a warp's first pair reads its neighbour's a itself)
    const int prev = __shfl_up_sync(kFull, a, 1);
    bool start = tid < n;
    if (start && tid > 0)
      start = a != (t > 0 ? prev : __ldg(a_idx + p0 + tid - 1));
    const unsigned bits = __ballot_sync(kFull, start);
    if (t == 0) {
      starts[warp] = bits;
      for (int s = 0; s < kStages; ++s) mbar_init(bars + 4 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
#ifdef PT_PROFILE
  long long prof_[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long last_ = clock64();
#endif

  // This warp's pairs are warp, warp + kWarps, ...; its ring runs over
  // their (pair, b tile) items in order, whatever run a pair is in (a b
  // row does not depend on the table).  A pair of width 0 is one empty
  // item.
  int next_pair = warp, next_tile = 0, requested = 0, consumed = 0;
  auto request_tile = [&]() {
    if (next_pair < n) {
      const int wb = wb_s[next_pair];
      const int j0 = next_tile * kTile;
      if (t == 0) {
        const int bytes = ((min(kTile, wb - j0) + 3) >> 2) * 16;
        const int* src = table + b_s[next_pair] * row + j0;
        const int st = requested % kStages;
        int* dst = ring + st * (2 * kTile);
        mbar_expect_tx(bars + 4 * st, 2 * bytes);
        if (bytes > 0) {
          bulk_copy(dst, src, bytes, bars + 4 * st);
          bulk_copy(dst + kTile, src + W, bytes, bars + 4 * st);
        }
      }
      ++next_tile;
      if (next_tile * kTile >= wb) {
        next_pair += kWarps;
        next_tile = 0;
      }
    }
    ++requested;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) request_tile();

  int pos = 0;
  while (pos < n) {
    // the run [pos, end) of pairs that share this a
    int end = n;
    for (int w = pos >> 5; w < kWarps; ++w) {
      unsigned m = starts[w];
      if (w == (pos >> 5)) m &= ~((2u << (pos & 31)) - 1u);
      if (m) {
        end = min(n, w * 32 + __ffs(m) - 1);
        break;
      }
    }
    const int a = a_s[pos];
    const int wa = __ldg(widths + a);
    // the block builds the table of a's entries
    const int run_slots = min(slots, pow2_at_least(8LL * wa));
    const int mask = run_slots - 1;
    const int shift = __clz(run_slots) + 1;  // 32 - log2(run_slots)
    int4* h4 = reinterpret_cast<int4*>(hash);
    for (int u = tid; u < run_slots / 2; u += kThreads)
      h4[u] = make_int4(0, 0, 0, 0);
    __syncthreads();
    const int* ia = table + a * row;
    for (int u = tid; u < wa; u += kThreads) {
      const int v = __ldg(ia + u);
      const int c = __ldg(ia + W + u);
      int h = (int)(((unsigned)v * kHashMul) >> shift);
      while (atomicCAS(&hash[h].y, 0, c) != 0) h = (h + 1) & mask;
      hash[h].x = v;
    }
    __syncthreads();
    PT_TICK(0)
    for (int i = pos + ((warp - pos) & (kWarps - 1)); i < end; i += kWarps) {
      const int wb = wb_s[i];
      const int n_tiles = max(1, (wb + kTile - 1) / kTile);
      int inter = 0, perc = 0, tr = 0;
      for (int k = 0; k < n_tiles; ++k) {
        request_tile();
        PT_TICK(1)
        mbar_wait(bars + 4 * (consumed % kStages), (consumed / kStages) & 1);
        PT_TICK(2)
        const int* st = ring + (consumed % kStages) * (2 * kTile);
        const int nb = min(kTile, wb - k * kTile);
        int v[kBatch], c[kBatch], h[kBatch];
        int2 s[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int u = 32 * j + t;
          c[j] = 0;
          v[j] = 0;
          if (u < nb) {
            v[j] = st[u];
            c[j] = st[kTile + u];
          }
          h[j] = (int)(((unsigned)v[j] * kHashMul) >> shift);
          s[j] = hash[h[j]];
        }
        // a slot settles a lookup when it is free (no match) or holds
        // the entry's id (a match); otherwise the lookup moves on.  c[j]
        // is zeroed once lookup j has settled.
        bool more = false;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const bool hit = c[j] > 0 && s[j].y != 0 && s[j].x == v[j];
          if (hit) {
            inter += min(s[j].y, c[j]);
            perc += s[j].y;
            tr += c[j];
          }
          if (c[j] > 0 && s[j].y != 0 && !hit) more = true; else c[j] = 0;
        }
        while (more) {
          more = false;
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (c[j] > 0) {
              h[j] = (h[j] + 1) & mask;
              s[j] = hash[h[j]];
              const bool hit = s[j].y != 0 && s[j].x == v[j];
              if (hit) {
                inter += min(s[j].y, c[j]);
                perc += s[j].y;
                tr += c[j];
              }
              if (s[j].y != 0 && !hit) more = true; else c[j] = 0;
            }
          }
        }
        ++consumed;
        __syncwarp();  // every lane is done with this stage
        PT_TICK(3)
      }
      inter = __reduce_add_sync(kFull, inter);
      perc = __reduce_add_sync(kFull, perc);
      tr = __reduce_add_sync(kFull, tr);
      if (t == 0) {
        inter_s[i] = inter;
        perc_s[i] = perc;
        tr_s[i] = tr;
      }
      PT_TICK(4)
    }
    __syncthreads();  // every warp is done with this table
    PT_TICK(5)
    pos = end;
  }
#ifdef PT_PROFILE
  if (t == 0)
    for (int k = 0; k < 8; ++k)
      atomicAdd(&g_profile[k], (unsigned long long)prof_[k]);
#endif
  if (tid < n) {
    inter_out[p0 + tid] = (float)inter_s[tid];
    perc_out[p0 + tid] = (float)perc_s[tid];
    tr_out[p0 + tid] = (float)tr_s[tid];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  All pointers are device
// pointers, `table` 16-byte aligned; `W` is the padded profile width (the
// table's row is 2W int32), a multiple of 4 and at most 8192; `widths` is
// scratch for `n_rows` int32.  Launches the width kernel and the join on
// `stream` and returns the first CUDA error of the attribute call or the
// launches (0 on success).
extern "C" int pt_pair_join(const int* table, long long W, long long n_rows,
                            const int* a_idx, const int* b_idx,
                            long long n_pairs, int* widths, float* inter,
                            float* perc, float* tr, void* stream) {
  if (n_pairs <= 0) return 0;
  if (W <= 0 || W % 4 || W > (1 << 20) || n_rows <= 0 || n_rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int slots = pow2_at_least(4 * W);
  if (3LL * layout(slots).total * (long long)sizeof(int) > kSmemPerBlock)
    slots = pow2_at_least(2 * W);
  const long long smem = (long long)layout(slots).total * (long long)sizeof(int);
  if (smem > kSmemPerBlock) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_pairs + kBlockPairs - 1) / kBlockPairs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      pair_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_width_kernel<<<(unsigned int)((n_rows + 255) / 256), 256, 0,
                     (cudaStream_t)stream>>>(table, (int)W, (int)n_rows, widths);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pair_join_kernel<<<(unsigned int)blocks, kThreads, (int)smem,
                     (cudaStream_t)stream>>>(table, (int)W, widths, a_idx,
                                             b_idx, n_pairs, slots, inter, perc,
                                             tr);
  return (int)cudaGetLastError();
}
