// k-mer multiset index build for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its index on the host
// (pandelos_tpu/index.py and its C++ core).  It replaces the reference's
// preprocessing core (ig/native/library.cpp:189-371) for runs whose index
// is built on a card, and produces what the JAX package's index and the
// port's NumPy build (index.py) produce, bit for bit:
//
// - the alphabet census (dense ranks in ascending byte order) and one
//   packed key per window that lies inside one gene;
// - the (k-mer, gene) multiset entries with their counts;
// - the groups: total_vocab (every distinct k-mer), and a dense shared id,
//   in ascending key order, for each k-mer on two genes or more;
// - computation_costs: each shared group's size charged to each member
//   gene (an int64 atomic sum, exact in any order);
// - the CSR by gene, ids ascending within a gene.
//
// What bounds it on this card: bytes.  Every step is a pass over the
// windows, the entries or the groups (a few hundred MB at the benchmark's
// shapes, well under a millisecond at 3.35 TB/s); no step does more than a
// handful of integer operations per byte.  The single-threaded host
// build it replaced was bound by memory latency (a 64 M-bucket histogram,
// random scatter, a walk over every bucket); here every pass is wide and
// mostly streaming.
//
// Design:
// - Keys: one thread per window; its gene by binary search of the
//   per-gene window offsets; the key (k ranks, Horner) packed with the
//   gene as (key << gene_bits) | gene.  Windows come out gene-major.
// - One stable least-significant-digit radix sort, written here, sorts
//   only the key's bits (the gene bits are already in order: the input
//   is gene-major and every pass is stable), at most 8 bits a pass.  A
//   pass is three kernels: per-block digit histograms over a contiguous
//   range of tiles, one exclusive scan of them (digit-major, so the order
//   is digit, then block), and a scatter in which each warp ranks its keys
//   in input order with __match_any_sync and a per-warp count in shared
//   memory, the warps' counts are turned into offsets per digit, and each
//   key is written to its place.  After the sort equal (k-mer, gene) pairs
//   are adjacent.
// - Four stream compactions (flag, per-block count, scan, emit) then give
//   the entries and their counts (runs of equal composite keys), the
//   groups (runs of equal k-mers over the entries), the shared ids (an
//   exclusive scan of "group size >= 2"), and the kept entries, which
//   also add their group's size to their gene's cost and count their gene
//   for the CSR pointer.
// - The CSR: the kept entries, in key order (so ids ascending), are sorted
//   stably by gene with the same radix sort on (gene << 32 | kept index),
//   and a gather writes ids and counts.
//
// Buffers: the caller allocates a head (census, per-gene window offsets),
// a workspace (pt_kmer_workspace_bytes), the small output (CSR pointer,
// costs, four counts) and the large output (ids, then counts); this file
// allocates nothing.  Every kernel runs on the caller's stream; each entry
// point returns cudaGetLastError() and adds the kernels it launched to
// *launched.  Only cudaMemsetAsync besides: no library sort or scan.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                   // radix: keys a thread a tile
constexpr int kTile = kThreads * kItems;     // radix tile
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kScanItems = 8;                // compaction: items a thread
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kMaxBlocks = 1056;             // 8 per SM of 132
constexpr int kScanThreads = 1024;           // the one-block scan
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// Blocks over n items in contiguous ranges of whole tiles: at most
// kMaxBlocks blocks, `per` tiles each.
struct Ranges {
  int blocks;
  int per;
};

Ranges ranges(long long n, int tile) {
  long long tiles = cdiv(n > 0 ? n : 1, tile);
  long long per = cdiv(tiles, kMaxBlocks);
  return {(int)cdiv(tiles, per), (int)per};
}

// ---------------------------------------------------------------------------
// block helpers (kThreads threads)

__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; w++) {
    const int p = part[w];
    if (w < warp) before += p;
    all += p;
  }
  __syncthreads();  // part[] is reused by the next call
  *total = all;
  return before + inc - x;
}

// ---------------------------------------------------------------------------
// exclusive scan of in[0, m) into out[0, m], out[m] the total: one block of
// kScanThreads, each thread a contiguous segment (m is at most a few
// hundred thousand here).  in may equal out.

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kScanThreads)
k_scan_one_block(const Tin* in, Tout* out, long long m) {
  __shared__ Tout part[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long seg = cdiv(m, kScanThreads);
  const long long beg = min(m, (long long)t * seg);
  const long long end = min(m, beg + seg);
  Tout sum = 0;
  for (long long i = beg; i < end; i++) sum += (Tout)in[i];
  Tout inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Tout y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Tout s = part[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const Tout y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    part[lane] = s;
  }
  __syncthreads();
  Tout run = (warp ? part[warp - 1] : (Tout)0) + inc - sum;
  for (long long i = beg; i < end; i++) {
    const Tout v = (Tout)in[i];
    out[i] = run;
    run += v;
  }
  if (t == kScanThreads - 1) out[m] = part[kScanThreads / 32 - 1];
}

// ---------------------------------------------------------------------------
// census and windows

__global__ void k_census(const uint8_t* concat, long long n, int* present) {
  __shared__ int seen[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) seen[i] = 0;
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += step)
    seen[concat[i]] = 1;
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (seen[i]) present[i] = 1;
}

__global__ void k_windows(const long long* offsets, long long G, int k,
                          long long* nwin) {
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g < G) {
    const long long len = offsets[g + 1] - offsets[g];
    nwin[g] = len >= k ? len - k + 1 : 0;
  }
}

// one packed key per window: (key << gene_bits) | gene
__global__ void __launch_bounds__(kThreads)
k_keys(const uint8_t* concat, const long long* offsets,
       const long long* win_off, long long G, long long n, int k,
       unsigned base, int gene_bits, const int* present, u64* out) {
  __shared__ unsigned rank[256];
  if (threadIdx.x == 0) {
    unsigned r = 0;
    for (int c = 0; c < 256; c++) {
      rank[c] = r;
      r += present[c] ? 1u : 0u;
    }
  }
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long w = blockIdx.x * (long long)blockDim.x + threadIdx.x; w < n;
       w += step) {
    // win_off[lo] <= w < win_off[hi]
    long long lo = 0, hi = G;
    while (hi - lo > 1) {
      const long long mid = (lo + hi) >> 1;
      if (win_off[mid] <= w) lo = mid; else hi = mid;
    }
    const uint8_t* p = concat + offsets[lo] + (w - win_off[lo]);
    u64 key = 0;
    for (int j = 0; j < k; j++) key = key * base + rank[p[j]];
    out[w] = (key << gene_bits) | (u64)lo;
  }
}

// ---------------------------------------------------------------------------
// one stable LSD radix pass over bits [shift, shift + bits), bits <= 8

__global__ void __launch_bounds__(kThreads)
k_radix_hist(const u64* in, long long n, int shift, int bits, int per,
             unsigned* hist) {
  __shared__ unsigned h[kWarps][kRadix];
  const int radix = 1 << bits, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
    (&h[0][0])[i] = 0;
  __syncthreads();
  const long long beg = (long long)blockIdx.x * per * kTile;
  const long long end = min(n, beg + (long long)per * kTile);
  const u64 mask = (u64)(radix - 1);
  for (long long i = beg + threadIdx.x; i < end; i += kThreads)
    atomicAdd(&h[warp][(unsigned)((in[i] >> shift) & mask)], 1u);
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; w++) s += h[w][d];
    hist[(long long)d * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
k_radix_scatter(const u64* in, u64* out, long long n, int shift, int bits,
                int per, const unsigned* offs) {
  __shared__ unsigned base[kRadix];
  __shared__ unsigned wh[kWarps][kRadix];
  const int radix = 1 << bits;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const u64 mask = (u64)(radix - 1);
  for (int d = threadIdx.x; d < radix; d += kThreads)
    base[d] = offs[(long long)d * gridDim.x + blockIdx.x];
  const long long beg = (long long)blockIdx.x * per * kTile;
  const long long end = min(n, beg + (long long)per * kTile);
  for (long long t0 = beg; t0 < end; t0 += kTile) {
    for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
      (&wh[0][0])[i] = 0;
    __syncthreads();
    // warp w takes the w-th run of 32 * kItems keys of the tile, in rows
    // of 32: item j of a lane is key w0 + 32 j
    const long long w0 = t0 + (long long)warp * 32 * kItems + lane;
    u64 v[kItems];
    unsigned rk[kItems];
#pragma unroll
    for (int j = 0; j < kItems; j++) {
      const long long i = w0 + 32 * j;
      v[j] = i < end ? in[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kItems; j++) {
      const bool ok = w0 + 32 * j < end;
      const unsigned d =
          ok ? (unsigned)((v[j] >> shift) & mask) : (unsigned)kRadix;
      const unsigned peers = __match_any_sync(kFull, d);
      unsigned before = 0;
      if (ok) before = wh[warp][d];
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) wh[warp][d] = before + __popc(peers);
      __syncwarp();
      rk[j] = before + __popc(peers & lt);
    }
    __syncthreads();
    // per digit: the warps' counts become their offsets, after the
    // block's running offset for the digit
    for (int d = threadIdx.x; d < radix; d += kThreads) {
      unsigned run = base[d];
#pragma unroll
      for (int w = 0; w < kWarps; w++) {
        const unsigned c = wh[w][d];
        wh[w][d] = run;
        run += c;
      }
      base[d] = run;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; j++) {
      if (w0 + 32 * j < end) {
        const unsigned d = (unsigned)((v[j] >> shift) & mask);
        out[wh[warp][d] + rk[j]] = v[j];
      }
    }
    __syncthreads();  // wh is cleared for the next tile
  }
}

// Sorts a[0, n) stably by bits [lo, lo + bits) with b as the second
// buffer; returns the buffer that holds the result.  hist holds
// kRadix * kMaxBlocks + 1 entries.
u64* radix_sort(u64* a, u64* b, long long n, int lo, int bits,
                unsigned* hist, cudaStream_t st, int* launched) {
  if (bits <= 0) return a;
  const int passes = (int)cdiv(bits, kRadixBits);
  const Ranges r = ranges(n, kTile);
  int shift = lo, left = bits;
  for (int p = 0; p < passes; p++) {
    const int w = (int)cdiv(left, passes - p);  // even widths, <= 8
    k_radix_hist<<<r.blocks, kThreads, 0, st>>>(a, n, shift, w, r.per, hist);
    const long long m = (long long)(1 << w) * r.blocks;
    k_scan_one_block<unsigned, unsigned>
        <<<1, kScanThreads, 0, st>>>(hist, hist, m);
    k_radix_scatter<<<r.blocks, kThreads, 0, st>>>(a, b, n, shift, w, r.per,
                                                   hist);
    *launched += 3;
    u64* t = a;
    a = b;
    b = t;
    shift += w;
    left -= w;
  }
  return a;
}

int sort_passes(int bits) {
  return bits > 0 ? (int)cdiv(bits, kRadixBits) : 0;
}

// ---------------------------------------------------------------------------
// stream compaction: flag, per-block count, one scan, emit in order

template <class F>
__global__ void __launch_bounds__(kThreads)
k_flag_count(F f, int per, int* counts) {
  const long long n = f.size();
  const long long beg = (long long)blockIdx.x * per * kScanTile;
  const long long end = min(n, beg + (long long)per * kScanTile);
  int c = 0;
  for (long long i = beg + threadIdx.x; i < end; i += kThreads)
    c += f.flag(i, n);
  int total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <class F>
__global__ void __launch_bounds__(kThreads)
k_flag_emit(F f, int per, const int* offs) {
  const long long n = f.size();
  const long long beg = (long long)blockIdx.x * per * kScanTile;
  const long long end = min(n, beg + (long long)per * kScanTile);
  int carry = offs[blockIdx.x];
  for (long long t0 = beg; t0 < end; t0 += kScanTile) {
    const long long i0 = t0 + (long long)threadIdx.x * kScanItems;
    int fl[kScanItems];
    int c = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; j++) {
      fl[j] = i0 + j < end ? f.flag(i0 + j, n) : 0;
      c += fl[j];
    }
    int total;
    int x = carry + block_exclusive_scan(c, &total);
#pragma unroll
    for (int j = 0; j < kScanItems; j++) {
      if (i0 + j < end) f.emit(i0 + j, x, fl[j], n);
      x += fl[j];
    }
    carry += total;
  }
}

// entries: runs of equal (k-mer, gene) over the sorted windows
struct EntryStage {
  const u64* s;
  long long n;
  u64* e_val;
  int* e_first;
  __device__ long long size() const { return n; }
  __device__ int flag(long long i, long long) const {
    return i == 0 || s[i] != s[i - 1];
  }
  __device__ void emit(long long i, int at, int fl, long long) const {
    if (fl) {
      e_val[at] = s[i];
      e_first[at] = (int)i;
    }
  }
};

// groups: runs of equal k-mers over the entries; every entry's group
struct GroupStage {
  const u64* e_val;
  const int* n_entries;
  int gene_bits;
  int* g_first;
  int* grp;
  __device__ long long size() const { return *n_entries; }
  __device__ int flag(long long e, long long) const {
    return e == 0 || (e_val[e] >> gene_bits) != (e_val[e - 1] >> gene_bits);
  }
  __device__ void emit(long long e, int at, int fl, long long) const {
    if (fl) g_first[at] = (int)e;
    grp[e] = at + fl - 1;
  }
};

__device__ inline int group_size(const int* g_first, long long g,
                                 long long n_groups, int n_entries) {
  const int end = g + 1 < n_groups ? g_first[g + 1] : n_entries;
  return end - g_first[g];
}

// shared ids: an exclusive scan of "group size >= 2"
struct SharedStage {
  const int* g_first;
  const int* n_groups;
  const int* n_entries;
  int* sid;
  __device__ long long size() const { return *n_groups; }
  __device__ int flag(long long g, long long n) const {
    return group_size(g_first, g, n, *n_entries) >= 2;
  }
  __device__ void emit(long long g, int at, int, long long) const {
    sid[g] = at;
  }
};

// kept entries (of shared groups), in key order: (gene << 32 | index),
// id and count; the gene's cost and CSR count
struct KeptStage {
  const u64* e_val;
  const int* e_first;
  const int* grp;
  const int* g_first;
  const int* sid;
  const int* n_entries;
  const int* n_groups;
  long long n_windows;
  u64 gene_mask;
  u64* key2;
  int* sid2;
  int* cnt2;
  long long* costs;
  int* gene_cnt;
  __device__ long long size() const { return *n_entries; }
  __device__ int gsize(long long e, long long n) const {
    return group_size(g_first, grp[e], *n_groups, (int)n);
  }
  __device__ int flag(long long e, long long n) const {
    return gsize(e, n) >= 2;
  }
  __device__ void emit(long long e, int at, int fl, long long n) const {
    if (!fl) return;
    const unsigned gene = (unsigned)(e_val[e] & gene_mask);
    key2[at] = ((u64)gene << 32) | (unsigned)at;
    sid2[at] = sid[grp[e]];
    cnt2[at] = (e + 1 < n ? e_first[e + 1] : (int)n_windows) - e_first[e];
    atomicAdd((u64*)&costs[gene], (u64)gsize(e, n));
    atomicAdd(&gene_cnt[gene], 1);
  }
};

template <class F>
void compact(const F& f, long long n_ub, int* blk, cudaStream_t st,
             int* launched) {
  const Ranges r = ranges(n_ub, kScanTile);
  k_flag_count<F><<<r.blocks, kThreads, 0, st>>>(f, r.per, blk);
  k_scan_one_block<int, int><<<1, kScanThreads, 0, st>>>(blk, blk, r.blocks);
  k_flag_emit<F><<<r.blocks, kThreads, 0, st>>>(f, r.per, blk);
  *launched += 3;
}

__global__ void k_counts(const int* a, const int* b, const int* c,
                         const int* d, long long* out) {
  out[0] = *a;
  out[1] = *b;
  out[2] = *c;
  out[3] = *d;
}

__global__ void k_gather(const u64* key2, const int* sid2, const int* cnt2,
                         long long nnz, int* ids, int* cnts) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < nnz; t += step) {
    const unsigned j = (unsigned)key2[t];
    ids[t] = sid2[j];
    cnts[t] = cnt2[j];
  }
}

int grid_for(long long n) {
  return (int)std::max(1LL, std::min(cdiv(n, kThreads), 132LL * 16));
}

// ---------------------------------------------------------------------------
// workspace layout (bytes, 256-aligned segments)

size_t align(size_t x) { return (x + 255) & ~(size_t)255; }

struct Work {
  u64* buf[2];
  int* e_first;
  int* g_first;
  int* grp;
  int* sid;
  int* sid2;
  int* cnt2;
  int* gene_cnt;
  unsigned* hist;
  int* blk[4];
  size_t bytes;
};

Work layout(void* base, long long n, long long G) {
  Work w;
  size_t at = 0;
  auto take = [&](size_t nbytes) {
    void* q = (void*)((uintptr_t)base + at);
    at += align(nbytes);
    return q;
  };
  w.buf[0] = (u64*)take(8 * (size_t)n);
  w.buf[1] = (u64*)take(8 * (size_t)n);
  w.e_first = (int*)take(4 * (size_t)n);
  w.g_first = (int*)take(4 * (size_t)n);
  w.grp = (int*)take(4 * (size_t)n);
  w.sid = (int*)take(4 * (size_t)n);
  w.sid2 = (int*)take(4 * (size_t)n);
  w.cnt2 = (int*)take(4 * (size_t)n);
  w.gene_cnt = (int*)take(4 * (size_t)G);
  w.hist = (unsigned*)take(4 * ((size_t)kRadix * kMaxBlocks + 1));
  for (int i = 0; i < 4; i++) w.blk[i] = (int*)take(4 * (kMaxBlocks + 1));
  w.bytes = at;
  return w;
}

}  // namespace

extern "C" {

// Bytes of the workspace of pt_kmer_entries / pt_kmer_csr for n windows
// and G genes.
long long pt_kmer_workspace_bytes(long long n, long long G) {
  return (long long)layout(nullptr, n, G).bytes;
}

// The census and the per-gene window offsets.  head: 256 int32 (present,
// zeroed here), then G int64 (windows a gene), then G + 1 int64 (window
// offsets; [G] is the number of windows).
int pt_kmer_prepare(const uint8_t* concat, long long L,
                    const long long* offsets, long long G, int k, void* head,
                    void* stream, int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  int* present = (int*)head;
  long long* nwin = (long long*)((char*)head + 1024);
  long long* win_off = nwin + G;
  cudaMemsetAsync(present, 0, 1024, st);
  if (L > 0) {
    k_census<<<grid_for(L / 4 + 1), kThreads, 0, st>>>(concat, L, present);
    *launched += 1;
  }
  k_windows<<<(int)cdiv(G, kThreads), kThreads, 0, st>>>(offsets, G, k, nwin);
  k_scan_one_block<long long, long long>
      <<<1, kScanThreads, 0, st>>>(nwin, win_off, G);
  *launched += 2;
  return (int)cudaGetLastError();
}

// Keys, the sort, the entries, groups, shared ids and kept entries, the
// CSR pointer and the costs.  small: G + 1 int64 (CSR pointer), G int64
// (costs), then 4 int64 (entries, total_vocab, vocab_size, nnz).
int pt_kmer_entries(const uint8_t* concat, const long long* offsets,
                    const void* head, long long G, long long n, int k,
                    unsigned base, int key_bits, int gene_bits, void* work,
                    long long* small, void* stream, int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  const int* present = (const int*)head;
  const long long* win_off = (const long long*)((const char*)head + 1024) + G;
  Work w = layout(work, n, G);
  long long* ptr = small;
  long long* costs = small + G + 1;
  cudaMemsetAsync(costs, 0, 8 * (size_t)G, st);
  cudaMemsetAsync(w.gene_cnt, 0, 4 * (size_t)G, st);

  k_keys<<<grid_for(n), kThreads, 0, st>>>(concat, offsets, win_off, G, n, k,
                                           base, gene_bits, present, w.buf[0]);
  *launched += 1;
  u64* s = radix_sort(w.buf[0], w.buf[1], n, gene_bits, key_bits, w.hist, st,
                      launched);
  u64* e_val = s == w.buf[0] ? w.buf[1] : w.buf[0];

  compact(EntryStage{s, n, e_val, w.e_first}, n, w.blk[0], st, launched);
  const Ranges r = ranges(n, kScanTile);
  const int* n_entries = w.blk[0] + r.blocks;
  compact(GroupStage{e_val, n_entries, gene_bits, w.g_first, w.grp}, n,
          w.blk[1], st, launched);
  const int* n_groups = w.blk[1] + r.blocks;
  compact(SharedStage{w.g_first, n_groups, n_entries, w.sid}, n, w.blk[2],
          st, launched);
  const u64 gene_mask = gene_bits ? ((u64)1 << gene_bits) - 1 : 0;
  // the kept entries' keys go to the sorted windows' buffer, free now
  compact(KeptStage{e_val, w.e_first, w.grp, w.g_first, w.sid, n_entries,
                    n_groups, n, gene_mask, s, w.sid2, w.cnt2, costs,
                    w.gene_cnt},
          n, w.blk[3], st, launched);
  k_scan_one_block<int, long long>
      <<<1, kScanThreads, 0, st>>>(w.gene_cnt, ptr, G);
  k_counts<<<1, 1, 0, st>>>(n_entries, n_groups, w.blk[2] + r.blocks,
                            w.blk[3] + r.blocks, small + 2 * G + 1);
  *launched += 2;
  return (int)cudaGetLastError();
}

// The CSR's ids and counts: the nnz kept entries sorted stably by gene.
// out: nnz int32 ids, then nnz int32 counts.
int pt_kmer_csr(void* work, long long n, long long G, int key_bits,
                int gene_bits, long long nnz, int* out, void* stream,
                int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  Work w = layout(work, n, G);
  // where pt_kmer_entries left the kept entries' keys
  u64* key2 = w.buf[sort_passes(key_bits) % 2];
  u64* other = key2 == w.buf[0] ? w.buf[1] : w.buf[0];
  u64* sorted = radix_sort(key2, other, nnz, 32, gene_bits, w.hist, st,
                           launched);
  k_gather<<<grid_for(nnz), kThreads, 0, st>>>(sorted, w.sid2, w.cnt2, nnz,
                                               out, out + nnz);
  *launched += 1;
  return (int)cudaGetLastError();
}

}  // extern "C"
