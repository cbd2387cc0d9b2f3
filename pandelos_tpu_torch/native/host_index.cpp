// Native host core of the port: the clustering's one Girvan-Newman split
// level (pt_gn_split), every colliding component's whole recursion on a
// pool of threads (pt_gn_families), the CPython set order that recursion
// replays (pt_pyset_order), and the .net writer's formatting on a pool of
// threads (pt_format_net).
//
// The file's name is older than its content: the k-mer index is built
// by ops/kmer_index.py (csrc/kmer_index.cu on a card, its plain PyTorch
// twin elsewhere) and, for keys past 63 bits, by index.py's NumPy build.
//
// C ABI for ctypes; buffers are malloc'd here and released by pt_free.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <system_error>
#include <algorithm>
#include <atomic>
#include <chrono>
#include <thread>
#include <vector>

extern "C" void pt_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Every colliding component's netclu split_until_max_k recursion
// (netclu_ng.py:101-115) in one call, on a pool of threads that never
// enters the Python interpreter.  Level for level it computes what
// cluster.py's Python-driven path (_split_component and
// _split_colliding_native) hands pt_gn_split, and the same families:
// - comp_order: the members ranked by first appearance in the .net stream
//   (order_rank); pnet's adjacency restricted to the component is the
//   per-edge double append in .net order;
// - coco, networkx's BFS set from comp_order[0], and every level's member
//   set are CPython sets filled in networkx's insertion order (PySetReplay);
//   a level's view iterates its set when 2*len < n_total, else comp_order;
// - a level's edges come in Graph.copy()'s scan order (_copy_scan_edges_np):
//   sources by view position, each source's pnet adjacency in insertion
//   order, every pair at its first encounter;
// - each level is one gn_split_flat, the core of pt_gn_split;
// - the communities, grouped by label in view order and each sorted, face
//   _max_collision_arrays' test (over the component's edges, counted with
//   multiplicity) and are split again or kept, depth first.

namespace {

// A CPython set of ints (hash(i) == i), slot for slot as
// Objects/setobject.c fills it: set_add_entry's 9 linear probes and then
// perturbed jumps, growth once fill*5 >= mask*3 to the least power of two
// above used*4 (used*2 past 50,000), set_insert_clean's reinsertion in
// the old table's slot order.  Iteration walks the slots in order.  Keys
// are never deleted, so the table holds no dummies.
class PySetReplay {
  public:
    void clear() {
        table_.assign(kMinSize, -1);
        mask_ = kMinSize - 1;
        fill_ = 0;
    }

    void add(int64_t key) {
        size_t perturb = (size_t)key;
        size_t i = (size_t)key & mask_;
        while (true) {
            const size_t last = i + kLinearProbes <= mask_ ? i + kLinearProbes : i;
            for (size_t j = i; j <= last; j++) {
                if (table_[j] < 0) {
                    table_[j] = key;
                    if (++fill_ * 5 >= mask_ * 3)
                        resize(fill_ > 50000 ? fill_ * 2 : fill_ * 4);
                    return;
                }
                if (table_[j] == key) return;
            }
            perturb >>= kPerturbShift;
            i = (i * 5 + 1 + perturb) & mask_;
        }
    }

    void order(std::vector<int64_t>& out) const {
        out.clear();
        for (int64_t key : table_)
            if (key >= 0) out.push_back(key);
    }

  private:
    static constexpr size_t kMinSize = 8, kLinearProbes = 9;
    static constexpr int kPerturbShift = 5;

    void resize(size_t minused) {
        size_t size = kMinSize;
        while (size <= minused) size <<= 1;
        old_.swap(table_);
        table_.assign(size, -1);
        mask_ = size - 1;
        for (int64_t key : old_)
            if (key >= 0) insert_clean(key);
    }

    void insert_clean(int64_t key) {
        size_t perturb = (size_t)key;
        size_t i = (size_t)key & mask_;
        while (true) {
            const size_t last = i + kLinearProbes <= mask_ ? i + kLinearProbes : i;
            for (size_t j = i; j <= last; j++) {
                if (table_[j] < 0) {
                    table_[j] = key;
                    return;
                }
            }
            perturb >>= kPerturbShift;
            i = (i * 5 + 1 + perturb) & mask_;
        }
    }

    std::vector<int64_t> table_, old_;
    size_t mask_ = 0, fill_ = 0;
};

// One thread's arrays for GN levels, reused from level to level.
struct GnScratch {
    std::vector<int32_t> off, len, nbr, eid;     // live adjacency (CSR)
    std::vector<int32_t> pred_v, pred_e, npred;  // preds at adjacency offsets
    std::vector<int32_t> dist, queue, mark;
    std::vector<double> bet, sigma, delta;
    int32_t stamp = 0;
};

// Labels the connected components of the live graph, numbered in order of
// their first node; returns their number.
int32_t label_components(int32_t k, GnScratch& g, int32_t* labels) {
    std::fill(labels, labels + k, -1);
    int32_t n_comp = 0;
    for (int32_t s = 0; s < k; s++) {
        if (labels[s] >= 0) continue;
        labels[s] = n_comp;
        int32_t head = 0, tail = 0;
        g.queue[tail++] = s;
        while (head < tail) {
            const int32_t v = g.queue[head++];
            for (int32_t j = g.off[v]; j < g.off[v] + g.len[v]; j++) {
                const int32_t w = g.nbr[j];
                if (labels[w] < 0) {
                    labels[w] = n_comp;
                    g.queue[tail++] = w;
                }
            }
        }
        n_comp++;
    }
    return n_comp;
}

// Whether b is reachable from a in the live graph.
bool reaches(int32_t a, int32_t b, GnScratch& g) {
    const int32_t stamp = ++g.stamp;
    int32_t head = 0, tail = 0;
    g.queue[tail++] = a;
    g.mark[a] = stamp;
    while (head < tail) {
        const int32_t v = g.queue[head++];
        for (int32_t j = g.off[v]; j < g.off[v] + g.len[v]; j++) {
            const int32_t w = g.nbr[j];
            if (w == b) return true;
            if (g.mark[w] != stamp) {
                g.mark[w] = stamp;
                g.queue[tail++] = w;
            }
        }
    }
    return false;
}

// One Girvan-Newman split level (netclu_ng.py:101-115 via networkx
// girvan_newman) over k nodes and the m edges (ea[e], eb[e]): repeatedly
// remove the max-edge-betweenness edge until the number of connected
// components increases; labels receives the components, removed (may be
// null) the removed edge ids in order of removal.
//
// Bit-parity with networkx 3.x is preserved by mirroring its exact
// iteration and float accumulation order:
// - nodes are 0..k-1 in the caller's insertion order (first appearance
//   in the .net edge stream, like PangeneNet/netclu's dict order),
// - adjacency lists keep edge-insertion order: one CSR whose removed
//   edges are compacted out in place, the order of what stays kept,
// - Brandes' BFS accumulation (_single_source_shortest_path_basic +
//   _accumulate_edges) runs per source in node order with float64 sums
//   in identical order; each node's preds sit at its own adjacency
//   offsets, and the BFS queue is the visit order S,
// - rescale multiplies every edge by 1/(k*(k-1)) (normalized=True),
// - the argmax replicates max() over the G.edges() iteration order
//   (first endpoint in node order, neighbors in adjacency order,
//   skipping earlier-source nodes), keeping the FIRST maximum on ties,
// - a removal adds a component exactly when its endpoints (not a
//   self-loop's) no longer reach each other.
void gn_split_flat(int32_t k, int64_t m, const int32_t* ea, const int32_t* eb,
                   int32_t* labels, std::vector<int32_t>* removed,
                   GnScratch& g) {
    g.off.assign(k + 1, 0);
    for (int64_t e = 0; e < m; e++) {
        g.off[ea[e] + 1]++;
        g.off[eb[e] + 1]++;
    }
    for (int32_t v = 0; v < k; v++) g.off[v + 1] += g.off[v];
    g.len.assign(k, 0);
    g.nbr.resize(2 * m);
    g.eid.resize(2 * m);
    for (int64_t e = 0; e < m; e++) {
        const int32_t a = ea[e], b = eb[e];
        const int32_t ia = g.off[a] + g.len[a]++;
        g.nbr[ia] = b;
        g.eid[ia] = (int32_t)e;
        const int32_t ib = g.off[b] + g.len[b]++;
        g.nbr[ib] = a;
        g.eid[ib] = (int32_t)e;
    }
    g.pred_v.resize(2 * m);
    g.pred_e.resize(2 * m);
    g.npred.assign(k, 0);
    g.dist.assign(k, -1);
    g.queue.resize(k);
    g.mark.assign(k, 0);
    g.stamp = 0;
    g.sigma.assign(k, 0.0);
    g.delta.assign(k, 0.0);
    g.bet.resize(m);

    const int32_t original = label_components(k, g, labels);
    int32_t current = original;
    const double scale = 1.0 / ((double)k * (double)(k - 1));
    while (current <= original) {
        std::fill(g.bet.begin(), g.bet.end(), 0.0);
        for (int32_t s = 0; s < k; s++) {
            g.sigma[s] = 1.0;
            g.dist[s] = 0;
            int32_t head = 0, tail = 0;
            g.queue[tail++] = s;
            while (head < tail) {
                const int32_t v = g.queue[head++];
                const int32_t dv = g.dist[v];
                const double sv = g.sigma[v];
                for (int32_t j = g.off[v]; j < g.off[v] + g.len[v]; j++) {
                    const int32_t w = g.nbr[j];
                    if (g.dist[w] < 0) {
                        g.queue[tail++] = w;
                        g.dist[w] = dv + 1;
                    }
                    if (g.dist[w] == dv + 1) {
                        g.sigma[w] += sv;
                        const int32_t slot = g.off[w] + g.npred[w]++;
                        g.pred_v[slot] = v;
                        g.pred_e[slot] = g.eid[j];
                    }
                }
            }
            for (int32_t t = tail - 1; t >= 0; t--) {
                const int32_t w = g.queue[t];
                const double coeff = (1.0 + g.delta[w]) / g.sigma[w];
                const int32_t* pv = &g.pred_v[g.off[w]];
                const int32_t* pe = &g.pred_e[g.off[w]];
                for (int32_t i = 0; i < g.npred[w]; i++) {
                    const double c = g.sigma[pv[i]] * coeff;
                    g.bet[pe[i]] += c;
                    g.delta[pv[i]] += c;
                }
            }
            for (int32_t t = 0; t < tail; t++) {
                const int32_t w = g.queue[t];
                g.sigma[w] = 0.0;
                g.dist[w] = -1;
                g.delta[w] = 0.0;
                g.npred[w] = 0;
            }
        }
        for (int64_t e = 0; e < m; e++) g.bet[e] *= scale;

        int64_t best = -1;
        double best_val = 0.0;
        for (int32_t u = 0; u < k; u++) {
            for (int32_t j = g.off[u]; j < g.off[u] + g.len[u]; j++) {
                if (g.nbr[j] < u) continue;  // seen from its lower endpoint
                const int32_t e = g.eid[j];
                if (best < 0 || g.bet[e] > best_val) {
                    best = e;
                    best_val = g.bet[e];
                }
            }
        }
        if (best < 0) break;  // no edges left (degenerate)
        for (const int32_t x : {ea[best], eb[best]}) {
            int32_t* nb = &g.nbr[g.off[x]];
            int32_t* id = &g.eid[g.off[x]];
            int32_t i = 0;
            while (id[i] != best) i++;
            for (; i + 1 < g.len[x]; i++) {
                nb[i] = nb[i + 1];
                id[i] = id[i + 1];
            }
            g.len[x]--;
        }
        if (removed) removed->push_back((int32_t)best);
        if (ea[best] != eb[best] && !reaches(ea[best], eb[best], g)) current++;
    }
    label_components(k, g, labels);
}

// What every thread reads and writes: the flat inputs of all components
// and the output arrays, where each component owns its own slots.
struct FamiliesCall {
    int64_t n_total;
    const int64_t *members, *member_off, *eu, *ev, *edge_off, *rank, *genome;
    int64_t n_ids, n_genomes;
    int64_t *out_members, *out_sizes, *out_n_families, *out_levels;
};

// One thread's state: a component's local graph and the recursion.
class ComponentSplitter {
  public:
    explicit ComponentSplitter(const FamiliesCall& call)
        : call_(call), local_(call.n_ids, -1), gcount_(call.n_genomes, 0) {}

    // Splits component c; appends its levels to `trace` if non-null.
    void run(int64_t c, std::vector<int64_t>* trace) {
        trace_ = trace;
        const int64_t m0 = call_.member_off[c], m1 = call_.member_off[c + 1];
        const int32_t sz = (int32_t)(m1 - m0);
        order_.assign(call_.members + m0, call_.members + m1);
        std::sort(order_.begin(), order_.end(), [&](int64_t a, int64_t b) {
            return call_.rank[a] < call_.rank[b];
        });
        gen_.resize(sz);
        for (int32_t i = 0; i < sz; i++) {
            local_[order_[i]] = i;
            gen_[i] = call_.genome[order_[i]];
        }
        // pnet's adjacency: per edge in .net order, v onto u's list, u onto v's
        const int64_t e0 = call_.edge_off[c], e1 = call_.edge_off[c + 1];
        padj_off_.assign(sz + 1, 0);
        for (int64_t e = e0; e < e1; e++) {
            padj_off_[local_[call_.eu[e]] + 1]++;
            padj_off_[local_[call_.ev[e]] + 1]++;
        }
        for (int32_t v = 0; v < sz; v++) padj_off_[v + 1] += padj_off_[v];
        padj_.resize(2 * (e1 - e0));
        fillpos_.assign(padj_off_.begin(), padj_off_.end() - 1);
        for (int64_t e = e0; e < e1; e++) {
            const int32_t u = local_[call_.eu[e]], v = local_[call_.ev[e]];
            padj_[fillpos_[u]++] = v;
            padj_[fillpos_[v]++] = u;
        }
        in_.assign(sz, 0);
        pos_.assign(sz, -1);
        last_.resize(sz);

        // coco: the BFS set from comp_order[0], filled in visit order
        std::vector<int32_t> bfs(1, 0);
        in_[0] = 1;
        for (size_t h = 0; h < bfs.size(); h++)
            for (int32_t j = padj_off_[bfs[h]]; j < padj_off_[bfs[h] + 1]; j++)
                if (!in_[padj_[j]]) {
                    in_[padj_[j]] = 1;
                    bfs.push_back(padj_[j]);
                }
        set_.clear();
        for (int32_t v : bfs) {
            in_[v] = 0;
            set_.add(order_[v]);
        }
        std::vector<int64_t> coco;
        set_.order(coco);

        fam_members_.clear();
        fam_sizes_.clear();
        levels_ = 0;
        level(coco);

        std::copy(fam_members_.begin(), fam_members_.end(),
                  call_.out_members + m0);
        std::copy(fam_sizes_.begin(), fam_sizes_.end(), call_.out_sizes + m0);
        call_.out_n_families[c] = (int64_t)fam_sizes_.size();
        call_.out_levels[c] = levels_;
        for (int64_t x : order_) local_[x] = -1;
    }

  private:
    // One split_until_max_k level over `bunch`, in its insertion order.
    void level(const std::vector<int64_t>& bunch) {
        levels_++;
        std::vector<int64_t> view;
        set_.clear();
        for (int64_t x : bunch) set_.add(x);
        if (2 * (int64_t)bunch.size() < call_.n_total) {
            set_.order(view);
        } else {
            for (int64_t x : bunch) in_[local_[x]] = 1;
            for (int64_t x : order_)
                if (in_[local_[x]]) view.push_back(x);
            for (int64_t x : bunch) in_[local_[x]] = 0;
        }
        const int32_t k = (int32_t)view.size();

        // Graph.copy()'s scan: (p, q) with p < q at its first encounter
        ea_.clear();
        eb_.clear();
        for (int32_t p = 0; p < k; p++) {
            pos_[local_[view[p]]] = p;
            last_[p] = -1;
        }
        for (int32_t p = 0; p < k; p++) {
            const int32_t x = local_[view[p]];
            for (int32_t j = padj_off_[x]; j < padj_off_[x + 1]; j++) {
                const int32_t q = pos_[padj_[j]];
                if (q > p && last_[q] != p) {
                    last_[q] = p;
                    ea_.push_back(p);
                    eb_.push_back(q);
                }
            }
        }
        for (int32_t p = 0; p < k; p++) pos_[local_[view[p]]] = -1;

        labels_.resize(k);
        removed_.clear();
        gn_split_flat(k, (int64_t)ea_.size(), ea_.data(), eb_.data(),
                      labels_.data(), trace_ ? &removed_ : nullptr, gn_);
        if (trace_) {
            trace_->push_back(k);
            trace_->insert(trace_->end(), view.begin(), view.end());
            trace_->push_back((int64_t)removed_.size());
            for (int32_t e : removed_) {
                trace_->push_back(ea_[e]);
                trace_->push_back(eb_[e]);
            }
        }

        // communities by label, members in view order, then each sorted
        const int32_t n_lab =
            k ? *std::max_element(labels_.begin(), labels_.end()) + 1 : 0;
        std::vector<int32_t> start(n_lab + 1, 0);
        for (int32_t p = 0; p < k; p++) start[labels_[p] + 1]++;
        for (int32_t l = 0; l < n_lab; l++) start[l + 1] += start[l];
        std::vector<int64_t> coms(k);
        std::vector<int32_t> fill(start.begin(), start.end() - 1);
        for (int32_t p = 0; p < k; p++) coms[fill[labels_[p]]++] = view[p];
        for (int32_t l = 0; l < n_lab; l++) {
            std::vector<int64_t> com(coms.begin() + start[l],
                                     coms.begin() + start[l + 1]);
            std::sort(com.begin(), com.end());
            if (max_collision(com) > 0) {
                level(com);
            } else {
                fam_members_.insert(fam_members_.end(), com.begin(), com.end());
                fam_sizes_.push_back((int64_t)com.size());
            }
        }
    }

    // _max_collision_arrays: per member, its genome's count in `com` less
    // one less its same-genome edges inside `com`; the largest, or 0.
    int64_t max_collision(const std::vector<int64_t>& com) {
        for (int64_t x : com) {
            in_[local_[x]] = 1;
            gcount_[gen_[local_[x]]]++;
        }
        int64_t most = 0;
        for (int64_t x : com) {
            const int32_t l = local_[x];
            int64_t same = 0;
            for (int32_t j = padj_off_[l]; j < padj_off_[l + 1]; j++)
                same += in_[padj_[j]] && gen_[padj_[j]] == gen_[l];
            most = std::max(most, gcount_[gen_[l]] - 1 - same);
        }
        for (int64_t x : com) {
            in_[local_[x]] = 0;
            gcount_[gen_[local_[x]]] = 0;
        }
        return most;
    }

    const FamiliesCall& call_;
    std::vector<int32_t> local_;   // global id -> rank in comp_order, else -1
    std::vector<int64_t> gcount_;  // per genome, inside max_collision
    std::vector<int64_t> order_, gen_;
    std::vector<int32_t> padj_off_, padj_, fillpos_;
    std::vector<uint8_t> in_;
    std::vector<int32_t> pos_, last_, ea_, eb_, labels_, removed_;
    std::vector<int64_t> fam_members_, fam_sizes_;
    std::vector<int64_t>* trace_ = nullptr;
    int64_t levels_ = 0;
    PySetReplay set_;
    GnScratch gn_;
};

// ---------------------------------------------------------------------------
// The .net writer's lines (io/net.py::write_net): "a\tb\tscore\n" an edge,
// the f32 score widened to double and printed as Java's Double.toString
// prints it (PangeneNet.java:171), which io/net.py::java_double_str
// renders: the shortest digits that round-trip, plain in [1e-3, 1e7) with
// ".0" on integral values, else d.dddE<exp> with a bare exponent.

constexpr int64_t kLinesPerThread = 1 << 16;  // the least a thread takes
constexpr size_t kMaxLine = 2 * 20 + 2 + 32 + 1;  // 2 int64, 2 tabs, score, \n

char* put(char* p, const char* s, size_t n) {
    memcpy(p, s, n);
    return p + n;
}

char* java_double(char* p, double v) {
    if (std::isnan(v)) return put(p, "NaN", 3);
    if (std::signbit(v)) {
        *p++ = '-';
        v = -v;
    }
    if (std::isinf(v)) return put(p, "Infinity", 8);
    if (v == 0.0) return put(p, "0.0", 3);
    // shortest round-trip digits in scientific form: d[.ddd]e(+|-)xx
    char sci[40];
    const char* end =
        std::to_chars(sci, sci + sizeof sci, v, std::chars_format::scientific)
            .ptr;
    char digits[24];
    int n = 0;
    const char* q = sci;
    for (; *q != 'e'; q++)
        if (*q != '.') digits[n++] = *q;
    int exp = 0;
    std::from_chars(q + (q[1] == '+' ? 2 : 1), end, exp);
    if (v >= 1e-3 && v < 1e7) {  // plain: exp in [-3, 6]
        if (exp < 0) {
            p = put(p, "0.", 2);
            for (int i = 0; i < -exp - 1; i++) *p++ = '0';
            return put(p, digits, n);
        }
        for (int i = 0; i <= exp; i++) *p++ = i < n ? digits[i] : '0';
        *p++ = '.';
        if (n <= exp + 1) {
            *p++ = '0';
            return p;
        }
        return put(p, digits + exp + 1, n - exp - 1);
    }
    *p++ = digits[0];
    *p++ = '.';
    p = n > 1 ? put(p, digits + 1, n - 1) : put(p, "0", 1);
    *p++ = 'E';
    return std::to_chars(p, p + 8, exp).ptr;
}

// Lines [lo, hi) into a malloc'd buffer, grown as it fills.
struct NetChunk {
    char* buf = nullptr;
    size_t len = 0;
    bool ok = true;

    void format(const int64_t* a, const int64_t* b, const float* w,
                int64_t lo, int64_t hi) {
        size_t cap = (size_t)(hi - lo) * 32 + kMaxLine;
        buf = (char*)malloc(cap);
        if (!buf) {
            ok = false;
            return;
        }
        char* p = buf;
        for (int64_t i = lo; i < hi; i++) {
            if ((size_t)(p - buf) + kMaxLine > cap) {
                const size_t at = (size_t)(p - buf);
                cap += cap / 2;
                char* grown = (char*)realloc(buf, cap);
                if (!grown) {
                    ok = false;
                    return;
                }
                buf = grown;
                p = buf + at;
            }
            p = std::to_chars(p, p + 20, a[i]).ptr;
            *p++ = '\t';
            p = std::to_chars(p, p + 20, b[i]).ptr;
            *p++ = '\t';
            p = java_double(p, (double)w[i]);
            *p++ = '\n';
        }
        len = (size_t)(p - buf);
    }
};

}  // namespace

extern "C" {

// The .net text of the n edges (a[i], b[i], w[i]), in the order given,
// into a malloc'd buffer (release with pt_free) of *out_len bytes.
// n_threads threads (0: the host's cores), each taking at least
// kLinesPerThread lines, format contiguous chunks that are joined in order,
// so the bytes do not depend on the count; *out_threads receives the count
// used.  Returns 0, -1 on bad arguments, -3 if memory ran out.
int pt_format_net(const int64_t* a, const int64_t* b, const float* w,
                  int64_t n, int32_t n_threads, char** out_buf,
                  int64_t* out_len, int32_t* out_threads) {
    if (n < 0 || n_threads < 0 || !out_buf || !out_len || !out_threads)
        return -1;
    int64_t workers = n_threads ? n_threads
                                : (int64_t)std::thread::hardware_concurrency();
    workers = std::max<int64_t>(
        1, std::min(workers, (n + kLinesPerThread - 1) / kLinesPerThread));
    std::vector<NetChunk> chunks(workers);
    auto run = [&](int64_t t) {
        chunks[t].format(a, b, w, n * t / workers, n * (t + 1) / workers);
    };
    bool ok = true;
    if (workers == 1) {
        run(0);
    } else {
        std::vector<std::thread> pool;
        try {
            for (int64_t t = 0; t < workers; t++) pool.emplace_back(run, t);
        } catch (const std::system_error&) {
            ok = false;  // a chunk was never formatted
        }
        for (auto& th : pool) th.join();
    }
    size_t total = 0;
    for (const auto& c : chunks) {
        total += c.len;
        ok = ok && c.ok;
    }
    char* out = ok ? (char*)malloc(total ? total : 1) : nullptr;
    size_t at = 0;
    for (auto& c : chunks) {
        if (out) memcpy(out + at, c.buf, c.len);
        at += c.len;
        free(c.buf);  // one chunk at a time: at most twice the file held
    }
    if (!out) return -3;
    *out_buf = out;
    *out_len = (int64_t)total;
    *out_threads = (int32_t)workers;
    return 0;
}

// One Girvan-Newman split level over n nodes and the m edges (eu[e], ev[e])
// in insertion order (gn_split_flat): out_labels receives the components;
// out_removed (may be null; m + 1 slots) the removed edge ids in order of
// removal, closed by -1.  Returns 0, -1 on bad arguments.
int pt_gn_split(int32_t n, int64_t m, const int32_t* eu, const int32_t* ev,
                int32_t* out_labels, int64_t* out_removed) {
    if (n <= 0 || m < 0 || m > INT32_MAX) return -1;
    GnScratch g;
    std::vector<int32_t> removed;
    gn_split_flat(n, m, eu, ev, out_labels, out_removed ? &removed : nullptr,
                  g);
    if (out_removed) {
        std::copy(removed.begin(), removed.end(), out_removed);
        out_removed[removed.size()] = -1;  // closes the removal sequence
    }
    return 0;
}

// The iteration order of a CPython set filled with keys[0..n) in turn,
// into out (n slots); returns its length.  cluster.py holds this to
// list(set(...)) once a process before it trusts pt_gn_families.
int64_t pt_pyset_order(const int64_t* keys, int64_t n, int64_t* out) {
    PySetReplay set;
    set.clear();
    for (int64_t i = 0; i < n; i++) set.add(keys[i]);
    std::vector<int64_t> order;
    set.order(order);
    std::copy(order.begin(), order.end(), out);
    return (int64_t)order.size();
}

// Splits n_comp colliding components (component c: members
// members[member_off[c]:member_off[c+1]], global ids; edges
// (eu[e], ev[e]) for e in [edge_off[c], edge_off[c+1]), in .net order, no
// self-loops) on n_threads threads, which take components by an atomic
// index, the most edges first.  order_rank and seq_genome are indexed by
// global id (n_ids of them); n_total is pnet's node count.  Component c's
// families, each sorted, fill out_members from member_off[c] on, their
// sizes out_sizes from member_off[c] on; out_n_families[c] counts them,
// out_levels[c] its GN levels, out_seconds[c] its own wall.  With
// out_trace set, every level's k, view order, removal count and removed
// (p, q) view positions follow one another, component by component, in a
// malloc'd buffer (release with pt_free).  Returns 0, -1 on bad
// arguments, -3 if a thread failed.
int pt_gn_families(int64_t n_comp, int64_t n_total, int64_t n_ids,
                   const int64_t* members, const int64_t* member_off,
                   const int64_t* eu, const int64_t* ev,
                   const int64_t* edge_off, const int64_t* order_rank,
                   const int64_t* seq_genome, int32_t n_threads,
                   int64_t* out_members, int64_t* out_sizes,
                   int64_t* out_n_families, int64_t* out_levels,
                   double* out_seconds, int64_t** out_trace,
                   int64_t* out_trace_len) {
    if (n_comp < 0 || n_ids < 0) return -1;
    int64_t n_genomes = 1;
    for (int64_t i = 0; i < n_ids; i++)
        n_genomes = std::max(n_genomes, seq_genome[i] + 1);
    const FamiliesCall call{n_total, members, member_off, eu,
                            ev, edge_off, order_rank, seq_genome,
                            n_ids, n_genomes, out_members, out_sizes,
                            out_n_families, out_levels};
    std::vector<int64_t> work(n_comp);
    for (int64_t c = 0; c < n_comp; c++) work[c] = c;
    std::stable_sort(work.begin(), work.end(), [&](int64_t a, int64_t b) {
        return edge_off[a + 1] - edge_off[a] > edge_off[b + 1] - edge_off[b];
    });
    std::vector<std::vector<int64_t>> traces(out_trace ? n_comp : 0);
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};
    auto worker = [&]() {
        try {
            ComponentSplitter splitter(call);
            for (int64_t t = next++; t < n_comp && !failed; t = next++) {
                const int64_t c = work[t];
                const auto t0 = std::chrono::steady_clock::now();
                splitter.run(c, out_trace ? &traces[c] : nullptr);
                out_seconds[c] = std::chrono::duration<double>(
                                     std::chrono::steady_clock::now() - t0)
                                     .count();
            }
        } catch (...) {
            failed = true;
        }
    };
    const int64_t n_workers =
        std::max<int64_t>(1, std::min<int64_t>(n_threads, n_comp));
    if (n_workers == 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < n_workers; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    if (failed) return -3;
    if (out_trace) {
        int64_t len = 0;
        for (const auto& t : traces) len += (int64_t)t.size();
        int64_t* buf = (int64_t*)malloc(sizeof(int64_t) * (size_t)(len ? len : 1));
        if (!buf) return -3;
        int64_t at = 0;
        for (const auto& t : traces) {
            std::copy(t.begin(), t.end(), buf + at);
            at += (int64_t)t.size();
        }
        *out_trace = buf;
        *out_trace_len = len;
    }
    return 0;
}

}  // extern "C"
