"""The similarity network of PanDelos from a ``.faa``, in plain NumPy and
PyTorch: k selection, the k-mer multisets, the exact similarity of every
pair of genes that share a k-mer, and the bidirectional-best-hit (BBH)
network.  It shares no code with the program.

Semantics (upstream PanDelos: ``calculate_k.py``, ``ig/native/
library.cpp``, ``Pangenes.java``):

- k = floor(log_S(L) / H), L the residue count, S the number of distinct
  residues, H the residue entropy in base S;
- a gene's k-mer multiset has len - k + 1 windows (0 if shorter);
- for genes i != j sharing a k-mer: inter = sum of min(c_i, c_j),
  perc_cnt = sum of c_i, tr_cnt = sum of c_j over the shared k-mers;
  perc = perc_cnt / |i|, tr = tr_cnt / |j| and the score inter /
  (|i| + |j| - inter), each one float32 division; a pair is kept when
  perc >= 1/(2k) or tr >= 1/(2k) (in float32) and the score is > 0;
- BBH per row genome g: an inter-genome pair (i, j) is an edge when its
  score is the best of row i towards j's genome and the best of column
  j among g's rows; an intra-genome pair i < j is an edge when its score
  is the best of both rows towards g and at least the row's threshold,
  the least over its accepted target genomes of the best accepted score
  below 1 of g towards that genome.

The pair counts are summed on ``device`` (the card in a benchmark run) in
blocks of rows; the float arithmetic runs in NumPy, or with
``precision="bf16"`` in bfloat16 (the benchmark's control).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

# bytes of one block's three int32 pair accumulators
_BLOCK_BYTES = 1 << 31
# pair terms expanded at once
_TERMS = 1 << 26


def select_k(sequences: List[str]) -> int:
    blob = np.frombuffer("".join(sequences).encode("latin-1"), np.uint8)
    hist = np.bincount(blob, minlength=256)
    total = int(blob.size)
    counts = [int(c) for c in hist if c]
    base = len(counts)
    if total == 0 or base < 2:
        raise ValueError("cannot derive k: need a non-trivial alphabet")
    entropy = 0.0
    for c in counts:  # ascending residue code
        p = c / total
        entropy += -math.log(p, base) * p
    return math.floor(math.log(total, base) / entropy)


def kmer_entries(sequences: List[str], k: int, device):
    """(gene, k-mer id, count) of every k-mer of every gene, sorted by
    gene then id, and each gene's multiset size; ids are dense over the
    k-mers that occur."""
    lengths = np.array([len(s) for s in sequences], dtype=np.int64)
    n_windows = np.maximum(lengths - k + 1, 0)
    blob = np.frombuffer("".join(sequences).encode("latin-1"),
                         np.uint8).copy()
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    gene = np.repeat(np.arange(len(sequences), dtype=np.int64), n_windows)
    pos = (np.arange(int(n_windows.sum()), dtype=np.int64)
           - np.repeat(np.cumsum(n_windows) - n_windows, n_windows)
           + np.repeat(starts, n_windows))
    if k <= 8:  # a window's bytes as one integer
        b = torch.from_numpy(blob).to(device=device, dtype=torch.int64)
        p = torch.from_numpy(pos).to(device)
        key = torch.zeros_like(p)
        for j in range(k):
            key = key * 256 + b[p + j]
        _, kid = torch.unique(key, return_inverse=True)
    else:
        win = np.lib.stride_tricks.sliding_window_view(blob, k)[pos]
        win = np.ascontiguousarray(win).view(np.dtype((np.void, k)))[:, 0]
        _, inv = np.unique(win, return_inverse=True)
        kid = torch.from_numpy(inv.astype(np.int64)).to(device)
    g = torch.from_numpy(gene).to(device)
    n_ids = int(kid.max()) + 1 if kid.numel() else 1
    pair, count = torch.unique(g * n_ids + kid, return_counts=True)
    return pair // n_ids, pair % n_ids, count, n_windows


def pair_counts(sequences: List[str], k: int, device):
    """(rows, cols, inter, perc_cnt, tr_cnt, |gene|) of every ordered pair
    of distinct genes that share a k-mer, as host int64 arrays."""
    n = len(sequences)
    eg, ek, ec, n_windows = kmer_entries(sequences, k, device)
    # postings: each k-mer's entries, by k-mer
    order = torch.argsort(ek, stable=True)
    pg, pk, pc = eg[order], ek[order], ec[order]
    n_ids = int(pk.max()) + 1 if pk.numel() else 1
    plen = torch.bincount(pk, minlength=n_ids)
    pstart = torch.cumsum(plen, 0) - plen
    gene_ptr = torch.searchsorted(eg, torch.arange(n + 1, device=device))
    shared = plen[ek] >= 2  # a k-mer of one entry pairs with nothing
    rows_per_block = max(1, _BLOCK_BYTES // (12 * max(n, 1)))
    out = ([], [], [], [], [])
    for r0 in range(0, n, rows_per_block):
        r1 = min(n, r0 + rows_per_block)
        acc = torch.zeros((3, (r1 - r0) * n), dtype=torch.int32,
                          device=device)
        e0, e1 = int(gene_ptr[r0]), int(gene_ptr[r1])
        sel = torch.arange(e0, e1, device=device)[shared[e0:e1]]
        m = plen[ek[sel]]
        ends = torch.cumsum(m, 0)
        c0 = 0
        while c0 < len(sel):
            base = int(ends[c0 - 1]) if c0 else 0
            c1 = int(torch.searchsorted(ends, base + _TERMS, right=True))
            c1 = max(c1, c0 + 1)
            e = sel[c0:c1]
            src = torch.repeat_interleave(
                torch.arange(len(e), device=device), m[c0:c1])
            first = torch.cumsum(m[c0:c1], 0) - m[c0:c1]
            mate = pstart[ek[e]][src] + (
                torch.arange(len(src), device=device) - first[src])
            a, b = eg[e][src], pg[mate]
            ca, cb = ec[e][src], pc[mate]
            keep = a != b
            flat = ((a - r0) * n + b)[keep]
            ca, cb = ca[keep], cb[keep]
            acc[0].index_add_(0, flat, torch.minimum(ca, cb).to(torch.int32))
            acc[1].index_add_(0, flat, ca.to(torch.int32))
            acc[2].index_add_(0, flat, cb.to(torch.int32))
            c0 = c1
        hit = torch.nonzero(acc[1] > 0)[:, 0]
        vals = acc[:, hit].cpu().numpy().astype(np.int64)
        hit = hit.cpu().numpy()
        out[0].append(hit // n + r0)
        out[1].append(hit % n)
        for i in range(3):
            out[2 + i].append(vals[i])
        del acc
    cat = [np.concatenate(x) if x else np.zeros(0, np.int64) for x in out]
    return (*cat, n_windows)


def finalize(rows, cols, inter, perc_cnt, tr_cnt, n_windows, k: int,
             precision: str = "f32") -> Tuple[np.ndarray, ...]:
    """(rows, cols, score as float32) of the kept pairs.  ``precision``
    ``"bf16"`` does every division and comparison in bfloat16."""
    a = n_windows[rows]
    b = n_windows[cols]
    union = a + b - inter
    if precision == "f32":
        f = np.float32
        thr = f(1.0) / (f(2.0) * f(k))
        perc = perc_cnt.astype(f) / a.astype(f)
        tr = tr_cnt.astype(f) / b.astype(f)
        score = inter.astype(f) / union.astype(f)
    elif precision == "bf16":
        def h(x):
            return torch.from_numpy(np.asarray(x)).to(torch.bfloat16)
        thr = h(1.0) / (h(2.0) * h(float(k)))
        perc = (h(perc_cnt) / h(a)).float().numpy()
        tr = (h(tr_cnt) / h(b)).float().numpy()
        score = (h(inter) / h(union)).float().numpy()
        thr = np.float32(thr.float().item())
    else:
        raise ValueError(f"unknown precision {precision!r}")
    keep = ((perc >= thr) | (tr >= thr)) & (score > 0)
    return rows[keep], cols[keep], score[keep].astype(np.float32)


def _group_max(keys, vals):
    """The largest value of each distinct key: (sorted keys, maxima)."""
    order = np.lexsort((vals, keys))
    k, v = keys[order], vals[order]
    last = np.flatnonzero(np.r_[k[1:] != k[:-1], True])
    return k[last], v[last]


def _lookup(keys, table_keys, table_vals, default):
    i = np.searchsorted(table_keys, keys)
    i = np.minimum(i, max(len(table_keys) - 1, 0))
    found = (table_keys[i] == keys) if len(table_keys) else np.zeros(
        len(keys), bool)
    out = np.full(len(keys), default, dtype=table_vals.dtype)
    out[found] = table_vals[i[found]]
    return out


def bbh_network(rows, cols, score, genome, n_genomes: int):
    """The BBH edges as (a, b, weight) arrays, a < b, sorted by (a, b)."""
    genome = np.asarray(genome, dtype=np.int64)
    n = len(genome)
    gr, gc = genome[rows], genome[cols]
    zero = np.float32(0.0)
    best_k, best_v = _group_max(rows * n_genomes + gc, score)
    col_k, col_v = _group_max(gr * n + cols, score)
    best = _lookup(rows * n_genomes + gc, best_k, best_v, zero)
    colbest = _lookup(gr * n + cols, col_k, col_v, zero)
    inter = (gc != gr) & (score == best) & (score == colbest)
    below = inter & (score < np.float32(1.0))
    top_k, top_v = _group_max((gr * n_genomes + gc)[below], score[below])
    top = _lookup((gr * n_genomes + gc)[inter], top_k, top_v, zero)
    threshold = np.full(n, np.float32(np.inf), dtype=np.float32)
    np.minimum.at(threshold, rows[inter], top)
    best_ji = _lookup(cols * n_genomes + gr, best_k, best_v, zero)
    intra = ((rows < cols) & (gc == gr) & (score == best)
             & (score == best_ji) & (score >= threshold[rows]))
    # the first occurrence in Pangenes.java's order keeps its weight:
    # row genome, inter before intra, then (row, col)
    sel = np.flatnonzero(inter | intra)
    phase = np.where(intra[sel], 1, 0)
    sel = sel[np.lexsort((cols[sel], rows[sel], phase, gr[sel]))]
    a = np.minimum(rows[sel], cols[sel])
    b = np.maximum(rows[sel], cols[sel])
    key = a * n + b
    _, first = np.unique(key, return_index=True)
    return a[first], b[first], score[sel][first]
