"""Exact host-side oracle for the similarity cells.

Semantic twin of the native scoring kernel (``library.cpp:409-527``) used as
the correctness oracle for the TPU path: for every ordered gene pair (i, j),
i != j, sharing at least one k-mer, accumulate over the shared k-mer ids r:

- ``intersection += min(count_i(r), count_j(r))``   (library.cpp:475)
- ``perc_cnt     += count_i(r)``                    (library.cpp:476)
- ``tr_perc_cnt  += count_j(r)``                    (library.cpp:477)

It walks a vocabulary-major posting list exactly like the reference's
inverted index, so its cost matches the reference's "total lookups"
complexity model (library.cpp:327).  All arithmetic is integer and exact;
score finalization lives in :mod:`pandelos_tpu_torch.net` shared with the TPU
path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pandelos_tpu_torch.index import KmerIndex


@dataclasses.dataclass
class ScoreCells:
    """Sparse ordered-pair accumulator cells (integer, pre-finalization)."""

    row: np.ndarray  # int32 [n]
    col: np.ndarray  # int32 [n]
    intersection: np.ndarray  # int64 [n]
    perc_cnt: np.ndarray  # int64 [n]  (sum of row counts over shared ids)
    tr_perc_cnt: np.ndarray  # int64 [n] (sum of col counts over shared ids)

    def __len__(self):
        return len(self.row)

    def sort(self) -> "ScoreCells":
        order = np.lexsort((self.col, self.row))
        return ScoreCells(
            self.row[order],
            self.col[order],
            self.intersection[order],
            self.perc_cnt[order],
            self.tr_perc_cnt[order],
        )


def apply_validity(cells: ScoreCells, kseq_lengths, k: int) -> ScoreCells:
    """Drop cells failing the 1/(2k) validity threshold (exact integer
    form of library.cpp:499-500) — mirrors the device-side filter."""
    a = np.asarray(kseq_lengths)[cells.row].astype(np.int64)
    b = np.asarray(kseq_lengths)[cells.col].astype(np.int64)
    keep = (2 * k * cells.perc_cnt >= a) | (2 * k * cells.tr_perc_cnt >= b)
    return ScoreCells(
        cells.row[keep],
        cells.col[keep],
        cells.intersection[keep],
        cells.perc_cnt[keep],
        cells.tr_perc_cnt[keep],
    )


def _posting_csr(index: KmerIndex):
    """Vocabulary-major postings: for each shared k-mer id, the (gene,
    count) entries — the analogue of kmers_ranges (library.cpp:297-335)."""
    order = np.argsort(index.profile_ids, kind="stable")
    post_gene_order = np.repeat(
        np.arange(index.n_sequences, dtype=np.int64),
        np.diff(index.profile_ptr),
    )[order]
    post_count = index.profile_counts[order].astype(np.int64)
    sizes = np.bincount(index.profile_ids, minlength=index.vocab_size)
    post_ptr = np.zeros(index.vocab_size + 1, dtype=np.int64)
    np.cumsum(sizes, out=post_ptr[1:])
    return post_ptr, post_gene_order.astype(np.int32), post_count


def compute_cells_oracle(index: KmerIndex) -> ScoreCells:
    return cells_of_rows(index, range(index.n_sequences))


def cells_of_rows(index: KmerIndex, rows) -> ScoreCells:
    """Every cell (i, j), i in ``rows``, j != i sharing a k-mer, by the
    posting walk; the cells of each row in ascending column order."""
    post_ptr, post_gene, post_count = _posting_csr(index)
    G = index.n_sequences

    rows_out = []
    cols_out = []
    inter_out = []
    perc_out = []
    tr_out = []

    for i in rows:
        s, e = index.profile_ptr[i], index.profile_ptr[i + 1]
        if e == s:
            continue
        ids = index.profile_ids[s:e]
        my_counts = index.profile_counts[s:e].astype(np.int64)

        # Gather all posting entries for this gene's shared ids.
        lens = post_ptr[ids + 1] - post_ptr[ids]
        other_gene = np.concatenate(
            [post_gene[post_ptr[v] : post_ptr[v + 1]] for v in ids]
        )
        other_count = np.concatenate(
            [post_count[post_ptr[v] : post_ptr[v + 1]] for v in ids]
        )
        mine = np.repeat(my_counts, lens)

        keep = other_gene != i
        other_gene = other_gene[keep]
        other_count = other_count[keep]
        mine = mine[keep]
        if other_gene.size == 0:
            continue

        inter = np.zeros(G, dtype=np.int64)
        perc = np.zeros(G, dtype=np.int64)
        tr = np.zeros(G, dtype=np.int64)
        np.add.at(inter, other_gene, np.minimum(other_count, mine))
        np.add.at(perc, other_gene, mine)
        np.add.at(tr, other_gene, other_count)

        touched = np.flatnonzero(inter)
        rows_out.append(np.full(touched.shape, i, dtype=np.int32))
        cols_out.append(touched.astype(np.int32))
        inter_out.append(inter[touched])
        perc_out.append(perc[touched])
        tr_out.append(tr[touched])

    if not rows_out:
        z32 = np.zeros(0, dtype=np.int32)
        z64 = np.zeros(0, dtype=np.int64)
        return ScoreCells(z32, z32, z64, z64, z64)
    return ScoreCells(
        np.concatenate(rows_out),
        np.concatenate(cols_out),
        np.concatenate(inter_out),
        np.concatenate(perc_out),
        np.concatenate(tr_out),
    )
