"""K-mer multiset index: what replaces the reference native core's
preprocessing phase (``ig/native/library.cpp:189-371``).

Reference behaviour being replaced (not translated):
- alphabet census + dense char ranks (``library.cpp:216-230, 88-132``),
- rolling polynomial ranks with a Rabin-Karp hash fallback on overflow
  (``library.cpp:75-86, 134-150``),
- LSD radix sort + dedup into (rank, seq, count) multiset entries
  (``library.cpp:270-287``),
- inverted index of posting ranges, dropping singleton ranks
  (``library.cpp:297-335``),
- per-sequence computation costs for the ``-c`` complexity mode
  (``library.cpp:327, 337-370``).

TPU-first redesign: instead of a 64-bit rank inverted index walked by
pointer-chasing, every k-mer is mapped to a **dense int32 vocabulary id**
(global sorted order of occurring k-mers) so the device only ever sees
int32; per-gene profiles become CSR (id, count) arrays sorted by id.  K-mers
occurring in a single (gene) entry are pruned from the profiles — they can
never contribute to an intersection (same pruning as the reference's
singleton-rank drop) — while full multiset cardinalities ``kseq_lengths``
are kept for union/perc denominators.

Exactness note: the reference identifies k-mers by exact polynomial rank,
falling back to a Rabin-Karp hash mod 2^64-59 when base^(k) overflows
(``library.cpp:105-131``).  Here k-mer identity is always exact (packed
integer rank when it fits in uint64, lexicographic bytes otherwise), which
is semantically identical to the exact-rank path and differs from the hash
path only in the astronomically unlikely event of a 64-bit hash collision.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from pandelos_tpu_torch import tracing
from pandelos_tpu_torch.io.faa import FaaDataset

# The reference's hardcoded throughput model used for the -c mode ETA
# (library.cpp:352).
REFERENCE_OPS_PER_MS = 40505.500586716735


@dataclasses.dataclass
class KmerIndex:
    k: int
    n_sequences: int
    n_genomes: int
    seq_genome: np.ndarray  # int32 [G]
    kseq_lengths: np.ndarray  # int32 [G]: len-k+1 (or 0), multiset |A|
    total_vocab: int  # distinct k-mers overall
    vocab_size: int  # distinct k-mers shared by >= 2 (gene) entries
    # CSR profiles over the shared vocabulary, per gene sorted by id:
    profile_ptr: np.ndarray  # int64 [G+1]
    profile_ids: np.ndarray  # int32 [nnz]
    profile_counts: np.ndarray  # int32 [nnz]
    computation_costs: np.ndarray  # int64 [G]: reference "total_visited"
    # not a field (neither saved nor compared): True where build_index
    # built the arrays on a card
    on_card = False

    @property
    def max_profile_len(self) -> int:
        if self.n_sequences == 0:
            return 0
        return int(np.max(np.diff(self.profile_ptr)))

    def profile(self, i: int):
        s, e = self.profile_ptr[i], self.profile_ptr[i + 1]
        return self.profile_ids[s:e], self.profile_counts[s:e]

    def complexity_report(self) -> dict:
        """The -c mode report (library.cpp:337-370): total lookups, linear
        ratio, and an ETA using the reference's own throughput constant."""
        total = int(self.computation_costs.sum())
        total_len = int(self.kseq_lengths.sum())
        return {
            "total_lookups": total,
            "linear_ratio": (total / total_len) if total_len else 0.0,
            "reference_eta_ms": total / REFERENCE_OPS_PER_MS,
        }

    def save(self, path: str) -> None:
        """Checkpoint the index (SURVEY §5: index shards must be resumable)."""
        np.savez_compressed(
            path,
            k=self.k,
            n_sequences=self.n_sequences,
            n_genomes=self.n_genomes,
            seq_genome=self.seq_genome,
            kseq_lengths=self.kseq_lengths,
            total_vocab=self.total_vocab,
            vocab_size=self.vocab_size,
            profile_ptr=self.profile_ptr,
            profile_ids=self.profile_ids,
            profile_counts=self.profile_counts,
            computation_costs=self.computation_costs,
        )

    @staticmethod
    def from_arrays(d: dict) -> "KmerIndex":
        """An index from its fields as plain values and numpy arrays —
        e.g. ``dataclasses.asdict`` of another implementation's index or
        an ``np.load`` of :meth:`save`'s file — so that two engines can
        be fed the very same index."""
        fields = [f.name for f in dataclasses.fields(KmerIndex)]
        missing = [f for f in fields if f not in d]
        if missing:
            raise KeyError(f"index arrays lack {missing}")
        kw = {f: d[f] for f in fields}
        for f in ("k", "n_sequences", "n_genomes", "total_vocab", "vocab_size"):
            kw[f] = int(kw[f])
        dtypes = {
            "seq_genome": np.int32,
            "kseq_lengths": np.int32,
            "profile_ptr": np.int64,
            "profile_ids": np.int32,
            "profile_counts": np.int32,
            "computation_costs": np.int64,
        }
        for f, dt in dtypes.items():
            kw[f] = np.ascontiguousarray(kw[f], dtype=dt)
        return KmerIndex(**kw)

    @staticmethod
    def load(path: str) -> "KmerIndex":
        return KmerIndex.from_arrays(dict(np.load(path)))


def _encode_sequences(sequences: List[str]):
    """Concatenate all sequences as uint8 codes with per-gene offsets."""
    try:
        blobs = [s.encode("latin-1") for s in sequences]
    except UnicodeEncodeError as e:
        raise ValueError(
            "sequence contains characters outside the byte range; the "
            "reference only ranks chars < 256 (library.cpp:222-226)"
        ) from e
    lengths = np.array([len(b) for b in blobs], dtype=np.int64)
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    if offsets[-1] == 0:
        return np.zeros(0, dtype=np.uint8), offsets, lengths
    concat = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    return concat, offsets, lengths


def _window_keys(concat: np.ndarray, k: int, alphabet_codes: np.ndarray):
    """Exact integer key per window start position of the concatenated
    residue array.  Keys for windows crossing gene boundaries are junk and
    must be masked by the caller."""
    # Dense rank per used char, in ascending char-code order — the same
    # assignment rule as rank_init (library.cpp:96-100).
    rank_values = np.zeros(256, dtype=np.uint64)
    rank_values[alphabet_codes] = np.arange(len(alphabet_codes), dtype=np.uint64)
    base = np.uint64(len(alphabet_codes))
    n = concat.shape[0] - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    coded = rank_values[concat]
    if int(len(alphabet_codes)) ** k < 2**64:
        keys = np.zeros(n, dtype=np.uint64)
        for j in range(k):
            keys *= base
            keys += coded[j : j + n]
        return keys
    # Wide-k fallback: exact lexicographic identity via byte packing into
    # ceil(k/8) big-endian uint64 limbs (alphabet <= 256, arbitrary k —
    # the reference would switch to its Rabin-Karp hash here,
    # library.cpp:81-86; exact packing is strictly stronger).  np.unique
    # on the structured array compares field-by-field, so limb order ==
    # lexicographic k-mer order.
    n_limbs = (k + 7) // 8
    pad = n_limbs * 8 - k
    out = np.zeros(n, dtype=[(f"l{i}", np.uint64) for i in range(n_limbs)])
    for j in range(k):
        f = f"l{(j + pad) // 8}"
        out[f] = out[f] * np.uint64(256) + coded[j : j + n]
    return out


def build_index(
    ds: FaaDataset,
    k: Optional[int] = None,
    only_complexity: bool = False,
    device=None,
) -> KmerIndex:
    """The index of ``ds`` at ``k`` (chosen by entropy when None).  Where
    the packed key fits in 63 bits and the windows stay under 2^31, which
    the host decides before anything goes up
    (:func:`~pandelos_tpu_torch.ops.kmer_index.fits_packed_key`), it is
    built on ``device``, the CPU when None
    (:func:`~pandelos_tpu_torch.ops.kmer_index.index_on_device`, span
    ``index.device``: the kernels on a card, their plain twin elsewhere);
    otherwise by NumPy on the host.  Both give the same arrays;
    ``KmerIndex.on_card`` says whether a card built them.  With
    ``only_complexity`` the profiles are left empty."""
    from pandelos_tpu_torch.ksel import select_k
    from pandelos_tpu_torch.ops import kmer_index

    if k is None:
        k = select_k(ds.sequences)
    if k <= 0:
        raise ValueError("K value must be greater than 0")

    n_seq = ds.n_sequences
    seq_genome = np.asarray(ds.seq_genome, dtype=np.int32)
    with tracing.span("index.encode"):
        concat, offsets, lengths = _encode_sequences(ds.sequences)

    kseq_lengths = np.maximum(lengths - k + 1, 0).astype(np.int64)

    on_card = False
    if kmer_index.fits_packed_key(concat, offsets, k):
        device = torch.device("cpu" if device is None else device)
        on_card = device.type == "cuda"
        built = kmer_index.index_on_device(concat, offsets, k, device)
    else:
        built = _numpy_index(concat, offsets, k, kseq_lengths)
    ptr, ids, cnts, costs, vocab_size, total_vocab = built
    if only_complexity:
        ids = ids[:0]
        cnts = cnts[:0]
        ptr = np.zeros(n_seq + 1, dtype=np.int64)
    index = KmerIndex(
        k=int(k),
        n_sequences=n_seq,
        n_genomes=ds.n_genomes,
        seq_genome=seq_genome,
        kseq_lengths=kseq_lengths.astype(np.int32),
        total_vocab=total_vocab,
        vocab_size=vocab_size,
        profile_ptr=ptr,
        profile_ids=ids,
        profile_counts=cnts,
        computation_costs=costs,
    )
    index.on_card = on_card
    return index


def _numpy_index(concat: np.ndarray, offsets: np.ndarray, k: int,
                 kseq_lengths: np.ndarray):
    """The index's arrays by NumPy on the host, for keys of any width:
    (profile_ptr, profile_ids, profile_counts, computation_costs,
    vocab_size, total_vocab), as ``ops/kmer_index.py::kmer_index``
    gives them."""
    n_seq = offsets.shape[0] - 1
    alphabet_codes = np.unique(concat) if concat.size else np.zeros(0, np.uint8)

    keys = _window_keys(concat, k, alphabet_codes)

    # Valid windows: start position p belongs to gene i iff
    # offsets[i] <= p < offsets[i+1] - k + 1 (window must not cross genes).
    n_pos = keys.shape[0]
    if n_pos > 0:
        pos = np.arange(n_pos, dtype=np.int64)
        gene_of_pos = np.searchsorted(offsets, pos, side="right") - 1
        valid = pos - offsets[gene_of_pos] < kseq_lengths[gene_of_pos]
        win_keys = keys[valid]
        win_gene = gene_of_pos[valid].astype(np.int64)
    else:
        win_keys = keys[:0]
        win_gene = np.zeros(0, dtype=np.int64)

    # Global vocabulary: sorted distinct k-mers -> dense int32 ids.
    vocab, dense = np.unique(win_keys, return_inverse=True)
    total_vocab = int(vocab.shape[0])
    if total_vocab >= 2**31:
        raise ValueError("vocabulary exceeds int32 range")

    # (gene, id) multiset entries with counts — the analogue of the radix
    # sort + dedup at library.cpp:270-287, as one vectorized group-by.
    combined = (win_gene.astype(np.uint64) << np.uint64(32)) | dense.astype(
        np.uint64
    )
    entries, entry_counts = np.unique(combined, return_counts=True)
    entry_gene = (entries >> np.uint64(32)).astype(np.int64)
    entry_id = (entries & np.uint64(0xFFFFFFFF)).astype(np.int64)

    # Posting-group sizes per k-mer id (number of (gene, id) entries).  The
    # reference creates a posting range only for groups with >= 2 entries
    # (library.cpp:308) and charges each member `group_size` lookups
    # (library.cpp:327).
    group_size = np.bincount(entry_id, minlength=total_vocab)
    shared_mask_per_entry = group_size[entry_id] >= 2
    computation_costs = np.bincount(
        entry_gene,
        weights=np.where(shared_mask_per_entry, group_size[entry_id], 0),
        minlength=n_seq,
    ).astype(np.int64)

    # Prune singleton-group k-mers from profiles and re-densify ids.
    keep = shared_mask_per_entry
    kept_gene = entry_gene[keep]
    kept_id = entry_id[keep]
    kept_counts = entry_counts[keep].astype(np.int32)

    shared_vocab_mask = group_size >= 2
    new_id_of = np.cumsum(shared_vocab_mask, dtype=np.int64) - 1
    vocab_size = int(shared_vocab_mask.sum())
    profile_ids = new_id_of[kept_id].astype(np.int32)

    # entries came out of np.unique sorted by combined key = gene-major,
    # id-minor — exactly the CSR order we need.
    per_gene_nnz = np.bincount(kept_gene, minlength=n_seq)
    profile_ptr = np.zeros(n_seq + 1, dtype=np.int64)
    np.cumsum(per_gene_nnz, out=profile_ptr[1:])

    return (profile_ptr, profile_ids, kept_counts, computation_costs,
            vocab_size, total_vocab)
