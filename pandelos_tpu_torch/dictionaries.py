"""K-mer dictionary library: iteration over (k-mer, multiplicity,
positions) blocks.

Functional equivalent of the reference's legacy dictionary stack
(``ig/infoasys/core/dictionaries/``: ELSA/NELSA enhanced suffix arrays
with SA-IS construction, ``ELSA.java:122-163`` block iterators,
``NELSA.java:134-151`` null-spacer handling, ``ExtensionNELSAIterator``
k->k+1 refinement, versioned binary save/load) — that stack is dead code
in the reference's pangenes path but is part of its public library
surface.

Redesign: a suffix array is the wrong tool on modern vector hardware; a
sorted k-mer table (packed integer keys + positions, built with the same
vectorized machinery as the index) provides the identical iteration
contract with O(n log n) construction and O(1) block stepping:

- ``begin(k)`` iterates distinct k-mers in lexicographic order exposing
  ``kmer() / multiplicity() / positions() / next() / prev()``
  (``IELSAIterator`` contract),
- k-mers crossing sequence boundaries are excluded, as NELSA's ``ns``
  array does for NULL separators (``NELSA.java:58-80``),
- ``extend(iterator)`` iterates the (k+1)-mers refining a parent k-mer
  (``ExtensionNELSAIterator`` contract) via prefix-range bisection,
- ``save/load`` with an explicit format version
  (``DataVersioning.java`` role).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

FORMAT_VERSION = 1


@dataclasses.dataclass
class KmerBlock:
    """One dictionary entry: a distinct k-mer and its occurrences."""

    kmer: str
    multiplicity: int
    positions: np.ndarray  # global positions in the concatenated text

    def sequences_of(self, dictionary: "KmerDictionary") -> np.ndarray:
        """Distinct sequence ids containing this k-mer."""
        seq = (
            np.searchsorted(
                dictionary.offsets, self.positions, side="right"
            )
            - 1
        )
        return np.unique(seq)


class KmerDictionary:
    """Sorted k-mer dictionary over a set of sequences."""

    def __init__(self, sequences: List[str]):
        self.sequences = list(sequences)
        blobs = [s.encode("latin-1") for s in self.sequences]
        lengths = np.array([len(b) for b in blobs], dtype=np.int64)
        self.offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum(lengths, out=self.offsets[1:])
        self.text = (
            np.frombuffer(b"".join(blobs), dtype=np.uint8)
            if self.offsets[-1]
            else np.zeros(0, np.uint8)
        )
        self._cache: dict = {}

    # --- construction -------------------------------------------------
    @staticmethod
    def _key_dtype(k: int) -> np.dtype:
        """uint64 for k <= 8; ceil(k/8) big-endian uint64 limbs beyond
        (np.unique / argsort / searchsorted compare structured dtypes
        field-by-field, i.e. lexicographically — arbitrary k supported,
        where the reference's ELSA suffix array is k-agnostic by
        construction)."""
        if k <= 8:
            return np.dtype(np.uint64)
        n_limbs = (k + 7) // 8
        return np.dtype([(f"l{i}", np.uint64) for i in range(n_limbs)])

    def _pack(self, kmer_bytes: bytes, k: int):
        """Scalar table key for a k-mer's bytes (len(kmer_bytes) == k)."""
        if k <= 8:
            key = 0
            for ch in kmer_bytes:
                key = (key << 8) | ch
            return np.uint64(key)
        n_limbs = (k + 7) // 8
        pad = n_limbs * 8 - k
        limbs = [0] * n_limbs
        for j, ch in enumerate(kmer_bytes):
            limbs[(j + pad) // 8] = (limbs[(j + pad) // 8] << 8) | ch
        return np.array([tuple(limbs)], dtype=self._key_dtype(k))[0]

    def _table(self, k: int):
        """(sorted_keys, start_ptr, positions) for width k."""
        if k in self._cache:
            return self._cache[k]
        if k <= 0:
            raise ValueError("k must be positive")
        n = self.text.shape[0] - k + 1
        if n <= 0:
            empty = (
                np.zeros(0, self._key_dtype(k)),
                np.zeros(1, np.int64),
                np.zeros(0, np.int64),
            )
            self._cache[k] = empty
            return empty
        if k <= 8:
            keys = np.zeros(n, dtype=np.uint64)
            for j in range(k):
                keys = (keys << np.uint64(8)) | self.text[
                    j : j + n
                ].astype(np.uint64)
        else:
            n_limbs = (k + 7) // 8
            pad = n_limbs * 8 - k
            keys = np.zeros(n, dtype=self._key_dtype(k))
            for j in range(k):
                f = f"l{(j + pad) // 8}"
                keys[f] = (keys[f] << np.uint64(8)) | self.text[
                    j : j + n
                ].astype(np.uint64)
        pos = np.arange(n, dtype=np.int64)
        # exclude windows crossing sequence boundaries (NELSA ns role)
        seq_of = np.searchsorted(self.offsets, pos, side="right") - 1
        valid = pos + k <= self.offsets[seq_of + 1]
        keys, pos = keys[valid], pos[valid]
        order = np.argsort(keys, kind="stable")
        keys, pos = keys[order], pos[order]
        uniq, starts = np.unique(keys, return_index=True)
        ptr = np.concatenate([starts, [keys.shape[0]]]).astype(np.int64)
        table = (uniq, ptr, pos)
        self._cache[k] = table
        return table

    def _decode(self, key, k: int) -> str:
        if k <= 8:
            key = int(key)
            return "".join(
                chr((key >> (8 * (k - 1 - j))) & 0xFF) for j in range(k)
            )
        n_limbs = (k + 7) // 8
        pad = n_limbs * 8 - k
        chars = []
        for j in range(k):
            limb = int(key[(j + pad) // 8])
            shift = 8 * (7 - ((j + pad) % 8))
            chars.append(chr((limb >> shift) & 0xFF))
        return "".join(chars)

    # --- iteration (IELSA contract) -----------------------------------
    def begin(self, k: int) -> "KmerDictionaryIterator":
        return KmerDictionaryIterator(self, k)

    def blocks(self, k: int) -> Iterator[KmerBlock]:
        it = self.begin(k)
        while it.valid():
            yield it.block()
            it.next()

    def extend(self, parent: "KmerDictionaryIterator") -> "KmerDictionaryIterator":
        """Iterator over (k+1)-mers whose prefix is the parent's k-mer
        (ExtensionNELSAIterator contract)."""
        k1 = parent.k + 1
        child = KmerDictionaryIterator(self, k1)
        uniq, _, _ = self._table(k1)
        # the parent's refinement range is [kmer+0x00, kmer+0xff]
        kb = parent.kmer().encode("latin-1")
        lo_key = self._pack(kb + b"\x00", k1)
        hi_key = self._pack(kb + b"\xff", k1)
        child._idx = int(np.searchsorted(uniq, lo_key, side="left"))
        child._end = int(np.searchsorted(uniq, hi_key, side="right"))
        return child

    # --- persistence --------------------------------------------------
    def save(self, path: str, k: int) -> None:
        uniq, ptr, pos = self._table(k)
        np.savez_compressed(
            path,
            version=FORMAT_VERSION,
            k=k,
            offsets=self.offsets,
            text=self.text,
            keys=uniq,
            ptr=ptr,
            positions=pos,
        )

    @staticmethod
    def load(path: str) -> "KmerDictionary":
        z = np.load(path)
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                f"unsupported dictionary format version {version}"
            )
        d = KmerDictionary.__new__(KmerDictionary)
        d.offsets = z["offsets"]
        d.text = z["text"]
        starts = d.offsets[:-1]
        ends = d.offsets[1:]
        d.sequences = [
            d.text[s:e].tobytes().decode("latin-1")
            for s, e in zip(starts, ends)
        ]
        d._cache = {
            int(z["k"]): (z["keys"], z["ptr"], z["positions"])
        }
        return d


class KmerDictionaryIterator:
    """Block iterator: kmer()/multiplicity()/positions()/next()/prev()."""

    def __init__(self, dictionary: KmerDictionary, k: int):
        self.dictionary = dictionary
        self.k = k
        uniq, _, _ = dictionary._table(k)
        self._idx = 0
        self._end = uniq.shape[0]

    def _key(self):
        uniq, _, _ = self.dictionary._table(self.k)
        return uniq[self._idx]

    def valid(self) -> bool:
        return 0 <= self._idx < self._end

    def kmer(self) -> str:
        return self.dictionary._decode(self._key(), self.k)

    def multiplicity(self) -> int:
        _, ptr, _ = self.dictionary._table(self.k)
        return int(ptr[self._idx + 1] - ptr[self._idx])

    def positions(self) -> np.ndarray:
        _, ptr, pos = self.dictionary._table(self.k)
        return np.sort(pos[ptr[self._idx] : ptr[self._idx + 1]])

    def block(self) -> KmerBlock:
        return KmerBlock(self.kmer(), self.multiplicity(), self.positions())

    def next(self) -> bool:
        self._idx += 1
        return self.valid()

    def prev(self) -> bool:
        self._idx -= 1
        return self.valid()

    def seek(self, kmer: str) -> bool:
        """Position at a specific k-mer; returns False when absent."""
        if len(kmer) != self.k:
            raise ValueError("kmer length mismatch")
        key = self.dictionary._pack(kmer.encode("latin-1"), self.k)
        uniq, _, _ = self.dictionary._table(self.k)
        idx = int(np.searchsorted(uniq, key, side="left"))
        if idx < uniq.shape[0] and uniq[idx] == key:
            self._idx = idx
            return True
        return False


class CompleteKmerIterator:
    """Exhaustive alphabet^k enumerator (the ``CompleteCharIterator``
    contract, ``CompleteCharIterator.java:1-73``): iterates EVERY k-mer
    over a given alphabet in lexicographic order — present in a dictionary
    or not — with ``multiplicity()`` fixed at 1, via an odometer over the
    last position.

    Differences from the reference, by design: the alphabet is an explicit
    character sequence instead of a bare code count (the Java odometer
    counts codes 0..alpha_size INCLUSIVE, enumerating (alpha_size+1)^k
    words — an off-by-one its dead-code status never surfaced), and
    ``prev()`` is implemented rather than throwing."""

    def __init__(self, k: int, alphabet: str):
        if k < 0:
            raise ValueError("k must be >= 0")
        if len(set(alphabet)) != len(alphabet):
            raise ValueError("alphabet has duplicate characters")
        self.k = k
        self.alphabet = "".join(sorted(alphabet))
        self._codes = [0] * k
        self._exhausted = k == 0 or not alphabet

    def valid(self) -> bool:
        return not self._exhausted

    def kmer(self) -> str:
        if self._exhausted:
            raise StopIteration("iterator exhausted")
        return "".join(self.alphabet[c] for c in self._codes)

    def multiplicity(self) -> int:
        return 1

    def next(self) -> bool:
        """Advance the odometer; returns validity (IWordIterator.next)."""
        if self._exhausted:
            return False
        base = len(self.alphabet)
        p = self.k - 1
        while p >= 0:
            if self._codes[p] == base - 1:
                self._codes[p] = 0
                p -= 1
            else:
                self._codes[p] += 1
                return True
        self._exhausted = True
        return False

    def prev(self) -> bool:
        if self._exhausted:
            return False
        base = len(self.alphabet)
        p = self.k - 1
        while p >= 0:
            if self._codes[p] == 0:
                self._codes[p] = base - 1
                p -= 1
            else:
                self._codes[p] -= 1
                return True
        self._exhausted = True
        return False

    def __iter__(self):
        while self.valid():
            yield self.kmer()
            if not self.next():
                break
