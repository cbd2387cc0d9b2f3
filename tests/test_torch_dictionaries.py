"""The port's k-mer dictionary library (``pandelos_tpu_torch/dictionaries.py``)
against the JAX package's on the cases of tests/test_dictionaries.py:
every walk (k-mers, positions, multiplicities, in order), seek, prev,
extension and complete-alphabet iteration equal, and each package loads
the other's saved file."""

import itertools
from collections import Counter

import numpy as np
import pytest

from pandelos_tpu import dictionaries as jd
from pandelos_tpu_torch import dictionaries as td


def _walk(it):
    """Every block an iterator visits: (k-mer, positions, multiplicity)."""
    out = []
    while it.valid():
        out.append((it.kmer(), it.positions().tolist(), it.multiplicity()))
        it.next()
    return out


def _brute_blocks(sequences, k):
    out = {}
    offset = 0
    for s in sequences:
        for i in range(max(0, len(s) - k + 1)):
            out.setdefault(s[i : i + k], []).append(offset + i)
        offset += len(s)
    return {km: sorted(v) for km, v in out.items()}


def test_iteration_matches_jax_and_bruteforce():
    seqs = ["BANANA", "ANANAS", "NA", "A"]
    for k in (1, 2, 3):
        got = _walk(td.KmerDictionary(seqs).begin(k))
        assert got == _walk(jd.KmerDictionary(seqs).begin(k))
        assert [g[0] for g in got] == sorted(g[0] for g in got)
        assert {km: pos for km, pos, _ in got} == _brute_blocks(seqs, k)
        assert all(len(pos) == m for _, pos, m in got)


def test_boundary_kmers_excluded():
    kmers = [b.kmer for b in td.KmerDictionary(["NA", "AS"]).blocks(2)]
    assert kmers == [b.kmer for b in jd.KmerDictionary(["NA", "AS"]).blocks(2)]
    assert set(kmers) == {"NA", "AS"}


def test_extension_iterator():
    seqs = ["BANANA", "ANANAS"]
    walks = []
    for mod in (td, jd):
        d = mod.KmerDictionary(seqs)
        it = d.begin(2)
        assert it.seek("AN")
        walks.append(_walk(d.extend(it)))
    assert walks[0] == walks[1]
    want = Counter()
    for s in seqs:
        for i in range(len(s) - 2):
            if s[i : i + 2] == "AN":
                want[s[i : i + 3]] += 1
    assert {km: m for km, _, m in walks[0]} == dict(want)


def test_prev_and_seek():
    for mod in (td, jd):
        it = mod.KmerDictionary(["ABCABC"]).begin(3)
        assert it.seek("BCA")
        assert it.multiplicity() == 1
        assert it.prev()
        assert (it.kmer(), it.multiplicity()) == ("ABC", 2)
        assert not it.seek("ZZZ")


def test_save_load_roundtrip_across_packages(tmp_path):
    seqs = ["BANANA", "ANANAS"]
    for save_mod, load_mod in ((td, jd), (jd, td), (td, td)):
        p = str(tmp_path / f"{save_mod.__name__}_{load_mod.__name__}.npz")
        save_mod.KmerDictionary(seqs).save(p, 2)
        d2 = load_mod.KmerDictionary.load(p)
        assert d2.sequences == seqs
        assert _walk(d2.begin(2)) == _walk(jd.KmerDictionary(seqs).begin(2))


def test_sequences_of():
    got = []
    for mod in (td, jd):
        d = mod.KmerDictionary(["BANANA", "ANANAS", "XYZ"])
        it = d.begin(3)
        assert it.seek("ANA")
        got.append(it.block().sequences_of(d).tolist())
    assert got == [[0, 1], [0, 1]]


def test_version_check(tmp_path):
    p = str(tmp_path / "v.npz")
    td.KmerDictionary(["ABC"]).save(p, 2)
    data = dict(np.load(p))
    data["version"] = np.int64(99)
    np.savez_compressed(p, **data)
    for mod in (td, jd):
        with pytest.raises(ValueError, match="version"):
            mod.KmerDictionary.load(p)


@pytest.mark.parametrize("k", [9, 12, 20])
def test_wide_k_iteration_matches_jax(k):
    """k > 8 (multi-limb keys): walks, seek and extension across the
    8-byte limb boundary equal the JAX package's and brute force."""
    rng = np.random.default_rng(k)
    alpha = "ACDEFGHIKLMNPQRSTVWY"
    seqs = [
        "".join(rng.choice(list(alpha), size=int(rng.integers(k, 40))))
        for _ in range(6)
    ] + ["SHORT"]
    got = _walk(td.KmerDictionary(seqs).begin(k))
    assert got == _walk(jd.KmerDictionary(seqs).begin(k))
    assert {km: pos for km, pos, _ in got} == _brute_blocks(seqs, k)
    some = got[len(got) // 2][0]
    children = []
    for mod in (td, jd):
        d = mod.KmerDictionary(seqs)
        it = d.begin(k)
        assert it.seek(some) and it.kmer() == some
        children.append([c[0] for c in _walk(d.extend(it))])
    assert children[0] == children[1] == sorted(
        km for km in _brute_blocks(seqs, k + 1) if km.startswith(some))


def test_complete_kmer_iterator_matches_jax_and_product():
    for alphabet, k in (("ACGT", 3), ("AB", 5), ("XYZW", 1), ("Q", 4)):
        it = td.CompleteKmerIterator(k, alphabet)
        got = list(it)
        assert got == list(jd.CompleteKmerIterator(k, alphabet))
        assert got == ["".join(t) for t in
                       itertools.product(sorted(alphabet), repeat=k)]
        assert it.multiplicity() == 1
        assert not it.valid()


def test_complete_kmer_iterator_prev_and_edges():
    for mod in (td, jd):
        it = mod.CompleteKmerIterator(2, "BA")
        assert it.kmer() == "AA"
        assert it.next() and it.kmer() == "AB"
        assert it.prev() and it.kmer() == "AA"
        assert not it.prev()
        assert not it.valid()
        assert not mod.CompleteKmerIterator(0, "AC").valid()
        assert not mod.CompleteKmerIterator(3, "").valid()
