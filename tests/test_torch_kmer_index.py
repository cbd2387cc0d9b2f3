"""The card build of the k-mer index (``ops/kmer_index.py``) through its
plain PyTorch version on the CPU: field by field equal to the host C++
build and to the JAX package's index on the test presets and on the
shapes that steer the builds (more than 64 genes, empty and short genes,
one gene, k = 1, repeated k-mers, a keyspace past 2^28); its refusals;
and the pipeline on the CPU, which keeps the host build."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pandelos_tpu.index import build_index as jax_build_index
from pandelos_tpu.io.faa import FaaDataset as JaxFaaDataset
from pandelos_tpu_torch.bench.synth import SynthSpec, generate
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.index import KmerIndex, _encode_sequences, build_index
from pandelos_tpu_torch.io.faa import FaaDataset, read_faa
from pandelos_tpu_torch.ksel import select_k
from pandelos_tpu_torch.native import loader, native_build_index
from pandelos_tpu_torch.ops.kmer_index import (
    fits_on_card,
    key_layout,
    kmer_index,
    kmer_index_plain,
)
from pandelos_tpu_torch.pipeline import run_pipeline

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")
DATA = os.path.join(HERE, "data")


def _dataset(seqs, genomes=None):
    genomes = genomes or [i % 2 for i in range(len(seqs))]
    n_gen = max(genomes) + 1
    return FaaDataset(
        sequences=list(seqs), names=[f"s{i}" for i in range(len(seqs))],
        descriptions=["d"] * len(seqs), seq_genome=list(genomes),
        genome_names=[f"g{i}" for i in range(n_gen)])


def _preset(name):
    path = os.path.join(DATA if name == "toy" else GOLDEN, name + ".faa")
    return read_faa(path), None


def _many():
    ds = generate(SynthSpec(n_genomes=5, n_families=24, min_len=30,
                            max_len=90, singleton_per_genome=3, seed=3))
    assert ds.n_sequences > 64  # the host build's threads engage past 64
    return ds, 4


def _short():
    return _dataset(["", "MKV", "MKVLA", "", "MKVLAMKV", "MK", "LAMKVW",
                     ""]), 4


def _single():
    return _dataset(["MKVLAWMKVLAWPQ"], [0]), 3


def _k1():
    return _dataset(["MKVLA", "KKVV", "AMW", "W", "MMMM"]), 1


def _repeats():
    return _dataset(["A" * 50, "A" * 40 + "C", "ACACACACAC", "CACA",
                     "MKVMKVMKVMKV", "KVMKVM"]), 3


def _wide():
    # 20 residues at k = 7: 20^7 keys pass 2^28, the host's radix path
    rng = np.random.default_rng(5)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    base = "".join(rng.choice(aa, 200))
    seqs = [base[i:i + 60 + 7 * i] for i in range(12)]
    seqs += ["".join(rng.choice(aa, 80)) for _ in range(6)]
    return _dataset(seqs), 7


CASES = {
    "toy": lambda: _preset("toy"),
    "synth_small": lambda: _preset("synth_small"),
    "synth_edge": lambda: _preset("synth_edge"),
    "synth_real": lambda: _preset("synth_real"),
    "more_than_64_genes": _many,
    "empty_and_short_genes": _short,
    "single_gene": _single,
    "k_1": _k1,
    "repeated_kmers": _repeats,
    "keyspace_past_2_28": _wide,
}


def _plain_index(ds, k, host):
    concat, offsets, _ = _encode_sequences(ds.sequences)
    out = kmer_index(torch.tensor(concat), torch.from_numpy(offsets), k)
    ptr, ids, cnts, costs, vocab_size, total_vocab = out
    return dataclasses.replace(
        host, profile_ptr=ptr, profile_ids=ids, profile_counts=cnts,
        computation_costs=costs, vocab_size=vocab_size,
        total_vocab=total_vocab)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_card_build_matches_host_and_jax(case):
    ds, k = CASES[case]()
    k = k or select_k(ds.sequences)
    if case == "keyspace_past_2_28":
        assert 20 ** k > 1 << 28
    host = build_index(ds, k=k)
    jax_idx = KmerIndex.from_arrays(dataclasses.asdict(jax_build_index(
        JaxFaaDataset(ds.sequences, ds.names, ds.descriptions,
                      ds.seq_genome, ds.genome_names), k=k)))
    plain = _plain_index(ds, k, host)
    concat, offsets, _ = _encode_sequences(ds.sequences)
    native = native_build_index(concat, offsets, k)
    assert native is not None
    for got, name in ((host, "host"), (jax_idx, "jax")):
        for f in dataclasses.fields(KmerIndex):
            a, b = getattr(plain, f.name), getattr(got, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, (name, f.name)
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {f.name}")
            else:
                assert a == b, (name, f.name)
    if case == "repeated_kmers":
        assert plain.profile_counts.max() > 1


def test_plain_card_build_refuses_keys_past_63_bits():
    """The packed key (key << gene_bits) | gene must stay a non-negative
    int64: past that the card build raises, and ``fits_on_card`` says so
    on the host arrays beforehand."""
    assert key_layout(20, 7, 2) == (20, 31, 1)
    assert key_layout(20, 13, 64) == (20, 57, 6)  # 63 bits fit ...
    assert key_layout(20, 13, 65) is None  # ... 64 do not
    ds = _dataset(["MKVLAWPQEDCGHINRSTFY" * 2, "MKVLAWPQEDCGHINRSTFY"])
    concat, offsets, _ = _encode_sequences(ds.sequences)
    assert fits_on_card(concat, offsets, 14)
    assert not fits_on_card(concat, offsets, 16)
    with pytest.raises(ValueError, match="63 bits"):
        kmer_index_plain(torch.tensor(concat), torch.from_numpy(offsets), 16)


def test_wide_keys_stay_on_the_host_before_any_upload():
    """A CUDA device with keys past 63 bits gets the host build, decided
    on the host: nothing goes to the card (on a machine without one the
    upload would raise), and the arrays are the host build's."""
    ds = _dataset(["MKVLAWPQEDCGHINRSTFY" * 2, "MKVLAWPQEDCGHINRSTFY"])
    before = loader.CALLS["build_index"]
    launches = kmer_index.launches
    index = build_index(ds, k=16, device="cuda")
    assert not index.on_card
    assert loader.CALLS["build_index"] == before + 1
    assert kmer_index.launches == launches
    host = build_index(ds, k=16)
    for f in dataclasses.fields(KmerIndex):
        a, b = getattr(index, f.name), getattr(host, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "device", "shape"])
def test_kmer_index_refuses_bad_arguments(bad):
    concat = torch.zeros(10, dtype=torch.uint8)
    offsets = torch.tensor([0, 4, 10], dtype=torch.int64)
    if bad == "dtype":
        concat = concat.to(torch.int32)
    elif bad == "contiguity":
        offsets = torch.tensor([0, 0, 4, 0, 10, 0])[::2]
    elif bad == "device":
        concat, offsets = concat.to("meta"), offsets.to("meta")
    else:
        offsets = offsets[:1]
    with pytest.raises((TypeError, ValueError)):
        kmer_index(concat, offsets, 3)


def test_cpu_pipeline_keeps_the_host_build(tmp_path):
    """On the CPU the index is the host C++ build: its call count moves,
    the ``index`` span reads ``on_card`` 0 and has an ``index.native``
    child and no ``index.device``; the card build launches nothing."""
    before = loader.CALLS["build_index"]
    launches = kmer_index.launches
    res = run_pipeline(os.path.join(DATA, "toy.faa"), str(tmp_path / "t"),
                       PipelineConfig(device="cpu"))
    assert loader.CALLS["build_index"] == before + 1
    assert kmer_index.launches == launches
    index = [s for s in res.spans if s["name"] == "index"]
    assert len(index) == 1 and index[0]["counters"]["on_card"] == 0
    names = {s["name"] for s in res.spans}
    assert "index.native" in names and "index.device" not in names
