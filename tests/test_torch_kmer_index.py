"""The device build of the k-mer index (``ops/kmer_index.py``) through
its plain PyTorch version on the CPU: field by field equal to the NumPy
build and to the JAX package's index on the test presets and on the
shapes that steer the builds (more than 64 genes, empty and short genes,
one gene, k = 1, repeated k-mers, a keyspace past 2^28); its refusals;
``build_index``'s two routes (the device build where the packed key fits
in 63 bits, NumPy past it), each equal to the JAX package's index at the
edges of that band; and the pipeline on the CPU, which builds with the
plain version."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pandelos_tpu.index import build_index as jax_build_index
from pandelos_tpu.io.faa import FaaDataset as JaxFaaDataset
from pandelos_tpu_torch import tracing
from pandelos_tpu_torch.bench.synth import SynthSpec, generate
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.index import (
    KmerIndex,
    _encode_sequences,
    _numpy_index,
    build_index,
)
from pandelos_tpu_torch.io.faa import FaaDataset, read_faa
from pandelos_tpu_torch.ksel import select_k
from pandelos_tpu_torch.ops.kmer_index import (
    fits_packed_key,
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
    assert ds.n_sequences > 64  # past 64 genes: 7 gene bits
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
    # 20 residues at k = 7: 20^7 keys pass 2^28
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


def _jax_index(ds, k):
    return KmerIndex.from_arrays(dataclasses.asdict(jax_build_index(
        JaxFaaDataset(ds.sequences, ds.names, ds.descriptions,
                      ds.seq_genome, ds.genome_names), k=k)))


def _assert_same(got, want, name=""):
    for f in dataclasses.fields(KmerIndex):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, (name, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {f.name}")
        else:
            assert a == b, (name, f.name)


def _with_arrays(index, arrays):
    ptr, ids, cnts, costs, vocab_size, total_vocab = arrays
    return dataclasses.replace(
        index, profile_ptr=ptr, profile_ids=ids, profile_counts=cnts,
        computation_costs=costs, vocab_size=vocab_size,
        total_vocab=total_vocab)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_card_build_matches_host_and_jax(case):
    ds, k = CASES[case]()
    k = k or select_k(ds.sequences)
    if case == "keyspace_past_2_28":
        assert 20 ** k > 1 << 28
    jax_idx = _jax_index(ds, k)
    concat, offsets, _ = _encode_sequences(ds.sequences)
    plain = _with_arrays(jax_idx, kmer_index(
        torch.tensor(concat), torch.from_numpy(offsets), k))
    host = _with_arrays(jax_idx, _numpy_index(
        concat, offsets, k, jax_idx.kseq_lengths.astype(np.int64)))
    for got, name in ((host, "numpy"), (jax_idx, "jax"),
                      (build_index(ds, k=k), "routed")):
        _assert_same(plain, got, name)
    if case == "repeated_kmers":
        assert plain.profile_counts.max() > 1


def test_plain_card_build_refuses_keys_past_63_bits():
    """The packed key (key << gene_bits) | gene must stay a non-negative
    int64: past that the device build raises, and ``fits_packed_key``
    says so on the host arrays beforehand (as it does for no gene)."""
    assert key_layout(20, 7, 2) == (20, 31, 1)
    assert key_layout(20, 13, 64) == (20, 57, 6)  # 63 bits fit ...
    assert key_layout(20, 13, 65) is None  # ... 64 do not
    ds = _dataset(["MKVLAWPQEDCGHINRSTFY" * 2, "MKVLAWPQEDCGHINRSTFY"])
    concat, offsets, _ = _encode_sequences(ds.sequences)
    assert fits_packed_key(concat, offsets, 14)
    assert not fits_packed_key(concat, offsets, 16)
    assert not fits_packed_key(concat[:0], offsets[:1], 3)
    with pytest.raises(ValueError, match="63 bits"):
        kmer_index_plain(torch.tensor(concat), torch.from_numpy(offsets), 16)


def _routed(ds, k, device=None):
    """``build_index`` in a job of its own: the index and whether the
    device build ran (an ``index.device`` span)."""
    with tracing.job() as j:
        index = build_index(ds, k=k, device=device)
    return index, "index.device" in {s.name for s in j.spans}


def test_wide_keys_stay_on_the_host_before_any_upload():
    """A CUDA device with keys past 63 bits gets the NumPy build, decided
    on the host: nothing goes to the card (on a machine without one the
    upload would raise), no ``index.device`` span opens, and the arrays
    are the JAX package's."""
    ds = _dataset(["MKVLAWPQEDCGHINRSTFY" * 2, "MKVLAWPQEDCGHINRSTFY"])
    launches = kmer_index.launches
    index, on_device = _routed(ds, 16, device="cuda")
    assert not index.on_card and not on_device
    assert kmer_index.launches == launches
    _assert_same(index, _jax_index(ds, 16))


def _band_edge(k, n_genes):
    # every one of 20 residues present, and k-mers shared between genes
    rng = np.random.default_rng(k * 1000 + n_genes)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    base = "ACDEFGHIKLMNPQRSTVWY" + "".join(rng.choice(aa, 300))
    seqs = [base[(5 * i) % 250:(5 * i) % 250 + 30 + i % 17]
            for i in range(n_genes)]
    return _dataset(seqs, [i % 3 for i in range(n_genes)])


@pytest.mark.parametrize("k,n_genes,bits,on_device", [
    (13, 64, 63, True),
    (13, 65, 64, False),
    (14, 65, 68, False),
    (15, 65, None, False),  # 20^15 passes 2^64: the NumPy limb keys
], ids=["63_bits", "64_bits", "past_64_bits", "past_64_bit_ranks"])
def test_build_index_routes_at_the_band_edges(k, n_genes, bits, on_device):
    """Key plus gene bits of 63 take the device build (here its plain
    version), 64 and more the NumPy build; each equals the JAX package's
    index, also where base^k passes 64 bits."""
    ds = _band_edge(k, n_genes)
    layout = key_layout(20, k, n_genes)
    if bits is None:
        assert 20 ** k >= 1 << 64 and layout is None
    else:
        assert (20 ** k - 1).bit_length() + (n_genes - 1).bit_length() \
            == bits
        assert (layout is not None) == on_device
    index, routed = _routed(ds, k)
    assert routed == on_device and not index.on_card
    jax_idx = _jax_index(ds, k)
    assert jax_idx.vocab_size > 0
    _assert_same(index, jax_idx)


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
    """On the CPU the index is the plain version of the device build: the
    ``index`` span reads ``on_card`` 0 and has an ``index.device`` child
    that launched nothing, and the index is the JAX package's."""
    launches = kmer_index.launches
    cap = {}
    res = run_pipeline(os.path.join(DATA, "toy.faa"), str(tmp_path / "t"),
                       PipelineConfig(device="cpu"), capture=cap)
    assert kmer_index.launches == launches
    index = [s for s in res.spans if s["name"] == "index"]
    assert len(index) == 1 and index[0]["counters"]["on_card"] == 0
    device = [s for s in res.spans if s["name"] == "index.device"]
    assert len(device) == 1 and device[0]["parent"] == index[0]["id"]
    assert device[0]["counters"]["launches"] == 0
    assert "bytes_to_card" not in device[0]["counters"]
    ds = read_faa(os.path.join(DATA, "toy.faa"))
    _assert_same(cap["index"], _jax_index(ds, res.k))
