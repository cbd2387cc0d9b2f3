"""The port's CUDA kernels on the card: each join kernel against its plain
PyTorch version bit for bit (seeded tables, then adversarial tables and
pair lists), the k-mer index build against its plain version and the
NumPy build (seeded, adversarial and the xanthomonas14 preset's data),
the wrappers' refusals, no fallback when a kernel cannot load, and the
engine's paths to the goldens through the kernels.  Every test needs an
NVIDIA card and skips without one.  The file imports neither JAX nor
the JAX package, so it also runs where JAX is absent:

    python3 -m pytest --noconftest -o markers=cuda -p no:cacheprovider -q \\
        tests/test_torch_kernels_on_card.py
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from pandelos_tpu_torch import kernels
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.index import (
    _encode_sequences,
    _numpy_index,
    build_index,
)
from pandelos_tpu_torch.io.faa import FaaDataset
from pandelos_tpu_torch.ops import kmer_index as tki
from pandelos_tpu_torch.ops import lane_join as tlj
from pandelos_tpu_torch.ops import pair_join as tpj
from pandelos_tpu_torch.pipeline import run_pipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _profiles(seed, n_genes, vocab, max_count, id_base, G_pad, W):
    """Seeded padded profiles (pad_profiles layout) and their lane
    depths: empty rows among them, padding genes past ``n_genes``."""
    rng = np.random.default_rng(seed)
    ids = np.full((G_pad, W), id_base + vocab, np.int32)
    cnt = np.zeros((G_pad, W), np.int32)
    dg = np.zeros(G_pad, np.int32)
    for g in range(n_genes):
        w = int(rng.integers(0, min(W, vocab) + 1))
        v = id_base + np.sort(rng.choice(vocab, size=w, replace=False))
        ids[g, :w] = v
        cnt[g, :w] = rng.integers(1, max_count, size=w)
        if w:
            dg[g] = np.bincount(v & 127, minlength=128).max()
    a = rng.integers(0, G_pad, size=5000).astype(np.int32)
    b = rng.integers(0, G_pad, size=5000).astype(np.int32)
    b[:100] = a[:100]
    return ids, cnt, dg, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lane2", "lane", "roll"])
def test_kernel_matches_plain_on_card(card, kind):
    wide = kind != "lane2"  # counts to 999 and ids past 2^23
    ids, cnt, dg, a, b = _profiles(
        5, 40, 3000, 1000 if wide else 256, (1 << 23) + 1 if wide else 0,
        48, 2048)
    ids_d, cnt_d = torch.from_numpy(ids).to(card), torch.from_numpy(cnt).to(
        card)
    pairs = (torch.from_numpy(a).to(card), torch.from_numpy(b).to(card))
    if kind == "roll":
        fn, plain = tpj.join_pairs_core, tpj.join_pairs_plain
        args = (tpj.pack_profiles(ids_d, cnt_d),) + pairs
    else:
        fn, plain = ((tlj.lane2_join, tlj.lane2_join_plain) if kind == "lane2"
                     else (tlj.lane_join, tlj.lane_join_plain))
        table = tlj.pack_lane_device_core(ids_d, cnt_d, int(dg.max()),
                                          packed=not wide)
        args = (table, torch.from_numpy(dg).to(card)) + pairs
    launches = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    for g, w in zip(got, plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lane2", "lane", "roll"])
def test_kernel_matches_plain_on_adversarial_lists(card, kind):
    """Runs of one a across chunk and block edges, an a that changes at
    every pair, a == b, the padding gene on either side, empty and
    full-width rows, depths at and past the kernels' tile and stage
    depths, D = 1, and lists that are no multiple of a chunk."""
    from chip_smoke import adversarial_join_cases, join_fns

    fn, plain = join_fns(kind)
    n_lists = 0
    for label, args in adversarial_join_cases(kind, card, 31):
        got = fn(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, plain(*args)):
            assert torch.equal(g, w), label
        n_lists += 1
    assert n_lists == 18


@pytest.mark.cuda
def test_lane_kernel_matches_plain_on_deep_rows(card):
    """Lane depths 128, 129 and 130: more b depths than one block of the
    kernel's b loop can name."""
    from chip_smoke import deep_join_case

    args = deep_join_case(card, 41)
    assert int(args[1].max()) == 130
    got = tlj.lane_join(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, tlj.lane_join_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_pair_join_refuses_rows_too_wide_for_shared_memory(card):
    z = torch.zeros(8, dtype=torch.int32, device=card)
    wide = torch.zeros((4, 2 * 8196), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="do not fit shared memory"):
        tpj.join_pairs_core(wide, z, z)
    widest = torch.zeros((4, 2 * 8192), dtype=torch.int32, device=card)
    for out in tpj.join_pairs_core(widest, z, z):
        assert float(out.abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["lane2_join", "join_pairs_core"])
def test_kernels_refuse_a_misaligned_table(card, wrapper):
    """Rows are copied in 16-byte pieces: a table that starts 4 bytes
    into an allocation is refused, and so is a pair table whose W is no
    multiple of 4."""
    z = torch.zeros(8, dtype=torch.int32, device=card)
    flat = torch.zeros(4 * 256 + 1, dtype=torch.int32, device=card)
    table = flat[1:].view(4, 256)
    assert table.is_contiguous() and table.data_ptr() % 16
    if wrapper == "lane2_join":
        with pytest.raises(ValueError, match="16-byte aligned"):
            tlj.lane2_join(table, torch.zeros(4, dtype=torch.int32,
                                              device=card), z, z)
        return
    with pytest.raises(ValueError, match="16-byte"):
        tpj.join_pairs_core(table, z, z)
    odd = torch.zeros((4, 2 * 130), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiple of 4"):
        tpj.join_pairs_core(odd, z, z)


@pytest.mark.cuda
def test_card_calls_raise_when_a_kernel_cannot_load(card, monkeypatch):
    """No fallback to the plain version on the card: a kernel that does
    not build or load makes the call raise."""
    def broken(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(kernels, "load", broken)
    z = torch.zeros(8, dtype=torch.int32, device=card)
    dg = torch.zeros(4, dtype=torch.int32, device=card)
    table = torch.zeros((4, 256), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="cannot load lane2_join"):
        tlj.lane2_join(table, dg, z, z)
    with pytest.raises(RuntimeError, match="cannot load lane_join"):
        tlj.lane_join(table, dg, z, z)
    with pytest.raises(RuntimeError, match="cannot load pair_join"):
        tpj.join_pairs_core(table, z, z)
    with pytest.raises(RuntimeError, match="cannot load pair_join"):
        tpj.join_pairs(table, np.zeros(3, np.int64), np.ones(3, np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("join_kernel", ["lane2", "lane", "roll"])
@pytest.mark.parametrize("device_bbh", [None, False])
def test_engine_paths_reproduce_golden_on_card(card, tmp_path, join_kernel,
                                               device_bbh):
    fn = {"lane2": tlj.lane2_join, "lane": tlj.lane_join,
          "roll": tpj.join_pairs_core}[join_kernel]
    launches = fn.launches
    prefix = str(tmp_path / "synth_small")
    run_pipeline(os.path.join(GOLDEN, "synth_small.faa"), prefix,
                 PipelineConfig(row_block=16, col_block=128, candidate_cap=64,
                                join_kernel=join_kernel,
                                device_bbh=device_bbh))
    assert fn.launches > launches
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, "synth_small" + suffix),
                           shallow=False), suffix


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "xla"])
def test_engine_never_synchronises_the_card(card, monkeypatch, backend):
    """The device engine's spans time its sub-phases without draining
    the card's queue: ``torch.cuda.synchronize`` is never called, and
    ``phase_s`` holds every sub-phase and the host's wait on the card."""
    from pandelos_tpu_torch.index import build_index
    from pandelos_tpu_torch.io.faa import read_faa
    from pandelos_tpu_torch.ops.net_device import compute_network_device

    index = build_index(read_faa(os.path.join(GOLDEN, "synth_small.faa")))
    config = PipelineConfig(row_block=16, col_block=128, candidate_cap=64,
                            backend=backend)
    compute_network_device(index, config)  # builds and loads the kernels
    calls = []
    real = torch.cuda.synchronize

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    _, stats = compute_network_device(index, config)
    assert calls == []
    names = ["setup.pad_profiles", "setup.runner", "setup.signatures",
             "extract", "plan", "flatten_join", "bbh", "fetch",
             "host.edges", "host.stats"]
    if backend == "xla":
        names.remove("flatten_join")
    assert list(stats["phase_s"]) == names + ["wait"]
    assert 0 < stats["phase_s"]["wait"] <= sum(
        stats["phase_s"][n] for n in names)


def _genes(seed, n_genes, alphabet, lo, hi):
    rng = np.random.default_rng(seed)
    letters = np.array(list(alphabet))
    return ["".join(rng.choice(letters, int(rng.integers(lo, hi + 1))))
            for _ in range(n_genes)]


def _index_case(name):
    """(sequences, k) of a named index case."""
    if name.startswith("seeded"):
        seed = int(name[-1])
        return _genes(seed, 300 + 500 * seed, "ACDEFGHIKLMNPQRSTVWY", 0,
                      400), 3 + seed
    if name == "xanthomonas14":
        from pandelos_tpu_torch.bench.synth import generate_preset

        return generate_preset("xanthomonas14").sequences, 6
    return {
        "empty_and_short": (["", "MK", "MKV", "", "MKVLAW", "A", ""] * 40, 4),
        "single_gene": (["MKVLAWMKVLAWPQ" * 30], 3),
        "k_1": (_genes(7, 90, "MKVLAW", 0, 12), 1),
        "homopolymers": (["A" * 3000, "A" * 2999 + "C", "AC" * 700,
                          "CA" * 5, "C"] * 20, 3),
        "one_letter": (["A" * 50, "A" * 7, "A"], 4),
        "keyspace_past_2_28": (_genes(8, 2000, "ACDEFGHIKLMNPQRSTVWY", 5,
                                      300), 7),
        "many_genes": (_genes(9, 70000, "ACDEFGHIKLMNPQRSTVWY", 0, 40), 5),
    }[name]


INDEX_CASES = ["seeded0", "seeded1", "seeded2", "empty_and_short",
               "single_gene", "k_1", "homopolymers", "one_letter",
               "keyspace_past_2_28", "many_genes", "xanthomonas14"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", INDEX_CASES)
def test_kmer_index_kernel_matches_plain_and_host(card, name):
    seqs, k = _index_case(name)
    concat, offsets, lengths = _encode_sequences(seqs)
    plain = tki.kmer_index(torch.tensor(concat), torch.from_numpy(offsets), k)
    host = _numpy_index(concat, offsets, k, np.maximum(lengths - k + 1, 0))
    launches = tki.kmer_index.launches
    got = tki.kmer_index(torch.tensor(concat).to(card),
                         torch.from_numpy(offsets).to(card), k)
    torch.cuda.synchronize()
    assert tki.kmer_index.launches > launches
    for other in (plain, host):
        for a, b in zip(got, other):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


@pytest.mark.cuda
def test_kmer_index_refuses_on_card(card):
    """A wrong dtype, a non-contiguous tensor or tensors on two devices
    raise before any launch; so does a packed key past 63 bits, which
    ``build_index`` never hands the card: it decides on the host and
    builds such a dataset there."""
    concat = torch.zeros(64, dtype=torch.uint8, device=card)
    offsets = torch.tensor([0, 30, 64], dtype=torch.int64, device=card)
    launches = tki.kmer_index.launches
    with pytest.raises(TypeError):
        tki.kmer_index(concat.to(torch.int32), offsets, 3)
    with pytest.raises(TypeError):
        tki.kmer_index(concat, offsets.to(torch.int32), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tki.kmer_index(torch.zeros(128, dtype=torch.uint8,
                                   device=card)[::2], offsets, 3)
    with pytest.raises(ValueError, match="offsets is on"):
        tki.kmer_index(concat, offsets.cpu(), 3)
    assert tki.kmer_index.launches == launches
    seqs = ["MKVLAWPQEDCGHINRSTFY" * 3] * 2
    concat, off, _ = _encode_sequences(seqs)
    assert not tki.fits_packed_key(concat, off, 16)
    with pytest.raises(ValueError, match="63 bits"):
        tki.kmer_index(torch.tensor(concat).to(card),
                       torch.from_numpy(off).to(card), 16)
    ds = FaaDataset(sequences=seqs, names=["a", "b"], descriptions=["", ""],
                    seq_genome=[0, 1], genome_names=["g0", "g1"])
    launches = tki.kmer_index.launches
    index = build_index(ds, k=16, device=card)
    assert not index.on_card and tki.kmer_index.launches == launches


@pytest.mark.cuda
def test_default_pipeline_builds_the_index_on_card(card, tmp_path):
    """A default run on the card builds the index with the kernels: the
    launch counter moves, the ``index`` span reads ``on_card`` 1 with one
    ``index.device`` child, and the outputs are the goldens."""
    launches = tki.kmer_index.launches
    prefix = str(tmp_path / "synth_small")
    res = run_pipeline(os.path.join(GOLDEN, "synth_small.faa"), prefix,
                       PipelineConfig(row_block=16, col_block=128,
                                      candidate_cap=64))
    assert tki.kmer_index.launches > launches
    index = [s for s in res.spans if s["name"] == "index"]
    assert len(index) == 1 and index[0]["counters"]["on_card"] == 1
    device = [s for s in res.spans if s["name"] == "index.device"]
    assert len(device) == 1 and device[0]["parent"] == index[0]["id"]
    counters = device[0]["counters"]
    for key in ("windows", "nnz", "total_vocab", "vocab_size", "launches",
                "bytes_to_card", "bytes_to_host", "wait_s"):
        assert counters[key] > 0, key
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, "synth_small" + suffix),
                           shallow=False), suffix
