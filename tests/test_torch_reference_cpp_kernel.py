"""Cell-level equality of the port against the REFERENCE'S OWN
compiled C++ kernel: ``tests/test_reference_cpp_kernel.py`` over
``pandelos_tpu_torch`` alone.

Unlike every other differential test (whose truth descends from the
transcription in reference.py), the truth source here is the reference
tree's ``ig/native/library.cpp`` itself (``PANDELOS_REF_ROOT``),
compiled unmodified through ``pandelos_tpu_torch/native/
ref_oracle_harness.cpp``; the whole module skips without that tree.

Compared bit-for-bit per cell: f32 score (inter/union), perc and
tr_perc (the reference's own float divisions, library.cpp:493-517).
"""

import os

import pytest

from pandelos_tpu_torch.index import build_index
from pandelos_tpu_torch.io.faa import read_faa, write_faa
from pandelos_tpu_torch.ksel import select_k
from pandelos_tpu_torch.native.ref_oracle import (
    our_cells_bits,
    reference_available,
    reference_cells,
)

pytestmark = pytest.mark.skipif(
    not reference_available(), reason="reference tree not present"
)

_HERE = os.path.dirname(os.path.abspath(__file__))


def _compare(faa_path, k=None):
    ds = read_faa(faa_path)
    if k is None:
        k = select_k(ds.sequences)
    theirs = reference_cells(faa_path, k)
    index = build_index(ds, k=k)
    ours = our_cells_bits(index)
    assert set(ours) == set(theirs), (
        f"cell sets differ: ours={len(ours)} theirs={len(theirs)}, "
        f"only-ours={list(set(ours) - set(theirs))[:5]}, "
        f"only-theirs={list(set(theirs) - set(ours))[:5]}"
    )
    bad = [
        (xy, ours[xy], theirs[xy])
        for xy in ours
        if ours[xy] != theirs[xy]
    ]
    assert not bad, f"{len(bad)} cells differ in bits, first: {bad[:3]}"
    return len(ours)


def test_toy_matches_reference_kernel():
    n = _compare(os.path.join(_HERE, "data", "toy.faa"))
    assert n > 0


@pytest.mark.parametrize("seed,k", [(0, None), (7, 3)])
def test_synth_matches_reference_kernel(tmp_path, seed, k):
    from pandelos_tpu_torch.bench.synth import SynthSpec, generate

    faa = str(tmp_path / "synth.faa")
    write_faa(
        faa,
        generate(
            SynthSpec(
                n_genomes=5, n_families=30, singleton_per_genome=3,
                min_len=40, max_len=180, seed=seed,
            )
        ),
    )
    n = _compare(faa, k=k)
    assert n > 100


def test_mycoplasma16_matches_reference_kernel():
    """Mid-scale: the committed bench preset vs the reference kernel."""
    faa = os.path.join(
        os.path.dirname(_HERE), "bench_cache", "mycoplasma16.faa"
    )
    if not os.path.exists(faa):
        pytest.skip("mycoplasma16 preset not generated")
    n = _compare(faa)
    assert n > 100_000


def test_mycoplasma64_net_provenance_from_reference_kernel(tmp_path):
    """Flagship-preset provenance: drive net.build_network
    from the reference kernel's OWN cells (library.cpp:409-527 compiled
    unmodified, 2.0M cells at native speed) and require the result to
    byte-match the committed golden bench_cache/mycoplasma64.net.

    With this test plus test_reference_netclu.py (the reference's own
    netclu_ng.py reproducing the .clus goldens) the only repo-authored
    stage left in the flagship golden chain is the BBH filter itself
    (Pangenes.java:98-176, no JVM to run it), whose semantics are pinned
    at smaller scale by tests/test_cells_and_net.py."""
    import filecmp

    from pandelos_tpu_torch.io.faa import read_faa
    from pandelos_tpu_torch.io.net import write_net
    from pandelos_tpu_torch.native.ref_oracle import reference_finalized_cells
    from pandelos_tpu_torch.net import build_network

    cache = os.path.join(os.path.dirname(_HERE), "bench_cache")
    faa = os.path.join(cache, "mycoplasma64.faa")
    golden = os.path.join(cache, "mycoplasma64.net")
    if not (os.path.exists(faa) and os.path.exists(golden)):
        pytest.skip("mycoplasma64 preset not generated")
    import numpy as np

    ds = read_faa(faa)
    fin = reference_finalized_cells(faa, k=6)  # bench preset's k
    assert len(fin.row) > 1_000_000
    net = build_network(
        fin, np.asarray(ds.seq_genome), ds.n_genomes, ds.n_sequences
    )
    out = str(tmp_path / "m64.net")
    write_net(out, net.edges)
    assert filecmp.cmp(out, golden, shallow=False)


def test_mycoplasma64_cells_match_reference_kernel():
    """Flagship-preset cell bits: our oracle path vs the compiled
    reference kernel, every cell bit-for-bit (~70s: full 39.5k-gene
    oracle scoring on host)."""
    faa = os.path.join(
        os.path.dirname(_HERE), "bench_cache", "mycoplasma64.faa"
    )
    if not os.path.exists(faa):
        pytest.skip("mycoplasma64 preset not generated")
    n = _compare(faa, k=6)
    assert n > 1_000_000
