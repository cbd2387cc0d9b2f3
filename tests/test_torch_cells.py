"""The port's cells path (ops/candidate.py::compute_cells_candidate) against
the JAX package's compute_cells_candidate with backend "pallas" (interpret
mode) and against the oracle, for each join kernel: the cases of
test_candidate.py (matches_oracle, overflow_fallback, device_retry,
no_duplicate_cells, homopolymer_counts), plus an input that lane2 cannot
pack and the host fallback rows.  Cells compare exactly as sets."""

import numpy as np
import pytest

from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.io.faa import FaaDataset
from pandelos_tpu.ops import candidate as jcand
from pandelos_tpu.oracle.cells import apply_validity, compute_cells_oracle
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.ops import candidate as tcand

from tests.test_cells_and_net import _random_ds
from tests.torch_port_util import twin_indexes

KERNELS = ["lane2", "lane", "roll"]


def _cells_dict(cells):
    """{(row, col): (inter, perc, tr)}; asserts no cell appears twice."""
    keys = list(zip(cells.row.tolist(), cells.col.tolist()))
    assert len(keys) == len(set(keys))
    return {
        k: (int(i), int(p), int(t))
        for k, i, p, t in zip(keys, cells.intersection, cells.perc_cnt,
                              cells.tr_perc_cnt)
    }


def _valid_dict(cells, idx):
    return _cells_dict(apply_validity(cells, idx.kseq_lengths, idx.k))


def _both(ds, join_kernel, k=3, **cfg):
    """(port cells, JAX cells, oracle cells, JAX index) on one dataset."""
    jidx, tidx = twin_indexes(ds, k=k)
    got = tcand.compute_cells_candidate(
        tidx, PipelineConfig(join_kernel=join_kernel, device="cpu", **cfg))
    want = jcand.compute_cells_candidate(
        jidx, JaxConfig(backend="pallas", join_kernel=join_kernel, **cfg))
    return got, want, compute_cells_oracle(jidx), jidx


def _assert_all_equal(got, want, oracle, idx):
    g = _valid_dict(got, idx)
    assert g == _valid_dict(want, idx)
    assert g == _valid_dict(oracle, idx)
    assert g  # the case has cells


@pytest.mark.parametrize("join_kernel", KERNELS)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_cells_match_jax_and_oracle(seed, join_kernel):
    ds = _random_ds(np.random.default_rng(seed), n_genomes=4, n_fams=9)
    got, want, oracle, idx = _both(ds, join_kernel, row_block=16,
                                   col_block=128, candidate_cap=64)
    _assert_all_equal(got, want, oracle, idx)
    # no overflow here: the port returns exactly JAX's valid cells
    assert _cells_dict(got) == _cells_dict(want)


@pytest.mark.parametrize("join_kernel", KERNELS)
def test_overflow_fallback(join_kernel, monkeypatch):
    """A tiny cap, and a retry cap below every overflow count, send the
    overflowing rows to the host posting walk (invalid cells included,
    dropped by the validity test as JAX's are)."""
    ds = _random_ds(np.random.default_rng(3), n_genomes=4, n_fams=6)
    monkeypatch.setattr(tcand, "MAX_RETRY_CAP", 0)
    jidx, tidx = twin_indexes(ds, k=3)
    calls = []
    real = tcand._host_fallback_rows
    monkeypatch.setattr(tcand, "_host_fallback_rows",
                        lambda index, rows: calls.append(rows) or real(
                            index, rows))
    got = tcand.compute_cells_candidate(tidx, PipelineConfig(
        join_kernel=join_kernel, device="cpu", row_block=8, col_block=128,
        candidate_cap=2))
    assert calls and len(calls[0]) > 0
    want = jcand.compute_cells_candidate(jidx, JaxConfig(
        backend="pallas", join_kernel=join_kernel, row_block=8,
        col_block=128, candidate_cap=2))
    _assert_all_equal(got, want, compute_cells_oracle(jidx), jidx)


@pytest.mark.parametrize("join_kernel", KERNELS)
@pytest.mark.parametrize("cap", [2, 8])
def test_device_retry(join_kernel, cap, monkeypatch):
    """Overflowing rows rerun on the device at a cap of their count
    rounded up to 128 (upper triangle, mirrored); no host walk."""
    ds = _random_ds(np.random.default_rng(13 if cap == 8 else 3),
                    n_genomes=4, n_fams=6)
    monkeypatch.setattr(
        tcand, "_host_fallback_rows",
        lambda *a: pytest.fail("the retry must stay on the device"))
    got, want, oracle, idx = _both(ds, join_kernel, row_block=8,
                                   col_block=128, candidate_cap=cap)
    _assert_all_equal(got, want, oracle, idx)


@pytest.mark.parametrize("join_kernel", KERNELS)
def test_no_duplicate_cells(join_kernel):
    ds = _random_ds(np.random.default_rng(5), n_genomes=3, n_fams=6)
    _, tidx = twin_indexes(ds, k=3)
    cells = tcand.compute_cells_candidate(tidx, PipelineConfig(
        join_kernel=join_kernel, device="cpu", row_block=8, col_block=128,
        candidate_cap=3))
    _cells_dict(cells)  # asserts uniqueness


@pytest.mark.parametrize("tract", [40, 300])
def test_homopolymer_counts(tract):
    """A poly-A tract: at 300 residues the 3-mer AAA counts 298, which
    lane2 cannot pack, so the runner takes the lane kernel."""
    ds = FaaDataset(
        sequences=["A" * tract + "CDE", "A" * (tract - 7) + "CDE",
                   "CDECDECDE"],
        names=["a", "b", "c"],
        descriptions=["d"] * 3,
        seq_genome=[0, 1, 1],
        genome_names=["g0", "g1"],
    )
    got, want, oracle, idx = _both(ds, "lane2", row_block=8, col_block=128,
                                   candidate_cap=8)
    _assert_all_equal(got, want, oracle, idx)
    assert _valid_dict(got, idx)[(0, 1)][0] >= tract - 9
    assert tcand.join_kernel_for(idx, PipelineConfig()) == (
        "lane2" if tract < 256 else "lane")


def test_host_fallback_rows_match_jax():
    ds = _random_ds(np.random.default_rng(2), n_genomes=3, n_fams=5)
    jidx, tidx = twin_indexes(ds, k=3)
    rows = [0, 3, jidx.n_sequences - 1]
    want = jcand._host_fallback_rows(jidx, rows)
    got = tcand._host_fallback_rows(tidx, rows)
    for f in ("row", "col", "intersection", "perc_cnt", "tr_perc_cnt"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    empty = tcand._host_fallback_rows(tidx, [])
    assert len(empty) == 0 and empty.row.dtype == np.int32


def test_empty_index_has_no_cells():
    ds = FaaDataset(sequences=["AC", "D"], names=["a", "b"],
                    descriptions=["d"] * 2, seq_genome=[0, 1],
                    genome_names=["g0", "g1"])
    _, tidx = twin_indexes(ds, k=3)
    cells = tcand.compute_cells_candidate(tidx, PipelineConfig(device="cpu"))
    assert len(cells) == 0
