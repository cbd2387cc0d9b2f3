"""The port's dense backend (ops/score.py::compute_cells_xla) against the
JAX package's on the same index: every case of tests/test_xla_score.py,
cells equal in order and value, and equal to the oracle's valid cells;
plus the JAX package's own f32 count-clip fault, which the port keeps."""

import numpy as np
import pytest

from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.io.faa import FaaDataset
from pandelos_tpu.ops import score as jscore
from pandelos_tpu.oracle.cells import apply_validity, compute_cells_oracle
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.ops import score as tscore

from tests.test_cells_and_net import _random_ds
from tests.torch_port_util import twin_indexes


def _arrays(cells):
    return np.stack([cells.row.astype(np.int64), cells.col,
                     cells.intersection, cells.perc_cnt, cells.tr_perc_cnt])


def _cells_dict(cells):
    return {
        (int(r), int(c)): (int(i), int(p), int(t))
        for r, c, i, p, t in zip(cells.row, cells.col, cells.intersection,
                                 cells.perc_cnt, cells.tr_perc_cnt)
    }


def _both(ds, k=3, **cfg):
    """(port cells, JAX cells, the oracle's valid cells)."""
    jidx, tidx = twin_indexes(ds, k=k)
    got = tscore.compute_cells_xla(tidx, PipelineConfig(device="cpu", **cfg))
    want = jscore.compute_cells_xla(jidx, JaxConfig(**cfg))
    oracle = apply_validity(compute_cells_oracle(jidx), jidx.kseq_lengths,
                            jidx.k)
    assert got.row.dtype == want.row.dtype == np.int32
    assert got.intersection.dtype == want.intersection.dtype == np.int64
    return got, want, oracle


def _homopolymer():
    return FaaDataset(
        sequences=["A" * 30 + "CDE", "A" * 25 + "CDE", "CDECDECDE"],
        names=["a", "b", "c"], descriptions=["d"] * 3,
        seq_genome=[0, 1, 1], genome_names=["g0", "g1"],
    )


def _tiny():
    return FaaDataset(
        sequences=["ACDEF", "GHIKL"], names=["a", "b"],
        descriptions=["d"] * 2, seq_genome=[0, 1],
        genome_names=["g0", "g1"],
    )


def _rand(seed, n_genomes, n_fams):
    return lambda: _random_ds(np.random.default_rng(seed), n_genomes, n_fams)


# the cases of tests/test_xla_score.py: name -> (dataset, config)
CASES = {
    "seed0": (_rand(0, 3, 7), dict(row_block=16, col_block=128, level_cap=4)),
    "seed1": (_rand(1, 3, 7), dict(row_block=16, col_block=128, level_cap=4)),
    "seed5": (_rand(5, 3, 7), dict(row_block=16, col_block=128, level_cap=4)),
    "level_cap_correction": (
        _homopolymer, dict(row_block=8, col_block=128, level_cap=2)),
    "empty_and_tiny": (_tiny, {}),
    "blocking_8_128": (_rand(9, 4, 10), dict(row_block=8, col_block=128)),
    "blocking_32_256": (_rand(9, 4, 10), dict(row_block=32, col_block=256)),
    "overflow_retry": (
        _rand(13, 4, 10), dict(row_block=8, col_block=128, nnz_cap_per_row=1)),
    "f32_matmul_dtype": (
        _rand(11, 2, 5), dict(matmul_dtype="f32", row_block=8, col_block=128)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_cells_match_jax(name):
    build, cfg = CASES[name]
    got, want, oracle = _both(build(), **cfg)
    np.testing.assert_array_equal(_arrays(got), _arrays(want))
    assert _cells_dict(got) == _cells_dict(oracle)
    if name == "empty_and_tiny":
        assert len(got) == 0
    else:
        assert len(got) > 0
    if name == "level_cap_correction":
        # AAA: 28 in gene a, 23 in gene b, so min 23 > the cap of 2
        assert _cells_dict(got)[(0, 1)][0] >= 23


def test_overflow_retry_reruns_blocks():
    """nnz_cap_per_row=1 leaves blocks past their cap: each is rerun with
    its exact count, and those cells come first, as in the JAX package."""
    build, cfg = CASES["overflow_retry"]
    _, tidx = twin_indexes(build(), k=3)
    calls = []
    real = tscore._score_all_blocks

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((kw["cap"], [c for _, c in out]))
        return out

    tscore._score_all_blocks = spy
    try:
        tscore.compute_cells_xla(tidx, PipelineConfig(device="cpu", **cfg))
    finally:
        tscore._score_all_blocks = real
    cap = cfg["nnz_cap_per_row"] * cfg["row_block"]
    assert calls[0][0] == cap and max(calls[0][1]) > cap
    assert any(c > cap and counts[0] <= c for c, counts in calls[1:])


def test_f32_count_clip_fault_of_the_jax_package():
    """The JAX package clips counts at COUNT_CLIP = 256 for every matmul
    dtype but corrects the clip only for bf16 (pandelos_tpu/ops/score.py
    compute_cells_xla): with matmul_dtype="f32" and a k-mer count above
    256 its perc/tr counters come out short.  The port keeps that rule
    for parity: port == JAX != oracle there, and bf16 equals the oracle."""
    ds = FaaDataset(
        sequences=["A" * 300 + "CDEFG", "A" * 290 + "CDEFH"],
        names=["a", "b"], descriptions=["d"] * 2, seq_genome=[0, 1],
        genome_names=["g0", "g1"],
    )
    cfg = dict(row_block=8, col_block=128, matmul_dtype="f32")
    got, want, oracle = _both(ds, **cfg)
    np.testing.assert_array_equal(_arrays(got), _arrays(want))
    g, o = _cells_dict(got), _cells_dict(oracle)
    # AAA: 298 and 288; the clip takes 42 and 32 off perc and tr
    assert o[(0, 1)] == (292, 302, 292)
    assert g[(0, 1)] == (292, 260, 260) != o[(0, 1)]
    cfg["matmul_dtype"] = "bf16"
    got, want, oracle = _both(ds, **cfg)
    np.testing.assert_array_equal(_arrays(got), _arrays(want))
    assert _cells_dict(got) == _cells_dict(oracle)


@pytest.mark.parametrize("level_cap", [1, 4])
def test_row_block_core_matches_jax(level_cap):
    """One row block's f32 (inter, perc, tr) against every column, the
    clipped counters included, equal the JAX core's bits."""
    import jax.numpy as jnp
    import torch

    ds = _random_ds(np.random.default_rng(2), 3, 8)
    ds.sequences[0] = "A" * 280 + ds.sequences[0]  # a count past the clip
    jidx, tidx = twin_indexes(ds, k=3)
    padded = tscore.pad_profiles(tidx, 8, 128)
    rows = np.arange(8)
    w_row = padded.width
    want = jscore._score_row_block(
        jnp.asarray(padded.ids[rows, :w_row]),
        jnp.asarray(padded.counts[rows, :w_row]),
        jnp.asarray(padded.ids), jnp.asarray(padded.counts),
        vocab_size=tidx.vocab_size, col_block=128, level_cap=level_cap,
        matmul_dtype="bf16",
    )
    ids, cnt = torch.from_numpy(padded.ids), torch.from_numpy(padded.counts)
    got = tscore._score_row_block_core(
        ids[rows, :w_row], cnt[rows, :w_row], ids, cnt, tidx.vocab_size,
        128, level_cap, "bf16",
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # gene 0 against itself: perc sums its counts clipped at COUNT_CLIP
    c0 = tidx.profile_counts[: tidx.profile_ptr[1]]
    assert c0.max() > tscore.COUNT_CLIP
    assert float(got[1][0, 0]) == np.minimum(c0, tscore.COUNT_CLIP).sum()


def test_width_buckets_and_corrections_match_jax():
    ds = _random_ds(np.random.default_rng(4), 4, 10)
    ds.sequences[1] = "A" * 300 + ds.sequences[1]
    ds.sequences[5] = "A" * 270 + ds.sequences[5]
    jidx, tidx = twin_indexes(ds, k=3)
    widths = np.diff(tidx.profile_ptr)
    for rb in (8, 16):
        want = jscore._width_buckets(widths, rb, 256)
        got = tscore._width_buckets(widths, rb, 256)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[0] == w[0]
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
    for cap in (1, 2, 4):
        assert tscore._host_level_cap_corrections(tidx, cap) == \
            jscore._host_level_cap_corrections(jidx, cap)
    cc = tscore._host_count_clip_corrections(tidx)
    assert cc and cc == jscore._host_count_clip_corrections(jidx)
    assert tscore._host_compute_cell(tidx, 1, 5) == \
        jscore._host_compute_cell(jidx, 1, 5)
