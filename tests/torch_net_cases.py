"""Cases and runners shared by the tests that hold the port's on-device
BBH network against the JAX package's ``compute_network_device`` (pallas
backend in interpret mode, or the xla backend; one CPU device).  The
cases mirror tests/test_net_device.py; each JAX result is computed once
per process."""

import functools

import numpy as np

from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.io.faa import FaaDataset
from pandelos_tpu.ops.net_device import (
    compute_network_device as jax_network,
)
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.ops.net_device import compute_network_device

from tests.test_cells_and_net import _random_ds
from tests.torch_port_util import twin_indexes

# name -> (dataset builder, row_block, candidate_cap)
CASES = {
    "seed0": (lambda: _random_ds(np.random.default_rng(0), 4, 10), 16, 64),
    "seed1": (lambda: _random_ds(np.random.default_rng(1), 4, 10), 16, 64),
    "seed4": (lambda: _random_ds(np.random.default_rng(4), 4, 10), 16, 64),
    "seed9": (lambda: _random_ds(np.random.default_rng(9), 4, 10), 16, 64),
    # a tiny cap forces the candidate-cap doubling retry
    "overflow_retry": (
        lambda: _random_ds(np.random.default_rng(2), 4, 8), 8, 2),
    "stats": (lambda: _random_ds(np.random.default_rng(5), 3, 12), 8, 64),
    # past 128 genomes the genome-pair stats are omitted
    "many_genomes": (
        lambda: _random_ds(np.random.default_rng(11), 130, 2), 16, 64),
}


def _paralog_ds():
    a = "ACDEFGHIKLMNPQRSTVWY" * 2
    b = a[:-3] + "WYW"
    return FaaDataset(
        sequences=[a, a, b, a, b],
        names=[f"s{i}" for i in range(5)],
        descriptions=["d"] * 5,
        seq_genome=[0, 0, 0, 1, 1],
        genome_names=["g0", "g1"],
    )


CASES["paralogs_identical_genes"] = (_paralog_ds, 8, 8)


@functools.lru_cache(maxsize=None)
def _indexes(name):
    build, _, _ = CASES[name]
    return twin_indexes(build(), k=3)


@functools.lru_cache(maxsize=None)
def _jax_result(name, no_stats, backend="pallas"):
    import os

    _, rb, cap = CASES[name]
    old = os.environ.pop("PANDELOS_NO_PAIR_STATS", None)
    if no_stats:
        os.environ["PANDELOS_NO_PAIR_STATS"] = "1"
    try:
        out = jax_network(_indexes(name)[0], JaxConfig(
            backend=backend, row_block=rb, col_block=128, candidate_cap=cap))
    finally:
        os.environ.pop("PANDELOS_NO_PAIR_STATS", None)
        if old is not None:
            os.environ["PANDELOS_NO_PAIR_STATS"] = old
    assert out is not None
    return out


def _port(name, backend="cuda"):
    _, rb, cap = CASES[name]
    out = compute_network_device(_indexes(name)[1], PipelineConfig(
        backend=backend, row_block=rb, col_block=128, candidate_cap=cap,
        device="cpu"))
    assert out is not None
    return out


def _assert_same(got, want):
    (ge, gs), (we, ws) = got, want
    np.testing.assert_array_equal(ge.a, we.a)
    np.testing.assert_array_equal(ge.b, we.b)
    np.testing.assert_array_equal(ge.w, we.w)
    shared = (set(gs) & set(ws)) - {"phase_s"}
    assert {"n_cells", "n_edges", "n_inter_edges", "n_intra_edges",
            "n_accepted_inter_cells", "n_joined_pairs",
            "candidate_cap_final", "pair_cap", "lane_D",
            "edge_cap"} <= shared
    assert ("genome_pairs" in gs) == ("genome_pairs" in ws)
    for k in sorted(shared):
        assert gs[k] == ws[k], k


