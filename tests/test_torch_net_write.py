"""The ``.net`` writer (``pandelos_tpu_torch/io/net.py::write_net``) on the
CPU: the native formatter (``pt_format_net``, any thread count) and the
Python twin (``write_net_plain``) write the bytes of the JAX package's
writer on canonical, unsorted, duplicated, boundary-scored and empty edge
lists; the native scores are ``java_double_str``'s; and a job's
``net_write`` span carries the writer's counters."""

import filecmp
import os

import numpy as np
import pytest

from pandelos_tpu.io.net import EdgeList as JaxEdgeList
from pandelos_tpu.io.net import write_net as jax_write_net
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.io import net as torch_net
from pandelos_tpu_torch.io.net import (
    EdgeList,
    java_double_str,
    read_net,
    write_net,
    write_net_plain,
)
from pandelos_tpu_torch.native import loader
from pandelos_tpu_torch.pipeline import run_pipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SMALL = os.path.join(GOLDEN, "synth_small.faa")


def _canonical_large(n=200_000, seed=0):
    """Sorted, unique (a < b) edges with Jaccard-like f32 scores, as the
    device path's ``host.edges`` builds them; more lines than three
    native threads' least share."""
    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(0, 20_000, n))
    key = np.unique((a << 32) | (a + rng.integers(1, 400, n)))
    inter = rng.integers(1, 3000, len(key))
    union = inter + rng.integers(0, 4000, len(key))
    w = (inter.astype(np.float32) / union.astype(np.float32))
    return EdgeList(key >> 32, key & 0xFFFFFFFF, w.astype(np.float64))


def _unsorted():
    """Reversed pairs (a > b), duplicates in either orientation (the last
    one wins) and shuffled order."""
    el = _canonical_large(5_000, seed=1)
    rng = np.random.default_rng(2)
    flip = rng.random(len(el)) < 0.5
    a = np.where(flip, el.b, el.a)
    b = np.where(flip, el.a, el.b)
    dup = rng.choice(len(el), 700, replace=False)
    a = np.concatenate([a, el.b[dup]])
    b = np.concatenate([b, el.a[dup]])
    w = np.concatenate([el.w, rng.random(len(dup)).astype(np.float32)])
    order = rng.permutation(len(a))
    return EdgeList(a[order], b[order], w[order])


def _sorted_duplicates():
    """Ascending keys with runs of one pair repeated: the last score wins."""
    el = _canonical_large(5_000, seed=3)
    rep = np.ones(len(el), np.int64)
    rep[::7] = 3
    w = np.repeat(el.w, rep) * np.tile([1.0, 0.5, 0.25],
                                       len(el))[:rep.sum()]
    return EdgeList(np.repeat(el.a, rep), np.repeat(el.b, rep), w)


def _sorted_flipped():
    """Ascending canonical keys, some pairs given as (b, a): no sort."""
    el = _canonical_large(5_000, seed=4)
    flip = np.arange(len(el)) % 3 == 0
    return EdgeList(np.where(flip, el.b, el.a), np.where(flip, el.a, el.b),
                    el.w)


def _boundaries():
    """Scores on both sides of Java's notation switch at 1e-3, 1/20000,
    1.0 and 0.0."""
    f = np.float32
    scores = [f(1e-3), np.nextafter(f(1e-3), f(0)), np.nextafter(f(1e-3), f(1)),
              f(1) / f(20000), f(1.0), np.nextafter(f(1.0), f(0)), f(0.0),
              f(1) / f(1001), f(1) / f(999), f(5e-4), f(0.5), f(2) / f(3)]
    n = len(scores)
    return EdgeList(np.arange(n), np.arange(n) + 7,
                    np.array(scores, np.float32).astype(np.float64))


def _golden_net():
    return read_net(os.path.join(GOLDEN, "synth_small.net"))


CASES = {
    "canonical": _canonical_large,
    "golden": _golden_net,
    "unsorted_duplicates": _unsorted,
    "sorted_duplicates": _sorted_duplicates,
    "sorted_flipped": _sorted_flipped,
    "boundaries": _boundaries,
    "empty": lambda: EdgeList.from_any([]),
}


def _native_off(monkeypatch):
    monkeypatch.setattr(torch_net, "native_available", lambda: False)


@pytest.mark.parametrize("native", [True, False], ids=["native", "plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_writer_matches_the_jax_writer(tmp_path, monkeypatch, case, native):
    edges = CASES[case]()
    want = str(tmp_path / "jax.net")
    jax_write_net(want, JaxEdgeList(edges.a, edges.b, edges.w))
    if not native:
        _native_off(monkeypatch)
    got = str(tmp_path / "port.net")
    counters = write_net(got, edges)
    assert filecmp.cmp(want, got, shallow=False)
    assert counters["native"] == int(native)
    assert counters["bytes"] == os.path.getsize(want)
    assert counters["sorted_input"] == int("duplicates" not in case)
    assert counters["threads"] >= int(native)
    if case == "golden":
        assert filecmp.cmp(os.path.join(GOLDEN, "synth_small.net"), got,
                           shallow=False)


def test_plain_twin_matches_the_jax_writer_on_unsorted_edges(tmp_path):
    edges = _unsorted()
    jax_write_net(str(tmp_path / "jax.net"),
                  JaxEdgeList(edges.a, edges.b, edges.w))
    counters = write_net_plain(str(tmp_path / "plain.net"), edges)
    assert filecmp.cmp(str(tmp_path / "jax.net"), str(tmp_path / "plain.net"),
                       shallow=False)
    assert counters == {"native": 0, "sorted_input": 0, "threads": 0,
                        "bytes": os.path.getsize(tmp_path / "jax.net")}


def test_tuple_input_and_last_duplicate_wins(tmp_path):
    edges = [(3, 1, 0.5), (0, 2, 0.25), (1, 3, 0.125), (2, 0, 1.0)]
    write_net(str(tmp_path / "t.net"), edges)
    assert (tmp_path / "t.net").read_text() == "0\t2\t1.0\n1\t3\t0.125\n"


@pytest.mark.parametrize("threads", [1, 2, 3, 16, 0])
def test_bytes_do_not_depend_on_the_thread_count(tmp_path, threads):
    edges = _canonical_large()
    one = str(tmp_path / "one.net")
    loader.native_write_net(one, edges.a, edges.b,
                            edges.w.astype(np.float32), 1)
    many = str(tmp_path / "many.net")
    n_bytes, used = loader.native_write_net(
        many, edges.a, edges.b, edges.w.astype(np.float32), threads)
    assert filecmp.cmp(one, many, shallow=False)
    assert n_bytes == os.path.getsize(one)
    # each thread takes at least 65,536 lines
    if threads:
        assert used == min(threads, -(-len(edges) // 65536))
    assert 1 <= used <= 4


def _native_scores(tmp_path, w32):
    idx = np.arange(len(w32))
    path = str(tmp_path / "scores.net")
    loader.native_write_net(path, idx, idx, w32)
    with open(path) as fh:
        return [line.split("\t")[2] for line in fh.read().splitlines()]


def test_every_small_ratio_formats_as_java_double_str(tmp_path):
    i, j = np.triu_indices(1024)
    w32 = np.unique((i + 1).astype(np.float32) / (j + 1).astype(np.float32))
    assert _native_scores(tmp_path, w32) == [
        java_double_str(v) for v in w32.tolist()]


def test_special_scores_format_as_java_double_str(tmp_path):
    f = np.float32
    w32 = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e7, 9999999.0,
                    np.nextafter(f(1e7), f(0)), 12345678.0, 1e-45, 3.4e38,
                    -0.5, -1e-4, 100.0, 1234567.0, 0.1, 1e-3, 2.5e-3],
                   dtype=np.float32)
    assert _native_scores(tmp_path, w32) == [
        java_double_str(v) for v in w32.tolist()]


def _net_write_span(res):
    (sp,) = [s for s in res.spans if s["name"] == "net_write"]
    return sp["counters"]


@pytest.mark.parametrize("native", [True, False], ids=["native", "plain"])
def test_net_write_span_counts_the_mechanism(tmp_path, monkeypatch, native):
    if not native:
        _native_off(monkeypatch)
    prefix = str(tmp_path / "s")
    res = run_pipeline(SMALL, prefix, PipelineConfig(
        device="cpu", row_block=16, col_block=128, candidate_cap=64))
    counters = _net_write_span(res)
    assert filecmp.cmp(prefix + ".net",
                       os.path.join(GOLDEN, "synth_small.net"), shallow=False)
    assert counters["edges"] == len(res.edges)
    assert counters["bytes"] == os.path.getsize(prefix + ".net")
    assert counters["native"] == int(native)
    assert counters["sorted_input"] == 1  # host.edges is canonical
    assert counters["threads"] == int(native)  # far below 65,536 lines
