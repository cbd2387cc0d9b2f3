"""The job's span tree (``pandelos_tpu_torch/tracing.py``) on the CPU:
the top-level spans tile ``run_pipeline`` and every child lies inside
its parent, ``phase_times`` and the engine's ``phase_s`` come from the
spans, ``.stats.json`` holds them; waits on the device count on every
span around them and worker threads hand theirs to the span that owns
them; the clustering pool and the memory plan are counted; and no
``torch.profiler`` range is opened without ``profile_dir``."""

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from pandelos_tpu_torch import tracing
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.pipeline import run_pipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SMALL = os.path.join(GOLDEN, "synth_small.faa")
REAL = os.path.join(GOLDEN, "synth_real.faa")
SIX = {"ingest", "k_select", "index", "score", "network", "cluster"}
ENGINE = ["setup.pad_profiles", "setup.runner", "setup.signatures",
          "extract", "plan", "flatten_join", "bbh", "fetch", "host.edges",
          "host.stats"]
TAIL = ["net_write", "cluster", "clus_write", "stats"]
HEAD = ["ingest", "k_select", "index", "score"]


def _cfg(**kw):
    return PipelineConfig(**{"row_block": 16, "col_block": 128,
                             "candidate_cap": 64, "device": "cpu", **kw})


def _seconds(s):
    return (s["end_ns"] - s["start_ns"]) / 1e9


@pytest.mark.parametrize("opts,top", [
    ({}, HEAD + TAIL),
    ({"backend": "xla"}, HEAD + TAIL),
    ({"device_bbh": False}, HEAD + ["network"] + TAIL),
    ({"backend": "dense"}, HEAD + ["network"] + TAIL),
    ({"backend": "reference"}, HEAD + ["network"] + TAIL),
    ({"n_devices": 2, "write_report": True},
     HEAD + ["net_write", "cluster", "clus_write", "report", "stats"]),
], ids=["cuda", "xla", "cells", "dense", "reference", "two_shards"])
def test_spans_tile_the_job(tmp_path, opts, top):
    prefix = str(tmp_path / "s")
    run_pipeline(SMALL, prefix, _cfg(**opts))  # first-use costs
    untiled = []
    for _ in range(3):
        # neither the last result's release nor the config is timed
        res = out = spans = None
        cfg = _cfg(**opts)
        t = time.perf_counter_ns()
        out = run_pipeline(SMALL, prefix, cfg)
        wall = (time.perf_counter_ns() - t) / 1e9
        res, spans = out, out.spans
        tops = [s for s in spans if s["parent"] is None]
        assert [s["name"] for s in tops] == top
        for a, b in zip(tops, tops[1:]):
            assert 0 <= b["start_ns"] - a["end_ns"] < 1_000_000
        untiled.append(abs(1 - sum(map(_seconds, tops)) / wall))
    assert min(untiled) < 0.01

    assert len({s["job"] for s in spans}) == 1 and spans[0]["job"]
    assert len({s["id"] for s in spans}) == len(spans)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["parent"] is not None:
            up = by_id[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= up["end_ns"]

    pt = res.phase_times
    assert SIX <= set(pt)
    for name in top:
        assert pt[name] == pytest.approx(sum(
            _seconds(s) for s in tops if s["name"] == name))
    for child in ("index.encode", "index.device", "cluster.assemble"):
        assert pt[child] == pytest.approx(sum(
            _seconds(s) for s in spans if s["name"] == child))
    if "network" not in top:
        assert pt["network"] == 0.0
        engine = [s["name"] for s in spans
                  if by_id.get(s["parent"], {}).get("name") == "score"]
        want = [n for n in ENGINE
                if n != "flatten_join" or opts.get("backend") != "xla"]
        assert engine == want
        phase_s = res.stats["network"]["phase_s"]
        assert list(phase_s) == want + ["wait"]
        assert 0 <= phase_s["wait"] <= pt["score"]

    with open(prefix + ".stats.json") as fh:
        doc = json.load(fh)
    assert doc["trace"]["job"] == spans[0]["job"]
    # written inside the stats span: every span but that one
    assert doc["trace"]["spans"] == [s for s in spans
                                     if s["name"] != "stats"]
    assert set(doc["phase_times"]) == set(pt) - {"stats"}


def test_engine_counters_and_waits():
    res = run_pipeline(SMALL, None, _cfg())
    by = {s["name"]: s for s in res.spans}
    net = res.stats["network"]
    assert by["extract"]["counters"]["passes"] >= 1
    assert by["extract"]["counters"]["K"] == net["candidate_cap_final"]
    assert by["flatten_join"]["counters"]["pair_cap"] == net["pair_cap"]
    assert by["flatten_join"]["counters"]["launches"] == 1
    # the fill kernel runs on a card only (test_torch_kernels_on_card.py)
    assert by["flatten_join"]["counters"]["fill_launches"] == 0
    assert by["plan"]["counters"]["planned_peak_bytes"] == \
        net["planned_peak_bytes"]
    assert by["bbh"]["counters"]["edge_cap"] == net["edge_cap"]
    assert by["bbh"]["counters"]["edge_cap_initial"] == \
        net["edge_cap_initial"]
    assert by["fetch"]["counters"]["edges"] == net["n_edges"]
    # the engine's waits add up on the score span around them
    score = by["score"]["counters"]
    assert score["wait_reads"] == sum(
        by[n]["counters"].get("wait_reads", 0) for n in ENGINE)
    assert score["wait_reads"] > 0
    assert score["wait_s"] == pytest.approx(net["phase_s"]["wait"])
    assert by["net_write"]["counters"] == {"edges": len(res.edges)}
    assert by["ingest"]["counters"]["sequences"] == res.n_sequences
    assert by["k_select"]["counters"] == {"k": res.k}
    assert by["index"]["counters"]["vocab_size"] == \
        res.stats["vocab_size"]


@pytest.mark.parametrize("opts", [
    {"device_bbh": False},
    {"device_bbh": False, "ring_extract": True, "n_devices": 2},
], ids=["cells", "ring_cells"])
def test_cells_paths_count_fill_launches_on_score(opts):
    """The cells path and the ring's fill their flat pair lists inside
    ``score``, which counts the fill kernel's launches (0 on the CPU)."""
    res = run_pipeline(SMALL, None, _cfg(**opts))
    by = {s["name"]: s for s in res.spans}
    assert by["score"]["counters"]["fill_launches"] == 0
    assert "flatten_join" not in by


def test_net_write_counts_its_bytes(tmp_path):
    prefix = str(tmp_path / "s")
    res = run_pipeline(SMALL, prefix, _cfg())
    (net,) = [s for s in res.spans if s["name"] == "net_write"]
    assert net["counters"]["bytes"] == os.path.getsize(prefix + ".net")


def test_clustering_pool_is_counted():
    res = run_pipeline(REAL, None, _cfg(backend="oracle"))
    by = {s["name"]: s for s in res.spans}
    comps = by["cluster.components"]["counters"]
    split = by["cluster.split"]["counters"]
    assert comps["components"] > comps["colliding"] > 0
    assert split["split_calls"] >= comps["colliding"]
    assert split["native_components"] == comps["colliding"]
    assert split["threads"] >= 1
    assert 0 < split["split_thread_s"]
    assert res.phase_times["cluster.split"] <= res.phase_times["cluster"]


def test_a_span_outside_a_job_is_timed_and_kept_nowhere():
    with tracing.span("alone", n=1) as sp:
        time.sleep(0.002)
    assert sp.job is None and sp.parent is None
    assert 0.002 <= sp.seconds < 1.0
    assert sp.record()["counters"] == {"n": 1}
    with tracing.job() as j:
        with tracing.span("a"):
            with tracing.span("b"):
                pass
    assert [s.name for s in j.spans] == ["a", "b"]
    assert j.spans[1].parent == j.spans[0].id
    assert tracing._current.get() is None


def test_waits_count_on_every_span_around_them():
    with tracing.job() as j:
        with tracing.span("outer") as outer:
            with tracing.span("inner") as inner:
                with tracing.blocked():
                    time.sleep(0.005)
                assert tracing.to_int(torch.tensor(7)) == 7
            with tracing.span("dry") as dry:
                pass
    assert inner.counters["wait_reads"] == outer.counters["wait_reads"] == 2
    assert inner.counters["wait_s"] >= 0.005
    assert outer.counters["wait_s"] == inner.counters["wait_s"]
    assert dry.counters == {}
    assert [s.name for s in j.spans] == ["outer", "inner", "dry"]


def test_worker_threads_hand_their_waits_to_the_owning_span():
    def work(x):
        assert tracing._current.get() is None  # a worker opens no span
        with tracing.blocked():
            time.sleep(0.002)
        return x * 2, threading.get_ident()

    with tracing.job() as j:
        with tracing.span("owner") as owner:
            with ThreadPoolExecutor(3) as pool:
                done = list(pool.map(tracing.worker(work), range(3)))
            tracing.add_waits([tally for _, tally in done])
    assert [v for (v, _), _ in done] == [0, 2, 4]
    assert owner.counters["wait_reads"] == 3
    assert owner.counters["wait_s"] >= 0.006
    assert [s.name for s in j.spans] == ["owner"]


def test_phase_times_reads_top_spans_and_their_named_children():
    def rec(i, name, parent, s, e):
        return {"name": name, "id": i, "parent": parent, "job": "j",
                "start_ns": s, "end_ns": e, "counters": {}}

    recs = [rec(1, "index", None, 0, 10**9),
            rec(2, "index.device", 1, 0, 5 * 10**8),
            rec(3, "score", None, 10**9, 3 * 10**9),
            rec(4, "extract", 3, 10**9, 2 * 10**9),
            rec(5, "cluster", None, 3 * 10**9, 4 * 10**9),
            rec(6, "cluster.assemble", 5, 3 * 10**9, 3 * 10**9 + 10**8),
            rec(7, "cluster.assemble", 5, 4 * 10**9 - 10**8, 4 * 10**9),
            rec(8, "index.device", 4, 10**9, 10**9 + 1)]
    assert tracing.phase_times(recs) == pytest.approx({
        "index": 1.0, "index.device": 0.5, "score": 2.0, "cluster": 1.0,
        "cluster.assemble": 0.2})


def test_no_profiler_range_without_profile_dir(tmp_path):
    """Under an outer profiler (the benchmark's traced run) the program
    opens no range of its own; mirrored spans would show."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_pipeline(SMALL, str(tmp_path / "s"), _cfg())
    assert not [e.name for e in prof.events()
                if e.name.startswith(tracing.PREFIX)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.mirrored():
            run_pipeline(SMALL, str(tmp_path / "s"), _cfg())
    names = {e.name for e in prof.events()}
    assert {tracing.PREFIX + n for n in HEAD + TAIL} <= names
