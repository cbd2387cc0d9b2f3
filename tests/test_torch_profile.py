"""``config.profile_dir`` (``pandelos_tpu_torch/profiling.py``) on the
CPU: a profiled run writes the Chrome trace and ``profile_summary.json``
(device fields null off the card) and the same ``.net``/``.clus`` bytes
as a run without it; the summary's device fields from a trace; a card
run without kernel events raises; the profiler stops on an error."""

import filecmp
import json
import os

import pytest
import torch

from pandelos_tpu_torch import profiling
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.pipeline import run_pipeline

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")
FAA = os.path.join(GOLDEN, "synth_small.faa")
DEVICE_FIELDS = ("device_busy_s", "busy_share", "n_kernel_launches",
                 "top_kernels")


def _cfg(**kw):
    return PipelineConfig(row_block=16, col_block=128, candidate_cap=64,
                          device="cpu", **kw)


@pytest.mark.parametrize("backend", ["cuda", "xla", "dense", "reference"])
def test_profiled_run_writes_trace_and_keeps_outputs(tmp_path, backend):
    plain = str(tmp_path / "plain")
    prof = str(tmp_path / "prof")
    pdir = str(tmp_path / "trace")
    run_pipeline(FAA, plain, _cfg(backend=backend))
    res = run_pipeline(FAA, prof, _cfg(backend=backend, profile_dir=pdir))
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prof + suffix, plain + suffix, shallow=False)
        assert filecmp.cmp(prof + suffix,
                           os.path.join(GOLDEN, "synth_small" + suffix),
                           shallow=False)
    assert sorted(os.listdir(pdir)) == ["profile_summary.json", "trace.json"]
    with open(os.path.join(pdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    if backend != "reference":  # the host-only twin runs no torch op
        assert any(e.get("cat") == "cpu_op" for e in events)
    with open(os.path.join(pdir, "profile_summary.json")) as fh:
        summary = json.load(fh)
    assert summary["trace"] == "trace.json"
    # the window covers the whole job, from its first span to its last
    job_s = (res.spans[-1]["end_ns"] - res.spans[0]["start_ns"]) / 1e9
    assert job_s <= summary["window_s"] <= job_s + 1.0
    for f in DEVICE_FIELDS:
        assert summary[f] is None


def test_profiled_run_writes_the_job_spans(tmp_path):
    """Each span of the job is a ``pandelos.<span>`` range of the trace,
    from ``ingest`` to ``stats``, each inside its parent's range."""
    pdir = str(tmp_path / "trace")
    res = run_pipeline(FAA, str(tmp_path / "p"), _cfg(profile_dir=pdir))
    with open(os.path.join(pdir, "trace.json")) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("name", "").startswith("pandelos.")]
    assert sorted(e["name"] for e in events) == sorted(
        "pandelos." + s["name"] for s in res.spans)
    tops = [s["name"] for s in res.spans if s["parent"] is None]
    first = min(events, key=lambda e: e["ts"])
    last = max(events, key=lambda e: e["ts"] + e["dur"])
    assert (first["name"], last["name"]) == ("pandelos.ingest",
                                            "pandelos.stats")
    assert (tops[0], tops[-1]) == ("ingest", "stats")
    (index,) = [e for e in events if e["name"] == "pandelos.index"]
    (device,) = [e for e in events if e["name"] == "pandelos.index.device"]
    assert index["ts"] <= device["ts"]
    assert device["ts"] + device["dur"] <= index["ts"] + index["dur"]


def _trace(path, kernels):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
               "dur": 1e6}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d}
               for n, ts, d in kernels]
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)


def test_summary_busy_time_is_the_union_of_kernel_intervals(tmp_path):
    path = str(tmp_path / "t.json")
    # microseconds: [10, 30) and [20, 50) overlap, [100, 110) apart, and
    # [40, 45) inside; busy 40 + 10 = 50 us
    _trace(path, [("gemm", 10.0, 20.0), ("gemm", 20.0, 30.0),
                  ("join", 100.0, 10.0), ("fill", 40.0, 5.0)]
           + [(f"k{i}", 200.0 + i, 0.5) for i in range(12)])
    s = profiling.summarize(path, 1e-3, on_card=True)
    assert s["device_busy_s"] == pytest.approx((50 + 12 * 0.5) * 1e-6)
    assert s["busy_share"] == pytest.approx(s["device_busy_s"] / 1e-3)
    assert s["n_kernel_launches"] == 16
    top = s["top_kernels"]
    assert len(top) == 10
    assert top[0] == {"name": "gemm", "launches": 2,
                      "seconds": pytest.approx(50e-6)}
    assert [t["name"] for t in top[1:3]] == ["join", "fill"]


def test_summary_of_a_card_run_without_kernels_raises(tmp_path):
    path = str(tmp_path / "t.json")
    _trace(path, [])
    with pytest.raises(RuntimeError, match="no kernel event"):
        profiling.summarize(path, 1.0, on_card=True)
    assert profiling.summarize(path, 1.0, on_card=False)["busy_share"] is None


def test_profiled_device_run_needs_the_card(tmp_path, monkeypatch):
    """A profiled run of a device backend on "cuda" (the default) raises
    where there is no card, and writes nothing; host-only backends do not
    touch the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pdir = str(tmp_path / "trace")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pipeline(FAA, None, PipelineConfig(profile_dir=pdir))
    assert not os.path.exists(os.path.join(pdir, "profile_summary.json"))
    for backend in ("oracle", "reference"):
        cfg = PipelineConfig(backend=backend, profile_dir=pdir)
        assert profiling.profiled_device(cfg) is None


def test_profiler_stops_on_an_error(tmp_path, monkeypatch):
    import pandelos_tpu_torch.ops.net_device as nd

    def fail(*a, **k):
        raise ValueError("boom")

    monkeypatch.setattr(nd, "compute_network_device", fail)
    pdir = str(tmp_path / "trace")
    with pytest.raises(ValueError, match="boom"):
        run_pipeline(FAA, None, _cfg(profile_dir=pdir))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not os.path.exists(os.path.join(pdir, "profile_summary.json"))
