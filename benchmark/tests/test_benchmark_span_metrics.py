"""The readers of the program's own spans (``net_write_s``,
``index_native_s``, ``cluster_split_s``, ``engine_wait_s``) on synthetic
records: the mean over the window's jobs where every job holds the key,
None where a job lacks it (a program without the span), and a traced
run of the program on the CPU that reports all four."""

import time

import pytest

from benchmark import harness

from test_benchmark_harness import _recorded, _small_cell, SEED

# metric -> (the job's field, its key)
SPAN_METRICS = {
    "net_write_s": ("phase_times", "net_write"),
    "index_native_s": ("phase_times", "index.native"),
    "cluster_split_s": ("phase_times", "cluster.split"),
    "engine_wait_s": ("phase_s", "wait"),
}


def _with(field, key, values):
    rec = _recorded()
    for job, v in zip(rec["jobs"], values):
        job[field][key] = v
    return rec


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reads_the_mean_over_the_jobs(name):
    field, key = SPAN_METRICS[name]
    rec = _with(field, key, [0.5, 1.5])
    assert harness.load_metric(name).read(rec) == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_none_where_a_job_lacks_the_span(name):
    field, key = SPAN_METRICS[name]
    reader = harness.load_metric(name)
    assert reader.read(_recorded()) is None  # the parent program
    rec = _with(field, key, [0.5])  # one job of two holds it
    assert reader.read(rec) is None
    for job in rec["jobs"]:
        job.pop(field)
    assert reader.read(rec) is None
    rec["jobs"] = []
    assert reader.read(rec) is None


def test_a_traced_run_reports_the_span_metrics(tmp_path):
    out = harness.measure(_small_cell(), SEED, 0.5, True, "cpu",
                          str(tmp_path), time.monotonic(), workers=1)
    assert out["correct"] is True
    m = out["metrics"]
    assert set(SPAN_METRICS) <= set(m)
    assert m["index_native_s"]["value"] <= m["index_s"]["value"]
    assert m["cluster_split_s"]["value"] <= m["cluster_s"]["value"]
    assert m["engine_wait_s"]["value"] <= m["engine_s"]["value"]
    assert all(m[n]["unit"] == "s" for n in SPAN_METRICS)
