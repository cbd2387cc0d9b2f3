"""The reader of ``heavy_rows_s`` on synthetic records: the mean over the
window's jobs of the engine's ``phase_s["extract.heavy"]`` where every
job holds it, None where a job lacks it (a program without the heavy-row
pass, or a job none of whose rows passed the cap)."""

import pytest

from benchmark import harness

from test_benchmark_harness import _recorded


def test_reads_the_mean_over_the_jobs():
    rec = _recorded()
    for job, v in zip(rec["jobs"], (0.25, 0.75)):
        job["phase_s"]["extract.heavy"] = v
    assert harness.load_metric("heavy_rows_s").read(rec) == pytest.approx(
        0.5)


def test_none_without_the_span():
    reader = harness.load_metric("heavy_rows_s")
    rec = _recorded()
    assert reader.read(rec) is None  # the parent program
    rec["jobs"][0]["phase_s"]["extract.heavy"] = 0.5  # one job of two
    assert reader.read(rec) is None
    for job in rec["jobs"]:
        job.pop("phase_s")
    assert reader.read(rec) is None
    rec["jobs"] = []
    assert reader.read(rec) is None
