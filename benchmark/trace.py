"""The traced run's record: one ``torch.profiler`` session over the
whole measured window, reduced to device intervals, the jobs' rebuilt
phase intervals and the breakdown of the result line.

The harness marks each job with a ``record_function`` range
(``bench.job.<i>``), so jobs and kernels share the trace's clock.  Each
job's phases are rebuilt from its start and its consecutive
``phase_times`` (ingest, k_select, index, then score + network, the
device engine); the ``.net`` write follows the engine and ends when the
``.net`` file was last written (its mtime, taken against the job's start
on the same wall clock); cluster follows it; the rest of the job, the
``.clus`` and ``.stats.json`` writes, is ``tail``.  These rebuilt spans
label the device's idle time until the program carries spans of its own.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

JOB_PREFIX = "bench.job."
BETWEEN = "harness"  # the harness's own work between two jobs


def merge(intervals) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals as sorted disjoint intervals
    (the arithmetic of ``pandelos_tpu_torch/profiling.py::_union_seconds``,
    kept as intervals)."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: int, hi: int):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def overlap_seconds(a, b) -> float:
    """Seconds in both unions, of ``a`` and of ``b``."""
    a, b = merge(a), merge(b)
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e9


def device_events(prof) -> Tuple[list, Dict[int, Tuple[int, int]]]:
    """(device operations as (name, start ns, end ns), each job's
    (start ns, end ns) by job number) from a stopped profiler."""
    import torch

    ops = []
    jobs = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = int(ev.start_ns())
        end = start + int(ev.duration_ns())
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # a job's range is mirrored on the device's timeline: it is
            # no device operation
            if end > start and not name.startswith(JOB_PREFIX):
                ops.append((name, start, end))
        elif name.startswith(JOB_PREFIX):
            jobs[int(name[len(JOB_PREFIX):])] = (start, end)
    return ops, jobs


def job_phases(job: dict, start: int, end: int) -> List[Tuple[str, int, int]]:
    """The rebuilt phase intervals of one job on the trace's clock."""
    pt = job["phase_times"]
    spans = []
    t = start
    for label, secs in (("ingest", pt["ingest"]), ("k_select", pt["k_select"]),
                        ("index", pt["index"]),
                        ("engine", pt["score"] + pt["network"])):
        d = int(secs * 1e9)
        spans.append((label, t, min(t + d, end)))
        t += d
    net_done = start + job["net_written_ns"] - job["wall_start_ns"]
    net_done = min(max(net_done, t), end)
    spans.append(("net_write", t, net_done))
    c_end = min(net_done + int(pt["cluster"] * 1e9), end)
    spans.append(("cluster", net_done, c_end))
    spans.append(("tail", c_end, end))
    return [(lbl, s, e) for lbl, s, e in spans if e > s]


def engine_intervals(record: dict) -> List[Tuple[int, int]]:
    return [(s, e) for lbl, s, e in record["spans"] if lbl == "engine"]


def build_record(jobs: List[dict], ops, job_ranges, join_work) -> dict:
    """What the per-layer readers read.  ``jobs``: the window's jobs
    (``phase_times``, ``phase_s``, wall clock of start and ``.net``
    write); ``ops``/``job_ranges``: from :func:`device_events`;
    ``join_work``: each job's join count (``counts/join.py``) or None."""
    starts = [job_ranges[i][0] for i in range(len(jobs))]
    ends = [job_ranges[i][1] for i in range(len(jobs))]
    lo, hi = min(starts), max(ends)
    spans = []
    for i, job in enumerate(jobs):
        spans += job_phases(job, *job_ranges[i])
        if i + 1 < len(jobs):
            spans.append((BETWEEN, ends[i], starts[i + 1]))
    ops = [(n, s, e) for n, s, e in ops if e > lo and s < hi]
    return {
        "jobs": jobs,
        "n_jobs": len(jobs),
        "window": (lo, hi),
        "ops": ops,
        "busy": merge(clip([(s, e) for _, s, e in ops], lo, hi)),
        "spans": spans,
        "join_work": join_work,
    }


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time by what the host was doing (a rebuilt phase, or the harness
    between jobs), the largest first; seconds over the whole window."""
    by_op: Dict[str, float] = {}
    for name, s, e in record["ops"]:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
    lo, hi = record["window"]
    idle = []
    cur = lo
    for s, e in record["busy"]:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        idle.append((cur, hi))
    by_phase: Dict[str, float] = {}
    for label, s, e in record["spans"]:
        sec = overlap_seconds(idle, [(s, e)])
        if sec > 0:
            by_phase[label] = by_phase.get(label, 0.0) + sec
    ordered = lambda d: [[k[:160], v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ordered(by_op), "idle_gaps": ordered(by_phase)}


def busy_seconds(record: dict) -> float:
    return sum(e - s for s, e in record["busy"]) / 1e9


def window_seconds(record: dict) -> float:
    lo, hi = record["window"]
    return (hi - lo) / 1e9
