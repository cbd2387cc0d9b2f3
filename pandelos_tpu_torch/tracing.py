"""The job's span tree: the one timing of a pipeline run.

Every ``run_pipeline`` call is a job (:func:`job`).  Code at each layer
boundary opens a span (``with span("index") as sp: ... sp.add("kmers",
n)``); a span records its name, its id, its parent's id, the job's id,
its start and end in ns, and the counters the code set while it was
open.  The current span lives in a ``ContextVar``, so a function deep in
a layer opens a child without being handed its parent.  Spans are kept
in memory; the pipeline returns them and writes them into the job's
``.stats.json`` (its ``"trace"`` block), and derives ``phase_times``
from them (:func:`phase_times`).

Clock: a job reads ``time.time_ns()`` once at its start and stamps every
span with that anchor plus the ``time.perf_counter_ns()`` time since, so
spans sit on the wall clock that ``torch.profiler`` events use, without
the wall clock's steps.  A span opened outside any job is timed the same
way from an anchor taken at import, and recorded nowhere.

A span never synchronises the card.  Where the host blocks on the card
(a device scalar read into Python, a copy to the host, a ``nonzero``),
the blocking code runs under :func:`blocked`, which adds the seconds and
one read to the ``wait_s`` and ``wait_reads`` counters of the current
span and of every span around it.  Worker threads open no spans:
:func:`worker` runs a thread's function with a wait tally of its own and
returns it beside the result, and the owning thread adds the tallies up
(:func:`add_waits`).

Under ``config.profile_dir`` (``profiling.profiled``, through
:func:`mirrored`) every span is also a ``torch.profiler`` range named
``pandelos.<span>``; otherwise no range is opened.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

PREFIX = "pandelos."  # the profiler ranges' names under profile_dir

_ANCHOR = (time.time_ns(), time.perf_counter_ns())
_ids = itertools.count(1)
_job: contextvars.ContextVar = contextvars.ContextVar(
    "pandelos_job", default=None)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "pandelos_span", default=None)
_tally: contextvars.ContextVar = contextvars.ContextVar(
    "pandelos_wait_tally", default=None)
_mirror: contextvars.ContextVar = contextvars.ContextVar(
    "pandelos_mirror", default=False)


class Job:
    """One run's spans, in the order they opened, and its clock."""

    __slots__ = ("id", "anchor_ns", "perf0_ns", "spans")

    def __init__(self):
        # 16 hex digits; uuid4 took some 30 us here, before the first span
        self.id = os.urandom(8).hex()
        self.anchor_ns = time.time_ns()
        self.perf0_ns = time.perf_counter_ns()
        self.spans: List[Span] = []

    def now_ns(self) -> int:
        return self.anchor_ns + time.perf_counter_ns() - self.perf0_ns

    def records(self) -> List[dict]:
        """The closed spans as dicts (:meth:`Span.record`)."""
        return [s.record() for s in self.spans if s.end_ns is not None]


def _now_ns(job: Optional[Job]) -> int:
    if job is not None:
        return job.now_ns()
    return _ANCHOR[0] + time.perf_counter_ns() - _ANCHOR[1]


class Span:
    """A timed region; a context manager (:func:`span`)."""

    __slots__ = ("name", "id", "parent", "job", "start_ns", "end_ns",
                 "counters", "_up", "_token", "_range")

    def __init__(self, name: str, counters: dict):
        self.name = name
        self.counters = counters
        self.start_ns = self.end_ns = None

    def __enter__(self) -> "Span":
        job = _job.get()
        up = _current.get()
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.job = job.id if job is not None else None
        self._up = up
        self._token = _current.set(self)
        self._range = None
        if _mirror.get():
            from torch.autograd.profiler import record_function

            self._range = record_function(PREFIX + self.name)
            self._range.__enter__()
        if job is not None:
            job.spans.append(self)
        self.start_ns = _now_ns(job)
        return self

    def __exit__(self, *exc) -> None:
        job = _job.get()
        self.end_ns = _now_ns(job)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _current.reset(self._token)

    def add(self, key: str, value) -> None:
        """Add ``value`` to the counter ``key`` (0 before)."""
        self.counters[key] = self.counters.get(key, 0) + value

    def set(self, key: str, value) -> None:
        self.counters[key] = value

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def record(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "job": self.job, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "counters": dict(self.counters)}


def span(name: str, **counters) -> Span:
    """A span named ``name`` under the current one, with ``counters``."""
    return Span(name, counters)


def add(key: str, value) -> None:
    """Add ``value`` to the counter ``key`` of the current span (none
    outside a span), for code that is not handed its span."""
    sp = _current.get()
    if sp is not None:
        sp.add(key, value)


@contextmanager
def job():
    """A job: a fresh span tree and clock anchor for the body."""
    j = Job()
    tj = _job.set(j)
    ts = _current.set(None)
    try:
        yield j
    finally:
        _current.reset(ts)
        _job.reset(tj)


@contextmanager
def mirrored():
    """Spans opened in the body are also ``torch.profiler`` ranges."""
    token = _mirror.set(True)
    try:
        yield
    finally:
        _mirror.reset(token)


def _add_wait(ns: int, reads: int) -> None:
    tally = _tally.get()
    if tally is not None:
        tally[0] += ns
        tally[1] += reads
        return
    sp = _current.get()
    while sp is not None:
        sp.add("wait_s", ns / 1e9)
        sp.add("wait_reads", reads)
        sp = sp._up


@contextmanager
def blocked():
    """The body blocks the host on the card: count it as a wait."""
    t = time.perf_counter_ns()
    try:
        yield
    finally:
        _add_wait(time.perf_counter_ns() - t, 1)


def to_int(t) -> int:
    """A device scalar as a Python int (a wait on the card)."""
    with blocked():
        return int(t)


def worker(fn):
    """``fn`` for a worker thread: it returns ``(fn(x), tally)``, the
    tally holding the ns and reads of the waits it made."""
    def run(x):
        tally = [0, 0]
        token = _tally.set(tally)
        try:
            return fn(x), tally
        finally:
            _tally.reset(token)
    return run


def add_waits(tallies) -> None:
    """Add worker threads' wait tallies to the current spans."""
    ns = sum(t[0] for t in tallies)
    reads = sum(t[1] for t in tallies)
    if reads:
        _add_wait(ns, reads)


def phase_times(spans) -> Dict[str, float]:
    """Seconds by name (summed over spans of one name) of every top-level
    span and of each child named under its parent (``index.encode``
    under ``index``); ``spans``: closed spans' records
    (:meth:`Job.records`)."""
    top = {r["id"]: r["name"] for r in spans if r["parent"] is None}
    out: Dict[str, float] = {}
    for r in spans:
        up = top.get(r["parent"])
        if r["parent"] is None or (up is not None
                                   and r["name"].startswith(up + ".")):
            out[r["name"]] = (out.get(r["name"], 0.0)
                              + (r["end_ns"] - r["start_ns"]) / 1e9)
    return out
