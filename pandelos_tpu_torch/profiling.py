"""``config.profile_dir``: a whole job, entry to return, under
``torch.profiler`` (the JAX package's ``jax.profiler.trace`` covers its
score and network phases only).  While the profiler runs, each span of
the job (:mod:`pandelos_tpu_torch.tracing`) is also a profiler range
named ``pandelos.<span>``, so each kernel sits under the span that
launched it, on one clock; without ``profile_dir`` no range is opened.

The window writes two files into ``profile_dir``:

- ``trace.json``: the Chrome trace (``chrome://tracing`` or Perfetto):
  the ``pandelos.*`` ranges, host operators, and on the card every
  kernel and copy;
- ``profile_summary.json``: ``window_s`` (the window on the host clock),
  ``device_busy_s`` (the union of the intervals of the ``cat ==
  "kernel"`` events: overlapping kernels count once), ``busy_share``
  (busy over window; one minus it is the card's idle share),
  ``n_kernel_launches`` and ``top_kernels`` (the ten kernels with the
  most total time, each with its launches and seconds).  The device
  fields are null when the run touches no card: a CPU run, and the
  host-only backends ``oracle`` and ``reference``.

The profiler records CPU activity always, and CUDA activity when the run
drives the card; a card run whose trace holds no kernel raises instead
of writing an empty summary.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

from pandelos_tpu_torch import tracing
from pandelos_tpu_torch.config import resolve_backend

# backends that run on the device of ``config.device``
DEVICE_BACKENDS = ("cuda", "xla", "dense")
TRACE = "trace.json"
SUMMARY = "profile_summary.json"


def profiled_device(config):
    """The card a profiled run drives, or None for a host-only run."""
    if resolve_backend(config.backend) not in DEVICE_BACKENDS:
        return None
    from pandelos_tpu_torch.device import resolve_device

    dev = resolve_device(config.device)
    return dev if dev.type == "cuda" else None


def _union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in the trace's
    microseconds, as seconds."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def summarize(trace_path: str, window_s: float, on_card: bool) -> dict:
    """``profile_summary.json``'s fields from a Chrome trace."""
    summary = {
        "trace": os.path.basename(trace_path),
        "window_s": window_s,
        "device_busy_s": None,
        "busy_share": None,
        "n_kernel_launches": None,
        "top_kernels": None,
    }
    if not on_card:
        return summary
    with open(trace_path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = [e for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if not kernels:
        raise RuntimeError(
            f"{trace_path}: a run on the card recorded no kernel event "
            "(the profiler saw no CUDA activity)")
    busy = _union_seconds(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels)
    by_name = {}
    for e in kernels:
        n, s = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, s + float(e["dur"]) / 1e6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    summary.update(
        device_busy_s=busy,
        busy_share=busy / window_s,
        n_kernel_launches=len(kernels),
        top_kernels=[{"name": n, "launches": c, "seconds": s}
                     for n, (c, s) in top],
    )
    return summary


@contextlib.contextmanager
def profiled(config):
    """Profile the body into ``config.profile_dir``; on an exception the
    profiler stops and nothing is written."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = profiled_device(config)
    activities = [ProfilerActivity.CPU]
    if dev is not None:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(config.profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        # the window opens once the profiler runs: its start-up (the
        # first start in a process takes seconds on a card) is not the
        # run's
        t0 = time.monotonic()
        with tracing.mirrored():
            yield
        if dev is not None:
            torch.cuda.synchronize(dev)
        window_s = time.monotonic() - t0
    trace_path = os.path.join(config.profile_dir, TRACE)
    prof.export_chrome_trace(trace_path)
    summary = summarize(trace_path, window_s, dev is not None)
    with open(os.path.join(config.profile_dir, SUMMARY), "w") as fh:
        json.dump(summary, fh, indent=2)
