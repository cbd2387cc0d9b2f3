"""The exact join's share of its roofline, in %: the least time its work
needs on this card (``counts/join.py``: bytes at the memory bandwidth or
comparisons at the issue rate of ``peaks.json``, whichever is larger),
summed over the window's jobs, over the join kernels' device time."""

from benchmark.counts.join import least_seconds
from benchmark.metrics.join_kernel_ms import join_seconds


def read(record):
    peak = record.get("peak")
    work = record.get("join_work") or []
    secs = join_seconds(record)
    if peak is None or secs <= 0 or not work or None in work:
        return None
    return 100.0 * sum(least_seconds(w, peak) for w in work) / secs
