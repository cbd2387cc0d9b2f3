"""The card's idle share inside the device engine, in %: one minus the
device's busy time within the jobs' rebuilt engine intervals over their
length (``benchmark/trace.py``)."""

from benchmark.trace import engine_intervals, overlap_seconds


def read(record):
    spans = engine_intervals(record)
    total = sum(e - s for s, e in spans) / 1e9
    if total <= 0:
        return None
    return 100.0 * (1.0 - overlap_seconds(record["busy"], spans) / total)
