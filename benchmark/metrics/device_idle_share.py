"""The card's idle share of the traced window, in %: one minus the union
of its kernel and copy intervals over the window (first job's start to
the last job's end)."""

from benchmark.trace import busy_seconds, window_seconds


def read(record):
    window = window_seconds(record)
    if window <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(record) / window)
