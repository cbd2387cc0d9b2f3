"""Milliseconds of device time a job spends in the exact join's kernels
(``ops/lane_join.py``, ``csrc/lane2_join.cu`` on the default path): the
traced window's device operations whose name holds "join", over the
jobs."""

MARK = "join"


def join_seconds(record):
    return sum((e - s) / 1e9 for name, s, e in record["ops"]
               if MARK in name.lower())


def read(record):
    secs = join_seconds(record)
    if secs <= 0 or not record["n_jobs"]:
        return None
    return 1e3 * secs / record["n_jobs"]
