"""Seconds a job spends building the k-mer index on the host
(``index.py``, ``native/host_index.cpp``): ``phase_times.index``."""


def read(record):
    jobs = record["jobs"]
    if not jobs:
        return None
    return sum(j["phase_times"]["index"] for j in jobs) / len(jobs)
