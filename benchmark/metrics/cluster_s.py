"""Seconds a job spends clustering on the host (``cluster.py``, the
native Girvan-Newman split): ``phase_times.cluster``."""


def read(record):
    jobs = record["jobs"]
    if not jobs:
        return None
    return sum(j["phase_times"]["cluster"] for j in jobs) / len(jobs)
