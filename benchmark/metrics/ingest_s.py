"""Seconds a job spends reading the ``.faa`` and choosing k
(``io/faa.py``, ``ksel.py``): ``phase_times`` ingest + k_select."""


def read(record):
    jobs = record["jobs"]
    if not jobs:
        return None
    return sum(j["phase_times"]["ingest"] + j["phase_times"]["k_select"]
               for j in jobs) / len(jobs)
