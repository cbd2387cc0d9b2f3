"""Seconds a job spends in the native k-mer index build
(``native/host_index.cpp`` through ``native_build_index``): the
program's ``index.native`` span, ``phase_times["index.native"]``.
``index_s`` less it is the Python encoding and the index's assembly."""

KEY = "index.native"


def read(record):
    jobs = record["jobs"]
    vals = [j["phase_times"][KEY] for j in jobs
            if KEY in j.get("phase_times", {})]
    if not jobs or len(vals) != len(jobs):
        return None
    return sum(vals) / len(jobs)
