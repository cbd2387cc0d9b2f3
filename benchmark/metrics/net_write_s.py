"""Seconds a job spends writing its ``.net`` (``io/net.py::write_net``),
the card idle: the program's ``net_write`` span,
``phase_times.net_write``."""

KEY = "net_write"


def read(record):
    jobs = record["jobs"]
    vals = [j["phase_times"][KEY] for j in jobs
            if KEY in j.get("phase_times", {})]
    if not jobs or len(vals) != len(jobs):
        return None
    return sum(vals) / len(jobs)
