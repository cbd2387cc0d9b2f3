"""Seconds a job spends in the clustering's pool of native
Girvan-Newman splits (``cluster.py``, ``pt_gn_split``): the program's
``cluster.split`` span, ``phase_times["cluster.split"]``.  ``cluster_s``
less it is the components pass and the families' assembly."""

KEY = "cluster.split"


def read(record):
    jobs = record["jobs"]
    vals = [j["phase_times"][KEY] for j in jobs
            if KEY in j.get("phase_times", {})]
    if not jobs or len(vals) != len(jobs):
        return None
    return sum(vals) / len(jobs)
