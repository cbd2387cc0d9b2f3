"""Seconds a job's device engine spends with the host blocked on the
card (``ops/net_device.py``, ``parallel/shards.py``: scalar reads,
``nonzero``, copies to the host): the engine's ``phase_s["wait"]``, the
``wait_s`` counters of its sub-phase spans."""

KEY = "wait"


def read(record):
    jobs = record["jobs"]
    vals = [j["phase_s"][KEY] for j in jobs if KEY in j.get("phase_s", {})]
    if not jobs or len(vals) != len(jobs):
        return None
    return sum(vals) / len(jobs)
