"""Seconds a job's device engine spends on its heavy rows, those whose
candidates pass the main extraction's cap (``ops/net_device.py``): the
engine's ``phase_s["extract.heavy"]``, the span of their second
extraction at their own cap and of the host walk of any row past the
retry cap.  A job with no such row has no span."""

KEY = "extract.heavy"


def read(record):
    jobs = record["jobs"]
    vals = [j["phase_s"][KEY] for j in jobs if KEY in j.get("phase_s", {})]
    if not jobs or len(vals) != len(jobs):
        return None
    return sum(vals) / len(jobs)
