"""Seconds a job spends padding the profiles on the host and uploading
them (``ops/score.py::pad_profiles``): the device engine's
``phase_s["setup.pad_profiles"]`` (which synchronises the card)."""

KEY = "setup.pad_profiles"


def read(record):
    jobs = record["jobs"]
    vals = [j["phase_s"][KEY] for j in jobs if KEY in j.get("phase_s", {})]
    if not jobs or len(vals) != len(jobs):
        return None
    return sum(vals) / len(jobs)
