"""Seconds a job spends in the device engine, from the padded profiles
to the BBH edges on the host (``ops/net_device.py``, ``ops/candidate.py``,
``ops/hist.py``, ``ops/score.py``): ``phase_times`` score + network.  The
engine's span ends in a fetch to the host, so it holds its device time."""


def read(record):
    jobs = record["jobs"]
    if not jobs:
        return None
    return sum(j["phase_times"]["score"] + j["phase_times"]["network"]
               for j in jobs) / len(jobs)
