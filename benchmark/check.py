"""What decides ``correct``: a job's ``.net`` and ``.clus`` against the
plain reference (``benchmark/reference/``), and every timed job's files
against the judged job's.

Each number compared has the limit 0: the program's output is exact
(integer counters, one float32 division a score, the upstream's BBH and
Girvan-Newman rules), so any pair, weight, family line or k that
differs is a fault.  ``PERF.md`` gives the readings each limit was set
from.
"""

from __future__ import annotations

import collections
import filecmp
import json
import os

import numpy as np

LIMITS = {
    "k_gap": 0,
    "net_pairs_differing": 0,
    "net_weights_differing": 0,
    "clus_lines_differing": 0,
    "jobs_unlike_judged": 0,
}


def read_net(path: str):
    """(a, b, weight as float64) of a ``.net``: ``a<TAB>b<TAB>weight``
    lines."""
    with open(path, "rb") as fh:
        toks = fh.read().split()
    if len(toks) % 3:
        raise ValueError(f"{path}: not three fields a line")
    arr = np.array(toks).reshape(-1, 3)
    if not len(arr):
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0),)
    return (arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64),
            arr[:, 2].astype(np.float64))


def read_lines(path: str):
    with open(path) as fh:
        return fh.read().split("\n")[:-1]


def compare(ref, net_path: str, clus_path: str, stats_path: str) -> dict:
    """The numbers :data:`LIMITS` bounds (but ``jobs_unlike_judged``) for
    one job's files against the reference result ``ref``; a file that is
    missing or unreadable counts every line of the reference as
    differing."""
    out = {}
    try:
        with open(stats_path) as fh:
            k = json.load(fh)["stats"]["k"]
        out["k_gap"] = abs(int(k) - ref.k)
    except (OSError, ValueError, KeyError, TypeError):
        out["k_gap"] = max(ref.k, 1)
    try:
        a, b, w = read_net(net_path)
    except (OSError, ValueError):
        out["net_pairs_differing"] = len(ref.a)
        out["net_weights_differing"] = 0
    else:
        n = int(max(a.max(initial=0), b.max(initial=0),
                    ref.a.max(initial=0), ref.b.max(initial=0))) + 1
        key = a * n + b
        ukey, first = np.unique(key, return_index=True)
        rkey = ref.a * n + ref.b
        common, pi, ri = np.intersect1d(ukey, rkey, assume_unique=True,
                                        return_indices=True)
        out["net_pairs_differing"] = int(
            (len(key) - len(ukey)) + (len(ukey) - len(common))
            + (len(rkey) - len(common)))
        out["net_weights_differing"] = int(np.count_nonzero(
            w[first[pi]] != ref.w[ri].astype(np.float64)))
    try:
        lines = read_lines(clus_path)
    except OSError:
        lines = []
    got = collections.Counter(lines)
    want = collections.Counter(ref.clus_lines)
    out["clus_lines_differing"] = int(sum(((got - want) + (want - got))
                                          .values()))
    return out


def same_files(a: str, b: str) -> bool:
    return (os.path.exists(a) and os.path.exists(b)
            and filecmp.cmp(a, b, shallow=False))
