"""The exact join's work, counted from its inputs and not from any table
the program packs them into, so that the count stays right when the join
is redesigned or replaced (lane, roll, or a join inside the scan).

Inputs: the index's row widths (the (k-mer id, count) entries a gene's
profile holds) and the list of gene pairs that was joined.  Slots of the
list whose genes are past the last gene are padding and count nothing.

- bytes: each input byte read once: every distinct joined row's entries
  (an int32 id and an int32 count each) and the pair list (two int32
  gene numbers a pair), and the three float32 counters (inter, perc, tr)
  of each pair written once;
- operations: the merge of each pair's two rows, w_a + w_b comparisons.
"""

from __future__ import annotations

import numpy as np

ENTRY_BYTES = 8
PAIR_BYTES = 8
OUT_BYTES = 12


def join_work(widths, pi, pj) -> dict:
    """``{"bytes", "ops", "pairs"}`` of joining the pairs (pi, pj) over
    rows of the given widths."""
    widths = np.asarray(widths, dtype=np.int64)
    pi = np.asarray(pi, dtype=np.int64)
    pj = np.asarray(pj, dtype=np.int64)
    n = len(widths)
    real = (pi < n) & (pj < n)
    a, b = pi[real], pj[real]
    rows = np.unique(np.concatenate([a, b]))
    return {
        "bytes": int(ENTRY_BYTES * widths[rows].sum()
                     + (PAIR_BYTES + OUT_BYTES) * len(a)),
        "ops": int((widths[a] + widths[b]).sum()),
        "pairs": int(len(a)),
    }


def from_capture(capture: dict) -> dict:
    """:func:`join_work` of a run's ``capture`` (``run_pipeline``'s): the
    index's row widths and the pair list the join kernel read; None when
    the run joined no pair list (a path without the join kernel)."""
    if "pi" not in capture:
        return None
    index = capture["index"]
    widths = np.diff(np.asarray(index.profile_ptr))
    return join_work(widths, capture["pi"].cpu().numpy(),
                     capture["pj"].cpu().numpy())


def least_seconds(work: dict, peak: dict) -> float:
    """The least time the card could take for ``work``: the larger of its
    bytes at the memory bandwidth and its comparisons at the issue rate
    of ``peak`` (an entry of ``benchmark/peaks.json``)."""
    return max(work["bytes"] / peak["hbm_bytes_per_s"],
               work["ops"] / peak["int_ops_per_s"])
