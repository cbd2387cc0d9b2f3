"""The exact join's count: bytes and comparisons from the index's row
widths and the joined pair list, whatever table the pairs were packed
into."""

import numpy as np
import torch

from benchmark.counts import join


class _Index:
    def __init__(self, widths):
        self.profile_ptr = np.concatenate([[0], np.cumsum(widths)])


def test_counts_worked_by_hand():
    # four genes of 3, 2, 4 and 1 entries; the last slot is padding (4)
    widths = np.array([3, 2, 4, 1])
    pi = np.array([0, 0, 2, 4])
    pj = np.array([1, 2, 3, 4])
    work = join.join_work(widths, pi, pj)
    # rows 0-3 read once: 10 entries x 8 B; 3 pairs x (8 B in + 12 B out)
    assert work == {"bytes": 10 * 8 + 3 * 20, "ops": 5 + 7 + 5,
                    "pairs": 3}
    # a row joined twice is read once
    twice = join.join_work(widths, np.array([0, 0]), np.array([1, 1]))
    assert twice == {"bytes": 5 * 8 + 2 * 20, "ops": 10, "pairs": 2}


def test_count_ignores_the_table_depth():
    widths = np.array([5, 130, 7, 1, 64, 9])
    pairs = np.array([[0, 1], [1, 4], [2, 5], [4, 0], [5, 3]])
    counts = []
    for depth, cap in ((128, 8), (2176, 64)):
        pad = cap - len(pairs)
        pi = torch.tensor(np.r_[pairs[:, 0], [6] * pad], dtype=torch.int32)
        pj = torch.tensor(np.r_[pairs[:, 1], [6] * pad], dtype=torch.int32)
        capture = {"index": _Index(widths), "pi": pi, "pj": pj,
                   "table": torch.zeros((8, depth), dtype=torch.int32),
                   "dg": torch.full((8,), depth // 32, dtype=torch.int32)}
        counts.append(join.from_capture(capture))
    assert counts[0] == counts[1]
    assert counts[0]["ops"] == (5 + 130) + (130 + 64) + (7 + 9) + (
        64 + 5) + (9 + 1)


def test_no_pair_list_no_count():
    assert join.from_capture({"index": _Index([1, 2])}) is None


def test_least_time_takes_the_larger_bound():
    peak = {"hbm_bytes_per_s": 1e12, "int_ops_per_s": 1e13}
    assert join.least_seconds({"bytes": 2e9, "ops": 1e9}, peak) == 2e-3
    assert join.least_seconds({"bytes": 1e6, "ops": 1e11}, peak) == 1e-2
