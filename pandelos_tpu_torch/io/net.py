"""``.net`` intermediate format: one undirected edge per line.

Contract: ``seqIdx \t seqIdx \t score`` (writer ``PangeneNet.java:167-174``
with ``key <= node`` dedup; readers ``netclu_ng.py:43-56`` and
``benchmark/test-framework/src/verify.rs:48-86``).

The reference writes scores as Java ``Double.toString`` of the f32 score
widened to double; Python ``repr(float(np.float32(x)))`` produces the same
shortest-round-trip decimal for the same double in the value range of
Jaccard scores (0, 1].
"""

from __future__ import annotations

import os
from decimal import Decimal
from typing import List

import numpy as np

from pandelos_tpu_torch.native.loader import (
    native_available,
    native_write_net,
)


class EdgeList:
    """Array-backed undirected edge sequence.

    Iterates as (src, dst, score) tuples for drop-in compatibility with the
    tuple-list representation, but producers/consumers on the hot path
    (network build, clustering, .net writer) use the ``a/b/w`` arrays
    directly — at 1M+ edges the tuple materialisation alone costs ~1s."""

    __slots__ = ("a", "b", "w")

    def __init__(self, a, b, w):
        self.a = np.asarray(a, dtype=np.int64)
        self.b = np.asarray(b, dtype=np.int64)
        self.w = np.asarray(w, dtype=np.float64)

    @staticmethod
    def from_any(edges) -> "EdgeList":
        if isinstance(edges, EdgeList):
            return edges
        if len(edges) == 0:
            return EdgeList(
                np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64),
            )
        arr = np.asarray(edges, dtype=np.float64)
        return EdgeList(
            arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64), arr[:, 2]
        )

    def __len__(self) -> int:
        return int(self.a.shape[0])

    def __iter__(self):
        return zip(self.a.tolist(), self.b.tolist(), self.w.tolist())

    def __getitem__(self, i):
        if isinstance(i, slice):
            return EdgeList(self.a[i], self.b[i], self.w[i])
        return (int(self.a[i]), int(self.b[i]), float(self.w[i]))

    def __eq__(self, other):
        if isinstance(other, EdgeList):
            return (
                np.array_equal(self.a, other.a)
                and np.array_equal(self.b, other.b)
                and np.array_equal(self.w, other.w)
            )
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented


def java_double_str(v: float) -> str:
    """Java ``Double.toString`` rendering of a double.

    Python ``repr`` and Java both print the shortest decimal that
    round-trips (for the f32-derived doubles scores are, the digit strings
    agree), but the NOTATION switch differs: Java uses scientific form
    outside [1e-3, 1e7) with a bare exponent (``4.8828125E-4``), Python
    outside [1e-4, 1e16) with a padded one (``4.8828125e-05``).  Scores
    below 1e-3 occur for long-gene pairs (score >= 1/union and union can
    exceed 1000, library.cpp:496), so byte parity with PangeneNet.java:171
    needs the Java rules."""
    v = float(v)
    if v != v or v in (float("inf"), float("-inf")):
        return {float("inf"): "Infinity", float("-inf"): "-Infinity"}.get(
            v, "NaN"
        )
    if v == 0.0:
        return "-0.0" if str(v)[0] == "-" else "0.0"
    a = abs(v)
    if 1e-3 <= a < 1e7:
        s = repr(v)
        if "e" not in s:  # repr stays plain across this whole range
            return s
    sign, digits, exp = Decimal(repr(v)).as_tuple()
    e10 = exp + len(digits) - 1
    ds = "".join(map(str, digits)).rstrip("0") or "0"
    mant = ds[0] + "." + (ds[1:] or "0")
    return ("-" if sign else "") + f"{mant}E{e10}"


def canonical_edges(edges):
    """``(a, b, w32, sorted_input)``: the edges with src <= dst, sorted by
    (src, dst), the LAST score of a duplicate pair kept (the dict overwrite
    in PangeneNet's adjacency), scores narrowed to f32.  Where the
    canonical keys ``(src << 32) | dst`` are strictly ascending already,
    as the device path's ``host.edges`` builds them, no sort runs:
    ``sorted_input`` says so."""
    el = EdgeList.from_any(edges)
    a = np.minimum(el.a, el.b)
    b = np.maximum(el.a, el.b)
    w32 = el.w.astype(np.float32)
    key = (a << np.int64(32)) | b
    if np.all(key[1:] > key[:-1]):
        return a, b, w32, True
    # last occurrence wins: unique-first over the reversed stream
    _, first_rev = np.unique(key[::-1], return_index=True)
    sel = len(key) - 1 - first_rev  # ascending (a, b) order
    return a[sel], b[sel], w32[sel], False


def write_net(path: str, edges) -> dict:
    """Write edges as (src, dst, score) with src <= dst, sorted.

    ``edges`` is an EdgeList or iterable of (int, int, float-like).  Scores
    are widened from f32 to double before printing, matching the reference
    writer; on duplicate (src, dst) the LAST score wins (the dict overwrite
    in PangeneNet's adjacency).  The native library formats the lines on
    the host's cores (``native_write_net``); without it
    (``PANDELOS_NATIVE=0``) :func:`write_net_plain` writes the same bytes.
    Returns the ``net_write`` span's counters: ``native`` (1 where the
    native call wrote the file), ``sorted_input`` (1 where the input was
    canonical already and no sort ran), ``threads`` and ``bytes``."""
    if not native_available():
        return write_net_plain(path, edges)
    a, b, w32, sorted_input = canonical_edges(edges)
    n_bytes, threads = native_write_net(path, a, b, w32)
    return {"native": 1, "sorted_input": int(sorted_input),
            "threads": threads, "bytes": n_bytes}


def write_net_plain(path: str, edges) -> dict:
    """:func:`write_net`'s Python twin: the same bytes and counters
    (``native`` and ``threads`` 0)."""
    a, b, w32, sorted_input = canonical_edges(edges)
    # java_double_str is pure-Python; scores repeat heavily (small-integer
    # rationals), so format each distinct f32 value once and map back
    uvals, inv = np.unique(w32, return_inverse=True)
    suffix = ["\t" + java_double_str(v) + "\n" for v in uvals.tolist()]
    text = "".join(
        f"{x}\t{y}{suffix[i]}"
        for x, y, i in zip(a.tolist(), b.tolist(), inv.tolist())
    )
    with open(path, "w") as fh:
        fh.write(text)
    return {"native": 0, "sorted_input": int(sorted_input), "threads": 0,
            "bytes": len(text)}


def read_net(path: str) -> EdgeList:
    if os.path.getsize(path) == 0:  # loadtxt warns on empty input
        return EdgeList.from_any([])
    try:
        data = np.loadtxt(path, delimiter="\t", dtype=np.float64, ndmin=2)
    except ValueError:
        data = None
    if data is None:
        edges = []
        with open(path, "r") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                cols = line.split("\t")
                edges.append((int(cols[0]), int(cols[1]), float(cols[2])))
        return EdgeList.from_any(edges)
    if data.size == 0:
        return EdgeList.from_any([])
    return EdgeList(
        data[:, 0].astype(np.int64), data[:, 1].astype(np.int64), data[:, 2]
    )


def canonical_edge_set(edges) -> dict:
    """Canonical (min,max) -> score map, as the Rust verifier's
    ``BTreeSet<Point>`` (verify.rs:48-86)."""
    out = {}
    for a, b, s in edges:
        a, b = int(a), int(b)
        if a > b:
            a, b = b, a
        out[(a, b)] = float(s)
    return out


def diff_nets(edges_a, edges_b, tolerance: float = 0.001) -> dict:
    """Differential check equivalent to ``test-framework check``
    (main.rs:129-168): counts equal / missing / wrong-weight edges."""
    sa = canonical_edge_set(edges_a)
    sb = canonical_edge_set(edges_b)
    equal = 0
    wrong_weight = 0
    for key, w in sa.items():
        if key in sb:
            if abs(w - sb[key]) <= tolerance:
                equal += 1
            else:
                wrong_weight += 1
    missing_in_a = len(sb) - equal - wrong_weight
    missing_in_b = len(sa) - equal - wrong_weight
    return {
        "equal": equal,
        "wrong_weight": wrong_weight,
        "missing_in_first": missing_in_a,
        "missing_in_second": missing_in_b,
        "total_first": len(sa),
        "total_second": len(sb),
        "identical": wrong_weight == 0 and missing_in_a == 0 and missing_in_b == 0,
    }
