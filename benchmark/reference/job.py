"""One reference job: the ``.faa``'s network and ``.clus`` lines.  The
comparison in ``benchmark/check.py`` reads the program's output files
only to judge them."""

from __future__ import annotations

import dataclasses
from decimal import Decimal
from typing import List

import numpy as np

from benchmark.reference import netclu, network


@dataclasses.dataclass
class Result:
    k: int
    a: np.ndarray  # edge endpoints, a < b, sorted by (a, b)
    b: np.ndarray
    w: np.ndarray  # float32 weights
    clus_lines: List[str]


def read_faa(path: str):
    """(sequences, names, genome index a gene) of a ``.faa``: header
    ``genome<TAB>gene<TAB>product`` then the sequence; blank lines are
    skipped; genomes are numbered in order of first appearance."""
    seqs, names, genome, ids = [], [], [], {}
    header = None
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            if header is None:
                cols = line.split("\t")
                if len(cols) < 3:
                    raise ValueError(f"malformed .faa header: {line!r}")
                header = cols
            else:
                genome.append(ids.setdefault(header[0], len(ids)))
                names.append(header[1])
                seqs.append(line)
                header = None
    if header is not None:
        raise ValueError("malformed .faa: a header without its sequence")
    return seqs, names, np.asarray(genome, dtype=np.int64), len(ids)


def clus_lines(families, singletons, names) -> List[str]:
    """The ``.clus`` lines: a family's members (by gene number) joined by
    spaces; a gene in no family as its name and one space; sorted,
    without repeats (the upstream ``sort | uniq``)."""
    lines = {" ".join(names[i] for i in fam) for fam in families}
    lines.update(names[i] + " " for i in singletons)
    return sorted(lines)


def run(faa_path: str, device, precision: str = "f32",
        workers=None) -> Result:
    """The reference's network and families of the ``.faa``;
    ``precision`` "bf16" is the control (see ``network.finalize``)."""
    seqs, names, genome, n_genomes = read_faa(faa_path)
    k = network.select_k(seqs)
    *counts, n_windows = network.pair_counts(seqs, k, device)
    rows, cols, score = network.finalize(*counts, n_windows, k, precision)
    a, b, w = network.bbh_network(rows, cols, score, genome, n_genomes)
    families, singletons = netclu.cluster(zip(a.tolist(), b.tolist()),
                                          genome.tolist(), len(seqs),
                                          workers=workers)
    return Result(k, a, b, w, clus_lines(families, singletons, names))


def java_double(v: float) -> str:
    """Java's ``Double.toString`` of a positive float32 weight widened to
    double, as the upstream ``.net`` writer prints it: the shortest
    decimal that reads back the same double (as Python's ``repr``), plain
    in [1e-3, 1e7) and otherwise as ``<digit>.<digits>E<exponent>``."""
    v = float(v)
    if 1e-3 <= v < 1e7:
        return repr(v)
    _, digits, exp = Decimal(repr(v)).as_tuple()
    e10 = exp + len(digits) - 1
    ds = "".join(map(str, digits)).rstrip("0") or "0"
    return f"{ds[0]}.{ds[1:] or '0'}E{e10}"


def net_text(ref: Result) -> str:
    """The ``.net`` file of ``ref``: ``a<TAB>b<TAB>weight`` a line, sorted."""
    return "".join(f"{a}\t{b}\t{java_double(w)}\n" for a, b, w in
                   zip(ref.a.tolist(), ref.b.tolist(), ref.w.tolist()))
