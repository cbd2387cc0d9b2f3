"""Build & drive the REFERENCE's own C++ kernel as a truth source.

The harness (``ref_oracle_harness.cpp`` beside this file) #includes the
reference's ``ig/native/library.cpp`` translation unit unmodified and
drives its real entry points (mock JNIEnv for ``preprocessSequences``,
direct call of the internal ``computeScores``).  This gives differential
tests a truth source not authored in this repo: the reference's census,
ranking, radix sort, dedup, posting-range build and scoring kernel all
execute verbatim.  The counterpart of the JAX package's
``native/ref_oracle.py``, with the same names and outputs, over this
package's oracle path.

The reference tree is read from ``PANDELOS_REF_ROOT`` (default: a
``reference/`` directory at the root of the checkout).  Unavailable when
the tree is absent; callers and tests must skip then.  The harness is
built with ``g++`` at first use into ``build/`` next to this file.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
REF_ROOT = os.environ.get("PANDELOS_REF_ROOT",
                          os.path.join(_REPO, "reference"))


def reference_available() -> bool:
    return os.path.exists(
        os.path.join(REF_ROOT, "ig", "native", "library.cpp")
    )


def build_harness(force: bool = False) -> str:
    """Compile the harness against the reference tree; returns the
    binary path (cached under build/)."""
    src = os.path.join(_HERE, "ref_oracle_harness.cpp")
    out_dir = os.path.join(_HERE, "build")
    os.makedirs(out_dir, exist_ok=True)
    binary = os.path.join(out_dir, "ref_oracle")
    if not force and os.path.exists(binary) and (
        os.path.getmtime(binary) >= os.path.getmtime(src)
    ):
        return binary
    lib = os.path.join(REF_ROOT, "ig", "native", "library.cpp")
    native = os.path.join(REF_ROOT, "ig", "native")
    cmd = [
        "g++", "-O2", "-std=c++14",
        f'-DREF_LIBRARY_CPP="{lib}"',
        f"-I{native}",
        f"-I{os.path.join(native, 'jni')}",
        f"-I{os.path.join(native, 'jni', 'linux')}",
        src, "-o", binary,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return binary


def reference_cells_arrays(faa_path: str, k: int):
    """Run the reference kernel; returns numpy arrays (row, col,
    score_bits, perc_bits, tr_perc_bits) over its nonzero score cells
    (both directions present, as the reference emits them).  Array form
    scales to the flagship preset (mycoplasma64: 2M cells)."""
    import tempfile

    binary = build_harness()
    with tempfile.NamedTemporaryFile(suffix=".cells") as tmp:
        subprocess.run(
            [binary, faa_path, str(k), tmp.name],
            check=True, capture_output=True,
        )
        rows, cols, sbl, pbl, tbl = [], [], [], [], []
        with open(tmp.name) as fh:
            for line in fh:
                x, y, sb, pb, tb = line.split()
                rows.append(int(x))
                cols.append(int(y))
                sbl.append(int(sb, 16))
                pbl.append(int(pb, 16))
                tbl.append(int(tb, 16))
        return (
            np.array(rows, np.int32), np.array(cols, np.int32),
            np.array(sbl, np.uint32), np.array(pbl, np.uint32),
            np.array(tbl, np.uint32),
        )


def reference_cells(faa_path: str, k: int) -> dict:
    """Dict view of :func:`reference_cells_arrays`:
    {(x, y): (score_bits, perc_bits, tr_perc_bits)}."""
    row, col, sb, pb, tb = reference_cells_arrays(faa_path, k)
    return {
        (int(x), int(y)): (int(s), int(p), int(t))
        for x, y, s, p, t in zip(row, col, sb, pb, tb)
    }


def reference_finalized_cells(faa_path: str, k: int):
    """The reference kernel's cells as a :class:`FinalizedCells`: the
    input contract of net.build_network, so the BBH/network stage can be
    driven directly from reference-authored scores."""
    from pandelos_tpu_torch.net import FinalizedCells

    row, col, sb, pb, tb = reference_cells_arrays(faa_path, k)
    return FinalizedCells(
        row, col,
        sb.view(np.float32), pb.view(np.float32), tb.view(np.float32),
    )


def our_cells_bits(index) -> dict:
    """The same {(x, y): bit-triple} map from this package's oracle path
    (compute_cells_oracle + finalize_scores f32 arithmetic)."""
    from pandelos_tpu_torch.net import finalize_scores
    from pandelos_tpu_torch.oracle.cells import compute_cells_oracle

    cells = compute_cells_oracle(index)
    fin = finalize_scores(cells, index.kseq_lengths, index.k)
    sb = fin.score.astype(np.float32).view(np.uint32)
    pb = fin.perc.astype(np.float32).view(np.uint32)
    tb = fin.tr_perc.astype(np.float32).view(np.uint32)
    return {
        (int(r), int(c)): (int(s), int(p), int(t))
        for r, c, s, p, t in zip(fin.row, fin.col, sb, pb, tb)
    }
