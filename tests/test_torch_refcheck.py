"""The port's ``refcheck`` and its reference harness against the JAX
package's, on the CPU, with no reference tree: the missing tree exits 2
with the same message; the oracle side of the comparison
(``our_cells_bits``) is the same map; a stub harness's hex lines read
back into the same arrays, dicts and finalized cells; and the harness
builds with the same ``g++`` arguments, the port's paths in place of
the JAX package's."""

import os
import stat

import numpy as np
import pytest

import pandelos_tpu.native.ref_oracle as jax_ref
import pandelos_tpu_torch.native.ref_oracle as port_ref
from pandelos_tpu.cli import main as jax_main
from pandelos_tpu.index import build_index as jax_build_index
from pandelos_tpu.io.faa import read_faa as jax_read_faa
from pandelos_tpu.ksel import select_k
from pandelos_tpu_torch.cli import main as port_main
from pandelos_tpu_torch.index import build_index
from pandelos_tpu_torch.io.faa import read_faa

HERE = os.path.dirname(__file__)
TOY = os.path.join(HERE, "data", "toy.faa")
SMALL = os.path.join(HERE, "golden", "synth_small.faa")

# what the stub harness writes: "x y score perc tr_perc", f32 bits in hex
STUB_LINES = [
    "0 1 3f000000 3f400000 3f200000",
    "1 0 3f000000 3f200000 3f400000",
    "2 5 3e800000 3f800000 3e99999a",
    "7 3 00000001 7f7fffff 3f7fffff",
]


def test_refcheck_without_the_tree_exits_2(tmp_path, monkeypatch, capsys):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    monkeypatch.setattr(jax_ref, "REF_ROOT", empty)
    monkeypatch.setattr(port_ref, "REF_ROOT", empty)
    assert jax_main(["refcheck", TOY]) == 2
    jax_err = capsys.readouterr()
    assert port_main(["refcheck", TOY, "--k", "4"]) == 2
    port_err = capsys.readouterr()
    assert port_err.err == jax_err.err == (
        "error: reference tree not found (PANDELOS_REF_ROOT)\n")
    assert port_err.out == jax_err.out == ""


@pytest.mark.parametrize("faa", [TOY, SMALL], ids=["toy", "synth_small"])
def test_our_cells_bits_match_jax(faa):
    ds, jds = read_faa(faa), jax_read_faa(faa)
    k = select_k(jds.sequences)
    got = port_ref.our_cells_bits(build_index(ds, k=k))
    want = jax_ref.our_cells_bits(jax_build_index(jds, k=k))
    assert len(got) > 0
    assert got == want


def _stub_harness(tmp_path):
    """An executable that writes STUB_LINES to its third argument, as
    the harness writes its cells."""
    path = tmp_path / "stub_harness"
    path.write_text("#!/bin/sh\ncat > \"$3\" <<'EOF'\n"
                    + "\n".join(STUB_LINES) + "\nEOF\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_reference_readers_match_jax(tmp_path, monkeypatch):
    stub = _stub_harness(tmp_path)
    for mod in (jax_ref, port_ref):
        monkeypatch.setattr(mod, "build_harness", lambda force=False: stub)
    got = port_ref.reference_cells_arrays(TOY, 4)
    want = jax_ref.reference_cells_arrays(TOY, 4)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], [0, 1, 2, 7])
    assert got[2][3] == 1 and got[3][3] == 0x7F7FFFFF

    cells = port_ref.reference_cells(TOY, 4)
    assert cells == jax_ref.reference_cells(TOY, 4)
    assert cells[(2, 5)] == (0x3E800000, 0x3F800000, 0x3E99999A)

    fin = port_ref.reference_finalized_cells(TOY, 4)
    jfin = jax_ref.reference_finalized_cells(TOY, 4)
    for field in ("row", "col", "score", "perc", "tr_perc"):
        g, w = getattr(fin, field), getattr(jfin, field)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint32) if g.dtype ==
                                      np.float32 else g,
                                      w.view(np.uint32) if w.dtype ==
                                      np.float32 else w)
    assert fin.score[0] == np.float32(0.5)


def test_build_harness_runs_the_jax_g_plus_plus_command(tmp_path,
                                                        monkeypatch):
    """With the same reference tree, ``build_harness(force=True)`` runs
    the JAX package's g++ argument list, the port's harness source and
    binary in place of the JAX package's."""
    ref = str(tmp_path / "ref")
    jax_repo = tmp_path / "jax_repo"
    monkeypatch.setattr(jax_ref, "REF_ROOT", ref)
    monkeypatch.setattr(port_ref, "REF_ROOT", ref)
    monkeypatch.setattr(jax_ref, "_REPO", str(jax_repo))
    calls = []

    def fake_run(cmd, **kw):
        calls.append((list(cmd), kw))

    monkeypatch.setattr(jax_ref.subprocess, "run", fake_run)
    monkeypatch.setattr(port_ref.subprocess, "run", fake_run)
    jax_bin = jax_ref.build_harness(force=True)
    port_bin = port_ref.build_harness(force=True)
    (jax_cmd, jax_kw), (port_cmd, port_kw) = calls
    here = os.path.dirname(port_ref.__file__)
    port_src = os.path.join(here, "ref_oracle_harness.cpp")
    assert port_bin == os.path.join(here, "build", "ref_oracle")
    assert os.path.isfile(port_src)
    jax_src = str(jax_repo / "native" / "ref_oracle_harness.cpp")
    assert jax_bin == str(jax_repo / "build" / "ref_oracle")
    swap = {jax_src: port_src, jax_bin: port_bin}
    assert port_cmd == [swap.get(a, a) for a in jax_cmd]
    assert port_cmd[0] == "g++" and port_cmd[-3:] == [
        port_src, "-o", port_bin]
    assert f'-DREF_LIBRARY_CPP="{ref}/ig/native/library.cpp"' in port_cmd
    assert port_kw == jax_kw == {"check": True, "capture_output": True}


def test_port_harness_is_the_jax_one_in_code():
    """The port's copy of the harness differs from the JAX package's
    only in its header comment: every line of code is the same."""
    def code(path):
        with open(path) as fh:
            return [ln for ln in fh.read().splitlines()
                    if not ln.lstrip().startswith("//")]

    here = os.path.dirname(port_ref.__file__)
    root = os.path.dirname(HERE)
    assert code(os.path.join(here, "ref_oracle_harness.cpp")) == code(
        os.path.join(root, "native", "ref_oracle_harness.cpp"))
