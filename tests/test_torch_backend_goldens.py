"""The JAX package's backend names through the port's entry points, on the
CPU: ``.net``/``.clus`` byte-identical to tests/golden/ (which every JAX
backend reproduces, tests/test_golden.py) for ``xla`` (device BBH and the
cells path), ``dense``, ``pallas`` and ``auto``, and ``cli run`` with
them; and ``reference``, the host-only transcription twin."""

import filecmp
import os

import pytest

from pandelos_tpu_torch.config import PipelineConfig, resolve_backend
from pandelos_tpu_torch.pipeline import run_pipeline

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")

CASES = [
    ("toy", os.path.join(HERE, "data", "toy.faa")),
    ("synth_small", os.path.join(GOLDEN, "synth_small.faa")),
    ("synth_edge", os.path.join(GOLDEN, "synth_edge.faa")),
    ("synth_real", os.path.join(GOLDEN, "synth_real.faa")),
]
BACKENDS = {
    "xla": dict(backend="xla"),
    "xla_cells": dict(backend="xla", device_bbh=False),
    "dense": dict(backend="dense"),
    "pallas": dict(backend="pallas"),
    "auto": dict(backend="auto"),
}


def _same_as_golden(prefix, name):
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, name + suffix),
                           shallow=False), suffix


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("name,faa", CASES, ids=[c[0] for c in CASES])
def test_backend_reproduces_golden(tmp_path, name, faa, backend):
    prefix = str(tmp_path / name)
    res = run_pipeline(faa, prefix, PipelineConfig(
        row_block=16, col_block=128, candidate_cap=64, device="cpu",
        **BACKENDS[backend]))
    _same_as_golden(prefix, name)
    net = res.stats["network"]
    if resolve_backend(BACKENDS[backend]["backend"]) == "cuda":
        assert net["join_kernel"] == "lane2"
    elif backend in ("xla", "auto"):
        assert net["device_bbh"] and net["join_kernel"] is None
    else:  # the cells path: host BBH
        assert "device_bbh" not in net


def test_resolve_backend():
    assert [resolve_backend(b) for b in
            ("auto", "pallas", "xla", "dense", "cuda", "oracle")] == [
        "xla", "cuda", "xla", "dense", "cuda", "oracle"]


@pytest.mark.parametrize("backend", ["auto", "dense"])
def test_cli_run_backends(tmp_path, backend):
    from pandelos_tpu_torch.cli import main

    prefix = str(tmp_path / "s")
    assert main(["run", CASES[1][1], prefix, "--device", "cpu",
                 "--backend", backend, "--row-block", "16", "--col-block",
                 "128", "--level-cap", "2"]) == 0
    _same_as_golden(prefix, "synth_small")


def test_cli_reference_backend_is_not_ported(tmp_path, capsys):
    """The reference backend, which earlier slices did not port, now
    runs: ``cli run --backend reference`` and ``run_pipeline`` write the
    golden output."""
    from pandelos_tpu_torch.cli import main

    for name, faa in CASES[:2]:
        prefix = str(tmp_path / name)
        assert main(["run", faa, prefix, "--device", "cpu",
                     "--backend", "reference"]) == 0
        assert '"n_families"' in capsys.readouterr().out
        _same_as_golden(prefix, name)
        res = run_pipeline(faa, prefix + "_api",
                           PipelineConfig(backend="reference", device="cpu"))
        _same_as_golden(prefix + "_api", name)
        assert "device_bbh" not in res.stats["network"]


@pytest.mark.parametrize("backend", ["xla", "dense", "auto"])
def test_backends_default_to_the_card(backend, monkeypatch):
    """Like the engine, the kernel-free backends run on the card unless
    the caller asks for the CPU, and raise where there is none."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pipeline(CASES[0][1], None, PipelineConfig(
            backend=backend, row_block=16, col_block=128))
