"""The plain reference against the committed goldens, its imports, and
the control: the reference in bfloat16 must come out not correct."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import job as reference

from conftest import ROOT

GOLDEN = os.path.join(ROOT, "tests", "golden")
GOLDEN_FAA = {
    "toy": os.path.join(ROOT, "tests", "data", "toy.faa"),
    "synth_small": os.path.join(GOLDEN, "synth_small.faa"),
    "synth_edge": os.path.join(GOLDEN, "synth_edge.faa"),
}


def _read(path):
    with open(path) as fh:
        return fh.read()


def _clus_text(ref):
    return "".join(line + "\n" for line in ref.clus_lines)


@pytest.mark.parametrize("name", sorted(GOLDEN_FAA))
def test_reproduces_the_goldens(name):
    ref = reference.run(GOLDEN_FAA[name], "cpu", workers=1)
    assert reference.net_text(ref) == _read(
        os.path.join(GOLDEN, f"{name}.net"))
    assert _clus_text(ref) == _read(os.path.join(GOLDEN, f"{name}.clus"))


def test_parallel_split_matches_one_process():
    path = os.path.join(GOLDEN, "synth_real.faa")
    one = reference.run(path, "cpu", workers=1)
    two = reference.run(path, "cpu", workers=2)
    assert one.clus_lines == two.clus_lines
    assert reference.net_text(one) == _read(
        os.path.join(GOLDEN, "synth_real.net"))
    assert _clus_text(one) == _read(os.path.join(GOLDEN, "synth_real.clus"))


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(out.stdout.split())


def test_harness_and_reference_import_no_jax():
    mods = _modules_after(
        "import benchmark.run, benchmark.harness, benchmark.trace\n"
        "import benchmark.reference.job, benchmark.counts.join\n"
        "from benchmark import harness\n"
        "for m in harness.load_json('BENCHMARK.json')['per_layer']:\n"
        "    harness.load_metric(m['name'])\n"
        "import pandelos_tpu_torch.pipeline\n"
        "import pandelos_tpu_torch.ops.candidate\n"
        "import pandelos_tpu_torch.ops.net_device\n")
    assert not mods & {"jax", "jaxlib", "flax", "pandelos_tpu"}


def test_reference_imports_nothing_of_the_program():
    mods = _modules_after(
        "from benchmark.reference import job\n"
        f"job.run({GOLDEN_FAA['synth_small']!r}, 'cpu', workers=1)\n")
    assert not mods & {"jax", "jaxlib", "flax", "pandelos_tpu",
                       "pandelos_tpu_torch"}


def _write(tmp_path, ref, name):
    net = tmp_path / f"{name}.net"
    net.write_text(reference.net_text(ref))
    clus = tmp_path / f"{name}.clus"
    clus.write_text(_clus_text(ref))
    stats = tmp_path / f"{name}.stats.json"
    stats.write_text('{"stats": {"k": %d}}' % ref.k)
    return str(net), str(clus), str(stats)


def test_reference_judges_itself_correct(tmp_path):
    ref = reference.run(os.path.join(GOLDEN, "synth_real.faa"), "cpu")
    got = check.compare(ref, *_write(tmp_path, ref, "same"))
    assert all(v == 0 for v in got.values()), got


def test_bf16_control_is_not_correct(tmp_path):
    """The control, at a test's size: the reference put in the program's
    place with its divisions and comparisons in bfloat16."""
    path = os.path.join(GOLDEN, "synth_real.faa")
    ref = reference.run(path, "cpu")
    control = reference.run(path, "cpu", precision="bf16")
    got = check.compare(ref, *_write(tmp_path, control, "control"))
    assert any(got[n] > check.LIMITS[n] for n in got), got
    assert got["net_weights_differing"] > 0


@pytest.mark.cuda
def test_reference_on_the_card_matches_mycoplasma16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    base = os.path.join(ROOT, "bench_cache", "mycoplasma16")
    ref = reference.run(base + ".faa", "cuda")
    assert reference.net_text(ref) == _read(base + ".net")
    assert _clus_text(ref) == _read(base + ".clus")
    assert ref.w.dtype == np.float32


def test_betweenness_is_networkx_bit_for_bit():
    """The list-based Brandes pass against networkx's own, values and
    edge order, on random graphs with ties (networkx where installed)."""
    nx = pytest.importorskip("networkx")
    import random

    from benchmark.reference import netclu

    for trial in range(120):
        rng = random.Random(trial)
        n = rng.randint(2, 30)
        p = rng.choice([0.1, 0.3, 0.6, 0.9, 1.0])
        theirs, mine = nx.Graph(), netclu.Graph()
        nodes = list(range(n))
        rng.shuffle(nodes)
        for u in nodes:
            theirs.add_node(u)
            mine.add_node(u)
        pairs = [(u, v) for u in range(n) for v in range(u + 1, n)
                 if rng.random() < p]
        rng.shuffle(pairs)
        for u, v in pairs:
            if rng.random() < 0.5:
                u, v = v, u
            theirs.add_edge(u, v)
            mine.add_edge(u, v)
        want = nx.edge_betweenness_centrality(theirs)
        edges, bet = netclu.edge_betweenness(mine)
        assert edges == list(want)
        assert bet == [want[e] for e in edges]
