"""The port's ``reference`` backend (``pandelos_tpu_torch/reference.py``)
against the JAX package's twin: its cells, f32 finalization and
dict-based BBH on the goldens; its networkx-free clustering against the
JAX twin's networkx run on the goldens' networks and on seeded graphs
whose edge betweenness ties decide the Girvan-Newman splits; and whole
``backend="reference"`` runs byte-identical to tests/golden/.  Exact
everywhere: integer counters, f32 bits, bytes."""

import filecmp
import os

import numpy as np
import pytest

from pandelos_tpu import reference as jref
from pandelos_tpu_torch import reference as tref
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.index import build_index
from pandelos_tpu_torch.io.faa import read_faa
from pandelos_tpu_torch.io.net import read_net
from pandelos_tpu_torch.ksel import select_k
from pandelos_tpu_torch.pipeline import run_pipeline

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")
CACHE = os.path.join(HERE, "..", "bench_cache")
CASES = [
    ("toy", os.path.join(HERE, "data", "toy.faa")),
    ("synth_small", os.path.join(GOLDEN, "synth_small.faa")),
    ("synth_edge", os.path.join(GOLDEN, "synth_edge.faa")),
    ("synth_real", os.path.join(GOLDEN, "synth_real.faa")),
]
IDS = [c[0] for c in CASES]


def _same_clusters(edges, seq_genome, n):
    got = tref.cluster_reference(edges, seq_genome, n)
    want = jref.cluster_reference(edges, seq_genome, n)
    assert got.families == want.families
    assert got.singletons == want.singletons
    assert got.component_size_distr == want.component_size_distr
    assert got.family_size_distr == want.family_size_distr
    return got


@pytest.mark.parametrize("name,faa", CASES, ids=IDS)
def test_cells_finalize_network_match_jax(name, faa):
    ds = read_faa(faa)
    k = select_k(ds.sequences)
    cells = tref.compute_cells_reference(ds.sequences, k)
    jcells = jref.compute_cells_reference(ds.sequences, k)
    for f in ("row", "col", "intersection", "perc_cnt", "tr_perc_cnt"):
        a, b = getattr(cells, f), getattr(jcells, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    lens = build_index(ds, k=k).kseq_lengths
    fc = tref.finalize_cells_reference(cells, lens, k)
    jfc = jref.finalize_cells_reference(jcells, lens, k)
    assert len(fc) == len(jfc) > 0
    for x, y in zip(fc, jfc):
        assert x[:2] == y[:2]
        for u, v in zip(x[2:], y[2:]):
            assert type(u) is type(v) is np.float32
            assert u.view(np.int32) == v.view(np.int32)
    net = tref.build_network_reference(fc, ds.seq_genome, ds.n_genomes)
    assert net == jref.build_network_reference(jfc, ds.seq_genome,
                                               ds.n_genomes)


@pytest.mark.parametrize("name", IDS + ["mycoplasma16"])
def test_cluster_reference_matches_networkx_on_goldens(name):
    if name == "mycoplasma16":
        faa = os.path.join(CACHE, "mycoplasma16.faa")
        net = os.path.join(CACHE, "mycoplasma16.net")
    else:
        faa = dict(CASES)[name]
        net = os.path.join(GOLDEN, name + ".net")
    ds = read_faa(faa)
    _same_clusters(read_net(net), ds.seq_genome, ds.n_sequences)


def _structure(rng, kind):
    """(n_nodes, edges) of one tie-heavy graph: a cycle, a complete
    bipartite graph, a grid, or rings of paralog cliques (each clique's
    i-th member joined to the next clique's)."""
    if kind == "cycle":
        n = int(rng.integers(4, 14))
        return n, [(i, (i + 1) % n) for i in range(n)]
    if kind == "bipartite":
        p, q = int(rng.integers(2, 5)), int(rng.integers(2, 5))
        return p + q, [(i, p + j) for i in range(p) for j in range(q)]
    if kind == "grid":
        r, c = int(rng.integers(2, 5)), int(rng.integers(2, 5))
        e = [(i * c + j, i * c + j + 1) for i in range(r) for j in range(c - 1)]
        e += [(i * c + j, (i + 1) * c + j) for i in range(r - 1)
              for j in range(c)]
        return r * c, e
    k, m = int(rng.integers(2, 5)), int(rng.integers(2, 4))
    e = [(c * k + i, c * k + j) for c in range(m) for i in range(k)
         for j in range(i + 1, k)]
    e += [(c * k + i, ((c + 1) % m) * k + i) for c in range(m)
          for i in range(k)]
    return k * m, e


def _tie_graph(seed):
    """A seeded disjoint union of one to four tie-heavy structures over
    relabelled nodes (so that components below half the graph iterate
    their node set, above it the graph's order), edges shuffled, some
    written (b, a), some repeated, a self-loop, and few genomes (so that
    components collide and split); plus nodes with no edge."""
    rng = np.random.default_rng(seed)
    kinds = ("cycle", "bipartite", "grid", "cliques")
    edges, n = [], 0
    for _ in range(int(rng.integers(1, 5))):
        m, e = _structure(rng, kinds[int(rng.integers(0, 4))])
        edges += [(a + n, b + n) for a, b in e]
        n += m
    n_seq = n + 3
    perm = rng.permutation(n_seq)
    edges = [(int(perm[a]), int(perm[b])) for a, b in edges]
    edges += [edges[i] for i in rng.integers(0, len(edges), size=3)]
    edges.append((int(perm[0]), int(perm[0])))
    edges = [edges[i] for i in rng.permutation(len(edges))]
    edges = [(b, a, 0.5) if rng.random() < 0.5 else (a, b, 0.5)
             for a, b in edges]
    genomes = rng.integers(0, max(2, n // 4), size=n_seq)
    return edges, genomes, n_seq


@pytest.mark.parametrize("block", range(4))
def test_cluster_reference_matches_networkx_on_ties(block):
    """60 seeded tie-heavy graphs per block; most of them split."""
    n_split = 0
    for seed in range(60 * block, 60 * (block + 1)):
        edges, genomes, n_seq = _tie_graph(seed)
        got = _same_clusters(edges, genomes, n_seq)
        n_split += len(got.families) > sum(got.component_size_distr.values())
    assert n_split >= 30


def test_cluster_reference_matches_networkx_on_random_graphs():
    """Seeded G(n, p) graphs with few genomes.  Seed 536 is one where the
    float order of Brandes' accumulation (``sigma[v] * ((1 + delta[w]) /
    sigma[w])``, networkx 3.x) decides a tie: the order
    ``sigma[v] / sigma[w] * (1 + delta[w])`` splits it differently."""
    for seed in range(500, 600):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(6, 16))
        p = float(rng.uniform(0.2, 0.6))
        edges = [(i, j, 0.5) for i in range(n) for j in range(i + 1, n)
                 if rng.random() < p]
        _same_clusters(edges, rng.integers(0, max(2, n // 3), size=n), n)


@pytest.mark.parametrize("name,faa", CASES, ids=IDS)
def test_reference_backend_reproduces_golden(tmp_path, name, faa):
    prefix = str(tmp_path / name)
    res = run_pipeline(faa, prefix, PipelineConfig(backend="reference",
                                                   device="cpu"))
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, name + suffix),
                           shallow=False), suffix
    assert set(res.stats["network"]) == {"n_cells", "n_inter_edges",
                                         "n_intra_edges"}


def test_reference_backend_touches_no_device(tmp_path, monkeypatch):
    """Host-only: with device "cuda" (the default) and no card it runs
    all the same."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prefix = str(tmp_path / "s")
    run_pipeline(CASES[1][1], prefix, PipelineConfig(backend="reference"))
    assert filecmp.cmp(prefix + ".clus",
                       os.path.join(GOLDEN, "synth_small.clus"), shallow=False)


def test_reference_module_shares_no_code():
    """The twin imports only the ClusterResult record of the production
    path (the agreement of the two is the whole-run differential check)."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(tref))
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    assert mods == {"__future__", "collections", "typing", "numpy",
                    "pandelos_tpu_torch.oracle.cells",
                    "pandelos_tpu_torch.cluster"}
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             and n.module == "pandelos_tpu_torch.cluster" for a in n.names}
    assert names == {"ClusterResult"}
