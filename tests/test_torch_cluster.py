"""The port's clustering split (``pandelos_tpu_torch/cluster.py``): the
one native call over every colliding component (``pt_gn_families``)
against the Python-driven pool of ``pt_gn_split`` calls and against
networkx's ``girvan_newman`` (``_split_until_max_k``); the native replay
of CPython's set order against ``list(set(...))``; the fallback when the
replay's self-check fails; and the probe that compares the two paths'
removal sequences."""

import json
import os

import networkx as nx
import numpy as np
import pytest

from pandelos_tpu_torch import cluster, tracing
from pandelos_tpu_torch.io.faa import read_faa
from pandelos_tpu_torch.io.net import read_net
from pandelos_tpu_torch.native import loader

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

pytestmark = pytest.mark.skipif(not loader.native_available(),
                                reason="native core unavailable")


def _inserted(keys):
    s = set()
    for k in keys:
        s.add(k)
    return list(s)


# sizes about every growth of a set's table: 5, 19 and 77 keys fill 8, 32
# and 128 slots
@pytest.mark.parametrize("size", [1, 2, 4, 5, 6, 18, 19, 20, 33, 64, 76,
                                  77, 78, 150, 231, 299, 300])
def test_pyset_replay_matches_cpython(size):
    rng = np.random.default_rng(size)
    for _ in range(25):
        keys = rng.choice(10**6, size=size, replace=False).tolist()
        assert loader.native_pyset_order(keys).tolist() == \
            list(set(keys)) == _inserted(keys)
    for step in (8, 32, 128, 512):  # keys that share their low bits
        keys = (np.arange(1, size + 1) * step).tolist()
        assert loader.native_pyset_order(keys).tolist() == _inserted(keys)


@pytest.mark.parametrize("seed", range(6))
def test_pyset_replay_matches_bfs_sets(seed):
    """The BFS set of networkx's connected_components, filled in visit
    order (``_plain_bfs_set``), and a set refilled in its order."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        n = int(rng.integers(1, 301))
        ids = rng.choice(10**6, size=n, replace=False).tolist()
        g = nx.gnp_random_graph(n, float(rng.uniform(0.01, 0.2)),
                                seed=int(rng.integers(1 << 30)))
        adj = {ids[u]: [ids[v] for v in g[u]] for u in g}
        src = ids[int(rng.integers(n))]
        visit = [src]
        for v in visit:
            visit.extend(w for w in adj[v] if w not in visit)
        coco = cluster._plain_bfs_set(src, adj)
        assert loader.native_pyset_order(visit).tolist() == list(coco)
        refilled = _inserted(coco)
        assert loader.native_pyset_order(list(coco)).tolist() == refilled


def test_pyset_self_check_passes():
    assert loader.pyset_order_ok()


def _golden(name):
    ds = read_faa(os.path.join(GOLDEN, name + ".faa"))
    return (read_net(os.path.join(GOLDEN, name + ".net")),
            np.asarray(ds.seq_genome), ds.n_sequences)


def _paralog_graph(seed):
    """A random graph over 2-3 genomes: dense enough that collisions
    recurse; every fourth with a self-loop line, which places its node
    early in netclu's order."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 40))
    n_seq = n + int(rng.integers(0, 5))  # genes in no edge: singletons
    genome = rng.integers(0, int(rng.integers(2, 4)), size=n_seq)
    g = nx.gnp_random_graph(n, float(rng.uniform(0.12, 0.4)),
                            seed=int(rng.integers(1 << 30)))
    edges = [(u, v, 0.5) for u, v in g.edges()]
    rng.shuffle(edges)
    if seed % 4 == 0 and edges:
        s = int(rng.integers(n))
        edges.insert(int(rng.integers(len(edges))), (s, s, 1.0))
    return edges, genome.astype(np.int64), n_seq


def _near_cliques(seed):
    """Cliques of paralog-free genes bridged symmetrically, plus
    isolated pairs that make the component small against the graph
    (the set-order view): betweenness ties everywhere, settled by the
    first maximum."""
    rng = np.random.default_rng(seed)
    size, n_cliques = int(rng.integers(3, 7)), int(rng.integers(2, 5))
    edges, genome = [], []
    for c in range(n_cliques):
        base = c * size
        genome.extend(range(size))
        edges += [(base + i, base + j, 1.0) for i in range(size)
                  for j in range(i + 1, size)]
        if c:  # two bridges, each a mirror of the other
            edges += [(base - size, base, 1.0), (base - 1, base + size - 1,
                                                 1.0)]
    n = n_cliques * size
    for i in range(int(rng.integers(0, 3 * n))):
        edges.append((n + 2 * i, n + 2 * i + 1, 1.0))
        genome += [0, 1]
    perm = rng.permutation(len(genome))  # ids no longer follow the order
    edges = [(int(perm[a]), int(perm[b]), w) for a, b, w in edges]
    rng.shuffle(edges)
    return edges, np.asarray(genome, np.int64)[np.argsort(perm)], len(genome)


def _strided(graph):
    """``graph`` with gene i renamed 1024*i + 3: ids that share their low
    bits collide in a set's table, so the order a set was filled in
    shows in its iteration order, and the graph's unnamed genes make
    every component small against it (the set-order view)."""
    edges, genome, n = graph
    wide = np.zeros(1024 * n + 3, np.int64)
    wide[1024 * np.arange(n) + 3] = genome
    return [(1024 * a + 3, 1024 * b + 3, w) for a, b, w in edges], wide, \
        len(wide)


CASES = ([("golden", name) for name in ("synth_real", "synth_edge",
                                        "synth_small")]
         + [("paralogs", s) for s in range(8)]
         + [("near_cliques", s) for s in range(4)]
         + [("paralogs_strided", s) for s in range(8, 12)]
         + [("near_cliques_strided", s) for s in range(4, 8)])


def _case(kind, arg):
    if kind == "golden":
        return _golden(arg)
    make = _paralog_graph if kind.startswith("paralogs") else _near_cliques
    return _strided(make(arg)) if kind.endswith("strided") else make(arg)


def _clustered(edges, genome, n):
    with tracing.job() as job:
        res = cluster.cluster_network(edges, genome, n)
    counters = {s["name"]: s["counters"] for s in job.records()}
    return res.families, counters


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("kind,arg", CASES,
                         ids=[f"{k}-{a}" for k, a in CASES])
def test_one_call_families_match_pool_and_networkx(monkeypatch, kind, arg,
                                                   threads):
    edges, genome, n = _case(kind, arg)
    monkeypatch.setattr(cluster.os, "cpu_count", lambda: threads)
    fams, counters = _clustered(edges, genome, n)
    colliding = counters["cluster.components"]["colliding"]
    split = counters["cluster.split"]
    assert split["native_components"] == colliding
    assert split["threads"] == (min(colliding, threads) if colliding else 0)
    assert split["split_calls"] >= colliding

    monkeypatch.setattr(loader, "pyset_order_ok", lambda: False)
    pool_fams, pool_counters = _clustered(edges, genome, n)
    assert pool_fams == fams
    assert pool_counters["cluster.split"]["native_components"] == 0
    assert pool_counters["cluster.split"]["split_calls"] == \
        split["split_calls"]

    monkeypatch.setattr(cluster, "native_available", lambda: False)
    nx_fams, _ = _clustered(edges, genome, n)
    assert sorted(nx_fams) == sorted(fams)


def test_one_call_counts_repeated_pairs_as_the_pool_does(monkeypatch):
    """A .net line repeated, or its reverse, adds a same-genome edge
    twice to the collision count, as ``_max_collision_arrays`` counts."""
    rng = np.random.default_rng(5)
    for seed in range(6):
        edges, genome, n = _paralog_graph(seed)
        edges = edges + [(b, a, w) for a, b, w in
                         (edges[i] for i in rng.choice(len(edges), 4))]
        fams, counters = _clustered(edges, genome, n)
        assert counters["cluster.split"]["native_components"] == \
            counters["cluster.components"]["colliding"]
        with monkeypatch.context() as m:
            m.setattr(loader, "pyset_order_ok", lambda: False)
            assert _clustered(edges, genome, n)[0] == fams


def test_failed_self_check_runs_the_pool(monkeypatch):
    """A replay that disagrees with CPython (here, reversed) fails the
    self-check; the Python-driven pool then splits every component and
    the families stay the same."""
    edges, genome, n = _golden("synth_real")
    want, counters = _clustered(edges, genome, n)
    assert counters["cluster.split"]["native_components"] > 0
    replay = loader.native_pyset_order
    monkeypatch.setattr(loader, "_pyset_ok", None)
    monkeypatch.setattr(loader, "native_pyset_order",
                        lambda keys: replay(keys)[::-1])
    assert not loader.pyset_order_ok()
    before = loader.CALLS["gn_families"]
    got, counters = _clustered(edges, genome, n)
    assert got == want
    assert loader.CALLS["gn_families"] == before
    split = counters["cluster.split"]
    assert split["native_components"] == 0
    assert split["split_calls"] >= counters["cluster.components"]["colliding"]


def test_gn_split_reports_its_removals():
    """``pt_gn_split``'s removal sequence, as the probe reads it: each
    removal is an edge of the level, none twice, and removing them
    leaves the components the labels give."""
    g = nx.barbell_graph(5, 2)
    eu, ev = (np.asarray(x, np.int32) for x in zip(*g.edges()))
    removed = []
    labels = loader.native_gn_split(g.number_of_nodes(), eu, ev, removed)
    assert removed and len(set(removed)) == len(removed)
    g.remove_edges_from((int(eu[e]), int(ev[e])) for e in removed)
    comps = sorted(sorted(c) for c in nx.connected_components(g))
    by_label = {}
    for node, lab in enumerate(labels.tolist()):
        by_label.setdefault(lab, []).append(node)
    assert sorted(by_label.values()) == comps
    assert np.array_equal(
        loader.native_gn_split(g.number_of_nodes(), eu, ev), labels)


def test_gn_split_self_loop_removal_is_no_split():
    """Removing a self-loop never splits: with every betweenness 0 the
    level removes the loops one by one, first max first, until none is
    left, even where a loop was its node's only edge."""
    eu = np.array([0, 1, 1], np.int32)
    removed = []
    labels = loader.native_gn_split(2, eu, eu.copy(), removed)
    assert removed == [0, 1, 2]
    assert labels.tolist() == [0, 1]


def test_probe_matches_removal_sequences(tmp_path, capsys):
    from pandelos_tpu_torch import probe_cluster

    rc = probe_cluster.main([
        "--net", os.path.join(GOLDEN, "synth_real.net"),
        "--faa", os.path.join(GOLDEN, "synth_real.faa"),
        "--repeats", "1", "--out", str(tmp_path), "--tag", "t"])
    assert rc == 0
    with open(tmp_path / "cluster_t.json") as fh:
        out = json.load(fh)
    parity = out["parity"]
    assert parity["families_equal"] and parity["all_removals_matched"]
    assert parity["levels"] == parity["levels_matched"] > 0
    ways = [r["way"] for r in out["runs"]]
    assert ways == ["native", "pool"] * 2
    assert all(r["native_components"] == 0 for r in out["runs"]
               if r["way"] == "pool")
