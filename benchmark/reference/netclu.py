"""Gene families from the BBH network: ``netclu_ng.py``'s declustering as
it runs on networkx 3.x, without networkx.

A frozen copy of the clustering transcription in
``pandelos_tpu_torch/reference.py`` (which the program's tests hold
against networkx 3.6.1), with two changes for speed that keep every
result: the Brandes pass runs over lists indexed by node and edge number
instead of dicts keyed by nodes and edge tuples, with the same
floating-point operations in the same order; and the components that
need Girvan-Newman splits, which are independent, are split in worker
processes (one Python Brandes pass over a 65-node component takes about
40 ms, and mycoplasma64 needs about 7,500 of them).

netclu_ng.py reaches these parts of networkx, transcribed here with the
same insertion histories so that every dict and set iterates in the
same order:

- nx.Graph: node -> {neighbour: None} in insertion order;
- G.subgraph(nodes): a view over the ROOT graph whose node filter is
  ``set(nodes present)``; it iterates that set when it holds fewer than
  half the root's nodes, else the root's nodes in order, filtered;
- Graph.copy(): rebuilt by an adjacency walk, which reorders adjacency;
- connected_components: _plain_bfs in ``for v in G`` order;
- edge_betweenness_centrality: Brandes with BFS, unweighted, normalised
  by 1/(n(n-1)); max() of it keeps the first of equal values in
  ``G.edges()`` order.
"""

from __future__ import annotations

import multiprocessing
import os
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List


class Graph:
    """nx.Graph's storage: ``adj[u]`` is u's neighbour dict."""

    def __init__(self, size=None):
        self.adj: Dict[int, Dict[int, None]] = {}
        # nodes of the whole graph, where this holds one component of it
        self.size = size

    def __len__(self) -> int:
        return len(self.adj) if self.size is None else self.size

    def add_node(self, n) -> None:
        if n not in self.adj:
            self.adj[n] = {}

    def add_edge(self, u, v) -> None:
        self.add_node(u)
        self.add_node(v)
        self.adj[u][v] = None
        self.adj[v][u] = None

    def remove_edge(self, u, v) -> None:
        del self.adj[u][v]
        if u != v:
            del self.adj[v][u]

    def edges(self):
        # EdgeView.__iter__: each edge once, at its first endpoint
        seen = {}
        for n, nbrs in self.adj.items():
            for nbr in nbrs:
                if nbr not in seen:
                    yield (n, nbr)
            seen[n] = 1


class _View:
    """nx.subgraph_view(root, filter_node=show_nodes(nodes))."""

    def __init__(self, root: Graph, nodes: set):
        self.root = root
        self.nodes = nodes

    def __contains__(self, n) -> bool:
        return n in self.root.adj and n in self.nodes

    def order(self) -> List[int]:
        if 2 * len(self.nodes) < len(self.root):
            return [n for n in self.nodes if n in self.root.adj]
        return [n for n in self.root.adj if n in self.nodes]

    def neighbours(self, u) -> List[int]:
        return [v for v in self.root.adj[u] if v in self.nodes]

    def copy(self) -> Graph:
        g = Graph()
        for n in self.order():
            g.add_node(n)
        for u in self.order():
            for v in self.neighbours(u):
                g.add_edge(u, v)
        return g


def _subgraph(g, nodes) -> _View:
    if isinstance(g, _View):
        return _View(g.root, set(n for n in nodes if n in g))
    return _View(g, set(n for n in nodes if n in g.adj))


def _plain_bfs(g: Graph, n: int, source) -> set:
    adj = g.adj
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def connected_components(g: Graph):
    seen = set()
    n = len(g.adj)
    for v in g.adj:
        if v not in seen:
            c = _plain_bfs(g, n - len(seen), v)
            seen.update(c)
            yield c


def edge_betweenness(g: Graph):
    """``nx.edge_betweenness_centrality(g)`` (unweighted, normalised) as
    (edges in ``g.edges()`` order, values).

    networkx's Brandes over dicts keyed by nodes and edge tuples, on
    lists indexed by node place and edge number instead: per source s
    in node order a BFS (S: the visit order, P: predecessors, sigma: path
    counts), then S popped: for each w, ``coeff = (1 + delta[w]) /
    sigma[w]`` and, for each v in P[w], ``c = sigma[v] * coeff`` added to
    the edge (v, w) and to ``delta[v]``.  The same operations in the same
    order give the same values bit for bit; then each is multiplied by
    1/(n(n-1))."""
    nodes = list(g.adj)
    n = len(nodes)
    index = {u: i for i, u in enumerate(nodes)}
    edges = list(g.edges())
    eid = {}
    for e, (u, v) in enumerate(edges):
        eid[(u, v)] = e
        eid[(v, u)] = e
    nbrs = [[(index[v], eid[(u, v)]) for v in g.adj[u]] for u in nodes]
    bet = [0.0] * len(edges)
    for s in range(n):
        sigma = [0.0] * n
        dist = [-1] * n
        preds = [[] for _ in range(n)]
        sigma[s] = 1.0
        dist[s] = 0
        order = []
        q = deque([s])
        while q:
            v = q.popleft()
            order.append(v)
            dv = dist[v]
            sv = sigma[v]
            for w, e in nbrs[v]:
                if dist[w] < 0:
                    q.append(w)
                    dist[w] = dv + 1
                if dist[w] == dv + 1:
                    sigma[w] += sv
                    preds[w].append((v, e))
        delta = [0] * n
        for w in reversed(order):
            coeff = (1 + delta[w]) / sigma[w]
            for v, e in preds[w]:
                c = sigma[v] * coeff
                bet[e] += c
                delta[v] += c
    if n >= 2:
        scale = 1 / (n * (n - 1))
        bet = [b * scale for b in bet]
    return edges, bet


def _without_most_central_edges(g: Graph):
    original_num_components = sum(1 for _ in connected_components(g))
    num_new_components = original_num_components
    while num_new_components <= original_num_components:
        edges, bet = edge_betweenness(g)
        # max() keeps the first of equal values
        g.remove_edge(*edges[bet.index(max(bet))])
        new_components = tuple(connected_components(g))
        num_new_components = len(new_components)
    return new_components


def _has_edge(root: Graph, u, v) -> bool:
    # views keep every edge of the root between their nodes
    return v in root.adj.get(u, ())


def _max_collision(coco, root: Graph, genome) -> int:  # netclu_ng.py:79-96
    collisions: Dict[int, List[int]] = {}
    for s in coco:
        collisions.setdefault(genome[s], []).append(s)
    max_k = 0
    for v in collisions.values():
        for s1 in v:
            s_k = 0
            for s2 in v:
                if s1 != s2 and not (
                    _has_edge(root, s1, s2) or _has_edge(root, s2, s1)
                ):
                    s_k += 1
            if s_k > max_k:
                max_k = s_k
    return max_k


def _split_until_max_k(coco, g, root: Graph, genome):  # netclu_ng.py:101-115
    snet = _subgraph(g, coco)
    coms = tuple(sorted(c) for c in _without_most_central_edges(snet.copy()))
    rcoms = []
    for com in coms:
        if _max_collision(com, root, genome) > 0:
            rcoms = rcoms + _split_until_max_k(com, snet, root, genome)
        else:
            rcoms.append(com)
    return rcoms


def _split_component(job):
    """The families of one colliding component, in a worker: ``job``
    holds the component's nodes in the root's order with their
    adjacency, the node its BFS started from, the count of nodes the
    BFS was told remained, the root's node count and the genomes.  The
    BFS is run again so that the component's set has the insertion
    history, and so the iteration order, it has in the whole graph."""
    order, adjs, source, remaining, size, genome = job
    root = Graph(size)
    for u, a in zip(order, adjs):
        root.adj[u] = dict.fromkeys(a)
    coco = _plain_bfs(root, remaining, source)
    return _split_until_max_k(coco, root, root, genome)


def cluster(edges, seq_genome, n_sequences: int, workers=None):
    """netclu_ng.py:41-175 over the edge list ``edges`` ((a, b) pairs in
    ``.net`` order): (families as sorted member ids, singletons).
    Colliding components are split in ``workers`` processes (default:
    the CPUs this process may use, at most 8), forked, and ended before
    it returns.  Forked workers unlink the pool's semaphores as soon as
    they are made, so nothing is left in ``/dev/shm``; they run plain
    Python only, never the card."""
    seq_genome = list(seq_genome)

    pnet = Graph()
    inodes = set()
    for a, b in edges:
        a, b = int(a), int(b)
        if a not in inodes:
            inodes.add(a)
            pnet.add_node(a)
        if (b not in inodes) and (a != b):
            inodes.add(b)
            pnet.add_node(b)
        if a != b:
            pnet.add_edge(a, b)
            pnet.add_edge(b, a)

    families: List[List[int]] = []
    jobs = []
    seen = 0
    for v in pnet.adj:  # connected_components, keeping each BFS's start
        if v in inodes:
            remaining = len(pnet.adj) - seen
            coco = _plain_bfs(pnet, remaining, v)
            seen += len(coco)
            inodes -= coco
            if _max_collision(coco, pnet, seq_genome) > 0:
                order = [u for u in pnet.adj if u in coco]
                jobs.append((order, [list(pnet.adj[u]) for u in order], v,
                             remaining, len(pnet.adj),
                             {u: seq_genome[u] for u in order}))
            else:
                families.append(sorted(coco))
    if workers is None:
        workers = min(8, len(os.sched_getaffinity(0)))
    jobs.sort(key=lambda j: -len(j[0]))  # the largest first
    if jobs and workers > 1:
        ctx = multiprocessing.get_context("fork")
        with ProcessPoolExecutor(min(workers, len(jobs)),
                                 mp_context=ctx) as pool:
            split = list(pool.map(_split_component, jobs))
    else:
        split = [_split_component(j) for j in jobs]
    for coms in split:
        families.extend(sorted(int(x) for x in com) for com in coms)
    placed = set()
    for fam in families:
        placed.update(fam)
    singletons = [i for i in range(n_sequences) if i not in placed]
    return families, singletons
