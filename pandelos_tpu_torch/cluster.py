"""Family clustering / "de-clustering": connected components + collision
check + recursive Girvan-Newman splitting.

Semantic twin of ``netclu_ng.py``:
- build an undirected graph from the edge list, skipping self-loops
  (netclu_ng.py:54),
- for every connected component (:149) compute the max paralog collision:
  the max over members of the number of same-genome, non-adjacent other
  members (:79-96),
- components with collisions are split recursively with one level of
  unweighted Girvan-Newman per recursion, communities sorted
  (:101-115, ``sorted(c)`` at :106),
- families print members sorted by sequence id (:121),
- genes absent from every family are singletons (:142-175).

Kept on host: components that need GN splitting are small, and the
reference's output depends on networkx's exact unweighted girvan_newman
behaviour, so we call the same library function.  networkx is imported only on the
branch that runs without the native core: the Girvan-Newman split
normally runs every colliding component's recursion in one native call
(``pt_gn_families``), and a machine without networkx runs the whole
path.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Sequence, Tuple

import numpy as np

from pandelos_tpu_torch import tracing
from pandelos_tpu_torch.native.loader import native_available


@dataclasses.dataclass
class ClusterResult:
    families: List[List[int]]  # member seq-ids, sorted ascending
    singletons: List[int]  # seq-ids never placed in a family
    component_size_distr: dict
    family_size_distr: dict


def _max_collision(nodes, graph, seq_genome) -> int:
    """netclu_ng.py:79-96: max number of same-genome non-adjacent pairs."""
    by_genome = {}
    for s in nodes:
        by_genome.setdefault(seq_genome[s], []).append(s)
    max_k = 0
    for members in by_genome.values():
        for s1 in members:
            s_k = 0
            for s2 in members:
                if s1 != s2 and not graph.has_edge(s1, s2):
                    s_k += 1
            if s_k > max_k:
                max_k = s_k
    return max_k


def _split_until_max_k(nodes, graph, seq_genome) -> List[List[int]]:
    """netclu_ng.py:101-115: one unweighted GN split level per recursion."""
    import networkx as nx

    subgraph = graph.subgraph(nodes)
    gcoms = nx.algorithms.community.centrality.girvan_newman(subgraph)
    coms = tuple(sorted(c) for c in next(gcoms))
    result: List[List[int]] = []
    for com in coms:
        if _max_collision(com, subgraph, seq_genome) > 0:
            result.extend(_split_until_max_k(com, subgraph, seq_genome))
        else:
            result.append(list(com))
    return result


def _max_collision_arrays(members, eu, ev, seq_genome, bool_scratch) -> int:
    """Vectorized _max_collision for a member set against the edge list
    of its (parent) component.  ``bool_scratch`` is an all-False bool
    array over all sequence ids, restored before returning."""
    mset = np.asarray(sorted(members), dtype=np.int64)
    bool_scratch[mset] = True
    sel = bool_scratch[eu] & bool_scratch[ev]
    bool_scratch[mset] = False
    u, v = eu[sel], ev[sel]
    sgm = seq_genome[u] == seq_genome[v]
    su = np.searchsorted(mset, u[sgm])
    sv = np.searchsorted(mset, v[sgm])
    deg_same = np.bincount(su, minlength=len(mset)) + np.bincount(
        sv, minlength=len(mset)
    )
    _, ginv, gcnt = np.unique(
        seq_genome[mset], return_inverse=True, return_counts=True
    )
    coll = gcnt[ginv] - 1 - deg_same
    return int(coll.max(initial=0))


def _plain_bfs_set(source: int, adj: dict) -> set:
    """networkx ``_plain_bfs`` transcribed: returns the visited SET.

    netclu passes the component set from ``connected_components`` straight
    into ``Graph.subgraph`` (netclu_ng.py:103,147), and networkx 3.x
    subgraph views iterate small member sets in the SET's own iteration
    order — so the exact insertion sequence of this set (BFS level order
    over pnet adjacency) is part of the output contract."""
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
    return seen


def _copy_scan_edges_np(vo, dsrc, ddst, pos_scratch):
    """Edges in networkx ``Graph.copy()`` insertion order, as LOCAL
    positions into ``vo`` — fully vectorized.

    ``girvan_newman`` does not run on the subgraph view it is given: it
    runs on ``view.copy().to_undirected()``, which rebuilds adjacency by
    scanning nodes in view order and each node's view-adjacency (pnet
    adjacency filtered to the member set) in edge-insertion order,
    inserting every undirected edge into BOTH endpoints' dicts at its
    first encounter.  ``pt_gn_split`` builds adjacency by per-edge
    append, so feeding it edges in this scan order reproduces the copy's
    adjacency — and therefore Brandes' float accumulation order and the
    ``G.edges()`` first-max tie scan — bit-exactly.  (The second rebuild
    inside ``to_undirected`` is an order no-op: one scan already leaves
    every node's lower-position neighbours sorted by position ahead of
    its higher-position neighbours in view-adjacency order.)

    ``dsrc``/``ddst`` is the component's DIRECTED edge stream in pnet
    adjacency-insertion order (for edge i: (u_i, v_i) then (v_i, u_i)),
    so the subsequence with both endpoints in the member set, stably
    sorted by source position, is exactly the copy scan; ``np.unique``'s
    first-occurrence indices are the seen-set dedup.  ``pos_scratch`` is
    an all--1 int array over all sequence ids, restored before return."""
    pos_scratch[vo] = np.arange(len(vo), dtype=np.int64)
    pu = pos_scratch[dsrc]
    pv = pos_scratch[ddst]
    pos_scratch[vo] = -1
    ok = (pu >= 0) & (pv >= 0)
    pu, pv = pu[ok], pv[ok]
    order = np.argsort(pu, kind="stable")
    pu, pv = pu[order], pv[order]
    key = np.minimum(pu, pv) * np.int64(len(vo)) + np.maximum(pu, pv)
    _, first = np.unique(key, return_index=True)
    sel = np.sort(first)
    return pu[sel].astype(np.int32), pv[sel].astype(np.int32)


def _split_colliding_native(
    bunch, dsrc, ddst, comp_order, n_total, eu, ev, seq_genome,
    pos_scratch, bool_scratch, calls,
) -> "List[List[int]] | None":
    """One netclu ``split_until_max_k`` level (netclu_ng.py:101-115) via
    the C++ Brandes core, mirroring networkx 3.x order semantics exactly:

    - the member set girvan_newman sees is ``show_nodes`` =
      ``set(nbunch_iter(bunch))`` — a fresh CPython set built by inserting
      ``bunch``'s elements in ``bunch``'s own iteration order
      (``Graph.subgraph``; ``bunch`` is the BFS component set at the top
      level and netclu's ``sorted(c)`` list in recursion);
    - the subgraph view iterates nodes in THAT set's iteration order when
      ``2*len(members) < len(pnet)`` (``FilterAtlas.__iter__``'s
      node_ok_shorter branch), else in pnet node-insertion order —
      ``n_total`` is therefore the FULL graph's node count, threaded
      through every recursion depth;
    - the graph Brandes actually runs on is the view's copy, whose edge
      order comes from ``_copy_scan_edges``.

    ``calls`` (a one-item list) counts the native split calls."""
    from pandelos_tpu_torch.native.loader import native_gn_split

    m_set: set = set()
    for x in bunch:
        m_set.add(x)
    if 2 * len(m_set) < n_total:
        view_order = list(m_set)  # CPython set iteration order
    else:
        view_order = [u for u in comp_order if u in m_set]
    vo = np.asarray(view_order, dtype=np.int64)
    leu, lev = _copy_scan_edges_np(vo, dsrc, ddst, pos_scratch)
    calls[0] += 1
    labels = native_gn_split(len(view_order), leu, lev)
    if labels is None:
        return None

    by_label: dict = {}
    for i, u in enumerate(view_order):
        by_label.setdefault(int(labels[i]), []).append(u)
    result: List[List[int]] = []
    for com in by_label.values():
        com = sorted(com)  # netclu: sorted(c) before testing/recursing
        com_a = np.asarray(com, dtype=np.int64)
        if _max_collision_arrays(com_a, eu, ev, seq_genome, bool_scratch) > 0:
            sub = _split_colliding_native(
                com, dsrc, ddst, comp_order, n_total, eu, ev, seq_genome,
                pos_scratch, bool_scratch, calls,
            )
            if sub is None:
                return None
            result.extend(sub)
        else:
            result.append(com)
    return result


def _split_all_native(comp_ids, nodes, node_starts, seu, sev, edge_starts,
                      order_rank, seq_genome, n_total, n_workers):
    """Every colliding component's split in one ``pt_gn_families`` call
    on ``n_workers`` native threads: ``(c, its communities, its own
    seconds, its split levels)`` per component, or None (CPython's set
    order not replayed, or the call failed) for the Python-driven pool.
    Component c's nodes are ``nodes[node_starts[c]:node_starts[c+1]]``,
    its edges ``(seu, sev)[edge_starts[c]:edge_starts[c+1]]`` in ``.net``
    order."""
    from pandelos_tpu_torch.native.loader import (native_gn_families,
                                                  pyset_order_ok)

    if not pyset_order_ok():
        return None
    ids = np.asarray(comp_ids, dtype=np.int64)
    offsets = []
    for starts in (node_starts, edge_starts):
        counts = starts[ids + 1] - starts[ids]
        offsets.append(np.concatenate([[0], np.cumsum(counts)]))
    members = np.concatenate(
        [nodes[node_starts[c]:node_starts[c + 1]] for c in comp_ids])
    eidx = np.concatenate(
        [np.arange(edge_starts[c], edge_starts[c + 1]) for c in comp_ids])
    got = native_gn_families(
        n_total, members, offsets[0], seu[eidx], sev[eidx], offsets[1],
        order_rank, seq_genome, n_workers)
    if got is None:
        return None
    return list(zip(comp_ids, got.families, got.seconds.tolist(),
                    got.levels.tolist()))


def _split_pool(comp_ids, nodes, node_starts, seu, sev, edge_starts,
                split_component, n_sequences, n_workers):
    """The Python-driven split: a pool of ``n_workers`` threads runs
    ``split_component`` (one ``pt_gn_split`` call per level, the GIL
    held between them) per component; the same tuples as
    :func:`_split_all_native`, None for a component's communities on a
    native miss."""
    def job(c):
        """(c, its communities, the call's own seconds, its native split
        calls): worker threads open no spans."""
        t = time.perf_counter()
        lo, hi = node_starts[c], node_starts[c + 1]
        el, eh = edge_starts[c], edge_starts[c + 1]
        calls = [0]
        coms = split_component(
            nodes[lo:hi], seu[el:eh], sev[el:eh],
            np.full(n_sequences, -1, dtype=np.int64),
            np.zeros(n_sequences, dtype=bool), calls,
        )
        return c, coms, time.perf_counter() - t, calls[0]

    if n_workers > 1:
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(n_workers) as pool:
            return list(pool.map(job, comp_ids))
    return [job(c) for c in comp_ids]


def cluster_network(
    edges: Sequence[Tuple[int, int, float]],
    seq_genome: np.ndarray,
    n_sequences: int,
) -> ClusterResult:
    """Vectorized host clustering: scipy connected components + numpy
    collision detection; only components with paralog collisions build a
    networkx subgraph for the (reference-exact) Girvan-Newman recursion.
    A pure-networkx pass took ~4 minutes at 1M edges / 39k genes; this
    runs in seconds with identical output (.clus lines are sorted, so
    component order is immaterial)."""
    with tracing.span("cluster.components") as sp:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        seq_genome = np.asarray(seq_genome, dtype=np.int64)

        if len(edges) == 0:
            return ClusterResult(
                families=[],
                singletons=sorted(range(n_sequences)),
                component_size_distr={},
                family_size_distr={},
            )

        from pandelos_tpu_torch.io.net import EdgeList

        el = EdgeList.from_any(edges)
        ea, eb, ew = el.a, el.b, el.w
        seen = np.zeros(n_sequences, dtype=bool)
        seen[ea] = True
        seen[eb] = True
        # Global node insertion order: netclu adds cols[0] then cols[1] per
        # line (netclu_ng.py:43-50), INCLUDING self-loop lines (which add the
        # node but skip the edge) — a node's first appearance can be a
        # self-loop, so the order is derived from the raw stream, not the
        # loop-filtered one.
        stream = np.empty(2 * len(ea), dtype=np.int64)
        stream[0::2] = ea
        stream[1::2] = eb
        _, first_idx = np.unique(stream, return_index=True)
        global_order = stream[np.sort(first_idx)]
        order_rank = np.full(n_sequences, -1, dtype=np.int64)
        order_rank[global_order] = np.arange(len(global_order))
        # Self-loops are skipped (netclu_ng.py:54); the lone node still joins
        # the graph (netclu_ng.py:48-50) and forms a 1-node component.
        ns = ea != eb
        ea2, eb2, ew2 = ea[ns], eb[ns], ew[ns]

        adj = coo_matrix(
            (np.ones(len(ea2), np.int8), (ea2, eb2)),
            shape=(n_sequences, n_sequences),
        )
        n_comp, labels = connected_components(adj, directed=False)

        # component sizes over seen nodes only (unseen genes are singletons)
        seen_idx = np.flatnonzero(seen)
        comp_sizes = np.bincount(labels[seen_idx], minlength=n_comp)

        # --- vectorized max-collision per component (netclu_ng.py:79-96):
        # collision(s) = (#same-genome members in s's component - 1)
        #               - (#same-genome direct neighbours of s)
        n_gen = int(seq_genome.max()) + 1 if n_sequences else 1
        grp_key = labels[seen_idx] * np.int64(n_gen) + seq_genome[seen_idx]
        uk, uinv, ucnt = np.unique(
            grp_key, return_inverse=True, return_counts=True
        )
        members_same = ucnt[uinv]  # per seen node: same-(comp, genome) count
        deg_same = np.zeros(n_sequences, dtype=np.int64)
        sg = seq_genome[ea2] == seq_genome[eb2]
        np.add.at(deg_same, ea2[sg], 1)
        np.add.at(deg_same, eb2[sg], 1)
        coll = members_same - 1 - deg_same[seen_idx]
        comp_coll = np.zeros(n_comp, dtype=np.int64)
        np.maximum.at(comp_coll, labels[seen_idx], coll)

        # --- group nodes and edges by component
        order_n = np.argsort(labels[seen_idx], kind="stable")
        nodes_sorted = seen_idx[order_n]
        node_starts = np.searchsorted(
            labels[seen_idx][order_n], np.arange(n_comp + 1)
        )
        e_comp = labels[ea2]
        order_e = np.argsort(e_comp, kind="stable")
        edge_starts = np.searchsorted(
            e_comp[order_e], np.arange(n_comp + 1)
        )

        families: List[List[int]] = []
        comp_distr: dict = {}
        fam_distr: dict = {}
        remaining = np.ones(n_sequences, dtype=bool)
        n_total = len(global_order)  # pnet node count, incl. self-loop-only
        pnet_nx = None  # literal netclu graph, built lazily on native miss
        coco_by_member: dict = {}

        def _split_component(members, ceu, cev, pos_scratch, bool_scratch,
                         calls):
            """Colliding-component GN recursion; None on native miss.
            Thread-safe: every input and scratch is job-local."""
            # members in netclu's full-graph dict order (first appearance
            # may be a self-loop line, hence the global stream rank); the
            # per-line double append restricted to this component IS
            # pnet's adjacency for these nodes.
            comp_order = members[np.argsort(order_rank[members])].tolist()
            adj = {u: [] for u in comp_order}
            for u, v in zip(ceu.tolist(), cev.tolist()):
                adj[u].append(v)
                adj[v].append(u)
            # netclu's coco is the BFS set from connected_components,
            # sourced at the first component member in pnet node order
            coco = _plain_bfs_set(comp_order[0], adj)
            # directed edge stream in pnet adjacency-insertion order:
            # per edge, (u, v) then (v, u) (netclu_ng.py:55-56's double
            # add_edge) — the basis for every copy-scan at any depth
            dsrc = np.empty(2 * len(ceu), dtype=np.int64)
            dsrc[0::2] = ceu
            dsrc[1::2] = cev
            ddst = np.empty_like(dsrc)
            ddst[0::2] = cev
            ddst[1::2] = ceu
            return _split_colliding_native(
                iter(coco), dsrc, ddst, comp_order, n_total, ceu, cev,
                seq_genome, pos_scratch, bool_scratch, calls,
            )

        # colliding components are independent jobs: one native call
        # splits them all on its own threads (pt_gn_families), the GIL
        # released throughout; where CPython's set order cannot be
        # replayed, a thread pool drives one pt_gn_split call per level
        # from Python (the Java analogue is the reference running netclu
        # once, single-threaded — this phase parallelism has no ordering
        # effect because each family list is derived per component and
        # .clus lines are sorted on write)
        comp_ids = [
            c for c in range(n_comp)
            if node_starts[c + 1] > node_starts[c] and comp_coll[c] > 0
        ]
        split_results: dict = {}
        sp.set("components", int(n_comp))
        sp.set("colliding", len(comp_ids))

    with tracing.span("cluster.split", split_calls=0, split_thread_s=0.0,
                      threads=0, native_components=0) as sp:
        if comp_ids and native_available():
            n_workers = min(len(comp_ids), os.cpu_count() or 1)
            # nodes and edges by component: c's are [starts[c], starts[c+1])
            by_comp = (nodes_sorted, node_starts, ea2[order_e], eb2[order_e],
                       edge_starts)
            done = _split_all_native(comp_ids, *by_comp, order_rank,
                                     seq_genome, n_total, n_workers)
            if done is not None:
                sp.set("native_components", len(done))
            else:
                done = _split_pool(comp_ids, *by_comp, _split_component,
                                   n_sequences, n_workers)
            for c, coms, secs, calls in done:
                split_results[c] = coms
                sp.add("split_thread_s", secs)
                sp.add("split_calls", calls)
            sp.set("threads", n_workers)

    with tracing.span("cluster.assemble"):
        for c in range(n_comp):
            lo, hi = node_starts[c], node_starts[c + 1]
            if hi == lo:
                continue  # component of only-unseen nodes (isolated)
            members = nodes_sorted[lo:hi]
            size = int(hi - lo)
            comp_distr[size] = comp_distr.get(size, 0) + 1
            if comp_coll[c] > 0:
                coms = split_results.get(c)
                if coms is None:  # native core unavailable: literal networkx
                    if pnet_nx is None:
                        import networkx as nx

                        pnet_nx = nx.Graph()
                        inodes: set = set()
                        for a_, b_, w_ in zip(
                            ea.tolist(), eb.tolist(), ew.tolist()
                        ):
                            if a_ not in inodes:
                                inodes.add(a_)
                                pnet_nx.add_node(a_)
                            if b_ not in inodes and a_ != b_:
                                inodes.add(b_)
                                pnet_nx.add_node(b_)
                            if a_ != b_:
                                pnet_nx.add_edge(a_, b_, weight=w_)
                                pnet_nx.add_edge(b_, a_, weight=w_)
                        for coco_s in nx.connected_components(pnet_nx):
                            coco_by_member[min(coco_s)] = coco_s
                    coms = _split_until_max_k(
                        coco_by_member[int(members.min())], pnet_nx, seq_genome
                    )
            else:
                coms = [sorted(members.tolist())]
            for com in coms:
                fam = sorted(com)
                fam_distr[len(fam)] = fam_distr.get(len(fam), 0) + 1
                families.append(fam)
                remaining[fam] = False

    return ClusterResult(
        families=families,
        singletons=np.flatnonzero(remaining).tolist(),
        component_size_distr=comp_distr,
        family_size_distr=fam_distr,
    )


def families_as_names(result: ClusterResult, names: Sequence[str]):
    """(family name-lists in seq-id order, singleton names) for the .clus
    writer.  Singletons keep the reference's trailing-space rendering
    (see pandelos_tpu_torch.io.clus)."""
    fams = [[names[i] for i in fam] for fam in result.families]
    singles = [names[i] for i in result.singletons]
    return fams, singles
