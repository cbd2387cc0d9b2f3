"""Clustering's Girvan-Newman split two ways on the CPU: the one native
call over every colliding component (``pt_gn_families``) against the
pool of threads that drives one ``pt_gn_split`` call per level from
Python (the fallback, forced here by failing the set-order self-check),
on a ``.net`` and its ``.faa``::

    python3 -m pandelos_tpu_torch.probe_cluster --preset mycoplasma64
    python3 -m pandelos_tpu_torch.probe_cluster --net x.net --faa x.faa

Runs ``cluster_network`` one warm time each way, then ``--repeats``
times each way in turn, and prints one JSON line a run: the
``cluster.split`` span's seconds and counters, and for the one call its
wall (``native_s``).  Then it replays both ways once more with every
level's view order and removed edges recorded and every native call
timed (the pool's calls are timed only here: a Python wrapper around
each call slows the pool's hand-offs of the GIL), and prints whether
the families and every split level's removal sequence matched.  Writes
it all to ``<out>/cluster_<tag>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from contextlib import contextmanager

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench_cache")


@contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextmanager
def _way(native, walls, trace=None):
    """Run the body the one-call way (``native``) or the pool's, adding
    each native call's wall to ``walls`` and, with ``trace``, recording
    every level as (view order, removed id pairs) into it."""
    from pandelos_tpu_torch import cluster
    from pandelos_tpu_torch.native import loader

    families, split = loader.native_gn_families, loader.native_gn_split
    scan = cluster._copy_scan_edges_np
    view = threading.local()  # a pool thread's level: its view order

    def timed_families(*args, **kw):
        t = time.perf_counter()
        got = families(*args, **kw, trace=trace is not None)
        walls.append(time.perf_counter() - t)
        if got is not None and trace is not None:
            trace.extend(lvl for comp in got.trace for lvl in comp)
        return got

    def viewed_scan(vo, *args):
        view.order = vo.tolist()
        return scan(vo, *args)

    def traced_split(n, leu, lev):
        removed = []
        t = time.perf_counter()
        got = split(n, leu, lev, removed)
        walls.append(time.perf_counter() - t)
        vo = view.order
        trace.append((tuple(vo), [(vo[leu[e]], vo[lev[e]]) for e in removed]))
        return got

    with _patched(loader, "native_gn_families", timed_families), \
            _patched(loader, "pyset_order_ok",
                     loader.pyset_order_ok if native else lambda: False):
        if trace is None:
            yield
            return
        with _patched(loader, "native_gn_split", traced_split), \
                _patched(cluster, "_copy_scan_edges_np", viewed_scan):
            yield


def _run(edges, seq_genome, n, native, trace=None):
    from pandelos_tpu_torch import tracing
    from pandelos_tpu_torch.cluster import cluster_network

    walls = []
    with _way(native, walls, trace), tracing.job() as job:
        res = cluster_network(edges, seq_genome, n)
    (split,) = [s for s in job.records() if s["name"] == "cluster.split"]
    rec = {"way": "native" if native else "pool",
           "split_s": (split["end_ns"] - split["start_ns"]) / 1e9,
           "native_s": sum(walls) if walls else None, **split["counters"]}
    return rec, res.families


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="mycoplasma64",
                   help="bench_cache/<preset>.net and .faa")
    p.add_argument("--net")
    p.add_argument("--faa")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", default=os.path.join("build", "cluster_probe"))
    p.add_argument("--tag", default="probe")
    args = p.parse_args(argv)

    from pandelos_tpu_torch.io.faa import read_faa
    from pandelos_tpu_torch.io.net import read_net
    from pandelos_tpu_torch.native.loader import (native_available,
                                                  pyset_order_ok)

    if not native_available():
        raise SystemExit("probe_cluster needs the native host core")
    net = args.net or os.path.join(CACHE, args.preset + ".net")
    faa = args.faa or os.path.join(CACHE, args.preset + ".faa")
    ds = read_faa(faa)
    edges = read_net(net)
    genome = np.asarray(ds.seq_genome)
    out = {"net": os.path.relpath(net, ROOT), "cpus": os.cpu_count(),
           "pyset_order_ok": pyset_order_ok(), "runs": []}
    for i in range(args.repeats + 1):
        for native in (True, False):
            rec = dict(_run(edges, genome, ds.n_sequences, native)[0],
                       warm=i == 0)
            out["runs"].append(rec)
            print(json.dumps(rec), flush=True)

    traces, fams, replay = {}, {}, {}
    for native in (True, False):
        levels = []
        replay[native], fams[native] = _run(edges, genome, ds.n_sequences,
                                            native, levels)
        traces[native] = dict(levels)
        if len(traces[native]) != len(levels):
            raise SystemExit("two levels with one view order")
    one, pool = traces[True], traces[False]
    same = [v for v in pool if one.get(v) == pool[v]]
    out["parity"] = {
        "native_s_traced": replay[True]["native_s"],
        "pool_native_s_traced": replay[False]["native_s"],
        "families_equal": fams[True] == fams[False],
        "levels": len(pool), "levels_native": len(one),
        "levels_matched": len(same),
        "removals": sum(len(r) for r in pool.values()),
        "all_removals_matched": len(same) == len(pool) == len(one)}
    print(json.dumps(out["parity"]), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"cluster_{args.tag}.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if out["parity"]["all_removals_matched"] and \
        out["parity"]["families_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
