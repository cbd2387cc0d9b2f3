"""The lane2 table build's device temporaries against
``lane_join.build_temp_bytes``, the count that ``memory_model`` and the
memory plan's join-table stage take: for each benchmark cell named, one
job on the cell's dataset (``benchmark/jobs.py``, the seed given), and
one JSON line with every build's shape, table bytes, the temporaries it
held above its table at its peak, and the count::

    python3 scripts/probe_lane_build.py --cells mycoplasma64.full

Needs a card; run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", required=True)
    p.add_argument("--seed", type=int, default=2718281829)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness, jobs
    from pandelos_tpu_torch.ops import lane_join

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    os.environ.update(harness.cache_dirs(ROOT))
    real = lane_join.pack_lane_device_core
    builds = []

    def measured(ids, counts, D, packed=True, **kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        table = real(ids, counts, D, packed=packed, **kw)
        torch.cuda.synchronize()
        G_pad, W = ids.shape
        nbytes = table.numel() * table.element_size()
        builds.append({
            "G_pad": G_pad, "W": W, "D": D, "table": nbytes,
            "temps": torch.cuda.max_memory_allocated() - before - nbytes,
            "model": lane_join.build_temp_bytes(G_pad, W)})
        return table

    lane_join.pack_lane_device_core = measured
    for name in args.cells.split(","):
        cell = harness.load_cell(name, ROOT)
        work = tempfile.mkdtemp(prefix="lane-build-")
        faa = jobs.make_input(cell.config, args.seed, work)
        harness.pipeline_job(faa, os.path.join(work, "job"),
                             dict(cell.config.get("pipeline", {}),
                                  device="cuda"))
        print(json.dumps({"cell": name, "builds": builds}), flush=True)
        builds.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
