"""The readings that the limits of ``benchmark/check.py`` are set from, at
a cell's own size, in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 --generator-seeds 21,22,...

- the lower readings: for each ``--seeds`` seed, one job of the cell's
  timed path (what a run's window drives) on that seed's input, judged
  against the reference as a run judges it;
- the same, for each ``--generator-seeds`` seed, on another gene set:
  the configuration's dataset generated with that seed in place of its
  own (a run's seed only reorders one gene set, so these cover the data
  that the timed runs never hold);
- the upper readings: for each ``--control-seeds`` seed, the control, the
  reference computed in bfloat16 (``network.finalize``), put in the
  program's place and judged against the float32 reference.

Each reading is one JSON line on standard output.  The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def _write(ref, prefix, job_mod):
    with open(prefix + ".net", "w") as fh:
        fh.write(job_mod.net_text(ref))
    with open(prefix + ".clus", "w") as fh:
        fh.write("".join(line + "\n" for line in ref.clus_lines))
    with open(prefix + ".stats.json", "w") as fh:
        json.dump({"stats": {"k": ref.k}}, fh)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--generator-seeds", type=_seeds, default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import check, harness, jobs
    from benchmark.reference import job as reference

    cell = harness.load_cell(args.workload, ROOT)
    options = dict(cell.config.get("pipeline", {}), device=args.device)
    work = tempfile.mkdtemp(prefix="pandelos-readings-")
    try:
        for kind, seeds in (("program", args.seeds),
                            ("control", args.control_seeds),
                            ("generator", args.generator_seeds)):
            for seed in seeds:
                config = cell.config
                if kind == "generator":
                    config = dict(config, generator=dict(
                        config["generator"], seed=seed))
                faa = jobs.make_input(config, seed, work)
                prefix = os.path.join(work, "out")
                t = time.monotonic()
                ref = reference.run(faa, args.device)
                if kind != "control":
                    harness.pipeline_job(faa, prefix, options)
                else:
                    _write(reference.run(faa, args.device, precision="bf16"),
                           prefix, reference)
                got = check.compare(ref, prefix + ".net", prefix + ".clus",
                                    prefix + ".stats.json")
                print(json.dumps({
                    "kind": kind, "workload": args.workload, "seed": seed,
                    "genes": sum(len(line.split())
                                 for line in ref.clus_lines),
                    "edges": int(len(ref.a)),
                    "seconds": round(time.monotonic() - t, 1),
                    "readings": got}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
