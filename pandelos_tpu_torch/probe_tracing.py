"""What tracing costs when it is on: whole jobs of a preset
(``bench_cache/<preset>.faa``) in one process on the card, with
``config.profile_dir`` unset and set in turn (off, on, on, off, ...),
after one warm job of each::

    python3 -m pandelos_tpu_torch.probe_tracing --pairs 8

Prints one JSON line a job: its wall on the host clock (after a
``torch.cuda.synchronize``), the sum of its top-level spans, its
``phase_times`` and the engine's ``phase_s``, the counters of every span
that has some, and with ``profile_dir`` the summary's window and busy
share, the trace's size and its ``pandelos.*`` ranges.  Writes them all,
with the card's name and power limit, to ``<out>/tracing_<tag>.json``.
The wall less the spans' sum of a profiled job is the profiler's stop
and the trace's export.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "bench_cache")


def _job(faa, work, i, on):
    import torch

    from pandelos_tpu_torch.config import PipelineConfig
    from pandelos_tpu_torch.pipeline import run_pipeline

    pdir = os.path.join(work, f"profile{i}") if on else None
    t = time.perf_counter()
    res = run_pipeline(faa, os.path.join(work, "job"),
                       PipelineConfig(profile_dir=pdir))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    tops = [s for s in res.spans if s["parent"] is None]
    rec = {"profile_dir": on, "wall_s": wall,
           "spans_s": sum(s["end_ns"] - s["start_ns"] for s in tops) / 1e9,
           "n_spans": len(res.spans), "phase_times": res.phase_times,
           "phase_s": res.stats["network"].get("phase_s"),
           "counters": {s["name"]: s["counters"] for s in res.spans
                        if s["counters"]}}
    if on:
        with open(os.path.join(pdir, "profile_summary.json")) as fh:
            summary = json.load(fh)
        trace = os.path.join(pdir, "trace.json")
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        rec.update(window_s=summary["window_s"],
                   busy_share=summary["busy_share"],
                   trace_mb=os.path.getsize(trace) / 1e6,
                   ranges=sum(1 for e in events
                              if str(e.get("name", "")).startswith(
                                  "pandelos.")
                              and e.get("cat") == "user_annotation"))
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="mycoplasma64")
    p.add_argument("--pairs", type=int, default=4,
                   help="off/on pairs after the warm jobs (even: whole "
                        "off, on, on, off blocks)")
    p.add_argument("--out", default=os.path.join("build", "tracing_probe"))
    p.add_argument("--tag", default="probe")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_tracing needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    faa = os.path.join(CACHE, args.preset + ".faa")
    work = tempfile.mkdtemp(prefix="probe-tracing-")
    order = [False, True] + [False, True, True, False] * (
        (args.pairs + 1) // 2)
    runs = []
    for i, on in enumerate(order):
        rec = dict(_job(faa, work, i, on), warm=i < 2)
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"tracing_{args.tag}.json"), "w") as fh:
        json.dump({"card": card, "preset": args.preset, "runs": runs}, fh,
                  indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
