"""The device engine's memory plan against the card: for each benchmark
cell named, one job on the cell's dataset (``benchmark/jobs.py``, the
seed given) through ``cli run``'s path, then a second with every span's
peak device memory recorded, and one JSON line a job::

    python3 scripts/probe_memory_plan.py --cells escherichia30.full
    python3 scripts/probe_memory_plan.py --cells mycoplasma64.full \
        --pipeline '{"backend": "xla"}'

``--pipeline`` overrides the cells' ``PipelineConfig`` options (a shape
or path other than the cells', to check the plan where its constants
were not set).

Each line holds the job's wall, its measured peak
(``torch.cuda.max_memory_allocated()``, reset before the job; on the
second job, the largest of its spans' peaks), the plan's
``planned_peak_bytes`` and its ratio to the peak, every stage the plan
sized (``ops/candidate.py::MemoryPlan``), the engine's ``phase_s`` and,
on the second job, each engine span's peak and counters.  Needs a card;
run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = ("index", "setup.runner", "setup.signatures", "extract",
         "extract.heavy", "plan", "flatten_join", "bbh", "fetch")


def _span_peaks(tracing, torch):
    """Wrap every span so that each records the peak device memory
    allocated while it was open (the allocator's peak is reset at every
    span boundary and credited to each open span); returns the records
    and a function that restores the spans."""
    enter, leave = tracing.Span.__enter__, tracing.Span.__exit__
    stack, rec = [], []

    def tick():
        peak = torch.cuda.max_memory_allocated()
        for d in stack:
            d["peak"] = max(d["peak"], peak)
        torch.cuda.reset_peak_memory_stats()

    def on_enter(self):
        tick()
        d = {"name": self.name, "peak": 0}
        stack.append(d)
        rec.append(d)
        return enter(self)

    def on_exit(self, *exc):
        out = leave(self, *exc)
        tick()
        stack.pop()["counters"] = {
            k: v for k, v in self.counters.items()
            if isinstance(v, (int, float))}
        return out

    tracing.Span.__enter__, tracing.Span.__exit__ = on_enter, on_exit

    def restore():
        tracing.Span.__enter__, tracing.Span.__exit__ = enter, leave

    return rec, restore


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", required=True)
    p.add_argument("--seed", type=int, default=2718281829)
    p.add_argument("--pipeline", default="{}")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness, jobs
    from pandelos_tpu_torch import tracing
    from pandelos_tpu_torch.ops import candidate

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    os.environ.update(harness.cache_dirs(ROOT))
    plans = []
    init = candidate.MemoryPlan.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        plans.append(self)

    candidate.MemoryPlan.__init__ = recorded
    print(json.dumps({"card": torch.cuda.get_device_name()}), flush=True)
    for name in args.cells.split(","):
        cell = harness.load_cell(name, ROOT)
        work = tempfile.mkdtemp(prefix="memory-plan-")
        faa = jobs.make_input(cell.config, args.seed, work)
        for traced in (False, True):
            rec, restore = (_span_peaks(tracing, torch) if traced
                            else ([], lambda: None))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.monotonic()
            res = harness.pipeline_job(faa, os.path.join(work, "job"),
                                       dict(cell.config.get("pipeline", {}),
                                            **json.loads(args.pipeline),
                                            device="cuda"))
            torch.cuda.synchronize()
            wall = time.monotonic() - t
            restore()
            peak = (max(d["peak"] for d in rec) if traced
                    else torch.cuda.max_memory_allocated())
            plan = plans[-1]
            print(json.dumps({
                "cell": name, "pipeline": args.pipeline,
                "spans_recorded": traced,
                "wall_s": round(wall, 3), "peak_bytes": peak,
                "planned_peak_bytes": plan.planned_peak,
                "planned_over_peak": round(plan.planned_peak / peak, 4),
                "budget_bytes": plan.budget, "base_bytes": plan.base,
                "fixed_bytes": plan.fixed, "stages": plan.stages,
                "phase_s": res.stats["network"]["phase_s"],
                "spans": {d["name"]: [d["peak"], d.get("counters", {})]
                          for d in rec if d["name"] in SPANS},
            }), flush=True)
            res = None
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
