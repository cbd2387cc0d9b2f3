"""The measurement: set-up, the window of whole jobs, the traced run's
reduction and the check of the timed jobs' outputs.

A job is one ``pandelos_tpu_torch.pipeline.run_pipeline(faa, prefix,
PipelineConfig(...))`` call on an input that set-up wrote, as ``cli
run`` makes it.  The window runs whole jobs back to back: it opens when
the first timed job starts and closes when the last job that started
within ``seconds`` finishes.  Each job's outputs are renamed after it to
names of its own, so every timed job's files are judged once the window
has closed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import random
import sys
import time
from typing import Callable, List, Optional

from benchmark import check, jobs as jobgen, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# top-level module names no process that prints a result may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "pandelos_tpu")
OUTPUTS = (".net", ".clus", ".stats.json")
JOB_RANGE = "bench.job."


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def cache_dirs(root: str = ROOT) -> dict:
    """Fixed build and kernel-cache directories inside the checkout."""
    build = os.path.join(root, "build")
    return {
        "TORCH_EXTENSIONS_DIR": os.path.join(build, "torch_extensions"),
        "TRITON_CACHE_DIR": os.path.join(build, "triton_cache"),
        "CUDA_CACHE_PATH": os.path.join(build, "cuda_cache"),
    }


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: str = ROOT,
              traffic_dir: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its configuration file and
    its traffic file (``<traffic_dir>/<traffic>.json``), found by name."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    traffic_dir = traffic_dir or os.path.join(root, "benchmark", "traffic")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(root, cfg["file"])),
        traffic=load_json(os.path.join(traffic_dir, w["traffic"] + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def load_metric(name: str, metrics_dir: Optional[str] = None):
    """The reader ``<metrics_dir>/<name>.py`` (``read(record)``)."""
    path = os.path.join(metrics_dir or os.path.join(HERE, "metrics"),
                        name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def pipeline_job(faa: str, prefix: str, options: dict, capture=None):
    """One whole job as ``cli run`` makes it."""
    from pandelos_tpu_torch.config import PipelineConfig
    from pandelos_tpu_torch.pipeline import run_pipeline

    return run_pipeline(faa, prefix, PipelineConfig(**options),
                        capture=capture)


def _remove(prefix: str) -> None:
    for ext in OUTPUTS:
        if os.path.exists(prefix + ext):
            os.remove(prefix + ext)


def measure(cell: Cell, seed: int, seconds: float, traced: bool,
            device: str, workdir: str, setup_start: float,
            job: Callable = pipeline_job, log=sys.stderr,
            workers=None) -> dict:
    """One run of ``cell``: the result line's object (see ``run.py``)."""
    import torch
    from torch.profiler import record_function

    on_card = device.startswith("cuda")
    options = dict(cell.config.get("pipeline", {}), device=device)
    faa = jobgen.make_input(cell.config, seed, workdir)
    warm = os.path.join(workdir, "warm")
    job(faa, warm, options)  # loads the kernels and pays first-use costs
    _remove(warm)
    prefix = os.path.join(workdir, "job")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()

    done: List[dict] = []
    t0 = time.monotonic()
    setup_s = t0 - setup_start
    i = 0
    while i == 0 or time.monotonic() - t0 < seconds:
        capture = {} if traced else None
        rec = {"wall_start_ns": time.time_ns()}
        with record_function(f"{JOB_RANGE}{i}"):
            try:
                res = job(faa, prefix, options, capture)
            except Exception as exc:  # a job that fails is counted
                print(f"job {i} failed: {exc!r}", file=log)
                res = None
        wall = (time.time_ns() - rec["wall_start_ns"]) / 1e9
        print(f"job {i} {wall:.4f} s "
              f"{json.dumps(getattr(res, 'phase_times', None))}", file=log)
        if res is not None:
            rec["phase_times"] = dict(res.phase_times)
            rec["phase_s"] = dict((res.stats.get("network") or {})
                                  .get("phase_s") or {})
        if capture:
            rec["join_input"] = (
                (capture["index"].profile_ptr, capture["pi"], capture["pj"])
                if "pi" in capture else None)
        capture = res = None
        for ext in OUTPUTS:
            if os.path.exists(prefix + ext):
                os.replace(prefix + ext, f"{prefix}{i}{ext}")
        done.append(rec)
        i += 1
    if on_card:
        torch.cuda.synchronize()
    window_s = time.monotonic() - t0
    peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    if prof is not None:
        prof.stop()
    leaked = forbidden_modules()

    metrics = {}
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak_bytes),
    }
    breakdown = None
    if traced:
        record = _traced_record(prof, done, prefix, device_info["kind"])
        prof = None
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(record) if record else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if record:
            device_info["busy_s"] = trace.busy_seconds(record)
            device_info["window_s"] = trace.window_seconds(record)
            breakdown = trace.breakdown(record)
    else:
        e2e = {
            "job_s": window_s / len(done),
            "peak_mem_gib": peak_bytes / 2**30,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    for rec in done:
        rec.pop("join_input", None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks, failed = judge(done, faa, prefix, seed, device, workers, log)
    if leaked:
        print(f"forbidden modules loaded: {leaked}", file=log)
    correct = (not leaked and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": len(done), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=log)
    return result


def _traced_record(prof, done, prefix, kind):
    from benchmark.counts.join import join_work

    import numpy as np

    ops, ranges = trace.device_events(prof)
    jobs = []
    work = []
    for i, rec in enumerate(done):
        if "phase_times" not in rec or i not in ranges:
            return None
        net = f"{prefix}{i}.net"
        rec["net_written_ns"] = (os.stat(net).st_mtime_ns
                                 if os.path.exists(net)
                                 else rec["wall_start_ns"])
        jobs.append(rec)
        ji = rec.get("join_input")
        work.append(None if ji is None else join_work(
            np.diff(np.asarray(ji[0])), ji[1].cpu().numpy(),
            ji[2].cpu().numpy()))
    record = trace.build_record(jobs, ops, ranges, work)
    record["peak"] = load_json(os.path.join(HERE, "peaks.json")).get(kind)
    return record


def judge(done, faa, prefix, seed, device, workers, log):
    """(the checks, the jobs that failed: raised, or left an output
    missing): one timed job drawn from the seed is compared with the
    reference, and every other timed job with it byte for byte."""
    from benchmark.reference import job as reference

    totals = {name: 0 for name in check.LIMITS}
    whole = [i for i, rec in enumerate(done) if "phase_times" in rec and all(
        os.path.exists(f"{prefix}{i}{ext}") for ext in OUTPUTS)]
    failed = len(done) - len(whole)
    judged = random.Random(seed).choice(whole) if whole else 0
    t = time.monotonic()
    ref = reference.run(faa, device, workers=workers)
    print(f"reference: {time.monotonic() - t:.1f} s", file=log)
    totals.update(check.compare(ref, f"{prefix}{judged}.net",
                                f"{prefix}{judged}.clus",
                                f"{prefix}{judged}.stats.json"))
    totals["jobs_unlike_judged"] = sum(
        not all(check.same_files(f"{prefix}{i}{ext}",
                                 f"{prefix}{judged}{ext}")
                for ext in (".net", ".clus"))
        for i in whole if i != judged)
    return ({n: {"value": v, "limit": check.LIMITS[n]}
             for n, v in totals.items()}, failed)
