"""What binds the lane2, lane and pair join kernels on the card.

    python3 -m pandelos_tpu_torch.probe_joins [--out DIR] [--tag NAME]
        [--kinds lane2,lane,lane_cells,roll]

(``DIR`` defaults to ``build/join_probe``; ``--kinds`` names the runs to
probe, all four by default.)

Run from the root of the checkout on a machine with one NVIDIA card.
It builds the kernels and runs ``bench_cache/mycoplasma64.faa`` through
one path per kind to capture the kernel's table and pair list: the
default path (``lane2``), ``join_kernel="lane"`` with device BBH
(``lane``: lane2's 2,097,152 pair slots, so the two compare step for
step), the cells path with the lane kernel (``lane_cells``: the upper
triangle's 1,048,576 slots) and the roll path (``roll``).  It then
reports, as JSON lines and into ``DIR/join_probe_<tag>.json``:

- ``card``: name, power limit and SM clocks from ``nvidia-smi``;
- ``int_rates``: what the card executes, per clock and SM, of the integer
  instructions the lane steps are made of (add, logic, minimum,
  three-way minimum, fused add-and-minimum, multiply-add, compare and
  select), from the micro-kernels of ``probe_int_rates.cu``;
- ``build``: what ``nvcc -Xptxas -v`` said of each kernel;
- ``sass``: per kernel, every loop of its SASS (a backward branch and
  its target) with its instruction count and opcode histogram; the full
  listing goes to ``DIR/sass_<tag>_<kernel>.txt``;
- ``pairs``: of the captured pair list, pairs per run of equal a (mean,
  p50, p99, max), mean depth and width on each side, and the share of b
  rows in a window of 64 and of 512 consecutive a rows that the window
  has already named (what a cache can give once the a rows are off the
  bus);
- ``timing``: each kernel on the captured list as it is, on the pairs
  whose two genes lie in a window of the width-sorted permutation whose
  table rows fit 30 MB (L2-resident), and with ``b_idx = a_idx`` (rows
  from L1), with milliseconds, compare (lane2, lane) or merge (pair join)
  steps per second and per-pair row bytes per second: a rate that holds across
  the three says instruction throughput binds, one that follows the bytes says
  memory does;
- ``phases``: each kernel built with ``-DPT_PROFILE`` on the captured
  list: the cycles a warp spends in each phase of the kernel (named in
  its source), per pair, from ``clock64`` timers summed over all warps.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

L2_WINDOW_BYTES = 30e6


def _smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sass_loops(so_path: str, listing_path: str) -> dict:
    """Loops of every kernel in ``so_path``: {kernel: [{start, end,
    instructions, opcodes}]}, from ``cuobjdump -sass``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    with open(listing_path, "w") as fh:
        fh.write(text)
    out = {}
    name, instrs = None, []

    def close():
        if name is None:
            return
        loops = []
        for k, (addr, op, rest) in enumerate(instrs):
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op + " " + rest)
            if not m:
                continue
            target = int(m.group(1), 16)
            if target < addr:
                body = [o for a, o, _ in instrs if target <= a <= addr]
                hist = collections.Counter(o.split(".")[0] for o in body)
                loops.append({"start": hex(target), "end": hex(addr),
                              "instructions": len(body),
                              "opcodes": dict(hist.most_common())})
        out[name] = {"instructions": len(instrs), "loops": loops}

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            name, instrs = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?(\S+)(.*?);",
                     line)
        if m and name is not None:
            instrs.append((int(m.group(1), 16), m.group(2), m.group(3)))
    close()
    return out


def int_rates(out_dir: str) -> dict:
    """Builds and runs ``probe_int_rates.cu``: {instruction: chain
    updates per clock and SM}."""
    from pandelos_tpu_torch import kernels

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "probe_int_rates.cu")
    exe = os.path.join(out_dir, "probe_int_rates")
    subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-O3", "-o", exe,
                    src], check=True)
    text = subprocess.run([exe], capture_output=True, text=True,
                          check=True).stdout
    os.remove(exe)
    return {ln.split()[0]: float(ln.split()[3]) for ln in text.splitlines()}


def pair_stats(pi, pj, dg, widths, n_genes) -> dict:
    """Host-side shape of a captured pair list (numpy int arrays)."""
    real = pi < n_genes
    a, b = pi[real].astype(np.int64), pj[real].astype(np.int64)
    cut = np.flatnonzero(np.diff(a) != 0) + 1
    runs = np.diff(np.concatenate([[0], cut, [len(a)]]))
    starts = np.concatenate([[0], cut])
    row_of = np.repeat(np.arange(len(runs)), runs)
    out = {
        "pairs": int(len(a)), "padding_slots": int((~real).sum()),
        "a_runs": int(len(runs)),
        "run_len": {"mean": float(runs.mean()),
                    "p50": float(np.percentile(runs, 50)),
                    "p99": float(np.percentile(runs, 99)),
                    "max": int(runs.max())},
        "mean_dg_a": float(dg[a].mean()), "mean_dg_b": float(dg[b].mean()),
        "mean_dgdg": float((dg[a].astype(np.float64) * dg[b]).mean()),
        "dg_hist": np.bincount(dg[np.concatenate([a, b])]).tolist(),
        "mean_w_a": float(widths[a].mean()),
        "mean_w_b": float(widths[b].mean()),
        "distinct_a_rows": int(len(np.unique(a[starts]))),
    }
    for win in (64, 512):
        w_of = row_of // win
        key = w_of * np.int64(n_genes + 1) + b
        out[f"b_reuse_in_{win}_a_rows"] = float(
            1.0 - len(np.unique(key)) / len(key))
    return out


def _time(fn, args=(), reps=10):
    fn(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def variants(cap, unit_of_gene, unit_bytes):
    """The captured list as it is, cut to an L2-resident window of the
    permutation, and with b = a.  ``unit_of_gene`` [G_pad] is what a row
    costs to read in units of ``unit_bytes`` (depth or width)."""
    pi, pj = cap["pi"], cap["pj"]
    dev = pi.device
    perm = np.asarray(cap["perm_ext"], np.int64)
    G_pad = unit_of_gene.shape[0]
    perm = perm[perm < G_pad]
    cost = unit_of_gene[perm].astype(np.float64) * unit_bytes
    s0 = len(perm) // 2
    n = int(np.searchsorted(np.cumsum(cost[s0:]), L2_WINDOW_BYTES))
    inside = np.zeros(G_pad, bool)
    inside[perm[s0:s0 + n]] = True
    inside_d = torch.from_numpy(inside).to(dev)
    keep = inside_d[pi.long()] & inside_d[pj.long()]
    yield "as captured", pi, pj, {}
    yield "L2 window", pi[keep].contiguous(), pj[keep].contiguous(), {
        "window_genes": n, "window_bytes": float(cost[s0:s0 + n].sum())}
    yield "b = a", pi, pi.clone(), {}


def _lane_wrapper(kind):
    """The wrapper a lane kind (``lane2``, ``lane``, ``lane_cells``)
    times."""
    from pandelos_tpu_torch.ops import lane_join

    return lane_join.lane2_join if kind == "lane2" else lane_join.lane_join


def probe_kernel(kind, cap, log):
    from pandelos_tpu_torch.ops import pair_join

    table = cap["table"]
    if kind != "roll":
        dg = cap["dg"]
        unit = dg.cpu().numpy().astype(np.int64)
        # a depth row: 128 packed words, or 128 ids and 128 counts
        unit_bytes = 512 if kind == "lane2" else 1024
        join = _lane_wrapper(kind)

        def call(pi, pj):
            return join(table, dg, pi, pj)

        def steps(pi, pj):
            return float((dg[pi.long()].double() * dg[pj.long()].double()
                          * 128).sum())
    else:
        W = table.shape[1] // 2
        w_d = (table[:, W:] > 0).sum(1)
        unit = w_d.cpu().numpy().astype(np.int64)
        unit_bytes = 8

        def call(pi, pj):
            return pair_join.join_pairs_core(table, pi, pj)

        def steps(pi, pj):
            return float((w_d[pi.long()] + w_d[pj.long()]).double().sum())

    unit_d = torch.from_numpy(unit).to(table.device)
    for label, pi, pj, extra in variants(cap, unit, unit_bytes):
        ms = _time(call, (pi, pj))
        n_steps = steps(pi, pj)
        row_bytes = float((unit_d[pi.long()] + unit_d[pj.long()]).double()
                          .sum()) * unit_bytes
        rec = {"kernel": kind, "variant": label, "pairs": int(pi.shape[0]),
               "ms": ms, "steps": n_steps,
               "steps_per_s": n_steps / (ms * 1e-3),
               "pair_row_bytes": row_bytes,
               "pair_row_bytes_per_s": row_bytes / (ms * 1e-3), **extra}
        if label == "as captured":
            # the SM clock under this kernel's load: read while a queue
            # of launches runs
            for _ in range(100):
                call(pi, pj)
            rec["clocks_sm_power_under_load"] = _smi("clocks.sm,power.draw")
            torch.cuda.synchronize()
        log({"timing": rec})
    return unit


_LANE_PHASES = ["pair set-up", "a row", "prefetch request",
                "wait for the b row", "compare and account", "reduce"]
PHASES = {
    "lane2": ("lane2_join", _LANE_PHASES),
    "lane": ("lane_join", _LANE_PHASES),
    "lane_cells": ("lane_join", _LANE_PHASES),
    "roll": ("pair_join", ["table build", "tile request", "wait for the tile",
                           "lookups", "reduce", "barrier at the end of a run"]),
}


# kind -> the PipelineConfig fields of the run that captures its inputs
RUNS = {
    "lane2": {},
    "lane": {"join_kernel": "lane"},
    "lane_cells": {"join_kernel": "lane", "device_bbh": False},
    "roll": {"join_kernel": "roll"},
}


def probe_phases(kind, cap, log):
    """Warp cycles per pair and phase, from the kernel built with its
    phase timers."""
    import ctypes

    from pandelos_tpu_torch import kernels
    from pandelos_tpu_torch.ops import pair_join

    source, names = PHASES[kind]
    lib = kernels.build_profiled(source)
    plain_load = kernels.load
    kernels.load = lambda name: lib if name == source else plain_load(name)
    try:
        if kind != "roll":
            join = _lane_wrapper(kind)

            def call():
                return join(cap["table"], cap["dg"], cap["pi"], cap["pj"])
        else:
            def call():
                return pair_join.join_pairs_core(cap["table"], cap["pi"],
                                                 cap["pj"])
        buf = (ctypes.c_ulonglong * 8)()

        def read():  # the timers' sums since the last read
            torch.cuda.synchronize()
            if lib.pt_profile_read(buf):
                raise RuntimeError("pt_profile_read failed")

        ms = _time(call)
        read()
        call()  # one launch on zeroed timers
        read()
    finally:
        kernels.load = plain_load
    n = cap["pi"].shape[0]
    log({"phases": {"kernel": kind, "ms_with_timers": ms,
                    "warp_cycles_per_pair": {
                        name: buf[k] / n for k, name in enumerate(names)}}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "join_probe"))
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--kinds", default=",".join(RUNS),
                    help="comma-separated runs to probe: " + ", ".join(RUNS))
    args = ap.parse_args()
    kinds = args.kinds.split(",")
    if not set(kinds) <= set(RUNS):
        ap.error(f"--kinds takes {', '.join(RUNS)}")
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from pandelos_tpu_torch import kernels

    os.makedirs(args.out, exist_ok=True)
    result = {}

    def log(obj):
        print(json.dumps(obj), flush=True)
        for k, v in obj.items():
            if k in ("timing", "phases"):
                result.setdefault(k, []).append(v)
            else:
                result[k] = v

    log({"card": {"name_power_limit": _smi("name,power.limit"),
                  "clocks_sm_now_max_mhz": _smi("clocks.sm,clocks.max.sm"),
                  "torch": torch.__version__, "cuda": torch.version.cuda}})
    log({"int_rates": int_rates(args.out)})
    kernels.build_all()
    log({"build": {k: [ln.strip() for ln in v["nvcc"].splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling" in ln]
                   for k, v in kernels.BUILD_LOG.items()}})
    sass = {}
    for name in ("lane2_join", "lane_join", "pair_join"):
        so = kernels._so_path(os.path.join(kernels.CSRC, name + ".cu"))
        sass[name] = sass_loops(
            so, os.path.join(args.out, f"sass_{args.tag}_{name}.txt"))
    log({"sass": sass})

    outdir = tempfile.mkdtemp(prefix="pandelos_probe_")
    dg = None
    try:
        for kind in kinds:
            cap = {}
            cs.run(cs.MAIN, outdir, capture=cap, tag="_" + kind, **RUNS[kind])
            if cap["join_kernel"] != RUNS[kind].get("join_kernel", "lane2"):
                raise AssertionError(f"joined with {cap['join_kernel']}")
            unit = probe_kernel(kind, cap, log)
            probe_phases(kind, cap, log)
            if kind != "roll":
                dg = unit
            elif dg is not None:
                n_genes = cap["index"].n_sequences
                log({"pairs": pair_stats(
                    cap["pi"].cpu().numpy(), cap["pj"].cpu().numpy(), dg,
                    unit, n_genes)})
            del cap
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    with open(os.path.join(args.out, f"join_probe_{args.tag}.json"),
              "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
