"""Command-line interface of the PyTorch/CUDA engine: the JAX package's
commands, with the same arguments, stdout JSON and exit codes.

    python -m pandelos_tpu_torch.cli run input.faa out_prefix [--k K]
        [--backend cuda|auto|xla|dense|pallas|oracle|reference]
        [--device cuda|cpu] [--checkpoint-dir DIR] [--device-bbh] [--report]
    python -m pandelos_tpu_torch.cli complexity input.faa       (the -c mode)
    python -m pandelos_tpu_torch.cli cluster input.faa net out  (resume from .net)
    python -m pandelos_tpu_torch.cli check first.net second.net (differential check)
    python -m pandelos_tpu_torch.cli k input.faa                (k selection only)
    python -m pandelos_tpu_torch.cli quality input.faa out.clus
    python -m pandelos_tpu_torch.cli bench input.faa out_prefix (rusage + JSON)
    python -m pandelos_tpu_torch.cli auto input.faa workdir     (two-backend sweep)
    python -m pandelos_tpu_torch.cli reinput in.faa out.faa [--max-sequences N]
    python -m pandelos_tpu_torch.cli gbk2faa gbk_dir out.faa
    python -m pandelos_tpu_torch.cli synth preset out.faa
    python -m pandelos_tpu_torch.cli examples workdir [--presets a,b]
    python -m pandelos_tpu_torch.cli refcheck input.faa [--k K]
        (cells vs the reference's own C++ kernel; PANDELOS_REF_ROOT)

Every command that runs the pipeline (``run``, ``complexity``, ``bench``,
``examples``, ``auto``) runs on the card unless ``--device cpu`` is given,
and fails where there is none.  ``--backend`` takes the JAX package's
names (``auto`` is ``xla``, ``pallas`` is ``cuda``); ``oracle`` and
``reference`` run on the host whatever ``--device`` says.  ``--devices
N`` shards the candidate engine over N devices (cards 0..N-1, or N CPU
shards with ``--device cpu``), ``--ring`` shards its signatures too
(backend ``cuda``, N >= 2; otherwise the replicated engine runs, as in
the JAX package; ``dense``, ``oracle`` and ``reference`` ignore both),
and ``--distributed`` joins the processes
named by PANDELOS_COORDINATOR / PANDELOS_NUM_PROCS / PANDELOS_PROC_ID
(NCCL on cards, gloo with ``--device cpu``; ``--devices`` is then the
global shard count), prints the topology JSON to stderr and lets only
the primary write outputs.  More shards than cards exits 2.
``refcheck`` runs on the host; it exits 2 when the reference tree is
absent.  ``check``, ``auto`` and ``refcheck`` exit 1 when the networks
(cells) differ.
"""

from __future__ import annotations

import argparse
import json
import sys

from pandelos_tpu_torch.config import PipelineConfig


def _add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--k", type=int, default=None, help="k-mer length override")
    p.add_argument(
        "--backend",
        default="cuda",
        choices=["cuda", "auto", "oracle", "dense", "xla", "pallas",
                 "reference"],
    )
    _add_device_arg(p)
    p.add_argument("--row-block", type=int, default=None)
    p.add_argument("--col-block", type=int, default=None)
    p.add_argument("--candidate-cap", type=int, default=None)
    p.add_argument("--level-cap", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument(
        "--devices",
        type=int,
        default=None,
        help="shard the scoring row axis over N devices (-j analogue; "
        "the global count under --distributed)",
    )
    p.add_argument(
        "--device-bbh",
        action="store_true",
        help="run BBH network construction on device (the default of the "
        "cuda and xla backends)",
    )
    p.add_argument(
        "--ring",
        action="store_true",
        help="ring-sharded signatures over the devices (memory-scaling "
        "mode: the cuda backend over --devices >= 2; otherwise the "
        "replicated engine; composes with --device-bbh)",
    )
    p.add_argument(
        "--report",
        action="store_true",
        help="also write <out>.report: the netclu per-family "
        "F{ }/D{ }/S{ } stream (netclu_ng.py:117-138)",
    )
    p.add_argument(
        "--distributed",
        action="store_true",
        help="multi-process run: torch.distributed from the "
        "PANDELOS_COORDINATOR / PANDELOS_NUM_PROCS / PANDELOS_PROC_ID "
        "env vars (NCCL, or gloo with --device cpu); the shards span every "
        "process and only the primary process writes outputs",
    )


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the device backends")


def _config_from_args(args) -> PipelineConfig:
    cfg = PipelineConfig(k=args.k, backend=args.backend, device=args.device)
    if getattr(args, "row_block", None):
        cfg.row_block = args.row_block
    if getattr(args, "col_block", None):
        cfg.col_block = args.col_block
    if getattr(args, "candidate_cap", None):
        cfg.candidate_cap = args.candidate_cap
    if getattr(args, "level_cap", None):
        cfg.level_cap = args.level_cap
    if getattr(args, "checkpoint_dir", None):
        cfg.checkpoint_dir = args.checkpoint_dir
    if getattr(args, "devices", None):
        cfg.n_devices = args.devices
    if getattr(args, "device_bbh", False):
        cfg.device_bbh = True
    if getattr(args, "ring", False):
        cfg.ring_extract = True
    if getattr(args, "report", False):
        cfg.write_report = True
    return cfg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pandelos_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="full pipeline: .faa -> .net + .clus")
    p_run.add_argument("input")
    p_run.add_argument("out_prefix")
    _add_config_args(p_run)

    p_cx = sub.add_parser("complexity", help="index + cost report only (-c)")
    p_cx.add_argument("input")
    _add_config_args(p_cx)

    p_cl = sub.add_parser("cluster", help="resume clustering from a .net")
    p_cl.add_argument("input")
    p_cl.add_argument("net")
    p_cl.add_argument("out_prefix")

    p_ck = sub.add_parser("check", help="differential .net comparison")
    p_ck.add_argument("first")
    p_ck.add_argument("second")
    p_ck.add_argument("--tolerance", type=float, default=0.001)

    p_k = sub.add_parser("k", help="entropy-based k selection")
    p_k.add_argument("input")

    p_q = sub.add_parser("quality", help="family quality statistics")
    p_q.add_argument("input")
    p_q.add_argument("clus")

    p_bench = sub.add_parser("bench", help="measured run (rusage + JSON)")
    p_bench.add_argument("input")
    p_bench.add_argument("out_prefix")
    _add_config_args(p_bench)

    p_auto = sub.add_parser(
        "auto", help="scaling sweep: two backends, growing subsets, diff"
    )
    p_auto.add_argument("input")
    p_auto.add_argument("workdir")
    p_auto.add_argument("--backend-new", default="xla")
    p_auto.add_argument("--backend-ref", default="oracle")
    p_auto.add_argument("--seq-start", type=int, default=200)
    p_auto.add_argument("--max-rounds", type=int, default=10)
    _add_device_arg(p_auto)

    p_re = sub.add_parser("reinput", help="truncate a dataset (subsetting)")
    p_re.add_argument("input")
    p_re.add_argument("output")
    p_re.add_argument("--max-sequences", type=int, default=None)
    p_re.add_argument("--max-genomes", type=int, default=None)

    p_gbk = sub.add_parser("gbk2faa", help="GenBank directory -> .faa")
    p_gbk.add_argument("directory")
    p_gbk.add_argument("output")

    p_syn = sub.add_parser("synth", help="generate a synthetic dataset")
    p_syn.add_argument("preset", help="toy|salmonella7|escherichia10|xanthomonas14|mycoplasma64")
    p_syn.add_argument("output")

    p_rc = sub.add_parser(
        "refcheck",
        help="bit-exact cell diff vs the reference's own compiled C++ "
        "kernel (needs the reference tree; PANDELOS_REF_ROOT)",
    )
    p_rc.add_argument("input")
    p_rc.add_argument("--k", type=int, default=None)

    p_ex = sub.add_parser(
        "examples",
        help="run all four reference datasets end-to-end + quality "
        "(example/run_examples.sh:3-13; synth presets stand in for the "
        "NCBI download)",
    )
    p_ex.add_argument("workdir")
    p_ex.add_argument(
        "--presets",
        default="salmonella7,escherichia10,xanthomonas14,mycoplasma64",
        help="comma-separated preset subset",
    )
    _add_config_args(p_ex)

    args = parser.parse_args(argv)
    try:
        return _dispatch(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _dispatch(args) -> int:
    if not getattr(args, "distributed", False):
        return _command(args)
    from pandelos_tpu_torch.parallel import distributed

    topo = distributed.initialize_from_env(args.device, args.devices)
    print(json.dumps({"distributed": topo}), file=sys.stderr)
    try:
        return _command(args)
    finally:
        distributed.shutdown()


def _command(args) -> int:
    if args.cmd == "run":
        from pandelos_tpu_torch.pipeline import run_pipeline

        out_prefix = args.out_prefix
        if getattr(args, "distributed", False):
            from pandelos_tpu_torch.parallel.distributed import is_primary

            # every process runs the whole pipeline (the collectives need
            # them all); only the primary writes .net/.clus/.stats.json
            if not is_primary():
                out_prefix = None
        res = run_pipeline(args.input, out_prefix, _config_from_args(args))
        stats = dict(res.stats)
        if "network" in stats and "genome_pairs" in stats.get("network", {}):
            stats["network"] = {
                k: v for k, v in stats["network"].items() if k != "genome_pairs"
            }
            stats["network"]["genome_pairs"] = "written to .stats.json"
        print(json.dumps({"stats": stats, "phase_times": res.phase_times},
                         indent=2))
        return 0

    if args.cmd == "complexity":
        from pandelos_tpu_torch.pipeline import run_pipeline

        cfg = _config_from_args(args)
        cfg.only_complexity = True
        res = run_pipeline(args.input, None, cfg)
        print(json.dumps(res.stats, indent=2))
        return 0

    if args.cmd == "cluster":
        from pandelos_tpu_torch.pipeline import cluster_from_net

        res = cluster_from_net(args.input, args.net, args.out_prefix)
        print(json.dumps({"n_families": len(res.families)}, indent=2))
        return 0

    if args.cmd == "check":
        from pandelos_tpu_torch.io.net import diff_nets, read_net

        report = diff_nets(
            read_net(args.first), read_net(args.second), args.tolerance
        )
        print(json.dumps(report, indent=2))
        return 0 if report["identical"] else 1

    if args.cmd == "k":
        from pandelos_tpu_torch.io.faa import read_faa
        from pandelos_tpu_torch.ksel import k_report

        ds = read_faa(args.input)
        print(json.dumps(k_report(ds.sequences), indent=2))
        return 0

    if args.cmd == "quality":
        from pandelos_tpu_torch.bench.quality import quality_report

        print(json.dumps(quality_report(args.input, args.clus), indent=2))
        return 0

    if args.cmd == "bench":
        from pandelos_tpu_torch.bench.harness import run_measured

        res, bench = run_measured(
            args.input, args.out_prefix, _config_from_args(args)
        )
        print(
            json.dumps(
                {"bench": bench.to_dict(), "phase_times": res.phase_times},
                indent=2,
            )
        )
        return 0

    if args.cmd == "auto":
        from pandelos_tpu_torch.bench.harness import auto_sweep

        reports = auto_sweep(
            args.input,
            args.workdir,
            backend_new=args.backend_new,
            backend_ref=args.backend_ref,
            seq_start=args.seq_start,
            max_rounds=args.max_rounds,
            device=args.device,
        )
        ok = all(r["check"]["identical"] for r in reports)
        print(json.dumps({"rounds": len(reports), "all_identical": ok}))
        return 0 if ok else 1

    if args.cmd == "reinput":
        from pandelos_tpu_torch.bench.harness import reinput
        from pandelos_tpu_torch.io.faa import read_faa, write_faa

        ds = reinput(
            read_faa(args.input),
            max_sequences=args.max_sequences,
            max_genomes=args.max_genomes,
        )
        write_faa(args.output, ds)
        print(json.dumps({"n_sequences": ds.n_sequences, "n_genomes": ds.n_genomes}))
        return 0

    if args.cmd == "gbk2faa":
        from pandelos_tpu_torch.io.faa import write_faa
        from pandelos_tpu_torch.io.gbk import gbk_dir_to_faa

        ds = gbk_dir_to_faa(args.directory)
        write_faa(args.output, ds)
        print(json.dumps({"n_sequences": ds.n_sequences, "n_genomes": ds.n_genomes}))
        return 0

    if args.cmd == "synth":
        from pandelos_tpu_torch.bench.synth import generate_preset
        from pandelos_tpu_torch.io.faa import write_faa

        ds = generate_preset(args.preset)
        write_faa(args.output, ds)
        print(json.dumps({"n_sequences": ds.n_sequences, "n_genomes": ds.n_genomes}))
        return 0

    if args.cmd == "refcheck":
        from pandelos_tpu_torch.index import build_index
        from pandelos_tpu_torch.io.faa import read_faa
        from pandelos_tpu_torch.ksel import select_k
        from pandelos_tpu_torch.native.ref_oracle import (
            our_cells_bits,
            reference_available,
            reference_cells,
        )

        if not reference_available():
            print("error: reference tree not found (PANDELOS_REF_ROOT)",
                  file=sys.stderr)
            return 2
        ds = read_faa(args.input)
        k = args.k if args.k is not None else select_k(ds.sequences)
        theirs = reference_cells(args.input, k)
        ours = our_cells_bits(build_index(ds, k=k))
        only_ours = len(set(ours) - set(theirs))
        only_theirs = len(set(theirs) - set(ours))
        bit_diffs = sum(
            1 for xy in ours if xy in theirs and ours[xy] != theirs[xy]
        )
        report = {
            "k": k,
            "cells_ours": len(ours),
            "cells_reference": len(theirs),
            "only_ours": only_ours,
            "only_reference": only_theirs,
            "bit_diffs": bit_diffs,
            "identical": not (only_ours or only_theirs or bit_diffs),
        }
        print(json.dumps(report, indent=2))
        return 0 if report["identical"] else 1

    if args.cmd == "examples":
        # the reference's example runner (example/run_examples.sh:3-13):
        # per dataset, download -> pandelos -> quality.py; here the synth
        # preset stands in for the network-gated NCBI download and
        # quality_report mirrors example/quality.py.
        import os
        import time

        from pandelos_tpu_torch.bench.quality import quality_report
        from pandelos_tpu_torch.bench.synth import generate_preset
        from pandelos_tpu_torch.io.faa import write_faa
        from pandelos_tpu_torch.pipeline import run_pipeline

        os.makedirs(args.workdir, exist_ok=True)
        summary = {}
        for preset in args.presets.split(","):
            preset = preset.strip()
            faa = os.path.join(args.workdir, f"{preset}.faa")
            if not os.path.exists(faa):
                write_faa(faa, generate_preset(preset))
            prefix = os.path.join(args.workdir, preset)
            t0 = time.monotonic()
            res = run_pipeline(faa, prefix, _config_from_args(args))
            summary[preset] = {
                "elapsed_s": round(time.monotonic() - t0, 3),
                "n_families": res.stats.get("n_families"),
                "quality": quality_report(faa, prefix + ".clus"),
            }
            print(json.dumps({preset: summary[preset]}), flush=True)
        with open(os.path.join(args.workdir, "examples.json"), "w") as fh:
            json.dump(summary, fh, indent=2)
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
