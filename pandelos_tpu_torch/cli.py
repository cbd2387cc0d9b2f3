"""Command-line interface of the PyTorch/CUDA engine.

    python -m pandelos_tpu_torch.cli run input.faa out_prefix \
        [--device cuda|cpu] [--backend cuda|auto|xla|dense|pallas|oracle]
        [--k K] [--level-cap N]
    python -m pandelos_tpu_torch.cli check first.net second.net

``run`` writes ``out_prefix.net``, ``.clus`` and ``.stats.json`` and runs
on the card unless ``--device cpu`` is given.  ``--backend`` takes the
JAX package's names (``auto`` is ``xla``, ``pallas`` is ``cuda``);
``reference`` is not ported and exits with its ROADMAP item.  ``check`` compares two
``.net`` files (exit 1 when they differ).
"""

from __future__ import annotations

import argparse
import json
import sys

from pandelos_tpu_torch.config import NotPortedError, PipelineConfig


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pandelos_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="full pipeline: .faa -> .net + .clus")
    p_run.add_argument("input")
    p_run.add_argument("out_prefix")
    p_run.add_argument("--k", type=int, default=None,
                       help="k-mer length override")
    p_run.add_argument("--backend", default="cuda",
                       choices=["cuda", "auto", "oracle", "dense", "xla",
                                "pallas", "reference"])
    p_run.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p_run.add_argument("--row-block", type=int, default=None)
    p_run.add_argument("--col-block", type=int, default=None)
    p_run.add_argument("--candidate-cap", type=int, default=None)
    p_run.add_argument("--level-cap", type=int, default=None)

    p_ck = sub.add_parser("check", help="differential .net comparison")
    p_ck.add_argument("first")
    p_ck.add_argument("second")
    p_ck.add_argument("--tolerance", type=float, default=0.001)

    args = parser.parse_args(argv)
    try:
        return _dispatch(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename}", file=sys.stderr)
        return 2
    except (ValueError, NotPortedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _dispatch(args) -> int:
    if args.cmd == "run":
        from pandelos_tpu_torch.pipeline import run_pipeline

        cfg = PipelineConfig(k=args.k, backend=args.backend,
                             device=args.device)
        if args.row_block:
            cfg.row_block = args.row_block
        if args.col_block:
            cfg.col_block = args.col_block
        if args.candidate_cap:
            cfg.candidate_cap = args.candidate_cap
        if args.level_cap:
            cfg.level_cap = args.level_cap
        res = run_pipeline(args.input, args.out_prefix, cfg)
        stats = dict(res.stats)
        if "genome_pairs" in stats.get("network", {}):
            stats["network"] = {
                k: v for k, v in stats["network"].items()
                if k != "genome_pairs"
            }
            stats["network"]["genome_pairs"] = "written to .stats.json"
        print(json.dumps({"stats": stats, "phase_times": res.phase_times},
                         indent=2))
        return 0

    if args.cmd == "check":
        from pandelos_tpu_torch.io.net import diff_nets, read_net

        report = diff_nets(
            read_net(args.first), read_net(args.second), args.tolerance
        )
        print(json.dumps(report, indent=2))
        return 0 if report["identical"] else 1

    return 2


if __name__ == "__main__":
    sys.exit(main())
