"""The benchmark's entry:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for.  It prints, as the last line of standard output, one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics`` and
``device`` (and with ``--trace 1`` ``breakdown``), then ``checks``: each
number compared beside its limit, which are also the last lines of
standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.  It exits
with 2 and prints no result when the card is missing, and with 3 when
the process holds a module of JAX or of the JAX package.
"""

from __future__ import annotations

import time

SETUP_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    os.environ.update(harness.cache_dirs(ROOT))
    cell = harness.load_cell(args.workload, ROOT)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import pandelos_tpu_torch  # noqa: F401  (the system under test)

    workdir = tempfile.mkdtemp(prefix="pandelos-bench-")
    try:
        result = harness.measure(
            cell, args.seed, args.seconds, bool(args.trace), "cuda",
            workdir, SETUP_START)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"the process holds {leaked}: no result", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
