"""Benchmark harness: run / check / auto — the Python equivalent of the
reference's Rust test-framework (``benchmark/test-framework/src/*.rs``).

- ``run``: execute the pipeline on an input, measuring wall/user/sys time
  and max RSS via ``resource.getrusage`` (manager.rs:79-98 uses wait4).
- ``check``: differential ``.net`` comparison with weight tolerance
  (verify.rs:48-86, main.rs:129-168).
- ``auto``: scaling sweep over growing input subsets, comparing two
  backends and appending JSON reports to a log (main.rs:170-266).
- ``reinput``: deterministic truncation of a dataset to <= N sequences /
  <= M genomes (reinput.rs:24-84).
"""

from __future__ import annotations

import dataclasses
import json
import os
import resource
import time
from typing import List, Optional

from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.io.faa import FaaDataset, read_faa, write_faa


@dataclasses.dataclass
class BenchmarkResults:
    real_s: float
    user_s: float
    system_s: float
    memory_mb: float
    exdate: str

    def to_dict(self):
        return dataclasses.asdict(self)


def reinput(
    ds: FaaDataset,
    max_sequences: Optional[int] = None,
    max_genomes: Optional[int] = None,
) -> FaaDataset:
    """Deterministically truncate a dataset (reinput.rs semantics: keep
    the first N sequences / first M genomes in file order)."""
    sequences, names, descriptions, seq_genome = [], [], [], []
    genome_names: List[str] = []
    remap = {}
    for i in range(ds.n_sequences):
        g = ds.seq_genome[i]
        if g not in remap:
            if max_genomes is not None and len(remap) >= max_genomes:
                continue
            remap[g] = len(remap)
            genome_names.append(ds.genome_names[g])
        if max_sequences is not None and len(sequences) >= max_sequences:
            break
        sequences.append(ds.sequences[i])
        names.append(ds.names[i])
        descriptions.append(ds.descriptions[i])
        seq_genome.append(remap[g])
    return FaaDataset(sequences, names, descriptions, seq_genome, genome_names)


def run_measured(
    input_faa: Optional[str],
    out_prefix: Optional[str],
    config: PipelineConfig,
    dataset: Optional[FaaDataset] = None,
):
    """Run the pipeline, returning (PipelineResult, BenchmarkResults)."""
    from pandelos_tpu_torch.pipeline import run_pipeline

    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.monotonic()
    res = run_pipeline(input_faa, out_prefix, config, dataset=dataset)
    real = time.monotonic() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    bench = BenchmarkResults(
        real_s=real,
        user_s=ru1.ru_utime - ru0.ru_utime,
        system_s=ru1.ru_stime - ru0.ru_stime,
        memory_mb=ru1.ru_maxrss / 1024.0,
        exdate=time.strftime("%Y-%m-%dT%H:%M:%S"),
    )
    return res, bench


def run_measured_subprocess(
    input_faa: str, out_prefix: str, config: PipelineConfig
) -> BenchmarkResults:
    """``run_measured`` in a fresh child process, so ``memory_mb`` is that
    run's own peak RSS — the semantics of the reference harness, which
    ``wait4``s each benchmark child (manager.rs:79-98).  In-process
    ``ru_maxrss`` is a lifetime high-water mark and inherits earlier runs'
    peaks.  The child takes ``config`` whole (its ``device`` included)
    through ``PipelineConfig.to_json``."""
    import subprocess
    import sys
    import tempfile

    with tempfile.NamedTemporaryFile("r", suffix=".json") as out:
        code = (
            "import json, sys\n"
            "from pandelos_tpu_torch.bench.harness import run_measured\n"
            "from pandelos_tpu_torch.config import PipelineConfig\n"
            "cfg = PipelineConfig.from_json(sys.argv[1])\n"
            "_, bench = run_measured(sys.argv[2], sys.argv[3], cfg)\n"
            "json.dump(bench.to_dict(), open(sys.argv[4], 'w'))\n"
        )
        subprocess.run(
            [sys.executable, "-c", code, config.to_json(), input_faa,
             out_prefix, out.name],
            check=True,
        )
        return BenchmarkResults(**json.load(open(out.name)))


def auto_sweep(
    input_faa: str,
    workdir: str,
    backend_new: str = "xla",
    backend_ref: str = "oracle",
    seq_start: int = 200,
    seq_jump: int = 200,
    seq_factor: float = 1.5,
    tolerance: float = 0.001,
    log_name: str = "log.json",
    max_rounds: int = 20,
    in_process: bool = False,
    device: str = "cuda",
) -> List[dict]:
    """Scaling sweep: grow the sequence budget (start + jump, then x
    factor — main.rs:248-263), run both backends, diff the networks, and
    append JSON reports.

    Each backend runs in its own child process by default so time/memory
    are per-run (manager.rs:79-98 semantics); ``in_process=True`` keeps
    everything in this process (faster for tests, but cumulative
    ``memory_mb``).  Both backends run on ``device`` (the host-only
    ``oracle`` and ``reference`` ignore it).

    Known divergence from ``reinput.rs``: the Rust harness iterates its
    genome ``HashMap`` in ``DefaultHasher`` order when truncating; this
    harness keeps file order (deterministic, but a cross-implementation
    ``auto`` at the same budget may subset different genes)."""
    from pandelos_tpu_torch.io.net import diff_nets, read_net

    os.makedirs(workdir, exist_ok=True)
    full = read_faa(input_faa)
    reports = []
    budget = seq_start
    log_path = os.path.join(workdir, log_name)
    for round_no in range(max_rounds):
        subset = reinput(full, max_sequences=budget)
        sub_path = os.path.join(workdir, f"subset_{budget}.faa")
        write_faa(sub_path, subset)

        p_new = os.path.join(workdir, f"new_{budget}")
        p_ref = os.path.join(workdir, f"ref_{budget}")
        if in_process:
            _, bench_new = run_measured(
                sub_path, p_new, PipelineConfig(
                    backend=backend_new, device=device)
            )
            _, bench_ref = run_measured(
                sub_path, p_ref, PipelineConfig(
                    backend=backend_ref, device=device)
            )
        else:
            bench_new = run_measured_subprocess(
                sub_path, p_new, PipelineConfig(
                    backend=backend_new, device=device)
            )
            bench_ref = run_measured_subprocess(
                sub_path, p_ref, PipelineConfig(
                    backend=backend_ref, device=device)
            )
        check = diff_nets(
            read_net(p_new + ".net"), read_net(p_ref + ".net"), tolerance
        )
        report = {
            "inpath": sub_path,
            "seqcount": subset.n_sequences,
            "gencount": subset.n_genomes,
            "new_bench": bench_new.to_dict(),
            "old_bench": bench_ref.to_dict(),
            "check": check,
        }
        reports.append(report)
        with open(log_path, "a") as fh:
            fh.write(json.dumps(report) + "\n")
        if subset.n_sequences < budget:
            break  # input exhausted
        budget = max(budget + seq_jump, int(budget * seq_factor))
    return reports
