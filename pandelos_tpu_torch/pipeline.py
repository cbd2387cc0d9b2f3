"""End-to-end pipeline: ingest -> k -> index -> score -> network -> cluster.

Replaces the reference's bash orchestration (``pandelos.sh:60-81``) which
chains four OS processes through temp files and stdout scraping.  Here every
phase is a function call with validated results, per-phase timing, and
restartable checkpoints (the reference's only de-facto checkpoint is the
``.net`` file, ``pandelos.sh:73-76``; we persist both the index and the
network).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from pandelos_tpu_torch.cluster import cluster_network, families_as_names
from pandelos_tpu_torch.config import (
    PipelineConfig,
    check_ported,
    resolve_backend,
)
from pandelos_tpu_torch.index import KmerIndex, build_index
from pandelos_tpu_torch.io.clus import family_lines, write_clus
from pandelos_tpu_torch.io.faa import FaaDataset, read_faa
from pandelos_tpu_torch.io.net import write_net
from pandelos_tpu_torch.ksel import select_k
from pandelos_tpu_torch.net import NetworkResult, build_network, finalize_scores
from pandelos_tpu_torch.oracle.cells import ScoreCells, compute_cells_oracle


@dataclasses.dataclass
class PipelineResult:
    k: int
    n_sequences: int
    n_genomes: int
    edges: List[Tuple[int, int, float]]
    families: List[List[str]]
    singletons: List[str]
    clus_lines: List[str]
    phase_times: dict
    stats: dict


def compute_cells(
    index: KmerIndex, config: PipelineConfig, capture: Optional[dict] = None
) -> ScoreCells:
    """The valid cells of the index on the host, dispatched as in the JAX
    package: the candidate engine's cells path for backends ``"cuda"``
    and ``"xla"``, the dense scorer for ``"dense"``, the posting walk for
    ``"oracle"``."""
    backend = resolve_backend(config.backend)
    if backend in ("oracle", "reference"):
        return compute_cells_oracle(index)
    if backend == "dense":
        from pandelos_tpu_torch.ops.score import compute_cells_xla

        return compute_cells_xla(index, config, capture=capture)
    from pandelos_tpu_torch.ops.candidate import compute_cells_candidate

    return compute_cells_candidate(index, config, capture=capture)


def _score_and_network(ds, index, k, config, times, capture):
    """The score and network phases of ``run_pipeline``: the network of
    the index with the backend of ``config``, their seconds in
    ``times``."""
    backend = resolve_backend(config.backend)
    net = None
    if backend == "reference":
        # whole-run transcription twin (reference.py): its own cells from
        # the raw sequences -> per-cell f32 finalize -> Pangenes.java dict
        # BBH, on the host.  Clustering below also takes its netclu_ng.py
        # transcription.
        from pandelos_tpu_torch import reference as refmod

        t = time.monotonic()
        cells = refmod.compute_cells_reference(ds.sequences, k)
        times["score"] = time.monotonic() - t
        t = time.monotonic()
        fcells = refmod.finalize_cells_reference(cells, index.kseq_lengths, k)
        edges, rstats = refmod.build_network_reference(
            fcells, index.seq_genome, ds.n_genomes
        )
        net = NetworkResult(
            edges=edges,
            n_inter_edges=rstats["n_inter_edges"],
            n_intra_edges=rstats["n_intra_edges"],
            genome_max=np.zeros((0, 0), np.float32),
            inter_max_score=np.zeros((0, 0), np.float32),
            stats=rstats,
        )
        times["network"] = time.monotonic() - t
    elif backend in ("cuda", "xla") and config.device_bbh is not False:
        from pandelos_tpu_torch.ops.net_device import compute_network_device

        t = time.monotonic()
        out = compute_network_device(index, config, capture=capture)
        if out is not None:
            edges, dstats = out
            times["score"] = time.monotonic() - t
            times["network"] = 0.0
            net = NetworkResult(
                edges=edges,
                n_inter_edges=dstats.get("n_inter_edges", len(edges)),
                n_intra_edges=dstats.get("n_intra_edges", 0),
                genome_max=np.zeros((0, 0), np.float32),
                inter_max_score=np.zeros((0, 0), np.float32),
                stats=dstats,
            )
    if net is None:
        t = time.monotonic()
        cells = compute_cells(index, config, capture=capture)
        times["score"] = time.monotonic() - t

        t = time.monotonic()
        finalized = finalize_scores(cells, index.kseq_lengths, k)
        net = build_network(
            finalized, index.seq_genome, ds.n_genomes, ds.n_sequences
        )
        times["network"] = time.monotonic() - t

    return net


def run_pipeline(
    input_faa: str,
    out_prefix: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    dataset: Optional[FaaDataset] = None,
    capture: Optional[dict] = None,
) -> PipelineResult:
    """.faa -> .net + .clus (+ .stats.json) with the backend of
    ``config`` (see :mod:`pandelos_tpu_torch.config`).  The candidate
    engine (``"cuda"``, ``"xla"``) builds the network on the device
    unless ``config.device_bbh`` is False; it takes the cells path
    (:func:`compute_cells`, then BBH on the host) then, and when a row's
    candidates pass the largest device cap.  ``"dense"`` and
    ``"oracle"`` always take the cells path; ``"reference"`` runs the
    transcription twin (:mod:`pandelos_tpu_torch.reference`) on the
    host.  ``capture``, when given, receives the index and the engine's
    join inputs (see ``compute_network_device``) or the dense pass's
    times.  With ``config.profile_dir`` the score and network phases run
    under a ``torch.profiler`` trace (:mod:`pandelos_tpu_torch.profiling`)."""
    config = config or PipelineConfig()
    check_ported(config)
    times = {}
    t0 = time.monotonic()

    ds = dataset if dataset is not None else read_faa(input_faa)
    times["ingest"] = time.monotonic() - t0

    t = time.monotonic()
    k = config.k if config.k is not None else select_k(ds.sequences)
    times["k_select"] = time.monotonic() - t

    t = time.monotonic()
    index = build_index(ds, k=k, only_complexity=config.only_complexity)
    times["index"] = time.monotonic() - t
    if capture is not None:
        capture["index"] = index

    if config.checkpoint_dir:
        os.makedirs(config.checkpoint_dir, exist_ok=True)
        index.save(os.path.join(config.checkpoint_dir, "index.npz"))

    if config.only_complexity:
        # The -c mode stops after the complexity report (Pangenes.java:33-36).
        report = index.complexity_report()
        return PipelineResult(
            k=k,
            n_sequences=ds.n_sequences,
            n_genomes=ds.n_genomes,
            edges=[],
            families=[],
            singletons=[],
            clus_lines=[],
            phase_times=times,
            stats={"complexity": report},
        )

    backend = resolve_backend(config.backend)
    if config.profile_dir:
        from pandelos_tpu_torch.profiling import profiled
    else:
        from contextlib import nullcontext as profiled
    with profiled(config):
        net = _score_and_network(ds, index, k, config, times, capture)

    if out_prefix and config.write_net:
        write_net(out_prefix + ".net", net.edges)
    if config.checkpoint_dir:
        write_net(os.path.join(config.checkpoint_dir, "network.net"), net.edges)

    t = time.monotonic()
    if backend == "reference":
        from pandelos_tpu_torch.reference import cluster_reference

        clusters = cluster_reference(
            net.edges, np.asarray(ds.seq_genome), ds.n_sequences
        )
    else:
        clusters = cluster_network(
            net.edges, np.asarray(ds.seq_genome), ds.n_sequences
        )
    fams, singles = families_as_names(clusters, ds.names)
    lines = family_lines(fams, singles)
    times["cluster"] = time.monotonic() - t

    if out_prefix and config.write_clus:
        write_clus(out_prefix + ".clus", lines)
    if out_prefix and config.write_report:
        from pandelos_tpu_torch.io.clus import family_report_lines

        report = family_report_lines(
            clusters.families, ds.names, ds.descriptions
        )
        report += [f"F{{ {ds.names[g]} }}" for g in clusters.singletons]
        with open(out_prefix + ".report", "w") as fh:
            fh.write("\n".join(report) + ("\n" if report else ""))

    # degree distribution of the similarity network (the reference prints
    # it after network construction, Pangenes.java:202-219)
    from pandelos_tpu_torch.io.net import EdgeList

    _el = EdgeList.from_any(net.edges)
    ea, eb = _el.a, _el.b
    deg = np.bincount(ea, minlength=ds.n_sequences)
    deg += np.bincount(eb[eb != ea], minlength=ds.n_sequences)
    deg_vals, deg_cnts = np.unique(deg, return_counts=True)
    degree_distr = {
        str(int(v)): int(c) for v, c in zip(deg_vals, deg_cnts)
    }

    stats = {
        "k": k,
        "n_sequences": ds.n_sequences,
        "n_genomes": ds.n_genomes,
        "vocab_size": index.vocab_size,
        "total_vocab": index.total_vocab,
        "degree_distr": degree_distr,
        "complexity": index.complexity_report(),
        "network": net.stats,
        "n_families": len(clusters.families),
        "n_singletons": len(clusters.singletons),
        "component_size_distr": {
            str(kk): v for kk, v in sorted(clusters.component_size_distr.items())
        },
        "family_size_distr": {
            str(kk): v for kk, v in sorted(clusters.family_size_distr.items())
        },
    }
    if out_prefix:
        with open(out_prefix + ".stats.json", "w") as fh:
            json.dump({"stats": stats, "phase_times": times}, fh, indent=2)

    return PipelineResult(
        k=k,
        n_sequences=ds.n_sequences,
        n_genomes=ds.n_genomes,
        edges=net.edges,
        families=fams,
        singletons=singles,
        clus_lines=lines,
        phase_times=times,
        stats=stats,
    )


def cluster_from_net(
    input_faa: str, net_path: str, out_prefix: Optional[str] = None
) -> PipelineResult:
    """Resume clustering from a ``.net`` checkpoint without rescoring — the
    reference allows rerunning netclu_ng.py on an existing .net."""
    from pandelos_tpu_torch.io.net import read_net

    ds = read_faa(input_faa)
    edges = read_net(net_path)
    t = time.monotonic()
    clusters = cluster_network(edges, np.asarray(ds.seq_genome), ds.n_sequences)
    fams, singles = families_as_names(clusters, ds.names)
    lines = family_lines(fams, singles)
    times = {"cluster": time.monotonic() - t}
    if out_prefix:
        write_clus(out_prefix + ".clus", lines)
    return PipelineResult(
        k=0,
        n_sequences=ds.n_sequences,
        n_genomes=ds.n_genomes,
        edges=edges,
        families=fams,
        singletons=singles,
        clus_lines=lines,
        phase_times=times,
        stats={},
    )
