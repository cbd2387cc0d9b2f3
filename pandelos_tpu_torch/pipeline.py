"""End-to-end pipeline: ingest -> k -> index -> score -> network -> cluster.

Replaces the reference's bash orchestration (``pandelos.sh:60-81``) which
chains four OS processes through temp files and stdout scraping.  Here every
phase is a function call with validated results, a span of the job's
trace (:mod:`pandelos_tpu_torch.tracing`), and restartable checkpoints
(the reference's only de-facto checkpoint is the ``.net`` file,
``pandelos.sh:73-76``; we persist both the index and the network).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from pandelos_tpu_torch import tracing
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
    # the job's closed spans (tracing.Span.record), in the order they opened
    spans: List[dict] = dataclasses.field(default_factory=list)


def compute_cells(
    index: KmerIndex, config: PipelineConfig, capture: Optional[dict] = None,
    devices=None,
) -> ScoreCells:
    """The valid cells of the index on the host, dispatched as in the JAX
    package: the posting walk for ``"oracle"`` and ``"reference"`` and
    the dense scorer for ``"dense"`` (both whatever ``ring_extract`` and
    ``n_devices`` say), the candidate engine's cells path for backends
    ``"cuda"`` and ``"xla"`` (its ring form with ``config.ring_extract``,
    which joins with the join kernel under either backend and needs two
    shards or more).
    ``devices``: see :func:`run_pipeline`."""
    backend = resolve_backend(config.backend)
    if backend in ("oracle", "reference"):
        return compute_cells_oracle(index)
    if backend == "dense":
        from pandelos_tpu_torch.ops.score import compute_cells_xla

        return compute_cells_xla(index, config, capture=capture)
    if config.ring_extract:
        from pandelos_tpu_torch.ops.ring import compute_cells_ring

        return compute_cells_ring(index, config, capture=capture,
                                  devices=devices)
    from pandelos_tpu_torch.ops.candidate import compute_cells_candidate

    return compute_cells_candidate(index, config, capture=capture,
                                   devices=devices)


def _score_and_network(ds, index, k, config, capture, devices):
    """The ``score`` span of ``run_pipeline`` and, off the device path,
    its ``network`` span: the network of the index with the backend of
    ``config``."""
    backend = resolve_backend(config.backend)
    if backend == "reference":
        # whole-run transcription twin (reference.py): its own cells from
        # the raw sequences -> per-cell f32 finalize -> Pangenes.java dict
        # BBH, on the host.  Clustering below also takes its netclu_ng.py
        # transcription.
        with tracing.span("score"):
            from pandelos_tpu_torch import reference as refmod

            cells = refmod.compute_cells_reference(ds.sequences, k)
        with tracing.span("network"):
            fcells = refmod.finalize_cells_reference(
                cells, index.kseq_lengths, k)
            edges, rstats = refmod.build_network_reference(
                fcells, index.seq_genome, ds.n_genomes
            )
            del cells, fcells  # freed inside the span, not after it
            return NetworkResult(
                edges=edges,
                n_inter_edges=rstats["n_inter_edges"],
                n_intra_edges=rstats["n_intra_edges"],
                genome_max=np.zeros((0, 0), np.float32),
                inter_max_score=np.zeros((0, 0), np.float32),
                stats=rstats,
            )
    with tracing.span("score") as sp:
        if backend in ("cuda", "xla") and config.device_bbh is not False:
            from pandelos_tpu_torch.ops.net_device import (
                compute_network_device,
            )

            out = compute_network_device(index, config, capture=capture,
                                         devices=devices)
            if out is not None:
                edges, dstats = out
                return NetworkResult(
                    edges=edges,
                    n_inter_edges=dstats.get("n_inter_edges", len(edges)),
                    n_intra_edges=dstats.get("n_intra_edges", 0),
                    genome_max=np.zeros((0, 0), np.float32),
                    inter_max_score=np.zeros((0, 0), np.float32),
                    stats=dstats,
                )
            sp.set("engine.fallback", 1)  # the host cells path takes over
        cells = compute_cells(index, config, capture=capture,
                              devices=devices)
    with tracing.span("network"):
        net = build_network(finalize_scores(cells, index.kseq_lengths, k),
                            index.seq_genome, ds.n_genomes, ds.n_sequences)
        del cells  # freed inside the span, not after it
        return net


def _index_device(config, devices):
    """The device the index is built on: the first shard's device of the
    engine, resolved as the engine resolves it (``resolve_shards`` under
    ``"cuda"`` and ``"xla"``, ``resolve_device`` under ``"dense"``), so
    that a CUDA run without a card raises here as it would there; None
    (the CPU) for the host backends and the -c mode, which run no device
    stage."""
    backend = resolve_backend(config.backend)
    if config.only_complexity or backend not in ("cuda", "xla", "dense"):
        return None
    if backend == "dense":
        from pandelos_tpu_torch.device import resolve_device

        return resolve_device(config.device)
    from pandelos_tpu_torch.parallel.shards import resolve_shards

    return resolve_shards(config, None, devices).devices[0]


def _phase_times(spans: List[dict]) -> dict:
    """``phase_times`` from the job's closed spans; the device path has
    no ``network`` span, and its ``network`` reads 0.0."""
    times = tracing.phase_times(spans)
    if "score" in times:
        times.setdefault("network", 0.0)
    return times


def run_pipeline(
    input_faa: str,
    out_prefix: Optional[str] = None,
    config: Optional[PipelineConfig] = None,
    dataset: Optional[FaaDataset] = None,
    capture: Optional[dict] = None,
    devices=None,
) -> PipelineResult:
    """.faa -> .net + .clus (+ .stats.json) with the backend of
    ``config`` (see :mod:`pandelos_tpu_torch.config`).  The candidate
    engine (``"cuda"``, ``"xla"``) builds the network on the device
    unless ``config.device_bbh`` is False; it takes the cells path
    (:func:`compute_cells`, then BBH on the host) then, and when the
    card cannot hold the engine's heavy-row pass (rows whose candidates
    pass its cap; ``compute_network_device``).  ``"dense"`` and
    ``"oracle"`` always take the cells path; ``"reference"`` runs the
    transcription twin (:mod:`pandelos_tpu_torch.reference`) on the
    host.  ``capture``, when given, receives the index and the engine's
    join inputs (see ``compute_network_device``).

    The run is one job of :mod:`pandelos_tpu_torch.tracing`: its
    top-level spans (``ingest``, ``k_select``, ``index``, ``score``,
    ``network`` off the device path, ``net_write``, ``cluster``,
    ``clus_write``, ``report`` when one is written, ``stats``) follow one
    another from entry to return; the result carries them (``spans``),
    ``phase_times`` is derived from them, and ``.stats.json`` holds them
    as its ``"trace"`` block.  With ``config.profile_dir`` the whole job
    runs under a ``torch.profiler`` trace
    (:mod:`pandelos_tpu_torch.profiling`).

    With ``config.n_devices`` the candidate engine shards its row blocks
    over that many devices (``"cuda"``: cards 0..n-1; ``"cpu"``: CPU
    shards), and under ``torch.distributed`` over every process's
    shards; every process computes every result (only the caller decides
    who writes: the CLI's ``--distributed`` lets the primary).
    ``devices`` (a list of devices, one a shard) places the shards
    explicitly, several on one card if it says so: the testing
    counterpart of JAX's virtual devices, not a user option."""
    config = config or PipelineConfig()
    if config.profile_dir:
        from pandelos_tpu_torch.profiling import profiled
    else:
        from contextlib import nullcontext as profiled
    with profiled(config), tracing.job() as job:
        return _run_job(job, input_faa, out_prefix, config, dataset,
                        capture, devices)


def _run_job(job, input_faa, out_prefix, config, dataset, capture, devices):
    with tracing.span("ingest") as sp:
        check_ported(config)
        ds = dataset if dataset is not None else read_faa(input_faa)
        sp.set("sequences", ds.n_sequences)
        sp.set("genomes", ds.n_genomes)
        sp.set("residues", sum(map(len, ds.sequences)))

    with tracing.span("k_select") as sp:
        k = config.k if config.k is not None else select_k(ds.sequences)
        sp.set("k", k)

    with tracing.span("index") as sp:
        index = build_index(ds, k=k, only_complexity=config.only_complexity,
                            device=_index_device(config, devices))
        sp.set("on_card", int(index.on_card))
        sp.set("vocab_size", index.vocab_size)
        sp.set("total_vocab", index.total_vocab)
        sp.set("kmers", int(np.sum(index.kseq_lengths, dtype=np.int64)))
        if capture is not None:
            capture["index"] = index
        if config.checkpoint_dir:
            os.makedirs(config.checkpoint_dir, exist_ok=True)
            index.save(os.path.join(config.checkpoint_dir, "index.npz"))

    if config.only_complexity:
        # The -c mode stops after the complexity report (Pangenes.java:33-36).
        with tracing.span("stats") as sp:
            spans = job.records()
            result = PipelineResult(
                k=k,
                n_sequences=ds.n_sequences,
                n_genomes=ds.n_genomes,
                edges=[],
                families=[],
                singletons=[],
                clus_lines=[],
                phase_times=_phase_times(spans),
                stats={"complexity": index.complexity_report()},
                spans=spans,
            )
            del ds, index  # freed inside the span, not after it
        return _with_last_span(result, sp)

    backend = resolve_backend(config.backend)
    net = _score_and_network(ds, index, k, config, capture, devices)

    with tracing.span("net_write") as sp:
        sp.set("edges", len(net.edges))
        if out_prefix and config.write_net:
            for key, value in write_net(out_prefix + ".net",
                                        net.edges).items():
                sp.set(key, value)
        if config.checkpoint_dir:
            write_net(os.path.join(config.checkpoint_dir, "network.net"),
                      net.edges)

    with tracing.span("cluster"):
        if backend == "reference":
            from pandelos_tpu_torch.reference import cluster_reference

            clusters = cluster_reference(
                net.edges, np.asarray(ds.seq_genome), ds.n_sequences
            )
        else:
            clusters = cluster_network(
                net.edges, np.asarray(ds.seq_genome), ds.n_sequences
            )
        with tracing.span("cluster.assemble"):
            fams, singles = families_as_names(clusters, ds.names)
            lines = family_lines(fams, singles)

    with tracing.span("clus_write"):
        if out_prefix and config.write_clus:
            write_clus(out_prefix + ".clus", lines)
    if out_prefix and config.write_report:
        with tracing.span("report"):
            from pandelos_tpu_torch.io.clus import family_report_lines

            report = family_report_lines(
                clusters.families, ds.names, ds.descriptions
            )
            report += [f"F{{ {ds.names[g]} }}" for g in clusters.singletons]
            with open(out_prefix + ".report", "w") as fh:
                fh.write("\n".join(report) + ("\n" if report else ""))

    with tracing.span("stats") as sp:
        # degree distribution of the similarity network (the reference
        # prints it after network construction, Pangenes.java:202-219)
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
                str(kk): v
                for kk, v in sorted(clusters.component_size_distr.items())
            },
            "family_size_distr": {
                str(kk): v
                for kk, v in sorted(clusters.family_size_distr.items())
            },
        }
        # the spans closed so far: every one but this
        spans = job.records()
        phase_times = _phase_times(spans)
        if out_prefix:
            with open(out_prefix + ".stats.json", "w") as fh:
                json.dump({"stats": stats, "phase_times": phase_times,
                           "trace": {"job": job.id, "spans": spans}},
                          fh, indent=2)
        result = PipelineResult(
            k=k,
            n_sequences=ds.n_sequences,
            n_genomes=ds.n_genomes,
            edges=net.edges,
            families=fams,
            singletons=singles,
            clus_lines=lines,
            phase_times=phase_times,
            stats=stats,
            spans=spans,
        )
        # the job's intermediates (the index and the profiles padded from
        # it, the dataset, the network) are freed inside the span, not
        # after it
        del ds, index, net, clusters
    return _with_last_span(result, sp)


def _with_last_span(result: PipelineResult, last) -> PipelineResult:
    """``result``, built inside its job's last top-level span ``last``,
    with that span's record and seconds added once it has closed."""
    result.spans.append(last.record())
    result.phase_times[last.name] = last.seconds
    return result


def cluster_from_net(
    input_faa: str, net_path: str, out_prefix: Optional[str] = None
) -> PipelineResult:
    """Resume clustering from a ``.net`` checkpoint without rescoring — the
    reference allows rerunning netclu_ng.py on an existing .net.  A job of
    its own: spans ``ingest`` (the ``.faa`` and the ``.net``),
    ``cluster`` and ``clus_write``."""
    from pandelos_tpu_torch.io.net import read_net

    with tracing.job() as job:
        with tracing.span("ingest"):
            ds = read_faa(input_faa)
            edges = read_net(net_path)
        with tracing.span("cluster"):
            clusters = cluster_network(edges, np.asarray(ds.seq_genome),
                                       ds.n_sequences)
            with tracing.span("cluster.assemble"):
                fams, singles = families_as_names(clusters, ds.names)
                lines = family_lines(fams, singles)
        with tracing.span("clus_write"):
            if out_prefix:
                write_clus(out_prefix + ".clus", lines)
        spans = job.records()
        return PipelineResult(
            k=0,
            n_sequences=ds.n_sequences,
            n_genomes=ds.n_genomes,
            edges=edges,
            families=fams,
            singletons=singles,
            clus_lines=lines,
            phase_times=_phase_times(spans),
            stats={},
            spans=spans,
        )
