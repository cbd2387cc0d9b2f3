"""The multi-shard dry run: the counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``.

    python -m pandelos_tpu_torch.parallel.dryrun N [--device cpu]

runs the production engine over N shards, all on one device (the
``devices=`` placement: on the CPU, N CPU shards, the counterpart of the
JAX tests' N virtual CPU devices; on a card, N shards sharing it), and
holds each step against the single-host reference path:

1. sharded cells (``backend="cuda"``): their network equals the host BBH
   over them;
2. the device BBH with its cross-shard ``all_gather`` / ``pmax``: the
   same edges;
3. every shard's candidate pairs (capped at K) from the round-robin
   width-interleaved blocks: max/mean at most 1.15;
4. ring extraction: cells equal the replicated engine's, and the ring
   composed with the device BBH gives the same edges;
5. a block count the shards do not divide (inert padding blocks);
6. a mycoplasma16-sized pass (>= 8000 genes) through the ``xla``
   backend's device BBH with a small initial edge cap, so that the cap
   grows: edges equal the host BBH over the posting walk's cells.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _example_index(scale: int = 1):
    """The JAX dry run's deterministic dataset (seed 99) and its index."""
    from pandelos_tpu_torch.bench.synth import SynthSpec, generate
    from pandelos_tpu_torch.index import build_index

    ds = generate(SynthSpec(
        n_genomes=4 * scale, n_families=24 * scale, singleton_per_genome=2,
        min_len=40, max_len=120, seed=99,
    ))
    return build_index(ds, k=4)


def _edge_dict(edges):
    return {(a, b): np.float32(s) for a, b, s in edges}


def _host_network(index, cells):
    from pandelos_tpu_torch.net import build_network, finalize_scores

    fin = finalize_scores(cells, index.kseq_lengths, index.k)
    return build_network(fin, np.asarray(index.seq_genome), index.n_genomes,
                         index.n_sequences)


def _cells_dict(c):
    return {(int(r), int(cc)): (int(i), int(p), int(t))
            for r, cc, i, p, t in zip(c.row, c.col, c.intersection,
                                      c.perc_cnt, c.tr_perc_cnt)}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     large: bool = True) -> dict:
    """The dry run's six steps over ``n_devices`` shards on ``device``
    (``large=False`` stops after step 5).  Raises AssertionError where a
    step diverges; returns what the JAX dry run reports (genes, cells,
    edges, per-shard pairs and their spread, the uneven block count, the
    large pass's edges and edge caps, the ring's signature bytes)."""
    import os

    from pandelos_tpu_torch.config import PipelineConfig
    from pandelos_tpu_torch.ops.candidate import (
        compute_cells_candidate,
        memory_model,
    )
    from pandelos_tpu_torch.ops.net_device import compute_network_device
    from pandelos_tpu_torch.ops.ring import compute_cells_ring

    devices = [device] * n_devices
    idx = _example_index(scale=4)  # 16 genomes, 1,174 genes
    cfg = PipelineConfig(
        backend="cuda", row_block=16, col_block=256, candidate_cap=64,
        n_devices=n_devices, device=device,
    )

    # 1) sharded scoring: extraction + flatten + join per shard
    cells = compute_cells_candidate(idx, cfg, devices=devices)
    want = _host_network(idx, cells)
    ref = _edge_dict(want.edges)

    # 2) device BBH: the all_gather maxima merge + pmax/pmin matrices
    cap = {}
    edges, stats = compute_network_device(idx, cfg, capture=cap,
                                          devices=devices)
    assert _edge_dict(edges) == ref, (
        f"device BBH diverged: {len(edges)} vs {len(ref)} edges")
    assert stats["n_devices"] == n_devices

    # 3) per-shard candidate pairs of the upper-triangle extraction (the
    # cells pass; rows past the cap count K): the round-robin interleave
    # must keep them even
    runner = cap["runner"]
    outs = runner.extract_shards(
        cap["perm_ext"], cap["starts"], cap["row_block"], runner.w_pad,
        cfg.candidate_cap, do_join=False, upper_only=True)
    counts_h = runner.shards.fetch([o[2] for o in outs]).reshape(
        n_devices, -1)
    grow_h = runner.grow_layout(cap["perm_ext"], cap["starts"],
                                cap["row_block"]).reshape(n_devices, -1)
    pairs_per_shard = np.where(
        grow_h < idx.n_sequences, np.minimum(counts_h, cfg.candidate_cap),
        0).sum(axis=1)
    del runner, outs, cap
    spread = float(pairs_per_shard.max() / max(1.0, pairs_per_shard.mean()))
    assert spread <= 1.15, (
        f"round-robin width interleave is unbalanced: per-shard pairs "
        f"{pairs_per_shard.tolist()}, max/mean {spread:.3f} > 1.15")

    # 4) ring-sharded extraction, alone and with the device BBH
    ring_cfg = PipelineConfig(
        backend="cuda", row_block=16, col_block=256, candidate_cap=64,
        n_devices=n_devices, device=device, ring_extract=True,
    )
    ring_cells = compute_cells_ring(idx, ring_cfg, devices=devices)
    assert _cells_dict(ring_cells) == _cells_dict(cells), \
        "ring cells diverged"
    ring_out = compute_network_device(idx, ring_cfg, devices=devices)
    assert ring_out is not None, "ring device BBH fell back unexpectedly"
    assert ring_out[1]["ring_extract"] is True
    assert _edge_dict(ring_out[0]) == ref, (
        f"ring device BBH diverged: {len(ring_out[0])} vs {len(ref)}")
    mm = memory_model(idx, ring_cfg, budget_bytes=1e12)
    rep = memory_model(idx, ring_cfg, budget_bytes=1e12, ring=False)

    # 5) a block count the shards do not divide: inert padding blocks
    idx_odd = _example_index(scale=3)
    odd_cfg = PipelineConfig(
        backend="cuda", row_block=16, col_block=128, candidate_cap=64,
        n_devices=n_devices, device=device,
    )
    n_blocks_odd = -(-idx_odd.n_sequences // 16)
    assert n_blocks_odd % n_devices, (
        f"uneven case degenerate: {n_blocks_odd} blocks divisible by "
        f"{n_devices}")
    want_odd = _host_network(
        idx_odd, compute_cells_candidate(idx_odd, odd_cfg, devices=devices))
    out_odd = compute_network_device(idx_odd, odd_cfg, devices=devices)
    assert out_odd is not None
    assert _edge_dict(out_odd[0]) == _edge_dict(want_odd.edges), \
        "uneven-block device BBH diverged"

    report = {
        "n_devices": n_devices,
        "device": device,
        "small_pass_genes": idx.n_sequences,
        "cells": len(cells.row),
        "edges": len(edges),
        "pairs_per_shard": pairs_per_shard.tolist(),
        "work_spread_max_over_mean": round(spread, 3),
        "ring_cells_match": True,
        "ring_device_bbh_edges_match": True,
        "ring_sig_bytes_per_device": mm["sig_bytes"],
        "replicated_sig_bytes_per_device": rep["sig_bytes"],
        "uneven_blocks": n_blocks_odd,
    }
    print("dryrun_multichip steps 1-5 ok: " + json.dumps(report), flush=True)
    if not large:
        return report

    # 6) realistic scale: a mycoplasma16-shaped dataset through the xla
    # backend's device BBH, the edge cap forced to grow
    from pandelos_tpu_torch.bench.synth import SynthSpec, generate
    from pandelos_tpu_torch.index import build_index
    from pandelos_tpu_torch.ksel import select_k
    from pandelos_tpu_torch.oracle.cells import compute_cells_oracle

    ds_big = generate(SynthSpec(
        n_genomes=16, n_families=600, singleton_per_genome=55,
        min_len=60, max_len=400, seed=77,
    ))
    idx_big = build_index(ds_big, k=select_k(ds_big.sequences))
    assert idx_big.n_sequences >= 8000, idx_big.n_sequences
    want_big = _host_network(idx_big, compute_cells_oracle(idx_big))
    big_cfg = PipelineConfig(
        backend="xla", row_block=64, col_block=256, candidate_cap=64,
        n_devices=n_devices, device=device, device_bbh=True,
    )
    before = os.environ.get("PANDELOS_EDGE_CAP_INIT")
    os.environ["PANDELOS_EDGE_CAP_INIT"] = "1024"  # force the cap to grow
    try:
        out_big = compute_network_device(idx_big, big_cfg, devices=devices)
    finally:
        if before is None:
            os.environ.pop("PANDELOS_EDGE_CAP_INIT", None)
        else:
            os.environ["PANDELOS_EDGE_CAP_INIT"] = before
    big_edges, big_stats = out_big
    assert _edge_dict(big_edges) == _edge_dict(want_big.edges), (
        f"large BBH diverged: {len(big_edges)} vs {len(want_big.edges)}")
    assert big_stats["edge_cap"] > big_stats["edge_cap_initial"], \
        "the edge cap did not grow"
    report.update({
        "large_genes": idx_big.n_sequences,
        "large_edges": len(big_edges),
        "large_edge_cap": [big_stats["edge_cap_initial"],
                           big_stats["edge_cap"]],
        "large_candidate_cap_final": big_stats["candidate_cap_final"],
    })
    print("dryrun_multichip ok: " + json.dumps(report), flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pandelos_tpu_torch.parallel.dryrun")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--small", action="store_true",
                    help="stop before the large pass (step 6)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, large=not args.small)
    return 0


if __name__ == "__main__":
    sys.exit(main())
