"""BBH network construction on the device.

The counterpart of the JAX package's ``ops/net_device.py``: the
candidate engine extracts every row's candidate list; the exact counters
come from the selected join kernel over the flat pair list (backend
``"cuda"``: lane2, lane or roll; :func:`_bbh_flat_program`) or from the
in-scan join's [rows, K] outputs (backend ``"xla"``: array code;
:func:`_bbh_program`, the JAX ``_bbh_local``); the reference's BBH +
paralog filters (``Pangenes.java:98-176``) run on the device, so that
only the accepted cells come back to the host.

One formulation serves one device, N shards and N processes, as the JAX
``shard_map`` does: each shard runs its own rows' program, which yields
at the collectives (:meth:`ShardGroup.spmd`): the per-row maxima that the
both-endpoint test needs are merged with an ``all_gather`` (the
reference's cross-thread ``col_max_scores`` merge, library.cpp:515), the
genome-pair matrices with max/min reduces.  Alone, every collective is
the identity.  The ring layout (``ops/ring.py``) adds a step axis whose
maxima and row thresholds merge before the gather.

Float semantics: scores are compared on the device for exact equality
(score == per-(row, genome) maxima), so every quotient must be the
host's IEEE f32 quotient; :func:`exact_div_f32` is that quotient here
(see its module).  The final ``.net`` scores are computed on the host
from the shipped integer counters; the genome-pair min/max statistics
aggregate on the device, mean and count on the host (float64).

Layout: rows live in width-sorted, shard-interleaved PERM order (as
produced by the extraction); ``inv_perm`` maps gene id -> global row
position for the counterpart-maxima lookups, the ``all_gather`` order.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from pandelos_tpu_torch.config import (
    PipelineConfig,
    check_ported,
    resolve_backend,
    ring_engaged,
)
from pandelos_tpu_torch.device import configure_numerics, resolve_device
from pandelos_tpu_torch.index import KmerIndex
from pandelos_tpu_torch.io.net import EdgeList
from pandelos_tpu_torch.ops.candidate import (
    MAX_CANDIDATE_CAP,
    _next_pow2,
    build_signatures,
    check_hbm_fit,
    get_runner,
)
from pandelos_tpu_torch.ops.exact_div import exact_div_f32
from pandelos_tpu_torch.ops.score import _round_up, pad_profiles


def _no_stats() -> bool:
    """PANDELOS_NO_PAIR_STATS=1 disables the per-genome-pair min/max
    stats aggregation (print-only diagnostics in the reference,
    Pangenes.java:130-143); edges are unaffected."""
    return os.environ.get("PANDELOS_NO_PAIR_STATS") == "1"


def _chunked_genome_multi(vals_ops, gsel, n_gen: int):
    """Per-row genome reductions: [(values [P, K], op), ...] -> tuple of
    [P, n_gen]: ``out[r, g] = op over k with gsel[r, k] == g of
    values[r, k]``, with neutral 0 for "max" and +inf for "min" (the
    JAX one-hot's neutrals).  max/min are exact and order-free, so a
    scatter-reduce gives the one-hot reduction's bits."""
    P, K = gsel.shape
    flat = (
        torch.arange(P, device=gsel.device, dtype=torch.int64)[:, None]
        * n_gen + gsel.long()
    ).reshape(-1)
    out = []
    for v, op in vals_ops:
        neutral = 0.0 if op == "max" else float("inf")
        M = torch.full((P * n_gen,), neutral, dtype=v.dtype, device=v.device)
        M.scatter_reduce_(
            0, flat, v.reshape(-1), "amax" if op == "max" else "amin"
        )
        out.append(M.reshape(P, n_gen))
    return tuple(out)


def _genome_segment_multi(rows_ops, g_rows, n_gen: int):
    """[P, n_gen] -> [n_gen, n_gen] segment reductions keyed by the row
    genome (same neutrals)."""
    idx = g_rows.long()[:, None].expand(-1, n_gen)
    out = []
    for m, op in rows_ops:
        neutral = 0.0 if op == "max" else float("inf")
        acc = torch.full((n_gen, n_gen), neutral, dtype=m.dtype,
                         device=m.device)
        acc.scatter_reduce_(0, idx, m, "amax" if op == "max" else "amin")
        out.append(acc)
    return tuple(out)


def _ims_and_aggregates(lt1_score, acc_cell, score, ap, atp, g_i, g_j,
                        n_gen: int, with_stats: bool):
    """inter_max_score + (optionally) the per-genome-pair stats aggregates
    over CANONICAL accepted cells.  Stats matrices are in the canonical
    (genome of smaller id, genome of larger id) orientation; empty
    entries carry the neutrals (+inf / +inf / 0) — the host mirrors them
    (m op m.T) and applies the reference's 1.0 inits."""
    if not with_stats:
        (M2,) = _chunked_genome_multi([(lt1_score, "max")], g_j, n_gen)
        (ims,) = _genome_segment_multi([(M2, "max")], g_i, n_gen)
        z = torch.zeros((n_gen, n_gen), dtype=torch.float32,
                        device=score.device)
        return ims, z, z, z
    inf = torch.full_like(score, float("inf"))
    min_in = torch.where(acc_cell, score, inf)
    minp_in = torch.where(acc_cell, torch.minimum(ap, atp), inf)
    maxp_in = torch.where(acc_cell, torch.maximum(ap, atp),
                          torch.zeros_like(score))
    r = _chunked_genome_multi(
        [(lt1_score, "max"), (min_in, "min"), (minp_in, "min"),
         (maxp_in, "max")],
        g_j, n_gen,
    )
    return _genome_segment_multi(
        [(r[0], "max"), (r[1], "min"), (r[2], "min"), (r[3], "max")],
        g_i, n_gen,
    )


def _emit(emask, accept, gf, cf, e_inter_of, edge_cap: int):
    """The emitted cells of ``emask`` [P, K] in row-major order, padded
    to ``edge_cap`` (doubled past the emitted count, as the JAX retry
    loop does) with row -1: (e_row, e_col, e_inter, e_acc, n_edges,
    edge_cap).  ``e_inter_of`` maps the flat [P * K] positions to the
    cells' intersections."""
    dev = emask.device
    K = cf.shape[1]
    (eidx,) = torch.nonzero(emask.reshape(-1), as_tuple=True)
    n_edges = int(eidx.shape[0])
    while n_edges > edge_cap:
        edge_cap = _next_pow2(n_edges)
    fill = torch.full((edge_cap - n_edges,), -1, dtype=eidx.dtype, device=dev)
    eidx = torch.cat([eidx, fill])
    safe = torch.clamp(eidx, min=0)
    found = eidx >= 0
    e_row = torch.where(found, gf[safe // K], torch.full_like(safe, -1))
    e_col = cf.reshape(-1)[safe]
    e_acc = accept.reshape(-1)[safe] & found
    return e_row, e_col, e_inter_of(safe), e_acc, n_edges, edge_cap


def _bbh_core(score, gf, cf, ap, atp, inv_perm, genome_of, n_gen: int,
              with_stats: bool, valid=None, steps: int = 1):
    """The BBH and paralog filters over [P, K] exact scores (0 where the
    cell is not a valid one with shared k-mers): the per-(row, genome)
    maxima, the accepted inter-genome cells, the genome-pair matrices and
    the intra-genome cells (Pangenes.java:98-176).  ``valid``, when
    given, also gates both tests (the JAX ``_bbh_local`` form).

    A generator, one shard's program (:meth:`ShardGroup.spmd`): it
    yields at its two collectives, the tiled ``all_gather`` of the
    per-row maxima (every shard needs every row's for the both-endpoint
    test, the reference's ``col_max_scores`` merge, library.cpp:515) and
    the ``pmax``/``pmin`` of the genome-pair matrices.  ``inv_perm`` maps
    a gene to its GLOBAL row position.  ``steps > 1`` is the ring
    composition: the rows are ``steps`` copies of the shard's real rows
    (one a ring step, each holding that step's column shard's
    candidates), so the maxima and the row threshold merge over the step
    axis first.  Returns (accept, intra, acc_cell, (ims, gmin_s, gmin_p,
    gmax_p))."""
    G_pad = genome_of.shape[0]
    P = score.shape[0]
    SR = P // steps  # real rows of the shard
    zeros_rk = torch.zeros_like(score)
    g_i = genome_of[torch.clamp(gf, max=G_pad - 1)].long()
    g_j = genome_of[cf].long()
    (M_virt,) = _chunked_genome_multi([(score, "max")], g_j, n_gen)
    # a real row's maxima span every ring step (column shard)
    M_row = M_virt if steps == 1 else M_virt.view(steps, SR, n_gen).amax(0)
    M = yield ("all_gather", M_row)
    M_grid = M_row if steps == 1 else M_row.repeat(steps, 1)
    jpos = inv_perm[cf].long()
    M_at_gj = torch.gather(M_grid, 1, g_j)  # M[row, gen(j)]
    M_j_gi = M[jpos, g_i[:, None].expand_as(jpos)]  # M[j, genome(i)]
    inter_genome = g_j != g_i[:, None]
    base = (score > 0) & (score == M_at_gj) & (score == M_j_gi)
    if valid is not None:
        base = base & valid
    accept = base & inter_genome
    lt1v = torch.where(accept & (score < 1.0), score, zeros_rk)
    acc_cell = accept & (cf > gf[:, None])
    ims, gmin_s, gmin_p, gmax_p = _ims_and_aggregates(
        lt1v, acc_cell, score, ap, atp, g_i, g_j, n_gen, with_stats
    )
    ims, gmax_p = (yield ("pmax", torch.stack([ims, gmax_p]))).unbind(0)
    gmin_s, gmin_p = (yield ("pmin", torch.stack([gmin_s, gmin_p]))).unbind(0)
    mats = (ims, gmin_s, gmin_p, gmax_p)
    thr_cell = ims[g_i[:, None].expand_as(g_j), g_j]
    row_thr = torch.where(
        accept, thr_cell, torch.full_like(thr_cell, float("inf"))
    ).amin(1)
    if steps > 1:
        # the threshold spans the row's accepted cells in every ring step
        row_thr = row_thr.view(steps, SR).amin(0).repeat(steps)
    intra = (
        base
        & (~inter_genome)
        & (gf[:, None] < cf)
        & (score >= row_thr[:, None])
    )
    return accept, intra, acc_cell, mats


def _emit_program(emask, accept, gf, cf, e_inter_of, edge_cap: int):
    """:func:`_emit` at an edge cap every shard shares: the initial cap,
    or past the largest shard's emitted count its next power of two (the
    JAX retry loop's cap).  A generator (one collective)."""
    n_edges = int(emask.sum())
    most = yield ("max_int", n_edges)
    if most > edge_cap:
        edge_cap = _next_pow2(most)
    return _emit(emask, accept, gf, cf, e_inter_of, edge_cap)


def _bbh_program(grow, cand, inter, perc, tr, valid, inv_perm, lens,
                 genome_of, n_gen: int, edge_cap: int):
    """One shard's BBH over the in-scan join's [rows, K] outputs (backend
    ``"xla"``): the JAX ``_bbh_local``.  Exact scores per (row, slot);
    candidates come in ascending gene order, so each unordered cell is
    emitted once from its lower-id row (``cand > grow``).  A generator
    (see :func:`_bbh_core`); returns what :func:`_bbh_flat_program`
    returns."""
    K = cand.shape[-1]
    gf = grow.reshape(-1).long()
    cf = cand.reshape(-1, K).long()
    inter_rk = inter.reshape(-1, K)
    perc_rk = perc.reshape(-1, K)
    tr_rk = tr.reshape(-1, K)
    valid_rk = valid.reshape(-1, K)
    G_pad = lens.shape[0]
    lenA = lens[torch.clamp(gf, max=G_pad - 1)]  # [P]
    lenB = lens[cf]  # [P, K]
    union = lenA[:, None] + lenB - inter_rk
    one = torch.ones_like(inter_rk)
    zero = torch.zeros_like(inter_rk)
    score = exact_div_f32(torch.maximum(inter_rk, one),
                          torch.maximum(union, one))
    score = torch.where(valid_rk & (inter_rk > 0), score, zero)
    with_stats = n_gen <= 128 and not _no_stats()
    if with_stats:
        ap = torch.where(perc_rk > 0, exact_div_f32(
            torch.maximum(perc_rk, one),
            torch.maximum(lenA[:, None], one)), zero)
        atp = torch.where(tr_rk > 0, exact_div_f32(
            torch.maximum(tr_rk, one), torch.maximum(lenB, one)), zero)
    else:
        ap = atp = score
    accept, intra, acc_cell, mats = yield from _bbh_core(
        score, gf, cf, ap, atp, inv_perm, genome_of, n_gen, with_stats,
        valid=valid_rk,
    )
    emask = (accept | intra) & (cf > gf[:, None])
    e_row, e_col, e_inter, e_acc, n_edges, edge_cap = yield from (
        _emit_program(emask, accept, gf, cf,
                      lambda flat: inter_rk.reshape(-1)[flat], edge_cap))
    counts_out = {
        "n_edges": n_edges,
        "n_valid": int((score > 0).sum()),
        "n_inter": int(acc_cell.sum()),
        "n_intra": int(intra.sum()),
    }
    return e_row, e_col, e_inter, e_acc, counts_out, mats, edge_cap


def _bbh_flat_program(grow, cand, counts, pi, pj, fi, fp, ft, fv,
                      inv_perm, lens, genome_of, n_gen: int, edge_cap: int,
                      steps: int = 1):
    """One shard's flat-pair BBH (backend ``"cuda"``): exact scores once
    per flat pair, re-expanded to the [rows, K] maxima structure by one
    gather; the emitted cells' counters are read from the flat arrays at
    their flat positions.  ``steps > 1``: the ring layout (a leading
    ring-step axis on grow, cand and counts; see :func:`_bbh_core`).  A
    generator; returns the emitted cells (canonical col > row, padded to
    ``edge_cap`` with row -1), the cell counts and the genome-pair
    matrices, and the final ``edge_cap``."""
    dev = fi.device
    K = cand.shape[-1]
    gf = grow.reshape(-1).long()
    cf = cand.reshape(-1, K).long()
    nf = counts.reshape(-1).long()
    nf = torch.where(nf > K, torch.zeros_like(nf), nf)
    cs = torch.cumsum(nf, 0)
    base = cs - nf  # exclusive cumsum: the layout flatten_join used
    n_flat = fi.shape[0]
    G_pad = lens.shape[0]

    lenA = lens[torch.clamp(pi.long(), max=G_pad - 1)]
    lenB = lens[torch.clamp(pj.long(), max=G_pad - 1)]
    union = lenA + lenB - fi
    one = torch.ones_like(fi)
    score_f = exact_div_f32(torch.maximum(fi, one), torch.maximum(union, one))
    # score > 0 encodes exactly "validity-passing cell with shared k-mers"
    # (library.cpp:499-512), the only predicate BBH needs
    zero_f = torch.zeros_like(score_f)
    score_f = torch.where(fv & (fi > 0), score_f, zero_f)

    sidx = torch.arange(K, device=dev)[None, :]
    slot_ok = sidx < nf[:, None]
    idx = torch.clamp(base[:, None] + sidx, max=n_flat - 1)
    zeros_rk = torch.zeros(cf.shape, dtype=torch.float32, device=dev)
    score = torch.where(slot_ok, score_f[idx], zeros_rk)  # [P, K]
    # past 128 genomes only the edge-critical ims matrix is aggregated;
    # the O(n_gen^2) stats matrices are print-only diagnostics
    # (Pangenes.java:130-143) and the host path degrades the same way
    with_stats = n_gen <= 128 and not _no_stats()
    if with_stats:
        # perc/tr fractions as exact IEEE quotients (host parity)
        apf = torch.where(
            fp > 0, exact_div_f32(torch.maximum(fp, one),
                                  torch.maximum(lenA, one)), zero_f)
        atpf = torch.where(
            ft > 0, exact_div_f32(torch.maximum(ft, one),
                                  torch.maximum(lenB, one)), zero_f)
        ap = torch.where(slot_ok, apf[idx], zeros_rk)
        atp = torch.where(slot_ok, atpf[idx], zeros_rk)
    else:
        ap = atp = score
    accept, intra, acc_cell, mats = yield from _bbh_core(
        score, gf, cf, ap, atp, inv_perm, genome_of, n_gen, with_stats,
        steps=steps)
    # canonical emission (intra already is; accept is symmetric)
    emask = (accept | intra) & (cf > gf[:, None])

    def inter_at(flat):
        return fi[torch.clamp(base[flat // K] + (flat % K), max=n_flat - 1)]

    e_row, e_col, e_inter, e_acc, n_edges, edge_cap = yield from (
        _emit_program(emask, accept, gf, cf, inter_at, edge_cap))
    counts_out = {
        "n_edges": n_edges,
        "n_valid": int((score_f > 0).sum()),
        "n_inter": int(acc_cell.sum()),
        "n_intra": int(intra.sum()),
    }
    return e_row, e_col, e_inter, e_acc, counts_out, mats, edge_cap


def compute_network_device(
    index: KmerIndex, config: Optional[PipelineConfig] = None, device=None,
    capture: Optional[dict] = None, devices=None,
):
    """Candidate engine + on-device BBH, its rows sharded over
    ``config.n_devices`` shards (``devices``: explicit placement, see
    :func:`~pandelos_tpu_torch.parallel.shards.resolve_shards`).
    Returns (edges, stats) with edges as canonical (a, b, host-exact f32
    score), or None when a pathological candidate overflow (a cap above
    ``MAX_CANDIDATE_CAP``) needs the host cells path.

    Extraction runs with ``upper_only=False`` (each cell on both its
    rows) so the per-row maxima are complete; on candidate-cap overflow
    the whole extraction reruns at the next power-of-two cap.  With
    ``config.ring_extract`` under backend ``"cuda"`` over two shards or
    more (:func:`~pandelos_tpu_torch.config.ring_engaged`) the extraction
    shards and rotates the signatures (``ops/ring.py``) and the BBH takes
    its step-axis outputs; otherwise the replicated engine runs, as in
    the JAX package, and ``stats["ring_extract"]`` says which ran.

    Backend ``"cuda"`` joins each shard's flat pair list with its join
    kernel; backend ``"xla"`` joins inside the extraction (at the whole
    padded width) and runs the BBH on the [rows, K] outputs.  Each shard
    runs its own rows; the per-row maxima and the genome-pair matrices
    merge over every shard (and process) by collectives.

    ``capture``, when given, receives the runner and the extraction
    layout, and under backend ``"cuda"`` the join's kernel name, inputs
    and outputs of the first local shard (the table that kernel read,
    depths, pair lists, counters), so that a caller can check and time
    the kernel and the bound bits at the shapes of this run, and every
    shard's pair total (``pairs_per_shard``)."""
    from pandelos_tpu_torch.parallel.shards import resolve_shards

    config = config or PipelineConfig()
    check_ported(config)
    G = index.n_sequences
    if G == 0 or index.profile_ids.size == 0:
        return [], {"n_cells": 0}
    shards = resolve_shards(config, device, devices)
    dev = shards.devices[0]
    configure_numerics()
    # ring_extract under another backend or on one shard: the replicated
    # engine, as in the JAX package
    use_ring = ring_engaged(config, shards.n)

    _trace = os.environ.get("PT_TIMING") == "1"
    _t0 = time.monotonic()
    _phase_s = {}

    def _mark(label):
        nonlocal _t0
        for d in set(shards.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        dt = time.monotonic() - _t0
        _phase_s[label.split("(")[0]] = round(dt, 4)
        if _trace:
            print(f"[pt:bbh] {label}: {dt:.2f}s", flush=True)
        _t0 = time.monotonic()

    check_hbm_fit(index, config, dev, ring=use_ring, n_devices=shards.n)
    row_block = min(config.row_block, _round_up(G, 8))
    col_block = min(config.col_block, _round_up(G, 128))
    padded = pad_profiles(index, row_block, col_block)
    _mark("setup.pad_profiles")
    G_pad = padded.ids.shape[0]
    if use_ring and G_pad % shards.n:
        raise ValueError(
            f"G_pad={G_pad} not divisible by n_devices={shards.n}; "
            f"choose a col_block divisible by the device count")

    runner = get_runner(index, padded, config, shards)
    _mark("setup.runner(upload)")
    if not use_ring:
        # the ring builds each shard's signatures in its own program
        sig_mass, _, _ = build_signatures(
            index, padded, runner.all_ids, runner.all_counts
        )
        runner.set_sig(sig_mass)
    _mark("setup.signatures")

    widths = np.diff(index.profile_ptr)
    perm = np.argsort(widths, kind="stable").astype(np.int32)
    n_blocks = -(-G // row_block)
    perm_pad = np.full(n_blocks * row_block, G, dtype=np.int32)
    perm_pad[:G] = perm
    perm_ext = np.concatenate(
        [perm_pad, np.full(row_block, G, dtype=np.int32)]
    )
    starts = np.arange(0, n_blocks * row_block, row_block, np.int32)

    K = config.candidate_cap
    # backend "xla" joins inside the extraction ([rows, K] counters, no
    # join kernel, no bound bits), as the JAX package gates both on its
    # pallas backend
    use_kernel = resolve_backend(config.backend) == "cuda"
    use_T = use_kernel and runner.use_bound_bits(len(starts), row_block)
    grow_h = runner.grow_layout(perm_ext, starts, row_block)  # [S*n, R]
    steps = shards.n if use_ring else 1
    while True:
        if use_ring:
            from pandelos_tpu_torch.ops.ring import ring_extract

            outs = ring_extract(runner, perm_ext, starts, row_block, K,
                                upper_only=False)
            # [steps, S*n, R]: the step axis leads, rows are sharded
            counts_h = shards.fetch([o[2] for o in outs], axis=1)
        else:
            outs = runner.extract_shards(
                perm_ext, starts, row_block, padded.width, K,
                do_join=not use_kernel, upper_only=False, from_T=use_T,
            )
            counts_h = shards.fetch([o[-1] for o in outs])
        grow_v = np.broadcast_to(grow_h, counts_h.shape)
        over = (counts_h > K) & (grow_v < G)
        if not np.any(over):
            break
        K = _next_pow2(int(counts_h[over].max()))
        if K > MAX_CANDIDATE_CAP:
            return None  # pathological: the host cells path
    _mark(f"extract(K={K})")
    if capture is not None:
        capture.update(runner=runner, perm_ext=perm_ext, starts=starts,
                       row_block=row_block, use_T=use_T)

    # every shard's flat pair total: rows are sharded on the S*n axis
    nf_cap = np.minimum(counts_h, K).reshape(steps, shards.n, -1)
    per_shard = nf_cap.sum(axis=(0, 2), dtype=np.int64)
    pair_cap = None
    if use_kernel:
        pair_cap = runner.pair_capacity_from_worst(
            int(per_shard.max(initial=0)))
        flat = runner.flatten_join_shards(outs, K, pair_cap)
        if capture is not None:
            fpi, fpj, fi, fp, ft, _ = flat[0]
            capture.update(
                join_kernel=runner.join_kernel, table=runner.join_table,
                dg=runner.dg, pi=fpi, pj=fpj, inter=fi, perc=fp, tr=ft,
            )
        _mark(f"flatten_join(pair_cap={pair_cap})")
    if capture is not None:
        capture["pairs_per_shard"] = per_shard

    # gene -> global row position (the all_gather row order)
    rows_h = grow_h.reshape(-1)
    inv_perm = np.zeros(G_pad, dtype=np.int32)
    real = rows_h < G
    inv_perm[rows_h[real]] = np.flatnonzero(real).astype(np.int32)
    lens_pad = np.zeros(G_pad, dtype=np.float32)
    lens_pad[:G] = index.kseq_lengths
    genome_pad = np.zeros(G_pad, dtype=np.int32)
    genome_pad[:G] = index.seq_genome
    n_gen = index.n_genomes

    # every emitted cell is valid and valid pairs pass the bound in both
    # orientations, so emitted cells <= half the candidate slots (on one
    # shard; a shard's mirror slots can sit elsewhere, and the cap grows
    # past the largest shard's count)
    edge_cap = max(
        1 << 14, _next_pow2(int(per_shard.max(initial=0)) // 2 + 1)
    )
    # test hook: a small initial cap makes the doubling step run
    cap_env = os.environ.get("PANDELOS_EDGE_CAP_INIT")
    if cap_env:
        edge_cap = _next_pow2(int(cap_env))
    edge_cap_initial = edge_cap
    tails = zip(shards.replicate(inv_perm), shards.replicate(lens_pad),
                shards.replicate(genome_pad))
    if use_kernel:
        programs = [
            _bbh_flat_program(*o, *f, *t, n_gen, edge_cap, steps=steps)
            for o, f, t in zip(outs, flat, tails)]
    else:
        programs = [_bbh_program(*o[:-1], *t, n_gen, edge_cap)
                    for o, t in zip(outs, tails)]
    results = shards.spmd(programs)
    edge_cap = results[0][6]
    mats = results[0][5]  # merged over every shard
    n_by_shard = shards.fetch([
        torch.tensor([[r[4][k] for k in ("n_edges", "n_valid", "n_inter",
                                          "n_intra")]], device=d)
        for r, d in zip(results, shards.devices)])
    n_edges_max = int(n_by_shard[:, 0].max())
    n_valid, n_acc_canonical, _ = (int(x) for x in n_by_shard[:, 1:].sum(0))
    _mark(f"bbh(edge_cap={edge_cap})")

    # --- ship the accepted cells: bit-packed to 8 bytes per cell when
    # they fit ((row+1) << 16 | col and inter << 1 | acc), and sliced to
    # the largest shard's edge count
    pack_ok = (
        G < 65535
        and int(np.asarray(index.kseq_lengths).max(initial=0)) < 2**24
        # test hook: force the unpacked fetch branch at small G
        and os.environ.get("PANDELOS_NO_EDGE_PACK") != "1"
    )
    ims, gmin_s, gmin_p, gmax_p = (m.cpu().numpy() for m in mats)
    n_fetch = min(edge_cap, _round_up(n_edges_max + 1, 4096))
    cut = [[x[:n_fetch] for x in r[:4]] for r in results]
    if pack_ok:
        packed = []
        for r, c, i, acc in cut:
            # int64 on the device, cut to the low 32 bits for the transfer
            # (the host reads them back as uint32)
            rc_d = torch.where(r >= 0, ((r + 1) << 16) | c,
                               torch.zeros_like(r))
            ia_d = (i.to(torch.int64) << 1) | acc.to(torch.int64)
            packed.append((rc_d.to(torch.int32), ia_d.to(torch.int32)))
        rc_h, ia_h = shards.fetch_many(*zip(*packed))
        rc_u = rc_h.view(np.uint32)
        keep_mask = rc_u != 0
        e_row = np.where(keep_mask, (rc_u >> 16).astype(np.int64) - 1, -1)
        e_col = (rc_u & 0xFFFF).astype(np.int64)
        e_inter = (ia_h >> 1).astype(np.int64)
        e_acc = (ia_h & 1).astype(bool)
    else:
        e_row, e_col, e_inter, e_acc = shards.fetch_many(*zip(*cut))
    keep = e_row >= 0
    e_row = e_row[keep].astype(np.int64)
    e_col = e_col[keep].astype(np.int64)
    e_inter = e_inter[keep].astype(np.int64)
    # union from the exact integer kseq lengths (|A| + |B| - inter); the
    # device accept used f32 lengths, exact below 2^24
    assert int(np.asarray(index.kseq_lengths).max(initial=0)) < 2**24
    assert int(e_row.max(initial=-1)) < G and int(e_col.max(initial=-1)) < G
    lens_i64 = np.asarray(index.kseq_lengths, np.int64)
    e_union = lens_i64[e_row] + lens_i64[e_col] - e_inter
    e_acc = e_acc[keep]
    _mark(f"fetch(edges={int(keep.sum())})")

    # host-exact f32 scores.  Each cell was emitted once (canonical col >
    # row, from the one shard holding its lower-id row; under the ring,
    # from the one step holding its column), so the keys are unique and
    # an argsort orders them (the JAX package's np.unique over its
    # shards' cells finds nothing to drop)
    scores = e_inter.astype(np.float32) / e_union.astype(np.float32)
    a = np.minimum(e_row, e_col)
    b = np.maximum(e_row, e_col)
    key = (a << np.int64(32)) | b
    first = np.argsort(key, kind="stable")
    uk = key[first]
    assert not np.any(uk[1:] == uk[:-1]), "a cell was emitted twice"
    edges = EdgeList(
        uk >> np.int64(32),
        uk & np.int64(0xFFFFFFFF),
        scores[first].astype(np.float64),
    )
    _mark("host.edges")

    # genome-pair statistics (net.py build_network's aggregates,
    # Pangenes.java:130-143): min/max families from the device over the
    # canonical accepted cells, mirrored as (m op m.T); mean/count here
    stats = {
        "n_cells": n_valid,
        "n_accepted_inter_cells": 2 * n_acc_canonical,
        "n_inter_edges": int(e_acc.sum()),
        "n_intra_edges": int((~e_acc).sum()),
        "n_edges": len(edges),
        "n_joined_pairs": int(
            np.minimum(counts_h, K)[grow_v < G].sum(dtype=np.int64)),
        "device_bbh": True,
        "ring_extract": use_ring,
        "device": str(dev),
        "n_devices": shards.n,
        "phase_s": dict(_phase_s),
        "candidate_cap_final": int(K),
        "bound_bits_mode": bool(use_T),
        "edge_cap_initial": int(edge_cap_initial),
        # backend "xla" has no flat pair list and no join table (None, as
        # in the JAX package)
        "pair_cap": int(pair_cap) if use_kernel else None,
        "lane_D": int(runner.lane_D) if use_kernel else None,
        "join_kernel": runner.join_kernel if use_kernel else None,
        # only when the lane2 table exists: under lane or roll, building
        # it would cost memory for nothing (and cannot pack when the
        # input forced the lane fallback)
        "lane_table_cols": (
            int(runner.all_lane2.shape[1])
            if use_kernel and runner.join_kernel == "lane2" else None
        ),
        "edge_cap": int(edge_cap),
    }
    if shards.n > 1 or shards.group is not None:
        stats["pairs_per_shard"] = per_shard.tolist()
    if n_gen <= 128 and not _no_stats() and n_acc_canonical > 0:
        acc_i = e_row[e_acc]
        acc_j = e_col[e_acc]
        asc = scores[e_acc].astype(np.float64)
        sg = np.asarray(index.seq_genome)
        bins = sg[acc_i] * n_gen + sg[acc_j]
        S = np.bincount(bins, weights=asc, minlength=n_gen * n_gen)
        C = np.bincount(bins, minlength=n_gen * n_gen)
        gp_sum = S.reshape(n_gen, n_gen)
        gp_sum = gp_sum + gp_sum.T
        gp_cnt = C.reshape(n_gen, n_gen).astype(np.int64)
        gp_cnt = gp_cnt + gp_cnt.T
        # device matrices carry the neutrals (+inf / 0) at empty entries;
        # the reference inits everything at 1.0, and max_perc's init
        # dominates (perc fractions <= 1.0 — the host-path quirk)
        gp_min = np.minimum(np.minimum(gmin_s, gmin_s.T), np.float32(1.0))
        gp_minp = np.minimum(np.minimum(gmin_p, gmin_p.T), np.float32(1.0))
        gp_maxp = np.maximum(np.maximum(gmax_p, gmax_p.T), np.float32(1.0))
        with np.errstate(invalid="ignore"):
            gp_mean = np.where(gp_cnt > 0, gp_sum / np.maximum(gp_cnt, 1), 0.0)
        stats["genome_pairs"] = {
            "mean_score": gp_mean.round(6).tolist(),
            "min_score": gp_min.astype(float).tolist(),
            "max_score_lt1": ims.astype(float).tolist(),
            "min_perc": gp_minp.astype(float).tolist(),
            "max_perc": gp_maxp.astype(float).tolist(),
            "accepted_cells": gp_cnt.tolist(),
        }
    _mark("host.stats")
    return edges, stats
