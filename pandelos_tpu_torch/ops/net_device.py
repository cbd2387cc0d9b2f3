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
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pandelos_tpu_torch import tracing
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
    MemoryPlan,
    _next_pow2,
    build_signatures,
    cached_runner,
    get_runner,
    rows_layout,
)
from pandelos_tpu_torch.ops.exact_div import exact_div_f32
from pandelos_tpu_torch.ops.score import _round_up, pad_profiles

# the most joined pairs whose lists a run keeps for its caller
# (``capture``): 20 bytes a pair on the card
CAPTURE_PAIRS = 1 << 28


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


class _Seg(NamedTuple):
    """One segment of a shard's rows for the BBH: exact scores [P, K]
    (0 where the cell is not a valid one with shared k-mers), the row
    and candidate gene ids, the perc/tr fractions (the scores when the
    stats are off), the validity that also gates both tests (or None),
    the ring steps its rows repeat over, and ``inter_of``, which maps
    flat [P * K] positions to the cells' intersections."""

    score: torch.Tensor
    gf: torch.Tensor
    cf: torch.Tensor
    ap: torch.Tensor
    atp: torch.Tensor
    valid: Optional[torch.Tensor]
    steps: int
    inter_of: Callable


def _emit(parts, edge_cap: int):
    """The emitted cells of each segment's ``emask`` [P, K] in row-major
    order, one segment after another, padded to ``edge_cap`` (doubled
    past the emitted count, as the JAX retry loop does) with row -1:
    (e_row, e_col, e_inter, e_acc, n_edges, edge_cap).  ``parts``: (emask,
    accept, gf, cf, inter_of) a segment (see :class:`_Seg`)."""
    rows, cols, inters, accs = [], [], [], []
    for emask, accept, gf, cf, inter_of in parts:
        K = cf.shape[1]
        with tracing.blocked():
            (eidx,) = torch.nonzero(emask.reshape(-1), as_tuple=True)
        rows.append(gf[eidx // K])
        cols.append(cf.reshape(-1)[eidx])
        inters.append(inter_of(eidx))
        accs.append(accept.reshape(-1)[eidx])
    n_edges = sum(int(r.shape[0]) for r in rows)
    while n_edges > edge_cap:
        edge_cap = _next_pow2(n_edges)
    fill = edge_cap - n_edges

    def padded(xs, value):
        return torch.cat(xs + [torch.full((fill,), value, dtype=xs[0].dtype,
                                          device=xs[0].device)])

    return (padded(rows, -1), padded(cols, 0), padded(inters, 0),
            padded(accs, False), n_edges, edge_cap)


def _bbh_core(segs, inv_perm, genome_of, n_gen: int, with_stats: bool):
    """The BBH and paralog filters over the segments' exact scores (see
    :class:`_Seg`): the per-(row, genome) maxima, the accepted
    inter-genome cells, the genome-pair matrices and the intra-genome
    cells (Pangenes.java:98-176).  A segment holds every candidate of
    each of its rows: the main extraction's rows, then those of the
    heavy-row pass (each row's candidates in one segment).

    A generator, one shard's program (:meth:`ShardGroup.spmd`): it
    yields at its two collectives, the tiled ``all_gather`` of the
    per-row maxima, every segment's in turn (every shard needs every
    row's for the both-endpoint test, the reference's ``col_max_scores``
    merge, library.cpp:515), and the ``pmax``/``pmin`` of the genome-pair
    matrices.  ``inv_perm`` maps a gene to its GLOBAL row position in
    that gathered order.  ``steps > 1`` is the ring composition: a
    segment's rows are ``steps`` copies of its real rows (one a ring
    step, each holding that step's column shard's candidates), so the
    maxima and the row threshold merge over the step axis first.
    Returns ([(accept, intra, acc_cell) a segment], (ims, gmin_s,
    gmin_p, gmax_p))."""
    G_pad = genome_of.shape[0]
    pre = []
    for sg in segs:
        g_i = genome_of[torch.clamp(sg.gf, max=G_pad - 1)].long()
        g_j = genome_of[sg.cf].long()
        (M_virt,) = _chunked_genome_multi([(sg.score, "max")], g_j, n_gen)
        # a real row's maxima span every ring step (column shard)
        SR = sg.score.shape[0] // sg.steps
        M_row = M_virt if sg.steps == 1 else (
            M_virt.view(sg.steps, SR, n_gen).amax(0))
        pre.append((g_i, g_j, M_row))
    M = yield ("all_gather", pre[0][2] if len(pre) == 1
               else torch.cat([m for _, _, m in pre]))
    cells, mats = [], None
    for sg, (g_i, g_j, M_row) in zip(segs, pre):
        score, gf, cf = sg.score, sg.gf, sg.cf
        M_grid = M_row if sg.steps == 1 else M_row.repeat(sg.steps, 1)
        jpos = inv_perm[cf].long()
        M_at_gj = torch.gather(M_grid, 1, g_j)  # M[row, gen(j)]
        M_j_gi = M[jpos, g_i[:, None].expand_as(jpos)]  # M[j, genome(i)]
        inter_genome = g_j != g_i[:, None]
        base = (score > 0) & (score == M_at_gj) & (score == M_j_gi)
        if sg.valid is not None:
            base = base & sg.valid
        accept = base & inter_genome
        lt1v = torch.where(accept & (score < 1.0), score,
                           torch.zeros_like(score))
        acc_cell = accept & (cf > gf[:, None])
        m = _ims_and_aggregates(lt1v, acc_cell, score, sg.ap, sg.atp, g_i,
                                g_j, n_gen, with_stats)
        mats = m if mats is None else (
            torch.maximum(mats[0], m[0]), torch.minimum(mats[1], m[1]),
            torch.minimum(mats[2], m[2]), torch.maximum(mats[3], m[3]))
        cells.append((base, accept, acc_cell, inter_genome))
    ims, gmax_p = (yield ("pmax", torch.stack([mats[0], mats[3]]))).unbind(0)
    gmin_s, gmin_p = (
        yield ("pmin", torch.stack([mats[1], mats[2]]))).unbind(0)
    out = []
    for sg, (g_i, g_j, _), (base, accept, acc_cell, inter_genome) in zip(
            segs, pre, cells):
        thr_cell = ims[g_i[:, None].expand_as(g_j), g_j]
        row_thr = torch.where(
            accept, thr_cell, torch.full_like(thr_cell, float("inf"))
        ).amin(1)
        if sg.steps > 1:
            # the threshold spans the row's accepted cells in every step
            SR = sg.score.shape[0] // sg.steps
            row_thr = row_thr.view(sg.steps, SR).amin(0).repeat(sg.steps)
        intra = (
            base
            & (~inter_genome)
            & (sg.gf[:, None] < sg.cf)
            & (sg.score >= row_thr[:, None])
        )
        out.append((accept, intra, acc_cell))
    return out, (ims, gmin_s, gmin_p, gmax_p)


def _emit_program(segs, cells, edge_cap: int):
    """:func:`_emit` of the segments' canonical cells (col > row; intra
    already is, accept is symmetric) at an edge cap every shard shares:
    the initial cap, or past the largest shard's emitted count its next
    power of two (the JAX retry loop's cap).  A generator (one
    collective)."""
    parts = [((accept | intra) & (sg.cf > sg.gf[:, None]), accept, sg.gf,
              sg.cf, sg.inter_of)
             for sg, (accept, intra, _) in zip(segs, cells)]
    total = parts[0][0].sum()
    for part in parts[1:]:
        total = total + part[0].sum()
    n_edges = tracing.to_int(total)
    most = yield ("max_int", n_edges)
    if most > edge_cap:
        edge_cap = _next_pow2(most)
    return _emit(parts, edge_cap)


def _dense_seg(grow, cand, inter, perc, tr, valid, lens,
               with_stats: bool) -> _Seg:
    """A segment from [rows, K] exact counters and validity (the in-scan
    join's outputs, or the heavy-row pass's valid cells): the JAX
    ``_bbh_local``'s scores, exact per (row, slot)."""
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
    if with_stats:
        ap = torch.where(perc_rk > 0, exact_div_f32(
            torch.maximum(perc_rk, one),
            torch.maximum(lenA[:, None], one)), zero)
        atp = torch.where(tr_rk > 0, exact_div_f32(
            torch.maximum(tr_rk, one), torch.maximum(lenB, one)), zero)
    else:
        ap = atp = score
    return _Seg(score, gf, cf, ap, atp, valid_rk, 1,
                lambda flat: inter_rk.reshape(-1)[flat])


def _with_stats(n_gen: int) -> bool:
    # past 128 genomes only the edge-critical ims matrix is aggregated;
    # the O(n_gen^2) stats matrices are print-only diagnostics
    # (Pangenes.java:130-143) and the host path degrades the same way
    return n_gen <= 128 and not _no_stats()


def _bbh_result(segs, cells, edge_cap):
    """The emission and cell counts after :func:`_bbh_core` (a
    generator): what :func:`_bbh_flat_program` returns, less the matrices
    and the count of valid cells."""
    e_row, e_col, e_inter, e_acc, n_edges, edge_cap = yield from (
        _emit_program(segs, cells, edge_cap))
    n_inter = n_intra = 0
    for _, intra, acc_cell in cells:
        n_inter = n_inter + acc_cell.sum()
        n_intra = n_intra + intra.sum()
    counts_out = {"n_edges": n_edges, "n_inter": tracing.to_int(n_inter),
                  "n_intra": tracing.to_int(n_intra)}
    return (e_row, e_col, e_inter, e_acc), counts_out, edge_cap


def _bbh_program(grow, cand, inter, perc, tr, valid, inv_perm, lens,
                 genome_of, n_gen: int, edge_cap: int, extra=()):
    """One shard's BBH over the in-scan join's [rows, K] outputs (backend
    ``"xla"``): the JAX ``_bbh_local``; ``extra``: further segments'
    (grow, cand, inter, perc, tr, valid), the heavy-row pass's valid
    cells.  Each unordered cell is emitted once from its lower-id
    row (``cand > grow``).  A generator (see :func:`_bbh_core`); returns
    what :func:`_bbh_flat_program` returns."""
    with_stats = _with_stats(n_gen)
    segs = [_dense_seg(*seg, lens, with_stats)
            for seg in [(grow, cand, inter, perc, tr, valid), *extra]]
    cells, mats = yield from _bbh_core(segs, inv_perm, genome_of, n_gen,
                                       with_stats)
    emitted, counts_out, edge_cap = yield from _bbh_result(segs, cells,
                                                           edge_cap)
    n_valid = (segs[0].score > 0).sum()
    for sg in segs[1:]:
        n_valid = n_valid + (sg.score > 0).sum()
    counts_out["n_valid"] = tracing.to_int(n_valid)
    return (*emitted, counts_out, mats, edge_cap)


def _bbh_flat_program(grow, cand, counts, pi, pj, fi, fp, ft, fv,
                      inv_perm, lens, genome_of, n_gen: int, edge_cap: int,
                      steps: int = 1, extra=()):
    """One shard's flat-pair BBH (backend ``"cuda"``): exact scores once
    per flat pair, re-expanded to the [rows, K] maxima structure by one
    gather; the emitted cells' counters are read from the flat arrays at
    their flat positions.  ``steps > 1``: the ring layout (a leading
    ring-step axis on grow, cand and counts; see :func:`_bbh_core`).
    ``extra``: further segments as :func:`_bbh_program` takes them (the
    heavy-row pass's valid cells).  A generator; returns the emitted
    cells (canonical col > row, padded to ``edge_cap`` with row -1), the
    cell counts and the genome-pair matrices, and the final
    ``edge_cap``."""
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
    with_stats = _with_stats(n_gen)
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
    del slot_ok, idx, zeros_rk  # [P, K] each, not held through the BBH

    def inter_at(flat):
        return fi[torch.clamp(base[flat // K] + (flat % K), max=n_flat - 1)]

    segs = [_Seg(score, gf, cf, ap, atp, None, steps, inter_at)]
    segs += [_dense_seg(*seg, lens, with_stats) for seg in extra]
    cells, mats = yield from _bbh_core(segs, inv_perm, genome_of, n_gen,
                                       with_stats)
    emitted, counts_out, edge_cap = yield from _bbh_result(segs, cells,
                                                           edge_cap)
    n_valid = (score_f > 0).sum()
    for sg in segs[1:]:
        n_valid = n_valid + (sg.score > 0).sum()
    counts_out["n_valid"] = tracing.to_int(n_valid)
    return (*emitted, counts_out, mats, edge_cap)


def _heavy_pass(index, runner, shards, over_rows, over_counts,
                plan: MemoryPlan, slots: int, row_block: int, steps: int,
                use_kernel: bool, extract, sp, keep_joined: bool):
    """The heavy-row pass (span ``extract.heavy``, ``sp``): the rows whose
    candidates passed the main extraction's cap (``over_rows``, with each
    overflowing (row, ring step)'s count in ``over_counts``), most
    candidates first, extracted again on the card by ``extract`` (the
    main pass's) in chunks, each at its first row's count rounded up to
    128 and of at most ``slots`` slots (the main extraction's), each
    planned before it runs (:meth:`MemoryPlan.heavy`, which raises
    ``MemoryError`` where the card cannot hold it); each chunk's pairs
    are joined (the join kernel under ``"cuda"``, else the in-scan join)
    and only its valid cells kept.

    Returns the heavy rows, each global shard's heavy rows [n, H] (the
    segment's ``all_gather`` layout), each local shard's segment of their
    valid cells (:func:`_heavy_segment`), the pairs joined, and with
    ``keep_joined`` shard 0's joined pair lists (pi, pj, inter, perc, tr)
    under ``"cuda"``, or None past ``CAPTURE_PAIRS`` pairs."""
    G = index.n_sequences
    heavy = np.unique(over_rows)
    most = np.zeros(len(heavy), np.int64)  # over the ring steps
    np.maximum.at(most, np.searchsorted(heavy, over_rows), over_counts)
    order = np.argsort(-most, kind="stable")
    sp.set("rows", len(heavy))
    sp.set("K", _round_up(int(most.max()), 128))  # the first chunk's
    layouts, cells = [], [[] for _ in shards.devices]
    joined0 = [] if keep_joined else None
    pairs, start, kept = 0, 0, 0
    while start < len(order):
        K = _round_up(int(most[order[start]]), 128)
        n = max(row_block, slots // K // row_block * row_block)
        plan.heavy(n, K, kept)
        rows = heavy[order[start:start + n]]
        start += n
        sp.add("chunks", 1)
        perm, starts = rows_layout(rows, row_block, G)
        layouts.append(runner.grow_layout(perm, starts, row_block)
                       .reshape(shards.n, -1))
        outs, counts = extract(perm, starts, K, False)
        pairs += int(counts.sum(dtype=np.int64))
        for mine, found in zip(cells, _chunk_cells(
                runner, shards, outs, counts, K, steps, use_kernel,
                joined0)):
            mine.append(found)
            kept += sum(x.numel() * x.element_size() for x in found)
        if joined0 is not None and pairs > CAPTURE_PAIRS:
            joined0 = None  # too many to keep for the caller
    sp.set("pairs", pairs)
    layout = np.concatenate(layouts, axis=1)
    segs = _heavy_segment(cells, layout, shards, runner.G_pad, G)
    return heavy, layout, segs, pairs, joined0


def _chunk_cells(runner, shards, outs, counts, K: int, steps: int,
                 use_kernel: bool, joined0) -> list:
    """A heavy chunk's valid cells on each local shard, (row gene, column
    gene, inter, perc, tr): its extraction ``outs`` at cap ``K`` (counts
    on the host) joined by the join kernel under ``"cuda"`` (shard 0's
    pair lists appended to ``joined0`` unless None), or read from the
    in-scan join's outputs."""
    G = runner.G
    if use_kernel:
        per_shard = counts.reshape(steps, shards.n, -1).sum(
            axis=(0, 2), dtype=np.int64)
        pair_cap = runner.pair_capacity_from_worst(int(per_shard.max()))
        flat = runner.flatten_join_shards(outs, K, pair_cap)
        if joined0 is not None:
            joined0.append(flat[0][:5])
        found = [(pi, pj, inter, perc, tr, valid & (pi < G))
                 for pi, pj, inter, perc, tr, valid in flat]
    else:
        found = [(grow.reshape(-1, 1).expand(-1, K), cand, inter, perc, tr,
                  valid)
                 for grow, cand, inter, perc, tr, valid, _ in outs]
    out = []
    for *xs, keep in found:
        with tracing.blocked():
            (at,) = torch.nonzero(keep.reshape(-1), as_tuple=True)
        out.append([x.reshape(-1)[at] for x in xs])
    return out


def _heavy_segment(cells, layout, shards, G_pad: int, G: int) -> list:
    """Each local shard's BBH segment of its heavy rows (``layout``, [n, H]
    gene ids, ``G`` for padding): (grow [H], cand [H, V], inter, perc,
    tr, valid [H, V]), V the most valid cells of a row over every shard,
    from ``cells``: a local shard's valid cells as lists of (row gene,
    column gene, inter, perc, tr), each row's in ascending slot order."""
    H = layout.shape[1]
    local = [[torch.cat(x) for x in zip(*c)] for c in cells]
    pos, widths = [], []
    for (i, dev), (gi, *_) in zip(enumerate(shards.devices), local):
        rows = layout[shards.first + i]
        at = np.zeros(G_pad, np.int64)  # gene -> its row of the segment
        at[rows[rows < G]] = np.flatnonzero(rows < G)
        p = torch.from_numpy(at).to(dev)[gi.long()]
        pos.append(p)
        widths.append(tracing.to_int(torch.bincount(p, minlength=H).max()))
    V = max(1, shards.max_int(widths))
    out = []
    for (i, dev), (gi, gj, inter, perc, tr), p in zip(
            enumerate(shards.devices), local, pos):
        p, o = torch.sort(p, stable=True)
        n = torch.bincount(p, minlength=H)
        slot = torch.arange(p.numel(), device=dev) - (torch.cumsum(n, 0)
                                                      - n)[p]
        cand = torch.full((H, V), G, dtype=torch.int32, device=dev)
        cand[p, slot] = gj[o].to(torch.int32)
        counters = []
        for x in (inter, perc, tr):
            c = torch.zeros((H, V), dtype=torch.float32, device=dev)
            c[p, slot] = x[o].to(torch.float32)
            counters.append(c)
        valid = torch.zeros((H, V), dtype=torch.bool, device=dev)
        valid[p, slot] = True
        grow = torch.from_numpy(layout[shards.first + i]).to(dev)
        out.append((grow, cand, *counters, valid))
    return out


def _drop_heavy(outs, shards, heavy: np.ndarray, G_pad: int, K: int,
                use_kernel: bool) -> list:
    """The main extraction's local outputs with the heavy rows left out
    of every ring step: their counts past ``K`` (the flat pair list and
    the flat BBH skip such rows), or under the in-scan join their
    validity cleared."""
    flag = np.zeros(G_pad, dtype=bool)
    flag[heavy] = True
    out = []
    for o, f in zip(outs, shards.replicate(flag)):
        hit = f[o[0].long()]
        if use_kernel:
            grow, cand, counts = o
            out.append((grow, cand, counts.masked_fill(hit, K + 1)))
        else:
            *head, valid, counts = o
            out.append((*head, valid & ~hit[..., None], counts))
    return out


def compute_network_device(
    index: KmerIndex, config: Optional[PipelineConfig] = None, device=None,
    capture: Optional[dict] = None, devices=None,
):
    """Candidate engine + on-device BBH, its rows sharded over
    ``config.n_devices`` shards (``devices``: explicit placement, see
    :func:`~pandelos_tpu_torch.parallel.shards.resolve_shards`).
    Returns (edges, stats) with edges as canonical (a, b, host-exact f32
    score).

    Device memory is held to a stage-wise plan
    (:class:`~pandelos_tpu_torch.ops.candidate.MemoryPlan`) with two
    gates, each raising ``MemoryError`` naming the stage that cannot fit.
    Gate 1, before anything reaches the card, checks the stages that the
    shapes alone decide: signatures, profiles, the bound-bit matrix, the
    extraction's workspace and the join table.  Gate 2 plans the
    candidate work from the counts the extraction found: each heavy-row
    chunk before it runs, then (span ``plan``) the main rows' flat pass
    and the BBH beside the heavy rows' segment.

    Extraction runs with ``upper_only=False`` (each cell on both its
    rows) so the per-row maxima are complete; on candidate-cap overflow
    the whole extraction reruns at the next power-of-two cap, up to
    ``MAX_CANDIDATE_CAP``.  The rows whose candidates pass that
    (``extract.heavy``, :func:`_heavy_pass`) are extracted again on the
    card, alone, in chunks each at its own cap; they leave the main
    extraction's rows, and the BBH takes every valid cell of theirs as a
    segment of its own.  With
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
    shard's pair total (``pairs_per_shard``).

    The engine's sub-phases are spans of :mod:`pandelos_tpu_torch.tracing`
    under the caller's (``setup.pad_profiles``, ``setup.runner``,
    ``setup.signatures``, ``extract``, ``extract.heavy`` where a row
    passed the cap, ``plan``, ``flatten_join`` under ``"cuda"``, ``bbh``,
    ``fetch``, ``host.edges``, ``host.stats``); none
    synchronises the card.  ``stats["phase_s"]`` holds their seconds and
    ``wait``, the seconds the host spent blocked on the card within
    them."""
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

    # one span a sub-phase, each a child of the caller's; none syncs the
    # card: the host's waits on it are counted where it blocks
    spans = []

    def phase(name, **counters):
        sp = tracing.span(name, **counters)
        spans.append(sp)
        return sp

    with phase("setup.pad_profiles"):
        row_block = min(config.row_block, _round_up(G, 8))
        col_block = min(config.col_block, _round_up(G, 128))
        padded = pad_profiles(index, row_block, col_block)
        # gate 1: the stages the shapes alone decide, before anything
        # reaches the card
        plan = MemoryPlan(index, config, dev, shards.n, use_ring,
                          cached_runner(index, padded, config, shards))
        plan.check()
    G_pad = padded.ids.shape[0]
    if use_ring and G_pad % shards.n:
        raise ValueError(
            f"G_pad={G_pad} not divisible by n_devices={shards.n}; "
            f"choose a col_block divisible by the device count")

    with phase("setup.runner"):
        runner = get_runner(index, padded, config, shards)
    with phase("setup.signatures"):
        if not use_ring:
            # the ring builds each shard's signatures in its own program
            sig_mass, _, _ = build_signatures(
                index, padded, runner.all_ids, runner.all_counts
            )
            runner.set_sig(sig_mass)

    with phase("extract") as sp:
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
        # backend "xla" joins inside the extraction ([rows, K] counters,
        # no join kernel, no bound bits), as the JAX package gates both on
        # its pallas backend
        use_kernel = resolve_backend(config.backend) == "cuda"
        use_T = use_kernel and runner.use_bound_bits(len(starts), row_block)
        grow_h = runner.grow_layout(perm_ext, starts, row_block)  # [S*n, R]
        steps = shards.n if use_ring else 1

        def extract(perm_ext, starts, K, from_T):
            """One pass over the rows of (perm_ext, starts) at cap K: the
            local shards' outputs and the global counts on the host (under
            the ring [steps, S*n, R]: the step axis leads, rows are
            sharded)."""
            if use_ring:
                from pandelos_tpu_torch.ops.ring import ring_extract

                outs = ring_extract(runner, perm_ext, starts, row_block, K,
                                    upper_only=False)
                return outs, shards.fetch([o[2] for o in outs], axis=1)
            outs = runner.extract_shards(
                perm_ext, starts, row_block, padded.width, K,
                do_join=not use_kernel, upper_only=False, from_T=from_T,
            )
            return outs, shards.fetch([o[-1] for o in outs])

        K_prev = 0
        while True:
            sp.add("passes", 1)  # each pass past the first grew K
            sp.set("K", K)
            outs, counts_h = extract(perm_ext, starts, K, use_T)
            grow_v = np.broadcast_to(grow_h, counts_h.shape)
            over = (counts_h > K) & (grow_v < G)
            # K doubles past the overflowing rows' counts up to
            # MAX_CANDIDATE_CAP; rows past it take the heavy-row pass
            fit = counts_h[over & (counts_h <= MAX_CANDIDATE_CAP)]
            if not fit.size:
                break
            K_prev, K = K, _next_pow2(int(fit.max()))
        plan.extracted(K, K_prev)
        # no pass below reads the bound bits: their bytes go to the BBH
        runner.release_bound_bits()
    if capture is not None:
        capture.update(runner=runner, perm_ext=perm_ext, starts=starts,
                       row_block=row_block, use_T=use_T)

    # rows past the cap: extracted again at their own cap, their pairs
    # joined and their valid cells kept; their rows leave the main
    # extraction's, and the BBH takes their cells as a segment of its own
    heavy_rows = np.zeros(0, np.int32)
    heavy_layout, heavy_segs, heavy_pairs, joined0 = None, None, 0, []
    if np.any(over):
        with phase("extract.heavy") as sp:
            heavy_rows, heavy_layout, heavy_segs, heavy_pairs, joined0 = (
                _heavy_pass(index, runner, shards, grow_v[over],
                            counts_h[over], plan, grow_h.size // shards.n * K,
                            row_block, steps, use_kernel, extract, sp,
                            keep_joined=capture is not None))
            outs = _drop_heavy(outs, shards, heavy_rows, G_pad, K,
                               use_kernel)
    main_counts = np.where(np.isin(grow_v, heavy_rows) | (grow_v >= G), 0,
                           counts_h)
    extra = ([[seg] for seg in heavy_segs] if heavy_segs
             else [()] * len(outs))

    # every shard's flat pair total: rows are sharded on the S*n axis
    per_shard = main_counts.reshape(steps, shards.n, -1).sum(
        axis=(0, 2), dtype=np.int64)
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
    with phase("plan") as sp:
        # gate 2: the main rows' flat pass and the BBH, beside the heavy
        # rows' segment
        plan.bbh(int(per_shard.max(initial=0)), grow_h.size // shards.n * K,
                 heavy_segs[0][1].numel() if heavy_segs else 0, edge_cap)
        for name, value in plan.counters().items():
            sp.set(name, value)
    pair_cap = None
    if use_kernel:
        with phase("flatten_join") as sp:
            pair_cap = runner.pair_capacity_from_worst(
                int(per_shard.max(initial=0)))
            sp.set("pair_cap", pair_cap)
            sp.set("launches", shards.n_local)  # a join kernel a shard
            flat = runner.flatten_join_shards(outs, K, pair_cap)
        if capture is not None:
            capture.update(join_kernel=runner.join_kernel,
                           table=runner.join_table, dg=runner.dg)
        if capture is not None and joined0 is not None:
            fpi, fpj, fi, fp, ft = flat[0][:5]
            if joined0:
                # every pair shard 0's join launches joined, the heavy
                # chunks' after the main list's
                fpi, fpj, fi, fp, ft = (
                    torch.cat(x) for x in zip(flat[0][:5], *joined0))
            capture.update(pi=fpi, pj=fpj, inter=fi, perc=fp, tr=ft)
    if capture is not None:
        capture["pairs_per_shard"] = per_shard

    with phase("bbh") as sp:
        # gene -> global row position (the all_gather row order: each
        # shard's main rows, then its heavy rows; a heavy row's main slot
        # is left out)
        rows_h = grow_h.reshape(shards.n, -1)
        if heavy_layout is not None:
            rows_h = np.concatenate(
                [np.where(np.isin(rows_h, heavy_rows), G, rows_h),
                 heavy_layout], axis=1)
        rows_h = rows_h.reshape(-1)
        inv_perm = np.zeros(G_pad, dtype=np.int32)
        real = rows_h < G
        inv_perm[rows_h[real]] = np.flatnonzero(real).astype(np.int32)
        lens_pad = np.zeros(G_pad, dtype=np.float32)
        lens_pad[:G] = index.kseq_lengths
        genome_pad = np.zeros(G_pad, dtype=np.int32)
        genome_pad[:G] = index.seq_genome
        n_gen = index.n_genomes
        edge_cap_initial = edge_cap
        tails = zip(shards.replicate(inv_perm), shards.replicate(lens_pad),
                    shards.replicate(genome_pad))
        if use_kernel:
            programs = [
                _bbh_flat_program(*o, *f, *t, n_gen, edge_cap, steps=steps,
                                  extra=x)
                for o, f, t, x in zip(outs, flat, tails, extra)]
        else:
            programs = [
                _bbh_program(*o[:-1], *t, n_gen, edge_cap, extra=x)
                for o, t, x in zip(outs, tails, extra)]
        results = shards.spmd(programs)
        edge_cap = results[0][6]
        mats = results[0][5]  # merged over every shard
        n_by_shard = shards.fetch([
            torch.tensor([[r[4][k] for k in ("n_edges", "n_valid",
                                              "n_inter", "n_intra")]],
                         device=d)
            for r, d in zip(results, shards.devices)])
        n_edges_max = int(n_by_shard[:, 0].max())
        n_valid, n_acc_canonical, _ = (
            int(x) for x in n_by_shard[:, 1:].sum(0))
        sp.set("edge_cap_initial", edge_cap_initial)
        sp.set("edge_cap", edge_cap)

    with phase("fetch") as sp:
        # --- ship the accepted cells: bit-packed to 8 bytes per cell
        # when they fit ((row+1) << 16 | col and inter << 1 | acc), and
        # sliced to the largest shard's edge count
        pack_ok = (
            G < 65535
            and int(np.asarray(index.kseq_lengths).max(initial=0)) < 2**24
            # test hook: force the unpacked fetch branch at small G
            and os.environ.get("PANDELOS_NO_EDGE_PACK") != "1"
        )
        with tracing.blocked():
            ims, gmin_s, gmin_p, gmax_p = (m.cpu().numpy() for m in mats)
        n_fetch = min(edge_cap, _round_up(n_edges_max + 1, 4096))
        cut = [[x[:n_fetch] for x in r[:4]] for r in results]
        if pack_ok:
            packed = []
            for r, c, i, acc in cut:
                # int64 on the device, cut to the low 32 bits for the
                # transfer (the host reads them back as uint32)
                rc_d = torch.where(r >= 0, ((r + 1) << 16) | c,
                                   torch.zeros_like(r))
                ia_d = (i.to(torch.int64) << 1) | acc.to(torch.int64)
                packed.append((rc_d.to(torch.int32), ia_d.to(torch.int32)))
            rc_h, ia_h = shards.fetch_many(*zip(*packed))
            rc_u = rc_h.view(np.uint32)
            keep_mask = rc_u != 0
            e_row = np.where(keep_mask, (rc_u >> 16).astype(np.int64) - 1,
                             -1)
            e_col = (rc_u & 0xFFFF).astype(np.int64)
            e_inter = (ia_h >> 1).astype(np.int64)
            e_acc = (ia_h & 1).astype(bool)
        else:
            e_row, e_col, e_inter, e_acc = shards.fetch_many(*zip(*cut))
        keep = e_row >= 0
        e_row = e_row[keep].astype(np.int64)
        e_col = e_col[keep].astype(np.int64)
        e_inter = e_inter[keep].astype(np.int64)
        # union from the exact integer kseq lengths (|A| + |B| - inter);
        # the device accept used f32 lengths, exact below 2^24
        assert int(np.asarray(index.kseq_lengths).max(initial=0)) < 2**24
        assert (int(e_row.max(initial=-1)) < G
                and int(e_col.max(initial=-1)) < G)
        lens_i64 = np.asarray(index.kseq_lengths, np.int64)
        e_union = lens_i64[e_row] + lens_i64[e_col] - e_inter
        e_acc = e_acc[keep]
        sp.set("edges", len(e_row))

    with phase("host.edges"):
        # host-exact f32 scores.  Each cell was emitted once (canonical
        # col > row, from the one shard holding its lower-id row; under
        # the ring, from the one step holding its column), so the keys
        # are unique and an argsort orders them (the JAX package's
        # np.unique over its shards' cells finds nothing to drop)
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

    with phase("host.stats"):
        # genome-pair statistics (net.py build_network's aggregates,
        # Pangenes.java:130-143): min/max families from the device over
        # the canonical accepted cells, mirrored as (m op m.T); mean/count
        # here
        stats = {
            "n_cells": n_valid,
            "n_accepted_inter_cells": 2 * n_acc_canonical,
            "n_inter_edges": int(e_acc.sum()),
            "n_intra_edges": int((~e_acc).sum()),
            "n_edges": len(edges),
            "n_joined_pairs": int(main_counts.sum(dtype=np.int64)
                                  + heavy_pairs),
            "device_bbh": True,
            "ring_extract": use_ring,
            "device": str(dev),
            "n_devices": shards.n,
            "phase_s": None,  # below, once every sub-phase has closed
            "candidate_cap_final": int(K),
            "bound_bits_mode": bool(use_T),
            "edge_cap_initial": int(edge_cap_initial),
            # backend "xla" has no flat pair list and no join table (None,
            # as in the JAX package)
            "pair_cap": int(pair_cap) if use_kernel else None,
            "lane_D": int(runner.lane_D) if use_kernel else None,
            "join_kernel": runner.join_kernel if use_kernel else None,
            # only when the lane2 table exists: under lane or roll,
            # building it would cost memory for nothing (and cannot pack
            # when the input forced the lane fallback)
            "lane_table_cols": (
                int(runner.all_lane2.shape[1])
                if use_kernel and runner.join_kernel == "lane2" else None
            ),
            "edge_cap": int(edge_cap),
            # the memory plan's peak, and the card's bytes it held to
            # (None where no card budget binds)
            "planned_peak_bytes": int(plan.planned_peak),
            "budget_bytes": plan.budget,
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
            # device matrices carry the neutrals (+inf / 0) at empty
            # entries; the reference inits everything at 1.0, and
            # max_perc's init dominates (perc fractions <= 1.0 — the
            # host-path quirk)
            gp_min = np.minimum(np.minimum(gmin_s, gmin_s.T),
                                np.float32(1.0))
            gp_minp = np.minimum(np.minimum(gmin_p, gmin_p.T),
                                 np.float32(1.0))
            gp_maxp = np.maximum(np.maximum(gmax_p, gmax_p.T),
                                 np.float32(1.0))
            with np.errstate(invalid="ignore"):
                gp_mean = np.where(gp_cnt > 0,
                                   gp_sum / np.maximum(gp_cnt, 1), 0.0)
            stats["genome_pairs"] = {
                "mean_score": gp_mean.round(6).tolist(),
                "min_score": gp_min.astype(float).tolist(),
                "max_score_lt1": ims.astype(float).tolist(),
                "min_perc": gp_minp.astype(float).tolist(),
                "max_perc": gp_maxp.astype(float).tolist(),
                "accepted_cells": gp_cnt.tolist(),
            }
    # each sub-phase's seconds, and the seconds the host spent blocked on
    # the card over all of them
    stats["phase_s"] = {sp.name: sp.seconds for sp in spans}
    stats["phase_s"]["wait"] = sum(sp.counters.get("wait_s", 0.0)
                                   for sp in spans)
    return edges, stats
