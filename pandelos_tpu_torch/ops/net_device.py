"""BBH network construction on the device.

The counterpart of the JAX package's ``ops/net_device.py`` on one device
(no mesh, no ring): the candidate engine extracts every row's candidate
list, the selected exact join (lane2, lane or roll) computes the exact
counters of every flat pair, and
the reference's BBH + paralog filters (``Pangenes.java:98-176``) run on
the device, so that only the accepted cells come back to the host.

Float semantics: scores are compared on the device for exact equality
(score == per-(row, genome) maxima), so every quotient must be the
host's IEEE f32 quotient; :func:`exact_div_f32` is that quotient here
(see its module).  The final ``.net`` scores are computed on the host
from the shipped integer counters; the genome-pair min/max statistics
aggregate on the device, mean and count on the host (float64).

Layout: rows live in width-sorted PERM order (as produced by the
extraction); ``inv_perm`` maps gene id -> row position for the
counterpart-maxima lookups.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from pandelos_tpu_torch.config import PipelineConfig, check_ported
from pandelos_tpu_torch.device import configure_numerics, resolve_device
from pandelos_tpu_torch.index import KmerIndex
from pandelos_tpu_torch.io.net import EdgeList
from pandelos_tpu_torch.ops.candidate import (
    _next_pow2,
    build_signatures,
    check_hbm_fit,
    get_runner,
)
from pandelos_tpu_torch.ops.exact_div import exact_div_f32
from pandelos_tpu_torch.ops.score import _round_up, pad_profiles

# candidate caps past this go to the host cells path
# (compute_cells_candidate + host BBH)
MAX_CANDIDATE_CAP = 1024


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


def _bbh_flat_local(grow, cand, counts, pi, pj, fi, fp, ft, fv,
                    inv_perm, lens, genome_of, n_gen: int, edge_cap: int):
    """Flat-pair BBH on one device: exact scores once per flat pair,
    re-expanded to the [rows, K] maxima structure by one gather; the
    emitted cells' counters are read from the flat arrays at their flat
    positions.  Returns the emitted cells (canonical col > row, padded to
    ``edge_cap`` with row -1), the cell counts and the genome-pair
    matrices, and the final ``edge_cap`` (doubled past the emitted
    count, as the TPU path's retry loop does)."""
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

    g_i = genome_of[torch.clamp(gf, max=G_pad - 1)].long()
    g_j = genome_of[cf].long()
    (M,) = _chunked_genome_multi([(score, "max")], g_j, n_gen)
    jpos = inv_perm[cf].long()
    M_at_gj = torch.gather(M, 1, g_j)  # M[row, gen(j)]
    M_j_gi = M[jpos, g_i[:, None].expand_as(jpos)]  # M[j, genome(i)]
    inter_genome = g_j != g_i[:, None]
    accept = (
        (score > 0) & inter_genome & (score == M_at_gj) & (score == M_j_gi)
    )
    lt1v = torch.where(accept & (score < 1.0), score, zeros_rk)
    acc_cell = accept & (cf > gf[:, None])
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
    ims, gmin_s, gmin_p, gmax_p = _ims_and_aggregates(
        lt1v, acc_cell, score, ap, atp, g_i, g_j, n_gen, with_stats
    )
    thr_cell = ims[g_i[:, None].expand_as(g_j), g_j]
    row_thr = torch.where(
        accept, thr_cell, torch.full_like(thr_cell, float("inf"))
    ).amin(1)
    intra = (
        (score > 0)
        & (~inter_genome)
        & (gf[:, None] < cf)
        & (score == M_at_gj)
        & (score == M_j_gi)
        & (score >= row_thr[:, None])
    )
    # canonical emission (intra already is; accept is symmetric)
    emask = (accept | intra) & (cf > gf[:, None])
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
    fpos = torch.clamp(base[safe // K] + (safe % K), max=n_flat - 1)
    e_inter = fi[fpos]
    e_acc = accept.reshape(-1)[safe] & found
    counts_out = {
        "n_edges": n_edges,
        "n_valid": int((score_f > 0).sum()),
        "n_inter": int(acc_cell.sum()),
        "n_intra": int(intra.sum()),
    }
    return (e_row, e_col, e_inter, e_acc, counts_out,
            (ims, gmin_s, gmin_p, gmax_p), edge_cap)


def compute_network_device(
    index: KmerIndex, config: Optional[PipelineConfig] = None, device=None,
    capture: Optional[dict] = None,
):
    """Candidate engine + on-device BBH on one device.  Returns
    (edges, stats) with edges as canonical (a, b, host-exact f32 score),
    or None when a pathological candidate overflow (a cap above
    ``MAX_CANDIDATE_CAP``) needs the host cells path.

    Extraction runs with ``upper_only=False`` (each cell on both its
    rows) so the per-row maxima are complete; on candidate-cap overflow
    the whole extraction reruns at the next power-of-two cap.

    ``capture``, when given, receives the runner, the extraction layout
    and the join's kernel name, inputs and outputs (the table that kernel
    read, depths, pair lists, counters), so that a caller can check and
    time the kernel and the bound bits at the shapes of this run."""
    config = config or PipelineConfig()
    check_ported(config)
    dev = resolve_device(device if device is not None else config.device)
    configure_numerics()

    _trace = os.environ.get("PT_TIMING") == "1"
    _t0 = time.monotonic()
    _phase_s = {}

    def _mark(label):
        nonlocal _t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.monotonic() - _t0
        _phase_s[label.split("(")[0]] = round(dt, 4)
        if _trace:
            print(f"[pt:bbh] {label}: {dt:.2f}s", flush=True)
        _t0 = time.monotonic()

    G = index.n_sequences
    if G == 0 or index.profile_ids.size == 0:
        return [], {"n_cells": 0}

    check_hbm_fit(index, config, dev)
    row_block = min(config.row_block, _round_up(G, 8))
    col_block = min(config.col_block, _round_up(G, 128))
    padded = pad_profiles(index, row_block, col_block)
    _mark("setup.pad_profiles")
    G_pad = padded.ids.shape[0]

    runner = get_runner(index, padded, config, dev)
    _mark("setup.runner(upload)")
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
    use_T = runner.use_bound_bits(len(starts), row_block)
    grow_h = runner.grow_layout(perm_ext, starts, row_block).reshape(-1)
    while True:
        grow_d, cand_d, counts_d = runner.extract(
            perm_ext, starts, row_block, K, upper_only=False, from_T=use_T,
        )
        counts_h = counts_d.reshape(-1).cpu().numpy()
        over = (counts_h > K) & (grow_h < G)
        if not np.any(over):
            break
        K = _next_pow2(int(counts_h[over].max()))
        if K > MAX_CANDIDATE_CAP:
            return None  # pathological: the host cells path
    _mark(f"extract(K={K})")

    pair_cap = runner.pair_capacity(counts_h, K)
    fpi, fpj, fi, fp, ft, fv = runner.flatten_join(
        grow_d, cand_d, counts_d, K, pair_cap
    )
    if capture is not None:
        capture.update(
            runner=runner, perm_ext=perm_ext, starts=starts,
            row_block=row_block, use_T=use_T, join_kernel=runner.join_kernel,
            table=runner.join_table, dg=runner.dg, pi=fpi, pj=fpj,
            inter=fi, perc=fp, tr=ft,
        )
    _mark(f"flatten_join(pair_cap={pair_cap})")

    # gene -> row position
    inv_perm = np.zeros(G_pad, dtype=np.int32)
    real = grow_h < G
    inv_perm[grow_h[real]] = np.flatnonzero(real).astype(np.int32)
    lens_pad = np.zeros(G_pad, dtype=np.float32)
    lens_pad[:G] = index.kseq_lengths
    genome_pad = np.zeros(G_pad, dtype=np.int32)
    genome_pad[:G] = index.seq_genome
    n_gen = index.n_genomes

    # every emitted cell is valid and valid pairs pass the bound in both
    # orientations, so emitted cells <= half the candidate slots
    nf_cap = np.minimum(counts_h, K)
    edge_cap = max(
        1 << 14, _next_pow2(int(nf_cap.sum(dtype=np.int64)) // 2 + 1)
    )
    # test hook: a small initial cap makes the doubling step run
    cap_env = os.environ.get("PANDELOS_EDGE_CAP_INIT")
    if cap_env:
        edge_cap = _next_pow2(int(cap_env))
    edge_cap_initial = edge_cap
    (e_row, e_col, e_inter, e_acc, cnt, mats, edge_cap) = _bbh_flat_local(
        grow_d, cand_d, counts_d, fpi, fpj, fi, fp, ft, fv,
        runner._put(inv_perm), runner._put(lens_pad),
        runner._put(genome_pad), n_gen, edge_cap,
    )
    _mark(f"bbh(edge_cap={edge_cap})")

    # --- ship the accepted cells: bit-packed to 8 bytes per cell when
    # they fit ((row+1) << 16 | col and inter << 1 | acc), and sliced to
    # the known edge count
    pack_ok = (
        G < 65535
        and int(np.asarray(index.kseq_lengths).max(initial=0)) < 2**24
        # test hook: force the unpacked fetch branch at small G
        and os.environ.get("PANDELOS_NO_EDGE_PACK") != "1"
    )
    ims, gmin_s, gmin_p, gmax_p = (m.cpu().numpy() for m in mats)
    if pack_ok:
        n_fetch = min(edge_cap, _round_up(cnt["n_edges"] + 1, 4096))
        r, c = e_row[:n_fetch], e_col[:n_fetch]
        # int64 on the device, cut to the low 32 bits for the transfer
        # (the host reads them back as uint32)
        rc_d = torch.where(r >= 0, ((r + 1) << 16) | c, torch.zeros_like(r))
        ia_d = (e_inter[:n_fetch].to(torch.int64) << 1) | e_acc[
            :n_fetch].to(torch.int64)
        rc_h = rc_d.to(torch.int32).cpu().numpy()
        ia_h = ia_d.to(torch.int32).cpu().numpy()
        rc_u = rc_h.view(np.uint32)
        keep_mask = rc_u != 0
        e_row = np.where(keep_mask, (rc_u >> 16).astype(np.int64) - 1, -1)
        e_col = (rc_u & 0xFFFF).astype(np.int64)
        e_inter = (ia_h >> 1).astype(np.int64)
        e_acc = (ia_h & 1).astype(bool)
    else:
        e_row = e_row.cpu().numpy()
        e_col = e_col.cpu().numpy()
        e_inter = e_inter.cpu().numpy()
        e_acc = e_acc.cpu().numpy()
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

    # host-exact f32 scores; the device emitted each cell once (canonical
    # col > row), so the keys are unique and an argsort orders them
    scores = e_inter.astype(np.float32) / e_union.astype(np.float32)
    a = np.minimum(e_row, e_col)
    b = np.maximum(e_row, e_col)
    key = (a << np.int64(32)) | b
    first = np.argsort(key, kind="stable")
    uk = key[first]
    edges = EdgeList(
        uk >> np.int64(32),
        uk & np.int64(0xFFFFFFFF),
        scores[first].astype(np.float64),
    )
    _mark("host.edges")

    # genome-pair statistics (net.py build_network's aggregates,
    # Pangenes.java:130-143): min/max families from the device over the
    # canonical accepted cells, mirrored as (m op m.T); mean/count here
    n_acc_canonical = cnt["n_inter"]
    stats = {
        "n_cells": cnt["n_valid"],
        "n_accepted_inter_cells": 2 * n_acc_canonical,
        "n_inter_edges": int(e_acc.sum()),
        "n_intra_edges": int((~e_acc).sum()),
        "n_edges": len(edges),
        "n_joined_pairs": int(
            np.minimum(counts_h, K)[grow_h < G].sum(dtype=np.int64)
        ),
        "device_bbh": True,
        "device": str(dev),
        "n_devices": 1,
        "phase_s": dict(_phase_s),
        "candidate_cap_final": int(K),
        "bound_bits_mode": bool(use_T),
        "edge_cap_initial": int(edge_cap_initial),
        "pair_cap": int(pair_cap),
        "lane_D": int(runner.lane_D),
        "join_kernel": runner.join_kernel,
        # only when the lane2 table exists: under lane or roll, building
        # it would cost memory for nothing (and cannot pack when the
        # input forced the lane fallback)
        "lane_table_cols": (
            int(runner.all_lane2.shape[1])
            if runner.join_kernel == "lane2" else None
        ),
        "edge_cap": int(edge_cap),
    }
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
