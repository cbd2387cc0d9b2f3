"""Ring-sharded candidate extraction: signatures never replicated.

The counterpart of the JAX package's ``ops/ring.py``.  The replicated
engine (``ops/candidate.py``) holds the [G_pad, B] bf16 signature matrix
on every device, its largest allocation.  Here each shard instead:

- builds the signatures of ITS OWN contiguous gene range (the column
  shard ``d``: genes ``d*Gc .. (d+1)*Gc``) and of its own row blocks,
  from the replicated profiles (``ops/hist.py``);
- at ring step ``s`` holds column shard ``(d + s) % n``: bounds its rows
  against it with two bf16 matmuls with f32 results (exact: every
  summand is an integer and every sum < 2^24) and extracts that shard's
  candidates (the first K set columns of each row, ascending);
- passes the column shard on (``ring_shift``: shard i receives shard
  i+1's, JAX's ``ppermute`` i -> i-1).

After n steps every (row, column) pair has been bounded exactly once.
Per-device signature memory drops from ``G_pad * B`` to about ``3 *
G_pad * B / n`` (own shard, the one held, its presence) plus the rows'.
The bound only gates candidates, and the exact join and validity
downstream are the replicated engine's, so the cells are identical to
it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.device import configure_numerics, mm_f32
from pandelos_tpu_torch.index import KmerIndex
from pandelos_tpu_torch.oracle.cells import ScoreCells


def _ring_program(runner, d: int, dev, perm_d, starts_d, R: int, S: int,
                  K: int, n_buckets: int, shift: int, Gc: int,
                  upper_only: bool):
    """One shard's ring extraction (global shard ``d`` on ``dev``): the
    JAX ``_ring_extract_program``'s local function.  A generator that
    yields ``("ring_shift", sig)`` after each step.  Returns grow [S, R],
    cand [n, S, R, K] (gene ids; absent slots gene G) and counts [n, S,
    R] (may exceed K), the step axis first."""
    from pandelos_tpu_torch.ops.candidate import _MASK_ELEMS, first_k
    from pandelos_tpu_torch.ops.hist import device_histogram

    n = runner.n_dev
    G = runner.G
    k2 = float(runner.k2)
    all_ids = runner.on("all_ids", dev)
    all_counts = runner.on("all_counts", dev)
    col_lens = runner.on("col_lens", dev)
    # column-shard signatures from the shard's own gene range
    sig_cur = device_histogram(all_ids[d * Gc:(d + 1) * Gc],
                               all_counts[d * Gc:(d + 1) * Gc], n_buckets,
                               shift, round_up_bf16=True)  # [Gc, B]
    # the signatures of this shard's rows
    pos = (starts_d[:, None] + torch.arange(R, device=dev)[None, :])
    row_idx = perm_d[pos.reshape(-1)].long()  # [S*R]
    sig_r = device_histogram(all_ids[row_idx], all_counts[row_idx],
                             n_buckets, shift, round_up_bf16=True)
    pres_r = (sig_r != 0).to(sig_r.dtype)
    row_lens = col_lens[row_idx]
    rows = S * R
    cand = torch.full((n, rows, K), G, dtype=torch.int32, device=dev)
    counts = torch.zeros((n, rows), dtype=torch.int32, device=dev)
    step = max(1, _MASK_ELEMS // Gc)
    for s in range(n):
        c0 = ((d + s) % n) * Gc
        pres_cur = (sig_cur != 0).to(sig_cur.dtype)
        lens_c = col_lens[c0:c0 + Gc]
        cols_g = c0 + torch.arange(Gc, device=dev)
        col_ok = (cols_g < G) & (lens_c > 0)
        for r0 in range(0, rows, step):
            r1 = min(rows, r0 + step)
            g, rl = row_idx[r0:r1], row_lens[r0:r1]
            perc_bnd = mm_f32(sig_r[r0:r1], pres_cur.t())  # [rows, Gc]
            tr_bnd = mm_f32(pres_r[r0:r1], sig_cur.t())
            rel = (cols_g[None, :] > g[:, None]) if upper_only else (
                cols_g[None, :] != g[:, None])
            mask = (
                ((k2 * perc_bnd >= rl[:, None])
                 | (k2 * tr_bnd >= lens_c[None, :]))
                & rel & col_ok[None, :] & ((g < G) & (rl > 0))[:, None]
            )
            cnt, rr, rank, cc = first_k(mask, K)
            counts[s, r0:r1] = cnt
            cand[s, r0 + rr, rank] = (c0 + cc).to(torch.int32)
        sig_cur = yield ("ring_shift", sig_cur)
    return (row_idx.to(torch.int32).view(S, R), cand.view(n, S, R, K),
            counts.view(n, S, R))


def ring_extract(runner, perm_ext, starts, row_block: int, K: int,
                 upper_only: bool) -> list:
    """The ring extraction over every local shard of ``runner`` (the
    row blocks in its round-robin layout): a list, one entry a local
    shard, of (grow [n, S, R], cand [n, S, R, K], counts [n, S, R]), the
    ring-step axis first (grow repeats the shard's rows at each step), on
    the shard's device; the flatten-join and the flat BBH take them
    as they are."""
    from pandelos_tpu_torch.ops.hist import pick_buckets

    index = runner.index
    shards = runner.shards
    n = runner.n_dev
    Gc = runner.G_pad // n
    n_buckets, shift = pick_buckets(
        index.vocab_size, max(1, index.max_profile_len), index.k,
        n_genes=runner.G_pad,
    )
    local = runner.shard_starts(perm_ext, starts, row_block)
    S = local[0].shape[0]
    perm = shards.replicate(np.asarray(perm_ext, np.int32))
    programs = [
        _ring_program(runner, shards.first + i, dev, perm_d, st, row_block,
                      S, K, n_buckets, shift, Gc, upper_only)
        for i, (dev, st, perm_d) in enumerate(zip(shards.devices, local,
                                                  perm))]
    return [(grow.expand(n, S, row_block), cand, counts)
            for grow, cand, counts in shards.spmd(programs)]


def compute_cells_ring(
    index: KmerIndex, config: PipelineConfig, device=None,
    capture: Optional[dict] = None, devices=None,
) -> ScoreCells:
    """Every valid cell (both orientations) with ring-sharded signatures:
    the counterpart of the JAX ``compute_cells_ring``.  Needs two shards
    or more (``config.n_devices``, or ``devices``: see
    :func:`~pandelos_tpu_torch.parallel.shards.resolve_shards`) and a
    padded gene count they divide; cells equal
    :func:`~pandelos_tpu_torch.ops.candidate.compute_cells_candidate`'s.
    Each shard joins its own pair list (step-major) with
    ``config.join_kernel``, under backend ``"xla"`` too, as the JAX
    package's ring joins with its runner's kernel whatever the backend;
    rows past the candidate cap take the exact host walk.  ``capture``
    receives what ``compute_cells_candidate``'s does, and every shard's
    pair total."""
    from pandelos_tpu_torch.ops.candidate import (
        _host_fallback_rows,
        _mirrored,
        _round_up,
        check_hbm_fit,
        get_runner,
    )
    from pandelos_tpu_torch.ops.score import pad_profiles
    from pandelos_tpu_torch.parallel.shards import resolve_shards

    G = index.n_sequences
    if G == 0 or index.profile_ids.size == 0:
        z32 = np.zeros(0, dtype=np.int32)
        z64 = np.zeros(0, dtype=np.int64)
        return ScoreCells(z32, z32, z64, z64, z64)
    shards = resolve_shards(config, device, devices)
    n = shards.n
    if n < 2:
        raise ValueError(
            "ring extraction needs a multi-device mesh (n_devices >= 2)")
    configure_numerics()
    check_hbm_fit(index, config, shards.devices[0], ring=True, n_devices=n)

    row_block = min(config.row_block, _round_up(G, 8))
    col_block = min(config.col_block, _round_up(G, 128))
    padded = pad_profiles(index, row_block, col_block)
    G_pad = padded.ids.shape[0]
    if G_pad % n:
        raise ValueError(
            f"G_pad={G_pad} not divisible by n_devices={n}; "
            f"choose a col_block divisible by the device count")
    K = config.candidate_cap
    runner = get_runner(index, padded, config, shards)

    widths = np.diff(index.profile_ptr)
    perm = np.argsort(widths, kind="stable").astype(np.int32)
    n_blocks = -(-G // row_block)
    perm_pad = np.full(n_blocks * row_block, G, dtype=np.int32)
    perm_pad[:G] = perm
    perm_ext = np.concatenate(
        [perm_pad, np.full(row_block, G, dtype=np.int32)])
    starts = np.arange(0, n_blocks * row_block, row_block, np.int32)
    outs = ring_extract(runner, perm_ext, starts, row_block, K,
                        upper_only=True)
    if capture is not None:
        capture.update(runner=runner, perm_ext=perm_ext, starts=starts,
                       row_block=row_block, use_T=False)

    counts_h = shards.fetch([o[2] for o in outs], axis=1)  # [n, S*n, R]
    grow_h = runner.grow_layout(perm_ext, starts, row_block)  # [S*n, R]
    grow_steps = np.broadcast_to(grow_h, counts_h.shape)
    over = (counts_h > K) & (grow_steps < G)
    overflow_rows = sorted(set(grow_steps[over].astype(int).tolist()))

    # each shard's pairs: rows are sharded on the middle (S*n) axis
    nf = np.where(counts_h > K, 0, counts_h)
    per_shard = nf.reshape(n, n, -1).sum(axis=(0, 2), dtype=np.int64)
    pair_cap = runner.pair_capacity_from_worst(int(per_shard.max(initial=0)))
    joined = runner.flatten_join_shards(outs, K, pair_cap)
    if capture is not None:
        out = joined[0]
        capture.update(table=runner.join_table, dg=runner.dg, pi=out[0],
                       pj=out[1], inter=out[2], perc=out[3], tr=out[4],
                       join_kernel=runner.join_kernel, pair_cap=pair_cap,
                       pairs_per_shard=per_shard)
    pi, pj, inter, perc, tr, valid = shards.fetch_many(*zip(*joined))
    keep = valid & (pi < G)
    parts = [_mirrored(pi[keep], pj[keep], inter[keep], perc[keep],
                       tr[keep])]
    if overflow_rows:
        fb = _host_fallback_rows(index, overflow_rows)
        keep = fb.col > fb.row
        parts.append(_mirrored(
            fb.row[keep], fb.col[keep], fb.intersection[keep],
            fb.perc_cnt[keep], fb.tr_perc_cnt[keep],
        ))
    return ScoreCells(*(np.concatenate(x) for x in zip(*parts)))
