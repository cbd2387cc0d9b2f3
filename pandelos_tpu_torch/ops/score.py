"""Padded device-ready profiles, and the ``dense`` backend: blocked
generalized-Jaccard counters over k-mer multisets (the counterpart of the
JAX package's ``ops/score.py``).

Profiles become fixed-shape ``[G_pad, W]`` int32 arrays, id-sorted and
left-packed per gene; padding slots carry the sentinel id ``vocab_size``
and count 0, and there is always at least one all-padding row (gene
``G``), the target of every padded row and candidate slot.

The dense backend (:func:`compute_cells_xla`) projects a row block of R
genes and a column block of C genes onto the row block's local
vocabulary (V = R * W_row dense columns) and computes every counter by
matmul:

- ``perc_cnt(i, j)    = sum_v count_i(v) * [count_j(v) > 0]``,
- ``tr_perc_cnt(i, j) = sum_v [count_i(v) > 0] * count_j(v)``,
- ``intersection(i, j) = sum_v min(count_i(v), count_j(v))`` by the level
  decomposition ``min(a, b) = sum_t [a >= t][b >= t]``, ``level_cap``
  matmuls of 0/1 matrices.

Counts are clipped at ``COUNT_CLIP`` = 256 (the largest integer bf16
holds exactly) whatever ``matmul_dtype`` is, and intersections at
``level_cap``; exact host corrections add back what the clips took, the
count-clip ones only for ``matmul_dtype == "bf16"``.  That is the JAX
package's rule, kept for parity: with ``"f32"`` and a count above 256 the
``perc``/``tr`` counters come out short there and here alike.

Every summand is an integer and every sum stays below 2^24, so the f32
results are exact in any order: bf16 operands with an f32 result on the
card (TF32 and reduced-precision reductions off), f32 operands on the CPU.
These matmuls are plain products; the JAX package computes them outside
any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pandelos_tpu_torch import tracing
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.device import (
    configure_numerics,
    mm_f32,
    resolve_device,
)
from pandelos_tpu_torch.index import KmerIndex
from pandelos_tpu_torch.oracle.cells import ScoreCells

# Largest integer bfloat16 represents exactly; counts are clipped here for
# the matmuls and corrected on the host above it.
COUNT_CLIP = 256
# f32-equivalent bytes of one projected column chunk ([C, V]); a column
# block past it is projected and multiplied in chunks (same bits)
_PROJ_BYTES = 1 << 30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class PaddedProfiles:
    """Fixed-shape device-ready profile arrays."""

    ids: np.ndarray  # int32 [G_pad, W], sentinel = vocab_size
    counts: np.ndarray  # int32 [G_pad, W], 0 on padding
    n_sequences: int  # true G
    vocab_size: int
    width: int


def pad_profiles(index: KmerIndex, row_block: int, col_block: int) -> PaddedProfiles:
    """Dense padded (ids, counts) arrays for the device engines.

    Memoized on the index: rebuilding costs seconds of host time per
    call at Mycoplasma-64 scale and every scoring pass needs the same
    arrays."""
    cache = getattr(index, "_pad_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(index, "_pad_cache", cache)
    key = ("pad", row_block, col_block)
    if key in cache:
        return cache[key]
    out = _pad_profiles_impl(index, row_block, col_block)
    cache[key] = out
    return out


def _pad_profiles_impl(
    index: KmerIndex, row_block: int, col_block: int
) -> PaddedProfiles:
    G = index.n_sequences
    W = max(128, _round_up(max(1, index.max_profile_len), 128))
    # Always strictly more padded rows than genes: padded (empty) rows are
    # used as masked targets for row-permutation padding.
    G_pad = _round_up(G + 1, max(row_block, col_block))
    sentinel = index.vocab_size
    ids = np.full((G_pad, W), sentinel, dtype=np.int32)
    counts = np.zeros((G_pad, W), dtype=np.int32)
    ptr = index.profile_ptr
    widths = np.diff(ptr)
    if G > 0 and widths.max(initial=0) > W:
        raise AssertionError("profile wider than padding width")
    if G > 0 and index.profile_ids.size:
        # boolean-mask assignment walks the destination in row-major
        # order — exactly the CSR source order — in one C pass (the
        # element-index scatter it replaces cost ~1.5s at Mycoplasma-64
        # scale, ~10x this form)
        mask = np.arange(W) < widths[:, None]
        ids[:G][mask] = index.profile_ids
        counts[:G][mask] = index.profile_counts
    return PaddedProfiles(ids, counts, G, index.vocab_size, W)


def _score_row_block_core(
    row_ids: torch.Tensor,  # int32 [R, W_row]
    row_counts: torch.Tensor,  # int32 [R, W_row]
    all_ids: torch.Tensor,  # int32 [G_pad, W]
    all_counts: torch.Tensor,  # int32 [G_pad, W]
    vocab_size: int,
    col_block: int,
    level_cap: int,
    matmul_dtype: str,
):
    """Integer accumulators of one row block against every column.

    Returns (inter, perc, tr), each f32 [R, G_pad] holding exact integers
    up to the COUNT_CLIP / level_cap clipping that the host corrects.
    Columns past ``(G_pad // col_block) * col_block`` stay 0, as in the
    JAX package's fixed-trip loop."""
    dev = row_ids.device
    R, W_row = row_ids.shape
    G_pad, W = all_ids.shape
    V = R * W_row
    sentinel = vocab_size
    dot_dtype = (
        torch.bfloat16
        if matmul_dtype == "bf16" and dev.type == "cuda"
        else torch.float32
    )

    # --- local vocabulary of the row block: its sorted distinct ids; the
    # JAX package pads them with the sentinel up to V (jnp.unique with
    # size=V), and every sentinel slot then names column V, which is cut
    rv = torch.unique(row_ids.reshape(-1))
    rv = rv[rv != sentinel]
    # --- inverse table: global id -> local position (V where absent)
    inv = torch.full((vocab_size + 1,), V, dtype=torch.int64, device=dev)
    inv[rv.long()] = torch.arange(rv.shape[0], device=dev)

    def project(ids_blk, counts_blk):
        """[C, w] profiles -> the entries that land in the local
        vocabulary: (row, position, count).  Positions are distinct per
        row (a profile's ids are), so the dense [C, V] matrix is a plain
        assignment; the entries bound for column V are dropped here
        explicitly."""
        pos = inv[torch.clamp(ids_blk, 0, vocab_size).long()]
        pos = torch.where(ids_blk == sentinel, torch.full_like(pos, V), pos)
        keep = pos < V
        rows = torch.arange(ids_blk.shape[0], device=dev)[:, None].expand(
            pos.shape)
        return rows[keep], pos[keep], counts_blk[keep]

    def dense(rows, pos, vals, C):
        m = torch.zeros((C, V), dtype=dot_dtype, device=dev)
        m[rows, pos] = vals.to(dot_dtype)
        return m

    ar, ap_, ac = project(row_ids, row_counts)
    A_pres = dense(ar, ap_, torch.ones_like(ac), R)
    A_cnt = dense(ar, ap_, torch.clamp(ac, max=COUNT_CLIP), R)
    # the row side's level matrices serve every column block
    A_levels = [A_pres] + [
        dense(ar, ap_, (ac >= t).to(torch.int32), R)
        for t in range(2, level_cap + 1)
    ]

    inter_acc = torch.zeros((R, G_pad), dtype=torch.float32, device=dev)
    perc_acc = torch.zeros_like(inter_acc)
    tr_acc = torch.zeros_like(inter_acc)
    step = _PROJ_BYTES // (4 * V) // 128 * 128
    step = min(col_block, max(128, step))
    n_cols = (G_pad // col_block) * col_block
    for c0 in range(0, n_cols, step):
        c1 = min(n_cols, c0 + step)
        br, bp, bc = project(all_ids[c0:c1], all_counts[c0:c1])
        C = c1 - c0
        B_pres = dense(br, bp, torch.ones_like(bc), C)
        perc_acc[:, c0:c1] = mm_f32(A_cnt, B_pres.t())
        tr_acc[:, c0:c1] = mm_f32(
            A_pres, dense(br, bp, torch.clamp(bc, max=COUNT_CLIP), C).t())
        inter = mm_f32(A_levels[0], B_pres.t())
        del B_pres
        for t in range(2, level_cap + 1):
            inter += mm_f32(A_levels[t - 1], dense(
                br, bp, (bc >= t).to(torch.int32), C).t())
        inter_acc[:, c0:c1] = inter
    return inter_acc, perc_acc, tr_acc


def _extract_nonzero_core(inter, perc, tr, grow, row_lens, col_lens,
                          cap: int, n_true: int, k2: int):
    """The surviving cells of one row block, in row-major order, cut to
    the first ``cap``, and the block's count of them (which may pass
    ``cap``: the caller reruns such a block).

    A cell survives when intersection > 0 and the reference's validity
    threshold holds (library.cpp:499-500) in the JAX package's f32 form
    ``2k * perc >= |A| OR 2k * tr >= |B|``; self cells and padding are
    out (library.cpp:484-487).  ``grow`` is each local row's global gene
    id (>= n_true on padding).  Returns (rows, cols, inter, perc, tr) and
    the count."""
    R, G_pad = inter.shape
    cols = torch.arange(G_pad, device=inter.device)[None, :]
    grow_l = grow.long()[:, None]
    valid = (float(k2) * perc >= row_lens[:, None]) | (
        float(k2) * tr >= col_lens[None, :])
    mask = (
        (inter > 0) & valid & (cols != grow_l) & (cols < n_true)
        & (grow_l < n_true)
    )
    with tracing.blocked():
        (idx,) = torch.nonzero(mask.reshape(-1), as_tuple=True)
    count = int(idx.shape[0])
    idx = idx[:cap]
    return (
        grow[idx // G_pad], idx % G_pad, inter.reshape(-1)[idx],
        perc.reshape(-1)[idx], tr.reshape(-1)[idx],
    ), count


def _score_all_blocks(all_ids, all_counts, col_lens, perm_pad, starts,
                      vocab_size: int, row_block: int, w_row: int,
                      col_block: int, level_cap: int, matmul_dtype: str,
                      cap: int, n_true: int, k2: int):
    """One width bucket's pass: every row block at ``starts`` scored and
    compacted to at most ``cap`` cells.  Returns per block ((rows, cols,
    inter, perc, tr) on the host, count)."""
    dev = all_ids.device
    out = []
    for s in starts:
        idxs = torch.from_numpy(
            np.ascontiguousarray(perm_pad[int(s): int(s) + row_block],
                                 np.int64)).to(dev)
        inter, perc, tr = _score_row_block_core(
            all_ids[idxs, :w_row], all_counts[idxs, :w_row], all_ids,
            all_counts, vocab_size, col_block, level_cap, matmul_dtype,
        )
        row_lens = col_lens[torch.clamp(idxs, max=col_lens.shape[0] - 1)]
        cells, count = _extract_nonzero_core(
            inter, perc, tr, idxs, row_lens, col_lens, cap, n_true, k2)
        with tracing.blocked():
            out.append(([x.cpu().numpy() for x in cells], count))
    return out


def _host_level_cap_corrections(index: KmerIndex, level_cap: int):
    """Sparse exact corrections for per-(gene, kmer) counts > level_cap.

    Returns dict (i, j) -> extra intersection, for ordered pairs where both
    genes hold the same k-mer with count > level_cap.
    """
    over = np.flatnonzero(index.profile_counts > level_cap)
    if over.size == 0:
        return {}
    gene_of_entry = np.repeat(
        np.arange(index.n_sequences, dtype=np.int64),
        np.diff(index.profile_ptr),
    )
    genes = gene_of_entry[over]
    ids = index.profile_ids[over]
    counts = index.profile_counts[over].astype(np.int64)
    order = np.argsort(ids, kind="stable")
    genes, ids, counts = genes[order], ids[order], counts[order]
    corrections: dict = {}
    start = 0
    n = ids.shape[0]
    while start < n:
        end = start
        while end < n and ids[end] == ids[start]:
            end += 1
        for x in range(start, end):
            for y in range(start, end):
                if x == y:
                    continue
                key = (int(genes[x]), int(genes[y]))
                corrections[key] = corrections.get(key, 0) + int(
                    min(counts[x], counts[y]) - level_cap
                )
        start = end
    return corrections


def _host_count_clip_corrections(index: KmerIndex):
    """Sparse exact corrections for per-(gene, kmer) counts > COUNT_CLIP
    (the clipped perc/tr counts of the matmuls).

    Returns dict (i, j) -> (d_perc, d_tr): for every over-clip entry
    (gene i, kmer v, count c) and every other gene j sharing v,
    perc_cnt(i, j) is short by c - COUNT_CLIP and tr_perc_cnt(j, i)
    likewise.
    """
    over = np.flatnonzero(index.profile_counts > COUNT_CLIP)
    if over.size == 0:
        return {}
    gene_of_entry = np.repeat(
        np.arange(index.n_sequences, dtype=np.int64),
        np.diff(index.profile_ptr),
    )
    # posting lists: all entries grouped by kmer id
    order = np.argsort(index.profile_ids, kind="stable")
    post_ids = index.profile_ids[order]
    post_gene = gene_of_entry[order]
    corrections: dict = {}
    for e in over:
        i = int(gene_of_entry[e])
        v = int(index.profile_ids[e])
        extra = int(index.profile_counts[e]) - COUNT_CLIP
        lo = np.searchsorted(post_ids, v, side="left")
        hi = np.searchsorted(post_ids, v, side="right")
        for j in post_gene[lo:hi]:
            j = int(j)
            if j == i:
                continue
            dp, dt = corrections.get((i, j), (0, 0))
            corrections[(i, j)] = (dp + extra, dt)
            dp, dt = corrections.get((j, i), (0, 0))
            corrections[(j, i)] = (dp, dt + extra)
    return corrections


def _host_compute_cell(index: KmerIndex, i: int, j: int):
    """Exact (intersection, perc_cnt, tr_perc_cnt) for one ordered pair."""
    si, ei = index.profile_ptr[i], index.profile_ptr[i + 1]
    sj, ej = index.profile_ptr[j], index.profile_ptr[j + 1]
    ids_i = index.profile_ids[si:ei]
    ids_j = index.profile_ids[sj:ej]
    common, ia, ja = np.intersect1d(
        ids_i, ids_j, assume_unique=True, return_indices=True
    )
    ci = index.profile_counts[si:ei][ia].astype(np.int64)
    cj = index.profile_counts[sj:ej][ja].astype(np.int64)
    return (
        int(np.minimum(ci, cj).sum()),
        int(ci.sum()),
        int(cj.sum()),
    )


def _width_buckets(widths: np.ndarray, row_block: int, w_max: int):
    """Permute genes by profile width into row blocks; group blocks by the
    per-block padded width class.  Returns list of
    (w_bucket, perm_pad, starts) with perm padding value = len(widths)."""
    G = widths.shape[0]
    perm = np.argsort(widths, kind="stable").astype(np.int32)
    n_blocks = (G + row_block - 1) // row_block
    perm_pad = np.full(n_blocks * row_block, G, dtype=np.int32)
    perm_pad[:G] = perm
    buckets: dict = {}
    for b in range(n_blocks):
        blk = perm_pad[b * row_block : (b + 1) * row_block]
        real = blk[blk < G]
        wb = int(widths[real].max()) if real.size else 1
        # width classes are powers of two (a bounded number of shapes),
        # capped at the global padded width
        w2 = 128
        while w2 < wb:
            w2 *= 2
        wb = min(w2, _round_up(w_max, 128))
        buckets.setdefault(wb, []).append(b * row_block)
    return [
        (wb, perm_pad, np.asarray(starts, dtype=np.int32))
        for wb, starts in sorted(buckets.items())
    ]


def compute_cells_xla(index: KmerIndex,
                      config: Optional[PipelineConfig] = None, device=None,
                      capture: Optional[dict] = None) -> ScoreCells:
    """Every valid cell of the index through the dense backend, on the
    card unless ``config.device`` (or ``device``) says ``"cpu"``: the
    counterpart of the JAX package's ``compute_cells_xla``, with its
    per-block extraction cap and rerun, and its host corrections.
    Its two parts are spans of :mod:`pandelos_tpu_torch.tracing`:
    ``score.dense_pass`` (padding, upload, every row block's matmuls,
    compaction and fetch) and ``score.host_corrections``.  ``capture``,
    when given, receives the pass's matmul work
    (``dense_matmul_flops``: 2 R V C per product, ``2 + level_cap``
    products per row block and column, reruns included)."""
    config = config or PipelineConfig()
    G = index.n_sequences
    if G == 0 or index.profile_ids.size == 0:
        z32 = np.zeros(0, dtype=np.int32)
        z64 = np.zeros(0, dtype=np.int64)
        return ScoreCells(z32, z32, z64, z64, z64)
    dev = resolve_device(device if device is not None else config.device)
    configure_numerics()
    with tracing.span("score.dense_pass"):
        row_block = min(config.row_block, _round_up(G, 8))
        col_block = min(config.col_block, _round_up(G, 128))
        padded = pad_profiles(index, row_block, col_block)
        G_pad = padded.ids.shape[0]
        all_ids = torch.from_numpy(padded.ids).to(dev)
        all_counts = torch.from_numpy(padded.counts).to(dev)
        cap = config.nnz_cap_per_row * row_block
        lens_pad = np.zeros(G_pad, dtype=np.float32)
        lens_pad[:G] = index.kseq_lengths
        col_lens = torch.from_numpy(lens_pad).to(dev)
        widths = np.diff(index.profile_ptr)

        rows_out, cols_out, i_out, p_out, t_out = [], [], [], [], []
        flops = 0.0

        def put(cells):
            r, c, iv, pv, tv = cells
            rows_out.append(r.astype(np.int32))
            cols_out.append(c.astype(np.int32))
            i_out.append(iv.astype(np.int64))
            p_out.append(pv.astype(np.int64))
            t_out.append(tv.astype(np.int64))

        def run_bucket(w_row, perm_pad, starts, local_cap):
            nonlocal flops
            n_cols = (G_pad // col_block) * col_block
            flops += (2.0 * row_block * row_block * w_row * n_cols
                      * (2 + config.level_cap) * len(starts))
            return _score_all_blocks(
                all_ids, all_counts, col_lens, perm_pad, starts,
                vocab_size=index.vocab_size, row_block=row_block, w_row=w_row,
                col_block=col_block, level_cap=config.level_cap,
                matmul_dtype=config.matmul_dtype, cap=local_cap, n_true=G,
                k2=2 * index.k,
            )

        for w_row, perm_pad, starts in _width_buckets(
            widths, row_block, padded.width
        ):
            blocks = run_bucket(w_row, perm_pad, starts, cap)
            # a block past the cap lost cells: it is rerun alone with its
            # exact count rounded up to the row block (those cells come
            # first, as in the JAX package)
            for bi, (_, count) in enumerate(blocks):
                if count > cap:
                    ((cells, _),) = run_bucket(
                        w_row, perm_pad, starts[bi: bi + 1],
                        _round_up(count, row_block),
                    )
                    put(cells)
            for cells, count in blocks:
                if count <= cap:
                    put(cells)
    if capture is not None:
        capture["dense_matmul_flops"] = flops

    row = np.concatenate(rows_out)
    col = np.concatenate(cols_out)
    inter = np.concatenate(i_out)
    perc = np.concatenate(p_out)
    tr = np.concatenate(t_out)

    # --- host corrections (rare entries above the clipping thresholds);
    # the count-clip ones for bf16 only, as in the JAX package
    with tracing.span("score.host_corrections"):
        lvl_corr = _host_level_cap_corrections(index, config.level_cap)
        cnt_corr = (
            _host_count_clip_corrections(index)
            if config.matmul_dtype == "bf16"
            else {}
        )
        if lvl_corr or cnt_corr:
            cell_index = {
                (int(a), int(b)): n for n, (a, b) in enumerate(zip(row, col))
            }
            extra_rows = []
            for key in set(lvl_corr) | set(cnt_corr):
                n = cell_index.get(key)
                if n is not None:
                    if key in lvl_corr:
                        inter[n] += lvl_corr[key]
                    if key in cnt_corr:
                        dp, dt = cnt_corr[key]
                        perc[n] += dp
                        tr[n] += dt
                else:
                    # the cell was dropped by the device's validity filter on
                    # CLIPPED counters; recompute it exactly: it may be valid
                    # unclipped (perc corrections only raise perc).  Level-cap
                    # corrections alone cannot change validity.
                    if key not in cnt_corr:
                        continue
                    i0, j0 = key
                    ti, tp, tt = _host_compute_cell(index, i0, j0)
                    a = int(index.kseq_lengths[i0])
                    b = int(index.kseq_lengths[j0])
                    if 2 * index.k * tp >= a or 2 * index.k * tt >= b:
                        extra_rows.append((i0, j0, ti, tp, tt))
            if extra_rows:
                er = np.asarray(extra_rows, dtype=np.int64)
                row = np.concatenate([row, er[:, 0].astype(np.int32)])
                col = np.concatenate([col, er[:, 1].astype(np.int32)])
                inter = np.concatenate([inter, er[:, 2]])
                perc = np.concatenate([perc, er[:, 3]])
                tr = np.concatenate([tr, er[:, 4]])

    return ScoreCells(
        row.astype(np.int32), col.astype(np.int32), inter, perc, tr
    )
