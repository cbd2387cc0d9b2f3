"""Candidate engine on one device: signatures, bound bits, extraction,
the fused flatten + exact join + validity step, and the cells path.

The counterpart of the JAX package's ``ops/candidate.py`` on one device,
for the passes that ``compute_network_device`` and
:func:`compute_cells_candidate` run:

1. **Signatures** (``build_signatures``): per-gene bucket masses, rounded
   up to bf16, so that for genes i, j::

       perc_bound(i, j) = sum_b S[i, b] * [S[j, b] > 0]  >=  perc_cnt(i, j)

   (true shared k-mers land in buckets both genes occupy).
2. **Bound bits** (``_bound_bits_blocks``): ``T[p, q] = 2k *
   perc_bound(perm[p], perm[q]) >= len(perm[p])`` as int8 over
   width-sorted positions, one matmul per row block with an exact f32
   result, returned as ``T | T^T`` (the candidate mask is symmetric).
   Past the 4 GB cap the extraction takes the two-matmul form instead.
3. **Extraction** (``_candidate_blocks``): the first K candidate columns
   of every row in ascending column order, and each row's candidate
   count (rows with count > K are rerun at a larger K by the caller).
4. **Flatten + join + validity** (``Runner.flatten_join``): the per-row
   lists become one flat pair list; the selected CUDA join kernel
   (``Runner.join_kernel``: lane2, lane or roll) joins every pair
   exactly; the reference's validity test is applied.

Every summand of the bound matmuls is an integer (a bf16 round-up of an
integer is an integer) and every partial sum is < 2^24, so any f32
accumulation order gives the same bits; bf16 products are exact in f32.
The matmuls therefore run with bf16 operands and an f32 result on the
card (TF32 and reduced-precision reductions off), f32 operands on the
CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.device import configure_numerics, resolve_device
from pandelos_tpu_torch.index import KmerIndex
from pandelos_tpu_torch.oracle.cells import ScoreCells, cells_of_rows
from pandelos_tpu_torch.ops.score import _round_up, pad_profiles

_PAIR_BLOCK = 128  # smallest pair capacity (the TPU kernel's pair block)
# int8 bound-bit matrix byte cap; past this, extraction takes the
# two-matmul bound pass (memory_model documents the consequence)
_T_BYTES_CAP = int(4e9)
# rows per device step of the bound-bit build and the extraction (any
# value gives the same bits; this one bounds the f32 / bool temporaries)
_T_ROWS = 4096
_MASK_ELEMS = 1 << 26


def _bf16_round_up(x: np.ndarray) -> np.ndarray:
    """Round positive float32 values UP to the nearest bfloat16 value
    (keeps upper-bound semantics).  Returned as float32 holding exact
    bf16 values."""
    x32 = np.ascontiguousarray(x, dtype=np.float32)
    bits = x32.view(np.uint32)
    trunc = bits & np.uint32(0xFFFF0000)
    lost = (bits & np.uint32(0x0000FFFF)) != 0
    bumped = trunc + np.where(lost, np.uint32(0x00010000), np.uint32(0))
    return bumped.view(np.float32).copy()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result, exact for this module's integer sums: bf16
    operands with an f32 output on the card, f32 operands on the CPU
    (whose matmul has no bf16 -> f32 form)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def build_signatures(index: KmerIndex, padded, ids_d, counts_d):
    """Range-bucket mass signatures [G_pad, B] bf16 holding the masses
    rounded UP (upper-bound safe), built on the device of ``ids_d`` from
    the runner's resident padded profiles.  Memoized on the index."""
    from pandelos_tpu_torch.ops.hist import device_histogram, pick_buckets

    cache = getattr(index, "_pad_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(index, "_pad_cache", cache)
    ckey = ("sig", padded.ids.shape, str(ids_d.device))
    if ckey in cache:
        return cache[ckey]
    n_buckets, shift = pick_buckets(
        index.vocab_size,
        max(1, index.max_profile_len),
        index.k,
        n_genes=padded.ids.shape[0],
    )
    mass = device_histogram(
        ids_d, counts_d, n_buckets=n_buckets, shift=shift, round_up_bf16=True
    )
    out = (mass, n_buckets, shift)
    cache[ckey] = out
    return out


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def t_mode_enabled(n_dev: int, n_proc: int, n_pos: int) -> bool:
    """Bound-bits (T-mode) predicate: single device, single process, and
    the symmetric int8 T matrix fits the byte cap."""
    return n_dev == 1 and n_proc == 1 and n_pos * n_pos <= _T_BYTES_CAP


def _bound_bits_blocks(sig, col_lens, perm_pos, k2: int,
                       row_block: int = _T_ROWS):
    """One-sided bound bits ``T[p, q] = test1(perm[p], perm[q])`` as int8
    over perm POSITIONS, returned symmetrized as ``T | T^T``.

    With perc_bnd(i, j) = sum_b mass_i[b] * pres_j[b] and test1(i, j) =
    k2 * perc_bnd(i, j) >= len_i, the two-matmul mask equals test1(i, j)
    OR test1(j, i): the tr-side matmul is the same bilinear form
    transposed, so one matmul per row block and one transpose give it."""
    sig_perm = sig[perm_pos]  # [n_pos, B]: rows AND cols in perm order
    pres_perm = (sig_perm != 0).to(sig_perm.dtype)
    lens_perm = col_lens[perm_pos]
    n_pos = perm_pos.shape[0]
    T = torch.empty((n_pos, n_pos), dtype=torch.int8, device=sig.device)
    pres_t = pres_perm.t()
    for r0 in range(0, n_pos, row_block):
        r1 = min(n_pos, r0 + row_block)
        bnd = _mm_f32(sig_perm[r0:r1], pres_t)  # [rows, n_pos] exact f32
        T[r0:r1] = (float(k2) * bnd >= lens_perm[r0:r1, None]).to(torch.int8)
    return T | T.t()


def _candidate_blocks(
    sig_or_T,  # bf16 [G_pad, B] signatures; with from_T: int8 T [GP, GP]
    col_lens,  # f32 [G_pad]
    perm_ext,  # int32 [>= max(starts) + row_block] width-sorted gene order
    starts,  # int64 [n_blocks] row-block starts (perm positions)
    row_block: int,
    cand_cap: int,
    n_true: int,
    k2: int,
    upper_only: bool = False,
    from_T: bool = False,
):
    """One extraction pass over the row blocks at ``starts``.

    Returns grow [n_blocks, R] (row gene ids), cand [n_blocks, R, K] (the
    first K candidate columns per row in ascending column order, as gene
    ids; absent slots hold gene ``n_true``, an empty padded profile) and
    counts [n_blocks, R] (candidates per row, may exceed K).  With
    ``from_T`` the column space is perm positions (lists come out
    perm-ordered: the same SET per row); with ``upper_only`` only columns
    j > row are kept."""
    dev = col_lens.device
    G_pad = col_lens.shape[0]
    R = row_block
    K = cand_cap
    pos = (starts[:, None] + torch.arange(R, device=dev)[None, :]).reshape(-1)
    grow = perm_ext[pos]  # [n_rows]
    n_rows = pos.shape[0]
    if from_T:
        GP = sig_or_T.shape[0]
        cols_gene = perm_ext[:GP]
        col_ls = col_lens[torch.clamp(cols_gene, max=G_pad - 1)]
        col_ids = cols_gene
        CW = GP
    else:
        sig_bf = sig_or_T
        sig_pres = (sig_bf != 0).to(sig_bf.dtype)
        col_ls = col_lens
        col_ids = torch.arange(G_pad, dtype=torch.int32, device=dev)
        CW = G_pad
    cand = torch.full((n_rows, K), n_true, dtype=torch.int32, device=dev)
    counts = torch.empty(n_rows, dtype=torch.int32, device=dev)
    col_ok = (col_ids < n_true) & (col_ls > 0)
    step = max(1, _MASK_ELEMS // max(1, CW))
    for r0 in range(0, n_rows, step):
        r1 = min(n_rows, r0 + step)
        g = grow[r0:r1]
        row_lens = col_lens[g]
        if from_T:
            bound = sig_or_T[pos[r0:r1]] > 0  # [rows, GP]
        else:
            perc_bnd = _mm_f32(sig_bf[g], sig_pres.t())
            tr_bnd = _mm_f32(sig_pres[g], sig_bf.t())
            bound = (float(k2) * perc_bnd >= row_lens[:, None]) | (
                float(k2) * tr_bnd >= col_lens[None, :]
            )
        rel = (col_ids[None, :] > g[:, None]) if upper_only else (
            col_ids[None, :] != g[:, None]
        )
        mask = (
            bound & rel & col_ok[None, :]
            & ((g < n_true) & (row_lens > 0))[:, None]
        )
        cnt = mask.sum(1, dtype=torch.int32)
        counts[r0:r1] = cnt
        # rank-select: nonzero walks the mask row-major, so each row's
        # set columns come out ascending; a set bit's rank is its index
        # minus the row's exclusive base
        nz = mask.nonzero()
        rr, cc = nz[:, 0], nz[:, 1]
        base = torch.cumsum(cnt.long(), 0) - cnt.long()
        rank = torch.arange(nz.shape[0], device=dev) - base[rr]
        keep = rank < K
        rr, cc, rank = rr[keep], cc[keep], rank[keep]
        val = cols_gene[cc] if from_T else cc.to(torch.int32)
        val = torch.clamp(val, max=G_pad - 1).to(torch.int32)
        cand[r0 + rr, rank] = val
    n_blocks = starts.shape[0]
    return (
        grow.reshape(n_blocks, R),
        cand.reshape(n_blocks, R, K),
        counts.reshape(n_blocks, R),
    )


def packable(index: KmerIndex) -> bool:
    """Whether lane2 can pack ``id << 8 | count`` into one int32: every
    count < 256 and every id < 2^23 (the padding sentinel id ==
    vocab_size packs too)."""
    counts = np.asarray(index.profile_counts)
    return index.vocab_size < (1 << 23) and int(counts.max(initial=0)) < 256


def join_kernel_for(index: KmerIndex, config) -> str:
    """The join kernel a run takes: ``config.join_kernel``, except that
    lane2 falls back to the lane kernel (ids and counts apart) when the
    input cannot pack, as in the JAX package."""
    if config.join_kernel == "lane2" and not packable(index):
        return "lane"
    return config.join_kernel


class Runner:
    """Single-device counterpart of the JAX package's ``MeshRunner``: the
    device-resident padded profiles, signatures, join tables and per-gene
    depths of one index, and the extraction and flatten-join passes over
    them."""

    def __init__(self, index: KmerIndex, padded, config, device):
        G_pad = padded.ids.shape[0]
        self.index = index
        self.device = torch.device(device)
        self.G = index.n_sequences
        self.k2 = 2 * index.k
        self.w_pad = padded.width
        self.G_pad = G_pad
        self.n_dev = 1
        lens_pad = np.zeros(G_pad, dtype=np.float32)
        lens_pad[: self.G] = index.kseq_lengths
        self.join_kernel = join_kernel_for(index, config)
        self.all_ids = self._put(padded.ids)
        self.all_counts = self._put(padded.counts)
        self.col_lens = self._put(lens_pad)
        self.sig = None
        self._all_lane2 = None
        self._all_lane = None
        self._all_pair = None
        self._dg = None
        self._T_cache = {}
        self.lane_D = 0

    def _put(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def set_sig(self, sig_mass):
        if self.sig is None:
            self.sig = sig_mass
        return self.sig

    def _lane_table(self, packed: bool):
        from pandelos_tpu_torch.ops.lane_join import (
            lane_depth,
            pack_lane_device_core,
        )

        self.lane_D = lane_depth(self.index)
        return pack_lane_device_core(
            self.all_ids, self.all_counts, self.lane_D, packed=packed
        )

    @property
    def all_lane2(self):
        """The packed lane2 table [G_pad, D*128] (id << 8 | count, empty
        -256), built on the device from the resident padded profiles."""
        if self._all_lane2 is None:
            self._all_lane2 = self._lane_table(packed=True)
        return self._all_lane2

    @property
    def all_lane(self):
        """The unpacked lane table [G_pad, 2*D*128] (ids, then counts;
        empty slots id -1, count 0), built on the device like
        ``all_lane2``."""
        if self._all_lane is None:
            self._all_lane = self._lane_table(packed=False)
        return self._all_lane

    @property
    def all_pair(self):
        """The pair table [G_pad, 2W] (padded ids || counts) of the roll
        join, concatenated on the device."""
        if self._all_pair is None:
            from pandelos_tpu_torch.ops.pair_join import pack_profiles

            self._all_pair = pack_profiles(self.all_ids, self.all_counts)
        return self._all_pair

    @property
    def join_table(self):
        """The table that ``join_kernel`` reads (built at first use)."""
        if self.join_kernel == "roll":
            return self.all_pair
        return self.all_lane2 if self.join_kernel == "lane2" else self.all_lane

    def join(self, pi, pj):
        """Exact counters (inter, perc, tr) of the pairs (pi, pj) with
        ``join_kernel``."""
        from pandelos_tpu_torch.ops.lane_join import lane2_join, lane_join
        from pandelos_tpu_torch.ops.pair_join import join_pairs_core

        if self.join_kernel == "roll":
            return join_pairs_core(self.all_pair, pi, pj)
        fn = lane2_join if self.join_kernel == "lane2" else lane_join
        return fn(self.join_table, self.dg, pi, pj)

    @property
    def dg(self):
        """Per-gene lane depths [G_pad] int32 (padding genes 0)."""
        if self._dg is None:
            from pandelos_tpu_torch.ops.lane_join import lane_depths

            dg_pad = np.zeros(self.G_pad, np.int32)
            dg_pad[: self.G] = lane_depths(self.index)
            self._dg = self._put(dg_pad)
        return self._dg

    def bound_bits(self, perm_ext, starts, row_block: int):
        """Memoized symmetric bound-bit matrix T for this (perm, starts,
        row_block) layout, keyed on the permutation's raw bytes (a hash
        of them could collide)."""
        n_pos = len(starts) * row_block
        key = (
            row_block, len(starts),
            np.asarray(perm_ext[:n_pos], np.int32).tobytes(),
        )
        T = self._T_cache.get(key)
        if T is None:
            T = _bound_bits_blocks(
                self.sig, self.col_lens,
                self._put(np.asarray(perm_ext[:n_pos], np.int64)),
                self.k2,
            )
            self._T_cache[key] = T
        return T

    def use_bound_bits(self, starts_len: int, row_block: int) -> bool:
        return t_mode_enabled(self.n_dev, 1, starts_len * row_block)

    def extract(
        self, perm_ext, starts, row_block, cand_cap, upper_only=False,
        from_T=False,
    ):
        """One extraction pass: (grow, cand, counts) device tensors with a
        leading block axis (the JAX ``extract`` with ``do_join=False``;
        its in-scan join is ROADMAP Queue 1 item 8)."""
        perm_d = self._put(np.asarray(perm_ext, np.int32))
        starts_d = self._put(np.asarray(starts, np.int64))
        src = self.bound_bits(perm_ext, starts, row_block) if from_T else (
            self.sig
        )
        return _candidate_blocks(
            src, self.col_lens, perm_d, starts_d, row_block, cand_cap,
            self.G, self.k2, upper_only=upper_only, from_T=from_T,
        )

    def grow_layout(self, perm_ext, starts, row_block: int) -> np.ndarray:
        """Host twin of extract()'s ``grow``: the permutation sliced at
        the block starts."""
        pe = np.asarray(perm_ext)
        return np.stack([pe[s : s + row_block] for s in starts])

    def pair_capacity_from_worst(self, worst: int) -> int:
        """Flat pair-list capacity: the pair total rounded up to a power
        of two (at least one 128-pair block).  The TPU path also chose a
        gather chunk here; the CUDA kernel reads rows by index and has
        none."""
        if worst >= 2**31:
            raise ValueError("pair list exceeds int32 indexing")
        return _next_pow2(max(worst, _PAIR_BLOCK))

    def pair_capacity(self, counts_h: np.ndarray, cand_cap: int) -> int:
        nf = np.where(counts_h > cand_cap, 0, counts_h)
        return self.pair_capacity_from_worst(int(nf.sum(dtype=np.int64)))

    def flatten_join(self, grow, cand, counts, cand_cap: int, pair_cap: int):
        """Compact the (cand, counts) extraction output into a flat pair
        list, join every pair with ``join_kernel`` and apply the
        reference's validity test (library.cpp:499-500, exact integer
        form).  Overflowing rows (counts > cand_cap) emit nothing.

        Returns [pair_cap] tensors (pi, pj, inter, perc, tr, valid);
        padding slots carry pi == pj == G (an empty profile, depth 0)."""
        dev = self.device
        K = cand.shape[-1]
        gf = grow.reshape(-1)
        cf = cand.reshape(-1, K)
        nf = counts.reshape(-1)
        nf = torch.where(nf > K, torch.zeros_like(nf), nf)
        cs = torch.cumsum(nf, 0, dtype=torch.int64)
        total = cs[-1]
        p = torch.arange(pair_cap, dtype=torch.int64, device=dev)
        # row of pair slot p: every row with candidates marks its index
        # at its exclusive base; a running max fills the row's slot range.
        # JAX drops out-of-range scatter indices (.at[].max(mode="drop"));
        # torch would fault, so they are removed first.
        b = cs - nf
        row_ids = torch.arange(gf.shape[0], dtype=torch.int64, device=dev)
        sel = (nf > 0) & (b < pair_cap)
        marks = torch.zeros(pair_cap, dtype=torch.int64, device=dev)
        marks.scatter_reduce_(0, b[sel], row_ids[sel], "amax")
        r = torch.cummax(marks, 0).values
        r_safe = torch.clamp(r, max=gf.shape[0] - 1)
        base = torch.where(
            r_safe > 0, cs[torch.clamp(r_safe - 1, min=0)],
            torch.zeros_like(r_safe),
        )
        s = torch.clamp(p - base, 0, K - 1)
        ok = p < total
        pad = torch.full((pair_cap,), self.G, dtype=torch.int32, device=dev)
        pi = torch.where(ok, gf[r_safe].to(torch.int32), pad)
        pj = torch.where(ok, cf[r_safe, s].to(torch.int32), pad)
        inter, perc, tr = self.join(pi, pj)
        k2f = float(self.k2)
        valid = (inter > 0) & (
            (k2f * perc >= self.col_lens[pi.long()])
            | (k2f * tr >= self.col_lens[pj.long()])
        )
        return pi, pj, inter, perc, tr, valid


def get_runner(index: KmerIndex, padded, config, device) -> Runner:
    """Runner cached on the index per (padded shape, device, join
    kernel)."""
    rkey = ("runner", padded.ids.shape, str(device), config.join_kernel)
    cache = index._pad_cache  # populated by pad_profiles
    runner = cache.get(rkey)
    if runner is None:
        runner = Runner(index, padded, config, device)
        cache[rkey] = runner
    return runner


def work_model(
    index: KmerIndex, config: Optional[PipelineConfig] = None
) -> dict:
    """Analytic device-work model of one extraction + join pass, with the
    JAX package's keys and values:

    - ``bound_matmul_flops`` of the bound-bit build (one [n_pos, B] x
      [B, n_pos] matmul in T mode, two [rows, B] x [B, G_pad] otherwise);
    - ``join_ops_per_pair``: the JAX package's compare-and-rotate cost,
      W^2 id compares at ~4 vector ops each (kept as that package
      defines it; the roll kernel here is a sorted search);
    - ``join_lane2_ops_per_pair``: the lane2 join's, ~mean_depth^2 slot
      rows of 128 lanes at ~10 ops each."""
    from pandelos_tpu_torch.ops.hist import pick_buckets
    from pandelos_tpu_torch.ops.lane_join import lane_depths

    config = config or PipelineConfig()
    G = index.n_sequences
    if G == 0:
        return {"bound_matmul_flops": 0, "join_ops_per_pair": 0}
    mean_depth = float(lane_depths(index).mean())
    row_block = min(config.row_block, _round_up(G, 8))
    col_block = min(config.col_block, _round_up(G, 128))
    W = max(128, _round_up(max(1, index.max_profile_len), 128))
    G_pad = _round_up(G + 1, max(row_block, col_block))
    B, _ = pick_buckets(
        index.vocab_size, max(1, index.max_profile_len), index.k,
        n_genes=G_pad,
    )
    rows = -(-G // row_block) * row_block
    t_mode = t_mode_enabled(1, 1, rows)
    return {
        "bound_matmul_flops": float(
            2.0 * rows * B * rows if t_mode else 4.0 * rows * B * G_pad
        ),
        "bound_bits_mode": bool(t_mode),
        "join_ops_per_pair": float(4.0 * W * W),
        "join_lane2_ops_per_pair": 10.0 * 128.0 * mean_depth * mean_depth,
        "signature_buckets": int(B),
        "padded_width": int(W),
        "padded_genes": int(G_pad),
    }


def memory_model(
    index: KmerIndex, config: Optional[PipelineConfig] = None,
    budget_bytes: Optional[float] = None, device=None,
) -> dict:
    """Device-memory accounting of the single-device engine against the
    card's memory (``torch.cuda.get_device_properties(dev).total_memory``
    unless ``budget_bytes`` is given): signatures and their presence
    copy in bf16, the padded profiles, the table of the join kernel the
    run takes (packed lane2 [G_pad, D*128], unpacked lane [G_pad,
    2*D*128] or pair [G_pad, 2W], each its own allocation), the bound-bit
    matrix and its transpose, and the extraction workspace."""
    config = config or PipelineConfig()
    if budget_bytes is None:
        budget_bytes = float(
            torch.cuda.get_device_properties(
                device if device is not None else 0
            ).total_memory
        )
    G = index.n_sequences
    wm = work_model(index, config)
    if G == 0:
        return {"fits": True, "budget_bytes": budget_bytes, **wm}
    G_pad = wm["padded_genes"]
    W = wm["padded_width"]
    B = wm["signature_buckets"]
    from pandelos_tpu_torch.ops.lane_join import lane_depth

    kernel = join_kernel_for(index, config)
    R = min(config.row_block, _round_up(G, 8))
    rows = -(-G // R) * R
    sig = 2 * 2 * G_pad * B  # bf16 masses + the permuted copy
    pres = 2 * rows * B  # bf16 presence of the permuted copy
    profiles = 2 * 4 * G_pad * W  # ids + counts
    join_table = {
        "lane2": 4 * G_pad * lane_depth(index) * 128,
        "lane": 8 * G_pad * lane_depth(index) * 128,
        "roll": 8 * G_pad * W,
    }[kernel]
    t_bytes = 2 * rows * rows if t_mode_enabled(1, 1, rows) else 0
    workspace = 4 * _T_ROWS * rows + 3 * _MASK_ELEMS + 6 * 4 * (1 << 21)
    total = sig + pres + profiles + join_table + t_bytes + workspace
    return {
        **wm,
        "budget_bytes": budget_bytes,
        "join_kernel": kernel,
        "sig_bytes": int(sig + pres),
        "profile_bytes": int(profiles),
        "join_table_bytes": int(join_table),
        "bound_bits_bytes": int(t_bytes),
        "workspace_bytes": int(workspace),
        "total_bytes": int(total),
        "fits": total <= budget_bytes,
    }


def check_hbm_fit(index: KmerIndex, config, device) -> None:
    """Fail fast with an actionable message when the engine's footprint
    exceeds the card's memory, instead of an out-of-memory error
    mid-run.  ``PANDELOS_IGNORE_HBM_MODEL=1`` overrides (the model is
    analytic, not measured).  No check on the CPU (host RAM)."""
    if os.environ.get("PANDELOS_IGNORE_HBM_MODEL") == "1":
        return
    if torch.device(device).type != "cuda":
        return
    mm = memory_model(index, config, device=device)
    if mm["fits"]:
        return
    raise MemoryError(
        f"the single-device engine needs ~{mm['total_bytes']/1e9:.1f}GB "
        f"(card {mm['budget_bytes']/1e9:.1f}GB): signatures "
        f"{mm['sig_bytes']/1e9:.1f}GB + profiles "
        f"{mm['profile_bytes']/1e9:.1f}GB + {mm['join_kernel']} join table "
        f"{mm['join_table_bytes']/1e9:.1f}GB + bound bits "
        f"{mm['bound_bits_bytes']/1e9:.1f}GB; shard the input by genome "
        f"subsets or wait for the multi-GPU path (ROADMAP Queue 1 item 9); "
        f"PANDELOS_IGNORE_HBM_MODEL=1 overrides"
    )


def _host_fallback_rows(index: KmerIndex, rows) -> ScoreCells:
    """Exact posting walk for a small set of rows (candidate overflow past
    the device retry): every cell of those rows, invalid ones included
    (the finalization drops them)."""
    return cells_of_rows(index, rows)


# the largest candidate cap of the device retry; rows past it take the
# host posting walk
MAX_RETRY_CAP = 4096


def _mirrored(i, j, inter, perc, tr):
    """Upper-triangle cells (i < j) and their mirrors (j, i), whose perc
    and tr exchange (the validity test is direction-symmetric,
    library.cpp:499-500)."""
    return (
        np.concatenate([i, j]).astype(np.int32),
        np.concatenate([j, i]).astype(np.int32),
        np.concatenate([inter, inter]).astype(np.int64),
        np.concatenate([perc, tr]).astype(np.int64),
        np.concatenate([tr, perc]).astype(np.int64),
    )


def _valid_pairs(runner: Runner, grow, cand, counts, K: int, capture=None):
    """Flatten + join + validity over one extraction; the valid pairs'
    (pi, pj, inter, perc, tr) on the host."""
    counts_h = counts.reshape(-1).cpu().numpy()
    pair_cap = runner.pair_capacity(counts_h, K)
    out = runner.flatten_join(grow, cand, counts, K, pair_cap)
    if capture is not None:
        capture.update(table=runner.join_table, dg=runner.dg, pi=out[0],
                       pj=out[1], inter=out[2], perc=out[3], tr=out[4],
                       join_kernel=runner.join_kernel)
    keep = out[5] & (out[0] < runner.G)
    return [x[keep].cpu().numpy() for x in out[:5]]


def compute_cells_candidate(
    index: KmerIndex, config: Optional[PipelineConfig] = None, device=None,
    capture: Optional[dict] = None,
) -> ScoreCells:
    """Every VALID cell (both orientations) through the candidate engine
    on one device: the counterpart of the JAX package's
    ``compute_cells_candidate`` with backend ``"pallas"``.

    One extraction pass (upper triangle only: each unordered pair once,
    in its lower-id row's list) feeds the flatten + join + validity step
    with ``config.join_kernel``; the host mirrors the valid cells.  Rows
    whose candidates overflow ``config.candidate_cap`` are rerun on the
    device with a cap of their count rounded up to 128 when that is at
    most 4096, else walked exactly on the host
    (:func:`_host_fallback_rows`, whose invalid cells the finalization
    drops).  The JAX package's device retry joins inside its extraction
    scan (the xla backend's in-scan join, ROADMAP Queue 1 item 8); here
    the retry extracts without joining and runs the same flatten + join
    through the selected kernel.  The counters are exact integers either
    way, so the cells are equal as a set.

    ``capture``, when given, receives the runner and the main pass's
    join inputs and outputs (see ``compute_network_device``)."""
    config = config or PipelineConfig()
    dev = resolve_device(device if device is not None else config.device)
    configure_numerics()
    G = index.n_sequences
    if G == 0 or index.profile_ids.size == 0:
        z32 = np.zeros(0, dtype=np.int32)
        z64 = np.zeros(0, dtype=np.int64)
        return ScoreCells(z32, z32, z64, z64, z64)

    check_hbm_fit(index, config, dev)
    row_block = min(config.row_block, _round_up(G, 8))
    col_block = min(config.col_block, _round_up(G, 128))
    padded = pad_profiles(index, row_block, col_block)
    K = config.candidate_cap
    runner = get_runner(index, padded, config, dev)
    sig_mass, _, _ = build_signatures(
        index, padded, runner.all_ids, runner.all_counts
    )
    runner.set_sig(sig_mass)

    widths = np.diff(index.profile_ptr)
    perm = np.argsort(widths, kind="stable").astype(np.int32)
    n_blocks = -(-G // row_block)
    perm_pad = np.full(n_blocks * row_block, G, dtype=np.int32)
    perm_pad[:G] = perm
    perm_ext = np.concatenate([perm_pad, np.full(row_block, G, np.int32)])
    starts = np.arange(0, n_blocks * row_block, row_block, np.int32)
    use_T = runner.use_bound_bits(len(starts), row_block)
    grow_d, cand_d, counts_d = runner.extract(
        perm_ext, starts, row_block, K, upper_only=True, from_T=use_T,
    )
    if capture is not None:
        capture.update(runner=runner, perm_ext=perm_ext, starts=starts,
                       row_block=row_block, use_T=use_T)
    counts_h = counts_d.reshape(-1).cpu().numpy()
    grow_h = runner.grow_layout(perm_ext, starts, row_block).reshape(-1)
    over = (counts_h > K) & (grow_h < G)
    parts = [_mirrored(*_valid_pairs(runner, grow_d, cand_d, counts_d, K,
                                     capture))]

    if over.any():
        rows = np.sort(grow_h[over]).astype(np.int32)
        K2 = _round_up(int(counts_h[over].max()), 128)
        if K2 <= MAX_RETRY_CAP:
            pad = (-len(rows)) % row_block
            perm2 = np.concatenate(
                [rows, np.full(pad + row_block, G, dtype=np.int32)]
            )
            starts2 = np.arange(
                0, len(perm2) - row_block, row_block, dtype=np.int32
            )
            out = runner.extract(perm2, starts2, row_block, K2,
                                 upper_only=True)
            parts.append(_mirrored(*_valid_pairs(runner, *out, K2)))
        else:
            # upper-triangle discipline: keep col > row and mirror, so
            # partner rows' mirrored cells are not duplicated
            fb = _host_fallback_rows(index, rows)
            keep = fb.col > fb.row
            parts.append(_mirrored(
                fb.row[keep], fb.col[keep], fb.intersection[keep],
                fb.perc_cnt[keep], fb.tr_perc_cnt[keep],
            ))
    return ScoreCells(*(np.concatenate(x) for x in zip(*parts)))
