"""Candidate engine: signatures, bound bits, extraction, the fused
flatten + exact join + validity step, and the cells path.

The counterpart of the JAX package's ``ops/candidate.py``, for the
passes that ``compute_network_device`` and :func:`compute_cells_candidate`
run.  The :class:`Runner` (the JAX ``MeshRunner``) deals the row blocks
round-robin over the shards of a
:class:`~pandelos_tpu_torch.parallel.shards.ShardGroup`; each shard
extracts and joins its own rows against the replicated profiles and
signatures:

1. **Signatures** (``build_signatures``): per-gene bucket masses, rounded
   up to bf16, so that for genes i, j::

       perc_bound(i, j) = sum_b S[i, b] * [S[j, b] > 0]  >=  perc_cnt(i, j)

   (true shared k-mers land in buckets both genes occupy).
2. **Bound bits** (``_bound_bits_blocks``): ``T[p, q] = 2k *
   perc_bound(perm[p], perm[q]) >= len(perm[p])`` as int8 over
   width-sorted positions, one matmul per row block with an exact f32
   result, returned as ``T | T^T`` (the candidate mask is symmetric).
   Past the 4 GB cap, and over more than one shard, the extraction
   takes the two-matmul form instead.
3. **Extraction** (``_candidate_blocks``): the first K candidate columns
   of every row in ascending column order, and each row's candidate
   count (rows with count > K are rerun at a larger K by the caller).
4. **Flatten + join + validity** (``Runner.flatten_join``, backend
   ``"cuda"``): the per-row lists become one flat pair list
   (``ops/flat_pairs.py``: ``csrc/flat_pairs.cu`` on a card); the selected
   CUDA join kernel (``Runner.join_kernel``: lane2, lane or roll) joins
   every pair exactly; the reference's validity test is applied.
4'. **In-scan join** (``_join_slots``, backend ``"xla"``): the exact
   counters and validity of every (row, candidate slot) of the
   extraction, [rows, K] like the JAX package's ``do_join=True`` scan,
   by a sorted search of each row's ids in each candidate's profile.
   Array code, no join kernel, as in the JAX package.

Every summand of the bound matmuls is an integer (a bf16 round-up of an
integer is an integer) and every partial sum is < 2^24, so any f32
accumulation order gives the same bits; bf16 products are exact in f32.
The matmuls therefore run with bf16 operands and an f32 result on the
card (TF32 and reduced-precision reductions off), f32 operands on the
CPU.
"""

from __future__ import annotations

import os
import weakref
from typing import Optional

import numpy as np
import torch

from pandelos_tpu_torch import tracing
from pandelos_tpu_torch.config import (
    PipelineConfig,
    resolve_backend,
    ring_engaged,
)
from pandelos_tpu_torch.device import (
    configure_numerics,
    mm_f32,
    resolve_device,
)
from pandelos_tpu_torch.index import KmerIndex
from pandelos_tpu_torch.oracle.cells import ScoreCells, cells_of_rows
from pandelos_tpu_torch.ops.flat_pairs import flat_pairs
from pandelos_tpu_torch.ops.score import (
    _round_up,
    _width_buckets,
    pad_profiles,
)

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
        bnd = mm_f32(sig_perm[r0:r1], pres_t)  # [rows, n_pos] exact f32
        T[r0:r1] = (float(k2) * bnd >= lens_perm[r0:r1, None]).to(torch.int8)
    return T | T.t()


def first_k(mask, K: int) -> tuple:
    """Rank-select over a [rows, cols] bool mask: each row's count of set
    columns (int32), and (row, rank, column) of every row's first ``K``
    set columns in ascending column order.  ``nonzero`` walks the mask
    row-major, so a set bit's rank is its index minus its row's
    exclusive base."""
    cnt = mask.sum(1, dtype=torch.int32)
    with tracing.blocked():  # the host waits for the set bits' count
        nz = mask.nonzero()
    rr, cc = nz[:, 0], nz[:, 1]
    base = torch.cumsum(cnt.long(), 0) - cnt.long()
    rank = torch.arange(nz.shape[0], device=mask.device) - base[rr]
    keep = rank < K
    return cnt, rr[keep], rank[keep], cc[keep]


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
            perc_bnd = mm_f32(sig_bf[g], sig_pres.t())
            tr_bnd = mm_f32(sig_pres[g], sig_bf.t())
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
        cnt, rr, rank, cc = first_k(mask, K)
        counts[r0:r1] = cnt
        val = cols_gene[cc] if from_T else cc.to(torch.int32)
        val = torch.clamp(val, max=G_pad - 1).to(torch.int32)
        cand[r0 + rr, rank] = val
    n_blocks = starts.shape[0]
    return (
        grow.reshape(n_blocks, R),
        cand.reshape(n_blocks, R, K),
        counts.reshape(n_blocks, R),
    )


# bytes that _join_slots allocates, every temporary summed (a bound of
# its peak): per entry of a chunk's searched rows (ids, counts, search
# positions, matches, gathered counts; a pair's indices and sums spread
# over its >= 128 entries), and per [rows, K] slot (the long candidate
# ids, the counters, the slot list, the validity test)
_JOIN_ENTRY_BYTES = 40
_JOIN_SLOT_BYTES = 48
# the rest of the xla backend's [rows, K] work per slot, every temporary
# summed: the extraction's candidate lists and the device BBH over them
_BBH_SLOT_BYTES = 256
# the "cuda" backend's flat path, every temporary summed as above: per
# [rows, K] slot the extraction's candidate lists and the flat BBH's
# re-expansion to [rows, K]; per flat pair slot (``pair_cap``) the pair
# list, the join kernel's three outputs and the flat BBH's per-pair
# scores
_FLAT_BBH_SLOT_BYTES = 176
_PAIR_SLOT_BYTES = 328
# a slot of the device BBH's heavy-row segment ([rows, valid cells]): its
# counters and validity, as the in-scan join holds them, and the BBH over
# them
_HEAVY_SLOT_BYTES = _JOIN_SLOT_BYTES + _BBH_SLOT_BYTES
# compute_network_device doubles its main extraction's cap up to this;
# rows whose candidates pass it take the heavy-row pass (extracted again
# at their own cap, in chunks of at most the main extraction's slots)
MAX_CANDIDATE_CAP = 1024


def join_slots_bytes(n_slots: int, W: int,
                     n_pairs: Optional[int] = None) -> int:
    """What :func:`_join_slots` allocates over ``n_slots`` [rows, K]
    slots of width-``W`` profiles, of which ``n_pairs`` (at most all)
    are searched."""
    n_pairs = n_slots if n_pairs is None else n_pairs
    return (_JOIN_ENTRY_BYTES * min(join_chunk(W), n_pairs) * W
            + _JOIN_SLOT_BYTES * n_slots)


def join_chunk(W: int) -> int:
    """(row, slot) pairs that :func:`_join_slots` searches at once: about
    2^25 b-row entries of width ``W``."""
    return max(1, (1 << 25) // W)


def _join_slots(all_ids, all_counts, col_lens, grow, cand, counts,
                w_row: int, k2: int, pair_chunk: Optional[int] = None):
    """The JAX package's in-scan join: for every (row, candidate slot)
    of an extraction, the exact (inter, perc, tr) of the row's first
    ``w_row`` profile slots against the candidate's whole profile, and
    the validity, each [n_blocks, R, K] like ``grow``/``cand``.

    The JAX body compares every pair of slots; here each a id is looked
    up in the b row by a sorted search (profiles are id-sorted and
    left-packed, with the sentinel ``vocab_size`` above every real id),
    which names the same matches: inter sums min(ca, cb), perc ca and tr
    cb over them.  Padding slots match padding slots with count 0 and
    add nothing.  Slots past a row's count (``have`` false) stay 0 and
    invalid, as the JAX package's (they join the empty gene there).
    Every counter is an integer below 2^24: exact in f32 in any order.

    ``pair_chunk`` bounds the (row, slot) pairs searched at once (by
    default :func:`join_chunk`); :func:`join_slots_bytes` counts what the
    join allocates."""
    dev = cand.device
    K = cand.shape[-1]
    W = all_ids.shape[1]
    G_pad = all_ids.shape[0]
    gf = grow.reshape(-1).long()
    cf = cand.reshape(-1, K).long()
    nf = counts.reshape(-1)
    have = torch.arange(K, device=dev)[None, :] < nf[:, None]
    inter = torch.zeros(cf.shape, dtype=torch.float32, device=dev)
    perc = torch.zeros_like(inter)
    tr = torch.zeros_like(inter)
    with tracing.blocked():
        rr, ss = have.nonzero(as_tuple=True)
    step = pair_chunk or join_chunk(W)
    for p0 in range(0, rr.shape[0], step):
        r, sl = rr[p0: p0 + step], ss[p0: p0 + step]
        a, b = gf[r], cf[r, sl]
        a_ids = all_ids[a, :w_row]
        b_ids = all_ids[b]
        pos = torch.searchsorted(b_ids, a_ids).clamp_(max=W - 1)
        miss = torch.gather(b_ids, 1, pos) != a_ids
        del a_ids, b_ids
        a_cnt = all_counts[a, :w_row].masked_fill_(miss, 0)
        b_cnt = torch.gather(all_counts[b], 1, pos).masked_fill_(miss, 0)
        inter[r, sl] = torch.minimum(a_cnt, b_cnt).sum(1).to(torch.float32)
        perc[r, sl] = a_cnt.sum(1).to(torch.float32)
        tr[r, sl] = b_cnt.sum(1).to(torch.float32)
    # validity: the JAX package's f32 form of the 1/(2k) threshold
    row_lens = col_lens[torch.clamp(gf, max=G_pad - 1)]
    cand_lens = col_lens[torch.clamp(cf, max=G_pad - 1)]
    valid = (inter > 0) & have & (
        (float(k2) * perc >= row_lens[:, None])
        | (float(k2) * tr >= cand_lens)
    )
    shape = cand.shape
    return (inter.reshape(shape), perc.reshape(shape), tr.reshape(shape),
            valid.reshape(shape))


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
    """The counterpart of the JAX package's ``MeshRunner``: the padded
    profiles, signatures, join tables and per-gene depths of one index,
    replicated on the devices of a shard group
    (:class:`~pandelos_tpu_torch.parallel.shards.ShardGroup`; shards that
    share a device share them), and the extraction and flatten-join
    passes, each shard over its own row blocks.

    Row-block starts are dealt round-robin over the global shards
    (:meth:`_pad_starts`), so every shard gets an even mix of the
    width-sorted blocks.  One shard in one process is the single-device
    engine: its starts run as they are, and the bound-bit matrix (T mode)
    may replace the two bound matmuls.

    The index caches its runner (:func:`get_runner`), so the runner
    holds the index weakly: with a strong reference each would keep the
    other, and a run's device tensors would outlive it until a cyclic
    collection."""

    def __init__(self, index: KmerIndex, padded, config, shards):
        from pandelos_tpu_torch.parallel.shards import ShardGroup

        if not isinstance(shards, ShardGroup):
            shards = ShardGroup([resolve_device(shards)])
        G_pad = padded.ids.shape[0]
        self._index = weakref.ref(index)
        self.shards = shards
        self.device = shards.devices[0]
        self.G = index.n_sequences
        self.k2 = 2 * index.k
        self.w_pad = padded.width
        self.G_pad = G_pad
        self.n_dev = shards.n
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
        self._copies = {}
        self.lane_D = 0

    @property
    def index(self) -> KmerIndex:
        index = self._index()
        if index is None:
            raise ReferenceError("the runner's index was freed")
        return index

    def _put(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def on(self, name: str, dev) -> torch.Tensor:
        """The replicated tensor ``name`` (an attribute: ``all_ids``,
        ``sig``, ``join_table``, ``dg``, ...) on ``dev``: the runner's own
        on the first shard's device, a copy made once on any other."""
        t = getattr(self, name)
        dev = torch.device(dev)
        if dev == self.device:
            return t
        key = (name, str(dev))
        if key not in self._copies:
            self._copies[key] = t.to(dev)
        return self._copies[key]

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
        ``join_kernel``, on the device of ``pi``."""
        from pandelos_tpu_torch.ops.lane_join import lane2_join, lane_join
        from pandelos_tpu_torch.ops.pair_join import join_pairs_core

        dev = pi.device
        if self.join_kernel == "roll":
            return join_pairs_core(self.on("join_table", dev), pi, pj)
        fn = lane2_join if self.join_kernel == "lane2" else lane_join
        return fn(self.on("join_table", dev), self.on("dg", dev), pi, pj)

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

    def release_bound_bits(self) -> None:
        """Drop the memoized bound-bit matrices (the largest allocation of
        a run, [rows, rows] int8): only extraction passes over their
        layout read them; a later call builds them again."""
        self._T_cache.clear()

    def use_bound_bits(self, starts_len: int, row_block: int) -> bool:
        """T mode: one shard in one process, T within its byte cap.  The
        bound is symmetric, and T's halving reads ``T | T^T``: a
        row-sharded T would need every shard's column slab of every other
        shard's rows, so sharded runs keep the two bound matmuls."""
        return t_mode_enabled(self.n_dev, self.shards.world,
                              starts_len * row_block)

    def _pad_starts(self, starts: np.ndarray, inert: int) -> np.ndarray:
        """Round-robin global starts layout: original block t goes to
        position (t % n_dev) * S + (t // n_dev), S = next_pow2(ceil(n /
        n_dev)), so every shard gets an even mix of the width spectrum;
        padding is the inert start (an all-padding block that emits zero
        candidates).  One shard runs the exact block list as it is."""
        n = len(starts)
        if self.n_dev == 1:
            return np.asarray(starts, np.int32)
        S = _next_pow2(max(1, -(-n // self.n_dev)))
        sg = np.full(S * self.n_dev, inert, dtype=np.int32)
        t = np.arange(n)
        sg[(t % self.n_dev) * S + t // self.n_dev] = starts
        return sg

    def shard_starts(self, perm_ext, starts, row_block: int) -> list:
        """This process's shards' row-block starts in the round-robin
        layout: int64 tensors, one a local shard, on its device."""
        sg = self._pad_starts(np.asarray(starts, np.int32),
                              len(perm_ext) - row_block)
        return self.shards.shard0(sg.astype(np.int64))

    def extract_shards(
        self, perm_ext, starts, row_block, w_row, cand_cap, do_join=True,
        upper_only=False, from_T=False,
    ) -> list:
        """One extraction pass over every local shard's row blocks: a
        list (one entry a local shard) of the JAX ``MeshRunner.extract``
        outputs, each on its shard's device with a leading block axis:
        (grow, cand, counts) with ``do_join=False``, (grow, cand, inter,
        perc, tr, valid, counts) with the in-scan join of each row's
        first ``w_row`` profile slots (:func:`_join_slots`).  Inert
        blocks emit rows with grow == G.  ``from_T`` (one shard only):
        bounds from the memoized bound-bit matrix."""
        if from_T and self.n_dev != 1:
            raise ValueError("bound-bit extraction is single-shard")
        local = self.shard_starts(perm_ext, starts, row_block)
        src = self.bound_bits(perm_ext, starts, row_block) if from_T \
            else None
        perm = self.shards.replicate(np.asarray(perm_ext, np.int32))
        # the replicated tensors on every device, before any thread runs
        names = ("col_lens",) + (() if from_T else ("sig",)) + (
            ("all_ids", "all_counts") if do_join else ())
        for dev in self.shards.devices:
            for name in names:
                self.on(name, dev)

        def one(args):
            dev, st, perm_d = args
            grow, cand, counts = _candidate_blocks(
                src if from_T else self.on("sig", dev),
                self.on("col_lens", dev), perm_d, st, row_block, cand_cap,
                self.G, self.k2, upper_only=upper_only, from_T=from_T,
            )
            if not do_join:
                return grow, cand, counts
            joined = _join_slots(
                self.on("all_ids", dev), self.on("all_counts", dev),
                self.on("col_lens", dev), grow, cand, counts, w_row,
                self.k2)
            return (grow, cand) + joined + (counts,)

        return self.shards.map(one, zip(self.shards.devices, local, perm))

    def extract_fetched(self, *args, **kwargs):
        """:meth:`extract_shards` with every output on the host as NumPy:
        the global arrays, every shard's blocks in global shard order."""
        outs = self.extract_shards(*args, **kwargs)
        return self.shards.fetch_many(*zip(*outs))

    def grow_layout(self, perm_ext, starts, row_block: int) -> np.ndarray:
        """Host twin of the global ``grow``: the permutation sliced at
        the round-robin starts of every shard."""
        sg = self._pad_starts(np.asarray(starts, np.int32),
                              len(perm_ext) - row_block)
        pe = np.asarray(perm_ext)
        return np.stack([pe[s : s + row_block] for s in sg])

    def pair_capacity_from_worst(self, worst: int) -> int:
        """Flat pair-list capacity of every shard from the largest
        shard's pair total: rounded up to a power of two (at least one
        128-pair block).  The TPU path also chose a gather chunk here; the
        CUDA kernels read rows by index and have none, whatever the join
        kernel."""
        if worst >= 2**31:
            raise ValueError("pair list exceeds int32 indexing")
        return _next_pow2(max(worst, _PAIR_BLOCK))

    def pair_capacity(self, counts_h: np.ndarray, cand_cap: int) -> int:
        """:meth:`pair_capacity_from_worst` of the global per-row
        candidate counts [n_dev * S * R]: the worst shard's total of rows
        that do not overflow."""
        return self.pair_capacity_from_worst(
            int(self.pairs_per_shard(counts_h, cand_cap).max(initial=0)))

    def pairs_per_shard(self, counts_h: np.ndarray,
                        cand_cap: int) -> np.ndarray:
        """Each global shard's flat pair total (rows past ``cand_cap``
        emit none) from the global per-row candidate counts."""
        nf = np.where(counts_h > cand_cap, 0, counts_h)
        return nf.reshape(self.n_dev, -1).sum(axis=1, dtype=np.int64)

    def flatten_join(self, grow, cand, counts, cand_cap: int, pair_cap: int,
                     launched=None):
        """One shard's step: compact its (cand, counts) extraction output
        into a flat pair list, join every pair with ``join_kernel`` and
        apply the reference's validity test (library.cpp:499-500, exact
        integer form).  Overflowing rows (counts > cand_cap) emit nothing.
        Runs on the device of ``grow``; any leading axes (blocks, ring
        steps) flatten row-major.  ``launched``, a list, gets a 1 for each
        launch of the fill kernel.

        Returns [pair_cap] tensors (pi, pj, inter, perc, tr, valid);
        padding slots carry pi == pj == G (an empty profile, depth 0)."""
        dev = grow.device
        pi, pj = flat_pairs(grow, cand, counts, pair_cap, self.G, launched)
        inter, perc, tr = self.join(pi, pj)
        k2f = float(self.k2)
        col_lens = self.on("col_lens", dev)
        valid = (inter > 0) & (
            (k2f * perc >= col_lens[pi.long()])
            | (k2f * tr >= col_lens[pj.long()])
        )
        return pi, pj, inter, perc, tr, valid

    def flatten_join_shards(self, outs, cand_cap: int, pair_cap: int):
        """:meth:`flatten_join` of every local shard's (grow, cand,
        counts); a list, one entry a local shard.  The fill kernel's
        launches are added to the current span's ``fill_launches``."""
        for dev in self.shards.devices:  # tables first, outside threads
            for name in ("col_lens", "join_table") + (
                    () if self.join_kernel == "roll" else ("dg",)):
                self.on(name, dev)

        def one(o):
            launched = []
            return (self.flatten_join(*o, cand_cap, pair_cap, launched),
                    len(launched))

        done = self.shards.map(one, outs)
        tracing.add("fill_launches", sum(n for _, n in done))
        return [out for out, _ in done]


def _runner_key(padded, config, shards) -> tuple:
    from pandelos_tpu_torch.parallel.shards import ShardGroup

    where = shards.key if isinstance(shards, ShardGroup) else str(shards)
    return ("runner", padded.ids.shape, where, config.join_kernel)


def cached_runner(index: KmerIndex, padded, config,
                  shards) -> Optional[Runner]:
    """The runner :func:`get_runner` would return, where an earlier run
    on this index built it; else None."""
    return getattr(index, "_pad_cache", {}).get(
        _runner_key(padded, config, shards))


def get_runner(index: KmerIndex, padded, config, shards) -> Runner:
    """Runner cached on the index per (padded shape, shard group or
    device, join kernel)."""
    rkey = _runner_key(padded, config, shards)
    cache = index._pad_cache  # populated by pad_profiles
    runner = cache.get(rkey)
    if runner is None:
        runner = Runner(index, padded, config, shards)
        cache[rkey] = runner
    return runner


def _layout(index: KmerIndex, config, n_dev: int) -> tuple:
    """(row_block, col_block, W, G_pad, B, rows, rows per shard) of a run
    over ``n_dev`` shards: ``rows`` the width-sorted blocks' rows, and a
    shard's S * R rows in the round-robin layout (all of them on one
    shard)."""
    from pandelos_tpu_torch.ops.hist import pick_buckets

    G = index.n_sequences
    row_block = min(config.row_block, _round_up(G, 8))
    col_block = min(config.col_block, _round_up(G, 128))
    W = max(128, _round_up(max(1, index.max_profile_len), 128))
    G_pad = _round_up(G + 1, max(row_block, col_block))
    B, _ = pick_buckets(
        index.vocab_size, max(1, index.max_profile_len), index.k,
        n_genes=G_pad,
    )
    n_blocks = -(-G // row_block)
    S = n_blocks if n_dev == 1 else _next_pow2(-(-n_blocks // n_dev))
    return (row_block, col_block, W, G_pad, B, n_blocks * row_block,
            S * row_block)


def _n_devices(config, n_devices=None) -> tuple:
    from pandelos_tpu_torch.parallel.distributed import world
    from pandelos_tpu_torch.parallel.shards import resolve_n_devices

    n = n_devices if n_devices is not None else resolve_n_devices(config)
    return max(1, n), world()[1]


def work_model(
    index: KmerIndex, config: Optional[PipelineConfig] = None
) -> dict:
    """Analytic device-work model of one extraction + join pass, with the
    JAX package's keys and values:

    - ``bound_matmul_flops`` of the bound-bit build (one [n_pos, B] x
      [B, n_pos] matmul in T mode, two [rows, B] x [B, G_pad] otherwise;
      T mode needs one shard in one process);
    - ``join_ops_per_pair``: the JAX package's compare-and-rotate cost,
      W^2 id compares at ~4 vector ops each (kept as that package
      defines it; the roll kernel here is a sorted search);
    - ``join_lane2_ops_per_pair``: the lane2 join's, ~mean_depth^2 slot
      rows of 128 lanes at ~10 ops each."""
    from pandelos_tpu_torch.ops.lane_join import lane_depths

    config = config or PipelineConfig()
    G = index.n_sequences
    if G == 0:
        return {"bound_matmul_flops": 0, "join_ops_per_pair": 0}
    mean_depth = float(lane_depths(index).mean())
    n_dev, n_proc = _n_devices(config)
    _, _, W, G_pad, B, rows, _ = _layout(index, config, n_dev)
    t_mode = t_mode_enabled(n_dev, n_proc, rows)
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
    cand_cap: Optional[int] = None, pair_cap: Optional[int] = None,
    n_devices: Optional[int] = None, ring: Optional[bool] = None,
    heavy_slots: int = 0,
) -> dict:
    """Device-memory accounting of the engine per device, one shard a
    device (shards that share a card share its replicated tensors, so a
    card's use is at most this times its shards), against the card's
    memory (``torch.cuda.get_device_properties(dev).total_memory`` unless
    ``budget_bytes`` is given), over ``n_devices`` shards (default as a
    run resolves it), for the replicated engine and the ring.

    Replicated engine: signatures and their presence copy in bf16, the
    padded profiles, the table of the join kernel the run takes (packed
    lane2 [G_pad, D*128], unpacked lane [G_pad, 2*D*128] or pair [G_pad,
    2W], each its own allocation), the bound-bit matrix and its transpose
    (one shard only), the extraction workspace (or, where larger, the
    lane table builder's temporaries, ``lane_join.build_temp_bytes``: the
    table is built when no workspace is held), and what the candidate
    work allocates over a shard's rows at ``cand_cap``: by default the
    largest cap the run can reach, ``MAX_CANDIDATE_CAP`` with device BBH
    and ``config.candidate_cap`` without.  Backend ``"xla"`` builds no
    join table and no bound bits; its [rows, K] work is the in-scan join
    (:func:`join_slots_bytes`) and the device BBH (``_BBH_SLOT_BYTES``).
    Backend ``"cuda"``'s is the flat path: ``_FLAT_BBH_SLOT_BYTES`` per
    [rows, K] slot and ``_PAIR_SLOT_BYTES`` per slot of the shard's flat
    pair list, whose length is ``pair_cap`` when a run knows it and else
    its largest value at ``cand_cap`` (every slot holding a pair, rounded
    up to a power of two as :meth:`Runner.pair_capacity` rounds).

    ``heavy_slots``: a shard's slots of the device BBH's heavy-row
    segment (rows whose candidates pass ``MAX_CANDIDATE_CAP``, as [rows,
    most valid cells of a row]), which a run knows once its heavy-row
    pass has joined them: each costs what a slot of the in-scan join and
    BBH costs (``_HEAVY_SLOT_BYTES``).  The pass itself works in chunks of at
    most the main extraction's slots at ``cand_cap``, which the
    candidate work above already bounds.

    Ring (``ring``, default as the device BBH decides,
    :func:`~pandelos_tpu_torch.config.ring_engaged`; ``ops/ring.py``): the
    signatures of the shard's own gene range, the column shard it holds
    and that shard's presence ([G_pad / n, B] bf16 each), its rows'
    masses and presence; the candidate lists of every ring step (a shard
    sees each of its rows once a step, so n times its rows, [n, S, R, K]
    int32) and the flat path over those virtual rows; profiles and join
    table replicated as above, the join kernel's table under either
    backend (the ring's cells path joins with it under ``"xla"`` too)."""
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
    from pandelos_tpu_torch.ops.lane_join import build_temp_bytes, lane_depth

    n_dev, n_proc = _n_devices(config, n_devices)
    ring = ring_engaged(config, n_dev) if ring is None else ring
    _, _, W, G_pad, B, rows, rows_shard = _layout(index, config, n_dev)
    # the replicated engine of backend "xla" joins in the scan; the ring
    # joins with the join kernel under either backend
    in_scan = resolve_backend(config.backend) == "xla"
    kernel = join_kernel_for(index, config)
    sig = 2 * 2 * G_pad * B  # bf16 masses + the permuted copy
    pres = 2 * rows_shard * B  # bf16 presence of the permuted copy
    Gc = -(-G_pad // n_dev)
    sig_ring = 3 * 2 * Gc * B + 2 * 2 * rows_shard * B
    profiles = 2 * 4 * G_pad * W  # ids + counts
    table_ring = {
        "lane2": 4 * G_pad * lane_depth(index) * 128,
        "lane": 8 * G_pad * lane_depth(index) * 128,
        "roll": 8 * G_pad * W,
    }[kernel]
    table_rep = 0 if in_scan else table_ring
    if cand_cap is None:
        cand_cap = config.candidate_cap if config.device_bbh is False \
            else max(config.candidate_cap, MAX_CANDIDATE_CAP)

    def candidate_work(n_slots, scan):
        if scan:
            return (join_slots_bytes(n_slots, W)
                    + _BBH_SLOT_BYTES * n_slots)
        pc = pair_cap if pair_cap is not None else _next_pow2(
            max(n_slots, _PAIR_BLOCK))
        return _FLAT_BBH_SLOT_BYTES * n_slots + _PAIR_SLOT_BYTES * pc

    heavy = _HEAVY_SLOT_BYTES * heavy_slots
    rep_temps = candidate_work(rows_shard * cand_cap, in_scan) + heavy
    ring_slots = n_dev * rows_shard * cand_cap
    ring_temps = 4 * ring_slots + 4 * n_dev * rows_shard + candidate_work(
        ring_slots, False) + heavy
    t_bytes = (
        2 * rows * rows
        if not in_scan and t_mode_enabled(n_dev, n_proc, rows) else 0
    )
    workspace = 4 * _T_ROWS * rows + 3 * _MASK_ELEMS + 6 * 4 * (1 << 21)
    # a lane table is built at the first join, when no extraction
    # workspace is held: its builder's temporaries take the workspace's
    # place where they are larger
    build = build_temp_bytes(G_pad, W) if kernel in ("lane2", "lane") else 0
    ws_rep = max(workspace, build if table_rep else 0)
    ws_ring = max(workspace, build)
    replicated_total = (sig + pres + profiles + ws_rep + table_rep
                        + rep_temps + t_bytes)
    ring_total = sig_ring + profiles + ws_ring + table_ring + ring_temps
    total = ring_total if ring else replicated_total
    join_table = table_ring if ring else table_rep
    return {
        **wm,
        "budget_bytes": budget_bytes,
        "n_devices": n_dev,
        "ring": ring,
        "join_kernel": kernel if join_table else None,
        "sig_bytes": int(sig_ring if ring else sig + pres),
        "profile_bytes": int(profiles),
        "join_table_bytes": int(join_table),
        "join_temp_bytes": int(ring_temps if ring else rep_temps),
        "bound_bits_bytes": int(0 if ring else t_bytes),
        "heavy_bytes": int(heavy),
        "workspace_bytes": int(ws_ring if ring else ws_rep),
        "total_bytes": int(total),
        "replicated_bytes_per_device": int(replicated_total),
        "ring_bytes_per_device": int(ring_total),
        "fits_replicated": replicated_total <= budget_bytes,
        "fits_ring": ring_total <= budget_bytes,
        "fits": total <= budget_bytes,
    }


def hbm_model(index: KmerIndex, config, device,
              ring: Optional[bool] = None,
              n_devices: Optional[int] = None) -> Optional[dict]:
    """:func:`memory_model` against the card of ``device``; None where no
    check applies: on the CPU (host RAM), and under
    ``PANDELOS_IGNORE_HBM_MODEL=1`` (the model is analytic, not
    measured)."""
    if os.environ.get("PANDELOS_IGNORE_HBM_MODEL") == "1":
        return None
    if torch.device(device).type != "cuda":
        return None
    return memory_model(index, config, device=device, ring=ring,
                        n_devices=n_devices)


def check_hbm_fit(index: KmerIndex, config, device,
                  ring: Optional[bool] = None,
                  n_devices: Optional[int] = None) -> None:
    """Fail fast with an actionable message when the engine's footprint
    per device (``ring``: which engine the caller runs; None: the device
    BBH's gate, as in the JAX package) exceeds the card's memory,
    instead of an out-of-memory error mid-run (no check where
    :func:`hbm_model` makes none)."""
    mm = hbm_model(index, config, device, ring=ring, n_devices=n_devices)
    if mm is None or mm["fits"]:
        return
    if mm["ring"]:
        mode = "the ring engine"
        hint = ("the replicated engine would fit "
                f"(~{mm['replicated_bytes_per_device'] / 1e9:.1f}GB): drop "
                f"config.ring_extract" if mm["fits_replicated"] else
                _CELLS_HINT)
    else:
        mode = "the replicated engine"
        hint = ("set config.ring_extract=True (signatures shard over the "
                "devices and rotate; ops/ring.py)"
                if mm["fits_ring"] and mm["n_devices"] > 1 else
                _CELLS_HINT)
    raise MemoryError(
        f"{mode} needs ~{mm['total_bytes']/1e9:.1f}GB per device "
        f"(card {mm['budget_bytes']/1e9:.1f}GB): signatures "
        f"{mm['sig_bytes']/1e9:.1f}GB + profiles "
        f"{mm['profile_bytes']/1e9:.1f}GB + {mm['join_kernel']} join table "
        f"{mm['join_table_bytes']/1e9:.1f}GB + candidate work "
        f"{mm['join_temp_bytes']/1e9:.1f}GB + bound bits "
        f"{mm['bound_bits_bytes']/1e9:.1f}GB; {hint}; "
        f"PANDELOS_IGNORE_HBM_MODEL=1 overrides"
    )


# The stage-wise memory plan of compute_network_device.  memory_model sums
# every stage's worst case (the dry run's report); the plan holds each
# stage to what its code keeps live at once.  Bytes a unit, each set as an
# upper bound of the per-span peaks the card showed at the shapes of the
# benchmark's first three cells (a calibration, PERF.md): a signature
# histogram chunk's [4096, B] masses, their f32 cast and the bf16
# round-up's bit work, an element
_HIST_ELEM_BYTES = 20
# a bound-bit row block's [4096, n_pos] products (this block's and the
# last), the scaled test and its int8 bits, an element
_BITS_ELEM_BYTES = 20
# an extraction step's [rows, columns] bound products and tests, its
# masks, and the rank-select's position, rank and base of a set bit,
# an element with every bit set
_STEP_ELEM_BYTES = 72
# flatten + join + validity over a flat pair slot: the slot's row fill,
# base and slot index, the pair ids, the join kernel's three counters and
# the validity test
_PAIR_LIVE_BYTES = 100
# what the BBH holds of the main rows' flat pair list to its end: the
# pair ids, the three counters and the validity, a slot
_PAIR_HELD_BYTES = 21
# a [rows, K] slot handed to the device BBH: while its segment is built
# (the flat scores and fractions gathered back into [rows, K]), what the
# BBH holds of it to the end (scores, fractions, long candidate and genome
# ids, the cell masks), and the BBH's transients over one segment
_HANDOVER_SLOT_BYTES = 40
_SEG_SLOT_BYTES = 40
_BBH_LIVE_SLOT_BYTES = 80
# a slot of the heavy rows' segment ([rows, most valid cells of a row]):
# candidate ids, the three counters, validity
_HEAVY_SEG_SLOT_BYTES = 17
# an emitted cell's slot (``edge_cap``): row, column, counters, acceptance
_EMIT_SLOT_BYTES = 32
# the share of the card the plan leaves unplanned: the caching
# allocator's rounding and fragmentation, cuBLAS's workspace, and kernel
# images loaded after the plan is made
_MARGIN_SHARE = 0.05


def card_memory(device) -> Optional[int]:
    """The memory plan's budget on the card of ``device``: the bytes this
    process can still hold there, what CUDA reports free and what
    the caching allocator has reserved (its tensors and its free blocks),
    less 5 % of the card (``_MARGIN_SHARE``); None where no plan binds: on
    the CPU (host RAM) and under ``PANDELOS_IGNORE_HBM_MODEL=1``."""
    if os.environ.get("PANDELOS_IGNORE_HBM_MODEL") == "1":
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev)
               - _MARGIN_SHARE * total)


def _allocated(device) -> int:
    """Bytes the caching allocator holds for tensors on ``device`` (0 off
    a card): a host-side counter, no synchronisation."""
    dev = torch.device(device)
    return int(torch.cuda.memory_allocated(dev)) if dev.type == "cuda" else 0


def _gb(n: float) -> str:
    return f"{n / 1e9:.2f}GB"


class MemoryPlan:
    """The device memory of one :func:`compute_network_device` run, stage
    by stage, on the card of its first shard: ``budget``
    (:func:`card_memory`; None where nothing binds), ``base`` (what the
    card held when the engine began), ``fixed`` (what every stage after
    the signatures holds: profiles, signatures, the join table) and
    ``stages``, each stage's planned peak, ``base`` included;
    ``planned_peak`` is the largest.

    Gate 1 (:meth:`check`) checks the stages that the shapes alone
    decide, which the constructor plans before anything reaches the card:
    the signatures, the bound-bit matrix, the extraction at the largest
    cap and the join table's build.  Gate 2 plans the candidate work from
    the counts the extraction found, beside what the card holds: each
    heavy-row chunk (:meth:`heavy`), then the main rows' flat pass and the
    BBH (:meth:`bbh`).  Each gate raises ``MemoryError`` naming the stage
    that cannot fit."""

    def __init__(self, index: KmerIndex, config, device, n_devices: int,
                 ring: bool, runner: Optional[Runner] = None):
        from pandelos_tpu_torch.ops.lane_join import (
            build_temp_bytes,
            lane_depth,
        )

        self.budget = card_memory(device)
        n_proc = _n_devices(config, n_devices)[1]
        R, _, W, Gp, B, rows, rows_shard = _layout(index, config, n_devices)
        self.W, self.G_pad, self.B = W, Gp, B
        self.rows_shard = rows_shard
        self.in_scan = resolve_backend(config.backend) == "xla"
        self.ring = ring
        self.t_mode = (not self.in_scan and not ring
                       and t_mode_enabled(n_devices, n_proc, rows))
        kernel = join_kernel_for(index, config)
        if ring:
            Gc = -(-Gp // n_devices)
            sig = 3 * 2 * Gc * B + 2 * 2 * rows_shard * B
        else:
            sig = 2 * Gp * B
        table = 0
        if ring or not self.in_scan:
            table = {"lane2": 4 * Gp * lane_depth(index) * 128,
                     "lane": 8 * Gp * lane_depth(index) * 128,
                     "roll": 8 * Gp * W}[kernel]
        build = build_temp_bytes(Gp, W) if table and kernel != "roll" else 0
        profiles = 8 * Gp * W + 4 * Gp
        self.parts = {"profiles": profiles, "signatures": sig,
                      "join table": table}
        self.fixed = profiles + sig + table
        # what a runner an earlier run built already holds on the card
        # (its profiles, its signatures and join table where built):
        # those stages do not run again
        has_sig = runner is not None and runner.sig is not None
        has_table = runner is not None and (
            {"lane2": runner._all_lane2, "lane": runner._all_lane,
             "roll": runner._all_pair}[kernel] is not None)
        cached = 0 if runner is None else (
            profiles + sig * has_sig + table * has_table)
        self.base = max(0, _allocated(device) - cached)
        self.stages = {}
        self.heavy_chunks = 0
        cap = max(config.candidate_cap, MAX_CANDIDATE_CAP)
        if not has_sig:
            self._stage("signatures", profiles + sig + min(4096, Gp) * (
                B * _HIST_ELEM_BYTES + W * 16))
        if self.t_mode:
            self._stage("bound bits", profiles + sig + 4 * rows * B + max(
                rows * rows + min(_T_ROWS, rows) * rows * _BITS_ELEM_BYTES,
                2 * rows * rows))
        self._stage("extract", self._extract_bytes(cap, cap // 2))
        if not has_table:
            self._stage("join table", self.fixed + build)

    def _stage(self, name: str, nbytes: int) -> None:
        self.stages[name] = max(self.stages.get(name, 0),
                                self.base + int(nbytes))

    @property
    def planned_peak(self) -> int:
        return max(self.stages.values())

    def _cand_bytes(self, K: int) -> int:
        """A shard's extraction outputs at cap ``K``: candidate ids, row
        ids, counts."""
        return self.rows_shard * (4 * K + 8)

    def _step_bytes(self, n_rows: int, cols: int) -> int:
        """An extraction step's temporaries over ``n_rows`` rows against
        ``cols`` columns."""
        step = max(1, _MASK_ELEMS // max(1, cols))
        return min(n_rows, step) * cols * _STEP_ELEM_BYTES

    def _extract_bytes(self, K: int, K_prev: int) -> int:
        """The extraction at cap ``K`` (the last pass's outputs, at
        ``K_prev``, still held): the bound's source (bound bits, or the
        signatures' presence copy), a step's temporaries, the outputs, and
        under ``"xla"`` the in-scan join's."""
        Gp, rows = self.G_pad, self.rows_shard
        if self.t_mode:
            src, cols = rows * rows, rows
        else:
            src, cols = 2 * Gp * self.B, Gp
        out = self._cand_bytes(K) + (self._cand_bytes(K_prev) if K_prev
                                     else 0)
        if self.in_scan:
            out += join_slots_bytes(rows * K, self.W)
        return (self.parts["profiles"] + self.parts["signatures"] + src
                + self._step_bytes(rows, cols) + out)

    def _refuse(self, stage: str) -> None:
        """Raise ``MemoryError`` where ``stage`` cannot fit."""
        nbytes = self.stages[stage]
        if self.budget is None or nbytes <= self.budget:
            return
        parts = " + ".join(f"{k} {_gb(v)}"
                           for k, v in self.parts.items() if v)
        raise MemoryError(
            f"the engine's {stage} stage needs ~{_gb(nbytes)} on a card "
            f"with {_gb(self.budget)} to give ({parts} held, "
            f"{_gb(self.base)} before the engine): shard the input by "
            f"genome subsets or add devices (config.n_devices, "
            f"config.ring_extract); PANDELOS_IGNORE_HBM_MODEL=1 overrides")

    def check(self) -> None:
        """Gate 1: raise ``MemoryError`` naming the first stage planned so
        far that cannot fit."""
        for stage in list(self.stages):
            self._refuse(stage)

    def extracted(self, K: int, K_prev: int) -> None:
        """The extraction ran to cap ``K`` (its last pass's predecessor at
        ``K_prev``, 0 for none): its stage at the caps it reached."""
        self.stages["extract"] = self.base + self._extract_bytes(K, K_prev)
        self.K = K

    def heavy_work(self, n: int, K: int) -> int:
        """What a heavy-row chunk of ``n`` rows at cap ``K`` adds to what
        the card holds: its candidate lists, and the larger of its
        extraction's temporaries (the heavy pass never reads bound bits:
        the signatures' presence copy and a step's) and its flat pair
        list's (at most a pair a slot; the in-scan join's under
        ``"xla"``)."""
        slots = n * K
        extract = 2 * self.G_pad * self.B + self._step_bytes(n, self.G_pad)
        if self.in_scan:
            return 4 * slots + extract + join_slots_bytes(slots, self.W)
        flat = _PAIR_LIVE_BYTES * _next_pow2(max(slots, _PAIR_BLOCK))
        return 4 * slots + max(extract, flat)

    def heavy(self, n: int, K: int, kept: int) -> None:
        """Gate 2, before each heavy-row chunk: ``n`` rows at cap ``K``
        beside the main extraction's outputs and ``kept``, the valid
        cells of the chunks before it."""
        held = self.base + self.fixed + self._cand_bytes(self.K) + kept
        self.heavy_chunks += 1
        self._stage("heavy", held + self.heavy_work(n, K))
        self._refuse("heavy")

    def bbh(self, pairs: int, slots: int, heavy_slots: int,
            edge_cap: int) -> None:
        """Gate 2, before the main rows' flat pass: a shard's ``pairs``
        (the most of any shard) over its ``slots`` [rows, K] slots,
        flattened, joined and handed to the BBH, beside the heavy rows'
        segment (``heavy_slots``) and the emission's ``edge_cap`` slots;
        under ``"xla"`` and on the ring the [rows, K] join outputs are
        the BBH's input."""
        held = (self.base + self.fixed + self._cand_bytes(self.K)
                + (_HEAVY_SEG_SLOT_BYTES + _SEG_SLOT_BYTES) * heavy_slots
                + _EMIT_SLOT_BYTES * edge_cap)
        if self.in_scan or self.ring:
            work = ((_JOIN_SLOT_BYTES + _BBH_SLOT_BYTES) * slots
                    + _BBH_LIVE_SLOT_BYTES * heavy_slots)
        else:
            pair_cap = _next_pow2(max(pairs, _PAIR_BLOCK))
            work = (_PAIR_HELD_BYTES * pair_cap + _SEG_SLOT_BYTES * slots
                    + max(_PAIR_LIVE_BYTES * pair_cap
                          + _HANDOVER_SLOT_BYTES * slots,
                          _BBH_LIVE_SLOT_BYTES * max(slots, heavy_slots)))
        self._stage("bbh", held + work)
        self._refuse("bbh")

    def counters(self) -> dict:
        """The ``plan`` span's counters."""
        return {"budget_bytes": self.budget or 0, "fixed_bytes": self.fixed,
                "planned_peak_bytes": self.planned_peak,
                "heavy_chunks": self.heavy_chunks}


# check_hbm_fit's hint where no other engine fits
_CELLS_HINT = ("shard the input by genome subsets, add devices, or take "
               "the device BBH (config.device_bbh, the default), whose "
               "memory plan counts the candidate work its extraction finds "
               "instead of every row at the cap")


def _host_fallback_rows(index: KmerIndex, rows) -> ScoreCells:
    """Exact posting walk for a small set of rows (candidate overflow past
    the device retry): every cell of those rows, invalid ones included
    (the finalization drops them)."""
    return cells_of_rows(index, rows)


# the largest candidate cap of the cells path's device retry; rows past
# it take the host posting walk
MAX_RETRY_CAP = 4096


def rows_layout(rows: np.ndarray, row_block: int, G: int) -> tuple:
    """(perm_ext, starts) of an extraction over ``rows`` alone: the rows
    in row blocks, padded with the empty gene ``G``, and one all-padding
    block after them (the inert block of :meth:`Runner._pad_starts`)."""
    pad = (-len(rows)) % row_block
    perm = np.concatenate(
        [np.asarray(rows, np.int32),
         np.full(pad + row_block, G, dtype=np.int32)])
    starts = np.arange(0, len(perm) - row_block, row_block, dtype=np.int32)
    return perm, starts


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


def _valid_pairs(runner: Runner, outs, counts_h, K: int, capture=None):
    """Flatten + join + validity over every shard's extraction ``outs``
    ((grow, cand, counts) a local shard; ``counts_h`` the global counts
    on the host); the valid pairs' (pi, pj, inter, perc, tr) of every
    shard on the host."""
    shards = runner.shards
    pair_cap = runner.pair_capacity(counts_h, K)
    joined = runner.flatten_join_shards(outs, K, pair_cap)
    if capture is not None:
        out = joined[0]
        capture.update(table=runner.join_table, dg=runner.dg, pi=out[0],
                       pj=out[1], inter=out[2], perc=out[3], tr=out[4],
                       join_kernel=runner.join_kernel, pair_cap=pair_cap,
                       pairs_per_shard=runner.pairs_per_shard(counts_h, K))
    pi, pj, inter, perc, tr, valid = shards.fetch_many(*zip(*joined))
    keep = valid & (pi < runner.G)
    return [x[keep] for x in (pi, pj, inter, perc, tr)]


def _valid_slots(grow, cand, inter, perc, tr, valid, rows_ok=None):
    """The valid (row, candidate) cells of an in-scan join's [.., K]
    host outputs, as (i, j, inter, perc, tr); ``rows_ok`` masks rows."""
    K = cand.shape[-1]
    grow = grow.reshape(-1)
    vmask = valid.reshape(-1, K)
    if rows_ok is not None:
        vmask = vmask & rows_ok[:, None]
    rr = np.broadcast_to(grow[:, None], vmask.shape)[vmask]
    return (
        rr.astype(np.int32),
        cand.reshape(-1, K)[vmask].astype(np.int32),
        inter.reshape(-1, K)[vmask].astype(np.int64),
        perc.reshape(-1, K)[vmask].astype(np.int64),
        tr.reshape(-1, K)[vmask].astype(np.int64),
    )


def compute_cells_candidate(
    index: KmerIndex, config: Optional[PipelineConfig] = None, device=None,
    capture: Optional[dict] = None, devices=None,
) -> ScoreCells:
    """Every VALID cell (both orientations) through the candidate engine,
    its row blocks sharded over ``config.n_devices`` shards (see
    :func:`~pandelos_tpu_torch.parallel.shards.resolve_shards`;
    ``devices`` places the shards explicitly, the testing counterpart of
    JAX's virtual devices): the counterpart of the JAX package's
    ``compute_cells_candidate``.

    Backend ``"cuda"`` (the JAX ``"pallas"``): one extraction pass (upper
    triangle only: each unordered pair once, in its lower-id row's list)
    feeds each shard's flatten + join + validity step with
    ``config.join_kernel``; the host mirrors the valid cells.  Rows whose
    candidates overflow ``config.candidate_cap`` are rerun on the device
    with a cap of their count rounded up to 128 when that is at most
    4096, else walked exactly on the host (:func:`_host_fallback_rows`,
    whose invalid cells the finalization drops).

    Backend ``"xla"``: one extraction per profile-width bucket
    (``score._width_buckets``), both orientations, each with the in-scan
    join of the rows' first ``w_bucket`` slots; no mirroring; past 4096
    the host walk's cells are kept as they come.

    Either backend's device retry reruns the overflowing rows with the
    in-scan join (:func:`_join_slots`) at the whole width, upper triangle
    and mirrored for ``"cuda"``, as the JAX package's retry does.

    ``capture``, when given, receives the runner and the main pass's
    join inputs and outputs (the first local shard's; see
    ``compute_network_device``; backend ``"cuda"`` only)."""
    from pandelos_tpu_torch.parallel.shards import resolve_shards

    config = config or PipelineConfig()
    G = index.n_sequences
    if G == 0 or index.profile_ids.size == 0:
        z32 = np.zeros(0, dtype=np.int32)
        z64 = np.zeros(0, dtype=np.int64)
        return ScoreCells(z32, z32, z64, z64, z64)
    shards = resolve_shards(config, device, devices)
    configure_numerics()

    use_kernel = resolve_backend(config.backend) == "cuda"
    # this engine is replicated whatever ring_extract says: judge its
    # bytes (the JAX package's check here takes the device BBH's gate)
    check_hbm_fit(index, config, shards.devices[0], ring=False,
                  n_devices=shards.n)
    row_block = min(config.row_block, _round_up(G, 8))
    col_block = min(config.col_block, _round_up(G, 128))
    padded = pad_profiles(index, row_block, col_block)
    K = config.candidate_cap
    runner = get_runner(index, padded, config, shards)
    sig_mass, _, _ = build_signatures(
        index, padded, runner.all_ids, runner.all_counts
    )
    runner.set_sig(sig_mass)

    widths = np.diff(index.profile_ptr)
    parts = []
    overflow = {}  # row -> its candidate count

    if use_kernel:
        perm = np.argsort(widths, kind="stable").astype(np.int32)
        n_blocks = -(-G // row_block)
        perm_pad = np.full(n_blocks * row_block, G, dtype=np.int32)
        perm_pad[:G] = perm
        perm_ext = np.concatenate(
            [perm_pad, np.full(row_block, G, np.int32)])
        starts = np.arange(0, n_blocks * row_block, row_block, np.int32)
        use_T = runner.use_bound_bits(len(starts), row_block)
        outs = runner.extract_shards(
            perm_ext, starts, row_block, padded.width, K, do_join=False,
            upper_only=True, from_T=use_T,
        )
        if capture is not None:
            capture.update(runner=runner, perm_ext=perm_ext, starts=starts,
                           row_block=row_block, use_T=use_T)
        counts_h = shards.fetch([o[2] for o in outs]).reshape(-1)
        grow_h = runner.grow_layout(perm_ext, starts, row_block).reshape(-1)
        over = (counts_h > K) & (grow_h < G)
        overflow.update(zip(grow_h[over].tolist(), counts_h[over].tolist()))
        parts.append(_mirrored(*_valid_pairs(runner, outs, counts_h, K,
                                             capture)))
    else:
        for w_row, perm_pad, starts in _width_buckets(
            widths, row_block, padded.width
        ):
            perm_ext = np.concatenate(
                [perm_pad, np.full(row_block, G, dtype=np.int32)])
            grow, cand, inter, perc, tr, valid, counts = (
                runner.extract_fetched(
                    perm_ext, starts, row_block, w_row, K, do_join=True,
                    upper_only=False,
                )
            )
            grow = grow.reshape(-1)
            counts = counts.reshape(-1)
            over = (counts > K) & (grow < G)
            for r, c in zip(grow[over].tolist(), counts[over].tolist()):
                overflow[r] = max(overflow.get(r, 0), c)
            parts.append(_valid_slots(grow, cand, inter, perc, tr, valid,
                                      rows_ok=~over))

    if overflow:
        rows = np.asarray(sorted(overflow), dtype=np.int32)
        K2 = _round_up(max(overflow.values()), 128)
        if K2 <= MAX_RETRY_CAP:
            perm2, starts2 = rows_layout(rows, row_block, G)
            grow, cand, inter, perc, tr, valid, _ = runner.extract_fetched(
                perm2, starts2, row_block, padded.width, K2, do_join=True,
                upper_only=use_kernel,
            )
            cells = _valid_slots(grow, cand, inter, perc, tr, valid)
            parts.append(_mirrored(*cells) if use_kernel else cells)
        else:
            fb = _host_fallback_rows(index, rows)
            if use_kernel:
                # upper-triangle discipline: keep col > row and mirror, so
                # partner rows' mirrored cells are not duplicated
                keep = fb.col > fb.row
                parts.append(_mirrored(
                    fb.row[keep], fb.col[keep], fb.intersection[keep],
                    fb.perc_cnt[keep], fb.tr_perc_cnt[keep],
                ))
            else:
                parts.append((fb.row, fb.col, fb.intersection, fb.perc_cnt,
                              fb.tr_perc_cnt))
    return ScoreCells(*(np.concatenate(x) for x in zip(*parts)))
