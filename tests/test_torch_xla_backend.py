"""The port's xla backend (the candidate engine with the in-scan join)
against the JAX package's on the same inputs: the in-scan join's outputs
bit for bit, the cells path (``compute_cells_candidate``) on the cases of
tests/test_candidate.py, the device BBH (``compute_network_device``) on
those of tests/test_net_device.py, and the memory model's count."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.ops import candidate as jcand
from pandelos_tpu.ops.score import pad_profiles as jax_pad_profiles
from pandelos_tpu.oracle.cells import apply_validity, compute_cells_oracle
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.ops import candidate as tcand
from pandelos_tpu_torch.ops.score import _width_buckets, pad_profiles

from tests.test_cells_and_net import _random_ds
from tests.torch_net_cases import _assert_same, _jax_result, _port
from tests.torch_port_util import twin_indexes


def _with_long_family(rng, n_genomes=3, n_fams=10):
    """A random dataset plus one family of ~200-residue proteins, so that
    the padded width (256) passes the narrow rows' bucket (128) and most
    rows carry padding."""
    ds = _random_ds(rng, n_genomes, n_fams)
    anc = rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=200)
    for g in range(n_genomes):
        s = anc.copy()
        flip = rng.random(len(s)) < 0.1
        s[flip] = rng.choice(list("ACDEFGHIKL"), size=int(flip.sum()))
        ds.sequences.append("".join(s))
        ds.names.append(f"long{g}")
        ds.descriptions.append("d")
        ds.seq_genome.append(g)
    return ds


@pytest.fixture(scope="module", params=[0, 3, 6])
def engines(request):
    """JAX MeshRunner and port Runner over one index, signatures set, and
    the width-sorted layout of the extraction."""
    ds = _with_long_family(np.random.default_rng(request.param))
    jidx, tidx = twin_indexes(ds, k=3)
    R = 8
    jcfg = JaxConfig(backend="xla", row_block=R, col_block=128)
    jpad = jax_pad_profiles(jidx, R, 128)
    tpad = pad_profiles(tidx, R, 128)
    jr = jcand.get_runner(jidx, jpad, None, jcfg)
    jsig, _, _ = jcand.build_signatures(jidx, jpad, jcfg)
    jr.set_sig(jsig)
    tr = tcand.get_runner(tidx, tpad, PipelineConfig(backend="xla"), "cpu")
    tsig, _, _ = tcand.build_signatures(tidx, tpad, tr.all_ids,
                                        tr.all_counts)
    tr.set_sig(tsig)
    buckets = _width_buckets(np.diff(tidx.profile_ptr), R, tpad.width)
    assert tpad.width == 256 and [b[0] for b in buckets] == [128, 256]
    return dict(jr=jr, tr=tr, tpad=tpad, R=R, buckets=buckets, tidx=tidx)


def _join_oracle(tidx, a, b, w_row):
    """(inter, perc, tr) of gene a's first w_row profile entries against
    gene b's profile, from the CSR index alone."""
    def prof(g):
        s, e = tidx.profile_ptr[g], tidx.profile_ptr[g + 1]
        return dict(zip(tidx.profile_ids[s:e].tolist(),
                        tidx.profile_counts[s:e].tolist()))

    pa = dict(list(prof(a).items())[:w_row]) if a < tidx.n_sequences else {}
    pb = prof(b) if b < tidx.n_sequences else {}
    common = set(pa) & set(pb)
    return (sum(min(pa[v], pb[v]) for v in common),
            sum(pa[v] for v in common), sum(pb[v] for v in common))


@pytest.mark.parametrize("w_row", ["bucket", "whole"])
@pytest.mark.parametrize("upper_only", [False, True])
def test_in_scan_join_matches_jax(engines, upper_only, w_row):
    """(grow, cand, inter, perc, tr, valid, counts) of the port's in-scan
    join equal JAX ``_candidate_blocks(do_join=True)``'s bit for bit, per
    width bucket (rows joined on their bucket's width) and at the whole
    width; a small cap leaves rows past it (joined on their first K)."""
    e = engines
    R, K = e["R"], 2
    n_overflow = 0
    for wb, perm_pad, starts in e["buckets"]:
        w = wb if w_row == "bucket" else e["tpad"].width
        G = e["tidx"].n_sequences
        perm_ext = np.concatenate([perm_pad, np.full(R, G, np.int32)])
        args = (perm_ext, starts, R, w, K)
        want = [np.asarray(x) for x in e["jr"].extract(
            *args, do_join=True, upper_only=upper_only)]
        got = e["tr"].extract_fetched(*args, do_join=True,
                                      upper_only=upper_only)
        assert len(got) == len(want) == 7
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
        n_overflow += int((got[6] > K).sum())
        assert got[5].any()
    if not upper_only:
        assert n_overflow > 0


def test_in_scan_join_padding_adds_nothing(engines):
    """Every joined row carries padding slots (sentinel id, count 0); the
    counters equal an exact join of the real entries alone, and slots
    past a row's count are 0 and invalid."""
    e = engines
    R, K = e["R"], 64
    tidx = e["tidx"]
    wb, perm_pad, starts = e["buckets"][0]
    G = tidx.n_sequences
    perm_ext = np.concatenate([perm_pad, np.full(R, G, np.int32)])
    grow, cand, inter, perc, tr, valid, counts = e["tr"].extract_fetched(
        perm_ext, starts, R, wb, K, do_join=True)
    ids = e["tpad"].ids
    sent = tidx.vocab_size
    n = 0
    for blk in range(grow.shape[0]):
        for r in range(R):
            a = int(grow[blk, r])
            for s in range(K):
                if s >= counts[blk, r]:
                    assert inter[blk, r, s] == perc[blk, r, s] == 0
                    assert tr[blk, r, s] == 0 and not valid[blk, r, s]
                    continue
                b = int(cand[blk, r, s])
                assert (ids[a, :wb] == sent).any() and (ids[b] == sent).any()
                assert (inter[blk, r, s], perc[blk, r, s], tr[blk, r, s]) \
                    == _join_oracle(tidx, a, b, wb)
                n += 1
    assert n > 0


def _valid_dict(cells, idx):
    c = apply_validity(cells, idx.kseq_lengths, idx.k)
    keys = list(zip(c.row.tolist(), c.col.tolist()))
    assert len(keys) == len(set(keys))
    return {k: (int(i), int(p), int(t)) for k, i, p, t in zip(
        keys, c.intersection, c.perc_cnt, c.tr_perc_cnt)}


# the cases of tests/test_candidate.py:38-81 (backend xla)
CELL_CASES = {
    "seed0": (0, 9, dict(row_block=16, candidate_cap=64)),
    "seed1": (1, 9, dict(row_block=16, candidate_cap=64)),
    "seed7": (7, 9, dict(row_block=16, candidate_cap=64)),
    # a tiny cap; the host walk is forced by a lower retry limit below
    "overflow_fallback": (3, 6, dict(row_block=8, candidate_cap=2)),
    "device_retry": (13, 6, dict(row_block=8, candidate_cap=8)),
}


@pytest.mark.parametrize("name", sorted(CELL_CASES))
def test_cells_path_matches_jax(name, monkeypatch):
    seed, n_fams, cfg = CELL_CASES[name]
    ds = _random_ds(np.random.default_rng(seed), n_genomes=4, n_fams=n_fams)
    jidx, tidx = twin_indexes(ds, k=3)
    if name == "overflow_fallback":
        # past the retry's largest cap the rows take the host walk, in
        # both packages
        monkeypatch.setattr(tcand, "MAX_RETRY_CAP", 64)
        seen = []
        real = tcand._host_fallback_rows
        monkeypatch.setattr(tcand, "_host_fallback_rows",
                            lambda i, r: seen.append(r) or real(i, r))
    got = tcand.compute_cells_candidate(
        tidx, PipelineConfig(backend="xla", col_block=128, device="cpu",
                             **cfg))
    want = jcand.compute_cells_candidate(
        jidx, JaxConfig(backend="xla", col_block=128, **cfg))
    g = _valid_dict(got, jidx)
    assert g and g == _valid_dict(want, jidx)
    assert g == _valid_dict(compute_cells_oracle(jidx), jidx)
    if name == "overflow_fallback":
        assert seen
    else:
        # cells in the JAX package's order, with its values
        for x, y in zip((got.row, got.col, got.intersection, got.perc_cnt,
                         got.tr_perc_cnt),
                        (want.row, want.col, want.intersection,
                         want.perc_cnt, want.tr_perc_cnt)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize(
    "name", ["seed0", "seed1", "seed4", "seed9", "overflow_retry", "stats"])
def test_network_matches_jax(name, monkeypatch):
    """Edges and every shared stats field, the genome-pair aggregates
    included, equal the JAX xla backend's device BBH; pair_cap, lane_D
    and lane_table_cols are None in both."""
    monkeypatch.delenv("PANDELOS_NO_PAIR_STATS", raising=False)
    got = _port(name, backend="xla")
    want = _jax_result(name, False, backend="xla")
    _assert_same(got, want)
    for k in ("pair_cap", "lane_D", "lane_table_cols", "join_kernel"):
        assert got[1][k] is None
    assert not got[1]["bound_bits_mode"]
    assert "genome_pairs" in got[1]
    if name == "overflow_retry":
        assert got[1]["candidate_cap_final"] > 2
    # the same network as the cuda engine's
    ref = _port(name)
    np.testing.assert_array_equal(got[0].a, ref[0].a)
    np.testing.assert_array_equal(got[0].w, ref[0].w)


def test_xla_builds_no_join_table_and_no_bound_bits():
    from pandelos_tpu_torch.ops.candidate import memory_model
    from pandelos_tpu_torch.ops.net_device import compute_network_device

    ds = _with_long_family(np.random.default_rng(1))
    _, tidx = twin_indexes(ds, k=3)
    cfg = PipelineConfig(backend="xla", row_block=8, col_block=128,
                         device="cpu")
    cap = {}
    compute_network_device(tidx, cfg, capture=cap)
    r = cap["runner"]
    assert (r._all_lane2, r._all_lane, r._all_pair, r._T_cache) == (
        None, None, None, {})
    assert "pi" not in cap and not cap["use_T"]
    mm = memory_model(tidx, cfg, budget_bytes=1e12)
    ref = memory_model(tidx, PipelineConfig(row_block=8, col_block=128),
                       budget_bytes=1e12)
    assert mm["join_kernel"] is None
    assert mm["join_table_bytes"] == mm["bound_bits_bytes"] == 0
    # the in-scan join's work in place of the flat path's
    assert mm["join_temp_bytes"] > 0 and ref["join_temp_bytes"] > 0
    assert mm["join_temp_bytes"] != ref["join_temp_bytes"]
    # by default at the largest cap device BBH can reach
    assert mm["join_temp_bytes"] == memory_model(
        tidx, cfg, budget_bytes=1e12,
        cand_cap=tcand.MAX_CANDIDATE_CAP)["join_temp_bytes"]
    assert mm["total_bytes"] == (
        ref["total_bytes"] - ref["join_table_bytes"]
        - ref["bound_bits_bytes"] - ref["join_temp_bytes"]
        + mm["join_temp_bytes"])
    assert mm["fits"]


def test_join_slots_chunking_is_invisible(engines):
    """Any pair chunk gives the same bits."""
    e = engines
    r = e["tr"]
    R = e["R"]
    wb, perm_pad, starts = e["buckets"][-1]
    perm_ext = np.concatenate(
        [perm_pad, np.full(R, e["tidx"].n_sequences, np.int32)])
    grow, cand, counts = r.extract(perm_ext, starts, R, wb, 16,
                                   do_join=False)
    whole = tcand._join_slots(r.all_ids, r.all_counts, r.col_lens, grow,
                              cand, counts, wb, r.k2)
    for chunk in (1, 7):
        got = tcand._join_slots(r.all_ids, r.all_counts, r.col_lens, grow,
                                cand, counts, wb, r.k2, pair_chunk=chunk)
        for g, w in zip(got, whole):
            assert torch.equal(g, w)


class _Allocated(TorchDispatchMode):
    """Sums the bytes of every new storage an operation returns (views
    and in-place results share an input's storage and are not counted):
    what a function allocates, with no reuse."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr()
               for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and (
                    t.untyped_storage().data_ptr() not in ins):
                self.bytes += t.untyped_storage().nbytes()
        return out


def test_join_slots_bytes_bounds_what_it_allocates(engines):
    """The memory model's count of the in-scan join holds everything the
    join allocates, and is not loose by more than a fifth."""
    e = engines
    r, R, W = e["tr"], e["R"], e["tpad"].width
    G = e["tidx"].n_sequences
    for K in (4, 64):
        for _, perm_pad, starts in e["buckets"]:
            perm_ext = np.concatenate([perm_pad, np.full(R, G, np.int32)])
            grow, cand, counts = r.extract(perm_ext, starts, R, W, K,
                                           do_join=False)
            n_pairs = int(torch.clamp(counts, max=K).sum())
            with _Allocated() as seen:
                tcand._join_slots(r.all_ids, r.all_counts, r.col_lens, grow,
                                  cand, counts, W, r.k2)
            model = tcand.join_slots_bytes(cand.numel(), W, n_pairs)
            assert n_pairs > 0 and 0.8 * model <= seen.bytes <= model


def test_memory_model_bounds_the_device_bbh_per_slot():
    """What the xla backend's device BBH run allocates per [rows, K]
    slot (the growth between two caps that no row overflows) is within
    the memory model's per-slot bytes."""
    from pandelos_tpu_torch.ops.net_device import compute_network_device

    ds = _with_long_family(np.random.default_rng(1))
    _, tidx = twin_indexes(ds, k=3)
    R = 8
    seen = {}
    for K in (128, 512):
        cfg = PipelineConfig(backend="xla", row_block=R, col_block=128,
                             device="cpu", candidate_cap=K)
        compute_network_device(tidx, cfg)  # build the cached runner first
        with _Allocated() as a:
            stats = compute_network_device(tidx, cfg)[1]
        assert stats["candidate_cap_final"] == K
        seen[K] = a.bytes
    rows = -(-tidx.n_sequences // R) * R
    per_slot = (seen[512] - seen[128]) / (rows * 384)
    bound = tcand._JOIN_SLOT_BYTES + tcand._BBH_SLOT_BYTES
    assert 0.8 * bound <= per_slot <= bound


def test_memory_model_bounds_the_flat_path_per_slot():
    """What the cuda backend's flat path allocates (every temporary
    summed, as _Allocated counts) is within the memory model's bytes and
    not loose by more than a fifth: per [rows, K] slot (the growth of a
    device BBH run between two caps that no row overflows, whose pair
    list is the same) and per flat pair slot (the flatten, the join
    kernel's three outputs and the flat BBH, between pair lists of P and
    2P and 4P slots)."""
    from pandelos_tpu_torch.ops.net_device import (
        _bbh_flat_local,
        compute_network_device,
    )

    ds = _with_long_family(np.random.default_rng(1))
    _, tidx = twin_indexes(ds, k=3)
    R = 8
    seen, caps = {}, set()
    for K in (128, 512):
        cfg = PipelineConfig(row_block=R, col_block=128, device="cpu",
                             candidate_cap=K)
        compute_network_device(tidx, cfg)  # build the cached runner first
        cap = {}
        with _Allocated() as a:
            stats = compute_network_device(tidx, cfg, capture=cap)[1]
        assert stats["candidate_cap_final"] == K
        caps.add(stats["pair_cap"])
        seen[K] = a.bytes
    assert len(caps) == 1
    rows = -(-tidx.n_sequences // R) * R
    per_slot = (seen[512] - seen[128]) / (rows * 384)
    bound = tcand._FLAT_BBH_SLOT_BYTES
    assert 0.8 * bound <= per_slot <= bound

    # per pair slot: the join's outputs as the kernel allocates them (its
    # plain version's chunk temporaries are the CPU's, not the card's)
    r = cap["runner"]
    K = 128
    grow, cand, counts = r.extract(cap["perm_ext"], cap["starts"], R,
                                   r.w_pad, K, do_join=False,
                                   from_T=cap["use_T"])
    P = r.pair_capacity(counts.reshape(-1).numpy(), K)
    want = r.flatten_join(grow, cand, counts, K, 4 * P)[2:5]
    lens, zeros = r.col_lens, torch.zeros(r.G_pad, dtype=torch.int32)
    got = {}
    try:
        for n in (P, 2 * P, 4 * P):
            r.join = lambda pi, pj, n=n: tuple(x[:n].clone() for x in want)
            with _Allocated() as a:
                out = r.flatten_join(grow, cand, counts, K, n)
                _bbh_flat_local(grow, cand, counts, *out, zeros, lens, zeros,
                                tidx.n_genomes, 1 << 14)
            got[n] = a.bytes
    finally:
        del r.join
    bound = tcand._PAIR_SLOT_BYTES
    for lo, hi in ((P, 2 * P), (2 * P, 4 * P)):
        per_pair = (got[hi] - got[lo]) / (hi - lo)
        assert 0.8 * bound <= per_pair <= bound


def test_memory_model_counts_the_run_pair_list():
    """The cuda model counts the flat pair list at the run's pair_cap
    when given, and at its largest value for the cap otherwise."""
    from pandelos_tpu_torch.ops.candidate import memory_model

    ds = _with_long_family(np.random.default_rng(1))
    _, tidx = twin_indexes(ds, k=3)
    cfg = PipelineConfig(row_block=8, col_block=128, device="cpu")
    rows = -(-tidx.n_sequences // 8) * 8
    at = {pc: memory_model(tidx, cfg, budget_bytes=1e12, cand_cap=64,
                           pair_cap=pc)["join_temp_bytes"]
          for pc in (128, 256, None)}
    assert at[256] - at[128] == 128 * tcand._PAIR_SLOT_BYTES
    assert at[128] == (tcand._FLAT_BBH_SLOT_BYTES * rows * 64
                       + tcand._PAIR_SLOT_BYTES * 128)
    assert at[None] - at[128] == tcand._PAIR_SLOT_BYTES * (
        tcand._next_pow2(rows * 64) - 128)
