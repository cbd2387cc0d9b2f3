"""The port's lane joins (ops/lane_join.py) against the JAX package's:
lane depths, the packed and unpacked lane tables, and the lane2 and lane
join counters — the plain PyTorch versions against the Pallas kernels in
interpret mode, all exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pandelos_tpu.ops import lane_join as jlj
from pandelos_tpu_torch.ops import lane_join as tlj

from tests.test_lane_join import (
    _FakeIndex,
    _numpy_counters,
    _padded_arrays,
    _random_profiles,
)

# the inputs of test_lane_join.py's pack tests (layout invariants, then
# device-vs-host pack)
PACK_CASES = [
    (3, 10, 2000, 300, False),
    (0, 10, 500, 140, True),
    (7, 13, 5000, 400, True),
    (9, 5, 64, 30, True),
]
JOIN_CASES = [(0, 8, 500, 140), (1, 12, 3000, 400), (2, 6, 64, 30)]


def _profiles(seed, n_genes, vocab, max_w, empty_last):
    rng = np.random.default_rng(seed)
    max_cnt = 4 if not empty_last else 5
    profiles = _random_profiles(rng, n_genes, vocab, max_w, max_cnt=max_cnt)
    if empty_last:
        profiles[-1] = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    return rng, profiles


@pytest.mark.parametrize("seed,n_genes,vocab,max_w,empty_last", PACK_CASES)
def test_lane_depths_and_packed_table_match_jax(
    seed, n_genes, vocab, max_w, empty_last
):
    _, profiles = _profiles(seed, n_genes, vocab, max_w, empty_last)
    # separate index objects: both packages memoize on the index
    jidx, tidx = _FakeIndex(profiles), _FakeIndex(profiles)
    np.testing.assert_array_equal(tlj.lane_depths(tidx), jlj.lane_depths(jidx))
    D = tlj.lane_depth(tidx)
    assert D == jlj.lane_depth(jidx)
    G_pad = n_genes + 3
    W = ((max_w + 127) // 128) * 128
    ids, cnts = _padded_arrays(jidx, G_pad, W, sentinel=vocab)
    want = np.asarray(jlj.pack_lane_device(
        jnp.asarray(ids), jnp.asarray(cnts), D, packed=True))
    got = tlj.pack_lane_device_core(
        torch.from_numpy(ids), torch.from_numpy(cnts), D, packed=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a small row chunk walks the same rows in several steps
    small = tlj.pack_lane_device_core(
        torch.from_numpy(ids), torch.from_numpy(cnts), D,
        chunk_bytes=W * 128 * 4 * 3)
    np.testing.assert_array_equal(small.numpy(), want)


@pytest.mark.parametrize("seed,n_genes,vocab,max_w", JOIN_CASES)
def test_lane2_plain_matches_jax_kernel(seed, n_genes, vocab, max_w):
    rng = np.random.default_rng(seed)
    profiles = _random_profiles(rng, n_genes, vocab, max_w, max_cnt=5)
    idx = _FakeIndex(profiles)
    G_pad = n_genes + 2
    D = jlj.lane_depth(idx)
    W = ((max_w + 127) // 128) * 128
    ids, cnts = _padded_arrays(idx, G_pad, W, sentinel=vocab)
    packed = jlj.pack_lane_device(jnp.asarray(ids), jnp.asarray(cnts), D,
                                  packed=True)
    n_pairs = 2 * jlj._PAIR_BLOCK
    i = rng.integers(0, n_genes, size=n_pairs).astype(np.int32)
    j = rng.integers(0, n_genes, size=n_pairs).astype(np.int32)
    i[:3] = [0, n_genes, 1]  # self pair, padding genes, duplicate
    j[:3] = [0, n_genes + 1, 1]
    dg = np.zeros(G_pad, np.int32)
    dg[:n_genes] = jlj.lane_depths(idx)
    want = jlj.join_pairs_lane2_device(
        packed, jnp.asarray(i), jnp.asarray(j),
        jnp.asarray(dg[i].reshape(-1, 8).max(axis=1)),
        jnp.asarray(dg[j].reshape(-1, 8).max(axis=1)),
        D=D, chunk=jlj._PAIR_BLOCK, interpret=True,
    )
    launches = tlj.lane2_join.launches
    got = tlj.lane2_join(
        torch.from_numpy(np.array(packed)), torch.from_numpy(dg),
        torch.from_numpy(i), torch.from_numpy(j),
    )
    assert tlj.lane2_join.launches == launches  # CPU: plain version only
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(
            g.numpy().view(np.int32), np.asarray(w).view(np.int32)
        )
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    for p in range(0, n_pairs, 17):
        pa = profiles[i[p]] if i[p] < n_genes else empty
        pb = profiles[j[p]] if j[p] < n_genes else empty
        assert tuple(int(x[p]) for x in got) == _numpy_counters(pa, pb)


@pytest.mark.parametrize("seed,n_genes,vocab,max_w,empty_last", PACK_CASES)
def test_unpacked_lane_table_matches_jax(
    seed, n_genes, vocab, max_w, empty_last
):
    """The lane kernel's table (ids then counts, empty id -1 / count 0)
    equals the JAX device pack and the host pack."""
    _, profiles = _profiles(seed, n_genes, vocab, max_w, empty_last)
    idx = _FakeIndex(profiles)
    D = tlj.lane_depth(idx)
    G_pad = n_genes + 3
    W = ((max_w + 127) // 128) * 128
    ids, cnts = _padded_arrays(idx, G_pad, W, sentinel=vocab)
    want = np.asarray(jlj.pack_lane_device(
        jnp.asarray(ids), jnp.asarray(cnts), D, packed=False))
    host, D_host = jlj.pack_lane_profiles(idx, G_pad=G_pad)
    assert D == D_host
    np.testing.assert_array_equal(host, want)
    for chunk_bytes in (1 << 28, W * 128 * 4 * 3):
        got = tlj.pack_lane_device_core(
            torch.from_numpy(ids), torch.from_numpy(cnts), D, packed=False,
            chunk_bytes=chunk_bytes)
        assert got.dtype == torch.int32 and got.shape == (G_pad, 2 * D * 128)
        np.testing.assert_array_equal(got.numpy(), want)


def _wide_profiles(rng, n_genes, vocab, max_w, max_cnt, id_base):
    """Random profiles whose counts reach ``max_cnt - 1`` and whose ids
    start at ``id_base``: inputs that lane2 cannot pack."""
    return [(ids + id_base, cnts) for ids, cnts in _random_profiles(
        rng, n_genes, vocab, max_w, max_cnt=max_cnt)]


# JOIN_CASES, then counts up to 999 and ids past 2^23
LANE_CASES = [c + (5, 0) for c in JOIN_CASES] + [(3, 10, 1000, 200, 1000,
                                                  1 << 23)]


@pytest.mark.parametrize("seed,n_genes,vocab,max_w,max_cnt,id_base",
                         LANE_CASES)
def test_lane_plain_matches_jax_kernel(seed, n_genes, vocab, max_w, max_cnt,
                                       id_base):
    rng = np.random.default_rng(seed)
    profiles = _wide_profiles(rng, n_genes, vocab, max_w, max_cnt, id_base)
    idx = _FakeIndex(profiles)
    G_pad = n_genes + 2
    table, D = jlj.pack_lane_profiles(idx, G_pad=G_pad)
    n_pairs = 2 * jlj._PAIR_BLOCK
    i = rng.integers(0, n_genes, size=n_pairs).astype(np.int32)
    j = rng.integers(0, n_genes, size=n_pairs).astype(np.int32)
    i[:3] = [0, n_genes, 1]  # self pair, padding genes, duplicate
    j[:3] = [0, n_genes + 1, 1]
    want = jlj.join_pairs_lane_device(
        jnp.asarray(table), jnp.asarray(i), jnp.asarray(j), D=D,
        chunk=jlj._PAIR_BLOCK, interpret=True)
    dg = np.zeros(G_pad, np.int32)
    dg[:n_genes] = tlj.lane_depths(idx)
    args = (torch.from_numpy(table), torch.from_numpy(dg),
            torch.from_numpy(i), torch.from_numpy(j))
    launches = tlj.lane_join.launches
    got = tlj.lane_join(*args)
    assert tlj.lane_join.launches == launches  # CPU: plain version only
    small = tlj.lane_join_plain(*args, pair_chunk=7)
    for g, s, w in zip(got, small, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(
            g.numpy().view(np.int32), np.asarray(w).view(np.int32))
        assert torch.equal(g, s)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    for p in range(0, n_pairs, 7):
        pa = profiles[i[p]] if i[p] < n_genes else empty
        pb = profiles[j[p]] if j[p] < n_genes else empty
        assert tuple(int(x[p]) for x in got) == _numpy_counters(pa, pb)
    if max_cnt > 256:
        with pytest.raises(ValueError, match="packed lane table"):
            ids, cnts = _padded_arrays(idx, G_pad, 384, sentinel=id_base)
            tlj.pack_lane_device_core(torch.from_numpy(ids),
                                      torch.from_numpy(cnts), D)


def test_lane_join_empty_index():
    idx = _FakeIndex([])
    table, D = jlj.pack_lane_profiles(idx, G_pad=4)
    z = np.zeros(jlj._PAIR_BLOCK, np.int32)
    want = jlj.join_pairs_lane_device(
        jnp.asarray(table), jnp.asarray(z), jnp.asarray(z), D=D,
        chunk=jlj._PAIR_BLOCK, interpret=True)
    assert tlj.lane_depth(idx) == D
    ids, cnts = _padded_arrays(idx, 4, 128, sentinel=0)
    port_table = tlj.pack_lane_device_core(
        torch.from_numpy(ids), torch.from_numpy(cnts), D, packed=False)
    np.testing.assert_array_equal(port_table.numpy(), table)
    got = tlj.lane_join(port_table, torch.zeros(4, dtype=torch.int32),
                        torch.from_numpy(z), torch.from_numpy(z))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert float(g.sum()) == 0.0


def _small_join_args(n_pairs=64):
    table = torch.full((4, 256), -256, dtype=torch.int32)
    table[0, 0] = (5 << 8) | 3
    table[1, 0] = (5 << 8) | 7
    table[1, 128 + 1] = (129 << 8) | 2
    dg = torch.tensor([1, 2, 0, 0], dtype=torch.int32)
    a = torch.zeros(n_pairs, dtype=torch.int32)
    b = torch.ones(n_pairs, dtype=torch.int32)
    return table, dg, a, b


def test_lane2_join_counters_and_pair_chunks():
    table, dg, a, b = _small_join_args()
    b[1] = 2  # empty partner
    a[2] = b[2] = 1  # a == b
    inter, perc, tr = tlj.lane2_join_plain(table, dg, a, b, pair_chunk=5)
    assert (inter[0].item(), perc[0].item(), tr[0].item()) == (3, 3, 7)
    assert (inter[1].item(), perc[1].item(), tr[1].item()) == (0, 0, 0)
    assert (inter[2].item(), perc[2].item(), tr[2].item()) == (9, 9, 9)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "dg",
                                 "lane_width"])
def test_lane2_join_rejects_bad_arguments(bad):
    table, dg, a, b = _small_join_args()
    if bad == "lane_width":  # the lane table's rows are 2*D*128 wide
        with pytest.raises(ValueError, match="D\\*256"):
            tlj.lane_join(torch.zeros((4, 384), dtype=torch.int32), dg, a, b)
        return
    if bad == "dtype":
        a = a.long()
        err = TypeError
    elif bad == "contiguity":
        table = torch.full((256, 4), -256, dtype=torch.int32).t()
        err = ValueError
    elif bad == "shape":
        b = b[:-1]
        err = ValueError
    else:
        dg = dg[:-1]
        err = ValueError
    with pytest.raises(err):
        tlj.lane2_join(table, dg, a, b)
