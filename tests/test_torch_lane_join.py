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


@pytest.mark.parametrize("packed", [True, False])
def test_table_build_temporaries_within_the_model(packed):
    """What the lane table builder allocates besides its table, every
    temporary of its one row chunk summed (no less than what it holds at
    once), is within ``build_temp_bytes``, the memory model's count, and
    not loose by more than half."""
    from tests.test_torch_xla_backend import _Allocated

    seed, n_genes, vocab, max_w, empty_last = PACK_CASES[2]
    _, profiles = _profiles(seed, n_genes, vocab, max_w, empty_last)
    idx = _FakeIndex(profiles)
    G_pad = n_genes + 3
    W = ((max_w + 127) // 128) * 128
    ids, cnts = _padded_arrays(idx, G_pad, W, sentinel=vocab)
    with _Allocated() as seen:
        table = tlj.pack_lane_device_core(
            torch.from_numpy(ids), torch.from_numpy(cnts),
            tlj.lane_depth(idx), packed=packed)
    temps = seen.bytes - table.numel() * 4
    model = tlj.build_temp_bytes(G_pad, W)
    assert 0.5 * model <= temps <= model


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


# --- the arithmetic of csrc/lane2_join.cu, modelled in numpy -------------
#
# No CUDA kernel runs on the CPU, so the step the kernel relies on is held
# against the plain version here: a warp takes a chunk of 32 pair slots,
# keeps the a row while the pair's a stays, walks it in tiles of up to 4
# depths (a remainder of 1..3 takes a smaller tile), takes
# m = min over the b rows of (y - (x & ~255)) as uint32, two rows a step
# and a single row for an odd depth, and accounts once per a slot
# (m < 256: cb = m, ca = x & 255).

_CHUNK, _TILE_A = 32, 4


def _lane2_kernel_model(table, dg, a_idx, b_idx):
    t3 = table.reshape(table.shape[0], -1, 128).view(np.uint32)
    P = len(a_idx)
    out = np.zeros((3, P), np.int64)
    for p0 in range(0, P, _CHUNK):
        cur_a, row_a = None, None
        for p in range(p0, min(P, p0 + _CHUNK)):
            a, b = int(a_idx[p]), int(b_idx[p])
            Da, Db = int(dg[a]), int(dg[b])
            if a != cur_a:  # the a row is loaded when a changes
                cur_a, row_a = a, t3[a, :Da]
            if Db == 0:
                continue
            for a0 in range(0, Da, _TILE_A):
                x = row_a[a0:min(Da, a0 + _TILE_A)]
                nx = (~(x & np.uint32(0xFFFFFF00)) + np.uint32(1))  # -(x & ~255)
                m = np.full(x.shape, 0xFFFFFFFF, np.uint32)
                for db in range(0, Db - 1, 2):
                    d0 = t3[b, db][None, :] + nx  # wraps mod 2^32
                    d1 = t3[b, db + 1][None, :] + nx
                    m = np.minimum(m, np.minimum(d0, d1))
                if Db % 2:
                    m = np.minimum(m, t3[b, Db - 1][None, :] + nx)
                hit = m < 256
                ca = (x & np.uint32(255)).astype(np.int64)
                cb = m.astype(np.int64)
                out[0, p] += np.minimum(ca, cb)[hit].sum()
                out[1, p] += ca[hit].sum()
                out[2, p] += cb[hit].sum()
    return out


@pytest.mark.parametrize("vocab", [2304, 128])
@pytest.mark.parametrize("case", range(9))
def test_lane2_kernel_step_model_matches_plain(vocab, case):
    """Empty and full-depth rows, depths at and past the a tile and the
    staged depth, counts 1..255, a == b, padding genes and runs that cross
    chunk edges; vocab 128 gives D = 1."""
    from chip_smoke import adversarial_pairs, adversarial_profiles

    ids, cnt, dg, n_genes, rng = adversarial_profiles(11, vocab=vocab,
                                                      n_random=6)
    D = max(1, int(dg.max()))
    assert D == vocab // 128 and cnt.max() == 255 and cnt[cnt > 0].min() == 1
    table = tlj.pack_lane_device_core(torch.from_numpy(ids),
                                      torch.from_numpy(cnt), D)
    label, a, b = list(adversarial_pairs(rng, n_genes, ids.shape[0]))[case]
    want = tlj.lane2_join_plain(table, torch.from_numpy(dg),
                                torch.from_numpy(a), torch.from_numpy(b))
    with np.errstate(over="ignore"):
        got = _lane2_kernel_model(table.numpy(), dg, a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.int64), label)


def test_lane2_match_is_difference_below_256():
    """The identity under the kernel's step, on every kind of slot: with
    nx = -(x & ~255) as uint32, y + nx is y's count when the ids are
    equal, at least 256 for different ids and for a real slot against an
    empty one (either way), and 0 for two empty slots."""
    rng = np.random.default_rng(0)
    n = 4000
    idv = rng.integers(0, 1 << 23, size=n).astype(np.int64)
    idv[:4] = [0, 0, (1 << 23) - 1, (1 << 23) - 1]
    ido = idv ^ rng.integers(1, 1 << 23, size=n)
    ido[:4] = [1, (1 << 23) - 1, 0, (1 << 23) - 2]
    ca = rng.integers(1, 256, size=n)
    cb = rng.integers(1, 256, size=n)
    ca[:8], cb[:8] = 255, 1

    def u32(v):
        return np.asarray(v, np.int64).astype(np.int32).view(np.uint32)

    x, same, other = u32((idv << 8) | ca), u32((idv << 8) | cb), u32(
        (ido << 8) | cb)
    empty = u32(np.full(n, -256))
    with np.errstate(over="ignore"):
        def diff(xx, yy):
            return yy + (~(xx & np.uint32(0xFFFFFF00)) + np.uint32(1))

        np.testing.assert_array_equal(diff(x, same), cb)
        assert (diff(x, other) >= 256).all()
        assert (diff(x, empty) >= 256).all()
        assert (diff(empty, x) >= 256).all()
        assert (diff(empty, empty) == 0).all()


# --- the arithmetic of csrc/lane_join.cu, modelled in numpy --------------
#
# The lane kernel walks chunks, a rows and tiles as lane2's does, but its
# step touches no count: with ky = (y & ~127) | j, j the b depth within a
# block of 128 depths, and nx = -(x & ~127), it takes m = min(ky + nx) as
# uint32 over the block (two depths a step, a single one for an odd
# depth), and after the block accounts once per a slot: m < 128 names the
# matching depth, whose count is then read from the table's count half.

_BLOCK_DEPTHS = 128
_LANE_MASK = np.uint32(0xFFFFFF80)


def _lane_key(y, nx, j):
    """(y & ~127 | j) + nx, wrapping mod 2^32."""
    return ((y & _LANE_MASK) | np.uint32(j)) + nx


def _lane_kernel_model(table, dg, a_idx, b_idx):
    G_pad, W2 = table.shape
    t4 = table.reshape(G_pad, 2, W2 // 256, 128)
    ids, cnts = t4[:, 0].view(np.uint32), t4[:, 1].astype(np.int64)
    lanes = np.arange(128)
    P = len(a_idx)
    out = np.zeros((3, P), np.int64)
    for p0 in range(0, P, _CHUNK):
        cur_a, neg_a = None, None
        for p in range(p0, min(P, p0 + _CHUNK)):
            a, b = int(a_idx[p]), int(b_idx[p])
            Da, Db = int(dg[a]), int(dg[b])
            if a != cur_a:  # the a ids are loaded and negated when a changes
                cur_a = a
                neg_a = ~(ids[a, :Da] & _LANE_MASK) + np.uint32(1)
            for a0 in range(0, Da, _TILE_A):
                nx = neg_a[a0:min(Da, a0 + _TILE_A)]
                ca = cnts[a, a0:a0 + len(nx)]
                for j0 in range(0, Db, _BLOCK_DEPTHS):
                    end = min(Db, j0 + _BLOCK_DEPTHS)
                    m = np.full(nx.shape, 0xFFFFFFFF, np.uint32)
                    for j in range(j0, end - 1, 2):
                        k0 = _lane_key(ids[b, j][None, :], nx, j - j0)
                        k1 = _lane_key(ids[b, j + 1][None, :], nx, j + 1 - j0)
                        m = np.minimum(np.minimum(m, k0), k1)
                    if (end - j0) % 2:
                        m = np.minimum(m, _lane_key(ids[b, end - 1][None, :],
                                                    nx, end - 1 - j0))
                    hit = m < _BLOCK_DEPTHS
                    depth = np.where(hit, j0 + m.astype(np.int64), 0)
                    cb = cnts[b][depth, lanes[None, :]]
                    out[0, p] += np.minimum(ca, cb)[hit].sum()
                    out[1, p] += ca[hit].sum()
                    out[2, p] += cb[hit].sum()
    return out


def _assert_lane_model_matches_plain(table, dg, a, b, label):
    want = tlj.lane_join_plain(table, torch.from_numpy(dg),
                               torch.from_numpy(a), torch.from_numpy(b))
    with np.errstate(over="ignore"):
        got = _lane_kernel_model(table.numpy(), dg, a, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy().astype(np.int64), label)


@pytest.mark.parametrize("vocab", [2304, 128])
@pytest.mark.parametrize("case", range(9))
def test_lane_kernel_step_model_matches_plain(vocab, case):
    """The adversarial tables of the lane2 model, with counts to 999 and
    ids past 2^23 (what lane2 cannot pack)."""
    from chip_smoke import adversarial_pairs, adversarial_profiles

    ids, cnt, dg, n_genes, rng = adversarial_profiles(
        12, vocab=vocab, n_random=6, max_count=1000, id_base=(1 << 23) + 5)
    D = max(1, int(dg.max()))
    assert D == vocab // 128 and cnt.max() == 999 and ids.min() > 1 << 23
    table = tlj.pack_lane_device_core(torch.from_numpy(ids),
                                      torch.from_numpy(cnt), D, packed=False)
    label, a, b = list(adversarial_pairs(rng, n_genes, ids.shape[0]))[case]
    _assert_lane_model_matches_plain(table, dg, a, b, label)


def test_lane_kernel_step_model_matches_plain_on_deep_rows():
    """Lane depths 128, 129 and 130: the b loop runs in blocks of 128
    depths, matches lie in the second block and at other depths in b than
    in a."""
    from chip_smoke import deep_join_case

    table, dg, a, b = deep_join_case("cpu", 40)
    assert sorted(set(dg.tolist()))[-3:] == [128, 129, 130]
    assert table.shape[1] == 2 * 130 * 128
    _assert_lane_model_matches_plain(table, dg.numpy(), a.numpy(), b.numpy(),
                                     "deep rows")


@pytest.mark.parametrize("depth", [0, 1, 126, 127, 128, 129, 255, 269])
def test_lane_match_is_key_below_128(depth):
    """The identity under the lane kernel's step, on every kind of slot
    pair of one lane: with j = depth % 128 (the depth within its block of
    128), ky = (y & ~127) | j and nx = -(x & ~127), ky + nx as uint32 is j
    when the ids are equal, at least 128 for two different valid ids of
    the lane and for a valid slot against an empty one (either way), and
    j for two empty slots."""
    rng = np.random.default_rng(depth)
    n = 4000
    lane = rng.integers(0, 128, size=n)
    lane[:4] = [0, 127, 127, 0]
    hi = rng.integers(0, 1 << 24, size=n)
    hi[:4] = [0, (1 << 24) - 1, 0, (1 << 24) - 1]  # ids 0 and 2^31 - 1
    x = (hi << 7) | lane
    other_hi = hi ^ rng.integers(1, 1 << 24, size=n)  # differs above bit 6
    other_hi[:4] = [1, (1 << 24) - 2, (1 << 24) - 1, 0]
    other = (other_hi << 7) | lane
    assert x.max() == (1 << 31) - 1 and x.min() == 0 and (x != other).all()

    def u32(v):
        return np.asarray(v, np.int64).astype(np.int32).view(np.uint32)

    def neg(v):
        return ~(v & _LANE_MASK) + np.uint32(1)

    j = depth % _BLOCK_DEPTHS
    empty = u32(np.full(n, -1))
    x, other = u32(x), u32(other)
    with np.errstate(over="ignore"):
        assert (_lane_key(x, neg(x), j) == j).all() and j < _BLOCK_DEPTHS
        assert (_lane_key(other, neg(x), j) >= _BLOCK_DEPTHS).all()
        assert (_lane_key(x, neg(other), j) >= _BLOCK_DEPTHS).all()
        assert (_lane_key(empty, neg(x), j) >= 1 << 31).all()
        assert (_lane_key(x, neg(empty), j) >= _BLOCK_DEPTHS).all()
        assert (_lane_key(empty, neg(empty), j) == j).all()
