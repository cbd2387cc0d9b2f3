"""The port's pair join (ops/pair_join.py) against the JAX package's
compare-and-rotate kernel (ops/pallas_join.py, interpret mode, banded and
plain) on the cases of test_pallas_join.py: the plain PyTorch version,
the wrapper and the host API with dedup and mirror, all exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pandelos_tpu.ops import pallas_join as jpj
from pandelos_tpu_torch.ops import lane_join as tlj
from pandelos_tpu_torch.ops import pair_join as tpj

from tests.test_pallas_join import _numpy_counters


def _tables(seed, n_genes, W, vocab=400, max_cnt=5, id_base=0):
    """test_pallas_join.py's padded profiles (pad id = vocab, count 0),
    ids offset by ``id_base``."""
    rng = np.random.default_rng(seed)
    G_pad = n_genes + 2
    ids = np.full((G_pad, W), id_base + vocab, dtype=np.int32)
    counts = np.zeros((G_pad, W), dtype=np.int32)
    widths = np.zeros(G_pad, dtype=np.int64)
    for g in range(n_genes):
        w = int(rng.integers(0, min(W, vocab) + 1))
        ids[g, :w] = id_base + np.sort(
            rng.choice(vocab, size=w, replace=False)).astype(np.int32)
        counts[g, :w] = rng.integers(1, max_cnt, size=w)
        widths[g] = w
    return rng, ids, counts, widths


def _pairs(rng, n_genes, n_pairs):
    i = rng.integers(0, n_genes, size=n_pairs)
    j = rng.integers(0, n_genes, size=n_pairs)
    keep = i != j
    i, j = i[keep], j[keep]
    return np.concatenate([i, j[:5]]), np.concatenate([j, i[:5]])


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed,n_genes,W,n_pairs",
                         [(0, 8, 128, 40), (1, 12, 256, 90)])
def test_join_pairs_matches_jax(seed, n_genes, W, n_pairs):
    rng, ids, counts, widths = _tables(seed, n_genes, W)
    i, j = _pairs(rng, n_genes, n_pairs)
    want = jpj.join_pairs(jnp.asarray(jpj.pack_profiles(ids, counts)), i, j,
                          widths, w_pad=W, pad_gene=n_genes, interpret=True)
    table = tpj.pack_profiles(torch.from_numpy(ids), torch.from_numpy(counts))
    np.testing.assert_array_equal(table.numpy(),
                                  jpj.pack_profiles(ids, counts))
    got = tpj.join_pairs(table, i, j)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(_bits(g), _bits(w))
    for p in range(len(i)):
        assert tuple(int(x[p]) for x in got) == _numpy_counters(
            ids[i[p]], counts[i[p]], ids[j[p]], counts[j[p]])
    # assume_unique joins the pairs as given
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    u = np.unique(lo * 10**6 + hi)
    lo, hi = u // 10**6, u % 10**6
    got_u = tpj.join_pairs(table, lo, hi, assume_unique=True)
    want_u = jpj.join_pairs(jnp.asarray(jpj.pack_profiles(ids, counts)), lo,
                            hi, widths, w_pad=W, pad_gene=n_genes,
                            interpret=True, assume_unique=True)
    for g, w in zip(got_u, want_u):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_join_pairs_empty():
    table = tpj.pack_profiles(torch.full((2, 128), 9, dtype=torch.int32),
                              torch.zeros((2, 128), dtype=torch.int32))
    inter, perc, tr = tpj.join_pairs(table, np.zeros(0, np.int64),
                                     np.zeros(0, np.int64))
    assert len(inter) == len(perc) == len(tr) == 0


@pytest.mark.parametrize("banded", [True, False])
@pytest.mark.parametrize("seed,W,max_cnt,id_base", [
    (3, 256, 6, 0), (4, 512, 6, 0),
    # counts past 255 and ids past 2^23: nothing packs here
    (5, 256, 1000, 1 << 23),
])
def test_join_pairs_core_matches_jax(seed, W, max_cnt, id_base, banded):
    """test_banded_kernel_matches_plain's pairs (padding gene, a == b and
    empty rows among them) through the JAX kernel in each mode, the
    port's wrapper and its plain version at two pair chunks."""
    rng, ids, counts, _ = _tables(seed, 16, W, vocab=3000, max_cnt=max_cnt,
                                  id_base=id_base)
    G_pad = ids.shape[0]
    P = 128
    a = rng.integers(0, G_pad, size=P).astype(np.int32)
    b = rng.integers(0, G_pad, size=P).astype(np.int32)
    b[:4] = a[:4]
    want = jpj.join_pairs_core(
        jnp.asarray(jpj.pack_profiles(ids, counts)), jnp.asarray(a),
        jnp.asarray(b), w_pad=W, chunk=P, interpret=True, banded=banded)
    table = tpj.pack_profiles(torch.from_numpy(ids), torch.from_numpy(counts))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    launches = tpj.join_pairs_core.launches
    got = tpj.join_pairs_core(table, ta, tb)
    assert tpj.join_pairs_core.launches == launches  # CPU: plain only
    small = tpj.join_pairs_plain(table, ta, tb, pair_chunk=7)
    for g, s, w in zip(got, small, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        assert torch.equal(g, s)
    for p in range(0, P, 9):
        assert tuple(int(x[p]) for x in got) == _numpy_counters(
            ids[a[p]], counts[a[p]], ids[b[p]], counts[b[p]])


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "width"])
def test_join_pairs_core_rejects_bad_arguments(bad):
    table = torch.zeros((4, 256), dtype=torch.int32)
    a = torch.zeros(8, dtype=torch.int32)
    b = torch.ones(8, dtype=torch.int32)
    err = ValueError
    if bad == "dtype":
        a, err = a.long(), TypeError
    elif bad == "contiguity":
        table = torch.zeros((256, 4), dtype=torch.int32).t()
    elif bad == "shape":
        b = b[:-1]
    else:
        table = torch.zeros((4, 255), dtype=torch.int32)
    with pytest.raises(err):
        tpj.join_pairs_core(table, a, b)


@pytest.mark.parametrize("wrapper", ["lane2_join", "lane_join",
                                     "join_pairs_core"])
def test_wrappers_never_take_the_plain_version_off_the_cpu(wrapper):
    """A tensor on a device other than the CPU or a card raises; only CPU
    tensors take the plain versions."""
    meta = torch.device("meta")
    a = torch.zeros(8, dtype=torch.int32, device=meta)
    if wrapper == "join_pairs_core":
        args = (torch.zeros((4, 256), dtype=torch.int32, device=meta), a, a)
        fn = tpj.join_pairs_core
    else:
        unit = 128 if wrapper == "lane2_join" else 256
        args = (torch.zeros((4, unit), dtype=torch.int32, device=meta),
                torch.zeros(4, dtype=torch.int32, device=meta), a, a)
        fn = getattr(tlj, wrapper)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*args)
