"""The port's candidate engine (ops/score.py, ops/hist.py,
ops/candidate.py) against the JAX package's on the same inputs: padded
profiles, signatures, bound bits, and the extraction's (grow, cand,
counts) in both bound modes and both row halves — all exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.ops import candidate as jcand
from pandelos_tpu.ops import pallas_hist as jhist
from pandelos_tpu.ops.score import pad_profiles as jax_pad_profiles
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.ops import candidate as tcand
from pandelos_tpu_torch.ops import hist as thist
from pandelos_tpu_torch.ops.score import pad_profiles

from tests.test_cells_and_net import _random_ds
from tests.torch_port_util import twin_indexes


def _hist_inputs(seed, G_pad, W, n_buckets, shift, max_count, pad_tails):
    rng = np.random.default_rng(seed)
    vocab = n_buckets << shift
    ids = np.sort(
        rng.integers(0, vocab, size=(G_pad, W)).astype(np.int32), axis=1
    )
    counts = rng.integers(1, max_count, size=(G_pad, W)).astype(np.int32)
    if pad_tails:  # sentinel-padded tails must contribute nothing
        for g in range(G_pad):
            n = rng.integers(0, W)
            ids[g, n:] = vocab + 7
            counts[g, n:] = 0
    return ids, counts


# the inputs of test_candidate.py's device-histogram tests
@pytest.mark.parametrize("case", ["padded", "large_counts"])
def test_histogram_matches_jax_and_host(case):
    if case == "padded":
        args = (2, 16, 128, jhist.BUCKET_CHUNK, 2, 5, True)
    else:
        args = (5, 8, 256, 4096, 3, 60000, False)
    ids, counts = _hist_inputs(*args)
    nb, shift = args[3], args[4]
    want = jhist.host_histogram(ids, counts, nb, shift)
    jdev = np.asarray(jhist.device_histogram(
        jnp.asarray(ids), jnp.asarray(counts), n_buckets=nb, shift=shift))
    np.testing.assert_array_equal(jdev, want)
    got = thist.device_histogram(
        torch.from_numpy(ids), torch.from_numpy(counts), nb, shift,
        row_chunk=5,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        thist.host_histogram(ids, counts, nb, shift), want
    )
    # the fused bf16 round-up: the JAX device build's bits
    jup = np.asarray(jhist.device_histogram(
        jnp.asarray(ids), jnp.asarray(counts), n_buckets=nb, shift=shift,
        round_up_bf16=True).astype(jnp.float32))
    up = thist.device_histogram(
        torch.from_numpy(ids), torch.from_numpy(counts), nb, shift,
        round_up_bf16=True,
    )
    assert up.dtype == torch.bfloat16
    np.testing.assert_array_equal(up.float().numpy(), jup)
    np.testing.assert_array_equal(up.float().numpy(), jcand._bf16_round_up(want))


def test_bf16_round_up_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.random(10000) * 2000).astype(np.float32),
        rng.integers(0, 1 << 24, size=1000).astype(np.float32),
        np.asarray([0.0, 1.0, 2.0, 256.0, 0.5, 257.0], np.float32),
    ])
    want = jcand._bf16_round_up(x)
    np.testing.assert_array_equal(tcand._bf16_round_up(x), want)
    got = thist.bf16_round_up(torch.from_numpy(x)).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module", params=[0, 3])
def engines(request):
    """JAX MeshRunner and port Runner over one index, signatures set."""
    rng = np.random.default_rng(request.param)
    ds = _random_ds(rng, n_genomes=3, n_fams=10)
    jidx, tidx = twin_indexes(ds, k=3)
    R = 8
    jcfg = JaxConfig(backend="pallas", row_block=R, col_block=128)
    jpad = jax_pad_profiles(jidx, R, 128)
    tpad = pad_profiles(tidx, R, 128)
    jr = jcand.get_runner(jidx, jpad, None, jcfg)
    jsig, _, _ = jcand.build_signatures(jidx, jpad, jcfg)
    jr.set_sig(jsig)
    tr = tcand.get_runner(tidx, tpad, PipelineConfig(), "cpu")
    tsig, _, _ = tcand.build_signatures(tidx, tpad, tr.all_ids,
                                        tr.all_counts)
    tr.set_sig(tsig)
    G = jidx.n_sequences
    perm = np.argsort(np.diff(jidx.profile_ptr), kind="stable").astype(
        np.int32)
    n_blocks = -(-G // R)
    perm_pad = np.full(n_blocks * R, G, dtype=np.int32)
    perm_pad[:G] = perm
    perm_ext = np.concatenate([perm_pad, np.full(R, G, np.int32)])
    starts = np.arange(0, n_blocks * R, R, np.int32)
    # the port's runner holds its index weakly (the index caches it):
    # keep the index
    return dict(jpad=jpad, tpad=tpad, jr=jr, tr=tr, jsig=jsig, tsig=tsig,
                perm_ext=perm_ext, starts=starts, R=R, jidx=jidx, tidx=tidx)


def test_padded_profiles_and_signatures_match_jax(engines):
    jp, tp = engines["jpad"], engines["tpad"]
    np.testing.assert_array_equal(tp.ids, jp.ids)
    np.testing.assert_array_equal(tp.counts, jp.counts)
    assert (tp.width, tp.n_sequences, tp.vocab_size) == (
        jp.width, jp.n_sequences, jp.vocab_size)
    np.testing.assert_array_equal(
        engines["tsig"].float().numpy(),
        np.asarray(engines["jsig"].astype(jnp.float32)),
    )


def test_bound_bits_match_jax(engines):
    e = engines
    assert e["tr"].use_bound_bits(len(e["starts"]), e["R"])
    want = np.asarray(e["jr"].bound_bits(e["perm_ext"], e["starts"], e["R"]))
    got = e["tr"].bound_bits(e["perm_ext"], e["starts"], e["R"])
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # memoized on the raw permutation bytes; another order is another T
    assert e["tr"].bound_bits(e["perm_ext"], e["starts"], e["R"]) is got
    other = e["perm_ext"].copy()
    other[[0, 1]] = other[[1, 0]]
    assert e["tr"].bound_bits(other, e["starts"], e["R"]) is not got


@pytest.mark.parametrize("from_T", [True, False])
@pytest.mark.parametrize("upper_only", [False, True])
def test_extraction_matches_jax(engines, from_T, upper_only):
    e = engines
    K = 32
    args = (e["perm_ext"], e["starts"], e["R"])
    want = [np.asarray(x) for x in e["jr"].extract(
        *args, e["tpad"].width, K, do_join=False, upper_only=upper_only,
        from_T=from_T)]
    got = [x.numpy() for x in e["tr"].extract(
        *args, e["tpad"].width, K, do_join=False, upper_only=upper_only,
        from_T=from_T)]
    for g, w in zip(got, want):  # grow, cand, counts
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        e["tr"].grow_layout(e["perm_ext"], e["starts"], e["R"]),
        e["jr"].grow_layout(e["perm_ext"], e["starts"], e["R"]),
    )


def test_flatten_join_matches_jax(engines):
    """The fused flatten + lane2 join + validity over a T-mode extraction
    with a small cap (some rows overflow and must emit nothing)."""
    e = engines
    K = 2
    args = (e["perm_ext"], e["starts"], e["R"])
    jout = e["jr"].extract(*args, e["tpad"].width, K, do_join=False,
                           from_T=True)
    tout = e["tr"].extract(*args, e["tpad"].width, K, do_join=False,
                           from_T=True)
    counts_h = np.asarray(jout[2]).reshape(-1)
    assert (counts_h > K).any()
    pair_cap, chunk = e["jr"].pair_capacity(counts_h, K)
    assert e["tr"].pair_capacity(counts_h, K) == pair_cap
    want = e["jr"].flatten_join(*jout, K, pair_cap, chunk)
    got = e["tr"].flatten_join(*tout, K, pair_cap)
    for g, w in zip(got, want):  # pi, pj, inter, perc, tr, valid
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert e["tr"].lane_D == e["jr"].lane_D
