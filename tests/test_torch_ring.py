"""The port's ring-sharded extraction (``ops/ring.py``) against the JAX
package's on the CPU: cells equal the oracle's valid cells, the
replicated engine's and the JAX ring's; the ring with the device BBH
gives the host path's edges; the per-shard layouts (the ring program's
grow/cand/counts, each shard's step-major pair list) equal the JAX
``_ring_extract_program``'s and ``_flatten_join_program``'s.  Mirrors
``tests/test_ring.py``; inputs from seeded generators, comparisons
exact."""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax

from pandelos_tpu.bench.synth import SynthSpec, generate
from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.ksel import select_k
from pandelos_tpu.ops.net_device import (
    compute_network_device as jax_network_device,
)
from pandelos_tpu.ops.ring import compute_cells_ring as jax_cells_ring
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.ops.candidate import compute_cells_candidate
from pandelos_tpu_torch.ops.net_device import compute_network_device
from pandelos_tpu_torch.ops.ring import compute_cells_ring
from pandelos_tpu_torch.pipeline import run_pipeline

from tests.test_net_device import _host_edges
from tests.test_ring import _cells_as_set, _valid_oracle_cells
from tests.torch_port_util import (  # noqa: F401
    twin_indexes,
    two_torch_threads,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs >= 8 virtual devices"
)

HERE = os.path.dirname(__file__)


def _twins(seed, k=None, **spec):
    ds = generate(SynthSpec(**spec, seed=seed))
    return twin_indexes(ds, k=k if k is not None else select_k(ds.sequences))


def _edges(edges):
    return {(a, b): np.float32(s) for a, b, s in edges}


SPEC5 = dict(n_genomes=5, n_families=40, singleton_per_genome=4,
             min_len=50, max_len=220)


@pytest.mark.parametrize("n_dev,seed", [(2, 3), (4, 5), (8, 4)])
def test_ring_cells_match_oracle_and_jax(n_dev, seed):
    jidx, tidx = _twins(seed, **SPEC5)
    kw = dict(backend="pallas", row_block=16, col_block=128,
              n_devices=n_dev, candidate_cap=32, ring_extract=True)
    got = _cells_as_set(compute_cells_ring(
        tidx, PipelineConfig(device="cpu", **kw)))
    assert got == _cells_as_set(jax_cells_ring(jidx, JaxConfig(**kw)))
    assert got == _cells_as_set(_valid_oracle_cells(jidx))


def test_ring_matches_replicated_engine():
    jidx, tidx = _twins(9, n_genomes=4, n_families=60,
                        singleton_per_genome=2, min_len=60, max_len=300)
    kw = dict(backend="pallas", row_block=16, col_block=128,
              candidate_cap=64, device="cpu")
    got = _cells_as_set(compute_cells_ring(
        tidx, PipelineConfig(n_devices=4, ring_extract=True, **kw)))
    assert got == _cells_as_set(compute_cells_candidate(
        tidx, PipelineConfig(n_devices=1, **kw)))
    assert got == _cells_as_set(compute_cells_candidate(
        tidx, PipelineConfig(n_devices=4, **kw)))


def test_ring_requires_multi_device(tmp_path):
    """One shard: ValueError naming the multi-device mesh from the ring
    itself and from a run on the cells path (which writes nothing); the
    device BBH runs the replicated engine instead, as the JAX package
    does, and says so in its statistics."""
    jidx, tidx = _twins(1, k=3, n_genomes=2, n_families=5,
                        singleton_per_genome=1, min_len=40, max_len=80)
    kw = dict(backend="pallas", n_devices=1, ring_extract=True)
    cfg = PipelineConfig(device="cpu", **kw)
    with pytest.raises(ValueError, match="multi-device"):
        compute_cells_ring(tidx, cfg)
    edges, stats = compute_network_device(tidx, cfg)
    jedges, jstats = jax_network_device(jidx, JaxConfig(**kw))
    assert stats["ring_extract"] is jstats["ring_extract"] is False
    assert stats["n_devices"] == 1
    assert _edges(edges) == _edges(jedges)
    prefix = str(tmp_path / "x")
    with pytest.raises(ValueError, match="multi-device"):
        run_pipeline(os.path.join(HERE, "data", "toy.faa"), prefix,
                     PipelineConfig(device="cpu", device_bbh=False, **kw))
    assert not os.path.exists(prefix + ".net")


@pytest.mark.parametrize("n_dev", [2, 4])
def test_ring_device_bbh_matches_host_and_jax(n_dev):
    """The ring composed with the device BBH (the step-axis max-merge
    before the all_gather, the threshold merge): edges equal the host
    path's and the JAX ring's, statistics the JAX ring's."""
    jidx, tidx = _twins(6, **SPEC5)
    kw = dict(backend="pallas", row_block=16, col_block=128,
              n_devices=n_dev, candidate_cap=64, ring_extract=True)
    edges, stats = compute_network_device(
        tidx, PipelineConfig(device="cpu", **kw))
    jedges, jstats = jax_network_device(jidx, JaxConfig(**kw))
    assert stats["ring_extract"] is True and stats["n_devices"] == n_dev
    assert _edges(edges) == _edges(jedges) == _host_edges(jidx)
    for key in ("n_cells", "n_accepted_inter_cells", "n_inter_edges",
                "n_intra_edges", "n_edges", "n_joined_pairs",
                "candidate_cap_final", "edge_cap_initial", "edge_cap",
                "pair_cap", "genome_pairs"):
        assert stats[key] == jstats[key], key


def test_ring_device_bbh_overflow_retry():
    """Candidate-cap overflow inside the ring + device BBH reruns the ring
    extraction at a widened cap and still matches."""
    jidx, tidx = _twins(2, k=3, n_genomes=4, n_families=12,
                        singleton_per_genome=2, min_len=40, max_len=120)
    kw = dict(backend="pallas", row_block=8, col_block=128, n_devices=2,
              candidate_cap=2, ring_extract=True)
    edges, stats = compute_network_device(
        tidx, PipelineConfig(device="cpu", **kw))
    assert stats["candidate_cap_final"] > 2
    jedges, jstats = jax_network_device(jidx, JaxConfig(**kw))
    assert stats["candidate_cap_final"] == jstats["candidate_cap_final"]
    assert _edges(edges) == _edges(jedges) == _host_edges(jidx)


def test_ring_layout_matches_jax():
    """At n = 4: each shard's ring program outputs (its rows; the
    candidates and counts of every step) and its step-major flat pair
    list, counters and validity equal the JAX program's global arrays."""
    from pandelos_tpu.ops import candidate as jcand
    from pandelos_tpu.ops.pallas_hist import pick_buckets
    from pandelos_tpu.ops.ring import _ring_extract_program
    from pandelos_tpu.ops.score import pad_profiles as jax_pad_profiles
    from pandelos_tpu_torch.ops import candidate as tcand
    from pandelos_tpu_torch.ops.ring import ring_extract
    from pandelos_tpu_torch.ops.score import pad_profiles
    from pandelos_tpu_torch.parallel.shards import resolve_shards

    jidx, tidx = _twins(5, **SPEC5)
    n, R, K = 4, 16, 32
    kw = dict(backend="pallas", row_block=R, col_block=128, n_devices=n,
              candidate_cap=K, ring_extract=True)
    jpad = jax_pad_profiles(jidx, R, 128)
    tpad = pad_profiles(tidx, R, 128)
    G, G_pad = tidx.n_sequences, tpad.ids.shape[0]
    jr = jcand.get_runner(jidx, jpad, np.zeros((1, 1), np.float32),
                          JaxConfig(**kw), tag="ring")
    tcfg = PipelineConfig(device="cpu", **kw)
    tr = tcand.get_runner(tidx, tpad, tcfg, resolve_shards(tcfg))
    perm = np.argsort(np.diff(tidx.profile_ptr), kind="stable")
    n_blocks = -(-G // R)
    perm_ext = np.full((n_blocks + 1) * R, G, dtype=np.int32)
    perm_ext[:G] = perm
    starts = np.arange(0, n_blocks * R, R, dtype=np.int32)
    sg = jr._pad_starts(starts, len(perm_ext) - R)
    S = len(sg) // n
    nb, shift = pick_buckets(jidx.vocab_size, max(1, jidx.max_profile_len),
                             jidx.k, n_genes=G_pad)
    fn = _ring_extract_program(jr.mesh, jr.axis, R, S, K, G, 2 * jidx.k, nb,
                               shift, G_pad // n, jpad.width, n,
                               upper_only=True)
    jgrow, jcand_, jcounts = fn(
        jr.all_ids, jr.all_counts, jr.col_lens,
        jr._replicate(np.asarray(perm_ext, np.int32)), jr._shard0(sg))
    outs = ring_extract(tr, perm_ext, starts, R, K, upper_only=True)
    assert len(outs) == n
    np.testing.assert_array_equal(
        torch.cat([o[0][0] for o in outs]).numpy(), np.asarray(jgrow))
    np.testing.assert_array_equal(
        torch.cat([o[1] for o in outs], dim=1).numpy(), np.asarray(jcand_))
    np.testing.assert_array_equal(
        torch.cat([o[2] for o in outs], dim=1).numpy(), np.asarray(jcounts))

    counts_h = np.asarray(jcounts)
    worst = int(np.where(counts_h > K, 0, counts_h).reshape(n, n, -1).sum(
        axis=(0, 2)).max())
    pair_cap = tr.pair_capacity_from_worst(worst)
    grow_v = jax.device_put(
        np.ascontiguousarray(np.broadcast_to(np.asarray(jgrow)[None],
                                             counts_h.shape)),
        jax.sharding.NamedSharding(
            jr.mesh, jax.sharding.PartitionSpec(None, jr.axis, None)))
    chunk = min(256, pair_cap)
    want = jr.flatten_join(grow_v, jcand_, jcounts, K, pair_cap, chunk,
                           ring=True)
    got = tr.flatten_join_shards(outs, K, pair_cap)
    for w, g in zip(want, zip(*got)):
        np.testing.assert_array_equal(torch.cat(g).numpy(), np.asarray(w))


def test_ring_option_errors(tmp_path):
    """The ring under backend xla or dense runs what the JAX package runs
    (xla's replicated engine with device BBH, the dense scorer) and
    writes the goldens; it raises ValueError, writing nothing, when the
    shards do not divide the padded gene count."""
    toy = os.path.join(HERE, "data", "toy.faa")
    prefix = str(tmp_path / "x")
    cfg = dict(device="cpu", row_block=16, col_block=128, ring_extract=True)
    for backend in ("xla", "dense"):
        res = run_pipeline(toy, prefix, PipelineConfig(
            backend=backend, n_devices=2, **cfg))
        assert res.stats["network"].get("ring_extract", False) is False
        for suffix in (".net", ".clus"):
            assert filecmp.cmp(prefix + suffix,
                               os.path.join(HERE, "golden", "toy" + suffix),
                               shallow=False), (backend, suffix)
            os.remove(prefix + suffix)
    with pytest.raises(ValueError, match="not divisible"):
        run_pipeline(toy, prefix, PipelineConfig(n_devices=3, **cfg))
    assert not os.path.exists(prefix + ".net")
