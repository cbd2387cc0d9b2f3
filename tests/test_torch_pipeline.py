"""The port end to end on the CPU: goldens byte for byte on every join
kernel, on the cells path and on every backend name, the shared index,
the import boundary,
device resolution, lane2's fallback for inputs it cannot pack, the work
and memory models, a run's device memory freed with its last reference,
every option of the JAX package's config (the multi-device ones on CPU
shards), and every combination of them that the JAX package runs
otherwise than asked, run as it runs them."""

import dataclasses
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.index import build_index as jax_build_index
from pandelos_tpu.io.faa import FaaDataset as JaxFaaDataset
from pandelos_tpu.io.faa import read_faa as jax_read_faa
from pandelos_tpu.pipeline import run_pipeline as jax_run_pipeline
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.index import KmerIndex, build_index
from pandelos_tpu_torch.io.faa import FaaDataset, read_faa
from pandelos_tpu_torch.pipeline import run_pipeline

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(HERE)

CASES = [
    ("toy", os.path.join(DATA, "toy.faa")),
    ("synth_small", os.path.join(GOLDEN, "synth_small.faa")),
    ("synth_edge", os.path.join(GOLDEN, "synth_edge.faa")),
]


def _cfg(**kw):
    base = dict(row_block=16, col_block=128, candidate_cap=64, device="cpu")
    base.update(kw)
    return PipelineConfig(**base)


@pytest.mark.parametrize("backend", ["cuda", "oracle"])
@pytest.mark.parametrize("name,faa", CASES, ids=[c[0] for c in CASES])
def test_pipeline_reproduces_golden(tmp_path, name, faa, backend):
    prefix = str(tmp_path / name)
    run_pipeline(faa, prefix, _cfg(backend=backend))
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, name + suffix),
                           shallow=False), suffix


# the other routes of the engine: each join kernel with device BBH, and
# the cells path (host BBH) with each
PATHS = {
    "lane": dict(join_kernel="lane"),
    "roll": dict(join_kernel="roll"),
    "cells_lane2": dict(device_bbh=False),
    "cells_lane": dict(device_bbh=False, join_kernel="lane"),
    "cells_roll": dict(device_bbh=False, join_kernel="roll"),
}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("name,faa", CASES, ids=[c[0] for c in CASES])
def test_engine_paths_reproduce_golden(tmp_path, name, faa, path):
    prefix = str(tmp_path / name)
    res = run_pipeline(faa, prefix, _cfg(**PATHS[path]))
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, name + suffix),
                           shallow=False), suffix
    if not path.startswith("cells"):
        assert res.stats["network"]["join_kernel"] == path


def test_cli_run_and_check(tmp_path):
    from pandelos_tpu_torch.cli import main

    prefix = str(tmp_path / "toy")
    assert main(["run", os.path.join(DATA, "toy.faa"), prefix,
                 "--device", "cpu"]) == 0
    assert main(["check", prefix + ".net",
                 os.path.join(GOLDEN, "toy.net")]) == 0
    assert filecmp.cmp(prefix + ".clus", os.path.join(GOLDEN, "toy.clus"),
                       shallow=False)


@pytest.mark.parametrize("name,faa", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_index_matches_jax_and_round_trips(tmp_path, name, faa):
    jidx = jax_build_index(jax_read_faa(faa), k=4)
    tidx = build_index(read_faa(faa), k=4)
    twin = KmerIndex.from_arrays(dataclasses.asdict(jidx))
    path = str(tmp_path / "index.npz")
    tidx.save(path)
    for other in (twin, KmerIndex.load(path)):
        for f in dataclasses.fields(KmerIndex):
            a, b = getattr(tidx, f.name), getattr(other, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
    with pytest.raises(KeyError):
        KmerIndex.from_arrays({"k": 3})


def test_native_core_is_used():
    """The native host core splits a colliding component (two genes of
    genome 0 in one component) in one ``pt_gn_families`` call."""
    from pandelos_tpu_torch.cluster import cluster_network
    from pandelos_tpu_torch.native import loader

    before = loader.CALLS["gn_families"]
    res = cluster_network([(0, 2, 0.9), (1, 3, 0.9), (2, 1, 0.5)],
                          np.array([0, 0, 1, 1]), 4)
    assert loader.CALLS["gn_families"] == before + 1
    assert res.families == [[0, 2], [1, 3]]


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    code = (
        "import filecmp, sys\n"
        "from pandelos_tpu_torch.config import PipelineConfig\n"
        "from pandelos_tpu_torch.pipeline import run_pipeline\n"
        "for kw in ({}, {'join_kernel': 'lane'}, {'join_kernel': 'roll'},\n"
        "           {'device_bbh': False}, {'backend': 'xla'},\n"
        "           {'backend': 'xla', 'device_bbh': False},\n"
        "           {'backend': 'dense'}, {'backend': 'reference'},\n"
        "           {'n_devices': 2}, {'n_devices': 2, 'ring_extract': True},\n"
        f"           {{'profile_dir': {str(tmp_path / 'trace')!r}}}):\n"
        f"    run_pipeline({os.path.join(DATA, 'toy.faa')!r}, "
        f"{str(tmp_path / 'toy')!r}, PipelineConfig(device='cpu', **kw))\n"
        "    assert filecmp.cmp("
        f"{str(tmp_path / 'toy.net')!r}, "
        f"{os.path.join(GOLDEN, 'toy.net')!r}, shallow=False), kw\n"
        "import pandelos_tpu_torch.ops.pair_join, pandelos_tpu_torch.kernels\n"
        "import pandelos_tpu_torch.cli, pandelos_tpu_torch.dictionaries\n"
        "import pandelos_tpu_torch.bench.harness, pandelos_tpu_torch.io.gbk\n"
        "import pandelos_tpu_torch.bench.quality, pandelos_tpu_torch.reference\n"
        "import pandelos_tpu_torch.parallel.dryrun, pandelos_tpu_torch.ops.ring\n"
        "import pandelos_tpu_torch.probe_multigpu\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pandelos_tpu' or m.startswith('pandelos_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout
    assert filecmp.cmp(str(tmp_path / "toy.net"),
                       os.path.join(GOLDEN, "toy.net"), shallow=False)


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    from pandelos_tpu_torch.device import resolve_device

    assert PipelineConfig().device == "cuda"
    assert PipelineConfig().backend == "cuda"
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pipeline(os.path.join(DATA, "toy.faa"), None,
                     PipelineConfig(row_block=16, col_block=128))


# the options of the JAX package's config: the JAX backend names, the
# join kernels, the cells path and the multi-device options (on CPU
# shards) all run
OPTIONS = {
    "backend_xla": dict(backend="xla"),
    "backend_dense": dict(backend="dense"),
    "backend_pallas": dict(backend="pallas"),
    "backend_reference": dict(backend="reference"),
    "backend_auto": dict(backend="auto"),
    "n_devices": dict(n_devices=2),
    "ring_extract": dict(ring_extract=True, n_devices=2),
    "join_kernel_lane": dict(join_kernel="lane"),
    "join_kernel_roll": dict(join_kernel="roll"),
    "device_bbh_off": dict(device_bbh=False),
    "profile_dir": dict(profile_dir="trace"),
}
RUNS = set(OPTIONS)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_unported_option_raises(name, tmp_path):
    """Every option (RUNS: all of them, none is left unported) writes the
    golden output, which equals the JAX package's; the multi-device ones
    run on CPU shards against the JAX mesh of virtual CPU devices."""
    prefix = str(tmp_path / "x")
    toy = os.path.join(DATA, "toy.faa")
    opts = dict(OPTIONS[name])
    if "profile_dir" in opts:
        opts["profile_dir"] = str(tmp_path / opts["profile_dir"])
    if name in RUNS:
        run_pipeline(toy, prefix, _cfg(**opts))
        # the JAX run takes the case's backend, else its pallas engine,
        # and writes no trace
        opts.pop("profile_dir", None)
        jax_run_pipeline(toy, prefix + "_jax", JaxConfig(
            row_block=16, col_block=128, candidate_cap=64,
            **{"backend": "pallas", **opts}))
        for suffix in (".net", ".clus"):
            assert filecmp.cmp(prefix + suffix, prefix + "_jax" + suffix,
                               shallow=False), suffix
            assert filecmp.cmp(prefix + suffix,
                               os.path.join(GOLDEN, "toy" + suffix),
                               shallow=False), suffix
        return
    raise AssertionError(f"{name}: every option runs")


# option combinations where ring_extract or n_devices does not apply as
# asked: each runs what the JAX package runs (its pallas engine where
# the port's is cuda, Pallas in interpret mode), with device_bbh set on
# both sides (the JAX default turns it off on the CPU); row d raises in
# both.  (options, whether the device BBH ran the ring (None: a path
# that does not report it), and what the port's run captured: the join
# kernel it launched and its number of shard pair lists, None where
# the path has none)
COMBINATIONS = {
    # a: the ring needs backend pallas: the replicated xla engine
    "a_xla_ring_two_devices": (
        dict(backend="xla", ring_extract=True, n_devices=2,
             device_bbh=True), False, (None, 2)),
    # b: the ring needs two devices: the replicated engine on one
    "b_ring_one_device": (
        dict(ring_extract=True, n_devices=1, device_bbh=True), False,
        ("lane2", 1)),
    "b_ring_default_devices": (
        dict(ring_extract=True, device_bbh=True), False, ("lane2", 1)),
    # c: the cells path's ring under xla (joined with the join kernel;
    # the replicated xla cells path joins in the scan, captures nothing)
    "c_xla_ring_cells_path": (
        dict(backend="xla", ring_extract=True, n_devices=2,
             device_bbh=False), None, ("lane2", 2)),
    # d: the cells path's ring on one device raises
    "d_ring_cells_path_one_device": (
        dict(ring_extract=True, n_devices=1, device_bbh=False),
        "ring extraction needs a multi-device mesh (n_devices >= 2)", None),
    # e: dense reads neither n_devices nor ring_extract
    "e_dense_two_devices": (dict(backend="dense", n_devices=2), None,
                            (None, None)),
    "e_dense_ring_two_devices": (
        dict(backend="dense", n_devices=2, ring_extract=True), None,
        (None, None)),
    # f: the host backends return before the ring
    "f_oracle_ring": (dict(backend="oracle", ring_extract=True), None,
                      (None, None)),
    "f_reference_ring": (dict(backend="reference", ring_extract=True),
                         None, (None, None)),
}


@pytest.mark.parametrize("name", sorted(COMBINATIONS))
def test_option_combinations_match_jax(name, tmp_path):
    """Every combination writes the JAX package's .net/.clus (the toy
    goldens) and reports the engine that ran as it does, and the port's
    capture shows that engine ran; the one the JAX package refuses
    raises the same ValueError, writing nothing."""
    opts, want, engine = COMBINATIONS[name]
    toy = os.path.join(DATA, "toy.faa")
    prefix = str(tmp_path / "x")
    jax_opts = dict(row_block=16, col_block=128, candidate_cap=64,
                    **{"backend": "pallas", **opts})
    if isinstance(want, str):
        with pytest.raises(ValueError) as jax_err:
            jax_run_pipeline(toy, prefix + "_jax", JaxConfig(**jax_opts))
        with pytest.raises(ValueError) as err:
            run_pipeline(toy, prefix, _cfg(**opts))
        assert str(err.value) == str(jax_err.value) == want
        assert not os.path.exists(prefix + ".net")
        return
    cap = {}
    res = run_pipeline(toy, prefix, _cfg(**opts), capture=cap)
    jres = jax_run_pipeline(toy, prefix + "_jax", JaxConfig(**jax_opts))
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix, prefix + "_jax" + suffix,
                           shallow=False), suffix
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, "toy" + suffix),
                           shallow=False), suffix
    net, jnet = res.stats["network"], jres.stats["network"]
    assert net.get("ring_extract") == jnet.get("ring_extract") == want
    lists = cap.get("pairs_per_shard")
    assert (cap.get("join_kernel"),
            None if lists is None else len(lists)) == engine


def test_unknown_backend_is_an_error():
    with pytest.raises(ValueError):
        run_pipeline(os.path.join(DATA, "toy.faa"), None,
                     _cfg(backend="tpu"))
    with pytest.raises(ValueError, match="join_kernel"):
        run_pipeline(os.path.join(DATA, "toy.faa"), None,
                     _cfg(join_kernel="merge"))


def _homopolymer(cls):
    seq = "A" * 300 + "CDEFGHIK"
    return cls(sequences=[seq, seq, "CDEFGHIKLM", "A" * 280 + "CDEF"],
               names=["a", "b", "c", "d"], descriptions=["d"] * 4,
               seq_genome=[0, 1, 1, 2], genome_names=["g0", "g1", "g2"])


@pytest.mark.parametrize("device_bbh", [None, False])
def test_unpackable_counts_raise(tmp_path, device_bbh):
    """A k-mer count >= 256 (AAA in a 300-residue poly-A tract) cannot be
    packed for lane2: the run takes the lane kernel instead, builds no
    lane2 table, and writes the JAX package's output byte for byte."""
    prefix = str(tmp_path / "port")
    cap = {}
    res = run_pipeline("", prefix, _cfg(k=3, device_bbh=device_bbh),
                       dataset=_homopolymer(FaaDataset), capture=cap)
    assert int(cap["index"].profile_counts.max()) >= 256
    assert cap["join_kernel"] == "lane"
    assert cap["runner"]._all_lane2 is None
    if device_bbh is None:
        assert res.stats["network"]["join_kernel"] == "lane"
        assert res.stats["network"]["lane_table_cols"] is None
    jax_run_pipeline("", str(tmp_path / "jax"), JaxConfig(
        backend="pallas", k=3, row_block=16, col_block=128,
        candidate_cap=64, device_bbh=device_bbh),
        dataset=_homopolymer(JaxFaaDataset))
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix, str(tmp_path / "jax") + suffix,
                           shallow=False), suffix
    assert len(res.edges) > 0


def test_candidate_cap_past_the_device_limit_raises(monkeypatch, tmp_path):
    """Past the largest device candidate cap the heavy-row pass keeps the
    network on the device, and the output is the golden; where the card
    cannot hold a chunk of that pass, the memory plan raises naming its
    heavy stage.  The cells path (compute_cells_candidate, host BBH,
    ``device_bbh=False``) gives the golden too, its cells the oracle's
    valid cells."""
    from pandelos_tpu_torch.oracle.cells import (
        apply_validity,
        compute_cells_oracle,
    )
    from pandelos_tpu_torch.ops import candidate, net_device

    monkeypatch.setattr(net_device, "MAX_CANDIDATE_CAP", 2)
    seen = []
    real = candidate.compute_cells_candidate

    def spy(index, config, **kw):
        seen.append(real(index, config, **kw))
        return seen[-1]

    monkeypatch.setattr(candidate, "compute_cells_candidate", spy)
    prefix = str(tmp_path / "s")
    res = run_pipeline(os.path.join(GOLDEN, "synth_small.faa"), prefix,
                       _cfg(candidate_cap=2))
    assert not seen and res.stats["network"]["device_bbh"]
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, "synth_small" + suffix),
                           shallow=False), suffix
    monkeypatch.setattr(candidate, "card_memory", lambda device: 10**12)
    monkeypatch.setattr(candidate.MemoryPlan, "heavy_work",
                        lambda self, n, K: 10**13)
    with pytest.raises(MemoryError, match="the engine's heavy stage needs "
                                          "~10000.*GB on a card with "
                                          "1000.00GB to give"):
        run_pipeline(os.path.join(GOLDEN, "synth_small.faa"), prefix,
                     _cfg(candidate_cap=2))
    assert not seen
    cap = {}
    run_pipeline(os.path.join(GOLDEN, "synth_small.faa"), prefix,
                 _cfg(candidate_cap=2, device_bbh=False), capture=cap)
    assert len(seen) == 1
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, "synth_small" + suffix),
                           shallow=False), suffix
    idx = cap["index"]

    def cells(c):
        c = apply_validity(c, idx.kseq_lengths, idx.k).sort()
        return np.stack([c.row, c.col, c.intersection, c.perc_cnt,
                         c.tr_perc_cnt])

    np.testing.assert_array_equal(cells(seen[0]),
                                  cells(compute_cells_oracle(idx)))


def test_unported_engine_parts_raise():
    """The runner's lane and pair tables, built on the device from its
    resident profiles, equal the JAX MeshRunner's."""
    from pandelos_tpu.ops import candidate as jcand
    from pandelos_tpu.ops.score import pad_profiles as jax_pad_profiles
    from pandelos_tpu_torch.ops import candidate as tcand
    from pandelos_tpu_torch.ops.score import pad_profiles

    from tests.torch_port_util import twin_indexes

    ds = jax_read_faa(os.path.join(GOLDEN, "synth_small.faa"))
    for jk in ("lane", "roll"):
        jidx, tidx = twin_indexes(ds, k=4)  # runners are cached per index
        jr = jcand.get_runner(jidx, jax_pad_profiles(jidx, 16, 128), None,
                              JaxConfig(backend="pallas", join_kernel=jk))
        tr = tcand.get_runner(tidx, pad_profiles(tidx, 16, 128),
                              PipelineConfig(join_kernel=jk), "cpu")
        assert tr.join_kernel == jk
        want = np.asarray(jr.all_lane if jk == "lane" else jr.all_pair)
        np.testing.assert_array_equal(tr.join_table.numpy(), want)
        assert tr.lane_D == jr.lane_D
        assert tr._all_lane2 is None


@pytest.mark.parametrize("join_kernel", ["lane", "roll"])
def test_no_lane2_table_under_other_joins(join_kernel):
    from pandelos_tpu_torch.ops.net_device import compute_network_device

    idx = build_index(read_faa(os.path.join(GOLDEN, "synth_small.faa")), k=4)
    cap = {}
    _, stats = compute_network_device(
        idx, _cfg(join_kernel=join_kernel), capture=cap)
    assert cap["runner"]._all_lane2 is None
    assert stats["lane_table_cols"] is None
    assert stats["join_kernel"] == cap["join_kernel"] == join_kernel
    assert cap["table"] is cap["runner"].join_table
    assert stats["lane_D"] == (cap["runner"].lane_D if join_kernel == "lane"
                               else 0)


def test_work_model_matches_jax():
    from pandelos_tpu.ops.candidate import work_model as jax_work_model
    from pandelos_tpu_torch.ops.candidate import work_model

    from tests.torch_port_util import twin_indexes

    ds = jax_read_faa(os.path.join(GOLDEN, "synth_small.faa"))
    jidx, tidx = twin_indexes(ds, k=4)
    for rb, cb in ((16, 128), (256, 2048)):
        want = jax_work_model(jidx, JaxConfig(row_block=rb, col_block=cb))
        got = work_model(tidx, PipelineConfig(row_block=rb, col_block=cb))
        assert got == want


def test_memory_model_counts_the_selected_table():
    from pandelos_tpu_torch.ops.candidate import memory_model
    from pandelos_tpu_torch.ops.lane_join import lane_depth

    idx = build_index(read_faa(os.path.join(GOLDEN, "synth_small.faa")), k=4)
    got = {jk: memory_model(idx, _cfg(join_kernel=jk), budget_bytes=1e12)
           for jk in ("lane2", "lane", "roll")}
    G_pad, W = got["roll"]["padded_genes"], got["roll"]["padded_width"]
    D = lane_depth(idx)
    assert got["lane2"]["join_table_bytes"] == 4 * G_pad * D * 128
    assert got["lane"]["join_table_bytes"] == 8 * G_pad * D * 128
    assert got["roll"]["join_table_bytes"] == 8 * G_pad * W
    for jk, mm in got.items():
        assert mm["join_kernel"] == jk and mm["fits"]
        assert mm["total_bytes"] - mm["join_table_bytes"] == (
            got["roll"]["total_bytes"] - got["roll"]["join_table_bytes"])
    # an input lane2 cannot pack is counted with the lane table
    hidx = build_index(_homopolymer(FaaDataset), k=3)
    mm = memory_model(hidx, _cfg(), budget_bytes=1e12)
    assert mm["join_kernel"] == "lane"
    assert mm["join_table_bytes"] == 8 * mm["padded_genes"] * lane_depth(
        hidx) * 128
    assert not memory_model(hidx, _cfg(), budget_bytes=1.0)["fits"]


def test_memory_model_counts_the_ring_table_under_xla():
    """The ring joins with the join kernel under backend "xla" too, so
    its model counts the kernel's table there; the replicated xla engine
    joins in the scan and counts none."""
    from pandelos_tpu_torch.ops.candidate import memory_model
    from pandelos_tpu_torch.ops.lane_join import lane_depth

    idx = build_index(read_faa(os.path.join(GOLDEN, "synth_small.faa")), k=4)
    cfg = _cfg(backend="xla", ring_extract=True, n_devices=2)
    ring = memory_model(idx, cfg, budget_bytes=1e12, ring=True)
    rep = memory_model(idx, cfg, budget_bytes=1e12, ring=False)
    assert ring["ring"] and not rep["ring"]
    assert ring["join_kernel"] == "lane2"
    assert ring["join_table_bytes"] == 4 * ring["padded_genes"] * \
        lane_depth(idx) * 128
    assert rep["join_kernel"] is None and rep["join_table_bytes"] == 0
    # by default the device BBH's gate: under xla the replicated engine
    assert not memory_model(idx, cfg, budget_bytes=1e12)["ring"]


def test_memory_model_counts_the_lane_table_build():
    """A lane table is built when no extraction workspace is held: the
    model counts its builder's temporaries in the workspace's place
    where they are larger (wide profiles over many rows), for the run
    that builds one: not for the roll join, nor for the replicated xla
    engine, whose join is in the scan."""
    from pandelos_tpu_torch.ops.candidate import memory_model
    from pandelos_tpu_torch.ops.lane_join import build_temp_bytes

    rng = np.random.default_rng(0)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    n = 1024
    ds = FaaDataset(
        sequences=["".join(rng.choice(aa, 700)) for _ in range(n)],
        names=[f"p{i}" for i in range(n)], descriptions=["d"] * n,
        seq_genome=[i % 4 for i in range(n)],
        genome_names=[f"g{g}" for g in range(4)])
    idx = build_index(ds, k=4)
    base = {jk: memory_model(idx, _cfg(join_kernel=jk), budget_bytes=1e12)
            for jk in ("lane2", "lane", "roll")}
    build = build_temp_bytes(base["roll"]["padded_genes"],
                             base["roll"]["padded_width"])
    assert build > base["roll"]["workspace_bytes"]
    assert base["lane2"]["workspace_bytes"] == build
    assert base["lane"]["workspace_bytes"] == build
    xla = _cfg(backend="xla", n_devices=2)
    assert memory_model(idx, xla, budget_bytes=1e12, ring=False)[
        "workspace_bytes"] == base["roll"]["workspace_bytes"]
    assert memory_model(idx, xla, budget_bytes=1e12, ring=True)[
        "workspace_bytes"] == build


def test_cells_path_fit_check_judges_the_replicated_engine(monkeypatch):
    """compute_cells_candidate runs the replicated engine whatever
    ring_extract says, so its fail-fast memory check judges the
    replicated bytes, not the ring's (smaller at scale, where the
    signatures dominate)."""
    from pandelos_tpu_torch.ops import candidate as tcand

    idx = build_index(read_faa(os.path.join(GOLDEN, "synth_small.faa")), k=4)
    cfg = _cfg(ring_extract=True, n_devices=2)
    judged = []

    def fit(index, config, device, ring=None, n_devices=None):
        judged.append(tcand.memory_model(index, config, ring=ring,
                                         n_devices=n_devices,
                                         budget_bytes=1e12))

    monkeypatch.setattr(tcand, "check_hbm_fit", fit)
    tcand.compute_cells_candidate(idx, cfg)
    (mm,) = judged
    assert mm["n_devices"] == 2 and not mm["ring"]
    assert mm["total_bytes"] == mm["replicated_bytes_per_device"]
    # the two footprints differ here, so the check tells them apart
    assert mm["total_bytes"] != mm["ring_bytes_per_device"]


@pytest.mark.parametrize("backend", ["cuda", "cuda_cells", "xla", "dense"])
def test_run_frees_its_index_without_a_collection(backend):
    """An index and the runner cached on it do not hold each other: with
    the garbage collector off, the index of a run (and with it the
    runner's device tensors) is freed once the caller's references are
    gone.  A first run imports torch's lazily loaded modules, which leave
    reference cycles of their own through the importing frame, so it
    runs before the collector is switched off."""
    import gc
    import weakref

    faa = os.path.join(GOLDEN, "synth_small.faa")
    kw = ({"backend": "cuda", "device_bbh": False}
          if backend == "cuda_cells" else {"backend": backend})
    run_pipeline(faa, None, _cfg(**kw))
    gc.collect()
    gc.disable()
    try:
        cap = {}
        res = run_pipeline(faa, None, _cfg(**kw), capture=cap)
        assert res.stats["n_families"] > 0
        index = weakref.ref(cap["index"])
        if backend != "dense":
            runner = weakref.ref(cap["runner"])
            assert cap["runner"].index is cap["index"]
        del cap, res
        assert index() is None
        if backend != "dense":
            assert runner() is None
    finally:
        gc.enable()
