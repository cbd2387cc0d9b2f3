"""The port's bench harness, synthetic presets, quality report and GenBank
reader against the JAX package's, on the cases of
tests/test_harness_gbk.py: datasets, files and reports equal; timing and
rusage fields (which no two runs share) compared by key."""

import dataclasses
import filecmp
import json
import os

import pytest

from pandelos_tpu.bench import harness as jh
from pandelos_tpu.bench import synth as jsynth
from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.io.faa import write_faa as jax_write_faa
from pandelos_tpu.io.gbk import gbk_dir_to_faa as jax_gbk_dir_to_faa
from pandelos_tpu_torch.bench import harness as th
from pandelos_tpu_torch.bench import synth as tsynth
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.io.faa import write_faa
from pandelos_tpu_torch.io.gbk import gbk_dir_to_faa

from tests.test_harness_gbk import GBK_SAMPLE

HERE = os.path.dirname(__file__)
CACHE = os.path.join(HERE, "..", "bench_cache")
BENCH_KEYS = {"real_s", "user_s", "system_s", "memory_mb", "exdate"}


def _fields(ds):
    return (ds.sequences, ds.names, ds.descriptions, list(ds.seq_genome),
            ds.genome_names)


def _spec(i, **kw):
    return dict(n_genomes=4, n_families=10, singleton_per_genome=2,
                min_len=20, max_len=40, seed=i, **kw)


def _same_files(a, b, names):
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


def test_reinput_truncation():
    spec = _spec(1)
    ds = tsynth.generate(tsynth.SynthSpec(**spec))
    jds = jsynth.generate(jsynth.SynthSpec(**spec))
    assert _fields(ds) == _fields(jds)
    for kw in (dict(max_sequences=15), dict(max_genomes=2),
               dict(max_sequences=7, max_genomes=3)):
        assert _fields(th.reinput(ds, **kw)) == _fields(jh.reinput(jds, **kw))
    sub = th.reinput(ds, max_sequences=15)
    assert sub.n_sequences == 15 and sub.sequences == ds.sequences[:15]
    sub2 = th.reinput(ds, max_genomes=2)
    assert sub2.n_genomes == 2 and set(sub2.seq_genome) == {0, 1}
    assert sub2.genome_names == ds.genome_names[:2]


def test_run_measured(tmp_path):
    spec = dict(n_genomes=2, n_families=6, singleton_per_genome=1,
                min_len=30, max_len=60, seed=2)
    res, bench = th.run_measured(
        None, str(tmp_path / "m"), PipelineConfig(backend="oracle"),
        dataset=tsynth.generate(tsynth.SynthSpec(**spec)))
    jres, jbench = jh.run_measured(
        None, str(tmp_path / "j"), JaxConfig(backend="oracle"),
        dataset=jsynth.generate(jsynth.SynthSpec(**spec)))
    assert bench.real_s > 0 and bench.memory_mb > 0
    assert set(bench.to_dict()) == set(jbench.to_dict()) == BENCH_KEYS
    assert res.clus_lines == jres.clus_lines
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(str(tmp_path / ("m" + suffix)),
                           str(tmp_path / ("j" + suffix)), shallow=False)


def test_auto_sweep(tmp_path):
    ds = tsynth.generate(tsynth.SynthSpec(
        n_genomes=3, n_families=10, singleton_per_genome=1, min_len=25,
        max_len=60, seed=3))
    faa = str(tmp_path / "d.faa")
    write_faa(faa, ds)
    kw = dict(backend_new="xla", backend_ref="oracle", seq_start=10,
              seq_jump=20, seq_factor=2.0, max_rounds=3, in_process=True)
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    reports = th.auto_sweep(faa, t, device="cpu", **kw)
    jreports = jh.auto_sweep(faa, j, **kw)
    assert len(reports) >= 2
    assert all(r["check"]["identical"] for r in reports)
    # every subset, network and family file equal (the .stats.json hold
    # times); the reports (and log.json's lines) equal but for the bench
    # fields, compared by key
    names = sorted(os.listdir(t))
    assert names == sorted(os.listdir(j))
    _same_files(t, j, [n for n in names
                       if n.endswith((".faa", ".net", ".clus"))])
    with open(os.path.join(t, "log.json")) as fh:
        logged = [json.loads(line) for line in fh]
    assert logged == reports
    for r, jr in zip(reports, jreports):
        for b in ("new_bench", "old_bench"):
            assert set(r.pop(b)) == set(jr.pop(b)) == BENCH_KEYS
        r["inpath"] = os.path.relpath(r["inpath"], t)
        jr["inpath"] = os.path.relpath(jr["inpath"], j)
    assert reports == jreports


def test_gbk_parser(tmp_path):
    d = tmp_path / "gbks"
    d.mkdir()
    (d / "test1.gbk").write_text(GBK_SAMPLE)
    (d / "test2.gb").write_text(GBK_SAMPLE.replace("T1_0002", "T2_0002"))
    ds = gbk_dir_to_faa(str(d))
    assert _fields(ds) == _fields(jax_gbk_dir_to_faa(str(d)))
    assert _fields(gbk_dir_to_faa(str(d), genome_name="x")) == _fields(
        jax_gbk_dir_to_faa(str(d), genome_name="x"))
    assert ds.n_genomes == 2 and ds.n_sequences == 4
    assert ds.sequences[0] == "MKRISTTITTTITITTGNGAG"
    assert ds.sequences[1].startswith("MLTKYALVAVIVLCLTV")
    assert "LAYEPKK" in ds.sequences[1] and " " not in ds.sequences[1]
    assert ds.names[0] == "test1:TEST0001.1:T1_0001:1"
    assert ds.descriptions[1] == "beta protein"


def test_cli_new_subcommands(tmp_path):
    from pandelos_tpu.cli import main as jmain
    from pandelos_tpu_torch.cli import main

    for m, d, extra in ((main, tmp_path / "t", ["--device", "cpu"]),
                        (jmain, tmp_path / "j", [])):
        d.mkdir()
        assert m(["synth", "toy", str(d / "toy.faa")]) == 0
        assert m(["reinput", str(d / "toy.faa"), str(d / "sub.faa"),
                  "--max-sequences", "4"]) == 0
        assert m(["bench", str(d / "sub.faa"), str(d / "b"), "--backend",
                  "oracle"] + extra) == 0
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"),
                ["toy.faa", "sub.faa", "b.net", "b.clus"])
    assert filecmp.cmp(str(tmp_path / "t" / "toy.faa"),
                       os.path.join(CACHE, "toy.faa"), shallow=False)


def test_cli_examples_runner(tmp_path):
    from pandelos_tpu.cli import main as jmain
    from pandelos_tpu_torch.cli import main

    got = {}
    for m, d, extra in ((main, "t", ["--device", "cpu"]), (jmain, "j", [])):
        wd = str(tmp_path / d)
        assert m(["examples", wd, "--presets", "toy", "--backend",
                  "oracle"] + extra) == 0
        with open(os.path.join(wd, "examples.json")) as fh:
            got[d] = json.load(fh)
        assert set(got[d]["toy"]) == {"elapsed_s", "n_families", "quality"}
        got[d]["toy"].pop("elapsed_s")
    assert got["t"] == got["j"]
    assert got["t"]["toy"]["n_families"] == 4
    assert got["t"]["toy"]["quality"]["n_genomes"] == 2
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"),
                ["toy.faa", "toy.net", "toy.clus"])


def test_run_measured_subprocess(tmp_path):
    """Per-run child process: its own peak RSS, and the whole config
    (device included) reaches the child: an xla run with device "cpu"
    runs here, where a card run would fail."""
    ds = tsynth.generate(tsynth.SynthSpec(
        n_genomes=2, n_families=6, singleton_per_genome=1, min_len=25,
        max_len=60, seed=5))
    faa = str(tmp_path / "d.faa")
    write_faa(faa, ds)
    bench = th.run_measured_subprocess(
        faa, str(tmp_path / "out"),
        PipelineConfig(backend="xla", device="cpu", row_block=8,
                       col_block=128))
    assert bench.real_s > 0
    assert 0 < bench.memory_mb < 4096
    jh.run_measured(faa, str(tmp_path / "j"), JaxConfig(backend="oracle"))
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(str(tmp_path / ("out" + suffix)),
                           str(tmp_path / ("j" + suffix)), shallow=False)


def test_run_measured_subprocess_imports_only_the_port():
    import inspect

    src = inspect.getsource(th.run_measured_subprocess)
    assert "pandelos_tpu_torch.bench.harness" in src
    assert "from pandelos_tpu." not in src and "import jax" not in src


@pytest.mark.parametrize("name", sorted(jsynth.PRESETS))
def test_synth_presets_match_jax(name):
    """Every preset: the same spec, and the generator at that spec (with
    the families cut to 12, keeping every other field) writes the same
    dataset as the JAX package's."""
    spec = tsynth.PRESETS[name]
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        jsynth.PRESETS[name])
    kw = {**dataclasses.asdict(spec),
          "n_families": min(12, spec.n_families)}
    assert _fields(tsynth.generate(tsynth.SynthSpec(**kw))) == _fields(
        jsynth.generate(jsynth.SynthSpec(**kw)))


@pytest.mark.parametrize("name", ["toy", "mycoplasma16"])
def test_synth_preset_is_bench_cache(tmp_path, name):
    """At full size the generated preset is byte-identical to the
    committed bench_cache file, through both packages' writers."""
    path = str(tmp_path / f"{name}.faa")
    write_faa(path, tsynth.generate_preset(name))
    assert filecmp.cmp(path, os.path.join(CACHE, f"{name}.faa"),
                       shallow=False)
    if name == "toy":
        jpath = str(tmp_path / "j.faa")
        jax_write_faa(jpath, jsynth.generate_preset(name))
        assert filecmp.cmp(path, jpath, shallow=False)
