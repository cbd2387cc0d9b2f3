"""The harness on the CPU: cells found by name, a new traffic file
picked up without an edit, each per-layer reader on a small recorded
trace, the result line's keys, the refusal without a card, and the
faults that must turn ``correct`` false."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, jobs, synth, trace

from conftest import ROOT

SMALL = dict(n_genomes=4, n_families=30, singleton_per_genome=3,
             min_len=60, max_len=200, seed=5, aa_freq="mycoplasma",
             divergence_sigma=0.9, indel_rate=0.8, max_paralogs=5,
             length_lognorm=True, paralog_rate=0.3)
CPU_OPTIONS = {"row_block": 16, "col_block": 128, "candidate_cap": 64}
SEED = 2**33 + 99


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _small_cell(name="mycoplasma64.full"):
    cell = harness.load_cell(name)
    cell.config = dict(cell.config, generator=SMALL, pipeline=CPU_OPTIONS)
    return cell


def test_every_cell_resolves_by_name():
    spec = _spec()
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        synth.SynthSpec(**cell.config["generator"])
        assert cell.chips == w["chips"] == 1
        names = {m["name"] for m in cell.per_layer}
        assert names == {m["name"] for m in spec["per_layer"]}
        for m in cell.per_layer:
            assert hasattr(harness.load_metric(m["name"]), "read")
        assert {m["name"] for m in cell.end_to_end} == {
            "job_s", "peak_mem_gib", "setup_s"}
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_a_new_traffic_file_is_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark", "configs"),
                    root / "benchmark" / "configs")
    shutil.copytree(os.path.join(ROOT, "benchmark", "traffic"),
                    root / "benchmark" / "traffic")
    before = {p: (root / "benchmark" / "traffic" / p).read_bytes()
              for p in os.listdir(root / "benchmark" / "traffic")}
    (root / "benchmark" / "traffic" / "again.json").write_text(
        json.dumps({"why": "the whole set once more"}))
    spec = _spec()
    spec["workloads"].append({"name": "mycoplasma64.again",
                              "config": "mycoplasma64",
                              "traffic": "again", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("mycoplasma64.again", root=str(root))
    assert cell.traffic == {"why": "the whole set once more"}
    cell.config = dict(cell.config, generator=SMALL)
    faa = jobs.make_input(cell.config, SEED, str(tmp_path))
    with open(faa) as fh:
        n_genes = sum(1 for line in fh if line.strip()) // 2
    assert n_genes == len(jobs.dataset(cell.config, SEED).sequences)
    assert before == {p: (root / "benchmark" / "traffic" / p).read_bytes()
                      for p in before}


def _recorded():
    """Two jobs of 10 s on a trace clock in ns, with kernels in the
    engine of each and a copy in the first's index."""
    s = 10**9
    pt = {"ingest": 0.5, "k_select": 0.5, "index": 2.0, "score": 2.0,
          "network": 0.0, "cluster": 3.0}
    jobs_ = []
    ranges = {}
    for i, start in enumerate((100 * s, 111 * s)):
        jobs_.append({"phase_times": dict(pt),
                      "phase_s": {"setup.pad_profiles": 0.25 * (i + 1)},
                      "wall_start_ns": 7 * s, "net_written_ns": 13 * s})
        ranges[i] = (start, start + 10 * s)
    ops = [("lane2_join_kernel(int const*)", 103 * s, 103 * s + 2 * 10**6),
           ("gemm", 104 * s, 104 * s + 10**9 // 2),
           ("Memcpy HtoD", 101 * s, 101 * s + 10**9 // 4),
           ("lane2_join_kernel(int const*)", 114 * s, 114 * s + 3 * 10**6)]
    work = [{"bytes": 0, "ops": 3.345408e13 * 1e-3, "pairs": 1}] * 2
    rec = trace.build_record(jobs_, ops, ranges, work)
    with open(os.path.join(ROOT, "benchmark", "peaks.json")) as fh:
        rec["peak"] = json.load(fh)["NVIDIA H100 80GB HBM3"]
    return rec


def test_rebuilt_phases_and_idle_labels():
    rec = _recorded()
    s = 10**9
    assert [x for x in rec["spans"] if x[1] < 111 * s] == [
        ("ingest", 100 * s, 100 * s + s // 2),
        ("k_select", 100 * s + s // 2, 101 * s),
        ("index", 101 * s, 103 * s),
        ("engine", 103 * s, 105 * s),
        # the .net was last written 6 s after the job started
        ("net_write", 105 * s, 106 * s),
        ("cluster", 106 * s, 109 * s),
        ("tail", 109 * s, 110 * s),
        ("harness", 110 * s, 111 * s),
    ]
    bd = trace.breakdown(rec)
    idle = dict(bd["idle_gaps"])
    assert idle == pytest.approx({
        "cluster": 6.0, "engine": 4.0 - 0.502 - 0.003, "index": 3.75,
        "net_write": 2.0, "tail": 2.0, "ingest": 1.0, "k_select": 1.0,
        "harness": 1.0})
    assert [n for n, _ in bd["idle_gaps"]][:3] == ["cluster", "index",
                                                  "engine"]
    assert bd["device_ops"][0][0] == "gemm"
    assert bd["device_ops"][2] == ["lane2_join_kernel(int const*)",
                                   pytest.approx(0.005)]
    assert len(bd["device_ops"]) == 3


@pytest.mark.parametrize("name,value", [
    ("ingest_s", 1.0), ("index_s", 2.0), ("engine_s", 2.0),
    ("pad_s", 0.375), ("cluster_s", 3.0), ("join_kernel_ms", 2.5),
    ("join_roofline", 100.0 * 2e-3 / 5e-3),
    ("device_idle_share", 100.0 * (1 - (0.25 + 0.5 + 0.005) / 21)),
    ("engine_idle_share", 100.0 * (1 - (0.5 + 0.002 + 0.003) / 4)),
])
def test_each_reader_on_a_recorded_trace(name, value):
    assert harness.load_metric(name).read(_recorded()) == pytest.approx(
        value)


def test_readers_find_nothing_to_read():
    rec = _recorded()
    rec["ops"] = [op for op in rec["ops"] if "join" not in op[0]]
    assert harness.load_metric("join_kernel_ms").read(rec) is None
    assert harness.load_metric("join_roofline").read(rec) is None
    for job in rec["jobs"]:
        job["phase_s"] = {}
    assert harness.load_metric("pad_s").read(rec) is None


def _measure(tmp_path, traced=False, job=harness.pipeline_job,
             seconds=0.5):
    return harness.measure(_small_cell(), SEED, seconds, traced, "cpu",
                           str(tmp_path), time.monotonic(), job=job,
                           workers=1)


def test_result_line_has_the_contract_keys(tmp_path):
    for traced in (False, True):
        out = _measure(tmp_path, traced)
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(out) == keys + (["breakdown"] if traced else []) + [
            "checks"]
        assert out["correct"] is True and out["failed"] == 0
        assert set(out["device"]) >= {"platform", "kind", "count",
                                      "memory_peak_bytes"}
        if traced:
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
            assert {"busy_s", "window_s"} <= set(out["device"])
        else:
            assert set(out["metrics"]) == {"job_s", "peak_mem_gib",
                                           "setup_s"}
        for c in out["checks"].values():
            assert set(c) == {"value", "limit"}


def test_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mycoplasma64.full", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 2 and res.stdout == ""


def _unchanged(faa, prefix, options, capture=None):
    """A job that leaves its state as it was: it writes nothing."""
    return harness.pipeline_job(faa, prefix + ".elsewhere", options,
                                capture)


def _half(faa, prefix, options, capture=None):
    """Half of the genes left out of the job."""
    with open(faa) as fh:
        lines = fh.read().split("\n")[:-1]
    half = faa + ".half"
    with open(half, "w") as fh:
        fh.write("\n".join(lines[: len(lines) // 4 * 2]) + "\n")
    return harness.pipeline_job(half, prefix, options, capture)


def _altered_weight(faa, prefix, options, capture=None):
    res = harness.pipeline_job(faa, prefix, options, capture)
    with open(prefix + ".net") as fh:
        lines = fh.read().split("\n")[:-1]
    a, b, _ = lines[0].split("\t")
    lines[0] = f"{a}\t{b}\t0.123"
    with open(prefix + ".net", "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return res


def _altered_family(faa, prefix, options, capture=None):
    res = harness.pipeline_job(faa, prefix, options, capture)
    with open(prefix + ".clus") as fh:
        lines = fh.read().split("\n")[:-1]
    two = [i for i, line in enumerate(lines) if " " in line.strip()]
    lines[two[0]] = lines[two[0]].strip().split(" ")[0]
    with open(prefix + ".clus", "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return res


def _wrong_k(faa, prefix, options, capture=None):
    """k chosen one above the entropy rule's."""
    from benchmark.reference.network import select_k
    from benchmark.reference.job import read_faa

    k = select_k(read_faa(faa)[0]) + 1
    return harness.pipeline_job(faa, prefix, dict(options, k=k), capture)


_CALLS = []


def _one_job_altered(faa, prefix, options, capture=None):
    """Every timed job but the second one is sound."""
    _CALLS.append(prefix)
    res = harness.pipeline_job(faa, prefix, options, capture)
    if sum(p.endswith("job") for p in _CALLS) == 2:
        with open(prefix + ".clus", "a") as fh:
            fh.write("extra \n")
    return res


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered_weight,
                                   _altered_family, _wrong_k,
                                   _one_job_altered])
def test_a_broken_timed_path_is_not_correct(fault, tmp_path):
    _CALLS.clear()
    out = _measure(tmp_path, job=fault,
                   seconds=4.0 if fault is _one_job_altered else 0.5)
    assert out["correct"] is False
    if fault is _wrong_k:
        assert out["checks"]["k_gap"]["value"] == 1
    if fault is _one_job_altered:
        assert out["attempted"] >= 2
        bad = (out["checks"]["jobs_unlike_judged"]["value"]
               + out["checks"]["clus_lines_differing"]["value"])
        assert bad >= 1


@pytest.mark.cuda
def test_mycoplasma64_full_once_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mycoplasma64.full", "--seed", "2718281828", "--seconds", "10",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().split("\n")[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"


def test_every_seed_holds_the_same_genes_in_another_order():
    config = {"generator": SMALL}
    one = jobs.dataset(config, SEED)
    assert one == jobs.dataset(config, SEED)
    other = jobs.dataset(config, SEED + 1)
    assert sorted(one.sequences) == sorted(other.sequences)
    assert one.sequences != other.sequences
    made = synth.generate(synth.SynthSpec(**SMALL))
    assert sorted(made.names) == sorted(one.names)
    for ds in (one, other):  # each gene keeps its genome
        genome = {n: ds.genome_names[g] for n, g in zip(ds.names,
                                                           ds.seq_genome)}
        assert all(genome[n] == made.genome_names[g]
                   for n, g in zip(made.names, made.seq_genome))


def _raises(faa, prefix, options, capture=None):
    res = harness.pipeline_job(faa, prefix, options, capture)
    if prefix.endswith("warm"):  # set-up's warm-up job: a crash there
        return res               # ends the run with no result
    raise RuntimeError("a timed job that fails after writing its files")


def test_a_job_that_raises_is_failed(tmp_path):
    out = _measure(tmp_path, job=_raises)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1
