"""Every command of the port's CLI against the JAX package's CLI on the
CPU (``--device cpu`` for the port, the JAX package pinned to its CPU
backend): the same exit code, the same stdout JSON and the same files.
Timing and rusage fields, which no two runs share, are compared by key.
``refcheck`` (it needs the reference's own tree) is not ported."""

import filecmp
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from pandelos_tpu.cli import main as jax_main
from pandelos_tpu_torch.cli import main as port_main

from tests.test_harness_gbk import GBK_SAMPLE

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")
SMALL = os.path.join(GOLDEN, "synth_small.faa")
TOY = os.path.join(HERE, "data", "toy.faa")
BLOCKS = ["--row-block", "16", "--col-block", "128"]
TIMING = {"phase_times", "phase_s", "elapsed_s", "real_s", "user_s",
          "system_s", "memory_mb", "exdate"}
# the port's device-BBH stats also name the torch device, the join kernel,
# whether the bound-bit matrix ran, and the memory plan's peak and the
# card's bytes it held to; the JAX package's have none of them
PORT_ONLY_NETWORK = {"device", "join_kernel", "bound_bits_mode",
                     "planned_peak_bytes", "budget_bytes"}
# the port's job spans: the timing keys they add (phase_times: the spans
# past the JAX package's six phases and the dotted children; phase_s: the
# engine's last sub-phase, its wait on the card and its memory plan) and
# .stats.json's "trace" block; the JAX package has none of them
PORT_ONLY_TIMING = {
    "phase_times": {"net_write", "clus_write", "report", "stats",
                    "index.encode", "index.device", "cluster.components",
                    "cluster.split", "cluster.assemble", "score.dense_pass",
                    "score.host_corrections"},
    "phase_s": {"host.stats", "wait", "plan"},
    "stats.json": {"trace"},
}


def _masked(x):
    """``x`` with every timing field replaced by its keys (a dict) or a
    marker (a number): compared by key, the port's own timing keys
    (``PORT_ONLY_TIMING``) dropped."""
    if isinstance(x, dict):
        return {k: (sorted(set(v) - PORT_ONLY_TIMING.get(k, set()))
                    if isinstance(v, dict) else "timing")
                if k in TIMING else _masked(v) for k, v in x.items()
                if k not in PORT_ONLY_TIMING["stats.json"]
                or not isinstance(v, dict)}
    if isinstance(x, list):
        return [_masked(v) for v in x]
    return x


def _network_fields(doc, same_path):
    """Drop the port-only network fields of a run's stats, or the whole
    network stats where the two runs took different paths."""
    stats = doc.get("stats", {}) if isinstance(doc, dict) else {}
    if not same_path:
        stats.pop("network", None)
    for k in PORT_ONLY_NETWORK:
        stats.get("network", {}).pop(k, None)


def _outputs(stdout, out_dir, same_path):
    """The JSON objects a command printed (one, or one a line), with its
    output directory written as ``{d}``."""
    text = stdout.replace(out_dir, "{d}")
    try:
        docs = [json.loads(text)]
    except json.JSONDecodeError:
        docs = [json.loads(line) for line in text.splitlines() if line]
    for doc in docs:
        _network_fields(doc, same_path)
    return _masked(docs)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _same_file(a, b, same_path):
    if a.endswith(".npz"):  # zip members carry their write time
        with np.load(a) as x, np.load(b) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k])
        return
    if a.endswith(".json"):
        with open(a) as fa, open(b) as fb:
            if a.endswith("log.json"):  # one report a line
                x = [json.loads(line) for line in fa]
                y = [json.loads(line) for line in fb]
            else:
                x, y = json.load(fa), json.load(fb)
        x, y = _masked(x), _masked(y)
        for doc in (x if isinstance(x, list) else [x]) + (
                y if isinstance(y, list) else [y]):
            _network_fields(doc, same_path)
        if a.endswith("log.json"):
            for r, dirpath in ((x, os.path.dirname(a)),
                               (y, os.path.dirname(b))):
                for line in r:
                    line["inpath"] = os.path.relpath(line["inpath"], dirpath)
                    for bench in ("new_bench", "old_bench"):
                        line[bench] = sorted(line[bench])
        assert x == y, a
        return
    assert filecmp.cmp(a, b, shallow=False), a


def _both(tmp_path, argv, port_extra=("--device", "cpu"), jax_argv=None,
          same_path=True):
    """Run ``argv`` (``{d}`` names the command's output directory)
    through both CLIs; assert equal exit codes, stdout and files.
    ``same_path=False``: the runs' network statistics come from different
    paths (the port's xla backend builds the network on the device by
    default, the JAX package's only on an accelerator) and are not
    compared.  Returns (exit code, the port's stdout objects, its
    directory)."""
    got = {}
    for name, main, extra, args in (
            ("port", port_main, list(port_extra), argv),
            ("jax", jax_main, [], jax_argv or argv)):
        d = str(tmp_path / name)
        os.makedirs(d, exist_ok=True)
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main([a.replace("{d}", d) for a in args] + extra)
        got[name] = (rc, _outputs(buf.getvalue(), d, same_path), d)
    (rc, out, d), (jrc, jout, jd) = got["port"], got["jax"]
    assert rc == jrc
    assert out == jout
    assert _files(d) == _files(jd)
    for f in _files(d):
        _same_file(os.path.join(d, f), os.path.join(jd, f), same_path)
    return rc, out, d


@pytest.mark.parametrize("backend", ["oracle", "reference", "xla"])
def test_run(tmp_path, backend):
    argv = ["run", SMALL, "{d}/s", "--backend", backend] + BLOCKS
    if backend == "xla":  # device BBH, with the other run flags
        argv += ["--device-bbh", "--report", "--checkpoint-dir", "{d}/ck"]
    _, _, d = _both(tmp_path, argv)
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(os.path.join(d, "s" + suffix),
                           os.path.join(GOLDEN, "synth_small" + suffix),
                           shallow=False)
    if backend == "xla":
        assert sorted(os.listdir(os.path.join(d, "ck"))) == [
            "index.npz", "network.net"]
        assert os.path.getsize(os.path.join(d, "s.report")) > 0


def test_run_default_engine(tmp_path):
    """The port's default (the cuda engine, lane2, device BBH) against
    the JAX package's pallas engine with device BBH."""
    argv = ["run", TOY, "{d}/t"] + BLOCKS
    _both(tmp_path, argv, jax_argv=["run", TOY, "{d}/t", "--backend",
                                    "pallas", "--device-bbh"] + BLOCKS)


def test_complexity_cluster_check_k_quality(tmp_path):
    _both(tmp_path, ["complexity", SMALL])
    _both(tmp_path, ["cluster", SMALL,
                     os.path.join(GOLDEN, "synth_small.net"), "{d}/c"],
          port_extra=())
    net = os.path.join(GOLDEN, "synth_small.net")
    assert _both(tmp_path, ["check", net, net], port_extra=())[0] == 0
    assert _both(tmp_path, ["check", net, os.path.join(
        GOLDEN, "synth_edge.net"), "--tolerance", "0"], port_extra=())[0] == 1
    _both(tmp_path, ["k", SMALL], port_extra=())
    _both(tmp_path, ["quality", SMALL,
                     os.path.join(GOLDEN, "synth_small.clus")], port_extra=())


def test_bench(tmp_path):
    _, out, _ = _both(tmp_path, ["bench", SMALL, "{d}/b", "--backend",
                                 "oracle"])
    assert out[0]["bench"] == dict.fromkeys(
        ["real_s", "user_s", "system_s", "memory_mb", "exdate"], "timing")


def test_auto(tmp_path):
    """One round (the budget passes the input), each backend in its own
    child process; the host-only backends keep the children cheap (a
    device backend's child is tested in test_torch_harness_gbk.py)."""
    rc, out, d = _both(tmp_path, ["auto", SMALL, "{d}/a", "--seq-start",
                                  "1000", "--max-rounds", "1",
                                  "--backend-new", "reference"])
    assert rc == 0 and out == [{"rounds": 1, "all_identical": True}]


def test_reinput_gbk2faa_synth(tmp_path):
    gbk = tmp_path / "gbk"
    gbk.mkdir()
    (gbk / "a.gbk").write_text(GBK_SAMPLE)
    _both(tmp_path, ["reinput", SMALL, "{d}/r.faa", "--max-sequences", "9",
                     "--max-genomes", "2"], port_extra=())
    _both(tmp_path, ["gbk2faa", str(gbk), "{d}/g.faa"], port_extra=())
    _both(tmp_path, ["synth", "toy", "{d}/toy.faa"], port_extra=())
    assert _both(tmp_path, ["synth", "nope", "{d}/x.faa"],
                 port_extra=())[0] == 2


def test_examples(tmp_path):
    """The toy preset through both CLIs' xla backend with device BBH."""
    _, out, d = _both(tmp_path, ["examples", "{d}/ex", "--presets", "toy",
                                 "--backend", "xla", "--device-bbh"]
                      + BLOCKS)
    assert out[0]["toy"]["n_families"] == 4
    assert sorted(os.listdir(os.path.join(d, "ex"))) == [
        "examples.json", "toy.clus", "toy.faa", "toy.net", "toy.stats.json"]


@pytest.mark.parametrize("flag", [["--devices", "2"],
                                  ["--ring", "--devices", "2"],
                                  ["--distributed"]])
def test_multi_device_flags_exit_2(tmp_path, capsys, monkeypatch, flag):
    """The multi-device flags run on CPU shards and write the golden toy
    outputs: two shards, the ring over two, and a one-process gloo group
    (``--distributed``, which prints its topology to stderr and leaves
    the group when done)."""
    import torch.distributed as dist

    if "--distributed" in flag:
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        monkeypatch.setenv("PANDELOS_COORDINATOR", f"127.0.0.1:{port}")
        monkeypatch.setenv("PANDELOS_NUM_PROCS", "1")
        monkeypatch.setenv("PANDELOS_PROC_ID", "0")
    prefix = str(tmp_path / "x")
    assert port_main(["run", TOY, prefix, "--device", "cpu"] + flag
                     + BLOCKS) == 0
    out, err = capsys.readouterr()
    stats = json.loads(out)["stats"]["network"]
    assert stats["n_devices"] == (1 if "--distributed" in flag else 2)
    assert stats["ring_extract"] is ("--ring" in flag)
    if "--distributed" in flag:
        assert json.loads(err.strip().splitlines()[-1]) == {"distributed": {
            "process_id": 0, "num_processes": 1, "local_devices": 1,
            "global_devices": 1}}
    assert not dist.is_initialized()
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, "toy" + suffix),
                           shallow=False), suffix


@pytest.mark.parametrize("flags", [
    ["--ring"], ["--ring", "--devices", "2", "--backend", "xla"],
    ["--devices", "2", "--backend", "dense"]],
    ids=["ring_one_device", "ring_xla", "dense_two_devices"])
def test_multi_device_flags_run_as_the_jax_package_runs_them(
        tmp_path, capsys, flags):
    """The flags the JAX package runs otherwise than asked run as it runs
    them and write the goldens: --ring on one device or under xla runs
    the replicated engine; dense ignores --devices."""
    prefix = str(tmp_path / "x")
    assert port_main(["run", TOY, prefix, "--device", "cpu"] + flags
                     + BLOCKS) == 0
    stats = json.loads(capsys.readouterr().out)["stats"]["network"]
    assert stats.get("ring_extract", False) is False
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, "toy" + suffix),
                           shallow=False), suffix


def test_bad_multi_device_flags_exit_2(tmp_path, capsys, monkeypatch):
    """More shards than cards exits 2 naming the reason, writing
    nothing."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    prefix = str(tmp_path / "x")
    assert port_main(["run", TOY, prefix, "--devices", "2"] + BLOCKS) == 2
    assert capsys.readouterr().err.strip() == (
        "error: config requests n_devices=2 (2 in this process) but only 1 "
        "CUDA device(s) exist; pass devices= to put several shards on one "
        "card")
    assert not os.path.exists(prefix + ".net")


def test_device_commands_default_to_the_card(tmp_path, monkeypatch, capsys):
    """run, complexity's pipeline, bench, examples and auto take the card
    unless told otherwise; without one they fail, they do not fall back."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["run", TOY, str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["bench", TOY, str(tmp_path / "b")])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["examples", str(tmp_path / "ex"), "--presets", "toy"])
    assert not os.path.exists(str(tmp_path / "x.net"))
