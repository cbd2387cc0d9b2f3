"""The device engine's heavy-row pass on the CPU: rows whose candidates
pass ``MAX_CANDIDATE_CAP`` are extracted again on the device, in chunks
each at its own cap, and only their valid cells kept, so the job stays
on the device path (an ``extract.heavy`` span).
Its ``.net`` and ``.clus`` are byte-identical to the plain reference's
(``benchmark/reference/job.py``: NumPy and PyTorch, none of either
package) and to the JAX package's cells path (``device_bbh=False``, the
path its own engine falls back to past the cap; its caps are literals,
left as they are).  ``MAX_CANDIDATE_CAP`` (and where rows pass it,
``MAX_RETRY_CAP``, the cells path's limit of the device retry) are
lowered here so that a small set overflows; their sources are left as
they are.  The memory model counts the pass's segment."""

import numpy as np
import pytest
import torch

from benchmark.reference import job as reference
from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.pipeline import run_pipeline as jax_run_pipeline
from pandelos_tpu_torch.bench.synth import SynthSpec, generate
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.io.faa import write_faa
from pandelos_tpu_torch.ops import candidate, net_device
from pandelos_tpu_torch.pipeline import run_pipeline

from tests.test_torch_xla_backend import _Allocated

# 181 genes in 6 genomes, k=3: rows hold 0-12 candidates, 58 of them 9-12
SPEC = SynthSpec(n_genomes=6, n_families=24, singleton_per_genome=3,
                 min_len=60, max_len=200, seed=5, paralog_rate=0.3,
                 max_paralogs=4)
CAP = 8  # MAX_CANDIDATE_CAP: the ladder runs 2 -> 8; rows of 9-12 pass it
HEAVY = 58  # rows past CAP
RETRY = 10  # MAX_RETRY_CAP where rows pass it too (those of 11-12)
ENGINE = ["setup.pad_profiles", "setup.runner", "setup.signatures",
          "extract", "plan", "flatten_join", "bbh", "fetch", "host.edges",
          "host.stats"]


def _cfg(**kw):
    return PipelineConfig(**{"device": "cpu", "row_block": 16,
                             "col_block": 128, "candidate_cap": 2, **kw})


def _bytes(prefix):
    out = []
    for suffix in (".net", ".clus"):
        with open(prefix + suffix, "rb") as fh:
            out.append(fh.read())
    return out


@pytest.fixture(scope="module")
def expected(tmp_path_factory):
    """The input; the .net and .clus bytes of the plain reference and of
    the JAX package's cells path; every row's candidates summed (a run
    in which no row overflows joins each once)."""
    d = tmp_path_factory.mktemp("heavy_rows")
    faa = str(d / "in.faa")
    write_faa(faa, generate(SPEC))
    ref = reference.run(faa, "cpu", workers=1)
    want = [reference.net_text(ref).encode(),
            "".join(line + "\n" for line in ref.clus_lines).encode()]
    jax_run_pipeline(faa, str(d / "jax"), JaxConfig(
        backend="xla", device_bbh=False, row_block=16, col_block=128,
        candidate_cap=2))
    whole = run_pipeline(faa, None, _cfg(candidate_cap=64))
    return faa, want, _bytes(str(d / "jax")), whole.stats["network"]


CASES = {
    "cuda_over_cap": ({}, None),
    "cuda_over_retry_cap": ({}, RETRY),
    "xla_over_cap": ({"backend": "xla"}, None),
    "xla_over_retry_cap": ({"backend": "xla"}, RETRY),
    "cuda_two_shards_over_retry_cap": ({"n_devices": 2}, RETRY),
    "cuda_ring_over_retry_cap": ({"n_devices": 2, "ring_extract": True},
                                 RETRY),
    "no_overflow": ({"candidate_cap": 64}, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_heavy_rows_stay_on_the_device_path(name, expected, monkeypatch,
                                            tmp_path):
    opts, retry = CASES[name]
    if name != "no_overflow":
        monkeypatch.setattr(net_device, "MAX_CANDIDATE_CAP", CAP)
    if retry is not None:
        monkeypatch.setattr(candidate, "MAX_RETRY_CAP", retry)
    walked = []
    real = candidate._host_fallback_rows
    monkeypatch.setattr(candidate, "_host_fallback_rows",
                        lambda index, rows: walked.append(rows) or real(
                            index, rows))
    faa, want, jax_out, whole = expected
    prefix = str(tmp_path / "port")
    res = run_pipeline(faa, prefix, _cfg(**opts))
    got = _bytes(prefix)
    assert got == want, "the port against the plain reference"
    assert got == jax_out, "the port against the JAX package's cells path"

    net = res.stats["network"]
    by = {s["name"]: s for s in res.spans}
    assert "network" not in by and net["device_bbh"]
    assert not walked  # every row on the device, past the retry cap too
    # every candidate of every row joined once, the heavy rows' included
    assert net["n_joined_pairs"] == whole["n_joined_pairs"]
    assert net["n_cells"] == whole["n_cells"]
    engine = [s["name"] for s in res.spans
              if s["parent"] == by["score"]["id"]]
    tree = [n for n in ENGINE
            if n != "flatten_join" or opts.get("backend") != "xla"]
    if name == "no_overflow":
        # the span tree as it was before the pass existed
        assert engine == tree
        assert by["extract"]["counters"]["passes"] == 1
        return
    assert engine == tree[:4] + ["extract.heavy"] + tree[4:]
    assert by["extract"]["counters"]["K"] == CAP
    heavy = by["extract.heavy"]["counters"]
    rows = heavy["rows"]
    if opts.get("ring_extract"):
        # a row passes the cap where one ring step's candidates do
        assert 0 < rows < HEAVY
    else:
        assert rows == HEAVY
    # 128 slots a row; a chunk holds at most a shard's main extraction
    # slots (at most 12 blocks of 16 rows, 8 slots each): 16 rows a chunk
    assert heavy["K"] == 128 and heavy["chunks"] == -(-rows // 16)
    assert CAP * rows < heavy["pairs"] <= 12 * rows
    # the fill kernel runs on a card only (test_torch_kernels_on_card.py)
    assert heavy["fill_launches"] == 0
    assert net["phase_s"]["extract.heavy"] > 0


def test_memory_model_counts_the_heavy_segment(expected, monkeypatch):
    """The model counts the heavy-row segment at an in-scan slot's bytes
    (its counters and the BBH over them), on both backends and on the
    ring; a run hands it the segment it built: every heavy row's slot of
    its chunk's row blocks, as wide as the most valid cells of a heavy
    row; and the segment and what the flat BBH allocates for it are
    within the model's bytes."""
    from pandelos_tpu_torch.index import build_index
    from pandelos_tpu_torch.io.faa import read_faa
    from pandelos_tpu_torch.ksel import select_k
    from pandelos_tpu_torch.oracle.cells import (
        apply_validity,
        compute_cells_oracle,
    )

    faa = expected[0]
    ds = read_faa(faa)
    idx = build_index(ds, k=select_k(ds.sequences))
    for opts in ({}, {"backend": "xla"},
                 {"n_devices": 2, "ring_extract": True}):
        cfg = _cfg(**opts)
        base = candidate.memory_model(idx, cfg, budget_bytes=1e12)
        more = candidate.memory_model(idx, cfg, budget_bytes=1e12,
                                      heavy_slots=1000)
        assert more["heavy_bytes"] == candidate._HEAVY_SLOT_BYTES * 1000
        assert more["total_bytes"] - base["total_bytes"] == (
            candidate._HEAVY_SLOT_BYTES * 1000)
        assert more["join_temp_bytes"] - base["join_temp_bytes"] == (
            candidate._HEAVY_SLOT_BYTES * 1000)

    seen = []
    monkeypatch.setattr(net_device, "MAX_CANDIDATE_CAP", CAP)
    plan_bbh = candidate.MemoryPlan.bbh
    monkeypatch.setattr(
        candidate.MemoryPlan, "bbh",
        lambda self, pairs, slots, heavy_slots, edge_cap: seen.append(
            heavy_slots) or plan_bbh(self, pairs, slots, heavy_slots,
                                     edge_cap))
    segs = []
    real = net_device._heavy_segment
    monkeypatch.setattr(net_device, "_heavy_segment",
                        lambda *a: segs.append(real(*a)) or segs[-1])
    cap = {}
    net_device.compute_network_device(idx, _cfg(), capture=cap)
    cells = apply_validity(compute_cells_oracle(idx), idx.kseq_lengths,
                           idx.k)
    grow, cand = segs[0][0][:2]
    heavy = grow[grow < idx.n_sequences].numpy()
    assert len(heavy) == HEAVY
    per_row = np.bincount(cells.row, minlength=idx.n_sequences)
    # four chunks of one 16-row block each
    assert tuple(cand.shape) == (4 * 16, per_row[heavy].max())
    assert seen == [cand.numel()]

    # what the flat BBH allocates for the segment, every temporary
    # summed, over the same run's main lists without it
    r = cap["runner"]
    main = r.extract_shards(cap["perm_ext"], cap["starts"], 16, r.w_pad,
                            CAP, do_join=False, from_T=cap["use_T"])[0]
    flat = r.flatten_join(*main, CAP, 1024)
    tail = (torch.zeros(r.G_pad, dtype=torch.int32), r.col_lens,
            torch.zeros(r.G_pad, dtype=torch.int32))
    got = {}
    for extra in ((), (segs[0][0],)):
        with _Allocated() as a:
            r.shards.spmd([net_device._bbh_flat_program(
                *main, *flat, *tail, 6, 1 << 14, extra=extra)])
        got[len(extra)] = a.bytes
    held = sum(t.untyped_storage().nbytes() for t in segs[0][0][1:])
    per_slot = (got[1] - got[0] + held) / cand.numel()
    assert 0.8 * candidate._HEAVY_SLOT_BYTES < per_slot
    assert per_slot <= candidate._HEAVY_SLOT_BYTES
