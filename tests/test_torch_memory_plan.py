"""The device engine's stage-wise memory plan on the CPU
(``ops/candidate.py::MemoryPlan``).  A card's memory is stood in for by
monkeypatching ``candidate.card_memory``, the function that reads it
(None on the CPU: nothing binds there).  The index is built once a test
and handed to every run of it, as an earlier run leaves it: its runner,
signatures and join table already built, so that the candidate work, and
not those stages, is what a small budget binds.

Each gate raises ``MemoryError`` naming the stage that cannot fit; where
every stage fits, the ``.net`` and ``.clus`` are the port's
transcription twin's (``reference.py``, backend ``"reference"``) and the
JAX package's."""

import filecmp
import os

import pytest
import torch

from pandelos_tpu.config import PipelineConfig as JaxConfig
from pandelos_tpu.pipeline import run_pipeline as jax_run_pipeline
from pandelos_tpu_torch import pipeline
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.ops import candidate, net_device
from pandelos_tpu_torch.pipeline import run_pipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SMALL = os.path.join(GOLDEN, "synth_small.faa")
# before the plan: the stages every run takes; after: the candidate work
GATE1 = ("signatures", "bound bits", "extract", "join table")


def _cfg(**kw):
    return PipelineConfig(**{"device": "cpu", "row_block": 16,
                             "col_block": 128, "candidate_cap": 64, **kw})


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """synth_small's .net and .clus bytes: the JAX package's and the
    transcription twin's."""
    d = tmp_path_factory.mktemp("memory_plan")
    jax_run_pipeline(SMALL, str(d / "jax"), JaxConfig(
        row_block=16, col_block=128, candidate_cap=64))
    run_pipeline(SMALL, str(d / "twin"), PipelineConfig(backend="reference"))
    return {"jax": str(d / "jax"), "twin": str(d / "twin")}


@pytest.fixture
def runs(monkeypatch, tmp_path):
    """run(name, config, budget): one job on one index built once, its
    output prefix, spans by name and memory plan."""
    held, plans = {}, []
    build = pipeline.build_index
    monkeypatch.setattr(pipeline, "build_index", lambda ds, **kw: held.get(
        "index") or held.setdefault("index", build(ds, **kw)))
    init = candidate.MemoryPlan.__init__

    def recorded(self, *a, **kw):
        init(self, *a, **kw)
        plans.append(self)

    monkeypatch.setattr(candidate.MemoryPlan, "__init__", recorded)

    def run(name, config, budget=None):
        monkeypatch.setattr(candidate, "card_memory", lambda device: budget)
        prefix = str(tmp_path / name)
        res = run_pipeline(SMALL, prefix, config)
        return prefix, {s["name"]: s for s in res.spans}, plans[-1], res

    run(".warm", _cfg())  # the runner, signatures and table, built once
    run.index = lambda: held["index"]
    return run


def _same(a, b):
    return all(filecmp.cmp(a + s, b + s, shallow=False)
               for s in (".net", ".clus"))


def test_the_budget_is_what_the_card_can_still_give(monkeypatch):
    """On a card: CUDA's free bytes and the allocator's reserved
    ones, less 5 % of the card; none on the CPU or under the override."""
    gib = 2**30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (30 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device: 6 * gib)
    assert candidate.card_memory("cuda:0") == 32 * gib
    assert candidate.card_memory("cpu") is None
    monkeypatch.setenv("PANDELOS_IGNORE_HBM_MODEL", "1")
    assert candidate.card_memory("cuda:0") is None


def test_a_budget_under_the_fixed_part_raises_naming_the_stage(
        monkeypatch):
    monkeypatch.setattr(candidate, "card_memory", lambda device: 10**6)
    with pytest.raises(MemoryError, match="the engine's signatures stage "
                                          "needs .* on a card with "
                                          "0.00GB to give"):
        run_pipeline(SMALL, None, _cfg())


def test_a_heavy_chunk_past_the_budget_raises_naming_the_stage(
        runs, monkeypatch):
    """Rows past the largest cap: gate 2 plans each heavy-row chunk
    before it runs, and raises where one cannot fit beside what the card
    holds, though every stage before it fits."""
    monkeypatch.setattr(net_device, "MAX_CANDIDATE_CAP", 16)
    cfg = _cfg(row_block=4, candidate_cap=16)
    _, by, plan, _ = runs("whole", cfg)
    assert by["plan"]["counters"]["heavy_chunks"] == plan.heavy_chunks == (
        by["extract.heavy"]["counters"]["chunks"]) > 0
    budget = max(v for k, v in plan.stages.items()
                 if k not in ("heavy", "bbh")) + 1
    assert plan.stages["heavy"] > budget
    with pytest.raises(MemoryError, match="the engine's heavy stage"):
        runs("cut", cfg, budget)


def test_a_flat_pass_past_the_budget_raises_naming_the_stage(runs):
    """Gate 2 plans the main rows' flat pass and the BBH from the pairs
    the extraction found, and raises where they cannot fit though every
    stage the shapes decide does."""
    _, _, plan, _ = runs("whole", _cfg())
    budget = max(v for k, v in plan.stages.items() if k in GATE1) + 1
    assert plan.stages["bbh"] > budget
    with pytest.raises(MemoryError, match="the engine's bbh stage"):
        runs("cut", _cfg(), budget)


def test_plan_counters_and_outputs(runs, outputs):
    """The plan span's counters and the .stats.json network stats it
    feeds; at a budget every stage fits, the outputs are the twin's and
    the JAX package's."""
    budget = 10**9
    prefix, by, plan, res = runs("job", _cfg(), budget)
    net = res.stats["network"]
    counters = by["plan"]["counters"]
    assert counters["budget_bytes"] == net["budget_bytes"] == budget
    assert counters["planned_peak_bytes"] == net["planned_peak_bytes"] == (
        plan.planned_peak) <= budget
    assert counters["fixed_bytes"] == plan.fixed > 0
    assert counters["heavy_chunks"] == 0
    # the warm runner holds the signatures and the join table already
    assert set(plan.stages) == {"bound bits", "extract", "bbh"}
    assert by["plan"]["parent"] == by["score"]["id"]
    assert list(net["phase_s"]).index("plan") == list(
        net["phase_s"]).index("flatten_join") - 1
    for other in (outputs["twin"], outputs["jax"]):
        assert _same(prefix, other), other
    # off a card no budget binds, and the plan still counts
    _, by, plan, res = runs("cpu", _cfg())
    assert by["plan"]["counters"]["budget_bytes"] == 0
    assert res.stats["network"]["budget_bytes"] is None
    assert by["plan"]["counters"]["planned_peak_bytes"] == plan.planned_peak


def test_past_the_bound_bit_cap_equals_bound_bits(runs, monkeypatch):
    """Past the bound-bit matrix's byte cap the extraction takes the
    two-matmul bound: the plan has no bound-bit stage, and the outputs
    are the bound-bit run's."""
    bits, by, plan, res = runs("bits", _cfg())
    assert res.stats["network"]["bound_bits_mode"]
    assert "bound bits" in plan.stages
    monkeypatch.setattr(candidate, "_T_BYTES_CAP", 1)
    two, by, plan, res = runs("two", _cfg())
    assert not res.stats["network"]["bound_bits_mode"]
    assert "bound bits" not in plan.stages
    assert _same(bits, two)


def test_the_cells_paths_gate_points_to_the_device_bbh(runs, monkeypatch):
    """Where ``memory_model``'s worst-case sum refuses the cells path
    (``device_bbh=False``), its message names the device BBH, whose plan
    counts the candidate work the extraction finds."""
    index = runs.index()
    cfg = _cfg(device_bbh=False)
    monkeypatch.setattr(
        candidate, "hbm_model",
        lambda index, config, device, ring=None, n_devices=None: (
            candidate.memory_model(index, config, budget_bytes=10**6,
                                   ring=ring, n_devices=n_devices)))
    with pytest.raises(MemoryError, match="the replicated engine needs .*"
                                          "take the device BBH"):
        candidate.check_hbm_fit(index, cfg, "cpu", ring=False)
