"""The benchmark's frozen generator against the program's: the same
bytes for the committed datasets and the same datasets under other
seeds."""

import dataclasses
import filecmp
import os

import pytest

from benchmark import synth
from pandelos_tpu_torch.bench import synth as original

from conftest import ROOT

CACHE = os.path.join(ROOT, "bench_cache")


def _spec(preset, **kw):
    return synth.SynthSpec(**dict(dataclasses.asdict(
        original.PRESETS[preset]), **kw))


@pytest.mark.parametrize("preset", ["mycoplasma16", "toy"])
def test_writes_the_committed_faa(preset, tmp_path):
    path = tmp_path / f"{preset}.faa"
    synth.write_faa(str(path), synth.generate(_spec(preset)))
    assert filecmp.cmp(path, os.path.join(CACHE, f"{preset}.faa"),
                       shallow=False)


@pytest.mark.parametrize("seed", [2**33 + 17, 4242])
@pytest.mark.parametrize("preset,cut", [
    ("mycoplasma64", dict(n_genomes=6, n_families=60)),
    ("xanthomonas14", dict(n_genomes=4, n_families=90)),
])
def test_same_dataset_as_the_original(preset, cut, seed):
    spec = dataclasses.asdict(original.PRESETS[preset])
    spec.update(cut, seed=seed)
    mine = synth.generate(synth.SynthSpec(**spec))
    theirs = original.generate(original.SynthSpec(**spec))
    assert mine.sequences == theirs.sequences
    assert mine.names == theirs.names
    assert mine.descriptions == theirs.descriptions
    assert list(mine.seq_genome) == list(theirs.seq_genome)
    assert mine.genome_names == theirs.genome_names
