"""The one traffic generator: a configuration's dataset in an order drawn
from the run's seed, written as the ``.faa`` that every job of a run
reads.

The generator's spec, seed included, is the configuration file's, so
every run holds the same genes and does the same work; the run's seed
draws the order of the genomes in the ``.faa`` and of the genes within
each genome.  A different dataset for each seed moved the work with the
seed: the peak device memory of mycoplasma64 on one NVIDIA H100 read
9.83, 10.74 and 10.96 GiB on three seeds, and the same on two runs of
one seed.

A traffic file (``benchmark/traffic/<name>.json``) holds data only.  The
one mix so far, ``full``, sets no parameter: every job is the whole
genome set of the configuration.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark import synth

# numpy seeds are non-negative
SEED_MODULUS = 1 << 64


def dataset(config: dict, seed: int) -> synth.Dataset:
    """The configuration's dataset, its genomes and each genome's genes in
    an order drawn from ``seed``."""
    ds = synth.generate(synth.SynthSpec(**config["generator"]))
    rng = np.random.default_rng(int(seed) % SEED_MODULUS)
    genes = [[] for _ in range(ds.n_genomes)]
    for i, g in enumerate(ds.seq_genome):
        genes[g].append(i)
    order, genome, names = [], [], []
    for new, g in enumerate(rng.permutation(ds.n_genomes).tolist()):
        order += [genes[g][j] for j in rng.permutation(len(genes[g]))]
        genome += [new] * len(genes[g])
        names.append(ds.genome_names[g])
    return synth.Dataset(
        [ds.sequences[i] for i in order], [ds.names[i] for i in order],
        [ds.descriptions[i] for i in order], genome, names)


def make_input(config: dict, seed: int, workdir: str) -> str:
    """Write the jobs' input into ``workdir``; its path."""
    path = os.path.join(workdir, "input.faa")
    synth.write_faa(path, dataset(config, seed))
    return path
