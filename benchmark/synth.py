"""Deterministic synthetic pan-genome datasets: the benchmark's frozen
copy of ``pandelos_tpu_torch/bench/synth.py``.

It draws from the random generator in exactly the original's order, so a
spec gives the same dataset, but builds each protein string in one table
lookup instead of a per-residue join and draws residues as numpy's
``Generator.choice`` does without its per-call checks of ``p``: the
original takes 8.2 s for mycoplasma64 on one CPU core, this copy 1.3 s.
Later changes to the program's generator do not move the benchmark's
data.

The upstream benchmark datasets (NCBI genomes listed in
``example/*.list.txt`` of Guilucand/PanDelos) are not in the repository,
so these scale-matched stand-ins take their place: empirical residue
compositions, per-family lognormal divergence, indels, Zipf-like paralog
tails and lognormal gene lengths.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"
_AA_BYTES = np.frombuffer(AMINO_ACIDS.encode("ascii"), dtype=np.uint8)

# Swiss-Prot average amino-acid composition (%, order = AMINO_ACIDS).
_FREQ_SWISSPROT = np.array(
    [8.25, 1.38, 5.45, 6.75, 3.86, 7.07, 2.27, 5.96, 5.84, 9.66,
     2.42, 4.06, 4.70, 3.93, 5.53, 6.56, 5.34, 6.87, 1.08, 2.92]
)

# Enterobacteria-like composition: the Swiss-Prot average sharpened to
# base-20 entropy 0.905, so the 10+-genome presets land at k=6.
_FREQ_ENTERO = np.array(
    [11.16, 0.36, 5.03, 7.59, 2.59, 8.30, 0.93, 5.98, 5.75, 15.12,
     1.06, 2.86, 3.79, 2.68, 5.18, 7.19, 4.84, 7.85, 0.22, 1.52]
)

# AT-rich mycoplasma-like composition (base-20 entropy 0.900 -> k=6 at
# the mycoplasma64 scale).
_FREQ_MYCOPLASMA = np.array(
    [3.93, 0.08, 4.19, 5.72, 6.01, 3.68, 0.80, 9.56, 12.47, 13.43,
     1.04, 8.37, 1.96, 3.07, 1.76, 8.54, 5.57, 6.16, 0.28, 3.37]
)

_FREQ_TABLES = {
    "uniform": np.ones(20),
    "swissprot": _FREQ_SWISSPROT,
    "entero": _FREQ_ENTERO,
    "mycoplasma": _FREQ_MYCOPLASMA,
}


@dataclasses.dataclass
class SynthSpec:
    n_genomes: int = 7
    n_families: int = 800
    core_fraction: float = 0.5
    min_len: int = 120
    max_len: int = 900
    substitution_rate: float = 0.05
    paralog_rate: float = 0.02
    singleton_per_genome: int = 20
    seed: int = 1234
    aa_freq: str = "uniform"
    divergence_sigma: float = 0.0
    indel_rate: float = 0.0
    max_paralogs: int = 2
    length_lognorm: bool = False


@dataclasses.dataclass
class Dataset:
    """One ``.faa``'s records, in file order."""

    sequences: List[str]
    names: List[str]
    descriptions: List[str]
    seq_genome: List[int]
    genome_names: List[str]

    @property
    def n_sequences(self) -> int:
        return len(self.sequences)

    @property
    def n_genomes(self) -> int:
        return len(self.genome_names)


def _freqs(spec: SynthSpec) -> np.ndarray:
    f = _FREQ_TABLES[spec.aa_freq].astype(np.float64)
    return f / f.sum()


def _cdf(p: np.ndarray) -> np.ndarray:
    cdf = p.cumsum()
    cdf /= cdf[-1]
    return cdf


def _choice(rng, size: int, cdf: np.ndarray) -> np.ndarray:
    """``rng.choice(20, size=size, p=p)`` as numpy's ``Generator`` computes
    it (one ``random`` draw a residue, searched in the normalised
    cumulative table), without its per-call checks of ``p``."""
    return cdf.searchsorted(rng.random(size), side="right").astype(np.int64)


def _random_protein(rng, length: int, cdf: np.ndarray) -> np.ndarray:
    return _choice(rng, length, cdf)


def _gene_length(rng, spec: SynthSpec) -> int:
    if not spec.length_lognorm:
        return int(rng.integers(spec.min_len, spec.max_len + 1))
    med = np.sqrt(spec.min_len * spec.max_len)
    length = int(np.exp(rng.normal(np.log(med), 0.55)))
    return int(np.clip(length, spec.min_len, spec.max_len))


def _mutate(rng, seq: np.ndarray, rate: float, cdf: np.ndarray,
            indel_rate: float) -> np.ndarray:
    out = seq.copy()
    mask = rng.random(seq.shape[0]) < rate
    n = int(mask.sum())
    if n:
        out[mask] = _choice(rng, n, cdf)
    if indel_rate > 0.0:
        n_events = rng.poisson(indel_rate * len(out) / 100.0)
        for _ in range(int(n_events)):
            if len(out) < 30:
                break
            pos = int(rng.integers(0, len(out)))
            size = 1 + int(rng.geometric(0.35))
            if rng.random() < 0.5:  # deletion
                out = np.concatenate([out[:pos], out[pos + size:]])
            else:  # insertion
                ins = _choice(rng, size, cdf)
                out = np.concatenate([out[:pos], ins, out[pos:]])
    return out


def _n_copies(rng, spec: SynthSpec) -> int:
    if rng.random() >= spec.paralog_rate:
        return 1
    if spec.max_paralogs <= 2:
        return 2
    z = int(rng.zipf(2.2))
    return 1 + min(z, spec.max_paralogs - 1)


def _to_str(codes: np.ndarray) -> str:
    return _AA_BYTES[codes].tobytes().decode("ascii")


def generate(spec: SynthSpec) -> Dataset:
    rng = np.random.default_rng(spec.seed)
    cdf = _cdf(_freqs(spec))
    sequences, names, descriptions, seq_genome = [], [], [], []
    genome_names = [f"G{g:03d}" for g in range(spec.n_genomes)]

    ancestors = []
    presence = []
    fam_rate = []
    for f in range(spec.n_families):
        ancestors.append(_random_protein(rng, _gene_length(rng, spec), cdf))
        if rng.random() < spec.core_fraction:
            present = np.ones(spec.n_genomes, dtype=bool)
        else:
            prob = rng.uniform(0.2, 0.9)
            present = rng.random(spec.n_genomes) < prob
            if not present.any():
                present[rng.integers(0, spec.n_genomes)] = True
        presence.append(present)
        if spec.divergence_sigma > 0.0:
            fam_rate.append(float(np.exp(rng.normal(
                np.log(spec.substitution_rate), spec.divergence_sigma))))
        else:
            fam_rate.append(spec.substitution_rate)

    # genome-major, like a concatenated multi-genome .faa
    for g in range(spec.n_genomes):
        gname = genome_names[g]
        for f in range(spec.n_families):
            if not presence[f][g]:
                continue
            copies = _n_copies(rng, spec)
            rate = min(fam_rate[f], 0.45)
            for c in range(copies):
                seq = _mutate(rng, ancestors[f], rate, cdf, spec.indel_rate)
                sequences.append(_to_str(seq))
                names.append(f"fam{f:05d}_c{c}@{gname}")
                descriptions.append(f"synthetic family {f} copy {c}")
                seq_genome.append(g)
        for s in range(spec.singleton_per_genome):
            seq = _random_protein(rng, _gene_length(rng, spec), cdf)
            sequences.append(_to_str(seq))
            names.append(f"uniq{s:04d}@{gname}")
            descriptions.append("synthetic singleton")
            seq_genome.append(g)

    return Dataset(sequences, names, descriptions, seq_genome, genome_names)


def write_faa(path: str, ds: Dataset) -> None:
    """The ``.faa`` layout: a ``genome<TAB>gene<TAB>product`` header line,
    then the sequence on one line."""
    lines = []
    for i, seq in enumerate(ds.sequences):
        lines.append(f"{ds.genome_names[ds.seq_genome[i]]}\t{ds.names[i]}"
                     f"\t{ds.descriptions[i]}\n{seq}\n")
    with open(path, "w") as fh:
        fh.write("".join(lines))
