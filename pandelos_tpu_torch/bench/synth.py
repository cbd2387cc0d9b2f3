"""Deterministic synthetic pan-genome datasets.

The reference benchmarks on four NCBI datasets downloaded with efetch
(``example/download.sh``, ``example/*.list.txt``: salmonella 7 genomes,
escherichia 10, xanthomonas 14, mycoplasma 64).  This environment has no
network access, so scale-matched synthetic datasets stand in.

v2 realism (round-3): uniform-random residues give base-20 entropy ~1.0 and
k=5 on every large preset, while the real datasets' skewed residue
distributions land at k=6 (``calculate_k.py:23-30``) and produce far
messier posting-list shapes.  The generator now models:

- **empirical residue frequencies** — a mycoplasma-like AT-rich proteome
  composition (high K/I/N/L/F, trace C/W) with base-20 entropy ~0.90, and a
  Swiss-Prot-average composition for the enterobacteria presets;
- **per-family divergence spread** — each family draws its own substitution
  rate from a lognormal, so some families are near-identical across genomes
  and some are heavily diverged (ragged score distributions);
- **indels** — per-copy short insertions/deletions with geometric lengths,
  shifting k-mer frames the way real alignments do;
- **power-law family sizes** — per-genome paralog copy counts with a
  Zipf-like tail instead of a fixed 2-copy coin flip;
- **lognormal gene lengths** — median ~300 aa with a long tail, clipped to
  [min_len, max_len], instead of uniform lengths.

Generation is fully deterministic given the seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pandelos_tpu_torch.io.faa import FaaDataset

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"

# Swiss-Prot average amino-acid composition (%, order = AMINO_ACIDS).
_FREQ_SWISSPROT = np.array(
    [8.25, 1.38, 5.45, 6.75, 3.86, 7.07, 2.27, 5.96, 5.84, 9.66,
     2.42, 4.06, 4.70, 3.93, 5.53, 6.56, 5.34, 6.87, 1.08, 2.92]
)

# Strongly codon-biased enterobacteria-like composition (the Swiss-Prot
# average sharpened to base-20 entropy 0.905, so the 10+-genome presets
# land at k=6 like the reference's real datasets do).
_FREQ_ENTERO = np.array(
    [11.16, 0.36, 5.03, 7.59, 2.59, 8.30, 0.93, 5.98, 5.75, 15.12,
     1.06, 2.86, 3.79, 2.68, 5.18, 7.19, 4.84, 7.85, 0.22, 1.52]
)

# AT-rich mycoplasma-like proteome composition: codon bias inflates
# K/I/N/F/L and starves C/W/G/H/M (base-20 entropy 0.900 -> k=6 at the
# mycoplasma64 preset's scale, matching the real datasets' k).
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
    n_families: int = 800  # ancestor gene families
    core_fraction: float = 0.5  # families present in every genome
    min_len: int = 120
    max_len: int = 900
    substitution_rate: float = 0.05  # median per-residue rate (see sigma)
    paralog_rate: float = 0.02  # chance a genome carries extra copies
    singleton_per_genome: int = 20  # unique genes per genome
    seed: int = 1234
    # v2 realism knobs (defaults preserve v1 behaviour for toy-scale specs)
    aa_freq: str = "uniform"  # residue distribution table
    divergence_sigma: float = 0.0  # lognormal sigma of per-family sub rate
    indel_rate: float = 0.0  # per-copy expected indel events per 100 aa
    max_paralogs: int = 2  # cap on per-genome copies (Zipf tail)
    length_lognorm: bool = False  # lognormal lengths instead of uniform


# Scale-matched stand-ins for the reference's benchmark datasets
# (genome counts from example/*.list.txt; gene counts per genome are
# order-of-magnitude for the organisms).
PRESETS = {
    "toy": SynthSpec(n_genomes=2, n_families=4, core_fraction=1.0,
                     min_len=40, max_len=120, singleton_per_genome=0, seed=7),
    "salmonella7": SynthSpec(
        n_genomes=7, n_families=4200, seed=11, aa_freq="entero",
        divergence_sigma=0.8, indel_rate=0.6, max_paralogs=4,
        length_lognorm=True),
    "escherichia10": SynthSpec(
        n_genomes=10, n_families=4300, seed=12, aa_freq="entero",
        divergence_sigma=0.8, indel_rate=0.6, max_paralogs=4,
        length_lognorm=True),
    "xanthomonas14": SynthSpec(
        n_genomes=14, n_families=4100, seed=13, aa_freq="entero",
        divergence_sigma=0.8, indel_rate=0.6, max_paralogs=4,
        length_lognorm=True),
    "mycoplasma64": SynthSpec(
        n_genomes=64, n_families=750, min_len=100, max_len=700, seed=14,
        aa_freq="mycoplasma", divergence_sigma=0.9, indel_rate=0.8,
        max_paralogs=5, length_lognorm=True),
    # 16-genome subset scale for the bench's CPU fallback (same family
    # structure / residue distribution as mycoplasma64)
    "mycoplasma16": SynthSpec(
        n_genomes=16, n_families=750, min_len=100, max_len=700, seed=14,
        aa_freq="mycoplasma", divergence_sigma=0.9, indel_rate=0.8,
        max_paralogs=5, length_lognorm=True),
}


def _freqs(spec: SynthSpec) -> np.ndarray:
    f = _FREQ_TABLES[spec.aa_freq].astype(np.float64)
    return f / f.sum()


def _random_protein(
    rng: np.random.Generator, length: int, p: np.ndarray
) -> np.ndarray:
    return rng.choice(20, size=length, p=p).astype(np.int64)


def _gene_length(rng: np.random.Generator, spec: SynthSpec) -> int:
    if not spec.length_lognorm:
        return int(rng.integers(spec.min_len, spec.max_len + 1))
    # median ~ geometric centre of the range, long right tail
    med = np.sqrt(spec.min_len * spec.max_len)
    length = int(np.exp(rng.normal(np.log(med), 0.55)))
    return int(np.clip(length, spec.min_len, spec.max_len))


def _mutate(
    rng: np.random.Generator,
    seq: np.ndarray,
    rate: float,
    p: np.ndarray,
    indel_rate: float,
) -> np.ndarray:
    out = seq.copy()
    mask = rng.random(seq.shape[0]) < rate
    n = int(mask.sum())
    if n:
        out[mask] = rng.choice(20, size=n, p=p).astype(np.int64)
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
                ins = rng.choice(20, size=size, p=p).astype(np.int64)
                out = np.concatenate([out[:pos], ins, out[pos:]])
    return out


def _n_copies(rng: np.random.Generator, spec: SynthSpec) -> int:
    """Per-genome copy count: 1, with a Zipf-like paralog tail."""
    if rng.random() >= spec.paralog_rate:
        return 1
    if spec.max_paralogs <= 2:
        return 2
    z = int(rng.zipf(2.2))
    return 1 + min(z, spec.max_paralogs - 1)


def _to_str(codes: np.ndarray) -> str:
    return "".join(AMINO_ACIDS[c] for c in codes)


def generate(spec: SynthSpec) -> FaaDataset:
    rng = np.random.default_rng(spec.seed)
    p = _freqs(spec)
    sequences, names, descriptions, seq_genome = [], [], [], []
    genome_names = [f"G{g:03d}" for g in range(spec.n_genomes)]

    ancestors = []
    presence = []
    fam_rate = []
    for f in range(spec.n_families):
        ancestors.append(_random_protein(rng, _gene_length(rng, spec), p))
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

    # Emit genome-major (like a concatenated multi-genome .faa).
    for g in range(spec.n_genomes):
        gname = genome_names[g]
        for f in range(spec.n_families):
            if not presence[f][g]:
                continue
            copies = _n_copies(rng, spec)
            rate = min(fam_rate[f], 0.45)
            for c in range(copies):
                seq = _mutate(rng, ancestors[f], rate, p, spec.indel_rate)
                sequences.append(_to_str(seq))
                names.append(f"fam{f:05d}_c{c}@{gname}")
                descriptions.append(f"synthetic family {f} copy {c}")
                seq_genome.append(g)
        for s in range(spec.singleton_per_genome):
            seq = _random_protein(rng, _gene_length(rng, spec), p)
            sequences.append(_to_str(seq))
            names.append(f"uniq{s:04d}@{gname}")
            descriptions.append("synthetic singleton")
            seq_genome.append(g)

    return FaaDataset(sequences, names, descriptions, seq_genome, genome_names)


def generate_preset(name: str) -> FaaDataset:
    if name not in PRESETS:
        raise ValueError(
            f"unknown preset {name!r}; available: {', '.join(PRESETS)}"
        )
    return generate(PRESETS[name])
