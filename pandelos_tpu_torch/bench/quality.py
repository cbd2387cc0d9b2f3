"""Family quality statistics: structured equivalent of ``example/quality.py``
(family-size distribution, genome-spread distribution, per-genome spread
matrix, ``quality.py:60-121``)."""

from __future__ import annotations

from pandelos_tpu_torch.io.clus import read_clus
from pandelos_tpu_torch.io.faa import read_faa


def quality_report(faa_path: str, clus_path: str) -> dict:
    ds = read_faa(faa_path)
    genome_of = {
        name: ds.genome_names[ds.seq_genome[i]] for i, name in enumerate(ds.names)
    }
    families = read_clus(clus_path)

    size_distr: dict = {}
    spread_distr: dict = {}  # number of distinct genomes per family
    per_genome_spread: dict = {}  # genome -> {spread: count}
    missing = 0

    for fam in families:
        size_distr[len(fam)] = size_distr.get(len(fam), 0) + 1
        genomes = set()
        for name in fam:
            g = genome_of.get(name)
            if g is None:
                missing += 1
            else:
                genomes.add(g)
        spread = len(genomes)
        spread_distr[spread] = spread_distr.get(spread, 0) + 1
        for g in genomes:
            per_genome_spread.setdefault(g, {})
            per_genome_spread[g][spread] = per_genome_spread[g].get(spread, 0) + 1

    core = spread_distr.get(ds.n_genomes, 0)
    singleton_families = size_distr.get(1, 0)
    return {
        "n_families": len(families),
        "n_genomes": ds.n_genomes,
        "n_sequences": ds.n_sequences,
        "family_size_distr": {str(k): v for k, v in sorted(size_distr.items())},
        "genome_spread_distr": {str(k): v for k, v in sorted(spread_distr.items())},
        "per_genome_spread": {
            g: {str(k): v for k, v in sorted(d.items())}
            for g, d in sorted(per_genome_spread.items())
        },
        "core_families": core,
        "singleton_families": singleton_families,
        "unknown_gene_names": missing,
    }
