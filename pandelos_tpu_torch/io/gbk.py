"""GenBank -> .faa conversion (equivalent of ``example/gbk2ig.py``).

The reference uses Biopython ``SeqIO.parse`` and keeps CDS features with a
``translation`` qualifier (gbk2ig.py:29-35), building unique gene ids
``genome:seqid:locus_tag:copy#`` (gbk2ig.py:54-63).  This is a minimal
dependency-free GenBank flat-file parser covering exactly what the
conversion needs: LOCUS/record boundaries, CDS features, and the
``/locus_tag``, ``/protein_id``, ``/product`` and ``/translation``
qualifiers.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Tuple

from pandelos_tpu_torch.io.faa import FaaDataset


def _parse_qualifier_block(lines: List[str]) -> Dict[str, str]:
    quals: Dict[str, str] = {}
    key = None
    buf: List[str] = []
    for line in lines:
        s = line.strip()
        if s.startswith("/"):
            if key is not None:
                quals[key] = " ".join(buf)
            m = re.match(r"/([A-Za-z_0-9]+)=?(.*)", s)
            key = m.group(1)
            buf = [m.group(2).strip('"')] if m.group(2) else []
        elif key is not None:
            buf.append(s.strip('"'))
    if key is not None:
        quals[key] = " ".join(buf)
    return quals


def parse_gbk_cds(path: str) -> Iterable[Tuple[str, Dict[str, str]]]:
    """Yield (record_name, qualifiers) for each CDS feature with a
    translation."""
    record = None
    in_features = False
    feature_lines: List[str] = []
    in_cds = False

    def flush():
        nonlocal feature_lines, in_cds
        if in_cds and feature_lines:
            quals = _parse_qualifier_block(feature_lines)
            if "translation" in quals:
                yield record, quals
        feature_lines = []
        in_cds = False

    with open(path) as fh:
        for line in fh:
            if line.startswith("LOCUS"):
                yield from flush()
                record = line.split()[1] if len(line.split()) > 1 else "unknown"
                in_features = False
            elif line.startswith("VERSION"):
                parts = line.split()
                if len(parts) > 1:
                    record = parts[1]
            elif line.startswith("FEATURES"):
                in_features = True
            elif line.startswith("ORIGIN") or line.startswith("//"):
                yield from flush()
                in_features = False
            elif in_features:
                if len(line) > 5 and line[5] != " " and line[:5].strip() == "":
                    # new feature key at column 5
                    yield from flush()
                    in_cds = line[5:21].strip() == "CDS"
                elif in_cds:
                    feature_lines.append(line)
        yield from flush()


def gbk_dir_to_faa(directory: str, genome_name: str = None) -> FaaDataset:
    """Convert every .gbk/.gb/.gbff file in a directory into one dataset;
    each file is one genome (reference: one download per accession)."""
    sequences, names, descriptions, seq_genome = [], [], [], []
    genome_names: List[str] = []
    files = sorted(
        f
        for f in os.listdir(directory)
        if f.endswith((".gbk", ".gb", ".gbff", ".gbwithparts"))
    )
    for fname in files:
        path = os.path.join(directory, fname)
        gid = len(genome_names)
        base = genome_name or os.path.splitext(fname)[0]
        gname = base if genome_name is None else f"{base}:{gid}"
        genome_names.append(gname)
        copies: Dict[str, int] = {}
        for record, quals in parse_gbk_cds(path):
            tag = quals.get("locus_tag", quals.get("protein_id", "unknown"))
            copies[tag] = copies.get(tag, 0) + 1
            # unique id format suggested by the reference README
            # (genome:record:locus_tag:copy#, gbk2ig.py:54-63)
            gene_id = f"{gname}:{record}:{tag}:{copies[tag]}"
            translation = quals["translation"].replace(" ", "")
            product = quals.get("product", "unknown product")
            sequences.append(translation)
            names.append(gene_id)
            descriptions.append(product)
            seq_genome.append(gid)
    return FaaDataset(sequences, names, descriptions, seq_genome, genome_names)
