"""VCF utilities: contig-ordered sorting and phasing-site selection.

Ports of reference HaplotypeModel/sortvcf.py:8-37 and
scripts/select_high_quality_hetesnps.py:27-56.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

from ..constants import contig_sort_key


def parse_vcf(lines: Iterable[str]) -> Tuple[List[str], Dict[str, Dict[int, str]]]:
    header: List[str] = []
    contig_dict: Dict[str, Dict[int, str]] = defaultdict(dict)
    for row in lines:
        if not row.strip():
            continue
        if row[0] == "#":
            if row not in header:
                header.append(row)
            continue
        cols = row.strip().split(maxsplit=3)
        contig_dict[cols[0]][int(cols[1])] = row
    return header, contig_dict


def sort_vcf_lines(lines: Iterable[str]) -> List[str]:
    header, contig_dict = parse_vcf(lines)
    out = list(header)
    for contig in sorted(contig_dict, key=contig_sort_key):
        for pos in sorted(contig_dict[contig]):
            out.append(contig_dict[contig][pos])
    return out


def select_phasing_hetesnps(
    vcf_lines: Iterable[str],
    support_quality: float = 16.0,
) -> Tuple[List[str], Dict[str, List[str]]]:
    """Keep heterozygous calls with QUAL >= support_quality, grouped per
    contig (whatshap phasing input). Returns (header, {contig: rows})."""
    header: List[str] = []
    per_contig: Dict[str, List[str]] = {}
    for row in vcf_lines:
        if not row.strip():
            continue
        if row[0] == "#":
            if row not in header:
                header.append(row)
            continue
        cols = row.strip().split()
        genotype = cols[9].split(":")[0].replace("|", "/")
        if genotype in ("0/0", "1/1"):
            continue
        if float(cols[5]) >= support_quality:
            per_contig.setdefault(cols[0], []).append(row)
    return header, per_contig
