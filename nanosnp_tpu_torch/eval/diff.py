"""Differential VCF comparison — the primary parity oracle surface
(SURVEY.md §4): site-level equality between two pipelines' outputs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple


@dataclass
class VcfDiff:
    only_a: List[str] = field(default_factory=list)
    only_b: List[str] = field(default_factory=list)
    field_diffs: List[Tuple[str, str, str]] = field(default_factory=list)
    n_common: int = 0

    @property
    def identical(self) -> bool:
        return not self.only_a and not self.only_b and not self.field_diffs

    def summary(self) -> Dict:
        return {
            "common": self.n_common,
            "only_a": len(self.only_a),
            "only_b": len(self.only_b),
            "field_diffs": len(self.field_diffs),
            "identical": self.identical,
        }


def _rows(lines: Iterable[str]) -> Dict[Tuple[str, int], str]:
    out = {}
    for line in lines:
        if not line.strip() or line[0] == "#":
            continue
        f = line.strip().split("\t")
        out[(f[0], int(f[1]))] = line.strip()
    return out


def diff_haplotype_csvs(a_lines: Iterable[str], b_lines: Iterable[str],
                        max_report: int = 50) -> "VcfDiff":
    """Site-level diff of haplotype CSVs (`ctg\\tpos\\tGT\\tqual` rows,
    reference predict_dev.py:43-47): GT must match at common sites."""
    return diff_vcfs(a_lines, b_lines, compare_fields=(2,),
                     max_report=max_report)


def diff_vcfs(a_lines: Iterable[str], b_lines: Iterable[str],
              compare_fields: Tuple[int, ...] = (3, 4, 6, 9),
              max_report: int = 50) -> VcfDiff:
    """Site-level diff; compare_fields picks the VCF columns that must match
    at common sites (default REF/ALT/FILTER/SAMPLE)."""
    a = _rows(a_lines)
    b = _rows(b_lines)
    d = VcfDiff()
    for k in sorted(set(a) - set(b)):
        if len(d.only_a) < max_report:
            d.only_a.append(a[k])
    for k in sorted(set(b) - set(a)):
        if len(d.only_b) < max_report:
            d.only_b.append(b[k])
    for k in sorted(set(a) & set(b)):
        d.n_common += 1
        fa = a[k].split("\t")
        fb = b[k].split("\t")
        for i in compare_fields:
            va = fa[i] if i < len(fa) else ""
            vb = fb[i] if i < len(fb) else ""
            if va != vb and len(d.field_diffs) < max_report:
                d.field_diffs.append((f"{k[0]}:{k[1]} col{i}", va, vb))
    return d
