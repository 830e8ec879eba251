"""SNP-calling accuracy vs a truth set.

The reference has no scorer of its own (evaluation used external hap.py /
manual scripts — SURVEY.md §4); this implements the standard site-level
SNV metric: within the confident regions, TP = called site matching a truth
site's alt set (optionally genotype too), FP = called variant with no truth,
FN = truth site not called.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple


@dataclass
class F1Result:
    tp: int = 0
    fp: int = 0
    fn: int = 0
    gt_mismatch: int = 0
    per_contig: Dict[str, Tuple[int, int, int]] = field(default_factory=dict)

    @property
    def precision(self) -> float:
        return self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    @property
    def recall(self) -> float:
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    def summary(self) -> Dict:
        return {
            "tp": self.tp, "fp": self.fp, "fn": self.fn,
            "gt_mismatch": self.gt_mismatch,
            "precision": round(self.precision, 6),
            "recall": round(self.recall, 6),
            "f1": round(self.f1, 6),
        }


def _parse_calls(lines: Iterable[str], snv_only: bool = True):
    calls = {}
    for line in lines:
        if not line.strip() or line[0] == "#":
            continue
        f = line.strip().split("\t")
        ctg, pos, ref, alt = f[0], int(f[1]), f[3], f[4]
        filt = f[6] if len(f) > 6 else "PASS"
        if filt == "RefCall":
            continue
        gt = f[9].split(":")[0].replace("|", "/") if len(f) > 9 else "./."
        if snv_only and (len(ref) != 1
                         or any(len(a) != 1 for a in alt.split(","))):
            continue
        calls[(ctg, pos)] = (ref, frozenset(alt.split(",")), gt)
    return calls


def evaluate_calls(
    called_vcf_lines: Iterable[str],
    truth_vcf_lines: Iterable[str],
    confident_bed: Optional[Iterable[Tuple[str, int, int]]] = None,
    genotype_aware: bool = True,
    snv_only: bool = True,
) -> F1Result:
    called = _parse_calls(called_vcf_lines, snv_only)
    truth = _parse_calls(truth_vcf_lines, snv_only)

    bed: Optional[Dict[str, List[Tuple[int, int]]]] = None
    if confident_bed is not None:
        bed = {}
        for ctg, s, e in confident_bed:
            bed.setdefault(ctg, []).append((s, e))
        for iv in bed.values():
            iv.sort()

    def in_bed(ctg: str, pos: int) -> bool:
        if bed is None:
            return True
        import bisect

        ivs = bed.get(ctg, [])
        i = bisect.bisect_right(ivs, (pos, 1 << 62)) - 1
        return i >= 0 and ivs[i][0] < pos <= ivs[i][1]

    res = F1Result()

    def bump(ctg, which):
        t = list(res.per_contig.get(ctg, (0, 0, 0)))
        t[which] += 1
        res.per_contig[ctg] = tuple(t)

    for key, (ref, alts, gt) in called.items():
        if not in_bed(*key):
            continue
        t = truth.get(key)
        if t is None:
            res.fp += 1
            bump(key[0], 1)
            continue
        t_ref, t_alts, t_gt = t
        if ref == t_ref and alts == t_alts and (
                not genotype_aware or _gt_equiv(gt, t_gt)):
            res.tp += 1
            bump(key[0], 0)
        else:
            res.fp += 1
            res.gt_mismatch += 1
            bump(key[0], 1)
    for key in truth:
        if not in_bed(*key):
            continue
        if key not in called:
            res.fn += 1
            bump(key[0], 2)
        else:
            c = called[key]
            t = truth[key]
            if not (c[0] == t[0] and c[1] == t[1]
                    and (not genotype_aware or _gt_equiv(c[2], t[2]))):
                res.fn += 1
                bump(key[0], 2)
    return res


def _gt_equiv(a: str, b: str) -> bool:
    return sorted(a.split("/")) == sorted(b.split("/"))


def classify_failed_sites(
    failed_lines: Iterable[str],
    truth: Dict[str, "np.ndarray"],
) -> list:
    """Reference compare.py:20-27: from a failed-site list (TSV rows
    starting `ctg\\tpos`), keep rows whose position lies in the confident
    BED and whose truth zygosity is heterozygous (zy==2) — i.e. classify
    candidate failures as genuine het false negatives. `truth` is the
    {contig: [L, 3]} array of (confident, gt21, zygosity) from
    train.labels.truth_arrays (get_truth.py layout)."""
    kept = []
    for line in failed_lines:
        fields = line.strip().split("\t")
        if len(fields) < 2:
            continue
        ctg, pos = fields[0], fields[1]
        try:
            pos = int(pos)
        except ValueError:
            continue
        arr = truth.get(ctg)
        if arr is None or not (1 <= pos <= len(arr)):
            continue
        if arr[pos - 1][0] > 0 and arr[pos - 1][2] == 2:
            kept.append(line if line.endswith("\n") else line + "\n")
    return kept


def genotype_confusion(
    called_vcf_lines: Iterable[str],
    truth_vcf_lines: Iterable[str],
    snv_only: bool = True,
) -> Dict[str, Dict[str, int]]:
    """Genotype-level confusion over common sites (the reference's
    ConfusionMeter analog, train_dev.py:87,269-270): truth GT -> called GT
    counts, with 'missed'/'spurious' rows for FN/FP sites."""
    called = _parse_calls(called_vcf_lines, snv_only)
    truth = _parse_calls(truth_vcf_lines, snv_only)
    conf: Dict[str, Dict[str, int]] = {}

    def bump(a, b):
        conf.setdefault(a, {})
        conf[a][b] = conf[a].get(b, 0) + 1

    for key, t in truth.items():
        c = called.get(key)
        t_gt = "/".join(sorted(t[2].split("/")))
        if c is None:
            bump(t_gt, "missed")
        else:
            bump(t_gt, "/".join(sorted(c[2].split("/"))))
    for key, c in called.items():
        if key not in truth:
            bump("spurious", "/".join(sorted(c[2].split("/"))))
    return conf
