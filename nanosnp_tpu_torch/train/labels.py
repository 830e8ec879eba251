"""Truth labeling: GT21/zygosity/variant-length label construction.

A copy of nanosnp_tpu/train/labels.py (numpy only), so that the port
imports nothing of the JAX package.

Ports of the reference's two equivalent implementations
(dna_sv_tensor/src/common/genotype.cpp:12-394 and
HaplotypeModel/get_truth.py:25-279):

  - partial labels: per-allele 'A'/'C'/'G'/'T'/'Ins'/'Del' vs the reference
    allele; two partials mix into one of the 21 GT21 classes;
  - zygosity: 0/0 -> homo-ref(0), x/x -> homo-var(1), 0/x -> het(2),
    x/y -> het-multi (folded to 2 for the task);
  - the 90-dim pileup training label = 21 GT21 one-hot + 3 zygosity one-hot
    + 33 + 33 variant-length one-hots (genotype.cpp:264-274). Note: the
    reference clamps variant lengths with min=max=16 (genotype.cpp:38-42),
    pinning both one-hots to index 32 — inert, because the production loss
    uses only gt+zy (model.py:110). We encode true lengths clamped to
    [-16, 16]; a `reference_quirk` flag restores the pinned behavior for
    byte-identical train-data diffing;
  - per-contig truth arrays [L, 3] = (confident-flag, gt21, zygosity) for
    haplotype-model training (get_truth.py:258-279: gt21 column initialized
    to the reference base's homozygous class for A/C/G/T, zygosity to -1).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .. import constants as C

# GT21 label strings in Ins/Del form, index-aligned with C.GT21_LABELS
GT21_FULL = [
    "AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT", "TT",
    "DelDel", "ADel", "CDel", "GDel", "TDel",
    "InsIns", "AIns", "CIns", "GIns", "TIns", "InsDel",
]
GT21_MAP = {s: i for i, s in enumerate(GT21_FULL)}

VARIANT_LENGTH_OFFSET = 16
NUM_VARIANT_LENGTH = 2 * VARIANT_LENGTH_OFFSET + 1  # 33


def partial_label_from(ref: str, alt: str) -> str:
    if len(ref) > len(alt):
        return "Del"
    if len(ref) < len(alt):
        return "Ins"
    return alt[0]


def mix_two_partial_labels(label1: str, label2: str) -> str:
    if len(label1) == 1 and len(label2) == 1:
        return label1 + label2 if label1 <= label2 else label2 + label1
    tlb1, tlb2 = label1, label2
    if len(label1) > 1 and len(label2) == 1:
        tlb1, tlb2 = label2, label1
    if len(tlb2) > 1 and len(tlb1) == 1:
        return tlb1 + tlb2
    if label1 and label2 and label1 == label2:
        return label1 + label2
    return "InsDel"


def _alternate_arr(reference: str, alternate: str, g1: int, g2: int,
                   cpp_split: bool = False) -> List[str]:
    # cpp_split: the C++ encoder tokenizes with strtok semantics
    # (cpp_aux.cpp:44-59 split_line skips empty tokens), which matters for
    # '*'-fixed alts like "CT," — C++ sees ONE token and rebuilds the pair
    # from the full comma-bearing string, Python's split(',') sees two.
    # Confirmed against the compiled DNA_CreateTrainData
    # (tests/test_train_data_oracle.py).
    arr = [t for t in alternate.split(",") if t] if cpp_split \
        else alternate.split(",")
    if len(arr) == 1:
        if g1 == 0 or g2 == 0:
            arr = [reference, alternate]
        else:
            arr = [alternate, alternate]
    return arr


def gt21_enum_from(reference: str, alternate: str, g1: int, g2: int,
                   cpp_split: bool = False) -> int:
    arr = _alternate_arr(reference, alternate, g1, g2, cpp_split)
    partials = [partial_label_from(reference, a) for a in arr]
    return GT21_MAP[mix_two_partial_labels(partials[0], partials[1])]


def genotype_enum_from(g1: int, g2: int) -> int:
    if g1 == 0 and g2 == 0:
        return 0  # homo reference
    if g1 == g2:
        return 1  # homo variant
    if g1 != 0 and g2 != 0:
        return 3  # hetero multi
    return 2      # hetero


def genotype_enum_for_task(g: int) -> int:
    return 2 if g == 3 else g


def variant_lengths(reference: str, alternate: str, g1: int, g2: int,
                    reference_quirk: bool = False) -> Tuple[int, int]:
    arr = _alternate_arr(reference, alternate, g1, g2,
                         cpp_split=reference_quirk)
    if reference_quirk:
        lens = [VARIANT_LENGTH_OFFSET, VARIANT_LENGTH_OFFSET]
    else:
        lens = sorted(
            max(min(len(a) - len(reference), VARIANT_LENGTH_OFFSET),
                -VARIANT_LENGTH_OFFSET) for a in arr)
    return lens[0], lens[1]


def y_label_from_truth(reference: str, alternate: str, g1: int, g2: int,
                       reference_quirk: bool = False) -> np.ndarray:
    """90-dim one-hot training label (21 + 3 + 33 + 33)."""
    y = np.zeros(21 + 3 + 2 * NUM_VARIANT_LENGTH, dtype=np.int32)
    y[gt21_enum_from(reference, alternate, g1, g2,
                     cpp_split=reference_quirk)] = 1
    y[21 + genotype_enum_for_task(genotype_enum_from(g1, g2))] = 1
    l1, l2 = variant_lengths(reference, alternate, g1, g2, reference_quirk)
    y[24 + l1 + VARIANT_LENGTH_OFFSET] = 1
    y[24 + NUM_VARIANT_LENGTH + l2 + VARIANT_LENGTH_OFFSET] = 1
    return y


def y_label_from_reference(ref_base: str) -> np.ndarray:
    """Label for a non-variant site (genotype.cpp:282-304)."""
    y = np.zeros(21 + 3 + 2 * NUM_VARIANT_LENGTH, dtype=np.int32)
    y[GT21_MAP[ref_base + ref_base]] = 1
    y[21 + 0] = 1  # homo reference
    y[24 + VARIANT_LENGTH_OFFSET] = 1
    y[24 + NUM_VARIANT_LENGTH + VARIANT_LENGTH_OFFSET] = 1
    return y


# ---------------------------------------------------------------------------
# Per-contig truth arrays for the haplotype model
# ---------------------------------------------------------------------------

_REF_GT21 = np.full(256, -1, dtype=np.int64)
for _b, _cls in (("A", 0), ("C", 4), ("G", 7), ("T", 9)):
    _REF_GT21[ord(_b)] = _cls
    _REF_GT21[ord(_b.lower())] = _cls


def truth_arrays(
    contig_lengths: Dict[str, int],
    contig_seqs: Dict[str, np.ndarray],
    bed_intervals: Iterable[Tuple[str, int, int]],
    truth_vcf_lines: Iterable[str],
) -> Dict[str, np.ndarray]:
    """{contig: [L, 3] int} of (confident, gt21, zygosity).

    gt21 column defaults to the reference base's homozygous class (or the
    raw ASCII code for non-ACGT, as the reference does); zygosity defaults
    to -1 (get_truth.py:264-275).
    """
    out: Dict[str, np.ndarray] = {}
    for ctg, length in contig_lengths.items():
        arr = np.zeros((length, 3), dtype=np.int64)
        seq = contig_seqs[ctg]
        gt_col = _REF_GT21[seq].copy()
        non_acgt = gt_col < 0
        gt_col[non_acgt] = seq[non_acgt]     # raw ASCII, like the reference
        arr[:, 1] = gt_col
        arr[:, 2] = -1
        out[ctg] = arr
    for ctg, start, end in bed_intervals:
        if ctg in out:
            # the reference marks [start-1, end-1) — it shifts the 0-based
            # BED interval down by one (get_truth.py:118-125); replicated
            # for label parity
            out[ctg][max(start - 1, 0): max(end - 1, 0), 0] = 1
    for line in truth_vcf_lines:
        if not line.strip() or line.startswith("#"):
            continue
        fields = line.strip().split("\t")
        ctg = fields[0]
        if ctg not in out:
            continue
        pos = int(fields[1])
        if out[ctg][pos - 1, 0] == 0:
            continue
        zyg = fields[-1].split(":")[0].replace("/", "|")
        g1, g2 = (int(v) for v in zyg.split("|"))
        gt21 = gt21_enum_from(fields[3], fields[4], g1, g2)
        out[ctg][pos - 1, 1] = gt21
        out[ctg][pos - 1, 2] = genotype_enum_for_task(genotype_enum_from(g1, g2))
    return out


def parse_bed(lines: Iterable[str]) -> List[Tuple[str, int, int]]:
    out = []
    for line in lines:
        if not line.strip():
            continue
        cols = line.split("\t")
        out.append((cols[0], int(cols[1]), int(cols[2])))
    return out
