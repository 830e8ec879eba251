"""Pileup-call VCF emission.

Port of the reference decode rules (PileupModel/predict.py:37-195) as
table-driven, mostly-vectorized logic. All quirks required for site-level
identical output are reproduced, gated by `bug_compat` (default True):

  - `gt_output[ti]` indexing (predict.py:107,119,151,163): the fallback-alt
    search indexes the *batch argmax array* with class ids, so the chosen alt
    depends on the first 10 rows of the current batch; with fewer rows than
    the probed index an IndexError is swallowed and the row is dropped
    (predict.py:193-194). We replicate both, which requires emulating the
    reference's batch boundaries (batch_size rows per step).
  - depth==0 -> ZeroDivisionError -> row dropped (predict.py:82,193).
  - support counting doubles homozygous-alt letters (predict.py:78-81).
  - QUAL is `str(round(x, 2))`, AF is "%f", GQ is `str(int(qual))`.

With bug_compat=False the fallback-alt search uses the sane rule (argmax of
the row's own class probabilities within the candidate set).
"""
from __future__ import annotations

import math
from typing import IO, List, Optional, Sequence

import numpy as np

from .. import constants as C

_LOG10E_NEG10 = -10 * math.log(math.e, 10)


def calculate_score(p: float) -> float:
    """Phred-like score (reference predict.py:31-34)."""
    tmp = max(_LOG10E_NEG10 * math.log(((1.0 - p) + 1e-300) / (p + 1e-300)) + 10, 0)
    return float(round(tmp, 2))


def write_vcf_header(fai_path: str, out: IO[str]) -> None:
    """VCF header from the reference .fai (reference predict.py:13-27)."""
    out.write("##fileformat=VCFv4.3\n")
    out.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
    out.write('##FILTER=<ID=RefCall,Description="Reference call">\n')
    with open(fai_path) as f:
        for line in f:
            cols = line.strip().split()
            out.write(f"##contig=<ID={cols[0]},length={cols[1]}>\n")
    out.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
    out.write('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">\n')
    out.write('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">\n')
    out.write('##FORMAT=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">\n')
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSample\n")


def _fallback_alt(sref: str, zy: str, gt_argmax_batch: np.ndarray,
                  gt_prob_row: Optional[np.ndarray], bug_compat: bool) -> Optional[str]:
    """The 'force an alt' search when gt says ref but zy says variant.

    bug_compat: max over gt_argmax_batch[ti] for ti in the class-id set
    (the reference quirk). Returns None if an index is out of range
    (row dropped, like the swallowed IndexError)."""
    ti_set = C.GT21_HOMO_SNV if zy == "1/1" else C.GT21_HET_SNV
    max_ti, max_v = -1, -1
    for ti in ti_set:
        if zy == "1/1" and C.GT21_LABELS[ti][0] == sref:
            continue
        if bug_compat:
            if ti >= len(gt_argmax_batch):
                return None
            v = int(gt_argmax_batch[ti])
        else:
            v = float(gt_prob_row[ti])
        if v > max_v:
            max_v = v
            max_ti = ti
    label = C.GT21_LABELS[max_ti]
    if zy == "1/1":
        return label[0]
    return label[1] if label[0] == sref else label[0]


def decode_pileup_calls(
    contig: str,
    positions: np.ndarray,       # [N] int64
    ref_bases: Sequence[str],    # center reference base per site ('A'..'T')
    gt_prob: np.ndarray,         # [N, 21] softmaxed
    zy_prob: np.ndarray,         # [N, 3] softmaxed
    center_counts: np.ndarray,   # [N, 18] int — center column of the window
    out: IO[str],
    batch_size: int = 1000,
    bug_compat: bool = True,
) -> int:
    """Decode one chromosome's model outputs into VCF rows. Returns #rows."""
    n = len(positions)
    if n == 0:
        return 0
    gt_arg = gt_prob.argmax(axis=1)
    zy_arg = zy_prob.argmax(axis=1)
    gt_max = gt_prob.max(axis=1)
    zy_max = zy_prob.max(axis=1)
    cov = center_counts[:, C.DECODE_COV_CH].astype(np.int64)   # [N, 8]
    # depth = -(sum of negative entries); AF support from per-base columns
    depth_all = np.where(cov < 0, -cov, 0).sum(axis=1)

    rows = 0
    for b0 in range(0, n, batch_size):
        b1 = min(b0 + batch_size, n)
        gt_arg_b = gt_arg[b0:b1]
        for j in range(b0, b1):
            if gt_arg[j] >= 10:
                continue
            sref = ref_bases[j]
            gt_label = C.GT21_LABELS[gt_arg[j]]
            zy = C.ZY_LABELS[zy_arg[j]]
            depth = int(depth_all[j])
            alt = gt_label.replace(sref, "")
            support = 0
            for base in alt:
                bidx = C.BASE_IDX[base]
                support += int(cov[j, bidx]) + int(cov[j, bidx + 4])
            if depth == 0:
                continue  # reference: ZeroDivisionError swallowed
            af = min(support / depth, 1.0)

            gt_qual = calculate_score(float(gt_max[j]))
            zy_qual = calculate_score(float(zy_max[j]))
            qual = min(gt_qual, zy_qual)

            if len(alt) == 0:
                if zy == "0/0":
                    out.write(f"{contig}\t{positions[j]}\t.\t{sref}\t{sref}\t{qual}\t"
                              f"RefCall\t.\tGT:GQ:DP:AF\t{zy}:{int(qual)}:{depth}:{af:f}\n")
                    rows += 1
                elif zy in ("1/1", "0/1"):
                    new_alt = _fallback_alt(sref, zy, gt_arg_b, gt_prob[j], bug_compat)
                    if new_alt is None:
                        continue
                    out.write(f"{contig}\t{positions[j]}\t.\t{sref}\t{new_alt}\t{zy_qual}\t"
                              f"PASS\t.\tGT:GQ:DP:AF\t{zy}:{int(zy_qual)}:{depth}:{af:f}\n")
                    rows += 1
                continue
            if len(alt) == 2 and alt[0] == alt[1]:
                alt = alt[0]
            if len(alt) == 2:
                alt = ",".join(alt)

            if len(alt) >= 3 and zy_arg[j] != 2:
                zy = "1/2"

            # (reference predict.py:143-176 `alt == sref` branch is
            # unreachable: alt is non-empty and sref-free here)

            if alt != sref and zy_arg[j] == 0:
                out.write(f"{contig}\t{positions[j]}\t.\t{sref}\t{alt}\t{gt_qual}\t"
                          f"PASS\t.\tGT:GQ:DP:AF\t{zy}:{int(gt_qual)}:{depth}:{af:f}\n")
                rows += 1
                continue

            out.write(f"{contig}\t{positions[j]}\t.\t{sref}\t{alt}\t{qual}\t"
                      f"PASS\t.\tGT:GQ:DP:AF\t{zy}:{int(qual)}:{depth}:{af:f}\n")
            rows += 1
    return rows


# ---------------------------------------------------------------------------
# Vectorized decoder
# ---------------------------------------------------------------------------
# The scalar decode_pileup_calls above is the reference-exact port; this
# fast path precomputes every (sref, gt_argmax, zy_argmax) combination's
# branch decision, alt/zy strings, AF support weights, and qual choice, so
# per-batch work is numpy plus one string-assembly comprehension over kept
# rows. Differential-tested against the scalar port.

_SREFS = "ACGT"


def _combo_tables():
    import numpy as np

    n_combo = 4 * 21 * 3
    keep = np.zeros(n_combo, dtype=bool)
    needs_fallback = np.zeros(n_combo, dtype=bool)   # batch-dependent alt
    alt_str = [""] * n_combo
    zy_str = [""] * n_combo
    filt = [""] * n_combo
    qual_kind = np.zeros(n_combo, dtype=np.int8)     # 0=min 1=gt 2=zy
    support_w = np.zeros((n_combo, 8), dtype=np.int64)

    for si, sref in enumerate(_SREFS):
        for gt_a in range(21):
            for zy_a in range(3):
                ci = (si * 21 + gt_a) * 3 + zy_a
                if gt_a >= 10:
                    continue
                gt_label = C.GT21_LABELS[gt_a]
                zy = C.ZY_LABELS[zy_a]
                alt = gt_label.replace(sref, "")
                for base in alt:
                    b = C.BASE_IDX[base]
                    support_w[ci, b] += 1
                    support_w[ci, b + 4] += 1
                if len(alt) == 0:
                    if zy == "0/0":
                        keep[ci] = True
                        alt_str[ci] = sref
                        zy_str[ci] = zy
                        filt[ci] = "RefCall"
                        qual_kind[ci] = 0
                    else:
                        keep[ci] = True
                        needs_fallback[ci] = True
                        zy_str[ci] = zy
                        filt[ci] = "PASS"
                        qual_kind[ci] = 2
                    continue
                if len(alt) == 2 and alt[0] == alt[1]:
                    alt = alt[0]
                if len(alt) == 2:
                    alt = ",".join(alt)
                if len(alt) >= 3 and zy_a != 2:
                    zy = "1/2"
                keep[ci] = True
                alt_str[ci] = alt
                zy_str[ci] = zy
                filt[ci] = "PASS"
                qual_kind[ci] = 1 if zy_a == 0 else 0
    return dict(keep=keep, needs_fallback=needs_fallback, alt=alt_str,
                zy=zy_str, filt=filt, qual_kind=qual_kind,
                support_w=support_w)


_TABLES = None


def _get_tables():
    global _TABLES
    if _TABLES is None:
        _TABLES = _combo_tables()
    return _TABLES


def _phred_vec(p: np.ndarray) -> np.ndarray:
    # float64 throughout so round(x, 2) and str() match the scalar path
    p = p.astype(np.float64)
    tmp = _LOG10E_NEG10 * np.log(((1.0 - p) + 1e-300) / (p + 1e-300)) + 10
    return np.round(np.maximum(tmp, 0), 2)


def decode_pileup_calls_fast(
    contig: str,
    positions: np.ndarray,
    ref_bases,
    gt_prob: np.ndarray,
    zy_prob: np.ndarray,
    center_counts: np.ndarray,
    out,
    batch_size: int = 1000,
    bug_compat: bool = True,
) -> int:
    """Vectorized equivalent of decode_pileup_calls (same output bytes)."""
    n = len(positions)
    if n == 0:
        return 0
    t = _get_tables()
    gt_arg = gt_prob.argmax(axis=1)
    zy_arg = zy_prob.argmax(axis=1)
    gt_qual = _phred_vec(gt_prob.max(axis=1))
    zy_qual = _phred_vec(zy_prob.max(axis=1))
    min_qual = np.minimum(gt_qual, zy_qual)

    sref_arr = np.frombuffer(
        "".join(ref_bases).encode(), dtype=np.uint8) if isinstance(
            ref_bases, list) else ref_bases
    sref_idx = np.searchsorted(np.frombuffer(b"ACGT", dtype=np.uint8),
                               sref_arr)
    combo = (sref_idx * 21 + gt_arg) * 3 + zy_arg

    cov = center_counts[:, C.DECODE_COV_CH].astype(np.int64)
    depth = np.where(cov < 0, -cov, 0).sum(axis=1)
    support = np.einsum("nk,nk->n", cov, t["support_w"][combo])
    with np.errstate(divide="ignore", invalid="ignore"):
        af = np.minimum(support / np.where(depth == 0, 1, depth), 1.0)

    keep = t["keep"][combo] & (depth > 0)
    qual_kind = t["qual_kind"][combo]
    qual = np.where(qual_kind == 0, min_qual,
                    np.where(qual_kind == 1, gt_qual, zy_qual))

    needs_fb = t["needs_fallback"][combo]
    rows_out = 0
    alt_cache = {}
    pieces = []
    for b0 in range(0, n, batch_size):
        b1 = min(b0 + batch_size, n)
        gt_arg_b = gt_arg[b0:b1]
        alt_cache.clear()
        for j in np.flatnonzero(keep[b0:b1]) + b0:
            ci = combo[j]
            if needs_fb[j]:
                key = (int(sref_idx[j]), t["zy"][ci])
                if key not in alt_cache:
                    alt_cache[key] = _fallback_alt(
                        _SREFS[sref_idx[j]], t["zy"][ci], gt_arg_b,
                        gt_prob[j], bug_compat)
                alt = alt_cache.get(key)
                # non-compat mode depends on the row's own probs: recompute
                if not bug_compat:
                    alt = _fallback_alt(_SREFS[sref_idx[j]], t["zy"][ci],
                                        gt_arg_b, gt_prob[j], bug_compat)
                if alt is None:
                    continue
            else:
                alt = t["alt"][ci]
            q = qual[j]
            pieces.append(
                f"{contig}\t{positions[j]}\t.\t{_SREFS[sref_idx[j]]}\t{alt}\t"
                f"{q}\t{t['filt'][ci]}\t.\tGT:GQ:DP:AF\t"
                f"{t['zy'][ci]}:{int(q)}:{depth[j]}:{af[j]:f}\n")
            rows_out += 1
    out.write("".join(pieces))
    return rows_out
