"""Frozen copy of the pileup-call decode (NanoSNP PileupModel/predict.py
rules, bug_compat on) and of the haplotype CSV row, written as plain
Python over numpy so the check does not move when the program's decoder
does. The reference rows come from the reference's probabilities.

Quirks kept, as the program keeps them with bug_compat: the fallback alt
(gt says reference, zy says variant) indexes the batch's gt argmax array
with class ids, in batches of 1000 rows counted from the start of each
decode chunk of 100,000 rows; a class id past the batch's end drops the
row; a site of depth 0 is dropped; QUAL is str(round(x, 2)).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

GT21 = ['AA', 'AC', 'AG', 'AT', 'CC', 'CG', 'CT', 'GG', 'GT', 'TT', 'DD',
        'AD', 'CD', 'GD', 'TD', 'II', 'AI', 'CI', 'GI', 'TI', 'ID']
ZY = ['0/0', '1/1', '0/1']
HOMO_SNV = [0, 4, 7, 9]
HET_SNV = [1, 2, 3, 5, 6, 8]
BASE_IDX = {'A': 0, 'C': 1, 'G': 2, 'T': 3}
COV_CH = np.array([0, 1, 2, 3, 9, 10, 11, 12])
DECODE_BATCH = 1000
DECODE_CHUNK = 100_000


def phred(p: float) -> float:
    """The reference's calculate_score."""
    tmp = max(-10 * math.log(math.e, 10)
              * math.log(((1.0 - p) + 1e-300) / (p + 1e-300)) + 10, 0)
    return float(round(tmp, 2))


def _fallback(sref: str, zy: str, batch_arg: np.ndarray):
    ti_set = HOMO_SNV if zy == "1/1" else HET_SNV
    max_ti, max_v = -1, -1
    for ti in ti_set:
        if zy == "1/1" and GT21[ti][0] == sref:
            continue
        if ti >= len(batch_arg):
            return None
        v = int(batch_arg[ti])
        if v > max_v:
            max_v, max_ti = v, ti
    label = GT21[max_ti]
    if zy == "1/1":
        return label[0]
    return label[1] if label[0] == sref else label[0]


def row_for(sref: str, gt_c: int, zy_c: int, gq: float, zq: float,
            cov: np.ndarray, batch_arg: np.ndarray):
    """The row that gt class gt_c and zy class zy_c give at a site ->
    (decision fields, QUAL, fallback), or None where no row is written.
    The decision fields are REF, ALT, FILTER, GT, DP, AF: every column but
    QUAL and GQ (GQ is int(QUAL)); gq and zq are the phred scores of the
    site's largest gt and zy probabilities; cov the center column's
    COV_CH counts; batch_arg the gt argmax of the site's decode batch."""
    if gt_c >= 10:
        return None
    zy = ZY[zy_c]
    depth = int(np.where(cov < 0, -cov, 0).sum())
    alt = GT21[gt_c].replace(sref, "")
    support = sum(int(cov[BASE_IDX[b]]) + int(cov[BASE_IDX[b] + 4])
                  for b in alt)
    if depth == 0:
        return None
    tail = (str(depth), f"{min(support / depth, 1.0):f}")
    if len(alt) == 0:
        if zy == "0/0":
            return (sref, sref, "RefCall", zy) + tail, min(gq, zq), False
        new_alt = _fallback(sref, zy, batch_arg)
        if new_alt is None:
            return None
        return (sref, new_alt, "PASS", zy) + tail, zq, True
    if len(alt) == 2 and alt[0] == alt[1]:
        alt = alt[0]
    if len(alt) == 2:
        alt = ",".join(alt)
    if len(alt) >= 3 and zy_c != 2:
        zy = "1/2"
    qual = gq if zy_c == 0 else min(gq, zq)
    return (sref, alt, "PASS", zy) + tail, qual, False


def pileup_rows(positions: np.ndarray, ref_bases: str, gt_prob: np.ndarray,
                zy_prob: np.ndarray, center: np.ndarray) -> Dict[int, tuple]:
    """{position: (decision fields, QUAL, fallback)} of the VCF rows that
    the probabilities give (`row_for` at each site's argmax classes)."""
    out = {}
    for g, _, row in site_rows(positions, ref_bases, gt_prob, zy_prob,
                               center):
        if row is not None:
            out[int(positions[g])] = row
    return out


def site_rows(positions, ref_bases, gt_prob, zy_prob, center, combos=None):
    """(site index, (gt class, zy class), row_for(...)) of each site at
    its argmax classes; `combos` {site index: [(gt class, zy class), ...]}
    takes those sites alone, at each of the pairs in turn (the batch's
    argmax kept for the fallback)."""
    n = len(positions)
    for c0 in range(0, n, DECODE_CHUNK):
        c1 = min(c0 + DECODE_CHUNK, n)
        gt_arg = gt_prob[c0:c1].argmax(1)
        zy_arg = zy_prob[c0:c1].argmax(1)
        for b0 in range(0, c1 - c0, DECODE_BATCH):
            b1 = min(b0 + DECODE_BATCH, c1 - c0)
            for j in range(b0, b1):
                g = c0 + j
                pairs = [(gt_arg[j], zy_arg[j])] if combos is None \
                    else combos.get(g, ())
                if not pairs:
                    continue
                gq = phred(float(gt_prob[g].max()))
                zq = phred(float(zy_prob[g].max()))
                cov = center[g, COV_CH].astype(np.int64)
                for gc, zc in pairs:
                    yield g, (int(gc), int(zc)), row_for(
                        ref_bases[g], int(gc), int(zc), gq, zq, cov,
                        gt_arg[b0:b1])


def parse_vcf(path: str) -> Dict[int, Tuple[tuple, float]]:
    """{position: (decision fields, QUAL)} of a pileup VCF's rows."""
    out = {}
    with open(path) as f:
        for line in f:
            if line[0] == "#":
                continue
            c = line.rstrip("\n").split("\t")
            fmt = c[9].split(":")
            out[int(c[1])] = ((c[3], c[4], c[6], fmt[0], fmt[2], fmt[3]),
                              float(c[5]))
    return out


def parse_csv(path: str) -> Dict[int, Tuple[str, float]]:
    """{position: (GT label, QUAL)} of a haplotype CSV's rows."""
    out = {}
    with open(path) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            out[int(c[1])] = (c[2], float(c[3]))
    return out
