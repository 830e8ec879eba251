"""Shard sanity checkers (the reference's verify_dlformat.py /
verify_predict_input.py equivalents, dna_sv_tensor/src/make_bin_data/).

Programmatic instead of print-only: each check returns a report dict and
raises on structural violations when strict=True.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .. import constants as C
from . import bins


def verify_pileup_shard(path: str, strict: bool = True) -> Dict:
    s = bins.load_pileup_shard(path)
    n = len(s)
    report = {"path": path, "samples": n, "contig": s.contig}
    problems = []
    if s.matrix.shape != (n, C.PILEUP_WINDOW, C.NUM_CHANNELS):
        problems.append(f"matrix shape {s.matrix.shape}")
    if len(s.ref_seqs) != n or len(s.alt_info) != n:
        problems.append("ragged arrays")
    if n:
        if not (np.diff(s.positions) > 0).all():
            problems.append("positions not strictly increasing")
        centers = np.asarray([r[16:17] for r in s.ref_seqs])
        bad = sum(1 for r in s.ref_seqs if r[16:17] not in b"ACGT")
        if bad:
            problems.append(f"{bad} non-ACGT centers")
        # ref-base negation invariant: each row's center column has exactly
        # one non-positive fwd ACGT channel (the negated reference base)
        ctr = s.matrix[:, C.PILEUP_WINDOW // 2, :]
        neg_fwd = (ctr[:, C.ACGT_FWD_CH] < 0).sum(axis=1)
        if (neg_fwd > 1).any():
            problems.append("multiple negative fwd channels at center")
        report["mean_depth"] = float(
            np.where(ctr < 0, -ctr, 0).sum(axis=1).mean())
    report["problems"] = problems
    if strict and problems:
        raise AssertionError(f"{path}: {problems}")
    return report


def verify_haplotype_shard(path: str, strict: bool = True) -> Dict:
    s = bins.load_haplotype_shard(path)
    n = len(s)
    report = {"path": path, "samples": n, "contig": s.contig}
    problems = []
    for view, L in (("pileup", C.PILEUP_WINDOW), ("haplotype", C.HAPLOTYPE_WINDOW)):
        d = getattr(s, view)
        shapes = {k: d[k].shape for k in d}
        if len({v for v in shapes.values()}) != 1:
            problems.append(f"{view} shape mismatch {shapes}")
        seq = d["sequences"]
        if seq.shape[0] != n or seq.shape[2] != L:
            problems.append(f"{view} sequences shape {seq.shape}")
        vals = np.unique(seq)
        bad_vals = [int(v) for v in vals if v not in (-2, -1, 0, 1, 2, 3, 4)]
        if bad_vals:
            problems.append(f"{view} invalid base codes {bad_vals}")
        hap_vals = np.unique(d["hap"])
        bad_hap = [int(v) for v in hap_vals if v not in (-2, 0, 1, 2, 3)]
        if bad_hap:
            problems.append(f"{view} invalid hap values {bad_hap}")
    if s.group_positions.shape != (n, C.HAPLOTYPE_WINDOW):
        problems.append(f"group_positions shape {s.group_positions.shape}")
    if n and not (s.group_positions[:, C.ADJACENT_SIZE]
                  == s.candidate_positions).all():
        problems.append("candidate not at group center")
    report["problems"] = problems
    if strict and problems:
        raise AssertionError(f"{path}: {problems}")
    return report
