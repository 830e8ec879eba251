"""Frozen copy of the haplotype featurizer (NanoSNP
HaplotypeModel/dataset_dev.py get_frequency_feature: 26 statistics of
each of four read groups, all, HP=1, HP=2, unphased, then the reference
base code -> [N, L, 105]), of the reference-base codes, and of the s5
deferral rule (a site whose candidate column's covering reads are phased
below the configured fraction gets no CSV row). Plain torch and numpy;
imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

BASE_CODE = {"A": 1, "C": 2, "G": 3, "T": 4}
PAD = -2


def _group(seq, bq, mq, member):
    m = member[:, :, None].float()
    is_base = [(seq == b).float() * m for b in (1.0, 2.0, 3.0, 4.0)]
    is_del = (seq == -1.0).float() * m
    cnts = [x.sum(1) for x in is_base]
    d_cnt = is_del.sum(1)
    total = cnts[0] + cnts[1] + cnts[2] + cnts[3] + d_cnt + 1e-6
    freqs = [c / total for c in cnts] + [d_cnt / total]
    bq_sums = [(bq * x).sum(1) for x in is_base]
    bq_means = [s / (c + 1e-9) for s, c in zip(bq_sums, cnts)]
    mq_sums = [(mq * x).sum(1) for x in is_base]
    mq_means = [s / (c + 1e-9) for s, c in zip(mq_sums, cnts)]
    out = torch.stack(freqs + cnts + [d_cnt] + bq_sums + bq_means + mq_sums
                      + mq_means, dim=-1)
    return torch.where(member.any(1)[:, None, None], out,
                       torch.zeros_like(out))


def features(seq, bq, mq, hap, ref_codes) -> torch.Tensor:
    """[N, D, L] read matrices, [N, L] codes -> [N, L, 105] f32."""
    seq, bq, mq, hap = (t.float() for t in (seq, bq, mq, hap))
    groups = [torch.ones(seq.shape[:2], dtype=torch.bool, device=seq.device)]
    groups += [(hap == g).any(2) for g in (1.0, 2.0, 3.0)]
    return torch.cat([_group(seq, bq, mq, g) for g in groups]
                     + [ref_codes.float()[:, :, None]], dim=-1)


def codes(seq: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Reference-base codes at 1-based positions (0 for N or outside)."""
    lut = np.zeros(256, np.float32)
    for b, v in BASE_CODE.items():
        lut[ord(b)] = v
        lut[ord(b.lower())] = v
    idx = positions - 1
    ok = (idx >= 0) & (idx < len(seq))
    return lut[np.where(ok, seq[np.clip(idx, 0, len(seq) - 1)], 0)]


def kept(hap_view_hap: np.ndarray, frac: float) -> np.ndarray:
    """[n] bool: the sites that s5's deferral keeps."""
    col = hap_view_hap[:, :, hap_view_hap.shape[2] // 2]
    covering = np.maximum((col != PAD).sum(1), 1)
    if frac <= 0:
        return np.ones(len(col), bool)
    return ((col == 1) | (col == 2)).sum(1) / covering >= frac
