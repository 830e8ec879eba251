"""The 105-statistic haplotype featurizer, as torch reductions on the
device, and the reference-base code helpers.

Counterpart of nanosnp_tpu/features/haplotype.py (the reference's
HaplotypeModel/dataset_dev.py:11-87): per site and position column, 26
statistics (A/C/G/T/D frequency and count, per-base baseq sum and mean,
mapq sum and mean) over 4 read groups (all, HP=1, HP=2, unphased), plus a
reference-base row -> [N, L, 105] feature-last. Read-matrix encoding: 0
absent, 1-4 = ACGT, -1 deletion, -2 depth padding. The group selection of
s4 (collect_sites, build_groups, chunk_groups) belongs to the host stages
and is not part of this slice.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as C


def _group_stats(seq, baseq, mapq, member):
    """26 stats for one read group. seq/baseq/mapq [N, D, L] f32, member
    [N, D] bool (whole read) -> [N, L, 26] f32, zeros where the group is
    empty. The sums run in the JAX package's order so that the results are
    the same f32 values."""
    m = member[:, :, None].to(seq.dtype)                    # [N, D, 1]
    is_base = [(seq == b).to(seq.dtype) * m for b in (1.0, 2.0, 3.0, 4.0)]
    is_del = (seq == -1.0).to(seq.dtype) * m
    cnts = [x.sum(dim=1) for x in is_base]                  # 4 x [N, L]
    d_cnt = is_del.sum(dim=1)
    total = cnts[0] + cnts[1] + cnts[2] + cnts[3] + d_cnt + 1e-6
    freqs = [c / total for c in cnts] + [d_cnt / total]
    bq_sums = [(baseq * x).sum(dim=1) for x in is_base]
    bq_means = [s / (c + 1e-9) for s, c in zip(bq_sums, cnts)]
    mq_sums = [(mapq * x).sum(dim=1) for x in is_base]
    mq_means = [s / (c + 1e-9) for s, c in zip(mq_sums, cnts)]
    feats = freqs + cnts + [d_cnt] + bq_sums + bq_means + mq_sums + mq_means
    out = torch.stack(feats, dim=-1)                        # [N, L, 26]
    has_reads = member.any(dim=1)[:, None, None]
    return torch.where(has_reads, out, torch.zeros_like(out))


def haplotype_features(seq, baseq, mapq, hap, ref_codes) -> torch.Tensor:
    """[N, D, L] read matrices (int8/int16 or float; argument order seq,
    baseq, mapq, hap) and [N, L] reference codes -> [N, L, 105] f32.

    Feature order along the last axis is the reference's row order: 26
    all-reads, 26 HP=1, 26 HP=2, 26 unphased, then the reference base."""
    seq = seq.float()
    baseq = baseq.float()
    mapq = mapq.float()
    hap = hap.float()
    all_member = torch.ones(seq.shape[:2], dtype=torch.bool,
                            device=seq.device)
    groups = [all_member] + [(hap == g).any(dim=2) for g in (1.0, 2.0, 3.0)]
    return torch.cat([_group_stats(seq, baseq, mapq, g) for g in groups]
                     + [ref_codes.float()[:, :, None]], dim=-1)


def _base_codes() -> np.ndarray:
    lut = np.zeros(256, dtype=np.float32)
    for b, v in C.BASE2INT.items():
        lut[ord(b)] = v
        lut[ord(b.lower())] = v
    return lut


def ref_window_codes(chr_seq: np.ndarray, centers: np.ndarray,
                     flank: int) -> np.ndarray:
    """Reference-base codes for +-flank windows (N and out-of-range -> 0,
    matching dataset_dev.py:112-118)."""
    offs = np.arange(-flank, flank + 1)
    return ref_position_codes(chr_seq, centers[:, None] + offs[None, :])


def ref_position_codes(chr_seq: np.ndarray,
                       positions: np.ndarray) -> np.ndarray:
    """Reference-base codes at explicit 1-based positions [N, L]."""
    idx = positions - 1
    valid = (idx >= 0) & (idx < len(chr_seq))
    chars = np.where(valid, chr_seq[np.clip(idx, 0, len(chr_seq) - 1)], 0)
    return _base_codes()[chars]


def haplotype_features_numpy(seq, baseq, mapq, hap, ref_codes) -> np.ndarray:
    """NumPy oracle of `haplotype_features` (mirrors
    dataset_dev.get_frequency_feature, including the output row order)."""
    n, d, L = seq.shape
    out = np.zeros((n, L, 105), dtype=np.float64)
    for s in range(n):
        blocks = []
        members = [
            np.ones(d, dtype=bool),
            (hap[s] == 1).any(axis=1),
            (hap[s] == 2).any(axis=1),
            (hap[s] == 3).any(axis=1),
        ]
        for gi, mem in enumerate(members):
            if gi > 0 and not mem.any():
                blocks.append(np.zeros((26, L)))
                continue
            sq, bq, mq = seq[s][mem], baseq[s][mem], mapq[s][mem]
            cnts = [(sq == b).sum(axis=0) for b in (1, 2, 3, 4)]
            d_cnt = (sq == -1).sum(axis=0)
            total = sum(cnts) + d_cnt + 1e-6
            freqs = [c / total for c in cnts] + [d_cnt / total]
            bq_sums = [(bq * (sq == b)).sum(axis=0) for b in (1, 2, 3, 4)]
            bq_means = [sm / (c + 1e-9) for sm, c in zip(bq_sums, cnts)]
            mq_sums = [(mq * (sq == b)).sum(axis=0) for b in (1, 2, 3, 4)]
            mq_means = [sm / (c + 1e-9) for sm, c in zip(mq_sums, cnts)]
            blocks.append(np.stack(
                freqs + cnts + [d_cnt] + bq_sums + bq_means + mq_sums
                + mq_means))
        feats = np.concatenate(blocks + [ref_codes[s][None, :]], axis=0)
        out[s] = feats.T
    return out.astype(np.float32)
