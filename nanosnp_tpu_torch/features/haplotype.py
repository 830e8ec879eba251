"""Haplotype-stage features: candidate-group selection (numpy, s4), the
105-statistic featurizer as torch reductions on the device (s5), and the
reference-base code helpers.

Counterpart of nanosnp_tpu/features/haplotype.py. Group selection ports
reference HaplotypeModel/select_hetesnp_homosnp.py:122-230 (vectorized:
nearest-5 support hets on each side via searchsorted). The reference's
`find_adjacent_sites` returns only its last contig's groups
(select_hetesnp_homosnp.py:228, an indentation bug masked in production
because each worker receives one contig); here, as in the JAX package,
selection is per contig and correct for any fan-out.

The featurizer (the reference's HaplotypeModel/dataset_dev.py:11-87): per
site and position column, 26
statistics (A/C/G/T/D frequency and count, per-base baseq sum and mean,
mapq sum and mean) over 4 read groups (all, HP=1, HP=2, unphased), plus a
reference-base row -> [N, L, 105] feature-last. Read-matrix encoding: 0
absent, 1-4 = ACGT, -1 deletion, -2 depth padding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from .. import constants as C

# ---------------------------------------------------------------------------
# Candidate-group selection
# ---------------------------------------------------------------------------


@dataclass
class ContigSites:
    """Kept sites of one contig (het any-qual + low-qual homo), pos-sorted."""
    contig: str
    positions: np.ndarray   # [S] int64
    quals: np.ndarray       # [S] float32
    is_het: np.ndarray      # [S] bool (genotype 0/1 after |/ normalization)


def collect_sites(
    vcf_lines: Iterable[str],
    quality_threshold: float = C.HAP_LOW_QUAL,
) -> Dict[str, ContigSites]:
    """Parse a pileup VCF keeping het sites and low-quality homozygous sites
    (reference select_hetesnp_homosnp.py:146-150)."""
    per: Dict[str, List[Tuple[int, float, bool]]] = {}
    for row in vcf_lines:
        if not row.strip() or row[0] == "#":
            continue
        cols = row.split()
        genotype = cols[9].split(":")[0].replace("|", "/")
        quality = float(cols[5])
        if genotype in ("0/0", "1/1") and quality >= quality_threshold:
            continue
        per.setdefault(cols[0], []).append(
            (int(cols[1]), quality, genotype == "0/1"))
    out = {}
    for ctg, rows in per.items():
        rows.sort()
        out[ctg] = ContigSites(
            contig=ctg,
            positions=np.array([r[0] for r in rows], dtype=np.int64),
            quals=np.array([r[1] for r in rows], dtype=np.float32),
            is_het=np.array([r[2] for r in rows], dtype=bool),
        )
    return out


def build_groups(
    sites: ContigSites,
    adjacent_size: int = C.ADJACENT_SIZE,
    quality_threshold: float = C.HAP_LOW_QUAL,
    support_quality: float = C.HAP_SUPPORT_QUAL,
) -> np.ndarray:
    """[G, 2*adjacent_size+1] positions: [5 left hets, candidate, 5 right
    hets]; candidates lacking 5 qualifying hets on either side are dropped
    (reference find_adjacent_sites:189-224)."""
    cand_idx = np.flatnonzero(sites.quals < quality_threshold)
    sup_idx = np.flatnonzero((sites.quals >= support_quality) & sites.is_het)
    if len(cand_idx) == 0 or len(sup_idx) < 2 * adjacent_size:
        return np.zeros((0, 2 * adjacent_size + 1), dtype=np.int64)
    # for candidate at site-index i: supports strictly left / right of i
    left_cnt = np.searchsorted(sup_idx, cand_idx, side="left")
    right_start = np.searchsorted(sup_idx, cand_idx, side="right")
    ok = (left_cnt >= adjacent_size) & (right_start + adjacent_size <= len(sup_idx))
    cand_idx = cand_idx[ok]
    left_cnt = left_cnt[ok]
    right_start = right_start[ok]
    if len(cand_idx) == 0:
        return np.zeros((0, 2 * adjacent_size + 1), dtype=np.int64)
    offs = np.arange(adjacent_size)
    left = sup_idx[left_cnt[:, None] - adjacent_size + offs[None, :]]
    right = sup_idx[right_start[:, None] + offs[None, :]]
    groups = np.concatenate(
        [sites.positions[left], sites.positions[cand_idx][:, None],
         sites.positions[right]], axis=1)
    return groups


def chunk_groups(
    groups: np.ndarray,
    chunk: int = C.GROUP_CHUNK,
    gap: int = C.GROUP_GAP,
) -> List[np.ndarray]:
    """Split a contig's groups into extraction sub-batches of <= `chunk`
    groups, broken where consecutive groups are > `gap` bp apart
    (reference make_predict_bins.py:89-109)."""
    out = []
    n = len(groups)
    start = 0
    for i in range(1, n + 1):
        if (i == n or i - start == chunk
                or groups[i][0] - groups[i - 1][-1] > gap):
            out.append(groups[start:i])
            start = i
        if i == n:
            break
    return [g for g in out if len(g)]


# ---------------------------------------------------------------------------
# 105-statistic featurizer (device-side)
# ---------------------------------------------------------------------------


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
