"""Native read-backed phasing of heterozygous SNVs (whatshap replacement).

The reference pipeline's s3 shells out to `whatshap phase` + `whatshap
haplotag` (scripts/s3_phasing_long_reads.sh:48-69) purely to partition the
reads into two haplotype groups for the s4 feature extractor — the phased
VCF itself is never consumed downstream. This module computes the same
read partition natively from the allele matrix:

  1. build A[r, p] ∈ {+1 (ref), −1 (alt), 0 (other/uncovered)} over reads ×
     het sites from the native BAM engine's read matrices;
  2. connected components over sites sharing ≥1 informative read = phase
     blocks (whatshap's block notion);
  3. per block, greedy chain initialization (each site oriented by the
     read-weighted vote against already-phased sites) followed by a few
     alternating majority sweeps — h = sign(A s), s = sign(Aᵀ h) — the
     classic MEC local-search heuristic, vectorized over the whole chunk;
  4. reads are assigned HP 1/2 by the sign of their agreement score; ties
     and single-site reads stay untagged (HP absent → the 'unphased'
     feature group), matching whatshap-haplotag behavior for uninformative
     reads.

Long contigs stream through overlapping windows; window k+1's blocks are
sign-aligned to window k on the shared sites, and per-read scores
accumulate across windows so boundary-spanning reads get one consistent
tag. Memory is O(window · depth).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import BASE2INT


@dataclass
class PhaseResult:
    contig: str
    positions: np.ndarray          # [S] int64 het sites (1-based)
    hap_of_alt: np.ndarray         # [S] int8: 1 → alt on hap1, 2 → alt on hap2, 0 unphased
    block_ids: np.ndarray          # [S] int64 phase-block id (position of block start)
    read_hp: Dict[int, int] = field(default_factory=dict)  # read_id -> 1|2
    n_switch_candidates: int = 0   # sites whose majority vote was weak

    @property
    def n_blocks(self) -> int:
        return len(set(self.block_ids[self.hap_of_alt != 0].tolist()))


def _allele_matrix(seqs: np.ndarray, ref_codes: np.ndarray,
                   alt_codes: np.ndarray) -> np.ndarray:
    """[R, P] base codes -> +1 ref / −1 alt / 0 other."""
    a = np.zeros(seqs.shape, dtype=np.int8)
    a[seqs == ref_codes[None, :]] = 1
    a[seqs == alt_codes[None, :]] = -1
    return a


def _phase_window(A: np.ndarray, n_iter: int = 8,
                  rng: Optional[np.random.Generator] = None
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Phase one window. A: [R, P] int8.

    Returns (s [P] ∈ {+1,−1,0}, comp [P] component label (−1 isolated),
    n_weak). s[p] = relative orientation: +1 means ref allele on hap1."""
    R, P = A.shape
    used = A != 0
    # pairwise link counts via informative reads: sites p,q linked when some
    # read covers both informatively
    s = np.zeros(P, dtype=np.int8)
    comp = np.full(P, -1, dtype=np.int64)
    n_weak = 0
    if P == 0:
        return s, comp, 0

    # chain edges (cols[j-1], cols[j]) of every read, extracted in one
    # vectorized pass: np.nonzero walks row-major, so consecutive entries
    # with equal row index are consecutive informative sites of one read
    rr, cc = np.nonzero(used)
    same_read = rr[1:] == rr[:-1]
    edges = np.unique(cc[:-1][same_read].astype(np.int64) * P
                      + cc[1:][same_read])

    # union-find over the (few) unique edges
    parent = np.arange(P)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in edges:
        a, b = find(int(e) // P), find(int(e) % P)
        if a != b:
            parent[b] = a
    roots = np.array([find(p) for p in range(P)])
    informative = np.zeros(P, dtype=bool)
    informative[cc] = True
    comp = np.where(informative, roots, -1)

    # greedy chain init: orient each site by the accumulated vote of
    # already-oriented sites (weighted by read agreement); `votes[r]`
    # carries each read's running agreement. Column-sparse updates make
    # the sweep O(nnz) — each site only touches its covering reads.
    s_f = np.zeros(P, dtype=np.float32)
    Af = A.astype(np.float32)
    votes = np.zeros(R, dtype=np.float32)
    col_starts = np.searchsorted(cc, np.arange(P + 1),
                                 sorter=np.argsort(cc, kind="stable"))
    cc_order = np.argsort(cc, kind="stable")
    rows_by_col = rr[cc_order]
    vals_by_col = A[rr[cc_order], cc[cc_order]].astype(np.float32)
    for p in range(P):
        if not informative[p]:
            continue
        sl = slice(col_starts[p], col_starts[p + 1])
        rows = rows_by_col[sl]
        vals = vals_by_col[sl]
        v = float(vals @ votes[rows])
        s_f[p] = 1.0 if v >= 0 else -1.0
        votes[rows] += vals * s_f[p]
    # alternating majority sweeps (vectorized local search)
    for _ in range(n_iter):
        h = Af @ s_f                          # [R] read scores
        h = np.sign(h)
        s_new = np.sign(Af.T @ h)             # [P]
        s_new = np.where(s_new == 0, s_f, s_new)
        if np.array_equal(s_new, s_f):
            break
        s_f = s_new
    # weak sites: majority margin ≤ 1 read
    margin = np.abs(Af.T @ np.sign(Af @ s_f))
    n_weak = int(((margin <= 1) & informative).sum())
    s = np.where(informative, s_f, 0).astype(np.int8)
    return s, comp, n_weak


def phase_contig(
    bam,
    contig: str,
    het_positions: np.ndarray,     # [S] int64, sorted, 1-based
    ref_bases: List[str],
    alt_bases: List[str],
    window_bp: int = 50_000,
    overlap_bp: int = 20_000,
    min_mq: int = 20,
    min_block_sites: int = 2,
) -> PhaseResult:
    """Phase a contig's het SNVs and partition its reads.

    `bam` is an io.bam.BamFile. Genomic windows of `window_bp` advance by
    window_bp − overlap_bp; the overlap (≳ a read length) aligns signs
    across windows and lets boundary-spanning reads vote in both. Memory
    is O(reads-in-window × sites-in-window).

    min_block_sites: components smaller than this stay UNPHASED (whatshap
    only phases variants connected to another variant by a read; a
    single-het block's HP tags partition reads by that site's own allele —
    zero cross-site information, and they leak noise through the merge
    deferral gate on sparse-het genomes). A site singleton in this window
    can still phase in an adjacent overlapping window that links it.
    Set 1 to restore the pre-r3 phase-everything behavior."""
    S = len(het_positions)
    lut = np.zeros(256, dtype=np.int32)
    for b, v in BASE2INT.items():
        lut[ord(b)] = v
        lut[ord(b.lower())] = v
    ref_codes_all = np.array([lut[ord(b[0])] for b in ref_bases], np.int32)
    alt_codes_all = np.array([lut[ord(b[0])] for b in alt_bases], np.int32)

    hap_of_alt = np.zeros(S, dtype=np.int8)
    block_ids = np.zeros(S, dtype=np.int64)
    read_scores: Dict[int, float] = {}
    prev_sign: Dict[int, float] = {}   # site index -> oriented sign
    n_weak_total = 0
    step = max(window_bp - overlap_bp, 1)
    win_start = int(het_positions[0]) if S else 0
    last_pos = int(het_positions[-1]) if S else 0
    while S and win_start <= last_pos:
        lo = np.searchsorted(het_positions, win_start)
        hi = np.searchsorted(het_positions, win_start + window_bp,
                             side="right")
        idx = np.arange(lo, hi)
        if len(idx) == 0:
            win_start += step
            continue
        pos = het_positions[idx]
        mats = bam.read_matrices(contig, pos, min_mq=min_mq,
                                 max_reads=8192)
        if mats is None:
            win_start += step
            continue
        A = _allele_matrix(mats["sequences"], ref_codes_all[idx],
                           alt_codes_all[idx])
        s, comp, n_weak = _phase_window(A)
        n_weak_total += n_weak
        if min_block_sites > 1:
            labels, counts = np.unique(comp[comp >= 0], return_counts=True)
            small = labels[counts < min_block_sites]
            if len(small):
                s = np.where(np.isin(comp, small), 0, s).astype(np.int8)
        # align to previous window on shared oriented sites, per component
        flips: Dict[int, float] = {}
        for j, site in enumerate(idx):
            if int(site) in prev_sign and s[j] != 0:
                c = comp[j]
                agree = prev_sign[int(site)] * s[j]
                flips[c] = flips.get(c, 0.0) + agree
        if flips:
            for c, v in flips.items():
                if v < 0:
                    s[comp == c] *= -1
        # record orientations + blocks (block id = first site position of
        # its component in this window; stable enough for PS-style output)
        comp_first: Dict[int, int] = {}
        for j, site in enumerate(idx):
            if s[j] == 0:
                continue
            c = int(comp[j])
            if c not in comp_first:
                c_sites = pos[comp == c]
                comp_first[c] = int(c_sites.min())
            if hap_of_alt[site] == 0:     # first window to phase this site wins
                # s=+1 → ref on hap1 → alt on hap2
                hap_of_alt[site] = 2 if s[j] > 0 else 1
                block_ids[site] = comp_first[c]
            prev_sign[int(site)] = float(s[j])
        # read votes (restricted to this window's orientation)
        scores = A.astype(np.float32) @ s.astype(np.float32)
        for rid, sc in zip(mats["read_ids"], scores):
            if sc:
                read_scores[int(rid)] = read_scores.get(int(rid), 0.0) + sc
        win_start += step

    read_hp = {rid: (1 if sc > 0 else 2)
               for rid, sc in read_scores.items() if sc != 0}
    return PhaseResult(
        contig=contig,
        positions=het_positions,
        hap_of_alt=hap_of_alt,
        block_ids=block_ids,
        read_hp=read_hp,
        n_switch_candidates=n_weak_total,
    )


def write_phased_vcf(result: PhaseResult, vcf_rows: List[str], out) -> int:
    """Rewrite the selected het rows with phased GT (0|1 / 1|0) + PS block
    tag, whatshap-style. vcf_rows are the contig's input het rows in
    position order; unphased rows pass through unchanged."""
    by_pos = {int(p): i for i, p in enumerate(result.positions)}
    n = 0
    for row in vcf_rows:
        cols = row.rstrip("\n").split("\t")
        i = by_pos.get(int(cols[1]))
        if i is None or result.hap_of_alt[i] == 0:
            out.write(row)
            continue
        gt = "1|0" if result.hap_of_alt[i] == 1 else "0|1"
        fmt = cols[8].split(":")
        vals = cols[9].split(":")
        if "PS" not in fmt:
            fmt.append("PS")
            vals.append(str(int(result.block_ids[i])))
        vals[fmt.index("GT")] = gt
        cols[8] = ":".join(fmt)
        cols[9] = ":".join(vals)
        out.write("\t".join(cols) + "\n")
        n += 1
    return n
