"""Pileup-stage feature extraction: mpileup rows -> 18-channel counts,
candidate detection, and 33x18 window tensors.

Semantics mirror the reference's TensorMaker + sliding-window loop
(dna_sv_tensor/src/make_candidate_snp_tensor/tensor_maker.cpp:61-249,
main.cpp:113-312) and are verified by differential tests against the
reference binary. The architecture differs deliberately:

  - parsing produces flat per-position arrays (positions, counts, flags)
    instead of a streaming ring buffer;
  - window emission is a vectorized gather: a candidate at row i is emitted
    iff rows i-16..i+16 exist and are genomically contiguous
    (`positions[i+16] - positions[i-16] == 32`), which is provably equivalent
    to the reference's ring-buffer + gap-reset logic (gaps clear pending
    candidates, main.cpp:174-178; incomplete windows are dropped,
    main.cpp:211-217);
  - the hot string parsing has a C++/OpenMP implementation
    (io/native/pileup_core.cpp) with this module as its oracle.

This module is the slow-but-exact NumPy implementation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C
from ..config import PileupFeatureConfig

# channel lookup for single mpileup chars
_CHAR_CH = {c: C.CH[c] for c in "ACGT*#acgt"}
_NORMAL = set("ACGTNacgtn*#")
_FWD = set("ACGTN*")


def make_tensor_row(
    bases: str,
    chr_seq: np.ndarray,
    pos1: int,
    snp_min_af: float,
    indel_min_af: float,
    max_indel_size: int = C.MAX_INDEL_SIZE,
) -> Tuple[np.ndarray, Dict[str, int], int, float, bool, int]:
    """Parse one mpileup base string into (counts[18], alt_dict, depth, af,
    pass_af, max_del_length). 1:1 with TensorMaker::make_tensor."""
    raw_ref = chr(chr_seq[pos1 - 1]) if pos1 - 1 < len(chr_seq) else "N"
    # evc_base_from: non-ACGT ref treated as 'A'/'a' preserving case
    if C.NT4_TABLE[ord(raw_ref)] < 4:
        chr_base = raw_ref.upper()
        chr_base_lower = raw_ref.lower()
    else:
        chr_base = "A"
        chr_base_lower = "a"

    cov_stats: Dict[str, int] = {}
    i, n = 0, len(bases)
    while i < n:
        b = bases[i]
        if b in "+-":
            i += 1
            adv = 0
            while i < n and bases[i].isdigit():
                adv = adv * 10 + ord(bases[i]) - 48
                i += 1
            if adv <= max_indel_size:
                key = b + bases[i: i + adv]
                cov_stats[key] = cov_stats.get(key, 0) + 1
            i += adv - 1
        elif b in _NORMAL:
            cov_stats[b] = cov_stats.get(b, 0) + 1
        elif b == "^":
            i += 1
        i += 1

    counts = np.zeros(C.NUM_CHANNELS, dtype=np.int64)
    depth = 0
    max_del_length = 0
    max_ins = [0, 0]
    max_del = [0, 0]
    alt_dict: Dict[str, int] = {}
    pileup_dict: Dict[str, int] = {}

    for key in sorted(cov_stats):  # std::map iteration order
        count = cov_stats[key]
        if key[0] == "+":
            alt_key = "I" + chr_base + key[1:].upper()
            alt_dict[alt_key] = alt_dict.get(alt_key, 0) + count
            pileup_dict["I"] = pileup_dict.get("I", 0) + count
            if key[1] in _FWD:
                counts[C.CH["I"]] += count
                max_ins[0] = max(max_ins[0], count)
            else:
                counts[C.CH["i"]] += count
                max_ins[1] = max(max_ins[1], count)
        elif key[0] == "-":
            dlen = len(key) - 1
            # deleted reference bases, case preserved (tensor_maker.cpp:151);
            # past-contig-end reads (UB in the reference) are defined as 'N'
            del_base = chr_seq[pos1: pos1 + dlen].tobytes().decode()
            if len(del_base) < dlen:
                del_base += "N" * (dlen - len(del_base))
            alt_key = "D" + del_base
            alt_dict[alt_key] = alt_dict.get(alt_key, 0) + count
            pileup_dict["D"] = pileup_dict.get("D", 0) + count
            max_del_length = max(max_del_length, dlen)
            if key[1] in _FWD:
                counts[C.CH["D"]] += count
                max_del[0] = max(max_del[0], count)
            else:
                counts[C.CH["d"]] += count
                max_del[1] = max(max_del[1], count)
        else:
            if C.NT4_TABLE[ord(key)] < 4:
                up = key.upper()
                pileup_dict[up] = pileup_dict.get(up, 0) + count
                depth += count
                if up != chr_base:
                    alt_dict["X" + up] = alt_dict.get("X" + up, 0) + count
                counts[_CHAR_CH[key]] += count
            elif key == "*":
                counts[C.CH["*"]] += count
                depth += count
            elif key == "#":
                counts[C.CH["#"]] += count
                depth += count

    counts[C.CH["I1"]] = max_ins[0]
    counts[C.CH["i1"]] = max_ins[1]
    counts[C.CH["D1"]] = max_del[0]
    counts[C.CH["d1"]] = max_del[1]

    denom = depth if depth else 1
    # stable sort by count desc over map-key order == the reference's
    # insertion-sorted small vector (tensor_maker.cpp:198)
    pileup_list = sorted(pileup_dict.items(), key=lambda kv: -kv[1])

    pass_af = bool(pileup_list) and pileup_list[0][0][0] != chr_base
    pass_snp = False
    pass_indel = False
    for item, count in pileup_list:
        if item == chr_base:
            continue
        if item in ("I", "D"):
            pass_indel = pass_indel or (count / denom >= indel_min_af)
            continue
        pass_snp = pass_snp or (count / denom >= snp_min_af)

    af = (pileup_list[1][1] / denom) if len(pileup_list) > 1 else 0.0
    if pileup_list and pileup_list[0][0][0] != chr_base:
        af = pileup_list[0][1] / denom

    # reference-base negation trick (tensor_maker.cpp:230-246)
    fwd_sum = int(counts[C.ACGT_FWD_CH].sum())
    counts[C.CH[chr_base]] = -fwd_sum
    rev_sum = int(counts[C.ACGT_REV_CH].sum())
    counts[C.CH[chr_base_lower]] = -rev_sum

    pass_af = pass_af or pass_snp or pass_indel
    return counts, alt_dict, depth, af, pass_af, max_del_length


@dataclass
class ChromPileup:
    """Per-position parse results for one chromosome (rows in file order)."""
    chrom: str
    positions: np.ndarray          # [P] int64, 1-based, strictly increasing
    counts: np.ndarray             # [P, 18] int32 (after ref-negation)
    depths: np.ndarray             # [P] int32
    is_candidate: np.ndarray       # [P] bool
    alt_info: List[str]            # [P]; "" for non-candidates; "key cnt " pairs
    afs: np.ndarray                # [P] float64


def parse_mpileup_text(
    lines: Iterable[str],
    chrom: str,
    chr_seq: np.ndarray,
    cfg: Optional[PileupFeatureConfig] = None,
    bed_mask: Optional[np.ndarray] = None,
    confident_mask: Optional[np.ndarray] = None,
) -> ChromPileup:
    """Parse mpileup rows of one chromosome (NumPy oracle path).

    bed_mask / confident_mask: optional bool arrays over the contig
    (0-based); bed_mask drops rows entirely (extended bed), confident_mask
    gates candidacy over [pos-1, pos+max_del+1) like
    BedIntvList::region_intersect_with_bed_intv (main.cpp:165,194).
    """
    cfg = cfg or PileupFeatureConfig()
    positions: List[int] = []
    counts_l: List[np.ndarray] = []
    depths: List[int] = []
    cand: List[bool] = []
    alt_infos: List[str] = []
    afs: List[float] = []

    for line in lines:
        if not line:
            continue
        cols = line.rstrip("\n").split("\t")
        pos1 = int(cols[1])
        if bed_mask is not None and not bed_mask[pos1 - 1]:
            continue
        bases = cols[4]
        counts, alt_dict, depth, af, pass_af, max_del = make_tensor_row(
            bases, chr_seq, pos1, cfg.snp_min_af, cfg.indel_min_af,
            cfg.max_indel_size)
        ref_base = chr(chr_seq[pos1 - 1]).upper()
        ok_bed = True
        if confident_mask is not None:
            lo = pos1 - 1
            hi = min(pos1 + max_del + 1, len(confident_mask))
            ok_bed = bool(confident_mask[lo:hi].any())
        is_cand = (ok_bed and C.NT4_TABLE[ord(ref_base)] < 4 and pass_af
                   and depth >= cfg.min_depth)
        positions.append(pos1)
        counts_l.append(counts)
        depths.append(depth)
        cand.append(is_cand)
        afs.append(af)
        alt_infos.append(
            "".join(f"{k} {v} " for k, v in sorted(alt_dict.items())) if is_cand else "")

    return ChromPileup(
        chrom=chrom,
        positions=np.asarray(positions, dtype=np.int64),
        counts=(np.stack(counts_l).astype(np.int32) if counts_l
                else np.zeros((0, 18), np.int32)),
        depths=np.asarray(depths, dtype=np.int32),
        is_candidate=np.asarray(cand, dtype=bool),
        alt_info=alt_infos,
        afs=np.asarray(afs, dtype=np.float64),
    )


class CandidateBatch:
    """Emitted candidate windows for one chromosome.

    Storage is COLUMNAR: adjacent candidates' 33-wide windows share most of
    their position columns (at typical candidate density the dense
    [N,33,18] tensor is ~3x redundant), so the batch holds the union of
    window columns once (`columns` [M,18]) plus each candidate's center
    offset into it (`cand_off`). Every candidate's window is the contiguous
    slice columns[off-flank : off+flank+1] — guaranteed by construction
    (union of contiguous index intervals stays contiguous per interval).
    `.matrix` materializes the dense [N, 2*flank+1, 18] view on first use
    for consumers that need it (training, HDF5 interop, text serializers);
    the hot paths (shard IO, s2 device feed) use the columns directly and
    never pay the 33x gather."""

    def __init__(self, chrom, positions, matrix=None, ref_seqs=None,
                 alt_info=None, depths=None, *, columns=None, cand_off=None,
                 flank: int = C.FLANKING_BASES):
        self.chrom = chrom
        self.positions = positions    # [N] int64 candidate centers (1-based)
        self.ref_seqs = ref_seqs      # [N] S33 bytes (case preserved)
        self.alt_info = alt_info      # "depth-key cnt key cnt " strings
        self.depths = depths          # [N] int32
        self.columns = columns        # [M, 18] int16 union window columns
        self.cand_off = cand_off      # [N] int64 center offsets into columns
        self.flank = flank
        self._matrix = matrix
        if matrix is None and columns is None:
            raise ValueError("CandidateBatch needs matrix or columns")

    @property
    def matrix(self) -> np.ndarray:
        """Dense [N, 2*flank+1, 18] windows (materialized lazily)."""
        if self._matrix is None:
            gather = self.cand_off[:, None] + np.arange(
                -self.flank, self.flank + 1)[None, :]
            self._matrix = self.columns[gather]
        return self._matrix

    @property
    def center_counts(self) -> np.ndarray:
        """[N, 18] center-column counts without materializing windows."""
        if self._matrix is not None:
            return self._matrix[:, self._matrix.shape[1] // 2, :]
        if getattr(self, "_centers", None) is None:
            self._centers = self.columns[self.cand_off]
        return self._centers

    def __len__(self):
        return len(self.positions)


def assemble_windows(
    pile: ChromPileup,
    chr_seq: np.ndarray,
    flank: int = C.FLANKING_BASES,
    emit_lo: Optional[int] = None,
    emit_hi: Optional[int] = None,
) -> CandidateBatch:
    """Vectorized window emission (equivalent of the reference ring buffer).

    emit_lo/emit_hi filter the emitted centers to (emit_lo, emit_hi]
    BEFORE the window gather — chunked callers (overlapped text units,
    BAM regions) previously gathered the full [N,33,18] matrix and then
    copied a boolean slice of it, doubling the largest allocation in s1."""
    window = 2 * flank + 1
    p = pile.positions
    n = len(p)
    idx = np.flatnonzero(pile.is_candidate)
    if n >= window and len(idx):
        ok = (idx >= flank) & (idx + flank < n)
        sel = idx[ok]
        contiguous = (p[sel + flank] - p[sel - flank]) == (window - 1)
        sel = sel[contiguous]
    else:
        sel = np.zeros(0, dtype=np.int64)
    if emit_lo is not None and len(sel):
        sel = sel[p[sel] > emit_lo]
    if emit_hi is not None and len(sel):
        sel = sel[p[sel] <= emit_hi]

    if len(sel) == 0:
        return CandidateBatch(pile.chrom, np.zeros(0, np.int64),
                              ref_seqs=np.zeros(0, dtype=f"S{window}"),
                              alt_info=[], depths=np.zeros(0, np.int32),
                              columns=np.zeros((0, 18), np.int16),
                              cand_off=np.zeros(0, np.int64), flank=flank)

    # union coverage of all window intervals [sel-flank, sel+flank] over the
    # parse rows, as a diff array -> compacted column store. |count| <=
    # 4*max_depth(144) = 576 after ref-negation, so int16 is lossless.
    cover = np.zeros(n + 1, dtype=np.int32)
    np.add.at(cover, sel - flank, 1)
    np.add.at(cover, sel + flank + 1, -1)
    mask = np.cumsum(cover[:-1]) > 0                   # [n] rows kept
    compact = np.cumsum(mask, dtype=np.int64) - 1      # orig row -> column
    columns = pile.counts[mask]
    if columns.dtype != np.int16:
        columns = columns.astype(np.int16)
    cand_off = compact[sel]
    centers = p[sel]
    # window reference strings as one vectorized gather + S-view (bounds
    # are guaranteed: the contiguity check proves positions c-flank..c+flank
    # exist, and positions are 1-based in [1, len(chr_seq)])
    win = (centers - 1 - flank)[:, None] + np.arange(window)[None, :]
    ref_seqs = np.ascontiguousarray(chr_seq[win]).view(f"S{window}").ravel()
    alt_info = [f"{pile.depths[i]}-{pile.alt_info[i]}" for i in sel]
    return CandidateBatch(pile.chrom, centers, ref_seqs=ref_seqs,
                          alt_info=alt_info,
                          depths=pile.depths[sel].astype(np.int32),
                          columns=columns, cand_off=cand_off, flank=flank)


def tensor_lines(batch: CandidateBatch) -> List[str]:
    """Serialize a CandidateBatch in the reference `.tensor` text format
    (main.cpp:246-251) for differential testing."""
    out = []
    for i in range(len(batch)):
        tensor_info = "".join(
            f"{v} " for v in batch.matrix[i].reshape(-1))
        rs = batch.ref_seqs[i]
        rs = rs.decode() if isinstance(rs, bytes) else rs
        out.append(
            f"{batch.chrom}\t{batch.positions[i]}\t{rs}\t"
            f"{tensor_info}\t{batch.alt_info[i]}")
    return out


def predict_inputs(batch: CandidateBatch) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Filter to ACGT-centered candidates and return model inputs, mirroring
    DNA_CreatePredictData (make_predict_data/main.cpp:92: rows whose 33-mer
    center is not ACGT are dropped; ref_seq uppercased).

    Returns (matrix [M,33,18] int16, positions [M] int64,
    ref_seqs [M] S-window uppercased bytes).
    """
    rs = np.asarray(batch.ref_seqs, dtype="S")
    n = len(rs)
    if n == 0:
        return (np.zeros((0, 33, 18), np.int16), np.zeros(0, np.int64),
                np.zeros(0, dtype="S33"))
    width = rs.dtype.itemsize
    refs_u = np.char.upper(rs)
    if width > 16:
        u8 = refs_u.view(np.uint8).reshape(n, width)
        center = u8[:, 16]
        keep = ((center == ord("A")) | (center == ord("C"))
                | (center == ord("G")) | (center == ord("T")))
        # short (truncated) windows pad with NULs; a NUL at byte 16 means
        # the string ended early — already excluded by the letter check
    else:
        keep = np.zeros(n, dtype=bool)
    keep = np.flatnonzero(keep)
    if len(keep) == 0:
        return (np.zeros((0, 33, 18), np.int16), np.zeros(0, np.int64),
                np.zeros(0, dtype=rs.dtype))
    return batch.matrix[keep], batch.positions[keep], refs_u[keep]


def predict_batch(batch: CandidateBatch) -> CandidateBatch:
    """`predict_inputs` semantics (drop non-ACGT centers, uppercase the
    window strings — make_predict_data/main.cpp:92) on the COLUMNAR
    storage: filters the per-candidate arrays without materializing the
    dense window tensor. Unreferenced columns are kept (harmless; they
    compress away)."""
    rs = np.asarray(batch.ref_seqs, dtype="S")
    n = len(rs)
    width = rs.dtype.itemsize if n else 0
    if n == 0 or width <= batch.flank:
        return CandidateBatch(
            batch.chrom, np.zeros(0, np.int64),
            ref_seqs=np.zeros(0, dtype=f"S{2 * batch.flank + 1}"),
            alt_info=[], depths=np.zeros(0, np.int32),
            columns=batch.columns, cand_off=np.zeros(0, np.int64),
            flank=batch.flank)
    refs_u = np.char.upper(rs)
    u8 = refs_u.view(np.uint8).reshape(n, width)
    center = u8[:, batch.flank]
    keep = np.flatnonzero(
        (center == ord("A")) | (center == ord("C"))
        | (center == ord("G")) | (center == ord("T")))
    return CandidateBatch(
        batch.chrom, batch.positions[keep], ref_seqs=refs_u[keep],
        alt_info=[batch.alt_info[i] for i in keep],
        depths=batch.depths[keep], columns=batch.columns,
        cand_off=batch.cand_off[keep], flank=batch.flank)
