"""Candidate windows of one chromosome: `CandidateBatch`, copied from
nanosnp_tpu/features/pileup.py (numpy only) for the training-data code.
The s1 featurization that builds it belongs to the host stages, which are
not ported yet."""
from __future__ import annotations

import numpy as np

from .. import constants as C


class CandidateBatch:
    """Emitted candidate windows for one chromosome.

    Storage is COLUMNAR: adjacent candidates' 33-wide windows share most of
    their position columns, so the batch holds the union of window columns
    once (`columns` [M,18]) plus each candidate's center offset into it
    (`cand_off`). Every candidate's window is the contiguous slice
    columns[off-flank : off+flank+1]. `.matrix` materializes the dense
    [N, 2*flank+1, 18] view on first use."""

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

    def __len__(self) -> int:
        return len(self.positions)
