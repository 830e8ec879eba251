"""Label-noise filter for legacy cat-model train bins.

Mirrors the reference's `HaplotypeModel/filter_catmodel_label.py:17-26,
221-247`: per tag, compute the A/C/G/T/D fraction of reads at one column
of the het read matrix; where BOTH tags reach a >=0.70 consensus, derive
the implied 15-class unordered-pair label (`cal_label`,
filter_catmodel_label.py:29-60) and flag sites whose stored truth label
disagrees — these are presumed phasing/truth errors and get dropped from
training.

Quirk note: the reference hardcodes column index **2** of the het matrix
(`g1_tag1_base_percentage[2]`, filter_catmodel_label.py:233-238) rather
than the center column (adjacent_size). `consensus_label_mismatches`
takes the column as a parameter; callers pass 2 for bit-parity with the
reference tool or the true center for the semantically-intended check.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .train import cal_label

# cal_label as a dense [5,5] table for vectorized lookup; -1 marks pairs
# the reference's if-chain falls through (never happens for argmax in 0..4)
_CAL_TABLE = np.full((5, 5), -1, dtype=np.int64)
for _a in range(5):
    for _b in range(5):
        _v = cal_label(_a, _b)
        if _v is not None:
            _CAL_TABLE[_a, _b] = _v


def column_base_fractions(read: np.ndarray, col: int,
                          pad: int = -2) -> np.ndarray:
    """read [N, D, L] base codes (A1 C2 G3 T4, del -1, absent 0, pad -2)
    -> [N, 5] fraction of non-pad reads showing A/C/G/T/D at `col`
    (filter_catmodel_label.py:17-26: denominator counts != -2 entries,
    + 1e-9)."""
    c = read[:, :, col]
    denom = (c != pad).sum(axis=1) + 1e-9
    fracs = [(c == v).sum(axis=1) / denom for v in (1, 2, 3, 4, -1)]
    return np.stack(fracs, axis=1)


def consensus_label_mismatches(
    read_tag1: np.ndarray,
    read_tag2: np.ndarray,
    gt_label: np.ndarray,
    col: int,
    threshold: float = 0.70,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (checked, mismatch) bool masks over sites: `checked` where
    both tags reach the consensus threshold at `col`, `mismatch` where the
    consensus-implied pair label differs from `gt_label` (the rows the
    reference writes to its output file and drops,
    filter_catmodel_label.py:239-247)."""
    f1 = column_base_fractions(read_tag1, col)
    f2 = column_base_fractions(read_tag2, col)
    a1, m1 = f1.argmax(axis=1), f1.max(axis=1)
    a2, m2 = f2.argmax(axis=1), f2.max(axis=1)
    checked = (m1 >= threshold) & (m2 >= threshold)
    implied = _CAL_TABLE[a1, a2]
    mismatch = checked & (implied != np.asarray(gt_label))
    return checked, mismatch
