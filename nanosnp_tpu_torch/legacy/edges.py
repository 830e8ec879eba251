"""Edge-transition / pair-route features for the legacy cat-model path.

The reference builds, per candidate group of 2*adjacent_size+1 sites, a
25 x (2*adjacent_size) count matrix over the base alphabet {A,C,G,T,D} for
(a) transitions between adjacent group sites and (b) routes from every
site to the group center, by iterating pandas rows edge by edge
(extract_adjacent_pileup.py:219-258). Here both are one vectorized
scatter-add over the read matrix.

Base codes follow the native engine: 0 absent, 1-4 = A,C,G,T, -1 deletion,
-2 pad. Edge alphabet index: A=0, C=1, G=2, T=3, D=4; a 25-row matrix is
indexed source*5 + target, matching the reference's
product('ACGTD','ACGTD') label order.
"""
from __future__ import annotations

from itertools import product
from typing import Dict, List, Optional

import numpy as np

EDGE_LABELS = ["".join(p) for p in product("ACGTD", "ACGTD")]


def _alphabet_index(codes: np.ndarray) -> np.ndarray:
    """Map native base codes to {A..D} = 0..4; absent/pad cells -> -1."""
    idx = np.full(codes.shape, -1, dtype=np.int64)
    valid = (codes >= 1) & (codes <= 4)
    idx[valid] = codes[valid] - 1
    idx[codes == -1] = 4
    return idx


def edge_transition_counts(reads: np.ndarray) -> np.ndarray:
    """reads [R, P] base codes -> [25, P-1] adjacent-transition counts.

    A read contributes to link j when it has an observation (base or
    deletion) at both position j and j+1 (extract_adjacent_pileup.py:223-234
    skips rows where either endpoint is 0)."""
    reads = np.asarray(reads)
    if reads.size == 0:
        return np.zeros((25, max(reads.shape[1] - 1, 0)), dtype=np.int64)
    s = _alphabet_index(reads[:, :-1])
    t = _alphabet_index(reads[:, 1:])
    valid = (s >= 0) & (t >= 0)
    out = np.zeros((25, reads.shape[1] - 1), dtype=np.int64)
    cols = np.broadcast_to(np.arange(reads.shape[1] - 1), s.shape)
    np.add.at(out, (s[valid] * 5 + t[valid], cols[valid]), 1)
    return out


def pair_route_counts(reads: np.ndarray) -> np.ndarray:
    """reads [R, P] -> [25, P-1] routes site->center.

    Column order follows the reference's pair_columns: ascending site
    order with the center skipped (extract_adjacent_pileup.py:237-258);
    the source is always the outer site, the target the center base."""
    reads = np.asarray(reads)
    if reads.size == 0:
        return np.zeros((25, max(reads.shape[1] - 1, 0)), dtype=np.int64)
    p = reads.shape[1]
    center = p // 2
    keep = [j for j in range(p) if j != center]
    s = _alphabet_index(reads[:, keep])
    t = _alphabet_index(reads[:, center])[:, None]
    valid = (s >= 0) & (t >= 0)
    out = np.zeros((25, p - 1), dtype=np.int64)
    cols = np.broadcast_to(np.arange(p - 1), s.shape)
    tt = np.broadcast_to(t, s.shape)
    np.add.at(out, (s[valid] * 5 + tt[valid], cols[valid]), 1)
    return out


def legacy_group_arrays(
    extractor,
    contig: str,
    groups: np.ndarray,
    *,
    surrounding_flank: int = 5,
) -> Optional[Dict[str, List[np.ndarray]]]:
    """Per-group legacy feature set from the native extractor.

    Reuses runtime.extract.NativeBamExtractor (one BAM sweep, coverage
    precheck, center-covering row filter) with flank=surrounding_flank so
    the "pileup" view is the legacy 11-mer surrounding window
    (extract_adjacent_pileup.py:276-293). Returns per-group lists:
    read/baseq/mapq at the group's het columns, surrounding_* at the
    11-mer, and the edge/pair-route count matrices, plus the group
    centers/positions actually kept."""
    mats = extractor(contig, groups, surrounding_flank)
    if mats is None:
        return None
    hap_view = mats["haplotype"]
    sur_view = mats["pileup"]
    # the extractor drops coverage-failed groups internally; recover the
    # kept groups by matching counts (it preserves order)
    kept_groups = mats.get("groups")
    if kept_groups is None and len(hap_view) != len(groups):
        raise RuntimeError(
            "extractor dropped groups but did not report which; "
            "need extractor result key 'groups'")
    if kept_groups is None:
        kept_groups = groups
    out: Dict[str, List[np.ndarray]] = {
        "position": [], "group_positions": [],
        "read_matrix": [], "base_quality_matrix": [],
        "mapping_quality_matrix": [],
        "surrounding_read_matrix": [],
        "surrounding_base_quality_matrix": [],
        "surrounding_mapping_quality_matrix": [],
        "edge_matrix": [], "pair_route": [],
    }
    for g, hv, sv in zip(kept_groups, hap_view, sur_view):
        center = int(g[len(g) // 2])
        out["position"].append(f"{contig}:{center}")
        out["group_positions"].append(
            np.array([f"{contig}:{int(p)}" for p in g]))
        out["read_matrix"].append(hv["sequences"])
        out["base_quality_matrix"].append(hv["baseq"])
        out["mapping_quality_matrix"].append(hv["mapq"])
        out["surrounding_read_matrix"].append(sv["sequences"])
        out["surrounding_base_quality_matrix"].append(sv["baseq"])
        out["surrounding_mapping_quality_matrix"].append(sv["mapq"])
        out["edge_matrix"].append(edge_transition_counts(hv["sequences"]))
        out["pair_route"].append(pair_route_counts(hv["sequences"]))
    return out


def pad_depth(mats: List[np.ndarray], max_depth: int,
              fill: int = -2) -> np.ndarray:
    """Stack ragged [depth_i, P] matrices to [N, max_depth, P], padding
    missing rows with `fill` (the reference pads to the contig max and the
    dataset later truncates to its own cap; make_predict_groups.py:198-233).
    Rows beyond max_depth are truncated (first rows kept, like the
    dataset's [:max_depth])."""
    if not mats:
        return np.zeros((0, max_depth, 0), dtype=np.int32)
    p = mats[0].shape[1]
    out = np.full((len(mats), max_depth, p), fill, dtype=np.int32)
    for i, m in enumerate(mats):
        d = min(m.shape[0], max_depth)
        out[i, :d] = m[:d]
    return out
