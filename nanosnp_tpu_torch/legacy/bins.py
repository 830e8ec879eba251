"""Legacy .bin (HDF5) schema interop, and `build_legacy_bins`, which writes
the bins per contig.

The reference's make_predict_groups.py:232-283 writes one PyTables file
per contig with edge/pair-route matrices, per-group read matrices at the
het columns, the 11-mer surrounding matrices, and string position/column
tables. We emit the same dataset names and shapes via h5py (the schema is
plain HDF5; PyTables metadata is not required to read it back with
pytables-free tooling, and our reader accepts files written by either
stack).

A path ending in `.npz` holds the same datasets, under the same names,
shapes and types, in a numpy archive: h5py is an optional dependency, and
a machine without it can still write and read legacy bins that way.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .edges import legacy_group_arrays, pad_depth

_STR_KEYS = ("position", "edge_columns", "pair_columns", "group_positions")
_MAT_KEYS = ("edge_matrix", "pair_route", "read_matrix",
             "base_quality_matrix", "mapping_quality_matrix",
             "surrounding_read_matrix", "surrounding_base_quality_matrix",
             "surrounding_mapping_quality_matrix")


def _datasets(arrays: Dict[str, List]) -> Dict[str, np.ndarray]:
    """The bin's datasets from legacy_group_arrays output."""
    n = len(arrays["position"])
    adj2 = arrays["edge_matrix"][0].shape[1] if n else 10
    max_depth = max((a.shape[0] for a in arrays["read_matrix"]), default=1)
    max_sur = max((a.shape[0] for a in arrays["surrounding_read_matrix"]),
                  default=1)
    str_len = 30 * adj2
    out: Dict[str, np.ndarray] = {}
    for key in ("edge_matrix", "pair_route"):
        out[key] = np.stack(arrays[key]).astype(np.int32) if n else \
            np.zeros((0, 25, adj2), np.int32)
    for key, cap in (("read_matrix", max_depth),
                     ("base_quality_matrix", max_depth),
                     ("mapping_quality_matrix", max_depth),
                     ("surrounding_read_matrix", max_sur),
                     ("surrounding_base_quality_matrix", max_sur),
                     ("surrounding_mapping_quality_matrix", max_sur)):
        out[key] = pad_depth(arrays[key], cap)
    out["position"] = np.array(arrays["position"],
                               dtype=f"S{str_len}").reshape(n, 1)
    out["group_positions"] = np.stack(arrays["group_positions"]).astype(
        f"S{str_len}") if n else np.zeros((0, adj2 + 1), f"S{str_len}")
    # edge/pair column labels are derivable from group_positions; the
    # reference stores them as strings: reproduce for readability
    ec, pc = [], []
    for g in arrays["group_positions"]:
        pos = [p.split(":")[1] for p in g]
        ctg = g[0].split(":")[0]
        ec.append([f"{ctg}:{pos[i]}-{pos[i + 1]}"
                   for i in range(len(pos) - 1)])
        c = len(pos) // 2
        pc.append([f"{ctg}:{pos[i]}-{pos[c]}"
                   for i in range(len(pos)) if i != c])
    for key, rows in (("edge_columns", ec), ("pair_columns", pc)):
        out[key] = np.array(rows, dtype=f"S{str_len}") if n else \
            np.zeros((0, adj2), f"S{str_len}")
    return out


def save_legacy_bin(path: str, arrays: Dict[str, List]) -> int:
    """Write one contig's legacy bin from legacy_group_arrays output: HDF5
    (the reference's container), or a numpy archive for a `.npz` path.
    Returns the number of groups written."""
    data = _datasets(arrays)
    if path.endswith(".npz"):
        with open(path, "wb") as f:
            np.savez(f, **data)
    else:
        import h5py

        with h5py.File(path, "w") as f:
            for key, value in data.items():
                f.create_dataset(key, data=value)
    return len(arrays["position"])


def load_legacy_bin(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path) as z:
            raw = {key: z[key] for key in _MAT_KEYS + _STR_KEYS}
    else:
        import h5py

        with h5py.File(path, "r") as f:
            raw = {key: np.asarray(f[key]) for key in _MAT_KEYS + _STR_KEYS}
    out: Dict[str, np.ndarray] = {key: raw[key] for key in _MAT_KEYS}
    for key in _STR_KEYS:
        out[key] = np.char.decode(raw[key].astype("S"), "utf-8")
    out["position"] = out["position"].reshape(-1)
    return out


def build_legacy_bins(
    pileup_vcf: str,
    bam_paths: Dict[str, str],
    out_dir: str,
    max_coverage: int = 150,
    quality_threshold: float = 15.0,
    support_quality: float = 19.0,
    adjacent_size: int = 5,
    contigs: Optional[List[str]] = None,
    suffix: str = ".bin",
) -> Dict[str, int]:
    """make_predict_groups.py Run(): pileup VCF -> groups -> per-contig
    legacy bins. bam_paths maps contig -> BAM (a per-HP-tag split BAM in
    the legacy dual-bin flow, or any haplotagged/plain BAM). `suffix`
    ".bin" writes HDF5 (needs h5py), ".npz" the numpy archive."""
    from ..features.haplotype import build_groups, collect_sites
    from ..runtime.extract import NativeBamExtractor

    os.makedirs(out_dir, exist_ok=True)
    with open(pileup_vcf) as fh:
        sites = collect_sites(fh, quality_threshold=quality_threshold)
    extractor = NativeBamExtractor(bam_paths, max_coverage=max_coverage)
    written: Dict[str, int] = {}
    try:
        for ctg, cs in sorted(sites.items()):
            if contigs and ctg not in contigs:
                continue
            if ctg not in bam_paths:
                continue
            groups = build_groups(cs, adjacent_size=adjacent_size,
                                  quality_threshold=quality_threshold,
                                  support_quality=support_quality)
            if len(groups) == 0:
                continue
            arrays = legacy_group_arrays(extractor, ctg, groups)
            if arrays is None or not arrays["position"]:
                continue
            written[ctg] = save_legacy_bin(
                os.path.join(out_dir, f"{ctg}{suffix}"), arrays)
    finally:
        extractor.close()
    return written
