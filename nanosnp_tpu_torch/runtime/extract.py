"""Native read-matrix extraction for the haplotype stage (s4).

NativeBamExtractor reproduces the reference's pysam extraction
(create_pileup_haplotype.py:23-216) on top of the native BAM engine:

  - coverage precheck: any group touching a position with coverage above
    max_coverage is dropped (:39-60);
  - one read-matrix sweep over the union of candidate windows and het
    positions (:74-134);
  - per group: slice the 11 het columns and the 33-window columns, keep
    reads covering the center, sort rows by the HP tag at the center column
    (:144-200). Sorting here is a stable argsort (pandas sort_values is
    unstable for ties; row order only matters at depth-cap truncation, and
    the downstream statistics are order-invariant).

Divergences from the reference (documented, both strictly better):
  - a non-ACGT read base leaves a 0 cell instead of poisoning the whole
    chunk via a swallowed KeyError (create_pileup_haplotype.py:122,213);
  - the coverage precheck counts base/del-covering reads (pysam's column.n
    also counts refskip reads, absent in ONT data).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .. import constants as C
from ..io.bam import BamFile, PYSAM_EXCL_FLAGS


class NativeBamExtractor:
    """ReadMatrixExtractor over per-contig haplotagged BAMs
    (stage_haplotype_features signature: (contig, groups, flank) -> mats)."""

    def __init__(self, bam_dir_or_paths, max_coverage: int = C.MAX_COVERAGE,
                 hp_overrides=None, nbase_chunk_drop: bool = False):
        # bam_dir_or_paths: directory with {contig}.bam, or {contig: path}
        # hp_overrides: {contig: {read_id: 1|2}} from the native phaser —
        # replaces BAM HP tags so no tagged-BAM round trip is needed
        # nbase_chunk_drop: bug-compat mode — drop the whole chunk when any
        # read carries a non-ACGT base at a requested position, replicating
        # the reference's swallowed base_to_int KeyError
        # (create_pileup_haplotype.py:122,213); default keeps the sites
        import threading

        self.max_coverage = max_coverage
        self.hp_overrides = hp_overrides or {}
        self.nbase_chunk_drop = nbase_chunk_drop
        self._open_lock = threading.Lock()
        if isinstance(bam_dir_or_paths, dict):
            self.paths = dict(bam_dir_or_paths)
        else:
            import os

            self.paths = {}
            if os.path.isdir(bam_dir_or_paths):
                for f in os.listdir(bam_dir_or_paths):
                    if f.endswith(".bam"):
                        self.paths[f[:-4]] = os.path.join(bam_dir_or_paths, f)
        self._open: Dict[str, BamFile] = {}

    def _bam(self, contig: str) -> Optional[BamFile]:
        if contig not in self.paths:
            return None
        with self._open_lock:   # callers run chunk-parallel (stages.py s4)
            if contig not in self._open:
                self._open[contig] = BamFile(self.paths[contig])
            return self._open[contig]

    def close(self):
        for b in self._open.values():
            b.close()
        self._open.clear()

    def __call__(self, contig: str, groups: np.ndarray, flank: int,
                 packed: bool = False
                 ) -> Optional[Dict[str, object]]:
        """packed=False (legacy contract): per-group lists of [d_g, L]
        matrices. packed=True (s4 hot path): one [G, D, L] array per key
        per view, depth-padded with -2, plus per-group depths — produced
        by BATCHED numpy gathers. The original per-group python loop
        (~15 small fancy-index ops x G) held the GIL long enough that s4's
        thread fan-out anti-scaled (4 threads ran 1.5x SLOWER than 1)."""
        bam = self._bam(contig)
        if bam is None or len(groups) == 0:
            return None

        # ONE sweep over the union of all needed positions; the coverage
        # precheck (create_pileup_haplotype.py:39-60) reads its counts off
        # the same matrices instead of a second BAM pass
        centers = groups[:, groups.shape[1] // 2]
        ext = set()
        for g in groups:
            ext.update(int(p) for p in g)
        for c in centers:
            ext.update(range(int(c) - flank, int(c) + flank + 1))
        ext_positions = np.array(sorted(ext), dtype=np.int64)
        mats = bam.read_matrices(contig, ext_positions,
                                 excl_flags=PYSAM_EXCL_FLAGS,
                                 max_reads=8192)
        if mats is None:
            return None
        if self.nbase_chunk_drop and mats.get("n_nonacgt", 0) > 0:
            return None

        group_pos = np.unique(groups.reshape(-1))
        gp_cols = np.searchsorted(ext_positions, group_pos)
        coverage = (mats["sequences"][:, gp_cols] != 0).sum(axis=0)
        failed = set(int(p) for p in group_pos[coverage > self.max_coverage])
        if failed:
            keep = [i for i in range(len(groups))
                    if not any(int(p) in failed for p in groups[i])]
            groups = groups[keep]
            if len(groups) == 0:
                return None
        seqm = mats["sequences"]
        bqm = mats["baseq"]
        mqm = mats["mapq"]
        hap_tag = mats["hap_tags"]
        over = self.hp_overrides.get(contig)
        if over is not None:
            o_ids, o_hp = self._override_arrays(contig, over)
            rids = mats["read_ids"]
            idx = np.searchsorted(o_ids, rids)
            idx_c = np.minimum(idx, len(o_ids) - 1) if len(o_ids) else idx
            hit = (idx < len(o_ids)) & (o_ids[idx_c] == rids) \
                if len(o_ids) else np.zeros(len(rids), bool)
            hap_tag = np.where(hit, o_hp[idx_c] if len(o_ids) else 3,
                               3).astype(np.int32)

        from ..io import bins as _bins

        adj = groups.shape[1]
        g_count = len(groups)
        # column tables: every group/window position is in ext_positions by
        # construction, so searchsorted is an exact lookup
        ch = np.searchsorted(ext_positions, groups)                # [G, adj]
        centers2 = groups[:, adj // 2].astype(np.int64)
        cp = np.searchsorted(
            ext_positions,
            centers2[:, None] + np.arange(-flank, flank + 1)[None, :])
        cmid = ch[:, adj // 2]                                     # [G]
        cover = seqm[:, cmid] != 0                                 # [R, G]
        depths = cover.sum(axis=0).astype(np.int64)                # [G]
        # HP-stable row order per group: covering reads sorted by tag
        # (ties keep BAM order — the reference sorts after its row filter,
        # create_pileup_haplotype.py:158-165), non-covering pushed last
        key = np.where(cover, hap_tag[:, None], np.int32(127))
        order = np.argsort(key, axis=0, kind="stable")             # [R, G]
        d_max = max(int(depths.max()) if g_count else 0, 1)
        rows_t = order[:d_max].T                                   # [G, D]
        valid = np.take_along_axis(cover, order[:d_max], axis=0).T  # [G, D]
        hp_rows = hap_tag[rows_t]                                  # [G, D]

        def gather_view(cols):
            vm = valid[:, :, None]
            sq = np.where(vm, seqm[rows_t[:, :, None], cols[:, None, :]],
                          C.PAD_VALUE)
            # hap: tag at covered cells, 0 elsewhere
            # (create_pileup_haplotype.py:124,132); -2 on pad rows
            hap = np.where(vm, np.where(sq != 0, hp_rows[:, :, None], 0),
                           C.PAD_VALUE)
            bq = np.where(vm, bqm[rows_t[:, :, None], cols[:, None, :]],
                          C.PAD_VALUE)
            mq = np.where(vm, mqm[rows_t[:, :, None], cols[:, None, :]],
                          C.PAD_VALUE)
            return {"sequences": sq.astype(_bins._KEY_DTYPE["sequences"]),
                    "hap": hap.astype(_bins._KEY_DTYPE["hap"]),
                    "baseq": bq.astype(_bins._KEY_DTYPE["baseq"]),
                    "mapq": mq.astype(_bins._KEY_DTYPE["mapq"])}

        pk_h = gather_view(ch)
        pk_p = gather_view(cp)
        if packed:
            return {"groups": groups, "depths": depths,
                    "packed": {"pileup": pk_p, "haplotype": pk_h}}
        # legacy per-group contract: trim each group to its true depth
        # (int32, as the original interface emitted)
        out: Dict[str, object] = {"pileup": [], "haplotype": [],
                                  "groups": groups}
        for g in range(g_count):
            d = int(depths[g])
            for view, pk in (("pileup", pk_p), ("haplotype", pk_h)):
                out[view].append(
                    {k: pk[k][g, :d].astype(np.int32) for k in
                     ("sequences", "hap", "baseq", "mapq")})
        return out

    def _override_arrays(self, contig, over):
        cached = getattr(self, "_over_cache", None)
        if cached is None:
            cached = self._over_cache = {}
        if contig not in cached:
            ids = np.fromiter(over.keys(), dtype=np.int64, count=len(over))
            hps = np.fromiter(over.values(), dtype=np.int32, count=len(over))
            srt = np.argsort(ids)
            cached[contig] = (ids[srt], hps[srt])
        return cached[contig]
