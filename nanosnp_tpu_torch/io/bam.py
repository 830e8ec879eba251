"""BAM access via the native engine (io/native/bam_core.cpp).

BamFile wraps a loaded+indexed BAM; pileup_region() yields the same
ChromPileup arrays as the mpileup-text path without any samtools round-trip;
read_matrices() yields read-by-position matrices for the haplotype stage
(rows ordered like pysam's pileup iteration: first covered requested column,
then BAM order).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .native import NativeUnavailable, _ptr, get_lib


def _bind(lib):
    if getattr(lib, "_bam_bound", False):
        return lib
    lib.nsp_bam_open.restype = ctypes.c_int64
    lib.nsp_bam_open.argtypes = [ctypes.c_char_p]
    lib.nsp_bam_close.restype = None
    lib.nsp_bam_close.argtypes = [ctypes.c_int64]
    lib.nsp_bam_ref_info.restype = ctypes.c_int64
    lib.nsp_bam_ref_info.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64]
    lib.nsp_bam_n_refs.restype = ctypes.c_int64
    lib.nsp_bam_n_refs.argtypes = [ctypes.c_int64]
    lib.nsp_bam_pileup_region.restype = ctypes.c_int64
    lib.nsp_bam_pileup_region.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.nsp_bam_read_matrices.restype = ctypes.c_int64
    lib.nsp_bam_read_matrices.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.nsp_bam_write_tagged.restype = ctypes.c_int64
    lib.nsp_bam_write_tagged.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_char_p]
    lib.nsp_bam_split_by_tag.restype = ctypes.c_int64
    lib.nsp_bam_split_by_tag.argtypes = [
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    lib._bam_bound = True
    return lib


# pysam stepper="all" default exclusion mask (UNMAP|SECONDARY|QCFAIL|DUP)
PYSAM_EXCL_FLAGS = 1796


class BamFile:
    def __init__(self, path: str):
        self.lib = _bind(get_lib())
        self.path = path
        self.handle = self.lib.nsp_bam_open(path.encode())
        if self.handle < 0:
            raise NativeUnavailable(f"failed to open BAM {path}: {self.handle}")
        # per-thread scratch for read_matrices: fresh multi-10-MB
        # allocations per call cost ~10x the native fill itself (page
        # faults on every window), so buffers persist and grow
        # geometrically; callers only ever see [:r] copies
        self._tls = threading.local()

    def _matrix_scratch(self, max_reads: int, n_pos: int):
        t = self._tls
        cap_r = getattr(t, "cap_r", 0)
        cap_p = getattr(t, "cap_p", 0)
        if max_reads > cap_r or max_reads * n_pos > cap_r * cap_p:
            cap_r = max(max_reads, cap_r, 1024)
            cap_p = max(n_pos, cap_p, 64)
            # flat cells: native packs rows at n_pos stride, so only the
            # total element count matters, not the 2-D shape
            t.base = np.zeros(cap_r * cap_p, dtype=np.int32)
            t.baseq = np.zeros(cap_r * cap_p, dtype=np.int32)
            t.mapq = np.zeros(cap_r * cap_p, dtype=np.int32)
            t.hap = np.zeros(cap_r, dtype=np.int32)
            t.first_col = np.zeros(cap_r, dtype=np.int32)
            t.read_ids = np.zeros(cap_r, dtype=np.int64)
            t.cap_r, t.cap_p = cap_r, cap_p
        return t

    def close(self):
        if self.handle >= 0:
            self.lib.nsp_bam_close(self.handle)
            self.handle = -1

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def references(self) -> List[Tuple[str, int]]:
        n = self.lib.nsp_bam_n_refs(self.handle)
        if n <= 0:
            return []
        name_cap = 4096 * max(n, 1)
        name_buf = ctypes.create_string_buffer(name_cap)
        lengths = np.zeros(n, dtype=np.int64)
        got = self.lib.nsp_bam_ref_info(self.handle, name_buf, name_cap,
                                        _ptr(lengths), n)
        names = name_buf.raw.split(b"\0")[: got]
        return [(names[i].decode(), int(lengths[i])) for i in range(got)]

    def pileup_region(
        self,
        contig: str,
        start0: int,
        end0: int,
        chr_seq: np.ndarray,
        snp_min_af: float = 0.12,
        indel_min_af: float = 0.12,
        min_coverage: int = 6,
        max_indel: int = 60,
        min_mq: int = 20,
        excl_flags: int = 2316,
        max_depth: int = 144,
        depth_mode: str = "column",
    ):
        """ChromPileup for positions in [start0, end0) (0-based).

        depth_mode:
          "column" (default) — per-column cap, first covering reads in BAM
            order win (cap re-fills at every column).
          "push" — htslib bam_plp_push admission: a read is dropped WHOLE
            when the buffer of still-active admitted reads is full at its
            start (samtools' coverage-spike shadow). Admission state is
            per call, so chunk boundaries reset it (edge effect of a few
            read lengths). See bam_core.cpp for the full semantics note.
        """
        from ..features.pileup import ChromPileup

        if depth_mode not in ("column", "push"):
            raise ValueError(f"depth_mode {depth_mode!r}")
        if depth_mode == "push":
            max_depth = -max_depth   # sign encodes the mode natively

        w = max(end0 - start0, 0)
        positions = np.zeros(w, dtype=np.int64)
        counts = np.zeros((w, 18), dtype=np.int32)
        depths = np.zeros(w, dtype=np.int32)
        cand = np.zeros(w, dtype=np.uint8)
        afs = np.zeros(w, dtype=np.float64)
        alt_off = np.zeros(2 * w, dtype=np.int64)
        ref_bytes = chr_seq.tobytes()
        alt_cap = max(1 << 16, 64 * w)
        for _ in range(3):
            alt_buf = np.zeros(alt_cap, dtype=np.uint8)
            ret = self.lib.nsp_bam_pileup_region(
                self.handle, contig.encode(), start0, end0,
                ref_bytes, len(ref_bytes),
                snp_min_af, indel_min_af, min_coverage, max_indel,
                min_mq, excl_flags, max_depth,
                _ptr(positions), _ptr(counts), _ptr(depths), _ptr(cand),
                _ptr(afs), _ptr(alt_buf), alt_cap, _ptr(alt_off))
            if ret >= 0:
                break
            if ret in (-1, -2, -3):   # bad handle / ref / region fetch
                raise NativeUnavailable(f"bam pileup failed: {ret}")
            alt_cap = -ret
        else:
            raise RuntimeError("alt buffer negotiation failed")
        m = int(ret)
        # decode alt_info lazily: only candidate rows carry/need it, and
        # decoding all ~2M rows per chunk cost more than the native pileup
        # itself (only ~1.5% of rows are candidates). Slice the numpy
        # buffer per candidate — a whole-buffer .tobytes() memcpy (64 B/row
        # of mostly-unused capacity) costed more than the native call.
        alt_info = [""] * m
        for i in np.flatnonzero(cand[:m]):
            alt_info[i] = (alt_buf[alt_off[2 * i]: alt_off[2 * i + 1]]
                           .tobytes().decode())
        # views, not copies: m ~= w for covered chunks, so copying freed
        # almost nothing and cost ~0.5 s/2 Mbp in memcpy; the window
        # gather (assemble_windows) narrows candidate rows to int16
        return ChromPileup(
            chrom=contig,
            positions=positions[:m],
            counts=counts[:m],
            depths=depths[:m],
            is_candidate=cand[:m].astype(bool),   # bool for mask indexing
            alt_info=alt_info,
            afs=afs[:m],
        )

    def read_matrices(
        self,
        contig: str,
        positions1: np.ndarray,
        min_mq: int = 0,
        excl_flags: int = PYSAM_EXCL_FLAGS,
        max_reads: int = 1024,
    ) -> Optional[Dict[str, np.ndarray]]:
        """Matrices over reads x requested positions: base (0/1-4/-1),
        baseq, mapq [R, P] int32; hap [R]; read_ids [R] int64 (stable
        per-record identity — the record's inflated-stream offset); rows
        sorted to pysam pileup order; n_nonacgt = count of non-ACGT read
        bases seen at requested positions (the reference's chunk-poisoning
        trigger, create_pileup_haplotype.py:122). Returns None when no
        read covers any position."""
        positions1 = np.asarray(positions1, dtype=np.int64)
        if not positions1.flags.c_contiguous:
            positions1 = np.ascontiguousarray(positions1)
        n_pos = len(positions1)
        if n_pos == 0:
            return None
        nonacgt = np.zeros(1, dtype=np.int64)
        for _ in range(4):
            t = self._matrix_scratch(max_reads, n_pos)
            # use the full scratch row capacity so a retry only happens
            # when the region genuinely outgrows it
            eff_max = min(t.cap_r, (t.cap_r * t.cap_p) // n_pos)
            ret = self.lib.nsp_bam_read_matrices(
                self.handle, contig.encode(), _ptr(positions1), n_pos,
                min_mq, excl_flags, eff_max,
                _ptr(t.base), _ptr(t.baseq), _ptr(t.mapq), _ptr(t.hap),
                _ptr(t.first_col), _ptr(t.read_ids), _ptr(nonacgt))
            if ret >= 0:
                break
            if ret in (-1, -2, -3):   # bad handle / ref / region fetch
                raise NativeUnavailable(f"bam read_matrices failed: {ret}")
            max_reads = -(ret + 10) + 16
        else:
            raise RuntimeError("read capacity negotiation failed")
        r = int(ret)
        if r == 0:
            return None
        base = t.base[: r * n_pos].reshape(r, n_pos)
        baseq = t.baseq[: r * n_pos].reshape(r, n_pos)
        mapq = t.mapq[: r * n_pos].reshape(r, n_pos)
        order = np.argsort(t.first_col[:r], kind="stable")
        return {
            "sequences": base[order],
            "baseq": baseq[order],
            "mapq": mapq[order],
            "hap_tags": t.hap[:r][order],
            "first_col": t.first_col[:r][order],
            "read_ids": t.read_ids[:r][order],
            "n_nonacgt": int(nonacgt[0]),
        }

    def write_tagged(self, out_path: str, read_hp: Dict[int, int],
                     contig: Optional[str] = None) -> int:
        """Write a haplotagged copy of this BAM (whatshap-haplotag's
        artifact): reads in `read_hp` (stable read id -> 1|2) get an HP:c
        aux (existing HP stripped), everything else passes through
        byte-identical; header preserved. `contig` limits the body to one
        reference. Returns records written."""
        ids = np.fromiter(read_hp.keys(), dtype=np.int64,
                          count=len(read_hp))
        hps = np.fromiter(read_hp.values(), dtype=np.int32,
                          count=len(read_hp))
        ret = self.lib.nsp_bam_write_tagged(
            self.handle, contig.encode() if contig else None,
            _ptr(ids), _ptr(hps), len(ids), out_path.encode())
        if ret < 0:
            raise NativeUnavailable(f"bam write_tagged failed: {ret}")
        return int(ret)

    def split_by_tag(self, h1_path: str, h2_path: str,
                     contig: Optional[str] = None) -> int:
        """Split by HP aux into h1/h2 BAMs, dropping untagged reads
        (reference scripts/split_bam_by_tag.py semantics). Returns total
        records written."""
        ret = self.lib.nsp_bam_split_by_tag(
            self.handle, contig.encode() if contig else None,
            h1_path.encode(), h2_path.encode())
        if ret < 0:
            raise NativeUnavailable(f"bam split_by_tag failed: {ret}")
        return int(ret)
