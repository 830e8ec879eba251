"""fai-indexed FASTA access.

One implementation serves every stage (the reference loads the genome into RAM
in three different shapes — ref_reader.cpp:34-64, get_truth.py:88-104; here a
single lazily-loaded, per-contig byte array is shared).

No samtools dependency: the .fai is generated on demand if missing.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int
    line_bases: int
    line_bytes: int


def build_fai(fasta_path: str) -> List[FaiEntry]:
    """Generate .fai entries by scanning the FASTA (equivalent of
    `samtools faidx`). Requires uniform line lengths per record."""
    entries: List[FaiEntry] = []
    with open(fasta_path, "rb") as f:
        name = None
        length = 0
        offset = 0
        line_bases = 0
        line_bytes = 0
        pos = 0
        for raw in f:
            if raw.startswith(b">"):
                if name is not None:
                    entries.append(FaiEntry(name, length, offset, line_bases, line_bytes))
                name = raw[1:].split()[0].decode()
                length = 0
                line_bases = 0
                line_bytes = 0
                offset = pos + len(raw)
            else:
                stripped = raw.rstrip(b"\r\n")
                if line_bases == 0:
                    line_bases = len(stripped)
                    line_bytes = len(raw)
                length += len(stripped)
            pos += len(raw)
        if name is not None:
            entries.append(FaiEntry(name, length, offset, line_bases, line_bytes))
    return entries


def write_fai(entries: Iterable[FaiEntry], fai_path: str) -> None:
    with open(fai_path, "w") as f:
        for e in entries:
            f.write(f"{e.name}\t{e.length}\t{e.offset}\t{e.line_bases}\t{e.line_bytes}\n")


def load_fai(fai_path: str) -> List[FaiEntry]:
    entries = []
    with open(fai_path) as f:
        for line in f:
            cols = line.split("\t")
            entries.append(FaiEntry(cols[0], int(cols[1]), int(cols[2]),
                                    int(cols[3]), int(cols[4])))
    return entries


class FastaReference:
    """Random access to contig sequences as numpy uint8 arrays (ASCII)."""

    def __init__(self, fasta_path: str):
        self.fasta_path = fasta_path
        fai_path = fasta_path + ".fai"
        if not os.path.exists(fai_path):
            write_fai(build_fai(fasta_path), fai_path)
        self.entries = load_fai(fai_path)
        self.by_name: Dict[str, FaiEntry] = {e.name: e for e in self.entries}
        self._cache: Dict[str, np.ndarray] = {}

    @property
    def names(self) -> List[str]:
        return [e.name for e in self.entries]

    def length(self, name: str) -> int:
        return self.by_name[name].length

    def contig(self, name: str) -> np.ndarray:
        """Full contig as uint8 ASCII (as stored: case preserved)."""
        if name in self._cache:
            return self._cache[name]
        e = self.by_name[name]
        n_lines = (e.length + e.line_bases - 1) // e.line_bases
        nbytes = (n_lines - 1) * e.line_bytes + (
            e.length - (n_lines - 1) * e.line_bases) if n_lines else 0
        with open(self.fasta_path, "rb") as f:
            f.seek(e.offset)
            raw = np.frombuffer(f.read(nbytes + e.line_bytes), dtype=np.uint8)
        if e.line_bases == e.line_bytes or n_lines <= 1:
            seq = raw[: e.length]
        else:
            pad_lines = (e.length + e.line_bases - 1) // e.line_bases
            padded = np.zeros(pad_lines * e.line_bytes, dtype=np.uint8)
            padded[: min(len(raw), len(padded))] = raw[: len(padded)]
            seq = padded.reshape(pad_lines, e.line_bytes)[:, : e.line_bases].reshape(-1)[
                : e.length]
        seq = np.ascontiguousarray(seq)
        self._cache[name] = seq
        return seq

    def contig_str(self, name: str) -> str:
        return self.contig(name).tobytes().decode()

    def window(self, name: str, pos1: int, flank: int) -> bytes:
        """Reference bases [pos1-flank, pos1+flank] (1-based center)."""
        seq = self.contig(name)
        return seq[pos1 - 1 - flank: pos1 + flank].tobytes()


def write_fasta(path: str, contigs: Dict[str, str], line_width: int = 70) -> None:
    with open(path, "w") as f:
        for name, seq in contigs.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                f.write(seq[i: i + line_width] + "\n")
    fai = path + ".fai"
    if os.path.exists(fai):
        os.remove(fai)
    write_fai(build_fai(path), fai)
