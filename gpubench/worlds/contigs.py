"""Several seeded pileup contigs written as a user's s1 leaves them: one
FASTA holding every contig and one columnar shard a contig, in one
directory. Each contig is worlds.pileup's world, drawn in turn from one
generator; the writers are the port's (`io.bins`, `io.fasta`), passed in
by the cell's driver."""
from __future__ import annotations

import os
from typing import List

import numpy as np

from . import pileup as PW


def contig_worlds(rng: np.random.Generator, contigs: int, length: int,
                  n_cand: int) -> List[PW.PileupWorld]:
    return [PW.pileup_world(rng, length, n_cand) for _ in range(contigs)]


def contig_names(contigs: int) -> List[str]:
    return [f"ctg{i:03d}" for i in range(contigs)]


def write_contigs(worlds: List[PW.PileupWorld], work: str, bins,
                  fasta) -> tuple:
    """-> (fasta path, shard dir): the contigs in one FASTA, each
    contig's candidates in a shard of its own."""
    names = contig_names(len(worlds))
    fa = os.path.join(work, "ref.fa")
    fasta.write_fasta(fa, {n: w.seq.tobytes().decode()
                           for n, w in zip(names, worlds)})
    shard_dir = os.path.join(work, "pileup_shards")
    os.makedirs(shard_dir, exist_ok=True)
    for name, w in zip(names, worlds):
        pos = w.positions
        win = pos[:, None] - 1 + np.arange(-PW.FLANK, PW.FLANK + 1)[None, :]
        shard = bins.PileupShard(
            contig=name, positions=pos,
            ref_seqs=w.seq[win].view(f"S{2 * PW.FLANK + 1}").reshape(-1),
            alt_info=np.full(len(pos), b"A:1", dtype="S3"),
            columns=w.columns, cand_off=pos - 1, flank=PW.FLANK)
        bins.save_pileup_shard(os.path.join(shard_dir, f"{name}.npz"), shard)
    return fa, shard_dir
