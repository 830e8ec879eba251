"""Seeded pileup worlds, numpy only.

Copied from the repository's `chip_smoke.py` (`_pileup_columns`,
`_pileup_world`, `_pileup_train_arrays`), never imported from there: the
benchmark's yardstick does not move when that script does. The shard and
FASTA writers are the port's own (`io.bins`, `io.fasta`): they are how a
user's s1 hands its output to s2, and the cell's driver passes them in.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

FLANK = 16


def pileup_columns(rng: np.random.Generator, seq: np.ndarray) -> np.ndarray:
    """[len(seq), 18] int16 pileup counts in the s1 layout: reads matching
    the reference count negative in the reference base's channels, the
    other base positive, small indel channels."""
    n = len(seq)
    cols = np.zeros((n, 18), np.int16)
    base = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), seq)
    depth = rng.integers(8, 45, n)
    alt = rng.binomial(depth, rng.choice([0.02, 0.5, 0.95], n,
                                         p=[0.9, 0.07, 0.03]))
    fwd = rng.binomial(depth, 0.5)
    fwd_alt = rng.binomial(alt, 0.5)
    alt_base = (base + rng.integers(1, 4, n)) % 4
    r = np.arange(n)
    cols[r, base] -= (fwd - fwd_alt).clip(0).astype(np.int16)
    cols[r, base + 9] -= (depth - fwd - (alt - fwd_alt)).clip(0).astype(
        np.int16)
    cols[r, alt_base] += fwd_alt.astype(np.int16)
    cols[r, alt_base + 9] += (alt - fwd_alt).astype(np.int16)
    cols[:, [4, 5, 6, 7, 13, 14, 15, 16]] = rng.integers(
        0, 3, (n, 8)).astype(np.int16)
    return cols


class PileupWorld(NamedTuple):
    seq: np.ndarray          # [length] uint8 ASCII bases
    positions: np.ndarray    # [n_cand] 1-based candidate positions, sorted
    columns: np.ndarray      # [length, 18] int16


def pileup_world(rng: np.random.Generator, length: int,
                 n_cand: int) -> PileupWorld:
    """A random contig, its pileup columns and n_cand candidate positions
    at least FLANK + 1 bases from either end."""
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    pos = np.sort(rng.choice(np.arange(FLANK + 1, length - FLANK), n_cand,
                             replace=False)).astype(np.int64)
    return PileupWorld(seq, pos, pileup_columns(rng, seq))


def write_pileup_world(world: PileupWorld, work: str, contig: str, bins,
                       fasta) -> tuple:
    """The world as a user's s1 leaves it: a FASTA and one columnar shard
    (the port's writers `bins`, `fasta`) -> (fasta path, shard dir)."""
    fa = os.path.join(work, "ref.fa")
    fasta.write_fasta(fa, {contig: world.seq.tobytes().decode()})
    pos = world.positions
    win = pos[:, None] - 1 + np.arange(-FLANK, FLANK + 1)[None, :]
    shard = bins.PileupShard(
        contig=contig, positions=pos,
        ref_seqs=world.seq[win].view(f"S{2 * FLANK + 1}").reshape(-1),
        alt_info=np.full(len(pos), b"A:1", dtype="S3"),
        columns=world.columns, cand_off=pos - 1, flank=FLANK)
    shard_dir = os.path.join(work, "pileup_shards")
    os.makedirs(shard_dir, exist_ok=True)
    bins.save_pileup_shard(os.path.join(shard_dir, f"{contig}.npz"), shard)
    return fa, shard_dir


class PileupTrainWorld(NamedTuple):
    matrix: np.ndarray       # [n, 33, 18] int32 signed counts
    label: np.ndarray        # [n, 90] int32 one-hot blocks


def pileup_train_arrays(rng: np.random.Generator, n: int) -> PileupTrainWorld:
    """Labelled pileup windows in the make-train-data layout: signed
    counts, 90-dim one-hot labels (gt 21, zy 3, two indel blocks)."""
    matrix = rng.integers(-30, 30, (n, 33, 18)).astype(np.int32)
    label = np.zeros((n, 90), np.int32)
    label[np.arange(n), rng.integers(0, 21, n)] = 1
    label[np.arange(n), 21 + rng.integers(0, 3, n)] = 1
    label[np.arange(n), 24 + 16] = 1
    label[np.arange(n), 57 + 16] = 1
    return PileupTrainWorld(matrix, label)
