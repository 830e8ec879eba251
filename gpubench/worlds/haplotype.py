"""Seeded haplotype worlds, numpy only.

Copied from the repository's `chip_smoke.py` (`_read_matrices`, the s5
world of `phase_slice`, `_haplotype_train_world`), never imported from
there. The s5 world takes its sites from a random contig rather than from
an s2 run's calls, so that it needs nothing but the seed. The shard and
FASTA writers are the port's (`io.bins`, `io.fasta`), passed in by the
cell's driver.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple

import numpy as np

GROUP_STEP = 7          # bp between the 11 positions of a site's group


def read_matrices(rng: np.random.Generator, n: int, depth: int,
                  seq_len: int, untagged: int) -> Dict[str, np.ndarray]:
    """One view of a haplotype shard: [n, depth, L] read matrices with
    ragged depth (pad -2); the first `untagged` sites carry no HP tag."""
    seq = rng.integers(-1, 5, (n, depth, seq_len)).astype(np.int8)
    keep = rng.integers(depth // 2, depth + 1, n)
    pad = np.arange(depth)[None, :, None] >= keep[:, None, None]
    seq[np.broadcast_to(pad, seq.shape)] = -2
    pad = seq == -2
    tags = rng.integers(1, 4, (n, depth, 1)).repeat(seq_len, axis=2)
    tags[:untagged] = 3
    return {"sequences": seq,
            "hap": np.where(pad, -2, tags).astype(np.int8),
            "baseq": np.where(pad, -2, rng.integers(0, 60, seq.shape)
                              ).astype(np.int8),
            "mapq": np.where(pad, -2, rng.integers(0, 254, seq.shape)
                             ).astype(np.int16)}


class HapBucket(NamedTuple):
    depth: int
    centers: np.ndarray                  # [n] 1-based, sorted
    groups: np.ndarray                   # [n, 11]
    pileup: Dict[str, np.ndarray]        # [n, depth, 33]
    haplotype: Dict[str, np.ndarray]     # [n, depth, 11]


class HapWorld(NamedTuple):
    seq: np.ndarray                      # [length] uint8 ASCII bases
    buckets: List[HapBucket]


def hap_world(rng: np.random.Generator, length: int, sites: int,
              depths=(64, 96), untagged_frac: float = 0.25) -> HapWorld:
    """A random contig and `sites` sites in each depth bucket, the first
    `untagged_frac` of each bucket's sites with no HP tag."""
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    pos = np.sort(rng.choice(np.arange(200, length - 200),
                             len(depths) * sites, replace=False)
                  ).astype(np.int64)
    buckets = []
    for i, depth in enumerate(depths):
        centers = pos[i::len(depths)]
        n = len(centers)
        untagged = int(n * untagged_frac)
        buckets.append(HapBucket(
            depth, centers,
            centers[:, None] + np.arange(-5, 6)[None, :] * GROUP_STEP,
            read_matrices(rng, n, depth, 33, untagged),
            read_matrices(rng, n, depth, 11, untagged)))
    return HapWorld(seq, buckets)


def write_hap_world(world: HapWorld, work: str, contig: str, bins, fasta,
                    name: str = "hap_shards") -> tuple:
    """The world as a user's s4 leaves it: a FASTA and one shard a depth
    bucket -> (fasta path, shard dir)."""
    fa = os.path.join(work, "ref.fa")
    fasta.write_fasta(fa, {contig: world.seq.tobytes().decode()})
    shard_dir = os.path.join(work, name)
    os.makedirs(shard_dir, exist_ok=True)
    for b in world.buckets:
        bins.save_haplotype_shard(
            os.path.join(shard_dir, f"{contig}_d{b.depth}x{b.depth}.npz"),
            bins.HaplotypeShard(
                contig=contig, candidate_positions=b.centers,
                group_positions=b.groups, pileup=b.pileup,
                haplotype=b.haplotype))
    return fa, shard_dir


def truth_files(rng: np.random.Generator, world: HapWorld, work: str,
                contig: str) -> tuple:
    """A truth VCF with SNPs at about 40% of the world's sites (60% of
    them het) and a BED over the contig -> (vcf path, bed path, truth),
    truth {pos: (the genotype's two bases, sorted, zygosity: 1 hom-alt,
    2 het)} of the variant sites; every other site is a reference call."""
    seq = world.seq
    pos = np.sort(np.concatenate([b.centers for b in world.buckets]))
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    truth = {}
    for p in pos[rng.random(len(pos)) < 0.4]:
        ref_b = chr(seq[p - 1])
        alt = "ACGT"[("ACGT".index(ref_b) + 1) % 4]
        gt = "0|1" if rng.random() < 0.6 else "1|1"
        truth[int(p)] = ("".join(sorted(ref_b + alt)), 2) if gt == "0|1" \
            else (alt + alt, 1)
        lines.append(f"{contig}\t{p}\t.\t{ref_b}\t{alt}\t50\tPASS\t.\tGT\t{gt}")
    vcf = os.path.join(work, "truth.vcf")
    with open(vcf, "w") as f:
        f.write("\n".join(lines) + "\n")
    bed = os.path.join(work, "conf.bed")
    with open(bed, "w") as f:
        f.write(f"{contig}\t0\t{len(seq)}\n")
    return vcf, bed, truth
