"""Shared constants of the NanoSNP-TPU pipeline.

These mirror the reference pipeline's fixed vocabularies so that outputs are
site-level identical:
  - 18 pileup channels: reference dna_sv_tensor/src/common/tensor.hpp:6-26
  - GT21 / zygosity label vocabularies: reference PileupModel/options.py,
    HaplotypeModel/options.py
  - pipeline thresholds: reference dna_sv_tensor/src/scripts/make_predict_data.sh,
    scripts/s4_haplotype_model_feature_generation.sh:57-65,
    scripts/s6_merge_pileup_haplotype_calls.sh:9-13
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Pileup tensor channels (order fixed; uppercase = forward strand).
# I/D = total count of reads with an insertion/deletion starting here;
# I1/D1 = count of the single most frequent ins/del observation;
# '*' = deletion placeholder base (fwd), '#' = same for reverse strand.
# ---------------------------------------------------------------------------
CHANNELS = [
    "A", "C", "G", "T", "I", "I1", "D", "D1", "*",
    "a", "c", "g", "t", "i", "i1", "d", "d1", "#",
]
NUM_CHANNELS = 18
CH = {name: i for i, name in enumerate(CHANNELS)}

# Center-column channel indices used to recover depth/AF at decode time
# (reference PileupModel/predict.py:63): A C G T a c g t
ACGT_FWD_CH = np.array([CH["A"], CH["C"], CH["G"], CH["T"]])
ACGT_REV_CH = np.array([CH["a"], CH["c"], CH["g"], CH["t"]])
DECODE_COV_CH = np.array([0, 1, 2, 3, 9, 10, 11, 12])

# ---------------------------------------------------------------------------
# Pipeline constants (single source of truth; the reference scatters these
# over shell scripts).
# ---------------------------------------------------------------------------
FLANKING_BASES = 16              # pileup window = 2*16+1 = 33
PILEUP_WINDOW = 2 * FLANKING_BASES + 1
MIN_AF = 0.12
SNP_MIN_AF = 0.12
INDEL_MIN_AF = 0.12
MIN_DEPTH = 6
MAX_INDEL_SIZE = 60              # indels longer than this are ignored while parsing
MPILEUP_MAX_DEPTH = 144
MPILEUP_MIN_MQ = 20
MPILEUP_EXCL_FLAGS = 2316
BED_EXTENDED_BASES = 31

# Haplotype stage (s3-s6)
PHASE_HET_QUAL = 16              # het sites with QUAL >= 16 go into whatshap phasing
HAP_LOW_QUAL = 19                # pileup QUAL < 19 -> haplotype-model candidate
HAP_SUPPORT_QUAL = 14            # group support hets need QUAL >= 14 and GT 0/1
ADJACENT_SIZE = 5                # 5 hets each side -> group of 11
HAPLOTYPE_WINDOW = 2 * ADJACENT_SIZE + 1
MAX_COVERAGE = 150               # positions above this coverage poison their groups
GROUP_CHUNK = 100                # groups per extraction sub-batch
GROUP_GAP = 1000                 # bp gap that breaks a sub-batch
MERGE_QUAL = 19                  # pileup QUAL <= 19 is eligible for haplotype rescue
MERGE_HAP_QUAL = 13              # haplotype call accepted when its qual >= 13
MERGE_PILEUP_RESCUE_QUAL = 13    # else fall back to pileup call if QUAL >= 13
PAD_VALUE = -2                   # depth-padding value in read matrices

# ---------------------------------------------------------------------------
# Label vocabularies
# ---------------------------------------------------------------------------
GT21_LABELS = [
    "AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT", "TT",
    "DD", "AD", "CD", "GD", "TD", "II", "AI", "CI", "GI", "TI", "ID",
]
GT21 = {name: i for i, name in enumerate(GT21_LABELS)}
NUM_GT21 = 21
# SNV-only genotypes (first 10) are the haplotype model's output space
NUM_GT10 = 10
ZY_LABELS = ["0/0", "1/1", "0/1"]
NUM_ZY = 3
NUM_INDEL_CLASSES = 33           # variant-length classes: <-15, -15..15, >15
# Homozygous / heterozygous SNV class ids inside GT21 (decode fallback search
# sets, reference PileupModel/predict.py:103,118)
GT21_HOMO_SNV = [0, 4, 7, 9]
GT21_HET_SNV = [1, 2, 3, 5, 6, 8]

BASES = "ACGT"
BASE_IDX = {b: i for i, b in enumerate(BASES)}
# Read-matrix base encoding (reference HaplotypeModel/create_pileup_haplotype.py:7):
# absent=0, A=1, C=2, G=3, T=4, deletion=-1, depth padding=-2
BASE2INT = {"A": 1, "C": 2, "G": 3, "T": 4, "N": 0}

# Contig ordering used for VCF sorting and merge (reference scripts/merge.py:11)
MAJOR_CONTIGS_ORDER = ["chr" + str(a) for a in list(range(1, 23)) + ["X", "Y"]] + [
    str(a) for a in list(range(1, 23)) + ["X", "Y"]
]
ALL_CHROMS = ["chr%d" % i for i in range(1, 23)] + ["chrX", "chrY"]


def contig_sort_key(name: str):
    """Sort key reproducing the reference's contig ordering."""
    try:
        return (0, MAJOR_CONTIGS_ORDER.index(name), name)
    except ValueError:
        return (1, 0, name)


# base -> 4-bit code used for "is this an ACGT base" tests; mirrors the
# semantics of nst_nt4_table (reference dna_sv_tensor/src/common/cpp_aux.cpp:85)
_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    _NT4[ord(_b)] = _i
    _NT4[ord(_b.lower())] = _i
NT4_TABLE = _NT4


def is_acgt(base: str) -> bool:
    return NT4_TABLE[ord(base)] < 4
