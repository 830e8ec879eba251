"""Call scoring and output diffs: a copy of the JAX package's eval/ (the
standard library only), so that both packages score calls alike."""
from .diff import VcfDiff, diff_haplotype_csvs, diff_vcfs
from .f1 import (F1Result, classify_failed_sites, evaluate_calls,
                 genotype_confusion)
