"""External genomics tool wrappers (samtools / whatshap / bgzip / tabix).

The phasing stage (s3) intentionally shells out to whatshap+samtools exactly
like the reference (scripts/s3_phasing_long_reads.sh:35-80): the HP tags are
the only thing downstream consumes, and replacing whatshap natively would
break site-level output parity. All calls are availability-gated so the rest
of the framework runs without the tools installed.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence


class ExternalToolMissing(RuntimeError):
    pass


def have(tool: str) -> bool:
    return shutil.which(tool) is not None


def require(*tools: str) -> None:
    missing = [t for t in tools if not have(t)]
    if missing:
        raise ExternalToolMissing(
            f"required external tools not found: {', '.join(missing)} "
            "(stage s3 phasing needs samtools + whatshap + bgzip + tabix)")


def _run(cmd: Sequence[str], log_path: Optional[str] = None) -> None:
    with open(log_path, "ab") if log_path else subprocess.DEVNULL as log:
        subprocess.run(cmd, check=True, stdout=log, stderr=log)


def run_mpileup(bam: str, ref_fasta: str, out_path: str,
                min_mq: int = 20, max_depth: int = 144,
                excl_flags: int = 2316, log_path: Optional[str] = None) -> None:
    """samtools mpileup with the reference's exact options
    (make_predict_data.sh SAMTOOS_MPILEUP_OPTIONS)."""
    require("samtools")
    _run(["samtools", "mpileup", "--min-MQ", str(min_mq), "--min-BQ", "0",
          "--reverse-del", "--excl-flags", str(excl_flags),
          "--max-depth", str(max_depth), "-o", out_path, bam], log_path)


def split_bam_by_contig(bam: str, contigs: Sequence[str], out_dir: str,
                        threads: int = 8, log_path: Optional[str] = None) -> Dict[str, str]:
    require("samtools")
    os.makedirs(out_dir, exist_ok=True)
    out = {}

    def one(ctg: str):
        path = os.path.join(out_dir, f"splited_{ctg}.bam")
        _run(["samtools", "view", "-b", "-h", bam, ctg, "-o", path], log_path)
        _run(["samtools", "index", path], log_path)
        out[ctg] = path

    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(one, contigs))
    return out


def phase_and_haplotag(
    split_vcfs: Dict[str, str],     # contig -> phasing-input vcf
    split_bams: Dict[str, str],     # contig -> per-contig bam
    ref_fasta: str,
    work_dir: str,
    threads: int = 8,
    log_path: Optional[str] = None,
) -> Dict[str, str]:
    """whatshap phase + haplotag per contig (s3 steps c-f). Returns
    contig -> haplotagged bam."""
    require("whatshap", "bgzip", "tabix", "samtools")
    phased_dir = os.path.join(work_dir, "phase_out")
    tag_dir = os.path.join(work_dir, "haplotag_out")
    os.makedirs(phased_dir, exist_ok=True)
    os.makedirs(tag_dir, exist_ok=True)
    out: Dict[str, str] = {}

    def one(ctg: str):
        if ctg not in split_bams:
            return
        phased = os.path.join(phased_dir, f"{ctg}.phased.vcf")
        _run(["whatshap", "phase", "--output", phased, "--reference", ref_fasta,
              "--chromosome", ctg, "--distrust-genotypes",
              "--ignore-read-groups", split_vcfs[ctg], split_bams[ctg]],
             log_path)
        _run(["bgzip", "-f", phased], log_path)
        _run(["tabix", "-p", "vcf", phased + ".gz"], log_path)
        tagged = os.path.join(tag_dir, f"{ctg}.bam")
        _run(["whatshap", "haplotag", "--output", tagged, "--reference",
              ref_fasta, "--ignore-read-groups", "--regions", ctg,
              phased + ".gz", split_bams[ctg]], log_path)
        _run(["samtools", "index", tagged], log_path)
        out[ctg] = tagged

    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(one, list(split_vcfs)))
    return out
