"""Merge pileup VCF with haplotype-model calls into the final VCF.

Line-exact port of the reference merge rules (scripts/merge.py:15-145):
  - pileup QUAL > threshold (19): pass through with INFO='P' unless RefCall;
  - else look up the haplotype call:
      * hap qual < 13 (or site absent): fall back to the pileup call when
        QUAL >= 13 and not RefCall (INFO='P');
      * ref in hap GT: homozygous -> drop; het -> 0/1 with alt = GT minus ref;
      * ref not in GT: homo -> 1/1; het -> 1/2 with sorted alts;
      * D/I alleles: drop, except 1/2 -> demoted to 0/1 without the indel;
      * rescued rows get INFO='H', QUAL = hap qual.
"""
from __future__ import annotations

from collections import defaultdict
from typing import IO, Iterable


def load_haplotype_calls(lines: Iterable[str]):
    """haplotype CSV rows `ctg\\tpos\\tGT\\tqual` -> nested dict."""
    cat = defaultdict(dict)
    for row in lines:
        row = row.strip()
        if not row:
            continue
        ctg, pos, gt, qual = row.split("\t")
        cat[ctg][pos] = (gt, qual)
    return cat


def merge_calls(
    pileup_vcf_lines: Iterable[str],
    haplotype_lines: Iterable[str],
    out: IO[str],
    quality_threshold: float = 19.0,
    hap_quality: float = 13.0,
    pileup_rescue_quality: float = 13.0,
) -> int:
    cat = load_haplotype_calls(haplotype_lines)
    modify_count = 0
    insert_hp = True
    for line in pileup_vcf_lines:
        if line.startswith("#"):
            out.write(line if line.endswith("\n") else line + "\n")
            if insert_hp:
                out.write('##INFO=<ID=P,Number=0,Type=Flag,Description="Result from pileup model">\n')
                out.write('##INFO=<ID=H,Number=0,Type=Flag,Description="Result from haplotype model">\n')
                insert_hp = False
            continue
        fields = line.strip().split("\t")
        ref = fields[3]
        quality = float(fields[5])
        filt = fields[6]
        ctg = fields[0]
        pos = int(fields[1])
        depth, af = fields[-1].split(":")[-2:]
        depth = int(depth)
        af = float(af)

        def passthrough_p():
            f2 = line.strip().split("\t")
            f2[7] = "P"
            out.write("\t".join(f2) + "\n")

        if quality <= quality_threshold:
            hap = cat[ctg].get(str(pos))
            if hap is None:
                if filt != "RefCall" and quality >= pileup_rescue_quality:
                    passthrough_p()
                continue
            gt, qual = hap
            qual = float(qual)
            if qual < hap_quality:
                if filt != "RefCall" and quality >= pileup_rescue_quality:
                    passthrough_p()
                continue
            if ref in gt:
                if gt[0] == gt[1]:
                    continue  # haplotype says hom-ref: drop
                new_gt = gt.replace(ref, "")
                new_zy = "0/1"
                quality = qual
            else:
                if gt[0] == gt[1]:
                    new_gt = gt[0]
                    new_zy = "1/1"
                    quality = qual
                else:
                    new_gt = ",".join(sorted(gt))
                    new_zy = "1/2"
                    quality = qual
            if "D" in new_gt:
                if new_zy in ("0/1", "1/1"):
                    continue
                new_gt = gt.replace("D", "")
                new_zy = "0/1"
            elif "I" in new_gt:
                if new_zy in ("0/1", "1/1"):
                    continue
                new_gt = gt.replace("I", "")
                new_zy = "0/1"
            out.write(f"{ctg}\t{pos}\t.\t{ref}\t{new_gt}\t{quality}\tPASS\tH\t"
                      f"GT:GQ:DP:AF\t{new_zy}:{int(quality)}:{depth}:{af:f}\n")
            modify_count += 1
        else:
            if filt != "RefCall":
                passthrough_p()
    return modify_count
