"""Command-line entry point: `python -m nanosnp_tpu_torch.runtime.cli <command>`.

Commands of this slice (same flags as the JAX package's CLI, plus
`--device`):

  s2-predict  pileup shards -> pileup.vcf
  s6-merge    pileup.vcf + haplotype.csv -> merge.vcf

s5 has no subcommand (the JAX CLI has none either): it runs through
`runtime.stages.stage_haplotype_predict`.
"""
from __future__ import annotations

import argparse
import os

from ..config import load_config
from ..io.fasta import FastaReference
from . import stages


def _add_common(p):
    p.add_argument("--config", default=None,
                   help="YAML config overriding defaults")
    p.add_argument("--threads", type=int, default=0)
    p.add_argument("--output", "-o", required=True, help="output directory")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nanosnp_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("s2-predict", help="pileup shards -> pileup.vcf")
    _add_common(p)
    p.add_argument("--shards", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--pileup-model", required=True,
                   help="reference-layout pileup checkpoint")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")

    p = sub.add_parser("s6-merge",
                       help="pileup.vcf + haplotype.csv -> merge.vcf")
    _add_common(p)
    p.add_argument("--pileup-vcf", required=True)
    p.add_argument("--haplotype-csv", required=True)

    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if args.threads:
        cfg.threads = args.threads
    os.makedirs(args.output, exist_ok=True)

    if args.cmd == "s2-predict":
        m = stages.stage_pileup_predict(
            cfg, FastaReference(args.ref), args.shards,
            os.path.join(args.output, "pileup.vcf"),
            model_path=args.pileup_model, device=args.device)
    else:
        m = stages.stage_merge(cfg, args.pileup_vcf, args.haplotype_csv,
                               os.path.join(args.output, "merge.vcf"))
    print(m)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
